"""Matroska files built by hand for the port's demuxer tests
(tests/test_torch_mkv.py): the layouts cv2's own writer never produces
(lacing, BlockGroups, unknown sizes, a VFW track, content encodings), each
read by cv2 and the port alike.

`build(frames, ...)` writes the EBML header, a Segment (of unknown size
with `unknown_segment`), Info, one video TrackEntry and Clusters of the
given frames; `blocks` says how frames go into blocks: "simple" (one
SimpleBlock a frame), "group" (one BlockGroup a frame, a ReferenceBlock
on the non-keyframes), or a lacing ("xiph", "ebml", "fixed") of `lace`
frames a SimpleBlock.
"""

from __future__ import annotations

import struct
import zlib

from vision_kit_tpu_torch.utils import mkv
from vision_kit_tpu_torch.utils.mkv import element, uint_element

UNKNOWN = b"\x01\xff\xff\xff\xff\xff\xff\xff"      # an 8-byte unknown size


def bitmapinfoheader(width: int, height: int, fourcc: bytes, extra: bytes = b"") -> bytes:
    return struct.pack("<IiiHH4sIiiII", 40 + len(extra), width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0) + extra


def _xiph(n: int) -> bytes:
    return b"\xff" * (n // 255) + bytes([n % 255])


def _ebml_signed(v: int) -> bytes:
    """A signed EBML lace size difference."""
    for width in range(1, 9):
        bias = (1 << (7 * width - 1)) - 1
        if -bias <= v <= bias:
            return ((1 << (7 * width)) | (v + bias)).to_bytes(width, "big")
    raise ValueError(v)


def _laced(frames: list, lacing: str) -> tuple:
    """(flags bits, lace header) of frames in one block."""
    head = bytes([len(frames) - 1])
    if lacing == "xiph":
        return 0x02, head + b"".join(_xiph(len(f)) for f in frames[:-1])
    if lacing == "fixed":
        assert len({len(f) for f in frames}) == 1
        return 0x04, head
    sizes = [len(f) for f in frames]
    body = mkv._size(sizes[0]) + b"".join(_ebml_signed(b - a)
                                          for a, b in zip(sizes, sizes[1:-1]))
    return 0x06, head + body


def build(path: str, frames: list, keys: list, width: int, height: int, *,
          codec_id: str = "V_MPEG4/ISO/ASP", private: bytes = b"", fps: float | None = 24.0,
          times: list | None = None, blocks: str = "simple", lace: int = 3,
          unknown_segment: bool = False, unknown_cluster: bool = False,
          encoding: tuple | None = None, doc: str = "matroska", read_version: int = 2,
          cluster_frames: int = 8, extra_tracks: bool = False) -> None:
    """A Matroska file of the coded `frames` (see the module docstring).
    fps: DefaultDuration's rate (None: none, the rate comes from the
    timestamps); times: each frame's timestamp in ms (default i * 1000 /
    fps, rounded); encoding: (scope, algorithm, settings) of one
    ContentEncoding, the frames (and CodecPrivate, by its scope) stored
    encoded: algorithm 0 zlib-compressed, 3 with `settings` stripped from
    their heads; extra_tracks: an audio track before the video one."""
    n = len(frames)
    if times is None:
        times = [round(i * 1000 / (fps or 25.0)) for i in range(n)]

    def stored(data: bytes, scope_bit: int) -> bytes:
        if encoding is None or not encoding[0] & scope_bit:
            return data
        if encoding[1] == 0:
            return zlib.compress(data)
        assert data.startswith(encoding[2])
        return data[len(encoding[2]):]

    video = element(mkv.VIDEO, uint_element(mkv.PIXEL_WIDTH, width)
                    + uint_element(mkv.PIXEL_HEIGHT, height))
    fields = (uint_element(mkv.TRACK_NUMBER, 2) + uint_element(mkv.TRACK_UID, 7)
              + element(mkv.CODEC_ID, codec_id.encode()) + uint_element(mkv.TRACK_TYPE, 1))
    if fps:
        fields += uint_element(mkv.DEFAULT_DURATION, int(1e9 / fps))
    fields += video
    if private:
        fields += element(mkv.CODEC_PRIVATE, stored(private, 2))
    if encoding is not None:
        comp = uint_element(mkv.CONTENT_COMP_ALGO, encoding[1])
        if encoding[2]:
            comp += element(mkv.CONTENT_COMP_SETTINGS, encoding[2])
        fields += element(mkv.CONTENT_ENCODINGS, element(
            mkv.CONTENT_ENCODING, uint_element(mkv.CONTENT_ENCODING_SCOPE, encoding[0])
            + element(mkv.CONTENT_COMPRESSION, comp)))
    tracks = element(mkv.TRACK_ENTRY, fields)
    if extra_tracks:
        audio = element(mkv.TRACK_ENTRY, uint_element(mkv.TRACK_NUMBER, 1)
                        + uint_element(mkv.TRACK_UID, 9) + element(mkv.CODEC_ID, b"A_PCM/INT/LIT")
                        + uint_element(mkv.TRACK_TYPE, 2)
                        + element(0xE1, element(0xB5, struct.pack(">d", 8000.0))
                                  + uint_element(0x9F, 1) + uint_element(0x6264, 16)))
        tracks = audio + tracks
    duration = float(times[-1] + round(1000 / (fps or 25.0))) if n else 0.0
    info = element(mkv.INFO, uint_element(mkv.TIMESTAMP_SCALE, 1000000)
                   + element(mkv.MUXING_APP, b"hand") + element(mkv.WRITING_APP, b"hand")
                   + element(mkv.DURATION, struct.pack(">d", duration)))
    body = info + element(mkv.TRACKS, tracks)
    i = 0
    while i < n:
        base = times[i]
        content = uint_element(mkv.TIMESTAMP, base)
        stop = min(i + cluster_frames, n)
        while i < stop:
            if blocks in ("simple", "group"):
                group = frames[i:i + 1]
            else:
                group = frames[i:min(i + lace, stop)]
            flags = 0x80 if keys[i] and blocks != "group" else 0
            lace_head = b""
            if len(group) > 1:
                bits, lace_head = _laced([stored(g, 1) for g in group], blocks)
                flags |= bits
            head = b"\x82" + struct.pack(">hB", times[i] - base, flags)
            data = head + lace_head + b"".join(stored(g, 1) for g in group)
            if extra_tracks:
                content += element(mkv.SIMPLE_BLOCK, b"\x81" + struct.pack(
                    ">hB", times[i] - base, 0x80) + bytes(16))
            if blocks == "group":
                ref = b"" if keys[i] else element(mkv.REFERENCE_BLOCK, b"\xff")
                content += element(mkv.BLOCK_GROUP, element(mkv.BLOCK, data) + ref)
            else:
                content += element(mkv.SIMPLE_BLOCK, data)
            i += len(group)
        if unknown_cluster:
            body += mkv._id(mkv.CLUSTER) + UNKNOWN + content
        else:
            body += element(mkv.CLUSTER, content)
    header = element(mkv.EBML, uint_element(0x4286, 1) + uint_element(0x42F7, 1)
                     + uint_element(0x42F2, 4) + uint_element(0x42F3, 8)
                     + element(mkv.DOC_TYPE, doc.encode()) + uint_element(0x4287, 4)
                     + uint_element(mkv.DOC_TYPE_READ_VERSION, read_version))
    segment = (mkv._id(mkv.SEGMENT) + UNKNOWN + body if unknown_segment
               else element(mkv.SEGMENT, body))
    with open(path, "wb") as f:
        f.write(header + segment)
