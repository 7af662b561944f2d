"""ISO base media files (MP4, and QuickTime .mov) in and out: the
demultiplexer and multiplexer of the demo's MPEG-4 video (and the
demultiplexer of its VP8, VP9, Motion-JPEG, PNG, JPEG 2000 and raw video
in MP4 and QuickTime).

The JAX package reads and writes video through cv2 (FFMPEG's libavformat);
the card's machine has neither. Only the first video track's sample table
is needed to hand each coded frame to data/mpeg4.py:

- `read_mp4(path)`: the top-level boxes in any order (`moov` before or
  after `mdat`, 64-bit box sizes), then the first track whose `hdlr` is
  `vide`: `mdhd`'s timescale, `stsd`'s first sample entry, mapped as
  libavformat's mov demuxer maps it (`_entry_codec`): `mp4v` by its
  `esds` objectTypeIndication (0x20 MPEG-4 Part 2 with the
  DecoderSpecificInfo, the VOS/VO/VOL headers; 0x6C Motion-JPEG, 0x6D PNG,
  0x6E JPEG 2000: cv2's .mp4 of those codecs); `vp08` or `vp09` with its
  `vpcC`, each sample a frame for data/vp8.py or data/vp9.py; QuickTime's
  `jpeg`, `mjpa`, `dmb1` (Motion-JPEG), `png `, `mjp2`, `RGBA` (raw) and
  `raw ` (by its depth; depth 12, cv2's I420 .mov, opens nothing: codec
  "none"); then riff.c's BMP fourccs (XVID and DIVX are MPEG-4 Part 2,
  their VOL in a `glbl` box, the tag passed on for libavcodec's XviD
  rule). Another entry such as `avc1` or `av01` raises naming it, as does
  an `mp4v` entry whose esds names another objectTypeIndication), `stts`, `stsc`, `stsz`, `stco` or
  `co64` and `stss`. Each frame's file offset and size follow from the
  chunk offsets and the samples each chunk holds. `fps` is what cv2's
  CAP_PROP_FPS gives (libavformat's avg_frame_rate: samples times the
  timescale over the summed durations) and the frame count its
  CAP_PROP_FRAME_COUNT (the sample count). The QuickTime brand (`qt  `)
  reads the same way.
- `Mp4Writer(path, fps)`: what cv2.VideoWriter's `mp4v` writes: `ftyp`
  (isom, minor 512, isom iso2 mp41), `free`, `mdat` with the samples in
  order, then `moov` (`mvhd`, and a `trak` of `tkhd`, `edts`/`elst`,
  `mdia` with `mdhd`, `hdlr` vide, `minf` with `vmhd`, `dinf`/`dref` and
  `stbl`: `stsd` -> `mp4v` -> `esds` + `btrt`, `stts`, `stss`, `stsc`,
  `stsz`, `stco`), the timescale libavformat's mov muxer picks (the frame
  rate's numerator doubled until it reaches 10000). cv2 reads it back.
"""

from __future__ import annotations

import dataclasses
import fractions
import os
import struct

MPEG4_VISUAL = 0x20     # esds objectTypeIndication of MPEG-4 Part 2
SAMPLE_ENTRY_NAMES = {
    b"avc1": "H.264 (avc1)", b"avc3": "H.264 (avc3)", b"hvc1": "HEVC (hvc1)",
    b"hev1": "HEVC (hev1)", b"av01": "AV1 (av01)", b"AVDJ": "Avid Motion-JPEG (AVDJ)",
    b"mjpb": "Motion-JPEG format B (mjpb)", b"s263": "H.263 (s263)",
    b"mp4s": "an MPEG-4 systems stream (mp4s)"}
# the esds objectTypeIndications of isom.c's ff_mp4_obj_type: the port's
# codec for those it decodes, a name for the others
OBJECT_CODECS = {MPEG4_VISUAL: "mpeg4", 0x6C: "mjpeg", 0x6D: "png", 0x6E: "jpeg2000"}
OBJECT_TYPES = {0x21: "H.264", 0x23: "HEVC", 0x6A: "MPEG-1 video", 0x60: "MPEG-2 video",
                0x61: "MPEG-2 video", 0x62: "MPEG-2 video", 0x63: "MPEG-2 video",
                0x64: "MPEG-2 video", 0x65: "MPEG-2 video", 0xA3: "VC-1", 0xA4: "Dirac",
                0xB1: "VP9"}
# the layouts libavcodec's rawvideo decoder gives a 'raw ' entry by its
# depth; at any other depth it finds none, and cv2 opens nothing (cv2's
# I420, IYUV and Y800 .mov, of depth 12)
RAW_DEPTHS = {1: "monob", 2: "pal8", 4: "pal8", 8: "pal8", 16: "rgb555be", 24: "rgb24",
              32: "argb", 33: "monow", 34: "pal8", 36: "pal8", 40: "gray"}
FILE_KINDS = ((b"RIFF", "a RIFF (AVI) file"), (b"\x1a\x45\xdf\xa3", "a Matroska/WebM file"))


@dataclasses.dataclass
class Mp4Movie:
    """An MP4's video track: `frames` holds each sample's (file offset,
    size) in decode order; `config` the esds DecoderSpecificInfo (or an
    XVID/DIVX entry's glbl); `codec` the port's codec ("none": cv2 opens
    nothing)."""

    path: str
    width: int
    height: int
    timescale: int
    durations: list
    frames: list
    keyframes: list
    codec: str = "mpeg4"
    config: bytes = b""
    brand: bytes = b""
    tag: bytes = b"mp4v"    # the sample entry, the codec tag libavcodec sees
    pix_fmt: str = ""       # a raw track's layout (data/rawvideo.py)

    @property
    def fps(self) -> float:
        """libavformat's avg_frame_rate: samples x timescale / duration."""
        total = sum(self.durations)
        if not total or not self.timescale:
            return 0.0
        frac = fractions.Fraction(len(self.durations) * self.timescale, total)
        return frac.numerator / frac.denominator

    def read_frame(self, f, i: int) -> bytes:
        offset, size = self.frames[i]
        f.seek(offset)
        return f.read(size)


def _boxes(f, start: int, end: int):
    """(type, body offset, body size) of each box in [start, end)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        size, kind = struct.unpack(">I4s", f.read(8))
        head = 8
        if size == 1:
            size = struct.unpack(">Q", f.read(8))[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"box {kind!r} at {pos} runs past its parent ({size} bytes)")
        yield kind, pos + head, size - head
        pos += size


def _find(f, start: int, size: int, kind: bytes):
    for k, body, n in _boxes(f, start, start + size):
        if k == kind:
            return body, n
    return None


def _read(f, where) -> bytes:
    f.seek(where[0])
    return f.read(where[1])


def file_kind(head: bytes) -> str | None:
    """What a file that is no ISO BMFF is, from its first bytes (None: an
    ISO BMFF)."""
    if head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip"):
        return None
    for magic, name in FILE_KINDS:
        if head.startswith(magic):
            return name
    return f"a file starting {head[:12]!r}"


def read_mp4(path: str) -> Mp4Movie:
    """The first video track of the MP4/QuickTime file at `path` (see the
    module docstring); ValueError for anything else."""
    end = os.path.getsize(path)
    with open(path, "rb") as f:
        kind = file_kind(f.read(12))
        if kind is not None:
            raise ValueError(f"{path}: not an MP4/QuickTime file but {kind}")
        brand, moov = b"", None
        for k, body, n in _boxes(f, 0, end):
            if k == b"ftyp":
                brand = _read(f, (body, 4))
            elif k == b"moov":
                moov = (body, n)
        if moov is None:
            raise ValueError(f"{path}: no moov box (an unfinished or fragmented file)")
        for k, body, n in _boxes(f, moov[0], moov[0] + moov[1]):
            if k != b"trak":
                continue
            mdia = _find(f, body, n, b"mdia")
            if mdia is None:
                continue
            hdlr = _find(f, *mdia, b"hdlr")
            if hdlr is None or _read(f, hdlr)[8:12] != b"vide":
                continue
            movie = _track(f, path, mdia)
            movie.brand = brand
            return movie
    raise ValueError(f"{path}: no video track")


def _track(f, path: str, mdia) -> Mp4Movie:
    mdhd = _read(f, _find(f, *mdia, b"mdhd"))
    timescale = struct.unpack(">I", mdhd[20:24] if mdhd[0] == 1 else mdhd[12:16])[0]
    minf = _find(f, *mdia, b"minf")
    stbl = _find(f, *minf, b"stbl") if minf else None
    if stbl is None:
        raise ValueError(f"{path}: a video track without a sample table")

    def box(kind, required=True):
        where = _find(f, *stbl, kind)
        if where is None:
            if required:
                raise ValueError(f"{path}: the video track has no {kind.decode()} box")
            return None
        return _read(f, where)

    stsd = box(b"stsd")
    entry_size, entry = struct.unpack(">I4s", stsd[8:16])
    body = stsd[16:8 + entry_size]
    width, height = struct.unpack(">HH", body[24:28])
    codec, config, pix_fmt = _entry_codec(path, entry, body)
    durations = []
    stts = box(b"stts")
    for i in range(struct.unpack(">I", stts[4:8])[0]):
        count, delta = struct.unpack(">II", stts[8 + 8 * i:16 + 8 * i])
        durations += [delta] * count
    stsz = box(b"stsz")
    fixed, count = struct.unpack(">II", stsz[4:12])
    sizes = ([fixed] * count if fixed else
             list(struct.unpack(f">{count}I", stsz[12:12 + 4 * count])))
    co = box(b"stco", required=False)
    if co is not None:
        n = struct.unpack(">I", co[4:8])[0]
        chunks = list(struct.unpack(f">{n}I", co[8:8 + 4 * n]))
    else:
        co = box(b"co64")
        n = struct.unpack(">I", co[4:8])[0]
        chunks = list(struct.unpack(f">{n}Q", co[8:8 + 8 * n]))
    stsc = box(b"stsc")
    runs = [struct.unpack(">III", stsc[8 + 12 * i:20 + 12 * i])
            for i in range(struct.unpack(">I", stsc[4:8])[0])]
    frames, k = [], 0
    for r, (first, per_chunk, _) in enumerate(runs):
        last = runs[r + 1][0] - 1 if r + 1 < len(runs) else len(chunks)
        for chunk in range(first - 1, last):
            offset = chunks[chunk]
            for _ in range(per_chunk):
                if k == len(sizes):
                    break
                frames.append((offset, sizes[k]))
                offset += sizes[k]
                k += 1
    if len(frames) != len(sizes):
        raise ValueError(f"{path}: the chunks hold {len(frames)} of {len(sizes)} samples")
    stss = box(b"stss", required=False)
    keyframes = (list(range(len(frames))) if stss is None else
                 [v - 1 for v in struct.unpack(f">{struct.unpack('>I', stss[4:8])[0]}I",
                                               stss[8:])])
    return Mp4Movie(path, width, height, timescale, durations[:len(frames)], frames,
                    keyframes, codec, config, tag=entry, pix_fmt=pix_fmt)


def _entry_codec(path: str, entry: bytes, body: bytes) -> tuple:
    """(codec, decoder configuration, raw layout) of a visual sample entry,
    as libavformat's mov demuxer maps it: `mp4v` by its esds
    objectTypeIndication; `vp08`, `vp09`; `raw ` by its depth (one that
    names no layout gives codec "none": cv2 opens nothing); then the
    fourccs of isom.c's QuickTime entries and riff.c's BMP tags, which
    utils/avi.py's fourcc_codec maps (`jpeg`, `mjpa`, `png `, `mjp2`,
    `RGBA`; XVID and DIVX are MPEG-4 Part 2, their VOL in a `glbl` or
    `esds` box). Anything else raises naming it."""
    from vision_kit_tpu_torch.data import rawvideo
    from vision_kit_tpu_torch.utils.avi import DECODED, fourcc_codec

    children = body[78:]
    if entry == b"mp4v":
        oti, config = _esds(path, children)
        if oti not in OBJECT_CODECS:
            name = OBJECT_TYPES.get(oti, f"objectTypeIndication 0x{oti:02x}")
            raise ValueError(f"{path}: the mp4v track holds {name}: the port decodes "
                             f"{DECODED} only")
        return OBJECT_CODECS[oti], config if oti == MPEG4_VISUAL else b"", ""
    if entry in (b"vp08", b"vp09"):
        _vpcc(path, children)
        return ("vp8" if entry == b"vp08" else "vp9"), b"", ""
    if entry == b"raw ":
        depth = struct.unpack(">H", body[74:76])[0]
        if depth not in RAW_DEPTHS:
            return "none", b"", ""
        raise ValueError(f"{path}: the video is QuickTime 'raw ' of depth {depth} "
                         f"({RAW_DEPTHS[depth]}): the port converts the layouts of "
                         "data/rawvideo.py's CONVERTED only")
    codec = None if entry in SAMPLE_ENTRY_NAMES else fourcc_codec(entry)
    if codec is None:
        name = SAMPLE_ENTRY_NAMES.get(entry, repr(entry.decode("latin-1")))
        raise ValueError(f"{path}: the video is {name}: the port decodes {DECODED} only")
    if codec == "mpeg4":
        return codec, _child(children, b"glbl") or _esds(path, children)[1], ""
    return codec, b"", rawvideo.fourcc_format(entry) if codec == "raw" else ""


def _child(boxes: bytes, kind: bytes) -> bytes:
    """The body of the first box `kind` among a sample entry's boxes."""
    pos = 0
    while pos + 8 <= len(boxes):
        size, k = struct.unpack(">I4s", boxes[pos:pos + 8])
        if size < 8:
            break
        if k == kind:
            return boxes[pos + 8:pos + size]
        pos += size
    return b""


def _vpcc(path: str, boxes: bytes):
    """The vpcC box of a vp08/vp09 entry (VP Codec ISO Media File Format
    Binding 2.2): (profile, level, bit depth, chroma subsampling, full
    range), or None where the entry has none (libavformat decodes the
    samples without it; the frames carry what the decoder reads)."""
    pos = 0
    while pos + 8 <= len(boxes):
        size, kind = struct.unpack(">I4s", boxes[pos:pos + 8])
        if size < 8:
            break
        if kind == b"vpcC":
            b = boxes[pos + 8:pos + size]
            if len(b) < 12 or b[0] != 1:
                raise ValueError(f"{path}: a vpcC box of version {b[0] if b else None} and "
                                 f"{len(b)} bytes (version 1 has 12 or more)")
            return b[4], b[5], b[6] >> 4, (b[6] >> 1) & 7, b[6] & 1
        pos += size
    return None


def _descriptor(data: bytes, pos: int) -> tuple:
    """(tag, body start, body end) of the MPEG-4 descriptor at pos."""
    tag, size, pos = data[pos], 0, pos + 1
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = size << 7 | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def _esds(path: str, boxes: bytes) -> tuple:
    """(objectTypeIndication, DecoderSpecificInfo) of an entry's esds box;
    (MPEG4_VISUAL, b"") without one."""
    data = _child(boxes, b"esds")[4:]
    if not data:
        return MPEG4_VISUAL, b""
    tag, p, end = _descriptor(data, 0)
    if tag != 3:
        return MPEG4_VISUAL, b""
    flags = data[p + 2]
    p += 3 + (2 if flags & 0x80 else 0) + (2 if flags & 0x20 else 0)
    if flags & 0x40:
        p += 1 + data[p]
    tag, p, end = _descriptor(data, p)
    if tag != 4:
        return MPEG4_VISUAL, b""
    oti = data[p]
    p += 13
    while p < end:
        tag, q, qend = _descriptor(data, p)
        if tag == 5:
            return oti, data[q:qend]
        p = qend
    return oti, b""


# -- the writer ------------------------------------------------------------

FTYP = b"isom" + struct.pack(">I", 512) + b"isomiso2mp41"
MOVIE_TIMESCALE = 1000
MAX_BOX = (1 << 32) - 1


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descr(tag: int, body: bytes) -> bytes:
    """An MPEG-4 descriptor with the 4-byte size libavformat writes."""
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F])
    return bytes([tag]) + size + body


MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class Mp4Writer:
    """MPEG-4 Part 2 samples into an MP4 laid out as cv2's mp4v writer
    lays it out (see the module docstring). `write(sample, keyframe,
    width, height, config)` appends one VOP; `config` (the VOS/VO/VOL
    headers) goes into the esds and is taken from the first call."""

    def __init__(self, path: str, fps: float):
        frac = fractions.Fraction(fps).limit_denominator(1001)
        if frac <= 0:
            raise ValueError(f"fps must be positive, got {fps}")
        self.path = path
        self.timescale = frac.numerator
        while self.timescale < 10000:
            self.timescale *= 2
        self.delta = self.timescale * frac.denominator // frac.numerator
        self.size = None
        self.config = b""
        self.sizes, self.keys = [], []
        self._f = open(path, "wb")
        self._f.write(_box(b"ftyp", FTYP) + _box(b"free"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4s", 8, b"mdat"))

    def write(self, sample: bytes, keyframe: bool, width: int, height: int,
              config: bytes = b"") -> None:
        if self.size is None:
            self.size, self.config = (width, height), bytes(config)
        elif self.size != (width, height):
            raise ValueError(f"frame of {width}x{height} in a {self.size[0]}x"
                             f"{self.size[1]} video")
        if self._f.tell() + len(sample) - self._mdat > MAX_BOX:
            raise ValueError(f"{self.path}: past the 4 GiB of a 32-bit mdat")
        if keyframe:
            self.keys.append(len(self.sizes) + 1)
        self.sizes.append(len(sample))
        self._f.write(sample)

    def _moov(self) -> bytes:
        n = len(self.sizes)
        width, height = self.size or (0, 0)
        media = n * self.delta
        movie = (media * MOVIE_TIMESCALE + self.timescale // 2) // self.timescale
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, MOVIE_TIMESCALE, movie),
                     struct.pack(">IH", 0x10000, 0x100), bytes(10), MATRIX, bytes(24),
                     struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie), bytes(8),
                     struct.pack(">HHHH", 0, 0, 0, 0), MATRIX,
                     struct.pack(">II", width << 16, height << 16))
        elst = _full(b"elst", 0, 0, struct.pack(">IIiI", 1, movie, 0, 0x10000))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, self.timescale, media),
                     struct.pack(">HH", 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"vide"), bytes(12),
                     b"VideoHandler\0")
        bitrate = (8 * sum(self.sizes) * self.timescale // max(media, 1)) if n else 0
        peak = max(self.sizes, default=0) * 8 * self.timescale // self.delta
        buffer = max(self.sizes, default=0)
        dcd = _descr(4, bytes([MPEG4_VISUAL, 0x11]) + buffer.to_bytes(3, "big")
                     + struct.pack(">II", peak, bitrate) + _descr(5, self.config))
        esds = _full(b"esds", 0, 0, _descr(3, struct.pack(">HB", 1, 0) + dcd
                                                + _descr(6, b"\x02")))
        btrt = _box(b"btrt", struct.pack(">III", buffer, peak, bitrate))
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1),
                     bytes(32), struct.pack(">Hh", 0x18, -1), esds, btrt)
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta) if n
                     else struct.pack(">I", 0))
        stss = (_full(b"stss", 0, 0, struct.pack(f">I{len(self.keys)}I", len(self.keys),
                                                *self.keys))
                if len(self.keys) < n else b"")
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1) if n
                     else struct.pack(">I", 0))
        stsz = _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self.sizes))
        stco = _full(b"stco", 0, 0, struct.pack(">II", 1, self._mdat + 8) if n
                     else struct.pack(">I", 0))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full(b"url ", 0, 1)))
        minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)), dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"edts", elst), _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)

    def close(self) -> None:
        if self._f is None:
            return
        f, self._f = self._f, None
        end = f.tell()
        f.write(self._moov())
        f.seek(self._mdat)
        f.write(struct.pack(">I", end - self._mdat))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
