"""Motion-JPEG, MPEG-4 Part 2, VP8, VP9, PNG, JPEG 2000 and raw video in
RIFF AVI: the demultiplexer and multiplexer of the demo's video mode.

The JAX package reads and writes video with cv2.VideoCapture and
cv2.VideoWriter; the card's machine has neither, nor any video codec. Every
frame of a Motion-JPEG AVI is a whole baseline JPEG, which the port decodes
(data/decode.py, nvJPEG on the card) and encodes (data/encode.py); an
MPEG-4 Part 2 AVI (fourcc FMP4, XVID, DIVX, DX50, mp4v, XVIX or another
of MPEG4_FOURCCS, in any case; cv2's mp4v writer names it mp4v) holds one
VOP a chunk, its
VOS/VOL headers in band before the first, which data/mpeg4.py decodes and
encodes. So only the container is needed here, and RIFF is plain:

- `read_avi(path)`: the header (avih, the video stream's strh and strf
  BITMAPINFOHEADER: width, height, dwRate / dwScale as the frame rate) and
  the file offset and size of each frame, walking `movi` (and the `movi` of
  OpenDML's AVIX continuation RIFFs, which FFMPEG writes past 1 GiB) in
  order: the `##dc` / `##db` chunks of the video stream, inside `LIST rec`
  groups too; JUNK, other streams and OpenDML `ix##` index chunks are
  skipped, and a zero-length chunk (a dropped frame) repeats the frame
  before it, as cv2's CAP_OPENCV_MJPEG reader gives it. idx1, where
  present, only cross-checks the walk. In a stream of another codec a
  zero-length chunk is dropped rather than repeated (the decoder has
  nothing to decode). The BITMAPINFOHEADER's fourcc picks the codec as
  libavformat's riff.c does (`fourcc_codec`, exact or in upper case):
  Motion-JPEG (MJPEG_FOURCCS: MJPG, JPGL, LJPG, jpeg, ...; the stream
  header's handler empty or one of them), MPEG-4 Part 2, VP8 (VP80, which
  cv2's VP80 writer gives an `.avi`; data/vp8.py decodes it), VP9 (VP90,
  data/vp9.py), PNG frames (MPNG, PNG1, png ), JPEG 2000 frames (MJ2C,
  mjp2, ...: one JP2 file a chunk) or raw video (data/rawvideo.py's
  AVI_FOURCCS, its layout in `pix_fmt`: a Y800 stream from cv2 holds I420
  planes, its grey frame their Y plane; UYVY and YUY2 streams from cv2
  hold packets too short for their layout, and give no frame). Anything
  else, or a file that is no RIFF AVI or holds no video stream, raises
  ValueError naming what it found. `tag` is the BITMAPINFOHEADER's
  fourcc, the codec tag libavcodec's MPEG-4 decoder reads.
- `AviWriter(path, fps, fourcc=b"MJPG")`: RIFF `AVI ` with `hdrl` (avih,
  strl: strh vids with the fourcc as its handler, and a BITMAPINFOHEADER
  of that fourcc: MJPG, or for MPEG-4 mp4v as cv2's mp4v writer writes
  it, or another of MPEG4_FOURCCS), `movi` of `00dc` chunks padded to
  even sizes, and an `idx1`
  (offsets from the `movi` fourcc, as cv2 writes them; the keyframe flag
  on the frames written as keyframes), the sizes and counts patched in on
  close. Both of cv2's readers (CAP_OPENCV_MJPEG, CAP_FFMPEG) read a
  Motion-JPEG file, CAP_FFMPEG an MPEG-4 one. It writes no OpenDML index,
  so a file stops at the 4 GiB that a RIFF size holds.
"""

from __future__ import annotations

import dataclasses
import fractions
import os
import struct

from vision_kit_tpu_torch.data import rawvideo
from vision_kit_tpu_torch.utils.logging_utils import logger

# the fourccs libavformat's riff.c maps to Motion-JPEG (any case; MJLS is
# JPEG-LS there, AVRn and AVDJ Avid's own decoder)
MJPEG_FOURCCS = (b"MJPG", b"LJPG", b"DMB1", b"MJPA", b"JR24", b"JPGL", b"JPEG", b"IJPG",
                 b"ACDV", b"QIVG", b"SLMJ", b"CJPG", b"IJLV", b"MVJP", b"AVI1", b"AVI2",
                 b"MTSJ", b"ZJPG", b"MMJP")
# riff.c's fourccs of PNG and JPEG 2000 frames (any case)
PNG_FOURCCS = (b"MPNG", b"PNG1", b"PNG ")
JPEG2000_FOURCCS = (b"MJP2", b"MJ2C", b"LJ2C", b"LJ2K", b"IPJ2", b"AVJ2")
# the fourccs libavformat's riff.c maps to MPEG-4 Part 2 that this cv2 reads
# and decodes as the port does (any case; GEOV and GEOX, GeoVision's, it
# decodes otherwise and the port refuses)
MPEG4_FOURCCS = (b"FMP4", b"XVID", b"DIVX", b"DX50", b"MP4V", b"XVIX", b"RMP4", b"ZMP4",
                 b"SIPP", b"MP4S", b"M4S2", b"DIV1", b"BLZ0", b"UMP4", b"WV1F", b"SEDG",
                 b"3IV2", b"WAWV", b"FFDS", b"FVFW", b"DCOD", b"MVXM", b"PM4V", b"SMP4",
                 b"DXGM", b"VIDM", b"M4T3", b"G264", b"HDX4", b"DM4V", b"DMK2", b"DYM4",
                 b"DIGI", b"EPHV", b"EM4A", b"M4CC", b"SN40", b"VSPX", b"ULDX", b"SM4V",
                 b"DREX", b"QMP4", b"PLV1", b"GLV4", b"GMP4", b"MNM4", b"GTM4")
# the fourcc libavformat's riff.c maps to VP8 (any case)
VP8_FOURCCS = (b"VP80",)
VP9_FOURCCS = (b"VP90",)
OTHER_FOURCCS = {b"H264": "H.264", b"X264": "H.264", b"AVC1": "H.264",
                 b"HEVC": "HEVC", b"H265": "HEVC", b"HVC1": "HEVC", b"DIV3": "MS MPEG-4 v3",
                 b"MP42": "MS MPEG-4 v2", b"MP43": "MS MPEG-4 v3", b"WMV3": "WMV9",
                 b"VP80": "VP8", b"VP90": "VP9", b"AV01": "AV1", b"H263": "H.263",
                 b"GEOV": "GeoVision MPEG-4", b"GEOX": "GeoVision MPEG-4"}
AVIF_HASINDEX, AVIF_ISINTERLEAVED, AVIF_TRUSTCKTYPE = 0x10, 0x100, 0x800
AVIIF_KEYFRAME = 0x10
RIFF_MAX = (1 << 32) - 1


@dataclasses.dataclass
class AviMovie:
    """An AVI's video stream: `frames` holds each frame's (file offset,
    size) in presentation order; `codec` is "mjpeg", "mpeg4" (whose
    headers come in band: `config` is empty), "vp8", "vp9", "png",
    "jpeg2000" or "raw" (its layout in `pix_fmt`)."""

    path: str
    width: int
    height: int
    rate: int
    scale: int
    frames: list
    codec: str = "mjpeg"
    config: bytes = b""
    tag: bytes = b""        # the BITMAPINFOHEADER's biCompression
    pix_fmt: str = ""       # a raw stream's layout (data/rawvideo.py)

    @property
    def fps(self) -> float:
        """dwRate / dwScale of the stream header; 0 when either is 0."""
        return self.rate / self.scale if self.rate and self.scale else 0.0

    def read_frame(self, f, i: int) -> bytes:
        """Frame i's JPEG bytes from the open file `f`."""
        offset, size = self.frames[i]
        f.seek(offset)
        return f.read(size)


def _fourcc_text(cc: bytes) -> str:
    return repr(cc.decode("latin-1"))


def _chunks(f, start: int, end: int):
    """(fourcc, body offset, size, list type or None) of each chunk in
    [start, end); a RIFF or LIST chunk's body starts after its type."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(12)
        if len(head) < 8:
            return
        cid, size = head[:4], struct.unpack("<I", head[4:8])[0]
        if cid in (b"RIFF", b"LIST") and len(head) == 12:
            yield cid, pos + 12, size - 4, head[8:12]
        else:
            yield cid, pos + 8, size, None
        pos += 8 + size + (size & 1)


def read_avi(path: str) -> AviMovie:
    """The video stream of the Motion-JPEG or MPEG-4 AVI at `path` (see the
    module docstring); ValueError for anything else."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            kind = ("an MP4/QuickTime file" if head[4:8] == b"ftyp" else
                    "a Matroska/WebM file" if head[:4] == b"\x1a\x45\xdf\xa3" else
                    f"a file starting {head[:12]!r}")
            raise ValueError(f"{path}: not a RIFF AVI but {kind}")
        header = None
        frames, sizes, idx1_sizes = [], [], None
        for cid, body, length, ltype in _chunks(f, 0, size):
            if cid != b"RIFF" or ltype not in (b"AVI ", b"AVIX"):
                continue
            for sub, sbody, slen, stype in _chunks(f, body, body + length):
                if sub == b"LIST" and stype == b"hdrl" and header is None:
                    header = _parse_hdrl(f, sbody, slen, path)
                elif sub == b"LIST" and stype == b"movi":
                    if header is None:
                        raise ValueError(f"{path}: movi before hdrl")
                    _walk_movi(f, sbody, slen, header["ids"], frames, sizes,
                               header["codec"] == "mjpeg")
                elif sub == b"idx1" and ltype == b"AVI ":
                    f.seek(sbody)
                    idx1_sizes = _idx1_sizes(f.read(slen), header["ids"] if header else ())
        if header is None:
            raise ValueError(f"{path}: RIFF AVI without an hdrl header")
    if idx1_sizes is not None:
        if idx1_sizes != sizes[:len(idx1_sizes)]:
            logger.warning("%s: idx1 lists %d video chunks that differ from the %d "
                           "in movi; reading movi's", path, len(idx1_sizes), len(sizes))
    return AviMovie(path, header["width"], header["height"], header["rate"],
                    header["scale"], frames, header["codec"], tag=header["tag"],
                    pix_fmt=header["pix_fmt"])


def _parse_hdrl(f, start: int, length: int, path: str) -> dict:
    """The first video stream's number, size, rate and scale; its fourccs
    checked."""
    for n, (cid, body, slen, ltype) in enumerate(
            c for c in _chunks(f, start, start + length)
            if c[0] == b"LIST" and c[3] == b"strl"):
        strh = strf = None
        for sub, sbody, sublen, _ in _chunks(f, body, body + slen):
            f.seek(sbody)
            if sub == b"strh":
                strh = f.read(sublen)
            elif sub == b"strf":
                strf = f.read(sublen)
        if strh is None or len(strh) < 32 or strh[:4] != b"vids":
            continue
        if strf is None or len(strf) < 20:
            raise ValueError(f"{path}: video stream {n} has no BITMAPINFOHEADER")
        handler, compression = strh[4:8], strf[16:20]
        codec, pix_fmt = fourcc_codec(compression), ""
        if codec == "mjpeg" and handler.strip(b"\0 ").upper() not in (b"", *MJPEG_FOURCCS):
            codec = None
        elif codec == "raw":
            pix_fmt = rawvideo.fourcc_format(compression)
        if codec is None:
            name = OTHER_FOURCCS.get(compression.upper(), "")
            raise ValueError(
                f"{path}: video stream {n} is {_fourcc_text(compression)}"
                f"{' (' + name + ')' if name else ''} (handler {_fourcc_text(handler)}): "
                f"the port decodes {DECODED} only")
        scale, rate = struct.unpack("<II", strh[20:28])
        width, height = struct.unpack("<ii", strf[4:12])
        ids = (f"{n:02d}dc".encode(), f"{n:02d}db".encode())
        return dict(width=width, height=abs(height), rate=rate, scale=scale, ids=ids,
                    codec=codec, tag=compression, pix_fmt=pix_fmt)
    raise ValueError(f"{path}: no video stream in the AVI header")


DECODED = "Motion-JPEG, MPEG-4 Part 2, VP8, VP9, PNG, JPEG 2000 and raw video"


def fourcc_codec(tag: bytes) -> str | None:
    """The port's codec for a BITMAPINFOHEADER fourcc, as libavformat's
    riff.c maps it (exact or upper case): "mjpeg", "mpeg4", "vp8", "vp9",
    "png", "jpeg2000", "raw" (data/rawvideo.py's AVI_FOURCCS), or None."""
    upper = tag.upper()
    for codec, tags in (("mjpeg", MJPEG_FOURCCS), ("mpeg4", MPEG4_FOURCCS),
                        ("vp8", VP8_FOURCCS), ("vp9", VP9_FOURCCS), ("png", PNG_FOURCCS),
                        ("jpeg2000", JPEG2000_FOURCCS)):
        if upper in tags:
            return codec
    return "raw" if rawvideo.fourcc_format(tag) else None


def _walk_movi(f, start: int, length: int, ids, frames: list, sizes: list,
               repeat: bool) -> None:
    """Append the (offset, size) of each video chunk of a movi list
    (descending into LIST rec groups) to `frames`, an empty chunk repeating
    the frame before it (none before the first frame) when `repeat`, else
    dropped, and each chunk's size to `sizes`."""
    for cid, body, size, ltype in _chunks(f, start, start + length):
        if cid == b"LIST" and ltype == b"rec ":
            _walk_movi(f, body, size, ids, frames, sizes, repeat)
        elif cid in ids:
            sizes.append(size)
            if size or (frames and repeat):
                frames.append((body, size) if size else frames[-1])


def _idx1_sizes(idx: bytes, ids) -> list:
    """The sizes of the video stream's entries of an idx1."""
    return [size for i in range(0, len(idx) - 15, 16)
            for cid, _, _, size in [struct.unpack("<4sIII", idx[i:i + 16])]
            if cid in ids]


class AviWriter:
    """Coded frames (JPEG bytes, or MPEG-4 VOPs with an MPEG-4 fourcc, the
    VOL headers before the first; all of one size) into a RIFF AVI."""

    def __init__(self, path: str, fps: float, fourcc: bytes = b"MJPG"):
        if not path.lower().endswith(".avi"):
            raise ValueError(f"{path}: name the output .avi")
        if fourcc != b"MJPG" and fourcc.upper() not in MPEG4_FOURCCS:
            raise ValueError(f"fourcc must be MJPG or an MPEG-4 one, got {fourcc!r}")
        self.fourcc = fourcc
        frac = fractions.Fraction(fps).limit_denominator(1001)
        if frac <= 0:
            raise ValueError(f"fps must be positive, got {fps}")
        self.path, self.rate, self.scale = path, frac.numerator, frac.denominator
        self.fps = float(fps)
        self.size = None
        self.index = []       # (offset from the movi fourcc, size, idx1 flags)
        self._f = open(path, "wb")
        self._f.write(self._header(0, 0, 0, 0))
        self._movi = self._f.tell() - 4            # the 'movi' fourcc
        self._max = 0

    def _header(self, width: int, height: int, n: int, largest: int) -> bytes:
        """RIFF and hdrl for n frames, and the head of LIST movi (its size
        patched on close)."""
        avih = struct.pack("<IIIIIIIIII4I", round(1e6 * self.scale / self.rate), 0, 0,
                           AVIF_HASINDEX | AVIF_ISINTERLEAVED | AVIF_TRUSTCKTYPE, n, 0,
                           1, largest, width, height, 0, 0, 0, 0)
        strh = (b"vids" + self.fourcc + struct.pack("<IHHIIIIIIIIHHHH", 0, 0, 0, 0, self.scale,
                                          self.rate, 0, n, largest, 0xFFFFFFFF, 0,
                                          0, 0, min(width, 0xFFFF), min(height, 0xFFFF)))
        strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, self.fourcc,
                           width * height * 3, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        return b"RIFF\0\0\0\0AVI " + hdrl + b"LIST\0\0\0\0movi"

    def write(self, jpeg: bytes, width: int, height: int, keyframe: bool = True) -> None:
        """Append one frame, `width` x `height` (every frame's must match
        the first's)."""
        if self.size is None:
            self.size = (width, height)
        elif self.size != (width, height):
            raise ValueError(f"frame of {width}x{height} in a {self.size[0]}x"
                             f"{self.size[1]} video")
        if self._f.tell() + 8 + len(jpeg) + 1 + 16 * (len(self.index) + 1) + 8 > RIFF_MAX:
            raise ValueError(f"{self.path}: past the 4 GiB of a RIFF without OpenDML")
        self.index.append((self._f.tell() - self._movi, len(jpeg),
                           AVIIF_KEYFRAME if keyframe else 0))
        self._f.write(_chunk(b"00dc", jpeg))
        self._max = max(self._max, len(jpeg))

    def close(self) -> None:
        if self._f is None:
            return
        f, self._f = self._f, None
        movi_end = f.tell()
        f.write(_chunk(b"idx1", b"".join(struct.pack("<4sIII", b"00dc", flags, off, size)
                                         for off, size, flags in self.index)))
        end = f.tell()
        width, height = self.size or (0, 0)
        f.seek(0)
        f.write(self._header(width, height, len(self.index), self._max))
        f.seek(4)
        f.write(struct.pack("<I", end - 8))
        f.seek(self._movi - 4)
        f.write(struct.pack("<I", movi_end - self._movi))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _chunk(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _list(ltype: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + ltype + body
