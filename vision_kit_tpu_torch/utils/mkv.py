"""Matroska (and WebM) in and out: the demultiplexer and multiplexer of the
demo's video mode.

The JAX package reads and writes video through cv2 (FFMPEG's libavformat),
so `demo -p clip.mkv -o out.mkv` reads and writes Matroska; the card's
machine has neither. Only the first video track's blocks are needed to
hand each coded frame to data/mpeg4.py or data/decode.py:

- `read_mkv(path)`: EBML elements with IDs and sizes of 1-8 bytes, a
  Segment and Clusters of unknown size (as a live writer leaves them: such
  an element ends where an element that cannot be its child begins), the
  EBML header (DocType matroska or webm, DocTypeReadVersion up to 3, what
  libavformat takes), `Info` (TimestampScale, Duration), `Tracks` (the
  first TrackEntry of TrackType 1: TrackNumber, CodecID, CodecPrivate,
  DefaultDuration, Video's PixelWidth and PixelHeight, ContentEncodings:
  header stripping and zlib compression, applied to every frame and, by
  their scope, to CodecPrivate; any other compression, or encryption,
  raises naming it), and the Clusters' SimpleBlocks and BlockGroups (a
  Block is a keyframe when its group has no ReferenceBlock) with no,
  Xiph, fixed-size or EBML lacing. The video track's frames come in block
  order. Codecs: `V_MPEG4/ISO/SP`, `ASP` and `AP` (MPEG-4 Part 2, the VOL
  in CodecPrivate), `V_MJPEG`, `V_VP8` (data/vp8.py), `V_VP9`
  (data/vp9.py), `V_UNCOMPRESSED` (raw video in the layout its Video
  ColourSpace fourcc names, data/rawvideo.py: cv2's I420, Y800 and RGBA
  .mkv; a Y800 track's blocks hold I420 planes, its frame their Y plane),
  and `V_MS/VFW/FOURCC`, whose CodecPrivate is a BITMAPINFOHEADER whose
  fourcc utils/avi.py's `fourcc_codec` routes (MPEG-4, Motion-JPEG, VP80,
  VP90, PNG or JPEG 2000 frames, raw; the bytes after its 40 are an
  MPEG-4 decoder configuration). Every other CodecID raises a ValueError
  naming it (AV1, H.264, HEVC, ...).
  `fps` is what cv2's CAP_PROP_FPS gives: 1e9 / DefaultDuration reduced
  as libavformat's av_reduce reduces it (denominators to 30000); without
  a DefaultDuration, an MPEG-4 track's VOL rate (time resolution over the
  fixed increment, or 1), else the standard rate libavformat's
  ff_rfps_calculate fits to the first 41 timestamps. `frame_count` is
  cv2's CAP_PROP_FRAME_COUNT (the Duration times fps, rounded), which
  equals the number of frames where the timestamps keep to that rate.
- `MkvWriter(path, fps)`: MPEG-4 Part 2 VOPs in the layout cv2's `mp4v`
  writer gives an `.mkv` (libavformat's matroskaenc): the EBML header
  (DocType matroska, version 4, read version 2), a Segment with a
  SeekHead, Info (TimestampScale 1 ms, the muxing and writing apps,
  Duration), Tracks (one `V_MPEG4/ISO/ASP` track, the encoder's VOS/VOL
  headers as CodecPrivate, DefaultDuration, the frame size), a Cluster at
  each keyframe of SimpleBlocks with the keyframe flag, and Cues (a cue
  point a keyframe). Sizes, Duration and the SeekHead are written at
  close. cv2 reads it back.
"""

from __future__ import annotations

import dataclasses
import fractions
import math
import os
import struct
import zlib

from vision_kit_tpu_torch.data import rawvideo
from vision_kit_tpu_torch.utils.avi import DECODED, OTHER_FOURCCS, fourcc_codec

# element IDs, with their marker bits
EBML, DOC_TYPE, DOC_TYPE_READ_VERSION = 0x1A45DFA3, 0x4282, 0x4285
SEGMENT, SEEK_HEAD, SEEK, SEEK_ID, SEEK_POSITION = 0x18538067, 0x114D9B74, 0x4DBB, 0x53AB, 0x53AC
INFO, TIMESTAMP_SCALE, DURATION = 0x1549A966, 0x2AD7B1, 0x4489
MUXING_APP, WRITING_APP = 0x4D80, 0x5741
TRACKS, TRACK_ENTRY, TRACK_NUMBER, TRACK_UID, TRACK_TYPE = 0x1654AE6B, 0xAE, 0xD7, 0x73C5, 0x83
FLAG_LACING, LANGUAGE, CODEC_ID, CODEC_PRIVATE = 0x9C, 0x22B59C, 0x86, 0x63A2
DEFAULT_DURATION, VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT = 0x23E383, 0xE0, 0xB0, 0xBA
COLOUR_SPACE = 0x2EB524
CONTENT_ENCODINGS, CONTENT_ENCODING = 0x6D80, 0x6240
CONTENT_ENCODING_SCOPE, CONTENT_ENCODING_TYPE = 0x5032, 0x5033
CONTENT_COMPRESSION, CONTENT_COMP_ALGO, CONTENT_COMP_SETTINGS = 0x5034, 0x4254, 0x4255
CONTENT_ENCRYPTION = 0x5035
CLUSTER, TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, BLOCK = 0x1F43B675, 0xE7, 0xA3, 0xA0, 0xA1
REFERENCE_BLOCK = 0xFB
CUES, CUE_POINT, CUE_TIME, CUE_TRACK_POSITIONS = 0x1C53BB6B, 0xBB, 0xB3, 0xB7
CUE_TRACK, CUE_CLUSTER_POSITION = 0xF7, 0xF1
VOID = 0xEC
# the children a Cluster of unknown size may hold (another ID ends it)
CLUSTER_CHILDREN = {TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, 0xA7, 0xAB, 0x5854, 0xAF, 0xBF,
                    VOID}

MPEG4_CODECS = ("V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP")
VFW = "V_MS/VFW/FOURCC"
RAW = "V_UNCOMPRESSED"
CODEC_NAMES = {
    "V_VP8": "VP8", "V_VP9": "VP9", "V_AV1": "AV1", "V_MPEG4/ISO/AVC": "H.264",
    "V_MPEGH/ISO/HEVC": "HEVC", "V_MPEG1": "MPEG-1 video", "V_MPEG2": "MPEG-2 video",
    "V_THEORA": "Theora", "V_MPEG4/MS/V3": "MS MPEG-4 v3",
    "V_QUICKTIME": "a QuickTime codec", "V_PRORES": "ProRes", "V_FFV1": "FFV1"}
COMP_ALGOS = {0: "zlib", 1: "bzlib", 2: "lzo", 3: "header stripping"}
MAX_READ_VERSION = 3        # libavformat refuses a DocTypeReadVersion above
RFPS_PACKETS = 41           # packets libavformat's stream probe reads for the rate


def _vint(data: bytes, pos: int, marker: bool) -> tuple:
    """(value, length) of the EBML variable-length integer at pos; an ID
    keeps its marker bit, a size drops it (None for an unknown size: all
    value bits set)."""
    first = data[pos]
    n = 1
    while n <= 8 and not first & (0x80 >> (n - 1)):
        n += 1
    if n > 8:
        raise ValueError(f"an EBML {'ID' if marker else 'size'} of more than 8 bytes")
    v = first if marker else first & (0xFF >> n)
    for k in range(1, n):
        v = v << 8 | data[pos + k]
    if not marker and v == (1 << (7 * n)) - 1:
        return None, n
    return v, n


def _uint(body: bytes) -> int:
    return int.from_bytes(body, "big") if body else 0


def _float(body: bytes) -> float:
    if len(body) == 4:
        return struct.unpack(">f", body)[0]
    if len(body) == 8:
        return struct.unpack(">d", body)[0]
    return 0.0


class _Reader:
    """Element headers over an open file of `size` bytes."""

    def __init__(self, f, size: int, path: str):
        self.f, self.size, self.path = f, size, path

    def header(self, pos: int) -> tuple:
        """(id, body offset, body size or None) of the element at pos."""
        self.f.seek(pos)
        head = self.f.read(16)
        if not head:
            raise ValueError(f"{self.path}: an element header past the end of the file")
        try:
            eid, n = _vint(head, 0, True)
            size, m = _vint(head, n, False)
        except (ValueError, IndexError) as e:
            raise ValueError(f"{self.path}: a damaged Matroska/WebM element header at "
                             f"{pos} ({e or 'truncated'})") from None
        return eid, pos + n + m, size

    def body(self, start: int, size: int) -> bytes:
        self.f.seek(start)
        return self.f.read(size)

    def children(self, start: int, end: int):
        """(id, body offset, body size or None) of each element in [start,
        end), up to the first of unknown size."""
        pos = start
        limit = min(end, self.size)
        while pos + 2 <= limit:
            eid, body, size = self.header(pos)
            yield eid, body, size
            if size is None:         # only a Segment or a Cluster may be unsized
                return
            pos = body + size

    def fields(self, start: int, size: int) -> dict:
        """{id: [body bytes]} of a master element's children."""
        out: dict = {}
        for eid, body, n in self.children(start, start + size):
            if n is None:
                raise ValueError(f"{self.path}: element {eid:#x} of unknown size")
            out.setdefault(eid, []).append(self.body(body, n))
        return out


@dataclasses.dataclass
class MkvMovie:
    """A Matroska file's first video track: `frames` holds each frame's
    (file offset, size) in block order, `keyframes` their flags, `times`
    their timestamps in TimestampScale units; `codec` the port's codec
    (utils/avi.py's names); `config` the decoder configuration (an MPEG-4 track's VOL
    headers); `tag` the codec tag libavcodec sees (a VFW track's fourcc,
    else empty); `encodings` the track's content encodings, (algorithm,
    settings) in the order they are undone."""

    path: str
    width: int
    height: int
    codec: str
    codec_id: str
    frames: list
    keyframes: list
    times: list
    timestamp_scale: int = 1000000
    default_duration: int = 0
    duration: float = 0.0
    config: bytes = b""
    tag: bytes = b""
    encodings: tuple = ()
    vol_rate: fractions.Fraction | None = None     # set by read_mkv for MPEG-4
    pix_fmt: str = ""       # a raw track's layout (data/rawvideo.py)

    @property
    def fps(self) -> float:
        """CAP_PROP_FPS as cv2 reads it (see the module docstring)."""
        if self.default_duration:
            num, den = _reduce(1000000000, self.default_duration, 30000)
            return num / den
        if self.vol_rate:
            return self.vol_rate.numerator / self.vol_rate.denominator
        return _rfps(self.times[:RFPS_PACKETS],
                     fractions.Fraction(self.timestamp_scale, 1000000000))

    @property
    def frame_count(self) -> int | None:
        """CAP_PROP_FRAME_COUNT as cv2 reads it: the Duration (to whole
        microseconds) times fps, rounded; None without a Duration."""
        if not self.duration:
            return None
        us = int(self.duration * self.timestamp_scale * 1000 / 1000000)
        return math.floor(us / 1e6 * self.fps + 0.5)

    def read_frame(self, f, i: int) -> bytes:
        """Frame i's coded bytes from the open file `f`, its content
        encodings undone."""
        offset, size = self.frames[i]
        f.seek(offset)
        return _decode(f.read(size), self.encodings)


def _decode(data: bytes, encodings: tuple) -> bytes:
    for algo, settings in encodings:
        data = settings + data if algo == 3 else zlib.decompress(data)
    return data


def read_mkv(path: str) -> MkvMovie:
    """The first video track of the Matroska/WebM file at `path` (see the
    module docstring); ValueError for anything else."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        r = _Reader(f, size, path)
        if f.read(4) != b"\x1a\x45\xdf\xa3":
            raise ValueError(f"{path}: not a Matroska/WebM file (no EBML header)")
        eid, body, n = r.header(0)
        if n is None:
            raise ValueError(f"{path}: an EBML header of unknown size")
        head = r.fields(body, n)
        doc = head.get(DOC_TYPE, [b"matroska"])[0].rstrip(b"\0").decode("latin-1")
        if doc not in ("matroska", "webm"):
            raise ValueError(f"{path}: EBML DocType {doc!r}, not matroska or webm")
        read_version = _uint(head.get(DOC_TYPE_READ_VERSION, [b"\1"])[0])
        if read_version > MAX_READ_VERSION:
            raise ValueError(f"{path}: DocTypeReadVersion {read_version} (libavformat "
                             f"reads up to {MAX_READ_VERSION})")
        pos = body + n
        segment = None
        for eid, sbody, ssize in r.children(pos, size):
            if eid == SEGMENT:
                segment = (sbody, ssize)
                break
        if segment is None:
            raise ValueError(f"{path}: no Segment")
        try:
            return _segment(r, doc, *segment)
        except (IndexError, struct.error, zlib.error) as e:
            raise ValueError(f"{path}: a damaged Matroska/WebM file ({e})") from None


def _segment(r: _Reader, doc: str, start: int, size: int | None) -> MkvMovie:
    limit = r.size if size is None else min(start + size, r.size)
    scale, duration, track = 1000000, 0.0, None
    frames, keys, times = [], [], []
    pos = start
    while pos + 2 <= limit:
        eid, body, n = r.header(pos)
        if eid == CLUSTER:
            if track is None:
                raise ValueError(f"{r.path}: a Cluster before the Tracks")
            end = _cluster_end(r, body, n)
            _cluster(r, body, end, track, frames, keys, times)
            pos = end
            continue
        if n is None:
            raise ValueError(f"{r.path}: element {eid:#x} of unknown size in the Segment")
        if eid == INFO:
            info = r.fields(body, n)
            scale = _uint(info.get(TIMESTAMP_SCALE, [b""])[0]) or 1000000
            duration = _float(info.get(DURATION, [b""])[0])
        elif eid == TRACKS and track is None:
            track = _video_track(r, body, n, doc)
        pos = body + n
    if track is None:
        raise ValueError(f"{r.path}: no video track")
    movie = MkvMovie(r.path, track["width"], track["height"], track["codec"],
                     track["codec_id"], frames, keys, times, scale,
                     track["default_duration"], duration, track["config"], track["tag"],
                     track["encodings"], pix_fmt=track["pix_fmt"])
    if movie.codec == "mpeg4":
        movie.vol_rate = _vol_rate(movie)
    return movie


def _vol_rate(movie: MkvMovie) -> fractions.Fraction | None:
    """The frame rate an MPEG-4 track's VOL gives libavcodec (from
    CodecPrivate, or in band before the first VOP)."""
    from vision_kit_tpu_torch.data import mpeg4

    data = movie.config
    if not data and movie.frames:
        with open(movie.path, "rb") as f:
            data = movie.read_frame(f, 0)
    try:
        vol = mpeg4.read_vol(data)
    except mpeg4.Mpeg4Error:
        return None
    return None if vol is None else fractions.Fraction(vol.time_resolution, vol.frame_ticks)


def _cluster_end(r: _Reader, start: int, size) -> int:
    """Where a Cluster's body ends (for an unknown size: where the first
    element that cannot be its child begins)."""
    if size is not None:
        return start + size
    pos = start
    while pos + 2 <= r.size:
        eid, body, n = r.header(pos)
        if eid not in CLUSTER_CHILDREN or n is None:
            return pos
        pos = body + n
    return r.size


def _video_track(r: _Reader, start: int, size: int, doc: str) -> dict:
    """The first TrackEntry of TrackType 1, its codec routed."""
    for eid, body, n in r.children(start, start + size):
        if eid != TRACK_ENTRY:
            continue
        entry = r.fields(body, n)
        if _uint(entry.get(TRACK_TYPE, [b""])[0]) != 1:
            continue
        width = height = 0
        encodings, colour_space = [], b""
        for sub, sbody, sn in r.children(body, body + n):
            if sub == VIDEO:
                v = r.fields(sbody, sn)
                width = _uint(v.get(PIXEL_WIDTH, [b""])[0])
                height = _uint(v.get(PIXEL_HEIGHT, [b""])[0])
                colour_space = v.get(COLOUR_SPACE, [b""])[0]
            elif sub == CONTENT_ENCODINGS:
                encodings = [_encoding(r, ebody, en)
                             for eid2, ebody, en in r.children(sbody, sbody + sn)
                             if eid2 == CONTENT_ENCODING]
        if len(encodings) > 1:
            raise ValueError(f"{r.path}: {len(encodings)} combined content encodings on "
                             "the video track (libavformat undoes one)")
        codec_id = entry.get(CODEC_ID, [b""])[0].rstrip(b"\0").decode("latin-1")
        private = entry.get(CODEC_PRIVATE, [b""])[0]
        private = _decode(private, tuple((a, st) for scope, a, st in encodings if scope & 2))
        codec, config, tag, size_hint = _codec(r.path, codec_id, private, colour_space)
        if not (width and height) and size_hint:
            width, height = size_hint
        return {"number": _uint(entry.get(TRACK_NUMBER, [b""])[0]), "codec_id": codec_id,
                "codec": codec, "config": config, "tag": tag, "width": width,
                "height": height, "pix_fmt": rawvideo.fourcc_format(tag) if codec == "raw"
                else "",
                "encodings": tuple((a, st) for scope, a, st in encodings if scope & 1),
                "default_duration": _uint(entry.get(DEFAULT_DURATION, [b""])[0])}
    kind = "WebM" if doc == "webm" else "Matroska"
    raise ValueError(f"{r.path}: a {kind} file without a video track")


def _encoding(r: _Reader, start: int, size: int) -> tuple:
    """(scope, algorithm, settings) of one ContentEncoding; ValueError for
    encryption or a compression other than zlib and header stripping."""
    fields = r.fields(start, size)
    scope = _uint(fields.get(CONTENT_ENCODING_SCOPE, [b"\1"])[0])
    if _uint(fields.get(CONTENT_ENCODING_TYPE, [b""])[0]) != 0 or CONTENT_ENCRYPTION in fields:
        raise ValueError(f"{r.path}: the video track is encrypted (ContentEncryption): "
                         "the port reads no encrypted track")
    algo, settings = 0, b""
    for eid, body, n in r.children(start, start + size):
        if eid == CONTENT_COMPRESSION:
            comp = r.fields(body, n)
            algo = _uint(comp.get(CONTENT_COMP_ALGO, [b""])[0])
            settings = comp.get(CONTENT_COMP_SETTINGS, [b""])[0]
    if algo not in (0, 3):
        raise ValueError(f"{r.path}: the video track is compressed with "
                         f"{COMP_ALGOS.get(algo, f'ContentCompAlgo {algo}')}: the port "
                         "undoes zlib and header stripping only")
    return scope, algo, settings


def _codec(path: str, codec_id: str, private: bytes, colour_space: bytes = b"") -> tuple:
    """(codec, decoder configuration, codec tag, (width, height) or None)
    of a video track; ValueError naming a codec the port does not decode.
    A V_UNCOMPRESSED track's tag is its ColourSpace fourcc."""
    if codec_id in MPEG4_CODECS:
        return "mpeg4", private, b"", None
    if codec_id in ("V_MJPEG", "V_VP8", "V_VP9"):
        return codec_id[2:].lower(), b"", b"", None
    if codec_id == RAW:
        if rawvideo.fourcc_format(colour_space) is None:
            raise ValueError(f"{path}: the video is {RAW!r} (raw video) of ColourSpace "
                             f"{colour_space!r}: the port reads the layouts of "
                             "data/rawvideo.py's AVI_FOURCCS only")
        return "raw", b"", colour_space, None
    if codec_id == VFW:
        if len(private) < 40:
            raise ValueError(f"{path}: a {VFW} track without a BITMAPINFOHEADER")
        width, height = struct.unpack("<ii", private[4:12])
        tag = private[16:20]
        codec = fourcc_codec(tag)
        if codec is not None:
            return codec, private[40:] if codec == "mpeg4" else b"", tag, (width, abs(height))
        name = OTHER_FOURCCS.get(tag.upper(), "")
        raise ValueError(f"{path}: the video is {VFW} {tag.decode('latin-1')!r}"
                         f"{' (' + name + ')' if name else ''}: the port decodes {DECODED} "
                         "only")
    name = CODEC_NAMES.get(codec_id)
    raise ValueError(f"{path}: the video is {codec_id!r}{' (' + name + ')' if name else ''}: "
                     f"the port decodes {DECODED} only")


def _cluster(r: _Reader, start: int, end: int, track: dict, frames: list, keys: list,
             times: list) -> None:
    """Append the video track's frames of the Cluster whose body is [start,
    end)."""
    base = 0
    for eid, body, n in r.children(start, end):
        if eid == TIMESTAMP:
            base = _uint(r.body(body, n))
        elif eid == SIMPLE_BLOCK:
            _block(r, body, n, track, base, None, frames, keys, times)
        elif eid == BLOCK_GROUP:
            group = None
            refs = False
            for gid, gbody, gn in r.children(body, body + n):
                if gid == BLOCK and group is None:
                    group = (gbody, gn)
                elif gid == REFERENCE_BLOCK:
                    refs = True
            if group is not None:
                _block(r, *group, track, base, not refs, frames, keys, times)


def _block(r: _Reader, start: int, size: int, track: dict, base: int, key,
           frames: list, keys: list, times: list) -> None:
    """One SimpleBlock's (key None: its flag says) or Block's frames."""
    head = r.body(start, min(size, 16))
    number, n = _vint(head, 0, False)
    if number != track["number"]:
        return
    rel, flags = struct.unpack(">hB", head[n:n + 3])
    is_key = bool(flags & 0x80) if key is None else key
    pos = start + n + 3
    lacing = (flags >> 1) & 3
    if lacing == 0:
        spans = [(pos, start + size - pos)]
    else:
        spans = _laces(r.body(pos, start + size - pos), pos, lacing, r.path)
    for span in spans:
        frames.append(span)
        keys.append(is_key)
        times.append(base + rel)


def _laces(data: bytes, pos: int, lacing: int, path: str) -> list:
    """(offset, size) of each frame of a laced block whose data (after its
    flags) starts at file offset `pos`: Xiph (1), fixed-size (2) or EBML
    (3) lacing."""
    count = data[0] + 1
    p = 1
    sizes = []
    if lacing == 1:
        for _ in range(count - 1):
            v = 0
            while True:
                b = data[p]
                p += 1
                v += b
                if b != 255:
                    break
            sizes.append(v)
    elif lacing == 3:
        first, k = _vint(data, p, False)
        p += k
        sizes.append(first)
        for _ in range(count - 2):
            raw, k = _vint(data, p, False)
            p += k
            sizes.append(sizes[-1] + raw - ((1 << (7 * k - 1)) - 1))
    rest = len(data) - p
    if lacing == 2:
        if rest % count:
            raise ValueError(f"{path}: a fixed-size lace of {rest} bytes in {count} frames")
        sizes = [rest // count] * count
    else:
        sizes.append(rest - sum(sizes))
    if min(sizes) < 0:
        raise ValueError(f"{path}: a laced block whose frames run past its end")
    out = []
    for s in sizes:
        out.append((pos + p, s))
        p += s
    return out


# -- libavformat's frame rate ----------------------------------------------------

def _reduce(num: int, den: int, limit: int) -> tuple:
    """av_reduce: num / den as the nearest fraction with both terms up to
    `limit` (its continued-fraction walk)."""
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    if num <= limit and den <= limit:
        return num, den
    while den:
        x = num // den
        next_den = num - den * x
        a2n, a2d = x * a1n + a0n, x * a1d + a0d
        if a2n > limit or a2d > limit:
            if a1n:
                x = (limit - a0n) // a1n
            if a1d:
                x = min(x, (limit - a0d) // a1d)
            if den * (2 * x * a1d + a0d) > num * a1d:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, next_den
    return a1n, a1d


def _std_rate(i: int) -> int:
    """libavformat's get_std_framerate(i), in frames per 12 * 1001 s."""
    if i < 30 * 12:
        return (i + 1) * 1001
    i -= 30 * 12
    if i < 30:
        return (i + 31) * 1001 * 12
    i -= 30
    if i < 3:
        return (80, 120, 240)[i] * 1001 * 12
    return (24, 30, 60, 12, 15, 48)[i - 3] * 1000 * 12


STD_RATES = [_std_rate(i) for i in range(30 * 12 + 30 + 3 + 6)]


def _rfps(times: list, time_base: fractions.Fraction) -> float:
    """The r_frame_rate libavformat's ff_rfps_add_frame / ff_rfps_calculate
    fit to a video stream's timestamps (in `time_base` units; 0 when none
    fits): the standard rate, at least 0.8 times the mean rate, whose
    frame grid the timestamps miss least (variance under 0.01), or with 16
    durations or more whose gcd exceeds a 500th of a second's ticks, the
    gcd's rate."""
    n_rates = len(STD_RATES)
    err = [[[0.0] * n_rates, [0.0] * n_rates], [[0.0] * n_rates, [0.0] * n_rates]]
    tb = time_base.numerator / time_base.denominator
    count = dsum = gcd = 0
    last = None
    for ts in times:
        if last is not None and ts > last:
            dts = ts * tb
            for i, rate in enumerate(STD_RATES):
                if err[0][1][i] < 1e10:
                    sdts = dts * rate / (1001 * 12)
                    for j in (0, 1):
                        e = sdts - round(sdts + j * 0.5) + j * 0.5
                        err[j][0][i] += e
                        err[j][1][i] += e * e
            count += 1
            dsum += ts - last
            if count % 10 == 0:
                for i in range(n_rates):
                    if err[0][1][i] < 1e10:
                        a0, a1 = err[0][0][i] / count, err[1][0][i] / count
                        if (err[0][1][i] / count - a0 * a0 > 0.04
                                and err[1][1][i] / count - a1 * a1 > 0.04):
                            err[0][1][i] = err[1][1][i] = 2e10
            if count > 3:
                gcd = math.gcd(gcd, ts - last)
        last = ts
    if (count > 15 and gcd > max(1, time_base.denominator // (500 * time_base.numerator))):
        num, den = _reduce(time_base.denominator, time_base.numerator * gcd, (1 << 31) - 1)
        return num / den
    if count <= 1:
        return 0.0
    best, pick = 0.01, 0
    mean = tb * dsum / count
    for j, rate in enumerate(STD_RATES):
        if rate < 1001 * 12 or mean < (1001 * 12.0 * 0.8) / rate:
            continue
        for k in (0, 1):
            a = err[k][0][j] / count
            e = err[k][1][j] / count - a * a
            if e < best and best > 0.000000001:
                best, pick = e, rate
    if pick and pick / (12 * 1001) < 1.01 / tb:
        num, den = _reduce(pick, 12 * 1001, (1 << 31) - 1)
        return num / den
    return 0.0


# -- the writer ------------------------------------------------------------------

MUXER = b"Lavf62.12.101"       # the muxing and writing apps cv2's libavformat names
SEEK_HEAD_ROOM = 96            # the SeekHead's placeholder (a Void where unused)


def _id(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _size(n: int, width: int = 0) -> bytes:
    """An EBML size, in `width` bytes (0: the fewest)."""
    if not width:
        width = 1
        while n >= (1 << (7 * width)) - 1:
            width += 1
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def element(eid: int, body: bytes) -> bytes:
    """One EBML element."""
    return _id(eid) + _size(len(body)) + body


def uint_element(eid: int, v: int) -> bytes:
    return element(eid, v.to_bytes(max((v.bit_length() + 7) // 8, 1), "big"))


def _void(n: int) -> bytes:
    """A Void element of exactly n >= 2 bytes."""
    if n < 10:
        return bytes([VOID, 0x80 | (n - 2)]) + bytes(n - 2)
    return bytes([VOID]) + _size(n - 9, 8) + bytes(n - 9)


class MkvWriter:
    """MPEG-4 Part 2 VOPs into a Matroska file laid out as cv2's mp4v writer
    lays it out (see the module docstring). `write(sample, keyframe,
    width, height, config)` appends one VOP; `config` (the VOS/VO/VOL
    headers) becomes CodecPrivate and is taken from the first call."""

    def __init__(self, path: str, fps: float):
        frac = fractions.Fraction(fps).limit_denominator(1001)
        if frac <= 0:
            raise ValueError(f"fps must be positive, got {fps}")
        self.path, self.rate = path, frac
        self.default_duration = 1000000000 * frac.denominator // frac.numerator
        self.frame_ms = round(1000 / frac)
        self.size = None
        self.n = 0
        self.cues = []                  # (time, cluster offset in the segment)
        self._cluster = None            # (offset of its size field, body start, time)
        self._f = open(path, "wb")
        header = element(EBML, uint_element(0x4286, 1) + uint_element(0x42F7, 1)
                         + uint_element(0x42F2, 4) + uint_element(0x42F3, 8)
                         + element(DOC_TYPE, b"matroska") + uint_element(0x4287, 4)
                         + uint_element(DOC_TYPE_READ_VERSION, 2))
        self._f.write(header + _id(SEGMENT) + _size(0, 8))
        self._segment = self._f.tell()
        self._f.write(_void(SEEK_HEAD_ROOM))

    def _time(self, i: int) -> int:
        """Frame i's timestamp in ms, as libavformat rescales it."""
        return int(fractions.Fraction(1000 * i) / self.rate + fractions.Fraction(1, 2))

    def _head(self, width: int, height: int, config: bytes) -> None:
        """Info and Tracks, before the first Cluster."""
        self._info = self._f.tell()
        info = element(INFO, uint_element(TIMESTAMP_SCALE, 1000000)
                       + element(MUXING_APP, MUXER) + element(WRITING_APP, MUXER)
                       + element(DURATION, struct.pack(">d", 0.0)))
        video = element(VIDEO, uint_element(PIXEL_WIDTH, width)
                        + uint_element(PIXEL_HEIGHT, height))
        entry = element(TRACK_ENTRY, uint_element(TRACK_NUMBER, 1)
                        + uint_element(TRACK_UID, 1) + uint_element(FLAG_LACING, 0)
                        + element(LANGUAGE, b"und") + element(CODEC_ID, b"V_MPEG4/ISO/ASP")
                        + uint_element(TRACK_TYPE, 1)
                        + uint_element(DEFAULT_DURATION, self.default_duration) + video
                        + element(CODEC_PRIVATE, bytes(config)))
        self._tracks = self._info + len(info)
        self._duration_at = self._tracks - 8         # Duration's float, the last field
        self._f.write(info + element(TRACKS, entry))

    def write(self, sample: bytes, keyframe: bool, width: int, height: int,
              config: bytes = b"") -> None:
        if self.size is None:
            self.size = (width, height)
            self._head(width, height, config)
        elif self.size != (width, height):
            raise ValueError(f"frame of {width}x{height} in a {self.size[0]}x"
                             f"{self.size[1]} video")
        t = self._time(self.n)
        if self._cluster is None or keyframe or t - self._cluster[2] > 32767:
            self._close_cluster()
            offset = self._f.tell()
            self._f.write(_id(CLUSTER) + _size(0, 8))
            self._cluster = (offset + 4, self._f.tell(), t)
            self._f.write(uint_element(TIMESTAMP, t))
            if keyframe:
                self.cues.append((t, offset - self._segment))
        block = b"\x81" + struct.pack(">hB", t - self._cluster[2], 0x80 if keyframe else 0)
        self._f.write(element(SIMPLE_BLOCK, block + bytes(sample)))
        self.n += 1

    def _close_cluster(self) -> None:
        if self._cluster is None:
            return
        size_at, body, _ = self._cluster
        end = self._f.tell()
        self._f.seek(size_at)
        self._f.write(_size(end - body, 8))
        self._f.seek(end)
        self._cluster = None

    def close(self) -> None:
        if self._f is None:
            return
        if self.size is None:
            self._head(0, 0, b"")
        self._close_cluster()
        f = self._f
        cues_at = f.tell()
        points = b"".join(
            element(CUE_POINT, uint_element(CUE_TIME, t) + element(
                CUE_TRACK_POSITIONS, uint_element(CUE_TRACK, 1)
                + uint_element(CUE_CLUSTER_POSITION, pos)))
            for t, pos in self.cues)
        f.write(element(CUES, points))
        end = f.tell()
        duration = float(self._time(self.n - 1) + self.frame_ms) if self.n else 0.0
        f.seek(self._duration_at)
        f.write(struct.pack(">d", duration))
        seeks = b"".join(
            element(SEEK, element(SEEK_ID, _id(eid)) + uint_element(SEEK_POSITION, pos))
            for eid, pos in ((INFO, self._info - self._segment),
                             (TRACKS, self._tracks - self._segment),
                             (CUES, cues_at - self._segment)))
        head = element(SEEK_HEAD, seeks)
        f.seek(self._segment)
        f.write(head + _void(SEEK_HEAD_ROOM - len(head)))
        f.seek(self._segment - 8)
        f.write(_size(end - self._segment, 8))
        f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
