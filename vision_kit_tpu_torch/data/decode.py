"""Image decode without OpenCV: a plain JPEG/PNG/BMP/WebP decoder on the
host and nvJPEG on the card.

Counterpart of the `cv2.imdecode(..., IMREAD_COLOR)` + `cvtColor(BGR2RGB)`
in vision_kit_tpu/serve.py:decode_request_bytes (and of native/vkio.cpp's
memory decode). The card's machine has no OpenCV, PIL or torchvision, so the
port decodes on its own:

- `decode_image(data)`: numpy and the standard library, equal to
  libjpeg-turbo 3.1 and OpenCV 5 (as cv2 runs them) bit for bit.
  JPEG: baseline, extended sequential and progressive Huffman, 8-bit, 1, 3
  or 4 components, sampling factors up to 4 (4:4:4, 4:2:2, 4:2:0, 4:4:0,
  4:1:1), restart intervals; a sequential scan's Huffman slot 0 or 1
  that no DHT defines takes jstdhuff.c's standard table, as jdhuff.c
  gives it (Motion-JPEG frames carry none; a progressive file takes none,
  as jdphuff.c). Arithmetic-coded sequential and progressive scans (SOF9,
  SOF10, DAC conditioning) through data/jpeg_arith.py (jdarith.c), and
  lossless frames (SOF3) through data/jpeg_lossless.py (jdlhuff.c,
  jdlossls.c), which decode only where libjpeg's lossless mode converts
  their colour to cv2's (RGB, and CMYK then OpenCV's CMYK -> BGR; a grey
  or YCbCr one gives None, as cv2 does). The integer `islow` IDCT of
  jidctint.c as libjpeg-turbo's AVX2 code runs it (16-bit dequantising,
  word adds and saturating packs, which only corrupt data reaches),
  libjpeg's "fancy" triangle upsampling (h2v1, h2v2, h1v2, with its
  biases; box replication where libjpeg takes it: other factors, and a
  chroma plane at most 2 wide), jdcolor.c's fixed-point YCbCr tables. Progressive scans follow
  jdphuff.c (DC and AC first scans with EOBRUN, their refinements); when
  the scans leave some of the first ten coefficients' bits unknown (a file
  that ends early), jdcoefct.c's 5x5 block smoothing (libjpeg-turbo 2.1
  on) estimates them, with the coefficient bits from before the last scan
  past the last iMCU row it began to decode. Colour as libjpeg assumes it
  (jpeg_colour): YCbCr, grey, RGB (Adobe transform 0, or 'R','G','B'
  ids), CMYK and YCCK (jdcolor.c's ycck_cmyk_convert), the last two then
  OpenCV's CMYK -> BGR. A restart interval that runs out of data before a
  marker leaves the rest of its MCUs as they are (grey in a sequential
  scan), as libjpeg does. Bytes that end inside a scan with no marker
  after it: libjpeg suspends for more input, which OpenCV cannot give, so
  cv2 gives None, unless the scan is the file's only one and its entropy
  decoder never reads past the bytes: jdhuff.c's 64-bit bit buffer
  (_suspends: decode_mcu_fast's 6-byte loads while 512 bytes a block are
  left, then jpeg_fill_bit_buffer's fills to 57 bits), jdarith.c's byte
  reads. 12-bit, arithmetic lossless (SOF11) and hierarchical JPEGs give
  None, as cv2 does. PNG through zlib: colour types 0/2/3/4/6, bit depths
  1/2/4/8/16 (16 keeps the high byte, as cv2 does), Adam7 interlacing,
  alpha dropped. BMP as grfmt_bmp.cpp reads it: header sizes 12 and 36 on,
  1/4/8-bit palettes, 16-bit 5-5-5 and 5-6-5, 24-bit, 32-bit (the fourth
  byte dropped), RLE8 and RLE4, bottom-up and top-down rows. WebP (lossy
  VP8, lossless VP8L, VP8X with alpha, ICC and EXIF, an animation's first
  frame) through data/webp.py. Netpbm P1-P6 and PAM (data/pxm.py), PFM
  (data/pfm.py), Sun raster (data/sunras.py), Radiance HDR (data/hdr.py),
  a GIF's first frame (data/gif.py) and a TIFF's first page (data/tiff.py,
  with data/ccitt.py for Group 4), each as OpenCV 5's own decoder (and
  for TIFF its libtiff 4.7.1) gives it, quirks included. JPEG 2000 (a JP2
  file or a raw J2K codestream) through data/jp2.py, as OpenCV's OpenJPEG
  2.5.3 decoder gives it. The EXIF
  orientation (a JPEG's APP1, a PNG's eXIf, a WebP's EXIF chunk, a TIFF's
  tag 274) is applied as cv2 applies it. An image
  over OpenCV's size limits (a side over 1 << 20, more than 1 << 30
  pixels; size_refusal) is refused, whatever its kind, before any
  allocation its header sizes, where cv2.imdecode raises; so is a JPEG
  with a side over libjpeg's 65500.
- `decode_jpeg_reduced(data, scale)`: the same JPEG decode at 1/2, 1/4 or
  1/8 scale, cv2.imread(IMREAD_REDUCED_COLOR_<scale>) bit for bit:
  libjpeg-turbo's DCT scaling (jdmaster.c's per-component IDCT sizes,
  jidctred.c's 4x4, 2x2 and 1x1 IDCTs, upsampling at the reduced sizes,
  plain replication at 1/8), block smoothing too; OpenCV's size limits
  apply at the reduced size, as cv2 applies them. A lossless JPEG comes
  out at its full size, as libjpeg does not scale it. `probe_jpeg(data)`
  reads a JPEG's size and whether it holds EXIF from its header, as the
  JAX package's data.fast_decode gate does.
- `decode_truncated_jpeg(data)`: what Pillow's LOAD_TRUNCATED_IMAGES read
  gives for JPEG bytes without their EOI marker (the JAX package's
  integrity scan restores such a file from it; data/datasets.py).
- `scans_short(data)`: for each scan of a JPEG, how many MCUs need bits
  past its entropy-coded data (the plain decoder's own walks, no IDCT);
  `walk_scans_short(data)` the same counts from the host C walk of
  csrc/jpeg_walk.cu, which the card's route runs on every JPEG.
- `decode_to(data, device)`: the route its header picks (`decode_route`;
  on the card also the C walk, no IDCT), counted in `route_counts`. An
  arithmetic-coded JPEG ("host_arith") and a lossless one
  ("host_lossless") decode with decode_image on the host on any device,
  and so does a one-scan JPEG that the bytes end inside ("host_cut"). On
  the card a baseline, extended or progressive JPEG in YCbCr or grey whose
  scans complete every coefficient goes to nvJPEG (csrc/jpeg_decode.cu, `decode_jpeg_cuda`,
  pixels within NVJPEG_TOLERANCE of the plain decoder's), unless the C
  walk finds a scan that runs out of bits ("host_cut": libjpeg reads the
  missing bits as zeros, nvJPEG does not); the standard Huffman tables of
  an undefined sequential slot 0 or 1 are spliced in as a DHT segment
  before nvJPEG reads it (with_standard_tables); a progressive JPEG that leaves
  bits unknown (libjpeg smooths it, nvJPEG does not), a CMYK, YCCK or RGB
  JPEG, a PNG, a BMP, a WebP and every other kind above (no library on
  the card decodes them) decode with decode_image on the host and are
  uploaded, each on its own route ("host_<kind>"). A JPEG that
  nvJPEG refuses is not handed to the host. The orientation transform is
  `apply_orientation` (torch flips and transposes).

The Huffman walks are the only Python loops here (a progressive
refinement's correction bits gathered and applied with numpy; the
arithmetic decoder and the lossless predictors 6 and 7 are loops too, in
their modules); the IDCT, smoothing, upsampling, colour conversion and PNG
filters (but Average and Paeth, which are serial along a row) are numpy
over whole planes, as is BMP but for its RLE commands. data/webp.py says how WebP's loops split.
"""

from __future__ import annotations

import ctypes
import functools
import queue
import re
import struct
import threading
import zlib

import numpy as np
import torch

# -- EXIF orientation ------------------------------------------------------


def parse_exif_orientation(tiff: bytes) -> int:
    """Tag 0x0112 of IFD0 of a TIFF-structured EXIF block; 1 when absent or
    malformed."""
    try:
        if tiff[:2] == b"II":
            end = "<"
        elif tiff[:2] == b"MM":
            end = ">"
        else:
            return 1
        if struct.unpack(end + "H", tiff[2:4])[0] != 42:
            return 1
        ifd = struct.unpack(end + "I", tiff[4:8])[0]
        n = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
        for i in range(n):
            off = ifd + 2 + 12 * i
            tag, typ, count = struct.unpack(end + "HHI", tiff[off:off + 8])
            if tag == 0x0112 and typ == 3 and count >= 1:
                return struct.unpack(end + "H", tiff[off + 8:off + 10])[0]
    except (struct.error, IndexError):
        pass
    return 1


def apply_orientation(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """(H, W, C) image in stored order -> visual order for EXIF orientation
    1-8 (cv2's ApplyExifOrientation); other values leave it as it is."""
    if orientation == 2:
        img = img.flip(1)
    elif orientation == 3:
        img = img.flip(0, 1)
    elif orientation == 4:
        img = img.flip(0)
    elif orientation in (5, 6, 7, 8):
        img = img.transpose(0, 1)
        if orientation == 6:
            img = img.flip(1)
        elif orientation == 7:
            img = img.flip(0, 1)
        elif orientation == 8:
            img = img.flip(0)
    return img.contiguous()


# -- OpenCV's size limits --------------------------------------------------

# loadsave.cpp's validateInputImageSize: CV_IO_MAX_IMAGE_WIDTH and _HEIGHT,
# and CV_IO_MAX_IMAGE_PIXELS. cv2.imdecode raises for an image over them,
# whatever its format, at the size it decodes to (a reduced JPEG's reduced
# size); every decoder here refuses it before any allocation its header sizes.
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def size_refusal(width: int, height: int) -> str | None:
    """Why OpenCV refuses an image of width x height, or None."""
    if width > MAX_SIDE or height > MAX_SIDE or width * height > MAX_PIXELS:
        return f"{width}x{height}, over OpenCV's size limits"
    return None


# -- JPEG: headers ---------------------------------------------------------

SOF_SEQUENTIAL = (0xC0, 0xC1)   # baseline, extended sequential (Huffman)
SOF_PROGRESSIVE = 0xC2          # progressive (Huffman)
SOF_HUFFMAN = (*SOF_SEQUENTIAL, SOF_PROGRESSIVE)
SOF_ARITH = (0xC9, 0xCA)        # sequential, progressive (arithmetic-coded)
SOF_LOSSLESS = 0xC3             # lossless (Huffman)
SOF_ALL = tuple(m for m in range(0xC0, 0xD0) if m not in (0xC4, 0xC8, 0xCC))
RST0, EOI, SOS, DHT, DQT, DRI, DAC = 0xD0, 0xD9, 0xDA, 0xC4, 0xDB, 0xDD, 0xCC
JPEG_MAX_DIMENSION = 65500      # jmorecfg.h: libjpeg refuses a longer side


class JpegError(ValueError):
    """Bytes the decoder cannot take; decode_image answers None."""


def _scan_end(data: bytes, pos: int) -> int | None:
    """Where the marker after the entropy-coded data from `pos` on starts
    (stuffed zeros, restart markers and fill bytes are part of the data), or
    None when the bytes end first."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    stop = ff[(nxt != 0) & (nxt != 0xFF) & ((nxt < RST0) | (nxt > RST0 + 7))]
    return pos + int(stop[0]) if len(stop) else None


def _walk(data: bytes, open_end: bool = False):
    """(marker, payload start, payload end, scan end) of each marker segment
    after SOI up to the end of the bytes or EOI (the last, when present).
    For an SOS, scan end is where the marker after its entropy-coded data
    starts; else None. Raises JpegError on a malformed segment, and on a
    scan that the bytes end inside unless `open_end`: such a scan is then
    the last segment, its scan end the length of the bytes (whether libjpeg
    suspends for more input inside it, where cv2 gives None, depends on how
    far its entropy decoder reads ahead)."""
    n, pos = len(data), 2
    while pos < n:
        if data[pos] != 0xFF:
            raise JpegError("marker expected")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return
        m = data[pos]
        pos += 1
        if m == EOI:
            yield m, pos, pos, None
            return
        if m == 0x01 or RST0 <= m <= RST0 + 7:
            continue  # parameterless
        if pos + 2 > n:
            raise JpegError("truncated segment")
        length = (data[pos] << 8) | data[pos + 1]
        a, b = pos + 2, pos + length
        if length < 2 or b > n:
            raise JpegError("truncated segment")
        if m == SOS:
            end = _scan_end(data, b)
            if end is None:
                if not open_end:
                    raise JpegError("the bytes end inside a scan")
                yield m, a, b, n
                return
            yield m, a, b, end
            pos = end
        else:
            yield m, a, b, None
            pos = b


def is_progressive(sof: int) -> bool:
    """Whether a frame's SOF marker is progressive (Huffman or arithmetic)."""
    return sof in (SOF_PROGRESSIVE, SOF_ARITH[1])


def jpeg_header(data: bytes) -> dict:
    """The frame of a JPEG: sof, precision, height, width, components [(id,
    h, v, tq)], and from the markers before the first scan jfif,
    adobe_transform, the EXIF orientation, huffman (the (class, slot) of
    each Huffman table a DHT defines), conditioning (the arithmetic
    conditioning values L, U and K of each table, DAC segments over
    jdarith.c's defaults) and first_scan (where the first SOS marker
    starts); eoi (whether the EOI marker ends the bytes), open_scan (the
    bytes end inside a scan, with no marker after it), multi_scan (libjpeg
    reads the whole file before any output) and complete (every
    coefficient of every component known to its last bit by the scans'
    headers; a progressive file that ends early is not). Walks every
    segment, so it raises JpegError for bytes that are no JPEG, hold no
    frame and scan, end inside a marker segment, or hold a bad progression
    or DAC segment (bytes that end inside a scan give open_scan)."""
    from vision_kit_tpu_torch.data import jpeg_arith

    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("not a JPEG")
    info = {"sof": None, "jfif": False, "adobe_transform": None, "orientation": 1,
            "eoi": False, "open_scan": False, "multi_scan": False, "huffman": set(),
            "conditioning": {k: v[:] for k, v in jpeg_arith.DEFAULT_CONDITIONING.items()}}
    exif_seen = scanned = False
    for m, a, b, end in _walk(data, open_end=True):
        seg = data[a:b]
        if m == EOI:
            info["eoi"] = True
        elif m == SOS:
            if info["sof"] is None:
                raise JpegError("no frame before the scan")
            progressive = is_progressive(info["sof"])
            if not scanned:   # jdinput.c's has_multiple_scans
                info["first_scan"] = a - 4
                info["multi_scan"] = (progressive
                                      or seg[:1] != bytes([len(info["components"])]))
                bits = np.full((len(info["components"]), 64), -1, np.int64)
            if progressive:
                ids = [c[0] for c in info["components"]]
                ns = seg[0] if seg else 0
                if len(seg) < 4 + 2 * ns or any(x not in ids for x in seg[1:1 + 2 * ns:2]):
                    raise JpegError("bad SOS")
                _progression(bits, [ids.index(x) for x in seg[1:1 + 2 * ns:2]],
                             seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4,
                             seg[3 + 2 * ns] & 15)
            info["open_scan"] = end == len(data)
            scanned = True
        elif m in SOF_ALL and info["sof"] is None:
            if len(seg) < 6:
                raise JpegError("short SOF")
            prec, h, w, nc = seg[0], (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            if len(seg) < 6 + 3 * nc:
                raise JpegError("short SOF")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                      seg[8 + 3 * i]) for i in range(nc)]
            info.update(sof=m, precision=prec, height=h, width=w, components=comps)
        elif scanned:
            continue
        elif m == DHT:
            i = 0
            while i < len(seg):
                info["huffman"].add((seg[i] >> 4, seg[i] & 15))
                i += 17 + sum(seg[i + 1:i + 17])
        elif m == DAC:
            jpeg_arith.read_dac(seg, info["conditioning"])
        elif m == 0xE0 and seg[:5] == b"JFIF\0":
            info["jfif"] = True
        elif m == 0xE1 and seg[:6] == b"Exif\0\0" and not exif_seen:
            exif_seen = True
            info["orientation"] = parse_exif_orientation(seg[6:])
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            info["adobe_transform"] = seg[11]
    if not scanned:
        raise JpegError("no scan")
    info["complete"] = not bits.any() if is_progressive(info["sof"]) else True
    return info


def jpeg_refusal(info: dict, scale: int = 1, pillow: bool = False) -> str | None:
    """Why the decoders refuse this JPEG decoded at 1/`scale`, or None when
    they take it. OpenCV's size limits apply to the decoded size,
    ceil(side / scale), as cv2.imdecode(IMREAD_REDUCED_COLOR_<scale>)
    applies them; libjpeg does not scale a lossless frame, so its decoded
    size is its own at every scale. A lossless frame converts no colour,
    so it decodes only to the output colour space of its own family: BGR
    (cv2's IMREAD_COLOR) from RGB, CMYK from CMYK, and with `pillow`
    (Pillow's modes L, RGB and CMYK) grey from grey too."""
    sof = info["sof"]
    if sof not in (*SOF_HUFFMAN, *SOF_ARITH, SOF_LOSSLESS):
        kind = ("arithmetic-coded lossless" if sof == 0xCB else "hierarchical"
                if sof in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF) else "unknown")
        return f"SOF{sof - 0xC0}, {kind} (libjpeg-turbo decodes no such frame)"
    why = pil_refusal(info) or jpeg_size_refusal(info, scale)
    if why:
        return why
    comps = info["components"]
    if any(not (1 <= h <= 4 and 1 <= v <= 4) for _, h, v, _ in comps):
        return "sampling factors outside 1..4"
    max_h = max(h for _, h, _, _ in comps)
    max_v = max(v for _, _, v, _ in comps)
    if len(comps) > 1 and any(max_h % h or max_v % v for _, h, v, _ in comps):
        return "fractional sampling ratios"
    if info["multi_scan"] and not info["eoi"]:
        # libjpeg reads a multi-scan file to its EOI before any output;
        # bytes that end first make it suspend for more input
        return "a multi-scan JPEG whose bytes end before the EOI marker"
    colour = jpeg_colour(info)
    if sof == SOF_LOSSLESS and colour not in (("grey", "rgb", "cmyk") if pillow
                                              else ("rgb", "cmyk")):
        # jdcolor.c converts no colour in lossless mode
        return (f"a lossless {colour} JPEG (libjpeg-turbo converts no colour in "
                f"lossless mode, so {'Pillow' if pillow else 'cv2.imdecode'} gets no pixels)")
    return None


def pil_refusal(info: dict) -> str | None:
    """Why Pillow's Image.open refuses this JPEG frame (JpegImagePlugin
    reads 8-bit samples of 1, 3 or 4 components only), or None."""
    if info["precision"] != 8:
        return f"{info['precision']}-bit samples"
    if len(info["components"]) not in (1, 3, 4):
        return f"{len(info['components'])} components"
    return None


def jpeg_size_refusal(info: dict, scale: int = 1) -> str | None:
    """Why libjpeg or OpenCV refuses the size of this JPEG frame decoded at
    1/`scale` (see jpeg_refusal), or None."""
    if info["height"] == 0 or info["width"] == 0:
        return "zero size (DNL)"
    if max(info["height"], info["width"]) > JPEG_MAX_DIMENSION:
        return f"a side over libjpeg's {JPEG_MAX_DIMENSION}"
    if info["sof"] == SOF_LOSSLESS:
        scale = 1
    return size_refusal(_ceil_div(info["width"], scale), _ceil_div(info["height"], scale))


def jpeg_colour(info: dict) -> str:
    """The colour space libjpeg assumes for the components (jdapimin.c
    default_decompress_parms): "grey", "ycc", "rgb" (Adobe transform 0, or
    ids 'R', 'G', 'B' without JFIF or Adobe marker), "cmyk" (Adobe transform
    0, or no Adobe marker) or "ycck" (any other Adobe transform)."""
    comps = info["components"]
    t = info["adobe_transform"]
    if len(comps) == 1:
        return "grey"
    if len(comps) == 4:
        return "cmyk" if t is None or t == 0 else "ycck"
    if info["jfif"]:
        return "ycc"
    if t is not None:
        return "rgb" if t == 0 else "ycc"
    return "rgb" if tuple(c[0] for c in comps) == (82, 71, 66) else "ycc"


# -- JPEG: entropy decoding ------------------------------------------------

# natural-order position of each zigzag index, with libjpeg's 16 guard
# entries of 63 (a corrupt run past 63 lands there)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16)
_NATURAL = ZIGZAG.tolist()
_MASK = [(1 << s) - 1 for s in range(33)]
_HALF = [1 << (s - 1) if s else 0 for s in range(33)]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# jstdhuff.c: (bits[1..16], symbols) of the standard DC (class 0) and AC
# (class 1) tables, by (class, slot): slot 0 luma, slot 1 chroma
STD_HUFFMAN = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}


@functools.cache
def _std_lookup(tc: int, th: int) -> list:
    return _huffman_lookup(*STD_HUFFMAN[(tc, th)], ac=tc == 1)


def _huffman_lookup(counts, symbols, ac: bool) -> list:
    """16-bit lookahead table: entry for the next 16 bits is (code length,
    symbol) for a DC table and (code length, run, size) for an AC table. A
    prefix matching no code takes 17 bits and gives symbol 0, as libjpeg's
    decoder does for a bad code."""
    bad = (17, 0, 0) if ac else (17, 0)
    table = [bad] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols):
                raise JpegError("short Huffman table")
            sym = symbols[k]
            k += 1
            entry = (length, sym >> 4, sym & 15) if ac else (length, sym)
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            if hi > 65536:
                raise JpegError("bad Huffman table")
            table[lo:hi] = [entry] * (hi - lo)
            code += 1
        code <<= 1
    return table


def _windows(seg: np.ndarray, zeros: int = 4096) -> list:
    """w[i] = the 64 bits from byte i on (big-endian), as Python ints, over
    the segment and `zeros` bytes of zeros after it (libjpeg's fill after
    a marker)."""
    pad = np.zeros(len(seg) + 8 + zeros, np.uint8)
    pad[:len(seg)] = seg
    w = np.zeros(len(pad) - 7, np.uint64)
    for j in range(8):
        w |= pad[j:j + len(w)].astype(np.uint64) << np.uint64(56 - 8 * j)
    return w.tolist()


def _unstuff(data: bytes, pos: int, end: int) -> list:
    """The entropy-coded bytes in [pos, end) as the unstuffed bytes of each
    restart interval: stuffed zeros and fill bytes dropped, split at the
    restart markers."""
    body = np.frombuffer(data, np.uint8, end - pos, pos)
    ff = np.flatnonzero(body == 0xFF)
    nxt = np.append(body, np.uint8(0xFF))[ff + 1]   # a last 0xFF is a fill byte
    keep = np.ones(len(body) + 1, bool)
    keep[ff[nxt == 0xFF]] = False
    keep[ff[nxt == 0] + 1] = False
    rst = ff[(nxt >= RST0) & (nxt <= RST0 + 7)]
    keep[rst] = False
    keep[rst + 1] = False
    bounds = [0, *rst.tolist(), len(body)]
    return [body[a:b][keep[a:b]] for a, b in zip(bounds[:-1], bounds[1:])]


def _decode_blocks(w, avail, plan, n_mcus, coef_idx, coef_val, trace=None):
    """Huffman-decode `n_mcus` MCUs of one restart interval. `plan` lists,
    per MCU, the blocks (flat coefficient offset, component slot, DC table,
    AC table). Appends each nonzero coefficient's flat index and value.
    When the walk needs bits past `avail`, the MCU where it ran out is kept,
    read on through zero bits, and the rest of the interval is left zero,
    as libjpeg leaves it; returns that MCU's index, else None. `trace`,
    when given, is a pair of lists that gain each code's (length, extra
    bits) and where each MCU's codes start."""
    nat, mask, half = _NATURAL, _MASK, _HALF
    ia, va = coef_idx.append, coef_val.append
    pred = [0, 0, 0, 0]
    p = 0
    codes = trace[0].append if trace else None
    for m in range(n_mcus):
        if trace:
            trace[1].append(len(trace[0]))
        for base, slot, dct, act in plan(m):
            q = p & 7
            length, s = dct[(w[p >> 3] >> (48 - q)) & 0xFFFF]
            p += length
            if s:
                s = min(s, 16)   # a corrupt DC category; 8-bit data has <= 11
                v = (w[p >> 3] >> (64 - (p & 7) - s)) & mask[s]
                p += s
                if v < half[s]:
                    v -= mask[s]
                pred[slot] += v
            if codes:
                codes((length, s))
            if pred[slot]:
                ia(base)
                va(pred[slot])
            k = 1
            while k < 64:
                q = p & 7
                length, r, s = act[(w[p >> 3] >> (48 - q)) & 0xFFFF]
                p += length
                if codes:
                    codes((length, s))
                if s:
                    k += r
                    v = (w[p >> 3] >> (64 - (p & 7) - s)) & mask[s]
                    p += s
                    if v < half[s]:
                        v -= mask[s]
                    ia(base + nat[k])
                    va(v)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
        if p > avail:
            break
    else:
        m = None
    if trace:
        trace[1].append(len(trace[0]))
    return m


# jdhuff.c's bit buffer as libjpeg-turbo 3.1 runs it on a 64-bit machine
MIN_GET_BITS = 57   # jdhuff.h: BIT_BUF_SIZE - 7, the depth a fill reaches
FAST_BYTES = 512    # jdhuff.c's BUFSIZE: decode_mcu_fast needs this many bytes a block


def _suspends(codes, starts, n_data: int, left_after=None, fast_blocks: int = 0) -> bool:
    """Whether libjpeg suspends for more input while decoding the codes of
    an interval whose `n_data` unstuffed bytes end the file with no marker
    after them (OpenCV's source holds the whole file and cannot refill, so
    cv2 then gives None). `codes` holds each code's (length, extra bits),
    `starts` where each MCU's codes start (and their end). jdhuff.c's
    decode_mcu takes decode_mcu_fast when the file bytes left after those
    in the bit buffer (`left_after(data bytes read)`) are at least
    FAST_BYTES x `fast_blocks` (0 with restart intervals, and for
    jdlhuff.c, which has no fast path): it loads 6 bytes whenever 16 bits
    or fewer are left, and cannot suspend. decode_mcu_slow fills through
    jpeg_fill_bit_buffer whenever a code needs more bits than the buffer
    holds (HUFF_DECODE's 8-bit look-ahead, jpeg_huff_decode's 9 and then 1
    for a longer code, the extra bits): each fill loads bytes until
    MIN_GET_BITS bits are there, and suspends when the bytes end first."""
    p = read = 0
    for m in range(len(starts) - 1):
        fast = fast_blocks and left_after(read) >= FAST_BYTES * fast_blocks
        for length, extra in codes[starts[m]:starts[m + 1]]:
            if fast:
                if 8 * read - p <= 16:
                    read += 6
                p += length
                if extra:
                    if 8 * read - p <= 16:
                        read += 6
                    p += extra
                continue
            wants = [8] if length <= 8 else [8, 9] + [1] * (length - 9)
            takes = [length] if length <= 8 else [0, 9] + [1] * (length - 9)
            if extra:
                wants.append(extra)
                takes.append(extra)
            for want, take in zip(wants, takes):
                if 8 * read - p < want:
                    read = _ceil_div(p + MIN_GET_BITS, 8)
                    if read > n_data:
                        return True
                p += take
    return False


def _huffman_suspends(data: bytes, pos: int, total: int, restart: int, blocks: int,
                      walk) -> bool:
    """_suspends for a sequential scan from data[pos:] that the bytes end
    inside: the last restart interval, re-walked by walk(first MCU,
    unstuffed bytes, trace). With fewer intervals than the scan has,
    libjpeg suspends looking for the next restart marker."""
    interval = restart or total
    firsts = range(0, total, interval)
    segs = _unstuff(data, pos, len(data))
    if len(segs) != len(firsts):
        return len(segs) < len(firsts)   # more: the last one ends at a marker
    seg = segs[-1]
    left_after = None
    if not restart:   # the file bytes left after each data byte (FF00 is two)
        body = np.frombuffer(data, np.uint8, offset=pos)
        ff = np.flatnonzero(body == 0xFF)
        nxt = np.append(body, np.uint8(0xFF))[ff + 1]
        keep = np.ones(len(body), bool)
        keep[ff[nxt == 0xFF]] = False   # fill bytes
        keep[ff[nxt == 0] + 1] = False  # stuffed zeros
        at = np.flatnonzero(keep)[:len(seg)]
        left = len(data) - np.concatenate([[pos], pos + at + 1 + (body[at] == 0xFF)])
        left_after = left.tolist().__getitem__
    trace = ([], [])
    walk(firsts[-1], seg, trace)
    return _suspends(trace[0], trace[1], len(seg), left_after, 0 if restart else blocks)


def _block_order(frame, scan_comps) -> tuple[np.ndarray, list]:
    """Each block of a scan, MCU by MCU: ((MCUs, blocks an MCU) flat
    coefficient offsets, each block's slot in the scan). A one-component
    scan walks the component's own grid of blocks (no dummy blocks), one
    block an MCU; an interleaved scan walks whole MCUs."""
    offs = frame["offsets"]
    if len(scan_comps) == 1:
        ci = scan_comps[0][0]
        c = frame["comps"][ci]
        rows, cols = np.mgrid[0:c["brows_real"], 0:c["bcols_real"]]
        return (offs[ci] + (rows * c["bcols"] + cols) * 64).reshape(-1, 1), [0]
    my, mx = np.mgrid[0:frame["mcu_rows"], 0:frame["mcu_cols"]]
    parts, slots = [], []
    for slot, (ci, *_) in enumerate(scan_comps):
        c = frame["comps"][ci]
        for by in range(c["v"]):
            for bx in range(c["h"]):
                parts.append((offs[ci] + ((my * c["v"] + by) * c["bcols"]
                                          + mx * c["h"] + bx) * 64).reshape(-1))
                slots.append(slot)
    return np.stack(parts, 1), slots


def _run_intervals(data, pos, end, total, restart, walk, short=None) -> int:
    """Run `walk(first MCU, unstuffed bytes)` on each restart interval of
    the scan in data[pos:end] that the bytes hold; it returns the index in
    the interval of the MCU where its bits ran out, or None. Intervals
    missing before the marker are left as they are, but for the first of
    them when the interval before it did not run out: libjpeg then decodes
    that one MCU from zero bits. Returns the last MCU whose decode began
    with bits left (libjpeg's insufficient_data still clear), -1 for none.
    Appends to `short`, when given, how many of the scan's MCUs needed bits
    past their interval's data: from the MCU where an interval ran out to
    its end, and every MCU of the intervals missing before the marker."""
    interval = restart or total
    firsts = range(0, total, interval)
    segs = _unstuff(data, pos, end)[:len(firsts)]
    good, ran, n_short = -1, None, 0
    for first, seg in zip(firsts, segs):
        ran = walk(first, seg)
        n = min(interval, total - first)
        good = first + (ran if ran is not None else n - 1)
        n_short += 0 if ran is None else n - ran
    if len(segs) < len(firsts):
        n_short += total - firsts[len(segs)]
        if ran is None:
            good = firsts[len(segs)]
            walk(good, np.zeros(0, np.uint8))
    if short is not None:
        short.append(n_short)
    return good


def _wrap16(x) -> np.ndarray:
    """Values stored as libjpeg's 16-bit JCOEF, as int32."""
    return np.asarray(x, np.int64).astype(np.int16).astype(np.int32)


def _scan(data, pos, end, frame, scan_comps, tables, restart, coefs, short=None):
    """Decode the sequential scan in data[pos:end] into `coefs` (each
    component's (rows, cols, 64) blocks, flat, int32). A restart interval
    that runs out of data keeps the MCU where it ran out (zero-padded) and
    leaves the rest zero, as do intervals missing before the marker."""
    bases, slots = _block_order(frame, scan_comps)
    tabs = [(tables[(0, td)], tables[(1, ta)]) for _, td, ta in scan_comps]
    pattern = [(slot, *tabs[slot]) for slot in slots]
    plan = [tuple((b, *p) for b, p in zip(row, pattern)) for row in bases.tolist()]
    total = len(plan)
    interval = restart or total
    idx, val = [], []

    def walk(first, seg, trace=None):
        return _decode_blocks(_windows(seg), 8 * len(seg), (lambda m: plan[first + m]),
                              min(interval, total - first), idx, val, trace)

    if end == len(data) and _huffman_suspends(data, pos, total, restart, len(slots), walk):
        raise JpegError("the bytes end inside the scan, where libjpeg's bit buffer "
                        "reads past them")
    idx.clear()
    val.clear()
    _run_intervals(data, pos, end, total, restart, walk, short)
    if idx:   # stored as libjpeg's 16-bit JCOEF
        np.put(coefs, np.asarray(idx, np.int64), _wrap16(val))


# -- JPEG: progressive scans (jdphuff.c) -----------------------------------


def _dc_first(w, avail, rows, pattern, al, idx, val):
    """decode_mcu_DC_first over the MCUs of one restart interval: `rows`
    holds each MCU's block offsets, `pattern` each block's (slot, DC table).
    Every block gets its DC value shifted left by `al`; once the bits run
    out, the MCU where they did is read on through zero bits and the rest
    of the interval is left as it is."""
    mask, half = _MASK, _HALF
    ia, va = idx.append, val.append
    pred = [0, 0, 0, 0]
    p = 0
    for i, row in enumerate(rows):
        for base, (slot, dct) in zip(row, pattern):
            length, s = dct[(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            p += length
            if s:
                s = min(s, 16)
                v = (w[p >> 3] >> (64 - (p & 7) - s)) & mask[s]
                p += s
                if v < half[s]:
                    v -= mask[s]
                pred[slot] += v
            ia(base)
            va(pred[slot] << al)
        if p > avail:
            return i
    return None


def _ac_first(w, avail, bases, act, ss, se, al, idx, val):
    """decode_mcu_AC_first over the blocks of one restart interval of a
    one-component scan: coefficients ss..se (zigzag), shifted left by `al`,
    with EOBRUN (an end-of-band over 2**r + r extra bits blocks)."""
    nat, mask, half = _NATURAL, _MASK, _HALF
    ia, va = idx.append, val.append
    eobrun = p = 0
    for i, base in enumerate(bases):
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            length, r, s = act[(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            p += length
            if s:
                k += r
                v = (w[p >> 3] >> (64 - (p & 7) - s)) & mask[s]
                p += s
                if v < half[s]:
                    v -= mask[s]
                ia(base + nat[k])
                va(v << al)
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = (1 << r) - 1
                if r:
                    eobrun += (w[p >> 3] >> (64 - (p & 7) - r)) & mask[r]
                    p += r
                break
        if p > avail:
            return i
    return None


def _ac_refine(w, avail, bases, first, nzk, starts, act, ss, se, p1, corr, new):
    """decode_mcu_AC_refine over the blocks of one restart interval.
    `nzk` holds, block after block, the zigzag positions in ss..se of the
    coefficients that are nonzero before this scan, `starts[first + i]`
    where block i's run of them begins. Each already-nonzero coefficient
    that the walk passes takes one correction bit: appended to `corr` as
    runs (bit position, index into nzk, count), applied afterwards. Each
    newly nonzero coefficient (+-p1, at the r+1-th still-zero position) is
    appended to `new` as (flat offset, value)."""
    nat, mask = _NATURAL, _MASK
    eobrun = p = 0
    for i, base in enumerate(bases):
        k = ss
        j, jend = starts[first + i], starts[first + i + 1]
        if not eobrun:
            while k <= se:
                length, r, s = act[(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                p += length
                if s:
                    s = p1 if (w[p >> 3] >> (63 - (p & 7))) & 1 else -p1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (64 - (p & 7) - r)) & mask[r]
                        p += r
                    break
                # skip r still-zero positions; the already-nonzero ones on
                # the way take a correction bit each
                t, j0 = k + r, j
                while j < jend and nzk[j] <= t:
                    t += 1
                    j += 1
                if j > j0:
                    corr.append((p, j0, j - j0))
                    p += j - j0
                k = t if t <= se else se + 1
                if s:
                    new.append((base + nat[k], s))
                k += 1
        if eobrun:
            if j < jend:
                corr.append((p, j, jend - j))
                p += jend - j
            eobrun -= 1
        if p > avail:
            return i
    return None


def _bits(seg: np.ndarray, n: int) -> np.ndarray:
    """The first n bits of `seg`, zero past its end (libjpeg's fill)."""
    bits = np.unpackbits(seg)[:n]
    return np.pad(bits, (0, n - len(bits)))


def _scan_progressive(data, pos, end, frame, scan_comps, tables, restart, coefs,
                      ss, se, ah, al, short=None):
    """Decode the progressive scan in data[pos:end] (spectral band ss..se,
    successive approximation ah -> al) into `coefs`, as jdphuff.c does.
    Returns the iMCU row of the last MCU whose decode began with bits left,
    or None when there is none."""
    bases, slots = _block_order(frame, scan_comps)
    total = len(bases)
    interval = restart or total
    p1 = 1 << al
    if ss == 0 and ah == 0:            # DC first
        pattern = [(slot, tables[(0, scan_comps[slot][1])]) for slot in slots]
        idx, val = [], []
        good = _run_intervals(data, pos, end, total, restart, lambda first, seg: _dc_first(
            _windows(seg), 8 * len(seg), bases[first:first + interval].tolist(),
            pattern, al, idx, val), short)
        if idx:
            coefs[np.asarray(idx, np.int64)] = _wrap16(val)
    elif ss == 0:                      # DC refinement: one bit a block
        def refine_dc(first, seg):
            blocks = bases[first:first + interval].reshape(-1)
            coefs[blocks[_bits(seg, len(blocks)) == 1]] |= p1
            n_bits = 8 * len(seg)    # the MCU that reads past them, if any
            return n_bits // bases.shape[1] if len(blocks) > n_bits else None

        good = _run_intervals(data, pos, end, total, restart, refine_dc, short)
    elif ah == 0:                      # AC first
        act = tables[(1, scan_comps[0][2])]
        flat = bases[:, 0].tolist()
        idx, val = [], []
        good = _run_intervals(data, pos, end, total, restart, lambda first, seg: _ac_first(
            _windows(seg), 8 * len(seg), flat[first:first + interval], act, ss, se, al,
            idx, val), short)
        if idx:
            np.put(coefs, np.asarray(idx, np.int64), _wrap16(val))
    else:                              # AC refinement
        act = tables[(1, scan_comps[0][2])]
        flat = bases[:, 0]
        zz = ZIGZAG[ss:se + 1]
        blk, pos_in_band = np.nonzero(coefs[flat[:, None] + zz[None, :]])
        starts = np.concatenate([[0], np.cumsum(np.bincount(blk, minlength=total))]).tolist()
        nz_flat = flat[blk] + zz[pos_in_band]
        nzk = (pos_in_band + ss).tolist()
        bases_list = flat.tolist()

        def refine_ac(first, seg):
            corr, new = [], []
            ran = _ac_refine(_windows(seg), 8 * len(seg), bases_list[first:first + interval],
                             first, nzk, starts, act, ss, se, p1, corr, new)
            if corr:
                rec = np.asarray(corr, np.int64)
                cnt = rec[:, 2]
                within = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
                bitpos = np.repeat(rec[:, 0], cnt) + within
                target = nz_flat[(np.repeat(rec[:, 1], cnt) + within)[
                    _bits(seg, int(bitpos[-1]) + 1)[bitpos] == 1]]
                v = coefs[target]
                grow = (v & p1) == 0    # a bit already set is left as it is
                coefs[target[grow]] = _wrap16(v[grow] + np.where(v[grow] >= 0, p1, -p1))
            if new:
                nv = np.asarray(new, np.int64)
                coefs[nv[:, 0]] = nv[:, 1]
            return ran

        good = _run_intervals(data, pos, end, total, restart, refine_ac, short)
    return None if good < 0 else _imcu_row(frame, scan_comps, good)


def _scan_arith(data, pos, end, frame, scan_comps, restart, coefs, cond, ss, se, ah, al,
                progressive, short=None) -> int:
    """Decode the arithmetic-coded scan in data[pos:end] into `coefs`
    (data/jpeg_arith.py). Every MCU decodes, from zero bytes past a marker,
    so the last good iMCU row is the scan's last (jdarith.c never sets
    insufficient_data). A scan that the bytes end inside (end is their
    length) raises where the decoder needs a byte past them or a restart
    marker the bytes do not hold."""
    from vision_kit_tpu_torch.data import jpeg_arith

    bases, slots = _block_order(frame, scan_comps)
    total = len(bases)
    interval = restart or total
    firsts = range(0, total, interval)
    marker = end < len(data)
    segs = _unstuff(data, pos, end)[:len(firsts)]
    # without a marker, libjpeg stops where the bytes end, or at the restart
    # marker after them (read_restart_marker cannot suspend either)
    held = len(firsts) if marker else len(segs)
    intervals = [(segs[i].tobytes() if i < len(segs) else b"", marker or i < len(segs) - 1,
                  first, min(interval, total - first)) for i, first in enumerate(firsts[:held])]
    try:
        jpeg_arith.decode_scan(intervals, bases, slots, [(td, ta) for _, td, ta in scan_comps],
                               cond, coefs, ss, se, ah, al, progressive)
        if held < len(firsts):
            end_at = jpeg_arith.BytesEnd("the bytes end inside a scan, before a restart marker")
            end_at.mcu = firsts[held]
            raise end_at
    except jpeg_arith.BytesEnd as e:
        e.row = _imcu_row(frame, scan_comps, e.mcu)
        raise
    if short is not None:
        short.append(0)
    return _imcu_row(frame, scan_comps, total - 1)


def _imcu_row(frame, scan_comps, mcu: int) -> int:
    """The iMCU row of a scan's MCU `mcu`."""
    if len(scan_comps) > 1:
        return mcu // frame["mcu_cols"]
    c = frame["comps"][scan_comps[0][0]]
    return mcu // c["bcols_real"] // c["sof_v"]


def _progression(coef_bits: np.ndarray, scan: list, ss: int, se: int, ah: int, al: int,
                 prev_bits: np.ndarray | None = None, first_scan: bool = False) -> None:
    """jdphuff.c start_pass_phuff_decoder's checks of a scan's parameters
    (a bad progression raises, as libjpeg's error exit does), then its
    update of libjpeg's coef_bits (each coefficient's lowest known bit, -1
    before any scan holds it) and of the copy it keeps from before the scan
    (`prev_bits`, for coefficients min(ss, 1)..max(se, 9); 0 in the first
    scan). `scan` lists the components' indices."""
    if ss == 0:
        bad = se != 0
    else:
        bad = ss > se or se > 63 or len(scan) != 1
    if (ah and al != ah - 1) or al > 13 or bad:
        raise JpegError(f"bad progression Ss={ss} Se={se} Ah={ah} Al={al}")
    for ci in scan:
        if prev_bits is not None:
            lo, hi = min(ss, 1), max(se, 9) + 1
            prev_bits[ci, lo:hi] = 0 if first_scan else coef_bits[ci, lo:hi]
        coef_bits[ci, ss:se + 1] = al


# -- JPEG: sample reconstruction ------------------------------------------

# jidctint.c's FIX_x constants: round(x * 2**13)
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _w16(x):
    """x wrapped to a signed 16-bit lane, as a SIMD word add or multiply
    leaves it."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _w32(x):
    """x wrapped to a signed 32-bit lane."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_pass(c, shift):
    """One 1-D pass of jpeg_idct_islow as libjpeg-turbo's AVX2 code
    (jidctint-avx2.asm) runs it over the eight 16-bit inputs c[0..7] (each
    an int64 array): descaled by `shift` (CONST_BITS - PASS1_BITS = 11
    after the columns, CONST_BITS + PASS1_BITS + 3 = 18 after the rows) and
    saturated to 16 bits (packssdw). Its products are jidctint.c's,
    regrouped into pairs (pmaddwd) with the same exact sums; the sums
    c[0] +- c[4], c[7] + c[3] and c[5] + c[1] are 16-bit word adds, which
    wrap for the values corrupt data can give (an arithmetic-coded scan
    decoded from the zeros after a cut)."""
    z2, z3 = c[2], c[6]
    tmp2 = z2 * FIX_0_541196100 + z3 * (FIX_0_541196100 - FIX_1_847759065)
    tmp3 = z2 * (FIX_0_541196100 + FIX_0_765366865) + z3 * FIX_0_541196100
    tmp0 = _w16(c[0] + c[4]) << 13
    tmp1 = _w16(c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z3, z4 = _w16(t0 + t2), _w16(t1 + t3)
    z3, z4 = (z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602,
              z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644))
    t0, t3 = (t0 * (FIX_0_298631336 - FIX_0_899976223) + t3 * -FIX_0_899976223 + z3,
              t0 * -FIX_0_899976223 + t3 * (FIX_1_501321110 - FIX_0_899976223) + z4)
    t1, t2 = (t1 * (FIX_2_053119869 - FIX_2_562915447) + t2 * -FIX_2_562915447 + z4,
              t1 * -FIX_2_562915447 + t2 * (FIX_3_072711026 - FIX_2_562915447) + z3)
    rnd = 1 << (shift - 1)
    return [np.clip((x + rnd) >> shift, -0x8000, 0x7FFF) for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit_table() -> np.ndarray:
    """jidctred.c's post-IDCT range limit for the 1x1 IDCT, indexed by
    (value & 0x3FF): x + 128 clamped to [0, 255] for x in [-512, 511],
    wrapping beyond. The 8x8, 4x4 and 2x2 IDCTs run as libjpeg-turbo's SIMD
    code, whose saturating packs clamp every value (a block decoded from
    the zero bits after a cut reaches past +-512)."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0],
                     i - 896).astype(np.uint8)


_RANGE = _range_limit_table()


def _idct_plane(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(rows, cols, 64) quantised blocks in natural order -> (8 rows, 8
    cols) uint8 plane, as libjpeg-turbo's AVX2 islow IDCT gives it: the
    dequantisation a 16-bit multiply (pmullw), and a block whose rows 1-7
    are all zero takes its column pass's shortcut, row 0 shifted left by
    PASS1_BITS in 16 bits (psllw), where the full pass would saturate."""
    rows, cols = coef.shape[:2]
    blocks = coef.reshape(-1, 8, 8).astype(np.int64)
    b = _w16(blocks * qt.reshape(8, 8).astype(np.int64))
    ws = np.stack(_idct_pass([b[:, k, :] for k in range(8)], 11), axis=1)  # (N, row, col)
    dc_only = ~blocks[:, 1:, :].any(axis=(1, 2))
    ws[dc_only] = _w16(b[dc_only, :1, :] << 2)
    out = _idct_pass([ws[:, :, k] for k in range(8)], 18)    # rows
    out = np.stack(out, axis=2)                               # (N, row, col)
    px = np.clip(out + 128, 0, 255).astype(np.uint8)
    return px.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


# jidctred.c's constants, round(x * 2**13), for the reduced-size IDCTs
FIX_0_211164243, FIX_0_509795579, FIX_0_601344887 = 1730, 4176, 4926
FIX_0_720959822, FIX_0_850430095, FIX_1_061594337 = 5906, 6967, 8697
FIX_1_272758580, FIX_1_451774981, FIX_2_172734803 = 10426, 11893, 17799
FIX_3_624509785 = 29692


def _descale(x, shift):
    return (x + (1 << (shift - 1))) >> shift


def _idct4_pass(c, shift):
    """One 1-D pass of jidctred.c's jpeg_idct_4x4 over c[0..7] (c[4] is not
    read): the 4 outputs, descaled by `shift` (CONST_BITS - PASS1_BITS + 1
    = 12 after the columns, CONST_BITS + PASS1_BITS + 3 + 1 = 19 after the
    rows). Its zero-AC shortcuts give the same values."""
    tmp0 = c[0] << 14
    tmp2 = c[2] * FIX_1_847759065 - c[6] * FIX_0_765366865
    tmp10, tmp12 = tmp0 + tmp2, tmp0 - tmp2
    z1, z2, z3, z4 = c[7], c[5], c[3], c[1]
    tmp0 = (z1 * -FIX_0_211164243 + z2 * FIX_1_451774981
            + z3 * -FIX_2_172734803 + z4 * FIX_1_061594337)
    tmp2 = (z1 * -FIX_0_509795579 + z2 * -FIX_0_601344887
            + z3 * FIX_0_899976223 + z4 * FIX_2_562915447)
    return [_descale(x, shift) for x in (tmp10 + tmp2, tmp12 + tmp0,
                                         tmp12 - tmp0, tmp10 - tmp2)]


def _idct2_pass(c, shift):
    """One 1-D pass of jpeg_idct_2x2 over c[0..7] (c[2], c[4], c[6] are not
    read): the 2 outputs, descaled by `shift` (13 after the columns, 20
    after the rows). Both passes sum in 32-bit lanes, which wrap, and the
    row pass takes the column pass's odd outputs saturated to 16 bits, as
    libjpeg-turbo's SIMD code does for the values corrupt data can give."""
    if shift == 20:   # the odd inputs come packed to 16 bits (saturated)
        c = [c[0]] + [np.clip(v, -0x8000, 0x7FFF) for v in c[1:]]
    tmp10 = c[0] << 15
    tmp0 = (c[7] * -FIX_0_720959822 + c[5] * FIX_0_850430095
            + c[3] * -FIX_1_272758580 + c[1] * FIX_3_624509785)
    rnd = 1 << (shift - 1)
    return [_w32(x + rnd) >> shift for x in (tmp10 + tmp0, tmp10 - tmp0)]


def _idct_scaled(coef: np.ndarray, qt: np.ndarray, size: int) -> np.ndarray:
    """(rows, cols, 64) quantised blocks in natural order -> (size * rows,
    size * cols) uint8 plane: libjpeg's IDCT that gives size x size samples
    a block (jidctint.c's islow at 8, jidctred.c's 4x4, 2x2 and 1x1 below),
    with the range limit of the full decode. The 4x4 runs as libjpeg-turbo's
    SSE2 code (jidctred-sse2.asm) does: a 16-bit dequantising multiply, the
    column pass saturated to 16 bits, and a shortcut for a block whose rows
    1-3 and 5-7 are zero (row 0 shifted left in 16 bits); the 2x2 has the
    16-bit multiply and 32-bit lanes (_idct2_pass); the 1x1 is plain C.
    Only corrupt data (an
    arithmetic-coded scan decoded from the zeros after a cut) reaches the
    values where these differ from jidctred.c, as measured against cv2."""
    if size == 8:
        return _idct_plane(coef, qt)
    rows, cols = coef.shape[:2]
    blocks = coef.reshape(-1, 8, 8).astype(np.int64)
    b = blocks * qt.reshape(8, 8).astype(np.int64)
    if size == 1:
        out = _descale(b[:, :1, :1], 3)
    else:
        one_pass, shifts = {4: (_idct4_pass, (12, 19)), 2: (_idct2_pass, (13, 20))}[size]
        b = _w16(b)
        ws = np.stack(one_pass([b[:, k, :] for k in range(8)], shifts[0]), axis=1)
        if size == 4:
            ws = np.clip(ws, -0x8000, 0x7FFF)
            dc_only = ~blocks[:, [1, 2, 3, 5, 6, 7], :].any(axis=(1, 2))
            ws[dc_only] = _w16(b[dc_only, :1, :] << 2)
        out = np.stack(one_pass([ws[:, :, k] for k in range(8)], shifts[1]), axis=2)
    px = _RANGE[out & 0x3FF] if size == 1 else np.clip(out + 128, 0, 255).astype(np.uint8)
    return px.reshape(rows, cols, size, size).transpose(0, 2, 1, 3).reshape(
        rows * size, cols * size)


def scaled_sizes(comps: list, scale: int) -> list:
    """Each component's IDCT size (samples a block side) when libjpeg
    decodes at 1/`scale` (jdmaster.c): 8 // scale, doubled while the
    component's sampling leaves room for it, so that chroma is scaled up in
    the IDCT rather than by upsampling. `comps` holds (h, v) pairs."""
    low = 8 // scale
    max_h = max(h for h, _ in comps)
    max_v = max(v for _, v in comps)
    sizes = []
    for h, v in comps:
        size = low
        while (size < 8 and (max_h * low) % (h * size * 2) == 0
               and (max_v * low) % (v * size * 2) == 0):
            size *= 2
        sizes.append(size)
    return sizes


def _upsample(plane: np.ndarray, fh: int, fv: int, fancy: bool = True) -> np.ndarray:
    """libjpeg's upsampling of a (dh, dw) plane by (fh, fv): fancy triangle
    filters with edge replication for h2v1, h2v2 and h1v2, box replication
    for other integer factors, for h2v1/h2v2 when the plane is at most 2
    wide, and for every factor when `fancy` is off (jdsample.c turns it off
    at 1/8 scale, where each block is one sample)."""
    if fh == 1 and fv == 1:
        return plane
    s = plane.astype(np.int32)
    dw = s.shape[1]
    if not fancy or fh > 2 or fv > 2 or (fh == 2 and dw <= 2):
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    up = np.concatenate([s[:1], s[:-1]], 0)
    down = np.concatenate([s[1:], s[-1:]], 0)
    if fh == 1:   # h1v2
        out = np.empty((2 * s.shape[0], dw), np.int32)
        out[0::2] = (3 * s + up + 1) >> 2
        out[1::2] = (3 * s + down + 2) >> 2
        return out.astype(np.uint8)
    if fv == 1:   # h2v1
        left = np.concatenate([s[:, :1], s[:, :-1]], 1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        out = np.empty((s.shape[0], 2 * dw), np.int32)
        out[:, 0::2] = (3 * s + left + 1) >> 2
        out[:, 1::2] = (3 * s + right + 2) >> 2
        return out.astype(np.uint8)
    out = np.empty((2 * s.shape[0], 2 * dw), np.int32)   # h2v2
    for r, near in ((0, up), (1, down)):
        cs = 3 * s + near
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        out[r::2, 0::2] = (3 * cs + left + 8) >> 4
        out[r::2, 1::2] = (3 * cs + right + 7) >> 4
    return out.astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table: FIX(1.402), FIX(1.772), FIX(0.71414)
    and FIX(0.34414) at 16 bits, Cb->G carrying the rounding half."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15
    cr_r = (91881 * x + one_half) >> 16
    cb_b = (116130 * x + one_half) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes -> (H, W, 3) uint8."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    yy = y.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on uint8 planes, as RGB: each of
    C, M, Y becomes k - ((255 - x) * k >> 8)."""
    kk = k.astype(np.int32)
    return np.stack([kk - (((255 - x.astype(np.int32)) * kk) >> 8) for x in (c, m, y)],
                    -1).astype(np.uint8)


def ycck_to_cmyk(y, cb, cr, k) -> tuple:
    """jdcolor.c's ycck_cmyk_convert: the YCbCr -> RGB of ycc_rgb_convert,
    each result x taken as 255 - x (clamped); K passes through."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    yy = y.astype(np.int64)
    rgb = (yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb])
    return (*(np.clip(255 - x, 0, 255).astype(np.uint8) for x in rgb), k)


# -- JPEG: block smoothing (jdcoefct.c) ------------------------------------

# libjpeg-turbo's 5x5 block smoothing (2.1 on): for each of the first ten
# zigzag coefficients, the weights of the DC values of the 5x5 blocks
# around a block (rows above to below, columns left to right), with the DC
# values of the other blocks unknown bits ("dc") or not ("ac").
_K_AC01_DC = [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
              [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]]
_K_AC01_AC = [[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5]
_K_AC20_DC = [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
              [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]]
_K_AC20_AC = [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
              [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]]
_K_AC11_DC = [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0],
              [1, 0, 0, 0, -1]]
_K_AC11_AC = [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5,
              [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]
_K_AC03 = [[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5]
_K_AC12 = [[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5]
_K_DC = [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
         [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]]


def _t(k):
    return np.asarray(k, np.int64).T


# zigzag index 1..9 -> (DC-interpolation kernel, kernel with AC data or None)
_SMOOTH = {
    1: (np.asarray(_K_AC01_DC), np.asarray(_K_AC01_AC)),
    2: (_t(_K_AC01_DC), _t(_K_AC01_AC)),
    3: (np.asarray(_K_AC20_DC), np.asarray(_K_AC20_AC)),
    4: (np.asarray(_K_AC11_DC), np.asarray(_K_AC11_AC)),
    5: (_t(_K_AC20_DC), _t(_K_AC20_AC)),
    6: (np.asarray(_K_AC03), None),
    7: (np.asarray(_K_AC12), None),
    8: (_t(_K_AC12), None),
    9: (_t(_K_AC03), None),
}


def _smooth_rows(hb: int, v: int, imcu_rows: int) -> np.ndarray:
    """(hb, 5) block rows read for each block row of a component, two above
    to two below, as decompress_smooth_data picks them iMCU row by iMCU row
    (its last iMCU row counts only its real block rows, also when it
    decides where the image's edge lies)."""
    out = []
    for i in range(imcu_rows):
        rows = v if i < imcu_rows - 1 else (hb % v or v)
        for b in range(rows):
            r, ib, n = i * v + b, i * rows + b, rows * imcu_rows
            up = r - 1 if ib > 0 else r
            down = r + 1 if ib < n - 1 else r
            out.append((r - 2 if ib > 1 else up, up, r, down,
                        r + 2 if ib < n - 2 else down))
    return np.asarray(out, np.int64)


def _smooth_block_grid(blocks: np.ndarray, qt: np.ndarray, bits: list, hb: int,
                       wb: int, v: int, imcu_rows: int) -> np.ndarray:
    """jdcoefct.c decompress_smooth_data on one component: (rows, cols, 64)
    blocks -> a copy whose hb x wb real blocks hold libjpeg's estimates of
    the first ten coefficients where their bits are not all known (`bits`,
    libjpeg's coef_bits[0..9]) and the coefficient is still zero. With no
    AC bit known at all, DC is re-estimated too."""
    # two rows past the grid read as zero DC: a one-component frame whose
    # SOF samples it 2 high has block rows that libjpeg pads and never decodes
    dc = np.zeros((blocks.shape[0] + 2, blocks.shape[1]), np.int64)
    dc[:blocks.shape[0]] = blocks[:, :, 0]
    rows = _smooth_rows(hb, v, imcu_rows)
    cols = np.clip(np.arange(wb)[:, None] + np.arange(-2, 3), 0, wb - 1)
    near = dc[rows[:, None, :, None], cols[None, :, None, :]]   # (y, x, 5, 5)
    change_dc = all(b == -1 for b in bits[1:10])
    q00 = int(qt[0])
    out = blocks.copy()
    ws = out[:hb, :wb]

    def predict(kernel, q, al):
        num = q00 * np.einsum("yxrc,rc->yx", near, kernel)
        pred = ((q << 7) + np.abs(num)) // (q << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        return np.where(num >= 0, pred, -pred)

    for k in range(1, 10):
        kern_dc, kern_ac = _SMOOTH[k]
        kernel = kern_dc if change_dc else kern_ac
        al = bits[k]
        if kernel is None or al == 0:
            continue
        pos = int(ZIGZAG[k])
        zero = ws[:, :, pos] == 0
        ws[:, :, pos] = np.where(zero, predict(kernel, int(qt[pos]), al), ws[:, :, pos])
    if change_dc:
        ws[:, :, 0] = predict(np.asarray(_K_DC), q00, 0)
    return out


def _smoothing_bits(coef_bits, qtables) -> list | None:
    """jdcoefct.c smoothing_ok: each component's coef_bits[0..9] when block
    smoothing applies (every component scanned, its DC partly known, none
    of its ten quantizers zero, and some of those ten coefficients not
    fully known in some component), else None."""
    if any(qt is None or not qt[ZIGZAG[:10]].all() for qt in qtables):
        return None
    bits = coef_bits[:, :10]
    if (bits[:, 0] < 0).any() or not (bits[:, 1:] != 0).any():
        return None
    return bits.tolist()


def _decode_jpeg(data: bytes, scale: int = 1) -> tuple[np.ndarray, int]:
    """(ceil(H / scale), ceil(W / scale), 3) RGB in stored order, and the
    EXIF orientation. `scale` 2, 4 or 8 decodes as libjpeg does with
    scale_num 1, scale_denom `scale`: every coefficient is entropy-decoded,
    each component runs the IDCT of its scaled size (scaled_sizes), and
    upsampling and colour conversion run at the reduced sizes. A lossless
    frame decodes at its own size whatever the scale, as libjpeg's does."""
    info = jpeg_header(data)
    why = jpeg_refusal(info, scale)
    if why:
        raise JpegError(why)
    if info["sof"] == SOF_LOSSLESS:
        return _colour(info, _lossless_planes(data, info)), info["orientation"]
    (frame, coefs, coef_bits, prev_bits, n_scans, last_good) = _coefficients(data, info)
    return _reconstruct(info, frame, coefs, coef_bits, prev_bits, n_scans, last_good,
                        scale)


def _lossless_planes(data: bytes, info: dict) -> list:
    """data/jpeg_lossless.py's component planes, upsampled to the image's
    size by replication (libjpeg's lossless mode has no fancy upsampling:
    each "block" is one sample)."""
    from vision_kit_tpu_torch.data import jpeg_lossless

    planes = jpeg_lossless.decode_lossless(data, info)
    comps = info["components"]
    max_h = max(h for _, h, _, _ in comps)
    max_v = max(v for _, _, v, _ in comps)
    if len(comps) == 1:
        return planes
    return [_upsample(p, max_h // h, max_v // v, fancy=False)[:info["height"], :info["width"]]
            for p, (_, h, v, _) in zip(planes, comps)]


def scans_short(data: bytes) -> list[int]:
    """For each scan of a JPEG that decode_image takes, how many of its MCUs
    (blocks, in a one-component scan) need Huffman-coded bits past the
    entropy-coded data of their restart interval, which the decoder reads
    as zeros: all 0 for a file whose scans are whole. From the decoder's
    own walks (no IDCT); all 0 for an arithmetic-coded file, which reads
    zeros to the end of each scan. Raises JpegError for a JPEG decode_image
    refuses, and for a lossless one (no DCT scans: no route walks it)."""
    info = jpeg_header(data)
    why = jpeg_refusal(info) or ("a lossless JPEG" if info["sof"] == SOF_LOSSLESS else None)
    if why:
        raise JpegError(why)
    short: list[int] = []
    _coefficients(data, info, short)
    return short


def _coefficients(data: bytes, info: dict, short: list | None = None) -> tuple:
    """Entropy-decode every scan of a JPEG that jpeg_refusal takes: (frame
    geometry, the coefficients of every component's blocks, flat, libjpeg's
    coef_bits and their copy from before the last scan, the number of
    scans, the last good iMCU row of a progressive file). Appends each
    scan's count of MCUs short of bits to `short` when given (none are
    short in an arithmetic-coded scan, which reads zeros to its end)."""
    from vision_kit_tpu_torch.data import jpeg_arith

    progressive = is_progressive(info["sof"])
    arith = info["sof"] in SOF_ARITH
    cond = {k: v[:] for k, v in jpeg_arith.DEFAULT_CONDITIONING.items()}
    height, width = info["height"], info["width"]
    comps = [dict(id=i, h=h, v=v, tq=tq, sof_v=v) for i, h, v, tq in info["components"]]
    if len(comps) == 1:       # one component is never interleaved: 1x1
        comps[0].update(h=1, v=1)
    max_h = max(c["h"] for c in comps)
    max_v = max(c["v"] for c in comps)
    mcu_cols = _ceil_div(width, 8 * max_h)
    mcu_rows = _ceil_div(height, 8 * max_v)
    offsets, total = [], 0
    for c in comps:
        c["bcols"], c["brows"] = mcu_cols * c["h"], mcu_rows * c["v"]
        c["bcols_real"] = _ceil_div(_ceil_div(width * c["h"], max_h), 8)
        c["brows_real"] = _ceil_div(_ceil_div(height * c["v"], max_v), 8)
        offsets.append(total)
        total += c["bcols"] * c["brows"] * 64
    frame = dict(width=width, height=height, comps=comps, max_h=max_h,
                 max_v=max_v, mcu_cols=mcu_cols, mcu_rows=mcu_rows,
                 offsets=offsets)
    coefs = np.zeros(total, np.int32)
    coef_bits = np.full((len(comps), 64), -1, np.int64)
    prev_bits = np.zeros_like(coef_bits)
    imcu_rows = _ceil_div(height, 8 * max(c["sof_v"] for c in comps))
    n_scans = last_good = 0
    qtables, tables, restart = {}, {}, 0
    started = False
    by_id = {c["id"]: i for i, c in enumerate(comps)}
    for m, a, b, end in _walk(data, open_end=True):
        seg = data[a:b]
        if m == DQT:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + size],
                                     ">u2" if pq else np.uint8)
                if len(vals) != 64:
                    raise JpegError("short DQT")
                qt = np.zeros(64, np.int64)
                qt[ZIGZAG[:64]] = vals
                qtables[tq] = qt
                i += 1 + size
        elif m == DHT:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                if len(counts) != 16:
                    raise JpegError("short DHT")
                nsym = sum(counts)
                symbols = list(seg[i + 17:i + 17 + nsym])
                tables[(tc, th)] = _huffman_lookup(counts, symbols, ac=tc == 1)
                i += 17 + nsym
        elif m == DRI:
            restart = (seg[0] << 8) | seg[1]
        elif m == DAC:
            jpeg_arith.read_dac(seg, cond)
        elif m == SOS:
            ns = seg[0]
            if len(seg) < 4 + 2 * ns:
                raise JpegError("short SOS")
            ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            if not (started or progressive or arith):
                # jdhuff.c's jinit_huff_decoder, as decompression starts:
                # sequential slots 0 and 1 that no DHT has defined take the
                # standard tables (Motion-JPEG frames carry none); jdphuff.c
                # fills nothing
                for key in STD_HUFFMAN:
                    tables.setdefault(key, _std_lookup(*key))
            started = True
            if progressive:   # which tables the scan reads
                need = (0,) if ss == 0 and ah == 0 else () if ss == 0 else (1,)
            else:
                need = (0, 1)
            scan_comps = []
            for k in range(ns):
                cid, t = seg[1 + 2 * k], seg[2 + 2 * k]
                if cid not in by_id:
                    raise JpegError("scan names an unknown component")
                td, ta = t >> 4, t & 15
                if not arith and any((tc, (td, ta)[tc]) not in tables for tc in need):
                    raise JpegError("Huffman table not defined")
                ci = by_id[cid]
                if comps[ci]["tq"] not in qtables:
                    raise JpegError("quantization table not defined")
                comps[ci].setdefault("qt", qtables[comps[ci]["tq"]])
                scan_comps.append((ci, td, ta))
            if progressive:
                _progression(coef_bits, [ci for ci, _, _ in scan_comps], ss, se, ah, al,
                             prev_bits, n_scans == 0)
                n_scans += 1
            if arith:
                row = _scan_arith(data, b, end, frame, scan_comps, restart, coefs, cond,
                                  ss, se, ah, al, progressive, short)
            elif progressive:
                row = _scan_progressive(data, b, end, frame, scan_comps, tables,
                                        restart, coefs, ss, se, ah, al, short)
            else:
                _scan(data, b, end, frame, scan_comps, tables, restart, coefs, short)
            if progressive and row is not None:   # jdcoefct.c's last_good_iMCU_row
                last_good = row
    return frame, coefs, coef_bits, prev_bits, n_scans, last_good


def _reconstruct(info, frame, coefs, coef_bits, prev_bits, n_scans, last_good,
                 scale) -> tuple[np.ndarray, int]:
    """The RGB samples of _coefficients' blocks at 1/`scale`: smoothing,
    IDCT, upsampling and colour conversion (see _decode_jpeg)."""
    planes = _planes(info, frame, coefs, coef_bits, prev_bits, n_scans, last_good, scale)
    return _colour(info, planes), info["orientation"]


def _colour(info: dict, planes: list) -> np.ndarray:
    """The (H, W, 3) RGB of a JPEG's upsampled component planes, in the
    colour space jpeg_colour names."""
    colour = jpeg_colour(info)
    if colour == "grey":
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    if colour == "ycc":
        return ycc_to_rgb(*planes)
    if colour == "rgb":
        return np.stack(planes, -1)
    return cmyk_to_rgb(*(planes if colour == "cmyk" else ycck_to_cmyk(*planes)))


def _planes(info, frame, coefs, coef_bits, prev_bits, n_scans, last_good,
            scale) -> list:
    """Each component's samples at 1/`scale`, upsampled to the image's size:
    smoothing, IDCT and upsampling, before any colour conversion."""
    progressive = is_progressive(info["sof"])
    height, width, comps, offsets = (frame["height"], frame["width"], frame["comps"],
                                     frame["offsets"])
    imcu_rows = _ceil_div(height, 8 * max(c["sof_v"] for c in comps))
    max_h, max_v = frame["max_h"], frame["max_v"]
    smooth = _smoothing_bits(coef_bits, [c.get("qt") for c in comps]) if progressive else None
    low = 8 // scale
    out_h, out_w = _ceil_div(height, scale), _ceil_div(width, scale)
    planes = []
    for ci, (c, off, size) in enumerate(zip(
            comps, offsets, scaled_sizes([(c["h"], c["v"]) for c in comps], scale))):
        blocks = coefs[off:off + c["bcols"] * c["brows"] * 64].reshape(c["brows"], c["bcols"], 64)
        if "qt" not in c:
            if not progressive:
                raise JpegError(f"component {c['id']} is in no scan")
            c["qt"] = np.zeros(64, np.int64)   # never scanned: mid grey
        if smooth is not None:
            grid = (c["brows_real"], c["bcols_real"], c["sof_v"], imcu_rows)
            smoothed = _smooth_block_grid(blocks, c["qt"], smooth[ci], *grid)
            # rows past the last good iMCU row take the bits from before
            # the last scan (all unknown after a single scan)
            cut = (last_good + 1) * c["sof_v"]
            if cut < c["brows_real"]:
                prev = [-1] * 10 if n_scans == 1 else [0] + prev_bits[ci, 1:10].tolist()
                smoothed[cut:] = _smooth_block_grid(blocks, c["qt"], prev, *grid)[cut:]
            blocks = smoothed
        plane = _idct_scaled(blocks, c["qt"], size)
        dh = _ceil_div(height * c["v"] * size, max_v * 8)
        dw = _ceil_div(width * c["h"] * size, max_h * 8)
        plane = _upsample(plane[:dh, :dw], max_h * low // (c["h"] * size),
                          max_v * low // (c["v"] * size), fancy=low > 1)
        planes.append(plane[:out_h, :out_w])
    return planes


# -- PNG -------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))   # (y0, x0, dy, dx)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of `h` rows of `row_bytes` bytes (each
    preceded by its filter byte) -> (h, row_bytes) uint8."""
    out = np.zeros((h, row_bytes), np.uint8)
    rows = raw[:h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    prior = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        ft, cur = rows[y, 0], rows[y, 1:]
        if ft == 0:
            rec = cur.copy()
        elif ft == 1:
            pad = (-row_bytes) % bpp
            lanes = np.concatenate([cur, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            rec = (np.cumsum(lanes, axis=0, dtype=np.int64) & 0xFF).astype(
                np.uint8).reshape(-1)[:row_bytes]
        elif ft == 2:
            rec = cur + prior
        elif ft in (3, 4):
            rec = _serial_filter(cur.tolist(), prior.tolist(), bpp, ft)
        else:
            raise ValueError(f"PNG filter type {ft}")
        out[y] = rec
        prior = out[y]
    return out


def _serial_filter(cur: list, prior: list, bpp: int, ft: int) -> np.ndarray:
    """Average (3) and Paeth (4), which depend on the reconstructed byte to
    the left, one byte at a time."""
    rec = cur[:]
    n = len(cur)
    if ft == 3:
        for i in range(n):
            left = rec[i - bpp] if i >= bpp else 0
            rec[i] = (cur[i] + ((left + prior[i]) >> 1)) & 0xFF
    else:
        for i in range(n):
            if i >= bpp:
                a, c = rec[i - bpp], prior[i - bpp]
            else:
                a = c = 0
            b = prior[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = c
            rec[i] = (cur[i] + pred) & 0xFF
    return np.asarray(rec, np.uint8)


def _png_samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """(h, row_bytes) unfiltered rows -> (h, w, channels) uint8 samples:
    the high byte at depth 16 (cv2 strips the low one), else the values of
    `depth` bits."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :2 * w * channels].reshape(h, w, channels, 2)[..., 0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :, None]


def _png_chunks(data: bytes):
    """(type, body) of each chunk after the signature up to IEND or the end
    of the bytes. A truncated chunk, or a critical chunk whose CRC fails,
    raises ValueError; an ancillary chunk whose CRC fails is skipped."""
    pos, n = 8, len(data)
    while pos + 8 <= n:
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        pos += 12 + length
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            if not ctype[0] & 0x20:
                raise ValueError(f"CRC error in {ctype!r}")
            continue
        if ctype == b"IEND":
            return
        yield ctype, body


def png_header(data: bytes) -> dict:
    """height, width and the eXIf orientation of a PNG, from its chunks
    (every CRC checked, no pixel inflated). Raises ValueError for bytes that
    are no PNG, end inside a chunk, or hold no IHDR or IDAT."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    info, idat = {"orientation": 1}, False
    for ctype, body in _png_chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError("malformed IHDR")
            info["width"], info["height"] = struct.unpack(">II", body[:8])
        elif ctype == b"IDAT":
            idat = True
        elif ctype == b"eXIf":
            info["orientation"] = parse_exif_orientation(body)
    if "width" not in info or not idat:
        raise ValueError("no IHDR or IDAT")
    return info


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (colour type 2, depth 8, filter
    None, zlib level 1): the port's lossless image writer, for sample
    grids, synthetic datasets and the demo's .png outputs."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def _decode_png(data: bytes) -> tuple[np.ndarray, int]:
    ihdr, plte, idat, orientation = None, None, [], 1
    for ctype, body in _png_chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf":
            orientation = parse_exif_orientation(body)
    if ihdr is None or not idat:
        raise ValueError("no IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    too_big = size_refusal(w, h)
    if too_big:
        raise ValueError(too_big)
    channels = _CHANNELS.get(ctype)
    if (channels is None or comp or filt or interlace > 1 or w == 0 or h == 0
            or depth not in ((8, 16) if ctype in (2, 4, 6) else
                             (1, 2, 4, 8) if ctype == 3 else (1, 2, 4, 8, 16))):
        raise ValueError("unsupported PNG header")
    raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat)), np.uint8)
    bpp = max(1, channels * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.zeros((h, w, channels), np.uint8)
    off = 0
    for y0, x0, dy, dx in passes:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue
        row_bytes = -(-pw * channels * depth // 8)
        need = ph * (row_bytes + 1)
        if off + need > len(raw):
            raise ValueError("not enough image data")
        rows = _unfilter(raw[off:off + need], ph, row_bytes, bpp)
        off += need
        samples[y0::dy, x0::dx] = _png_samples(rows, pw, depth, channels)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette image without PLTE")
        idx = samples[:, :, 0]
        if int(idx.max()) >= len(plte):
            plte = np.concatenate([plte, np.zeros((256 - len(plte), 3), np.uint8)])
        return plte[idx], orientation
    if depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        return np.repeat(samples[:, :, :1], 3, axis=2), orientation
    return np.ascontiguousarray(samples[:, :, :3]), orientation


# -- BMP (OpenCV's grfmt_bmp.cpp) -----------------------------------------

BMP_RGB, BMP_RLE8, BMP_RLE4, BMP_BITFIELDS = 0, 1, 2, 3


class BmpError(ValueError):
    """Bytes that OpenCV's BMP decoder refuses (or reads past the end of);
    decode_image answers None."""


class _Stream:
    """OpenCV's little-endian RLByteStream over the bytes: reading past the
    end raises `error` (a ValueError), as cv2 then gives None."""

    def __init__(self, data: bytes, pos: int = 0, error: type = BmpError):
        self.data, self.pos, self.error = data, pos, error

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise self.error("unexpected end of the data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def byte(self) -> int:
        return self.take(1)[0]

    def word(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def dword(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def bmp_header(data: bytes) -> dict:
    """BmpDecoder::readHeader: width, height (positive; bottom_up when the
    stored height is), bpp (15 for 16-bit 5-5-5), compression, the pixel
    data's offset and the (256, 3) BGR palette of a palette image. Raises
    BmpError for what OpenCV refuses: a header size other than 12 or 36 and
    more, compression above 3, a bit depth or compression it does not
    take, 16-bit masks other than 5-5-5 and 5-6-5, more than 256 colours, a
    side over 1 << 20 or more than 1 << 30 pixels."""
    if data[:2] != b"BM":
        raise BmpError("not a BMP")
    st = _Stream(data, 10)
    offset, size = st.dword(), st.dword()
    palette = np.zeros((256, 3), np.uint8)
    if size >= 36:
        width, height = st.dword(), st.dword()
        bpp, comp = st.dword() >> 16, st.dword()
        if not 0 <= comp <= BMP_BITFIELDS:
            raise BmpError(f"compression {comp}")
        st.take(12)
        clrused = st.dword()
        st.take(size - 36)
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == BMP_RGB)
            or (bpp in (16, 32) and comp in (BMP_RGB, BMP_BITFIELDS))
            or (bpp == 4 and comp == BMP_RLE4) or (bpp == 8 and comp == BMP_RLE8))
        if not ok:
            raise BmpError(f"{bpp}-bit BMP with compression {comp}")
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise BmpError(f"{clrused} palette colours")
            n = clrused or 1 << bpp
            palette[:n] = np.frombuffer(st.take(4 * n), np.uint8).reshape(n, 4)[:, :3]
        elif bpp == 16 and comp == BMP_BITFIELDS:
            red, green, blue = st.dword(), st.dword(), st.dword()
            if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
                raise BmpError("16-bit masks other than 5-5-5 and 5-6-5")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        width, height, bpp, comp = st.word(), st.word(), st.dword() >> 16, BMP_RGB
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise BmpError(f"{bpp}-bit BMP")
        if bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(st.take(3 * n), np.uint8).reshape(n, 3)
    else:
        raise BmpError(f"header size {size}")
    too_big = size_refusal(width, abs(height))
    if too_big:
        raise BmpError(f"BMP of {too_big}")
    return dict(width=width, height=abs(height), bottom_up=height > 0, bpp=bpp,
                compression=comp, offset=offset, palette=palette, orientation=1)


def _bmp_rle(st: _Stream, info: dict) -> np.ndarray:
    """BmpDecoder::readData's RLE8 and RLE4 loops: (H, W, 3) BGR rows in
    file order. Runs, absolute runs, end of line, end of bitmap and delta,
    each skipped pixel painted with palette entry 0 (in RLE4, as OpenCV
    does, end of bitmap only ends the line and delta moves only right); a
    run past the end of its line, or the bytes ending first, raise."""
    w, h, pal, rle8 = info["width"], info["height"], info["palette"], info["bpp"] == 8
    out = np.empty((h, w, 3), np.uint8)
    flat = out.reshape(-1, 3)
    y = x = 0           # the row being written, the pixel in it
    line_end_flag = 0   # (RLE8) whether the last run ended its line

    def fill(count: int, colour) -> None:   # FillUniColor, count pixels
        nonlocal x, y
        while True:
            n = min(count, w - x)
            flat[y * w + x:y * w + x + n] = colour
            count -= n
            x += n
            if x >= w:
                x = 0
                y += 1
                if y >= h:
                    return
            if count <= 0:
                return

    while True:
        n, code = st.byte(), st.byte()
        if n:                                           # a run
            if x + n > w:
                raise BmpError("RLE run past the end of its line")
            if rle8:
                prev = y
                fill(n, pal[code])
                line_end_flag = y - prev
                if y >= h:
                    break
            else:
                pair = pal[[code >> 4, code & 15]]
                flat[y * w + x:y * w + x + n] = pair[np.arange(n) & 1]
                x += n
        elif code > 2:                                  # an absolute run
            if x + code > w:
                raise BmpError("RLE run past the end of its line")
            if rle8:
                idx = np.frombuffer(st.take((code + 1) & ~1), np.uint8)[:code]
                line_end_flag = 0
            else:
                packed = np.frombuffer(st.take((((code + 1) >> 1) + 1) & ~1), np.uint8)
                idx = np.stack([packed >> 4, packed & 15], 1).reshape(-1)[:code]
            flat[y * w + x:y * w + x + code] = pal[idx]
            x += code
        else:                                           # EOL, EOB, delta
            skip = w - x
            rows = h - y
            if rle8 and not (code or not line_end_flag or skip < w):
                line_end_flag = 0      # EOL right after a run that ended its line
                continue
            if code == 2:
                skip, rows = st.byte(), st.byte()
            if rle8 and code != 0:
                skip += rows * w
                if y >= h:
                    break
            fill(skip, pal[0])   # RLE4 drops the rows: EOB ends a line, delta moves right
            line_end_flag = 0
            if y >= h:
                break
    return out


def _decode_bmp(data: bytes) -> tuple[np.ndarray, int]:
    """cv2.imdecode(IMREAD_COLOR) of a BMP (BmpDecoder) as (H, W, 3) RGB,
    and orientation 1: palettes of 1, 4 and 8 bits, 16-bit 5-5-5 and 5-6-5
    (low bits zero, as cv2 expands them), 24-bit, 32-bit with the fourth
    byte dropped, RLE8 and RLE4; rows bottom-up or top-down."""
    info = bmp_header(data)
    w, h, bpp = info["width"], info["height"], info["bpp"]
    st = _Stream(data, info["offset"])
    if info["compression"] in (BMP_RLE8, BMP_RLE4):
        bgr = _bmp_rle(st, info)
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        rows = np.frombuffer(st.take(pitch * h), np.uint8).reshape(h, pitch)
        if bpp <= 8:
            bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(h, w, bpp)
            idx = (bits * (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)).sum(-1)
            bgr = info["palette"][idx]
        elif bpp in (15, 16):
            t = rows[:, :2 * w].view("<u2").astype(np.int32)
            if bpp == 15:
                bgr = np.stack([t << 3, (t >> 2) & ~7, (t >> 7) & ~7], -1)
            else:
                bgr = np.stack([t << 3, (t >> 3) & ~3, (t >> 8) & ~7], -1)
            bgr = (bgr & 255).astype(np.uint8)
        else:
            bgr = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)[:, :, :3]
    if info["bottom_up"]:
        bgr = bgr[::-1]
    return np.ascontiguousarray(bgr[:, :, ::-1]), 1


def encode_bmp(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of cv2.imwrite('.bmp', BGR): a
    40-byte BITMAPINFOHEADER, 24 bits, bottom-up rows padded to 4 bytes."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    pitch = (3 * w + 3) & -4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    head = 14 + 40
    return (b"BM" + struct.pack("<IiI", head + pitch * h, 0, head)
            + struct.pack("<iiiHHiiiiii", 40, w, h, 1, 24, BMP_RGB, 0, 0, 0, 0, 0)
            + rows.tobytes())


# -- entry points ----------------------------------------------------------


# The kinds that data/<kind>.py decodes, in the order OpenCV's
# ImageCodecInitializer asks the decoders for their signatures
# (loadsave.cpp findDecoder): BMP, GIF, HDR, JPEG, WebP, Sun raster,
# Netpbm and PAM, PFM, TIFF, PNG, JPEG 2000 (JP2, then J2K). No two of
# these signatures overlap. Each is decoded on the host, on its own route
# host_<kind>; JPEG 2000 by the host C++ twin of its plain decoder on the
# card (decode_image(native=True)).
MODULE_KINDS = ("gif", "hdr", "webp", "sunras", "pxm", "pfm", "tiff", "jp2")
# The kinds that the JAX datasets read (their IMG_EXTS); the others are
# served but not trained on.
TRAIN_KINDS = ("jpeg", "png", "bmp", "webp")


def _kind_module(kind: str):
    import importlib

    return importlib.import_module(f"vision_kit_tpu_torch.data.{kind}")


def image_kind(data: bytes) -> str | None:
    """"jpeg", "png", "bmp", "webp", "gif", "hdr", "sunras", "pxm", "pfm",
    "tiff", "jp2" or None, from the leading bytes (each decoder's
    signature)."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:8] == PNG_SIGNATURE:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    for kind in MODULE_KINDS:
        if getattr(_kind_module(kind), f"is_{kind}")(data):
            return kind
    return None


def decode_image(data: bytes, native: bool = False) -> np.ndarray | None:
    """Encoded bytes -> (H, W, 3) uint8 RGB with the EXIF orientation
    applied, or None: cv2.imdecode(IMREAD_COLOR) + BGR2RGB for the kinds
    this module takes (see the module docstring). `native` decodes JPEG
    2000 by the host C++ twin of the plain decoder (csrc/j2k_decode.cu,
    built with nvcc at first use; RuntimeError when it cannot be), the
    same pixels; other kinds take their plain decoder either way."""
    kind = image_kind(data)
    try:
        if kind == "jp2" and native:
            from vision_kit_tpu_torch.data import jp2

            rgb, orientation = jp2.decode_jp2_c(data)
        elif kind == "jpeg":
            rgb, orientation = _decode_jpeg(data)
        elif kind == "png":
            rgb, orientation = _decode_png(data)
        elif kind == "bmp":
            rgb, orientation = _decode_bmp(data)
        elif kind is not None:
            rgb, orientation = getattr(_kind_module(kind), f"decode_{kind}")(data)
        else:
            return None
    except (ValueError, IndexError, struct.error, zlib.error):
        return None
    if not rgb.flags.writeable:   # a view of the bytes (a raw Netpbm, ...)
        rgb = rgb.copy()
    if orientation == 1:
        return rgb
    return apply_orientation(torch.from_numpy(rgb), orientation).numpy()


def decode_jpeg_reduced(data: bytes, scale: int) -> np.ndarray | None:
    """JPEG bytes -> (ceil(H / scale), ceil(W / scale), 3) uint8 RGB with
    the EXIF orientation applied, or None for bytes that are no JPEG or a
    JPEG that decode_image refuses: cv2.imdecode(IMREAD_REDUCED_COLOR_<scale>)
    + BGR2RGB bit for bit, scale 2, 4 or 8 (libjpeg's DCT scaling)."""
    if scale not in (2, 4, 8):
        raise ValueError(f"scale must be 2, 4 or 8, got {scale}")
    if image_kind(data) != "jpeg":
        return None
    try:
        rgb, orientation = _decode_jpeg(data, scale)
    except (ValueError, IndexError, struct.error):
        return None
    if orientation == 1:
        return rgb
    return apply_orientation(torch.from_numpy(rgb), orientation).numpy()


PROBE_BYTES = 256 * 1024


def probe_jpeg(data: bytes) -> tuple[int, int, bool] | None:
    """(h0, w0, has_exif) of a JPEG from its first 256 KiB, without
    decoding, or None when they do not parse as a JPEG with a frame header:
    the port's copy of the JAX package's datasets._probe_jpeg (and of
    native/vkio.cpp's ProbeJpeg), which gate data.fast_decode. Fill bytes
    are skipped, standalone markers carry no length, an SOS or EOI before
    any SOF gives None, and an Exif APP1 anywhere before the SOF sets
    has_exif. A frame that no scale decodes (a side over libjpeg's 65500,
    or over OpenCV's size limits even at 1/8) gives None: the full decode
    that the caller falls back to refuses it too."""
    buf = data[:PROBE_BYTES]
    n = len(buf)
    if n < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    has_exif = False
    pos = 2
    while pos + 4 <= n:
        if buf[pos] != 0xFF:
            return None
        m = pos + 1
        while m < n and buf[m] == 0xFF:
            m += 1
        if m >= n:
            return None
        marker = buf[m]
        pos = m + 1
        if marker == 0xD8 or marker == 0x01 or RST0 <= marker <= RST0 + 7:
            continue
        if marker in (EOI, SOS):
            return None
        if pos + 2 > n:
            return None
        length = (buf[pos] << 8) | buf[pos + 1]
        if length < 2 or pos + length > n:
            return None
        payload = buf[pos + 2:pos + length]
        if marker == 0xE1 and payload[:6] == b"Exif\0\0":
            has_exif = True
        if marker in SOF_ALL:
            if len(payload) < 5:
                return None
            h0 = (payload[1] << 8) | payload[2]
            w0 = (payload[3] << 8) | payload[4]
            if h0 <= 0 or w0 <= 0:
                return None
            if max(h0, w0) > JPEG_MAX_DIMENSION or size_refusal(-(-w0 // 8), -(-h0 // 8)):
                return None   # refused at every scale (libjpeg, OpenCV's limits)
            return h0, w0, has_exif
        pos += length
    return None


# -- JPEG: a truncated file, as Pillow reads it ----------------------------

# Image.MAX_IMAGE_PIXELS * 2: Pillow's DecompressionBombError, raised by
# Image.open for a larger frame
PIL_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
_XMP = b"http://ns.adobe.com/xap/1.0/\0"
_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')


def _exif_orientation_tag(tiff: bytes) -> int | None:
    """Tag 0x0112 of IFD0 of a TIFF-structured EXIF block, SHORT or LONG, as
    Pillow's Exif reads it; None when absent or malformed."""
    try:
        end = {b"II": "<", b"MM": ">"}[tiff[:2]]
        ifd = struct.unpack(end + "I", tiff[4:8])[0]
        n = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
        for i in range(n):
            off = ifd + 2 + 12 * i
            tag, typ, count = struct.unpack(end + "HHI", tiff[off:off + 8])
            if tag == 0x0112 and count == 1 and typ in (3, 4):
                return struct.unpack(end + ("H" if typ == 3 else "I"),
                                     tiff[off + 8:off + (10 if typ == 3 else 12)])[0]
    except (KeyError, struct.error, IndexError):
        pass
    return None


def _first_scan_start(data: bytes) -> int:
    """Where the entropy-coded data of a JPEG's first scan starts (the end
    of its SOS segment), from the segments before it, each whole; raises
    JpegError when the bytes end or break before it, where Pillow's
    Image.open raises."""
    n, pos = len(data), 2
    if n < 3 or data[:3] != b"\xff\xd8\xff":
        raise JpegError("not a JPEG")
    while pos < n:
        if data[pos] != 0xFF:
            raise JpegError("marker expected")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == EOI:
            raise JpegError("EOI before any scan")
        if m == 0x01 or RST0 <= m <= RST0 + 7:
            continue
        length = (data[pos] << 8) | data[pos + 1] if pos + 2 <= n else 0
        if length < 2 or pos + length > n:
            break
        pos += length
        if m == SOS:
            return pos
    raise JpegError("the bytes end inside the header, before the first scan")


def decode_truncated_jpeg(data: bytes) -> tuple[str, np.ndarray, dict]:
    """What Pillow's Image.open + load() with ImageFile.LOAD_TRUNCATED_IMAGES
    give for JPEG bytes, as the JAX package's integrity scan reads a JPEG
    without its EOI marker: (Pillow's mode "L", "RGB" or "CMYK", the (H, W,
    C) uint8 samples in stored order as libjpeg hands them over (CMYK as
    libjpeg's JCS_CMYK, which Pillow stores inverted), and the header's
    "orientation" (Pillow's getexif: IFD0 of the first Exif APP1, else an
    XMP tiff:Orientation) and "comment" (the last COM, which Pillow's save
    writes back)).

    Pillow feeds libjpeg an EOI marker when the file ends, so the samples
    are decode_image's of the bytes plus an EOI (the rows and scans decoded
    before the data ran out, missing blocks grey, block smoothing for a
    progressive file; a lossless frame read as zeros past its data; a grey
    lossless frame too, which Pillow reads as "L"), where that decodes.
    Where it does not, libjpeg has stopped at an error, which Pillow
    ignores in this mode: a frame libjpeg decodes to nothing (arithmetic
    lossless, hierarchical, a lossless frame of another colour family,
    sampling it refuses) or a multi-scan file (progressive, or a first scan
    without every component; the bytes end inside a segment after the
    first scan) has output no row: zeros, as Pillow allocates the image; a
    one-scan file has output every row of its whole scan. An
    arithmetic-coded scan cannot wait for the EOI (jdarith.c's get_byte
    cannot suspend): where it needs a byte past the bytes, libjpeg stops,
    after the rows of the iMCU rows before that one (less the last row
    group, for fancy upsampling that needs the next rows) in a one-scan
    file, and none in a multi-scan one. Raises JpegError where Image.open
    raises (the bytes end before the first scan's data, a frame Pillow
    refuses or over its decompression-bomb limit) and where the port
    refuses the frame's size (jpeg_size_refusal)."""
    from vision_kit_tpu_torch.data import jpeg_arith

    start = _first_scan_start(data)
    header = data[:start] + b"\xff\xd9"   # the segments before the first scan's data
    info = jpeg_header(header)
    why = pil_refusal(info) or jpeg_size_refusal(info)
    if why:
        raise JpegError(why)
    width, height = info["width"], info["height"]
    if width * height > PIL_MAX_PIXELS:
        raise JpegError(f"{width}x{height}, over Pillow's decompression-bomb limit")
    meta = {"orientation": 1, "comment": None}
    exif = xmp = None
    for m, a, b, _ in _walk(header):
        seg = header[a:b]
        if m == 0xE1 and seg[:6] == b"Exif\0\0" and exif is None:
            exif = seg[6:]
        elif m == 0xE1 and seg.startswith(_XMP):
            xmp = seg[len(_XMP):]
        elif m == 0xFE:
            meta["comment"] = seg
    tag = _exif_orientation_tag(exif) if exif is not None else None
    if tag is None and xmp is not None:
        found = _XMP_ORIENTATION.search(xmp)
        tag = int(found[2]) if found else None
    meta["orientation"] = 1 if tag is None else tag

    rows = height   # the rows libjpeg outputs before it stops
    if info["sof"] in SOF_ARITH:
        try:
            _coefficients(data, jpeg_header(data))
        except jpeg_arith.BytesEnd as e:
            comps = info["components"]
            max_v = 1 if len(comps) == 1 else max(v for _, _, v, _ in comps)
            context = len(comps) > 1 and any(max_v == 2 * v for _, _, v, _ in comps)
            rows = 0 if info["multi_scan"] else max(e.row * 8 * max_v - max_v * context, 0)
        except (ValueError, IndexError, struct.error):
            pass
    # the bytes plus an EOI; for a one-scan file, its first scan whole
    tries = [data] if info["multi_scan"] else [data, data[:_scan_end(data, start) or 0]]
    planes = None
    for jpeg in tries if rows else ():
        try:
            whole = jpeg_header(jpeg + b"\xff\xd9")
            why = jpeg_refusal(whole, pillow=True)
            if why:
                raise JpegError(why)
            if whole["sof"] == SOF_LOSSLESS:
                planes = _lossless_planes(jpeg + b"\xff\xd9", whole)
            else:
                planes = _planes(whole, *_coefficients(jpeg + b"\xff\xd9", whole), 1)
            break
        except (ValueError, IndexError, struct.error):
            continue
    colour = jpeg_colour(info)
    mode = {1: "L", 3: "RGB", 4: "CMYK"}[len(info["components"])]
    if planes is None:   # no row output; Pillow's CMYK zeros are 255 to libjpeg
        fill = 255 if mode == "CMYK" else 0
        return mode, np.full((height, width, len(info["components"])), fill, np.uint8), meta
    if colour == "ycc":
        out = ycc_to_rgb(*planes)
    elif colour == "ycck":
        out = np.stack(ycck_to_cmyk(*planes), -1)
    else:
        out = np.stack(planes, -1)
    out[rows:] = 255 if mode == "CMYK" else 0
    return mode, out, meta


# -- nvJPEG on the card ----------------------------------------------------

NVJPEG_OUTPUT_Y, NVJPEG_OUTPUT_RGBI = 2, 5   # nvjpegOutputFormat_t

# nvJPEG's pixels against the plain decoder's, per image: the largest
# |difference|, the mean |difference| and the share of values more than 2
# apart. nvJPEG's IDCT is within 3 of libjpeg's islow (4:4:4 and grey
# samples), but it upsamples chroma by replication where libjpeg filters
# (3/4 near, 1/4 far), so a sharp colour edge in a 4:2:0 or 4:2:2 image
# differs by up to a quarter of its chroma step (1.772 of it in blue).
# Set from the committed samples on an H100 (nvJPEG 12.4.0): largest 114,
# mean 1.19, share 0.069 (PERF.md, PR 7).
NVJPEG_TOLERANCE = {"max_abs": 128, "mean_abs": 1.5, "share_over_2": 0.08}


def pixel_agreement(got: torch.Tensor, want: np.ndarray) -> dict:
    """max_abs, mean_abs and share_over_2 of |got - want| over all values."""
    diff = (got.cpu().to(torch.int16) - torch.from_numpy(want).to(torch.int16)).abs()
    return {"max_abs": int(diff.max()), "mean_abs": float(diff.float().mean()),
            "share_over_2": float((diff > 2).float().mean())}


def within_nvjpeg_tolerance(agreement: dict) -> bool:
    return all(agreement[k] <= v for k, v in NVJPEG_TOLERANCE.items())


@functools.cache
def _jpeg_lib() -> ctypes.CDLL:
    from vision_kit_tpu_torch import _cuda_build

    lib = _cuda_build.load("jpeg_decode")
    ptr, size, ip = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
    for name, args in (
            ("vk_jpeg_version", [ip, ip, ip]),
            ("vk_jpeg_create", [ctypes.POINTER(ptr)]),
            ("vk_jpeg_destroy", [ptr]),
            ("vk_jpeg_state_create", [ptr, ctypes.POINTER(ptr)]),
            ("vk_jpeg_state_destroy", [ptr]),
            ("vk_jpeg_info", [ptr, ctypes.c_char_p, size, ip, ip, ip, ip]),
            ("vk_jpeg_decode", [ptr, ptr, ctypes.c_char_p, size, ptr, size,
                                ctypes.c_int, ptr])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def nvjpeg_version() -> str:
    """The nvJPEG library's version, major.minor.patch."""
    v = [ctypes.c_int() for _ in range(3)]
    status = _jpeg_lib().vk_jpeg_version(*(ctypes.byref(x) for x in v))
    if status:
        raise RuntimeError(f"nvjpegGetProperty failed: status {status}")
    return ".".join(str(x.value) for x in v)


class NvJpeg:
    """nvJPEG on one device: a handle (thread safe) and a pool of decode
    states, each serving one decode at a time, so that concurrent callers
    (the server's handler threads) never share one. nvjpegDecode returns
    before its work on the stream has run, and that work reads buffers the
    state owns: a state goes back to the pool with an event recorded after
    its decode, and the next decode on it waits for that event first."""

    def __init__(self, device: torch.device):
        self.lib = _jpeg_lib()
        self.device = device
        self.handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            status = self.lib.vk_jpeg_create(ctypes.byref(self.handle))
        if status:
            raise RuntimeError(f"nvjpegCreateSimple failed: status {status}")
        self._states: queue.SimpleQueue = queue.SimpleQueue()

    def _state(self) -> ctypes.c_void_p:
        try:
            state, done = self._states.get_nowait()
        except queue.Empty:
            state = ctypes.c_void_p()
            status = self.lib.vk_jpeg_state_create(self.handle, ctypes.byref(state))
            if status:
                raise RuntimeError(f"nvjpegJpegStateCreate failed: status {status}")
            return state
        done.synchronize()
        return state

    def decode(self, data: bytes, ncomp: int) -> torch.Tensor | None:
        """(H, W, 3) uint8 RGB in stored order on the current stream, or None
        when nvJPEG refuses the bytes. A grey JPEG decodes its Y plane,
        replicated to three channels."""
        c = [ctypes.c_int() for _ in range(4)]
        status = self.lib.vk_jpeg_info(self.handle, data, len(data),
                                       *(ctypes.byref(x) for x in c))
        if status:
            return None
        w, h = c[2].value, c[3].value
        grey = ncomp == 1
        out = torch.empty((h, w) if grey else (h, w, 3), dtype=torch.uint8,
                          device=self.device)
        stream = torch.cuda.current_stream(self.device)
        state = self._state()
        try:
            status = self.lib.vk_jpeg_decode(
                self.handle, state, data, len(data), out.data_ptr(),
                w if grey else 3 * w,
                NVJPEG_OUTPUT_Y if grey else NVJPEG_OUTPUT_RGBI, stream.cuda_stream)
        finally:
            done = torch.cuda.Event()
            done.record(stream)
            self._states.put((state, done))
        if status >= 1000:
            raise RuntimeError(f"nvjpegDecode left CUDA error {status - 1000}")
        if status:
            return None
        return out[:, :, None].expand(h, w, 3) if grey else out


_nvjpeg: dict = {}
_nvjpeg_lock = threading.Lock()


def _decoder(device: torch.device) -> NvJpeg:
    with _nvjpeg_lock:
        dec = _nvjpeg.get(device)
        if dec is None:
            dec = _nvjpeg[device] = NvJpeg(device)
        return dec


@functools.cache
def _walk_lib() -> ctypes.CDLL:
    from vision_kit_tpu_torch import _cuda_build

    lib = _cuda_build.load("jpeg_walk")
    lib.vk_jpeg_scans_short.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.vk_jpeg_scans_short.restype = ctypes.c_int
    return lib


def walk_scans_short(data: bytes) -> list[int]:
    """scans_short by the host C walk of csrc/jpeg_walk.cu (built with nvcc,
    loaded with ctypes): the same counts, in C++ instead of the plain
    decoder's Python loops. Raises JpegError for bytes the walk does not
    read as a Huffman JPEG, and RuntimeError (from the build) when the
    library cannot be built or loaded."""
    fn = _walk_lib().vk_jpeg_scans_short
    cap = 32
    while True:
        out = (ctypes.c_int * cap)()
        n = fn(data, len(data), out, cap)
        if n < 0:
            raise JpegError(f"the C walk cannot read these bytes (status {n})")
        if n <= cap:
            return list(out[:n])
        cap = n


ROUTES = ("nvjpeg", "nvjpeg_progressive", "host_smoothed", "host_colour",
          "host_cut", "host_arith", "host_lossless", "host_jpeg", "host_png", "host_bmp",
          *(f"host_{kind}" for kind in MODULE_KINDS), "refused")
route_counts = dict.fromkeys(ROUTES, 0)   # decode_to's decodes by route


def _route(data: bytes, device: torch.device, walk=None):
    """(route, JPEG header or None) of `data` on `device`, from its header
    alone (no entropy decoding): an arithmetic-coded JPEG ("host_arith")
    and a lossless one ("host_lossless") decode on the host on any device
    (nvJPEG reads neither); on a CUDA device a baseline or extended
    sequential JPEG in YCbCr or grey goes to nvJPEG ("nvjpeg"), so does a
    progressive one whose scans complete every coefficient
    ("nvjpeg_progressive"); a progressive JPEG that leaves coefficient bits
    unknown ("host_smoothed": libjpeg smooths its blocks, nvJPEG does not)
    and a CMYK, YCCK or RGB JPEG ("host_colour") decode on the host, as
    does every other JPEG on the CPU ("host_jpeg") and every other kind
    image_kind names ("host_png", "host_tiff", ...), while bytes of no kind
    are "refused". A one-scan JPEG
    that the bytes end inside ("host_cut": libjpeg decodes it or suspends,
    as its bit buffer reads ahead) decodes on the host. Before nvJPEG, the
    host C walk (walk_scans_short) reads every scan's Huffman codes: a
    JPEG in which any scan needs bits past its data ("host_cut": libjpeg
    reads them as zeros) or that the walk cannot read decodes on the host
    too."""
    kind = image_kind(data)
    if kind != "jpeg":
        return ("refused" if kind is None else f"host_{kind}"), None
    try:
        info = jpeg_header(data)
    except (JpegError, IndexError, struct.error):
        return "refused", None
    if jpeg_refusal(info):
        return "refused", info
    if info["sof"] in SOF_ARITH:
        return "host_arith", info
    if info["sof"] == SOF_LOSSLESS:
        return "host_lossless", info
    if device.type != "cuda":
        return "host_jpeg", info
    if jpeg_colour(info) not in ("grey", "ycc"):
        return "host_colour", info
    if info["sof"] == SOF_PROGRESSIVE and not info["complete"]:
        return "host_smoothed", info
    if info["open_scan"]:
        return "host_cut", info
    try:
        cut = any((walk or walk_scans_short)(data))
    except (ValueError, IndexError):   # bytes the walk cannot read
        cut = True
    if cut:
        return "host_cut", info
    return ("nvjpeg_progressive" if info["sof"] == SOF_PROGRESSIVE else "nvjpeg"), info


def decode_route(data: bytes, device: str | torch.device = "cuda", walk=None) -> str:
    """Which decoder decode_to takes for `data` on `device` (see _route),
    touching no CUDA. `walk` replaces the C walk of a JPEG bound for nvJPEG
    (scans_short, its plain version, where no card or nvcc is present)."""
    return _route(data, torch.device(device), walk)[0]


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"decode_jpeg_cuda decodes on a CUDA device, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def with_standard_tables(data: bytes, info: dict) -> bytes:
    """A sequential JPEG with the standard Huffman tables that libjpeg gives
    its undefined slots 0 and 1 (see _coefficients) spliced in as one DHT
    segment before its first SOS, so that a decoder without jdhuff.c's
    default (nvJPEG) reads it; other bytes as they are."""
    missing = [k for k in STD_HUFFMAN if k not in info["huffman"]]
    if info["sof"] == SOF_PROGRESSIVE or not missing:
        return data
    body = b"".join(bytes([tc << 4 | th, *STD_HUFFMAN[(tc, th)][0]]) + STD_HUFFMAN[(tc, th)][1]
                    for tc, th in missing)
    at = info["first_scan"]
    return data[:at] + struct.pack(">BBH", 0xFF, DHT, len(body) + 2) + body + data[at:]


def _nvjpeg_decode(data: bytes, device: torch.device, info: dict) -> torch.Tensor | None:
    with _nvjpeg_lock:   # handler threads decode concurrently
        decode_jpeg_cuda.calls += 1
    img = _decoder(device).decode(with_standard_tables(data, info), len(info["components"]))
    if img is None:
        return None
    return apply_orientation(img, info["orientation"])


def decode_jpeg_cuda(data: bytes, device: str | torch.device = "cuda") -> torch.Tensor | None:
    """JPEG bytes -> (H, W, 3) uint8 RGB on the card, oriented as its EXIF
    says, or None. The header is read on the host first and only the
    routes "nvjpeg" and "nvjpeg_progressive" reach nvJPEG: what
    decode_image refuses (and bytes that end inside a scan) gives None, as
    do the JPEGs that decode_to decodes on the host (CMYK, YCCK, RGB, a
    progressive file with unknown coefficient bits, a file whose scans run
    out of bits or that the C walk cannot read); nvJPEG then decodes on
    the current stream, and a status it returns for corrupt data also gives
    None. Each decode that reaches nvJPEG adds one to
    `decode_jpeg_cuda.calls`."""
    device = _card(device)
    route, info = _route(data, device)
    if not route.startswith("nvjpeg"):
        return None
    return _nvjpeg_decode(data, device, info)


decode_jpeg_cuda.calls = 0


def decode_to(data: bytes, device: str | torch.device,
              host_decode=None) -> torch.Tensor | None:
    """Encoded bytes -> (H, W, 3) uint8 RGB tensor on `device`, oriented as
    the EXIF says, or None, by the route its header picks (_route): nvJPEG
    on the card, else `host_decode` (decode_image, or a call that runs it
    elsewhere; by default decode_image with the host C++ JPEG 2000 decoder
    on a CUDA device and the plain one on the CPU) on the host and an
    upload. Adds one to `route_counts[route]`. A JPEG that nvJPEG refuses
    is not handed to the host decoder."""
    device = torch.device(device)
    if device.type == "cuda":
        device = _card(device)
    if host_decode is None:
        host_decode = functools.partial(decode_image, native=device.type == "cuda")
    route, info = _route(data, device)
    with _nvjpeg_lock:
        route_counts[route] += 1
    if route == "refused":
        return None
    if route.startswith("nvjpeg"):
        return _nvjpeg_decode(data, device, info)
    rgb = host_decode(data)
    return None if rgb is None else torch.from_numpy(rgb).to(device)
