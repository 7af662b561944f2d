"""Netpbm and PAM decode without OpenCV: cv2.imdecode(IMREAD_COLOR) +
BGR2RGB of a PBM, PGM, PPM (P1-P6) or PAM (P7) file, bit for bit, in numpy
and the standard library.

The reference is OpenCV 5's grfmt_pxm.cpp and grfmt_pam.cpp as cv2 runs
them, which differ from the Netpbm specification in places:

- P1-P6 (PxMDecoder): the signature is "P", a digit 1-6 and a C isspace
  byte. Each header number is ReadNumber: whitespace and "#" comments
  (to a CR or LF) skipped, then digits (a value over INT_MAX refused),
  then ONE more byte consumed whatever it is, so that a comment glued to a
  number eats its "#" and fails on its text. Width and height must be
  positive, maxval 1-65535 (P1 and P4 have none). Raw samples follow that
  byte: 8-bit ones as they are, whatever the maxval (no scaling, no
  clamp), 16-bit ones (maxval over 255) big-endian and then `>> 8`, rows
  of (width x bits + 7) / 8 bytes. ASCII samples are ReadNumber too,
  clamped to maxval, then `v * 255 // maxval` where maxval is at most 255
  and `v >> 8` above it; P1's are one digit each (no byte after), any
  non-zero digit black. A P1 or P4 bit of 1 is black. A file that ends
  before its last sample (or, in ASCII, before the byte after it) is
  refused.
- P7 (PAMDecoder): "P7" and a CR or LF, then lines of an identifier of at
  most 8 bytes (ENDHDR, HEIGHT, WIDTH, DEPTH, MAXVAL, TUPLTYPE; any other
  is refused), its value to the end of the line, comments and empty
  lines; each field at most once, all but TUPLTYPE required. TUPLTYPE is
  BLACKANDWHITE, GRAYSCALE, GRAYSCALE_ALPHA, RGB or RGB_ALPHA, and must
  agree with DEPTH (1, 1, 2, 3, 4); without it DEPTH 1 or 3 with a maxval
  under 256 is taken. Samples are raw, big-endian past maxval 255 and
  then `>> 8`, never scaled. Maxval 1 is "bit mode": each row still
  takes width x depth bytes, but is read as packed bits, MSB first, 1
  white. Three channels are copied as they are stored: cv2 takes a PAM's
  RGB tuples for BGR, so the channels come out reversed. GRAYSCALE_ALPHA
  and RGB_ALPHA go through OpenCV's basic_conversion, whose loop stops
  after ceil(width / depth) pixels of each row: the rest of the row is
  whatever the allocator gave cv2 (undefined). Here those pixels are
  zero; the defined pixels equal cv2's.
"""

from __future__ import annotations

import re

import numpy as np

from vision_kit_tpu_torch.data.decode import _Stream, size_refusal


class PxmError(ValueError):
    """Bytes that cv2 does not decode as Netpbm or PAM; decode_image
    answers None."""


_SPACE = b" \t\n\v\f\r"
_SKIP = rb"(?:[\t-\r ]+|#[^\n\r]*[\n\r])*"
_NUMBER = re.compile(_SKIP + rb"([0-9]+)[^0-9]")   # ReadNumber: digits and one byte after
_DIGIT = re.compile(_SKIP + rb"([0-9])")           # ReadNumber(maxdigits=1)
INT_MAX = (1 << 31) - 1


def is_pxm(data: bytes) -> bool:
    """PxMDecoder's or PAMDecoder's signature: "P1"-"P7" and a space byte
    (PAM: CR or LF, refused later otherwise)."""
    return len(data) >= 3 and data[0] == 0x50 and 0x31 <= data[1] <= 0x37 and data[2] in _SPACE


def _numbers(data: bytes, pos: int, n: int, pattern=_NUMBER) -> tuple[list[int], int]:
    """n ReadNumber values from `pos`, and the position after them."""
    out = []
    for m in pattern.finditer(data, pos):
        if m.start() != pos:
            break
        v = int(m.group(1))
        if v > INT_MAX:
            raise PxmError("PXM: a number over INT_MAX")
        out.append(v)
        pos = m.end()
        if len(out) == n:
            return out, pos
    raise PxmError("PXM: a byte no number starts with, or the end of the data")


def pxm_header(data: bytes) -> dict:
    """Width, height, orientation (1) and the fields of a P1-P6 file, as
    PxMDecoder::readHeader reads them."""
    if not is_pxm(data) or data[1] == 0x37:
        raise PxmError("not a P1-P6 file")
    code = data[1] - 0x30
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[code]
    (width, height), pos = _numbers(data, 2, 2)
    maxval = 1
    if bpp > 1:
        (maxval,), pos = _numbers(data, pos, 1)
    if maxval > 65535 or width <= 0 or height <= 0 or maxval <= 0:
        raise PxmError(f"PXM header {width}x{height}, maxval {maxval}")
    return dict(width=width, height=height, bpp=bpp, binary=code >= 4, maxval=maxval,
                offset=pos, orientation=1)


def _decode_pnm(data: bytes) -> np.ndarray:
    info = pxm_header(data)
    w, h, bpp, maxval, pos = (info[k] for k in ("width", "height", "bpp", "maxval", "offset"))
    if size_refusal(w, h):
        raise PxmError(size_refusal(w, h))
    nch = 3 if bpp == 24 else 1
    if bpp == 1:
        if info["binary"]:
            pitch = (w + 7) // 8
            if pos + pitch * h > len(data):
                raise PxmError("PBM: the data ends early")
            rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
            bits = np.unpackbits(rows, axis=1)[:, :w]
        else:
            bits = np.array(_numbers(data, pos, w * h, _DIGIT)[0], np.int64).reshape(h, w) != 0
        return np.repeat(np.where(bits, 0, 255).astype(np.uint8)[:, :, None], 3, 2)
    if info["binary"]:
        size = 2 if maxval > 255 else 1
        n = w * h * nch
        if pos + n * size > len(data):
            raise PxmError("PXM: the data ends early")
        v = np.frombuffer(data, ">u2" if size == 2 else np.uint8, n, pos)
        v = (v >> 8).astype(np.uint8) if size == 2 else v
    else:
        v = np.minimum(np.array(_numbers(data, pos, w * h * nch)[0], np.int64), maxval)
        v = (v >> 8 if maxval > 255 else v * 255 // maxval).astype(np.uint8)
    v = v.reshape(h, w, nch)
    return np.repeat(v, 3, 2) if nch == 1 else v


# -- PAM ---------------------------------------------------------------------

_FIELDS = (b"ENDHDR", b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE")
_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
              b"RGB_ALPHA": 4}


def _pam_line(st: _Stream):
    """ReadPAMHeaderLine: (field or None for a comment or empty line, value)."""
    code = st.byte()
    while code in _SPACE:
        code = st.byte()
    if code == 0x23:                          # '#': to the end of the line
        while code not in (0x0A, 0x0D):
            code = st.byte()
        return None, b""
    ident = bytearray()
    while len(ident) < 8 and code not in _SPACE:
        ident.append(code)
        code = st.byte()
    ident = bytes(ident).split(b"\0")[0]   # compared as a C string
    if code not in _SPACE or ident not in _FIELDS:
        raise PxmError(f"PAM: header field {ident!r}")
    if code in (0x0A, 0x0D):
        return ident, b""
    code = st.byte()
    while code in _SPACE:
        code = st.byte()
    value = bytearray()
    while len(value) < 255 and code not in (0x0A, 0x0D):
        value.append(code)
        code = st.byte()
    if code not in (0x0A, 0x0D):
        raise PxmError("PAM: a header value runs past 255 bytes")
    return ident, bytes(value).rstrip(_SPACE).split(b"\0")[0]


def _parse_int(value: bytes) -> int:
    """OpenCV's ParseInt: an optional "-", digits (under INT_MAX), nothing
    after them."""
    m = re.match(rb"(-?)([0-9]*)", value)
    if m.group(1) and not m.group(2) or m.end() < len(value):
        raise PxmError(f"PAM: {value!r} is not a number")
    v = int(m.group(2) or b"0")
    if v >= INT_MAX:
        raise PxmError("PAM: a number over INT_MAX")
    return -v if m.group(1) else v


def pam_header(data: bytes) -> dict:
    """Width, height, orientation (1) and the fields of a P7 file, as
    PAMDecoder::readHeader reads them."""
    if data[:2] != b"P7" or len(data) < 3 or data[2] not in (0x0A, 0x0D):
        raise PxmError("not a PAM file")
    st = _Stream(data, 3, PxmError)
    got: dict = {}
    tupltype = None
    while True:
        field, value = _pam_line(st)
        if field is None:
            continue
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":   # an empty one is OpenCV's "no format"
            if value and value not in _TUPLTYPES:
                raise PxmError(f"PAM: TUPLTYPE {value!r}")
            tupltype = value or None
            continue
        if field in got:
            raise PxmError(f"PAM: {field.decode()} twice")
        got[field] = _parse_int(value)
        if field == b"MAXVAL" and got[field] > 65535:
            raise PxmError("PAM: maxval over 65535")
    if len(got) < 4:
        raise PxmError("PAM: a required field is missing")
    width, height, depth, maxval = (got[k] for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    if tupltype is None:
        if not (depth in (1, 3) and maxval < 256):
            raise PxmError("PAM: no TUPLTYPE for this depth and maxval")
    elif _TUPLTYPES[tupltype] != depth:
        raise PxmError(f"PAM: TUPLTYPE {tupltype.decode()} with depth {depth}")
    if width <= 0 or height <= 0:   # OpenCV's size check refuses these
        raise PxmError(f"PAM: {width}x{height}")
    return dict(width=width, height=height, depth=depth, maxval=maxval, offset=st.pos,
                orientation=1)


def _decode_pam(data: bytes) -> np.ndarray:
    info = pam_header(data)
    w, h, depth, maxval, pos = (info[k] for k in ("width", "height", "depth", "maxval", "offset"))
    if size_refusal(w, h):
        raise PxmError(size_refusal(w, h))
    size = 2 if maxval > 255 else 1
    stride = w * depth * size
    if pos + stride * h > len(data):
        raise PxmError("PAM: the data ends early")
    rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)
    if maxval == 1:                                     # bit mode
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return np.repeat((bits * 255).astype(np.uint8)[:, :, None], 3, 2)
    v = rows.reshape(h, w * depth, size)[:, :, 0]      # the high byte of a 16-bit sample
    v = v.reshape(h, w, depth)
    if depth == 3:
        return np.ascontiguousarray(v[:, :, ::-1])     # stored order taken for BGR
    if depth == 1:
        return np.repeat(v, 3, 2)
    out = np.zeros((h, w, 3), np.uint8)
    n = -(-w // depth)                                  # basic_conversion's pixels
    if depth == 2:
        out[:, :n] = v[:, :n, :1]
    else:
        out[:, :n] = v[:, :n, :3]
    return out


def decode_pxm(data: bytes) -> tuple[np.ndarray, int]:
    """cv2.imdecode(IMREAD_COLOR) of a P1-P7 file as (H, W, 3) RGB, and
    orientation 1 (see the module docstring). Raises PxmError where cv2
    gives None."""
    rgb = _decode_pam(data) if data[1:2] == b"7" else _decode_pnm(data)
    return rgb, 1
