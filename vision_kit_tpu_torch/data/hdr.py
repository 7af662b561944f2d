"""Radiance HDR decode without OpenCV: cv2.imdecode(IMREAD_COLOR) +
BGR2RGB of a Radiance RGBE file (.hdr, .pic), bit for bit, in numpy.

The reference is OpenCV 5's grfmt_hdr.cpp and rgbe.cpp as cv2 runs them:

- The signature is "#?RGBE" or "#?RADIANCE". The header is read with
  fgets into a 128-byte buffer (a longer line comes back in pieces of 127
  bytes) and compared as C strings: lines up to the first empty one, one
  of which must be exactly
  "FORMAT=32-bit_rle_rgbe" (32-bit_rle_xyze is refused, as is a file
  whose header ends before it); then a line that sscanf reads as "-Y %d
  +X %d" (the only orientation taken: +Y, -X or +X first are refused).
  A height or width under 1 is refused.
- The pixels (RGBE_ReadPixels_RLE): a width under 8 or over 0x7FFF is
  read flat, four bytes a pixel. Otherwise each scanline starts with 2, 2
  and its width in 15 bits; its four channels follow one after the other
  as runs (a count over 128 repeats the next byte count - 128 times) and
  literal spans (a count of 1-128 bytes), none of them empty or past the
  channel's end. A scanline that does not start with 2, 2 (and a clear
  high bit) ends the RLE: from that pixel on the rest of the image is
  read flat. Old-style Radiance runs (1, 1, 1, n) are not read as runs.
  Any read past the end refuses the file.
- The conversion: a pixel with exponent e > 0 is m x float(2^(e - 136))
  for each mantissa m, else 0; then OpenCV's convertTo(CV_8U, 255): x 255
  in float32 (exact here), rounded half to even, values of 2^31 and more
  to 0 (saturate_cast's vector path), the rest clamped to 255.
"""

from __future__ import annotations

import re

import numpy as np

from vision_kit_tpu_torch.data.decode import size_refusal
from vision_kit_tpu_torch.data.pfm import saturate_u8

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y[\t-\r ]*([+-]?[0-9]+)[\t-\r ]*\+X[\t-\r ]*([+-]?[0-9]+)")


class HdrError(ValueError):
    """Bytes that cv2 does not decode as Radiance HDR; decode_image answers
    None."""


def is_hdr(data: bytes) -> bool:
    """HdrDecoder's signature."""
    return data.startswith(SIGNATURES)


def _fgets(data: bytes, pos: int) -> tuple[bytes, int]:
    """fgets(buf, 128): up to 127 bytes, through the first LF; the C string
    they make (cut at a NUL) and the position after them."""
    if pos >= len(data):
        raise HdrError("RGBE read error")
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end].split(b"\0")[0], end


def _c_int(digits: bytes) -> int:
    """sscanf's %d: strtol's clamp to 64 bits, then the int cast."""
    v = max(-(1 << 63), min(int(digits), (1 << 63) - 1))
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def hdr_header(data: bytes) -> dict:
    """Width, height, the pixels' offset and orientation (1), as
    RGBE_ReadHeader reads them."""
    if not is_hdr(data):
        raise HdrError("not a Radiance HDR file")
    line, pos = _fgets(data, 0)
    has_format = False
    while line != b"\n":
        has_format = has_format or line == _FORMAT
        line, pos = _fgets(data, pos)
    if not has_format:
        raise HdrError("RGBE bad file format: missing FORMAT specifier")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line)
    if m is None:
        raise HdrError("RGBE bad file format: missing image size specifier")
    height, width = _c_int(m.group(1)), _c_int(m.group(2))
    if width <= 0 or height <= 0:
        raise HdrError(f"HDR of {width}x{height}")
    return dict(width=width, height=height, offset=pos, orientation=1)


def _scanline(data: bytes, pos: int, width: int, out: np.ndarray) -> int:
    """One RLE scanline's four channels into out (4, width); the position
    after them."""
    n = len(data)
    for ch in range(4):
        row = out[ch]
        x = 0
        while x < width:
            if pos + 2 > n:
                raise HdrError("RGBE read error")
            count, value = data[pos], data[pos + 1]
            pos += 2
            if count > 128:
                count -= 128
                if count > width - x:
                    raise HdrError("RGBE bad scanline data")
                row[x:x + count] = value
            else:
                if count == 0 or count > width - x:
                    raise HdrError("RGBE bad scanline data")
                if pos + count - 1 > n:
                    raise HdrError("RGBE read error")
                row[x] = value
                row[x + 1:x + count] = np.frombuffer(data, np.uint8, count - 1, pos)
                pos += count - 1
            x += count
    return pos


def _rgbe_to_u8(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) RGBE bytes -> (..., 3) uint8 RGB, as rgbe2float and
    convertTo(CV_8U, 255) compute them."""
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1), e - 136), 0).astype(np.float32)
    with np.errstate(over="ignore"):
        x = rgbe[..., :3].astype(np.float32) * f[..., None] * np.float32(255)
    return saturate_u8(x)


def decode_hdr(data: bytes) -> tuple[np.ndarray, int]:
    """cv2.imdecode(IMREAD_COLOR) of a Radiance HDR file as (H, W, 3) RGB,
    and orientation 1 (see the module docstring). Raises HdrError where
    cv2 gives None or raises."""
    info = hdr_header(data)
    w, h, pos = info["width"], info["height"], info["offset"]
    if size_refusal(w, h):
        raise HdrError(size_refusal(w, h))
    rgbe = np.zeros((h, w, 4), np.uint8)
    flat = rgbe.reshape(-1, 4)
    y = 0
    if 8 <= w <= 0x7FFF:
        line = np.empty((4, w), np.uint8)
        while y < h:
            head = data[pos:pos + 4]
            if len(head) < 4:
                raise HdrError("RGBE read error")
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break                                   # flat from here on
            if (head[2] << 8 | head[3]) != w:
                raise HdrError("RGBE bad file format: wrong scanline width")
            pos = _scanline(data, pos + 4, w, line)
            rgbe[y] = line.T
            y += 1
    rest = (h - y) * w
    if rest:
        if pos + 4 * rest > len(data):
            raise HdrError("RGBE read error")
        flat[y * w:] = np.frombuffer(data, np.uint8, 4 * rest, pos).reshape(rest, 4)
    return _rgbe_to_u8(rgbe), 1
