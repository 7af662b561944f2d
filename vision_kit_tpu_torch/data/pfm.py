"""PFM decode without OpenCV: cv2.imdecode(IMREAD_COLOR) + BGR2RGB of a
Portable Float Map, bit for bit, in numpy and the standard library.

The reference is OpenCV 5's grfmt_pfm.cpp as cv2 runs it:

- The header: "PF" (three channels) or "Pf" (one), then exactly LF; then
  three tokens, each the bytes up to a C isspace byte (which is consumed;
  a byte of 0x80 or more refuses the file): the width and the height as
  C's atoi reads them (a leading sign, digits, anything after ignored; no
  digits is 0), the scale as C's strtod (decimal, hexadecimal, "inf",
  "nan"; no number is 0). A width or height under 1 is refused (OpenCV's
  size check raises), and so is a scale whose magnitude is 0 or NaN.
- The samples: float32 rows stored bottom-up, little-endian where the
  scale is negative and big-endian otherwise. A file that ends before its
  last row is refused.
- The conversion: each sample times float32(1 / |scale|) in float32, then
  saturate_cast<uchar> as OpenCV's vector code runs it: round half to
  even, NaN and anything outside the int32 range (infinities, 3e9) to 0,
  then clamped to 0..255. There is no x255: a sample of 1.0 is 1.
- "PF" samples are R, G, B. cv2 gives a "Pf" file as a one-channel image
  even under IMREAD_COLOR (BGR2RGB then refuses it); decode_pfm gives its
  values in all three channels.
"""

from __future__ import annotations

import re

import numpy as np

from vision_kit_tpu_torch.data.decode import size_refusal


class PfmError(ValueError):
    """Bytes that cv2 does not decode as PFM; decode_image answers None."""


_SPACE = b" \t\n\v\f\r"
_ATOI = re.compile(rb"[+-]?[0-9]*")
_STRTOD = re.compile(
    rb"[+-]?(?:(inf(?:inity)?|nan(?:\([0-9a-z_]*\))?)"
    rb"|(0x(?:[0-9a-f]+\.?[0-9a-f]*|\.[0-9a-f]+)(?:p[+-]?[0-9]+)?)"
    rb"|((?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:e[+-]?[0-9]+)?))", re.IGNORECASE)


def is_pfm(data: bytes) -> bool:
    """PFMDecoder's signature: "PF" or "Pf" and a space byte (anything
    but LF is refused later)."""
    return len(data) >= 3 and data[:2] in (b"PF", b"Pf") and data[2] in _SPACE


def _token(data: bytes, pos: int) -> tuple[bytes, int]:
    """read_number's bytes: up to 2048 before a space byte, which is
    consumed; the C string they make (cut at a NUL)."""
    out = bytearray()
    while len(out) < 2048:
        if pos >= len(data):
            raise PfmError("PFM: the header ends early")
        c = data[pos]
        pos += 1
        if c >= 0x80:
            raise PfmError("PFM: a header byte over 0x7f")
        if c in _SPACE:
            break
        out.append(c)
    return bytes(out).split(b"\0")[0], pos


def _atoi(token: bytes) -> int:
    digits = _ATOI.match(token).group(0)
    v = int(digits) if digits.strip(b"+-") else 0
    v = max(-(1 << 63), min(v, (1 << 63) - 1))      # strtol's clamp, then the int cast
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _strtod(token: bytes) -> float:
    m = _STRTOD.match(token)
    if m is None:
        return 0.0
    text = m.group(0).decode().lower()
    if m.group(2):
        sign = -1.0 if text[0] == "-" else 1.0
        return sign * float.fromhex(text.lstrip("+-"))
    if m.group(1):
        return float(text.split("(")[0])
    return float(text)


def pfm_header(data: bytes) -> dict:
    """Width, height, channels, scale, the samples' offset and orientation
    (1), as PFMDecoder::readHeader reads them."""
    if data[:2] not in (b"PF", b"Pf") or data[2:3] != b"\n":
        raise PfmError("not a PFM file")
    tw, pos = _token(data, 3)
    th, pos = _token(data, pos)
    ts, pos = _token(data, pos)
    width, height = _atoi(tw), _atoi(th)
    if width <= 0 or height <= 0:
        raise PfmError(f"PFM: {width}x{height}")
    return dict(width=width, height=height, channels=3 if data[1] == 0x46 else 1,
                scale=_strtod(ts), offset=pos, orientation=1)


def saturate_u8(x: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar> of float32 as OpenCV's vector code runs it
    (data/hdr.py's conversion too)."""
    with np.errstate(invalid="ignore"):
        r = np.rint(x)
        ok = (r >= -2.0 ** 31) & (r < 2.0 ** 31)      # NaN fails both
        return np.where(ok, np.clip(r, 0, 255), 0).astype(np.uint8)


def decode_pfm(data: bytes) -> tuple[np.ndarray, int]:
    """cv2.imdecode(IMREAD_COLOR) of a PFM as (H, W, 3) RGB (a "Pf" file's
    one channel in all three), and orientation 1 (see the module
    docstring). Raises PfmError where cv2 gives None or raises."""
    info = pfm_header(data)
    w, h, c, pos = info["width"], info["height"], info["channels"], info["offset"]
    if size_refusal(w, h):
        raise PfmError(size_refusal(w, h))
    n = w * h * c
    if pos + 4 * n > len(data):
        raise PfmError("PFM: the samples end early")
    scale = info["scale"]
    if not abs(scale) > 0.0:
        raise PfmError("PFM: a scale of 0 or NaN")
    x = np.frombuffer(data, "<f4" if scale < 0 else ">f4", n, pos).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        alpha = np.float32(1.0 / abs(scale))
        x = x * alpha
    rgb = saturate_u8(x).reshape(h, w, c)[::-1]
    if c == 1:
        rgb = np.repeat(rgb, 3, 2)
    return np.ascontiguousarray(rgb), 1
