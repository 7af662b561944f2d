"""Sun raster decode without OpenCV: cv2.imdecode(IMREAD_COLOR) + BGR2RGB
of a Sun raster file (.ras, .sr), bit for bit, in numpy.

The reference is OpenCV 5's grfmt_sunras.cpp as cv2 runs it:

- The header: eight big-endian signed 32-bit words, the magic 0x59A66A95,
  width, height, depth, length (ignored), type, colour map type and map
  length. Width and height must be positive and the depth 1, 8, 24 or 32.
  The type must be RT_OLD (0) or RT_STANDARD (1): readHeader compares
  RT_BYTE_ENCODED (2) and RT_FORMAT_RGB (3) with the decoder's own image
  type instead of the file's, so cv2 refuses every run-length-encoded and
  every RGB-ordered file, and so does this module. The map is either
  RMT_NONE (0) with length 0, or RMT_EQUAL_RGB (1) with a length from 1
  to 3 x 2^depth at a depth of 1 or 8: length // 3 red bytes, then as
  many green and blue, the rest of the 256 entries black. A depth of 1 or
  8 without a map is grey (1 white).
- The pixels follow the map: rows of (width x depth + 7) // 8 bytes padded
  to an even count, every row's padding included (a file that ends before
  it is refused). 1 bit a pixel MSB first; 8 bits an index; 24 bits B, G,
  R; 32 bits X, B, G, R.
"""

from __future__ import annotations

import struct

import numpy as np

from vision_kit_tpu_torch.data.decode import size_refusal

MAGIC = b"\x59\xa6\x6a\x95"
RT_OLD, RT_STANDARD = 0, 1
RMT_NONE, RMT_EQUAL_RGB = 0, 1


class SunRasterError(ValueError):
    """Bytes that cv2 does not decode as Sun raster; decode_image answers
    None."""


def is_sunras(data: bytes) -> bool:
    """SunRasterDecoder's signature."""
    return data[:4] == MAGIC


def sunras_header(data: bytes) -> dict:
    """Width, height, depth, the (256, 3) RGB palette, the pixels' offset
    and orientation (1), as SunRasterDecoder::readHeader reads them."""
    if data[:4] != MAGIC or len(data) < 32:
        raise SunRasterError("not a Sun raster file")
    _, width, height, depth, _, kind, maptype, maplength = struct.unpack(">8i", data[:32])
    if not (width > 0 and height > 0 and depth in (1, 8, 24, 32)):
        raise SunRasterError(f"Sun raster {width}x{height}, depth {depth}")
    pal_size = 3 << depth if depth <= 8 else 0
    if kind not in (RT_OLD, RT_STANDARD) or not (
            (maptype == RMT_NONE and maplength == 0)
            or (maptype == RMT_EQUAL_RGB and 0 < maplength <= pal_size and depth <= 8)):
        raise SunRasterError(f"Sun raster type {kind}, map {maptype} of {maplength} bytes")
    palette = np.zeros((256, 3), np.uint8)
    if maplength:
        if 32 + maplength > len(data):
            raise SunRasterError("Sun raster: the map ends early")
        n = maplength // 3
        palette[:n] = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n).T
    elif depth <= 8:
        palette[:1 << depth, :] = (np.arange(1 << depth) * (255 // ((1 << depth) - 1)))[:, None]
    return dict(width=width, height=height, depth=depth, palette=palette,
                offset=32 + maplength, orientation=1)


def decode_sunras(data: bytes) -> tuple[np.ndarray, int]:
    """cv2.imdecode(IMREAD_COLOR) of a Sun raster file as (H, W, 3) RGB, and
    orientation 1 (see the module docstring). Raises SunRasterError where
    cv2 gives None."""
    info = sunras_header(data)
    w, h, depth, pos = info["width"], info["height"], info["depth"], info["offset"]
    if size_refusal(w, h):
        raise SunRasterError(size_refusal(w, h))
    pitch = (((w * depth + 7) // 8) + 1) & ~1
    if pos + pitch * h > len(data):
        raise SunRasterError("Sun raster: the pixels end early")
    rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
    if depth == 1:
        return info["palette"][np.unpackbits(rows, axis=1)[:, :w]], 1
    if depth == 8:
        return info["palette"][rows[:, :w]], 1
    px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)
    return np.ascontiguousarray(px[:, :, :-4:-1]), 1
