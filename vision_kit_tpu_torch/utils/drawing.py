"""Detections drawn on an image, and sample grids: the batch images with
their ground-truth boxes, written as cv2.imwrite writes them.

Counterpart of vision_kit_tpu/utils/drawing.py (Drawing, grid_save,
class_color) without OpenCV: box outlines are cv2.rectangle's pixels
(draw_rectangle, OpenCV 5.0.0's drawing.cpp), a `.jpg` grid is
data/encode.py:encode_jpeg's bytes (cv2.imwrite's at its defaults) and a
`.png` one data/decode.py:encode_png's. A label ("<name> <conf>") is drawn
white on a strip of the box's colour, as the JAX Drawing draws it, but in a
built-in 5x7 bitmap font (capitals, digits and a few signs; lower case
drawn as capitals) where the JAX one uses cv2's anti-aliased Hershey font,
which cannot be matched without cv2.
"""

from __future__ import annotations

import math
import os

import numpy as np

from vision_kit_tpu_torch.data.decode import encode_png
from vision_kit_tpu_torch.data.encode import encode_jpeg

# fixed colour wheel (12 hues cycled), the JAX package's
_BASE = [
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207), (255, 152, 150), (197, 176, 213),
]


def class_color(cls_id: int) -> tuple[int, int, int]:
    return _BASE[int(cls_id) % len(_BASE)]


# drawing.cpp's fixed point: coordinates carry XY_SHIFT fraction bits
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _fill(img: np.ndarray, xa: int, ya: int, xb: int, yb: int, color) -> None:
    """img[ya..yb, xa..xb] (both ends included) = color, clipped; in place."""
    h, w = img.shape[:2]
    xa, ya, xb, yb = max(xa, 0), max(ya, 0), min(xb, w - 1), min(yb, h - 1)
    if xa <= xb and ya <= yb:
        img[ya:yb + 1, xa:xb + 1] = color


def _disc_half_widths(radius: int) -> list[int]:
    """The half-width of each row, -radius..radius, of drawing.cpp's filled
    Circle: its midpoint walk fills rows cy +- dy over cx +- dx and rows
    cy +- dx over cx +- dy, all centred on cx, so a row's span is the widest
    one given to it."""
    half = [-1] * (2 * radius + 1)
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for off, width in ((dy, dx), (dx, dy)):
            for row in (radius - off, radius + off):
                half[row] = max(half[row], width)
        dy += 1
        err += plus
        plus += 2
        if err > 0:            # mask = (err <= 0) - 1 = -1
            err -= minus
            dx -= 1
            minus -= 2
    return half


def _thick_segment(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """drawing.cpp's ThickLine(p0, p1) with LINE_8, shift 0 and flags 2
    (PolyLine's closed outline: a cap at p1 alone), for an axis-aligned
    segment, the only kind a rectangle has. Thickness 1 is Line: every pixel
    from p0 to p1. Thicker: FillConvexPoly of the segment's polygon, p0 and
    p1 offset across the segment by cvRound(d * r), r = (thickness <<
    (XY_SHIFT - 1) + (thickness & 1) * XY_ONE / 2) / |p1 - p0|, which on an
    axis-aligned segment is (thickness + 1) // 2 whole pixels, so the
    polygon is the segment's pixels widened by that on both sides (a
    zero-length segment has none); then the filled Circle at p1 of radius
    (thickness << (XY_SHIFT - 1) + XY_ONE / 2) >> XY_SHIFT, the same
    (thickness + 1) // 2."""
    (x0, y0), (x1, y1) = p0, p1
    if thickness <= 1:
        _fill(img, min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1), color)
        return
    wide = thickness << (XY_SHIFT - 1)
    off = (wide + (thickness & 1) * (XY_ONE >> 1)) >> XY_SHIFT
    if (x0, y0) != (x1, y1):
        ox, oy = (off, 0) if x0 == x1 else (0, off)
        _fill(img, min(x0, x1) - ox, min(y0, y1) - oy, max(x0, x1) + ox,
              max(y0, y1) + oy, color)
    radius = (wide + (XY_ONE >> 1)) >> XY_SHIFT
    for i, half in enumerate(_disc_half_widths(radius)):
        if half >= 0:
            y = y1 - radius + i
            _fill(img, x1 - half, y, x1 + half, y, color)


def draw_rectangle(img: np.ndarray, p1, p2, color, thickness: int = 2) -> None:
    """cv2.rectangle(img, p1, p2, color, thickness) with LINE_8 and shift
    0, bit for bit (OpenCV 5.0.0's drawing.cpp), in place: PolyLine over
    the closed outline p1, (p2.x, p1.y), p2, (p1.x, p2.y), each segment a
    ThickLine (_thick_segment) clipped to the image, so a thick outline
    has cv2's rounded corners. p1 and p2 are (x, y) in either order; the
    box may cross or lie outside the image, or have no width or height."""
    thickness = int(thickness)
    if thickness < 1:
        raise ValueError(f"draw_rectangle draws outlines of thickness >= 1, got {thickness}")
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    for a, b in zip(corners[-1:] + corners[:-1], corners):
        _thick_segment(img, a, b, color, thickness)


# 5x7 glyphs, one 5-bit row each (bit 4 the leftmost column)
_FONT = {
    "A": (14, 17, 17, 17, 31, 17, 17), "B": (30, 17, 17, 30, 17, 17, 30),
    "C": (14, 17, 16, 16, 16, 17, 14), "D": (28, 18, 17, 17, 17, 18, 28),
    "E": (31, 16, 16, 30, 16, 16, 31), "F": (31, 16, 16, 30, 16, 16, 16),
    "G": (14, 17, 16, 23, 17, 17, 15), "H": (17, 17, 17, 31, 17, 17, 17),
    "I": (14, 4, 4, 4, 4, 4, 14), "J": (7, 2, 2, 2, 2, 18, 12),
    "K": (17, 18, 20, 24, 20, 18, 17), "L": (16, 16, 16, 16, 16, 16, 31),
    "M": (17, 27, 21, 21, 17, 17, 17), "N": (17, 17, 25, 21, 19, 17, 17),
    "O": (14, 17, 17, 17, 17, 17, 14), "P": (30, 17, 17, 30, 16, 16, 16),
    "Q": (14, 17, 17, 17, 21, 18, 13), "R": (30, 17, 17, 30, 20, 18, 17),
    "S": (15, 16, 16, 14, 1, 1, 30), "T": (31, 4, 4, 4, 4, 4, 4),
    "U": (17, 17, 17, 17, 17, 17, 14), "V": (17, 17, 17, 17, 17, 10, 4),
    "W": (17, 17, 17, 21, 21, 21, 10), "X": (17, 17, 10, 4, 10, 17, 17),
    "Y": (17, 17, 17, 10, 4, 4, 4), "Z": (31, 1, 2, 4, 8, 16, 31),
    "0": (14, 17, 19, 21, 25, 17, 14), "1": (4, 12, 4, 4, 4, 4, 14),
    "2": (14, 17, 1, 2, 4, 8, 31), "3": (31, 2, 4, 2, 1, 17, 14),
    "4": (2, 6, 10, 18, 31, 2, 2), "5": (31, 16, 30, 1, 1, 17, 14),
    "6": (6, 8, 16, 30, 17, 17, 14), "7": (31, 1, 2, 4, 8, 8, 8),
    "8": (14, 17, 17, 14, 17, 17, 14), "9": (14, 17, 17, 15, 1, 2, 12),
    " ": (0, 0, 0, 0, 0, 0, 0), ".": (0, 0, 0, 0, 0, 12, 12),
    "-": (0, 0, 0, 31, 0, 0, 0), "_": (0, 0, 0, 0, 0, 0, 31),
    ":": (0, 12, 12, 0, 12, 12, 0), "/": (1, 1, 2, 4, 8, 16, 16),
    "?": (14, 17, 1, 2, 4, 0, 4),
}
GLYPH_W, GLYPH_H = 5, 7


def text_mask(text: str) -> np.ndarray:
    """The (7, 6 * len(text) - 1) bool mask of `text` in the 5x7 font, one
    blank column between glyphs; a character without a glyph is drawn as
    "?"."""
    if not text:
        return np.zeros((GLYPH_H, 0), bool)
    bits = np.array([_FONT.get(c, _FONT["?"]) for c in text.upper()], np.uint8)
    cols = (bits[:, :, None] >> np.arange(GLYPH_W - 1, -1, -1)) & 1   # (n, 7, 5)
    cols = np.concatenate([cols, np.zeros((len(text), GLYPH_H, 1), np.uint8)], axis=2)
    return cols.transpose(1, 0, 2).reshape(GLYPH_H, -1)[:, :-1].astype(bool)


def _paint(img: np.ndarray, mask: np.ndarray, x: int, y: int, color) -> None:
    """img[y:, x:][mask] = color, clipped to the image; in place."""
    h, w = img.shape[:2]
    mh, mw = mask.shape
    xa, ya, xb, yb = max(x, 0), max(y, 0), min(x + mw, w), min(y + mh, h)
    if xa < xb and ya < yb:
        img[ya:yb, xa:xb][mask[ya - y:yb - y, xa - x:xb - x]] = color


class Drawing:
    """Boxes and "<name> <conf>" labels of detections on an image."""

    def __init__(self, class_labels, line_thickness: int = 2):
        self.class_labels = list(class_labels)
        self.lt = line_thickness

    def draw(self, img: np.ndarray, dets: np.ndarray) -> np.ndarray:
        """A copy of img (HWC uint8, in the caller's channel order) with
        dets ((n, 6) [x1, y1, x2, y2, conf, cls]) drawn: each box in its
        class colour, its label above it."""
        out = np.array(img, copy=True, order="C")
        for row in dets:
            x1, y1, x2, y2 = map(int, row[:4])
            conf, cls = float(row[4]), int(row[5])
            color = class_color(cls)
            name = self.class_labels[cls] if 0 <= cls < len(self.class_labels) else str(cls)
            mask = text_mask(f"{name} {conf:.2f}")
            draw_rectangle(out, (x1, y1), (x2, y2), color, self.lt)
            th, tw = mask.shape
            _paint(out, np.ones((th + 4, tw + 2), bool), x1, y1 - th - 4, color)
            _paint(out, mask, x1 + 1, y1 - th - 2, (255, 255, 255))
        return out


def grid_save(images, targets, path: str, max_images: int = 16) -> np.ndarray:
    """Write a batch sample grid to `path` and return it (RGB): for a
    `.jpg`, the bytes the JAX grid_save's cv2.imwrite(path,
    cvtColor(canvas, RGB2BGR)) writes (encode_jpeg: quality 95, 4:2:0); for
    a `.png`, encode_png's (the same pixels, the port's own deflate).

    images: (B, H, W, 3) float in [0, 1] or uint8, numpy or a tensor on any
    device; targets: (B, M, 5) [cls, cxn, cyn, wn, hn] with cls < 0 padding,
    each box drawn by draw_rectangle at thickness 2 in its class colour.
    The caller's images are not written to."""
    ext = os.path.splitext(path)[1].lower()
    encode = {".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".png": encode_png}.get(ext)
    if encode is None:
        raise ValueError(f"grid_save writes .jpg or .png, not {path}")
    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy() if images.is_floating_point() \
            else images.cpu().numpy()
    b = min(len(images), max_images)
    cols = int(math.ceil(math.sqrt(b)))
    rows = int(math.ceil(b / cols))
    h, w = images.shape[1:3]
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(b):
        img = images[i]
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8) if img.dtype != np.uint8 \
            else np.array(img, copy=True, order="C")
        t = np.asarray(targets[i])
        for row in t[t[:, 0] >= 0]:
            cx, cy, bw, bh = row[1] * w, row[2] * h, row[3] * w, row[4] * h
            draw_rectangle(img, (int(cx - bw / 2), int(cy - bh / 2)),
                           (int(cx + bw / 2), int(cy + bh / 2)), class_color(int(row[0])))
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    with open(path, "wb") as f:
        f.write(encode(canvas))
    return canvas
