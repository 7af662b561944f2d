"""Detections drawn on an image, and sample grids: the batch images with
their ground-truth boxes, written as a PNG.

Counterpart of vision_kit_tpu/utils/drawing.py (Drawing, grid_save,
class_color) without OpenCV: boxes are numpy rectangles, grids are PNGs
(data/decode.py:encode_png) where the JAX package writes JPEGs. A label
("<name> <conf>") is drawn white on a strip of the box's colour, as the
JAX Drawing draws it, but in a built-in 5x7 bitmap font (capitals, digits
and a few signs; lower case drawn as capitals) where the JAX one uses
cv2's anti-aliased Hershey font, which cannot be matched without cv2.
"""

from __future__ import annotations

import math

import numpy as np

from vision_kit_tpu_torch.data.decode import encode_png

# fixed colour wheel (12 hues cycled), the JAX package's
_BASE = [
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207), (255, 152, 150), (197, 176, 213),
]


def class_color(cls_id: int) -> tuple[int, int, int]:
    return _BASE[int(cls_id) % len(_BASE)]


def draw_rectangle(img: np.ndarray, p1, p2, color, thickness: int = 2) -> None:
    """The outline of the box with corners p1, p2 (x, y), `thickness` px
    wide and centred on the box's edges, clipped to the image; in place.
    (cv2.rectangle rounds the corners of a thick line; this does not.)"""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    x1, x2 = sorted((int(x1), int(x2)))
    y1, y2 = sorted((int(y1), int(y2)))
    a, b = thickness // 2, (thickness + 1) // 2

    def fill(xa, ya, xb, yb):
        xa, ya, xb, yb = max(xa, 0), max(ya, 0), min(xb, w), min(yb, h)
        if xa < xb and ya < yb:
            img[ya:yb, xa:xb] = color

    fill(x1 - a, y1 - a, x2 + b, y1 + b)   # top
    fill(x1 - a, y2 - a, x2 + b, y2 + b)   # bottom
    fill(x1 - a, y1 - a, x1 + b, y2 + b)   # left
    fill(x2 - a, y1 - a, x2 + b, y2 + b)   # right


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
    """Write a batch sample grid to `path` (a PNG) and return it.

    images: (B, H, W, 3) float in [0, 1] or uint8, numpy or a tensor on any
    device; targets: (B, M, 5) [cls, cxn, cyn, wn, hn] with cls < 0 padding.
    The caller's images are not written to."""
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
        f.write(encode_png(canvas))
    return canvas
