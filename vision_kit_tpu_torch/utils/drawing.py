"""Sample grids: the batch images with their ground-truth boxes, written as
a PNG.

Counterpart of vision_kit_tpu/utils/drawing.py:grid_save and class_color
without OpenCV: boxes are numpy rectangles 2 px wide, and the file is a PNG
(data/decode.py:encode_png), as the port has no JPEG encoder. Detection
drawing (Drawing, with cv2's text) is not ported.
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
