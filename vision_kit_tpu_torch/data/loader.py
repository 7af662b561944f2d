"""Fixed-shape target batching: the subset of vision_kit_tpu/data/loader.py
the eval path needs.

Batches keep ValLoader's format: images (B, S, S, 3) uint8, targets padded
to (B, MAX_LABELS, 5) rows [cls, cx, cy, w, h] normalised, infos
(h0, w0, ratio, pad, img_id) per image and `count`, the number of real
images. The loaders themselves, which decode images, are not ported yet.
"""

from __future__ import annotations

import numpy as np

MAX_LABELS = 160


def pad_targets(labels_list, img_hw, max_labels=MAX_LABELS):
    """abs-xyxy+cls label arrays -> (B, M, 5) [cls, cxn, cyn, wn, hn],
    padded with cls = -1."""
    b = len(labels_list)
    h, w = img_hw
    out = np.full((b, max_labels, 5), -1, np.float32)
    for i, lab in enumerate(labels_list):
        n = min(len(lab), max_labels)
        if n == 0:
            continue
        lab = lab[:n]
        out[i, :n, 0] = lab[:, 4]
        out[i, :n, 1] = (lab[:, 0] + lab[:, 2]) / 2 / w
        out[i, :n, 2] = (lab[:, 1] + lab[:, 3]) / 2 / h
        out[i, :n, 3] = (lab[:, 2] - lab[:, 0]) / w
        out[i, :n, 4] = (lab[:, 3] - lab[:, 1]) / h
    return out
