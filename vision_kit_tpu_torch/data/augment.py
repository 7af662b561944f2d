"""Validation preprocessing: the ValAugPipeline of
vision_kit_tpu/data/augment.py.

The host-augmentation pipeline of that module (random affine, HSV LUTs,
blur, median blur, CLAHE, flips and pad, with cv2) is not ported; the
training path takes the device augmentation (data/device_aug.py).
"""

from __future__ import annotations

import numpy as np
import torch

from vision_kit_tpu_torch.ops.letterbox import letterbox_u8


class ValAugPipeline:
    """Validation: letterbox to img_sz only, on the image's device
    (ops/letterbox.py:letterbox_u8, cv2's letterbox bit for bit)."""

    def __init__(self, img_sz=(640, 640)):
        self.img_sz = (img_sz, img_sz) if isinstance(img_sz, int) else tuple(img_sz)

    def __call__(self, rng, img, labels):
        out, labels, _ = self.apply(img, labels)
        return out, labels

    def apply(self, img: torch.Tensor, labels: np.ndarray):
        """(letterboxed image, labels moved with it, (ratio, (dw, dh))): the
        transform applied, so that callers rescale eval coordinates with it
        instead of deriving it again."""
        out, (ratio, pad) = letterbox_u8(img, self.img_sz)
        if len(labels):
            labels = labels.copy()
            labels[:, :4] *= ratio
            labels[:, [0, 2]] += pad[0]
            labels[:, [1, 3]] += pad[1]
        return out, labels, (ratio, pad)
