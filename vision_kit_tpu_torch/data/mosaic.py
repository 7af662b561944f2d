"""Mosaic + MixUp dataset wrapper of the host-augmentation route.

Counterpart of vision_kit_tpu/data/mosaic.py: a 4-image mosaic on a 2S x
2S canvas of 114 gray around a jittered centre, warped back to S x S by
random_affine; MixUp blends a second, jitter-scaled and maybe flipped
sample at 0.5/0.5. Images are uint8 tensors on the dataset's device (the
resizes are ops/letterbox.py:resize_u8, cv2's INTER_LINEAR bit for bit),
labels numpy; every draw comes from the caller's np.random.Generator in
the JAX package's order.
"""

from __future__ import annotations

import numpy as np
import torch

from vision_kit_tpu_torch.data.augment import PAD_VALUE, random_affine
from vision_kit_tpu_torch.data.device_aug import label_count
from vision_kit_tpu_torch.ops.letterbox import resize_u8


def _resize(img: torch.Tensor, dst_wh: tuple[int, int]) -> torch.Tensor:
    """cv2.resize INTER_LINEAR; cv2 copies an image already at its size."""
    if (img.shape[1], img.shape[0]) == tuple(dst_wh):
        return img
    return resize_u8(img, dst_wh)


def mosaic_coordinate(i, xc, yc, w, h, input_h, input_w):
    """Placement rects of quadrant i: ((large x1, y1, x2, y2), (small x1,
    y1, x2, y2))."""
    if i == 0:  # top-left
        x1, y1, x2, y2 = max(xc - w, 0), max(yc - h, 0), xc, yc
        s = w - (x2 - x1), h - (y2 - y1), w, h
    elif i == 1:  # top-right
        x1, y1, x2, y2 = xc, max(yc - h, 0), min(xc + w, input_w * 2), yc
        s = 0, h - (y2 - y1), min(w, x2 - x1), h
    elif i == 2:  # bottom-left
        x1, y1, x2, y2 = max(xc - w, 0), yc, xc, min(input_h * 2, yc + h)
        s = w - (x2 - x1), 0, w, min(y2 - y1, h)
    else:  # bottom-right
        x1, y1, x2, y2 = xc, yc, min(xc + w, input_w * 2), min(input_h * 2, yc + h)
        s = 0, 0, min(w, x2 - x1), min(y2 - y1, h)
    return (x1, y1, x2, y2), s


class MosaicMixupDataset:
    """Wraps a base dataset (the pull_item protocol) with mosaic and mixup.

    getitem(rng, idx) -> (img (S, S, 3) uint8 tensor after the closing
    random_affine, or the dataset's item without mosaic; labels (n, 5)
    xyxy + cls in absolute pixels)."""

    def __init__(self, dataset, img_size=(640, 640), enable_mosaic=True,
                 enable_mixup=True, mosaic_prob=1.0, mixup_prob=1.0, degrees=0.0,
                 translate=0.1, mosaic_scale=(0.5, 1.5), mixup_scale=(0.5, 1.5),
                 shear=0.0):
        self.dataset = dataset
        self.input_dim = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.enable_mosaic = enable_mosaic
        self.enable_mixup = enable_mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.degrees = degrees
        self.translate = translate
        self.mosaic_scale = tuple(mosaic_scale)
        self.mixup_scale = tuple(mixup_scale)
        self.shear = shear

    def __len__(self):
        return len(self.dataset)

    def getitem(self, rng: np.random.Generator, idx: int, mosaic: bool = True):
        if self.enable_mosaic and mosaic and rng.random() < self.mosaic_prob:
            img, labels = self.mosaic(rng, idx)
            if self.enable_mixup and len(labels) and rng.random() < self.mixup_prob:
                img, labels = self.mixup(rng, img, labels)
        else:
            img, labels, _, _ = self.dataset.pull_item(idx)
        return img, labels

    def mosaic(self, rng, idx):
        input_h, input_w = self.input_dim
        yc = int(rng.uniform(0.5 * input_h, 1.5 * input_h))
        xc = int(rng.uniform(0.5 * input_w, 1.5 * input_w))
        indices = [idx] + [int(rng.integers(0, len(self.dataset))) for _ in range(3)]

        puller = getattr(self.dataset, "batch_pull_items", None)
        items = (puller(indices) if puller is not None
                 else [self.dataset.pull_item(i) for i in indices])
        canvas = torch.full((input_h * 2, input_w * 2, 3), PAD_VALUE, dtype=torch.uint8,
                            device=items[0][0].device)
        all_labels = []
        for i, (img, labels, _, _) in enumerate(items):
            h0, w0 = img.shape[:2]
            scale = min(input_h / h0, input_w / w0)
            img = _resize(img, (int(w0 * scale), int(h0 * scale)))
            h, w = img.shape[:2]
            (lx1, ly1, lx2, ly2), (sx1, sy1, sx2, sy2) = mosaic_coordinate(
                i, xc, yc, w, h, input_h, input_w)
            canvas[ly1:ly2, lx1:lx2] = img[sy1:sy2, sx1:sx2]
            padw, padh = lx1 - sx1, ly1 - sy1
            if len(labels):
                lab = labels.copy()
                lab[:, [0, 2]] = scale * labels[:, [0, 2]] + padw
                lab[:, [1, 3]] = scale * labels[:, [1, 3]] + padh
                all_labels.append(lab)

        if all_labels:
            labels = np.concatenate(all_labels, 0)
            labels[:, 0] = labels[:, 0].clip(0, 2 * input_w)
            labels[:, 1] = labels[:, 1].clip(0, 2 * input_h)
            labels[:, 2] = labels[:, 2].clip(0, 2 * input_w)
            labels[:, 3] = labels[:, 3].clip(0, 2 * input_h)
        else:
            labels = np.zeros((0, 5), np.float32)

        img, labels = random_affine(rng, canvas, labels, target_size=(input_w, input_h),
                                    degrees=self.degrees, translate=self.translate,
                                    scales=self.mosaic_scale, shear=self.shear)
        # drop degenerate boxes produced by clipping
        if len(labels):
            wh = labels[:, 2:4] - labels[:, 0:2]
            labels = labels[(wh > 1.0).all(1)]
        return img, labels

    def mixup(self, rng, origin_img, origin_labels):
        """0.5/0.5 blend with a second, jitter-scaled and maybe flipped
        sample; up to 30 draws for one with labels (counted from the label
        table, without a decode where the dataset has one)."""
        input_h, input_w = self.input_dim
        jit = rng.uniform(*self.mixup_scale)
        flip = rng.random() > 0.5

        found = False
        for _ in range(30):
            cp_index = int(rng.integers(0, len(self.dataset)))
            if label_count(self.dataset, cp_index):
                found = True
                break
        if not found:
            return origin_img, origin_labels
        img, cp_labels, _, _ = self.dataset.pull_item(cp_index)

        dev = origin_img.device
        cp_img = torch.full((input_h, input_w, 3), PAD_VALUE, dtype=torch.uint8, device=dev)
        r = min(input_h / img.shape[0], input_w / img.shape[1])
        resized = _resize(img.to(dev), (int(img.shape[1] * r), int(img.shape[0] * r)))
        cp_img[:resized.shape[0], :resized.shape[1]] = resized
        cp_img = _resize(cp_img, (int(cp_img.shape[1] * jit), int(cp_img.shape[0] * jit)))
        r *= jit
        if flip:
            cp_img = torch.flip(cp_img, [1])

        oh, ow = cp_img.shape[:2]
        th, tw = origin_img.shape[:2]
        padded = torch.zeros((max(oh, th), max(ow, tw), 3), dtype=torch.uint8, device=dev)
        padded[:oh, :ow] = cp_img
        y_off = int(rng.integers(0, padded.shape[0] - th)) if padded.shape[0] > th else 0
        x_off = int(rng.integers(0, padded.shape[1] - tw)) if padded.shape[1] > tw else 0
        cropped = padded[y_off:y_off + th, x_off:x_off + tw]

        boxes = cp_labels[:, :4] * r
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, ow)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, oh)
        if flip:
            boxes[:, 0::2] = ow - boxes[:, 0::2][:, ::-1]
        boxes[:, 0::2] = (boxes[:, 0::2] - x_off).clip(0, tw)
        boxes[:, 1::2] = (boxes[:, 1::2] - y_off).clip(0, th)

        labels = np.concatenate([boxes, cp_labels[:, 4:5]], axis=1)
        wh = labels[:, 2:4] - labels[:, 0:2]
        labels = labels[(wh > 1.0).all(1)]
        out_labels = np.concatenate([origin_labels, labels], axis=0)
        # 0.5 a + 0.5 b in float32 is exact; the cast truncates
        out_img = (0.5 * origin_img.float() + 0.5 * cropped.float()).to(torch.uint8)
        return out_img, out_labels
