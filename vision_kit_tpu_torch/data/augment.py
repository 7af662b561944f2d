"""Host-augmentation pipeline and validation preprocessing.

Counterpart of vision_kit_tpu/data/augment.py, without OpenCV: images are
(H, W, 3) uint8 RGB tensors on any device, and every cv2 call is its
bit-exact counterpart in ops/imgproc.py (warpAffine, the HSV conversions
and LUTs, blur, medianBlur, gray, Lab, CLAHE, copyMakeBorder). Labels stay
numpy (n, 5) float32 [x1, y1, x2, y2, cls] in absolute pixels, with the
JAX package's dtypes at every step. All randomness comes from the
caller's np.random.Generator, drawn in the JAX package's order and count,
so one default_rng([seed, 77, sid]) gives both packages the same sample.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vision_kit_tpu_torch.ops import imgproc
from vision_kit_tpu_torch.ops.letterbox import PAD_VALUE, letterbox_u8


def _rand(rng, value, center=0.0):
    """Uniform in [center - value, center + value], or in [v0, v1] for a
    pair."""
    if isinstance(value, (int, float)):
        return rng.uniform(center - value, center + value)
    return rng.uniform(value[0], value[1])


def rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center=(0, 0), angle, scale) in float64."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def get_affine_matrix(rng, target_size, degrees=10.0, translate=0.1, scales=0.1,
                      shear=10.0):
    """2x3 affine: rotation and scale about the origin, shear, translation.
    Returns (M float64, scale)."""
    twidth, theight = target_size
    angle = _rand(rng, degrees)
    scale = _rand(rng, scales, center=1.0)
    if scale <= 0.0:
        raise ValueError("affine scale must be positive")

    R = rotation_matrix(angle, scale)
    M = np.ones((2, 3))
    shear_x = math.tan(_rand(rng, shear) * math.pi / 180)
    shear_y = math.tan(_rand(rng, shear) * math.pi / 180)
    M[0] = R[0] + shear_y * R[1]
    M[1] = R[1] + shear_x * R[0]
    M[0, 2] = _rand(rng, translate) * twidth
    M[1, 2] = _rand(rng, translate) * theight
    return M, scale


def apply_affine_to_bboxes(boxes, target_size, M):
    """Warp the 4 corners of each (n, 4) xyxy box, take the axis-aligned
    hull and clip it to target_size (w, h); float64 out."""
    n = len(boxes)
    if n == 0:
        return boxes
    tw, th = target_size
    corners = np.ones((4 * n, 3))
    corners[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(4 * n, 2)
    corners = (corners @ M.T).reshape(n, 8)
    xs = corners[:, 0::2]
    ys = corners[:, 1::2]
    out = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
    out[:, 0::2] = out[:, 0::2].clip(0, tw)
    out[:, 1::2] = out[:, 1::2].clip(0, th)
    return out


def random_affine(rng, img, labels, target_size=(640, 640), degrees=10.0,
                  translate=0.1, scales=0.1, shear=10.0):
    """Affine-warp the image to target_size (w, h) with a gray border, and
    move the labels with it."""
    M, _ = get_affine_matrix(rng, target_size, degrees, translate, scales, shear)
    img = imgproc.warp_affine_u8(img, M, tuple(target_size), PAD_VALUE)
    if len(labels):
        labels = labels.copy()
        labels[:, :4] = apply_affine_to_bboxes(labels[:, :4], target_size, M)
    return img, labels


def augment_hsv(rng, img, h_gain=0.015, s_gain=0.7, v_gain=0.4):
    """HSV jitter of a uint8 RGB image through per-channel LUTs."""
    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    hsv = imgproc.lut_u8(imgproc.rgb2hsv_u8(img), (lut_hue, lut_sat, lut_val))
    return imgproc.hsv2rgb_u8(hsv)


def flip_lr(img, labels):
    img = torch.flip(img, [1])
    if len(labels):
        labels = labels.copy()
        w = img.shape[1]
        x1 = labels[:, 0].copy()
        labels[:, 0] = w - labels[:, 2]
        labels[:, 2] = w - x1
    return img, labels


def flip_ud(img, labels):
    img = torch.flip(img, [0])
    if len(labels):
        labels = labels.copy()
        h = img.shape[0]
        y1 = labels[:, 1].copy()
        labels[:, 1] = h - labels[:, 3]
        labels[:, 3] = h - y1
    return img, labels


def pixel_augs(rng, img):
    """Blur, median blur, gray and CLAHE on Lab's L, each at p = 0.01."""
    if rng.random() < 0.01:
        img = imgproc.blur_u8(img, (rng.integers(3, 8) | 1,) * 2)
    if rng.random() < 0.01:
        img = imgproc.median_blur_u8(img, int(rng.integers(3, 8)) | 1)
    if rng.random() < 0.01:
        img = imgproc.gray2rgb_u8(imgproc.rgb2gray_u8(img))
    if rng.random() < 0.01:
        lab = imgproc.rgb2lab_u8(img)
        lab[..., 0] = imgproc.clahe_u8(lab[..., 0].contiguous(), 4.0, (8, 8))
        img = imgproc.lab2rgb_u8(lab)
    return img


def pad_to(img, labels, dst_hw):
    """Pad (no resize) to at least dst_hw with gray, centred."""
    h, w = img.shape[:2]
    ph = max(dst_hw[0] - h, 0)
    pw = max(dst_hw[1] - w, 0)
    if ph == 0 and pw == 0:
        return img, labels
    top, left = ph // 2, pw // 2
    img = imgproc.copy_make_border_u8(img, top, ph - top, left, pw - left, PAD_VALUE)
    if len(labels):
        labels = labels.copy()
        labels[:, [0, 2]] += left
        labels[:, [1, 3]] += top
    return img, labels


class TrainAugPipeline:
    """Per-sample train augmentation: pixel augs, HSV, flips, pad."""

    def __init__(self, flip_lr_prob=0.5, flip_ud_prob=0.0, hsv_prob=1.0,
                 img_sz=(640, 640)):
        self.flip_lr_prob = flip_lr_prob
        self.flip_ud_prob = flip_ud_prob
        self.hsv_prob = hsv_prob
        self.img_sz = (img_sz, img_sz) if isinstance(img_sz, int) else tuple(img_sz)

    def __call__(self, rng, img, labels):
        img = pixel_augs(rng, img)
        if rng.random() < self.hsv_prob:
            img = augment_hsv(rng, img)
        if rng.random() < self.flip_lr_prob:
            img, labels = flip_lr(img, labels)
        if rng.random() < self.flip_ud_prob:
            img, labels = flip_ud(img, labels)
        return pad_to(img, labels, self.img_sz)


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
