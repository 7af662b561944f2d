"""Letterbox (resize + pad) and coordinate rescale.

Counterpart of vision_kit_tpu/ops/letterbox.py: letterbox_params is the
same pure-Python geometry; letterbox_device runs on a batch of uint8 NHWC
frames on the device; letterbox_u8 is the JAX letterbox_np (cv2.resize
INTER_LINEAR + copyMakeBorder) bit for bit, in torch integer ops on either
device, and letterbox_np the same on a numpy array with every option of
JAX's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 114


def letterbox_params(
    src_hw: tuple[int, int],
    dst_hw: tuple[int, int] | int,
    stride: int = 32,
    scaleup: bool = True,
    auto: bool = False,
    letterbox: bool = True,
):
    """Geometry of the letterbox transform.

    Returns (new_unpad_wh, (top, bottom, left, right), ratio, (dw, dh)).
    """
    if isinstance(dst_hw, int):
        dst_hw = (dst_hw, dst_hw)
    h, w = src_hw
    ratio = min(dst_hw[0] / h, dst_hw[1] / w)
    if not scaleup:
        ratio = min(ratio, 1.0)

    new_unpad = (int(round(w * ratio)), int(round(h * ratio)))  # (w, h)
    dw = dst_hw[1] - new_unpad[0]
    dh = dst_hw[0] - new_unpad[1]
    if auto:
        dw %= stride
        dh %= stride

    if letterbox:
        dwf, dhf = dw / 2.0, dh / 2.0
        top, bottom = int(round(dhf - 0.1)), int(round(dhf + 0.1))
        left, right = int(round(dwf - 0.1)), int(round(dwf + 0.1))
        pad = (dwf, dhf)
    else:
        top, bottom, left, right = 0, int(round(dh)), 0, int(round(dw))
        pad = (float(dw), float(dh))

    return new_unpad, (top, bottom, left, right), ratio, pad


def letterbox_device(
    imgs: torch.Tensor,
    dst_hw: tuple[int, int] | int,
    normalize: bool = True,
):
    """uint8 (B, H, W, C) frames -> (B, dst_h, dst_w, C) f32, padded with
    114 and scaled to [0, 1] when `normalize`.

    The returned NHWC tensor is a view of channels_last NCHW memory. The
    resize is bilinear with antialiasing, which is what JAX's
    `jax.image.resize(..., "bilinear")` does when it downscales.

    Returns (out, (ratio, (dw, dh))).
    """
    if isinstance(dst_hw, int):
        dst_hw = (dst_hw, dst_hw)
    new_unpad, (top, bottom, left, right), ratio, pad = letterbox_params(
        tuple(imgs.shape[1:3]), dst_hw
    )
    x = imgs.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(new_unpad[1], new_unpad[0]), mode="bilinear",
                      align_corners=False, antialias=True)
    x = F.pad(x, (left, right, top, bottom), value=float(PAD_VALUE))
    if normalize:
        x = x / 255.0
    x = x.contiguous(memory_format=torch.channels_last)
    return x.permute(0, 2, 3, 1), (ratio, pad)


RESIZE_COEF_SCALE = 2048   # cv2's INTER_RESIZE_COEF_SCALE (11 fractional bits)


def _linear_taps(src: int, dst: int, clamp: bool):
    """cv2.resize INTER_LINEAR's taps along one axis for uint8: (index of
    the first and second source sample, their 11-bit weights) per output.
    The source coordinate is f = float32((d + 0.5) * scale - 0.5) with
    scale = 1 / (dst / src) in double; each weight is rounded on its own
    (they need not sum to 2048). Along x (clamp) a coordinate left of the
    first or right of the last sample takes that sample whole; along y only
    the row indices are clamped, and the weights stay as computed."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        f = np.where(edge, np.float32(0), f)
        s = np.clip(s, 0, src - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(RESIZE_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(RESIZE_COEF_SCALE)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_u8(img: torch.Tensor, dst_wh: tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, dst_wh, interpolation=INTER_LINEAR) of an (H, W, C)
    uint8 tensor, bit for bit: a horizontal pass into exact int32 sums
    (S[x0] * w0 + S[x1] * w1), then cv2's vertical fixed-point rounding,
    (((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2) >> 2. An exact 2x
    shrink, which cv2 hands to its area path, comes out the same: (a + b +
    c + d + 2) >> 2."""
    h, w = img.shape[:2]
    dw, dh = dst_wh
    dev = img.device
    x0, x1, a0, a1 = (torch.from_numpy(t).to(dev) for t in _linear_taps(w, dw, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(dev) for t in _linear_taps(h, dh, False))
    rows = torch.unique(torch.cat([y0, y1]))       # source rows in use
    src = img.index_select(0, rows).to(torch.int32)
    horiz = (src.index_select(1, x0) * a0[None, :, None]
             + src.index_select(1, x1) * a1[None, :, None])
    pos = torch.searchsorted(rows, torch.cat([y0, y1]))
    r0 = horiz.index_select(0, pos[:dh]) >> 4
    r1 = horiz.index_select(0, pos[dh:]) >> 4
    out = (((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def letterbox_u8(img: torch.Tensor, dst_hw: tuple[int, int] | int):
    """letterbox_np on an (H, W, 3) uint8 tensor, on its own device: the
    cv2-exact resize (a copy when the size already fits) and pad 114.
    Returns ((dst_h, dst_w, 3) uint8, (ratio, (dw, dh)))."""
    if isinstance(dst_hw, int):
        dst_hw = (dst_hw, dst_hw)
    new_unpad, (top, bottom, left, right), ratio, pad = letterbox_params(
        tuple(img.shape[:2]), dst_hw)
    if (img.shape[1], img.shape[0]) != new_unpad:
        img = resize_u8(img, new_unpad)
    out = torch.full((new_unpad[1] + top + bottom, new_unpad[0] + left + right,
                      img.shape[2]), PAD_VALUE, dtype=torch.uint8, device=img.device)
    out[top:top + new_unpad[1], left:left + new_unpad[0]] = img
    return out, (ratio, pad)


def letterbox_np(
    img: np.ndarray,
    dst_hw: tuple[int, int] | int,
    stride: int = 32,
    scaleup: bool = True,
    auto: bool = False,
    letterbox: bool = True,
    color: tuple[int, int, int] = (PAD_VALUE, PAD_VALUE, PAD_VALUE),
):
    """The JAX package's host letterbox on an (H, W, C) or (H, W) uint8
    array, without OpenCV: resize_u8 (cv2.resize INTER_LINEAR bit for bit)
    to letterbox_params' size, then copyMakeBorder's constant border in
    `color`. Returns (img, (ratio, (dw, dh)))."""
    new_unpad, (top, bottom, left, right), ratio, pad = letterbox_params(
        img.shape[:2], dst_hw, stride=stride, scaleup=scaleup, auto=auto,
        letterbox=letterbox)
    planes = img[:, :, None] if img.ndim == 2 else img
    if (img.shape[1], img.shape[0]) != new_unpad:
        planes = resize_u8(torch.from_numpy(np.ascontiguousarray(planes)), new_unpad).numpy()
    out = np.empty((new_unpad[1] + top + bottom, new_unpad[0] + left + right,
                    planes.shape[2]), np.uint8)
    out[:] = np.resize(np.asarray(color, np.uint8), planes.shape[2])
    out[top:top + new_unpad[1], left:left + new_unpad[0]] = planes
    return (out[:, :, 0] if img.ndim == 2 else out), (ratio, pad)


def scale_coords(
    img1_hw: tuple[int, int],
    coords: torch.Tensor | np.ndarray,
    img0_hw: tuple[int, int],
    ratio_pad=None,
) -> torch.Tensor | np.ndarray:
    """Rescale xyxy coords (..., >=4) from letterboxed img1 space back to
    the original img0 and clip to it; columns past the fourth pass through.
    Takes a torch tensor or a numpy array (the evaluator's host path) and
    returns the same kind."""
    if ratio_pad is None:
        gain = min(img1_hw[0] / img0_hw[0], img1_hw[1] / img0_hw[1])
        pad = (
            (img1_hw[1] - img0_hw[1] * gain) / 2,
            (img1_hw[0] - img0_hw[0] * gain) / 2,
        )
    else:
        gain = ratio_pad[0][0] if isinstance(ratio_pad[0], (tuple, list)) else ratio_pad[0]
        pad = ratio_pad[1]
    if isinstance(coords, np.ndarray):
        cat, clip = np.concatenate, np.clip
    else:
        cat, clip = torch.cat, torch.clamp
    h, w = img0_hw
    box = cat([
        clip((coords[..., 0:1] - pad[0]) / gain, 0, w),
        clip((coords[..., 1:2] - pad[1]) / gain, 0, h),
        clip((coords[..., 2:3] - pad[0]) / gain, 0, w),
        clip((coords[..., 3:4] - pad[1]) / gain, 0, h),
    ], -1)
    if coords.shape[-1] > 4:
        box = cat([box, coords[..., 4:]], -1)
    return box
