"""Device letterbox (resize + pad + normalise) and coordinate rescale.

Counterpart of vision_kit_tpu/ops/letterbox.py: letterbox_params is the
same pure-Python geometry; letterbox_device runs on a batch of uint8 NHWC
frames on the device.
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
