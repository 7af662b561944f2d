"""Exact greedy-NMS keep mask: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of vision_kit_tpu/ops/pallas_nms.py (the TPU kernel
`_nms_kernel`, wrapped by `pallas_greedy_keep`), which computes the same
mask as the XLA blocked scan `_greedy_keep_blocked` on the JAX serving path.

The kernel is csrc/greedy_nms.cu; its note says what bounds it on the H100
and how the design meets that. `greedy_keep` takes the plain version for a
CPU tensor only; a CUDA tensor launches the kernel pair (mask build, then
walk; counted as one launch) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vision_kit_tpu_torch import _cuda_build
from vision_kit_tpu_torch.ops.boxes import box_iou_pairwise

IOU_CLAMP = 1e-9  # the TPU kernel's union clamp (box_iou_pairwise's is 1e-6)


def greedy_keep_reference(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Plain version: the full (B, K, K) IoU matrix, then a K-step greedy
    loop vectorised over the batch. boxes (B, K, 4) f32 xyxy in score order,
    valid (B, K) bool -> keep (B, K) bool."""
    iou = box_iou_pairwise(boxes, boxes, eps=IOU_CLAMP)
    k = boxes.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    over = (iou > iou_thres) & later
    removed = ~valid
    keep = torch.zeros_like(valid)
    for i in range(k):
        kept = ~removed[:, i]
        keep[:, i] = kept
        removed = removed | (over[:, i, :] & kept[:, None])
    return keep


def mask_scratch_shape(b: int, k: int) -> tuple[int, int, int]:
    """Shape of the kernel's 64-bit suppression mask: (B, 64 W, W) words
    for W = ceil(K / 64). Rows are padded to whole 64-row blocks so that
    each block's rows are one strip of 64 W words."""
    w = -(-k // 64)
    return (b, 64 * w, w)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("greedy_nms")
    lib.greedy_nms_keep.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.greedy_nms_keep.restype = ctypes.c_int
    return lib


def _launch(boxes: torch.Tensor, valid: torch.Tensor,
            iou_thres: float) -> torch.Tensor:
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"boxes must be float32 and valid bool, got "
                        f"{boxes.dtype} and {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"boxes (B, K, 4) and valid (B, K) expected, got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if valid.device != boxes.device:
        raise ValueError("boxes and valid must be on the same device")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must start on a 16-byte boundary (read as "
                         f"float4); got address {boxes.data_ptr():#x}")
    b, k = valid.shape
    keep = torch.empty_like(valid)
    with torch.cuda.device(boxes.device):
        mask = torch.empty(mask_scratch_shape(b, k), dtype=torch.int64,
                           device=boxes.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().greedy_nms_keep(boxes.data_ptr(), valid.data_ptr(),
                                     keep.data_ptr(), mask.data_ptr(), b, k,
                                     iou_thres, stream)
    if err == -1:
        raise ValueError(f"K={k} candidates: the walk's mask strips "
                         f"({512 * mask.shape[2]} bytes each, two in flight) "
                         "exceed the shared memory of a block")
    if err == -2:
        raise ValueError(f"B={b} images exceed the mask kernel's grid")
    if err != 0:
        raise RuntimeError(f"greedy_nms_keep launch failed: CUDA error {err}")
    greedy_keep.launches += 1
    return keep


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                iou_thres: float) -> torch.Tensor:
    """Batched exact-greedy keep mask. boxes (B, K, 4) f32 xyxy sorted by
    score descending (class offset added), valid (B, K) bool -> (B, K) bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if boxes.device.type == "cpu":
        return greedy_keep_reference(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    return _launch(boxes, valid, iou_thres)


greedy_keep.launches = 0
