"""Box geometry: the subset of vision_kit_tpu/ops/boxes.py the serving path
needs (cxcywh -> xyxy and pairwise IoU), on torch tensors."""

from __future__ import annotations

import torch

EPS = 1e-6


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = b.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; shape (..., 4) -> (...)."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _iou_core(b1: torch.Tensor, b2: torch.Tensor, eps: float) -> torch.Tensor:
    """Elementwise IoU over broadcast-aligned xyxy boxes (..., 4) -> (...).

    The operation order is the JAX package's: the union is
    (area1 + area2) - overlap, clamped at eps, then one division."""
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp_min(0)
    overlap = wh[..., 0] * wh[..., 1]
    union = box_area(b1) + box_area(b2) - overlap
    return overlap / union.clamp_min(eps)


def box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     eps: float = EPS) -> torch.Tensor:
    """IoU between all pairs of xyxy boxes: (..., N, 4) x (..., M, 4) ->
    (..., N, M)."""
    return _iou_core(boxes1[..., :, None, :], boxes2[..., None, :, :], eps)
