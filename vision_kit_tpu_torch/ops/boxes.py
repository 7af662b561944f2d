"""Box geometry on torch tensors: conversions and the IoU family.

Counterpart of vision_kit_tpu/ops/boxes.py (every conversion, clip_boxes, `_iou_core`,
`box_iou_aligned`, `box_iou_pairwise`), in the JAX version's order of
operations. `mode` is one of iou, iof, giou, diou, ciou; `box_format` one
of xyxy, xywh (corner and size) and cxcywh.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-6


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = b.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """(x_min, y_min, w, h) -> (x1, y1, x2, y2)."""
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def xywh_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x + w * 0.5, y + h * 0.5, w, h], dim=-1)


def xywhn_to_xyxy(b: torch.Tensor, w: float = 640, h: float = 640,
                  padw: float = 0, padh: float = 0) -> torch.Tensor:
    """Normalized (cx, cy, w, h) -> absolute (x1, y1, x2, y2) with padding."""
    cx, cy, bw, bh = b.unbind(-1)
    return torch.stack([w * (cx - bw * 0.5) + padw, h * (cy - bh * 0.5) + padh,
                        w * (cx + bw * 0.5) + padw, h * (cy + bh * 0.5) + padh], dim=-1)


def xyxy_to_xywhn(b: torch.Tensor, w: float = 640, h: float = 640) -> torch.Tensor:
    """Absolute (x1, y1, x2, y2) -> normalized (cx, cy, w, h)."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5 / w, (y1 + y2) * 0.5 / h, (x2 - x1) / w,
                        (y2 - y1) / h], dim=-1)


def clip_boxes(b: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to image (height, width); the first four columns."""
    h, w = shape
    return torch.stack([b[..., 0].clamp(0, w), b[..., 1].clamp(0, h),
                        b[..., 2].clamp(0, w), b[..., 3].clamp(0, h)], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; shape (..., 4) -> (...)."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _to_xyxy(b: torch.Tensor, box_format: str) -> torch.Tensor:
    if box_format == "xyxy":
        return b
    if box_format == "xywh":
        return xywh_to_xyxy(b)
    if box_format == "cxcywh":
        return cxcywh_to_xyxy(b)
    raise ValueError(f"Unsupported box format {box_format}")


def _iou_core(b1: torch.Tensor, b2: torch.Tensor, mode: str,
              eps: float) -> torch.Tensor:
    """Elementwise IoU over broadcast-aligned xyxy boxes (..., 4) -> (...).

    The union is (area1 + area2) - overlap, clamped at eps, then one
    division; CIoU's trade-off weight alpha carries no gradient, as
    jax.lax.stop_gradient detaches it in the JAX version."""
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp_min(0)
    overlap = wh[..., 0] * wh[..., 1]
    area1 = box_area(b1)
    if mode == "iof":
        union = area1 + eps
    else:
        union = area1 + box_area(b2) - overlap
    union = union.clamp_min(eps)
    ious = overlap / union
    if mode in ("iou", "iof"):
        return ious

    enclose_wh = (torch.maximum(b1[..., 2:], b2[..., 2:])
                  - torch.minimum(b1[..., :2], b2[..., :2])).clamp_min(0)
    if mode == "giou":
        enclose_area = (enclose_wh[..., 0] * enclose_wh[..., 1]).clamp_min(eps)
        return ious - (enclose_area - union) / enclose_area

    c2 = enclose_wh[..., 0] ** 2 + enclose_wh[..., 1] ** 2 + eps
    rho2 = (((b2[..., 0] + b2[..., 2]) - (b1[..., 0] + b1[..., 2])) ** 2
            + ((b2[..., 1] + b2[..., 3]) - (b1[..., 1] + b1[..., 3])) ** 2) / 4.0
    if mode == "diou":
        return ious - rho2 / c2
    if mode != "ciou":
        raise ValueError(f"Unsupported IoU mode {mode}")

    # the heights' +eps is the reference's, kept for degenerate boxes
    w1 = b1[..., 2] - b1[..., 0]
    h1 = b1[..., 3] - b1[..., 1] + eps
    w2 = b2[..., 2] - b2[..., 0]
    h2 = b2[..., 3] - b2[..., 1] + eps
    factor = 4.0 / math.pi ** 2
    v = factor * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - ious + (1.0 + eps))).detach()
    return ious - (rho2 / c2 + v * alpha)


def box_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor,
                    box_format: str = "xyxy", mode: str = "iou",
                    eps: float = EPS) -> torch.Tensor:
    """IoU between aligned pairs: (..., N, 4) x (..., N, 4) -> (..., N)."""
    return _iou_core(_to_xyxy(boxes1, box_format), _to_xyxy(boxes2, box_format),
                     mode, eps)


def box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     box_format: str = "xyxy", mode: str = "iou",
                     eps: float = EPS) -> torch.Tensor:
    """IoU between all pairs: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    b1 = _to_xyxy(boxes1, box_format)[..., :, None, :]
    b2 = _to_xyxy(boxes2, box_format)[..., None, :, :]
    return _iou_core(b1, b2, mode, eps)
