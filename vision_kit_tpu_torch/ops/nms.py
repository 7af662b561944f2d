"""Serving postprocess on the raw head maps: candidate selection before
decode, then class-aware greedy NMS, in fixed shapes on the device.

Counterpart of vision_kit_tpu/ops/nms.py:postprocess_raw. Stage 1 is the
head-score kernel (ops/head_scores.py) and the greedy suppression is the
greedy-NMS kernel (ops/greedy_nms.py); the rest is plain PyTorch in the
JAX version's operation order.
"""

from __future__ import annotations

import torch

from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
from vision_kit_tpu_torch.ops.head_scores import NEG_INF, head_scores

MAX_WH = 7680  # class-offset stride


def _select_top(raw: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                max_det: int):
    """Top `max_det` rows of raw (B, K, 6) by score among `valid`."""
    sel_scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top_scores, top_idx = torch.topk(sel_scores, max_det, dim=1)
    out = torch.gather(raw, 1, top_idx[..., None].expand(-1, -1, raw.shape[2]))
    return out, top_scores > NEG_INF / 2


def postprocess_raw(
    raws,
    anchors_px,
    strides=(8.0, 16.0, 32.0),
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    agnostic: bool = False,
    max_det: int = 300,
    max_cand: int = 1024,
    classes: torch.Tensor | None = None,
    approx_topk: bool = True,
):
    """Raw head maps -> padded detections.

    Args:
      raws: per-level raw maps in the head's native (B, ny, nx, na, 5+nc)
        layout.
      anchors_px: (nl, na, 2) anchors in pixel units.
      classes: optional (nc,) bool mask of allowed classes.
      approx_topk: accepted for the JAX signature. The candidate top-k is
        always exact (torch.topk), which meets approx_max_k's recall
        contract.

    Returns (dets (B, max_det, 6) rows [x1, y1, x2, y2, conf, cls],
    valid (B, max_det) bool).
    """
    del approx_topk
    dev = raws[0].device
    b = raws[0].shape[0]
    anchors = torch.as_tensor(anchors_px, dtype=torch.float32, device=dev)
    shapes = [(r.shape[3], r.shape[1], r.shape[2]) for r in raws]  # na, ny, nx

    # Stage 1: gated scores and best classes of every anchor, one global top-k
    scores_all, cls_all = head_scores(raws, conf_thres, classes)
    n_total = scores_all.shape[1]
    k = min(max_cand, n_total)
    top_s, top_i = torch.topk(scores_all, k, dim=1)            # (B, k)
    cls = torch.gather(cls_all, 1, top_i).float()

    # Stage 2: decode only the k survivors; per level, a gather of its
    # xywh logits and a select of the decoded values
    sel = torch.zeros(b, k, 4, dtype=raws[0].dtype, device=dev)
    cx = torch.zeros_like(top_s)
    cy = torch.zeros_like(top_s)
    ww = torch.zeros_like(top_s)
    hh = torch.zeros_like(top_s)
    levels = []
    off = 0
    for raw, (na, ny, nx) in zip(raws, shapes):
        n = na * ny * nx
        in_level = (top_i >= off) & (top_i < off + n)
        local = (top_i - off).clamp(0, n - 1)
        flat = raw.reshape(b, n, raw.shape[4])
        xywh = torch.gather(flat, 1, local[..., None].expand(-1, -1, 4))
        sel = torch.where(in_level[..., None], xywh, sel)
        levels.append((in_level, local, na, nx))
        off += n
    s = torch.sigmoid(sel.float())
    for li, (in_level, local, na, nx) in enumerate(levels):
        ia = local % na
        cell = local // na
        iy = (cell // nx).float()
        ix = (cell % nx).float()
        stride = float(strides[li])
        anc = anchors[li][ia]                                   # (B, k, 2)
        cx = torch.where(in_level, (s[..., 0] * 2.0 - 0.5 + ix) * stride, cx)
        cy = torch.where(in_level, (s[..., 1] * 2.0 - 0.5 + iy) * stride, cy)
        ww = torch.where(in_level, (s[..., 2] * 2.0) ** 2 * anc[..., 0], ww)
        hh = torch.where(in_level, (s[..., 3] * 2.0) ** 2 * anc[..., 1], hh)
    boxes = torch.stack([cx - ww / 2, cy - hh / 2, cx + ww / 2, cy + hh / 2],
                        dim=-1)

    valid_cand = top_s > NEG_INF / 2
    nms_boxes = boxes if agnostic else boxes + cls[..., None] * MAX_WH
    keep = greedy_keep(nms_boxes.contiguous(), valid_cand, iou_thres)
    keep = keep & valid_cand
    raw_rows = torch.cat([boxes, top_s[..., None], cls[..., None]], dim=-1)
    return _select_top(raw_rows, top_s, keep, min(max_det, k))
