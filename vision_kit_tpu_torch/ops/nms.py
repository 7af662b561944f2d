"""Fixed-shape batched, class-aware NMS on the device: the serving
postprocess on the raw head maps and the eval postprocess on the decoded
output.

Counterpart of vision_kit_tpu/ops/nms.py. postprocess_raw selects
candidates before decode: stage 1 is the head-score kernel
(ops/head_scores.py). postprocess takes the head's decoded output (the eval
protocol: multi-label expansion, per-anchor top-L truncation, merge-NMS),
and batched_nms takes already-selected candidates. Every greedy suppression
is the greedy-NMS kernel (ops/greedy_nms.py); the rest is plain PyTorch in
the JAX version's operation order.
"""

from __future__ import annotations

import torch

from vision_kit_tpu_torch.ops.boxes import box_iou_pairwise, cxcywh_to_xyxy
from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
from vision_kit_tpu_torch.ops.head_scores import NEG_INF, head_scores

MAX_WH = 7680  # class-offset stride


def _monotone_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys in the order of x's f32 values (-0.0 below 0.0)."""
    bits = x.float().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _topk_by_sort(x: torch.Tensor, k: int):
    """topk_stable by a stable descending sort of the keys."""
    idx = torch.sort(_monotone_keys(x), dim=-1, descending=True,
                     stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def _topk_by_int64(x: torch.Tensor, k: int):
    """topk_stable by a top-k of distinct int64 keys: the key in the high
    32 bits, the reversed index in the low 32."""
    n = x.shape[-1]
    key = (_monotone_keys(x).long() << 32) | torch.arange(n - 1, -1, -1,
                                                           device=x.device)
    idx = torch.topk(key, k, dim=-1)[1]
    return torch.gather(x, -1, idx), idx


def topk_stable(x: torch.Tensor, k: int):
    """torch.topk over the last dim in jax.lax.top_k's order: descending,
    and the lower index first among equal values (torch.topk sets no order
    among ties, and the greedy keep depends on candidate order).

    Rows of up to 2048 take the stable sort, longer rows the int64 top-k:
    on the H100 the sort is the cheaper at the eval path's 80 classes and
    at max_det cuts of 512 to 2048 candidates, the int64 top-k at its
    504,000 candidates (chip_smoke.py's eval phase times both routes at
    these widths).

    Returns (values, indices)."""
    return (_topk_by_sort if x.shape[-1] <= 2048 else _topk_by_int64)(x, k)


def _topk(x: torch.Tensor, k: int):
    """torch.topk over the last dim: no order among ties."""
    return torch.topk(x, k, dim=-1)


def _merge_boxes(nms_boxes, raw_rows, scores, valid, keep, iou_thres):
    """Merge-NMS over a batch: kept boxes become the score-weighted mean of
    ALL valid candidates that overlap them above iou_thres (in class-offset
    space). Kept boxes whose only overlap is themselves are dropped, except
    in an image with at most one valid candidate (the JAX version's
    `redundant` rule). One (B, K, K) IoU and one batched matmul.

    Returns (raw_rows with merged xyxy, keep')."""
    iou_m = (box_iou_pairwise(nms_boxes, nms_boxes) > iou_thres) & \
        valid[:, None, :]
    weights = iou_m.float() * scores.clamp_min(0.0)[:, None, :]
    denom = weights.sum(dim=2, keepdim=True).clamp_min(1e-12)
    merged = (weights @ raw_rows[..., :4]) / denom
    boxes = torch.where(keep[..., None], merged, raw_rows[..., :4])
    raw_rows = torch.cat([boxes, raw_rows[..., 4:]], dim=-1)
    keep = keep & ((iou_m.sum(dim=2) > 1)
                   | (valid.sum(dim=1, keepdim=True) <= 1))
    return raw_rows, keep


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, K) -> (B, K, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def _select_top(raw: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                max_det: int, topk):
    """Top `max_det` rows of raw (B, K, 6) by score among `valid`."""
    sel_scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top_scores, top_idx = topk(sel_scores, max_det)
    return _gather_rows(raw, top_idx), top_scores > NEG_INF / 2


def _suppress(cand_boxes, top_s, cls_idx, iou_thres, agnostic, merge, max_det,
              topk=topk_stable):
    """Class-offset greedy NMS of score-ordered f32 candidates (B, K), then
    the top `max_det` kept rows, cut by `topk`."""
    nms_boxes = cand_boxes if agnostic else cand_boxes + cls_idx[..., None] * MAX_WH
    raw = torch.cat([cand_boxes, top_s[..., None], cls_idx[..., None]], dim=-1)
    valid_cand = top_s > NEG_INF / 2
    keep = greedy_keep(nms_boxes.contiguous(), valid_cand, iou_thres)
    keep = keep & valid_cand
    if merge:
        raw, keep = _merge_boxes(nms_boxes, raw, top_s, valid_cand, keep,
                                 iou_thres)
    return _select_top(raw, top_s, keep, max_det, topk)


def postprocess(
    preds: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    multi_label: bool = False,
    agnostic: bool = False,
    max_det: int = 300,
    max_cand: int = 1024,
    classes: torch.Tensor | None = None,
    approx_topk: bool = False,
    multi_label_top: int = 0,
    merge: bool = False,
):
    """Decoded predictions -> padded detections.

    Args:
      preds: (B, N, 5+nc) decoded head output [cx, cy, w, h, obj, cls...]
        in letterboxed-image pixels (the head's eval decode).
      multi_label: one candidate per (anchor, class) pair, flattened
        anchor-major, instead of each anchor's best class (only when nc > 1).
      multi_label_top: with multi_label, keep each anchor's top L classes
        first, then take the global top-k over N*L (0: the full N*nc).
      classes: optional (nc,) bool mask of allowed class ids; the obj*cls
        scores of the others are zeroed.
      approx_topk: accepted for the JAX signature; the top-k is exact
        (topk_stable).
      merge: merge-NMS, kept boxes become the score-weighted mean of their
        over-threshold overlaps.

    Candidates are selected in the input dtype and cast to f32 after.

    Returns:
      (dets, valid): dets (B, max_det, 6) rows [x1, y1, x2, y2, conf, cls],
      valid (B, max_det) bool.
    """
    del approx_topk
    b, n, no = preds.shape
    nc = no - 5
    boxes_xyxy = cxcywh_to_xyxy(preds[..., :4])            # (B, N, 4)
    cls_conf = preds[..., 5:] * preds[..., 4:5]            # obj * cls (B, N, nc)
    if classes is not None:
        allowed = torch.as_tensor(classes, dtype=torch.bool, device=preds.device)
        cls_conf = torch.where(allowed, cls_conf, torch.zeros_like(cls_conf))

    use_multi = multi_label and nc > 1
    top_l = multi_label_top if use_multi and 0 < multi_label_top < nc else 0
    max_cand = min(max_cand, n * nc if use_multi else n)
    if top_l:
        max_cand = min(max_cand, n * top_l)
    max_det = min(max_det, max_cand)

    if top_l:
        vals, cidx = topk_stable(cls_conf, top_l)        # (B, N, L)
        flat = vals.reshape(b, -1)                         # (B, N*L)
        gated = torch.where(flat > conf_thres, flat, NEG_INF)
        top_s, top_i = topk_stable(gated, max_cand)
        box_idx = top_i // top_l
        cls_idx = torch.gather(cidx.reshape(b, -1), 1, top_i).float()
    elif use_multi:
        flat = cls_conf.reshape(b, -1)                     # (B, N*nc)
        gated = torch.where(flat > conf_thres, flat, NEG_INF)
        top_s, top_i = topk_stable(gated, max_cand)
        box_idx = top_i // nc
        cls_idx = (top_i % nc).float()
    else:
        best = cls_conf.amax(dim=2)                        # (B, N)
        best_cls = cls_conf.argmax(dim=2)                  # first index on ties
        gated = torch.where(best > conf_thres, best, NEG_INF)
        top_s, box_idx = topk_stable(gated, max_cand)
        cls_idx = torch.gather(best_cls, 1, box_idx).float()
    cand_boxes = _gather_rows(boxes_xyxy, box_idx).float()
    return _suppress(cand_boxes, top_s.float(), cls_idx, iou_thres, agnostic,
                     merge, max_det)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    iou_thres: float = 0.45,
    max_det: int = 300,
    agnostic: bool = False,
    merge: bool = False,
):
    """Standalone NMS over already-selected candidates of one image.

    Args:
      boxes: (K, 4) xyxy. scores: (K,). class_ids: (K,) int.
      merge: merge-NMS, kept boxes become the score-weighted mean of their
        over-threshold overlaps.
    Returns (dets (max_det, 6), valid (max_det,)).
    """
    max_det = min(max_det, boxes.shape[0])
    order = torch.argsort(-scores, stable=True)
    dets, valid = _suppress(boxes[order].float()[None], scores[order].float()[None],
                            class_ids[order].float()[None], iou_thres, agnostic,
                            merge, max_det)
    return dets[0], valid[0]


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
    anchor_major: bool = False,
):
    """Raw head maps -> padded detections.

    Args:
      raws: per-level raw maps in the head's native (B, ny, nx, na, 5+nc)
        layout, or with anchor_major=True the (B, na, ny, nx, 5+nc) maps of
        a decode_order="reference" model: permuted views of the same
        native memory, which the head-score kernel and the survivors'
        gather read in place. The candidates' indices, and so the order of
        ties, follow the given layout, as in JAX.
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
    if anchor_major:
        shapes = [(r.shape[1], r.shape[2], r.shape[3]) for r in raws]
        native = [r.permute(0, 2, 3, 1, 4) for r in raws]
    else:
        shapes = [(r.shape[3], r.shape[1], r.shape[2]) for r in raws]
        native = raws                                           # na, ny, nx

    # Stage 1: gated scores and best classes of every anchor, one global top-k
    scores_all, cls_all = head_scores(raws, conf_thres, classes,
                                      anchor_major=anchor_major)
    n_total = scores_all.shape[1]
    k = min(max_cand, n_total)
    # torch.topk here and at the max_det cut, not topk_stable: this
    # selection stands for approx_max_k, whose contract is recall, not the
    # order of ties, and the stable keys cost the serving step (PERF.md)
    top_s, top_i = torch.topk(scores_all, k, dim=1)             # (B, k)
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
    for raw, (na, ny, nx) in zip(native, shapes):
        n = na * ny * nx
        in_level = (top_i >= off) & (top_i < off + n)
        local = (top_i - off).clamp(0, n - 1)
        if anchor_major:                                        # (ia, iy, ix)
            ia, cell = local // (ny * nx), local % (ny * nx)
            row = cell * na + ia                                # native index
        else:                                                   # (iy, ix, ia)
            ia, cell, row = local % na, local // na, local
        flat = raw.reshape(b, n, raw.shape[4])                  # a view
        xywh = torch.gather(flat, 1, row[..., None].expand(-1, -1, 4))
        sel = torch.where(in_level[..., None], xywh, sel)
        levels.append((in_level, ia, cell, nx))
        off += n
    s = torch.sigmoid(sel.float())
    for li, (in_level, ia, cell, nx) in enumerate(levels):
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
    return _suppress(boxes, top_s, cls, iou_thres, agnostic, False,
                     min(max_det, k), topk=_topk)
