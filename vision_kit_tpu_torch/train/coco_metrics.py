"""COCO-protocol detection metrics on host (numpy).

A copy of vision_kit_tpu/train/coco_metrics.py. It replaces the
reference's torchmetrics ``MeanAveragePrecision`` dependency
(core/train/det_trainer.py:37,104 and the mAP/mAR tables of
test_epoch_end, det_trainer.py:150-177) with a first-party implementation of
the COCOeval bbox protocol:

  * AP at IoU .50:.95 (10 thresholds), .50, .75
  * AP for small (<32^2), medium (32^2..96^2), large (>96^2) objects
  * AR at maxDets 1 / 10 / 100, and AR small/medium/large (maxDets 100)
  * 101-point precision interpolation, score-sorted greedy matching with
    per-GT dedup, area-ignored GTs excluded from recall denominators.

Inputs are plain numpy arrays per image:
  preds:  (n, 6) [x1 y1 x2 y2 conf cls]
  labels: (m, 5) [cls x1 y1 x2 y2]
(the same shapes DetEvaluator already accumulates).
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _box_area(b: np.ndarray) -> np.ndarray:
    return np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None
    )


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise xyxy IoU (n, m)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(a)[:, None] + _box_area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _greedy_match(ious: np.ndarray, n_real: int) -> np.ndarray:
    """COCOeval greedy matching at ALL IoU thresholds simultaneously.

    ious: (n_det, m_gt) — det rows in score-desc order, gt columns ordered
    non-ignored first (`n_real` of them). Semantics per det (COCOeval
    evaluateImg): among untaken non-ignored gts with iou >= thr - 1e-10 pick
    the max-IoU one (LAST on exact ties — the sequential loop replaces on
    >=); only if none qualifies, the same among ignored gts.

    Returns match (n_iou, n_det) int: matched gt column or -1. The only
    remaining Python loop is over dets (greedy is sequential in score rank);
    thresholds and gts are vectorized.
    """
    n, m = ious.shape
    t = len(IOU_THRS)
    thr = (IOU_THRS - 1e-10)[:, None]  # (T, 1)
    taken = np.zeros((t, m), dtype=bool)
    match = np.full((t, n), -1, np.int64)
    rows = np.arange(t)
    for di in range(n):
        iou_d = ious[di][None, :]  # (1, m)
        cand = (~taken) & (iou_d >= thr)  # (T, m)
        best = np.full(t, -1)
        if n_real:
            mr = np.where(cand[:, :n_real], iou_d[:, :n_real], -1.0)
            any_r = mr.max(axis=1) >= 0.0
            # last argmax: ties resolve to the highest gt index in-segment
            br = (n_real - 1) - np.argmax(mr[:, ::-1], axis=1)
            best = np.where(any_r, br, best)
        if m > n_real:
            mi = np.where(cand[:, n_real:], iou_d[:, n_real:], -1.0)
            any_i = mi.max(axis=1) >= 0.0
            bi = (m - 1) - np.argmax(mi[:, ::-1], axis=1)
            best = np.where(best >= 0, best, np.where(any_i, bi, -1))
        ok = best >= 0
        match[ok, di] = best[ok]
        taken[rows[ok], best[ok]] = True
    return match


class COCOMetrics:
    """Accumulate per-image (preds, labels) and compute the COCOeval set."""

    def __init__(self, class_ids=None):
        self.images: list[tuple[np.ndarray, np.ndarray]] = []
        self.class_ids = class_ids

    def reset(self):
        self.images.clear()

    def update(self, preds: np.ndarray, labels: np.ndarray):
        self.images.append(
            (np.asarray(preds, np.float64), np.asarray(labels, np.float64))
        )

    def compute(self) -> dict:
        if self.class_ids is not None:
            classes = list(self.class_ids)
        else:
            cs = set()
            for p, l in self.images:
                cs.update(np.unique(l[:, 0]).astype(int).tolist() if len(l) else [])
                cs.update(np.unique(p[:, 5]).astype(int).tolist() if len(p) else [])
            classes = sorted(cs)

        n_iou, n_rec = len(IOU_THRS), len(REC_THRS)
        settings = [(a, d) for a in AREA_RANGES for d in MAX_DETS]
        # precision[setting][iou, recall, class], recall_[setting][iou, class]
        precision = {s: np.full((n_iou, n_rec, len(classes)), -1.0) for s in settings}
        recall_ = {s: np.full((n_iou, len(classes)), -1.0) for s in settings}

        # group ONCE per (image, class): score-sorted top-maxDets dets, gt
        # boxes, areas and the IoU matrix are shared across all four area
        # ranges; images without dets or gts of a class never enter its
        # loop at all.
        class_set = {c: i for i, c in enumerate(classes)}
        entries: dict[int, list] = {c: [] for c in classes}
        top = MAX_DETS[-1]
        for preds, labels in self.images:
            pc = preds[:, 5].astype(int) if len(preds) else np.zeros(0, int)
            gc = labels[:, 0].astype(int) if len(labels) else np.zeros(0, int)
            for c in set(pc.tolist()) | set(gc.tolist()):
                if c not in class_set:
                    continue
                d = preds[pc == c][:, :5]
                order = np.argsort(-d[:, 4], kind="stable")[:top]
                d = d[order]
                g = labels[gc == c][:, 1:5]
                ious = (
                    _iou(d[:, :4], g)
                    if len(d) and len(g) else np.zeros((len(d), len(g)))
                )
                entries[c].append(
                    (d[:, 4], _box_area(d), _box_area(g), ious)
                )

        for c, per_img in entries.items():
            ci = class_set[c]
            if not per_img:
                continue
            for a_name, (lo, hi) in AREA_RANGES.items():
                # match once at the largest maxDets; greedy matching in score
                # order is prefix-stable, so top-k results are row slices
                # (same trick as COCOeval: one evaluateImg, sliced in
                # accumulate)
                n_gt = 0
                s_list, tp_list, ign_list = [], [], []
                for scores, d_area, g_area, ious in per_img:
                    g_ignore = (g_area < lo) | (g_area > hi)
                    k = int((~g_ignore).sum())
                    n_gt += k
                    n, m = ious.shape
                    if n == 0:
                        continue
                    if m:
                        # gts ordered non-ignored first (COCOeval matches
                        # preferentially to them)
                        g_order = np.argsort(g_ignore, kind="stable")
                        match = _greedy_match(ious[:, g_order], k)
                        tp = ((match >= 0) & (match < k)).T  # (n, T)
                        dig = (match >= k).T
                    else:
                        tp = np.zeros((n, n_iou), bool)
                        dig = np.zeros((n, n_iou), bool)
                    # unmatched dets outside the area range are ignored,
                    # not FPs
                    out_rng = (d_area < lo) | (d_area > hi)
                    dig = dig | (out_rng[:, None] & ~tp)
                    s_list.append(scores)
                    tp_list.append(tp)
                    ign_list.append(dig)
                if n_gt == 0:
                    continue
                for max_det in MAX_DETS:
                    if s_list:
                        scores = np.concatenate(
                            [s[:max_det] for s in s_list])
                        tps = np.concatenate(
                            [t[:max_det] for t in tp_list], 0)
                        igns = np.concatenate(
                            [g[:max_det] for g in ign_list], 0)
                    else:
                        scores = np.zeros(0)
                        tps = np.zeros((0, n_iou), bool)
                        igns = np.zeros((0, n_iou), bool)
                    order = np.argsort(-scores, kind="mergesort")
                    tps, igns = tps[order], igns[order]
                    key = (a_name, max_det)
                    for ti in range(n_iou):
                        keep = ~igns[:, ti]
                        tp = tps[keep, ti]
                        tp_cum = np.cumsum(tp)
                        fp_cum = np.cumsum(~tp)
                        rc = tp_cum / n_gt
                        pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
                        recall_[key][ti, ci] = rc[-1] if len(rc) else 0.0
                        # monotone envelope then sample at 101 recall pts
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(n_rec)
                        valid = inds < len(pr)
                        q[valid] = pr[inds[valid]]
                        precision[key][ti, :, ci] = q

        def _ap(a_name, max_det, iou_slice=slice(None)):
            p = precision[(a_name, max_det)][iou_slice]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def _ar(a_name, max_det):
            r = recall_[(a_name, max_det)]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        return {
            "map": _ap("all", 100),
            "map_50": _ap("all", 100, slice(0, 1)),
            "map_75": _ap("all", 100, slice(5, 6)),
            "map_small": _ap("small", 100),
            "map_medium": _ap("medium", 100),
            "map_large": _ap("large", 100),
            "mar_1": _ar("all", 1),
            "mar_10": _ar("all", 10),
            "mar_100": _ar("all", 100),
            "mar_small": _ar("small", 100),
            "mar_medium": _ar("medium", 100),
            "mar_large": _ar("large", 100),
        }
