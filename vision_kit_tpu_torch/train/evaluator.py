"""Detection evaluator: mAP accumulation on host, matching on padded arrays.

A copy of vision_kit_tpu/train/evaluator.py (host code on numpy arrays;
the port imports nothing of the JAX package). The ultralytics mAP
protocol: per-image TP matrix at IoU 0.5:0.95 (greedy IoU match with
per-detection/per-label dedup), PR curves with 1000-point conf
interpolation, 101-point AP integration, F1-max operating point.

Device work (forward + decode + NMS) stays in the eval step
(train/step.py); this module only consumes fixed-shape (max_det, 6)
detections + validity masks, copied to the host as numpy arrays.

The reference's empty-batch crashes (det_evaluator.py:180-182 vstack on
empty, unbound `targetn`) are intentionally not replicated.
"""

from __future__ import annotations

import numpy as np

from vision_kit_tpu_torch.ops.letterbox import scale_coords


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (reference utils/metrics.py:15)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision):
    """101-point interpolated AP (reference det_evaluator.py:71-97)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps=1e-16):
    """PR curves + AP per class (reference det_evaluator.py:13-68)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = nt[ci]
        n_p = i.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1 = 2 * p * r / (p + r + eps)
    i = smooth(f1.mean(0), 0.1).argmax()
    p, r, f1 = p[:, i], r[:, i], f1[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return tp_count, fp_count, p, r, f1, ap, unique_classes.astype(int)


def _pairwise_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """xyxy IoU (n, m) in numpy."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def match_predictions(pred: np.ndarray, labels: np.ndarray,
                      iouv: np.ndarray) -> np.ndarray:
    """TP matrix (n_pred, n_iou): greedy IoU matching with class agreement
    and per-label/per-detection dedup (reference det_evaluator.py:273-300).

    pred: (n, 6) xyxy conf cls. labels: (m, 5) cls x1 y1 x2 y2.
    """
    correct = np.zeros((pred.shape[0], len(iouv)), dtype=bool)
    if not len(labels) or not len(pred):
        return correct
    iou = _pairwise_iou_np(labels[:, 1:], pred[:, :4])
    cls_match = labels[:, 0:1] == pred[None, :, 5]
    for i, thr in enumerate(iouv):
        li, pi = np.where((iou >= thr) & cls_match)
        if len(li):
            matches = np.stack([li, pi, iou[li, pi]], axis=1)
            if len(li) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


class DetEvaluator:
    """Accumulates padded device detections into mAP statistics."""

    def __init__(self, class_labels, img_size=(640, 640), gt_json=None):
        self.class_labels = list(class_labels)
        self.img_size = (
            (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        )
        self.gt_json = gt_json
        # contiguous class index -> dataset category id for COCO-json export
        # (reference det_evaluator.py:116-123 reads them from the gt json);
        # the actual COCO taxonomy defaults to the official COCO-91 id table
        # (a custom 80-class dataset keeps contiguous ids)
        from vision_kit_tpu_torch.classes import COCO as COCO_NAMES

        if list(self.class_labels) == list(COCO_NAMES):
            from vision_kit_tpu_torch.utils.general import coco80_to_coco91_class

            self.class_ids = coco80_to_coco91_class()
        else:
            self.class_ids = list(range(1, len(self.class_labels) + 1))
        if gt_json is not None:
            try:
                import json as _json

                with open(gt_json) as f:
                    cats = _json.load(f).get("categories", [])
                if cats:
                    self.class_ids = sorted(c["id"] for c in cats)
            except Exception:
                pass
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.reset()

    def reset(self, collect_coco: bool = True):
        """collect_coco=False skips the COCO-protocol accumulation (float64
        copies of every batch) — only summarize_coco() needs it, so the
        per-epoch val loop resets with False and test-time with True."""
        self.stats = []
        self.seen = 0
        self.coco_data = []
        self.metrics = {}
        if collect_coco:
            from vision_kit_tpu_torch.train.coco_metrics import COCOMetrics

            self.coco_metrics = COCOMetrics(
                class_ids=list(range(len(self.class_labels)))
            )
        else:
            self.coco_metrics = None

    def update(self, dets, valid, targets, infos, count=None):
        """Accumulate one batch.

        Args:
          dets: (B, max_det, 6) xyxy conf cls in letterboxed frame.
          valid: (B, max_det) bool.
          targets: (B, M, 5) [cls, cxn, cyn, wn, hn], cls<0 padded.
          infos: list of (h0, w0, ratio, pad, img_id) per image.
          count: number of real images in the batch (for padded last batch).
        """
        dets = np.asarray(dets)
        valid = np.asarray(valid)
        targets = np.asarray(targets)
        h, w = self.img_size
        n = count if count is not None else len(infos)
        for bi in range(n):
            h0, w0, ratio, pad, img_id = infos[bi]
            pred = dets[bi][valid[bi]]
            t = targets[bi]
            t = t[t[:, 0] >= 0]
            self.seen += 1

            predn = pred.copy()
            if len(predn):
                predn = scale_coords(
                    (h, w), predn, (h0, w0), ratio_pad=((ratio,), pad)
                )
                predn = np.asarray(predn)

            if len(t):
                cx, cy, bw, bh = t[:, 1] * w, t[:, 2] * h, t[:, 3] * w, t[:, 4] * h
                tbox = np.stack(
                    [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1
                )
                tbox = np.asarray(
                    scale_coords((h, w), tbox, (h0, w0),
                                 ratio_pad=((ratio,), pad))
                )
                labels = np.concatenate([t[:, 0:1], tbox], axis=1)
            else:
                labels = np.zeros((0, 5), np.float32)

            correct = match_predictions(predn, labels, self.iouv)
            self.stats.append(
                (correct, pred[:, 4], pred[:, 5], labels[:, 0])
            )
            if self.coco_metrics is not None:
                self.coco_metrics.update(
                    predn if len(predn) else np.zeros((0, 6), np.float32),
                    labels,
                )
            if self.gt_json is not None and len(predn):
                for row in predn:
                    ci = int(row[5])
                    cat = (
                        self.class_ids[ci]
                        if ci < len(self.class_ids) else ci + 1
                    )
                    self.coco_data.append({
                        "image_id": int(img_id),
                        "category_id": cat,
                        "bbox": [
                            float(row[0]), float(row[1]),
                            float(row[2] - row[0]), float(row[3] - row[1]),
                        ],
                        "score": float(row[4]),
                        "segmentation": [],
                    })

    def summarize(self):
        """Returns dict with mp/mr/map50/map50_95 + per-class table data."""
        if not self.stats:
            return {"map50": 0.0, "map50_95": 0.0, "map75": 0.0, "mp": 0.0,
                    "mr": 0.0, "per_class": []}
        stats = [np.concatenate(x, 0) for x in zip(*self.stats)]
        out = {"map50": 0.0, "map50_95": 0.0, "map75": 0.0, "mp": 0.0,
               "mr": 0.0, "per_class": []}
        if len(stats) and stats[0].any():
            tp, fp, p, r, f1, ap, ap_class = ap_per_class(*stats)
            ap50, ap_mean = ap[:, 0], ap.mean(1)
            out.update(
                mp=float(p.mean()), mr=float(r.mean()),
                map50=float(ap50.mean()), map50_95=float(ap_mean.mean()),
                map75=float(ap[:, 5].mean()),  # iouv[5] == 0.75
            )
            nt = np.bincount(stats[3].astype(int),
                             minlength=len(self.class_labels))
            for i, c in enumerate(ap_class):
                out["per_class"].append({
                    "class": self.class_labels[int(c)]
                    if int(c) < len(self.class_labels) else str(int(c)),
                    "images": self.seen,
                    "targets": int(nt[c]),
                    "precision": float(p[i]),
                    "recall": float(r[i]),
                    "ap50": float(ap50[i]),
                    "ap": float(ap_mean[i]),
                })
        self.metrics = out
        return out

    def summarize_coco(self) -> dict:
        """Full COCO-protocol metric set (map/map_50/map_75/size bins,
        mar_1/10/100/size bins) — the counterpart of the reference's
        torchmetrics MeanAveragePrecision tables (det_trainer.py:150-177)."""
        if self.coco_metrics is None:
            raise RuntimeError(
                "COCO accumulation was disabled for this pass — call "
                "reset(collect_coco=True) before update()"
            )
        return self.coco_metrics.compute()

    def coco_evaluate(self):
        """Optional pycocotools backend (gated, like the reference
        det_evaluator.py:246-271)."""
        try:
            from pycocotools.coco import COCO
            from pycocotools.cocoeval import COCOeval
        except ImportError:
            return "pycocotools not available"
        import contextlib
        import io
        import json
        import os
        import tempfile

        if not self.coco_data:
            return ""
        coco_gt = COCO(self.gt_json)
        fd, tmp = tempfile.mkstemp(suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(self.coco_data, f)
        coco_dt = coco_gt.loadRes(tmp)
        ev = COCOeval(coco_gt, coco_dt, "bbox")
        ev.evaluate()
        ev.accumulate()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ev.summarize()
        return buf.getvalue()
