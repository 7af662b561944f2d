"""SimOTA loss for YOLOv7, in PyTorch.

Counterpart of vision_kit_tpu/train/ota.py:YoloLossOTA (dynamic-k from the
top-10 IoUs, cost = cls + 3 * iou_loss, a candidate claimed by several
labels goes to the label of least cost) over the same dense candidate set
as losses.YoloLoss. The JAX version assigns per image under vmap; here one
set of batched ops covers the (B, M, C) cost tensor.

The assignment is part of the result, ties included: candidates of one
(label, anchor) whose offsets clip to the same cell carry the same features
and so the same cost. jax.lax.top_k keeps the lower index among equal
values, torch.topk sets no order, so both top-k's here are
ops/nms.py:topk_stable. The assignment runs without gradient, as the JAX
version's integer outputs carry none.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from vision_kit_tpu_torch.ops.boxes import box_iou_aligned, box_iou_pairwise
from vision_kit_tpu_torch.ops.nms import topk_stable
from vision_kit_tpu_torch.train.losses import YoloLoss

BIG = 1e6


class YoloLossOTA(YoloLoss):
    """SimOTA assignment + YOLO loss. Same call signature as YoloLoss."""

    def __init__(self, num_classes: int, anchors: np.ndarray, hyp: dict,
                 strides: Sequence[float] = (8.0, 16.0, 32.0),
                 top_k: int = 10, layout: str = "auto"):
        super().__init__(num_classes, anchors, hyp, layout=layout)
        self.strides = tuple(strides)
        self.top_k = top_k

    @staticmethod
    def _resolve_conflicts(mm: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
        """A candidate claimed by more than one label goes to the label of
        least cost (the first on ties), which may be one that never claimed
        it; it stays foreground either way. mm: (..., M, C) bool claims;
        cost: (..., M, C)."""
        claims = mm.sum(dim=-2, keepdim=True)
        best_gt = cost.argmin(dim=-2, keepdim=True)                   # (..., 1, C)
        rows = torch.arange(cost.shape[-2], device=cost.device)[:, None]
        return torch.where(claims > 1, rows == best_gt, mm)

    @torch.no_grad()
    def assign(self, feats, gxy, anc, stride, valid_c, targets, img_wh):
        """SimOTA over the batch. feats (B, C, no) raw candidate rows, gxy
        (B, C, 2) their cells, anc (C, 2) grid-unit anchors, stride (C,),
        valid_c (B, C), targets (B, M, 5), img_wh (2,) f32. Returns
        (fg (B, C) bool, matched_gt (B, C) int64)."""
        nc = self.num_classes
        sig = torch.sigmoid(feats)
        pxy = (sig[..., 0:2] * 2.0 - 0.5 + gxy) * stride[:, None]
        pwh = (sig[..., 2:4] * 2.0) ** 2 * anc * stride[:, None]
        pbox = torch.cat([pxy, pwh], dim=-1)                          # cxcywh px

        gt_valid = targets[..., 0] >= 0                               # (B, M)
        gt_cls = targets[..., 0].clamp(0, nc - 1).long()
        gt_box = targets[..., 1:5] * torch.cat([img_wh, img_wh])
        ok = gt_valid[:, :, None] & valid_c[:, None, :]               # (B, M, C)
        pair_iou = torch.where(
            ok, box_iou_pairwise(gt_box, pbox, box_format="cxcywh"), 0.0)
        iou_cost = -torch.log(pair_iou + 1e-8)

        # dynamic k per label: the sum of its top-10 IoUs, at least 1
        k = min(self.top_k, pair_iou.shape[-1])
        top_iou, _ = topk_stable(pair_iou, k)
        dynamic_k = top_iou.sum(dim=-1).int().clamp(1, k)             # (B, M)

        # classification cost from the logits in f32, through the stable
        # identities log y = (log_sig(cls) + log_sig(obj)) / 2 and
        # log(1 - y) = log(-expm1(log y)): y = sqrt(sig(cls) sig(obj))
        # rounds to 1 once the logits saturate, and log(1 - y) would give
        # -inf and a NaN cost that drops the best candidates
        cls_logit = feats[..., 5:].float()
        obj_logit = feats[..., 4].float()
        log_y = 0.5 * (F.logsigmoid(cls_logit) + F.logsigmoid(obj_logit)[..., None])
        log_1my = torch.log(-torch.expm1(log_y.clamp_max(-1e-20)))   # (B, C, nc)
        sum_log_1my = log_1my.sum(dim=-1)                             # (B, C)
        # BCE summed over classes with a one-hot target:
        # -(log y_c - log(1 - y_c) + sum_j log(1 - y_j))
        idx = gt_cls[:, None, :].expand(-1, log_y.shape[1], -1)      # (B, C, M)
        cls_cost = -(torch.gather(log_y, 2, idx) - torch.gather(log_1my, 2, idx)
                     + sum_log_1my[..., None]).transpose(1, 2)        # (B, M, C)

        cost = torch.where(ok, cls_cost + 3.0 * iou_cost, BIG)

        # the k least costs per label, kept at rank < dynamic_k
        neg_vals, idxs = topk_stable(-cost, k)                        # (B, M, k)
        rank_ok = ((torch.arange(k, device=cost.device) < dynamic_k[..., None])
                   & (-neg_vals < BIG / 2))
        mm = torch.zeros(cost.shape, dtype=torch.bool, device=cost.device)
        mm.scatter_(2, idxs, rank_ok)      # a row's top-k indices are distinct
        mm = self._resolve_conflicts(mm, cost)
        fg = mm.any(dim=1)                                            # (B, C)
        matched_gt = mm.to(torch.uint8).argmax(dim=1)                 # first claim
        return fg, matched_gt

    def __call__(self, preds, targets, mesh=None):
        """As YoloLoss.__call__, mesh included: under a mesh each level's
        foreground count, the objectness mean's anchors and the batch size
        are the global batch's; the assignment (dynamic k per image) stays
        on the rank's own rows."""
        bs = preds[0].shape[0]
        nc = self.num_classes

        # the candidate set of every level, concatenated
        metas, feats, gxys, ancs, strides, valids = [], [], [], [], [], []
        for i, pred in enumerate(preds):
            ny, nx = self._grid(pred)
            b, no = pred.shape[0], pred.shape[-1]
            anchors = self._const(("anchors", i), self.anchors[i], targets.device)
            c = self._candidates(targets, anchors, ny, nx)
            m = c["valid"].shape[1]
            cl = m * self.na * 5
            lin = self._linear(pred, c["gi"], c["gj"])                # (B, M, na, 5)
            feats.append(pred.reshape(-1, no).index_select(0, lin.reshape(-1))
                         .reshape(b, cl, no))
            gxys.append(torch.stack([c["gi"], c["gj"]], dim=-1).reshape(b, cl, 2).float())
            ancs.append(anchors[None, :, None, :].expand(m, self.na, 5, 2).reshape(cl, 2))
            strides.append(torch.full((cl,), self.strides[i], device=targets.device))
            valids.append(c["valid"].reshape(b, cl))
            metas.append((ny, nx, cl, lin))

        feats = torch.cat(feats, dim=1)                               # (B, C, no)
        gxy = torch.cat(gxys, dim=1)
        anc = torch.cat(ancs, dim=0)
        stride = torch.cat(strides, dim=0)
        ny0, nx0 = metas[0][:2]
        img_wh = self._const(("img_wh", nx0, ny0), [nx0 * self.strides[0],
                                                    ny0 * self.strides[0]], targets.device)
        with record_function("ota_assign"):
            fg, matched_gt = self.assign(feats.detach(), gxy, anc, stride,
                                         torch.cat(valids, dim=1), targets, img_wh)

        slices, col = [], 0
        for _, _, cl, _ in metas:
            slices.append(slice(col, col + cl))
            col += cl
        norms = [None] * len(preds)
        if mesh is not None:
            norms = self._global_counts(mesh, [fg[:, sl] for sl in slices], preds)
            bs *= mesh.n_data

        loss_box = loss_obj = loss_cls = 0.0
        for i, pred in enumerate(preds):
            ny, nx, cl, lin = metas[i]
            sl, norm = slices[i], norms[i]
            fg_l, feats_l, gxy_l, anc_l = fg[:, sl], feats[:, sl], gxy[:, sl], anc[sl]
            gt = torch.gather(targets, 1, matched_gt[:, sl, None].expand(-1, -1, 5))
            tbox = gt[..., 1:5] * self._const(("gain4", nx, ny), [nx, ny, nx, ny],
                                              targets.device)                # grid units
            tbox_rel = torch.cat([tbox[..., 0:2] - gxy_l, tbox[..., 2:4]], dim=-1)

            sig = torch.sigmoid(feats_l[..., 0:4])
            pxy = sig[..., 0:2] * 2.0 - 0.5
            pwh = (sig[..., 2:4] * 2.0) ** 2 * anc_l[None]
            pbox = torch.cat([pxy.to(pwh.dtype), pwh], dim=-1)
            iou = box_iou_aligned(pbox.reshape(-1, 4), tbox_rel.reshape(-1, 4),
                                  box_format="cxcywh", mode="ciou").reshape(fg_l.shape)
            n_l = (fg_l.sum() if norm is None else norm[0]).clamp_min(1).to(pred.dtype)
            loss_box = loss_box + torch.where(fg_l, 1.0 - iou, 0.0).sum() / n_l

            iou_det = iou.detach().clamp_min(0.0)
            loss_obj = loss_obj + self._obj_loss(
                pred, lin.reshape(-1), torch.where(fg_l, iou_det, 0.0).reshape(-1),
                None if norm is None else norm[1]) * self.balance[i]

            if nc > 1:
                ce = self._bce(feats_l[..., 5:], self._cls_targets(gt[..., 0]),
                               self.hyp.get("cls_pw", 1.0))
                loss_cls = loss_cls + (torch.where(fg_l[..., None], ce, 0.0).sum()
                                       / (n_l * nc))
        if nc <= 1:
            loss_cls = torch.zeros((), dtype=preds[0].dtype, device=targets.device)
        return self._total(loss_box, loss_obj, loss_cls, bs)
