"""YOLO training loss with a fixed-shape anchor assigner, in PyTorch.

Counterpart of vision_kit_tpu/train/losses.py. Every (image, label,
anchor, neighbour offset) tuple is a row of a dense candidate tensor
(B, M, na, 5) with a validity mask, so no shape depends on the data; row
gathers and a scatter-max against the flattened prediction grids stand for
the reference's ragged indexing.

Targets are padded per image to (B, M, 5) rows [cls, cx, cy, w, h]
(normalised cxcywh, cls < 0 marks padding).

The dtypes follow the JAX version's type promotion: with bf16 maps the
objectness target grid and the valid-candidate count are bf16, the box
terms f32 (the anchors are f32). Call the loss outside autocast, so each op
runs in the dtype its inputs give it.

The loss's constants (anchors, offsets, grid gains) go to the device once
and are kept: a copy from pageable host memory synchronises the stream, and
would stall the host behind the forward on every step.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vision_kit_tpu_torch.ops.boxes import box_iou_aligned

# neighbour offsets: centre, left, top, right, bottom
_OFFSETS = np.array(
    [[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.float32
) * 0.5


def smooth_bce(eps: float = 0.0) -> tuple[float, float]:
    """Label smoothing targets (positive, negative)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Elementwise BCE-with-logits with positive-class weighting
    (torch.nn.BCEWithLogitsLoss(pos_weight=...) semantics), in the JAX
    version's log-sigmoid form."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    return -(pos_weight * targets * log_p + (1.0 - targets) * log_not_p)


def focal_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                          pos_weight: float = 1.0, gamma: float = 1.5,
                          alpha: float = 0.25) -> torch.Tensor:
    """BCE modulated by (1 - p_t)^gamma with alpha class balancing."""
    bce = bce_with_logits(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    alpha_t = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return bce * alpha_t * (1.0 - p_t) ** gamma


class YoloLoss:
    """Anchor-based YOLO loss (CIoU box + BCE obj + BCE cls).

    Args:
      num_classes: class count.
      anchors: (nl, na, 2) anchors in grid units (the head's grid_anchors).
      hyp: box/obj/cls gains, *_pw positive weights, anchor_t,
        label_smoothing, fl_gamma.
      layout: of the raw maps, "native" (B, ny, nx, na, no) as the port's
        head emits them, "anchor_major" (B, na, ny, nx, no), or "auto" (per
        level from the shape).
    """

    def __init__(self, num_classes: int, anchors: np.ndarray, hyp: dict,
                 layout: str = "auto"):
        if layout not in ("auto", "anchor_major", "native"):
            raise ValueError(f"layout {layout!r}")
        self.num_classes = num_classes
        self.anchors = np.asarray(anchors, np.float32)  # (nl, na, 2)
        self.nl, self.na = self.anchors.shape[:2]
        self.layout = layout
        self.hyp = dict(hyp)
        self.balance = ([4.0, 1.0, 0.4] if self.nl == 3
                        else [4.0, 1.0, 0.25, 0.06, 0.02])
        self.cp, self.cn = smooth_bce(self.hyp.get("label_smoothing", 0.0))
        self.gr = 1.0
        self.fl_gamma = float(self.hyp.get("fl_gamma", 0.0))
        self._consts: dict = {}

    def _const(self, key, value, device) -> torch.Tensor:
        """`value` as an f32 tensor on `device`, copied there on first use."""
        t = self._consts.get((key, device))
        if t is None:
            t = torch.from_numpy(np.asarray(value, np.float32)).to(device)
            self._consts[(key, device)] = t
        return t

    def _bce(self, logits, targets, pos_weight):
        if self.fl_gamma > 0:
            return focal_bce_with_logits(logits, targets, pos_weight,
                                         gamma=self.fl_gamma)
        return bce_with_logits(logits, targets, pos_weight)

    def __call__(self, preds: Sequence[torch.Tensor], targets: torch.Tensor, mesh=None):
        """preds: per-level raw maps; targets: (B, M, 5) padded rows.

        Returns (total, parts): total = (box + obj + cls) * batch size, and
        parts the detached (box, obj, cls) after their gains.

        mesh (parallel.mesh.Mesh): preds and targets are this rank's rows of
        the global batch, and the normalisers are the global batch's (the
        matched count of each level, the anchors of the objectness mean, the
        batch size), summed over the data axis in one collective (the ranks
        of a model group hold the same rows: the whole maps under spatial
        partitioning). The result is
        this rank's share: the ranks' totals and parts sum to the loss of the
        global batch, and their gradients to its gradient."""
        bs = preds[0].shape[0]
        anchors = [self._const(("anchors", i), self.anchors[i], targets.device)
                   for i in range(self.nl)]
        cands = [self._candidates(targets, anchors[i], *self._grid(preds[i]))
                 for i in range(self.nl)]
        norms = [None] * self.nl
        if mesh is not None:
            norms = self._global_counts(mesh, [c["valid"] for c in cands], preds)
            bs *= mesh.n_data
        loss_box = loss_obj = loss_cls = 0.0
        for i in range(self.nl):
            lb, lo, lc = self._level_loss(preds[i], cands[i], anchors[i], norms[i])
            loss_box = loss_box + lb
            loss_obj = loss_obj + lo * self.balance[i]
            loss_cls = loss_cls + lc
        return self._total(loss_box, loss_obj, loss_cls, bs)

    @staticmethod
    def _global_counts(mesh, matched, preds):
        """Per level, (matched candidates, anchors) summed over the mesh's
        data axis: one all-reduce of every level's counts."""
        from vision_kit_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce

        # the anchor counts by a fill on the device: no host copy to wait on
        local = torch.stack([m.sum() for m in matched]
                            + [m.new_full((), p.numel() // p.shape[-1], dtype=torch.int64)
                               for p, m in zip(preds, matched)])
        total = all_reduce(mesh, local, DATA_AXIS)
        nl = len(matched)
        return [(total[i], total[nl + i]) for i in range(nl)]

    def _total(self, loss_box, loss_obj, loss_cls, bs):
        loss_box = loss_box * self.hyp["box"]
        loss_obj = loss_obj * self.hyp["obj"]
        loss_cls = loss_cls * self.hyp["cls"]
        total = (loss_box + loss_obj + loss_cls) * bs
        # f32, as jnp.stack promotes the f32 box term with the others
        parts = torch.stack([loss_box.float(), loss_obj.float(),
                             loss_cls.float()]).detach()
        return total, parts

    def _candidates(self, targets, anchors, ny, nx):
        """Dense candidates of one level: (B, M, na, 5) fields and validity."""
        b, m, _ = targets.shape
        na = self.na
        cls = targets[..., 0]                                  # (B, M)
        label_valid = cls >= 0
        gain = self._const(("gain", nx, ny), [nx, ny], targets.device)
        gxy = targets[..., 1:3] * gain                         # grid xy
        gwh = targets[..., 3:5] * gain

        # anchor-ratio filter
        ratio = gwh[:, :, None, :] / anchors[None, None]      # (B, M, na, 2)
        worst = torch.maximum(ratio, 1.0 / ratio).amax(dim=-1)
        match_ok = label_valid[:, :, None] & (worst < self.hyp.get("anchor_t", 4.0))

        # neighbour-offset validity
        gx, gy = gxy[..., 0], gxy[..., 1]
        gxi, gyi = nx - gx, ny - gy
        j = (gx % 1.0 < 0.5) & (gx > 1.0)       # left neighbour
        k = (gy % 1.0 < 0.5) & (gy > 1.0)       # top neighbour
        l = (gxi % 1.0 < 0.5) & (gxi > 1.0)     # right neighbour
        mm = (gyi % 1.0 < 0.5) & (gyi > 1.0)    # bottom neighbour
        off_ok = torch.stack([torch.ones_like(j), j, k, l, mm], dim=-1)  # (B,M,5)
        valid = match_ok[..., None] & off_ok[:, :, None, :]  # (B, M, na, 5)

        full = (b, m, na, 5, 2)
        offsets = self._const("offsets", _OFFSETS, targets.device)
        cell = torch.floor((gxy[:, :, None, None, :] - offsets).expand(full))
        gi = cell[..., 0].clamp(0, nx - 1).long()
        gj = cell[..., 1].clamp(0, ny - 1).long()
        txy = gxy[:, :, None, None, :] - torch.stack([gi, gj], dim=-1)
        twh = gwh[:, :, None, None, :].expand(full)
        return {"valid": valid, "gi": gi, "gj": gj, "txy": txy, "twh": twh,
                "cls": cls}

    def _resolve_layout(self, pred):
        if self.layout != "auto":
            return self.layout
        na = self.na
        if pred.shape[3] == na and pred.shape[1] != na:
            return "native"
        if pred.shape[1] == na and pred.shape[3] != na:
            return "anchor_major"
        raise ValueError(f"ambiguous raw-map shape {tuple(pred.shape)} (grid "
                         "size == na); construct YoloLoss with an explicit layout=")

    def _linear(self, pred, gi, gj):
        """Flat row of (image, anchor, gj, gi) in pred's layout, for
        (B, ..., na, 5)-shaped gi/gj."""
        b, na = pred.shape[0], self.na
        ny, nx = self._grid(pred)
        batch_idx = torch.arange(b, device=gi.device).reshape(b, 1, 1, 1)
        anchor_idx = torch.arange(na, device=gi.device).reshape(1, 1, na, 1)
        if self._resolve_layout(pred) == "native":
            return ((batch_idx * ny + gj) * nx + gi) * na + anchor_idx
        return ((batch_idx * na + anchor_idx) * ny + gj) * nx + gi

    def _grid(self, pred):
        """(ny, nx) of a level in its layout."""
        if self._resolve_layout(pred) == "native":
            return pred.shape[1], pred.shape[2]
        return pred.shape[2], pred.shape[3]

    def _obj_loss(self, pred, lin_flat, iou_updates, n_anchors=None):
        """BCE of every cell's objectness against the scatter-max of the
        candidates' detached, clamped IoU (in pred's dtype), averaged over
        the anchors, or summed over n_anchors (the global batch's) when
        given."""
        no = pred.shape[-1]
        obj_logits = pred.reshape(-1, no)[:, 4]
        tobj = torch.zeros(obj_logits.shape, dtype=pred.dtype, device=pred.device)
        tobj = tobj.scatter_reduce(0, lin_flat, iou_updates.to(pred.dtype), "amax",
                                   include_self=True)
        bce = self._bce(obj_logits, tobj, self.hyp.get("obj_pw", 1.0))
        if n_anchors is None:
            return bce.mean()
        acc = torch.promote_types(bce.dtype, torch.float32)
        return (bce.sum(dtype=acc) / n_anchors).to(bce.dtype)

    def _cls_targets(self, cls: torch.Tensor) -> torch.Tensor:
        """Smoothed one-hot targets (f32) of class ids (any shape)."""
        nc = self.num_classes
        onehot = F.one_hot(cls.clamp(0, nc - 1).long(), nc)
        return torch.where(onehot > 0, self.cp, self.cn).float()

    def _level_loss(self, pred, cand, anchors, norm=None):
        """One level's (box, obj, cls) over its candidates; norm: the
        global (matched, anchors) counts under a mesh."""
        nc = self.num_classes
        no = pred.shape[-1]
        b = pred.shape[0]
        valid = cand["valid"]                                  # (B, M, na, 5)
        m = valid.shape[1]
        lin_flat = self._linear(pred, cand["gi"], cand["gj"]).reshape(-1)
        valid_flat = valid.reshape(-1)

        psub = pred.reshape(-1, no).index_select(0, lin_flat)  # (C, no)

        # box regression
        pxy = torch.sigmoid(psub[:, 0:2]) * 2.0 - 0.5
        anc = anchors[None, None, :, None, :].expand(b, m, self.na, 5, 2).reshape(-1, 2)
        pwh = (torch.sigmoid(psub[:, 2:4]) * 2.0) ** 2 * anc
        pbox = torch.cat([pxy.to(pwh.dtype), pwh], dim=-1)
        tbox = torch.cat([cand["txy"].reshape(-1, 2), cand["twh"].reshape(-1, 2)], dim=-1)
        iou = box_iou_aligned(pbox, tbox, box_format="cxcywh", mode="ciou")
        n_valid = (valid_flat.sum() if norm is None else norm[0]).clamp_min(1).to(pred.dtype)
        loss_box = torch.where(valid_flat, 1.0 - iou, 0.0).sum() / n_valid

        # objectness target grid: scatter-max of the detached clamped IoU
        iou_det = iou.detach().clamp_min(0.0)
        if self.gr < 1.0:
            iou_det = (1.0 - self.gr) + self.gr * iou_det
        loss_obj = self._obj_loss(pred, lin_flat, torch.where(valid_flat, iou_det, 0.0),
                                  None if norm is None else norm[1])

        # classification
        if nc > 1:
            tcls = cand["cls"][:, :, None, None].expand(b, m, self.na, 5).reshape(-1)
            ce = self._bce(psub[:, 5:], self._cls_targets(tcls),
                           self.hyp.get("cls_pw", 1.0))
            loss_cls = torch.where(valid_flat[:, None], ce, 0.0).sum() / (n_valid * nc)
        else:
            loss_cls = torch.zeros((), dtype=pred.dtype, device=pred.device)
        return loss_box, loss_obj, loss_cls
