"""Batched predictor: uint8 frames in, detections in source-frame pixels out.

Counterpart of vision_kit_tpu/predictor.py:Predictor. Letterbox, forward,
the postprocess and the rescale/clip to the source frame all run on the
device; the only transfers are the frames in and the padded (max_det, 6)
result out. The postprocess is the raw-map one (with the port's two
kernels), or with multi_label the decoded-output one (ops/nms.py:postprocess,
with the greedy-NMS kernel).

As in the JAX predictor, the model gets the letterboxed image as float,
normalised by /255 in f32 (bench-style uint8 input, which the stem scales,
rounds differently; see utils/stream_bench.py). A model built with
decode_order="reference" serves through the same kernels: its raw maps are
anchor-major views of the same conv output (ops/nms.py:postprocess_raw).

Data-parallel serving (mesh=, the counterpart of the JAX predictor's
"data" axis): one process per device (torchrun; parallel/mesh.py), and
every rank calls predict_batch / run with the same global batch. A batch of
more than one frame that divides by the mesh's n_data runs on each data
shard's rows alone (shard_rows), and gather_rows hands every rank the whole
batch's (dets, valid); a single image, or a batch that does not divide,
runs whole on every data shard, as JAX replicates it.

Spatial serving (spatial=True, the "model" axis; parallel/spatial.py): the
multi-device latency path. Every rank letterboxes the whole frames and runs
the network on its band of their rows, the head maps are gathered over the
model axis, and every rank runs the postprocess (both kernels) on the
whole maps. A single image runs on the mesh, and a batch shards over the
data axis as above (with n_data 1 every batch runs whole on the model
group).

Weights (counterparts of vision_kit_tpu/predictor.py:load_weights and its
helpers): `load_weights` reads a vision_kit-format `.pt`/`.pth`/`.ckpt`, a
port TrainState checkpoint (train/checkpoint.py) or the JAX package's Flax
`.msgpack` (its export's variables, or its Trainer's best EMA weights;
utils/flax_msgpack.py) into a model, folds training weights into a deploy
model, and copies every entry whose name and shape match.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from vision_kit_tpu_torch.ops.letterbox import letterbox_device
from vision_kit_tpu_torch.ops.nms import postprocess, postprocess_raw
from vision_kit_tpu_torch.parallel import mesh as pmesh
from vision_kit_tpu_torch.parallel.spatial import banded, check_height
from vision_kit_tpu_torch.utils.general import resolve_device
from vision_kit_tpu_torch.utils.logging_utils import logger


class Predictor:
    def __init__(
        self,
        model,
        img_size: int | tuple[int, int] = 640,
        conf_thres: float = 0.25,
        iou_thres: float = 0.45,
        max_det: int = 300,
        max_cand: int = 1024,
        multi_label: bool = False,
        approx_topk: bool = True,
        mesh=None,
        spatial: bool = False,
        device: str | torch.device = "cuda",
    ):
        """model: a port YOLOV5 or YOLOV7 (moved to `device` here; a v7 in
        the training or the deploy structure). multi_label runs
        the model's decode and the decoded-output postprocess with every
        (anchor, class) pair a candidate. mesh: a parallel.mesh.Mesh
        (make_mesh) to shard batches over, its device taking the place of
        `device`. spatial: band the letterboxed height over the mesh's model
        axis; needs a mesh, and img_size H >= 64 * n_model. approx_topk is accepted; the top-k is exact (see ops/nms.py). The
        raw maps' order follows the model's decode_order, as in the JAX
        predictor."""
        self.mesh = pmesh.check_mesh(mesh)
        self.spatial = spatial
        self.img_size = (
            (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        )
        if spatial:
            if mesh is None:
                raise ValueError("spatial=True requires a mesh")
            check_height(self.img_size[0], mesh.n_model)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.model = model.to(self.device).eval()
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.max_cand = max_cand
        self.multi_label = multi_label
        self.approx_topk = approx_topk
        self.anchors_px = torch.as_tensor(model.anchors_px, dtype=torch.float32,
                                          device=self.device)
        self.strides = tuple(model.strides)

    def _local_rows(self, n: int) -> torch.Tensor | None:
        """This rank's rows of an n-frame batch, or None when the batch runs
        whole (no mesh, one frame, or n not a multiple of n_data)."""
        if self.mesh is None or n < 2 or n % self.mesh.n_data:
            return None
        return pmesh.shard_rows(self.mesh, n)

    def _gather(self, dets: torch.Tensor, valid: torch.Tensor):
        """The data shards' (dets, valid) stacked in order on every rank:
        one gather_rows, valid riding as a seventh column."""
        both = torch.cat([dets, valid[..., None].to(dets.dtype)], dim=-1)
        both = pmesh.gather_rows(self.mesh, both)
        return both[..., :6], both[..., 6] > 0

    def run(self, imgs_u8: torch.Tensor):
        """(B, H, W, 3) uint8 on the device -> (dets (B, max_det, 6),
        valid (B, max_det)) in source-frame pixels. Without a mesh it does
        not synchronise; under one, every rank passes the same batch, runs
        its data shard's rows of it when B divides by n_data (its band of
        them with spatial) and gathers the whole batch's result."""
        rows = self._local_rows(len(imgs_u8))
        if rows is None:
            return self._run(imgs_u8)
        return self._gather(*self._run(imgs_u8[rows.to(imgs_u8.device)]))

    @torch.inference_mode()
    def _run(self, imgs_u8: torch.Tensor):
        """run on this process's device alone."""
        h0, w0 = imgs_u8.shape[1:3]
        x, (ratio, pad) = letterbox_device(imgs_u8, self.img_size)
        kwargs = dict(conf_thres=self.conf_thres, iou_thres=self.iou_thres,
                      max_det=self.max_det, max_cand=self.max_cand,
                      approx_topk=self.approx_topk)
        with contextlib.ExitStack() as stack:
            if self.spatial:
                x = stack.enter_context(banded(self.mesh, x.shape[1])).rows(x)
            if self.multi_label:
                decoded, _ = self.model(x)
            else:
                raws = self.model(x, decode=False)
        if self.multi_label:
            dets, valid = postprocess(decoded, multi_label=True, **kwargs)
        else:
            dets, valid = postprocess_raw(
                raws, self.anchors_px, strides=self.strides,
                anchor_major=self.model.decode_order == "reference", **kwargs)
        pad_t = torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                             dtype=torch.float32, device=self.device)
        hi = torch.tensor([w0, h0, w0, h0], dtype=torch.float32,
                          device=self.device)
        ratio_t = torch.tensor(ratio, dtype=torch.float32, device=self.device)
        boxes = (dets[..., :4] - pad_t) / ratio_t
        boxes = torch.minimum(boxes.clamp_min(0.0), hi)
        return torch.cat([boxes, dets[..., 4:]], dim=-1), valid

    def warmup(self, src_hw: tuple[int, int], batch: int = 1):
        """One run on zero frames of this shape (kernel builds, autotune);
        under a mesh every rank calls it."""
        dummy = torch.zeros((batch, *src_hw, 3), dtype=torch.uint8,
                            device=self.device)
        dets, _ = self.run(dummy)
        dets.cpu()

    def __call__(self, img_rgb):
        """img_rgb: HWC uint8, numpy or a tensor (a decoded video frame on
        the device is used where it lies). Returns (dets (n, 6) np [xyxy
        conf cls], elapsed_ms)."""
        batch = img_rgb[None] if isinstance(img_rgb, torch.Tensor) else np.asarray(img_rgb)[None]
        dets, ms = self.predict_batch(batch)
        return dets[0], ms

    def predict_batch(self, imgs_rgb):
        """imgs_rgb: (B, H, W, 3) uint8, one source resolution, numpy or a
        tensor. Returns (list of (n_i, 6) arrays, elapsed_ms). Under a mesh
        every rank passes the same frames and gets the whole batch's
        detections; only its own rows are uploaded."""
        rows = self._local_rows(len(imgs_rgb))
        if isinstance(imgs_rgb, torch.Tensor):
            imgs = imgs_rgb if rows is None else imgs_rgb[rows.to(imgs_rgb.device)]
        else:
            imgs_rgb = np.asarray(imgs_rgb)
            local = imgs_rgb if rows is None else imgs_rgb[rows.numpy()]
            imgs = torch.from_numpy(np.ascontiguousarray(local))
        t0 = time.perf_counter()
        dets, valid = self._run(imgs.to(self.device))
        if rows is not None:
            dets, valid = self._gather(dets, valid)
        dets = dets.cpu().numpy()
        valid = valid.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1000
        return [dets[i][valid[i]] for i in range(len(dets))], ms


def load_predictor_from_config(cfg, weights: str | None = None,
                               device: str | torch.device = "cuda",
                               dtype: torch.dtype = torch.float32,
                               seed: int = 0, **kwargs):
    """Build the config's model (YOLOv5, or YOLOv7 in the structure that
    cfg.model.deploy names) with weights drawn from `seed`, load `weights`
    into it when given (load_weights, strict), and wrap it in a Predictor
    at cfg.model.input_size."""
    from vision_kit_tpu_torch.models import build_model

    model = build_model(cfg, device=device, dtype=dtype, seed=seed)
    if weights:
        load_weights(weights, model)
    return Predictor(model, img_size=tuple(cfg.model.input_size),
                     device=device, **kwargs)


def _read_weights(path: str, device="cpu") -> dict:
    """The weights in a checkpoint file or orbax directory as {key: f32
    tensor on the CPU}; `device` is where an orbax directory's chunks are
    decompressed (utils/orbax.py)."""
    from vision_kit_tpu_torch.convert import (
        checkpoint_state_dict,
        state_dict_from_jax_variables,
    )
    from vision_kit_tpu_torch.train.checkpoint import is_train_state, train_state_weights
    from vision_kit_tpu_torch.utils import flax_msgpack, orbax

    if os.path.isdir(path):
        if not orbax.is_checkpoint(path):
            raise ValueError(f"{path}: a directory without orbax's _METADATA is not a "
                             "checkpoint")
        return state_dict_from_jax_variables(_orbax_variables(path, device))
    if path.endswith(".msgpack"):
        return state_dict_from_jax_variables(
            flax_msgpack.variables_of(flax_msgpack.read_file(path), path))
    if not path.endswith((".pt", ".pth", ".ckpt")):
        raise ValueError(f"{path}: expected a .pt, .pth, .ckpt or .msgpack file, or an "
                         "orbax checkpoint directory")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if is_train_state(ckpt):
        return {k: v.float() for k, v in train_state_weights(ckpt).items()}
    return checkpoint_state_dict(ckpt)


def _orbax_variables(path: str, device="cpu") -> dict:
    """The model weights of an orbax checkpoint directory as Flax variables
    {"params", "batch_stats"}: for a JAX Trainer's TrainState the EMA once
    updated, else the raw params (convert.weights_from_jax_train_state,
    JAX's _extract_weights_from_train_state); a bare variables tree whole.
    Only the arrays that are returned are read (and ema.updates)."""
    from vision_kit_tpu_torch.convert import (
        train_state_weights_prefix,
        weights_from_jax_train_state,
    )
    from vision_kit_tpu_torch.utils import orbax

    probe = orbax.read_checkpoint(path, device, select=lambda p: p == ("ema", "updates"))
    prefix = train_state_weights_prefix(probe)
    if prefix is None:
        return weights_from_jax_train_state(orbax.read_checkpoint(path, device))
    n = len(prefix)
    tree = orbax.read_checkpoint(
        path, device,
        select=lambda p: (p == ("ema", "updates") or p[:n] == prefix
                          and p[n:n + 1] in (("params",), ("batch_stats",))))
    return weights_from_jax_train_state(tree)


def load_weights(path: str, model: torch.nn.Module, partial: bool = False):
    """Load a checkpoint into `model` in place and return it.

    `path`: a vision_kit-format `.pt`/`.pth`/`.ckpt` (a state_dict, or one
    wrapped as Lightning and the reference save it;
    convert.checkpoint_state_dict), a port TrainState checkpoint
    (train/checkpoint.py; its EMA once updated, else its parameters), a
    Flax `.msgpack` of {"params", "batch_stats"} (the JAX export's
    variables or the JAX Trainer's best EMA weights), or an orbax
    checkpoint directory (the JAX Trainer's ckpts/last or ckpts/best:
    its EMA once updated, else its params, as the JAX predictor picks
    them; utils/orbax.py reads it, its chunks decompressed on the model's
    device: the host C decoder for a model on the card). JAX weights are
    bridged by convert.state_dict_from_jax_variables.
    Training weights loaded into a deploy model are folded first
    (_maybe_deploy_fold). Every model entry whose key and shape the
    checkpoint has is copied, cast to the model's dtype and device;
    num_batches_tracked stays the model's own.

    partial=False raises when the checkpoint misses or mis-shapes any
    entry, with their count (JAX's count of template leaves for the same
    file); partial=True keeps the model's values there (the reference's
    shape-checked partial load, the fine-tune path to another number of
    classes)."""
    device = next(model.parameters()).device.type
    loaded = _maybe_deploy_fold(_read_weights(path, device), model)
    if partial:
        sd = merge_matching(model.state_dict(), loaded)
    else:
        sd, skipped = _merge_counting(model.state_dict(), loaded)
        if skipped:
            raise ValueError(
                f"checkpoint {path} does not cover the model: {skipped} model "
                "entries missing or shape-mismatched (use partial=True for a "
                "shape-checked partial load)")
    model.load_state_dict(sd, strict=True)
    return model


def _maybe_deploy_fold(loaded: dict, model: torch.nn.Module) -> dict:
    """Training weights for a deploy model, folded as the JAX predictor
    does at load time: RepConv branches (`rbr_dense`) into `rbr_reparam`
    when the model has it, and the head's implicit layers into its convs
    when the model's head has none (v7 x differs from its deploy structure
    by the implicits alone)."""
    from vision_kit_tpu_torch.convert import fuse_repconv_params, reparameterize_v7

    keys = model.state_dict().keys()
    if (any("rbr_dense." in k for k in loaded)
            and any("rbr_reparam." in k for k in keys)):
        loaded = fuse_repconv_params(loaded)
    if ("head.ia.0.implicit" in loaded and "head.ia.0.implicit" not in keys
            and "head.m.0.weight" in keys):
        loaded = reparameterize_v7(loaded)
    return loaded


def _merge_counting(template: dict, loaded: dict) -> tuple[dict, int]:
    """merge_matching and the number of template entries (without
    num_batches_tracked) that the checkpoint missed or mis-shaped."""
    out, kept, skipped = {}, 0, 0
    for k, v in template.items():
        lv = loaded.get(k)
        if k.endswith("num_batches_tracked"):
            out[k] = v
        elif lv is not None and lv.shape == v.shape:
            out[k] = lv.to(device=v.device, dtype=v.dtype)
            kept += 1
        else:
            out[k] = v
            skipped += 1
    if skipped:
        logger.info(
            "partial load: %d entries copied, %d kept from the model", kept, skipped)
    return out, skipped


def merge_matching(template: dict, loaded: dict) -> dict:
    """`template` (a model's state_dict) with every entry whose key and
    shape `loaded` has replaced by the loaded value in the template's dtype
    and device (the reference's load_ckpt); num_batches_tracked stays the
    template's."""
    return _merge_counting(template, loaded)[0]
