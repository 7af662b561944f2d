"""The training step and the eval step, on one device or data-parallel
over a mesh, over an explicit TrainState.

Counterpart of vision_kit_tpu/train/step.py. The parameters and BatchNorm
running statistics are the model's own tensors, which the step updates in
place; the state names them and carries the optimizer state, the EMA and
the step count:

    state, batch -> state', metrics

Under a data-parallel mesh (parallel/mesh.py; one process per device, the
batch this rank's rows) the step keeps the JAX step's numbers, which
torch's DistributedDataParallel would not: the BatchNorm statistics are
the global batch's (models/layers.py:BatchNorm2d), the loss's normalisers
too (train/losses.py), and the gradients and reported losses are summed
over the ranks in one flat bucket before the clip, the optimizer and the
EMA, which then run alike on every rank.

Spatial partitioning (spatial=True, over the mesh's model axis;
parallel/spatial.py): each rank of a model group runs the network on its
band of its data shard's images, and the loss (or the postprocess) on the
whole head maps, gathered on every rank, as the JAX step re-gathers them
before the loss. The BatchNorm statistics are then summed over the whole
mesh (every band of every image) and so are the parameter gradients (each
model rank holds its band's share); the losses are each data shard's,
every model rank holding the same. A step over a mesh with a model axis
but without spatial replicates the work over that axis, as JAX does: its
sums run over the data axis alone.

Precision: the parameters stay f32 (master weights); compute_dtype bf16
runs the forward under torch.autocast, and the loss outside it, in the
dtypes of the raw maps (train/losses.py).

The step's parts are profiler ranges (warp_augment, loss, optimizer, ema;
train/ota.py adds ota_assign), so a torch.profiler trace splits a step's
device time by part (chip_smoke.py's train phase).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from vision_kit_tpu_torch.models.layers import BatchNorm2d
from vision_kit_tpu_torch.ops.nms import postprocess
from vision_kit_tpu_torch.parallel import mesh as pmesh
from vision_kit_tpu_torch.parallel.spatial import banded
from vision_kit_tpu_torch.train.ema import EMAState, ema_init, ema_update
from vision_kit_tpu_torch.train.optim import global_norm

# the eval protocol: per-anchor top-20 class truncation gives the same mAP
# as the full N*nc expansion for any model whose anchors contribute <= 20
# classes to the global top-2048; set multi_label_top to 0 for the exact
# expansion
EVAL_POSTPROCESS = dict(conf_thres=0.001, iou_thres=0.6, multi_label=True,
                        max_det=300, max_cand=2048, multi_label_top=20)


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]       # the model's parameters, by name
    batch_stats: dict[str, torch.Tensor]  # its BatchNorm running statistics
    opt_state: Any
    ema: EMAState
    step: int


def create_train_state(model: nn.Module, tx, mesh=None) -> TrainState:
    """The state of `model`: its parameters and its floating buffers (the
    BatchNorm running mean and variance; num_batches_tracked is not state
    here, as the JAX tree has none), by state_dict name, with tx's state,
    an EMA of both and step 0. Under a mesh the model's parameters and
    buffers are rank 0's first (a broadcast), so the EMA is too."""
    if pmesh.check_mesh(mesh) is not None:
        with torch.no_grad():
            pmesh.broadcast_(mesh, [*model.parameters(), *model.buffers()])
    params = dict(model.named_parameters())
    stats = {k: v for k, v in model.named_buffers() if v.is_floating_point()}
    return TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                      ema=ema_init({**params, **stats}), step=0)


def _blocks(module: nn.Module):
    """The blocks under `module`, looking through nn.Sequential."""
    for child in module.children():
        if isinstance(child, nn.Sequential):
            yield from _blocks(child)
        else:
            yield child


@contextlib.contextmanager
def _frozen_stats(block: nn.Module):
    bns = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    for bn in bns:
        bn.freeze_stats = True
    try:
        yield
    finally:
        for bn in bns:
            bn.freeze_stats = False


def _recompute_contexts(block: nn.Module):
    return contextlib.nullcontext(), _frozen_stats(block)


@contextlib.contextmanager
def _synced(model: nn.Module, mesh, axis):
    """Batch statistics over the mesh's global batch (summed over `axis`,
    None the whole mesh) in every BatchNorm of `model` while the context is
    open (the forward, and the backward with its recomputes)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for bn in bns:
        bn.mesh, bn.axis = mesh, axis
    try:
        yield
    finally:
        for bn in bns:
            bn.mesh, bn.axis = None, None


def _spatial_mesh(mesh, spatial: bool):
    """check_mesh(mesh), and spatial's demand of one."""
    mesh = pmesh.check_mesh(mesh)
    if spatial and mesh is None:
        raise ValueError("spatial=True requires a mesh")
    return mesh


@contextlib.contextmanager
def _checkpointed(model: nn.Module):
    """Activation checkpointing of every backbone and neck block while the
    forward runs: a block keeps only its input, and the backward recomputes
    its activations. The recompute normalises with the batch statistics
    but leaves the running ones alone: the forward has updated them once."""
    blocks = [b for part in (model.backbone, model.neck) for b in _blocks(part)]
    for block in blocks:
        block.forward = functools.partial(
            checkpoint, block.forward, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=functools.partial(_recompute_contexts, block))
    try:
        yield
    finally:
        for block in blocks:
            del block.forward


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _autocast(dev: torch.device, compute_dtype: torch.dtype):
    """A context factory: torch.autocast in compute_dtype, none for f32."""
    if compute_dtype == torch.float32:
        return contextlib.nullcontext
    return functools.partial(torch.autocast, dev.type, dtype=compute_dtype)


def make_train_step(model: nn.Module, loss_fn, tx, mesh=None, spatial=False,
                    remat: bool = False, accum_steps: int = 1,
                    device_aug: bool = False, scale_to: int | None = None,
                    compute_dtype: torch.dtype = torch.float32):
    """Build train_step(state, batch) -> (state', metrics).

    batch: {"image": (B, H, W, 3) float in [0, 1] or uint8, "targets": (B,
    M, 5)}; with device_aug=True instead {"tiles": (B, 5, H, W, 3) uint8,
    "tile_hw": (B, 5, 2) int, "params": (B, N_PARAMS) float32, "targets"},
    and data/device_aug.py:warp_augment runs at the head of the step, on the
    whole batch, in compute_dtype. Numpy arrays or tensors on any device.

    scale_to: multi-scale training; the batch is resized to (scale_to,
    scale_to) on the device in compute_dtype (bilinear, antialiased when it
    downscales, as jax.image.resize; uint8 is normalised first). Targets are
    normalised and need no change.

    accum_steps > 1: the batch runs as accum_steps microbatches in turn,
    the applied gradient is their mean, and the BatchNorm statistics update
    after each microbatch (the resize, if any, runs per microbatch).

    remat: activation checkpointing of the forward (see _checkpointed).

    mesh (parallel.mesh.Mesh): the batch is this rank's rows of the global
    batch (parallel/mesh.py:shard_batch; with accum_steps, chunk k of them
    is the rank's share of microbatch k, as the JAX step shards each
    microbatch). Augmentation and the resize run on the local rows. The
    model's device must be the mesh's.

    spatial (needs a mesh): the images' height is banded over the mesh's
    model axis inside the step (the ranks of a model group pass the same
    rows, whole images, and each runs its band; the band plan follows each
    microbatch's height after the resize); the targets stay whole.

    metrics: loss, loss_box, loss_obj, loss_cls and grad_norm (the norm of
    the mean gradient before clipping), as tensors on the device; under a
    mesh those of the global batch, equal on every rank.
    """
    mesh = _spatial_mesh(mesh, spatial)
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} < 1")
    dev = _device(model)
    if mesh is not None and mesh.device != dev:
        raise ValueError(f"the model is on {dev}, the mesh's device is {mesh.device}")
    autocast = _autocast(dev, compute_dtype)
    loss_kw = {} if mesh is None else {"mesh": mesh}

    def maybe_scale(x):
        if scale_to is None or tuple(x.shape[1:3]) == (scale_to, scale_to):
            return x
        xf = x.to(compute_dtype)
        if x.dtype == torch.uint8:
            xf = xf * (1.0 / 255.0)
        y = F.interpolate(xf.permute(0, 3, 1, 2), size=(scale_to, scale_to),
                          mode="bilinear", align_corners=False, antialias=True)
        return y.permute(0, 2, 3, 1)

    # without spatial a model axis replicates the work: sums over the data axis
    axis = None if spatial else pmesh.DATA_AXIS

    def forward_backward(x, tgt):
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                stack.enter_context(_synced(model, mesh, axis))
            if spatial:
                x = stack.enter_context(banded(mesh, x.shape[1])).rows(x)
            with autocast(), (_checkpointed(model) if remat else contextlib.nullcontext()):
                raws = model(x, decode=False)
            with record_function("loss"):
                total, parts = loss_fn(raws, tgt, **loss_kw)
            total.backward()
        return total.detach().float(), parts

    def train_step(state: TrainState, batch):
        model.train()
        targets = torch.as_tensor(batch["targets"], device=dev)
        if device_aug:
            from vision_kit_tpu_torch.data.device_aug import warp_augment

            with record_function("warp_augment"):
                imgs = warp_augment(torch.as_tensor(batch["tiles"], device=dev),
                                    torch.as_tensor(batch["tile_hw"], device=dev),
                                    torch.as_tensor(batch["params"], device=dev),
                                    dtype=compute_dtype)
        else:
            imgs = torch.as_tensor(batch["image"], device=dev)

        params = state.params
        for p in params.values():
            p.grad = None
        b = imgs.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        total = 0.0
        parts = 0.0
        for x, tgt in zip(imgs.chunk(accum_steps), targets.chunk(accum_steps)):
            t, pp = forward_backward(maybe_scale(x), tgt)
            total, parts = total + t, parts + pp
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if mesh is not None:
            # the global gradient and losses: each rank's are its share.
            # Under spatial every model rank holds its data shard's losses,
            # so only model index 0 adds them (one collective for both)
            losses = torch.cat([total.reshape(1), parts])
            if spatial and mesh.model_index:
                losses = torch.zeros_like(losses)
            with record_function("all_reduce"):
                pmesh.all_reduce_(mesh, [*grads.values(), losses], axis)
            total, parts = losses[0], losses[1:]
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            torch._foreach_mul_(list(grads.values()), inv)
            total, parts = total * inv, parts * inv
        grad_norm = global_norm(grads.values())

        with torch.no_grad(), record_function("optimizer"):
            opt_state = tx.update(grads, state.opt_state, params, grad_norm)
        with torch.no_grad(), record_function("ema"):
            ema = ema_update(state.ema, {**params, **state.batch_stats})
        for p in params.values():
            p.grad = None
        metrics = {"loss": total, "loss_box": parts[0], "loss_obj": parts[1],
                   "loss_cls": parts[2], "grad_norm": grad_norm}
        return state._replace(opt_state=opt_state, ema=ema,
                              step=state.step + 1), metrics

    return train_step


def make_eval_step(model: nn.Module, postprocess_kwargs: dict | None = None,
                   state: TrainState | None = None, use_ema: bool = True,
                   compute_dtype: torch.dtype = torch.float32, mesh=None,
                   spatial: bool = False):
    """Eval step: forward with decode, then the eval-protocol postprocess.

    With a TrainState, as the JAX step, it evaluates the state's EMA
    weights (use_ema=True) in place of the model's own, or the model's own
    (use_ema=False); the training step updates the state's tensors in place,
    so the eval step always sees the latest. It captures the state's EMA
    tree when it is built: build it again after a checkpoint restore
    (train/checkpoint.py). Without a state it evaluates the model as it is.

    compute_dtype: the forward runs under torch.autocast in this dtype
    (bf16: the f32 EMA tree applied through a bf16 forward, as JAX's
    Trainer evaluates its bf16 model), as make_train_step's does.

    Returns eval_step(imgs): imgs (B, H, W, 3) uint8, a numpy array or a
    tensor on any device, goes straight into the model (the stem scales it),
    and eval_step returns (dets (B, max_det, 6), valid (B, max_det)) on the
    model's device without synchronising. The model runs in eval mode.

    mesh (parallel.mesh.Mesh): imgs are this rank's rows of the global
    batch (an equal share on every data shard); each rank runs its rows
    through the same postprocess, and the step returns the global batch's
    outputs, in data-shard order, on every rank.

    spatial (needs a mesh): the forward runs banded over the mesh's model
    axis (each rank of a model group passes the same rows and runs its band
    of them), and each rank postprocesses the gathered maps.
    """
    kwargs = {**EVAL_POSTPROCESS, **(postprocess_kwargs or {})}
    mesh = _spatial_mesh(mesh, spatial)
    model.eval()
    dev = _device(model)
    tree = state.ema.tree if state is not None and use_ema else None
    autocast = _autocast(dev, compute_dtype)

    @torch.inference_mode()
    def eval_step(imgs):
        if model.training:
            model.eval()
        x = torch.as_tensor(imgs, device=dev)
        with contextlib.ExitStack() as stack:
            if spatial:
                x = stack.enter_context(banded(mesh, x.shape[1])).rows(x)
            with autocast():
                if tree is None:
                    decoded, _ = model(x)
                else:
                    decoded, _ = torch.func.functional_call(model, tree, (x,),
                                                            strict=False)
        dets, valid = postprocess(decoded, **kwargs)
        if mesh is None:
            return dets, valid
        return pmesh.gather_rows(mesh, dets), pmesh.gather_rows(mesh, valid)

    return eval_step
