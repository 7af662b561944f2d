"""TrainState checkpoints: the port's own `torch.save` file with a
`.meta.json` beside it, and the JAX Trainer's orbax directories.

Stands for vision_kit_tpu/train/trainer.py:Trainer.save_checkpoint and
load_checkpoint. save_checkpoint writes the port's file: the state's
tensors under the port's names (the parameters, the BatchNorm
statistics, the SGD momentum buffers with the optimizer's step count, the
EMA tree with its update count, and the step), and the meta file JAX
writes beside its checkpoint (epoch, step, best_map50, epochs_no_improve,
val_pending). load_checkpoint reads that file or a JAX Trainer's
ckpts/last or ckpts/best directory (utils/orbax.py, without orbax or
tensorstore; the same parts under Flax's names, bridged by
convert.train_state_tensors_from_jax), with the JAX meta beside it.

A restore copies the tensors into a fresh state's own (the model's
parameters and statistics included), so it is bit-equal to the saved
state, and the next step equals the uninterrupted run's.
predictor.load_weights reads the same files and directories for its
weights: the EMA once it has been updated, else the parameters.
"""

from __future__ import annotations

import json
import os

import torch

from vision_kit_tpu_torch.train.ema import EMAState
from vision_kit_tpu_torch.train.optim import SGDState, sgd_state

FORMAT = "vision_kit_tpu_torch.train_state/1"


def is_train_state(obj) -> bool:
    """Whether a loaded checkpoint is one that save_checkpoint wrote."""
    return isinstance(obj, dict) and obj.get("format") == FORMAT


def save_checkpoint(path: str, state, epoch: int = -1,
                    best_map50: float = -1.0, epochs_no_improve: int = 0,
                    val_pending: bool = False, mesh=None) -> None:
    """Write `state` (train/step.py:TrainState) to `path` and the meta
    to `path + ".meta.json"`. The tensors go to the host as they are (f32
    master weights and f32 EMA).

    mesh (parallel.mesh.Mesh): rank 0 writes (the state is the same on
    every rank), and every rank returns past a barrier once the files are
    complete, so that any rank may read them."""
    try:
        if mesh is None or mesh.is_main:
            _write(path, state, epoch, best_map50, epochs_no_improve, val_pending)
    finally:
        if mesh is not None:
            from vision_kit_tpu_torch.parallel.mesh import barrier

            barrier(mesh)


def _write(path, state, epoch, best_map50, epochs_no_improve, val_pending):
    def host(tensors):
        return {k: v.detach().cpu() for k, v in tensors.items()}

    sgd = sgd_state(state.opt_state)
    torch.save({"format": FORMAT,
                "params": host(state.params),
                "batch_stats": host(state.batch_stats),
                "momentum": host(sgd.momentum_buf),
                "opt_step": sgd.step,
                "ema": {"updates": state.ema.updates, "tree": host(state.ema.tree)},
                "step": state.step}, path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": epoch, "step": state.step, "best_map50": best_map50,
                   "epochs_no_improve": epochs_no_improve,
                   "val_pending": val_pending}, f)


def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise ValueError(f"checkpoint {what} do not match the state: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    for k, t in dst.items():
        if t.shape != src[k].shape:
            raise ValueError(f"checkpoint {what} {k}: shape {tuple(src[k].shape)}, "
                             f"state {tuple(t.shape)}")
        t.copy_(src[k])


def _read(path: str, device: str) -> dict:
    """The checkpoint at `path` in save_checkpoint's format: the port's
    file, or a JAX Trainer's orbax directory read on `device`."""
    from vision_kit_tpu_torch.utils import orbax

    if os.path.isdir(path):
        from vision_kit_tpu_torch.convert import train_state_tensors_from_jax

        if not orbax.is_checkpoint(path):
            raise ValueError(f"{path}: a directory without orbax's _METADATA is not a "
                             "TrainState checkpoint")
        parts = train_state_tensors_from_jax(orbax.read_checkpoint(path, device))
        return {"format": FORMAT, "params": parts["params"],
                "batch_stats": parts["batch_stats"], "momentum": parts["momentum"],
                "opt_step": parts["opt_step"],
                "ema": {"updates": parts["ema_updates"], "tree": parts["ema"]},
                "step": parts["step"]}
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not is_train_state(ckpt):
        raise ValueError(f"{path} is not a TrainState checkpoint "
                         "(train/checkpoint.py:save_checkpoint)")
    return ckpt


@torch.no_grad()
def load_checkpoint(path: str, state):
    """Restore `path` into `state`, a TrainState of the same model and
    optimizer (train/step.py:create_train_state): every tensor is copied
    into the state's own, on their device and in their dtype, and the
    counts are carried. `path` is the port's file (save_checkpoint) or a
    JAX Trainer's orbax directory, whose chunks are decompressed on the
    state's device (the host C decoder on the card). Returns (state',
    meta), meta None when the `.meta.json` is absent.

    make_eval_step(state=...) captures the state's EMA tree when it is
    built: build the eval step again after a restore."""
    ckpt = _read(path, next(iter(state.params.values())).device.type)
    sgd = sgd_state(state.opt_state)
    _copy_into(state.params, ckpt["params"], "params")
    _copy_into(state.batch_stats, ckpt["batch_stats"], "batch_stats")
    _copy_into(sgd.momentum_buf, ckpt["momentum"], "momentum buffers")
    _copy_into(state.ema.tree, ckpt["ema"]["tree"], "EMA tree")
    restored = SGDState(step=int(ckpt["opt_step"]), momentum_buf=sgd.momentum_buf)
    opt_state = (tuple(restored if isinstance(s, SGDState) else s
                       for s in state.opt_state)
                 if isinstance(state.opt_state, tuple) else restored)
    ema = EMAState(updates=int(ckpt["ema"]["updates"]), tree=state.ema.tree)
    meta = None
    try:
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    except FileNotFoundError:
        pass
    return state._replace(opt_state=opt_state, ema=ema, step=int(ckpt["step"])), meta


def train_state_weights(ckpt: dict) -> dict:
    """The model weights of a loaded TrainState checkpoint, as a state_dict
    without num_batches_tracked: the EMA tree once the EMA has been
    updated (eval and export use the EMA model), else the parameters and
    statistics. Counterpart of
    vision_kit_tpu/predictor.py:_extract_weights_from_train_state."""
    if int(ckpt["ema"]["updates"]) > 0:
        return dict(ckpt["ema"]["tree"])
    return {**ckpt["params"], **ckpt["batch_stats"]}
