"""TrainState checkpoints: the JAX Trainer's orbax directories, written
in the background as its AsyncCheckpointer writes them, and read; and the
port's own `torch.save` file, still written for a `.pt` path and read.

Stands for vision_kit_tpu/train/trainer.py:Trainer.save_checkpoint and
load_checkpoint. save_checkpoint writes the state as the JAX Trainer's
tree (convert.jax_train_state_tree: the parameters, the BatchNorm
statistics, the SGD state with its momentum buffers, the EMA tree with its
update count, and the step, under Flax's names) into an orbax directory
(utils/orbax.py:write_checkpoint, which orbax and the JAX Trainer restore),
and the meta JAX writes beside it (epoch, step, best_map50,
epochs_no_improve, val_pending) to `path + ".meta.json"`. A path ending in
`.pt` gets the port's earlier file instead: the same parts under the
port's names. AsyncCheckpointer does the same on a background thread.
load_checkpoint reads either: the port's file, or an orbax directory of
the port's or the JAX Trainer's (utils/orbax.py, without orbax or
tensorstore; bridged by convert.train_state_tensors_from_jax).

A restore copies the tensors into a fresh state's own (the model's
parameters and statistics included), so it is bit-equal to the saved
state, and the next step equals the uninterrupted run's.
predictor.load_weights reads the same files and directories for its
weights: the EMA once it has been updated, else the parameters.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch

from vision_kit_tpu_torch.train.ema import EMAState
from vision_kit_tpu_torch.train.optim import SGDState, sgd_state

FORMAT = "vision_kit_tpu_torch.train_state/1"


def is_train_state(obj) -> bool:
    """Whether a loaded checkpoint is one that save_checkpoint wrote to a
    `.pt` path."""
    return isinstance(obj, dict) and obj.get("format") == FORMAT


def _is_pt(path: str) -> bool:
    return path.endswith(".pt")


def _snapshot(path: str, state):
    """What save_checkpoint writes to `path` for `state`, on the host and
    owning its memory: the JAX Trainer's tree (numpy), or the port's `.pt`
    payload. The train step updates the state's tensors in place, so a
    background write needs this copy taken before the next step."""
    if not _is_pt(path):
        from vision_kit_tpu_torch.convert import jax_train_state_tree

        return jax_train_state_tree(state)

    def host(tensors):
        return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}

    sgd = sgd_state(state.opt_state)
    return {"format": FORMAT, "params": host(state.params),
            "batch_stats": host(state.batch_stats), "momentum": host(sgd.momentum_buf),
            "opt_step": sgd.step,
            "ema": {"updates": state.ema.updates, "tree": host(state.ema.tree)},
            "step": state.step}


def _meta(state, epoch, best_map50, epochs_no_improve, val_pending) -> dict:
    return {"epoch": epoch, "step": state.step, "best_map50": best_map50,
            "epochs_no_improve": epochs_no_improve, "val_pending": val_pending}


def _write(path: str, snap, meta: dict) -> None:
    """The snapshot to `path`, then its meta beside it: a meta never names a
    state that is not complete on disk."""
    from vision_kit_tpu_torch.utils import orbax

    if _is_pt(path):
        torch.save(snap, path)
    else:
        orbax.write_checkpoint(path, snap)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def save_checkpoint(path: str, state, epoch: int = -1,
                    best_map50: float = -1.0, epochs_no_improve: int = 0,
                    val_pending: bool = False, mesh=None) -> None:
    """Write `state` (train/step.py:TrainState) to `path` and the meta to
    `path + ".meta.json"`, and return once both are on disk: an orbax
    directory of the JAX Trainer's tree, or the port's file when `path`
    ends in `.pt`. The tensors are written as they are (f32 master weights
    and f32 EMA).

    mesh (parallel.mesh.Mesh): rank 0 writes (the state is the same on
    every rank), and every rank returns past a barrier once the files are
    complete, so that any rank may read them."""
    AsyncCheckpointer(mesh).save(path, state, epoch, best_map50, epochs_no_improve,
                                 val_pending, blocking=True)


class AsyncCheckpointer:
    """save_checkpoint with the write in the background: the counterpart of
    the JAX Trainer's ocp.AsyncCheckpointer(StandardCheckpointHandler()).

    save() takes the snapshot on the caller's thread (device to host,
    before the next train step updates the state in place) and returns;
    one writer thread then frames the chunks and writes the files. At most
    one save is outstanding: save() and wait_until_finished() first wait
    for the one before. An exception on the writer thread is raised by the
    next wait. The meta is written on the writer thread after the
    directory's rename (JAX writes it first, beside a save still in
    flight), so a meta never names a state that is not yet on disk.

    mesh (parallel.mesh.Mesh): rank 0 writes, and every rank passes a
    barrier at every wait, so that past a wait any rank may read what was
    saved. Every rank makes the same calls.

    records: one {"path", "blocked_s", "write_s"} per save written on this
    rank: the seconds save() spent on the snapshot, and the writer's
    seconds (None until it has finished, or when it failed)."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.records: list[dict] = []
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, path: str, state, epoch: int = -1, best_map50: float = -1.0,
             epochs_no_improve: int = 0, val_pending: bool = False,
             blocking: bool = False) -> None:
        """Save `state` to `path` as save_checkpoint does; blocking: return
        once it is on disk."""
        self.wait_until_finished()
        if self.mesh is None or self.mesh.is_main:
            t0 = time.perf_counter()
            snap = _snapshot(path, state)
            meta = _meta(state, epoch, best_map50, epochs_no_improve, val_pending)
            record = {"path": path, "blocked_s": time.perf_counter() - t0, "write_s": None}
            self.records.append(record)
            self._thread = threading.Thread(target=self._run, args=(path, snap, meta, record),
                                            name="checkpoint-writer")
            self._thread.start()
        if blocking:
            self.wait_until_finished()

    def _run(self, path: str, snap, meta: dict, record: dict) -> None:
        t0 = time.perf_counter()
        try:
            _write(path, snap, meta)
        except Exception as e:   # raised by the next wait, on the caller's thread
            self._error = e
            return
        record["write_s"] = time.perf_counter() - t0

    def wait_until_finished(self) -> None:
        """Return once the outstanding save is on disk; raise its error if
        it failed (once: the next wait does not raise it again)."""
        try:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            error, self._error = self._error, None
            if error is not None:
                raise error
        finally:
            if self.mesh is not None:
                from vision_kit_tpu_torch.parallel.mesh import barrier

                barrier(self.mesh)


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
    """The checkpoint at `path` in the `.pt` payload's layout: the port's
    file, or an orbax directory (the port's or a JAX Trainer's) read on
    `device`."""
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
    counts are carried. `path` is an orbax directory (save_checkpoint's,
    or a JAX Trainer's), whose chunks are decompressed on the state's
    device (the host C decoder on the card), or the port's `.pt` file.
    Returns (state', meta), meta None when the `.meta.json` is absent.

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
