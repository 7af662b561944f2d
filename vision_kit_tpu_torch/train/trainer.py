"""Training orchestration: the imperative loop around the train and eval
steps, and the validation and test loops.

Counterpart of vision_kit_tpu/train/trainer.py: epochs over the infinite
TrainLoader, validation of the EMA weights every `val_interval` epochs
through ValLoader and make_eval_step (whose postprocess runs the greedy-NMS
kernel on the card), best/last checkpoints monitored on mAP@.5, early
stopping, exact-step resume, multi-scale size draws, sample grids, per-class
tables, TensorBoard when it imports and WandB when credentials are set.

On one device, or data-parallel over a mesh (parallel/mesh.py; one
process per device, launched by torchrun): each rank trains on its shard
of every global batch through the mesh's step, rank 0 alone writes
checkpoints, best weights, sample grids and the logs, and the validation
is gathered and evaluated on rank 0, its metrics broadcast so that every
rank takes the same best-checkpoint and early-stop decisions. The loader
takes the host-augmentation route unless data.device_aug is true; with
degrees or shear set the device route falls back to the host route with a
warning, as in the JAX package.
Precision: f32 master weights, and model.precision bf16 (the default) runs
the forwards of both steps under torch.autocast in bf16. The run directory
is the JAX Trainer's: ckpts/last and ckpts/best are orbax directories with
the JAX meta beside each, written in the background
(train/checkpoint.py:AsyncCheckpointer), which the JAX Trainer resumes; the
best EMA weights are weights/best-map50_<m>.msgpack, the bytes of flax's
to_bytes of the f32 EMA tree, which the JAX predictor and
predictor.load_weights read; the sample grids are <split>.jpg, cv2.imwrite's
bytes of the JAX grid.

Batches are in ValLoader's format for `validate` and `test` below: {"image":
(B, S, S, 3) uint8, "targets": (B, M, 5), "info": [(h0, w0, ratio, pad,
img_id)], "count"}.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from vision_kit_tpu_torch.utils.logging_utils import logger
from vision_kit_tpu_torch.utils.table import RichTable


def _gather_batch(mesh, batch):
    """The global batch's targets, infos and count from each rank's share
    (ValLoader(shard=rank)), in rank order."""
    from vision_kit_tpu_torch.parallel import mesh as pmesh

    dev = mesh.device
    targets = pmesh.gather_rows(mesh, torch.as_tensor(batch["targets"], device=dev))
    info = torch.tensor([[h0, w0, ratio, pad[0], pad[1], img_id]
                         for h0, w0, ratio, pad, img_id in batch["info"]],
                        dtype=torch.float64, device=dev)
    info = pmesh.gather_rows(mesh, info).tolist()
    count = pmesh.all_reduce(mesh, torch.tensor(batch["count"], device=dev), pmesh.DATA_AXIS)
    infos = [(int(h0), int(w0), ratio, (p0, p1), int(img_id))
             for h0, w0, ratio, p0, p1, img_id in info]
    return targets.cpu().numpy(), infos, int(count)


def validate(eval_step, batches, evaluator, collect_coco: bool = False,
             mesh=None) -> dict:
    """Reset `evaluator`, run `eval_step` on every batch and accumulate its
    detections, then summarize.

    collect_coco: also accumulate the COCO-protocol metric set (float64
    copies of every batch); only `test` reads it.

    mesh (parallel.mesh.Mesh): each rank's batches are its shares of the
    global batches (ValLoader(shard=rank)) and eval_step a
    make_eval_step(mesh=mesh); the global batch is gathered and evaluated on
    rank 0, and its result is returned on every rank.
    """
    if mesh is None:
        evaluator.reset(collect_coco=collect_coco)
        for batch in batches:
            dets, valid = eval_step(batch["image"])
            evaluator.update(dets.cpu().numpy(), valid.cpu().numpy(),
                             batch["targets"], batch["info"], batch["count"])
        return evaluator.summarize()
    from vision_kit_tpu_torch.parallel import mesh as pmesh

    if mesh.is_main:
        evaluator.reset(collect_coco=collect_coco)
    for batch in batches:
        dets, valid = eval_step(batch["image"])
        targets, infos, count = _gather_batch(mesh, batch)
        if mesh.is_main:
            evaluator.update(dets.cpu().numpy(), valid.cpu().numpy(), targets, infos,
                             count)
    return pmesh.broadcast_object(mesh, evaluator.summarize() if mesh.is_main else None)


def summarize_coco(evaluator, mesh=None) -> dict:
    """evaluator.summarize_coco(), on rank 0 under a mesh and then on every
    rank."""
    if mesh is None:
        return evaluator.summarize_coco()
    from vision_kit_tpu_torch.parallel import mesh as pmesh

    return pmesh.broadcast_object(mesh, evaluator.summarize_coco() if mesh.is_main
                                  else None)


def test(eval_step, batches, evaluator, mesh=None) -> dict:
    """validate with the COCO-protocol metric set under result["coco"]."""
    result = validate(eval_step, batches, evaluator, collect_coco=True, mesh=mesh)
    result["coco"] = summarize_coco(evaluator, mesh)
    return result


def _wandb_netrc_login() -> bool:
    """True when `wandb login` stored credentials in ~/.netrc."""
    import netrc

    try:
        return netrc.netrc().authenticators("api.wandb.ai") is not None
    except (OSError, netrc.NetrcParseError):
        return False


def _compute_dtype(cfg) -> torch.dtype:
    precision = str(getattr(cfg.model, "precision", "bf16"))
    return torch.bfloat16 if precision in ("bf16", "bfloat16", "16") else torch.float32


class Trainer:
    MS_INTERVAL = 10  # steps between multi-scale size draws

    def __init__(self, cfg, evaluator=None, mesh=None, use_tensorboard: bool = True,
                 seed: int | None = None, device: str | torch.device = "cuda",
                 deterministic: bool = False):
        """deterministic: deterministic algorithms for this process
        (utils/general.py:deterministic_mode), so that two runs from one
        seed, and a resumed run, repeat bit for bit on the card; it needs
        CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts (set here when
        CUDA has not started; `train --deterministic` sets it first), and
        raises when CUDA started without it."""
        from vision_kit_tpu_torch.models import build_model
        from vision_kit_tpu_torch.parallel import mesh as pmesh
        from vision_kit_tpu_torch.train.checkpoint import AsyncCheckpointer
        from vision_kit_tpu_torch.train.evaluator import DetEvaluator
        from vision_kit_tpu_torch.train.optim import make_optimizer
        from vision_kit_tpu_torch.train.step import create_train_state, make_train_step
        from vision_kit_tpu_torch.utils.general import resolve_device

        self.deterministic = bool(deterministic)
        if self.deterministic:
            from vision_kit_tpu_torch.utils.general import deterministic_mode

            deterministic_mode()
        # a mesh over the process group when one is initialised (torchrun);
        # its device is this rank's
        mesh = pmesh.check_mesh(mesh)
        if mesh is None and torch.distributed.is_initialized():
            mesh = pmesh.make_mesh(device=device)
        self.mesh = mesh
        # the loaders shard over the data axis (a model axis replicates)
        self.rank = mesh.data_index if mesh is not None else 0
        self.is_main = mesh is None or mesh.is_main
        self.cfg = cfg
        # one seed drives model init, the loader's index stream and every
        # per-sample augmentation draw; the CLI's --seed lands here
        if seed is None:
            seed = getattr(cfg.data, "seed", None)  # a config seed of 0 is valid
        self.seed = int(seed) if seed is not None else 21
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.compute_dtype = _compute_dtype(cfg)
        self.model = build_model(cfg, device=self.device, seed=self.seed)
        self.img_size = tuple(cfg.model.input_size)
        self.max_epochs = int(cfg.data.max_epochs)
        self.val_interval = int(cfg.testing.val_interval)
        self.output_dir = cfg.data.output_dir
        if self.is_main:
            os.makedirs(os.path.join(self.output_dir, "ckpts"), exist_ok=True)
        # one outstanding background save at a time (JAX's AsyncCheckpointer)
        self.checkpointer = AsyncCheckpointer(mesh=mesh)
        # the global batch, a multiple of the data axis; each rank trains on
        # its batch_size // n_data rows
        self.n_data = mesh.n_data if mesh is not None else 1
        self.batch_size = int(cfg.data.batch_size)
        if self.batch_size % self.n_data:
            self.batch_size = max(self.batch_size // self.n_data, 1) * self.n_data

        # data.device_aug moves the mosaic/mixup/HSV/flip pixel work into the
        # train step; rotation and shear need the host route
        aug = dict(cfg.augmentations)
        self.device_aug = bool(getattr(cfg.data, "device_aug", False))
        if self.device_aug and (float(aug.get("degrees", 0) or 0)
                                or float(aug.get("shear", 0) or 0)):
            logger.warning("data.device_aug disabled: degrees/shear require the host "
                           "augmentation pipeline")
            self.device_aug = False

        self.train_loader, self.val_loader = self._build_loaders()
        steps_per_epoch = self.train_loader.steps_per_epoch

        weight = getattr(cfg.model, "weight", None)
        if weight and os.path.exists(str(weight)):
            from vision_kit_tpu_torch.predictor import load_weights

            try:
                # shape-checked partial load: mismatched heads (another
                # num_classes) keep their fresh init
                load_weights(str(weight), self.model, partial=True)
                logger.info("loaded pretrained weights from %s", weight)
            except (OSError, ValueError, RuntimeError) as e:
                logger.warning("pretrained load failed (%s); training from scratch", e)

        self.cosine = cfg.model.name == "YOLOv7"
        hyp = dict(cfg.hypermeters)
        self.tx = make_optimizer(self.model, hyp, self.max_epochs, steps_per_epoch,
                                 cosine=self.cosine)
        # explicit layout: the head's training maps follow decode_order
        layout = ("anchor_major" if getattr(self.model, "decode_order", "native")
                  == "reference" else "native")
        if self.cosine and int(hyp.get("loss_ota", 0)):
            from vision_kit_tpu_torch.train.ota import YoloLossOTA as loss_cls
        else:
            from vision_kit_tpu_torch.train.losses import YoloLoss as loss_cls
        self.loss = loss_cls(int(cfg.model.num_classes), self.model.head.grid_anchors,
                             hyp, layout=layout)
        self.state = create_train_state(self.model, self.tx, mesh=mesh)
        self.train_step = make_train_step(self.model, self.loss, self.tx,
                                          **self._step_options())
        # multi-scale training (data.multiscale: true -> base +/- {64, 128},
        # or a list of sizes): the batch resizes on the device inside the
        # step, redrawn every MS_INTERVAL steps from a seeded stream
        self.ms_sizes = self._parse_multiscale(cfg)
        self._ms_steps: dict[int, object] = {}
        self.evaluator = evaluator or DetEvaluator(
            list(cfg.data.class_labels), self.img_size,
            gt_json=getattr(cfg.data, "gt_json", None))
        self.eval_step = self._build_eval_step()
        self.steps_per_epoch = steps_per_epoch
        self.ckpt_interval = int(getattr(cfg.data, "ckpt_interval", 1) or 1)
        self.best_map50 = -1.0
        self.epochs_no_improve = 0
        self.patience = int(getattr(cfg.testing, "patience", 5) or 5)
        # completed train steps reflected in self.state: the resume cursor
        self.global_step = 0
        # True while a validation's side effects (best checkpoint, patience)
        # are in flight; persisted so that a crash inside validate() re-runs it
        self._val_pending = False
        # per epoch: seconds, img/s, seconds waiting on the loader, and the
        # validation's wall seconds (None when it did not validate)
        self.epoch_stats: list[dict] = []

        self.tb = None
        if use_tensorboard and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(self.output_dir, "tb"))
            except (ImportError, OSError):
                self.tb = None
        # WandB only when credentials or a mode are configured: an
        # unconditional wandb.init blocks on a login prompt
        self.wandb = None
        if self.is_main and (os.environ.get("WANDB_API_KEY") or os.environ.get("WANDB_MODE")
                             or _wandb_netrc_login()):
            try:
                import wandb

                self.wandb = wandb.init(project="VisionKit", dir=self.output_dir,
                                        config=cfg.to_dict(), reinit=True)
            except Exception as e:  # any failure of an optional logger
                logger.warning("wandb disabled: %s", e)
                self.wandb = None

    def _step_options(self) -> dict:
        data = self.cfg.data
        return dict(accum_steps=int(getattr(data, "accum_steps", 1) or 1),
                    remat=bool(getattr(data, "remat", False)),
                    device_aug=self.device_aug, compute_dtype=self.compute_dtype,
                    mesh=self.mesh)

    def _build_eval_step(self):
        """The eval step over this state's EMA, in the compute dtype. It
        captures the state's EMA tree: built again by use_state."""
        from vision_kit_tpu_torch.train.step import make_eval_step

        return make_eval_step(
            self.model, state=self.state, compute_dtype=self.compute_dtype, mesh=self.mesh,
            postprocess_kwargs=dict(conf_thres=float(self.cfg.testing.conf_thresh),
                                    iou_thres=float(self.cfg.testing.iou_thresh)))

    def use_state(self, state) -> None:
        """Make `state` (a TrainState of this model and optimizer) the
        trainer's, with an eval step over its EMA."""
        self.state = state
        self.eval_step = self._build_eval_step()

    def _parse_multiscale(self, cfg):
        """cfg data.multiscale -> sorted size list or None (off)."""
        ms = getattr(cfg.data, "multiscale", False)
        if not ms:
            return None
        if self.img_size[0] != self.img_size[1]:
            raise ValueError("data.multiscale requires a square input_size")
        base = int(self.img_size[0])
        if isinstance(ms, (list, tuple)):
            sizes = sorted({int(s) for s in ms})
        else:
            sizes = sorted({max(64, base + d) for d in (-128, -64, 0, 64, 128)})
        for s in sizes:
            if s % 32:
                # the stride-32 pyramid needs whole cells at every level
                raise ValueError(f"multiscale size {s} not a multiple of 32")
        if base not in sizes:
            sizes.append(base)
            sizes.sort()
        return sizes

    def _train_step_for(self, gstep: int):
        """The (possibly size-jittered) train step for global step `gstep`."""
        from vision_kit_tpu_torch.train.step import make_train_step

        if not self.ms_sizes:
            return self.train_step
        rng = np.random.default_rng([self.seed, 4242, gstep // self.MS_INTERVAL])
        size = self.ms_sizes[int(rng.integers(len(self.ms_sizes)))]
        if size == int(self.img_size[0]):
            return self.train_step
        step = self._ms_steps.get(size)
        if step is None:
            step = self._ms_steps[size] = make_train_step(
                self.model, self.loss, self.tx, scale_to=size, **self._step_options())
        return step

    def _log_scalar(self, name: str, value: float, step: int):
        if self.tb:
            self.tb.add_scalar(name, value, step)
        if self.wandb:
            self.wandb.log({name: value}, step=step)

    def _log_image(self, tag: str, img_rgb, step: int):
        """Push an HWC uint8 RGB image to TensorBoard and WandB."""
        if self.tb:
            self.tb.add_image(tag, img_rgb, step, dataformats="HWC")
        if self.wandb:
            import wandb

            self.wandb.log({tag: wandb.Image(img_rgb)})

    # -- data -------------------------------------------------------------
    def _dataset(self, split_path: str, coco_json: str | None = None):
        from vision_kit_tpu_torch.data.datasets import COCODataset, YOLODataset

        cfg = self.cfg
        kw = dict(img_size=self.img_size,
                  filter_classes=list(cfg.data.filter_classes or []),
                  cache_images=getattr(cfg.data, "cache_images", None) or None,
                  fast_decode=bool(getattr(cfg.data, "fast_decode", False)),
                  decoder=str(getattr(cfg.data, "decoder", None) or "auto"),
                  device=self.device)
        fmt = cfg.data.data_format
        if fmt == "yolo":
            return YOLODataset(os.path.join(cfg.data.data_dir, split_path), **kw)
        if fmt == "coco":
            return COCODataset(cfg.data.data_dir, json_file=coco_json, name=split_path,
                               **kw)
        raise ValueError(f"unknown data_format {fmt!r}")

    def _rank0_first(self, make):
        """make() on rank 0, then, past a barrier, on the other ranks: a
        dataset's label and disk caches are built once and read by the rest."""
        if self.mesh is None:
            return make()
        from vision_kit_tpu_torch.parallel.mesh import barrier

        out = make() if self.is_main else None
        barrier(self.mesh)
        return out if self.is_main else make()

    def _num_workers(self) -> int:
        """data.num_workers, capped under a mesh at the host's cores over the
        ranks on it (each rank spawns its own)."""
        workers = int(getattr(self.cfg.data, "num_workers", 0) or 0)
        if self.mesh is None or not workers:
            return workers
        local = int(os.environ.get("LOCAL_WORLD_SIZE") or self.n_data)
        cap = max(1, len(os.sched_getaffinity(0)) // local)
        if workers > cap:
            logger.warning("data.num_workers %d capped at %d a rank (%d ranks on %d "
                           "cores)", workers, cap, local, len(os.sched_getaffinity(0)))
            return cap
        return workers

    def _val_loader(self, dataset):
        from vision_kit_tpu_torch.data.loader import ValLoader

        return ValLoader(dataset, self.batch_size, img_size=self.img_size,
                         shard=self.rank, num_shards=self.n_data)

    def _build_loaders(self):
        from vision_kit_tpu_torch.data.loader import TrainLoader

        cfg = self.cfg
        train_ds, val_ds = self._rank0_first(lambda: (
            self._dataset(str(cfg.data.train_path), "instances_train2017.json"),
            self._eval_dataset(str(cfg.data.val_path))))
        train_loader = TrainLoader(
            train_ds, self.batch_size // self.n_data, img_size=self.img_size,
            aug_cfg=dict(cfg.augmentations), seed=self.seed,
            shard=self.rank, num_shards=self.n_data,
            num_workers=self._num_workers(), device_aug=self.device_aug)
        return train_loader, self._val_loader(val_ds)

    def _eval_dataset(self, split_path: str):
        """Eval-split dataset for a `val_path`/`test_path` config value; a
        COCO split prefers instances_<split>.json, else instances_val2017.json."""
        json_file = None
        if self.cfg.data.data_format == "coco":
            for json_file in (f"instances_{split_path}.json", "instances_val2017.json"):
                if os.path.exists(os.path.join(self.cfg.data.data_dir, "annotations",
                                               json_file)):
                    break
        return self._dataset(split_path, json_file)

    # -- checkpointing ----------------------------------------------------
    def save_checkpoint(self, name: str, epoch: int, blocking: bool = False):
        """The state to the orbax directory ckpts/<name> and the meta beside
        it, in the background once the state's snapshot is on the host (the
        step saved is global_step, which the state's step equals). blocking:
        return once both are on disk."""
        path = os.path.join(self.output_dir, "ckpts", name)
        self.checkpointer.save(path, self.state, epoch, best_map50=self.best_map50,
                               epochs_no_improve=self.epochs_no_improve,
                               val_pending=self._val_pending, blocking=blocking)

    def load_checkpoint(self, path: str) -> int:
        """Restore `path` (an orbax directory, this port's or a JAX
        Trainer's ckpts/last or ckpts/best, or a file in the port's
        torch.save format: a `.pt` path, or an earlier port run's ckpts/)
        into the state, and the early-stop and pending-validation
        counters from its meta, read as the JAX Trainer reads them; returns
        the step to resume at. The eval step is built again over the
        restored EMA. As in JAX, a save of this Trainer still in flight is
        not waited for: fit waits for its own before it returns."""
        from vision_kit_tpu_torch.train import checkpoint

        state, meta = checkpoint.load_checkpoint(path, self.state)
        self.use_state(state)
        # a directory without a meta resumes at 0, the JAX rule, whoever
        # wrote it; the port's `.pt` file carries its step
        step = 0 if os.path.isdir(path) else state.step
        if meta is not None:
            self.best_map50 = float(meta.get("best_map50", -1.0))
            # early-stop patience survives a resume (an uninterrupted run
            # would still be counting)
            self.epochs_no_improve = int(meta.get("epochs_no_improve", 0))
            step = meta.get("step")
            if step is None:  # a meta from before the step was kept: epochs
                step = (int(meta.get("epoch", -1)) + 1) * self.steps_per_epoch
            step = int(step)
            self._val_pending = bool(meta.get("val_pending", False))
        self.global_step = step
        return step

    # -- loops ------------------------------------------------------------
    def fit(self, resume: str | None = None):
        """Training loop. On any exception (an interrupt included) the state
        is saved as the `last` checkpoint and the best weights exported
        before it re-raises.

        The crash-save records global_step, the train steps reflected in the
        saved state, so fit(resume=...) continues the data stream, the
        schedules and the optimizer and EMA state at the EXACT step, even
        mid-epoch. A crash inside validate() also marks the validation
        pending; the resume re-runs it (same weights, deterministic eval)
        before training goes on."""
        try:
            self._fit(resume)
        except BaseException:
            try:
                # the epoch field is informational (the last COMPLETED epoch);
                # the resume cursor is meta["step"]
                self.save_checkpoint("last", self.global_step // self.steps_per_epoch - 1,
                                     blocking=True)
                if self.best_map50 > 0:
                    self._export_best_weights(self.best_map50)
                logger.warning("exception: saved last checkpoint before exit")
            except Exception as e:  # the original exception is re-raised below
                logger.warning("crash-save failed: %s", e)
            raise

    def _fit(self, resume: str | None = None):
        from vision_kit_tpu_torch.train.optim import lr_schedules

        start_step = 0
        if resume:
            start_step = self.load_checkpoint(resume)
            logger.info("resumed from %s at step %d (epoch %d)", resume, start_step,
                        start_step // self.steps_per_epoch)
            # the batches are deterministic per batch id and the restored
            # state has consumed exactly start_step of them; close() makes
            # the loader idle so that seek is valid on a re-fit Trainer too
            self.train_loader.close()
            self.train_loader.seek(start_step)
        self.global_step = start_step
        start_epoch = start_step // self.steps_per_epoch

        lr_weight, _, _ = lr_schedules(dict(self.cfg.hypermeters), self.max_epochs,
                                       self.steps_per_epoch, cosine=self.cosine)
        it = iter(self.train_loader)

        # a crash inside validate() left its side effects (best checkpoint,
        # patience counter) unapplied: replay the interrupted epoch tail
        if (resume and self._val_pending and start_step
                and start_step % self.steps_per_epoch == 0):
            logger.info("resume: re-running the interrupted validation")
            self._cur_epoch = start_epoch - 1
            if self._epoch_tail(start_epoch - 1):
                self._finish_fit()
                return

        for epoch in range(start_epoch, self.max_epochs):
            self._cur_epoch = epoch
            t0 = time.perf_counter()
            wait = 0.0
            first = max(start_step - epoch * self.steps_per_epoch, 0)
            losses = None
            for step in range(first, self.steps_per_epoch):
                tw = time.perf_counter()
                batch = next(it)
                wait += time.perf_counter() - tw
                if step == first:
                    # the first batch's sample grid, every epoch
                    self._save_grid(batch, "train", step=epoch)
                step_fn = self._train_step_for(epoch * self.steps_per_epoch + step)
                self.state, losses = step_fn(self.state, batch)
                self.global_step += 1
            # one synchronisation an epoch
            losses = {k: float(v) for k, v in losses.items()}
            dt = time.perf_counter() - t0
            n_steps = self.steps_per_epoch - first
            stats = {"epoch": epoch, "seconds": dt, "img_s": n_steps * self.batch_size / dt,
                     "loader_wait_s": wait, "val_s": None}
            self.epoch_stats.append(stats)
            logger.info("epoch %d/%d loss %.4f (box %.4f obj %.4f cls %.4f) "
                        "%.1fs %.1f img/s, loader wait %.1f%%",
                        epoch + 1, self.max_epochs, losses["loss"], losses["loss_box"],
                        losses["loss_obj"], losses["loss_cls"], dt, stats["img_s"],
                        100 * wait / dt)
            self._log_scalar("loss", losses["loss"], epoch)
            self._log_scalar("loss/box", losses["loss_box"], epoch)
            self._log_scalar("loss/obj", losses["loss_obj"], epoch)
            self._log_scalar("loss/cls", losses["loss_cls"], epoch)
            self._log_scalar("lr", float(lr_weight((epoch + 1) * self.steps_per_epoch)),
                             epoch)
            if self._epoch_tail(epoch):
                break
        self._finish_fit()

    def _epoch_tail(self, epoch: int) -> bool:
        """Per-epoch validation + checkpointing; True => early stop."""
        if (epoch + 1) % self.val_interval == 0:
            self._val_pending = True
            self._run_validation(epoch)
        if (epoch + 1) % self.ckpt_interval == 0 or epoch + 1 == self.max_epochs:
            self.save_checkpoint("last", epoch)
        if self.epochs_no_improve >= self.patience:
            logger.info("early stopping: no mAP@.5 improvement in %d validations",
                        self.patience)
            return True
        return False

    def _run_validation(self, epoch: int):
        t0 = time.perf_counter()
        result = self.validate()
        val_s = time.perf_counter() - t0
        if self.epoch_stats and self.epoch_stats[-1]["epoch"] == epoch:
            self.epoch_stats[-1]["val_s"] = val_s
        map50 = result["map50"]
        logger.info("epoch %d mAP@.5 %.4f mAP@.5:.95 %.4f (validation %.1fs)",
                    epoch + 1, map50, result["map50_95"], val_s)
        if result["per_class"]:
            logger.info("\n%s", self._per_class_table(result))
        self._log_scalar("mAP@.5", map50, epoch)
        self._log_scalar("mAP@.5:.95", result["map50_95"], epoch)
        improved = map50 > self.best_map50
        if improved:
            self.best_map50 = map50
            self.epochs_no_improve = 0
        else:
            self.epochs_no_improve += 1
        # the counters are final for this epoch: checkpoints written from
        # here on resume without re-running this validation
        self._val_pending = False
        if improved:
            self.save_checkpoint("best", epoch)
            self._export_best_weights(map50)

    def _finish_fit(self):
        try:
            self.checkpointer.wait_until_finished()
        finally:
            self.train_loader.close()

    def validate(self, loader=None, collect_coco: bool = False, split: str = "val"):
        """Evaluate the EMA over `loader` (default: the val split); the first
        batch's sample grid is saved. collect_coco: also accumulate the
        COCO-protocol metric set, which only test() reads."""
        def batches():
            for bi, batch in enumerate(loader if loader is not None else self.val_loader):
                if bi == 0:
                    self._save_grid(batch, split, step=getattr(self, "_cur_epoch", 0))
                yield batch

        return validate(self.eval_step, batches(), self.evaluator, collect_coco,
                        mesh=self.mesh)

    def _test_loader(self):
        """The `data.test_path` split when configured, else the val split."""
        test_path = getattr(self.cfg.data, "test_path", None)
        if not test_path or str(test_path) == str(self.cfg.data.val_path):
            logger.info("test(): no separate data.test_path — evaluating the val "
                        "split (%s)", self.cfg.data.val_path)
            return self.val_loader
        if not os.path.isdir(os.path.join(self.cfg.data.data_dir, str(test_path))):
            logger.warning("test(): data.test_path %s does not exist — evaluating the "
                           "val split (%s) instead", test_path, self.cfg.data.val_path)
            return self.val_loader
        logger.info("test(): evaluating the test split (%s)", test_path)
        return self._val_loader(self._rank0_first(
            lambda: self._eval_dataset(str(test_path))))

    @staticmethod
    def _per_class_table(result) -> str:
        table = RichTable("Details Per Class")
        table.add_headers(["Class", "Images", "Num_Targets", "Precision", "Recall",
                           "mAP@.5", "mAP@.5:.95"])
        table.add_content([
            [r["class"], r["images"], r["targets"], round(r["precision"], 3),
             round(r["recall"], 3), round(r["ap50"], 3), round(r["ap"], 3)]
            for r in result["per_class"]])
        return table.table

    def test(self):
        result = self.validate(self._test_loader(), collect_coco=True, split="test")
        logger.info("\n%s", self._per_class_table(result))
        logger.info("mAP@.5 %.4f  mAP@.5:.95 %.4f", result["map50"], result["map50_95"])
        coco = summarize_coco(self.evaluator, self.mesh)
        map_table = RichTable("Average Precision (AP)")
        map_table.add_headers(["mAP", "mAP(.50)", "mAP(.75)", "mAP(small)",
                               "mAP(medium)", "mAP(large)"])
        map_table.add_content([[round(coco[k], 3) for k in (
            "map", "map_50", "map_75", "map_small", "map_medium", "map_large")]])
        mar_table = RichTable("Average Recall (AR)")
        mar_table.add_headers(["mAR", "mAR(max=10)", "mAR(max=100)", "mAR(small)",
                               "mAR(medium)", "mAR(large)"])
        mar_table.add_content([[round(coco[k], 3) for k in (
            "mar_1", "mar_10", "mar_100", "mar_small", "mar_medium", "mar_large")]])
        logger.info("\n%s", map_table.table)
        logger.info("\n%s", mar_table.table)
        result["coco"] = coco
        if self.is_main and self.evaluator.gt_json:
            info = self.evaluator.coco_evaluate()
            if info:
                logger.info("\n%s", info)
        return result

    def _export_best_weights(self, map50: float):
        """The f32 EMA weights as weights/best-map50_<m>.msgpack on each new
        best: for the same numbers, the bytes of the JAX Trainer's
        flax.serialization.to_bytes of its EMA tree (keys sorted, as
        jax.device_get gives them), which the JAX predictor and
        predictor.load_weights read."""
        from vision_kit_tpu_torch.convert import jax_variables_from_state_dict
        from vision_kit_tpu_torch.utils import flax_msgpack

        if not self.is_main:
            return
        path = os.path.join(self.output_dir, "weights", f"best-map50_{map50:.4f}.msgpack")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        flax_msgpack.write_file(path, flax_msgpack.sorted_keys(
            jax_variables_from_state_dict(self.state.ema.tree)))

    def profile(self, steps: int = 5):
        """A torch.profiler trace of `steps` train steps (after one untimed
        step) as a Chrome trace under <output_dir>/profile."""
        trace_dir = os.path.join(self.output_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        it = iter(self.train_loader)
        try:
            batch = next(it)
            self.state, _ = self.train_step(self.state, batch)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                for _ in range(steps):
                    self.state, metrics = self.train_step(self.state, batch)
                float(metrics["loss"])
        finally:
            self.train_loader.close()
        path = os.path.join(trace_dir, "train_step.json")
        if self.is_main:
            prof.export_chrome_trace(path)
        logger.info("profile trace written to %s", path)
        return path

    def _save_grid(self, batch, split, step: int = 0):
        """The first batch's sample grid (ground-truth boxes drawn) to
        <output_dir>/<split>.jpg, the JAX Trainer's bytes, and to TensorBoard/WandB as
        samples/<split>. A device-augmentation batch is warped for the
        grid's 16 images on its device. A failure is logged, never raised:
        the grid is a side product of training."""
        from vision_kit_tpu_torch.utils.drawing import grid_save

        if not self.is_main:
            return
        try:
            targets = batch["targets"]
            if "image" in batch:
                images = batch["image"]
            else:
                from vision_kit_tpu_torch.data.device_aug import warp_augment

                n = min(16, len(targets))
                tiles = batch["tiles"][:n]
                with torch.no_grad():
                    images = warp_augment(
                        tiles, torch.as_tensor(batch["tile_hw"][:n], device=tiles.device),
                        torch.as_tensor(batch["params"][:n], device=tiles.device))
                targets = targets[:n]
            grid = grid_save(images, targets, os.path.join(self.output_dir, f"{split}.jpg"))
            self._log_image(f"samples/{split}", grid, step)
        except Exception as e:  # a boundary that must keep training
            logger.warning("sample grid save failed: %s", e)
