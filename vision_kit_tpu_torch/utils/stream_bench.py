"""Detector, eval-step and training-step throughput on the card.

run_detector_bench is the counterpart of
vision_kit_tpu/utils/stream_bench.py:run_detector_bench: uint8 frames go
straight into the model (the stem normalises), then postprocess_raw runs
with the JAX bench's arguments. run_eval_bench is the counterpart of
tools/bench_eval.py: the eval step (train/step.py) with the eval protocol,
and beside it the host time of the evaluator on the bench's detections.
Both time with CUDA events after warmup; the input is perturbed on every
iteration so no step repeats another's input. run_train_bench is the
counterpart of tools/bench_train.py: the training step on its synthetic
batch (bench_targets, daug_batch) with its hyperparameters (TRAIN_HYP),
the same batch every step, as there; train_bench_setup builds that step,
state and batch for chip_smoke.py's other training runs too.

train_state_tensors and state_disagreements compare two training states;
train_step_card_vs_cpu and ota_card_vs_cpu hold a training step and the
SimOTA loss on the card against the CPU (chip_smoke.py, the cuda tests);
mesh_step_disagreements holds a data-parallel step against the step in
one process on the global batch.

calibrate_head and calibrate_bn make the synthetic loads of seeded random
weights: without them a seeded model scores every candidate below conf
(head as built), or, for v7, every anchor of a level alike.
same_detections is the check that two runs of a path gave the same
detections, used by chip_smoke.py and the tests.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vision_kit_tpu_torch.data.loader import pad_targets
from vision_kit_tpu_torch.ops.nms import postprocess_raw

POSTPROCESS_ARGS = dict(conf_thres=0.25, iou_thres=0.45, max_det=300,
                        max_cand=512, approx_topk=True)

# calibrate_bn's probe batch, and the weight it gives every BatchNorm. With
# the seeded init's identity statistics, v7's depth shrinks the features'
# spatial variation to ~1e-7 of their mean by the head, so every anchor of a
# level scores alike; normalising each layer on data keeps it, and a weight
# below 1 keeps the network contractive: at 1 its f32 rounding grows to
# ~1e-3 of the logits, at 0.25 ~5e-5 (CPU, f32 against f64).
BN_PROBE_BATCH = 8
BN_SCALE = 0.25


@torch.no_grad()
def calibrate_head(model, size: int, seed: int) -> None:
    """Zero the head biases and scale each level's kernel to unit logit
    spread on a seeded probe batch."""
    dev = next(model.parameters()).device
    probe = np.random.default_rng(seed).integers(0, 255, (2, size, size, 3),
                                                 dtype=np.uint8)
    for conv in model.head.m:
        conv.bias.zero_()
    raws = model(torch.from_numpy(probe).to(dev), decode=False)
    for conv, raw in zip(model.head.m, raws):
        conv.weight.div_(raw.float().std().to(conv.weight.dtype))


@torch.no_grad()
def calibrate_bn(model, size: int, seed: int) -> None:
    """Give every BatchNorm the statistics of a seeded probe batch of
    BN_PROBE_BATCH images, as training would estimate them, and the weight
    BN_SCALE."""
    dev = next(model.parameters()).device
    probe = np.random.default_rng(seed).integers(
        0, 255, (BN_PROBE_BATCH, size, size, 3), dtype=np.uint8)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momentum = [bn.momentum for bn in bns]
    for bn in bns:
        bn.reset_running_stats()
        bn.weight.fill_(BN_SCALE)
        bn.momentum = None          # one batch: its own statistics
    model.train()
    model(torch.from_numpy(probe).to(dev), decode=False)
    model.eval()
    for bn, m in zip(bns, momentum):
        bn.momentum = m


def same_detections(want: np.ndarray, got: np.ndarray, score_tol: float = 1e-5,
                    box_tol: float = 1e-3, box_rtol: float = 0.0) -> bool:
    """Two detection sets (n, 6) agree: same count, and each wanted row
    matches a distinct got row of its class, score within score_tol and
    every coordinate within box_tol + box_rtol * the box's longer side (rows
    whose scores tie may come in either order)."""
    if want.shape != got.shape:
        return False
    free = np.ones(len(got), bool)
    for row in want:
        tol = box_tol + box_rtol * max(row[2] - row[0], row[3] - row[1])
        ok = (free & (got[:, 5] == row[5])
              & (np.abs(got[:, 4] - row[4]) <= score_tol)
              & (np.abs(got[:, :4] - row[:4]).max(axis=1) <= tol))
        if not ok.any():
            return False
        free[np.argmax(ok)] = False
    return True


STATE_PARTS = ("params", "batch_stats", "momentum", "ema")


def train_state_tensors(state, dtype: torch.dtype = torch.float32) -> dict:
    """Copies of a TrainState's (train/step.py) tensors on the host, in
    `dtype`, by part: {"params", "batch_stats", "momentum", "ema"}."""
    from vision_kit_tpu_torch.train.optim import sgd_state

    parts = (state.params, state.batch_stats,
             sgd_state(state.opt_state).momentum_buf, state.ema.tree)
    return {name: {k: t.detach().to("cpu", dtype, copy=True)
                   for k, t in part.items()}
            for name, part in zip(STATE_PARTS, parts)}


def state_disagreements(want: dict, got: dict, before: dict,
                        value_rel: float = 1e-4, step_rel: float = 2e-3) -> list:
    """The tensors of two training states (train_state_tensors' layout) that
    differ by more than value_rel of the wanted tensor's largest magnitude
    plus step_rel of the largest change the step made to it (`before`:
    the state before the step), as (part, name, error, tolerance)."""
    out = []
    for part in STATE_PARTS:
        if set(got[part]) != set(want[part]):
            out.append((part, "keys differ", None, None))
            continue
        for k, w in want[part].items():
            err = float((got[part][k] - w).abs().max())
            tol = (value_rel * float(w.abs().max())
                   + step_rel * float((w - before[part][k]).abs().max()) + 1e-7)
            if not err <= tol:
                out.append((part, k, err, tol))
    return out


def train_step_card_vs_cpu(cfg) -> tuple[list, dict]:
    """One f32 step of `cfg`'s model with YoloLoss, B=2 at its input size,
    from the same seeded state on the CPU and on the card (bench_targets,
    TRAIN_HYP). Returns (disagreements, errors): each metric beyond 1e-4
    relative (the grad norm 1e-3) as (metric, card, CPU), then
    state_disagreements' rows (the gradients of two f32 runs agree to
    ~1e-3 of each tensor's largest element); and each metric's relative
    error."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.train.optim import make_optimizer
    from vision_kit_tpu_torch.train.step import create_train_state, make_train_step

    size = cfg.model.input_size[0]
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 255, (2, size, size, 3), dtype=np.uint8),
             "targets": bench_targets(rng, 2)}
    runs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev, seed=0)
        tx = make_optimizer(model, TRAIN_HYP, 3, 10)
        state = create_train_state(model, tx)
        before = train_state_tensors(state)
        loss = YoloLoss(cfg.model.num_classes, model.head.grid_anchors, TRAIN_HYP)
        state, metrics = make_train_step(model, loss, tx)(state, batch)
        runs[dev] = (train_state_tensors(state), {k: float(v) for k, v in metrics.items()})
    (want, wm), (got, gm) = runs["cpu"], runs["cuda"]
    rel = {k: abs(gm[k] / wm[k] - 1) for k in wm}
    bad = [(k, gm[k], wm[k]) for k, r in rel.items()
           if not r <= (1e-3 if k == "grad_norm" else 1e-4)]
    return bad + state_disagreements(want, got, before), rel


def deterministic() -> None:
    """The Trainer's deterministic mode (utils/general.py:deterministic_mode;
    CUBLAS_WORKSPACE_CONFIG=:4096:8 must be set before CUDA starts), and
    TF32 off for f32 comparisons: a TF32 conv rounds to 10 mantissa bits, so
    two f32 runs an ulp apart drift by far more than a step's tolerance."""
    from vision_kit_tpu_torch.utils.general import deterministic_mode

    deterministic_mode()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def worst_step_error(want: dict, got: dict, before: dict,
                     value_rel: float = 1e-4, step_rel: float = 2e-3) -> float:
    """The largest error of `got` against `want` over state_disagreements'
    tolerance (a ratio: 1 is the tolerance), over every tensor."""
    worst = 0.0
    for part in STATE_PARTS:
        for k, w in want[part].items():
            tol = (value_rel * float(w.abs().max())
                   + step_rel * float((w - before[part][k]).abs().max()) + 1e-7)
            worst = max(worst, float((got[part][k] - w).abs().max()) / tol)
    return worst


def mesh_step_disagreements(mesh, cfg, batch: int = 64, seed: int = 0,
                            referee: bool = False):
    """One f32 step of `cfg`'s seeded model (YoloLoss, TRAIN_HYP) under
    `mesh` on this rank's rows (parallel/mesh.py:shard_batch) of a global
    batch of `batch` seeded uint8 images with bench_targets, then on rank 0
    the same step without a mesh on the whole batch from the same state.

    Returns, on rank 0, (disagreements, report): the metrics beyond 1e-4
    relative (the grad norm 1e-3) and state_disagreements' rows, as
    train_step_card_vs_cpu; and each run's metrics. The other ranks return
    (None, report).

    With referee, both steps also run in float64, where the rounding of
    the convolutions' algorithms no longer hides the data-parallel
    arithmetic, and every rank also runs the step without a mesh on its
    own rows alone, in f32 and float64. The report then holds
    "f64_disagreements" (the float64 mesh step against the float64 step
    without it, as the disagreements above) and "f64_worst" (its worst
    error over state_disagreements' tolerance: 1 is the tolerance), each
    f32 step's worst error against the float64 step without a mesh
    ("mesh_vs_f64", "plain_vs_f64"), and by rank the f32 step on the
    rank's rows alone against its float64 step ("alone_vs_f64"): the
    rounding the convolutions make at a rank's batch without any mesh."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.parallel.mesh import gather_rows, shard_batch
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.train.optim import make_optimizer
    from vision_kit_tpu_torch.train.step import create_train_state, make_train_step

    size = cfg.model.input_size[0]
    rng = np.random.default_rng(seed)
    whole = {"image": torch.from_numpy(
                 rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8)),
             "targets": torch.from_numpy(bench_targets(rng, batch))}
    local = shard_batch(mesh, whole)
    model = build_model(cfg, device=mesh.device, seed=seed)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    dtypes = (torch.float32, torch.float64) if referee else (torch.float32,)
    plan = [(("mesh", d), mesh, local) for d in dtypes]
    if mesh.is_main:
        plan += [(("one_process", d), None, whole) for d in dtypes]
    if referee and mesh.n_data > 1:
        plan += [(("alone", d), None, local) for d in dtypes]
    runs = {}
    for (name, dtype), m, data in plan:
        model.load_state_dict(start)
        model.to(dtype)
        tx = make_optimizer(model, TRAIN_HYP, 3, 10)
        state = create_train_state(model, tx, mesh=m)
        before = train_state_tensors(state)
        loss = YoloLoss(cfg.model.num_classes, model.head.grid_anchors, TRAIN_HYP,
                        layout="native")
        state, metrics = make_train_step(model, loss, tx, mesh=m)(
            state, {k: v.to(mesh.device) for k, v in data.items()})
        runs[name, dtype] = (train_state_tensors(state),
                             {k: float(v) for k, v in metrics.items()}, before)
        del state, tx
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    model.float()
    f32, f64 = torch.float32, torch.float64
    report = {name: run[1] for (name, dtype), run in runs.items() if dtype == f32}
    if referee:
        # a world of one: the rank's rows alone are the whole batch
        key = "alone" if mesh.n_data > 1 else "one_process"
        mine = worst_step_error(runs[key, f64][0], runs[key, f32][0], runs[key, f64][2])
        report["alone_vs_f64"] = gather_rows(
            mesh, torch.tensor([mine], dtype=f64, device=mesh.device)).flatten().tolist()
    if not mesh.is_main:
        return None, report

    def disagreements(got, want):
        (gs, gm, _), (ws, wm, before) = got, want
        bad = [(k, gm[k], wm[k]) for k in wm
               if not abs(gm[k] / wm[k] - 1) <= (1e-3 if k == "grad_norm" else 1e-4)]
        return bad + state_disagreements(ws, gs, before)

    if referee:
        exact = runs["one_process", f64]
        report["f64_disagreements"] = disagreements(runs["mesh", f64], exact)
        report["f64_worst"] = worst_step_error(exact[0], runs["mesh", f64][0], exact[2])
        report["mesh_vs_f64"] = worst_step_error(exact[0], runs["mesh", f32][0], exact[2])
        report["plain_vs_f64"] = worst_step_error(exact[0], runs["one_process", f32][0],
                                                  exact[2])
    return disagreements(runs["mesh", f32], runs["one_process", f32]), report


def ota_card_vs_cpu(cfg) -> tuple[list, dict]:
    """YoloLossOTA on the same raw maps (a training forward of `cfg`'s
    seeded model on the CPU, B=2 at its input size, bench_targets) on the
    CPU and on the card. Returns (disagreements, errors): the assignment
    must be equal (fg mask, and the matched label of every fg candidate)
    with some fg, the loss to 1e-5 relative and its parts to 1e-5 relative
    plus 1e-7, each map's gradient to 1e-4 of its largest element."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.train.ota import YoloLossOTA

    size = cfg.model.input_size[0]
    model = build_model(cfg, device="cpu", seed=0).train()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 255, (2, size, size, 3), dtype=np.uint8))
    targets = torch.from_numpy(bench_targets(rng, 2))
    with torch.no_grad():
        raws = [r.contiguous() for r in model(x, decode=False)]
    out = {}
    for dev in ("cpu", "cuda"):
        loss = YoloLossOTA(cfg.model.num_classes, model.head.grid_anchors, TRAIN_HYP,
                           strides=model.strides)
        assigned = []
        assign = loss.assign      # record the assignment of the call below
        loss.assign = lambda *a: assigned.append(assign(*a)) or assigned[-1]
        maps = [r.detach().to(dev).requires_grad_() for r in raws]
        total, parts = loss(maps, targets.to(dev))
        total.backward()
        out[dev] = (float(total.detach()), parts.cpu(), [m.grad.cpu() for m in maps],
                    [t.cpu() for t in assigned[0]])
    (wt, wp, wg, (wfg, wmg)), (gt, gp, gg, (gfg, gmg)) = out["cpu"], out["cuda"]
    errors = {"fg": int(wfg.sum()), "loss_rel": abs(gt / wt - 1),
              "grad_rel": max(float((g - w).abs().max() / w.abs().max())
                              for g, w in zip(gg, wg))}
    bad = []
    if not (torch.equal(gfg, wfg) and torch.equal(gmg[wfg], wmg[wfg]) and wfg.sum() > 0):
        bad.append(("assignment", int(gfg.sum()), int(wfg.sum())))
    if not (errors["loss_rel"] <= 1e-5 and torch.allclose(gp, wp, rtol=1e-5, atol=1e-7)):
        bad.append(("loss", gt, wt, gp.tolist(), wp.tolist()))
    if not errors["grad_rel"] <= 1e-4:
        bad.append(("gradients", errors["grad_rel"]))
    return bad, errors


def _cuda_device(model, what: str) -> torch.device:
    dev = next(model.parameters()).device
    if dev.type != "cuda":
        raise RuntimeError(f"{what} measures on a CUDA device; the model is "
                           f"on {dev}")
    return dev


@torch.inference_mode()
def detector_step(model, x_u8: torch.Tensor, anchors_px: torch.Tensor):
    """One serving step on a uint8 NHWC batch: (dets, valid)."""
    raws = model(x_u8, decode=False)
    return postprocess_raw(raws, anchors_px, strides=model.strides,
                           **POSTPROCESS_ARGS)


def run_detector_bench(model, batch: int, size: int = 640, iters: int = 20,
                       warmup: int = 3, seed: int = 0) -> dict:
    """Images per second of `model` (on a CUDA device) at (batch, size,
    size, 3) uint8 input. Returns a record with the rate, the mean step
    time and the device it ran on."""
    dev = _cuda_device(model, "run_detector_bench")
    anchors = torch.as_tensor(model.anchors_px, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8)).to(dev)
    n_valid = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(warmup):
        _, valid = detector_step(model, images + i, anchors)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        _, valid = detector_step(model, images + (warmup + i), anchors)
        n_valid += valid.sum()
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / iters
    return {
        "metric": "images_per_sec",
        "value": batch * 1000.0 / ms,
        "unit": "img/s",
        "step_ms": ms,
        "batch": batch,
        "size": size,
        "detections": int(n_valid.item()),
        "device": torch.cuda.get_device_name(dev),
    }


def bench_targets(rng, batch: int) -> np.ndarray:
    """tools/bench_train.py's targets: (batch, 32, 5) rows, 4 labels an
    image of random class (of 80), centre and size in [0.2, 0.6)."""
    targets = np.full((batch, 32, 5), -1, np.float32)
    targets[:, :4, 0] = rng.integers(0, 80, (batch, 4))
    targets[:, :4, 1:] = rng.uniform(0.2, 0.6, (batch, 4, 4))
    return targets


def daug_batch(rng, batch: int, size: int) -> dict:
    """tools/bench_train.py's device-augmentation batch: 5 full tiles of
    random bytes an image, mosaic centre, fractional scale and translate,
    HSV on and mixup on (every tap bilinear, the costliest regime)."""
    from vision_kit_tpu_torch.data import device_aug as da

    targets = bench_targets(rng, batch)
    tiles = rng.integers(0, 255, (batch, da.N_TILES, size, size, 3), dtype=np.uint8)
    tile_hw = np.full((batch, da.N_TILES, 2), size, np.int32)
    params = np.zeros((batch, da.N_PARAMS), np.float32)
    params[:, da.P_XC] = rng.integers(size // 2, 3 * size // 2, batch)
    params[:, da.P_YC] = rng.integers(size // 2, 3 * size // 2, batch)
    params[:, da.P_SCALE] = rng.uniform(0.6, 1.4, batch)
    params[:, da.P_TX] = rng.uniform(-0.1, 0.1, batch) * size
    params[:, da.P_TY] = rng.uniform(-0.1, 0.1, batch) * size
    params[:, da.P_HSV_H] = rng.uniform(0.985, 1.015, batch)
    params[:, da.P_HSV_S] = rng.uniform(0.5, 1.5, batch)
    params[:, da.P_HSV_V] = rng.uniform(0.6, 1.4, batch)
    params[:, da.P_MIX_W] = 0.5
    params[:, da.P_MIX_JIT] = rng.uniform(1.0, 1.5, batch)
    params[:, da.P_MIX_OW] = (size * params[:, da.P_MIX_JIT]).astype(int)
    params[:, da.P_MIX_OH] = params[:, da.P_MIX_OW]
    return {"tiles": tiles, "tile_hw": tile_hw, "params": params,
            "targets": targets}


# tools/bench_train.py's program: its hyperparameters, optimizer horizon
# included (linear schedule), its input size, and bf16 compute; the data
# come from a fixed seed
TRAIN_HYP = {
    "lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_bias_lr": 0.1, "warmup_momentum": 0.8,
    "box": 0.05, "cls": 0.5, "obj": 1.0, "cls_pw": 1.0, "obj_pw": 1.0,
    "anchor_t": 4.0, "label_smoothing": 0.0,
}
TRAIN_EPOCHS, TRAIN_STEPS_PER_EPOCH = 300, 1000
TRAIN_SIZE, TRAIN_DTYPE, TRAIN_DATA_SEED = 640, torch.bfloat16, 0


def train_bench_setup(model, loss_fn, batch: int, device_aug: bool = False,
                      remat: bool = False, accum_steps: int = 1, mesh=None):
    """(step, state, data) of tools/bench_train.py's program over `model`
    on its device: make_train_step in TRAIN_DTYPE with TRAIN_HYP, a fresh
    state, and the batch at TRAIN_SIZE (images uniform in [0, 1] in f32,
    or with device_aug the tiles batch, daug_batch) on the device. Under a
    mesh, `batch` is each rank's: the step is data-parallel over the global
    batch of batch * n_data."""
    from vision_kit_tpu_torch.train.optim import make_optimizer
    from vision_kit_tpu_torch.train.step import create_train_state, make_train_step

    dev = next(model.parameters()).device
    rng = np.random.default_rng(TRAIN_DATA_SEED)
    tx = make_optimizer(model, TRAIN_HYP, TRAIN_EPOCHS, TRAIN_STEPS_PER_EPOCH)
    step = make_train_step(model, loss_fn, tx, remat=remat, accum_steps=accum_steps,
                           device_aug=device_aug, compute_dtype=TRAIN_DTYPE, mesh=mesh)
    if device_aug:
        data = daug_batch(rng, batch, TRAIN_SIZE)
    else:
        data = {"image": rng.uniform(0, 1, (batch, TRAIN_SIZE, TRAIN_SIZE, 3)
                                     ).astype(np.float32),
                "targets": bench_targets(rng, batch)}
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    return step, create_train_state(model, tx, mesh=mesh), data


def run_train_bench(model, loss_fn, batch: int = 64, iters: int = 10,
                    warmup: int = 3, device_aug: bool = False, remat: bool = False,
                    accum_steps: int = 1, mesh=None) -> dict:
    """Images per second of tools/bench_train.py's program
    (train_bench_setup) over `model` (on a CUDA device; it trains the model
    in place), the same batch every step. CUDA events over `iters` steps
    after `warmup`. Returns the rate, the mean step time and the peak
    device memory of the timed steps. Under a mesh `batch` is each rank's,
    and the rate is this rank's share of the global batch's."""
    dev = _cuda_device(model, "run_train_bench")
    step, state, data = train_bench_setup(model, loss_fn, batch, device_aug=device_aug,
                                          remat=remat, accum_steps=accum_steps, mesh=mesh)
    for _ in range(warmup):
        state, metrics = step(state, data)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        state, metrics = step(state, data)
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / iters
    return {
        "metric": "train_images_per_sec",
        "value": batch * 1000.0 / ms,
        "unit": "img/s",
        "step_ms": ms,
        "batch": batch,
        "size": TRAIN_SIZE,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "loss": float(metrics["loss"]),
        "device": torch.cuda.get_device_name(dev),
    }


def pseudo_targets(dets: np.ndarray, valid: np.ndarray, img_hw,
                   rng) -> np.ndarray:
    """Ground truth that a detector's own output half matches: each image's
    5 highest detections with every coordinate moved by up to 2 px, plus 2
    boxes of random COCO classes (2-10 % of the image a side), packed by
    pad_targets. dets (B, max_det, 6) and valid (B, max_det) on the host."""
    h, w = img_hw
    labels = []
    for d, v in zip(dets, valid):
        best = d[v][:5]
        boxes = best[:, :4] + rng.uniform(-2.0, 2.0, (len(best), 4))
        x1y1 = rng.uniform(0, 0.9, (2, 2)) * [w, h]
        wh = rng.uniform(0.02, 0.1, (2, 2)) * [w, h]
        rand = np.concatenate([x1y1, x1y1 + wh], 1)
        labels.append(np.concatenate([
            np.concatenate([boxes, best[:, 5:6]], 1),
            np.concatenate([rand, rng.integers(0, 80, (2, 1))], 1),
        ]).astype(np.float32))
    return pad_targets(labels, img_hw)


def run_eval_bench(model, batch: int = 64, size: int = 640, iters: int = 10,
                   warmup: int = 3, seed: int = 0) -> dict:
    """Images per second of the eval step (train/step.py:make_eval_step,
    the eval protocol) over `model` on a CUDA device, at (batch, size, size,
    3) uint8 input, and the host ms per batch of DetEvaluator.update on the
    bench's own detections (pseudo_targets as ground truth), with and
    without the COCO-protocol accumulation (each the mean of two passes,
    timed in turns)."""
    from vision_kit_tpu_torch.classes import COCO
    from vision_kit_tpu_torch.train.evaluator import DetEvaluator
    from vision_kit_tpu_torch.train.step import make_eval_step

    dev = _cuda_device(model, "run_eval_bench")
    eval_step = make_eval_step(model)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8)).to(dev)
    for i in range(warmup):
        eval_step(images + i)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    outs = []
    start.record()
    for i in range(iters):
        outs.append(eval_step(images + (warmup + i)))
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / iters

    host = [(d.cpu().numpy(), v.cpu().numpy()) for d, v in outs]
    targets = [pseudo_targets(d, v, (size, size), rng) for d, v in host]
    infos = [(size, size, 1.0, (0.0, 0.0), i) for i in range(batch)]
    evaluator = DetEvaluator(COCO, img_size=size)
    update_ms = {False: [], True: []}
    for collect_coco in (False, True, True, False):   # in turns
        evaluator.reset(collect_coco=collect_coco)
        t0 = time.perf_counter()
        for (d, v), t in zip(host, targets):
            evaluator.update(d, v, t, infos)
        update_ms[collect_coco].append((time.perf_counter() - t0) * 1e3 / iters)
    return {
        "metric": "eval_images_per_sec",
        "value": batch * 1000.0 / ms,
        "unit": "img/s",
        "step_ms": ms,
        "batch": batch,
        "size": size,
        "detections": int(sum(v.sum() for _, v in host)),
        "evaluator_update_ms": float(np.mean(update_ms[False])),
        "evaluator_update_coco_ms": float(np.mean(update_ms[True])),
        "device": torch.cuda.get_device_name(dev),
    }
