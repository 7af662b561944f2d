"""Detector and eval-step throughput on the card.

run_detector_bench is the counterpart of
vision_kit_tpu/utils/stream_bench.py:run_detector_bench: uint8 frames go
straight into the model (the stem normalises), then postprocess_raw runs
with the JAX bench's arguments. run_eval_bench is the counterpart of
tools/bench_eval.py: the eval step (train/step.py) with the eval protocol,
and beside it the host time of the evaluator on the bench's detections.
Both time with CUDA events after warmup; the input is perturbed on every
iteration so no step repeats another's input.

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
