#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vision_kit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: builds every CUDA source in csrc/ (one nvcc each, in parallel)
     and prints each kernel's registers, shared memory and spills; TF32 off
     for the f32 comparisons;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at both serving paths' shapes (greedy NMS bit-equal at K up
     to 2048, head scores in bf16, f16 and f32 with ragged tiles), one
     launch counted per call;
  4. main path: YOLOv5s (80 classes, 640, bf16, seeded random weights)
     behind Predictor.predict_batch for 3 requests of 8 720x1280 frames,
     with the kernels' launch counts read around it; detections equal those
     of the same program on the plain versions, and an f32 model on the card
     agrees with the same model on the CPU on a small input; then the
     median and p99 request latency over 200 requests;
  5. throughput: run_detector_bench for v5s@640, batch 128, bf16, on the
     calibrated head and on the seeded random head as built; then each
     kernel timed at both paths' shapes beside the plain version and the
     card's bound (utils/kernel_bench.py), and the device time of a step by
     kernel group and its idle share (profiler).
Then one JSON line with each kernel's numbers and, last,
{"ok": true, "device": ...}.

The main path's head has its biases zeroed and its kernels scaled to unit
logit spread (from a probe batch), so that seeded random weights yield
crowded detections instead of none: every frame then fills max_det, a load
at saturation that is heavier on the postprocess than a trained detector's.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOP_S = 989e12    # bf16 tensor cores, dense, H100 SXM
NMS_KS = (252, 512, 1024, 1280, 2048)
NMS_CHECK_CASES = ("random", "crowded", "invalid_tail", "all_invalid")
HEAD_CHECK_SHAPES = (
    (128, ((80, 80), (40, 40), (20, 20))),   # throughput path, v5s@640
    (8, ((80, 80), (40, 40), (20, 20))),     # request path, v5s@640
    (1, ((5, 5), (7, 3), (1, 1))),           # ragged last tiles
)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def build_kernels() -> None:
    """Build every csrc/*.cu at once (one nvcc each, in parallel) and print
    each kernel's registers, shared memory and spills from ptxas."""
    from concurrent.futures import ThreadPoolExecutor

    from vision_kit_tpu_torch import _cuda_build

    names = sorted(f[:-3] for f in os.listdir(_cuda_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_cuda_build.build, names))
    print(f"build: {', '.join(n + '.cu' for n in names)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, lib in zip(names, libs):
        kernel, info = None, {}
        with open(lib + ".log") as f:
            for line in f:
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                    info[kernel] = []
                elif kernel and ("registers" in line or "spill" in line):
                    info[kernel].append(line.split(":", 1)[-1].strip()
                                        if "registers" in line else line.strip())
        for kernel, lines in info.items():
            short = next((w for w in ("nms_mask_kernel", "nms_walk_kernel",
                                      "head_scores_kernel") if w in kernel), kernel)
            if short == "head_scores_kernel":
                dtype = ("bf16" if "bfloat16" in kernel else
                         "f16" if "__half" in kernel else "f32")
                short += f"<{dtype}{', masked' if 'Lb1E' in kernel else ''}>"
            print(f"build: {name}.cu {short}: {'; '.join(lines)}", flush=True)


def phase_kernels(rng):
    from vision_kit_tpu_torch.ops.boxes import box_iou_pairwise
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep, greedy_keep_reference
    from vision_kit_tpu_torch.ops.head_scores import head_scores, head_scores_reference
    from vision_kit_tpu_torch.utils import kernel_bench as kb

    # -- greedy NMS: bit-equal masks -------------------------------------
    for b in (8, 128):
        for k in NMS_KS:
            for case in NMS_CHECK_CASES:
                boxes, valid = kb.make_boxes(rng, b, k, case)
                before = greedy_keep.launches
                got = greedy_keep(boxes, valid, kb.IOU)
                check(greedy_keep.launches == before + 1,
                      "greedy_nms counted other than one launch per call")
                want = greedy_keep_reference(boxes, valid, kb.IOU)
                torch.cuda.synchronize()
                n_diff = int((got != want).sum())
                check(n_diff == 0, f"greedy_nms: {n_diff} mask bits differ at "
                      f"B={b} K={k} {case}")
                check(not bool((got & ~valid).any()), "greedy_nms kept an invalid box")
            print(f"kernels: greedy_nms B={b} K={k} masks bit-equal "
                  f"({', '.join(NMS_CHECK_CASES)})", flush=True)
    boxes, valid = kb.make_boxes(rng, 8, 300, "grid")
    ious = torch.unique(box_iou_pairwise(boxes[:1], boxes[:1], eps=1e-9))
    n_thres = 0
    for t in ious[(ious > 0.05) & (ious < 0.95)][::7].tolist():
        for thres in (*np.nextafter(np.float32(t), [np.float32(0), np.float32(1)]).tolist(), t):
            n_diff = int((greedy_keep(boxes, valid, thres)
                          != greedy_keep_reference(boxes, valid, thres)).sum())
            check(n_diff == 0, f"greedy_nms: {n_diff} bits differ at thres {thres!r}")
            n_thres += 1
    print(f"kernels: greedy_nms bit-equal on grid boxes at {n_thres} thresholds "
          "on and beside exact IoU values", flush=True)

    # -- head scores: both paths' level shapes and ragged tiles -----------
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for batch, grids in HEAD_CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            raws = kb.head_maps(gen, batch, dtype, grids)
            for classes in (None, torch.arange(80, device="cuda") % 3 != 1):
                before = head_scores.launches
                got = head_scores(raws, kb.CONF, classes)
                check(head_scores.launches == before + 1,
                      "head_scores counted other than one launch per call")
                want = head_scores_reference(raws, kb.CONF, classes)
                torch.cuda.synchronize()
                agree = kb.head_scores_agree(got, want)
                max_err = max(max_err, agree["max_abs_err"])
                print(f"kernels: head_scores b{batch} {grids[0][0]}x{grids[0][1]}.. "
                      f"{str(dtype)[6:]} classes={'mask' if classes is not None else 'all'} "
                      f"max_abs_err {agree['max_abs_err']:.3g} ({agree['ulp']} ulp), "
                      f"classes equal, {agree['flips']} gate flips within 1e-6 of conf",
                      flush=True)
            del raws
    shifted = torch.zeros(2 * 4 * 4 * 255 + 1, device="cuda",
                          dtype=torch.bfloat16)[1:].view(2, 4, 4, 3, 85)
    try:
        head_scores([shifted], kb.CONF)
    except ValueError:
        print("kernels: head_scores refuses a base off the 16-byte boundary", flush=True)
    else:
        raise RuntimeError("head_scores accepted a misaligned base")
    return max_err


def kernel_times(head_max_err: float):
    """Each kernel's times at both paths' shapes (utils/kernel_bench.py),
    and its JSON row. Runs after the latency phase: the profiler that
    kernel_bench uses for its per-kernel split may leave the host's launch
    path slower for the rest of the process."""
    from vision_kit_tpu_torch.utils import kernel_bench as kb

    bench = kb.run()
    nms = next(r for r in bench["greedy_nms"]
               if (r["batch"], r["k"], r["case"]) == (128, 512, "random"))
    head = next(r for r in bench["head_scores"] if r["batch"] == 128)
    return {
        "greedy_nms": {
            "name": "greedy_nms", "route": "cuda",
            "source": "vision_kit_tpu_torch/csrc/greedy_nms.cu",
            "replaces": "vision_kit_tpu/ops/pallas_nms.py:32",
            "max_abs_err": 0.0, "ms": float(np.mean(nms["current_ms"])),
            "plain_ms": nms["plain_ms"], "bound_ms": nms["bound_ms"],
            "bound_by": nms["bound_by"], "library_ms": None,
        },
        "head_scores": {
            "name": "head_scores", "route": "cuda",
            "source": "vision_kit_tpu_torch/csrc/head_scores.cu",
            "replaces": "tools/archive/bench_pallas_score.py:59",
            "max_abs_err": head_max_err, "ms": float(np.mean(head["current_ms"])),
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        },
    }


@contextlib.contextmanager
def plain_kernels():
    """Run postprocess_raw on the kernels' plain versions."""
    from vision_kit_tpu_torch.ops import greedy_nms, head_scores, nms

    saved = nms.head_scores, nms.greedy_keep
    nms.head_scores = head_scores.head_scores_reference
    nms.greedy_keep = greedy_nms.greedy_keep_reference
    try:
        yield
    finally:
        nms.head_scores, nms.greedy_keep = saved


def reset_counts():
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
    from vision_kit_tpu_torch.ops.head_scores import head_scores

    greedy_keep.launches = 0
    head_scores.launches = 0


def read_counts():
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
    from vision_kit_tpu_torch.ops.head_scores import head_scores

    return {"greedy_nms": greedy_keep.launches,
            "head_scores": head_scores.launches}


def same_detections(want, got, score_tol, box_tol) -> bool:
    if want.shape != got.shape:
        return False
    free = np.ones(len(got), bool)
    for row in want:
        ok = (free & (got[:, 5] == row[5])
              & (np.abs(got[:, 4] - row[4]) <= score_tol)
              & (np.abs(got[:, :4] - row[:4]).max(axis=1) <= box_tol))
        if not ok.any():
            return False
        free[np.argmax(ok)] = False
    return True


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


def v5s_config():
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = "s", 80
    cfg.model.input_size = [640, 640]
    return cfg


def phase_main_path(rng, smi: str):
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import Predictor

    cfg = v5s_config()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    calibrate_head(model, 640, seed=1)
    pred = Predictor(model, img_size=640, device="cuda")
    requests = [rng.integers(0, 255, (8, 720, 1280, 3), dtype=np.uint8)
                for _ in range(3)]
    pred.warmup((720, 1280), 8)
    torch.cuda.synchronize()

    reset_counts()
    outs = []
    for frames in requests:
        dets, ms = pred.predict_batch(frames)
        outs.append(dets)
    counts = read_counts()
    print(f"main path: Predictor.predict_batch v5s@640 bf16, 3 requests of "
          f"8x720x1280, launches {counts}, last request {ms:.1f} ms", flush=True)
    for name, n in counts.items():
        check(n > 0, f"main path never launched {name}")

    n_det = 0
    with plain_kernels():
        for frames, got in zip(requests, outs):
            want, _ = pred.predict_batch(frames)
            for w, g in zip(want, got):
                check(g.shape[1:] == (6,) and np.isfinite(g).all(),
                      "non-finite or misshapen detections")
                check(same_detections(w, g, 1e-5, 1e-3),
                      f"detections differ from the plain path ({len(w)} vs {len(g)})")
                n_det += len(g)
    check(n_det > 0, "main path produced no detections")
    print(f"main path: {n_det} detections over 24 frames, equal to the plain "
          "path's (class exact, score 1e-5, box 1e-3 px)", flush=True)

    # an f32 model on the card against the same model on the CPU, small input
    cfg_small = v5s_config()
    cfg_small.model.input_size = [128, 128]
    frames = rng.integers(0, 255, (2, 96, 160, 3), dtype=np.uint8)
    results = []
    for dev in ("cuda", "cpu"):
        m = build_model(cfg_small, device=dev, dtype=torch.float32, seed=0)
        calibrate_head(m, 128, seed=1)
        dets, _ = Predictor(m, img_size=128, device=dev).predict_batch(frames)
        results.append(dets)
    n_small = 0
    for g, w in zip(*results):
        check(same_detections(w, g, 1e-4, 1e-2),
              f"f32 card vs CPU detections differ ({len(w)} vs {len(g)})")
        n_small += len(w)
    check(n_small > 0, "small-input reference produced no detections")
    print(f"main path: f32 v5s@128 on the card equals the CPU run "
          f"({n_small} detections; score 1e-4, box 1e-2 px)", flush=True)

    lat = np.array([pred.predict_batch(requests[i % 3])[1] for i in range(200)])
    print(f"main path: request latency over {len(lat)} requests of 8x720x1280 "
          f"(host clock, upload to detections on the host): median "
          f"{np.median(lat):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
          f"min {lat.min():.3f} ms, max {lat.max():.3f} ms on {smi}", flush=True)
    return model, counts


# kernel-name words per group, tried in order (cuDNN's batch-norm kernels
# carry "cudnn" too, so batch norm comes before the convolutions)
PROFILE_GROUPS = (
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw")),
    ("conv", ("conv", "gemm", "xmma", "cudnn", "implicit", "cutlass")),
    ("head_scores", ("head_scores",)),
    ("greedy_nms", ("nms_mask_kernel", "nms_walk_kernel")),
    ("topk_sort", ("topk", "radix", "sort", "select")),
    ("concat", ("catarray",)),
    ("elementwise", ("elementwise", "vectorized", "silu", "unrolled")),
)


@torch.no_grad()
def conv_flops(model, x: torch.Tensor) -> int:
    """Floating-point operations (2 per multiply-add) of every convolution
    in one forward pass of `model` on `x`."""
    total = 0

    def count(mod, _, out):
        nonlocal total
        total += 2 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    model(x, decode=False)
    for h in hooks:
        h.remove()
    return total


def profile_steps(model, batch: int = 128, size: int = 640,
                  steps: int = 3) -> dict:
    """Device time per throughput step by kernel group (torch.profiler,
    kernel events only), the device's idle share of the wall time, and the
    convolutions' bound at the card's bf16 tensor-core peak."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vision_kit_tpu_torch.utils.stream_bench import detector_step

    dev = next(model.parameters()).device
    anchors = torch.as_tensor(model.anchors_px, dtype=torch.float32, device=dev)
    x = torch.randint(0, 255, (batch, size, size, 3), dtype=torch.uint8,
                      device=dev)
    flops = conv_flops(model, x)
    detector_step(model, x, anchors)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            detector_step(model, x, anchors)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [[e.key[:70], e.self_device_time_total / 1e3 / steps] for e in kernels[:8]]
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / steps
        key = e.key.lower()
        for name, words in PROFILE_GROUPS:
            if any(w in key for w in words):
                groups[name] += ms
                break
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    if busy == 0:
        return {"device_ms": "not measured"}
    check(busy <= wall_ms * 1.02, f"profile counts {busy:.2f} ms of device time "
          f"in {wall_ms:.2f} ms of wall time: kernels counted twice?")
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "conv_gflop": flops / 1e9,
            "conv_bound_ms": flops / H100_BF16_FLOP_S * 1e3,
            **{f"{k}_ms": v for k, v in groups.items()}, "top_kernels": top}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "vision_kit_tpu_torch")):
        print("chip_smoke: vision_kit_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    from vision_kit_tpu_torch.utils.kernel_bench import card

    smi = card()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    build_kernels()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.default_rng(0)
    head_max_err = phase_kernels(rng)
    model, counts = phase_main_path(rng, smi)

    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.utils.stream_bench import run_detector_bench

    as_built = build_model(v5s_config(), device="cuda", dtype=torch.bfloat16,
                           seed=0)
    for head, m in (("calibrated head", model), ("head as built", as_built)):
        reset_counts()
        rec = run_detector_bench(m, batch=128, size=640, iters=10, warmup=3)
        bench_counts = read_counts()
        for name, n in bench_counts.items():
            check(n > 0, f"throughput path never launched {name}")
        print(f"throughput: v5s@640 b128 bf16, {head}: {rec['value']:.1f} img/s "
              f"({rec['step_ms']:.3f} ms/step, {rec['detections']} detections "
              f"in 10 steps) on {smi}; launches {bench_counts}", flush=True)
    del as_built

    rows = kernel_times(head_max_err)
    prof = profile_steps(model)
    print("profile: v5s@640 b128 bf16, per step, device ms by kernel group: "
          + json.dumps(prof), flush=True)

    for name, row in rows.items():
        row["launches"] = counts[name]
    print(json.dumps({"kernels": [rows["greedy_nms"], rows["head_scores"]]}))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
