#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vision_kit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: builds the CUDA kernel from csrc/ (the Triton kernel compiles
     at its first launch); TF32 off for the f32 comparisons;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the serving path's shapes, and timed beside the plain
     version and the card's bound;
  4. main path: YOLOv5s (80 classes, 640, bf16, seeded random weights)
     behind Predictor.predict_batch for 3 requests of 8 720x1280 frames,
     with the kernels' launch counts read around it; detections equal those
     of the same program on the plain versions, and an f32 model on the card
     agrees with the same model on the CPU on a small input; then the
     median and p99 request latency over 200 requests;
  5. throughput: run_detector_bench for v5s@640, batch 128, bf16, on the
     calibrated head and on the seeded random head as built, then the
     device time of a step by kernel group and its idle share (profiler).
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
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOP_S = 67e12      # f32 outside the tensor cores, H100 SXM
H100_BF16_FLOP_S = 989e12    # bf16 tensor cores, dense, H100 SXM
NMS_OPS_PER_PAIR = 14        # min/max x4, sub x3, clamp x3, mul, add, div, cmp
CONF = 0.25
IOU = 0.45


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_boxes(rng, b, k, case):
    """(B, K, 4) xyxy f32 in score order (class offset added) and (B, K)
    valid; `crowded` clusters boxes of two classes around a few centres."""
    if case == "crowded":
        centres = rng.uniform(50, 600, (b, 6, 2))
        pick = rng.integers(0, 6, (b, k))
        c = np.take_along_axis(centres, pick[..., None], axis=1)
        c = c + rng.normal(0, 6, (b, k, 2))
        wh = rng.uniform(30, 60, (b, k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
        boxes = boxes + rng.integers(0, 2, (b, k, 1)) * 7680.0
    else:
        x1y1 = rng.uniform(0, 600, (b, k, 2))
        wh = rng.uniform(10, 150, (b, k, 2))
        boxes = np.concatenate([x1y1, x1y1 + wh], -1)
    valid = np.ones((b, k), bool)
    if case == "invalid_tail":
        valid[:, k - k // 3:] = False
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(valid).cuda())


def nms_pairs_needed(keep: torch.Tensor, valid: torch.Tensor) -> int:
    """IoU pairs the greedy result needs: each kept box against every valid
    later box."""
    later_valid = valid.flip(1).cumsum(1).flip(1) - valid.long()
    return int((later_valid * keep).sum())


def phase_kernels(rng):
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep, greedy_keep_reference
    from vision_kit_tpu_torch.ops.head_scores import head_scores, head_scores_reference

    rows = {}
    # -- greedy NMS: bit-equal masks -------------------------------------
    for b, k in ((128, 252), (128, 512), (128, 1024), (128, 1280)):
        for case in ("random", "crowded", "invalid_tail"):
            boxes, valid = make_boxes(rng, b, k, case)
            got = greedy_keep(boxes, valid, IOU)
            want = greedy_keep_reference(boxes, valid, IOU)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            check(n_diff == 0, f"greedy_nms: {n_diff} mask bits differ at "
                  f"B={b} K={k} {case}")
            check(not bool((got & ~valid).any()), "greedy_nms kept an invalid box")
        print(f"kernels: greedy_nms B={b} K={k} masks bit-equal "
              "(random, crowded, invalid_tail)", flush=True)
    boxes, valid = make_boxes(rng, 2, 2048, "random")
    try:
        greedy_keep(boxes, valid, IOU)
    except ValueError:
        print("kernels: greedy_nms refuses K=2048 (mask beyond shared memory)",
              flush=True)
    else:
        raise RuntimeError("greedy_nms accepted K=2048 beyond its shared memory")
    boxes, valid = make_boxes(rng, 128, 512, "random")
    keep = greedy_keep(boxes, valid, IOU)
    pairs = nms_pairs_needed(keep, valid)
    nbytes = boxes.numel() * 4 + valid.numel() * 2
    bound_ops = pairs * NMS_OPS_PER_PAIR / H100_F32_FLOP_S * 1e3
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    ms = time_ms(lambda: greedy_keep(boxes, valid, IOU))
    plain_ms = time_ms(lambda: greedy_keep_reference(boxes, valid, IOU), reps=3,
                       warmup=1)
    rows["greedy_nms"] = {
        "name": "greedy_nms", "route": "cuda",
        "source": "vision_kit_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "vision_kit_tpu/ops/pallas_nms.py:32",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
    }
    print(f"kernels: greedy_nms B=128 K=512 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {rows['greedy_nms']['bound_ms']:.4f} ms "
          f"({pairs} IoU pairs needed)", flush=True)

    # -- head scores: v5s@640 b128 level shapes --------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        raws = [
            (torch.randn(128, n, n, 255, generator=gen, device="cuda") * 2)
            .to(dtype).view(128, n, n, 3, 85)
            for n in (80, 40, 20)
        ]
        for classes in (None, torch.arange(80, device="cuda") % 3 != 1):
            ks, kc = head_scores(raws, CONF, classes)
            rs, rc = head_scores_reference(raws, CONF, classes)
            torch.cuda.synchronize()
            check(torch.equal(kc, rc), f"head_scores classes differ ({dtype})")
            kv, rv = ks > -1, rs > -1
            flip = kv != rv
            if bool(flip.any()):
                near = torch.where(kv, ks, rs)[flip]
                check(bool(((near - CONF).abs() <= 1e-6).all()),
                      f"head_scores gate differs away from conf ({dtype})")
            both = kv & rv
            check(torch.allclose(ks[both], rs[both], rtol=1e-6, atol=0),
                  f"head_scores scores differ beyond rtol 1e-6 ({dtype})")
            err = float((ks[both] - rs[both]).abs().max()) if bool(both.any()) else 0.0
            ulp = int((ks[both].view(torch.int32) - rs[both].view(torch.int32))
                      .abs().max()) if bool(both.any()) else 0
            max_err = max(max_err, err)
            print(f"kernels: head_scores {str(dtype)[6:]} "
                  f"classes={'mask' if classes is not None else 'all'} "
                  f"max_abs_err {err:.3g} ({ulp} ulp), classes equal, "
                  f"{int(flip.sum())} gate flips within 1e-6 of conf", flush=True)
    raws = [(torch.randn(128, n, n, 255, generator=gen, device="cuda") * 2)
            .to(torch.bfloat16).view(128, n, n, 3, 85) for n in (80, 40, 20)]
    ms = time_ms(lambda: head_scores(raws, CONF))
    plain_ms = time_ms(lambda: head_scores_reference(raws, CONF))
    n_out = sum(r.shape[0] * r.shape[1] * r.shape[2] * 3 for r in raws)
    nbytes = sum(r.numel() * r.element_size() for r in raws) + n_out * 8
    rows["head_scores"] = {
        "name": "head_scores", "route": "triton",
        "source": "vision_kit_tpu_torch/ops/head_scores.py",
        "replaces": "tools/archive/bench_pallas_score.py:59",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }
    print(f"kernels: head_scores bf16 b128 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {rows['head_scores']['bound_ms']:.4f} ms "
          f"({nbytes / 1e6:.1f} MB)", flush=True)
    return rows


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
    ("greedy_nms", ("greedy_nms",)),
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
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(
        REPO, "vision_kit_tpu_torch", "_build", "triton"))
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from vision_kit_tpu_torch import _cuda_build

    t0 = time.perf_counter()
    lib = _cuda_build.build("greedy_nms")
    with open(lib + ".log") as f:
        ptxas = " ".join(line.strip() for line in f if "registers" in line)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"build: greedy_nms.cu in {time.perf_counter() - t0:.1f} s ({ptxas})",
          flush=True)

    rng = np.random.default_rng(0)
    rows = phase_kernels(rng)
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
