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
     calibrated head and on the seeded random head as built;
  6. eval path: the phase-4 model behind make_eval_step (the eval
     protocol) and trainer.validate over 4 batches of 64 seeded 640x640
     frames in ValLoader's format, ground truth from a first pass; with
     the kernel against the plain keep (detections and metrics equal, one
     greedy_nms launch a batch, no head_scores launch), an f32 v5s@128 eval
     on the card against the CPU, trainer.test's COCO metric set,
     run_eval_bench at batch 64 (img/s and the evaluator's host ms a batch),
     and topk_stable's two routes: the order of ties on the card against a
     stable argsort, and each route's time beside torch.topk at every top-k
     of both postprocesses;
  7. YOLOv7: v7 base@640 (80 classes) built in the training structure in
     f32, head calibrated through the implicit layers, folded by
     convert.deploy_state_dict into a deploy model whose decoded output
     equals the training structure's to 2e-3 (both structures' raw maps
     pass head_scores' layout check); the deploy model in bf16 behind
     Predictor.predict_batch for 3 requests of 8 720x1280 frames (both
     kernels launched, detections equal to the plain versions'), and with
     multi_label for one; an f32 v7 base@128 on the card against the CPU;
     request latency over 100 requests; run_detector_bench and
     run_eval_bench at batch 64 in bf16;
then each kernel timed at the serving and eval paths' shapes beside the
plain version and the card's bound (utils/kernel_bench.py), and the device
time of a throughput step and of an eval step, v5s and v7, by kernel group
with the idle share and the convolutions' bound (profiler). Then one JSON
line with each kernel's numbers, a row for each path's shape
(greedy_nms_eval is the greedy-NMS kernel at the eval step's shape, with
the eval path's launches; head_scores_v7 and greedy_nms_v7 the kernels at
v7's b64 serving shape, with the v7 throughput run's launches) and, last,
{"ok": true, "device": ...}.

The main path's head has its biases zeroed and its kernels scaled to unit
logit spread (from a probe batch), so that seeded random weights yield
crowded detections instead of none: every frame then fills max_det, a load
at saturation that is heavier on the postprocess than a trained detector's.
"""

from __future__ import annotations

import contextlib
import copy
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
    (64, ((80, 80), (40, 40), (20, 20))),    # throughput path, v7 base@640
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
    for b in (8, 64, 128):
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
    max_err = {}
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
                max_err[batch] = max(max_err.get(batch, 0.0), agree["max_abs_err"])
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


def kernel_times(head_max_err: dict):
    """Each kernel's JSON row at the shape of the path it runs on
    (utils/kernel_bench.py): greedy_nms at the v5s serving step's B=128,
    K=512, as greedy_nms_eval at the eval step's B=64, K=2048 and as
    greedy_nms_v7 at the v7 serving step's B=64, K=512; head_scores at
    b128 and, as head_scores_v7, at b64. `head_max_err` holds head_scores'
    largest error against its plain version at each batch. Runs after the
    latency phases: the profiler that kernel_bench uses for its per-kernel
    split may leave the host's launch path slower for the rest of the
    process."""
    from vision_kit_tpu_torch.utils import kernel_bench as kb

    bench = kb.run()
    rows = {}
    for name, shape in (("greedy_nms", (128, 512)), ("greedy_nms_eval", (64, 2048)),
                        ("greedy_nms_v7", (64, 512))):
        nms = next(r for r in bench["greedy_nms"]
                   if (r["batch"], r["k"], r["case"]) == (*shape, "random"))
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "vision_kit_tpu_torch/csrc/greedy_nms.cu",
            "replaces": "vision_kit_tpu/ops/pallas_nms.py:32",
            "max_abs_err": 0.0, "ms": float(np.mean(nms["current_ms"])),
            "plain_ms": nms["plain_ms"], "bound_ms": nms["bound_ms"],
            "bound_by": nms["bound_by"], "library_ms": None,
        }
    for name, batch in (("head_scores", 128), ("head_scores_v7", 64)):
        head = next(r for r in bench["head_scores"] if r["batch"] == batch)
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "vision_kit_tpu_torch/csrc/head_scores.cu",
            "replaces": "tools/archive/bench_pallas_score.py:59",
            "max_abs_err": head_max_err[batch],
            "ms": float(np.mean(head["current_ms"])),
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        }
    return rows


@contextlib.contextmanager
def plain_kernels():
    """Run ops/nms.py's postprocesses on the kernels' plain versions."""
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


def v5s_config():
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = "s", 80
    cfg.model.input_size = [640, 640]
    return cfg


def phase_main_path(rng, smi: str):
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.utils.stream_bench import calibrate_head, same_detections

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


def profile_steps(model, step, batch: int, size: int = 640,
                  steps: int = 3) -> dict:
    """Device time per step(x) on a uint8 (batch, size, size, 3) input by
    kernel group (torch.profiler, kernel events only), the device's idle
    share of the wall time, and the convolutions' bound at the card's bf16
    tensor-core peak."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = next(model.parameters()).device
    x = torch.randint(0, 255, (batch, size, size, 3), dtype=torch.uint8,
                      device=dev)
    flops = conv_flops(model, x)
    step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(x)
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


def recording(step, outs: list):
    """step, with each (dets, valid) it returns appended to outs."""
    def run(imgs):
        dets, valid = step(imgs)
        outs.append((dets, valid))
        return dets, valid
    return run


def host_detections(outs):
    """[(dets, valid)] on the device -> per image (n, 6) arrays."""
    rows = []
    for dets, valid in outs:
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        rows += [d[v] for d, v in zip(dets, valid)]
    return rows


EVAL_METRICS = ("map50", "map50_95", "map75", "mp", "mr")


def topk_routes(model, images: np.ndarray, smi: str) -> None:
    """topk_stable's two routes on the card: the order of ties against a
    stable argsort on the host, then the time of each route beside
    torch.topk at every top-k of the eval and serving postprocesses, on the
    eval step's own scores where it has them."""
    from vision_kit_tpu_torch.ops import nms
    from vision_kit_tpu_torch.utils.kernel_bench import time_ms

    routes = {"sort": nms._topk_by_sort, "int64": nms._topk_by_int64}
    gen = np.random.default_rng(3)
    for shape, k in (((256, 80), 20), ((64, 2048), 300), ((4, 504000), 2048)):
        x = (gen.integers(0, 8, shape) / 8).astype(np.float32)
        x[gen.random(shape) < 0.15] = nms.NEG_INF
        want = np.argsort(-x, axis=-1, kind="stable")[..., :k]
        xt = torch.from_numpy(x).cuda()
        for name, fn in (*routes.items(), ("topk_stable", nms.topk_stable)):
            v, i = fn(xt, k)
            check(np.array_equal(i.cpu().numpy(), want),
                  f"{name} orders ties otherwise than a stable argsort at {shape}")
            check(np.array_equal(v.cpu().numpy(), np.take_along_axis(x, want, -1)),
                  f"{name} values differ from a stable argsort's at {shape}")
    print("eval: topk_stable's sort and int64 routes on the card order ties "
          "as a stable argsort (values on a 1/8 grid; widths 80, 2048, 504000)",
          flush=True)

    with torch.inference_mode():
        decoded, _ = model(torch.as_tensor(images, device="cuda"))
        cls_conf = decoded[..., 5:] * decoded[..., 4:5]
        flat = nms.topk_stable(cls_conf, 20)[0].reshape(64, -1)
        flat = torch.where(flat > 0.001, flat, nms.NEG_INF)
        cand = nms.topk_stable(flat, 2048)[0]
    serving = {}
    g = torch.Generator("cuda").manual_seed(4)
    for b, k in ((128, 512), (8, 1024)):   # scores in order, 40 % kept
        s = torch.rand(b, k, generator=g, device="cuda").sort(dim=1, descending=True)[0]
        kept = torch.rand(b, k, generator=g, device="cuda") < 0.4
        serving[b] = torch.where(kept, s, nms.NEG_INF)
    topk_ms = {}
    for name, x, k in (("top20_of_80 b64", cls_conf, 20),
                       ("top2048_of_504000 b64", flat, 2048),
                       ("max_det300_of_2048 b64", cand, 300),
                       ("max_det300_of_512 b128", serving[128], 300),
                       ("max_det300_of_1024 b8", serving[8], 300)):
        want = torch.topk(x, k, dim=-1)[0]
        topk_ms[name] = {"torch.topk": time_ms(lambda: torch.topk(x, k, dim=-1))}
        for route, fn in routes.items():
            check(torch.equal(fn(x, k)[0], want),
                  f"topk_stable ({route}) values differ from torch.topk's ({name})")
            topk_ms[name][route] = time_ms(lambda: fn(x, k))
    print("eval: top-k ms a call, torch.topk beside topk_stable's sort and "
          "int64 routes: " + json.dumps(topk_ms) + f" on {smi}", flush=True)


def phase_eval(model, rng, smi: str) -> dict:
    """The eval path on the phase-4 model; returns the greedy_nms and
    head_scores launches of its validate run on the kernels."""
    from vision_kit_tpu_torch.classes import COCO
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.train import trainer
    from vision_kit_tpu_torch.train.evaluator import DetEvaluator
    from vision_kit_tpu_torch.train.step import make_eval_step
    from vision_kit_tpu_torch.utils.stream_bench import (
        calibrate_head,
        pseudo_targets,
        run_eval_bench,
        same_detections,
    )

    t_phase = time.perf_counter()
    eval_step = make_eval_step(model)
    frames = [rng.integers(0, 255, (64, 640, 640, 3), dtype=np.uint8)
              for _ in range(4)]
    batches = []
    for bi, images in enumerate(frames):
        dets, valid = eval_step(images)
        batches.append({
            "image": images,
            "targets": pseudo_targets(dets.cpu().numpy(), valid.cpu().numpy(),
                                      (640, 640), rng),
            "info": [(640, 640, 1.0, (0.0, 0.0), 64 * bi + i) for i in range(64)],
            "count": 64})
    torch.cuda.synchronize()

    evaluator = DetEvaluator(COCO, img_size=640)
    reset_counts()
    outs = []
    t0 = time.perf_counter()
    got = trainer.validate(recording(eval_step, outs), batches, evaluator)
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts == {"greedy_nms": 4, "head_scores": 0},
          f"eval path launched {counts}, not one greedy_nms a batch and no head_scores")
    with plain_kernels():
        plain_outs = []
        want = trainer.validate(recording(eval_step, plain_outs), batches, evaluator)
    n_det = 0
    for w, g in zip(host_detections(plain_outs), host_detections(outs)):
        check(g.shape[1:] == (6,) and np.isfinite(g).all(),
              "non-finite or misshapen eval detections")
        check(same_detections(w, g, 1e-5, 1e-3),
              f"eval detections differ from the plain path ({len(w)} vs {len(g)})")
        n_det += len(g)
    for k in EVAL_METRICS:
        check(abs(got[k] - want[k]) <= 1e-9,
              f"eval {k} {got[k]!r} differs from the plain path's {want[k]!r}")
    check(0 < got["map50_95"] < 1, f"eval map50_95 {got['map50_95']} not in (0, 1)")
    print(f"eval: validate v5s@640 bf16 eval protocol, 4 batches of 64, launches "
          f"{counts}; {n_det} detections equal to the plain keep's (class exact, "
          f"score 1e-5, box 1e-3 px); metrics "
          + json.dumps({k: got[k] for k in EVAL_METRICS})
          + f" equal to 1e-9; validate wall {4 * 64 / wall_s:.1f} img/s "
          f"({wall_s * 1e3 / 4:.1f} ms a batch, upload and evaluator included) "
          f"on {smi}", flush=True)

    # f32 v5s@128 on the card against the CPU
    cfg_small = v5s_config()
    cfg_small.model.input_size = [128, 128]
    images = rng.integers(0, 255, (4, 128, 128, 3), dtype=np.uint8)
    steps = {}
    for dev in ("cpu", "cuda"):
        m = build_model(cfg_small, device=dev, dtype=torch.float32, seed=0)
        calibrate_head(m, 128, seed=1)
        steps[dev] = make_eval_step(m)
    dets, valid = steps["cpu"](images)
    batch = {"image": images, "count": 4,
             "info": [(128, 128, 1.0, (0.0, 0.0), i) for i in range(4)],
             "targets": pseudo_targets(dets.numpy(), valid.numpy(), (128, 128), rng)}
    runs = {}
    for dev, step in steps.items():
        step_outs = []
        summary = trainer.validate(recording(step, step_outs), [batch],
                                   DetEvaluator(COCO, img_size=128))
        runs[dev] = (host_detections(step_outs), summary)
    n_small = 0
    for w, g in zip(runs["cpu"][0], runs["cuda"][0]):
        check(same_detections(w, g, 1e-4, 1e-2),
              f"f32 eval card vs CPU detections differ ({len(w)} vs {len(g)})")
        n_small += len(w)
    for k in EVAL_METRICS:
        check(abs(runs["cuda"][1][k] - runs["cpu"][1][k]) <= 1e-6,
              f"f32 eval {k} card {runs['cuda'][1][k]!r} vs CPU {runs['cpu'][1][k]!r}")
    print(f"eval: f32 v5s@128 eval on the card equals the CPU run ({n_small} "
          f"detections; score 1e-4, box 1e-2 px; metrics to 1e-6)", flush=True)

    result = trainer.test(eval_step, batches[:1], evaluator)
    coco = result["coco"]
    check(all(np.isfinite(v) for v in coco.values()) and 0 < coco["map"] < 1,
          f"COCO metric set out of range: {coco}")
    print("eval: trainer.test on one batch, COCO-protocol metrics "
          + json.dumps(coco), flush=True)

    rec = run_eval_bench(model, batch=64, size=640, iters=10, warmup=3)
    print(f"eval: run_eval_bench v5s@640 b64 bf16, calibrated head: "
          f"{rec['value']:.1f} img/s ({rec['step_ms']:.3f} ms a batch, "
          f"{rec['detections']} detections in 10 batches) on {smi}; evaluator "
          f"update (host) {rec['evaluator_update_ms']:.2f} ms a batch, "
          f"{rec['evaluator_update_coco_ms']:.2f} ms with the COCO set", flush=True)

    topk_routes(model, frames[0], smi)
    print(f"eval: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def v7_config(deploy: bool, size: int = 640):
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "yolov7.yaml"))
    cfg.model.version, cfg.model.num_classes = "base", 80
    cfg.model.input_size = [size, size]
    cfg.model.deploy = deploy
    return cfg


def folded_v7(size: int, device: str):
    """v7 base in f32: the training structure with its BatchNorm statistics
    and head calibrated at `size`, and the deploy model loaded (strict)
    from its folded state_dict."""
    from vision_kit_tpu_torch.convert import deploy_state_dict
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.utils.stream_bench import calibrate_bn, calibrate_head

    train = build_model(v7_config(False, size), device=device, seed=0)
    calibrate_bn(train, size, seed=2)
    calibrate_head(train, size, seed=1)
    deploy = build_model(v7_config(True, size), device=device, seed=0)
    deploy.load_state_dict(deploy_state_dict(train.state_dict()), strict=True)
    return train, deploy


def phase_v7(rng, smi: str):
    """The v7 paths; returns the bf16 deploy model and the launches of its
    throughput run."""
    from vision_kit_tpu_torch.ops.head_scores import _check
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.utils.stream_bench import (
        run_detector_bench,
        run_eval_bench,
        same_detections,
    )

    t_phase = time.perf_counter()
    train, deploy = folded_v7(640, "cuda")
    x = torch.from_numpy(rng.integers(0, 255, (2, 640, 640, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        want, want_raws = train(x)
        got, got_raws = deploy(x)
    for raws in (want_raws, got_raws):
        _check(raws, None)      # contiguous NHWC views, 16-byte aligned
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=2e-3, atol=2e-3),
          f"v7 deploy output differs from the training structure's (max {err})")
    print(f"v7: base@640 f32, training structure with calibrated head, folded "
          f"by deploy_state_dict: decoded outputs of 2 frames equal to 2e-3 "
          f"(max abs diff {err:.3g}, values up to {float(want.abs().max()):.1f}); "
          "both structures' raw maps pass head_scores' layout check", flush=True)
    del train, want, got, want_raws, got_raws

    deploy = deploy.to(torch.bfloat16)
    with torch.inference_mode():
        _check(deploy(x, decode=False), None)
    pred = Predictor(deploy, img_size=640, device="cuda")
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
    check(counts == {"greedy_nms": 3, "head_scores": 3},
          f"v7 predict_batch launched {counts}, not each kernel once a request")
    n_det = 0
    with plain_kernels():
        for frames, got in zip(requests, outs):
            want, _ = pred.predict_batch(frames)
            for w, g in zip(want, got):
                check(g.shape[1:] == (6,) and np.isfinite(g).all(),
                      "non-finite or misshapen v7 detections")
                check(same_detections(w, g, 1e-5, 1e-3),
                      f"v7 detections differ from the plain path ({len(w)} vs {len(g)})")
                n_det += len(g)
    check(n_det > 0, "v7 predict_batch produced no detections")
    print(f"v7: Predictor.predict_batch base@640 bf16 deploy, 3 requests of "
          f"8x720x1280, launches {counts}; {n_det} detections equal to the "
          f"plain path's (class exact, score 1e-5, box 1e-3 px); last request "
          f"{ms:.1f} ms", flush=True)

    multi = Predictor(deploy, img_size=640, device="cuda", multi_label=True)
    multi.warmup((720, 1280), 8)
    reset_counts()
    got, _ = multi.predict_batch(requests[0])
    counts_multi = read_counts()
    check(counts_multi == {"greedy_nms": 1, "head_scores": 0},
          f"v7 multi-label predict_batch launched {counts_multi}")
    with plain_kernels():
        want, _ = multi.predict_batch(requests[0])
    for w, g in zip(want, got):
        check(same_detections(w, g, 1e-5, 1e-3), "v7 multi-label detections "
              f"differ from the plain path ({len(w)} vs {len(g)})")
    print(f"v7: multi-label predict_batch, one request, launches {counts_multi}; "
          f"{sum(len(g) for g in got)} detections equal to the plain path's",
          flush=True)

    # f32 v7 base@128, the same folded weights (calibrated on the CPU) on
    # the card and the CPU: network outputs to 1e-3, then Predictor's
    # detections. Boxes to 1e-2 px + 1e-4 of the box's longer side: the v7
    # size decode (2 sigmoid)^2 * anchor turns the ~5e-5 of f32 rounding in
    # a logit into ~0.02 px on the 459x401 anchor
    _, cpu_model = folded_v7(128, "cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(rng.integers(0, 255, (2, 128, 128, 3), dtype=np.uint8))
    with torch.inference_mode():
        want, want_raws = cpu_model(x)
        got, got_raws = card_model(x.cuda())
    errs = [float((g.cpu() - w).abs().max()) for g, w in
            zip([got, *got_raws], [want, *want_raws])]
    for g, w in zip([got, *got_raws], [want, *want_raws]):
        check(torch.allclose(g.cpu(), w, rtol=1e-3, atol=1e-3),
              f"f32 v7 card vs CPU outputs differ (max abs diffs {errs})")
    frames = rng.integers(0, 255, (2, 96, 160, 3), dtype=np.uint8)
    want, _ = Predictor(cpu_model, img_size=128, device="cpu").predict_batch(frames)
    got, _ = Predictor(card_model, img_size=128, device="cuda").predict_batch(frames)
    n_small = 0
    for w, g in zip(want, got):
        check(same_detections(w, g, 1e-4, 1e-2, 1e-4),
              f"f32 v7 card vs CPU detections differ ({len(w)} vs {len(g)})")
        n_small += len(w)
    check(n_small > 0, "small-input v7 reference produced no detections")
    print(f"v7: f32 base@128 (folded), same weights on the card and the CPU: "
          f"decoded output and raw maps equal to 1e-3 (max abs diffs "
          f"{', '.join(f'{e:.3g}' for e in errs)}), Predictor detections equal "
          f"({n_small}; score 1e-4, box 1e-2 px + 1e-4 of its longer side)",
          flush=True)
    del cpu_model, card_model

    lat = np.array([pred.predict_batch(requests[i % 3])[1] for i in range(100)])
    print(f"v7: request latency over {len(lat)} requests of 8x720x1280 (host "
          f"clock, upload to detections on the host): median "
          f"{np.median(lat):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
          f"min {lat.min():.3f} ms, max {lat.max():.3f} ms on {smi}", flush=True)

    reset_counts()
    rec = run_detector_bench(deploy, batch=64, size=640, iters=10, warmup=3)
    bench_counts = read_counts()
    for name, n in bench_counts.items():
        check(n > 0, f"v7 throughput path never launched {name}")
    print(f"v7: run_detector_bench base@640 b64 bf16 deploy, calibrated head: "
          f"{rec['value']:.1f} img/s ({rec['step_ms']:.3f} ms/step, "
          f"{rec['detections']} detections in 10 steps) on {smi}; launches "
          f"{bench_counts}", flush=True)

    reset_counts()
    rec = run_eval_bench(deploy, batch=64, size=640, iters=10, warmup=3)
    eval_counts = read_counts()
    check(eval_counts["greedy_nms"] > 0 and eval_counts["head_scores"] == 0,
          f"v7 eval path launched {eval_counts}")
    print(f"v7: run_eval_bench base@640 b64 bf16 deploy, calibrated head: "
          f"{rec['value']:.1f} img/s ({rec['step_ms']:.3f} ms a batch, "
          f"{rec['detections']} detections in 10 batches) on {smi}; evaluator "
          f"update (host) {rec['evaluator_update_ms']:.2f} ms a batch, "
          f"{rec['evaluator_update_coco_ms']:.2f} ms with the COCO set; "
          f"launches {eval_counts}", flush=True)
    print(f"v7: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return deploy, bench_counts


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
          f"CUDA {torch.version.cuda}, numpy {np.__version__}", flush=True)
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

    eval_counts = phase_eval(model, rng, smi)
    v7, v7_counts = phase_v7(rng, smi)

    from vision_kit_tpu_torch.train.step import make_eval_step
    from vision_kit_tpu_torch.utils.stream_bench import detector_step

    rows = kernel_times(head_max_err)
    anchors = torch.as_tensor(model.anchors_px, dtype=torch.float32, device="cuda")
    prof = profile_steps(model, lambda x: detector_step(model, x, anchors), batch=128)
    print("profile: v5s@640 b128 bf16, per step, device ms by kernel group: "
          + json.dumps(prof), flush=True)
    prof = profile_steps(model, make_eval_step(model), batch=64)
    print("profile: eval step v5s@640 b64 bf16, per step, device ms by kernel "
          "group: " + json.dumps(prof), flush=True)
    anchors = torch.as_tensor(v7.anchors_px, dtype=torch.float32, device="cuda")
    prof = profile_steps(v7, lambda x: detector_step(v7, x, anchors), batch=64)
    print("profile: v7 base@640 b64 bf16 deploy, per step, device ms by kernel "
          "group: " + json.dumps(prof), flush=True)
    prof = profile_steps(v7, make_eval_step(v7), batch=64)
    print("profile: eval step v7 base@640 b64 bf16 deploy, per step, device ms "
          "by kernel group: " + json.dumps(prof), flush=True)

    # each row counts the launches of the path whose shape it times:
    # predict_batch for greedy_nms and head_scores, validate for
    # greedy_nms_eval (validate launches no head_scores: checked), the v7
    # run_detector_bench for greedy_nms_v7 and head_scores_v7
    rows["greedy_nms"]["launches"] = counts["greedy_nms"]
    rows["head_scores"]["launches"] = counts["head_scores"]
    rows["greedy_nms_eval"]["launches"] = eval_counts["greedy_nms"]
    rows["greedy_nms_v7"]["launches"] = v7_counts["greedy_nms"]
    rows["head_scores_v7"]["launches"] = v7_counts["head_scores"]
    print(json.dumps({"kernels": list(rows.values())}))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
