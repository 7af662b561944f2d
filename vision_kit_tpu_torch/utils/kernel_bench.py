"""Kernel times on the card at the serving and eval paths' shapes, beside
an earlier design of the same kernels when one is given.

    python -m vision_kit_tpu_torch.utils.kernel_bench [--baseline DIR] [--json FILE]

Head scores run on 640-px head maps (3 levels of 80x80, 40x40 and
20x20, 255 channels, bf16: v5s's and v7 base's alike) at batch 128 (the
v5s throughput path, run_detector_bench), 64 (the v7 throughput path), 8
(the request path, Predictor.predict_batch), 4 (a rank's share of a
request on a 2-rank mesh) and 1 (a single-frame request, which a spatial
Predictor runs on the gathered maps on every rank), and anchor-major at
batch 128 (a decode_order="reference" model's permuted views of the same
maps; current design only); greedy NMS at B=128, K=512, B=64, K=512, B=8,
K=1024, B=4, K=1024 and B=1, K=1024 (the serving paths' batch and
max_cand) and at B=64, K=2048
(the eval step's), B=32, K=2048 (a rank's share of it on a 2-rank mesh)
and B=8, K=2048 (fit-host's validation), each on random, crowded and
all-invalid boxes. The batch-8, -4 and -1 maps (34, 17 and 4.3 MB) fit
the 50 MB L2, so the timing rotates 4 distinct inputs to read them from
device memory as the request path does; the b64 and b128 maps (274 and
548 MB) exceed the L2 on their own.

DIR holds an earlier design: greedy_nms.cu with the C entry
`greedy_nms_keep(boxes, valid, keep, B, K, thres, stream)` and
head_scores.py with `head_scores(raws, conf, classes)`. Each shape is then
timed in turns, earlier, current, current, earlier, in one process on one
card, and the two designs' outputs must agree. Prints one line per shape
and a JSON object last (also written to FILE).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import os
import re
import subprocess

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOP_S = 67e12      # f32 outside the tensor cores, H100 SXM
NMS_OPS_PER_PAIR = 14        # min/max x4, sub x3, clamp x3, mul, add, div, cmp
CONF = 0.25
IOU = 0.45
HEAD_BATCHES = (128, 64, 8, 4, 1)
NMS_SHAPES = ((128, 512), (64, 512), (8, 1024), (4, 1024), (1, 1024), (8, 2048),
              (32, 2048), (64, 2048))
NMS_CASES = ("random", "crowded", "all_invalid")


def time_ms(fn, reps: int = 20, warmup: int = 3, hold: bool = False) -> float:
    """Mean time of fn() over `reps` calls, by CUDA events. With `hold`, the
    card first sleeps about 50 ms so that the host has queued every call
    before the first one runs: the time is then the device's alone, without
    the gaps where the card waits for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int = 10) -> dict[str, float]:
    """Device time per call of each kernel that fn() launches, by name
    (torch.profiler, kernel events only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            found = re.search(r"(\w+)[<(]", e.key)
            name = found.group(1) if found else e.key[:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def make_boxes(rng, b, k, case, device="cuda"):
    """(B, K, 4) xyxy f32 in score order (class offset added) and (B, K)
    valid. `crowded` clusters boxes of two classes around a few centres;
    `grid` puts small integer boxes on a 16-px grid, where many IoUs are
    equal; `invalid_tail` marks the last third invalid, `all_invalid` every
    box."""
    if case == "crowded":
        centres = rng.uniform(50, 600, (b, 6, 2))
        pick = rng.integers(0, 6, (b, k))
        c = np.take_along_axis(centres, pick[..., None], axis=1)
        c = c + rng.normal(0, 6, (b, k, 2))
        wh = rng.uniform(30, 60, (b, k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
        boxes = boxes + rng.integers(0, 2, (b, k, 1)) * 7680.0
    elif case == "grid":
        x1y1 = rng.integers(0, 12, (b, k, 2))
        boxes = np.concatenate([x1y1, x1y1 + rng.integers(1, 6, (b, k, 2))], -1)
    else:
        x1y1 = rng.uniform(0, 600, (b, k, 2))
        wh = rng.uniform(10, 150, (b, k, 2))
        boxes = np.concatenate([x1y1, x1y1 + wh], -1)
    valid = np.ones((b, k), bool)
    if case == "invalid_tail":
        valid[:, k - k // 3:] = False
    elif case == "all_invalid":
        valid[:] = False
    return (torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device))


def nms_bound_ms(keep: torch.Tensor, valid: torch.Tensor) -> tuple[float, str, int]:
    """The least time for this greedy result: the IoU pairs it needs (each
    kept box against every valid later box) at the card's f32 rate, or the
    bytes (boxes and valid in, keep out) at its memory rate, the larger.
    Returns (ms, what bounds it, pairs)."""
    later_valid = valid.flip(1).cumsum(1).flip(1) - valid.long()
    pairs = int((later_valid * keep).sum())
    ops_ms = pairs * NMS_OPS_PER_PAIR / H100_F32_FLOP_S * 1e3
    bytes_ms = valid.numel() * (16 + 2) / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", pairs


V5S_640_GRIDS = ((80, 80), (40, 40), (20, 20))


def head_maps(gen, batch, dtype=torch.bfloat16, grids=V5S_640_GRIDS):
    """Raw head maps (B, ny, nx, 3, 85) on the card, one per level (ny, nx)
    of `grids`; logits ~ N(0, 2)."""
    return [(torch.randn(batch, ny, nx, 255, generator=gen, device="cuda") * 2)
            .to(dtype).view(batch, ny, nx, 3, 85) for ny, nx in grids]


def head_bound_ms(raws) -> float:
    """Bytes bound: every map read once, 8 bytes (score, class) written per
    anchor, at the card's memory rate."""
    n_out = sum(r.shape[0] * r.shape[1] * r.shape[2] * r.shape[3] for r in raws)
    nbytes = sum(r.numel() * r.element_size() for r in raws) + n_out * 8
    return nbytes / H100_BYTES_PER_S * 1e3


def head_scores_agree(got, want, conf: float = CONF) -> dict:
    """Compare (scores, classes) of a kernel with its plain version: classes
    exact; scores within rtol 1e-6 where both pass the conf gate, and a gate
    that differs only for a score within 1e-6 of conf. Raises on a
    difference; returns max_abs_err, the largest ulp distance and the gate
    flips."""
    (ks, kc), (rs, rc) = got, want
    if not torch.equal(kc, rc):
        raise RuntimeError("head_scores classes differ from the plain version")
    kv, rv = ks > -1, rs > -1
    flip = kv != rv
    if bool(flip.any()):
        near = torch.where(kv, ks, rs)[flip]
        if not bool(((near - conf).abs() <= 1e-6).all()):
            raise RuntimeError("head_scores gate differs away from conf")
    both = kv & rv
    if not torch.allclose(ks[both], rs[both], rtol=1e-6, atol=0):
        raise RuntimeError("head_scores scores differ beyond rtol 1e-6")
    if not bool(both.any()):
        return {"max_abs_err": 0.0, "ulp": 0, "flips": int(flip.sum())}
    return {"max_abs_err": float((ks[both] - rs[both]).abs().max()),
            "ulp": int((ks[both].view(torch.int32) - rs[both].view(torch.int32))
                       .abs().max()),
            "flips": int(flip.sum())}


def load_baseline(path: str):
    """(greedy_keep, head_scores) of the earlier design in `path`."""
    from vision_kit_tpu_torch import _cuda_build

    lib = ctypes.CDLL(_cuda_build.build("baseline_greedy_nms",
                                        os.path.join(path, "greedy_nms.cu")))
    fn = lib.greedy_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def greedy_keep(boxes, valid, thres):
        keep = torch.empty_like(valid)
        err = fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                 valid.shape[0], valid.shape[1], thres,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline greedy_nms_keep failed: {err}")
        return keep

    spec = importlib.util.spec_from_file_location(
        "baseline_head_scores", os.path.join(path, "head_scores.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return greedy_keep, mod.head_scores


def in_turns(designs: dict, timer) -> dict:
    """Time each design with timer(fn) in the order a, b, b, a; returns
    {name: [first, second]}."""
    names = list(designs)
    order = names + names[::-1]
    times = {n: [] for n in names}
    for n in order:
        times[n].append(timer(designs[n]))
    return times


def run(baseline: str | None = None) -> dict:
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep, greedy_keep_reference
    from vision_kit_tpu_torch.ops.head_scores import head_scores, head_scores_reference

    nms = {"current": greedy_keep}
    heads = {"current": head_scores}
    if baseline:
        old_nms, old_heads = load_baseline(baseline)
        nms = {"baseline": old_nms, **nms}
        heads = {"baseline": old_heads, **heads}
    out = {"card": card(), "device": torch.cuda.get_device_name(0),
           "head_scores": [], "greedy_nms": []}

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(b, False, heads) for b in HEAD_BATCHES]
    cases.append((128, True, {"current": head_scores}))
    for batch, anchor_major, designs in cases:
        n_sets = 1 if batch >= 32 else 4
        sets = [head_maps(gen, batch) for _ in range(n_sets)]
        if anchor_major:
            sets = [[r.permute(0, 3, 1, 2, 4) for r in raws] for raws in sets]
        kw = {"anchor_major": True} if anchor_major else {}
        ref = head_scores_reference(sets[0], CONF, **kw)
        for fn in designs.values():
            head_scores_agree(fn(sets[0], CONF, **kw), ref)

        def timer(fn, hold=True):
            it = itertools.cycle(sets)
            return time_ms(lambda: fn(next(it), CONF, **kw), reps=20 * n_sets,
                           hold=hold)

        times = in_turns(designs, timer)
        calls = in_turns(designs, lambda fn: timer(fn, hold=False))
        it = itertools.cycle(sets)
        plain = time_ms(lambda: head_scores_reference(next(it), CONF, **kw),
                        reps=4 * n_sets)
        split = kernel_ms(lambda: head_scores(next(it), CONF, **kw), reps=4 * n_sets)
        rec = {"batch": batch, "anchor_major": anchor_major, "distinct_inputs": n_sets,
               "bound_ms": head_bound_ms(sets[0]), "plain_ms": plain,
               **{f"{n}_ms": t for n, t in times.items()},
               **{f"{n}_call_ms": t for n, t in calls.items()}, "kernels_ms": split}
        out["head_scores"].append(rec)
        label = " anchor-major" if anchor_major else ""
        print(f"head_scores b{batch} bf16{label}, device: " + ", ".join(
            f"{n} {np.mean(t):.4f} ms ({t[0]:.4f}/{t[1]:.4f})" for n, t in times.items())
            + "; back-to-back calls: " + ", ".join(
            f"{n} {np.mean(t):.4f} ms" for n, t in calls.items())
            + f"; bound {rec['bound_ms']:.4f} ms, plain {plain:.4f} ms; "
            f"profiler {json.dumps(split)}", flush=True)
        del sets

    rng = np.random.default_rng(0)
    for b, k in NMS_SHAPES:
        for case in NMS_CASES:
            boxes, valid = make_boxes(rng, b, k, case)
            want = greedy_keep_reference(boxes, valid, IOU)
            for name, fn in nms.items():
                if not torch.equal(fn(boxes, valid, IOU), want):
                    raise RuntimeError(f"greedy_nms ({name}) differs from the "
                                       f"plain version at B={b} K={k} {case}")
            times = in_turns(nms, lambda fn: time_ms(lambda: fn(boxes, valid, IOU),
                                                     hold=True))
            calls = in_turns(nms, lambda fn: time_ms(lambda: fn(boxes, valid, IOU)))
            plain = time_ms(lambda: greedy_keep_reference(boxes, valid, IOU),
                            reps=2, warmup=1)
            split = kernel_ms(lambda: greedy_keep(boxes, valid, IOU))
            bound, bound_by, pairs = nms_bound_ms(want, valid)
            rec = {"batch": b, "k": k, "case": case, "kept": int(want.sum()),
                   "pairs": pairs, "bound_ms": bound, "bound_by": bound_by,
                   "plain_ms": plain, **{f"{n}_ms": t for n, t in times.items()},
                   **{f"{n}_call_ms": t for n, t in calls.items()},
                   "kernels_ms": split}
            out["greedy_nms"].append(rec)
            print(f"greedy_nms B={b} K={k} {case}, device: " + ", ".join(
                f"{n} {np.mean(t):.4f} ms ({t[0]:.4f}/{t[1]:.4f})"
                for n, t in times.items())
                + "; back-to-back calls: " + ", ".join(
                f"{n} {np.mean(t):.4f} ms" for n, t in calls.items())
                + f"; bound {bound:.5f} ms ({bound_by}), plain {plain:.3f} ms, "
                f"{rec['kept']} kept; profiler {json.dumps(split)}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="directory of an earlier design")
    parser.add_argument("--json", help="also write the JSON result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench measures on a CUDA device; none found")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run(args.baseline)
    print(out["card"], flush=True)
    text = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
