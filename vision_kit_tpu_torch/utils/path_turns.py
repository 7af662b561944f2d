"""The v5s request path and `validate` of two checkouts of the repo, timed
in turns on one card, each run in a process of its own.

    python vision_kit_tpu_torch/utils/path_turns.py BASE NEW [--rounds 3] [--json FILE]

BASE and NEW are repo roots (for example an earlier commit unpacked with
`git archive`, and this checkout). Each round runs BASE, NEW, NEW, BASE.
A run imports the port from its own root only, builds chip_smoke.py's
main-path model (v5s@640, 80 classes, bf16, seed 0, calibrated head) and
measures on the host clock:

- request latency: `Predictor.predict_batch` on 8 frames of 720x1280,
  median and p99 over 200 warm requests (3 seeded requests in turn),
  beside the detections of the 3 requests (equal loads give equal counts);
- `validate` wall img/s: `trainer.validate` over 4 seeded batches of 64 at
  640 with the eval protocol (ground truth from a first pass, as
  chip_smoke's eval phase makes it), timed 3 times.

Prints one JSON line per run, then, for each root, each metric's values and
range, and whether the two roots' ranges overlap; the summary is the last
line (also written to FILE).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REQUESTS = 200
VALIDATE_REPEATS = 3


def measure(root: str) -> dict:
    """One run of the v5s request path and validate, with the port of
    `root`."""
    import numpy as np
    import torch

    from vision_kit_tpu_torch.classes import COCO
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.train import trainer
    from vision_kit_tpu_torch.train.evaluator import DetEvaluator
    from vision_kit_tpu_torch.train.step import make_eval_step
    from vision_kit_tpu_torch.utils import stream_bench
    from vision_kit_tpu_torch.utils.config import load_config

    if hasattr(stream_bench, "calibrate_head"):
        calibrate_head = stream_bench.calibrate_head
    else:   # a checkout that keeps calibrate_head in its chip_smoke.py
        from chip_smoke import calibrate_head

    cfg = load_config(os.path.join(root, "configs", "yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = "s", 80
    cfg.model.input_size = [640, 640]
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    calibrate_head(model, 640, seed=1)
    rng = np.random.default_rng(0)

    pred = Predictor(model, img_size=640, device="cuda")
    requests = [rng.integers(0, 255, (8, 720, 1280, 3), dtype=np.uint8)
                for _ in range(3)]
    pred.warmup((720, 1280), 8)
    n_det = sum(len(d) for frames in requests for d in pred.predict_batch(frames)[0])
    lat = np.array([pred.predict_batch(requests[i % 3])[1]
                    for i in range(REQUESTS)])

    eval_step = make_eval_step(model)
    batches = []
    for bi in range(4):
        images = rng.integers(0, 255, (64, 640, 640, 3), dtype=np.uint8)
        dets, valid = eval_step(images)
        batches.append({
            "image": images,
            "targets": stream_bench.pseudo_targets(
                dets.cpu().numpy(), valid.cpu().numpy(), (640, 640), rng),
            "info": [(640, 640, 1.0, (0.0, 0.0), 64 * bi + i) for i in range(64)],
            "count": 64})
    torch.cuda.synchronize()
    evaluator = DetEvaluator(COCO, img_size=640)
    validate = []
    for _ in range(VALIDATE_REPEATS):
        t0 = time.perf_counter()
        trainer.validate(eval_step, batches, evaluator)
        validate.append(4 * 64 / (time.perf_counter() - t0))
    return {"root": root,
            "request_detections": n_det,
            "latency_median_ms": float(np.median(lat)),
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "validate_img_s": validate}


def run_in_turns(base: str, new: str, rounds: int) -> dict:
    roots = {"base": os.path.abspath(base), "new": os.path.abspath(new)}
    runs = {"base": [], "new": []}
    for _ in range(rounds):
        for name in ("base", "new", "new", "base"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", roots[name]],
                cwd=roots[name], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"run in {roots[name]} failed:\n{proc.stderr[-4000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": name, **rec}), flush=True)
            runs[name].append(rec)

    def values(name, key):
        out = []
        for rec in runs[name]:
            v = rec[key]
            out.extend(v if isinstance(v, list) else [v])
        return out

    summary = {"roots": roots, "order": "base, new, new, base", "rounds": rounds}
    for key in ("latency_median_ms", "latency_p99_ms", "validate_img_s"):
        ranges = {}
        for name in ("base", "new"):
            v = values(name, key)
            ranges[name] = {"values": v, "min": min(v), "max": max(v)}
        summary[key] = {**ranges, "overlap": (
            ranges["base"]["min"] <= ranges["new"]["max"]
            and ranges["new"]["min"] <= ranges["base"]["max"])}
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        # import the port (and chip_smoke) of that root, not of this file's
        sys.path[0] = args.child
        print(json.dumps(measure(args.child)), flush=True)
        return 0
    if not (args.base and args.new):
        ap.error("BASE and NEW are needed")
    summary = run_in_turns(args.base, args.new, args.rounds)
    line = json.dumps(summary)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
