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

    python vision_kit_tpu_torch/utils/path_turns.py BASE NEW --contention [--json FILE]

measures instead the server's HTTP load beside a client of heavy host
decodes (http_contention, which chip_smoke.py's serve phase also runs): the
same model behind InferenceServer (batch 8, max_wait 5 ms), 32 clients
POSTing the 720x1280 sample JPEGs for 10 s alone, then for 10 s while one
more client POSTs the 2048x2048 lossy WebP sample (of this file's
checkout) in a loop: request p50 and p99 of the JPEG load in both runs,
and the WebP client's answered decodes.
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


CONTENTION_S, CONTENTION_CLIENTS = 10.0, 32
HEAVY_SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "data", "samples", "large_2048x2048.webp")


def http_contention(port: int, seconds: float, jpegs: list, heavy: bytes | None = None,
                    clients: int = CONTENTION_CLIENTS) -> dict:
    """`clients` threads POST `jpegs` in turn to 127.0.0.1:`port`/predict
    for `seconds`, each request answered before its next; with `heavy`,
    one more thread POSTs it in a loop over the same window. Returns the
    JPEG requests' count, img/s, p50 and p99 ms (host clock), the heavy
    client's answered decodes and their median ms. Any failed request
    raises."""
    import threading
    import urllib.request

    import numpy as np

    url = f"http://127.0.0.1:{port}/predict"

    def post(data):
        req = urllib.request.Request(url, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            json.loads(resp.read())

    post(jpegs[0])
    if heavy is not None:
        post(heavy)   # the decode path warm, not timed
    lat, heavy_ms, errors = [], [], []
    mu = threading.Lock()
    stop = time.perf_counter() + seconds

    def client(k):
        i = k
        try:
            while time.perf_counter() < stop:
                t0 = time.perf_counter()
                post(jpegs[i % len(jpegs)])
                with mu:
                    lat.append(time.perf_counter() - t0)
                i += 1
        except BaseException as e:   # reported after the join
            errors.append(e)

    def heavy_client():
        try:
            while time.perf_counter() < stop:
                t0 = time.perf_counter()
                post(heavy)
                heavy_ms.append((time.perf_counter() - t0) * 1e3)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    if heavy is not None:
        threads.append(threading.Thread(target=heavy_client))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"contention load failed: {errors[:1]}")
    lat = np.sort(np.array(lat)) * 1e3
    return {"requests": len(lat), "img_s": len(lat) / wall,
            "p50_ms": float(lat[len(lat) // 2]), "p99_ms": float(lat[int(0.99 * len(lat))]),
            "heavy_decodes": len(heavy_ms),
            "heavy_median_ms": float(np.median(heavy_ms)) if heavy_ms else None}


def measure_contention(root: str, heavy_path: str) -> dict:
    """One run of http_contention alone and beside the heavy client, with the
    port of `root` serving chip_smoke's main-path model."""
    import glob

    import torch

    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.serve import InferenceServer
    from vision_kit_tpu_torch.utils import stream_bench
    from vision_kit_tpu_torch.utils.config import load_config

    if hasattr(stream_bench, "calibrate_head"):
        calibrate_head = stream_bench.calibrate_head
    else:
        from chip_smoke import calibrate_head

    cfg = load_config(os.path.join(root, "configs", "yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = "s", 80
    cfg.model.input_size = [640, 640]
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    calibrate_head(model, 640, seed=1)
    jpegs = []
    for path in sorted(glob.glob(os.path.join(root, "vision_kit_tpu_torch", "data",
                                              "samples", "frame*_720x1280_420_q90.jpg"))):
        with open(path, "rb") as f:
            jpegs.append(f.read())
    with open(heavy_path, "rb") as f:
        heavy = f.read()
    server = InferenceServer(Predictor(model, img_size=640, device="cuda"), batch_size=8,
                             max_wait_ms=5.0, port=0, queue_size=4096)
    server.start()
    try:
        pool = getattr(server, "_pool", None)   # none in a checkout without the pool
        pool_size = pool.size if pool is not None else 0
        alone = http_contention(server.port, CONTENTION_S, jpegs)
        beside = http_contention(server.port, CONTENTION_S, jpegs, heavy)
    finally:
        server.stop()
    return {"root": root, "alone": alone, "beside_heavy": beside, "pool_size": pool_size}


def run_in_turns(base: str, new: str, rounds: int, contention: bool = False) -> dict:
    roots = {"base": os.path.abspath(base), "new": os.path.abspath(new)}
    runs = {"base": [], "new": []}
    for _ in range(rounds):
        for name in ("base", "new", "new", "base"):
            child = ["--child", roots[name]] + (["--contention"] if contention else [])
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), *child],
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
    if contention:
        for name in ("base", "new"):
            for rec in runs[name]:
                rec["p50_ratio"] = rec["beside_heavy"]["p50_ms"] / rec["alone"]["p50_ms"]
        keys = ("p50_ratio",)
        summary["runs"] = runs
    else:
        keys = ("latency_median_ms", "latency_p99_ms", "validate_img_s")
    for key in keys:
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
    ap.add_argument("--contention", action="store_true",
                    help="the HTTP load alone and beside a heavy host-decode client")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        # import the port (and chip_smoke) of that root, not of this file's
        sys.path[0] = args.child
        rec = (measure_contention(args.child, HEAVY_SAMPLE) if args.contention
               else measure(args.child))
        print(json.dumps(rec), flush=True)
        return 0
    if not (args.base and args.new):
        ap.error("BASE and NEW are needed")
    summary = run_in_turns(args.base, args.new, args.rounds, args.contention)
    line = json.dumps(summary)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
