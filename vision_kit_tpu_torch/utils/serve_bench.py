"""Serving-daemon benchmark: throughput and request latency of serve.py's
batching engine. Counterpart of tools/bench_serve.py, with the same
functions and return shapes.

  engine      bypass HTTP: feed pre-decoded requests straight into the
              dispatcher queue (bench_engine; bench_load_curve paces them
              at fractions of a capacity). Measures batching, dispatch,
              readback overlap and the device program.
  http        the whole localhost stack (decode, HTTP, engine) from
              concurrent clients (bench_http).

  python -m vision_kit_tpu_torch.utils.serve_bench --batch 64 --requests 1920
  python -m vision_kit_tpu_torch.utils.serve_bench --batch 8 --http
  python -m vision_kit_tpu_torch.utils.serve_bench --load-curve 900

The HTTP mode posts the committed sample JPEGs (data/samples/), since the
card's machine has no image encoder.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(_PKG, "data", "samples")


def samples() -> list[tuple[str, dict, bytes]]:
    """(file name, manifest entry, bytes) of each committed sample
    (data/samples/MANIFEST.json: sha256, bytes, kind, decoded shape or
    None where the decoders refuse it)."""
    with open(os.path.join(SAMPLES, "MANIFEST.json")) as f:
        manifest = json.load(f)
    out = []
    for name, meta in sorted(manifest["files"].items()):
        with open(os.path.join(SAMPLES, name), "rb") as f:
            out.append((name, meta, f.read()))
    return out


def sample_bytes(kind: str = "jpeg_720p") -> list[bytes]:
    """The committed samples of one kind."""
    return [data for _, meta, data in samples() if meta["kind"] == kind]


def cut_inside_last_scan(data: bytes) -> bytes:
    """A JPEG cut halfway through the entropy-coded bytes of its last scan
    and closed by an EOI marker. libjpeg decodes it (the missing bits read
    as zeros; in a progressive file the rows past the cut are smoothed),
    and its header still reads complete."""
    from vision_kit_tpu_torch.data import decode

    start, end = [(b, end) for m, _, b, end in decode._walk(data) if m == decode.SOS][-1]
    return data[:(start + end) // 2] + b"\xff\xd9"


def walk_cases() -> list[tuple[str, bytes]]:
    """(name, bytes) of every committed Huffman-coded JPEG that the decoders
    take, each also cut inside its last scan (cut_inside_last_scan), and
    the restart sample cut before every fourth RST marker of its scan: the
    files the C walk is held to scans_short on (arithmetic-coded and
    lossless JPEGs never reach it)."""
    from vision_kit_tpu_torch.data import decode

    out = []
    for name, meta, data in samples():
        if (not name.endswith(".jpg") or meta["shape"] is None
                or decode.jpeg_header(data)["sof"] not in decode.SOF_HUFFMAN):
            continue
        out += [(name, data), (name + " cut", cut_inside_last_scan(data))]
        if meta["kind"] == "jpeg_restart":
            start, end = [(b, e) for m, _, b, e in decode._walk(data) if m == decode.SOS][-1]
            body = np.frombuffer(data, np.uint8, end - start, start)
            ff = np.flatnonzero(body[:-1] == 0xFF)
            rst = [start + int(i) for i in ff if 0xD0 <= body[i + 1] <= 0xD7]
            out += [(f"{name} cut at RST {k}", data[:pos] + b"\xff\xd9")
                    for k, pos in enumerate(rst) if k % 4 == 1]
    return out


def walk_disagreements(cases, device="cuda") -> list[str]:
    """The C walk (decode.walk_scans_short) against scans_short on each
    case, and the route on `device` of a case that scans_short finds short
    and whose header would send it to nvJPEG: "host_cut". Empty when all
    agree."""
    from vision_kit_tpu_torch.data import decode

    bad = []
    for name, data in cases:
        want, got = decode.scans_short(data), decode.walk_scans_short(data)
        if got != want:
            bad.append(f"{name}: C walk {got}, scans_short {want}")
        route = decode.decode_route(data, device)
        if any(want) and decode.jpeg_colour(decode.jpeg_header(data)) in ("grey", "ycc") \
                and decode.jpeg_header(data)["complete"] and route != "host_cut":
            bad.append(f"{name}: short {want} but route {route}")
        if not any(want) and route == "host_cut":
            bad.append(f"{name}: whole but route host_cut")
    return bad


def build_server(variant: str, img: int, batch: int, max_wait_ms: float,
                 synthetic_ingest: int = 0, device: str = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
    """An InferenceServer on port 0 over YOLOv5 `variant` (80 classes,
    seeded weights) at `img`."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.serve import InferenceServer
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(_PKG), "configs", "yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = variant, 80
    cfg.model.input_size = [img, img]
    model = build_model(cfg, device=device, dtype=dtype, seed=0)
    predictor = Predictor(model, img_size=(img, img), device=device)
    return InferenceServer(
        predictor, batch_size=batch, max_wait_ms=max_wait_ms, port=0,
        queue_size=4096, synthetic_ingest=synthetic_ingest,
    )


class _TimedEvent(threading.Event):
    """Event that timestamps set(): per-request completion time is
    captured where it happens (the completion thread), not where the
    bench's sequential waiter observes it."""

    t_set = 0.0

    def set(self):
        self.t_set = time.perf_counter()
        super().set()


def _request_factory(server, frames=None):
    """Timed-_Request factory for the engine-mode benches: a seeded random
    frame on the server's device, or the given (S, S, 3) device frames in
    turn."""
    from vision_kit_tpu_torch.serve import _Request

    h, w = server.img_size
    if frames is None:
        frames = [torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (h, w, 3), np.uint8)).to(server.device)]

    def make(n):
        out = []
        for i in range(n):
            r = _Request(frames[i % len(frames)], 1.0, (0.0, 0.0), (h, w), None)
            r.event = _TimedEvent()
            out.append(r)
        return out

    return make


def _warmup(server, make, warmup_batches: int):
    """Fill the dispatch/readback pipeline before measuring."""
    reqs = make(warmup_batches * server.batch_size)
    for r in reqs:
        server._queue.put(r)
    for r in reqs:
        if not r.event.wait(600):
            raise RuntimeError("warmup timed out")
        if r.error is not None:
            raise RuntimeError(r.error)


def _wait_all(reqs, what: str):
    for r in reqs:
        if not r.event.wait(600):
            raise RuntimeError(f"request timed out ({what})")
        if r.error is not None:
            raise RuntimeError(r.error)


def bench_engine(server, n_requests: int, warmup_batches: int = 4, frames=None):
    """Feed _Requests directly; measure submit->completion throughput and
    per-request queue latency (submit -> completion event). Returns
    (img/s, p50 ms, p99 ms)."""
    make = _request_factory(server, frames)
    _warmup(server, make, warmup_batches)

    reqs = make(n_requests)
    t_submit = {}
    lat0 = time.perf_counter()

    def feed():
        for r in reqs:
            t_submit[id(r)] = time.perf_counter()
            server._queue.put(r)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    _wait_all(reqs, "engine")
    wall = time.perf_counter() - lat0
    feeder.join(timeout=60)
    lat = sorted((r.event.t_set - t_submit[id(r)]) * 1000 for r in reqs)
    n = len(lat)
    return n_requests / wall, lat[n // 2], lat[int(0.99 * n)]


def bench_load_curve(server, capacity_ips: float, fracs, n_requests: int,
                     warmup_batches: int = 4, frames=None):
    """Latency against offered load below saturation.

    For each fraction of the measured capacity, submissions are paced at
    that offered rate (10 ms submission ticks) and every request's submit
    -> completion latency is recorded where the completion thread sets the
    event. Returns [(frac, offered_ips, achieved_ips, p50_ms, p99_ms), ...].
    """
    make = _request_factory(server, frames)
    _warmup(server, make, warmup_batches)

    rows = []
    for frac in fracs:
        rate = capacity_ips * frac
        reqs = make(n_requests)
        t_submit = {}

        def feed():
            t0 = time.perf_counter()
            i = 0
            while i < len(reqs):
                due = int((time.perf_counter() - t0) * rate) + 1
                while i < min(due, len(reqs)):
                    t_submit[id(reqs[i])] = time.perf_counter()
                    server._queue.put(reqs[i])
                    i += 1
                time.sleep(0.01)

        t0 = time.perf_counter()
        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        _wait_all(reqs, f"load {frac}")
        wall = time.perf_counter() - t0
        feeder.join(timeout=60)
        lat = sorted((r.event.t_set - t_submit[id(r)]) * 1000 for r in reqs)
        n = len(lat)
        rows.append((frac, rate, n / wall, lat[n // 2], lat[int(0.99 * n)]))
        print(f"  load {frac:.0%}: offered {rate:.1f} img/s, achieved "
              f"{n / wall:.1f} img/s, p50 {lat[n // 2]:.1f} ms, "
              f"p99 {lat[int(0.99 * n)]:.1f} ms", flush=True)
    return rows


def bench_http(server, n_requests: int, concurrency: int = 32, payloads=None):
    """Concurrent clients POSTing encoded images over localhost (the
    committed 720p sample JPEGs unless `payloads` is given). Returns
    (img/s, p50 request ms, p99 request ms)."""
    import urllib.request

    payloads = payloads or sample_bytes("jpeg_720p")
    url = f"http://127.0.0.1:{server.port}/predict"

    def post(data):
        req = urllib.request.Request(url, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            json.loads(resp.read())

    post(payloads[0])  # warmup
    lat: list[float] = []
    mu = threading.Lock()
    # ceil so no requests are silently dropped; actual count is len(lat)
    per_thread = max(1, -(-n_requests // concurrency))
    errors: list[BaseException] = []

    def worker(k):
        try:
            for i in range(per_thread):
                t0 = time.perf_counter()
                post(payloads[(k + i) % len(payloads)])
                with mu:
                    lat.append(time.perf_counter() - t0)
        except BaseException as e:  # reported after the join
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"http bench failed: {errors[:1]}")
    lat.sort()
    n = len(lat)
    return n / wall, lat[n // 2] * 1000, lat[int(0.99 * n)] * 1000


def decode_ms(decode, payloads, device, reps: int = 3) -> float:
    """Host-clock ms of one `decode(data)` (decode_to, or
    decode_request_bytes with its letterbox), synchronised, averaged over
    the payloads and `reps` after one warm pass."""
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for data in payloads:
        decode(data)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        for data in payloads:
            decode(data)
    sync()
    return (time.perf_counter() - t0) * 1000 / (reps * len(payloads))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="s")
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--requests", type=int, default=1920)
    ap.add_argument("--http", action="store_true")
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--synthetic-ingest", type=int, default=0, metavar="K",
                    help="engine mode only: pre-stage K device batches and "
                    "rotate through them instead of copying request frames")
    ap.add_argument("--load-curve", default=None, metavar="CAPACITY_IPS",
                    type=float, help="pace submissions at --load-fracs "
                    "fractions of this measured capacity and report "
                    "submit->completion p50/p99 per point")
    ap.add_argument("--load-fracs", default="0.25,0.5,0.75")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.http and args.synthetic_ingest:
        ap.error("--synthetic-ingest is an engine-mode knob")
    if args.load_curve and args.http:
        ap.error("--load-curve is an engine-mode knob")

    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    server = build_server(args.variant, args.img, args.batch, args.max_wait_ms,
                          args.synthetic_ingest, device=args.device, dtype=dtype)
    t0 = time.perf_counter()
    server.start()
    print(f"warm in {time.perf_counter() - t0:.1f} s (v5{args.variant}@{args.img} "
          f"batch={args.batch})", flush=True)
    try:
        if args.http:
            ips, p50, p99 = bench_http(server, args.requests, args.concurrency)
            print(f"http: {ips:.1f} img/s  p50 {p50:.1f} ms  p99 {p99:.1f} ms  "
                  f"(decode+HTTP+engine, concurrency={args.concurrency})")
        elif args.load_curve:
            fracs = [float(x) for x in args.load_fracs.split(",")]
            rows = bench_load_curve(server, args.load_curve, fracs, args.requests)
            print(json.dumps({
                "mode": "load_curve", "batch": args.batch,
                "max_wait_ms": args.max_wait_ms, "capacity_ips": args.load_curve,
                "points": [{"frac": f, "offered_ips": o, "achieved_ips": a,
                            "p50_ms": p50, "p99_ms": p99}
                           for f, o, a, p50, p99 in rows]}))
        else:
            ips, p50, p99 = bench_engine(server, args.requests)
            mode = (f"synthetic device ingest K={args.synthetic_ingest}"
                    if args.synthetic_ingest else "request frames copied per batch")
            print(f"engine: {ips:.1f} img/s  req p50 {p50:.1f} ms  "
                  f"p99 {p99:.1f} ms  (batch={args.batch}, {mode})")
        dev = server.device
        print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    finally:
        server.stop()


if __name__ == "__main__":
    main()
