"""How cuDNN's settings move an f32 training step's rounding, by the rows a
call gets.

    python -m vision_kit_tpu_torch.utils.cudnn_probe [--json OUT]

On the card, one process: the v5s@640 f32 training step (YoloLoss,
stream_bench.TRAIN_HYP) of the ddp phase's seeded batch of 64
(stream_bench.mesh_step_disagreements' data), on rows 0-31, rows 32-63
and all 64, each under every setting below, against the float64 step on
the same rows (deterministic algorithms, channels_last). Each number is
stream_bench.worst_step_error: the step's worst error over the step
tolerance of tests/test_torch_train.py (1 is the tolerance).

Settings: torch's deterministic algorithms with cuDNN deterministic and
its autotuner off (the deterministic mode, what the data-parallel checks
run); the autotuner on (cudnn.benchmark, nothing deterministic); cuDNN's
default heuristics (nothing deterministic, no autotuner); and the first
and the second again with every activation channels-first (contiguous
NCHW) in place of channels_last. TF32 is off throughout.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

SETTINGS = {
    # name: (deterministic algorithms, cudnn.deterministic, cudnn.benchmark,
    #        channels-first)
    "deterministic": (True, True, False, False),
    "benchmark": (False, False, True, False),
    "heuristics": (False, False, False, False),
    "deterministic_channels_first": (True, True, False, True),
    "benchmark_channels_first": (False, False, True, True),
}


def _apply(setting) -> None:
    algorithms, det, bench, _ = setting
    torch.use_deterministic_algorithms(algorithms)
    torch.backends.cudnn.deterministic = det
    torch.backends.cudnn.benchmark = bench
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def worst_tensors(want: dict, got: dict, before: dict, n: int = 3) -> list:
    """The n tensors of worst error over stream_bench.worst_step_error's
    tolerance: [part, name, ratio, |error|, max |value|, max |change|]."""
    rows = []
    for part in want:
        for k, w in want[part].items():
            scale, change = float(w.abs().max()), float((w - before[part][k]).abs().max())
            err = float((got[part][k] - w).abs().max())
            rows.append([part, k, err / (1e-4 * scale + 2e-3 * change + 1e-7), err, scale,
                         change])
    return sorted(rows, key=lambda r: -r[2])[:n]


def probe(batch: int = 64, seed: int = 0, device: str = "cuda", size: int = 640,
          version: str = "s") -> dict:
    """{setting: {rows: worst error of the f32 step against float64}} for
    the batch's first half, second half and whole, and each f32 step's
    loss. (device, size and version other than the card's v5s@640 serve a
    rehearsal on the CPU, where cuDNN's settings change nothing.)"""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.train.optim import make_optimizer
    from vision_kit_tpu_torch.train.step import create_train_state, make_train_step
    from vision_kit_tpu_torch.utils import stream_bench as sb
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "configs", "yolov5.yaml"))
    cfg.model.update(version=version, num_classes=80, input_size=[size, size])
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8))
    targets = torch.from_numpy(sb.bench_targets(rng, batch))
    model = build_model(cfg, device=device, seed=seed)
    half = batch // 2
    rows_of = {f"rows 0-{half - 1}": (0, half), f"rows {half}-{batch - 1}": (half, batch),
               f"rows 0-{batch - 1}": (0, batch)}
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def step(dtype, rows, channels_first):
        model.load_state_dict(start)
        # cuDNN takes channels_last when the input or the weight is: both go
        model.to(dtype, memory_format=torch.contiguous_format if channels_first
                 else torch.channels_last)
        hook = (model.backbone.register_forward_pre_hook(lambda m, a: (a[0].contiguous(),))
                if channels_first else None)
        try:
            tx = make_optimizer(model, sb.TRAIN_HYP, 3, 10)
            state = create_train_state(model, tx)
            before = sb.train_state_tensors(state)
            loss = YoloLoss(80, model.head.grid_anchors, sb.TRAIN_HYP, layout="native")
            lo, hi = rows
            data = {"image": images[lo:hi].to(device), "targets": targets[lo:hi].to(device)}
            state, metrics = make_train_step(model, loss, tx)(state, data)
            out = sb.train_state_tensors(state), float(metrics["loss"]), before
        finally:
            if hook is not None:
                hook.remove()
        del state, tx
        if device != "cpu":
            torch.cuda.empty_cache()
        return out

    _apply(SETTINGS["deterministic"])
    referee = {name: step(torch.float64, rows, False) for name, rows in rows_of.items()}
    out = {"worst": {}, "loss": {}, "worst_tensors": {}}
    for sname, setting in SETTINGS.items():
        _apply(setting)
        out["worst"][sname], out["loss"][sname], out["worst_tensors"][sname] = {}, {}, {}
        for rname, rows in rows_of.items():
            got, loss, _ = step(torch.float32, rows, setting[3])
            want, _, before = referee[rname]
            out["worst"][sname][rname] = sb.worst_step_error(want, got, before)
            out["worst_tensors"][sname][rname] = worst_tensors(want, got, before)
            out["loss"][sname][rname] = loss
        print(f"cudnn_probe: {sname}: " + ", ".join(
            f"{r} {v:.3f}x" for r, v in out["worst"][sname].items()), flush=True)
    out["referee_loss"] = {r: v[1] for r, v in referee.items()}
    return out


def main(argv=None) -> int:
    from vision_kit_tpu_torch.utils.general import CUBLAS_WORKSPACE_CONFIG
    from vision_kit_tpu_torch.utils.kernel_bench import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the numbers here too")
    args = ap.parse_args(argv)
    # deterministic algorithms need it before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    if not torch.cuda.is_available():
        raise SystemExit("cudnn_probe measures on a CUDA device; none found")
    out = {"card": card(), "cudnn": torch.backends.cudnn.version(),
           "torch": torch.__version__, **probe()}
    print(out["card"], flush=True)
    text = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
