"""Detector throughput on the card: forward + raw-map postprocess.

Counterpart of vision_kit_tpu/utils/stream_bench.py:run_detector_bench.
uint8 frames go straight into the model (the stem normalises), then
postprocess_raw runs with the JAX bench's arguments. Timed with CUDA events
after warmup; the input is perturbed on every iteration so no step repeats
another's input.
"""

from __future__ import annotations

import numpy as np
import torch

from vision_kit_tpu_torch.ops.nms import postprocess_raw

POSTPROCESS_ARGS = dict(conf_thres=0.25, iou_thres=0.45, max_det=300,
                        max_cand=512, approx_topk=True)


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
    dev = next(model.parameters()).device
    if dev.type != "cuda":
        raise RuntimeError("run_detector_bench measures on a CUDA device; "
                           f"the model is on {dev}")
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
