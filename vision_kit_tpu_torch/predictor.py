"""Batched predictor: uint8 frames in, detections in source-frame pixels out.

Counterpart of vision_kit_tpu/predictor.py:Predictor. Letterbox, forward,
the postprocess and the rescale/clip to the source frame all run on the
device; the only transfers are the frames in and the padded (max_det, 6)
result out. The postprocess is the raw-map one (with the port's two
kernels), or with multi_label the decoded-output one (ops/nms.py:postprocess,
with the greedy-NMS kernel).

As in the JAX predictor, the model gets the letterboxed image as float,
normalised by /255 in f32 (bench-style uint8 input, which the stem scales,
rounds differently; see utils/stream_bench.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vision_kit_tpu_torch.ops.letterbox import letterbox_device
from vision_kit_tpu_torch.ops.nms import postprocess, postprocess_raw
from vision_kit_tpu_torch.utils.general import resolve_device


class Predictor:
    def __init__(
        self,
        model,
        img_size: int | tuple[int, int] = 640,
        conf_thres: float = 0.25,
        iou_thres: float = 0.45,
        max_det: int = 300,
        max_cand: int = 1024,
        multi_label: bool = False,
        approx_topk: bool = True,
        mesh=None,
        spatial: bool = False,
        device: str | torch.device = "cuda",
    ):
        """model: a port YOLOV5 or YOLOV7 (moved to `device` here; a v7 in
        the training or the deploy structure). multi_label runs
        the model's decode and the decoded-output postprocess with every
        (anchor, class) pair a candidate. mesh/spatial are multi-chip
        serving, not ported yet; each raises if set. approx_topk is
        accepted; the top-k is exact (see ops/nms.py)."""
        if mesh is not None or spatial:
            raise NotImplementedError(
                "multi-chip serving (mesh/spatial) is not ported yet "
                "(ROADMAP.md, Queue 1: multi-GPU)")
        if not multi_label and model.decode_order != "native":
            raise ValueError("the serving path takes native-order raw maps; "
                             "build the model with decode_order='native'")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.img_size = (
            (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        )
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.max_cand = max_cand
        self.multi_label = multi_label
        self.approx_topk = approx_topk
        self.anchors_px = torch.as_tensor(model.anchors_px, dtype=torch.float32,
                                          device=self.device)
        self.strides = tuple(model.strides)

    @torch.inference_mode()
    def run(self, imgs_u8: torch.Tensor):
        """(B, H, W, 3) uint8 on the device -> (dets (B, max_det, 6),
        valid (B, max_det)) in source-frame pixels, without synchronising."""
        h0, w0 = imgs_u8.shape[1:3]
        x, (ratio, pad) = letterbox_device(imgs_u8, self.img_size)
        kwargs = dict(conf_thres=self.conf_thres, iou_thres=self.iou_thres,
                      max_det=self.max_det, max_cand=self.max_cand,
                      approx_topk=self.approx_topk)
        if self.multi_label:
            decoded, _ = self.model(x)
            dets, valid = postprocess(decoded, multi_label=True, **kwargs)
        else:
            raws = self.model(x, decode=False)
            dets, valid = postprocess_raw(raws, self.anchors_px,
                                          strides=self.strides, **kwargs)
        pad_t = torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                             dtype=torch.float32, device=self.device)
        hi = torch.tensor([w0, h0, w0, h0], dtype=torch.float32,
                          device=self.device)
        ratio_t = torch.tensor(ratio, dtype=torch.float32, device=self.device)
        boxes = (dets[..., :4] - pad_t) / ratio_t
        boxes = torch.minimum(boxes.clamp_min(0.0), hi)
        return torch.cat([boxes, dets[..., 4:]], dim=-1), valid

    def warmup(self, src_hw: tuple[int, int], batch: int = 1):
        """One run on zero frames of this shape (kernel builds, autotune)."""
        dummy = torch.zeros((batch, *src_hw, 3), dtype=torch.uint8,
                            device=self.device)
        dets, _ = self.run(dummy)
        dets.cpu()

    def __call__(self, img_rgb: np.ndarray):
        """img_rgb: HWC uint8. Returns (dets (n, 6) np [xyxy conf cls],
        elapsed_ms)."""
        dets, ms = self.predict_batch(np.asarray(img_rgb)[None])
        return dets[0], ms

    def predict_batch(self, imgs_rgb: np.ndarray):
        """imgs_rgb: (B, H, W, 3) uint8, one source resolution. Returns
        (list of (n_i, 6) arrays, elapsed_ms)."""
        imgs = torch.from_numpy(np.ascontiguousarray(imgs_rgb))
        t0 = time.perf_counter()
        dets, valid = self.run(imgs.to(self.device))
        dets = dets.cpu().numpy()
        valid = valid.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1000
        return [dets[i][valid[i]] for i in range(len(dets))], ms


def load_predictor_from_config(cfg, weights: str | None = None,
                               device: str | torch.device = "cuda",
                               dtype: torch.dtype = torch.float32,
                               seed: int = 0, **kwargs):
    """Build the config's model (YOLOv5, or YOLOv7 in the structure that
    cfg.model.deploy names) with weights drawn from `seed` and wrap it in a
    Predictor at cfg.model.input_size."""
    from vision_kit_tpu_torch.models import build_model

    if weights:
        raise NotImplementedError(
            "checkpoint loading is not ported yet; weights come from `seed`")
    model = build_model(cfg, device=device, dtype=dtype, seed=seed)
    return Predictor(model, img_size=tuple(cfg.model.input_size),
                     device=device, **kwargs)
