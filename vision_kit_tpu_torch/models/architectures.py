"""YOLOv5 assembly and the model factory, in PyTorch.

Counterpart of vision_kit_tpu/models/architectures.py. The model takes
NHWC images (uint8 0-255 or float 0-1), as the JAX model does, and runs
NCHW modules in channels_last memory: the NHWC -> NCHW step is a permute
view, no copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from vision_kit_tpu_torch.models.backbones import CSPDarknet
from vision_kit_tpu_torch.models.heads import YoloV5Head, head_bias_prior
from vision_kit_tpu_torch.models.necks import PAFPN
from vision_kit_tpu_torch.utils.general import dw_multiple_generator, resolve_device


class YOLOV5(nn.Module):
    """YOLOv5 n/s/m/l/x: CSPDarknet -> PAFPN -> YoloV5Head."""

    def __init__(self, variant: str = "s", act: str = "silu",
                 num_classes: int = 80, decode_order: str = "native"):
        super().__init__()
        wid_mul, dep_mul = dw_multiple_generator(variant)
        self.backbone = CSPDarknet(dep_mul, wid_mul, act=act)
        self.neck = PAFPN(dep_mul, wid_mul, self.backbone.out_chs, act=act)
        self.head = YoloV5Head(self.neck.out_chs, num_classes=num_classes,
                               decode_order=decode_order)

    def forward(self, x: torch.Tensor, decode: bool = True):
        """x: (B, H, W, 3) NHWC. Returns (decoded, raws), or the raws alone
        when decode=False (the serving path, which decodes only the
        candidates it keeps)."""
        feats = self.backbone(x.permute(0, 3, 1, 2))
        return self.head(self.neck(feats), decode=decode)

    @property
    def decode_order(self) -> str:
        return self.head.decode_order

    @property
    def strides(self) -> tuple[float, ...]:
        return self.head.stride

    @property
    def anchors_px(self) -> np.ndarray:
        """(nl, na, 2) pixel-unit anchors exactly as the eval decode uses
        them (for ops.nms.postprocess_raw)."""
        return self.head.grid_anchors * np.asarray(self.strides).reshape(-1, 1, 1)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: conv weights uniform(+-1/sqrt(fan_in)) (torch's Conv2d
    default family), BatchNorm to identity, head biases to the detection
    priors. Draws on the CPU from `generator`, so a seed gives the same
    weights on every device."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            w = torch.empty(mod.weight.shape).uniform_(-bound, bound,
                                                       generator=generator)
            mod.weight.copy_(w)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, YoloV5Head):
            for i, conv in enumerate(mod.m):
                prior = head_bias_prior(mod.stride[i], mod.na, mod.num_classes)
                conv.bias.copy_(torch.from_numpy(prior))


def build_model(cfg, device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32, seed: int = 0,
                decode_order: str = "native") -> nn.Module:
    """Build cfg.model in eval mode on `device`, in `dtype` and channels_last
    memory, with weights drawn from `seed`. Raises when `device` is CUDA and
    CUDA is absent."""
    device = resolve_device(device)
    name = cfg.model.name
    if name == "YOLOv7":
        raise NotImplementedError(
            "YOLOv7 is not ported yet (ROADMAP.md, Queue 1: YOLOv7 family)")
    if name != "YOLOv5":
        raise NotImplementedError(f"Unknown model {name!r}")
    with torch.device("meta"):
        model = YOLOV5(variant=cfg.model.version, act=cfg.model.act,
                       num_classes=cfg.model.num_classes,
                       decode_order=decode_order)
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype,
                     memory_format=torch.channels_last)
    return model.eval()
