"""YOLOv5 and YOLOv7 assemblies and the model factory, in PyTorch.

Counterpart of vision_kit_tpu/models/architectures.py. A model takes NHWC
images (uint8 0-255 or float 0-1), as the JAX model does, and runs NCHW
modules in channels_last memory: the NHWC -> NCHW step is a permute view,
no copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from vision_kit_tpu_torch.models.backbones import CSPDarknet, V7Backbone
from vision_kit_tpu_torch.models.heads import YoloV5Head, YoloV7Head, head_bias_prior
from vision_kit_tpu_torch.models.layers import Implicit
from vision_kit_tpu_torch.models.necks import PAFPN, PAFPNELAN
from vision_kit_tpu_torch.utils.general import dw_multiple_generator, resolve_device


class Detector(nn.Module):
    """backbone -> neck -> head; what the serving and eval paths read of a
    model (decode_order, strides, anchors_px) comes from its head."""

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
        return self.head.anchors_px


class YOLOV5(Detector):
    """YOLOv5 n/s/m/l/x: CSPDarknet -> PAFPN -> YoloV5Head."""

    def __init__(self, variant: str = "s", act: str = "silu",
                 num_classes: int = 80, decode_order: str = "native"):
        super().__init__()
        wid_mul, dep_mul = dw_multiple_generator(variant)
        self.backbone = CSPDarknet(dep_mul, wid_mul, act=act)
        self.neck = PAFPN(dep_mul, wid_mul, self.backbone.out_chs, act=act)
        self.head = YoloV5Head(self.neck.out_chs, num_classes=num_classes,
                               decode_order=decode_order)


class YOLOV7(Detector):
    """YOLOv7 base/x: V7Backbone -> PAFPNELAN -> YoloV7Head. deploy builds
    the folded structure (RepConvs as one conv, no head implicits), which
    loads convert.deploy_state_dict of a training-structure state_dict."""

    def __init__(self, variant: str = "base", act: str = "silu",
                 num_classes: int = 80, deploy: bool = False,
                 decode_order: str = "native"):
        super().__init__()
        self.backbone = V7Backbone(variant, act=act)
        self.neck = PAFPNELAN(variant, self.backbone.out_chs, act=act,
                              deploy=deploy)
        self.head = YoloV7Head(self.neck.out_chs, num_classes=num_classes,
                               deploy=deploy, decode_order=decode_order)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: conv weights uniform(+-1/sqrt(fan_in)) (torch's Conv2d
    default family) and conv biases zero, BatchNorm to identity, implicit
    layers N(mean, 0.02), then head biases to the detection priors. Draws
    on the CPU from `generator`, so a seed gives the same weights on every
    device."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            w = torch.empty(mod.weight.shape).uniform_(-bound, bound,
                                                       generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, Implicit):
            w = torch.empty(mod.implicit.shape).normal_(mod.mean, mod.std,
                                                        generator=generator)
            mod.implicit.copy_(w)
    for mod in model.modules():
        if isinstance(mod, YoloV5Head):
            for i, conv in enumerate(mod.m):
                prior = head_bias_prior(mod.stride[i], mod.na, mod.num_classes)
                conv.bias.copy_(torch.from_numpy(prior))


def build_model(cfg, device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32, seed: int = 0,
                decode_order: str = "native") -> nn.Module:
    """Build cfg.model in eval mode on `device`, in `dtype` and channels_last
    memory, with weights drawn from `seed`. YOLOv7 takes `deploy` from
    cfg.model.deploy. Raises when `device` is CUDA and CUDA is absent."""
    device = resolve_device(device)
    name = cfg.model.name
    with torch.device("meta"):
        if name == "YOLOv5":
            model = YOLOV5(variant=cfg.model.version, act=cfg.model.act,
                           num_classes=cfg.model.num_classes,
                           decode_order=decode_order)
        elif name == "YOLOv7":
            model = YOLOV7(variant=cfg.model.version, act=cfg.model.act,
                           num_classes=cfg.model.num_classes,
                           deploy=bool(cfg.model.deploy),
                           decode_order=decode_order)
        else:
            raise NotImplementedError(f"Unknown model {name!r}")
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype,
                     memory_format=torch.channels_last)
    return model.eval()
