"""Detection blocks of the YOLOv5 path in PyTorch (NCHW, channels_last).

Counterpart of vision_kit_tpu/models/layers.py. Submodule attribute names
mirror the torch keys that vision_kit_tpu's converter emits (a flax name
`m_0` is the torch path `m.0`), so one state_dict serves both packages.

BatchNorm uses eps 1e-3 and momentum 0.03, not torch's defaults.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry, same names as the JAX package."""
    acts = {
        "relu": F.relu,
        "relu6": lambda x: x.clamp(0.0, 6.0),
        "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "silu": F.silu,
        "hard_swish": F.hardswish,
        "none": lambda x: x,
    }
    if name not in acts:
        raise ValueError(f"Activation {name!r} not implemented")
    return acts[name]


def auto_pad(kernel: int, padding: int | None = None) -> int:
    return kernel // 2 if padding is None else padding


class ConvBnAct(nn.Module):
    """Conv + BN + activation.

    An integer input is an unnormalised 0-255 image: it is cast to the
    compute dtype (the conv weight's) and multiplied by 1/255 rounded to that
    dtype, as the JAX stem does. The JAX package's `s2d` stem is a TPU
    re-parameterisation of the same 6x6/s2 conv on the same (6,6,C,O)
    weight; here it is the plain conv.
    """

    def __init__(self, ins: int, outs: int, kernel: int = 1, stride: int = 1,
                 padding: int | None = None, groups: int = 1,
                 act: str = "silu"):
        super().__init__()
        p = auto_pad(kernel, padding)
        self.conv = nn.Conv2d(ins, outs, kernel, stride, p, groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(outs, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.conv.weight.dtype
        if not x.is_floating_point():
            # 1/255 rounded to the compute dtype, exact as a Python float
            scale = torch.tensor(1.0 / 255.0, dtype=dtype).item()
            x = x.to(dtype) * scale
        elif x.dtype != dtype:
            x = x.to(dtype)
        return self.act(self.bn(self.conv(x)))


def max_pool_same(x: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    """MaxPool with symmetric padding k//2 (padding never wins the max)."""
    return F.max_pool2d(x, kernel, stride, padding=kernel // 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class SPPF(nn.Module):
    """Fast SPP: three chained 5x5 maxpools."""

    def __init__(self, ins: int, outs: int, kernel: int = 5):
        super().__init__()
        hidden = ins // 2
        self.kernel = kernel
        self.conv1 = ConvBnAct(ins, hidden, 1, 1)
        self.conv2 = ConvBnAct(hidden * 4, outs, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        y1 = max_pool_same(x, self.kernel)
        y2 = max_pool_same(y1, self.kernel)
        y3 = max_pool_same(y2, self.kernel)
        return self.conv2(torch.cat([x, y1, y2, y3], dim=1))


class StandardBottleneck(nn.Module):
    """1x1 -> 3x3 with an optional residual."""

    def __init__(self, ins: int, outs: int, groups: int = 1,
                 expansion: float = 0.5, act: str = "silu",
                 shortcut: bool = True):
        super().__init__()
        hidden = int(outs * expansion)
        self.conv1 = ConvBnAct(ins, hidden, 1, 1, groups=groups, act=act)
        self.conv2 = ConvBnAct(hidden, outs, 3, 1, groups=groups, act=act)
        self.residual = shortcut and ins == outs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.residual else y


class C3Bottleneck(nn.Module):
    """CSP bottleneck with 3 convs."""

    def __init__(self, ins: int, outs: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, act: str = "silu"):
        super().__init__()
        hidden = int(outs * expansion)
        self.conv1 = ConvBnAct(ins, hidden, 1, 1, act=act)
        self.conv2 = ConvBnAct(ins, hidden, 1, 1, act=act)
        self.m = nn.Sequential(*[
            StandardBottleneck(hidden, hidden, expansion=1.0, act=act,
                               shortcut=shortcut)
            for _ in range(n)
        ])
        self.conv3 = ConvBnAct(2 * hidden, outs, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat([x1, x2], dim=1))
