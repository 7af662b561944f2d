"""Detection blocks of YOLOv5 and YOLOv7 in PyTorch (NCHW, channels_last).

Counterpart of vision_kit_tpu/models/layers.py. Flax infers a block's
input channels, torch does not: each block here takes `ins` first and
reproduces the JAX block's channel arithmetic. Submodule attribute names
mirror the torch keys that vision_kit_tpu's converter emits (a flax name
`m_0` is the torch path `m.0`), so one state_dict serves both packages.

BatchNorm uses eps 1e-3 and momentum 0.03, not torch's defaults.
"""

from __future__ import annotations

from typing import Callable, Sequence

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


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBn(nn.Module):
    """Conv + BN, no activation."""

    def __init__(self, ins: int, outs: int, kernel: int = 1, stride: int = 1,
                 padding: int | None = None, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(ins, outs, kernel, stride, auto_pad(kernel, padding),
                              groups=groups, bias=False)
        self.bn = batch_norm(outs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


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
        self.bn = batch_norm(outs)
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


class DWConvModule(nn.Module):
    """Depthwise conv followed by a pointwise conv."""

    def __init__(self, ins: int, outs: int, kernel: int, stride: int = 1,
                 act: str = "silu"):
        super().__init__()
        self.dconv = ConvBnAct(ins, ins, kernel, stride, groups=ins, act=act)
        self.pconv = ConvBnAct(ins, outs, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pconv(self.dconv(x))


class DWConv(nn.Module):
    """Depthwise Conv + BN + act, groups == ins (outs a multiple of ins)."""

    def __init__(self, ins: int, outs: int, kernel: int = 1, stride: int = 1,
                 act: str = "silu"):
        super().__init__()
        self.conv = ConvBnAct(ins, outs, kernel, stride, groups=ins, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class DWConvTranspose2d(nn.ConvTranspose2d):
    """Depthwise transposed conv, groups == ins, with a bias.

    The JAX block keeps a (k, k, 1, O) kernel, which the weight bridge
    carries over as (O, 1, k, k); torch's grouped transposed conv holds it
    as (ins, O/ins, k, k), the same numbers in the same order, so a weight
    of exactly the bridged shape is reshaped on load (any other shape is
    refused as usual)."""

    def __init__(self, ins: int, outs: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0, padding_out: int = 0):
        super().__init__(ins, outs, kernel, stride, padding, padding_out,
                         groups=ins, bias=True)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        w = state_dict.get(key)
        if w is not None and tuple(w.shape) == (self.out_channels, 1, *self.kernel_size):
            state_dict[key] = w.reshape(self.weight.shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    """MaxPool with symmetric padding k//2 (padding never wins the max)."""
    return F.max_pool2d(x, kernel, stride, padding=kernel // 2)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool k=2 s=2, no padding."""
    return F.max_pool2d(x, 2, 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Concat(nn.Module):
    """Channel concat as a module (dim 1, the NHWC layout's last axis)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, xs) -> torch.Tensor:
        return torch.cat(list(xs), dim=self.dim)


class MP(nn.Module):
    """MaxPool k=k s=k, no padding."""

    def __init__(self, kernel: int = 2):
        super().__init__()
        self.kernel = kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.kernel, self.kernel)


class SP(nn.Module):
    """'Same' MaxPool, padding k//2."""

    def __init__(self, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_same(x, self.kernel, self.stride)


class Focus(nn.Module):
    """Space-to-depth stem: patches (top-left, bottom-left, top-right,
    bottom-right) concatenated on channels, then ConvBnAct."""

    def __init__(self, ins: int, outs: int, kernel: int = 1, stride: int = 1,
                 act: str = "silu"):
        super().__init__()
        self.conv = ConvBnAct(4 * ins, outs, kernel, stride, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tl = x[:, :, ::2, ::2]
        bl = x[:, :, 1::2, ::2]
        tr = x[:, :, ::2, 1::2]
        br = x[:, :, 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], dim=1))


class SPP(nn.Module):
    """Spatial pyramid pooling over parallel 'same' maxpools."""

    def __init__(self, ins: int, outs: int, kernels: Sequence[int] = (5, 9, 13),
                 act: str = "silu"):
        super().__init__()
        hidden = ins // 2
        self.kernels = tuple(kernels)
        self.conv1 = ConvBnAct(ins, hidden, 1, 1, act=act)
        self.conv2 = ConvBnAct(hidden * (len(self.kernels) + 1), outs, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        pools = [max_pool_same(x, k) for k in self.kernels]
        return self.conv2(torch.cat([x] + pools, dim=1))


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


class SPPCSPC(nn.Module):
    """CSP-style SPP of the YOLOv7 neck. The convs are named in the JAX
    block's (and the reference's) order, not in the order they run."""

    def __init__(self, ins: int, outs: int, groups: int = 1,
                 epsilon: float = 0.5, kernels: Sequence[int] = (5, 9, 13),
                 act: str = "silu"):
        super().__init__()
        hidden = int(2 * outs * epsilon)
        self.kernels = tuple(kernels)

        def cba(i, o, k):
            return ConvBnAct(i, o, k, 1, groups=groups, act=act)

        self.conv1 = cba(ins, hidden, 1)
        self.conv2 = cba(ins, hidden, 1)
        self.conv3 = cba(hidden, hidden, 3)
        self.conv4 = cba(hidden, hidden, 1)
        self.conv5 = cba(hidden * (len(self.kernels) + 1), hidden, 1)
        self.conv6 = cba(hidden, hidden, 3)
        self.conv7 = cba(2 * hidden, outs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv4(self.conv3(self.conv1(x)))
        pools = [max_pool_same(x1, k) for k in self.kernels]
        y1 = self.conv6(self.conv5(torch.cat([x1] + pools, dim=1)))
        y2 = self.conv2(x)
        return self.conv7(torch.cat([y1, y2], dim=1))


class RepConv(nn.Module):
    """RepVGG-style 3x3 conv. Training form: 3x3 ConvBn + 1x1 ConvBn, plus
    an identity BN when ins == outs and stride 1, summed, then the
    activation. Deploy form: one 3x3 conv with a bias (`rbr_reparam`),
    folded from the training form by convert.deploy_state_dict."""

    def __init__(self, ins: int, outs: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: str = "silu", deploy: bool = False):
        super().__init__()
        if kernel != 3:
            raise ValueError(f"RepConv takes a 3x3 kernel, not {kernel}")
        self.act = get_act(act)
        self.deploy = deploy
        if deploy:
            self.rbr_reparam = nn.Conv2d(ins, outs, 3, stride, 1, groups=groups,
                                         bias=True)
            return
        self.rbr_dense = ConvBn(ins, outs, 3, stride, groups=groups)
        self.rbr_1x1 = ConvBn(ins, outs, 1, stride, padding=0, groups=groups)
        self.rbr_identity = (batch_norm(ins) if ins == outs and stride == 1
                             else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return self.act(self.rbr_reparam(x))
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return self.act(y)


class StandardBottleneck(nn.Module):
    """1x1 -> 3x3 with an optional residual; with depthwise the 3x3 is a
    DWConvModule."""

    def __init__(self, ins: int, outs: int, groups: int = 1,
                 expansion: float = 0.5, act: str = "silu",
                 shortcut: bool = True, depthwise: bool = False):
        super().__init__()
        hidden = int(outs * expansion)
        self.conv1 = ConvBnAct(ins, hidden, 1, 1, groups=groups, act=act)
        if depthwise:
            self.conv2 = DWConvModule(hidden, outs, 3, 1, act=act)
        else:
            self.conv2 = ConvBnAct(hidden, outs, 3, 1, groups=groups, act=act)
        self.residual = shortcut and ins == outs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.residual else y


class C3Bottleneck(nn.Module):
    """CSP bottleneck with 3 convs."""

    def __init__(self, ins: int, outs: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, act: str = "silu",
                 depthwise: bool = False):
        super().__init__()
        hidden = int(outs * expansion)
        self.conv1 = ConvBnAct(ins, hidden, 1, 1, act=act)
        self.conv2 = ConvBnAct(ins, hidden, 1, 1, act=act)
        self.m = nn.Sequential(*[
            StandardBottleneck(hidden, hidden, expansion=1.0, act=act,
                               shortcut=shortcut, depthwise=depthwise)
            for _ in range(n)
        ])
        self.conv3 = ConvBnAct(2 * hidden, outs, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat([x1, x2], dim=1))


class ELAN(nn.Module):
    """E-ELAN aggregation block.

    conv1 and conv2 take the input to `hidden_chs` (h); each later 3x3 conv
    writes h2 channels, h2 = h/2 when hidden_chs == outs, else h. The
    concatenation, which last_conv takes to `outs`:
      depth 2: [x4, x3, x2, x1]
      depth 4: [x6, x4, x2, x1], or all six [x6..x1] when hidden_chs == outs
      depth 6: [x8, x6, x4, x2, x1]
    """

    def __init__(self, ins: int, hidden_chs: int, outs: int,
                 act: str = "silu", depth: int = 2):
        super().__init__()
        if depth not in (2, 4, 6):
            raise ValueError(f"ELAN depth must be 2, 4 or 6, not {depth}")
        h = hidden_chs
        h2 = h // 2 if h == outs else h
        self.depth = depth
        self.all_six = depth == 4 and hidden_chs == outs
        self.conv1 = ConvBnAct(ins, h, 1, 1, act=act)
        self.conv2 = ConvBnAct(ins, h, 1, 1, act=act)
        self.conv3 = ConvBnAct(h, h2, 3, 1, act=act)
        for i in range(4, depth + 3):
            setattr(self, f"conv{i}", ConvBnAct(h2, h2, 3, 1, act=act))
        n_h2 = {2: 2, 4: 4 if self.all_six else 2}.get(depth, 3)
        self.last_conv = ConvBnAct(2 * h + n_h2 * h2, outs, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = [self.conv1(x), self.conv2(x)]       # x1, x2
        for i in range(3, self.depth + 3):        # x3 .. x_{depth+2}
            xs.append(getattr(self, f"conv{i}")(xs[-1]))
        if self.depth == 2 or self.all_six:
            concat = xs[::-1]
        else:                                     # x_{depth+2}, ..., x4, x2, x1
            concat = xs[:1:-2] + [xs[1], xs[0]]
        return self.last_conv(torch.cat(concat, dim=1))


class MPx3Conv(nn.Module):
    """Downsampling fork: maxpool + 1x1, and 1x1 + 3x3/s2. Returns
    (conv branch, pool branch)."""

    def __init__(self, ins: int, outs: int, act: str = "silu"):
        super().__init__()
        self.conv1 = ConvBnAct(ins, outs, 1, 1, act=act)
        self.conv2 = ConvBnAct(ins, outs, 1, 1, act=act)
        self.conv3 = ConvBnAct(outs, outs, 3, 2, act=act)

    def forward(self, x: torch.Tensor):
        x1 = self.conv1(max_pool_2x2(x))
        x3 = self.conv3(self.conv2(x))
        return x3, x1


class Implicit(nn.Module):
    """Implicit knowledge: a learned (1, C, 1, 1) added (ops "add", drawn
    around 0) or multiplied (ops "multiply", drawn around 1)."""

    def __init__(self, channel: int, ops: str = "add", std: float = 0.02):
        super().__init__()
        if ops not in ("add", "multiply"):
            raise ValueError(f"Implicit ops {ops!r}")
        self.ops = ops
        self.std = std
        self.mean = 0.0 if ops == "add" else 1.0
        self.implicit = nn.Parameter(torch.full((1, channel, 1, 1), self.mean))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ops == "add":
            return x + self.implicit
        return x * self.implicit
