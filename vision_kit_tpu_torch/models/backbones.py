"""Backbones: CSPDarknet (YOLOv5) and the E-ELAN backbone (YOLOv7), in
PyTorch.

Counterparts of vision_kit_tpu/models/backbones.py. Each returns the
(P3, P4, P5) features at strides 8/16/32 and carries their channels as
`out_chs`.
"""

from __future__ import annotations

import torch
from torch import nn

from vision_kit_tpu_torch.models.layers import (
    ELAN,
    SPP,
    SPPF,
    C3Bottleneck,
    ConvBnAct,
    DWConvModule,
    Focus,
    MPx3Conv,
)


class CSPDarknet(nn.Module):
    """Width/depth scaled by the v5 multipliers; 6x6/s2 conv stem (Focus
    with `with_focus`), SPPF tail on stage4 (SPP then a C3 without shortcut
    with `with_focus`); `depthwise` makes the strided convs and the
    bottlenecks' 3x3 convs DWConvModules."""

    def __init__(self, depth_mul: float, width_mul: float, act: str = "silu",
                 in_chs: int = 3, depthwise: bool = False,
                 with_focus: bool = False):
        super().__init__()
        b = int(width_mul * 64)
        d = max(round(depth_mul * 3), 1)

        def conv(ins, outs):
            if depthwise:
                return DWConvModule(ins, outs, 3, 2, act=act)
            return ConvBnAct(ins, outs, 3, 2, act=act)

        def c3(ch, n, shortcut=True):
            return C3Bottleneck(ch, ch, n=n, shortcut=shortcut, act=act,
                                depthwise=depthwise)

        if with_focus:
            self.stem = Focus(in_chs, b, kernel=3, act=act)
        else:
            self.stem = ConvBnAct(in_chs, b, 6, 2, 2)
        self.stage1 = nn.Sequential(conv(b, b * 2), c3(b * 2, d))
        self.stage2 = nn.Sequential(conv(b * 2, b * 4),
                                    c3(b * 4, d * 3 if with_focus else d * 2))
        self.stage3 = nn.Sequential(conv(b * 4, b * 8), c3(b * 8, d * 3))
        if with_focus:
            self.stage4 = nn.Sequential(conv(b * 8, b * 16),
                                        SPP(b * 16, b * 16, act=act),
                                        c3(b * 16, d, shortcut=False))
        else:
            self.stage4 = nn.Sequential(conv(b * 8, b * 16), c3(b * 16, d),
                                        SPPF(b * 16, b * 16, kernel=5))
        self.out_chs = (b * 4, b * 8, b * 16)

    def forward(self, x: torch.Tensor):
        c2 = self.stage1(self.stem(x))
        c3 = self.stage2(c2)
        c4 = self.stage3(c3)
        c5 = self.stage4(c4)
        return c3, c4, c5


V7_BACKBONE_CFG = {
    "tiny": {"base_chs": 32, "elan_depth": 2},
    "base": {"base_chs": 32, "elan_depth": 4},
    "x": {"base_chs": 40, "elan_depth": 6},
}


class V7Backbone(nn.Module):
    """YOLOv7 E-ELAN backbone. As in the JAX package, its ELANs take no
    `act` (they keep the default SiLU) and the downsampling forks keep the
    literal names `stageK_1` beside the ELANs `stageK`."""

    def __init__(self, variant: str = "base", act: str = "silu",
                 in_chs: int = 3):
        super().__init__()
        cfg = V7_BACKBONE_CFG[variant.lower()]
        bc, depth = cfg["base_chs"], cfg["elan_depth"]
        self.stem = ConvBnAct(in_chs, bc, 3, 1, act=act)
        self.stage1 = nn.Sequential(
            ConvBnAct(bc, bc * 2, 3, 2, act=act),
            ConvBnAct(bc * 2, bc * 2, 3, 1, act=act),
            ConvBnAct(bc * 2, bc * 4, 3, 2, act=act),
        )
        self.stage2 = ELAN(bc * 4, 64, bc * 8, depth=depth)
        self.stage2_1 = MPx3Conv(bc * 8, bc * 4, act=act)
        self.stage3 = ELAN(bc * 8, 128, bc * 16, depth=depth)
        self.stage3_1 = MPx3Conv(bc * 16, bc * 8, act=act)
        self.stage4 = ELAN(bc * 16, 256, bc * 32, depth=depth)
        self.stage4_1 = MPx3Conv(bc * 32, bc * 16, act=act)
        self.stage5 = ELAN(bc * 32, 256, bc * 32, depth=depth)
        self.out_chs = (bc * 16, bc * 32, bc * 32)

    def forward(self, x: torch.Tensor):
        p1 = self.stage1(self.stem(x))
        p2 = self.stage2(p1)
        p3 = self.stage3(torch.cat(self.stage2_1(p2), dim=1))
        p4 = self.stage4(torch.cat(self.stage3_1(p3), dim=1))
        p5 = self.stage5(torch.cat(self.stage4_1(p4), dim=1))
        return p3, p4, p5
