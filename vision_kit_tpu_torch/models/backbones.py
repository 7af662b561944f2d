"""CSPDarknet (YOLOv5 backbone) in PyTorch.

Counterpart of vision_kit_tpu/models/backbones.py:CSPDarknet with its
defaults (no Focus stem, no depthwise convs). Returns the (P3, P4, P5)
features at strides 8/16/32.
"""

from __future__ import annotations

import torch
from torch import nn

from vision_kit_tpu_torch.models.layers import SPPF, C3Bottleneck, ConvBnAct


class CSPDarknet(nn.Module):
    """Width/depth scaled by the v5 multipliers; 6x6/s2 conv stem, SPPF tail
    on stage4. `out_chs` are the channels of (P3, P4, P5)."""

    def __init__(self, depth_mul: float, width_mul: float, act: str = "silu",
                 in_chs: int = 3):
        super().__init__()
        b = int(width_mul * 64)
        d = max(round(depth_mul * 3), 1)
        self.stem = ConvBnAct(in_chs, b, 6, 2, 2)
        self.stage1 = nn.Sequential(
            ConvBnAct(b, b * 2, 3, 2, act=act),
            C3Bottleneck(b * 2, b * 2, n=d, act=act),
        )
        self.stage2 = nn.Sequential(
            ConvBnAct(b * 2, b * 4, 3, 2, act=act),
            C3Bottleneck(b * 4, b * 4, n=d * 2, act=act),
        )
        self.stage3 = nn.Sequential(
            ConvBnAct(b * 4, b * 8, 3, 2, act=act),
            C3Bottleneck(b * 8, b * 8, n=d * 3, act=act),
        )
        self.stage4 = nn.Sequential(
            ConvBnAct(b * 8, b * 16, 3, 2, act=act),
            C3Bottleneck(b * 16, b * 16, n=d, act=act),
            SPPF(b * 16, b * 16, kernel=5),
        )
        self.out_chs = (b * 4, b * 8, b * 16)

    def forward(self, x: torch.Tensor):
        c2 = self.stage1(self.stem(x))
        c3 = self.stage2(c2)
        c4 = self.stage3(c3)
        c5 = self.stage4(c4)
        return c3, c4, c5
