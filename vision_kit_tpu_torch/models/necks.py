"""PAFPN (YOLOv5 neck) in PyTorch.

Counterpart of vision_kit_tpu/models/necks.py:PAFPN: top-down FPN plus
bottom-up PAN with nearest 2x upsampling.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vision_kit_tpu_torch.models.layers import (
    C3Bottleneck,
    ConvBnAct,
    upsample_nearest_2x,
)


class PAFPN(nn.Module):
    """`feat_chs` are the backbone's (P3, P4, P5) channels; `out_chs` the
    neck's, which the head consumes."""

    def __init__(self, depth_mul: float, width_mul: float,
                 feat_chs: Sequence[int],
                 in_chs: Sequence[int] = (256, 512, 1024), act: str = "silu"):
        super().__init__()
        d = max(round(depth_mul * 3), 1)
        o0, o1, o2 = (int(c * width_mul) for c in in_chs)
        c3, c4, c5 = feat_chs

        def c3block(ins, outs):
            return C3Bottleneck(ins, outs, n=d, shortcut=False, act=act)

        self.lateral_conv0 = ConvBnAct(c5, o1, 1, 1, act=act)
        self.C3_p4 = c3block(o1 + c4, o1)
        self.reduce_conv1 = ConvBnAct(o1, o0, 1, 1, act=act)
        self.C3_p3 = c3block(o0 + c3, o0)
        self.bu_conv2 = ConvBnAct(o0, o0, 3, 2, act=act)
        self.C3_n3 = c3block(o0 + o0, o1)
        self.bu_conv1 = ConvBnAct(o1, o1, 3, 2, act=act)
        self.C3_n4 = c3block(o1 + o1, o2)
        self.out_chs = (o0, o1, o2)

    def forward(self, feats):
        c3, c4, c5 = feats
        fpn_out0 = self.lateral_conv0(c5)
        f_out0 = torch.cat([upsample_nearest_2x(fpn_out0), c4], dim=1)
        f_out0 = self.C3_p4(f_out0)

        fpn_out1 = self.reduce_conv1(f_out0)
        f_out1 = torch.cat([upsample_nearest_2x(fpn_out1), c3], dim=1)
        pan_out2 = self.C3_p3(f_out1)

        p_out1 = torch.cat([self.bu_conv2(pan_out2), fpn_out1], dim=1)
        pan_out1 = self.C3_n3(p_out1)

        p_out0 = torch.cat([self.bu_conv1(pan_out1), fpn_out0], dim=1)
        pan_out0 = self.C3_n4(p_out0)
        return pan_out2, pan_out1, pan_out0
