"""Necks: PAFPN (YOLOv5) and PAFPN-ELAN (YOLOv7), in PyTorch.

Counterparts of vision_kit_tpu/models/necks.py: top-down FPN plus
bottom-up PAN with nearest 2x upsampling.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vision_kit_tpu_torch.models.layers import (
    ELAN,
    SPPCSPC,
    C3Bottleneck,
    ConvBnAct,
    DWConvModule,
    MPx3Conv,
    RepConv,
    upsample_nearest_2x,
)


class PAFPN(nn.Module):
    """`feat_chs` are the backbone's (P3, P4, P5) channels; `out_chs` the
    neck's, which the head consumes. `depthwise` makes the two bottom-up
    strided convs DWConvModules (the C3 blocks stay dense, as in the JAX
    neck)."""

    def __init__(self, depth_mul: float, width_mul: float,
                 feat_chs: Sequence[int],
                 in_chs: Sequence[int] = (256, 512, 1024), act: str = "silu",
                 depthwise: bool = False):
        super().__init__()
        d = max(round(depth_mul * 3), 1)
        o0, o1, o2 = (int(c * width_mul) for c in in_chs)
        c3, c4, c5 = feat_chs
        down = DWConvModule if depthwise else ConvBnAct

        def c3block(ins, outs):
            return C3Bottleneck(ins, outs, n=d, shortcut=False, act=act)

        self.lateral_conv0 = ConvBnAct(c5, o1, 1, 1, act=act)
        self.C3_p4 = c3block(o1 + c4, o1)
        self.reduce_conv1 = ConvBnAct(o1, o0, 1, 1, act=act)
        self.C3_p3 = c3block(o0 + c3, o0)
        self.bu_conv2 = down(o0, o0, 3, 2, act=act)
        self.C3_n3 = c3block(o0 + o0, o1)
        self.bu_conv1 = down(o1, o1, 3, 2, act=act)
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


V7_NECK_CFG = {
    "base": {"out_chs": (256, 512, 1024), "elan_depth": 4},
    "x": {"out_chs": (320, 640, 1280), "elan_depth": 6},
}


class PAFPNELAN(nn.Module):
    """YOLOv7 ELAN-PAN neck over the backbone's (P3, P4, P5) channels
    `feat_chs`. The three output convs are RepConvs in base (one 3x3 conv
    each with `deploy`) and ConvBnActs in x. There is no "tiny" neck."""

    def __init__(self, variant: str, feat_chs: Sequence[int],
                 act: str = "silu", deploy: bool = False):
        super().__init__()
        variant = variant.lower()
        if variant not in V7_NECK_CFG:
            raise ValueError(
                f"YOLOv7 variant {variant!r} has no neck: base and x are "
                "defined (the reference's 'tiny' has a backbone table only)")
        cfg = V7_NECK_CFG[variant]
        o0, o1, o2 = cfg["out_chs"]
        depth = cfg["elan_depth"]
        c3, c4, c5 = feat_chs

        def cba(ins, outs, k, s=1):
            return ConvBnAct(ins, outs, k, s, act=act)

        def elan(ins, hidden, outs):
            return ELAN(ins, hidden, outs, act=act, depth=depth)

        self.sppcspc = SPPCSPC(c5, o1, act=act)
        self.lateral_conv = cba(o1, o0, 1)
        self.route_p4 = cba(c4, o0, 1)
        self.lateral_elan = elan(2 * o0, 256, o0)
        self.reduce_conv = cba(o0, o0 // 2, 1)
        self.route_p3 = cba(c3, o0 // 2, 1)
        self.reduce_elan = elan(o0, 128, o0 // 2)
        self.mp_3xconvs_1 = MPx3Conv(o0 // 2, o0 // 2, act=act)
        self.bu_elan1 = elan(2 * o0, 256, o0)
        self.mp_3xconvs_2 = MPx3Conv(o0, o0, act=act)
        self.bu_elan2 = elan(2 * o0 + o1, 512, o1)
        if variant == "base":
            def out_conv(ins, outs):
                return RepConv(ins, outs, act=act, deploy=deploy)
        else:
            def out_conv(ins, outs):
                return cba(ins, outs, 3)
        self.pan_conv2 = out_conv(o0 // 2, o0)
        self.pan_conv1 = out_conv(o0, o1)
        self.pan_conv0 = out_conv(o1, o2)
        self.out_chs = (o0, o1, o2)

    def forward(self, feats):
        p3, p4, p5 = feats
        x_sppcspc = self.sppcspc(p5)

        fpn_out1 = self.lateral_conv(x_sppcspc)
        f_out1 = torch.cat([self.route_p4(p4), upsample_nearest_2x(fpn_out1)], dim=1)
        f_out1 = self.lateral_elan(f_out1)

        fpn_out2 = self.reduce_conv(f_out1)
        f_out2 = torch.cat([self.route_p3(p3), upsample_nearest_2x(fpn_out2)], dim=1)
        pan_out2 = self.reduce_elan(f_out2)

        x_79, x_77 = self.mp_3xconvs_1(pan_out2)
        pan_out1 = self.bu_elan1(torch.cat([x_79, x_77, f_out1], dim=1))

        x_92, x_90 = self.mp_3xconvs_2(pan_out1)
        pan_out0 = self.bu_elan2(torch.cat([x_92, x_90, x_sppcspc], dim=1))

        return (self.pan_conv2(pan_out2), self.pan_conv1(pan_out1),
                self.pan_conv0(pan_out0))
