"""YOLOv5 and YOLOv7 Detect heads with static-grid decode, in PyTorch.

Counterparts of vision_kit_tpu/models/heads.py:YoloV5Head and YoloV7Head.
Each level's 1x1 conv writes (B, na*no, ny, nx) in channels_last memory, so
its NHWC view (B, ny, nx, na, no) -- the raw map in the JAX package's
native layout -- is a `permute` and `view` with no copy (the v7 head's
implicit multiply keeps channels_last). With decode_order="reference" the
raw maps are transposed to the anchor-major (B, na, ny, nx, no) order
instead.

In a banded forward (parallel/spatial.py) each level's conv runs on the
band, and the raw maps' bands are gathered into the whole maps on every
rank before the reshape and the decode, whose grid is the whole map's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from vision_kit_tpu_torch.models.layers import Implicit
from vision_kit_tpu_torch.parallel.spatial import Bands

V5_ANCHORS = (
    (10, 13, 16, 30, 33, 23),
    (30, 61, 62, 45, 59, 119),
    (116, 90, 156, 198, 373, 326),
)
V7_ANCHORS = (
    (12, 16, 19, 36, 40, 28),
    (36, 75, 76, 55, 72, 146),
    (142, 110, 192, 243, 459, 401),
)


def check_anchor_order(anchors: np.ndarray, strides: Sequence[float]) -> np.ndarray:
    """Flip anchor levels if their mean area order disagrees with stride
    order. Pure numpy, build-time."""
    a = anchors.prod(-1).mean(-1).reshape(-1)
    da = a[-1] - a[0]
    ds = strides[-1] - strides[0]
    if da != 0 and (np.sign(da) != np.sign(ds)):
        anchors = anchors[::-1].copy()
    return anchors


def normalized_anchors(
    anchors: Sequence[Sequence[float]], strides: Sequence[float]
) -> np.ndarray:
    """(nl, na, 2) anchors in grid units (divided by stride), order-checked."""
    a = np.asarray(anchors, dtype=np.float32).reshape(len(anchors), -1, 2)
    a = a / np.asarray(strides, dtype=np.float32).reshape(-1, 1, 1)
    return check_anchor_order(a, strides)


def head_bias_prior(stride: float, na: int, nc: int) -> np.ndarray:
    """Detection-prior bias: obj log(8 / (640/s)^2), cls log(0.6 / (nc-0.99))."""
    b = np.zeros((na, nc + 5), dtype=np.float32)
    b[:, 4] += float(np.log(8.0 / (640.0 / stride) ** 2))
    if nc > 0:
        b[:, 5:] += float(np.log(0.6 / (nc - 0.99)))
    return b.reshape(-1)


def _make_grid(ny: int, nx: int) -> np.ndarray:
    """Static (1, 1, ny, nx, 2) integer xy grid."""
    yv, xv = np.meshgrid(
        np.arange(ny, dtype=np.float32), np.arange(nx, dtype=np.float32),
        indexing="ij",
    )
    return np.stack([xv, yv], axis=-1).reshape(1, 1, ny, nx, 2)


def _decode_level(raw: torch.Tensor, stride: float, anchors_px: np.ndarray,
                  anchor_axis: int, centre) -> torch.Tensor:
    """Sigmoid-decode one level into (B, na*ny*nx, no). anchor_axis=1 takes
    the anchor-major (B, na, ny, nx, no) map, anchor_axis=3 the native
    (B, ny, nx, na, no) one. centre(s2, grid, stride) gives the box centres
    from 2*sigmoid(xy) and the integer grid. Grid and anchors are f32, so a
    bf16 map decodes to f32, as under JAX's type promotion."""
    y = raw.sigmoid()
    if anchor_axis == 1:
        b, na, ny, nx, no = raw.shape
        grid_shape, anc_shape = (1, 1, ny, nx, 2), (1, na, 1, 1, 2)
    else:
        b, ny, nx, na, no = raw.shape
        grid_shape, anc_shape = (1, ny, nx, 1, 2), (1, 1, 1, na, 2)
    grid = torch.from_numpy(_make_grid(ny, nx)).to(raw.device).reshape(grid_shape)
    anchor_grid = torch.from_numpy(anchors_px.astype(np.float32)).to(raw.device)
    xy = centre(y[..., 0:2] * 2.0, grid, stride)
    wh = (y[..., 2:4] * 2.0) ** 2 * anchor_grid.reshape(anc_shape)
    out = torch.cat([xy, wh, y[..., 4:].to(xy.dtype)], dim=-1)
    return out.reshape(b, na * ny * nx, no)


class YoloV5Head(nn.Module):
    """YOLOv5 Detect. forward(feats) returns the raw maps; with decode=True
    also the decoded (B, sum(na*ny*nx), 5+nc) boxes, as (decoded, raws)."""

    def __init__(self, in_chs: Sequence[int], num_classes: int = 80,
                 anchors: Sequence[Sequence[float]] = V5_ANCHORS,
                 stride: Sequence[float] = (8.0, 16.0, 32.0),
                 decode_order: str = "native"):
        super().__init__()
        if decode_order not in ("native", "reference"):
            raise ValueError(f"decode_order {decode_order!r}")
        self.num_classes = num_classes
        self.na = len(anchors[0]) // 2
        self.no = num_classes + 5
        self.stride = tuple(float(s) for s in stride)
        self.decode_order = decode_order
        self.grid_anchors = normalized_anchors(anchors, self.stride)
        self.m = nn.ModuleList(
            nn.Conv2d(c, self.no * self.na, 1, bias=True) for c in in_chs
        )

    @property
    def anchors_px(self) -> np.ndarray:
        """(nl, na, 2) pixel-unit anchors exactly as the decode uses them."""
        return self.grid_anchors * np.asarray(self.stride, np.float32).reshape(-1, 1, 1)

    def level_map(self, i: int, f: torch.Tensor) -> torch.Tensor:
        """Level i's conv output (B, na*no, ny, nx)."""
        return self.m[i](f)

    @staticmethod
    def centre(s2: torch.Tensor, grid: torch.Tensor, stride: float) -> torch.Tensor:
        """Box centres from s2 = 2*sigmoid(xy), in v5's order of operations:
        (s2 + (grid - 0.5)) * stride (the grid offset is exact in f32)."""
        return (s2 + (grid - 0.5)) * stride

    def forward(self, feats, decode: bool = True):
        raws, decoded = [], []
        reference = self.decode_order == "reference"
        anchors_px = self.anchors_px
        maps = [self.level_map(i, f) for i, f in enumerate(feats)]
        if Bands.active is not None:
            maps = Bands.active.gather(maps)
        for i, y in enumerate(maps):
            b, _, ny, nx = y.shape
            # the channel axis is anchor-major (na*no), like the JAX conv
            raw = y.permute(0, 2, 3, 1).reshape(b, ny, nx, self.na, self.no)
            if reference:
                raw = raw.permute(0, 3, 1, 2, 4)
            raws.append(raw)
            if decode:
                decoded.append(_decode_level(raw, self.stride[i], anchors_px[i],
                                             anchor_axis=1 if reference else 3,
                                             centre=self.centre))
        if not decode:
            return raws
        return torch.cat(decoded, dim=1), raws


class YoloV7Head(YoloV5Head):
    """YOLOv7 Detect with implicit knowledge: without deploy, level i runs
    ia_i (add), the 1x1 conv m_i, then im_i (multiply); with deploy (the
    implicits folded into m_i by convert.deploy_state_dict) m_i alone.

    The decode takes the raw pixel anchors V7_ANCHORS (the reference clones
    them before its anchor-order check), and the v7 centre formula."""

    def __init__(self, in_chs: Sequence[int], num_classes: int = 80,
                 anchors: Sequence[Sequence[float]] = V7_ANCHORS,
                 stride: Sequence[float] = (8.0, 16.0, 32.0),
                 deploy: bool = False, decode_order: str = "native"):
        super().__init__(in_chs, num_classes, anchors, stride, decode_order)
        self.deploy = deploy
        self.raw_anchors = np.asarray(anchors, np.float32).reshape(
            len(anchors), self.na, 2)
        if not deploy:
            self.ia = nn.ModuleList(Implicit(c, "add") for c in in_chs)
            self.im = nn.ModuleList(Implicit(self.no * self.na, "multiply")
                                    for _ in in_chs)

    @property
    def anchors_px(self) -> np.ndarray:
        return self.raw_anchors

    @staticmethod
    def centre(s2: torch.Tensor, grid: torch.Tensor, stride: float) -> torch.Tensor:
        """v7's order, (s2 - 0.5 + grid) * stride: equal to v5's in exact
        arithmetic, rounded differently in f32."""
        return (s2 - 0.5 + grid) * stride

    def level_map(self, i: int, f: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            return self.m[i](f)
        return self.im[i](self.m[i](self.ia[i](f)))
