"""Device-side train augmentation: mosaic + affine + mixup + HSV + flips, at
the head of the training step.

Counterpart of vision_kit_tpu/data/device_aug.py:warp_augment (the host
planner that draws the parameters and computes the labels, DeviceAugPlanner,
comes with the loaders). Every sample is determined by its parameter row;
there is no randomness on the device.

The warp is separable (no rotation or shear), so each tile's resample is
two bilinear weight-matrix products: out = sum_t A_t @ tile_t @ B_t^T +
114 * (1 - sum_t u_t (x) v_t), where A_t[o, i] = tri(y_src(o) - (padh_t +
i)) masked to the tile's valid, in-canvas rows, tri(d) = max(0, 1 - |d|),
and u_t, v_t are the weight row sums; the paste rectangles are disjoint, so
the tiles' weight masses add, and the uncovered mass is the 114 border.
MixUp is the same resample of slot 4 with edge-clamped source coordinates,
blended at its weight; HSV is the cv2 gain jitter in float; flips are
reversed axes.
"""

from __future__ import annotations

import torch

PAD_VALUE = 114.0

# params row layout (float32); one row per sample
P_XC = 0         # mosaic center x (int-valued; 2W => "all quadrant 0")
P_YC = 1         # mosaic center y
P_SCALE = 2      # affine scale about the origin
P_TX = 3         # affine translate x (pixels)
P_TY = 4         # affine translate y
P_FLIP_LR = 5    # 0/1
P_FLIP_UD = 6    # 0/1
P_HSV_H = 7      # hue gain r0 (all three 1 => skip, bit-exact passthrough)
P_HSV_S = 8      # sat gain r1
P_HSV_V = 9      # val gain r2
P_MIX_W = 10     # mixup blend weight (0 = off; the reference uses 0.5)
P_MIX_JIT = 11   # mixup jit scale
P_MIX_XOFF = 12  # mixup crop offset x (int-valued)
P_MIX_YOFF = 13  # mixup crop offset y
P_MIX_FLIP = 14  # mixup lr flip 0/1
P_MIX_OW = 15    # mixup resized width = the host's int(W*jit), shipped so the
P_MIX_OH = 16    # mixup resized height  device geometry matches the labels
N_PARAMS = 17

N_TILES = 5      # 4 mosaic quadrants + 1 mixup source


def _tri(d: torch.Tensor) -> torch.Tensor:
    """Bilinear hat weight: nonzero exactly for the floor/ceil taps."""
    return (1.0 - d.abs()).clamp_min(0.0)


def _select(conds, values, default):
    """jnp.select: the value of the first true condition, else default."""
    out = default
    for cond, value in zip(reversed(conds), reversed(values)):
        out = torch.where(cond, value, out)
    return out


def _hsv_jitter(img: torch.Tensor, r0, r1, r2) -> torch.Tensor:
    """cv2/ultralytics HSV gain jitter in float: hue scaled mod 180 (cv2's
    uint8 hue scale), saturation and value scaled and clipped. img (B, H, W,
    3) f32 in [0, 255]; r* (B,) gains."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    c = v - torch.minimum(torch.minimum(r, g), b)
    safe_c = torch.where(c > 0, c, 1.0)
    # cv2 precedence: v == r first, then v == g, else b
    h = torch.where(
        (v == r) & (c > 0), 60.0 * (g - b) / safe_c,
        torch.where((v == g) & (c > 0), 60.0 * (b - r) / safe_c + 120.0,
                    torch.where(c > 0, 60.0 * (r - g) / safe_c + 240.0, 0.0)))
    h = torch.remainder(h, 360.0) * 0.5          # cv2 uint8 hue scale [0, 180)
    h2 = torch.remainder(h * r0[:, None, None], 180.0) * 2.0
    s2 = (255.0 * c / torch.where(v > 0, v, 1.0) * r1[:, None, None]
          ).clamp(0.0, 255.0) / 255.0
    v2 = (v * r2[:, None, None]).clamp(0.0, 255.0)
    hi = torch.floor(h2 / 60.0).int() % 6
    f = h2 / 60.0 - torch.floor(h2 / 60.0)
    p = v2 * (1.0 - s2)
    q = v2 * (1.0 - f * s2)
    t = v2 * (1.0 - (1.0 - f) * s2)
    # sector table: 0:(v,t,p) 1:(q,v,p) 2:(p,v,t) 3:(p,q,v) 4:(t,p,v)
    # 5:(v,p,q), sector 5 the default
    sectors = [hi == s for s in range(5)]
    r_ = _select(sectors, [v2, q, p, p, t], v2)
    g_ = _select(sectors, [t, v2, v2, q, p], p)
    b_ = _select(sectors, [p, p, t, v2, v2], q)
    return torch.stack([r_, g_, b_], dim=-1)


def _scalar(value: float, dtype: torch.dtype) -> float:
    """value rounded to dtype, as a Python float."""
    return torch.tensor(value, dtype=dtype).item()


def warp_augment(tiles: torch.Tensor, tile_hw: torch.Tensor,
                 params: torch.Tensor, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """The device augmentation.

    tiles (B, N_TILES or 4, H, W, 3) uint8; tile_hw (B, N_TILES, 2) int
    [h, w] valid extents; params (B, N_PARAMS) float32. Returns (B, H, W, 3)
    `dtype` in [0, 1], the model's normalised-float input.

    dtype is the resample products' dtype (the model's compute dtype in
    the training step; products accumulate in f32 on the card either way).
    A 4-slot tiles buffer skips the mixup resample."""
    B, _, H, W, _ = tiles.shape
    dev = tiles.device
    p = params.float()

    xc1, yc1 = p[:, P_XC], p[:, P_YC]                  # int-valued floats
    th4 = tile_hw[:, :4, 0].float()
    tw4 = tile_hw[:, :4, 1].float()
    # paste offsets per quadrant (canvas coord - tile coord)
    padw = torch.stack([xc1 - tw4[:, 0], xc1, xc1 - tw4[:, 2], xc1], dim=1)  # (B, 4)
    padh = torch.stack([yc1 - th4[:, 0], yc1 - th4[:, 1], yc1, yc1], dim=1)

    s = p[:, P_SCALE]
    xo = torch.arange(W, dtype=torch.float32, device=dev)
    yo = torch.arange(H, dtype=torch.float32, device=dev)
    x_src = (xo[None, :] - p[:, P_TX, None]) / s[:, None]   # (B, W)
    y_src = (yo[None, :] - p[:, P_TY, None]) / s[:, None]   # (B, H)

    ii, jj = yo, xo                                    # tile row / col index
    # A[b, t, o, i]: bilinear weight of tile t's row i for output row o,
    # masked to in-canvas and valid-extent rows
    ypos = padh[:, :, None] + ii[None, None, :]        # (B, 4, H)
    yvalid = (ypos >= 0) & (ypos < 2 * H) & (ii[None, None, :] < th4[:, :, None])
    A = _tri(y_src[:, None, :, None] - ypos[:, :, None, :]) * yvalid[:, :, None, :]
    xpos = padw[:, :, None] + jj[None, None, :]
    xvalid = (xpos >= 0) & (xpos < 2 * W) & (jj[None, None, :] < tw4[:, :, None])
    Bw = _tri(x_src[:, None, :, None] - xpos[:, :, None, :]) * xvalid[:, :, None, :]

    t4 = tiles[:, :4].to(dtype)
    tmp = torch.einsum("btoi,btijc->btojc", A.to(dtype), t4)
    mos = torch.einsum("btojc,btpj->bopc", tmp, Bw.to(dtype))
    cov = torch.einsum("bto,btp->bop", A.sum(-1), Bw.sum(-1))
    out = mos + (PAD_VALUE * (1.0 - cov)[..., None]).to(dtype)

    if tiles.shape[1] > 4:
        out = _apply_mixup(out, tiles, p, xo, yo, H, W, dtype)

    # HSV in f32 (exact passthrough where all three gains are 1)
    r0, r1, r2 = p[:, P_HSV_H], p[:, P_HSV_S], p[:, P_HSV_V]
    do_hsv = ((r0 != 1.0) | (r1 != 1.0) | (r2 != 1.0))[:, None, None, None]
    hsv = _hsv_jitter(out.float(), r0, r1, r2).to(dtype)
    out = torch.where(do_hsv, hsv, out)

    out = torch.where(p[:, P_FLIP_LR, None, None, None] > 0.5, out.flip(2), out)
    out = torch.where(p[:, P_FLIP_UD, None, None, None] > 0.5, out.flip(1), out)
    return out * _scalar(1.0 / 255.0, dtype)


def _apply_mixup(out, tiles, p, xo, yo, H, W, dtype):
    # the host's int(W*jit) and int(H*jit), shipped in the params row
    ow = p[:, P_MIX_OW].clamp_min(1.0)
    oh = p[:, P_MIX_OH].clamp_min(1.0)
    xr = xo[None, :] + p[:, P_MIX_XOFF, None]          # (B, W)
    yr = yo[None, :] + p[:, P_MIX_YOFF, None]          # (B, H)
    flip = p[:, P_MIX_FLIP, None] > 0.5
    xf = torch.where(flip, (ow[:, None] - 1.0) - xr, xr)
    # cv2.resize's half-pixel convention at the actual ratio ow/W; the
    # source coordinate clamp is cv2's border replicate
    xs = (xf + 0.5) * (W / ow[:, None]) - 0.5
    ys = (yr + 0.5) * (H / oh[:, None]) - 0.5
    Am = _tri(ys.clamp(0.0, H - 1.0)[:, :, None] - yo[None, None, :])   # (B, H, H)
    Bm = _tri(xs.clamp(0.0, W - 1.0)[:, :, None] - xo[None, None, :])   # (B, W, W)
    mtmp = torch.einsum("boi,bijc->bojc", Am.to(dtype), tiles[:, 4].to(dtype))
    mix = torch.einsum("bojc,bpj->bopc", mtmp, Bm.to(dtype))
    # beyond the resized extent the reference's zero pad shows through
    ok = (((xr >= 0) & (xr < ow[:, None]))[:, None, :]
          & ((yr >= 0) & (yr < oh[:, None]))[:, :, None])
    mix = torch.where(ok[..., None], mix, 0.0)
    mixw = p[:, P_MIX_W][:, None, None, None].to(dtype)
    return out * (1.0 - mixw) + mix * mixw
