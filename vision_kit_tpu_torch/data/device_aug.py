"""Device-side train augmentation: mosaic + affine + mixup + HSV + flips, at
the head of the training step.

Counterpart of vision_kit_tpu/data/device_aug.py: warp_augment on the
device, and DeviceAugPlanner, the host half that draws each sample's
parameters and computes its labels (numpy, the JAX planner's draw order).
Every sample is determined by its parameter row; there is no randomness on
the device.

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

import numpy as np
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


# ======================================================================
# Host-side planner
# ======================================================================


def label_count(dataset, idx: int) -> int:
    """Number of labels of `idx` WITHOUT decoding the image: from the
    label table (YOLODataset's rows, filtered as load_anno filters them;
    COCODataset's items), else load_anno."""
    labs = getattr(dataset, "labels", None)
    if labs is not None:
        rows = labs[idx]
        fc = getattr(dataset, "filter_classes", None)
        if fc and len(rows):
            return int(np.isin(rows[:, 0], fc).sum())
        return len(rows)
    items = getattr(dataset, "items", None)
    if items is not None:
        return len(items[idx]["labels"])
    return len(dataset.load_anno(idx))


class DeviceAugPlanner:
    """Host half of the device augmentation: RNG decisions + label math.

    plan(rng, idx) -> (tile_idxs, draws); after the loader decodes every
    tile, finalize(draws, items) -> (params_row, tile_hw_row, labels,
    tile_imgs) with labels in the final SxS frame (abs xyxy+cls). The
    per-sample draw order is the JAX planner's, so one seed gives the same
    parameters and labels in both packages."""

    def __init__(self, dataset, img_size=(640, 640), enable_mosaic=True,
                 enable_mixup=False, mosaic_prob=1.0, mixup_prob=1.0,
                 degrees=0.0, translate=0.1, mosaic_scale=(0.5, 1.5),
                 mixup_scale=(0.5, 1.5), shear=0.0, flip_lr_prob=0.5,
                 flip_ud_prob=0.0, hsv_prob=1.0,
                 hsv_gains=(0.015, 0.7, 0.4), no_aug=False):
        if degrees or shear:
            raise ValueError(
                "device augmentation supports degrees=0, shear=0 only "
                "(rotation/shear make the warp non-separable); the host "
                "augmentation route (TrainLoader(device_aug=False)) takes them")
        self.dataset = dataset
        # label counts are immutable per idx; memoised so that datasets
        # without a label table pay load_anno's decode at most once per
        # index instead of once per mixup-retry probe
        self._label_counts: dict[int, int] = {}
        self.input_dim = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.enable_mosaic = enable_mosaic and not no_aug
        self.enable_mixup = enable_mixup and not no_aug
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.translate = translate
        self.mosaic_scale = tuple(mosaic_scale)
        self.mixup_scale = tuple(mixup_scale)
        self.flip_lr_prob = 0.0 if no_aug else flip_lr_prob
        self.flip_ud_prob = 0.0 if no_aug else flip_ud_prob
        self.hsv_prob = 0.0 if no_aug else hsv_prob
        self.hsv_gains = tuple(hsv_gains)
        # mixup off -> 4-slot tile buffers (the warp skips the slot-4 resample)
        self.n_tiles = N_TILES if self.enable_mixup else 4

    def plan(self, rng: np.random.Generator, idx: int):
        """Draw order: mosaic gate, (yc, xc, 3 extra indices), affine
        (scale, tx, ty), mixup gate + retry indices + (jit, flip), then HSV
        and the flips. Returns (tile_idxs to decode, draws dict)."""
        H, W = self.input_dim
        draws: dict = {"idx": idx}
        mosaic = self.enable_mosaic and rng.random() < self.mosaic_prob
        draws["mosaic"] = mosaic
        if mosaic:
            draws["yc"] = int(rng.uniform(0.5 * H, 1.5 * H))
            draws["xc"] = int(rng.uniform(0.5 * W, 1.5 * W))
            tile_idxs = [idx] + [int(rng.integers(0, len(self.dataset))) for _ in range(3)]
            draws["scale"] = float(rng.uniform(*self.mosaic_scale))
            draws["tx"] = float(rng.uniform(-self.translate, self.translate) * W)
            draws["ty"] = float(rng.uniform(-self.translate, self.translate) * H)
            if self.enable_mixup and rng.random() < self.mixup_prob:
                # up to 30 tries for a labelled sample, counted from the
                # label table without a decode
                cp = -1
                for _ in range(30):
                    cand = int(rng.integers(0, len(self.dataset)))
                    n = self._label_counts.get(cand)
                    if n is None:
                        n = self._label_counts[cand] = label_count(self.dataset, cand)
                    if n:
                        cp = cand
                        break
                if cp >= 0:
                    draws["mix_idx"] = cp
                    draws["mix_jit"] = float(rng.uniform(*self.mixup_scale))
                    draws["mix_flip"] = bool(rng.random() > 0.5)
                    tile_idxs = tile_idxs + [cp]
        else:
            tile_idxs = [idx]
        if rng.random() < self.hsv_prob:
            draws["hsv"] = tuple(float(v) for v in rng.uniform(-1, 1, 3) * self.hsv_gains + 1)
        else:
            draws["hsv"] = (1.0, 1.0, 1.0)
        draws["flip_lr"] = rng.random() < self.flip_lr_prob
        draws["flip_ud"] = rng.random() < self.flip_ud_prob
        draws["_rng"] = rng  # mixup crop offsets need post-decode draws
        return tile_idxs, draws

    def finalize(self, draws: dict, items):
        """items: (img, labels_resized_xyxy, hw0, id) for each of plan()'s
        tile_idxs. Returns (params (N_PARAMS,) f32, tile_hw (n_tiles, 2)
        i32, labels (n, 5) abs xyxy+cls in the final frame, tile_imgs list
        aligned to slots)."""
        H, W = self.input_dim
        params = np.zeros(N_PARAMS, np.float32)
        tile_hw = np.zeros((self.n_tiles, 2), np.int32)
        params[P_SCALE] = 1.0
        params[P_MIX_JIT] = 1.0
        params[P_MIX_OW], params[P_MIX_OH] = W, H
        tile_imgs: list = [None] * self.n_tiles

        if draws["mosaic"]:
            xc, yc = draws["xc"], draws["yc"]
            s, tx, ty = draws["scale"], draws["tx"], draws["ty"]
            params[P_XC], params[P_YC] = xc, yc
            params[P_SCALE], params[P_TX], params[P_TY] = s, tx, ty
            all_labels = []
            for t in range(4):
                img, lab, _, _ = items[t]
                h, w = img.shape[:2]
                tile_imgs[t] = img
                tile_hw[t] = (h, w)
                padw = (xc - w) if t in (0, 2) else xc
                padh = (yc - h) if t in (0, 1) else yc
                if len(lab):
                    l2 = lab.copy()
                    l2[:, [0, 2]] += padw
                    l2[:, [1, 3]] += padh
                    all_labels.append(l2)
            if all_labels:
                labels = np.concatenate(all_labels, 0)
                labels[:, 0] = labels[:, 0].clip(0, 2 * W)
                labels[:, 1] = labels[:, 1].clip(0, 2 * H)
                labels[:, 2] = labels[:, 2].clip(0, 2 * W)
                labels[:, 3] = labels[:, 3].clip(0, 2 * H)
                # scale + translate on the corners (no rotation), then clip
                labels[:, [0, 2]] = (labels[:, [0, 2]] * s + tx).clip(0, W)
                labels[:, [1, 3]] = (labels[:, [1, 3]] * s + ty).clip(0, H)
                wh = labels[:, 2:4] - labels[:, 0:2]
                labels = labels[(wh > 1.0).all(1)]
            else:
                labels = np.zeros((0, 5), np.float32)

            if "mix_idx" in draws and len(labels):
                labels = self._finalize_mixup(draws, items[4], labels, params,
                                              tile_hw, tile_imgs)
            else:
                params[P_MIX_W] = 0.0
        else:
            img, lab, _, _ = items[0]
            h, w = img.shape[:2]
            tile_imgs[0] = img
            tile_hw[0] = (h, w)
            left, top = (W - w) // 2, (H - h) // 2
            # degenerate params: xc=2W, yc=2H puts every in-bounds tap in
            # quadrant 0, whose paste offset is 2W - w; folding the centred
            # pad into the integer translate makes every tap exact
            params[P_XC], params[P_YC] = 2 * W, 2 * H
            params[P_SCALE] = 1.0
            params[P_TX] = left - (2 * W - w)
            params[P_TY] = top - (2 * H - h)
            labels = lab.copy() if len(lab) else np.zeros((0, 5), np.float32)
            if len(labels):
                labels[:, [0, 2]] += left
                labels[:, [1, 3]] += top

        # flips last, on the final frame
        if draws["flip_lr"] and len(labels):
            x1 = labels[:, 0].copy()
            labels[:, 0] = W - labels[:, 2]
            labels[:, 2] = W - x1
        if draws["flip_ud"] and len(labels):
            y1 = labels[:, 1].copy()
            labels[:, 1] = H - labels[:, 3]
            labels[:, 3] = H - y1
        params[P_FLIP_LR] = float(draws["flip_lr"])
        params[P_FLIP_UD] = float(draws["flip_ud"])
        params[P_HSV_H], params[P_HSV_S], params[P_HSV_V] = draws["hsv"]
        return params, tile_hw, labels, tile_imgs

    def _finalize_mixup(self, draws, cp_item, labels, params, tile_hw, tile_imgs):
        """Mixup geometry + labels. Post-decode draw order: y_off, x_off."""
        H, W = self.input_dim
        rng = draws["_rng"]
        img, cp_lab, _, _ = cp_item
        h, w = img.shape[:2]
        tile_imgs[4] = img
        tile_hw[4] = (h, w)
        jit, flip = draws["mix_jit"], draws["mix_flip"]
        ow, oh = int(W * jit), int(H * jit)
        y_off = int(rng.integers(0, oh - H)) if oh > H else 0
        x_off = int(rng.integers(0, ow - W)) if ow > W else 0
        params[P_MIX_W] = 0.5
        params[P_MIX_JIT] = jit
        params[P_MIX_OW], params[P_MIX_OH] = ow, oh
        params[P_MIX_FLIP] = float(flip)
        params[P_MIX_XOFF] = x_off
        params[P_MIX_YOFF] = y_off

        boxes = cp_lab[:, :4] * jit
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, ow)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, oh)
        if flip:
            boxes[:, 0::2] = ow - boxes[:, 0::2][:, ::-1]
        boxes[:, 0::2] = (boxes[:, 0::2] - x_off).clip(0, W)
        boxes[:, 1::2] = (boxes[:, 1::2] - y_off).clip(0, H)
        mix_labels = np.concatenate([boxes, cp_lab[:, 4:5]], axis=1)
        wh = mix_labels[:, 2:4] - mix_labels[:, 0:2]
        mix_labels = mix_labels[(wh > 1.0).all(1)]
        return np.concatenate([labels, mix_labels], axis=0)
