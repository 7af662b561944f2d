"""OpenCV's image operations of the host-augmentation route, bit for bit,
as plain torch functions on (H, W, C) uint8 tensors that run on either
device.

Counterparts of the cv2 calls in vision_kit_tpu/data/augment.py and
vision_kit_tpu/data/mosaic.py (OpenCV 5's results are the reference):

- warp_affine_u8: cv2.warpAffine, INTER_LINEAR, BORDER_CONSTANT. OpenCV 5
  warps in float32 with fused multiply-adds; each fma here is float32
  operands multiplied in float64 (exact), added and rounded to float32
  once, so the CPU and the card give the same bits whatever either
  compiler contracts.
- rgb2hsv_u8 / hsv2rgb_u8: cv2.cvtColor COLOR_RGB2HSV (integer, 12-bit
  tables) and COLOR_HSV2RGB (float sectors; OpenCV's vector body
  truncates, its scalar row tail rounds).
- lut_u8: cv2.LUT per channel.
- blur_u8: cv2.blur (normalised box, BORDER_REFLECT_101).
- median_blur_u8: cv2.medianBlur, ksize 3, 5 or 7 (border replicated).
- rgb2gray_u8: cv2.cvtColor COLOR_RGB2GRAY (15-bit fixed-point weights);
  gray2rgb_u8 replicates it.
- rgb2lab_u8 / lab2rgb_u8 and clahe_u8: the uint8 Lab conversions and
  cv2.createCLAHE(clipLimit, tileGridSize).apply.
- copy_make_border_u8: cv2.copyMakeBorder with BORDER_CONSTANT.

Every function keeps its input's device; the small tables are built on
the host in numpy and moved there.
"""

from __future__ import annotations

import numpy as np
import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once: the product of two float32 values is
    exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def invert_affine(M) -> np.ndarray:
    """cv2.invertAffineTransform of a 2x3 matrix, in float64 and its order."""
    M = np.asarray(M, np.float64)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = M[1, 1] * d, M[0, 0] * d
    a12, a21 = -M[0, 1] * d, -M[1, 0] * d
    b1 = -a11 * M[0, 2] - a12 * M[1, 2]
    b2 = -a21 * M[0, 2] - a22 * M[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


WARP_BLOCK = 16   # pixels a step of OpenCV's vector warpAffine


def warp_affine_u8(img: torch.Tensor, M, dsize: tuple[int, int],
                   border_value: int = 114) -> torch.Tensor:
    """cv2.warpAffine(img, M, dsize, borderValue=(v,) * C) of an (H, W, C)
    uint8 tensor, INTER_LINEAR, BORDER_CONSTANT: the output pixel (x, y)
    reads the source at (sx, sy) = inverse(M) (x, y), with m the inverse in
    float32 and sx = fma(m0, x, m1 y + m2) in OpenCV's vector body
    (WARP_BLOCK pixels a step), fma(m0, x, m1 y) + m2 in the scalar code
    that takes each row's last dw % WARP_BLOCK pixels, likewise sy; then
    its four neighbours blend with fmas in float32 (a neighbour outside the
    image reads the border value), rounded half to even and saturated."""
    h, w, c = img.shape
    dw, dh = dsize
    dev = img.device
    m = torch.from_numpy(invert_affine(M).astype(np.float32).reshape(6)).to(dev)
    xs = torch.arange(dw, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(dh, device=dev, dtype=torch.float32)[:, None]
    body = xs < dw - dw % WARP_BLOCK
    sx = torch.where(body, _fma(m[0], xs, m[1] * ys + m[2]), _fma(m[0], xs, m[1] * ys) + m[2])
    sy = torch.where(body, _fma(m[3], xs, m[4] * ys + m[5]), _fma(m[3], xs, m[4] * ys) + m[5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    # clamp far-off coordinates before the integer cast: they read the
    # border either way
    x0 = fx.clamp(-2, w + 1).to(torch.int64)
    y0 = fy.clamp(-2, h + 1).to(torch.int64)
    flat = img.reshape(h * w, c)
    border = torch.tensor(float(border_value), device=dev)

    def tap(yy, xx):
        ok = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[..., None]
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)
        v = flat.index_select(0, idx).reshape(dh, dw, c).float()
        return torch.where(ok, v, border)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = _fma(ax, p01 - p00, p00)
    bot = _fma(ax, p11 - p10, p10)
    v = _fma(ay, bot - top, top)
    return torch.round(v).clamp(0, 255).to(torch.uint8)


HSV_SHIFT = 12


def _hsv_tables():
    """OpenCV's RGB2HSV_b division tables: sdiv[i] = round((255 << 12) / i),
    hdiv[i] = round((180 << 12) / (6 i)), 0 at i = 0."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << HSV_SHIFT) / i), 0)
        hdiv = np.where(i > 0, np.rint((180 << HSV_SHIFT) / (6 * i)), 0)
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


def rgb2hsv_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_RGB2HSV) of an (H, W, 3) uint8 tensor: H in
    [0, 180), integer arithmetic with 12-bit division tables."""
    sdiv_np, hdiv_np = _hsv_tables()
    sdiv = torch.from_numpy(sdiv_np).to(img.device)
    hdiv = torch.from_numpy(hdiv_np).to(img.device)
    x = img.to(torch.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin
    vr = v == r
    vg = v == g
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> HSV_SHIFT
    hh = torch.where(vr, g - b, torch.where(vg, b - r + 2 * diff, r - g + 4 * diff))
    hh = (hh * hdiv[diff] + half) >> HSV_SHIFT
    hh = torch.where(hh < 0, hh + 180, hh)
    return torch.stack([hh, s, v], -1).to(torch.uint8)


# cv2's HSV2RGB sector table: (b, g, r) picks from (v, p, q, t)
_HSV_SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


HSV2RGB_BLOCK = 32   # pixels a step of OpenCV's vector HSV2RGB (AVX2's 32 lanes)


def hsv2rgb_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_HSV2RGB) of an (H, W, 3) uint8 tensor (H in
    [0, 180), a hue up to 255 wraps): in float32, h6 = h * (6 / 180), s
    and v scaled by 1/255, the sector table (v, v (1 - s), v fma(-s, f, 1),
    v fma(-s, 1 - f, 1)) with f the fraction of h6, then x 255. OpenCV's
    vector body, HSV2RGB_BLOCK pixels a step, truncates that; the scalar
    code that takes each row's last W % HSV2RGB_BLOCK pixels rounds it."""
    dev = img.device
    x = img.float()
    h6 = x[..., 0] * np.float32(6.0 / 180.0)
    h6 = torch.where(h6 >= 6, h6 - 6, h6)
    sector = torch.floor(h6)
    f = h6 - sector
    s = x[..., 1] * np.float32(1.0 / 255.0)
    v = x[..., 2] * np.float32(1.0 / 255.0)
    one = torch.ones_like(s)
    tab = torch.stack([v, v * (one - s), v * _fma(-s, f, one),
                       v * _fma(-s, one - f, one)], -1)
    # output channel order r, g, b: the table's third, second and first pick
    pick = torch.tensor([[row[2], row[1], row[0]] for row in _HSV_SECTORS],
                        device=dev)[sector.to(torch.int64)]
    out = torch.gather(tab, -1, pick) * np.float32(255.0)
    w = img.shape[1]
    body = (torch.arange(w, device=dev) < w - w % HSV2RGB_BLOCK)[:, None]
    out = torch.where(body, torch.floor(out), torch.round(out))
    return out.clamp(0, 255).to(torch.uint8)


def lut_u8(img: torch.Tensor, luts) -> torch.Tensor:
    """cv2.LUT per channel: channel k of the (H, W, C) uint8 image through
    luts[k], a 256-entry uint8 table."""
    dev = img.device
    out = torch.empty_like(img)
    for k, lut in enumerate(luts):
        t = torch.as_tensor(np.asarray(lut, np.uint8)).to(dev)
        out[..., k] = t[img[..., k].to(torch.int64)]
    return out


GRAY_SHIFT = 15
GRAY_RGB = (9798, 19235, 3735)   # OpenCV's RY15, GY15, BY15


def rgb2gray_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_RGB2GRAY): (9798 r + 19235 g + 3735 b +
    2^14) >> 15, as (H, W) uint8."""
    x = img.to(torch.int32)
    y = (x[..., 0] * GRAY_RGB[0] + x[..., 1] * GRAY_RGB[1] + x[..., 2] * GRAY_RGB[2]
         + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    return y.to(torch.uint8)


def gray2rgb_u8(gray: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(gray, COLOR_GRAY2RGB): the (H, W) plane three times."""
    return gray[..., None].expand(*gray.shape, 3).contiguous()


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a length-n axis padded by `pad` each side with
    BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)."""
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _replicate(n: int, pad: int, device) -> torch.Tensor:
    """Source indices with BORDER_REPLICATE (aaa|abcdefgh|hhh)."""
    return torch.arange(-pad, n + pad, device=device).clamp(0, n - 1)


def _padded(img: torch.Tensor, pad: int, index_fn) -> torch.Tensor:
    h, w = img.shape[:2]
    iy, ix = index_fn(h, pad, img.device), index_fn(w, pad, img.device)
    return img.index_select(0, iy).index_select(1, ix)


def blur_u8(img: torch.Tensor, ksize) -> torch.Tensor:
    """cv2.blur(img, ksize) (normalised box filter, anchor at the centre,
    BORDER_REFLECT_101) of an (H, W, C) uint8 tensor: the exact integer
    sum of each kw x kh window, divided and rounded to nearest."""
    kw, kh = (ksize, ksize) if isinstance(ksize, int) else (int(ksize[0]), int(ksize[1]))
    if kw != kh or kw % 2 == 0:
        raise ValueError(f"blur_u8 takes an odd square ksize, got {ksize}")
    k = kw
    h, w = img.shape[:2]
    p = _padded(img, k // 2, _reflect101).to(torch.int32)
    rows = sum(p[:, j:j + w] for j in range(k))
    total = sum(rows[i:i + h] for i in range(k))
    return torch.round(total.double() / (k * k)).to(torch.uint8)


def median_blur_u8(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.medianBlur(img, ksize), ksize 3, 5 or 7, of an (H, W, C) uint8
    tensor: the median of each ksize x ksize window, border replicated."""
    k = int(ksize)
    if k not in (3, 5, 7):
        raise ValueError(f"median_blur_u8 takes ksize 3, 5 or 7, got {ksize}")
    h, w = img.shape[:2]
    p = _padded(img, k // 2, _replicate)
    win = torch.stack([p[i:i + h, j:j + w] for i in range(k) for j in range(k)], -1)
    return win.sort(dim=-1).values[..., (k * k) // 2].contiguous()


def copy_make_border_u8(img: torch.Tensor, top: int, bottom: int, left: int,
                        right: int, value: int = 114) -> torch.Tensor:
    """cv2.copyMakeBorder(img, top, bottom, left, right, BORDER_CONSTANT,
    value=(value,) * C) of an (H, W, C) uint8 tensor."""
    h, w, c = img.shape
    out = torch.full((h + top + bottom, w + left + right, c), value, dtype=torch.uint8,
                     device=img.device)
    out[top:top + h, left:left + w] = img
    return out


# -- uint8 Lab (sRGB, D65), OpenCV's integer paths -----------------------
LAB_SHIFT = 12        # coefficient bits
GAMMA_SHIFT = 3       # extra bits of the sRGB gamma table
LAB_SHIFT2 = LAB_SHIFT + GAMMA_SHIFT
LAB_BASE = 1 << 14    # Lab2RGB's fixed-point unit
MIN_AB = -8145        # Lab2RGB's lowest a/b table index
INV_GAMMA_SHIFT = 12
SRGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
XYZ2SRGB = ((3.240479, -1.53715, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))
D65 = (0.950456, 1.0, 1.088754)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _rgb2lab_tables():
    """(coefficients (3, 3), sRGB gamma table (256,) at 255 << 3, cube-root
    table (3072,) at 1 << 15): RGB2Lab_b's."""
    coef = np.rint((1 << LAB_SHIFT) * np.array(SRGB2XYZ) / np.array(D65)[:, None])
    x = np.arange(256) / 255.0
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gtab = np.rint(255.0 * (1 << GAMMA_SHIFT) * gamma)
    # the linear toe in float32 with one rounding (a fused multiply-add),
    # the cube root of the float64 argument rounded to float32
    j = np.arange(256 * 3 // 2 * (1 << GAMMA_SHIFT))
    xf = np.float32(1) / np.float32(255 << GAMMA_SHIFT) * j.astype(np.float32)
    toe = (xf.astype(np.float64) * np.float64(np.float32(841) / np.float32(108))
           + np.float64(np.float32(16) / np.float32(116))).astype(np.float32)
    root = np.cbrt(j / float(255 << GAMMA_SHIFT)).astype(np.float32)
    f = np.where(xf < np.float32(216) / np.float32(24389), toe, root)
    ctab = np.rint(np.float32(1 << LAB_SHIFT2) * f)
    return coef.astype(np.int64), gtab.astype(np.int64), ctab.astype(np.int64)


def rgb2lab_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_RGB2LAB) of an (H, W, 3) uint8 tensor:
    gamma table, fixed-point XYZ, cube-root table, L a b descaled from 15
    bits."""
    coef_np, gtab_np, ctab_np = _rgb2lab_tables()
    dev = img.device
    gtab, ctab = torch.from_numpy(gtab_np).to(dev), torch.from_numpy(ctab_np).to(dev)
    c = coef_np.tolist()
    x = gtab[img.to(torch.int64)]
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    fx, fy, fz = (ctab[_descale(r * row[0] + g * row[1] + b * row[2], LAB_SHIFT)]
                  for row in c)
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)
    L = _descale(l_scale * fy + l_shift, LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    return torch.stack([L, a, bb], -1).clamp(0, 255).to(torch.uint8)


def _lab2rgb_tables():
    """(coefficients (3, 3) at 1 << 12 scaled by the white point, L ->
    (y, f(y)) (256, 2) at LAB_BASE, a/b -> X/Z from MIN_AB, inverse gamma
    table (4096,) to 0..255): Lab2RGBinteger's."""
    coef = np.rint((1 << LAB_SHIFT) * np.array(XYZ2SRGB) * np.array(D65)[None, :])
    i = np.arange(256)
    fy = LAB_BASE * (i * 100.0 / 255.0 + 16) / 116
    y = np.where(i <= 20, np.rint(LAB_BASE * i * 100.0 / 255.0 / 903.3),
                 np.rint(fy * fy / LAB_BASE * fy / LAB_BASE))
    ly = np.stack([y, np.rint(fy)], 1)
    k = np.arange(MIN_AB, LAB_BASE * 9 // 4 + MIN_AB)
    lin = np.sign(k) * (np.abs(k * 108) // 841) - LAB_BASE * 16 // 116 * 108 // 841
    xz = np.where(k <= 3390, lin, (k * k // LAB_BASE * k) // LAB_BASE)
    g = np.arange(1 << INV_GAMMA_SHIFT) / float(1 << INV_GAMMA_SHIFT)
    inv = np.where(g <= 0.0031308, g * 12.92, 1.055 * g ** (1 / 2.4) - 0.055)
    gtab = np.rint(255.0 * inv)
    return (coef.astype(np.int64), ly.astype(np.int64), xz.astype(np.int64),
            gtab.astype(np.int64))


def lab2rgb_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_LAB2RGB) of an (H, W, 3) uint8 tensor:
    OpenCV's integer path, with its shifted-multiply divisions of a by 500
    and b by 200."""
    coef_np, ly_np, xz_np, gtab_np = _lab2rgb_tables()
    dev = img.device
    ly, xz, gtab = (torch.from_numpy(t).to(dev) for t in (ly_np, xz_np, gtab_np))
    x = img.to(torch.int64)
    y, ify = ly[x[..., 0], 0], ly[x[..., 0], 1]
    adiv = ((5 * x[..., 1] * 53687 + (1 << 7)) >> 13) - 128 * LAB_BASE // 500
    bdiv = ((x[..., 2] * 41943 + (1 << 4)) >> 9) - 128 * LAB_BASE // 200 + 1
    top = len(xz_np) - 1
    xx = xz[(ify + adiv - MIN_AB).clamp(0, top)]
    zz = xz[(ify - bdiv - MIN_AB).clamp(0, top)]
    shift = LAB_SHIFT + (14 - INV_GAMMA_SHIFT)
    out = [gtab[_descale(row[0] * xx + row[1] * y + row[2] * zz, shift)
                .clamp(0, (1 << INV_GAMMA_SHIFT) - 1)] for row in coef_np.tolist()]
    return torch.stack(out, -1).to(torch.uint8)


def clahe_u8(gray: torch.Tensor, clip_limit: float = 4.0,
             tile_grid: tuple[int, int] = (8, 8)) -> torch.Tensor:
    """cv2.createCLAHE(clip_limit, tile_grid).apply(gray) of an (H, W) uint8
    tensor. Unless both sides divide into the grid, the image is padded
    bottom and right by (tiles - side % tiles) with BORDER_REFLECT_101; each
    tile's histogram is clipped at int(clip_limit * area / 256) (at least
    1), the excess spread evenly and its remainder over every
    max(256 // r, 1)-th bin; the LUT is the cumulative count times 255 /
    area in float32, rounded; each pixel blends the LUTs of its four
    nearest tile centres bilinearly in float32."""
    tx, ty = int(tile_grid[0]), int(tile_grid[1])
    h, w = gray.shape
    dev = gray.device
    src = gray
    if h % ty or w % tx:
        iy = _reflect101(h, ty - h % ty, dev)[ty - h % ty:]
        ix = _reflect101(w, tx - w % tx, dev)[tx - w % tx:]
        src = gray.index_select(0, iy).index_select(1, ix)
    th, tw = src.shape[0] // ty, src.shape[1] // tx
    area = th * tw
    tiles = src.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(ty * tx, area)
    key = tiles.to(torch.int64) + 256 * torch.arange(ty * tx, device=dev)[:, None]
    hist = torch.bincount(key.reshape(-1), minlength=ty * tx * 256).reshape(ty * tx, 256)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        clipped = (hist - limit).clamp(min=0).sum(1, keepdim=True)
        hist = hist.clamp(max=limit) + clipped // 256
        residual = clipped % 256
        step = (256 // residual.clamp(min=1)).clamp(min=1)
        i = torch.arange(256, device=dev)[None, :]
        hist = hist + ((residual > 0) & (i % step == 0) & (i // step < residual)).long()
    scale = np.float32(255) / np.float32(area)   # float32, as cv2's lutScale
    lut = torch.round(hist.cumsum(1).float() * scale).clamp(0, 255)

    def axis(n, size, count):
        f = torch.arange(n, device=dev, dtype=torch.float32) * (np.float32(1) / np.float32(size)) \
            - np.float32(0.5)
        lo = torch.floor(f)
        a = f - lo
        lo = lo.long()
        return lo.clamp(min=0), (lo + 1).clamp(max=count - 1), a, 1 - a

    x1, x2, xa, xa1 = axis(w, tw, tx)
    y1, y2, ya, ya1 = axis(h, th, ty)
    v = gray.to(torch.int64)
    flat = lut.reshape(-1)

    def at(ty_idx, tx_idx):
        return flat[(ty_idx[:, None] * tx + tx_idx[None, :]) * 256 + v]

    res = ((at(y1, x1) * xa1 + at(y1, x2) * xa) * ya1[:, None]
           + (at(y2, x1) * xa1 + at(y2, x2) * xa) * ya[:, None])
    return torch.round(res).clamp(0, 255).to(torch.uint8)
