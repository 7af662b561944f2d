"""A baseline JPEG encoder equal to cv2.imencode('.jpg') byte for byte.

The card's machine has no image encoder (no OpenCV, PIL or torchvision), and
the demo writes JPEG images and Motion-JPEG video as the JAX package's
cv2.imwrite does. `encode_jpeg(rgb, quality)` gives the bytes of
`cv2.imencode('.jpg', rgb[..., ::-1], [IMWRITE_JPEG_QUALITY, quality])`:
libjpeg-turbo with cv2's settings, all integer arithmetic:

- jcparam.c: the standard tables scaled by jpeg_quality_scaling and
  jpeg_add_quant_table, clamped to 1..255 (force_baseline);
- jccolor.c: RGB -> YCbCr through its 16-bit fixed-point tables;
- 4:2:0: jcsample.c's h2v2_downsample (the bias alternating 1, 2 along a
  row), with jcprepct.c's and jcsample.c's edge expansion (the last row and
  column replicated) to whole blocks, and jccoefct.c's dummy blocks (AC zero,
  DC copied) where the luma grid runs past the image; 4:4:4 and grey: the
  edge expansion alone;
- jfdctint.c's islow forward DCT and jcdctmgr.c's quantiser (the
  reciprocal multiply of compute_reciprocal on the divisor quantval << 3);
- jchuff.c with jstdhuff.c's tables: no optimisation, no restart interval,
  0xFF bytes stuffed with 0x00, the last byte padded with one bits;
- jcmarker.c's order: SOI, JFIF 1.01 APP0, DQT (luma, chroma), SOF0, DHT
  (DC 0, AC 0, DC 1, AC 1), SOS, the scan, EOI.

`sampling_factor=SAMPLING_FACTOR_444` gives cv2's
IMWRITE_JPEG_SAMPLING_FACTOR_444 bytes and an (H, W) array cv2's grey ones;
at quality 100 these equal what Pillow saves with subsampling=0, which the
integrity scan's restore of a truncated JPEG writes (data/datasets.py).
`encode_jpeg_cmyk` is Pillow's save of a "CMYK" image, the restore of a
CMYK or YCCK JPEG.

Every stage is numpy over whole planes; the Huffman stage builds each
block's codes by table lookup, places them by a cumulative sum of their
lengths and packs the bits with bincount, with no per-symbol Python loop.
"""
from __future__ import annotations

import struct

import numpy as np

from vision_kit_tpu_torch.data.decode import STD_HUFFMAN, ZIGZAG

# jcparam.c's std_luminance_quant_tbl and std_chrominance_quant_tbl, natural order
STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_QT = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                         + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38)

def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jpeg_set_quality(quality, force_baseline=TRUE) applied to one
    natural-order base table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _code_table(bits, symbols) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of each symbol 0..255 (jchuff.c's jpeg_make_c_derived_tbl)."""
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


# (code, length) by [table, symbol], for the DC (0) and AC (1) classes
_CODES = [np.stack([np.stack(_code_table(*STD_HUFFMAN[(ac, t)])) for t in (0, 1)], axis=1)
          for ac in (0, 1)]
_NBITS = np.zeros(1 << 16, np.int64)   # bit length of each magnitude
_NBITS[1:] = np.floor(np.log2(np.arange(1, 1 << 16))).astype(np.int64) + 1


def _rgb_to_ycc(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jccolor.c's rgb_ycc_convert on (H, W, 3) uint8 -> three int32 planes."""
    def fix(x):
        return int(x * 65536 + 0.5)

    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """`plane` grown to (rows, cols) by replicating its last row and column."""
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])),
                  mode="edge")


def _downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c's h2v2_downsample of an (even, even) plane: each 2x2 sum
    plus a bias of 1, 2, 1, 2, ... along the output row, shifted by 2."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2, 2, 1)
    return (s + bias) >> 2


# jfdctint.c's constants (the IDCT's, round(x * 2**13))
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _fdct_pass(d, shift_even, shift_odd):
    """One 1-D pass of jpeg_fdct_islow over d[0..7]; outputs 0 and 4 are
    descaled by `shift_even` (a left shift by PASS1_BITS after the rows, a
    descale by it after the columns), the rest by `shift_odd`."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if shift_even < 0:
        out[0], out[4] = (tmp10 + tmp11) << -shift_even, (tmp10 - tmp11) << -shift_even
    else:
        rnd = 1 << (shift_even - 1)
        out[0], out[4] = (tmp10 + tmp11 + rnd) >> shift_even, (tmp10 - tmp11 + rnd) >> shift_even
    rnd = 1 << (shift_odd - 1)
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = (z1 + tmp13 * _F0765 + rnd) >> shift_odd
    out[6] = (z1 - tmp12 * _F1847 + rnd) >> shift_odd
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = (tmp4 + z1 + z3 + rnd) >> shift_odd
    out[5] = (tmp5 + z2 + z4 + rnd) >> shift_odd
    out[3] = (tmp6 + z2 + z3 + rnd) >> shift_odd
    out[1] = (tmp7 + z1 + z4 + rnd) >> shift_odd
    return out


def _divisors(qt: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jcdctmgr.c's compute_reciprocal for each divisor quantval << 3:
    (reciprocal, correction, shift), so that a magnitude m quantises to
    ((m + correction) * reciprocal) >> shift."""
    divisor = qt << 3
    shift = 16 + np.floor(np.log2(divisor)).astype(np.int64)   # 16 + flss(divisor) - 1
    fq, fr = np.divmod(np.int64(1) << shift, divisor)
    corr = divisor // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > divisor // 2, fq + 1, fq))
    shift = np.where(pow2, shift - 1, shift)
    corr = np.where(~pow2 & (fr <= divisor // 2), corr + 1, corr)
    return fq, corr, shift


def _fdct_quantize(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Samples (8 R, 8 C) -> (R, C, 64) quantised coefficients in zigzag
    order: jpeg_fdct_islow on the samples less 128, then jcdctmgr.c's
    quantize (equal to its SIMD twin). int32 holds every intermediate."""
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    # (sample row, sample column, block), each 1-D pass over contiguous rows
    b = (plane.astype(np.int32) - 128).reshape(rows, 8, cols, 8).transpose(
        1, 3, 0, 2).reshape(8, 8, rows * cols)
    ws = np.stack(_fdct_pass([b[:, k] for k in range(8)], -2, 11), axis=1)  # rows
    coef = np.stack(_fdct_pass([ws[k] for k in range(8)], 2, 15), axis=0)   # columns
    coef = coef.reshape(64, rows * cols)[ZIGZAG[:64]]
    fq, corr, shift = (x[ZIGZAG[:64], None].astype(np.int32) for x in _divisors(qt))
    sign = coef >> 31                       # -1 where negative, else 0
    mag = ((np.abs(coef) + corr) * fq) >> shift
    return ((mag ^ sign) - sign).T.reshape(rows, cols, 64)


def _luma_dummies(q: np.ndarray, rows: int, cols: int) -> None:
    """jccoefct.c's dummy blocks of a 2x2-sampled component, in place: in
    the last MCU column a block past the `cols` real ones is AC zero with
    the DC of the block to its left; in the last MCU row a block row past
    the `rows` real ones is AC zero with the DC of the MCU's last block
    above it."""
    if cols < q.shape[1]:
        q[:rows, cols] = 0
        q[:rows, cols, 0] = q[:rows, cols - 1, 0]
    if rows < q.shape[0]:
        dc = q[rows - 1, 1::2, 0].copy()
        q[rows] = 0
        q[rows, 0::2, 0] = dc
        q[rows, 1::2, 0] = dc


def _entropy(blocks: np.ndarray, table: np.ndarray, comp: np.ndarray) -> np.ndarray:
    """Huffman-code (N, 64) zigzag blocks in scan order, each with its table
    (0 luma, 1 chroma) and its component (for the DC prediction) -> the
    entropy-coded bytes, stuffed and padded."""
    n = len(blocks)
    dc = blocks[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)

    def coded(values, symbol_of, tbl, ac):
        """(bits, length) of each Huffman symbol with its magnitude bits."""
        size = _NBITS[np.abs(values)]
        extra = np.where(values < 0, values + (np.int64(1) << size) - 1, values)
        sym = symbol_of(size)
        codes, lens = _CODES[ac][:, tbl, sym]
        return (codes << size) | extra, lens + size

    dc_bits, dc_len = coded(diff, lambda s: s, table, 0)

    # AC: each nonzero coefficient k of a block after the previous one p
    # (or the DC) carries (k - p - 1) // 16 ZRL codes before it, and a block
    # whose last nonzero coefficient is not the 63rd ends with EOB
    nonzero = blocks != 0
    nonzero[:, 0] = False
    flat = np.flatnonzero(nonzero)
    bi, k = flat >> 6, flat & 63
    first = np.ones(len(k), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    zrl = run >> 4
    ac_bits, ac_len = coded(blocks.ravel()[flat], lambda s: ((run & 15) << 4) | s,
                            table[bi], 1)
    last = np.zeros(n, np.int64)
    ends = np.flatnonzero(np.append(first[1:], len(k) > 0))   # each block's last nonzero
    last[bi[ends]] = k[ends]
    eob = last < 63

    # entries per block: DC, then for each nonzero its ZRLs and itself, then EOB
    per_nz = zrl + 1
    ac_count = np.bincount(bi, weights=per_nz, minlength=n).astype(np.int64)
    count = 1 + ac_count + eob
    start = np.cumsum(count) - count
    bits = np.empty(int(count.sum()), np.int64)
    lens = np.empty(len(bits), np.int64)
    bits[start], lens[start] = dc_bits, dc_len
    block_base = np.cumsum(ac_count) - ac_count
    within = np.cumsum(per_nz) - per_nz - block_base[bi]   # entries before this nonzero's
    ac_pos = start[bi] + 1 + within + zrl
    bits[ac_pos], lens[ac_pos] = ac_bits, ac_len
    if zrl.any():
        nz = np.flatnonzero(zrl)
        reps = zrl[nz]
        zpos = np.repeat(start[bi[nz]] + 1 + within[nz], reps) + (
            np.arange(int(reps.sum())) - np.repeat(np.cumsum(reps) - reps, reps))
        bits[zpos], lens[zpos] = _CODES[1][:, np.repeat(table[bi[nz]], reps), 0xF0]
    eob_pos = (start + count - 1)[eob]
    bits[eob_pos], lens[eob_pos] = _CODES[1][:, table[eob], 0]

    # pad to a whole byte with one bits, then pack: an entry of <= 27 bits
    # at bit offset o lies in the 64-bit window of 32-bit words o >> 5 and
    # (o >> 5) + 1; the entries never overlap, so the words are sums
    pad = -int(lens.sum()) % 8
    if pad:
        bits = np.append(bits, (1 << pad) - 1)
        lens = np.append(lens, pad)
    offset = np.cumsum(lens) - lens
    word = offset >> 5
    window = bits << (64 - (offset & 31) - lens)
    n_words = int((offset[-1] + lens[-1] + 31) >> 5) + 1
    hi = np.bincount(word, weights=(window >> 32).astype(np.float64), minlength=n_words)
    lo = np.bincount(word + 1, weights=(window & 0xFFFFFFFF).astype(np.float64),
                     minlength=n_words + 1)[:n_words]
    words = (hi + lo).astype(np.uint64).astype(">u4")
    out = np.frombuffer(words.tobytes(), np.uint8)[:int(offset[-1] + lens[-1]) // 8]
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


# cv2's IMWRITE_JPEG_SAMPLING_FACTOR values (h and v of each component, as
# hex digits) that encode_jpeg writes
SAMPLING_FACTOR_420, SAMPLING_FACTOR_444 = 0x221111, 0x111111
JFIF = b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00"   # 1.01, no units, 1:1
ADOBE_CMYK = b"Adobe\0\x64\0\0\0\0\0"   # version 100, no flags, transform 0
CMYK_IDS = b"CMYK"   # jcparam.c's component ids for JCS_CMYK


def _full_blocks(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """A component sampled 1x1: the last row and column replicated to whole
    blocks (jcprepct.c, jcsample.c's fullsize_downsample), then the FDCT
    and quantiser. There are no dummy blocks: an MCU is one block of it."""
    h, w = plane.shape
    return _fdct_quantize(_pad_edge(plane, -(-h // 8) * 8, -(-w // 8) * 8), qt)


def _file(app: bytes, comment: bytes | None, qts, sof: bytes, tables, sos: bytes,
          scan: bytes) -> bytes:
    """jcmarker.c's order: SOI, the JFIF or Adobe APPn, the comment (where
    Pillow writes it), one DQT a table, SOF0, one DHT a table (DC then AC
    of each table the scan names, in its order), SOS, the scan, EOI."""
    parts = [b"\xff\xd8", app]
    if comment:
        parts.append(_segment(0xFE, comment))
    parts += [_segment(0xDB, bytes([i]) + qt[ZIGZAG[:64]].astype(np.uint8).tobytes())
              for i, qt in enumerate(qts)]
    parts.append(_segment(0xC0, sof))
    for tid in tables:
        for ac in (0, 1):
            counts, symbols = STD_HUFFMAN[(ac, tid)]
            parts.append(_segment(0xC4, bytes([ac << 4 | tid, *counts]) + symbols))
    parts.append(_segment(0xDA, sos))
    return b"".join(parts) + scan + b"\xff\xd9"


def _check_size(h: int, w: int) -> None:
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG sizes are 1..65535, got {h}x{w}")


def encode_jpeg(img: np.ndarray, quality: int = 95,
                sampling_factor: int = SAMPLING_FACTOR_420,
                comment: bytes | None = None) -> bytes:
    """(H, W, 3) uint8 RGB or (H, W) grey -> the bytes of cv2.imencode('.jpg',
    its BGR (or the grey array), [IMWRITE_JPEG_QUALITY, quality,
    IMWRITE_JPEG_SAMPLING_FACTOR, sampling_factor]): baseline JFIF with the
    standard Huffman tables (see the module docstring). `sampling_factor`
    is SAMPLING_FACTOR_420 (cv2's default) or SAMPLING_FACTOR_444; a grey
    image is one component, whatever it says. At 4:4:4 these are also
    Pillow's bytes for an "RGB" or "L" image saved with subsampling=0; a
    `comment` adds the COM segment Pillow writes from the image's
    info["comment"]."""
    img = np.asarray(img)
    grey = img.ndim == 2
    if img.dtype != np.uint8 or not (grey or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 RGB or (H, W) uint8 grey, "
                         f"got {img.dtype} {img.shape}")
    if sampling_factor not in (SAMPLING_FACTOR_420, SAMPLING_FACTOR_444):
        raise ValueError(f"sampling_factor must be SAMPLING_FACTOR_420 or _444, got "
                         f"{sampling_factor:#x}")
    h, w = img.shape[:2]
    _check_size(h, w)
    app = _segment(0xE0, JFIF)
    luma_qt = quant_table(STD_LUMA_QT, quality)
    if grey:
        q = _full_blocks(img, luma_qt).reshape(-1, 64)
        scan = _entropy(q, np.zeros(len(q), np.int64), np.zeros(len(q), np.int64))
        return _file(app, comment, [luma_qt], struct.pack(">BHHB", 8, h, w, 1)
                     + bytes([1, 0x11, 0]), (0,), bytes([1, 1, 0x00, 0, 63, 0]), scan)
    qts = luma_qt, quant_table(STD_CHROMA_QT, quality)
    y, cb, cr = _rgb_to_ycc(img)
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    if sampling_factor == SAMPLING_FACTOR_444:
        planes = [_full_blocks(p, qts[min(i, 1)]) for i, p in enumerate((y, cb, cr))]
        blocks = np.stack(planes, axis=2).reshape(-1, 64)   # MCU: Y, Cb, Cr
        comp = np.tile(np.array([0, 1, 2]), len(blocks) // 3)
        scan = _entropy(blocks, np.minimum(comp, 1), comp)
        return _file(app, comment, qts, struct.pack(">BHHB", 8, h, w, 3)
                     + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1]), (0, 1), sos, scan)
    mcu_rows, mcu_cols = -(-h // 16), -(-w // 16)

    # luma: the last row and column replicated to the MCU grid; blocks past
    # ceil(h / 8) x ceil(w / 8) become jccoefct.c's dummies
    qy = _fdct_quantize(_pad_edge(y, 16 * mcu_rows, 16 * mcu_cols), qts[0])
    _luma_dummies(qy, -(-h // 8), -(-w // 8))
    # chroma: rows to even and columns to the blocks' 16 pixels replicated,
    # then downsampled, then the last row replicated to the MCU grid
    chroma = []
    for plane in (cb, cr):
        half = _downsample_h2v2(_pad_edge(plane, h + h % 2, 16 * mcu_cols))
        chroma.append(_fdct_quantize(_pad_edge(half, 8 * mcu_rows, 8 * mcu_cols), qts[1]))

    # scan order: each MCU's four luma blocks (row by row), then Cb, then Cr
    luma = qy.reshape(mcu_rows, 2, mcu_cols, 2, 64).transpose(0, 2, 1, 3, 4)
    mcus = np.concatenate([luma.reshape(mcu_rows, mcu_cols, 4, 64),
                           chroma[0][:, :, None], chroma[1][:, :, None]], axis=2)
    blocks = mcus.reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mcu_rows * mcu_cols)
    scan = _entropy(blocks, np.minimum(comp, 1), comp)
    return _file(app, comment, qts, struct.pack(">BHHB", 8, h, w, 3)
                 + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]), (0, 1), sos, scan)


def encode_jpeg_cmyk(cmyk: np.ndarray, quality: int = 95,
                     comment: bytes | None = None) -> bytes:
    """(H, W, 4) uint8 C, M, Y, K samples as libjpeg takes them (JCS_CMYK)
    -> a four-component baseline JPEG: jpeg_set_colorspace(JCS_CMYK)'s
    Adobe APP14 (transform 0) and no JFIF, every component 1x1 on the luma
    quantisation and Huffman tables, no colour transform. These are
    Pillow's bytes for a "CMYK" image saved with subsampling=0, whose
    samples it hands libjpeg inverted ("CMYK;I"): pass 255 - its values."""
    cmyk = np.asarray(cmyk)
    if cmyk.dtype != np.uint8 or cmyk.ndim != 3 or cmyk.shape[2] != 4:
        raise ValueError(f"encode_jpeg_cmyk takes (H, W, 4) uint8, got {cmyk.dtype} "
                         f"{cmyk.shape}")
    h, w = cmyk.shape[:2]
    _check_size(h, w)
    qt = quant_table(STD_LUMA_QT, quality)
    blocks = np.stack([_full_blocks(cmyk[..., i], qt) for i in range(4)],
                      axis=2).reshape(-1, 64)
    comp = np.tile(np.arange(4), len(blocks) // 4)
    scan = _entropy(blocks, np.zeros(len(blocks), np.int64), comp)
    sof = struct.pack(">BHHB", 8, h, w, 4) + b"".join(bytes([i, 0x11, 0]) for i in CMYK_IDS)
    sos = bytes([4, *b"".join(bytes([i, 0x00]) for i in CMYK_IDS), 0, 63, 0])
    return _file(_segment(0xEE, ADOBE_CMYK), comment, [qt], sof, (0,), sos, scan)


# -- lossless WebP (VP8L) ----------------------------------------------------

VP8L_MAX_SIDE = 16384            # 14-bit width and height minus one
_PREDICTOR_BITS = 4              # 16x16 tiles, one predictor mode each
_PREDICTOR_MODES = tuple(range(1, 11))   # the modes that average or copy neighbours
_MIN_COPY, _MAX_COPY = 3, 4096   # LZ77 lengths: the 24 length prefix codes reach 4096
_MAX_DISTANCE = (1 << 20) - 121  # the 40 distance prefix codes reach 2^20 less the plane codes
_CHAIN = 8                       # hash-chain links tried at a position
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ALPHABETS = (256 + 24, 256, 256, 256, 40)   # green+lengths, red, blue, alpha, distance


class _LsbWriter:
    """VP8L's bit order: each value's bits least significant first, packed
    from the low bit of each byte."""

    def __init__(self):
        self.values, self.nbits = [], []

    def put(self, value: int, n: int) -> None:
        self.values.append(value)
        self.nbits.append(n)

    def extend(self, values: np.ndarray, nbits: np.ndarray) -> None:
        self.values.extend(values.tolist())
        self.nbits.extend(nbits.tolist())

    def bytes(self) -> bytes:
        values = np.asarray(self.values, np.uint64)
        nbits = np.asarray(self.nbits, np.int64)
        start = np.concatenate([[0], np.cumsum(nbits)])
        bits = np.zeros(int(start[-1]) + 7, np.uint8)
        for b in range(int(nbits.max(initial=0))):
            on = nbits > b
            bits[start[:-1][on] + b] = (values[on] >> np.uint64(b)) & np.uint64(1)
        return np.packbits(bits[:len(bits) - len(bits) % 8], bitorder="little").tobytes()


def _huffman_lengths(counts: np.ndarray, limit: int) -> np.ndarray:
    """Code lengths of a Huffman code over `counts` no longer than `limit`
    bits (libwebp's way: while the tree is too deep, raise every used
    count to a growing floor and rebuild). A single used symbol gets
    length 0; no used symbol, all zeros."""
    import heapq

    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    lengths = np.zeros(len(counts), np.int64)
    if len(used) < 2:
        return lengths
    floor = 1
    while True:
        heap = [(max(int(counts[s]), floor), k, (int(s),)) for k, s in enumerate(used)]
        heapq.heapify(heap)
        depth = dict.fromkeys((int(s) for s in used), 0)
        tie = len(heap)
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            for s in a + b:
                depth[s] += 1
            heapq.heappush(heap, (c1 + c2, tie, a + b))
            tie += 1
        if max(depth.values()) <= limit:
            for s, d in depth.items():
                lengths[s] = d
            return lengths
        floor *= 2


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Each symbol's canonical code (ordered by length, then symbol), bit
    reversed for VP8L's least-significant-first reading."""
    codes = np.zeros(len(lengths), np.int64)
    code = 0
    for length in range(1, int(lengths.max(initial=0)) + 1):
        for s in np.flatnonzero(lengths == length).tolist():
            codes[s] = int(format(code, f"0{length}b")[::-1], 2)
            code += 1
        code <<= 1
    return codes


def _write_code(bw: _LsbWriter, counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Write the prefix code for `counts` (ReadHuffmanCode's simple form for
    at most one used symbol below 256, else the normal form with its
    code-length code) and return each symbol's (code, length)."""
    used = np.flatnonzero(counts)
    if len(used) == 1 and used[0] >= 256:   # the simple form holds 8-bit symbols only
        counts = counts.copy()
        counts[0 if used[0] else 1] = 1
        used = np.flatnonzero(counts)
    if len(used) <= 1:
        s = int(used[0]) if len(used) else 0
        bw.put(1, 1)                           # simple code
        bw.put(0, 1)                           # one symbol
        bw.put(int(s >= 2), 1)
        bw.put(s, 8 if s >= 2 else 1)
        return np.zeros(len(counts), np.int64), np.zeros(len(counts), np.int64)
    lengths = _huffman_lengths(counts, 15)
    # the lengths as code-length symbols: a literal 0-15, 16 (repeat the
    # previous length 3-6 times), 17 (3-10 zeros), 18 (11-138 zeros)
    tokens = []
    i, n = 0, len(lengths)
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and lengths[i + run] == v:
            run += 1
        if v == 0 and run >= 3:
            r = min(run, 138)
            tokens.append((18, r - 11, 7) if r >= 11 else (17, r - 3, 3))
            i += r
            continue
        tokens.append((v, 0, 0))
        i += 1
        run -= 1
        while v and run >= 3:
            r = min(run, 6)
            tokens.append((16, r - 3, 2))
            i += r
            run -= r
    cl_counts = np.bincount([t[0] for t in tokens], minlength=19)
    cl_lengths = _huffman_lengths(cl_counts, 7)
    if (cl_lengths > 0).sum() == 0:   # one code-length symbol: give it a 1-bit code
        cl_counts[(int(np.flatnonzero(cl_counts)[0]) + 1) % 19] = 1
        cl_lengths = _huffman_lengths(cl_counts, 7)
    cl_codes = _canonical_codes(cl_lengths)
    order = [cl_lengths[s] for s in _CODE_LENGTH_ORDER]
    k = 19
    while k > 4 and order[k - 1] == 0:
        k -= 1
    bw.put(0, 1)                               # normal code
    bw.put(k - 4, 4)
    for v in order[:k]:
        bw.put(int(v), 3)
    bw.put(0, 1)                               # every symbol's length is written
    for sym, extra, nbits in tokens:
        bw.put(int(cl_codes[sym]), int(cl_lengths[sym]))
        if nbits:
            bw.put(extra, nbits)
    return _canonical_codes(lengths), lengths


def _prefix(values: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """VP8L's prefix coding of values >= 1: (prefix symbol, extra bits'
    value, their count)."""
    d = np.asarray(values, np.int64) - 1
    high = np.floor(np.log2(np.maximum(d, 1))).astype(np.int64)
    small = d < 4
    nbits = np.where(small, 0, high - 1)
    second = np.where(small, 0, (d >> np.maximum(high - 1, 0)) & 1)
    symbol = np.where(small, d, 2 * high + second)
    return symbol, d & ((1 << nbits) - 1), nbits


def _run_lengths(eq: np.ndarray) -> np.ndarray:
    """For each index, how many consecutive True values of `eq` start there."""
    n = len(eq)
    idx = np.arange(n)
    last_false = np.where(~eq, idx, n)
    next_false = np.minimum.accumulate(last_false[::-1])[::-1]
    return next_false - idx


def _lz77(argb: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy LZ77 over the flat pixels: at each position the longest copy
    (at least _MIN_COPY pixels) from the pixel before, the pixel above, or
    the earlier positions of a hash chain over each pixel and the two after
    it. Returns (token start, copy length (0 for a literal), distance)."""
    n = len(argb)
    a = argb.astype(np.int64)
    near = {}
    for d in {1, width}:
        if d < n:
            run = np.zeros(n, np.int64)
            run[d:] = _run_lengths(a[d:] == a[:-d])
            near[d] = np.minimum(run, _MAX_COPY).tolist()
    # the hash chain: each position's previous one with the same 3 pixels
    ext = np.concatenate([a, [-1, -1]])
    nxt, nxt2 = ext[1:n + 1], ext[2:n + 2]
    key = (a * 0x9E3779B1 ^ nxt * 0x85EBCA77 ^ nxt2 * 0xC2B2AE3D) & ((1 << 62) - 1)
    order = np.argsort(key, kind="stable")
    prev = np.full(n, -1, np.int64)
    same = key[order[1:]] == key[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    # positions where some copy of _MIN_COPY or more may start
    cand = np.zeros(n, bool)
    for run in near.values():
        cand |= np.asarray(run) >= _MIN_COPY
    has = prev >= 0
    ok3 = np.zeros(n, bool)
    ok3[has] = ((a[has] == a[prev[has]]) & (nxt[has] == nxt[prev[has]])
                & (nxt2[has] == nxt2[prev[has]]) & (nxt2[has] >= 0))
    cand |= ok3
    starts = np.flatnonzero(cand).tolist()
    prev_l, px = prev.tolist(), a.tolist()
    tok_start, tok_len, tok_dist = [], [], []
    i = 0
    for s in starts:
        if s < i:
            continue
        best, best_d = 0, 0
        for d, run in near.items():
            if run[s] > best:
                best, best_d = run[s], d
        j, links = prev_l[s], 0
        limit = min(_MAX_COPY, n - s)
        while j >= 0 and links < _CHAIN and s - j <= _MAX_DISTANCE and best < limit:
            # a longer copy than the best so far must match at its length
            if px[j + best] == px[s + best] and px[j] == px[s]:
                length = 1
                while length < min(limit, 64) and px[j + length] == px[s + length]:
                    length += 1
                if length == 64 and limit > 64:   # a long copy: the rest at once
                    span = a[s + 64:s + limit] == a[j + 64:j + limit]
                    length = limit if span.all() else 64 + int(np.argmin(span))
                if length > best:
                    best, best_d = length, s - j
            j, links = prev_l[j], links + 1
        if best >= _MIN_COPY:
            tok_start.append(s)
            tok_len.append(best)
            tok_dist.append(best_d)
            i = s + best
    return (np.asarray(tok_start, np.int64), np.asarray(tok_len, np.int64),
            np.asarray(tok_dist, np.int64))


def _entropy_image(bw: _LsbWriter, argb: np.ndarray, width: int, copies: bool) -> None:
    """An entropy-coded image (no colour cache; the caller writes the
    meta-code bit where the main image has one): its five prefix codes,
    then each pixel as a literal or, with `copies`, inside an LZ77 copy."""
    n = len(argb)
    if copies:
        c_start, c_len, c_dist = _lz77(argb, width)
    else:
        c_start = c_len = c_dist = np.zeros(0, np.int64)
    covered = np.zeros(n + 1, np.int64)
    np.add.at(covered, c_start, 1)
    np.add.at(covered, c_start + c_len, -1)
    literal = np.cumsum(covered)[:n] == 0
    lit_pos = np.flatnonzero(literal)
    px = argb[lit_pos].astype(np.int64)
    green, red, blue, alpha = (px >> 8) & 255, (px >> 16) & 255, px & 255, (px >> 24) & 255
    len_sym, len_extra, len_nbits = _prefix(c_len)
    # plane codes 1 and 2 are the pixel above and the pixel before
    plane = np.where(c_dist == width, 1, np.where(c_dist == 1, 2, c_dist + 120))
    dist_sym, dist_extra, dist_nbits = _prefix(plane)
    counts = [np.bincount(np.concatenate([green, 256 + len_sym]), minlength=_ALPHABETS[0]),
              np.bincount(red, minlength=256), np.bincount(blue, minlength=256),
              np.bincount(alpha, minlength=256), np.bincount(dist_sym, minlength=40)]
    codes = [_write_code(bw, c) for c in counts]
    # tokens in pixel order, each four (value, bit count) slots
    starts = np.concatenate([lit_pos, c_start])
    slots_v = np.zeros((len(starts), 4), np.int64)
    slots_n = np.zeros((len(starts), 4), np.int64)
    k = len(lit_pos)
    for col, (code, sym) in enumerate(zip(codes[:4], (green, red, blue, alpha))):
        slots_v[:k, col], slots_n[:k, col] = code[0][sym], code[1][sym]
    slots_v[k:, 0], slots_n[k:, 0] = codes[0][0][256 + len_sym], codes[0][1][256 + len_sym]
    slots_v[k:, 1], slots_n[k:, 1] = len_extra, len_nbits
    slots_v[k:, 2], slots_n[k:, 2] = codes[4][0][dist_sym], codes[4][1][dist_sym]
    slots_v[k:, 3], slots_n[k:, 3] = dist_extra, dist_nbits
    order = np.argsort(starts, kind="stable")
    bw.extend(slots_v[order].reshape(-1), slots_n[order].reshape(-1))


def _predictions(p: np.ndarray) -> dict:
    """Each predictor mode's (H, W, 4) prediction from the pixels' own
    neighbours (the decoder sees the same pixels, losslessly), before the
    first row and column rules."""
    left = np.concatenate([p[:, :1], p[:, :-1]], 1)
    top = np.concatenate([p[:1], p[:-1]], 0)
    tl = np.concatenate([top[:, :1], top[:, :-1]], 1)
    tr = np.concatenate([top[:, 1:], p[:, :1]], 1)   # the last column's: this row's first
    tr[0] = top[0]

    def avg(x, y):
        return (x + y) >> 1

    return {1: left, 2: top, 3: tr, 4: tl, 5: avg(avg(left, tr), top), 6: avg(left, tl),
            7: avg(left, top), 8: avg(tl, top), 9: avg(top, tr),
            10: avg(avg(left, tl), avg(top, tr))}


def encode_webp(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> a lossless WebP (a VP8L bitstream in a RIFF
    container) that decodes to it bit for bit, in cv2.imdecode and in
    data/webp.py: the subtract-green transform, the predictor transform
    over 16x16 tiles (each tile's mode among 1-10, the one whose residuals
    cost least, sum(log2(1 + |residual|))), then the residuals with LZ77
    copies (from the pixel before, the pixel above and a hash chain) under
    length-limited canonical Huffman codes, one group, no colour cache.
    The bytes are not libwebp's (cv2.imencode('.webp') runs its method-4
    heuristics, which also try the cross-colour and palette transforms and
    a colour cache), so the files are larger than cv2's."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_webp takes (H, W, 3) uint8 RGB, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (1 <= h <= VP8L_MAX_SIDE and 1 <= w <= VP8L_MAX_SIDE):
        raise ValueError(f"{w}x{h}: a VP8L side is 1 to {VP8L_MAX_SIDE}")
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    # subtract green, then the predictor on (A, R, G, B)
    p = np.stack([np.full_like(g, 255), (r - g) & 255, g, (b - g) & 255], -1)
    preds = _predictions(p)
    tile = 1 << _PREDICTOR_BITS
    th, tw = -(-h // tile), -(-w // tile)
    cost_of = np.log2(1 + np.minimum(np.arange(256), 256 - np.arange(256)))
    best = None
    for mode in _PREDICTOR_MODES:
        cost = cost_of[(p - preds[mode]) & 255].sum(-1)
        cost = np.pad(cost, ((0, th * tile - h), (0, tw * tile - w)))
        cost = cost.reshape(th, tile, tw, tile).sum((1, 3))
        best = (cost, np.full((th, tw), mode)) if best is None else (
            np.minimum(best[0], cost), np.where(cost < best[0], mode, best[1]))
    modes = best[1]
    pred = np.choose(np.repeat(np.repeat(modes - 1, tile, 0), tile, 1)[:h, :w, None],
                     [preds[m] for m in _PREDICTOR_MODES])
    pred[0] = np.concatenate([p[0, :1], p[0, :-1]], 0)   # row 0: the left pixel
    pred[1:, 0] = p[:-1, 0]                              # column 0: the pixel above
    pred[0, 0] = (255, 0, 0, 0)                          # the first: black, opaque
    res = (p - pred) & 255
    argb = ((res[..., 0] << 24) | (res[..., 1] << 16) | (res[..., 2] << 8)
            | res[..., 3]).reshape(-1)

    bw = _LsbWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(0, 1)                                         # alpha unused
    bw.put(0, 3)                                         # version 0
    bw.put(1, 1)
    bw.put(2, 2)                                         # subtract green
    bw.put(1, 1)
    bw.put(0, 2)                                         # predictor
    bw.put(_PREDICTOR_BITS - 2, 3)
    mode_px = (0xFF000000 | (modes.astype(np.int64) << 8)).reshape(-1)
    bw.put(0, 1)                                         # no colour cache
    _entropy_image(bw, mode_px, tw, copies=False)
    bw.put(0, 1)                                         # no more transforms
    bw.put(0, 1)                                         # no colour cache
    bw.put(0, 1)                                         # no meta prefix codes
    _entropy_image(bw, argb, w, copies=True)
    body = bw.bytes()
    chunk = b"VP8L" + struct.pack("<I", len(body)) + body + b"\0" * (len(body) % 2)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
