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
