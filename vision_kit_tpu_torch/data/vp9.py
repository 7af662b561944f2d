"""VP9 (profile 0) without a codec library: the decoder cv2.VideoCapture
runs on VP9 video (libavcodec's vp9*.c behind its FFMPEG backend), bit for
bit. csrc/vp9_decode.cu is the same decoder as host C++ for the card
(`Vp9Decoder(device="cuda")`); data/vp9_tables.py holds libvpx's default
tables (read from its symbols by tests/torch_vp9_tables.py).

`Vp9Decoder.decode(packet)` takes one packet (a container's block, chunk
or sample: a frame or a superframe) and returns the Y, U and V planes of
the frame it shows, cropped to its size (chroma (h + 1) // 2 x (w + 1) //
2), or None when it shows none; a frame libavcodec refuses raises
Vp9Error naming why, and what the port refuses raises Vp9Unsupported. It
covers:

- the superframe index (each frame decoded in turn, at most one shown);
  show_existing_frame; the uncompressed header (key, inter and
  intra-only frames, sizes from the references, render sizes ignored,
  error-resilient mode, the loop filter's level, sharpness and deltas, the
  quantiser deltas and lossless mode, segmentation with its tree and
  temporal prediction probabilities and features, tile columns and rows)
  and the compressed header (tx mode, every probability update with
  inv_remap_prob's differential coding, the reference mode);
- the four saved frame contexts with reset_frame_context and
  refresh_frame_context, the backward adaptation of the coefficient, mode,
  tx, skip and MV probabilities when error_resilient_mode and
  frame_parallel_decoding_mode are both 0;
- tiles (a bool decoder each, its marker bit checked), partitions with
  their contexts, segment ids (tree, temporal prediction, the map kept
  across frames), skip, tx size, intra modes with the key-frame
  probabilities by above and left, references (single and compound,
  libvpx's contexts), find_mv_refs with the previous frame's vectors, MV
  decoding with high precision, tokens with the Pareto model and their
  contexts, dequantisation by segment;
- the DCT and ADST of 4 to 32 points (the specification's butterflies),
  the WHT of lossless frames, intra prediction with libavcodec's edges
  (127 above the frame, 129 left of the tile, rows and columns past the
  8-aligned frame repeated, above-right only inside the block and for
  4x4 transforms), the 8-tap regular, smooth and sharp filters and
  bilinear with 1/16-pel chroma, references read past their edges as
  repeated edge pixels (libavcodec's emulated edge), compound averaging;
- the loop filter with libvpx's masks (vp9_setup_mask): levels by
  segment, reference and mode, the 4-, 8- and 16-wide filters by transform
  size, the skipped inter blocks' inner edges left, the half superblocks
  at the frame's right and bottom edges, a superblock at a time (each
  plane's vertical edges, then its horizontal ones);
- the references' refresh and libavcodec's end of a tile's data
  (vpx_rac_is_end before each superblock; reading past a frame's end
  goes on into the packet's next bytes, then zeros).

Rules settled on this environment's cv2 (OpenCV 5.0.0, libavcodec 62),
each held by tests/test_torch_vp9.py:

- libavcodec first reads every frame header with cbs_vp9 (`cbs_units`,
  `cbs_header`): a header field past the end of the frame, a sync code or
  reserved bit off, or a padding bit after the uncompressed header that
  is not zero refuses the frame; a frame whose last byte looks like a
  superframe marker (110mmfff) is read as a superframe index, its length
  from that byte and its fields from the index's first byte, and refused
  when its sizes do not fit (each unit is then decoded as a frame);
- a superframe's frames are decoded in place: a frame's readers read on
  past its end into the packet's next bytes;
- the segmentation map a frame predicts from is that of the frame decoded
  before when that frame read a new map (update_map), else the one kept;
  a key, intra-only or error-resilient frame blanks it (predictions 0),
  and a frame without segmentation leaves a map of 0;
- a block smaller than 8x8 in a segment with the skip feature reads its
  modes (libvpx refuses such a block);
- an intra-only frame loads the frame context its frame_context_idx
  names and adapts into context 0; the sign biases of an error-resilient
  frame read as 0;
- the key frame's color_range is libavcodec's colour range (cv2 converts
  full-range frames with swscale's full-range coefficients,
  mpeg4.FULL_RANGE_COEFFS); an intra-only frame of profile 0 resets it to
  limited; a frame shown again keeps the range it was decoded with;
- color_space BT.709, SMPTE 240M and BT.2020 make cv2 convert with those
  matrices (its Y plane too), and the reserved value fails its conversion:
  the port converts BT.601 alone and refuses them by name
  (Vp9Unsupported); RGB is refused in profile 0 (Vp9Error), as libavcodec
  refuses it;
- profiles 1-3, references of another size than the frame (scaled motion
  compensation) and a change of the frame size are refused by name
  (Vp9Unsupported); libavcodec's own check of the references' sizes comes
  first (Vp9Error);
- a frame libavcodec refuses ends cv2's stream, a hidden frame gives no
  frame, an empty packet is skipped (VideoReader follows all three);
- at an odd height cv2's RGB comes from another swscale path (the Y plane
  equals the decoder's), as for MPEG-4 and VP8;
- with cv2's default frame threads the output may depend on timing on
  damaged streams: the port follows the single-threaded decoder
  (OPENCV_FFMPEG_THREADS=1); cv2's own clips decode alike either way.

Left different (ROADMAP, Known differences): coefficients past 16 bits in
damaged frames, which libavcodec's SIMD transforms take otherwise.

`yuv` planes convert to RGB by data/mpeg4.py:yuv420_to_rgb, cv2's swscale
arithmetic.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from vision_kit_tpu_torch.data import vp8
from vision_kit_tpu_torch.data import vp9_tables as T


class Vp9Error(ValueError):
    """A VP9 frame libavcodec refuses: cv2.VideoCapture's read fails there
    and its stream ends."""


class Vp9Unsupported(Vp9Error):
    """A VP9 stream libavcodec decodes and the port refuses by name:
    profiles 1-3, references of another size (scaled motion compensation),
    a change of the frame size."""


# -- constants -------------------------------------------------------------

INTRA_FRAME, LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME = 0, 1, 2, 3
DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, D63_PRED, \
    TM_PRED = range(10)
NEARESTMV, NEARMV, ZEROMV, NEWMV = 10, 11, 12, 13
BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8 = 0, 1, 2, 3
BLOCK_64X64 = 12
PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT = range(4)
TX_4X4, TX_8X8, TX_16X16, TX_32X32 = range(4)
ONLY_4X4, ALLOW_8X8, ALLOW_16X16, ALLOW_32X32, TX_MODE_SELECT = range(5)
SINGLE_REFERENCE, COMPOUND_REFERENCE, REFERENCE_MODE_SELECT = range(3)
EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE = range(5)
LITERAL_TO_FILTER = (EIGHTTAP_SMOOTH, EIGHTTAP, EIGHTTAP_SHARP, BILINEAR)
SEG_LVL_ALT_Q, SEG_LVL_ALT_LF, SEG_LVL_REF_FRAME, SEG_LVL_SKIP = range(4)
SEG_FEATURE_BITS = (8, 6, 2, 0)
SYNC_CODE = 0x498342
CS_RGB = 7
OTHER_MATRICES = {2: "BT.709", 4: "SMPTE 240M", 5: "BT.2020", 6: "reserved (6)"}
MV_BORDER = 16 << 3                 # how far past the frame a candidate vector may point
COMPANDED_MVREF_THRESH = 8
BW8 = tuple(int(v) for v in T.NUM_8X8_BLOCKS_WIDE)
BH8 = (1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8)
BW4 = tuple(int(v) for v in T.NUM_4X4_BLOCKS_WIDE)
BH4 = (1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16)
MI_WL = tuple(int(v) for v in T.MI_WIDTH_LOG2)
MAX_TX = tuple(int(v) for v in T.MAX_TXSIZE)
SIZE_GROUP = tuple(int(v) for v in T.SIZE_GROUP)
SUBSIZE = T.SUBSIZE.tolist()
UV_TX = T.UV_TXSIZE.tolist()
SS_SIZE = T.SS_SIZE.tolist()
PART_CTX = T.PARTITION_CONTEXT.tolist()
TX_MODE_TO_BIGGEST = (TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_32X32)
MODE_2_COUNTER = tuple(int(v) for v in T.MODE_2_COUNTER)
COUNTER_TO_CONTEXT = tuple(int(v) for v in T.COUNTER_TO_CONTEXT)
MV_REF_BLOCKS = T.MV_REF_BLOCKS.tolist()     # [bsize][i] = (row, col)
IDX_N_COLUMN_TO_SUBBLOCK = ((1, 2), (1, 3), (3, 2), (3, 3))
TX_TYPE = tuple(int(v) for v in T.INTRA_MODE_TO_TX_TYPE)   # DCT_DCT 0, ADST_DCT 1, DCT_ADST 2, ADST_ADST 3
PARETO = T.PARETO8_FULL.tolist()
INV_MAP = tuple(int(v) for v in T.INV_MAP_TABLE)
DC_Q = tuple(int(v) for v in T.DC_QLOOKUP)
AC_Q = tuple(int(v) for v in T.AC_QLOOKUP)
FILTERS = (T.SUB_PEL_FILTERS_8.astype(np.int64), T.SUB_PEL_FILTERS_8LP.astype(np.int64),
           T.SUB_PEL_FILTERS_8S.astype(np.int64), T.BILINEAR_FILTERS.astype(np.int64))
BAND_4X4 = tuple(int(v) for v in T.COEFBAND_TRANS_4X4)
BAND_8X8PLUS = tuple(int(v) for v in T.COEFBAND_TRANS_8X8PLUS)
ENERGY = (0, 1, 2, 3, 3, 4, 4, 5, 5, 5, 5, 5)      # vp9_pt_energy_class by token
CAT_PROBS = tuple(tuple(int(p) for p in t) for t in (T.CAT1_PROB, T.CAT2_PROB, T.CAT3_PROB,
                                                     T.CAT4_PROB, T.CAT5_PROB, T.CAT6_PROB))
CAT_BASE = (5, 7, 11, 19, 35, 67)


def _scans() -> list:
    """[tx size][tx type] -> (scan, neighbours as (2 per position))."""
    out = []
    for n in ("4X4", "8X8", "16X16"):
        d = (tuple(getattr(T, f"DEFAULT_SCAN_{n}").tolist()),
             getattr(T, f"DEFAULT_SCAN_{n}_NEIGHBORS").tolist())
        r = (tuple(getattr(T, f"ROW_SCAN_{n}").tolist()), getattr(T, f"ROW_SCAN_{n}_NEIGHBORS").tolist())
        c = (tuple(getattr(T, f"COL_SCAN_{n}").tolist()), getattr(T, f"COL_SCAN_{n}_NEIGHBORS").tolist())
        out.append((d, r, c, d))
    d = (tuple(T.DEFAULT_SCAN_32X32.tolist()), T.DEFAULT_SCAN_32X32_NEIGHBORS.tolist())
    out.append((d, d, d, d))
    return out


SCANS = _scans()


def default_probs() -> dict:
    """A frame context at its defaults (vp9_setup_past_independence's)."""
    coef = np.stack([T.COEF_PROBS_4X4, T.COEF_PROBS_8X8, T.COEF_PROBS_16X16,
                     T.COEF_PROBS_32X32]).astype(np.int64)
    comps = []
    for c in (T.MV_COMP0, T.MV_COMP1):
        v = [int(x) for x in c]
        comps.append(dict(sign=v[0], classes=v[1:11], class0=v[11:12], bits=v[12:22],
                          class0_fp=[v[22:25], v[25:28]], fp=v[28:31], class0_hp=v[31], hp=v[32]))
    return dict(
        coef=coef.tolist(),
        tx8=T.TX_PROBS_8X8.tolist(), tx16=T.TX_PROBS_16X16.tolist(), tx32=T.TX_PROBS_32X32.tolist(),
        skip=T.SKIP_PROBS.tolist(), inter_mode=T.INTER_MODE_PROBS.tolist(),
        interp=T.SWITCHABLE_INTERP_PROB.tolist(), intra_inter=T.INTRA_INTER_P.tolist(),
        comp_inter=T.COMP_INTER_P.tolist(), single_ref=T.SINGLE_REF_P.tolist(),
        comp_ref=T.COMP_REF_P.tolist(), y_mode=T.IF_Y_PROBS.tolist(), uv_mode=T.IF_UV_PROBS.tolist(),
        partition=T.PARTITION_PROBS.tolist(), mv_joint=T.MV_JOINTS.tolist(), mv_comp=comps)


def new_counts() -> dict:
    def z(*shape):
        return np.zeros(shape, np.int64).tolist()
    comps = [dict(sign=[0, 0], classes=[0] * 11, class0=[0, 0], bits=z(10, 2),
                  class0_fp=z(2, 4), fp=[0] * 4, class0_hp=[0, 0], hp=[0, 0]) for _ in range(2)]
    return dict(coef=z(4, 2, 2, 6, 6, 4), eob=z(4, 2, 2, 6, 6), tx8=z(2, 2), tx16=z(2, 3),
                tx32=z(2, 4), skip=z(3, 2), inter_mode=z(7, 4), interp=z(4, 3),
                intra_inter=z(4, 2), comp_inter=z(5, 2), single_ref=z(5, 2, 2), comp_ref=z(5, 2),
                y_mode=z(4, 10), uv_mode=z(10, 10), partition=z(16, 4), mv_joint=[0] * 4,
                mv_comp=comps)


# -- the raw-bit reader of the uncompressed header ------------------------------

class BitReader:
    """Bits MSB first; past the end it reads zeros (libavcodec's GetBitContext
    over a padded buffer). `f(n, name)` names each field for a writer that
    stands in for this reader."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def f(self, n: int, name: str = "") -> int:
        v = 0
        for _ in range(n):
            i = self.pos >> 3
            b = (self.data[i] >> (7 - (self.pos & 7))) & 1 if i < len(self.data) else 0
            v = (v << 1) | b
            self.pos += 1
        return v

    def su(self, n: int, name: str = "") -> int:
        """get_sbits_inv: n magnitude bits, then the sign."""
        v = self.f(n, name)
        return -v if self.f(1, name + "_sign") else v

    def byte_pos(self) -> int:
        return (self.pos + 7) >> 3


# -- the boolean decoder's helpers ----------------------------------------------

def read_tree(br, tree, probs) -> int:
    """vpx_read_tree: walk `tree` (libvpx's layout: index pairs, leaves as
    -value) with probs[i >> 1]."""
    i = 0
    while True:
        i = tree[i + br.bit(probs[i >> 1])]
        if i <= 0:
            return -i


INTRA_MODE_TREE = tuple(int(v) for v in T.INTRA_MODE_TREE)
INTER_MODE_TREE = tuple(int(v) for v in T.INTER_MODE_TREE)
PARTITION_TREE = tuple(int(v) for v in T.PARTITION_TREE)
INTERP_TREE = tuple(int(v) for v in T.SWITCHABLE_INTERP_TREE)
SEGMENT_TREE = tuple(int(v) for v in T.SEGMENT_TREE)
MV_JOINT_TREE = tuple(int(v) for v in T.MV_JOINT_TREE)
MV_CLASS_TREE = tuple(int(v) for v in T.MV_CLASS_TREE)
MV_FP_TREE = tuple(int(v) for v in T.MV_FP_TREE)
COEF_CON_TREE = tuple(int(v) for v in T.COEF_CON_TREE)
KF_PARTITION = T.KF_PARTITION_PROBS.tolist()
KF_Y_MODE = T.KF_Y_MODE_PROB.tolist()
KF_UV_MODE = T.KF_UV_MODE_PROB.tolist()


def inv_recenter_nonneg(v: int, m: int) -> int:
    if v > 2 * m:
        return v
    return m - ((v + 1) >> 1) if v & 1 else m + (v >> 1)


def update_prob(br, p: int) -> int:
    """A differential update of probability p (update_prob in libavcodec,
    decode_term_subexp + inv_remap_prob in the specification)."""
    if not br.bit(128):
        d = br.value_bits(4)
    elif not br.bit(128):
        d = br.value_bits(4) + 16
    elif not br.bit(128):
        d = br.value_bits(5) + 32
    else:
        d = br.value_bits(7)
        if d >= 65:
            d = (d << 1) - 65 + br.bit(128)
        d += 64
    if p <= 128:
        return 1 + inv_recenter_nonneg(INV_MAP[d], p - 1)
    return 255 - inv_recenter_nonneg(INV_MAP[d], 255 - p)


def diff_update(br, probs: list, i: int) -> None:
    if br.bit(252):
        probs[i] = update_prob(br, probs[i])


def mv_update(br, probs: list, i: int) -> None:
    if br.bit(252):
        probs[i] = (br.value_bits(7) << 1) | 1


# -- backward adaptation --------------------------------------------------------

def _binary_prob(n0: int, n1: int) -> int:
    den = n0 + n1
    if den == 0:
        return 128
    return min(255, max(1, (n0 * 256 + (den >> 1)) // den))


def merge_prob(pre: int, ct0: int, ct1: int, count_sat: int, max_factor: int) -> int:
    """merge_probs / adapt_prob: the pre-frame probability moved toward the
    counts' by a factor that grows with the count."""
    den = ct0 + ct1
    if den == 0:
        return pre
    prob = _binary_prob(ct0, ct1)
    factor = max_factor * min(den, count_sat) // count_sat
    return (pre * (256 - factor) + prob * factor + 128) >> 8


def mode_merge(pre: int, ct: list) -> int:
    return merge_prob(pre, ct[0], ct[1], 20, 128)


def tree_merge(tree, pre: list, counts: list, out: list) -> None:
    """vpx_tree_merge_probs."""
    def walk(i):
        left = tree[i]
        lc = counts[-left] if left <= 0 else walk(left)
        right = tree[i + 1]
        rc = counts[-right] if right <= 0 else walk(right)
        out[i >> 1] = mode_merge(pre[i >> 1], [lc, rc])
        return lc + rc
    walk(0)


# -- inverse transforms (libvpx's inv_txfm.c, which libavcodec matches) -----------
# Each 1-D transform takes a list of n integer arrays (one per input position,
# the batch along the array) and returns n arrays.

COSPI = (16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426, 15137, 14811, 14449, 14053,
         13623, 13160, 12665, 12140, 11585, 11003, 10394, 9760, 9102, 8423, 7723, 7005, 6270,
         5520, 4756, 3981, 3196, 2404, 1606, 804, 0)     # cospi_k_64 = round(16384 cos(k pi / 64))
SINPI = (0, 5283, 9929, 13377, 15212)                    # sinpi_k_9


def _rs(x):
    """dct_const_round_shift: round by 2^14."""
    return (x + 8192) >> 14


def _brev(bits: int, x: int) -> int:
    r = 0
    for i in range(bits):
        r |= ((x >> i) & 1) << (bits - 1 - i)
    return r


def _cos(angle: int) -> int:
    """cos(angle pi / 128) in 14 bits, for even angles (the specification's
    cos128 over libvpx's cospi table)."""
    a = angle & 255
    if a <= 64:
        return COSPI[a >> 1]
    if a <= 128:
        return -COSPI[(128 - a) >> 1]
    if a <= 192:
        return -COSPI[(a - 128) >> 1]
    return COSPI[(256 - a) >> 1]


def _idct_program(n: int) -> list:
    """The inverse DCT of 2^n points as the specification's sequence of
    butterflies (B: a rotation, rounded; H: a sum and difference) after the
    bit-reversal permutation."""
    prog = []

    def B(a, b, angle, flip):
        prog.append(("B", a, b, angle, flip))

    def H(a, b, flip):
        prog.append(("H", b, a) if flip else ("H", a, b))

    if n >= 5:
        for i in range(8):
            B(16 + i, 31 - i, 6 + (_brev(3, 7 - i) << 3), 0)
    if n >= 4:
        for i in range(4):
            B(8 + i, 15 - i, 12 + (_brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            H(16 + 2 * i, 17 + 2 * i, i & 1)
    if n >= 3:
        for i in range(2):
            B(4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            H(8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1)
    for i in range(2):
        B(2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            H(4 + 2 * i, 5 + 2 * i, i)
    if n >= 4:
        for i in range(2):
            B(14 - i, 9 + i, 48 + 64 * i, 1)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                H(16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    for i in range(2):
        H(i, 3 - i, 0)
    if n >= 3:
        B(6, 5, 32, 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                H(8 + 4 * i + j, 11 + 4 * i - j, i)
    if n >= 5:
        for i in range(4):
            B(29 - i, 18 + i, 48 + (i >> 1) * 64, 1)
    if n >= 3:
        for i in range(4):
            H(i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            B(13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                H(16 + i * 8 + j, 23 + i * 8 - j, i)
    if n >= 4:
        for i in range(8):
            H(i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            B(27 - i, 20 + i, 32, 1)
    if n >= 5:
        for i in range(16):
            H(i, 31 - i, 0)
    return prog


IDCT_PROGRAMS = {n: _idct_program(n) for n in (2, 3, 4, 5)}


def idct(x: list) -> list:
    size = len(x)
    n = size.bit_length() - 1
    t = [x[_brev(n, i)] for i in range(size)]
    for op in IDCT_PROGRAMS[n]:
        if op[0] == "B":     # a rotation; flipped, its outputs exchanged
            _, a, b, angle, flip = op
            c, s = _cos(angle), _cos(angle - 64)
            ta, tb = t[a], t[b]
            t[a], t[b] = _rs(ta * c - tb * s), _rs(ta * s + tb * c)
            if flip:
                t[a], t[b] = t[b], t[a]
        else:
            _, a, b = op
            ta, tb = t[a], t[b]
            t[a], t[b] = ta + tb, ta - tb
    return t


def iadst4(x: list) -> list:
    x0, x1, x2, x3 = x
    s0 = SINPI[1] * x0 + SINPI[4] * x2 + SINPI[2] * x3
    s1 = SINPI[2] * x0 - SINPI[1] * x2 - SINPI[4] * x3
    s3 = SINPI[3] * x1
    s2 = SINPI[3] * (x0 - x2 + x3)
    return [_rs(s0 + s3), _rs(s1 + s3), _rs(s2), _rs(s0 + s1 - s3)]


def iadst8(x: list) -> list:
    c = COSPI
    x0, x1, x2, x3, x4, x5, x6, x7 = x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]
    s0 = c[2] * x0 + c[30] * x1
    s1 = c[30] * x0 - c[2] * x1
    s2 = c[10] * x2 + c[22] * x3
    s3 = c[22] * x2 - c[10] * x3
    s4 = c[18] * x4 + c[14] * x5
    s5 = c[14] * x4 - c[18] * x5
    s6 = c[26] * x6 + c[6] * x7
    s7 = c[6] * x6 - c[26] * x7
    x0, x1, x2, x3 = _rs(s0 + s4), _rs(s1 + s5), _rs(s2 + s6), _rs(s3 + s7)
    x4, x5, x6, x7 = _rs(s0 - s4), _rs(s1 - s5), _rs(s2 - s6), _rs(s3 - s7)
    s4 = c[8] * x4 + c[24] * x5
    s5 = c[24] * x4 - c[8] * x5
    s6 = -c[24] * x6 + c[8] * x7
    s7 = c[8] * x6 + c[24] * x7
    x0, x1, x2, x3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
    x4, x5, x6, x7 = _rs(s4 + s6), _rs(s5 + s7), _rs(s4 - s6), _rs(s5 - s7)
    x2, x3 = _rs(c[16] * (x2 + x3)), _rs(c[16] * (x2 - x3))
    x6, x7 = _rs(c[16] * (x6 + x7)), _rs(c[16] * (x6 - x7))
    return [x0, -x4, x6, -x2, x3, -x7, x5, -x1]


def iadst16(x: list) -> list:
    c = COSPI
    x0, x1, x2, x3, x4, x5, x6, x7 = x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6]
    x8, x9, x10, x11, x12, x13, x14, x15 = x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]
    s0 = x0 * c[1] + x1 * c[31]
    s1 = x0 * c[31] - x1 * c[1]
    s2 = x2 * c[5] + x3 * c[27]
    s3 = x2 * c[27] - x3 * c[5]
    s4 = x4 * c[9] + x5 * c[23]
    s5 = x4 * c[23] - x5 * c[9]
    s6 = x6 * c[13] + x7 * c[19]
    s7 = x6 * c[19] - x7 * c[13]
    s8 = x8 * c[17] + x9 * c[15]
    s9 = x8 * c[15] - x9 * c[17]
    s10 = x10 * c[21] + x11 * c[11]
    s11 = x10 * c[11] - x11 * c[21]
    s12 = x12 * c[25] + x13 * c[7]
    s13 = x12 * c[7] - x13 * c[25]
    s14 = x14 * c[29] + x15 * c[3]
    s15 = x14 * c[3] - x15 * c[29]
    x0, x1, x2, x3 = _rs(s0 + s8), _rs(s1 + s9), _rs(s2 + s10), _rs(s3 + s11)
    x4, x5, x6, x7 = _rs(s4 + s12), _rs(s5 + s13), _rs(s6 + s14), _rs(s7 + s15)
    x8, x9, x10, x11 = _rs(s0 - s8), _rs(s1 - s9), _rs(s2 - s10), _rs(s3 - s11)
    x12, x13, x14, x15 = _rs(s4 - s12), _rs(s5 - s13), _rs(s6 - s14), _rs(s7 - s15)
    s8 = x8 * c[4] + x9 * c[28]
    s9 = x8 * c[28] - x9 * c[4]
    s10 = x10 * c[20] + x11 * c[12]
    s11 = x10 * c[12] - x11 * c[20]
    s12 = -x12 * c[28] + x13 * c[4]
    s13 = x12 * c[4] + x13 * c[28]
    s14 = -x14 * c[12] + x15 * c[20]
    s15 = x14 * c[20] + x15 * c[12]
    x0, x1, x2, x3, x4, x5, x6, x7 = (x0 + x4, x1 + x5, x2 + x6, x3 + x7, x0 - x4, x1 - x5,
                                      x2 - x6, x3 - x7)
    x8, x9, x10, x11 = _rs(s8 + s12), _rs(s9 + s13), _rs(s10 + s14), _rs(s11 + s15)
    x12, x13, x14, x15 = _rs(s8 - s12), _rs(s9 - s13), _rs(s10 - s14), _rs(s11 - s15)
    s4 = x4 * c[8] + x5 * c[24]
    s5 = x4 * c[24] - x5 * c[8]
    s6 = -x6 * c[24] + x7 * c[8]
    s7 = x6 * c[8] + x7 * c[24]
    s12 = x12 * c[8] + x13 * c[24]
    s13 = x12 * c[24] - x13 * c[8]
    s14 = -x14 * c[24] + x15 * c[8]
    s15 = x14 * c[8] + x15 * c[24]
    x0, x1, x2, x3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
    x4, x5, x6, x7 = _rs(s4 + s6), _rs(s5 + s7), _rs(s4 - s6), _rs(s5 - s7)
    x8, x9, x10, x11 = x8 + x10, x9 + x11, x8 - x10, x9 - x11
    x12, x13, x14, x15 = _rs(s12 + s14), _rs(s13 + s15), _rs(s12 - s14), _rs(s13 - s15)
    x2, x3 = _rs(-c[16] * (x2 + x3)), _rs(c[16] * (x2 - x3))
    x6, x7 = _rs(c[16] * (x6 + x7)), _rs(c[16] * (-x6 + x7))
    x10, x11 = _rs(c[16] * (x10 + x11)), _rs(c[16] * (-x10 + x11))
    x14, x15 = _rs(-c[16] * (x14 + x15)), _rs(c[16] * (x14 - x15))
    return [x0, -x8, x12, -x4, x6, x14, x10, x2, x3, x11, x15, x7, x5, -x13, x9, -x1]


_IADST = {4: iadst4, 8: iadst8, 16: iadst16}


def inverse_transform(coef: np.ndarray, tx_type: int, lossless: bool) -> np.ndarray:
    """The residual of one (n, n) block of dequantised coefficients (raster
    order): rows first, then columns, then the final rounding (4, 5, 6, 6
    bits for 4x4 ... 32x32), as libvpx's vp9_iht*_add / vpx_idct*_add; the
    WHT for lossless frames."""
    n = coef.shape[0]
    c = coef.astype(np.int64)
    if lossless:
        return iwht4(c)
    row_fn = _IADST[n] if tx_type in (2, 3) else idct      # DCT_ADST, ADST_ADST: ADST rows
    col_fn = _IADST[n] if tx_type in (1, 3) else idct      # ADST_DCT, ADST_ADST: ADST columns
    rows = row_fn([c[:, i] for i in range(n)])             # each entry: output column j over rows
    mid = np.stack(rows, axis=1)                           # (row, column) after the row pass
    cols = col_fn([mid[i, :] for i in range(n)])
    out = np.stack(cols, axis=0)
    shift = {4: 4, 8: 5, 16: 6, 32: 6}[n]
    return (out + (1 << (shift - 1))) >> shift


def iwht4(c: np.ndarray) -> np.ndarray:
    """vpx_iwht4x4_16_add: the lossless Walsh-Hadamard transform."""
    def one(a1, c1, d1, b1):
        a1 = a1 + c1
        d1 = d1 - b1
        e1 = (a1 - d1) >> 1
        b1 = e1 - b1
        c1 = e1 - c1
        a1 = a1 - b1
        d1 = d1 + c1
        return a1, b1, c1, d1

    x = c >> 2
    rows = one(x[:, 0], x[:, 1], x[:, 2], x[:, 3])
    mid = np.stack(rows, axis=1)
    cols = one(mid[0], mid[1], mid[2], mid[3])
    return np.stack(cols, axis=0)


# -- intra prediction (libvpx's vpx_dsp/intrapred.c, libavcodec's vp9dsp) -------

def intra_pred(mode: int, bs: int, a: list, al: int, l: list) -> np.ndarray:
    """The (bs, bs) prediction of `mode` from the edge: `a` the 2 * bs
    pixels above (those past what the frame has already replicated), `al`
    the one above-left, `l` the bs pixels to the left, top to bottom. The
    DC variants of a missing edge are modes 10 (left only), 11 (top only)
    and 12 (128)."""
    out = np.empty((bs, bs), np.int64)
    if mode == V_PRED:
        out[:] = np.array(a[:bs])
    elif mode == H_PRED:
        out[:] = np.array(l)[:, None]
    elif mode == DC_PRED:
        out[:] = (sum(a[:bs]) + sum(l) + bs) // (2 * bs)
    elif mode == 10:
        out[:] = (sum(l) + (bs >> 1)) // bs
    elif mode == 11:
        out[:] = (sum(a[:bs]) + (bs >> 1)) // bs
    elif mode == 12:
        out[:] = 128
    elif mode == TM_PRED:
        out[:] = np.clip(np.array(l)[:, None] + np.array(a[:bs])[None, :] - al, 0, 255)
    elif mode == D45_PRED:
        for r in range(bs):
            for c in range(bs):
                i = r + c
                out[r, c] = a[2 * bs - 1] if i == 2 * bs - 2 else \
                    (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    elif mode == D63_PRED:
        for r in range(bs):
            for c in range(bs):
                i = (r >> 1) + c
                out[r, c] = (a[i] + a[i + 1] + 1) >> 1 if not r & 1 else \
                    (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    elif mode == D207_PRED:
        ll = list(l) + [l[-1]] * (bs + 2)
        for r in range(bs):
            for c in range(bs):
                k = 2 * r + c
                i = k >> 1
                out[r, c] = (ll[i] + ll[i + 1] + 1) >> 1 if not k & 1 else \
                    (ll[i] + 2 * ll[i + 1] + ll[i + 2] + 2) >> 2
    else:
        # the diagonals through the corner: e[k], k = 0 .. 2 bs, from the
        # bottom-left pixel up the left edge, the corner, along the top
        e = list(reversed(l)) + [al] + list(a[:bs])
        if mode == D135_PRED:
            f = [0] + [(e[k - 1] + 2 * e[k] + e[k + 1] + 2) >> 2 for k in range(1, 2 * bs)]
            for r in range(bs):
                for c in range(bs):
                    out[r, c] = f[bs - r + c]
        elif mode == D117_PRED:
            for c in range(bs):
                out[0, c] = (e[bs + c] + e[bs + c + 1] + 1) >> 1          # AVG2(A[c-1], A[c])
            out[1, 0] = (l[0] + 2 * al + a[0] + 2) >> 2
            for c in range(1, bs):
                out[1, c] = (a[c - 2] if c >= 2 else al) + 2 * a[c - 1] + a[c] + 2 >> 2
            out[2, 0] = (al + 2 * l[0] + l[1] + 2) >> 2
            for r in range(3, bs):
                out[r, 0] = (l[r - 3] + 2 * l[r - 2] + l[r - 1] + 2) >> 2
            for r in range(2, bs):
                for c in range(1, bs):
                    out[r, c] = out[r - 2, c - 1]
        elif mode == D153_PRED:
            out[0, 0] = (al + l[0] + 1) >> 1
            for r in range(1, bs):
                out[r, 0] = (l[r - 1] + l[r] + 1) >> 1
            out[0, 1] = (l[0] + 2 * al + a[0] + 2) >> 2
            out[1, 1] = (al + 2 * l[0] + l[1] + 2) >> 2
            for r in range(2, bs):
                out[r, 1] = (l[r - 2] + 2 * l[r - 1] + l[r] + 2) >> 2
            for c in range(bs - 2):
                out[0, c + 2] = ((a[c - 1] if c else al) + 2 * a[c] + a[c + 1] + 2) >> 2
            for r in range(1, bs):
                for c in range(2, bs):
                    out[r, c] = out[r - 1, c - 2]
        else:
            raise AssertionError(mode)
    return out


# -- inter prediction ------------------------------------------------------------

def _filter_rows(src: np.ndarray, taps: np.ndarray, phase: np.ndarray) -> np.ndarray:
    """One 8-tap pass along axis 1: src (h, w + 7) -> (h, w), rounded by 7
    bits and clipped to 8 bits (convolve_horiz)."""
    w = src.shape[1] - 7
    acc = np.zeros((src.shape[0], w), np.int64)
    for k in range(8):
        acc += src[:, k:k + w] * taps[phase, k]
    return np.clip((acc + 64) >> 7, 0, 255)


def predict_block(plane: np.ndarray, width: int, height: int, x: int, y: int, bw: int, bh: int,
                  mvx: int, mvy: int, luma: bool, filt: int) -> np.ndarray:
    """The (bh, bw) prediction at (x, y) of a reference plane of (height,
    width) visible pixels, moved by (mvx, mvy) (eighth luma pixels, which
    are sixteenths of a chroma pixel): the reference's edge pixels repeated
    without end (libavcodec's emulated edge at the frame's size), the
    filter's horizontal pass then its vertical pass (vpx_convolve8)."""
    if luma:
        fx, fy, x, y = (mvx & 7) << 1, (mvy & 7) << 1, x + (mvx >> 3), y + (mvy >> 3)
    else:
        fx, fy, x, y = mvx & 15, mvy & 15, x + (mvx >> 4), y + (mvy >> 4)
    rows = np.clip(np.arange(y - 3, y + bh + 4), 0, height - 1)
    cols = np.clip(np.arange(x - 3, x + bw + 4), 0, width - 1)
    s = plane[rows[:, None], cols].astype(np.int64)
    taps = FILTERS[filt]
    s = _filter_rows(s, taps, fx)                       # (bh + 7, bw)
    return _filter_rows(s.T, taps, fy).T                # (bh, bw)


# -- the loop filter (vpx_dsp/loopfilter.c) ----------------------------------------

def _sc(v):
    """signed_char_clamp."""
    return np.clip(v, -128, 127)


def filter_edge(px: np.ndarray, lvl: int, limit: int, blimit: int, thresh: int, wide: int) -> None:
    """Filter one edge in place: px is (n, 16) with the 8 pixels on either
    side of the edge across axis 1 (p7 .. p0 at 0 .. 7, q0 .. q7 at 8 .. 15)
    for n positions along the edge; `wide` is 4, 8 or 16 (filter4, the
    flat filter8, the flat2 filter16)."""
    p = [px[:, 7 - i].astype(np.int64) for i in range(8)]
    q = [px[:, 8 + i].astype(np.int64) for i in range(8)]
    ad = np.abs
    mask = ((ad(p[3] - p[2]) <= limit) & (ad(p[2] - p[1]) <= limit) & (ad(p[1] - p[0]) <= limit)
            & (ad(q[1] - q[0]) <= limit) & (ad(q[2] - q[1]) <= limit) & (ad(q[3] - q[2]) <= limit)
            & (ad(p[0] - q[0]) * 2 + ad(p[1] - q[1]) // 2 <= blimit))
    if not mask.any():
        return
    hev = (ad(p[1] - p[0]) > thresh) | (ad(q[1] - q[0]) > thresh)
    flat = flat2 = np.zeros_like(mask)
    if wide >= 8:
        flat = mask & (ad(p[1] - p[0]) <= 1) & (ad(q[1] - q[0]) <= 1) & (ad(p[2] - p[0]) <= 1) \
            & (ad(q[2] - q[0]) <= 1) & (ad(p[3] - p[0]) <= 1) & (ad(q[3] - q[0]) <= 1)
    if wide == 16:
        flat2 = flat.copy()
        for i in range(4, 8):
            flat2 &= (ad(p[i] - p[0]) <= 1) & (ad(q[i] - q[0]) <= 1)
    # filter4
    ps1, ps0, qs0, qs1 = p[1] - 128, p[0] - 128, q[0] - 128, q[1] - 128
    f = np.where(hev, _sc(ps1 - qs1), 0)
    f = np.where(mask, _sc(f + 3 * (qs0 - ps0)), 0)
    f1 = _sc(f + 4) >> 3
    f2 = _sc(f + 3) >> 3
    o_q0 = _sc(qs0 - f1) + 128
    o_p0 = _sc(ps0 + f2) + 128
    f = np.where(hev, 0, (f1 + 1) >> 1)
    o_q1 = _sc(qs1 - f) + 128
    o_p1 = _sc(ps1 + f) + 128
    res = {7: o_p0, 8: o_q0, 6: o_p1, 9: o_q1}
    if wide >= 8:
        x = np.stack(p[3::-1] + q[:4], axis=1)           # p3 .. q3
        for k in range(1, 7):
            s = x[:, k]
            for j in range(k - 3, k + 4):
                s = s + x[:, min(max(j, 0), 7)]
            v = (s + 4) >> 3
            col = 4 + k
            res[col] = np.where(flat, v, res.get(col, px[:, col].astype(np.int64)))
    if wide == 16:
        x = np.stack(p[::-1] + q, axis=1)                # p7 .. q7
        for k in range(1, 15):
            s = x[:, k]
            for j in range(k - 7, k + 8):
                s = s + x[:, min(max(j, 0), 15)]
            v = (s + 8) >> 4
            res[k] = np.where(flat2, v, res.get(k, px[:, k].astype(np.int64)))
    for col, v in res.items():
        px[:, col] = v


# -- the superframe index ---------------------------------------------------------

def superframe_parts(data: bytes) -> list:
    """libavcodec's vp9_superframe_split: (offset, size) of each frame of a
    superframe (its index at the end: a marker byte 110mmfff, the sizes,
    the marker again), else of the packet itself. Vp9Error for a size of 0
    or sizes past the packet."""
    n = len(data)
    if n:
        marker = data[-1]
        if marker & 0xE0 == 0xC0:
            mag, count = ((marker >> 3) & 3) + 1, (marker & 7) + 1
            idx = 2 + mag * count
            if n >= idx and data[n - idx] == marker:
                parts, total, at = [], 0, n - idx + 1
                for _ in range(count):
                    s = int.from_bytes(data[at:at + mag], "little")
                    at += mag
                    if s <= 0 or total + s > n - idx:
                        raise Vp9Error(f"invalid frame size {s} in a superframe")
                    parts.append((total, s))
                    total += s
                return parts
    return [(0, n)]


def split_superframe(data: bytes) -> list:
    """The frames of a packet (superframe_parts), as bytes."""
    return [data[o:o + s] for o, s in superframe_parts(data)]


class _StrictBits(BitReader):
    """cbs_vp9's reader: a field past the end of the unit fails."""

    def f(self, n: int, name: str = "") -> int:
        if self.pos + n > 8 * len(self.data):
            raise Vp9Error(f"invalid value at {name or 'a header field'}: bitstream ended")
        return super().f(n, name)


def cbs_units(data: bytes) -> list:
    """cbs_vp9_split_fragment over one frame: (offset, size) of its units,
    the frame itself unless its last byte looks like a superframe marker
    (110mmfff). Then the index's length comes from that byte, and its
    fields from the index's first byte: the sizes must lie within the
    index, and the frames they give before it. libavcodec decodes each unit
    as a frame of that size."""
    n = len(data)
    if not n or data[-1] & 0xE0 != 0xC0:
        return [(0, n)]
    marker = data[-1]
    index = 2 + (((marker >> 3) & 3) + 1) * ((marker & 7) + 1)
    if index > n:
        raise Vp9Error(f"a superframe index of {index} bytes in a frame of {n}")
    first = data[n - index]
    mag, count = ((first >> 3) & 3) + 1, (first & 7) + 1
    if 2 + mag * count > index:
        raise Vp9Error("invalid value at frame_sizes: bitstream ended")
    units, pos = [], 0
    for i in range(count):
        at = n - index + 1 + i * mag
        size = int.from_bytes(data[at:at + mag], "little")
        if pos + size > n - index:
            raise Vp9Error(f"frame {i} too large in superframe: {size} bytes")
        units.append((pos, size))
        pos += size
    return units


def cbs_header(data: bytes, ref_sizes: list) -> None:
    """cbs_vp9's read of a frame's uncompressed header, which libavcodec's
    decoder runs before its own: Vp9Error where it fails (a field past the
    end, a sync code or reserved bit off, a padding bit set). ref_sizes
    holds cbs_vp9's own (width, height) of the 8 reference slots, updated
    here by the frame's refresh flags."""
    r = _StrictBits(data)
    f = r.f
    if f(2, "frame_marker") != 2:
        raise Vp9Error("invalid frame marker")
    profile = f(1, "profile_low_bit") | f(1, "profile_high_bit") << 1
    if profile == 3 and f(1, "reserved_zero"):
        raise Vp9Error("reserved_zero out of range")

    def sync():
        if f(24, "frame_sync_code") != SYNC_CODE:
            raise Vp9Error("invalid sync code")

    def color_config():
        if profile >= 2:
            f(1, "ten_or_twelve_bit")
        cs = f(3, "color_space")
        if cs != CS_RGB:
            f(1, "color_range")
            if profile in (1, 3):
                f(2, "subsampling")
                if f(1, "reserved_zero"):
                    raise Vp9Error("reserved_zero out of range")
        elif profile in (1, 3) and f(1, "reserved_zero"):
            raise Vp9Error("reserved_zero out of range")

    def frame_size():
        return f(16, "frame_width_minus_1") + 1, f(16, "frame_height_minus_1") + 1

    def render_size():
        if f(1, "render_and_frame_size_different"):
            f(32, "render_size")

    def end():
        while r.pos & 7:
            if f(1, "zero_bit"):
                raise Vp9Error("a bit that pads the uncompressed header is set")

    if f(1, "show_existing_frame"):
        f(3, "frame_to_show_map_idx")
        end()
        return
    key = not f(1, "frame_type")
    show = f(1, "show_frame")
    error_res = f(1, "error_resilient_mode")
    if key:
        sync()
        color_config()
        size = frame_size()
        render_size()
        refresh = 0xFF
    else:
        intra_only = f(1, "intra_only") if not show else 0
        if not error_res:
            f(2, "reset_frame_context")
        if intra_only:
            sync()
            if profile > 0:
                color_config()
            refresh = f(8, "refresh_frame_flags")
            size = frame_size()
            render_size()
        else:
            refresh = f(8, "refresh_frame_flags")
            idx = []
            for _ in range(3):
                idx.append(f(3, "ref_frame_idx"))
                f(1, "ref_frame_sign_bias")
            for i in range(3):
                if f(1, "found_ref"):
                    size = ref_sizes[idx[i]]
                    break
            else:
                size = frame_size()
            render_size()
            f(1, "allow_high_precision_mv")
            if not f(1, "is_filter_switchable"):
                f(2, "raw_interpolation_filter_type")
    if not error_res:
        f(2, "refresh_and_parallel")
    f(2, "frame_context_idx")
    f(6, "loop_filter_level")
    f(3, "loop_filter_sharpness")
    if f(1, "loop_filter_delta_enabled") and f(1, "loop_filter_delta_update"):
        for _ in range(6):
            if f(1, "update_delta"):
                f(7, "loop_filter_delta")
    f(8, "base_q_idx")
    for _ in range(3):
        if f(1, "delta_coded"):
            f(5, "delta_q")
    if f(1, "segmentation_enabled"):
        if f(1, "segmentation_update_map"):
            for _ in range(7):
                if f(1, "prob_coded"):
                    f(8, "segmentation_tree_probs")
            if f(1, "segmentation_temporal_update"):
                for _ in range(3):
                    if f(1, "prob_coded"):
                        f(8, "segmentation_pred_prob")
        if f(1, "segmentation_update_data"):
            f(1, "segmentation_abs_or_delta_update")
            for _ in range(8):
                for j in range(4):
                    if f(1, "feature_enabled") and SEG_FEATURE_BITS[j]:
                        f(SEG_FEATURE_BITS[j] + (j < 2), "feature_value")
    sb64_cols = (((size[0] + 7) >> 3) + 7) >> 3
    lo = 0
    while (64 << lo) < sb64_cols:
        lo += 1
    hi = 1
    while (sb64_cols >> hi) >= 4:
        hi += 1
    hi -= 1
    while lo < hi and f(1, "increment_tile_cols_log2"):
        lo += 1
    if f(1, "increment_tile_rows_log2"):
        f(1, "increment_tile_rows_log2")
    f(16, "header_size_in_bytes")
    for i in range(8):
        if refresh & (1 << i):
            ref_sizes[i] = size
    end()


class _Block:
    """One decoded block's mode info (libvpx's MODE_INFO), shared by every
    8x8 position it covers."""

    __slots__ = ("size", "skip", "tx", "inter", "ref", "mode", "sub_modes", "uv_mode", "mv",
                 "filt", "seg")

    def __init__(self, size):
        self.size = size
        self.skip = self.tx = self.inter = self.seg = 0
        self.ref = (0, -1)
        self.mode = DC_PRED
        self.sub_modes = [DC_PRED] * 4
        self.uv_mode = DC_PRED
        self.mv = [[(0, 0)] * 4, [(0, 0)] * 4]       # [ref][sub-block] = (row, col)
        self.filt = 3


class _Frame:
    """A decoded frame: its planes (uint8, the decoder's 64-aligned
    buffers), its visible size and colour range."""

    __slots__ = ("planes", "width", "height", "full_range")

    def __init__(self, planes, width, height, full_range):
        self.planes, self.width, self.height, self.full_range = planes, width, height, full_range


class Vp9Decoder:
    """Decode the frames of one VP9 stream in order (see the module
    docstring). device "cuda" runs csrc/vp9_decode.cu's host C++ decoder
    (built with nvcc at first use; a failed build raises) and "cpu" this
    module's."""

    def __init__(self, device: str = "cpu"):
        self.device = torch.device(device)
        self._c = _CDecoder() if self.device.type == "cuda" else None
        self.refs = [None] * 8
        self.ctx = [default_probs() for _ in range(4)]
        self.width = self.height = 0
        self.full_range = 0                      # the colour range of the last frame returned
        self.cur_range = 0                       # avctx->color_range: the last key or intra-only frame's
        self.last_frame = None                   # (width, height) of the frame decoded before
        self.last_shown = True
        self.last_key = False
        self.last_mvs = None                     # that frame's (ref0, ref1, mv0, mv1) by 8x8
        self.last_segmap = None                  # that frame's segmentation map
        self.segref = None                       # the map a frame predicts from (None: blank)
        self.prev_update_map = False             # the frame before read a new map
        self.lf_ref = [1, 0, -1, -1]
        self.lf_mode = [0, 0]
        self.seg = dict(enabled=0, update_map=0, temporal=0, abs=0, tree=[255] * 7,
                        pred=[255] * 3, feat=[[None] * 4 for _ in range(8)])
        self.cbs_refs = [(0, 0)] * 8             # cbs_vp9's reference sizes
        self._tail = b""                         # the packet from the frame's start on

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    def decode(self, packet: bytes):
        """(Y, U, V) uint8 planes of the packet's shown frame, None when it
        shows none; Vp9Error where libavcodec refuses a frame. A superframe's
        frames are decoded in turn; at most one of them is shown."""
        if self._c is not None:
            return self._c.decode(bytes(packet))
        shown = None
        packet = bytes(packet)
        for offset, size in superframe_parts(packet):
            frame = packet[offset:offset + size]
            units = cbs_units(frame)
            for at, n in units:
                cbs_header(frame[at:at + n], self.cbs_refs)
            for at, n in units:
                # a frame's readers read on past its end into the packet's next
                # bytes (libavcodec decodes a superframe's frames in place), zeros after
                self._tail = packet[offset + at:]
                out = self._decode_frame(frame[at:at + n])
                if out is not None:
                    shown = out
        return shown

    def range(self) -> bool:
        """Whether the last frame returned is full range (AVCOL_RANGE_JPEG):
        yuv420_to_rgb's `full_range`."""
        if self._c is not None:
            return self._c.full_range()
        return bool(self.full_range)

    # the readers, which a stream writer replaces
    def _bits(self, data: bytes):
        return BitReader(data)

    def _bool(self, data: bytes, start: int, size: int):
        if size < 1:
            raise Vp9Error("an empty partition")
        return vp8.range_decoder(self._tail or data, start, size)

    def _is_end(self, br) -> bool:
        return vp8.rac_is_end(br)

    def _header_end(self, r, data: bytes) -> None:
        """cbs_vp9's checks, which libavcodec's decoder runs over each frame
        header first: the header ends within the frame, and the bits that
        pad it to a byte are zero."""
        while r.pos & 7:
            if r.f(1, "zero_bit"):
                raise Vp9Error("a bit that pads the uncompressed header is set")
        if r.pos > 8 * len(data):
            raise Vp9Error(f"the uncompressed header runs past the frame's {len(data)} bytes")

    def _tile_readers(self, data: bytes, pos: int, rows: int, cols: int) -> list:
        """Each tile's reader in order (a 32-bit big-endian size before each
        but the last), its marker bit checked."""
        out = []
        size = len(data) - pos
        for r in range(rows):
            for c in range(cols):
                if r == rows - 1 and c == cols - 1:
                    n = size
                else:
                    n = int.from_bytes((self._tail or data)[pos:pos + 4].ljust(4, b"\0"), "big")
                    pos, size = pos + 4, size - 4
                if n > size:
                    raise Vp9Error(f"a tile of {n} bytes with {size} left in the frame")
                br = self._bool(data, pos, n)
                if br.bit(128):
                    raise Vp9Error("a tile's marker bit is set")
                out.append(br)
                pos, size = pos + n, size - n
        return out

    def _cropped(self, fr: _Frame) -> tuple:
        h, w = fr.height, fr.width
        ch, cw = (h + 1) >> 1, (w + 1) >> 1
        return (fr.planes[0][:h, :w].copy(), fr.planes[1][:ch, :cw].copy(),
                fr.planes[2][:ch, :cw].copy())

    # -- the frame headers -----------------------------------------------------

    def _color_config(self, r) -> None:
        cs = r.f(3, "color_space")
        if cs == CS_RGB:
            raise Vp9Error("RGB not supported in profile 0")
        if cs in OTHER_MATRICES:
            raise Vp9Unsupported(f"the colour space {OTHER_MATRICES[cs]}: cv2 converts it with "
                                 "its own matrix; the port converts BT.601 alone")
        self.cur_range = r.f(1, "color_range")

    def _decode_frame(self, data: bytes):
        r = self._bits(data)
        if r.f(2, "frame_marker") != 2:
            raise Vp9Error("invalid frame marker")
        profile = r.f(1, "profile_low") | r.f(1, "profile_high") << 1
        if profile == 3:
            profile += r.f(1, "reserved_zero")
        if profile > 3:
            raise Vp9Error(f"profile {profile} is not supported")
        if profile:
            raise Vp9Unsupported(f"VP9 profile {profile} (4:4:4, 4:2:2, 4:4:0 or 10/12-bit): the "
                                 "port decodes profile 0 (8-bit 4:2:0) alone")
        if r.f(1, "show_existing_frame"):
            idx = r.f(3, "frame_to_show_map_idx")
            self._header_end(r, data)
            ref = self.refs[idx]
            if ref is None:
                raise Vp9Error(f"requested reference {idx} not available")
            self.full_range = ref.full_range
            return self._cropped(ref)
        last_key = self.last_key
        key = not r.f(1, "frame_type")
        show = r.f(1, "show_frame")
        error_res = r.f(1, "error_resilient_mode")
        h = dict(key=key, show=show, error_res=error_res, intra_only=0, reset=0,
                 sign_bias=[0, 0, 0, 0], ref_idx=[0, 0, 0], hp=0, filter=0, last_key=last_key)
        use_prev = not error_res and self.last_shown
        if key:
            if r.f(24, "sync_code") != SYNC_CODE:
                raise Vp9Error("invalid sync code")
            self._color_config(r)
            refresh = 0xFF
            w, hh = r.f(16, "width_minus_1") + 1, r.f(16, "height_minus_1") + 1
            if r.f(1, "render_and_frame_size_different"):
                r.f(32, "render_size")
        else:
            h["intra_only"] = r.f(1, "intra_only") if not show else 0
            h["reset"] = 0 if error_res else r.f(2, "reset_frame_context")
            if h["intra_only"]:
                if r.f(24, "sync_code") != SYNC_CODE:
                    raise Vp9Error("invalid sync code")
                self.cur_range = 0
                refresh = r.f(8, "refresh_frame_flags")
                w, hh = r.f(16, "width_minus_1") + 1, r.f(16, "height_minus_1") + 1
                if r.f(1, "render_and_frame_size_different"):
                    r.f(32, "render_size")
            else:
                refresh = r.f(8, "refresh_frame_flags")
                for i in range(3):
                    h["ref_idx"][i] = r.f(3, "ref_frame_idx")
                    h["sign_bias"][1 + i] = r.f(1, "sign_bias") and not error_res
                if any(self.refs[i] is None for i in h["ref_idx"]):
                    raise Vp9Error("not all references are available")
                for i in range(3):
                    if r.f(1, "found_ref"):
                        ref = self.refs[h["ref_idx"][i]]
                        w, hh = ref.width, ref.height
                        break
                else:
                    w, hh = r.f(16, "width_minus_1") + 1, r.f(16, "height_minus_1") + 1
                use_prev = use_prev and self.last_frame == (w, hh)
                if r.f(1, "render_and_frame_size_different"):
                    r.f(32, "render_size")
                h["hp"] = r.f(1, "allow_high_precision_mv")
                h["filter"] = SWITCHABLE if r.f(1, "is_filter_switchable") else \
                    LITERAL_TO_FILTER[r.f(2, "raw_interpolation_filter")]
                for i in h["ref_idx"]:
                    ref = self.refs[i]
                    if (ref.width, ref.height) != (w, hh):
                        if w * 2 < ref.width or hh * 2 < ref.height or w > 16 * ref.width \
                                or hh > 16 * ref.height:
                            raise Vp9Error(f"invalid reference dimensions {ref.width}x{ref.height}"
                                           f" for a frame of {w}x{hh}")
                        raise Vp9Unsupported(
                            f"a reference of {ref.width}x{ref.height} for a frame of {w}x{hh}: "
                            "scaled motion compensation is not ported")
        if self.width and (w, hh) != (self.width, self.height):
            raise Vp9Unsupported(f"a frame of {w}x{hh} after frames of {self.width}x"
                                 f"{self.height}: the port refuses a change of the frame size")
        intra = key or h["intra_only"]
        h["intra"] = intra
        h["refresh_ctx"] = 0 if error_res else r.f(1, "refresh_frame_context")
        h["parallel"] = 1 if error_res else r.f(1, "frame_parallel_decoding_mode")
        c = r.f(2, "frame_context_idx")
        h["ctx_idx"] = 0 if intra else c
        h["c"] = c
        if key or error_res or h["intra_only"]:
            self.lf_ref, self.lf_mode = [1, 0, -1, -1], [0, 0]
            self.seg["feat"] = [[None] * 4 for _ in range(8)]
        h["level"] = r.f(6, "loop_filter_level")
        h["sharpness"] = r.f(3, "loop_filter_sharpness")
        h["lf_delta"] = r.f(1, "loop_filter_delta_enabled")
        if h["lf_delta"] and r.f(1, "loop_filter_delta_update"):
            for i in range(4):
                if r.f(1, "update_ref_delta"):
                    self.lf_ref[i] = r.su(6, "loop_filter_ref_delta")
            for i in range(2):
                if r.f(1, "update_mode_delta"):
                    self.lf_mode[i] = r.su(6, "loop_filter_mode_delta")
        base_q = r.f(8, "base_q_idx")
        dq = [r.su(4, "delta_q") if r.f(1, "delta_coded") else 0 for _ in range(3)]
        h["lossless"] = base_q == 0 and dq == [0, 0, 0]
        seg = self.seg
        seg["enabled"] = r.f(1, "segmentation_enabled")
        if seg["enabled"]:
            seg["update_map"] = r.f(1, "segmentation_update_map")
            if seg["update_map"]:
                seg["tree"] = [r.f(8, "segment_prob") if r.f(1, "prob_coded") else 255
                               for _ in range(7)]
                seg["temporal"] = r.f(1, "segmentation_temporal_update")
                if seg["temporal"]:
                    seg["pred"] = [r.f(8, "segment_pred_prob") if r.f(1, "prob_coded") else 255
                                   for _ in range(3)]
            if r.f(1, "segmentation_update_data"):
                seg["abs"] = r.f(1, "segmentation_abs_or_delta_update")
                for i in range(8):
                    feat = [None] * 4
                    for j in range(4):
                        if r.f(1, "feature_enabled"):
                            v = r.f(SEG_FEATURE_BITS[j], "feature_value")
                            if j < 2 and r.f(1, "feature_sign"):
                                v = -v
                            feat[j] = v
                    seg["feat"][i] = feat
        else:
            seg["update_map"] = seg["temporal"] = 0
        sb_cols = (((w + 7) >> 3) + 7) >> 3
        log2_cols = 0
        while sb_cols > (64 << log2_cols):
            log2_cols += 1
        max_log2 = 0
        while (sb_cols >> max_log2) >= 4:
            max_log2 += 1
        max_log2 = max(0, max_log2 - 1)
        while max_log2 > log2_cols and r.f(1, "increment_tile_cols_log2"):
            log2_cols += 1
        log2_rows = r.f(1, "tile_rows_log2")
        if log2_rows:
            log2_rows += r.f(1, "increment_tile_rows_log2")
        header_size = r.f(16, "header_size_in_bytes")
        self._header_end(r, data)
        pos = r.byte_pos()
        if header_size > len(data) - pos:
            raise Vp9Error(f"invalid compressed header size {header_size}")
        self.width, self.height = w, hh
        h.update(w=w, h=hh, base_q=base_q, dq=dq, log2_cols=log2_cols, log2_rows=log2_rows,
                 refresh=refresh, use_prev=use_prev)
        return self._decode_body(data, pos, header_size, h)

    def _compressed_header(self, br, h: dict, fc: dict) -> None:
        """The probability updates, read into the frame's context `fc`."""
        if br.bit(128):
            raise Vp9Error("the compressed header's marker bit is set")
        if h["lossless"]:
            tx_mode = ONLY_4X4
        else:
            tx_mode = br.value_bits(2)
            if tx_mode == ALLOW_32X32:
                tx_mode += br.value_bits(1)
            if tx_mode == TX_MODE_SELECT:
                for i in range(2):
                    diff_update(br, fc["tx8"][i], 0)
                for i in range(2):
                    for j in range(2):
                        diff_update(br, fc["tx16"][i], j)
                for i in range(2):
                    for j in range(3):
                        diff_update(br, fc["tx32"][i], j)
        h["tx_mode"] = tx_mode
        for t in range(TX_MODE_TO_BIGGEST[tx_mode] + 1):
            if br.value_bits(1):
                for i in range(2):
                    for j in range(2):
                        for k in range(6):
                            for m in range(3 if k == 0 else 6):
                                p = fc["coef"][t][i][j][k][m]
                                for n in range(3):
                                    diff_update(br, p, n)
        for i in range(3):
            diff_update(br, fc["skip"], i)
        h["ref_mode"] = SINGLE_REFERENCE
        if h["intra"]:
            return
        for i in range(7):
            for j in range(3):
                diff_update(br, fc["inter_mode"][i], j)
        if h["filter"] == SWITCHABLE:
            for i in range(4):
                for j in range(2):
                    diff_update(br, fc["interp"][i], j)
        for i in range(4):
            diff_update(br, fc["intra_inter"], i)
        sb = h["sign_bias"]
        if sb[2] != sb[1] or sb[3] != sb[1]:
            mode = br.value_bits(1)
            if mode:
                mode += br.value_bits(1)
            h["ref_mode"] = mode
            if sb[1] == sb[2]:
                h["fix_ref"], h["var_ref"] = ALTREF_FRAME, (LAST_FRAME, GOLDEN_FRAME)
            elif sb[1] == sb[3]:
                h["fix_ref"], h["var_ref"] = GOLDEN_FRAME, (LAST_FRAME, ALTREF_FRAME)
            else:
                h["fix_ref"], h["var_ref"] = LAST_FRAME, (GOLDEN_FRAME, ALTREF_FRAME)
            if mode == REFERENCE_MODE_SELECT:
                for i in range(5):
                    diff_update(br, fc["comp_inter"], i)
        if h["ref_mode"] != COMPOUND_REFERENCE:
            for i in range(5):
                diff_update(br, fc["single_ref"][i], 0)
                diff_update(br, fc["single_ref"][i], 1)
        if h["ref_mode"] != SINGLE_REFERENCE:
            for i in range(5):
                diff_update(br, fc["comp_ref"], i)
        for i in range(4):
            for j in range(9):
                diff_update(br, fc["y_mode"][i], j)
        for i in range(16):
            for j in range(3):
                diff_update(br, fc["partition"][i], j)
        for j in range(3):
            mv_update(br, fc["mv_joint"], j)
        for comp in fc["mv_comp"]:
            if br.bit(252):
                comp["sign"] = (br.value_bits(7) << 1) | 1
            for j in range(10):
                mv_update(br, comp["classes"], j)
            mv_update(br, comp["class0"], 0)
            for j in range(10):
                mv_update(br, comp["bits"], j)
        for comp in fc["mv_comp"]:
            for j in range(2):
                for k in range(3):
                    mv_update(br, comp["class0_fp"][j], k)
            for k in range(3):
                mv_update(br, comp["fp"], k)
        if h["hp"]:
            for comp in fc["mv_comp"]:
                if br.bit(252):
                    comp["class0_hp"] = (br.value_bits(7) << 1) | 1
                if br.bit(252):
                    comp["hp"] = (br.value_bits(7) << 1) | 1

    # -- a frame's body -----------------------------------------------------------

    def _decode_body(self, data: bytes, pos: int, header_size: int, h: dict):
        key, intra = h["key"], h["intra"]
        c = h["c"]
        if key or h["error_res"] or (h["intra_only"] and h["reset"] == 3):
            self.ctx = [default_probs() for _ in range(4)]
        elif h["intra_only"] and h["reset"] == 2:
            self.ctx[c] = default_probs()
        fc = copy.deepcopy(self.ctx[c])
        self.fc = fc
        br = self._bool(data, pos, header_size)
        self._compressed_header(br, h, fc)
        w, hh = h["w"], h["h"]
        mi_cols, mi_rows = (w + 7) >> 3, (hh + 7) >> 3
        sb_cols, sb_rows = (mi_cols + 7) >> 3, (mi_rows + 7) >> 3
        self.mi_cols, self.mi_rows = mi_cols, mi_rows
        self.h = h
        # the segmentation map this frame predicts from (libavcodec's REF_FRAME_SEGMAP):
        # the map of the frame decoded before when that frame read a new one, else
        # the one kept; blank (none) from a key, intra-only or error-resilient frame
        seg = self.seg
        retain = self.segref is not None and not self.prev_update_map
        if not retain or intra or h["error_res"]:
            self.segref = self.last_segmap if not intra and not h["error_res"] else None
        segmap = [0] * (mi_rows * mi_cols)
        if seg["enabled"] and not seg["update_map"] and not intra and not h["error_res"] \
                and self.segref is not None:
            segmap = list(self.segref)
        self.segmap = segmap
        self.write_segmap = seg["enabled"] and (seg["update_map"] or intra)
        # per-segment quantisers and loop-filter levels
        self.qmul = []
        self.lvl = []
        for s in range(8 if seg["enabled"] else 1):
            feat = seg["feat"][s] if seg["enabled"] else [None] * 4
            q = h["base_q"]
            if feat[SEG_LVL_ALT_Q] is not None:
                q = feat[SEG_LVL_ALT_Q] if seg["abs"] else q + feat[SEG_LVL_ALT_Q]
                q = min(max(q, 0), 255)
            dq = h["dq"]
            self.qmul.append(((DC_Q[min(max(q + dq[0], 0), 255)], AC_Q[q]),
                              (DC_Q[min(max(q + dq[1], 0), 255)], AC_Q[min(max(q + dq[2], 0), 255)])))
            lvl = h["level"]
            if feat[SEG_LVL_ALT_LF] is not None:
                lvl = feat[SEG_LVL_ALT_LF] if seg["abs"] else lvl + feat[SEG_LVL_ALT_LF]
                lvl = min(max(lvl, 0), 63)
            scale = 1 << (h["level"] >> 5)
            if not h["lf_delta"]:
                table = [[lvl, lvl] for _ in range(4)]
            else:
                table = [[min(max(lvl + self.lf_ref[0] * scale, 0), 63)] * 2]
                for ref in range(1, 4):
                    table.append([min(max(lvl + (self.lf_ref[ref] + self.lf_mode[m]) * scale, 0), 63)
                                  for m in range(2)])
            self.lvl.append(table)
        # the frame's buffers and state
        H, W = sb_rows * 64, sb_cols * 64
        self.planes = [np.zeros((H, W), np.int64), np.zeros((H // 2, W // 2), np.int64),
                       np.zeros((H // 2, W // 2), np.int64)]
        self.grid = [None] * (mi_rows * mi_cols)
        self.counts = new_counts()
        self.above_nz = [[0] * (sb_cols * 16), [0] * (sb_cols * 8), [0] * (sb_cols * 8)]
        self.above_part = [0] * (sb_cols * 8)
        self.above_segpred = [0] * (sb_cols * 8)
        self.sb_blocks = [[] for _ in range(sb_rows * sb_cols)]
        self.sb_cols = sb_cols
        self.ref_frames = [None] + [self.refs[i] for i in h["ref_idx"]] if not intra else None
        tile_cols, tile_rows = 1 << h["log2_cols"], 1 << h["log2_rows"]
        readers = self._tile_readers(data, pos + header_size, tile_rows, tile_cols)

        def offset(i, mis, log2):
            sbs = (mis + 7) >> 3
            return min(((i * sbs) >> log2) << 3, mis)

        for tr in range(tile_rows):
            r0, r1 = offset(tr, mi_rows, h["log2_rows"]), offset(tr + 1, mi_rows, h["log2_rows"])
            for tc in range(tile_cols):
                c0, c1 = offset(tc, mi_cols, h["log2_cols"]), offset(tc + 1, mi_cols, h["log2_cols"])
                br = readers[tr * tile_cols + tc]
                self.tile = (c0, c1)
                for mi_row in range(r0, r1, 8):
                    self.left_nz = [[0] * 16, [0] * 8, [0] * 8]
                    self.left_part = [0] * 8
                    self.left_segpred = [0] * 8
                    for mi_col in range(c0, c1, 8):
                        if self._is_end(br):
                            raise Vp9Error("a tile's data ends before its last superblock")
                        self._partition(br, mi_row, mi_col, BLOCK_64X64)
        if h["level"]:
            self._loop_filter(h)
        planes = tuple(np.clip(p, 0, 255).astype(np.uint8) for p in self.planes)
        frame = _Frame(planes, w, hh, self.cur_range)
        # backward adaptation and the saved contexts
        fid = h["ctx_idx"]
        if h["refresh_ctx"] and h["parallel"]:
            saved = self.ctx[fid]
            for t in range(TX_MODE_TO_BIGGEST[h["tx_mode"]] + 1):
                saved["coef"][t] = copy.deepcopy(fc["coef"][t])
            for k, v in fc.items():
                if k != "coef":
                    saved[k] = copy.deepcopy(v)
        elif h["refresh_ctx"]:
            self._adapt(h, fc)
        # references and what the next frame reads of this one
        for i in range(8):
            if h["refresh"] & (1 << i):
                self.refs[i] = frame
        self.last_frame = (w, hh)
        self.last_shown = bool(h["show"])
        self.last_key = key
        mvs = []
        for b in self.grid:
            mvs.append((b.ref[0], b.ref[1], b.mv[0][3], b.mv[1][3]) if b.inter else (-1, -1, 0, 0))
        self.last_mvs = mvs
        self.last_segmap = self.segmap
        self.prev_update_map = bool(seg["enabled"] and seg["update_map"])
        if not h["show"]:
            return None
        self.full_range = frame.full_range
        return self._cropped(frame)

    # -- partitions and blocks -------------------------------------------------------

    def _partition(self, br, r: int, c: int, bsize: int) -> None:
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        n8 = BW8[bsize]
        hbs = n8 >> 1
        bsl = MI_WL[bsize]
        ctx = ((self.above_part[c] >> bsl) & 1) + 2 * ((self.left_part[r & 7] >> bsl) & 1) \
            + bsl * 4
        probs = KF_PARTITION[ctx] if self.h["intra"] else self.fc["partition"][ctx]
        has_rows, has_cols = r + hbs < self.mi_rows, c + hbs < self.mi_cols
        if has_rows and has_cols:
            p = read_tree(br, PARTITION_TREE, probs)
        elif has_cols:
            p = PARTITION_SPLIT if br.bit(probs[1]) else PARTITION_HORZ
        elif has_rows:
            p = PARTITION_SPLIT if br.bit(probs[2]) else PARTITION_VERT
        else:
            p = PARTITION_SPLIT
        self.counts["partition"][ctx][p] += 1
        sub = SUBSIZE[p][bsize]
        if sub < BLOCK_8X8 or p == PARTITION_NONE:
            self._block(br, r, c, sub)
        elif p == PARTITION_HORZ:
            self._block(br, r, c, sub)
            if has_rows:
                self._block(br, r + hbs, c, sub)
        elif p == PARTITION_VERT:
            self._block(br, r, c, sub)
            if has_cols:
                self._block(br, r, c + hbs, sub)
        else:
            self._partition(br, r, c, sub)
            self._partition(br, r, c + hbs, sub)
            self._partition(br, r + hbs, c, sub)
            self._partition(br, r + hbs, c + hbs, sub)
        if bsize == BLOCK_8X8 or p != PARTITION_SPLIT:
            above, left = PART_CTX[sub]
            for i in range(n8):
                self.above_part[c + i] = above
                self.left_part[(r & 7) + i] = left

    def _block(self, br, r: int, c: int, bsize: int) -> None:
        mi_cols = self.mi_cols
        b = _Block(bsize)
        above = self.grid[(r - 1) * mi_cols + c] if r > 0 else None
        left = self.grid[r * mi_cols + c - 1] if c > self.tile[0] else None
        bw, bh = BW8[bsize], BH8[bsize]
        x_mis, y_mis = min(bw, mi_cols - c), min(bh, self.mi_rows - r)
        if self.h["intra"]:
            self._intra_frame_mode_info(br, b, r, c, above, left, x_mis, y_mis)
        else:
            self._inter_frame_mode_info(br, b, r, c, above, left, x_mis, y_mis)
        for y in range(y_mis):
            row = (r + y) * mi_cols + c
            for x in range(x_mis):
                self.grid[row + x] = b
        if self.write_segmap:
            for y in range(y_mis):
                row = (r + y) * mi_cols + c
                for x in range(x_mis):
                    self.segmap[row + x] = b.seg
        eobs = self._reconstruct(br, b, r, c)
        if b.inter and bsize >= BLOCK_8X8 and eobs == 0:
            b.skip = 1
        self.sb_blocks[(r >> 3) * self.sb_cols + (c >> 3)].append((r, c, b))

    # -- mode info ---------------------------------------------------------------------

    def _seg_feature(self, seg_id: int, j: int):
        return self.seg["feat"][seg_id][j] if self.seg["enabled"] else None

    def _read_skip(self, br, b, above, left) -> None:
        if self._seg_feature(b.seg, SEG_LVL_SKIP) is not None:
            b.skip = 1
            return
        ctx = (above.skip if above else 0) + (left.skip if left else 0)
        b.skip = br.bit(self.fc["skip"][ctx])
        self.counts["skip"][ctx][b.skip] += 1

    def _read_tx(self, br, b, above, left, allow_select: bool) -> None:
        max_tx = MAX_TX[b.size]
        tx_mode = self.h["tx_mode"]
        if allow_select and tx_mode == TX_MODE_SELECT and b.size >= BLOCK_8X8:
            a_ctx = above.tx if above and not above.skip else max_tx
            l_ctx = left.tx if left and not left.skip else max_tx
            if not left:
                l_ctx = a_ctx
            if not above:
                a_ctx = l_ctx
            ctx = int(a_ctx + l_ctx > max_tx)
            probs = (None, self.fc["tx8"], self.fc["tx16"], self.fc["tx32"])[max_tx][ctx]
            tx = br.bit(probs[0])
            if tx and max_tx >= TX_16X16:
                tx += br.bit(probs[1])
                if tx != TX_8X8 and max_tx >= TX_32X32:
                    tx += br.bit(probs[2])
            self.counts[("", "tx8", "tx16", "tx32")[max_tx]][ctx][tx] += 1
            b.tx = tx
        else:
            b.tx = min(max_tx, TX_MODE_TO_BIGGEST[tx_mode])

    def _intra_frame_mode_info(self, br, b, r, c, above, left, x_mis, y_mis) -> None:
        seg = self.seg
        if seg["enabled"] and seg["update_map"]:
            b.seg = read_tree(br, SEGMENT_TREE, seg["tree"])
        self._read_skip(br, b, above, left)
        self._read_tx(br, b, above, left, True)
        b.ref = (INTRA_FRAME, -1)

        def above_mode(i):      # vp9_above_block_mode
            if i >= 2:
                return b.sub_modes[i - 2]
            if not above or above.inter:
                return DC_PRED
            return above.sub_modes[i + 2] if above.size < BLOCK_8X8 else above.mode

        def left_mode(i):       # vp9_left_block_mode
            if i & 1:
                return b.sub_modes[i - 1]
            if not left or left.inter:
                return DC_PRED
            return left.sub_modes[i + 1] if left.size < BLOCK_8X8 else left.mode

        def read(i):
            return read_tree(br, INTRA_MODE_TREE, KF_Y_MODE[above_mode(i)][left_mode(i)])

        bs = b.size
        if bs == BLOCK_4X4:
            for i in range(4):
                b.sub_modes[i] = read(i)
            b.mode = b.sub_modes[3]
        elif bs == BLOCK_4X8:
            b.sub_modes[0] = b.sub_modes[2] = read(0)
            b.sub_modes[1] = b.sub_modes[3] = b.mode = read(1)
        elif bs == BLOCK_8X4:
            b.sub_modes[0] = b.sub_modes[1] = read(0)
            b.sub_modes[2] = b.sub_modes[3] = b.mode = read(2)
        else:
            b.mode = read(0)
            b.sub_modes = [b.mode] * 4
        b.uv_mode = read_tree(br, INTRA_MODE_TREE, KF_UV_MODE[b.mode])

    def _inter_segment_id(self, br, b, r, c, x_mis, y_mis) -> None:
        seg = self.seg
        if not seg["enabled"]:
            return
        pred = 0
        if self.segref is not None and not self.h["error_res"]:
            pred = 8
            for y in range(y_mis):
                row = (r + y) * self.mi_cols + c
                for x in range(x_mis):
                    pred = min(pred, self.segref[row + x])
        if not seg["update_map"]:
            b.seg = pred
            return
        if seg["temporal"]:
            ctx = self.above_segpred[c] + self.left_segpred[r & 7]
            flag = br.bit(seg["pred"][ctx])
            b.seg = pred if flag else read_tree(br, SEGMENT_TREE, seg["tree"])
            for x in range(BW8[b.size]):
                self.above_segpred[c + x] = flag
            for y in range(BH8[b.size]):
                self.left_segpred[(r & 7) + y] = flag
        else:
            b.seg = read_tree(br, SEGMENT_TREE, seg["tree"])

    def _inter_frame_mode_info(self, br, b, r, c, above, left, x_mis, y_mis) -> None:
        fc, counts = self.fc, self.counts
        self._inter_segment_id(br, b, r, c, x_mis, y_mis)
        self._read_skip(br, b, above, left)
        ref_feat = self._seg_feature(b.seg, SEG_LVL_REF_FRAME)
        if ref_feat is not None:
            inter = ref_feat != INTRA_FRAME
        else:
            if above and left:
                ai, li = not above.inter, not left.inter
                ctx = 3 if ai and li else int(ai or li)
            elif above or left:
                ctx = 2 * int(not (above or left).inter)
            else:
                ctx = 0
            inter = br.bit(fc["intra_inter"][ctx])
            counts["intra_inter"][ctx][inter] += 1
        b.inter = inter
        self._read_tx(br, b, above, left, not b.skip or not inter)
        if not inter:
            self._intra_block_modes(br, b)
            return
        self._read_refs(br, b, above, left, ref_feat)
        self._inter_block_modes(br, b, r, c, above, left)

    def _intra_block_modes(self, br, b) -> None:
        fc, counts = self.fc, self.counts

        def read(group):
            m = read_tree(br, INTRA_MODE_TREE, fc["y_mode"][group])
            counts["y_mode"][group][m] += 1
            return m

        bs = b.size
        if bs == BLOCK_4X4:
            for i in range(4):
                b.sub_modes[i] = read(0)
            b.mode = b.sub_modes[3]
        elif bs == BLOCK_4X8:
            b.sub_modes[0] = b.sub_modes[2] = read(0)
            b.sub_modes[1] = b.sub_modes[3] = b.mode = read(0)
        elif bs == BLOCK_8X4:
            b.sub_modes[0] = b.sub_modes[1] = read(0)
            b.sub_modes[2] = b.sub_modes[3] = b.mode = read(0)
        else:
            b.mode = read(SIZE_GROUP[bs])
            b.sub_modes = [b.mode] * 4
        b.uv_mode = read_tree(br, INTRA_MODE_TREE, fc["uv_mode"][b.mode])
        counts["uv_mode"][b.mode][b.uv_mode] += 1
        b.filt = 3
        b.ref = (INTRA_FRAME, -1)

    def _read_refs(self, br, b, above, left, ref_feat) -> None:
        """read_ref_frames with its contexts (vp9_pred_common.c)."""
        fc, counts, h = self.fc, self.counts, self.h
        if ref_feat is not None:
            b.ref = (ref_feat, -1)
            return
        mode = h["ref_mode"]
        if mode == REFERENCE_MODE_SELECT:
            ctx = self._comp_inter_ctx(above, left)
            mode = br.bit(fc["comp_inter"][ctx])
            counts["comp_inter"][ctx][mode] += 1
        if mode == COMPOUND_REFERENCE:
            idx = h["sign_bias"][h["fix_ref"]]
            ctx = self._comp_ref_ctx(above, left)
            bit = br.bit(fc["comp_ref"][ctx])
            counts["comp_ref"][ctx][bit] += 1
            refs = [0, 0]
            refs[idx] = h["fix_ref"]
            refs[1 - idx] = h["var_ref"][bit]
            b.ref = tuple(refs)
        else:
            ctx = self._single_ref_p1(above, left)
            bit = br.bit(fc["single_ref"][ctx][0])
            counts["single_ref"][ctx][0][bit] += 1
            if bit:
                ctx = self._single_ref_p2(above, left)
                bit = br.bit(fc["single_ref"][ctx][1])
                counts["single_ref"][ctx][1][bit] += 1
                b.ref = (ALTREF_FRAME if bit else GOLDEN_FRAME, -1)
            else:
                b.ref = (LAST_FRAME, -1)

    def _comp_inter_ctx(self, above, left) -> int:
        fix = self.h["fix_ref"]
        if above and left:
            a2, l2 = above.ref[1] > 0, left.ref[1] > 0
            if not a2 and not l2:
                return int(above.ref[0] == fix) ^ int(left.ref[0] == fix)
            if not a2:
                return 2 + int(above.ref[0] == fix or not above.inter)
            if not l2:
                return 2 + int(left.ref[0] == fix or not left.inter)
            return 4
        if above or left:
            e = above or left
            return int(e.ref[0] == fix) if e.ref[1] <= 0 else 3
        return 1

    def _comp_ref_ctx(self, above, left) -> int:
        h = self.h
        fix_idx = h["sign_bias"][h["fix_ref"]]
        var_idx = 1 - fix_idx
        var0, var1 = h["var_ref"]
        if above and left:
            ai, li = not above.inter, not left.inter
            if ai and li:
                return 2
            if ai or li:
                e = left if ai else above
                if e.ref[1] <= 0:
                    return 1 + 2 * int(e.ref[0] != var1)
                return 1 + 2 * int(e.ref[var_idx] != var1)
            l_sg, a_sg = left.ref[1] <= 0, above.ref[1] <= 0
            vrfa = above.ref[0] if a_sg else above.ref[var_idx]
            vrfl = left.ref[0] if l_sg else left.ref[var_idx]
            if vrfa == vrfl and var1 == vrfa:
                return 0
            if l_sg and a_sg:
                if (vrfa == h["fix_ref"] and vrfl == var0) or (vrfl == h["fix_ref"] and vrfa == var0):
                    return 4
                return 3 if vrfa == vrfl else 1
            if l_sg or a_sg:
                vrfc = vrfa if l_sg else vrfl
                rfs = vrfa if a_sg else vrfl
                if vrfc == var1 and rfs != var1:
                    return 1
                if rfs == var1 and vrfc != var1:
                    return 2
                return 4
            return 4 if vrfa == vrfl else 2
        if above or left:
            e = above or left
            if not e.inter:
                return 2
            if e.ref[1] > 0:
                return 4 * int(e.ref[var_idx] != var1)
            return 3 * int(e.ref[0] != var1)
        return 2

    @staticmethod
    def _single_ref_p1(above, left) -> int:
        L = LAST_FRAME
        if above and left:
            ai, li = not above.inter, not left.inter
            if ai and li:
                return 2
            if ai or li:
                e = left if ai else above
                if e.ref[1] <= 0:
                    return 4 * int(e.ref[0] == L)
                return 1 + int(e.ref[0] == L or e.ref[1] == L)
            a2, l2 = above.ref[1] > 0, left.ref[1] > 0
            a0, a1, l0, l1 = above.ref[0], above.ref[1], left.ref[0], left.ref[1]
            if a2 and l2:
                return 1 + int(a0 == L or a1 == L or l0 == L or l1 == L)
            if a2 or l2:
                rfs = a0 if not a2 else l0
                crf1, crf2 = (a0, a1) if a2 else (l0, l1)
                if rfs == L:
                    return 3 + int(crf1 == L or crf2 == L)
                return int(crf1 == L or crf2 == L)
            return 2 * int(a0 == L) + 2 * int(l0 == L)
        if above or left:
            e = above or left
            if not e.inter:
                return 2
            if e.ref[1] <= 0:
                return 4 * int(e.ref[0] == L)
            return 1 + int(e.ref[0] == L or e.ref[1] == L)
        return 2

    @staticmethod
    def _single_ref_p2(above, left) -> int:
        L, G, A = LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME
        if above and left:
            ai, li = not above.inter, not left.inter
            if ai and li:
                return 2
            if ai or li:
                e = left if ai else above
                if e.ref[1] <= 0:
                    if e.ref[0] == L:
                        return 3
                    return 4 * int(e.ref[0] == G)
                return 1 + 2 * int(e.ref[0] == G or e.ref[1] == G)
            a2, l2 = above.ref[1] > 0, left.ref[1] > 0
            a0, a1, l0, l1 = above.ref[0], above.ref[1], left.ref[0], left.ref[1]
            if a2 and l2:
                if a0 == l0 and a1 == l1:
                    return 3 * int(a0 == G or a1 == G or l0 == G or l1 == G)
                return 2
            if a2 or l2:
                rfs = a0 if not a2 else l0
                crf1, crf2 = (a0, a1) if a2 else (l0, l1)
                if rfs == G:
                    return 3 + int(crf1 == G or crf2 == G)
                if rfs == A:
                    return int(crf1 == G or crf2 == G)
                return 1 + 2 * int(crf1 == G or crf2 == G)
            if a0 == L and l0 == L:
                return 3
            if a0 == L or l0 == L:
                edge0 = l0 if a0 == L else a0
                return 4 * int(edge0 == G)
            return 2 * int(a0 == G) + 2 * int(l0 == G)
        if above or left:
            e = above or left
            if not e.inter or (e.ref[0] == L and e.ref[1] <= 0):
                return 2
            if e.ref[1] <= 0:
                return 4 * int(e.ref[0] == G)
            return 3 * int(e.ref[0] == G or e.ref[1] == G)
        return 2

    # -- motion vectors ----------------------------------------------------------------

    def _inside(self, r: int, c: int) -> bool:
        return 0 <= r < self.mi_rows and self.tile[0] <= c < self.tile[1]

    def _mode_context(self, b, r, c) -> int:
        counter = 0
        for dr, dc in MV_REF_BLOCKS[b.size][:2]:
            if self._inside(r + dr, c + dc):
                counter += MODE_2_COUNTER[self.grid[(r + dr) * self.mi_cols + c + dc].mode]
        return COUNTER_TO_CONTEXT[counter]

    def _find_mv_refs(self, b, r: int, c: int, ref: int, block: int) -> list:
        """find_mv_refs_idx: the first two distinct candidate vectors for
        `ref` (block >= 0: of a sub-block, whose nearest two neighbours give
        their touching sub-blocks), clamped 16 pixels past the frame."""
        found = []
        sign_bias = self.h["sign_bias"]

        def add(mv):
            if not found:
                found.append(mv)
                return False
            if mv != found[0]:
                found.append(mv)
                return True
            return False

        def scaled(cand_ref, mv):
            if sign_bias[cand_ref] != sign_bias[ref]:
                return (-mv[0], -mv[1])
            return mv

        search = MV_REF_BLOCKS[b.size]
        grid, cols = self.grid, self.mi_cols
        prev = self.last_mvs[r * cols + c] if self.h["use_prev"] else None
        different = False
        done = False
        for i, (dr, dc) in enumerate(search):
            if not self._inside(r + dr, c + dc):
                continue
            cand = grid[(r + dr) * cols + c + dc]
            different = True
            for j in (0, 1):
                if cand.ref[j] == ref:
                    if i < 2 and block >= 0 and cand.size < BLOCK_8X8:
                        mv = cand.mv[j][IDX_N_COLUMN_TO_SUBBLOCK[block][dc == 0]]
                    else:
                        mv = cand.mv[j][3]
                    done = add(mv)
                    break
            if done:
                break
        if not done and prev is not None:
            for j in (0, 1):
                if prev[j] == ref:
                    done = add(prev[2 + j])
                    break
        if not done and different:
            for dr, dc in search:
                if not self._inside(r + dr, c + dc):
                    continue
                cand = grid[(r + dr) * cols + c + dc]
                if not cand.inter:
                    continue
                if cand.ref[0] != ref:
                    done = add(scaled(cand.ref[0], cand.mv[0][3]))
                    if done:
                        break
                if cand.ref[1] > 0 and cand.ref[1] != ref and cand.mv[1][3] != cand.mv[0][3]:
                    done = add(scaled(cand.ref[1], cand.mv[1][3]))
                    if done:
                        break
        if not done and prev is not None:
            if prev[0] != ref and prev[0] > 0:
                done = add(scaled(prev[0], prev[2]))
            if not done and prev[1] > 0 and prev[1] != ref and prev[3] != prev[2]:
                done = add(scaled(prev[1], prev[3]))
        found += [(0, 0)] * (2 - len(found))
        bw, bh = BW8[b.size], BH8[b.size]
        lo_c, hi_c = -(c * 64) - MV_BORDER, (self.mi_cols - bw - c) * 64 + MV_BORDER
        lo_r, hi_r = -(r * 64) - MV_BORDER, (self.mi_rows - bh - r) * 64 + MV_BORDER
        return [(min(max(mv[0], lo_r), hi_r), min(max(mv[1], lo_c), hi_c)) for mv in found[:2]]

    def _lower(self, mv: tuple) -> tuple:
        """lower_mv_precision: odd components toward zero unless high
        precision is allowed and the vector is short."""
        if self.h["hp"] and abs(mv[0]) >> 3 < COMPANDED_MVREF_THRESH and \
                abs(mv[1]) >> 3 < COMPANDED_MVREF_THRESH:
            return mv
        return tuple(v + (-1 if v > 0 else 1) if v & 1 else v for v in mv)

    def _read_mv_component(self, br, comp: int, usehp: bool) -> int:
        p = self.fc["mv_comp"][comp]
        cnt = self.counts["mv_comp"][comp]
        sign = br.bit(p["sign"])
        cnt["sign"][sign] += 1
        cls = read_tree(br, MV_CLASS_TREE, p["classes"])
        cnt["classes"][cls] += 1
        if cls == 0:
            d = br.bit(p["class0"][0])
            cnt["class0"][d] += 1
            fr = read_tree(br, MV_FP_TREE, p["class0_fp"][d])
            cnt["class0_fp"][d][fr] += 1
            if usehp:
                hp = br.bit(p["class0_hp"])
                cnt["class0_hp"][hp] += 1
            else:
                hp = 1
                cnt["class0_hp"][1] += 1
            mag = 0
        else:
            d = 0
            for i in range(cls):
                bit = br.bit(p["bits"][i])
                cnt["bits"][i][bit] += 1
                d |= bit << i
            fr = read_tree(br, MV_FP_TREE, p["fp"])
            cnt["fp"][fr] += 1
            if usehp:
                hp = br.bit(p["hp"])
                cnt["hp"][hp] += 1
            else:
                hp = 1
                cnt["hp"][1] += 1
            mag = 2 << (cls + 2)
        mag += ((d << 3) | (fr << 1) | hp) + 1
        return -mag if sign else mag

    def _read_mv(self, br, best: tuple) -> tuple:
        usehp = bool(self.h["hp"]) and abs(best[0]) >> 3 < COMPANDED_MVREF_THRESH and \
            abs(best[1]) >> 3 < COMPANDED_MVREF_THRESH
        j = read_tree(br, MV_JOINT_TREE, self.fc["mv_joint"])
        self.counts["mv_joint"][j] += 1
        dr = self._read_mv_component(br, 0, usehp) if j in (2, 3) else 0
        dc = self._read_mv_component(br, 1, usehp) if j in (1, 3) else 0
        return (best[0] + dr, best[1] + dc)

    def _read_inter_mode(self, br, ctx: int) -> int:
        m = read_tree(br, INTER_MODE_TREE, self.fc["inter_mode"][ctx])
        self.counts["inter_mode"][ctx][m] += 1
        return NEARESTMV + m

    def _inter_block_modes(self, br, b, r, c, above, left) -> None:
        h = self.h
        compound = b.ref[1] > 0
        nrefs = 2 if compound else 1
        ctx = self._mode_context(b, r, c)
        if b.size >= BLOCK_8X8:
            if self._seg_feature(b.seg, SEG_LVL_SKIP) is not None:
                b.mode = ZEROMV         # (a smaller block reads its modes: libavcodec's rule)
            else:
                b.mode = self._read_inter_mode(br, ctx)
        if h["filter"] == SWITCHABLE:
            lt = left.filt if left else 3
            at = above.filt if above else 3
            fctx = lt if lt == at else at if lt == 3 else lt if at == 3 else 3
            b.filt = read_tree(br, INTERP_TREE, self.fc["interp"][fctx])
            self.counts["interp"][fctx][b.filt] += 1
        else:
            b.filt = h["filter"]
        if b.size >= BLOCK_8X8:
            mvs = []
            for i in range(nrefs):
                if b.mode == ZEROMV:
                    mvs.append((0, 0))
                    continue
                cands = [self._lower(mv) for mv in self._find_mv_refs(b, r, c, b.ref[i], -1)]
                if b.mode == NEWMV:
                    mvs.append(self._read_mv(br, cands[0]))
                else:
                    mvs.append(cands[0] if b.mode == NEARESTMV else cands[1])
            for i in range(nrefs):
                b.mv[i] = [mvs[i]] * 4
            return
        # sub-8x8 blocks: a mode and vector(s) for each 4x4, 4x8 or 8x4
        nw = 1 if b.size in (BLOCK_4X4, BLOCK_4X8) else 2      # sub-blocks' width in 4x4 units
        nh = 1 if b.size in (BLOCK_4X4, BLOCK_8X4) else 2
        best_new = None
        sub = [[(0, 0)] * 4 for _ in range(2)]
        for idy in range(0, 2, nh):
            for idx in range(0, 2, nw):
                k = idy * 2 + idx
                bmode = self._read_inter_mode(br, ctx)
                for i in range(nrefs):
                    if bmode in (NEARESTMV, NEARMV):
                        mv_list = self._find_mv_refs(b, r, c, b.ref[i], k)
                        nearest, near = self._sub8x8_mvs(sub[i], mv_list, k)
                        mv = nearest if bmode == NEARESTMV else near
                    elif bmode == NEWMV:
                        if best_new is None:
                            best_new = [self._lower(self._find_mv_refs(b, r, c, b.ref[j], -1)[0])
                                        for j in range(nrefs)]
                        mv = self._read_mv(br, best_new[i])
                    else:
                        mv = (0, 0)
                    sub[i][k] = mv
                    if nh == 2:
                        sub[i][k + 2] = mv
                    if nw == 2:
                        sub[i][k + 1] = mv
                b.mv = [list(s) for s in sub] if nrefs == 2 else [list(sub[0]), [(0, 0)] * 4]
                b.mode = bmode
        b.mv = [list(sub[0]), list(sub[1])]

    @staticmethod
    def _sub8x8_mvs(bmi: list, mv_list: list, k: int) -> tuple:
        """vp9_append_sub8x8_mvs_for_idx: (nearest, near) of sub-block k."""
        if k == 0:
            return mv_list[0], mv_list[1]
        if k in (1, 2):
            nearest = bmi[0]
            cands = mv_list
        else:
            nearest = bmi[2]
            cands = [bmi[1], bmi[0], mv_list[0], mv_list[1]]
        for mv in cands:
            if mv != nearest:
                return nearest, mv
        return nearest, (0, 0)

    # -- tokens and reconstruction --------------------------------------------------------

    def _tokens(self, br, tx: int, ptype: int, ref: int, ctx: int, scan, nb, dq: tuple,
                out: dict) -> int:
        """decode_coefs: one transform block's tokens into out[position]
        (dequantised, stored as libavcodec's int16); returns the end of
        block (the count of positions read)."""
        probs = self.fc["coef"][tx][ptype][ref]
        cnt = self.counts["coef"][tx][ptype][ref]
        eobc = self.counts["eob"][tx][ptype][ref]
        band = BAND_4X4 if tx == TX_4X4 else BAND_8X8PLUS
        max_eob = 16 << (tx << 1)
        cache = {}
        shift = 1 if tx == TX_32X32 else 0
        dqv = dq[0]
        i = 0
        while i < max_eob:
            bd = band[i]
            p = probs[bd][ctx]
            eobc[bd][ctx] += 1
            if not br.bit(p[0]):
                cnt[bd][ctx][3] += 1
                break
            while not br.bit(p[1]):
                cnt[bd][ctx][0] += 1
                dqv = dq[1]
                cache[scan[i]] = 0
                i += 1
                if i >= max_eob:
                    return i
                ctx = (1 + cache[nb[i][0]] + cache[nb[i][1]]) >> 1
                bd = band[i]
                p = probs[bd][ctx]
            if not br.bit(p[2]):
                cnt[bd][ctx][1] += 1
                token, val = 1, 1
            else:
                cnt[bd][ctx][2] += 1
                token = read_tree(br, COEF_CON_TREE, PARETO[p[2] - 1])
                if token <= 4:
                    val = token
                else:
                    cp = CAT_PROBS[token - 5]
                    val = 0
                    for q in cp:
                        val = (val << 1) | br.bit(q)
                    val += CAT_BASE[token - 5]
            v = (val * dqv) >> shift
            if br.bit(128):
                v = -v
            out[scan[i]] = ((v + 32768) & 0xFFFF) - 32768
            cache[scan[i]] = ENERGY[token]
            i += 1
            if i < max_eob:
                ctx = (1 + cache[nb[i][0]] + cache[nb[i][1]]) >> 1
            dqv = dq[1]
        return i

    def _intra_edges(self, plane: int, px: int, py: int, tx: int, x4: int, y4: int, w4: int,
                     r: int, c: int, mode: int) -> tuple:
        """libavcodec's check_intra_mode: the mode to run (DC without an
        edge becomes its left-only, top-only or 128 variant) and its edge
        pixels, read from the frame before the loop filter (rows and columns
        past the 8-aligned frame replicated, 127 above the frame, 129 left
        of the tile)."""
        buf = self.planes[plane]
        ss = 1 if plane else 0
        have_top = r > 0 or y4 > 0
        have_left = c > self.tile[0] or x4 > 0
        have_right = x4 < w4 - 1
        n = 4 << tx
        if mode == DC_PRED:
            mode = (DC_PRED if have_top else 10) if have_left else (11 if have_top else 12)
        needs_tr = mode in (D45_PRED, D63_PRED)
        a = [127] * (2 * n)
        if have_top:
            have = ((self.mi_cols - c) << (1 - ss)) * 4 - x4 * 4
            row = buf[py - 1]
            k = min(n, have)
            a[:k] = row[px:px + k].tolist()
            a[k:n] = [a[k - 1]] * (n - k)
            if tx == TX_4X4 and needs_tr and have_right and n + 4 <= have:
                a[4:8] = row[px + 4:px + 8].tolist()
            else:
                a[n:] = [a[n - 1]] * n
        if have_top and have_left:
            al = int(buf[py - 1, px - 1])
        else:
            al = 129 if have_top else 127
        if have_left:
            have = ((self.mi_rows - r) << (1 - ss)) * 4 - y4 * 4
            k = min(n, have)
            col = buf[py:py + k, px - 1].tolist()
            lft = col + [col[-1]] * (n - k)
        else:
            lft = [129] * n
        return mode, a, al, lft

    def _reconstruct(self, br, b, r: int, c: int) -> int:
        """Prediction, tokens and the inverse transforms of one block, in
        libvpx's order (an intra block predicts each transform block before
        its tokens); returns the blocks' summed end-of-block positions."""
        h = self.h
        bsize = b.size
        seg_q = self.qmul[b.seg if self.seg["enabled"] else 0]
        if b.skip:
            for p in range(3):
                ss = 1 if p else 0
                pb = SS_SIZE[max(bsize, BLOCK_8X8)][ss][ss]
                ax = (c * 2) >> ss
                ay = ((r & 7) * 2) >> ss
                for i in range(BW4[pb]):
                    self.above_nz[p][ax + i] = 0
                for i in range(BH4[pb]):
                    self.left_nz[p][ay + i] = 0
        if b.inter:
            self._inter_predict(b, r, c)
        total = 0
        bw8, bh8 = BW8[bsize], BH8[bsize]
        for p in range(3):
            ss = 1 if p else 0
            tx = b.tx if p == 0 else UV_TX[bsize][b.tx][1][1]
            step = 1 << tx
            pb = SS_SIZE[max(bsize, BLOCK_8X8)][ss][ss]
            w4, h4 = BW4[pb], BH4[pb]
            right = (self.mi_cols - bw8 - c) * 8 * 8
            bottom = (self.mi_rows - bh8 - r) * 8 * 8
            max_w = w4 + (right >> (5 + ss) if right < 0 else 0)
            max_h = h4 + (bottom >> (5 + ss) if bottom < 0 else 0)
            ax = (c * 2) >> ss
            ay = ((r & 7) * 2) >> ss
            x0, y0 = (c * 8) >> ss, (r * 8) >> ss
            buf = self.planes[p]
            above_nz, left_nz = self.above_nz[p], self.left_nz[p]
            dq = seg_q[1 if p else 0]
            for y4 in range(0, max_h, step):
                for x4 in range(0, max_w, step):
                    px, py = x0 + 4 * x4, y0 + 4 * y4
                    n = 4 << tx
                    if b.inter:
                        tx_type = 0
                    else:
                        mode = b.uv_mode if p else (
                            b.sub_modes[y4 * 2 + x4] if bsize < BLOCK_8X8 else b.mode)
                        tx_type = 0 if p or h["lossless"] or tx == TX_32X32 else TX_TYPE[mode]
                        run, a, al, lft = self._intra_edges(p, px, py, tx, x4, y4, w4, r, c, mode)
                        buf[py:py + n, px:px + n] = intra_pred(run, n, a, al, lft)
                    if b.skip:
                        continue
                    if tx == TX_4X4:
                        ctx = (above_nz[ax + x4] != 0) + (left_nz[ay + y4] != 0)
                    else:
                        ctx = int(any(above_nz[ax + x4:ax + x4 + step])) + \
                            int(any(left_nz[ay + y4:ay + y4 + step]))
                    scan, nb = SCANS[tx][tx_type]
                    coef = {}
                    eob = self._tokens(br, tx, 1 if p else 0, int(b.inter), ctx, scan, nb, dq, coef)
                    total += eob
                    nz = int(eob > 0)
                    ka = min(step, max_w - x4)
                    for i in range(step):
                        above_nz[ax + x4 + i] = nz if i < ka else 0
                    kl = min(step, max_h - y4)
                    for i in range(step):
                        left_nz[ay + y4 + i] = nz if i < kl else 0
                    if eob:
                        block = np.zeros((n, n), np.int64)
                        for pos, v in coef.items():
                            block[pos // n, pos % n] = v
                        res = inverse_transform(block, tx_type, h["lossless"])
                        buf[py:py + n, px:px + n] = np.clip(buf[py:py + n, px:px + n] + res, 0, 255)
        return total

    def _inter_predict(self, b, r: int, c: int) -> None:
        """The block's luma and chroma predictions from one reference, or the
        rounded average of two (vpx_convolve8_avg)."""
        bsize = b.size
        preds = []
        for i in range(2 if b.ref[1] > 0 else 1):
            ref = self.ref_frames[b.ref[i]]
            mvs = b.mv[i]
            w, hh = ref.width, ref.height
            cw, ch = (w + 1) >> 1, (hh + 1) >> 1
            if bsize >= BLOCK_8X8:
                bw, bh = BW8[bsize] * 8, BH8[bsize] * 8
                mv = mvs[3]
                y = predict_block(ref.planes[0], w, hh, c * 8, r * 8, bw, bh, mv[1], mv[0], True,
                                  b.filt)
                u = predict_block(ref.planes[1], cw, ch, c * 4, r * 4, bw >> 1, bh >> 1, mv[1], mv[0],
                                  False, b.filt)
                v = predict_block(ref.planes[2], cw, ch, c * 4, r * 4, bw >> 1, bh >> 1, mv[1], mv[0],
                                  False, b.filt)
            else:
                y = np.empty((8, 8), np.int64)
                for k in range(4):
                    mv = mvs[k]
                    bx, by = (k & 1) * 4, (k >> 1) * 4
                    y[by:by + 4, bx:bx + 4] = predict_block(ref.planes[0], w, hh, c * 8 + bx,
                                                            r * 8 + by, 4, 4, mv[1], mv[0], True,
                                                            b.filt)
                s = [sum(mvs[k][j] for k in range(4)) for j in (0, 1)]
                mv = tuple((v + 2) // 4 if v >= 0 else -((2 - v) // 4) for v in s)   # round_mv_comp_q4
                u = predict_block(ref.planes[1], cw, ch, c * 4, r * 4, 4, 4, mv[1], mv[0], False,
                                  b.filt)
                v = predict_block(ref.planes[2], cw, ch, c * 4, r * 4, 4, 4, mv[1], mv[0], False,
                                  b.filt)
            preds.append((y, u, v))
        if len(preds) == 2:
            preds = [tuple((a + bb + 1) >> 1 for a, bb in zip(preds[0], preds[1]))]
        y, u, v = preds[0]
        self.planes[0][r * 8:r * 8 + y.shape[0], c * 8:c * 8 + y.shape[1]] = y
        self.planes[1][r * 4:r * 4 + u.shape[0], c * 4:c * 4 + u.shape[1]] = u
        self.planes[2][r * 4:r * 4 + v.shape[0], c * 4:c * 4 + v.shape[1]] = v

    # -- the loop filter (libvpx's vp9_loopfilter.c masks) ---------------------------------

    def _loop_filter(self, h: dict) -> None:
        sharp = h["sharpness"]
        limits = []
        for lvl in range(64):
            lim = lvl >> ((sharp > 0) + (sharp > 4))
            if sharp > 0:
                lim = min(lim, 9 - sharp)
            lim = max(lim, 1)
            limits.append((lim, 2 * (lvl + 2) + lim, lvl >> 4))
        sb_rows = (self.mi_rows + 7) >> 3
        for sr in range(sb_rows):
            for sc in range(self.sb_cols):
                lfm = self._setup_mask(sr * 8, sc * 8)
                self._filter_sb(sr * 8, sc * 8, lfm, limits)

    def _setup_mask(self, mi_row: int, mi_col: int) -> dict:
        """vp9_setup_mask: the SB's edge masks by filter width (bit r*8+c
        for luma 8x8s, r*4+c for chroma 8x8s) and each 8x8's level."""
        left_y, above_y, left_uv, above_uv = [0] * 4, [0] * 4, [0] * 4, [0] * 4
        int_y = int_uv = 0
        lfl = [0] * 64
        lvl_tab = self.lvl
        for r, c, b in self.sb_blocks[(mi_row >> 3) * self.sb_cols + (mi_col >> 3)]:
            seg = b.seg if self.seg["enabled"] else 0
            level = lvl_tab[seg][b.ref[0]][b.mode != ZEROMV] if b.inter else lvl_tab[seg][0][0]
            if not level:
                continue
            bw, bh = BW8[b.size], BH8[b.size]
            shift_y = (r - mi_row) * 8 + (c - mi_col)
            for i in range(bh):
                for j in range(bw):
                    lfl[shift_y + i * 8 + j] = level
            txy = b.tx
            txuv = UV_TX[b.size][b.tx][1][1]
            row_bits = (1 << bw) - 1
            size_mask = sum(row_bits << (8 * i) for i in range(bh))
            above_y[txy] |= row_bits << shift_y
            left_y[txy] |= sum(1 << (8 * i) for i in range(bh)) << shift_y
            uv = not (r & 1) and not (c & 1)
            if uv:
                shift_uv = ((r - mi_row) >> 1) * 4 + ((c - mi_col) >> 1)
                w2, h2 = max(1, bw >> 1), max(1, bh >> 1)
                urow = (1 << w2) - 1
                size_uv = sum(urow << (4 * i) for i in range(h2))
                above_uv[txuv] |= urow << shift_uv
                left_uv[txuv] |= sum(1 << (4 * i) for i in range(h2)) << shift_uv
            if b.skip and b.inter:
                continue
            above_y[txy] |= (size_mask & ABOVE_TX_MASK_Y[txy]) << shift_y
            left_y[txy] |= (size_mask & LEFT_TX_MASK_Y[txy]) << shift_y
            if uv:
                above_uv[txuv] |= (size_uv & ABOVE_TX_MASK_UV[txuv]) << shift_uv
                left_uv[txuv] |= (size_uv & LEFT_TX_MASK_UV[txuv]) << shift_uv
            if txy == TX_4X4:
                int_y |= size_mask << shift_y
            if uv and txuv == TX_4X4:
                int_uv |= size_uv << shift_uv
        for m in (left_y, above_y, left_uv, above_uv):
            m[TX_16X16] |= m[TX_32X32]
        all64 = (1 << 64) - 1
        left_y[TX_8X8] |= left_y[TX_4X4] & 0x1111111111111111
        left_y[TX_4X4] &= ~0x1111111111111111 & all64
        above_y[TX_8X8] |= above_y[TX_4X4] & 0x000000FF000000FF
        above_y[TX_4X4] &= ~0x000000FF000000FF & all64
        left_uv[TX_8X8] |= left_uv[TX_4X4] & 0x1111
        left_uv[TX_4X4] &= ~0x1111 & 0xFFFF
        above_uv[TX_8X8] |= above_uv[TX_4X4] & 0x000F
        above_uv[TX_4X4] &= ~0x000F & 0xFFFF
        if mi_row + 8 > self.mi_rows:
            rows = self.mi_rows - mi_row
            mask_y = (1 << (rows << 3)) - 1
            mask_uv = (1 << (((rows + 1) >> 1) << 2)) - 1
            for i in range(3):
                left_y[i] &= mask_y
                above_y[i] &= mask_y
                left_uv[i] &= mask_uv
                above_uv[i] &= mask_uv
            int_y &= mask_y
            int_uv &= mask_uv
            if rows == 1:
                above_uv[TX_8X8] |= above_uv[TX_16X16]
                above_uv[TX_16X16] = 0
            if rows == 5:
                above_uv[TX_8X8] |= above_uv[TX_16X16] & 0xFF00
                above_uv[TX_16X16] &= ~0xFF00 & 0xFFFF
        if mi_col + 8 > self.mi_cols:
            cols = self.mi_cols - mi_col
            mask_y = ((1 << cols) - 1) * 0x0101010101010101
            mask_uv = ((1 << ((cols + 1) >> 1)) - 1) * 0x1111
            mask_uv_int = ((1 << (cols >> 1)) - 1) * 0x1111
            for i in range(3):
                left_y[i] &= mask_y
                above_y[i] &= mask_y
                left_uv[i] &= mask_uv
                above_uv[i] &= mask_uv
            int_y &= mask_y
            int_uv &= mask_uv_int
            if cols == 1:
                left_uv[TX_8X8] |= left_uv[TX_16X16]
                left_uv[TX_16X16] = 0
            if cols == 5:
                left_uv[TX_8X8] |= left_uv[TX_16X16] & 0xCCCC
                left_uv[TX_16X16] &= ~0xCCCC & 0xFFFF
        if mi_col == 0:
            for i in range(3):
                left_y[i] &= 0xFEFEFEFEFEFEFEFE
                left_uv[i] &= 0xEEEE
        return dict(left_y=left_y, above_y=above_y, int_y=int_y, left_uv=left_uv,
                    above_uv=above_uv, int_uv=int_uv, lfl=lfl)

    def _filter_sb(self, mi_row: int, mi_col: int, lfm: dict, limits: list) -> None:
        """filter_block_plane_ss00 and _ss11: each plane's vertical edges
        (left to right, the 4x4 edge inside an 8x8 after its left edge),
        then its horizontal edges (top to bottom)."""
        rows = min(8, self.mi_rows - mi_row)
        lfl = lfm["lfl"]
        for p in range(3):
            ss = 1 if p else 0
            buf = self.planes[p]
            x0, y0 = (mi_col * 8) >> ss, (mi_row * 8) >> ss
            if p == 0:
                n, lm, am, im = 8, lfm["left_y"], lfm["above_y"], lfm["int_y"]
                nrows = rows

                def level(R, C):
                    return lfl[R * 8 + C]
            else:
                n, lm, am, im = 4, lfm["left_uv"], lfm["above_uv"], lfm["int_uv"]
                nrows = (rows + 1) >> 1

                def level(R, C):
                    return lfl[(R * 2) * 8 + C * 2]
            for R in range(nrows):
                for C in range(n):
                    bit = 1 << (R * n + C)
                    x, y = x0 + C * 8, y0 + R * 8
                    lv = level(R, C)
                    wide = 16 if lm[TX_16X16] & bit else 8 if lm[TX_8X8] & bit else \
                        4 if lm[TX_4X4] & bit else 0
                    if wide:
                        _lf_vertical(buf, x, y, limits[lv], wide)
                    if im & bit:
                        _lf_vertical(buf, x + 4, y, limits[lv], 4)
            for R in range(nrows):
                mrow = mi_row + (R << ss)
                skip_int = ss and mrow == self.mi_rows - 1
                for C in range(n):
                    bit = 1 << (R * n + C)
                    x, y = x0 + C * 8, y0 + R * 8
                    lv = level(R, C)
                    wide = 0
                    if mrow:
                        wide = 16 if am[TX_16X16] & bit else 8 if am[TX_8X8] & bit else \
                            4 if am[TX_4X4] & bit else 0
                    if wide:
                        _lf_horizontal(buf, x, y, limits[lv], wide)
                    if im & bit and not skip_int:
                        _lf_horizontal(buf, x, y + 4, limits[lv], 4)

    # -- backward adaptation --------------------------------------------------------------

    def _adapt(self, h: dict, fc: dict) -> None:
        """vp9_adapt_coef_probs, vp9_adapt_mode_probs and vp9_adapt_mv_probs
        (as libavcodec's ff_vp9_adapt_probs): the saved context moves toward
        this frame's counts; a key or intra-only frame keeps its forward
        updates of the skip and tx probabilities instead."""
        pre = self.ctx[h["ctx_idx"]]
        cnt = self.counts
        uf = 112 if h["intra"] or not h["last_key"] else 128
        for t in range(4):
            for i in range(2):
                for j in range(2):
                    for k in range(6):
                        for l in range(3 if k == 0 else 6):
                            pp = pre["coef"][t][i][j][k][l]
                            e = cnt["eob"][t][i][j][k][l]
                            cc = cnt["coef"][t][i][j][k][l]
                            neob = cc[3]
                            pp[0] = merge_prob(pp[0], neob, e - neob, 24, uf)
                            pp[1] = merge_prob(pp[1], cc[0], cc[1] + cc[2], 24, uf)
                            pp[2] = merge_prob(pp[2], cc[1], cc[2], 24, uf)
        if h["intra"]:
            for k in ("skip", "tx8", "tx16", "tx32"):
                pre[k] = copy.deepcopy(fc[k])
            return
        for i in range(4):
            pre["intra_inter"][i] = mode_merge(pre["intra_inter"][i], cnt["intra_inter"][i])
        for i in range(5):
            pre["comp_inter"][i] = mode_merge(pre["comp_inter"][i], cnt["comp_inter"][i])
            pre["comp_ref"][i] = mode_merge(pre["comp_ref"][i], cnt["comp_ref"][i])
            for j in range(2):
                pre["single_ref"][i][j] = mode_merge(pre["single_ref"][i][j], cnt["single_ref"][i][j])
        for i in range(7):
            tree_merge(INTER_MODE_TREE, list(pre["inter_mode"][i]), cnt["inter_mode"][i],
                       pre["inter_mode"][i])
        for i in range(4):
            tree_merge(INTRA_MODE_TREE, list(pre["y_mode"][i]), cnt["y_mode"][i], pre["y_mode"][i])
        for i in range(10):
            tree_merge(INTRA_MODE_TREE, list(pre["uv_mode"][i]), cnt["uv_mode"][i], pre["uv_mode"][i])
        for i in range(16):
            tree_merge(PARTITION_TREE, list(pre["partition"][i]), cnt["partition"][i],
                       pre["partition"][i])
        if h["filter"] == SWITCHABLE:
            for i in range(4):
                tree_merge(INTERP_TREE, list(pre["interp"][i]), cnt["interp"][i], pre["interp"][i])
        if h["tx_mode"] == TX_MODE_SELECT:
            for i in range(2):
                c8, c16, c32 = cnt["tx8"][i], cnt["tx16"][i], cnt["tx32"][i]
                pre["tx8"][i][0] = mode_merge(pre["tx8"][i][0], [c8[0], c8[1]])
                pre["tx16"][i][0] = mode_merge(pre["tx16"][i][0], [c16[0], c16[1] + c16[2]])
                pre["tx16"][i][1] = mode_merge(pre["tx16"][i][1], [c16[1], c16[2]])
                pre["tx32"][i][0] = mode_merge(pre["tx32"][i][0], [c32[0], c32[1] + c32[2] + c32[3]])
                pre["tx32"][i][1] = mode_merge(pre["tx32"][i][1], [c32[1], c32[2] + c32[3]])
                pre["tx32"][i][2] = mode_merge(pre["tx32"][i][2], [c32[2], c32[3]])
        for i in range(3):
            pre["skip"][i] = mode_merge(pre["skip"][i], cnt["skip"][i])
        tree_merge(MV_JOINT_TREE, list(pre["mv_joint"]), cnt["mv_joint"], pre["mv_joint"])
        for comp, cc in zip(pre["mv_comp"], cnt["mv_comp"]):
            comp["sign"] = mode_merge(comp["sign"], cc["sign"])
            tree_merge(MV_CLASS_TREE, list(comp["classes"]), cc["classes"], comp["classes"])
            comp["class0"][0] = mode_merge(comp["class0"][0], cc["class0"])
            for j in range(10):
                comp["bits"][j] = mode_merge(comp["bits"][j], cc["bits"][j])
            for j in range(2):
                tree_merge(MV_FP_TREE, list(comp["class0_fp"][j]), cc["class0_fp"][j],
                           comp["class0_fp"][j])
            tree_merge(MV_FP_TREE, list(comp["fp"]), cc["fp"], comp["fp"])
            if h["hp"]:
                comp["class0_hp"] = mode_merge(comp["class0_hp"], cc["class0_hp"])
                comp["hp"] = mode_merge(comp["hp"], cc["hp"])


ALL64 = (1 << 64) - 1
ABOVE_TX_MASK_Y = (ALL64, ALL64, 0x00FF00FF00FF00FF, 0x000000FF000000FF)
LEFT_TX_MASK_Y = (ALL64, ALL64, 0x5555555555555555, 0x1111111111111111)
ABOVE_TX_MASK_UV = (0xFFFF, 0xFFFF, 0x0F0F, 0x000F)
LEFT_TX_MASK_UV = (0xFFFF, 0xFFFF, 0x5555, 0x1111)


def _lf_vertical(buf: np.ndarray, x: int, y: int, limit: tuple, wide: int) -> None:
    """vpx_lpf_vertical_{4,8,16} on the 8 rows from y of the edge at x."""
    lim, mblim, hev = limit
    lo, hi = max(0, x - 8), min(buf.shape[1], x + 8)
    seg = np.zeros((8, 16), np.int64)
    seg[:, lo - (x - 8):hi - (x - 8)] = buf[y:y + 8, lo:hi]
    filter_edge(seg, 0, lim, mblim, hev, wide)
    k = {4: 2, 8: 3, 16: 7}[wide]
    buf[y:y + 8, x - k:x + k] = seg[:, 8 - k:8 + k]


def _lf_horizontal(buf: np.ndarray, x: int, y: int, limit: tuple, wide: int) -> None:
    """vpx_lpf_horizontal_{4,8,16} on the 8 columns from x of the edge at y."""
    lim, mblim, hev = limit
    lo, hi = max(0, y - 8), min(buf.shape[0], y + 8)
    seg = np.zeros((16, 8), np.int64)
    seg[lo - (y - 8):hi - (y - 8)] = buf[lo:hi, x:x + 8]
    seg = seg.T.copy()
    filter_edge(seg, 0, lim, mblim, hev, wide)
    k = {4: 2, 8: 3, 16: 7}[wide]
    buf[y - k:y + k, x:x + 8] = seg[:, 8 - k:8 + k].T


# -- the host C++ decoder -------------------------------------------------------

def _lib():
    import ctypes

    from vision_kit_tpu_torch import _cuda_build

    lib = _cuda_build.load("vp9_decode")
    ptr, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.vk_vp9_create.argtypes, lib.vk_vp9_create.restype = [], ptr
    lib.vk_vp9_destroy.argtypes, lib.vk_vp9_destroy.restype = [ptr], None
    lib.vk_vp9_decode.argtypes = [ptr, ctypes.c_char_p, ctypes.c_size_t, ip, ip]
    lib.vk_vp9_decode.restype = ctypes.c_int
    lib.vk_vp9_planes.argtypes, lib.vk_vp9_planes.restype = [ptr, ptr, ptr, ptr], None
    lib.vk_vp9_error.argtypes, lib.vk_vp9_error.restype = [ptr], ctypes.c_char_p
    lib.vk_vp9_full_range.argtypes, lib.vk_vp9_full_range.restype = [ptr], ctypes.c_int
    lib.vk_vp9_calls.argtypes, lib.vk_vp9_calls.restype = [], ctypes.c_longlong
    return lib


def c_calls() -> int:
    """How many packets the host C++ decoder has taken in this process (its
    own count)."""
    return int(_lib().vk_vp9_calls())


class _CDecoder:
    """csrc/vp9_decode.cu's decoder state (nvcc-built at first use, loaded
    with ctypes); RuntimeError when it cannot be built or loaded, Vp9Error
    with the plain decoder's message on a refusal."""

    def __init__(self):
        self.lib = _lib()
        self.handle = self.lib.vk_vp9_create()

    def decode(self, data: bytes):
        import ctypes

        w, h = ctypes.c_int(0), ctypes.c_int(0)
        status = self.lib.vk_vp9_decode(self.handle, data, len(data), ctypes.byref(w),
                                        ctypes.byref(h))
        if status < 0:
            raise (Vp9Unsupported if status == -2 else Vp9Error)(
                self.lib.vk_vp9_error(self.handle).decode())
        if status == 0:
            return None
        w, h = w.value, h.value
        planes = (np.empty((h, w), np.uint8), np.empty(((h + 1) >> 1, (w + 1) >> 1), np.uint8),
                  np.empty(((h + 1) >> 1, (w + 1) >> 1), np.uint8))
        self.lib.vk_vp9_planes(self.handle, *(p.ctypes.data for p in planes))
        return planes

    def full_range(self) -> bool:
        return bool(self.lib.vk_vp9_full_range(self.handle))

    def close(self) -> None:
        if self.handle:
            self.lib.vk_vp9_destroy(self.handle)
            self.handle = None

    __del__ = close
