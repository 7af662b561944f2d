"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video without a codec
library: the plain decoder and the mp4v encoder of the demo's video mode.

The JAX demo reads video through cv2.VideoCapture (FFMPEG's libavcodec)
and writes `mp4v` through cv2.VideoWriter; the card's machine has neither.
This module is the reference decoder, in numpy and Python, for the tests
and the CPU; csrc/mpeg4_decode.cu is the same decoder as host C++ for the
card (`Mpeg4Decoder(device="cuda")`).

Decoding (`Mpeg4Decoder.decode(packet)` gives the Y, U and V planes of a
VOP; `frames_yuv(movie)` every frame of a demuxed clip):

- the VOS, VO and VOL headers, from the container's decoder configuration
  (an MP4's esds) or in band (an AVI's first frame), user data and GOV
  headers skipped; the VOP header (vop_coded 0 repeats the reference,
  vop_rounding_type, vop_fcode_forward, intra_dc_vlc_thr, vop_quant);
- I- and P-VOP macroblocks: MCBPC with stuffing, ac_pred_flag, CBPY,
  dquant, not-coded MBs, intra MBs inside P-VOPs, 1MV and 4MV; the
  intra DC size VLCs and the adaptive DC and AC prediction with the
  quantiser rescale; the TCOEF VLCs (intra and inter tables) with all
  three escape modes; MV VLCs, the median prediction of libavcodec's
  h263_pred_motion and the fcode range wrap;
- H.263 inverse quantisation, and MPEG quantisation with the default or
  loaded matrices and the mismatch control of inter blocks (intra blocks
  are not toggled: libavcodec's non-bitexact dct_unquantize_mpeg2_intra);
  every dequantised value is kept as libavcodec's int16 block keeps it
  (an escape-3 inter level saturates to [-2048, 2047] first, as there);
- video packets after resync markers (the predictors reset at the packet
  as libavcodec's first_slice_line and ff_mpeg4_clean_buffers reset them);
- reconstruction as cv2's FFMPEG build (libavcodec 62 on x86-64, its
  defaults) gives it, found by comparing: the integer "simple" IDCT
  (rows then columns, the DC-only row shortcut, the column pass's biased
  DC), or for a stream libavcodec takes as XviD's its XviD IDCT in the
  SSE2 version x86 dispatches to (`xvid_idct`); unrestricted half-pel
  bilinear motion compensation with rounding control over the previous
  VOP's coded-size (MB-aligned) planes, or its visible size under
  libavcodec's edge workaround, their edges extending without end;
  libavcodec's chroma vectors for 1MV and
  4MV, its 4MV paths' clamp of a block's origin to the VOP's size (a
  half-pel flag dropped there), and its 8-wide x86 rounding-1 averages
  (pavgb of one sample less one: the left one across, every odd source
  row down) where its 16-wide ones are exact;
- libavcodec's encoder identification (ff_mpeg4_workaround_bugs and the
  user-data parse of its decode_user_data): `XviD<n>` user data gives
  an XviD build, `DivX<v>b<b>` a DivX version, `Lavc<a>.<b>.<c>`,
  `FFmpe...b<n>` and `ffmpeg` a libavcodec build; failing all three,
  the container's codec tag XVID, XVIX, RMP4, ZMP4 or SIPP (any case)
  means XviD build 0, and DIVX on a VOL of object type 0 without
  vol_control_parameters DivX 4. An XviD build selects the XviD IDCT,
  and of the workarounds it and the others switch on, two change a
  Simple Profile picture and are ported: the edge bug (XviD builds
  0-12, libavcodec builds below 4670, DivX before 5: motion compensation
  reads the reference cropped to the VOP's size, chroma to half of it
  rounded down, where it reads the coded size) and the DC clip bug (XviD
  builds 0-32, libavcodec builds to 4712: an intra DC predictor past 2047
  is stored unclipped, as an int16). The padding-bug score that XviD
  builds 0-3 set only changes where a damaged VOP's macroblock loop
  stops; the quarter-pel and interlace workarounds belong to tools the
  decoder refuses.

A stream this decoder does not take raises ValueError naming what it is:
B-VOPs (Advanced Simple), sprites and GMC (S-VOPs), quarter-pel,
interlaced, data partitioning and reversible VLCs, the short video header
(H.263 baseline), non-rectangular shape, not_8_bit, scalability, newpred,
reduced-resolution VOPs and complexity estimation headers. A VOL that
declares one raises before its first frame; a VOP that uses one raises at
that VOP.

`yuv420_to_rgb` converts the planes as cv2's FFMPEG backend does
(swscale's unscaled yuv420p -> BGR24, flipped to RGB): torch integer ops,
the same bits on the CPU and the card. The encoder is `Mp4vEncoder`
(below the decoder).
"""

from __future__ import annotations

import numpy as np
import torch

# -- the standard's tables --------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
ALT_HORIZONTAL = np.array([
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63])
ALT_VERTICAL = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63])

# the default MPEG quantisation matrices (14496-2 6.3.3), natural order
DEFAULT_INTRA_MATRIX = np.array([
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45])
DEFAULT_INTER_MATRIX = np.array([
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33])

# TCOEF VLCs (Tables B-16 intra, B-17 inter) as (code, length) without the
# sign bit, in (last, run, level) order: last 0 then 1, runs ascending, levels
# 1..LMAX of each run; the escape code is the last entry.
INTRA_TCOEF = [
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6), (0x12, 6),
    (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
    (0x21, 10), (0x20, 10), (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11),
    (0x50, 12), (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8), (0x20, 9),
    (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12), (0xb, 5), (0x15, 7), (0x1e, 9),
    (0xc, 10), (0x56, 12), (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9),
    (0xa, 10), (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9), (0x54, 12), (0x14, 7),
    (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8), (0x23, 11), (0x17, 8), (0x19, 9),
    (0x18, 9), (0x7, 10), (0x58, 12), (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10),
    (0x5, 11), (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10), (0xe, 6), (0x4, 10),
    (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7), (0x5a, 12), (0x15, 8), (0x5b, 12),
    (0x14, 8), (0x13, 8), (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9),
    (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12), (0x3, 7)]
INTER_TCOEF = [
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9), (0x24, 9), (0x21, 10),
    (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10),
    (0x21, 11), (0x50, 12), (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
    (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10), (0x53, 12), (0x13, 6),
    (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10), (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10),
    (0x16, 7), (0x55, 12), (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
    (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9), (0x22, 11), (0x23, 11),
    (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9), (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6),
    (0xd, 6), (0xc, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9), (0x17, 9),
    (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10),
    (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12),
    (0x59, 12), (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12),
    (0x3, 7)]
# LMAX by (last, run): the largest level with a code of its own
INTRA_LMAX = ((27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1),
              (8, 3, 2, 2, 2, 2, 2) + (1,) * 14)
INTER_LMAX = ((12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2) + (1,) * 16,
              (3, 2) + (1,) * 39)
ESCAPE = 102


def _run_levels(lmax) -> list:
    """(last, run, level) of each TCOEF code in table order."""
    return [(last, run, level) for last in (0, 1)
            for run, top in enumerate(lmax[last]) for level in range(1, top + 1)]


def _rmax(lmax) -> tuple:
    """RMAX by (last, level): the longest run coded for a level (-1: none)."""
    out = []
    for last in (0, 1):
        row = [-1] * 64
        for run, top in enumerate(lmax[last]):
            for level in range(1, top + 1):
                row[level] = max(row[level], run)
        out.append(tuple(row))
    return tuple(out)


INTRA_RMAX, INTER_RMAX = _rmax(INTRA_LMAX), _rmax(INTER_LMAX)

# MCBPC of I-VOPs (mb_type 3, 4) and P-VOPs (0 inter, 1 inter+q, 2 inter4v,
# 3 intra, 4 intra+q), by (mb_type, cbpc); "stuff" is the stuffing code.
MCBPC_I = {(3, 0): "1", (3, 1): "001", (3, 2): "010", (3, 3): "011",
           (4, 0): "0001", (4, 1): "000001", (4, 2): "000010", (4, 3): "000011",
           "stuff": "000000001"}
MCBPC_P = {(0, 0): "1", (0, 1): "0011", (0, 2): "0010", (0, 3): "000101",
           (1, 0): "011", (1, 1): "0000111", (1, 2): "0000110", (1, 3): "000000101",
           (2, 0): "010", (2, 1): "0000101", (2, 2): "0000100", (2, 3): "00000101",
           (3, 0): "00011", (3, 1): "00000100", (3, 2): "00000011", (3, 3): "0000011",
           (4, 0): "000100", (4, 1): "000000100", (4, 2): "000000011",
           (4, 3): "000000010", "stuff": "000000001"}
# CBPY by its intra value (an inter MB codes 15 - cbpy)
CBPY = ("0011", "00101", "00100", "1001", "00011", "0111", "000010", "1011",
        "00010", "000011", "0101", "1010", "0100", "1000", "0110", "11")
DC_SIZE_LUMA = ("011", "11", "10", "010", "001", "0001", "00001", "000001",
                "0000001", "00000001", "000000001", "0000000001", "00000000001")
DC_SIZE_CHROMA = ("11", "10", "01", "001", "0001", "00001", "000001", "0000001",
                  "00000001", "000000001", "0000000001", "00000000001",
                  "000000000001")
# motion vector data 0..32 (a sign bit follows every code but the first)
MVD = ("1", "01", "001", "0001", "000011", "0000101", "0000100", "0000011",
       "000001011", "000001010", "000001001", "0000010001", "0000010000",
       "0000001111", "0000001110", "0000001101", "0000001100", "0000001011",
       "0000001010", "0000001001", "0000001000", "0000000111", "0000000110",
       "0000000101", "0000000100", "00000000111", "00000000110", "00000000101",
       "00000000100", "00000000011", "00000000010", "000000000011",
       "000000000010")
DQUANT = (-1, -2, 1, 2)
# intra_dc_vlc_thr: the intra DC is VLC-coded while the running QP is below
DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)
CHROMA_ROUND = (0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2)
# start codes other than these two and a VOL's (0x20-0x2F) are skipped
START_VOP, START_USER_DATA = 0xB6, 0xB2
I_VOP, P_VOP, B_VOP, S_VOP = 0, 1, 2, 3
VOP_KINDS = ("I", "P", "B (Advanced Simple Profile)", "S (sprite/GMC)")
SIMPLE_PROFILE = 0x01   # profile_and_level_indication cv2's mp4v writes


def luma_dc_scale(q: int) -> int:
    return 8 if q < 5 else 2 * q if q < 9 else q + 8 if q < 25 else 2 * q - 16


def chroma_dc_scale(q: int) -> int:
    return 8 if q < 5 else (q + 13) // 2 if q < 25 else q - 6


class Mpeg4Error(ValueError):
    """A stream the decoder does not take, or corrupt data."""


def _lut(codes, nbits: int) -> list:
    """A table of 2^nbits entries: (value, length) of the code each nbits
    prefix starts with, None where no code starts."""
    table = [None] * (1 << nbits)
    for value, (code, length) in codes:
        lo = code << (nbits - length)
        for i in range(lo, lo + (1 << (nbits - length))):
            if table[i] is not None:
                raise AssertionError(f"codes overlap at {value}")
            table[i] = (value, length)
    return table


def _bits(s: str) -> tuple:
    return int(s, 2), len(s)


MCBPC_I_LUT = _lut([(k, _bits(v)) for k, v in MCBPC_I.items()], 9)
MCBPC_P_LUT = _lut([(k, _bits(v)) for k, v in MCBPC_P.items()], 9)
CBPY_LUT = _lut([(k, _bits(v)) for k, v in enumerate(CBPY)], 6)
DC_LUMA_LUT = _lut([(k, _bits(v)) for k, v in enumerate(DC_SIZE_LUMA)], 11)
DC_CHROMA_LUT = _lut([(k, _bits(v)) for k, v in enumerate(DC_SIZE_CHROMA)], 12)
MVD_LUT = _lut([(k, _bits(v)) for k, v in enumerate(MVD)], 12)
INTRA_LUT = _lut([(rl, c) for rl, c in zip(_run_levels(INTRA_LMAX) + [ESCAPE],
                                           INTRA_TCOEF)], 12)
INTER_LUT = _lut([(rl, c) for rl, c in zip(_run_levels(INTER_LMAX) + [ESCAPE],
                                           INTER_TCOEF)], 12)


# -- the bit reader ---------------------------------------------------------

class _Bits:
    """MSB-first reads over data[start:end] (reads past the end see zeros
    and raise on the next check)."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, data: bytes, start: int = 0, end: int | None = None):
        end = len(data) if end is None else end
        self.buf = bytes(data[:end]) + b"\0" * 8
        self.pos = 8 * start
        self.end = 8 * end

    def peek(self, n: int) -> int:
        p = self.pos
        b = p >> 3
        return (int.from_bytes(self.buf[b:b + 5], "big") >> (40 - (p & 7) - n)) & (
            (1 << n) - 1)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.pos += n
        return v

    def bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.buf[p >> 3] >> (7 - (p & 7))) & 1

    def vlc(self, lut: list, nbits: int, what: str):
        entry = lut[self.peek(nbits)]
        if entry is None:
            raise Mpeg4Error(f"invalid {what} code at bit {self.pos}")
        self.pos += entry[1]
        return entry[0]

    def marker(self, what: str) -> None:
        if not self.bit():
            raise Mpeg4Error(f"missing marker bit after {what}")

    def check(self, what: str) -> None:
        if self.pos > self.end:
            raise Mpeg4Error(f"{what} runs past the end of its data")


def start_codes(data: bytes) -> list:
    """(code byte, offset of the byte after it) of each 00 00 01 xx."""
    out, i = [], data.find(b"\0\0\1")
    while 0 <= i and i + 3 < len(data):
        out.append((data[i + 3], i + 4))
        i = data.find(b"\0\0\1", i + 3)
    return out


# -- headers ----------------------------------------------------------------

class Vol:
    """The video object layer's fields this decoder uses."""

    def __init__(self):
        self.verid = 1
        self.vo_type = 0
        self.vol_control_parameters = 0
        self.width = self.height = 0
        self.time_resolution = 1
        self.time_bits = 1
        self.frame_ticks = 1      # fixed_vop_time_increment (1 without a fixed rate)
        self.quant_type = 0
        self.intra_matrix = DEFAULT_INTRA_MATRIX
        self.inter_matrix = DEFAULT_INTER_MATRIX
        self.resync_marker_disable = 1
        self.reduced_resolution = 0


def _load_matrix(r: _Bits, default: np.ndarray) -> np.ndarray:
    """A quantisation matrix in zigzag order, ended by a 0 (the last value
    repeats)."""
    out = np.zeros(64, np.int64)
    last = 0
    for i in range(64):
        v = r.read(8)
        if v == 0:
            if i == 0:
                raise Mpeg4Error("a loaded quantisation matrix starts with 0")
            out[ZIGZAG[i:]] = last
            return out
        out[ZIGZAG[i]] = last = v
    return out


def parse_vol(r: _Bits, vol: Vol) -> None:
    """video_object_layer() after its start code, into `vol`; refuses what
    the decoder does not take."""
    r.bit()                                         # random_accessible_vol
    vot = vol.vo_type = r.read(8)
    if vot == 0x12:
        raise Mpeg4Error("a fine granularity scalable VOL (not Simple Profile)")
    if r.bit():                                     # is_object_layer_identifier
        vol.verid = r.read(4)
        r.read(3)
    if r.read(4) == 15:                             # aspect_ratio_info: extended PAR
        r.read(16)
    vol.vol_control_parameters = r.bit()
    if vol.vol_control_parameters:
        if r.read(2) != 1:
            raise Mpeg4Error("chroma_format other than 4:2:0")
        r.bit()                                     # low_delay
        if r.bit():                                 # vbv_parameters
            r.read(15), r.marker("bit rate"), r.read(15), r.marker("bit rate")
            r.read(15), r.marker("vbv buffer"), r.read(3), r.read(11)
            r.marker("vbv occupancy"), r.read(15), r.marker("vbv occupancy")
    shape = r.read(2)
    if shape != 0:
        raise Mpeg4Error(f"non-rectangular shape (video_object_layer_shape {shape})")
    r.marker("shape")
    vol.time_resolution = r.read(16)
    if vol.time_resolution == 0:
        raise Mpeg4Error("vop_time_increment_resolution 0")
    vol.time_bits = max((vol.time_resolution - 1).bit_length(), 1)
    r.marker("vop_time_increment_resolution")
    vol.frame_ticks = r.read(vol.time_bits) if r.bit() else 1     # fixed_vop_rate
    r.marker("fixed_vop_rate")
    vol.width = r.read(13)
    r.marker("width")
    vol.height = r.read(13)
    r.marker("height")
    if vol.width == 0 or vol.height == 0:
        raise Mpeg4Error(f"a VOL of {vol.width}x{vol.height}")
    if r.bit():
        raise Mpeg4Error("interlaced video")
    r.bit()                                         # obmc_disable
    sprite = r.read(1 if vol.verid == 1 else 2)
    if sprite:
        raise Mpeg4Error(f"sprites/GMC (sprite_enable {sprite})")
    if r.bit():
        raise Mpeg4Error("not_8_bit video")
    vol.quant_type = r.bit()
    vol.intra_matrix, vol.inter_matrix = DEFAULT_INTRA_MATRIX, DEFAULT_INTER_MATRIX
    if vol.quant_type:
        if r.bit():
            vol.intra_matrix = _load_matrix(r, DEFAULT_INTRA_MATRIX)
        if r.bit():
            vol.inter_matrix = _load_matrix(r, DEFAULT_INTER_MATRIX)
    if vol.verid != 1 and r.bit():
        raise Mpeg4Error("quarter-pel motion (quarter_sample, Advanced Simple Profile)")
    if not r.bit():
        raise Mpeg4Error("complexity estimation headers "
                         "(complexity_estimation_disable 0)")
    vol.resync_marker_disable = r.bit()
    if r.bit():
        raise Mpeg4Error("data partitioning (and reversible VLCs)")
    vol.reduced_resolution = 0
    if vol.verid != 1:
        if r.bit():
            raise Mpeg4Error("newpred")
        vol.reduced_resolution = r.bit()
    if r.bit():
        raise Mpeg4Error("scalability")
    r.check("the VOL header")


class Vop:
    """One VOP header's fields."""

    __slots__ = ("kind", "coded", "rounding", "dc_thr", "quant", "fcode")


def parse_vop(r: _Bits, vol: Vol) -> Vop:
    vop = Vop()
    vop.kind = r.read(2)
    if vop.kind not in (I_VOP, P_VOP):
        raise Mpeg4Error(f"a {VOP_KINDS[vop.kind]}-VOP: the decoder takes I- and "
                         "P-VOPs (Simple Profile)")
    while r.bit():                                  # modulo_time_base
        r.check("modulo_time_base")
    r.marker("modulo_time_base")
    r.read(vol.time_bits)
    r.marker("vop_time_increment")
    vop.coded = r.bit()
    vop.rounding = vop.dc_thr = vop.quant = 0
    vop.fcode = 1
    if not vop.coded:
        return vop
    if vop.kind == P_VOP:
        vop.rounding = r.bit()
    if vol.reduced_resolution and r.bit():
        raise Mpeg4Error("a reduced-resolution VOP")
    vop.dc_thr = DC_THRESHOLD[r.read(3)]
    vop.quant = r.read(5)
    if vop.quant == 0:
        raise Mpeg4Error("vop_quant 0")
    if vop.kind == P_VOP:
        vop.fcode = r.read(3)
        if vop.fcode == 0:
            raise Mpeg4Error("vop_fcode_forward 0")
    r.check("the VOP header")
    return vop


# -- the inverse DCT ---------------------------------------------------------

W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


def _butterfly(x0, x1, x2, x3, x4, x5, x6, x7, a0):
    """The eight outputs of one 1-D pass before its shift, a0 the biased
    DC term."""
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * x2 + W4 * x4 + W6 * x6
    a1 = a1 + W6 * x2 - W4 * x4 - W2 * x6
    a2 = a2 - W6 * x2 - W4 * x4 + W2 * x6
    a3 = a3 - W2 * x2 + W4 * x4 - W6 * x6
    b0 = W1 * x1 + W3 * x3 + W5 * x5 + W7 * x7
    b1 = W3 * x1 - W7 * x3 - W1 * x5 - W5 * x7
    b2 = W5 * x1 - W1 * x3 + W7 * x5 + W3 * x7
    b3 = W7 * x1 - W5 * x3 + W3 * x5 - W1 * x7
    return (a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0)


def _wrap16(v: int) -> int:
    """v stored in an int16."""
    return ((v + 32768) & 0xFFFF) - 32768


def _int16(x: np.ndarray) -> np.ndarray:
    return ((x + 32768) & 0xFFFF) - 32768


def _butterfly_matrix() -> np.ndarray:
    """_butterfly as an 8x8 matrix: out = M @ x (without the DC bias)."""
    eye = np.eye(8, dtype=np.int64)
    cols = [np.array(_butterfly(*eye[j], 0)) for j in range(8)]
    cols[0] = cols[0] + np.array(_butterfly(*np.zeros(8, np.int64), W4))
    return np.stack(cols, axis=1).astype(np.float64)


_IDCT_M = _butterfly_matrix()


def idct(blocks: np.ndarray) -> np.ndarray:
    """libavcodec's simple IDCT (8-bit) of (N, 64) natural-order
    coefficients: a row pass (shift 11, a row whose only non-zero value is
    its DC gives DC << 3, each stored as int16) then a column pass (shift
    20, the DC biased by W4 * 32). Returns (N, 8, 8) int64, unclipped.

    Each pass is the butterfly's integer matrix applied in float64, which
    is exact: every product and sum is an integer below 2^53, and the
    shifts are divisions by powers of two, floored."""
    b = blocks.reshape(-1, 8).astype(np.float64)            # one row a line
    rows = np.floor((b @ _IDCT_M.T + (1 << 10)) * (1 / (1 << 11)))
    dc_only = ~b[:, 1:].any(axis=1)
    rows[dc_only] = b[dc_only, :1] * 8
    rows = _int16(rows.astype(np.int64)).reshape(-1, 8, 8)
    cols = rows.transpose(0, 2, 1).reshape(-1, 8).astype(np.float64)   # a column a line
    cols = np.floor((cols @ _IDCT_M.T + W4 * 32) * (1 / (1 << 20)))
    return cols.astype(np.int64).reshape(-1, 8, 8).transpose(0, 2, 1)


# libavcodec's XviD IDCT (xvididct.asm, ff_xvid_idct_sse2): the row pass's
# coefficients and rounders by row, and the column pass's constants
XVID_ROW_TABLES = (
    (22725, 21407, 19266, 16384, 12873, 8867, 4520),     # rows 0 and 4
    (31521, 29692, 26722, 22725, 17855, 12299, 6270),    # rows 1 and 7
    (29692, 27969, 25172, 21407, 16819, 11585, 5906),    # rows 2 and 6
    (26722, 25172, 22654, 19266, 15137, 10426, 5315))    # rows 3 and 5
XVID_ROW_TABLE = (0, 1, 2, 3, 0, 3, 2, 1)
XVID_ROUNDERS = (65536, 3597, 2260, 1203, 0, 120, 512, 512)
TAN1, TAN2, TAN3_LESS_1, SQRT2_HALF = 13036, 27146, 43790 - 65536, 23170


def _sat16(x):
    """Saturated to int16 (paddsw, psubsw, packssdw)."""
    return np.clip(x, -32768, 32767)


def _mulhi16(x, c: int):
    """pmulhw: the high half of the signed 16 x 16-bit product."""
    return (x * c) >> 16


def xvid_idct(blocks: np.ndarray) -> np.ndarray:
    """libavcodec's XviD IDCT of (N, 64) natural-order coefficients, as its
    SSE2 version computes it (cv2's x86-64 build dispatches there; the C
    ff_xvid_idct wraps where this saturates). Rows: the even and odd
    halves of each row's table (pmaddwd, 32-bit, wrapping) and the row's
    rounder, shifted right 11 and saturated to int16; the rounders of rows
    0-2 leave a zero row 32, 1, 1. Columns: the LLM butterfly in 16-bit
    saturating arithmetic, each product the high half of pmulhw (tan(3pi/16)
    as t3 - 1 plus the input), the sqrt(2) terms doubled, each output
    shifted right 6. Returns (N, 8, 8) int64, unclipped."""
    b = blocks.reshape(-1, 8, 8).astype(np.int64)
    rows = np.empty_like(b)
    for r in range(8):
        c1, c2, c3, c4, c5, c6, c7 = XVID_ROW_TABLES[XVID_ROW_TABLE[r]]
        x = [b[:, r, k] for k in range(8)]
        k = c4 * x[0] + XVID_ROUNDERS[r]
        a = (k + c2 * x[2] + c4 * x[4] + c6 * x[6], k + c6 * x[2] - c4 * x[4] - c2 * x[6],
             k - c6 * x[2] - c4 * x[4] + c2 * x[6], k - c2 * x[2] + c4 * x[4] - c6 * x[6])
        o = (c1 * x[1] + c3 * x[3] + c5 * x[5] + c7 * x[7],
             c3 * x[1] - c7 * x[3] - c1 * x[5] - c5 * x[7],
             c5 * x[1] - c1 * x[3] + c7 * x[5] + c3 * x[7],
             c7 * x[1] - c5 * x[3] + c3 * x[5] - c1 * x[7])
        out = [a[0] + o[0], a[1] + o[1], a[2] + o[2], a[3] + o[3],
               a[3] - o[3], a[2] - o[2], a[1] - o[1], a[0] - o[0]]
        rows[:, r] = np.stack([_sat16(_int32(v) >> 11) for v in out], axis=1)
    x = [rows[:, k] for k in range(8)]
    tm35 = _sat16(_sat16(_mulhi16(x[3], TAN3_LESS_1) + x[3]) - x[5])
    tp35 = _sat16(_sat16(_mulhi16(x[5], TAN3_LESS_1) + x[5]) + x[3])
    tp17 = _sat16(_mulhi16(x[7], TAN1) + x[1])
    tm17 = _sat16(_mulhi16(x[1], TAN1) - x[7])
    t1, b3 = _sat16(tp17 - tp35), _sat16(tm17 - tm35)
    b0, t2 = _sat16(tp35 + tp17), _sat16(tm35 + tm17)
    b1 = _sat16(2 * _mulhi16(_sat16(t2 + t1), SQRT2_HALF))
    b2 = _sat16(2 * _mulhi16(_sat16(t1 - t2), SQRT2_HALF))
    tp26 = _sat16(_mulhi16(x[6], TAN2) + x[2])
    tm26 = _sat16(_mulhi16(x[2], TAN2) - x[6])
    tm04, tp04 = _sat16(x[0] - x[4]), _sat16(x[4] + x[0])
    a0, a3 = _sat16(tp26 + tp04), _sat16(tp04 - tp26)
    a1, a2 = _sat16(tm26 + tm04), _sat16(tm04 - tm26)
    out = (b0 + a0, b1 + a1, b2 + a2, b3 + a3, a3 - b3, a2 - b2, a1 - b1, a0 - b0)
    return np.stack([_sat16(v) >> 6 for v in out], axis=1)


def _int32(x):
    """x stored in an int32 (pmaddwd and paddd wrap)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# -- motion compensation ------------------------------------------------------

def _mc(ref: np.ndarray, ix, iy, hx, hy, rounding: int, narrow) -> np.ndarray:
    """Half-pel bilinear prediction of (N,) 8x8 blocks whose top-left
    full-pel sample is (ix, iy) over `ref` (the previous VOP's coded-size
    plane), half-pel flags hx, hy; every coordinate is clamped into the
    plane (its edges extend without end). `narrow` (N,) marks the blocks
    libavcodec predicts with its 8-wide functions (chroma, and the luma of
    a 4MV MB), whose x86 rounding-1 half-pel averages differ from the exact
    ones its 16-wide functions give (below)."""
    limit_h, limit_w = ref.shape
    hx, hy = hx[:, None, None].astype(bool), hy[:, None, None].astype(bool)
    span = np.arange(9)
    xs = np.clip(ix[:, None] + span, 0, limit_w - 1)
    ys = np.clip(iy[:, None] + span, 0, limit_h - 1)
    p = ref[ys[:, :, None], xs[:, None, :]].astype(np.int32)
    a, b = p[:, :-1, :-1], p[:, :-1, 1:]
    c, d = p[:, 1:, :-1], p[:, 1:, 1:]
    if rounding:
        # libavcodec's x86 put_no_rnd_pixels8_x2 / _y2 (its non-bitexact
        # default, 8 wide): pavgb with one sample less one, saturated; x2
        # lowers the left sample, y2 every odd source row of the block
        x2, y2 = (a + b) >> 1, (a + c) >> 1
        narrow = np.asarray(narrow, bool)[:, None, None]
        odd = (np.arange(8) & 1).astype(bool)[None, :, None]
        low_a, low_c = np.maximum(a - 1, 0), np.maximum(c - 1, 0)
        x2 = np.where(narrow, (low_a + b + 1) >> 1, x2)
        y2 = np.where(narrow, (np.where(odd, low_a, a) + np.where(odd, c, low_c) + 1) >> 1, y2)
    else:
        x2, y2 = (a + b + 1) >> 1, (a + c + 1) >> 1
    return np.where(hx & hy, (a + b + c + d + 2 - rounding) >> 2,
                    np.where(hx, x2, np.where(hy, y2, a)))


def _source(x0, y0, mvx, mvy, clip, lo: int, hi_x: int, hi_y: int) -> tuple:
    """(ix, iy, hx, hy) of blocks at (x0, y0) moved by half-pel (mvx, mvy).
    Where `clip` (libavcodec's hpel_motion and chroma_4mv_motion, the 4MV
    paths) the full-pel origin is clamped into [lo, hi] (hi the VOP's width
    or height, halved for chroma) and a half-pel flag dropped at hi."""
    ix, iy, hx, hy = x0 + (mvx >> 1), y0 + (mvy >> 1), mvx & 1, mvy & 1
    cx, cy = np.clip(ix, lo, hi_x), np.clip(iy, lo, hi_y)
    hx = np.where(clip & (cx == hi_x), 0, hx)
    hy = np.where(clip & (cy == hi_y), 0, hy)
    return np.where(clip, cx, ix), np.where(clip, cy, iy), hx, hy


def chroma_vector(total: np.ndarray) -> np.ndarray:
    """The chroma half-pel vector of a macroblock from the sum of its four
    luma block vectors (1MV: four times the vector)."""
    return np.array(CHROMA_ROUND)[total & 15] + ((total >> 3) & ~1)


# -- the decoder ---------------------------------------------------------------

MB_INTRA, MB_INTER, MB_SKIP = 0, 1, 2


class _Frame:
    """Per-VOP state of the macroblock loop."""

    def __init__(self, mbw: int, mbh: int):
        self.mbw, self.mbh = mbw, mbh
        self.kind = np.full((mbh, mbw), MB_SKIP, np.int8)
        self.coef = np.zeros((mbh, mbw, 6, 64), np.int32)
        self.coded = np.zeros((mbh, mbw, 6), bool)
        self.four_mv = np.zeros((mbh, mbw), bool)
        # luma block vectors with a zero border: column 0 and 2 * mbw + 1
        self.mv = [[(0, 0)] * (2 * mbw + 2) for _ in range(2 * mbh)]
        # DC (level * scale) and AC (first column, first row) predictors,
        # with a border of 1024 / zeros on the left and on top
        self.dc = [[[1024] * (2 * mbw + 1) for _ in range(2 * mbh + 1)]] + [
            [[1024] * (mbw + 1) for _ in range(mbh + 1)] for _ in range(2)]
        zeros = (0,) * 16
        self.ac = [[[zeros] * (2 * mbw + 1) for _ in range(2 * mbh + 1)]] + [
            [[zeros] * (mbw + 1) for _ in range(mbh + 1)] for _ in range(2)]
        self.qscale = [[0] * mbw for _ in range(mbh)]


def _block_pos(n: int, mx: int, my: int) -> tuple:
    """(plane, row, column) of block n's predictor slot (1-based: row and
    column 0 are the border)."""
    if n < 4:
        return 0, 2 * my + (n >> 1) + 1, 2 * mx + (n & 1) + 1
    return n - 3, my + 1, mx + 1


def read_vol(data: bytes) -> Vol | None:
    """The VOL among the headers in `data` (a decoder configuration or a
    sample that starts with them), parsed with every refusal of
    parse_vol; None when `data` holds no VOL. VOPs are not decoded."""
    data = bytes(data)
    codes = start_codes(data)
    for k, (code, pos) in enumerate(codes):
        end = codes[k + 1][1] - 4 if k + 1 < len(codes) else len(data)
        if 0x20 <= code <= 0x2F:
            vol = Vol()
            parse_vol(_Bits(data, pos, end), vol)
            return vol
        if code == START_VOP:
            break
    if not codes and len(data) >= 3 and data[:2] == b"\0\0" and data[2] & 0xFC == 0x80:
        raise Mpeg4Error("the short video header (H.263 baseline)")
    return None


# -- the encoder identification ---------------------------------------------

XVID_TAGS = (b"XVID", b"XVIX", b"RMP4", b"ZMP4", b"SIPP")
C_SPACE = " \t\n\v\f\r"


def _scanf(text: str, fmt: str) -> list:
    """The values C's sscanf(text, fmt) assigns, in order, for the
    directives libavcodec's user-data parse uses: literals, white space
    (any run, none included), %d, %c and %*[^x] (a run of one or more
    characters other than x, not assigned)."""
    out, i, k = [], 0, 0
    while k < len(fmt):
        ch = fmt[k]
        if ch in C_SPACE:
            while i < len(text) and text[i] in C_SPACE:
                i += 1
            k += 1
        elif ch != "%":
            if i >= len(text) or text[i] != ch:
                return out
            i, k = i + 1, k + 1
        elif fmt[k + 1] == "d":
            j = i
            while j < len(text) and text[j] in C_SPACE:
                j += 1
            d = j + (j < len(text) and text[j] in "+-")
            e = d
            while e < len(text) and "0" <= text[e] <= "9":
                e += 1
            if e == d:
                return out
            out.append(int(text[j:e]))
            i, k = e, k + 2
        elif fmt[k + 1] == "c":
            if i >= len(text):
                return out
            out.append(text[i])
            i, k = i + 1, k + 2
        else:
            stop, j = fmt[k + 4], i
            while j < len(text) and text[j] != stop:
                j += 1
            if j == i:
                return out
            i, k = j, k + 6
    return out


class EncoderId:
    """What libavcodec's MPEG-4 decoder infers of a stream's encoder, and
    the workarounds that follow (see the module docstring): the user data
    of its decode_user_data, then ff_mpeg4_workaround_bugs at each VOP.
    Builds and versions are -1 while unknown; the flags, once set, stay."""

    def __init__(self, codec_tag: bytes = b""):
        self.codec_tag = bytes(codec_tag)[:4].upper()
        self.xvid_build = self.divx_version = self.divx_build = self.lavc_build = -1
        self.xvid_idct = self.edge_bug = self.dc_clip_bug = False

    def user_data(self, data: bytes) -> None:
        """One user_data() (after its start code): at most 255 bytes, as a
        C string."""
        text = bytes(data[:255]).split(b"\0")[0].decode("latin-1")
        v = _scanf(text, "DivX%dBuild%d%c")
        if len(v) < 2:
            v = _scanf(text, "DivX%db%d%c")
        if len(v) >= 2:
            self.divx_version, self.divx_build = v[0], v[1]
        build = None
        v = _scanf(text, "FFmpe%*[^b]b%d")
        if v:
            build = v[0]
        else:
            v = _scanf(text, "FFmpeg v%d.%d.%d / libavcodec build: %d")
            if len(v) == 4:
                build = v[3]
            else:
                v = _scanf(text, "Lavc%d.%d.%d")
                if len(v) == 3:
                    build = ((v[0] & 0xFF) << 16) + ((v[1] & 0xFF) << 8) + (v[2] & 0xFF)
                elif text == "ffmpeg":
                    self.lavc_build = 4600
        if build is not None:
            self.lavc_build = build
        v = _scanf(text, "XviD%d")
        if v:
            self.xvid_build = v[0]

    def at_vop(self, vol: Vol) -> None:
        """ff_mpeg4_workaround_bugs before a VOP is decoded."""
        if self.xvid_build == self.divx_version == self.lavc_build == -1:
            if self.codec_tag in XVID_TAGS:
                self.xvid_build = 0
            elif (self.codec_tag == b"DIVX" and vol.vo_type == 0
                  and not vol.vol_control_parameters):
                self.divx_version = 400
        if self.xvid_build >= 0 and self.divx_version >= 0:
            self.divx_version = self.divx_build = -1
        xvid, lavc, divx = (v & 0xFFFFFFFF for v in (self.xvid_build, self.lavc_build,
                                                      self.divx_version))
        self.edge_bug |= xvid <= 12 or lavc < 4670 or divx < 500
        self.dc_clip_bug |= xvid <= 32 or lavc <= 4712
        self.xvid_idct |= self.xvid_build >= 0


class Mpeg4Decoder:
    """Decode the VOPs of one MPEG-4 Part 2 stream in order.

    `config` is the decoder configuration (the VOS/VO/VOL headers of an
    MP4's esds); without it the headers come in band. `codec_tag` is the
    container's (an AVI's biCompression, an MP4's sample entry, a
    Matroska VFW track's fourcc; empty where there is none), which
    libavcodec's XviD rule reads (EncoderId). `decode(packet)`
    takes one container sample (start codes and all) and returns the
    (Y, U, V) uint8 planes of its VOP, cropped to the VOL's size (chroma
    (h + 1) // 2 x (w + 1) // 2), or None for a sample that holds headers
    only. device "cuda" runs csrc/mpeg4_decode.cu's host C++ decoder
    (built with nvcc at first use) and "cpu" this module's; either keeps
    the reference VOP in its own state."""

    def __init__(self, config: bytes | None = None, device: str = "cpu",
                 codec_tag: bytes = b""):
        self.device = torch.device(device)
        self.vol: Vol | None = None
        self.ref = None           # (Y, U, V) coded-size planes of the last decoded VOP
        self.encoder = EncoderId(codec_tag)
        self._c = _CDecoder(self.encoder.codec_tag) if self.device.type == "cuda" else None
        if config:
            self.decode(config)

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    def identity(self) -> dict:
        """What the decoder (the C++ one on "cuda") has inferred of the
        stream's encoder so far: EncoderId's builds and flags."""
        keys = ("xvid_build", "divx_version", "lavc_build", "xvid_idct", "edge_bug",
                "dc_clip_bug")
        if self._c is not None:
            return dict(zip(keys, self._c.identity()))
        return {k: getattr(self.encoder, k) for k in keys}

    def decode(self, packet: bytes):
        if self._c is not None:
            return self._c.decode(bytes(packet))
        return self._decode_plain(bytes(packet))

    def _decode_plain(self, data: bytes):
        codes = start_codes(data)
        if not codes and data:
            if len(data) >= 3 and data[0] == 0 and data[1] == 0 and data[2] & 0xFC == 0x80:
                raise Mpeg4Error("the short video header (H.263 baseline)")
            raise Mpeg4Error("a sample without start codes")
        out = None
        for k, (code, pos) in enumerate(codes):
            end = codes[k + 1][1] - 4 if k + 1 < len(codes) else len(data)
            if 0x20 <= code <= 0x2F:
                vol = Vol()
                parse_vol(_Bits(data, pos, end), vol)
                self.vol = vol
            elif code == START_USER_DATA:
                self.encoder.user_data(data[pos:end])
            elif code == START_VOP:
                if self.vol is None:
                    raise Mpeg4Error("a VOP before any VOL header")
                out = self._vop(_Bits(data, pos, end))
        return out

    # -- one VOP --------------------------------------------------------------

    def _vop(self, r: _Bits):
        vol = self.vol
        vop = parse_vop(r, vol)
        self.encoder.at_vop(vol)
        w, h = vol.width, vol.height
        if not vop.coded:
            if self.ref is None:
                raise Mpeg4Error("a not-coded VOP before any decoded one")
            cw, ch = (w + 1) >> 1, (h + 1) >> 1
            return (self.ref[0][:h, :w].copy(), self.ref[1][:ch, :cw].copy(),
                    self.ref[2][:ch, :cw].copy())
        if vop.kind == P_VOP and self.ref is None:
            raise Mpeg4Error("a P-VOP before any I-VOP")
        mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
        if vop.kind == P_VOP and self.ref[0].shape != (16 * mbh, 16 * mbw):
            raise Mpeg4Error("a P-VOP of another size than its reference")
        f = _Frame(mbw, mbh)
        self._macroblocks(r, vop, f)
        planes = self._reconstruct(vop, f)
        self.ref = planes
        cw, ch = (w + 1) >> 1, (h + 1) >> 1
        return (np.ascontiguousarray(planes[0][:h, :w]),
                np.ascontiguousarray(planes[1][:ch, :cw]),
                np.ascontiguousarray(planes[2][:ch, :cw]))

    def _macroblocks(self, r: _Bits, vop: Vop, f: _Frame) -> None:
        vol = self.vol
        mbw, mbh = f.mbw, f.mbh
        n_mb = mbw * mbh
        mb_bits = max((n_mb - 1).bit_length(), 1)
        q = vop.quant
        resync = (0, 0)
        for i in range(n_mb):
            mx, my = i % mbw, i // mbw
            if i and not vol.resync_marker_disable and _at_resync(r, vop):
                q, first = self._packet_header(r, vop, mb_bits)
                if first != i:
                    raise Mpeg4Error(f"a video packet starts at macroblock {first}, not {i}")
                resync = (mx, my)
                _clean_predictors(f, mx, my)
            first_line = my == resync[1] or (my == resync[1] + 1 and mx < resync[0])
            q = self._macroblock(r, vop, f, mx, my, q, resync, first_line)
            r.check(f"macroblock {i}")

    def _packet_header(self, r: _Bits, vop: Vop, mb_bits: int) -> tuple:
        """video_packet_header() after its resync marker: (quant, first MB)."""
        mb = r.read(mb_bits)
        q = r.read(5)
        if q == 0:
            raise Mpeg4Error("quant_scale 0 in a video packet header")
        if r.bit():                                 # header_extension_code
            while r.bit():
                r.check("modulo_time_base")
            r.marker("modulo_time_base")
            r.read(self.vol.time_bits)
            r.marker("vop_time_increment")
            if r.read(2) != vop.kind:
                raise Mpeg4Error("a video packet's vop_coding_type differs from its VOP's")
            r.read(3)                               # intra_dc_vlc_thr
            if vop.kind == P_VOP:
                r.read(3)
        return q, mb

    def _macroblock(self, r: _Bits, vop: Vop, f: _Frame, mx: int, my: int, q: int,
                    resync: tuple, first_line: bool) -> int:
        if vop.kind == P_VOP:
            while True:
                if r.bit():                         # not_coded
                    f.kind[my, mx] = MB_SKIP
                    _clear_intra(f, mx, my)
                    _set_mv(f, mx, my, [(0, 0)] * 4)
                    f.qscale[my][mx] = q
                    return q
                mcbpc = r.vlc(MCBPC_P_LUT, 9, "MCBPC")
                if mcbpc != "stuff":
                    break
            mb_type, cbpc = mcbpc
        else:
            while True:
                mcbpc = r.vlc(MCBPC_I_LUT, 9, "MCBPC")
                if mcbpc != "stuff":
                    break
            mb_type, cbpc = mcbpc
        intra = mb_type >= 3
        ac_pred = r.bit() if intra else 0
        cbpy = r.vlc(CBPY_LUT, 6, "CBPY")
        if not intra:
            cbpy = 15 - cbpy
        cbp = (cbpy << 2) | cbpc
        use_dc_vlc = q < vop.dc_thr
        if mb_type in (1, 4):
            q = min(max(q + DQUANT[r.read(2)], 1), 31)
        f.qscale[my][mx] = q
        if intra:
            f.kind[my, mx] = MB_INTRA
            _set_mv(f, mx, my, [(0, 0)] * 4)
            for n in range(6):
                self._intra_block(r, f, n, mx, my, q, ac_pred, bool(cbp & (32 >> n)),
                                  use_dc_vlc, resync, first_line)
            return q
        f.kind[my, mx] = MB_INTER
        _clear_intra(f, mx, my)
        for n in range(4 if mb_type == 2 else 1):
            px, py = _predict_mv(f, n, mx, my, resync, first_line)
            v = (_motion(r, px, vop.fcode), _motion(r, py, vop.fcode))
            f.mv[2 * my + (n >> 1)][2 * mx + (n & 1) + 1] = v
        if mb_type != 2:
            _set_mv(f, mx, my, [v] * 4)
        f.four_mv[my, mx] = mb_type == 2
        for n in range(6):
            if cbp & (32 >> n):
                self._inter_block(r, f, n, mx, my, q)
        return q

    def _intra_block(self, r, f, n, mx, my, q, ac_pred, coded, use_dc_vlc,
                     resync, first_line):
        plane, by, bx = _block_pos(n, mx, my)
        dcs, acs = f.dc[plane], f.ac[plane]
        a, b, c = dcs[by][bx - 1], dcs[by - 1][bx - 1], dcs[by - 1][bx]
        if first_line and n != 3:
            if n != 2:
                b = c = 1024
            if n != 1 and mx == resync[0]:
                b = a = 1024
        if mx == resync[0] and my == resync[1] + 1 and n in (0, 4, 5):
            b = 1024
        left = not abs(a - b) < abs(b - c)
        pred = a if left else c
        scale = luma_dc_scale(q) if n < 4 else chroma_dc_scale(q)
        block = [0] * 64
        start = 0
        if use_dc_vlc:
            size = r.vlc(DC_LUMA_LUT if n < 4 else DC_CHROMA_LUT,
                         11 if n < 4 else 12, "DC size")
            diff = 0
            if size:
                diff = r.read(size)
                if not diff >> (size - 1):
                    diff -= (1 << size) - 1
                if size > 8:
                    r.marker("a DC differential")
            block[0] = diff
            start = 1
        scan = (ALT_VERTICAL if left else ALT_HORIZONTAL) if ac_pred else ZIGZAG
        if coded:
            _tcoef(r, block, start, scan, INTRA_LUT, INTRA_LMAX, INTRA_RMAX, 1, 0)
        # the DC: predicted in quantised units, stored scaled and clipped
        # (under the DC clip bug only below: an int16 above)
        level = block[0] + (pred + (scale >> 1)) // scale
        block[0] = level
        dcs[by][bx] = (_wrap16(max(level * scale, 0)) if self.encoder.dc_clip_bug
                       else min(max(level * scale, 0), 2047))
        # the AC: the first column (left) or row (top) of the neighbour,
        # rescaled from its MB's quantiser where it lies in another MB
        if ac_pred:
            if left:
                nq = f.qscale[my][mx - 1] if mx > 0 and n in (0, 2, 4, 5) else q
                src, idx = acs[by][bx - 1][:8], range(8, 64, 8)
            else:
                nq = f.qscale[my - 1][mx] if my > 0 and n in (0, 1, 4, 5) else q
                src, idx = acs[by - 1][bx][8:], range(1, 8)
            for k, pos in zip(range(1, 8), idx):
                v = src[k]
                if nq != q:     # libavcodec's ROUNDED_DIV(v * nq, q)
                    v = (abs(v * nq) + (q >> 1)) // q * (1 if v > 0 else -1)
                block[pos] += v
        acs[by][bx] = tuple([0] + [block[8 * k] for k in range(1, 8)]
                            + [0] + [block[k] for k in range(1, 8)])
        # inverse quantisation, each value stored as libavcodec's int16
        # block stores it (wrapping, not saturating)
        out = f.coef[my, mx, n]
        vol = self.vol
        vals = [0] * 64
        if vol.quant_type:
            m = vol.intra_matrix
            for pos in range(1, 64):
                v = block[pos]
                if v:
                    mag = (abs(v) * q * 2 * int(m[pos])) >> 4
                    vals[pos] = _wrap16(mag if v > 0 else -mag)
        else:
            qmul, qadd = 2 * q, (q - 1) | 1
            for pos in range(1, 64):
                v = block[pos]
                if v:
                    vals[pos] = _wrap16(v * qmul + qadd if v > 0 else v * qmul - qadd)
        vals[0] = _wrap16(level * scale)
        out[:] = vals
        f.coded[my, mx, n] = True

    def _inter_block(self, r, f, n, mx, my, q):
        block = [0] * 64
        vol = self.vol
        if vol.quant_type:
            _tcoef(r, block, 0, ZIGZAG, INTER_LUT, INTER_LMAX, INTER_RMAX, 1, 0)
            m = vol.inter_matrix
            total = 0
            for pos in range(64):
                v = block[pos]
                if v:
                    mag = ((2 * abs(v) + 1) * q * 2 * int(m[pos])) >> 5
                    v = _wrap16(mag if v > 0 else -mag)
                    block[pos] = v
                    total += v
            if not total & 1:                       # mismatch control
                block[63] ^= 1
        else:
            _tcoef(r, block, 0, ZIGZAG, INTER_LUT, INTER_LMAX, INTER_RMAX,
                   2 * q, (q - 1) | 1)
        f.coef[my, mx, n] = block
        f.coded[my, mx, n] = True

    # -- reconstruction -------------------------------------------------------

    def _reconstruct(self, vop: Vop, f: _Frame) -> tuple:
        vol = self.vol
        w, h = vol.width, vol.height
        mbw, mbh = f.mbw, f.mbh
        coded = f.coded
        res = np.zeros((mbh, mbw, 6, 8, 8), np.int64)
        if coded.any():
            res[coded] = (xvid_idct if self.encoder.xvid_idct else idct)(f.coef[coded])
        intra = (f.kind == MB_INTRA)
        if vop.kind == P_VOP:
            pred = self._predict(vop, f)
            out = np.where(intra[:, :, None, None, None], res, pred + res)
        else:
            out = res
        out = np.clip(out, 0, 255).astype(np.uint8)
        y = out[:, :, :4].reshape(mbh, mbw, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5)
        y = y.reshape(mbh * 16, mbw * 16)
        u = out[:, :, 4].transpose(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
        v = out[:, :, 5].transpose(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
        return y, u, v

    def _predict(self, vop: Vop, f: _Frame) -> np.ndarray:
        """(mbh, mbw, 6, 8, 8) motion-compensated prediction of every MB
        (intra MBs too: their rows are discarded)."""
        w, h = self.vol.width, self.vol.height
        mbw, mbh = f.mbw, f.mbh
        ry, ru, rv = self.ref
        if self.encoder.edge_bug:       # libavcodec's h_edge_pos = width
            ry, ru, rv = ry[:h, :w], ru[:h >> 1, :w >> 1], rv[:h >> 1, :w >> 1]
        mv = np.array([row[1:2 * mbw + 1] for row in f.mv], np.int64)   # (2mbh, 2mbw, 2)
        by, bx = np.meshgrid(np.arange(2 * mbh), np.arange(2 * mbw), indexing="ij")
        four = np.repeat(np.repeat(f.four_mv, 2, axis=0), 2, axis=1).ravel()
        src = _source((8 * bx).ravel(), (8 * by).ravel(), mv[..., 0].ravel(),
                      mv[..., 1].ravel(), four, -16, w, h)
        luma = _mc(ry, *src, vop.rounding, four)
        luma = luma.reshape(mbh, 2, mbw, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5)
        total = mv.reshape(mbh, 2, mbw, 2, 2).sum(axis=(1, 3))          # (mbh, mbw, 2)
        cvec = chroma_vector(total)
        my, mx = np.meshgrid(np.arange(mbh), np.arange(mbw), indexing="ij")
        src = _source((8 * mx).ravel(), (8 * my).ravel(), cvec[..., 0].ravel(),
                      cvec[..., 1].ravel(), f.four_mv.ravel(), -8, w >> 1, h >> 1)
        args = (*src, vop.rounding, np.ones(mbw * mbh, bool))
        cu = _mc(ru, *args).reshape(mbh, mbw, 8, 8)
        cv = _mc(rv, *args).reshape(mbh, mbw, 8, 8)
        return np.concatenate([luma.reshape(mbh, mbw, 4, 8, 8), cu[:, :, None],
                               cv[:, :, None]], axis=2)


def _tcoef(r: _Bits, block: list, i: int, scan, lut, lmax, rmax, qmul: int,
           qadd: int) -> None:
    """Run/level pairs into block (natural order) from scan index i,
    dequantised as level * qmul + qadd (qmul 1, qadd 0: kept quantised)."""
    while True:
        entry = lut[r.peek(12)]
        if entry is None:
            raise Mpeg4Error(f"invalid TCOEF code at bit {r.pos}")
        r.pos += entry[1]
        if entry[0] == ESCAPE:
            mode = 1 if not r.bit() else 2 + r.bit()
            if mode == 1:
                entry = lut[r.peek(12)]
                if entry is None or entry[0] == ESCAPE:
                    raise Mpeg4Error(f"invalid escaped TCOEF code at bit {r.pos}")
                r.pos += entry[1]
                last, run, level = entry[0]
                level += lmax[last][run]
            elif mode == 2:
                entry = lut[r.peek(12)]
                if entry is None or entry[0] == ESCAPE:
                    raise Mpeg4Error(f"invalid escaped TCOEF code at bit {r.pos}")
                r.pos += entry[1]
                last, run, level = entry[0]
                run += rmax[last][level] + 1
            else:
                last, run = r.bit(), r.read(6)
                r.marker("an escaped run")
                level = r.read(12)
                r.marker("an escaped level")
                if level >= 2048:
                    level -= 4096
                if level == 0:
                    raise Mpeg4Error("an escaped level of 0")
                i += run
                if i > 63:
                    raise Mpeg4Error("a block of more than 64 coefficients")
                if qmul != 1 or qadd:
                    level = level * qmul + qadd if level > 0 else level * qmul - qadd
                    level = min(max(level, -2048), 2047)
                block[scan[i]] = level
                i += 1
                if last:
                    return
                continue
        else:
            last, run, level = entry[0]
        if r.bit():
            level = -level
        i += run
        if i > 63:
            raise Mpeg4Error("a block of more than 64 coefficients")
        if qmul != 1 or qadd:
            level = level * qmul + qadd if level > 0 else level * qmul - qadd
        block[scan[i]] = level
        i += 1
        if last:
            return


def _motion(r: _Bits, pred: int, fcode: int) -> int:
    """One motion vector component: its VLC, residual bits and the range
    wrap of fcode around the prediction `pred` (half-pels)."""
    code = r.vlc(MVD_LUT, 12, "motion vector")
    if code == 0:
        return pred
    sign = r.bit()
    shift = fcode - 1
    val = code
    if shift:
        val = ((val - 1) << shift | r.read(shift)) + 1
    if sign:
        val = -val
    val += pred
    return _sign_extend(val, 5 + fcode)


def _sign_extend(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _median(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


def _predict_mv(f: _Frame, n: int, mx: int, my: int, resync: tuple,
               first_line: bool) -> tuple:
    """libavcodec's h263_pred_motion for luma block n of MB (mx, my): the
    median of the left (A), above (B) and above-right (C) candidates, with
    its first-slice-line cases (the blocks of this MB decoded before n are
    in the grid already)."""
    grid = f.mv
    gx, gy = 2 * mx + (n & 1) + 1, 2 * my + (n >> 1)   # +1: the zero column
    a = grid[gy][gx - 1]
    cx = gx + (2, 1, 1, -1)[n]
    if first_line and n < 3:
        if n == 0:
            if mx == resync[0]:
                return 0, 0
            if mx + 1 == resync[0]:
                c = grid[gy - 1][cx]
                if mx == 0:
                    return c
                return _median(a[0], 0, c[0]), _median(a[1], 0, c[1])
            return a
        if n == 1:
            if mx + 1 == resync[0]:
                c = grid[gy - 1][cx]
                return _median(a[0], 0, c[0]), _median(a[1], 0, c[1])
            return a
        if mx == resync[0]:
            a = (0, 0)
    b, c = grid[gy - 1][gx], grid[gy - 1][cx]
    return _median(a[0], b[0], c[0]), _median(a[1], b[1], c[1])


def _set_mv(f: _Frame, mx: int, my: int, mvs: list) -> None:
    for k, v in enumerate(mvs):
        f.mv[2 * my + (k >> 1)][2 * mx + (k & 1) + 1] = v


def _clear_intra(f: _Frame, mx: int, my: int) -> None:
    """A non-intra MB's DC and AC predictors: 1024 and zeros."""
    zeros = (0,) * 16
    for n in range(6):
        plane, by, bx = _block_pos(n, mx, my)
        f.dc[plane][by][bx] = 1024
        f.ac[plane][by][bx] = zeros


def _clean_predictors(f: _Frame, mx: int, my: int) -> None:
    """ff_mpeg4_clean_buffers at a video packet starting at MB (mx, my):
    the AC predictors from the block left of it on the row above through
    the one left of it on its own row are zeroed."""
    zeros = (0,) * 16
    stride = 2 * f.mbw + 1
    flat = [(y, x) for y in range(2 * f.mbh + 1) for x in range(stride)]
    start = (2 * my) * stride + 2 * mx      # (row 2my - 1, column 2mx - 1), 1-based
    for y, x in flat[start:start + 2 * stride + 1]:
        f.ac[0][y][x] = zeros
    cstride = f.mbw + 1
    cflat = [(y, x) for y in range(f.mbh + 1) for x in range(cstride)]
    cstart = my * cstride + mx
    for plane in (1, 2):
        for y, x in cflat[cstart:cstart + cstride + 1]:
            f.ac[plane][y][x] = zeros


def _at_resync(r: _Bits, vop: Vop) -> bool:
    """Whether stuffing to the next byte boundary and a resync marker come
    next; if so, reads them."""
    pos = r.pos
    skip = 8 - (pos & 7)
    stuffing = r.peek(skip)
    if stuffing != (1 << (skip - 1)) - 1:
        return False
    marker_len = 17 if vop.kind == I_VOP else 16 + vop.fcode
    r.pos = pos + skip
    if r.pos + marker_len <= r.end and r.peek(marker_len) == 1:
        r.pos += marker_len
        return True
    r.pos = pos
    return False


# The decoded RGB against cv2.VideoCapture's (FFMPEG) frames, in
# data/decode.py:pixel_agreement's terms: bit-equal. Every frame of every
# cv2-written clip the tests and the committed samples hold (mp4v, XVID,
# DIVX and FMP4; static, panning and noisy content; sizes that are not
# multiples of 16; 720p GOPs of 8 and 12) agrees to the bit, with the
# reconstruction and the colour conversion above.
MPEG4_TOLERANCE = {"max_abs": 0, "mean_abs": 0.0, "share_over_2": 0.0}


def within_mpeg4_tolerance(agreement: dict) -> bool:
    return all(agreement[k] <= v for k, v in MPEG4_TOLERANCE.items())


# -- the host C++ decoder ---------------------------------------------------------

def _lib():
    import ctypes

    from vision_kit_tpu_torch import _cuda_build

    lib = _cuda_build.load("mpeg4_decode")
    ptr, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.vk_mpeg4_create.argtypes, lib.vk_mpeg4_create.restype = [], ptr
    lib.vk_mpeg4_destroy.argtypes, lib.vk_mpeg4_destroy.restype = [ptr], None
    lib.vk_mpeg4_set_codec_tag.argtypes = [ptr, ctypes.c_char_p]
    lib.vk_mpeg4_set_codec_tag.restype = None
    lib.vk_mpeg4_identity.argtypes, lib.vk_mpeg4_identity.restype = [ptr, ip], None
    lib.vk_mpeg4_decode.argtypes = [ptr, ctypes.c_char_p, ctypes.c_size_t, ip, ip]
    lib.vk_mpeg4_decode.restype = ctypes.c_int
    lib.vk_mpeg4_planes.argtypes = [ptr, ptr, ptr, ptr]
    lib.vk_mpeg4_planes.restype = None
    lib.vk_mpeg4_error.argtypes, lib.vk_mpeg4_error.restype = [ptr], ctypes.c_char_p
    lib.vk_mpeg4_calls.argtypes, lib.vk_mpeg4_calls.restype = [], ctypes.c_longlong
    return lib


def c_calls() -> int:
    """How many samples the host C++ decoder has taken in this process
    (its own count)."""
    return int(_lib().vk_mpeg4_calls())


class _CDecoder:
    """csrc/mpeg4_decode.cu's decoder state (nvcc-built at first use,
    loaded with ctypes); raises RuntimeError when it cannot be built or
    loaded, Mpeg4Error with the plain decoder's message on a refusal."""

    def __init__(self, codec_tag: bytes = b""):
        self.lib = _lib()
        self.handle = self.lib.vk_mpeg4_create()
        self.lib.vk_mpeg4_set_codec_tag(self.handle, bytes(codec_tag)[:4])

    def decode(self, data: bytes):
        import ctypes

        w, h = ctypes.c_int(0), ctypes.c_int(0)
        status = self.lib.vk_mpeg4_decode(self.handle, data, len(data), ctypes.byref(w),
                                          ctypes.byref(h))
        if status < 0:
            raise Mpeg4Error(self.lib.vk_mpeg4_error(self.handle).decode())
        if status == 0:
            return None
        w, h = w.value, h.value
        planes = (np.empty((h, w), np.uint8), np.empty(((h + 1) >> 1, (w + 1) >> 1), np.uint8),
                  np.empty(((h + 1) >> 1, (w + 1) >> 1), np.uint8))
        self.lib.vk_mpeg4_planes(self.handle, *(p.ctypes.data for p in planes))
        return planes

    def identity(self) -> tuple:
        import ctypes

        out = (ctypes.c_int * 6)()
        self.lib.vk_mpeg4_identity(self.handle, out)
        return tuple(out[:3]) + tuple(bool(v) for v in out[3:])

    def close(self) -> None:
        if self.handle:
            self.lib.vk_mpeg4_destroy(self.handle)
            self.handle = None

    __del__ = close


# -- colour ------------------------------------------------------------------

# swscale's yuv2rgb coefficients for BT.601 limited range (ff_yuv2rgb_coeffs
# default, contrast and saturation 1, brightness 0) in its 16-bit SIMD
# form: each product is the high half of a 16 x 16-bit multiply
Y_COEFF, Y_OFFSET = 9539, 128
VR_COEFF, UB_COEFF, UG_COEFF, VG_COEFF = 13075, 16525, -3209, -6660
UV_OFFSET = 1024
# the same for a full-range (JPEG range) source, as sws_setColorspaceDetails
# derives them: Y unscaled, the chroma products scaled by 224 / 255
FULL_RANGE_COEFFS = (8192, 0, 11485, 14516, -2819, -5850)


def _mulhi(a: torch.Tensor, c: int) -> torch.Tensor:
    return (a * c) >> 16


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  full_range: bool = False) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of 4:2:0 planes as cv2's FFMPEG capture converts
    them (swscale's yuv420p -> BGR24 with its x86 SIMD arithmetic: Y, U and
    V scaled by 8 and offset, multiplied keeping the high 16 bits, summed
    and saturated; each chroma sample serves its 2x2 luma samples), for a
    limited-range source or, with `full_range` (a frame libavcodec tags
    AVCOL_RANGE_JPEG), a full-range one. Integer torch ops on the planes'
    device."""
    y_coeff, y_offset, vr, ub, ug, vg = (FULL_RANGE_COEFFS if full_range else
                                         (Y_COEFF, Y_OFFSET, VR_COEFF, UB_COEFF, UG_COEFF,
                                          VG_COEFF))
    h, w = y.shape
    yy = _mulhi((y.to(torch.int32) << 3) - y_offset, y_coeff)
    uu = (u.to(torch.int32) << 3) - UV_OFFSET
    vv = (v.to(torch.int32) << 3) - UV_OFFSET
    r = _mulhi(vv, vr)
    g = _mulhi(uu, ug) + _mulhi(vv, vg)
    b = _mulhi(uu, ub)
    chroma = torch.stack([r, g, b], dim=-1)
    chroma = chroma.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:h, :w]
    return (yy[..., None] + chroma).clamp_(0, 255).to(torch.uint8)


# -- the encoder ---------------------------------------------------------------

KEY_INTERVAL = 12       # an I-VOP every 12 frames, libavcodec's default gop_size
QUANT = 2               # the fixed quantiser of every VOP (cv2's mp4v settles on 3,
                        # with motion search and adaptive quantisation)
# rounding offsets of |coefficient| / (2 quant), libavcodec's default biases
INTRA_BIAS, INTER_BIAS = 3 / 8, -1 / 4


class _BitWriter:
    """MSB-first fields gathered as (value, length) and packed at once."""

    def __init__(self):
        self.codes, self.lengths = [], []

    def put(self, value: int, length: int) -> None:
        self.codes.append(value)
        self.lengths.append(length)

    def stuff(self) -> None:
        """next_start_code(): a 0 then ones to the byte boundary."""
        n = 8 - sum(self.lengths) % 8
        self.put((1 << (n - 1)) - 1, n)

    def bytes(self) -> bytes:
        return _pack(np.array(self.codes, np.int64), np.array(self.lengths, np.int64))


def _pack(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """The codes' bits (each at most 32) back to back, in whole bytes:
    each code shifted into the 5 bytes from its first bit's byte, the bytes
    summed by bincount (no two codes share a bit, so the sum is the OR)."""
    ends = np.cumsum(lengths)
    starts = ends - lengths
    nbytes = (int(ends[-1]) + 7) // 8 if len(ends) else 0
    window = codes.astype(np.uint64) << (40 - (starts & 7) - lengths).astype(np.uint64)
    first = starts >> 3
    out = np.zeros(nbytes + 5)
    for k in range(5):
        lane = ((window >> np.uint64(32 - 8 * k)) & np.uint64(0xFF)).astype(np.float64)
        out += np.bincount(first + k, weights=lane, minlength=nbytes + 5)
    return out[:nbytes].astype(np.uint8).tobytes()


def _vlc_arrays(table: dict, keys) -> tuple:
    codes = np.array([_bits(table[k])[0] for k in keys], np.int64)
    lengths = np.array([_bits(table[k])[1] for k in keys], np.int64)
    return codes, lengths


def _tcoef_tables(vlc, lmax) -> tuple:
    """(code, length) arrays by [last, run, level] (length 0: no code)."""
    code = np.zeros((2, 64, 64), np.int64)
    length = np.zeros((2, 64, 64), np.int64)
    for (last, run, level), (c, n) in zip(_run_levels(lmax), vlc):
        code[last, run, level], length[last, run, level] = c, n
    lm = np.zeros((2, 64), np.int64)
    rm = np.full((2, 64), -1, np.int64)
    for last in (0, 1):
        lm[last, :len(lmax[last])] = lmax[last]
        rm[last] = _rmax(lmax)[last]
    return code, length, lm, rm


_INTRA_ENC = _tcoef_tables(INTRA_TCOEF, INTRA_LMAX)
_INTER_ENC = _tcoef_tables(INTER_TCOEF, INTER_LMAX)
_ESC_CODE, _ESC_LEN = INTRA_TCOEF[ESCAPE]


def _tcoef_codes(levels: np.ndarray, start: int, tables) -> tuple:
    """The TCOEF codes of (N, 64) scan-order levels from scan index
    `start`: (block, scan index, code, length) of each non-zero level, in
    order, each in the shortest of its direct code and three escapes."""
    code, length, lm, rm = tables
    blk, idx = np.nonzero(levels[:, start:])
    idx = idx + start
    if not len(blk):
        e = np.zeros(0, np.int64)
        return e, e, e, e
    val = levels[blk, idx].astype(np.int64)
    first = np.r_[True, blk[1:] != blk[:-1]]
    last = np.r_[blk[1:] != blk[:-1], True].astype(np.int64)
    prev = np.where(first, start - 1, np.r_[0, idx[:-1]])
    run = idx - prev - 1
    mag, sign = np.abs(val), (val < 0).astype(np.int64)
    small = np.minimum(mag, 63)
    key = (last << 12) | (run << 6) | small
    n0 = np.where(mag < 64, length.ravel()[key], 0)
    out_code = (code.ravel()[key] << 1) | sign
    out_len = n0 + 1
    esc = np.nonzero(n0 == 0)[0]           # the rest: the shortest escape
    if len(esc):
        la, ru, ma, sm, sg, va = last[esc], run[esc], mag[esc], small[esc], sign[esc], val[esc]
        # escape 1: the level less LMAX
        l1 = np.clip(ma - lm[la, ru], 0, 63)
        n1 = np.where(ma - lm[la, ru] == l1, length[la, ru, l1], 0)
        c1 = (((_ESC_CODE << 1) << n1) | code[la, ru, l1]) << 1 | sg
        # escape 2: the run less RMAX + 1
        r2 = ru - rm[la, sm] - 1
        r2c = np.clip(r2, 0, 63)
        n2 = np.where((ma < 64) & (rm[la, sm] >= 0) & (r2 >= 0), length[la, r2c, sm], 0)
        c2 = ((((_ESC_CODE << 2) | 2) << n2) | code[la, r2c, sm]) << 1 | sg
        # escape 3: last, run, level in fixed-length fields
        c3 = (((((_ESC_CODE << 2 | 3) << 1 | la) << 6 | ru) << 1 | 1) << 12
              | (va & 0xFFF)) << 1 | 1
        out_code[esc] = np.where(n1 > 0, c1, np.where(n2 > 0, c2, c3))
        out_len[esc] = np.where(n1 > 0, n1 + 9, np.where(n2 > 0, n2 + 10, 30))
    return blk, idx, out_code, out_len


_DCT32 = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                    for x in range(8)] for u in range(8)], np.float32)


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """The 8x8 forward DCT of (N, 8, 8) samples, DC = 8 x the mean
    (float32: only the encoder's choice of levels rests on it)."""
    return _DCT32 @ blocks.astype(np.float32) @ _DCT32.T


_RGB_TO_YUV = np.array([[66, 129, 25], [-38, -74, 112], [112, -94, -18]], np.float32)


def rgb_to_yuv420(rgb: np.ndarray) -> tuple:
    """BT.601 limited-range 4:2:0 planes of (H, W, 3) uint8 RGB (H and W
    even): the standard's integer formulas ((66 R + 129 G + 25 B + 128)
    >> 8) + 16 and the like, chroma averaged over each 2x2 block with
    rounding (float32 arithmetic, exact on these integers)."""
    h, w = rgb.shape[:2]
    yuv = np.floor((rgb.reshape(-1, 3).astype(np.float32) @ _RGB_TO_YUV.T + 128)
                   * (1 / 256)).reshape(h, w, 3)
    y = yuv[..., 0] + 16
    uv = yuv[..., 1:].reshape(h // 2, 2, w // 2, 2, 2).sum(axis=(1, 3))
    uv = np.floor((uv + 2) * 0.25) + 128
    return y.astype(np.uint8), uv[..., 0].astype(np.uint8), uv[..., 1].astype(np.uint8)


def _blocks(plane: np.ndarray, size: int) -> np.ndarray:
    """(rows/size, cols/size, size/8, size/8, 8, 8) 8x8 tiles of a plane,
    grouped by size x size macroblock tile."""
    h, w = plane.shape
    k = size // 8
    return plane.reshape(h // size, k, 8, w // size, k, 8).transpose(0, 3, 1, 4, 2, 5)


def _mb_blocks(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(mbh, mbw, 6, 8, 8) blocks of padded planes in MB order."""
    luma = _blocks(y, 16)
    mbh, mbw = luma.shape[:2]
    return np.concatenate([luma.reshape(mbh, mbw, 4, 8, 8),
                           _blocks(u, 8).reshape(mbh, mbw, 1, 8, 8),
                           _blocks(v, 8).reshape(mbh, mbw, 1, 8, 8)], axis=2)


def _planes(blocks: np.ndarray) -> tuple:
    """The inverse of _mb_blocks."""
    mbh, mbw = blocks.shape[:2]
    y = blocks[:, :, :4].reshape(mbh, mbw, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5)
    u = blocks[:, :, 4].transpose(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
    v = blocks[:, :, 5].transpose(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
    return y.reshape(mbh * 16, mbw * 16), u, v


class Mp4vEncoder:
    """MPEG-4 Part 2 Simple Profile VOPs of RGB frames, in vectorised
    numpy, as cv2's `mp4v` writer sets its VOL up (Simple Profile, H.263
    quantisation, resync markers disabled, no data partitioning, 8-bit).

    An I-VOP goes at frame 0 and every `key_interval` frames after; the
    VOPs between are P-VOPs whose MBs are not coded or inter-coded at MV
    (0, 0): an MB is not coded when every block of its residual against
    the reference quantises to zero (the zero-SAD test made exact), else
    its coded residual is sent. Every VOP has the fixed quantiser QUANT;
    intra DCs are always VLC-coded (intra_dc_vlc_thr 0) and predicted as
    the decoder predicts them, AC prediction is off. The reconstruction
    loop runs the decoder's IDCT and dequantisation, so Mpeg4Decoder gives
    back `self.recon` bit for bit. The frame's RGB goes to 4:2:0 by
    rgb_to_yuv420 after its edges are replicated to whole MBs (the VOL
    keeps the frame's own size, odd or not).

    `headers()` gives the VOS/VO/VOL headers (an MP4's esds, or in band
    before an AVI's first VOP); `encode(rgb)` one VOP and whether it is an
    I-VOP."""

    def __init__(self, width: int, height: int, fps: float = 30.0,
                 key_interval: int = KEY_INTERVAL):
        if width <= 0 or height <= 0 or width >= 1 << 13 or height >= 1 << 13:
            raise ValueError(f"a VOL cannot hold a {width}x{height} frame")
        import fractions

        frac = fractions.Fraction(fps).limit_denominator(1001)
        if frac <= 0 or frac.numerator >= 1 << 16:
            raise ValueError(f"fps {fps} does not fit a VOL's time resolution")
        self.width, self.height = width, height
        self.mbw, self.mbh = (width + 15) >> 4, (height + 15) >> 4
        self.rate, self.tick = frac.numerator, frac.denominator
        self.time_bits = max((self.rate - 1).bit_length(), 1)
        self.key_interval = max(int(key_interval), 1)
        self.quant = QUANT
        self.frames = 0
        self.recon = None          # (Y, U, V) coded-size planes of the last VOP

    def headers(self) -> bytes:
        """VOS (Simple Profile L1), visual object, VO and VOL."""
        w = _BitWriter()
        w.put(0x1B0, 32), w.put(SIMPLE_PROFILE, 8)
        w.put(0x1B5, 32), w.put(1, 1), w.put(1, 4), w.put(1, 3), w.put(1, 4), w.put(0, 1)
        w.stuff()
        w.put(0x100, 32), w.put(0x120, 32)
        w.put(0, 1), w.put(1, 8)                   # random access, Simple Object
        w.put(1, 1), w.put(1, 4), w.put(1, 3)      # layer verid 1, priority 1
        w.put(1, 4)                                # square pixels
        w.put(1, 1), w.put(1, 2), w.put(1, 1), w.put(0, 1)   # 4:2:0, low delay, no vbv
        w.put(0, 2), w.put(1, 1)                   # rectangular
        w.put(self.rate, 16), w.put(1, 1)
        w.put(1, 1), w.put(self.tick, self.time_bits)         # fixed_vop_rate
        w.put(1, 1), w.put(self.width, 13), w.put(1, 1), w.put(self.height, 13), w.put(1, 1)
        w.put(0, 1), w.put(1, 1), w.put(0, 1)      # progressive, no OBMC, no sprite
        w.put(0, 1), w.put(0, 1)                   # 8-bit, H.263 quantisation
        w.put(1, 1), w.put(1, 1), w.put(0, 1)      # no complexity estimation, no resync
        w.put(0, 1)                                # no scalability
        w.stuff()
        return w.bytes()

    def encode(self, rgb: np.ndarray) -> tuple:
        """(VOP bytes, is an I-VOP) of one (H, W, 3) uint8 RGB frame."""
        rgb = np.asarray(rgb)
        if rgb.shape != (self.height, self.width, 3) or rgb.dtype != np.uint8:
            raise ValueError(f"a frame of {rgb.shape} {rgb.dtype}, not "
                             f"({self.height}, {self.width}, 3) uint8")
        rgb = np.pad(rgb, ((0, 16 * self.mbh - self.height), (0, 16 * self.mbw - self.width),
                           (0, 0)), mode="edge")
        blocks = _mb_blocks(*rgb_to_yuv420(rgb)).astype(np.int32)
        intra = self.recon is None or self.frames % self.key_interval == 0
        w = _BitWriter()
        t = self.frames * self.tick
        seconds = t // self.rate - (self.frames - 1) * self.tick // self.rate \
            if self.frames else 0
        w.put(0x1B6, 32), w.put(I_VOP if intra else P_VOP, 2)
        w.put((1 << (seconds + 1)) - 2, seconds + 1)        # modulo_time_base
        w.put(1, 1), w.put(t % self.rate, self.time_bits), w.put(1, 1)
        w.put(1, 1)                                          # vop_coded
        if not intra:
            w.put(0, 1)                                      # vop_rounding_type
        w.put(0, 3), w.put(self.quant, 5)                    # intra_dc_vlc_thr 0
        if not intra:
            w.put(1, 3)                                      # vop_fcode_forward
        (codes, lengths), recon = (self._intra if intra else self._inter)(blocks)
        self.recon = _planes(np.clip(recon, 0, 255).astype(np.uint8))
        self.frames += 1
        codes = np.concatenate([np.array(w.codes, np.int64), codes])
        lengths = np.concatenate([np.array(w.lengths, np.int64), lengths])
        n = 8 - int(lengths.sum()) % 8                     # next_start_code()
        return _pack(np.r_[codes, (1 << (n - 1)) - 1], np.r_[lengths, n]), intra

    def _intra(self, blocks: np.ndarray) -> tuple:
        """The MB layer of an I-VOP of (mbh, mbw, 6, 8, 8) blocks: its
        (codes, lengths) in bitstream order and the reconstructed blocks."""
        q, mbh, mbw = self.quant, self.mbh, self.mbw
        coef = _fdct(blocks.reshape(-1, 8, 8)).reshape(mbh, mbw, 6, 64)
        scale = np.array([luma_dc_scale(q)] * 4 + [chroma_dc_scale(q)] * 2)
        levels = _quantise(coef, q, INTRA_BIAS)
        levels[..., 0] = np.clip(np.floor(coef[..., 0] / scale + 0.5), 0, 2047 // scale)
        dc = levels[..., 0]
        diff = dc - _dc_prediction(dc * scale, scale)
        scan = levels[..., ZIGZAG]
        coded = scan[..., 1:].any(axis=-1)
        items = []                  # (key, codes, lengths) groups
        n_mb = mbh * mbw
        mb = np.arange(n_mb)
        cbpc = (coded[..., 4] * 2 + coded[..., 5]).ravel()
        cbpy = (coded[..., 0] * 8 + coded[..., 1] * 4 + coded[..., 2] * 2
                + coded[..., 3]).ravel()
        mc, ml = _vlc_arrays(MCBPC_I, [(3, c) for c in range(4)])
        yc, yl = _vlc_arrays(dict(enumerate(CBPY)), range(16))
        items.append((_key(mb, 0, 0), mc[cbpc], ml[cbpc]))
        items.append((_key(mb, 0, 1), np.zeros(n_mb, np.int64), np.ones(n_mb, np.int64)))
        items.append((_key(mb, 0, 2), yc[cbpy], yl[cbpy]))
        d = diff.reshape(n_mb, 6)
        size = np.zeros_like(d)
        nz = d != 0
        size[nz] = np.floor(np.log2(np.abs(d[nz]))).astype(np.int64) + 1
        lum = np.array([_bits(c) for c in DC_SIZE_LUMA])
        chrom = np.array([_bits(c) for c in DC_SIZE_CHROMA])
        for n in range(6):
            table = lum if n < 4 else chrom
            items.append((_key(mb, n + 1, 0), table[size[:, n], 0], table[size[:, n], 1]))
            bits = np.where(d[:, n] >= 0, d[:, n], d[:, n] + (1 << size[:, n]) - 1)
            items.append((_key(mb, n + 1, 1), bits, size[:, n]))
            big = size[:, n] > 8
            items.append((_key(mb[big], n + 1, 2), np.ones(big.sum(), np.int64),
                          np.ones(big.sum(), np.int64)))
        blk, idx, c, ln = _tcoef_codes(scan.reshape(-1, 64), 1, _INTRA_ENC)
        items.append((_key(blk // 6, blk % 6 + 1, 3 + idx), c, ln))
        deq = _dequantise(levels, q)
        deq[..., 0] = dc * scale
        recon = idct(deq.reshape(-1, 64)).reshape(mbh, mbw, 6, 8, 8)
        return _ordered(items), recon

    def _inter(self, blocks: np.ndarray) -> tuple:
        """The MB layer of a P-VOP: each MB not coded or inter-coded at MV
        (0, 0) against the reference; (codes, lengths) and the
        reconstructed blocks."""
        q, mbh, mbw = self.quant, self.mbh, self.mbw
        ref = _mb_blocks(*self.recon).astype(np.int32)
        coef = _fdct((blocks - ref).reshape(-1, 8, 8)).reshape(mbh, mbw, 6, 64)
        levels = _quantise(coef, q, INTER_BIAS)
        scan = levels[..., ZIGZAG]
        coded = scan.any(axis=-1)                       # (mbh, mbw, 6)
        inter = coded.any(axis=-1).ravel()
        n_mb = mbh * mbw
        mb = np.arange(n_mb)
        items = [(_key(mb, 0, 0), (~inter).astype(np.int64), np.ones(n_mb, np.int64))]
        m = mb[inter]
        cbpc = (coded[..., 4] * 2 + coded[..., 5]).ravel()[inter]
        cbpy = (coded[..., 0] * 8 + coded[..., 1] * 4 + coded[..., 2] * 2
                + coded[..., 3]).ravel()[inter]
        mc, ml = _vlc_arrays(MCBPC_P, [(0, c) for c in range(4)])
        yc, yl = _vlc_arrays(dict(enumerate(CBPY)), range(16))
        ones = np.ones(len(m), np.int64)
        items.append((_key(m, 0, 1), mc[cbpc], ml[cbpc]))
        items.append((_key(m, 0, 2), yc[15 - cbpy], yl[15 - cbpy]))
        items.append((_key(m, 0, 3), ones, ones))      # MVD x 0 (the prediction is 0)
        items.append((_key(m, 0, 4), ones, ones))      # MVD y 0
        blk, idx, c, ln = _tcoef_codes(scan.reshape(-1, 64), 0, _INTER_ENC)
        items.append((_key(blk // 6, blk % 6 + 1, 3 + idx), c, ln))
        res = np.zeros((mbh, mbw, 6, 8, 8), np.int64)
        if coded.any():
            res[coded] = idct(_dequantise(levels[coded], q))
        return _ordered(items), ref + res


def _quantise(coef: np.ndarray, q: int, bias: float) -> np.ndarray:
    """H.263 quantisation: sign(c) floor(|c| / 2q + bias), at most 2047."""
    mag = np.minimum(np.floor(np.maximum(np.abs(coef) * (1 / (2 * q)) + bias, 0)), 2047)
    return np.copysign(mag, coef).astype(np.int32)


def _dequantise(levels: np.ndarray, q: int) -> np.ndarray:
    """The decoder's H.263 inverse quantisation: 2q L + sign(L) (q - 1 | 1)."""
    return levels * (2 * q) + np.sign(levels) * ((q - 1) | 1)


def _key(mb, part, sub) -> np.ndarray:
    """Sort key of a bitstream field: macroblock, part (0 the MB header,
    1 + n block n) and position within the part (3 + scan index for a
    coefficient)."""
    return (np.asarray(mb, np.int64) * 7 + part) * 80 + sub


def _ordered(items) -> tuple:
    keys = np.concatenate([np.broadcast_to(k, np.shape(c)) for k, c, _ in items])
    codes = np.concatenate([np.asarray(c, np.int64) for _, c, _ in items])
    lengths = np.concatenate([np.asarray(n, np.int64) for _, _, n in items])
    order = np.argsort(keys, kind="stable")
    return codes[order], lengths[order]


def _dc_prediction(dc: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The decoder's intra DC prediction (in quantised units) of every
    block of an all-intra VOP of one video packet, from the (mbh, mbw, 6)
    scaled DCs: left (A) unless |A - B| < |B - C|, then above (C); 1024
    outside the picture."""
    mbh, mbw = dc.shape[:2]
    out = np.zeros_like(dc)
    luma = dc[..., :4].reshape(mbh, mbw, 2, 2).transpose(0, 2, 1, 3).reshape(
        2 * mbh, 2 * mbw)
    grids = [(luma, slice(0, 4)), (dc[..., 4], 4), (dc[..., 5], 5)]
    for grid, where in grids:
        g = np.full((grid.shape[0] + 1, grid.shape[1] + 1), 1024, np.int64)
        g[1:, 1:] = grid
        a, b, c = g[1:, :-1], g[:-1, :-1], g[:-1, 1:]
        pred = np.where(np.abs(a - b) < np.abs(b - c), c, a)
        if where == slice(0, 4):
            pred = pred.reshape(mbh, 2, mbw, 2).transpose(0, 2, 1, 3).reshape(mbh, mbw, 4)
        out[..., where] = pred
    return (out + (scale >> 1)) // scale
