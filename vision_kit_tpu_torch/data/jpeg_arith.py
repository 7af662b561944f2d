"""Arithmetic-coded JPEG scans (SOF9, SOF10) as libjpeg-turbo's jdarith.c
decodes them, for the plain decoder of data/decode.py.

- The QM decoder of T.81 Annex D (arith_decode): the C and A registers,
  the 113 states of jaricom.c's jpeg_aritab (and its 114th, the fixed
  probability 0.5 bin), the statistics bins of each conditioning table: 64
  for DC (the five L/U contexts of the previous difference, X1 at 20, the
  magnitude bits 14 bins past their category) and 256 for AC (three per
  zigzag index, X1 at 189 up to Kx and at 217 past it).
- decode_mcu for sequential scans, and the progressive passes: DC first,
  DC refinement (one bit a block at probability 0.5), AC first and AC
  refinement (the previous end of band EOBx from the block itself).
- At a restart marker the statistics of the scan's tables, the DC
  predictions and the decoder reset. A marker inside the data (the scan's
  end, or a cut closed by an EOI) makes the decoder read zero bytes from
  there on, as get_byte's caller does, so the rest of the scan decodes from
  zeros; intervals missing before it decode from zeros too (libjpeg's
  resync leaves the marker unread). Bytes that end with no marker after
  them raise JpegError when the decoder needs one past them (libjpeg's
  JERR_CANT_SUSPEND; cv2 gives None). A magnitude or spectral overflow
  (corrupt data) stops the interval's decoding, as jdarith.c's ct = -1.

The coefficients land in decode.py's flat coefficient store, so the IDCT,
block smoothing and the reduced-size IDCTs take these scans unchanged. The
decoder is a serial Python loop (one call per binary decision).
"""

from __future__ import annotations

import numpy as np

from vision_kit_tpu_torch.data.decode import JpegError, ZIGZAG, _wrap16

# jaricom.c's jpeg_aritab: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
# of each state; the last is the fixed probability 0.5 of T.851
_ARITAB = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
)
_QE = [q for q, _, _, _ in _ARITAB]
_NL = [lps | (switch << 7) for _, lps, _, switch in _ARITAB]   # with the MPS switch
_NM = [mps for _, _, mps, _ in _ARITAB]
FIXED = 113                       # the state of jdarith.c's fixed_bin
DC_BINS, AC_BINS = 64, 256
_NATURAL = ZIGZAG.tolist()

# jdmarker.c get_soi's defaults of every conditioning table: DC L = 0,
# U = 1; AC Kx = 5
DEFAULT_CONDITIONING = {"L": [0] * 16, "U": [1] * 16, "K": [5] * 16}


class _Overflow(Exception):
    """jdarith.c's ct = -1: corrupt data stops the interval."""


class BytesEnd(JpegError):
    """The decoder needed a byte past bytes with no marker after them
    (libjpeg's JERR_CANT_SUSPEND). `mcu` is the scan's MCU it was decoding;
    decode.py adds `row`, that MCU's iMCU row."""

    mcu = row = None


def read_dac(seg: bytes, cond: dict) -> None:
    """A DAC segment's (table, value) pairs into `cond` (jdmarker.c get_dac):
    tables 0-15 are DC (L the low nibble, U the high), 16-31 AC (Kx).
    Raises JpegError where libjpeg's error exit does."""
    if len(seg) % 2:
        raise JpegError("bad DAC length")
    for i in range(0, len(seg), 2):
        index, val = seg[i], seg[i + 1]
        if index >= 32:
            raise JpegError(f"DAC table {index}")
        if index >= 16:
            cond["K"][index - 16] = val
        else:
            lo, hi = val & 15, val >> 4
            if lo > hi:
                raise JpegError(f"DAC value {val:#x}: L > U")
            cond["L"][index], cond["U"][index] = lo, hi


def _decoder(seg: bytes, marker: bool):
    """arith_decode over one restart interval's unstuffed bytes: a function
    (stats, index) -> the decoded bit, which updates the bin's state. Past
    the bytes it reads zeros when a marker follows them, else raises."""
    n = len(seg)
    c = a = pos = 0
    ct = -16
    qe_of, nl_of, nm_of = _QE, _NL, _NM

    def decode(st, i):
        nonlocal c, a, ct, pos
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if pos < n:
                    data = seg[pos]
                    pos += 1
                elif marker:
                    data = 0
                else:
                    raise BytesEnd("the bytes end inside an arithmetic-coded scan")
                c = (c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        k = sv & 0x7F
        qe = qe_of[k]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm_of[k]
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl_of[k]
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl_of[k]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm_of[k]
        return sv >> 7

    return decode


def _dc_diff(decode, dcs, ctx, slot, lo, hi):
    """Decode_DC_DIFF (figures F.19, F.21-F.24) with the statistics `dcs`:
    the difference, after updating ctx[slot]."""
    s0 = ctx[slot]
    if not decode(dcs, s0):
        ctx[slot] = 0
        return 0
    sign = decode(dcs, s0 + 1)
    st = s0 + 2 + sign
    m = decode(dcs, st)
    if m:
        st = 20
        while decode(dcs, st):
            m <<= 1
            if m == 0x8000:
                raise _Overflow
            st += 1
    if m < (1 << lo) >> 1:
        ctx[slot] = 0
    elif m > (1 << hi) >> 1:
        ctx[slot] = 12 + sign * 4
    else:
        ctx[slot] = 4 + sign * 4
    v = m
    st += 14
    m >>= 1
    while m:
        if decode(dcs, st):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _ac_value(decode, acs, fixed, st, k, kx):
    """The sign and magnitude of a nonzero AC coefficient at zigzag index
    k whose S0 bin is acs[st] (figures F.21-F.24)."""
    sign = decode(fixed, 0)
    st += 2
    m = decode(acs, st)
    if m:
        if decode(acs, st):
            m <<= 1
            st = 189 if k <= kx else 217
            while decode(acs, st):
                m <<= 1
                if m == 0x8000:
                    raise _Overflow
                st += 1
    v = m
    st += 14
    m >>= 1
    while m:
        if decode(acs, st):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _ac_band(decode, acs, fixed, base, ss, se, kx, al, ia, va):
    """Decode_AC_coefficients over zigzag ss..se of one block (the
    sequential form with ss 1, se 63, al 0), appending each nonzero
    coefficient's flat index and value << al."""
    nat = _NATURAL
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if decode(acs, st):
            break                     # end of block
        while not decode(acs, st + 1):
            st += 3
            k += 1
            if k > se:
                raise _Overflow
        v = _ac_value(decode, acs, fixed, st, k, kx)
        ia(base + nat[k])
        va(v << al)
        k += 1


def _ac_refine(decode, acs, fixed, blk, ss, se, p1):
    """decode_mcu_AC_refine on one block's 64 coefficients (zigzag order
    list `blk`, changed in place): correction bits of the coefficients
    nonzero before the scan, newly nonzero ones at +-p1."""
    kex = se
    while kex > 0 and not blk[kex]:
        kex -= 1
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if k > kex and decode(acs, st):
            break
        while True:
            if blk[k]:
                if decode(acs, st + 2):
                    blk[k] += -p1 if blk[k] < 0 else p1
                break
            if decode(acs, st + 1):
                blk[k] = -p1 if decode(fixed, 0) else p1
                break
            st += 3
            k += 1
            if k > se:
                raise _Overflow
        k += 1


def decode_scan(intervals, bases, slots, tables, cond, coefs, ss, se, ah, al,
                progressive: bool) -> None:
    """Decode one arithmetic-coded scan into `coefs` (decode.py's flat
    store). `intervals` lists each restart interval's (unstuffed bytes,
    whether a marker follows them, first MCU, MCU count); `bases` holds each
    MCU's flat block offsets, `slots` each block's component slot in the
    scan, `tables` each slot's (DC, AC) conditioning table numbers, `cond`
    the DAC values in force."""
    fixed = bytearray([FIXED])
    dc_first = progressive and ss == 0 and ah == 0
    dc_refine = progressive and ss == 0 and ah != 0
    use_dc = not progressive or dc_first
    use_ac = not progressive or ss != 0
    kx = cond["K"][tables[0][1]]
    idx, val = [], []
    ia, va = idx.append, val.append
    p1 = 1 << al
    shift = al if progressive else 0
    zigzag = ZIGZAG[:64]
    for seg, marker, first, count in intervals:
        decode = _decoder(seg, marker)
        dcs = {td: bytearray(DC_BINS) for td, _ in tables} if use_dc else {}
        acs = {ta: bytearray(AC_BINS) for _, ta in tables} if use_ac else {}
        pred = [0] * len(tables)
        ctx = [0] * len(tables)
        rows = bases[first:first + count].tolist()
        i = 0
        try:
            if dc_refine:
                for i, row in enumerate(rows):
                    for base in row:
                        if decode(fixed, 0):
                            coefs[base] |= p1
            elif progressive and ss:
                act = acs[tables[0][1]]
                for i, (base,) in enumerate(rows):
                    if ah == 0:
                        _ac_band(decode, act, fixed, base, ss, se, kx, al, ia, va)
                        continue
                    flat = base + zigzag
                    blk = coefs[flat].tolist()
                    before = blk[:]
                    try:
                        _ac_refine(decode, act, fixed, blk, ss, se, p1)
                    finally:
                        if blk != before:
                            coefs[flat] = _wrap16(blk)
            else:
                for i, row in enumerate(rows):
                    for base, slot in zip(row, slots):
                        td, ta = tables[slot]
                        pred[slot] += _dc_diff(decode, dcs[td], ctx, slot,
                                               cond["L"][td], cond["U"][td])
                        ia(base)
                        va(pred[slot] << shift)
                        if not progressive:
                            _ac_band(decode, acs[ta], fixed, base, 1, 63,
                                     cond["K"][ta], 0, ia, va)
        except _Overflow:
            pass          # the rest of the interval is left as it is
        except BytesEnd as e:
            e.mcu = first + i
            raise
    if idx:
        # a later value of one flat index (none in valid data) wins, as
        # libjpeg's store would
        coefs[np.asarray(idx, np.int64)] = _wrap16(val)

