"""Lossless JPEGs (SOF3, 8-bit) as libjpeg-turbo 3.1 decodes them
(jdlhuff.c, jddiffct.c, jdlossls.c), for the plain decoder of
data/decode.py.

- jdlhuff.c: each sample's difference is one Huffman-coded category s
  (a DC table) and s extra bits, extended as a DC difference is; category
  16 means 32768 with no extra bits. An interleaved scan walks MCUs of
  h x v samples of each component, a one-component scan the component's
  own grid, one sample an MCU.
- jdlossls.c: the seven predictors (Ra left, Rb above, Rc above left:
  Ra, Rb, Rc, Ra + Rb - Rc, Ra + ((Rb - Rc) >> 1), Rb + ((Ra - Rc) >> 1),
  (Ra + Rb) >> 1), undone in 16-bit modular arithmetic. The first row of
  the scan and of each restart interval predicts from 2^(P - Pt - 1) and
  then from the left; the first column of the other rows from the sample
  above. The point transform Pt is a left shift, and the sample keeps the
  low 8 bits, as the (JSAMPLE) cast does.
- jddiffct.c: restart intervals are whole MCU rows. A scan that runs out
  of data before its marker (a cut closed by an EOI) reads zero bits for
  the MCU row where it ran out; from the next row on, decode_mcus finds
  its insufficient_data flag set, zeroes the differences and restarts the
  predictor, so those rows come out as 2^(P - Pt - 1) << Pt (mid grey).
  Bytes that end with no marker raise JpegError where libjpeg would
  suspend (see decode._suspends).

The undifferencing of predictors 1, 4 and 5 is a cumulative sum along a
row (the prediction is the left sample plus terms of the row above), and
of 2 and 3 a sum with the row above, both numpy; 6 and 7 halve a sum that
holds the left sample, so each row is a Python loop. The Huffman walk is
a Python loop over the samples.
"""

from __future__ import annotations

import numpy as np

from vision_kit_tpu_torch.data.decode import (DHT, DRI, SOS, STD_HUFFMAN, JpegError,
                                              _ceil_div, _huffman_lookup, _std_lookup,
                                              _suspends, _unstuff, _walk, _windows)


def _walk_samples(w, avail, tables, n, row, trace=None):
    """Huffman-decode up to `n` sample differences of one restart interval,
    the i-th with the lookup table tables[i % len(tables)] (cycled over the
    MCU's samples). Returns (differences, the index of the sample during
    which the bits ran out past `avail`, or None); the walk ends with the
    MCU row (`row` samples) where they ran out, the rest left zero."""
    out = [0] * n
    p = 0
    ran = None
    k = len(tables)
    mask = [(1 << s) - 1 for s in range(17)]
    for i in range(n):
        length, s = tables[i % k][(w[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
        p += length
        if s == 16:
            v = 32768
            s = 0
        elif s:
            v = (w[p >> 3] >> (64 - (p & 7) - s)) & mask[s]
            p += s
            if v < 1 << (s - 1):
                v -= mask[s]
        else:
            v = 0
        out[i] = v
        if trace is not None:
            trace.append((length, s))
        if ran is None and p > avail:
            ran = i
        if ran is not None and (i + 1) % row == 0:
            break
    return out, ran


def _undifference(diff: np.ndarray, psv: int, initial: int, first_row: np.ndarray) -> np.ndarray:
    """jdlossls.c's undifferencing of one component's (rows, width) int64
    differences: rows whose first_row flag is set predict as the scan's
    first row does. Values stay in 0..65535."""
    rows, width = diff.shape
    out = np.zeros_like(diff)
    prev = None
    for y in range(rows):
        d = diff[y]
        if first_row[y] or prev is None:
            row = np.cumsum(d) + initial
        elif psv == 1:
            row = np.cumsum(np.concatenate([[d[0] + prev[0]], d[1:]]))
        elif psv == 2:
            row = d + prev
        elif psv == 3:
            row = d + np.concatenate([prev[:1], prev[:-1]])
        elif psv in (4, 5):
            step = prev[1:] - prev[:-1]
            if psv == 5:
                step = step >> 1
            row = np.cumsum(np.concatenate([[d[0] + prev[0]], d[1:] + step]))
        else:
            vals, pr, dl = [0] * width, prev.tolist(), d.tolist()
            ra = (dl[0] + pr[0]) & 0xFFFF
            vals[0] = ra
            for x in range(1, width):
                rb, rc = pr[x], pr[x - 1]
                pred = rb + ((ra - rc) >> 1) if psv == 6 else (ra + rb) >> 1
                ra = (dl[x] + pred) & 0xFFFF
                vals[x] = ra
            row = np.asarray(vals, np.int64)
        prev = row & 0xFFFF
        out[y] = prev
    return out


def decode_lossless(data: bytes, info: dict) -> list[np.ndarray]:
    """Each component's (height, width) uint8 samples at its own size
    (ceil(H * v / max_v), ceil(W * h / max_h)) for a lossless JPEG that
    jpeg_refusal takes. Raises JpegError where libjpeg's error exit does
    (a bad predictor or point transform, a restart interval that is not
    whole MCU rows, a table no DHT defines) and where it would suspend."""
    height, width = info["height"], info["width"]
    comps = [dict(id=i, h=h, v=v) for i, h, v, _ in info["components"]]
    if len(comps) == 1:
        comps[0].update(h=1, v=1)
    max_h = max(c["h"] for c in comps)
    max_v = max(c["v"] for c in comps)
    for c in comps:
        c["cols"] = _ceil_div(width * c["h"], max_h)
        c["rows"] = _ceil_div(height * c["v"], max_v)
        c["plane"] = None
    by_id = {c["id"]: i for i, c in enumerate(comps)}
    tables, restart, started = {}, 0, False
    for m, a, b, end in _walk(data, open_end=True):
        seg = data[a:b]
        if m == DHT:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                if len(counts) != 16:
                    raise JpegError("short DHT")
                nsym = sum(counts)
                tables[(tc, th)] = _huffman_lookup(counts, list(seg[i + 17:i + 17 + nsym]),
                                                   ac=tc == 1)
                i += 17 + nsym
        elif m == DRI:
            restart = (seg[0] << 8) | seg[1]
        elif m == SOS:
            if not started:   # jdlhuff.c fills undefined slots 0 and 1 as jdhuff.c
                for key in STD_HUFFMAN:
                    tables.setdefault(key, _std_lookup(*key))
            started = True
            _scan(data, b, end, seg, comps, by_id, tables, restart, height, width, max_h, max_v)
    planes = []
    for c in comps:
        if c["plane"] is None:
            raise JpegError(f"component {c['id']} is in no scan")
        planes.append(c["plane"])
    return planes


def _scan(data, pos, end, seg, comps, by_id, tables, restart, height, width, max_h, max_v):
    ns = seg[0]
    if len(seg) < 4 + 2 * ns:
        raise JpegError("short SOS")
    psv, se, ah, pt = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    if not 1 <= psv <= 7 or se or ah or pt >= 8:
        raise JpegError(f"bad lossless parameters Ss={psv} Se={se} Ah={ah} Al={pt}")
    scan = []
    for k in range(ns):
        cid, td = seg[1 + 2 * k], seg[2 + 2 * k] >> 4
        if cid not in by_id:
            raise JpegError("scan names an unknown component")
        if (0, td) not in tables:
            raise JpegError("Huffman table not defined")
        scan.append((comps[by_id[cid]], tables[(0, td)]))
    # the samples of each MCU, as (component slot, row, column) in the MCU
    # grid's padded planes, and the MCU grid
    if ns == 1:
        c = scan[0][0]
        mcu_rows, mcu_cols, shape = c["rows"], c["cols"], [(1, 1)]
    else:
        mcu_rows, mcu_cols = _ceil_div(height, max_v), _ceil_div(width, max_h)
        shape = [(c["v"], c["h"]) for c, _ in scan]
    if restart and restart % mcu_cols:
        raise JpegError(f"restart interval {restart} is not whole MCU rows of {mcu_cols}")
    pattern, lookup = [], []
    for slot, (v, h) in enumerate(shape):
        for by in range(v):
            for bx in range(h):
                pattern.append((slot, by, bx))
                lookup.append(scan[slot][1])
    per_mcu = len(pattern)
    interval_rows = restart // mcu_cols if restart else mcu_rows
    firsts = range(0, mcu_rows, interval_rows)
    marker = end < len(data)
    segs = _unstuff(data, pos, end)[:len(firsts)]
    if len(segs) < len(firsts) and not marker:
        raise JpegError("the bytes end inside a scan")
    diffs = [np.zeros((mcu_rows * v, mcu_cols * h), np.int64) for v, h in shape]
    first_row = [np.zeros(mcu_rows * v, bool) for v, _ in shape]
    insufficient = False
    for i, first in enumerate(firsts):
        rows_here = min(interval_rows, mcu_rows - first)
        body = segs[i] if i < len(segs) else np.zeros(0, np.uint8)
        for slot, (v, _) in enumerate(shape):
            first_row[slot][first * v] = True
        if insufficient:   # the rows after a run out of data: zero, predictor reset
            for slot, (v, _) in enumerate(shape):
                first_row[slot][first * v:(first + rows_here) * v] = True
            continue
        n = rows_here * mcu_cols * per_mcu
        if marker or i < len(segs) - 1:
            trace = None
        else:   # bytes that end with no marker: libjpeg may suspend
            trace = []
        row = mcu_cols * per_mcu   # zero bits past the bytes: at most 17 a sample
        vals, ran = _walk_samples(_windows(body, 17 * row // 8 + 16), 8 * len(body),
                                  lookup, n, row, trace)
        if trace is not None and _suspends(trace, range(0, len(trace) + 1, per_mcu),
                                           len(body)):
            raise JpegError("the bytes end inside a scan, where libjpeg's bit buffer "
                            "reads past them")
        grid = np.asarray(vals, np.int64).reshape(rows_here, mcu_cols, per_mcu)
        if ran is not None:
            bad_row = ran // (mcu_cols * per_mcu)
            grid[bad_row + 1:] = 0
            insufficient = True
            for slot, (v, _) in enumerate(shape):
                first_row[slot][(first + bad_row + 1) * v:(first + rows_here) * v] = True
        for j, (slot, by, bx) in enumerate(pattern):
            v, h = shape[slot]
            diffs[slot][first * v + by:(first + rows_here) * v:v, bx::h] = grid[:, :, j]
    initial = 1 << (8 - pt - 1)
    for slot, (c, _) in enumerate(scan):
        d = diffs[slot][:c["rows"], :c["cols"]]
        samples = _undifference(d, psv, initial, first_row[slot][:c["rows"]])
        c["plane"] = ((samples << pt) & 0xFF).astype(np.uint8)

