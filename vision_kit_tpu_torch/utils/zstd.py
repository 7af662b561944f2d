"""Zstandard decompression (RFC 8878) in plain Python.

The JAX package's orbax checkpoints store every array chunk, and the
OCDBT B-tree nodes that index them, as Zstandard frames (tensorstore's
`zstd` compressor). The card's machine has no zstd library, so the port
reads the format itself. This module is the plain decoder; the card's
path takes csrc/zstd_decode.cu (the same decoder as host C++, through
`decompress(..., device="cuda")`), which must equal it byte for byte.

It covers the whole frame format:

  * frames with or without Frame_Content_Size, single-segment frames and
    the window descriptor, the content checksum (the low 32 bits of
    XXH64, verified), concatenated frames and skippable frames; a frame
    that names a dictionary is refused (DictionaryError);
  * raw, RLE and compressed blocks;
  * literals raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the
    previous block's table); Huffman weights direct or FSE-compressed;
  * sequences with the three symbol types each predefined, RLE,
    FSE-compressed or repeated, the three repeat offsets, and matches
    that reach back into earlier blocks of the frame.

Huffman symbols are decoded one table lookup each, through a table of
2**max_bits entries. A frame is parsed first (headers, Huffman tables,
the literal streams' bounds), its literals decoded, then its sequences
executed; decompress_many decodes the literals of many frames together,
and from LOCKSTEP_LANES streams on it walks them all in lockstep with
numpy (one step a symbol of every stream), which is how the plain
decoder reads an orbax checkpoint's chunks at a usable rate. Truncated or
corrupt input raises ZstdError; the decoder never returns short output.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC = 0x184D2A50          # to 0x184D2A5F
MAX_BLOCK = 128 * 1024


class ZstdError(ValueError):
    """Input that is not a complete, valid Zstandard stream."""


class DictionaryError(ZstdError):
    """A frame that needs a dictionary (a nonzero Dictionary_ID)."""


# -- XXH64 ------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the zstd content checksum is its low 32 bits)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        pos = (n // 32) * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, pos)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= (struct.unpack_from("<I", data, pos)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# -- FSE tables -------------------------------------------------------------

# (baseline, extra bits) of the literal-length and match-length codes
LL_BASE = (*range(16), 16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
           1024, 2048, 4096, 8192, 16384, 32768, 65536)
LL_BITS = (0,) * 16 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13,
                       14, 15, 16)
ML_BASE = (*range(3, 35), 35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259,
           515, 1027, 2051, 4099, 8195, 16387, 32771, 65539)
ML_BITS = (0,) * 32 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13,
                       14, 15, 16)

# the predefined distributions (RFC 8878 3.1.1.3.2.2)
LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2,
              2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1)
ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2) + (1,) * 37 + (-1,) * 7
OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2) + (1,) * 15 + (-1,) * 5

# (largest code, largest accuracy log) of each sequence symbol type
LL_MAX, ML_MAX, OF_MAX = (35, 9), (52, 9), (31, 8)


def fse_table(norm, log: int):
    """The decoding table of a normalized distribution (-1 = "less than
    one"): (symbol, number of bits, next-state baseline) lists, one entry
    per state."""
    size = 1 << log
    sym = [0] * size
    high = size
    nxt = [0] * len(norm)
    for s, c in enumerate(norm):
        if c == -1:
            high -= 1
            sym[high] = s
            nxt[s] = 1
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(norm):
        if c <= 0:
            continue
        nxt[s] = c
        for _ in range(c):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos >= high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nbits = [0] * size
    base = [0] * size
    for i in range(size):
        d = nxt[sym[i]]
        nxt[sym[i]] = d + 1
        nb = log - (d.bit_length() - 1)
        nbits[i] = nb
        base[i] = (d << nb) - size
    return sym, nbits, base, log


def read_fse_header(data, pos: int, end: int, max_symbol: int, max_log: int):
    """Read an FSE table description at data[pos:end]: (table, position
    after it)."""
    bitpos = pos * 8

    def bits(n):
        # past `end` the reads give zeros; the final position is checked
        b = bitpos >> 3
        chunk = int.from_bytes(data[b:min(b + 8, end)], "little")
        return (chunk >> (bitpos & 7)) & ((1 << n) - 1)

    if pos >= end:
        raise ZstdError("FSE table description truncated")
    log = bits(4) + 5
    bitpos += 4
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over {max_log}")
    remaining = 1 << log
    norm = []
    while remaining > 0:
        if len(norm) > max_symbol:
            raise ZstdError("FSE table description has too many symbols")
        nb = (remaining + 1).bit_length()
        val = bits(nb)
        lower = (1 << (nb - 1)) - 1
        threshold = (1 << nb) - 1 - (remaining + 1)
        if (val & lower) < threshold:
            val &= lower
            bitpos += nb - 1
        else:
            if val > lower:
                val -= threshold
            bitpos += nb
        count = val - 1
        remaining -= abs(count)
        norm.append(count)
        if count == 0:
            while True:
                rep = bits(2)
                bitpos += 2
                norm.extend([0] * rep)
                if rep != 3:
                    break
    if remaining != 0 or len(norm) > max_symbol + 1:
        raise ZstdError("FSE table description is corrupt")
    if bitpos > end * 8:
        raise ZstdError("FSE table description truncated")
    return fse_table(norm, log), (bitpos + 7) >> 3


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


PREDEFINED = {"ll": fse_table(LL_DEFAULT, 6), "ml": fse_table(ML_DEFAULT, 6),
              "of": fse_table(OF_DEFAULT, 5)}


# -- backward bit streams ---------------------------------------------------

_PAD = bytes(8)


def _backward(data, start: int, end: int):
    """(stream with 8 zero bytes in front, bit position of its top): the
    bits of data[start:end] below the final byte's padding marker. A read
    below bit 64 reads the zero padding; a stream ends exactly at 64."""
    if end <= start:
        raise ZstdError("empty bit stream")
    last = data[end - 1]
    if last == 0:
        raise ZstdError("bit stream without its end marker")
    return _PAD + bytes(data[start:end]), 64 + (end - start - 1) * 8 + last.bit_length() - 1


# -- literals ---------------------------------------------------------------

def _huffman_weights(data, pos: int, end: int):
    """The Huffman tree description at data[pos:]: (weights, position after
    it)."""
    if pos >= end:
        raise ZstdError("Huffman tree description truncated")
    header = data[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        nbytes = (n + 1) // 2
        if pos + nbytes > end:
            raise ZstdError("Huffman weights truncated")
        weights = []
        for b in data[pos:pos + nbytes]:
            weights += (b >> 4, b & 15)
        return weights[:n], pos + nbytes
    if pos + header > end:
        raise ZstdError("Huffman weights truncated")
    (sym, nbits, base, log), start = read_fse_header(data, pos, pos + header, 255, 6)
    src, p = _backward(data, start, pos + header)

    def read(n):
        nonlocal p
        p -= n
        if p < 0:
            raise ZstdError("Huffman weight stream overrun")
        return (int.from_bytes(src[p >> 3:(p >> 3) + 4], "little") >> (p & 7)) & ((1 << n) - 1)

    s1, s2 = read(log), read(log)
    weights = []
    # two interleaved states; past the stream's end the reads give zeros,
    # and the other state's symbol is the last
    while True:
        weights.append(sym[s1])
        s1 = base[s1] + read(nbits[s1])
        if p < 64:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + read(nbits[s2])
        if p < 64:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return weights, pos + header


def huffman_table(weights):
    """(symbols, lengths, max_bits) tables indexed by max_bits bits from
    the weights of all but the last symbol (whose weight is implied)."""
    if len(weights) > 255:
        raise ZstdError("too many Huffman weights")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights are all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise ZstdError("Huffman weights are corrupt")
    weights = [*weights, rest.bit_length()]
    start, rank = 0, [0] * (max_bits + 2)
    counts = [0] * (max_bits + 2)
    for w in weights:
        if w > max_bits:
            raise ZstdError("Huffman weight over the table's bits")
        counts[w] += 1
    for w in range(1, max_bits + 1):
        rank[w] = start
        start += counts[w] << (w - 1)
    syms = np.zeros(1 << max_bits, np.int64)
    lens = np.zeros(1 << max_bits, np.int64)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            syms[rank[w]:rank[w] + n] = s
            lens[rank[w]:rank[w] + n] = max_bits + 1 - w
            rank[w] += n
    return syms.tolist(), lens.tolist(), max_bits


def _huffman_stream(data, start: int, end: int, n_out: int, table) -> bytes:
    """n_out symbols of the backward stream data[start:end], one lookup of
    max_bits bits each (the 24-bit windows at every byte made at once)."""
    syms, lens, mb = table
    src, pos = _backward(data, start, end)
    a = np.frombuffer(src + bytes(3), np.uint8).astype(np.int32)
    words = (a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16)).tolist()
    mask = (1 << mb) - 1
    out = bytearray(n_out)
    lo = pos - mb
    for i in range(n_out):
        v = (words[lo >> 3] >> (lo & 7)) & mask
        out[i] = syms[v]
        lo -= lens[v]
    if lo != 64 - mb:
        raise ZstdError("Huffman stream not consumed exactly")
    return out


def _literals(data, pos: int, end: int, st):
    """The literals section at data[pos:end]: (bytes, or the _Literals of
    its Huffman streams, to be decoded later; the position after it)."""
    if pos >= end:
        raise ZstdError("literals section truncated")
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if size > MAX_BLOCK:
            raise ZstdError("literals over the block maximum")
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals truncated")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("RLE literals truncated")
        return bytes([data[pos]]) * size, pos + 1
    nh = (3, 3, 4, 5)[fmt]
    if pos + nh > end:
        raise ZstdError("literals header truncated")
    h = int.from_bytes(data[pos:pos + nh], "little")
    bits = (10, 10, 14, 18)[fmt]
    regen = (h >> 4) & ((1 << bits) - 1)
    comp = h >> (4 + bits)
    streams = 1 if fmt == 0 else 4
    pos += nh
    lit_end = pos + comp
    if lit_end > end or regen > MAX_BLOCK:
        raise ZstdError("compressed literals truncated")
    if kind == 2:
        weights, pos = _huffman_weights(data, pos, lit_end)
        st.huffman = huffman_table(weights)
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    if streams == 1:
        return _Literals(data, st.huffman, [(pos, lit_end, regen)]), lit_end
    if pos + 6 > lit_end:
        raise ZstdError("literal jump table truncated")
    s1, s2, s3 = struct.unpack_from("<3H", data, pos)
    pos += 6
    bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, lit_end]
    if bounds[3] > lit_end:
        raise ZstdError("literal jump table is corrupt")
    each = (regen + 3) // 4
    sizes = (each, each, each, regen - 3 * each)
    if sizes[3] < 0:
        raise ZstdError("literal sizes are corrupt")
    return (_Literals(data, st.huffman, [(bounds[i], bounds[i + 1], sizes[i])
                                         for i in range(4)]), lit_end)


class _Literals:
    """A block's Huffman-coded literals: the bytes they lie in, the table
    and the streams' (start, end, symbols), decoded with every other
    block's at once."""
    __slots__ = ("data", "table", "streams", "decoded")

    def __init__(self, data, table, streams):
        self.data, self.table, self.streams, self.decoded = data, table, streams, None


LOCKSTEP_LANES = 48     # streams from which one lockstep walk beats one walk each


def _decode_literals(pending: list) -> None:
    """Decode every Huffman stream of `pending` (_Literals of any frames)
    into its .decoded bytes: one stream after another, or, with
    many streams, all in lockstep with numpy (one table lookup a symbol,
    each step a symbol of every stream still running)."""
    jobs = [(lit, *st) for lit in pending for st in lit.streams]
    if len(jobs) < LOCKSTEP_LANES:
        for lit in pending:
            lit.decoded = b"".join(_huffman_stream(lit.data, a, b, n, lit.table)
                                   for a, b, n in lit.streams)
        return
    srcs, tops = [], []
    for lit, a, b, _ in jobs:
        src, top = _backward(lit.data, a, b)
        srcs.append(src)
        tops.append(top)
    sizes = np.array([len(x) for x in srcs], np.int64)
    byte0 = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    raw = np.frombuffer(b"".join(srcs) + bytes(3), np.uint8).astype(np.int64)
    words = raw[:-3] | (raw[1:-2] << 8) | (raw[2:-1] << 16)
    tables, tbase, offset = {}, [], 0
    for lit, *_ in jobs:
        if id(lit.table) not in tables:
            tables[id(lit.table)] = (offset, lit.table)
            offset += 1 << lit.table[2]
        tbase.append(tables[id(lit.table)][0])
    syms = np.concatenate([np.asarray(t[0], np.uint8) for _, t in tables.values()])
    lens = np.concatenate([np.asarray(t[1], np.int64) for _, t in tables.values()])
    mb = np.array([lit.table[2] for lit, *_ in jobs], np.int64)
    n_out = np.array([job[3] for job in jobs], np.int64)
    order = np.argsort(-n_out, kind="stable")
    lo = (byte0 * 8 + np.asarray(tops) - mb)[order]
    mask, tbase = ((1 << mb) - 1)[order], np.asarray(tbase, np.int64)[order]
    counts = n_out[order]
    steps = int(counts[0]) if len(counts) else 0
    out = np.zeros((steps, len(jobs)), np.uint8)
    k = len(jobs)
    for t in range(steps):
        while counts[k - 1] <= t:
            k -= 1
        lk = lo[:k]
        v = (np.take(words, lk >> 3, mode="clip") >> (lk & 7)) & mask[:k]
        ti = tbase[:k] + v
        out[t, :k] = syms[ti]
        lk -= lens[ti]
    if not np.array_equal(lo, (byte0 * 8 + 64 - mb)[order]):
        raise ZstdError("Huffman stream not consumed exactly")
    decoded = [None] * len(jobs)
    for lane, j in enumerate(order):
        decoded[j] = out[:counts[lane], lane].tobytes()
    first = 0                      # jobs run through each block's streams in turn
    for lit in pending:
        lit.decoded = b"".join(decoded[first:first + len(lit.streams)])
        first += len(lit.streams)


# -- sequences --------------------------------------------------------------

def _seq_table(mode: int, data, pos: int, end: int, st, kind: str, limits):
    if mode == 0:
        table = PREDEFINED[kind]
    elif mode == 1:
        if pos >= end:
            raise ZstdError("RLE sequence symbol truncated")
        if data[pos] > limits[0]:
            raise ZstdError("RLE sequence symbol out of range")
        table, pos = _rle_table(data[pos]), pos + 1
    elif mode == 2:
        table, pos = read_fse_header(data, pos, end, limits[0], limits[1])
    else:
        table = st.tables[kind]
        if table is None:
            raise ZstdError("repeated sequence table without an earlier one")
    st.tables[kind] = table
    return table, pos


def _sequences(data, pos: int, end: int, st, lits: bytes, out: bytearray,
               frame_start: int) -> None:
    """Decode the sequences at data[pos:end] and execute them on `out`."""
    if pos >= end:
        raise ZstdError("sequences section truncated")
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ZstdError("data after an empty sequences section")
        out += lits
        return
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > end:
            raise ZstdError("sequence count truncated")
        n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > end:
            raise ZstdError("sequence count truncated")
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= end:
        raise ZstdError("sequence modes truncated")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits of the sequence modes are set")
    ll_t, pos = _seq_table(modes >> 6, data, pos, end, st, "ll", LL_MAX)
    of_t, pos = _seq_table((modes >> 4) & 3, data, pos, end, st, "of", OF_MAX)
    ml_t, pos = _seq_table((modes >> 2) & 3, data, pos, end, st, "ml", ML_MAX)
    src, p = _backward(data, pos, end)
    fb = int.from_bytes

    def read(n):
        nonlocal p
        p -= n
        if p < 0:
            raise ZstdError("sequence bit stream overrun")
        return (fb(src[p >> 3:(p >> 3) + 8], "little") >> (p & 7)) & ((1 << n) - 1)

    ll_sym, ll_nb, ll_base, ll_log = ll_t
    of_sym, of_nb, of_base, of_log = of_t
    ml_sym, ml_nb, ml_base, ml_log = ml_t
    ll_s = read(ll_log)
    of_s = read(of_log)
    ml_s = read(ml_log)
    rep = st.rep
    lit_pos = 0
    n_lits = len(lits)
    for i in range(n):
        of_code, ll_code, ml_code = of_sym[of_s], ll_sym[ll_s], ml_sym[ml_s]
        if of_code > 31:
            raise ZstdError("offset code out of range")
        if ll_code > 35 or ml_code > 52:
            raise ZstdError("sequence code out of range")
        of_val = (1 << of_code) + (read(of_code) if of_code else 0)
        ml = ML_BASE[ml_code] + (read(ML_BITS[ml_code]) if ML_BITS[ml_code] else 0)
        ll = LL_BASE[ll_code] + (read(LL_BITS[ll_code]) if LL_BITS[ll_code] else 0)
        if i + 1 < n:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if p < 64:
            raise ZstdError("sequence bit stream overrun")
        if of_val > 3:
            offset = of_val - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = of_val - 1 + (ll == 0)
            if idx == 0:
                offset = rep[0]
            else:
                offset = rep[idx] if idx < 3 else rep[0] - 1
                if idx > 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], offset
        if lit_pos + ll > n_lits:
            raise ZstdError("sequence takes more literals than the block has")
        out += lits[lit_pos:lit_pos + ll]
        lit_pos += ll
        have = len(out) - frame_start
        if offset == 0 or offset > have:
            raise ZstdError(f"match offset {offset} reaches before the frame")
        s = len(out) - offset
        if offset >= ml:
            out += out[s:s + ml]
        else:
            pat = out[s:]
            out += (pat * (ml // offset + 1))[:ml]
    if p != 64:
        raise ZstdError("sequence bit stream not consumed exactly")
    out += lits[lit_pos:]


# -- frames -----------------------------------------------------------------

class _FrameState:
    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def frame_header(data, pos: int = 0) -> dict:
    """The header of the frame at data[pos:]: window size, content size
    (None when absent), checksum flag, header length."""
    if pos + 5 > len(data):
        raise ZstdError("frame header truncated")
    (magic,) = struct.unpack_from("<I", data, pos)
    if magic != MAGIC:
        raise ZstdError(f"not a Zstandard frame (magic {magic:#010x})")
    fhd = data[pos + 4]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit of the frame header is set")
    p = pos + 5
    window = None
    if not single:
        if p >= len(data):
            raise ZstdError("frame header truncated")
        wd = data[p]
        p += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    nd = (0, 1, 2, 4)[dict_flag]
    fcs_n = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if p + nd + fcs_n > len(data):
        raise ZstdError("frame header truncated")
    dict_id = int.from_bytes(data[p:p + nd], "little")
    p += nd
    if dict_id:
        raise DictionaryError(f"frame needs dictionary {dict_id}; no dictionary is known")
    size = None
    if fcs_n:
        size = int.from_bytes(data[p:p + fcs_n], "little") + (256 if fcs_n == 2 else 0)
        p += fcs_n
    if single:
        window = size
    return {"window": window, "size": size, "checksum": bool(checksum), "end": p}


def _parse_frame(data, pos: int, pending: list) -> dict:
    """The frame at data[pos:]: its header, its blocks (bytes, or the
    literals and sequences bounds of a compressed block) and its end. The
    Huffman literals go to `pending`, to be decoded with the others."""
    h = frame_header(data, pos)
    p = h["end"]
    st = _FrameState()
    block_max = min(h["window"], MAX_BLOCK)
    blocks = []
    while True:
        if p + 3 > len(data):
            raise ZstdError("block header truncated")
        bh = data[p] | (data[p + 1] << 8) | (data[p + 2] << 16)
        p += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 1:
            if p + 1 > len(data):
                raise ZstdError("RLE block truncated")
            if bsize > block_max:
                raise ZstdError("block over the frame's maximum")
            blocks.append(bytes([data[p]]) * bsize)
            p += 1
        else:
            if p + bsize > len(data):
                raise ZstdError("block truncated")
            if bsize > block_max:
                raise ZstdError("block over the frame's maximum")
            if btype == 0:
                blocks.append(data[p:p + bsize])
            elif btype == 2:
                lits, q = _literals(data, p, p + bsize, st)
                if isinstance(lits, _Literals):
                    pending.append(lits)
                blocks.append((lits, q, p + bsize))
            else:
                raise ZstdError("reserved block type")
            p += bsize
        if last:
            break
    if h["checksum"]:
        if p + 4 > len(data):
            raise ZstdError("content checksum truncated")
        p += 4
    return {**h, "blocks": blocks, "block_max": block_max, "frame_end": p}


def _run_frame(data, f: dict, out: bytearray) -> None:
    """Execute a parsed frame's blocks onto `out` (its literals decoded)
    and verify its content size and checksum."""
    start = len(out)
    st = _FrameState()
    for block in f["blocks"]:
        if isinstance(block, tuple):
            lits, q, end = block
            before = len(out)
            _sequences(data, q, end, st,
                       lits.decoded if isinstance(lits, _Literals) else lits, out, start)
            if len(out) - before > f["block_max"]:
                raise ZstdError("block decodes to more than the frame's maximum")
        else:
            out += block
        if f["size"] is not None and len(out) - start > f["size"]:
            raise ZstdError("frame decodes to more than its content size")
    if f["size"] is not None and len(out) - start != f["size"]:
        raise ZstdError(f"frame decodes to {len(out) - start} bytes, its header "
                        f"says {f['size']}")
    if f["checksum"]:
        (want,) = struct.unpack_from("<I", data, f["frame_end"] - 4)
        got = xxh64(bytes(out[start:])) & 0xFFFFFFFF
        if got != want:
            raise ZstdError(f"content checksum {got:#010x}, frame says {want:#010x}")


def decompress_many(items, device: str = "cpu") -> list[bytes]:
    """decompress of each of `items`, the plain decoder taking the Huffman
    literals of all of them in one walk (an orbax checkpoint's chunks);
    device "cuda" runs the host C decoder on each."""
    if str(device).startswith("cuda"):
        return [decompress_c(x) for x in items]
    pending: list = []
    parsed = []
    for data in items:
        if not isinstance(data, bytes):
            data = bytes(data)
        frames, pos = [], 0
        if not len(data):
            raise ZstdError("no frame")
        while pos < len(data):
            if pos + 4 > len(data):
                raise ZstdError("trailing bytes after the last frame")
            (magic,) = struct.unpack_from("<I", data, pos)
            if magic & 0xFFFFFFF0 == SKIPPABLE_MAGIC:
                if pos + 8 > len(data):
                    raise ZstdError("skippable frame truncated")
                (n,) = struct.unpack_from("<I", data, pos + 4)
                if pos + 8 + n > len(data):
                    raise ZstdError("skippable frame truncated")
                pos += 8 + n
            else:
                f = _parse_frame(data, pos, pending)
                frames.append(f)
                pos = f["frame_end"]
        parsed.append((data, frames))
    _decode_literals(pending)
    outs = []
    for data, frames in parsed:
        out = bytearray()
        for f in frames:
            _run_frame(data, f, out)
        outs.append(bytes(out))
    return outs


def decompress(data: bytes, device: str = "cpu") -> bytes:
    """All frames of `data` decoded and joined; skippable frames are
    passed over. device "cuda" takes the host C decoder
    (csrc/zstd_decode.cu, built with nvcc) and raises if it cannot be built
    or loaded; any other device this plain decoder."""
    if str(device).startswith("cuda"):
        return decompress_c(data)
    return decompress_many([data])[0]


def raw_frame(data: bytes) -> bytes:
    """`data` as one single-segment frame of raw blocks, with its content
    size and no checksum: valid Zstandard that any decoder reads, the
    simplest a writer can make."""
    out = bytearray(struct.pack("<IBQ", MAGIC, 0xE0, len(data)))
    pos = 0
    while True:
        n = min(MAX_BLOCK, len(data) - pos)
        last = pos + n == len(data)
        out += (last | (n << 3)).to_bytes(3, "little")
        out += data[pos:pos + n]
        pos += n
        if last:
            return bytes(out)


# -- the host C decoder -----------------------------------------------------

def _lib():
    import ctypes

    from vision_kit_tpu_torch import _cuda_build

    lib = _cuda_build.load("zstd_decode")
    lib.vk_zstd_decompressed_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.vk_zstd_decompressed_size.restype = ctypes.c_longlong
    lib.vk_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_void_p, ctypes.c_size_t]
    lib.vk_zstd_decompress.restype = ctypes.c_longlong
    lib.vk_zstd_calls.argtypes = []
    lib.vk_zstd_calls.restype = ctypes.c_longlong
    lib.vk_zstd_error.argtypes = [ctypes.c_longlong]
    lib.vk_zstd_error.restype = ctypes.c_char_p
    return lib


def c_calls() -> int:
    """How many times the host C decoder has run in this process (its own
    count, one a decompress_c call)."""
    return int(_lib().vk_zstd_calls())


def decompress_c(data: bytes) -> bytes:
    """decompress by csrc/zstd_decode.cu's host C++ decoder (nvcc-built,
    loaded with ctypes): the same output and the same refusals as the plain
    decoder (DictionaryError for a dictionary, ZstdError otherwise).
    Raises RuntimeError when the library cannot be built or loaded."""
    lib = _lib()
    data = bytes(data)
    bound = lib.vk_zstd_decompressed_size(data, len(data))
    if bound < 0:
        _raise_c(lib, bound)
    out = np.empty(max(int(bound), 1), np.uint8)
    n = lib.vk_zstd_decompress(data, len(data), out.ctypes.data, int(bound))
    if n < 0:
        _raise_c(lib, n)
    return out[:n].tobytes()


def _raise_c(lib, status: int):
    msg = lib.vk_zstd_error(status).decode()
    if status == -2:
        raise DictionaryError(msg)
    raise ZstdError(msg)
