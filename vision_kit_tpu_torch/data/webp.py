"""WebP decode without libwebp: cv2.imdecode(IMREAD_COLOR) + BGR2RGB of a
WebP file, bit for bit, in numpy and the standard library.

The reference is OpenCV 5's grfmt_webp.cpp over its built-in libwebp
(decoder ABI 0x0210), as cv2 runs them:

- The container (webp_dec.c ParseHeadersInternal): RIFF/"WEBP" with its
  size checks (a RIFF size past the bytes, a chunk past the RIFF size, an
  odd size, trailing bytes), "VP8X" (24-bit canvas size plus one, its
  flags), the optional chunks before the image ("ICCP", "ALPH", unknown
  ones, skipped with their padding), then "VP8 " or "VP8L"; a raw "VP8L"
  bitstream without a RIFF header too (cv2 sniffs the first 32 bytes with
  WebPGetFeatures and takes it). The image decodes from every byte after
  its chunk header, as WebPDecode does. The last "ALPH" chunk before a
  "VP8 " image is decoded for its failures (libwebp fails the whole decode
  on a bad one) and dropped (IMREAD_COLOR keeps the colour planes as
  decoded: no blend, no premultiplication). The EXIF orientation of the
  first "EXIF" chunk of a VP8X file that flags it is applied as cv2
  applies it; "ICCP" and "XMP " are ignored, as cv2 ignores them.
  An animated file ("ANIM" and "ANMF" chunks) gives its first frame on a
  zero canvas at its offset, as WebPAnimDecoder composes it. OpenCV's
  size limits apply (decode.size_refusal).
- VP8L, lossless (vp8l_dec.c, huffman_utils.c, lossless.c): an LSB-first
  bit reader; simple and normal prefix codes (code lengths in
  kCodeLengthCodeOrder, repeat codes 16, 17 and 18, max_symbol), each
  checked complete as BuildHuffmanTable checks it; meta prefix codes
  (the entropy image); LZ77 lengths and distances with the 120-entry
  distance map; the colour cache (hash 0x1e35a7bd); the predictor
  (modes 0-13, 14 and 15 as 0), cross-colour, subtract-green and
  colour-indexing transforms (1, 2 and 4-bit bundling) undone in reverse
  order; the bits read past the end fail the decode, as libwebp's eos_.
- VP8, lossy (RFC 6386 as libwebp implements it: vp8_dec.c, tree_dec.c,
  quant_dec.c, frame_dec.c, dsp/dec.c, upsampling.c, yuv.h): the frame
  header, segments, filter header and 1-8 token partitions; the boolean
  decoder with libwebp's end of data (any read past a partition's bytes
  fails the decode, as its eof_ checks do); dequantisation; intra modes,
  coefficient tokens with their non-zero contexts; reconstruction with
  the border values (127 above, 129 to the left), the top-right pixels of
  the 4x4 predictors, the ten 4x4, four 16x16 and four chroma predictors,
  TransformOne and the WHT; the simple and normal loop filters in
  libwebp's edge order; the fancy upsampler with its own rounding and the
  14-bit YUV -> RGB of yuv.h; the crop to the frame.

The Huffman and token loops, the intra prediction of each macroblock and
the predictor transform's modes that read the left pixel are Python; the
other transforms, the residuals' IDCT, the loop filter (in waves of
macroblocks that do not touch each other's pixels), the upsampling and
the colour conversion are numpy.
"""

from __future__ import annotations

import numpy as np

from vision_kit_tpu_torch.data.decode import parse_exif_orientation, size_refusal
from vision_kit_tpu_torch.data.vp8 import (
    COEFFS_PROBA0 as _COEFFS_PROBA0,
    COEFFS_UPDATE_PROBA as _COEFFS_UPDATE_PROBA,
    BoolReader as _BoolReader,
    reconstruct as _reconstruct,
    loop_filter as _loop_filter,
    KEY_UVMODE_PROBA as _KEY_UVMODE_PROBA,
    key_intra_modes as _key_intra_modes,
    mb_coeffs as _mb_coeffs,
    quantizers as _quantizers,
    token_bands as _token_bands,
    uv_mode as _uv_mode,
)


class WebPError(ValueError):
    """Bytes that cv2 (libwebp) does not decode as WebP; decode_image
    answers None."""


class _NotEnoughData(WebPError):
    """VP8_STATUS_NOT_ENOUGH_DATA: the header parse ran out of bytes."""


# -- tables ----------------------------------------------------------------

# vp8l_dec.c kCodeToPlane: distance codes 1..120 as (dy << 4) | (8 - dx)
_CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54,
    58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52,
    60, 3, 87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2,
    103, 105, 18, 30, 102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120,
    1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115,
    125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112)
# vp8l_dec.c kCodeLengthCodeOrder, and the code-length repeats 16, 17, 18
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_REPEAT_BITS, _REPEAT_OFFSET = (2, 3, 7), (3, 3, 11)
# the five alphabets of a prefix-code group: green + lengths, red, blue,
# alpha, distance
_ALPHABETS = (256 + 24, 256, 256, 256, 40)


# -- the container ---------------------------------------------------------

SIGNATURE_BYTES = 32   # grfmt_webp.cpp WEBP_HEADER_SIZE: the bytes cv2 sniffs
_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
VP8X_ANIMATION, VP8X_XMP, VP8X_EXIF, VP8X_ALPHA, VP8X_ICC = 0x02, 0x04, 0x08, 0x10, 0x20
_VP8X_VALID = VP8X_ANIMATION | VP8X_XMP | VP8X_EXIF | VP8X_ALPHA | VP8X_ICC


def _le16(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8)


def _le24(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16)


def _le32(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16) | (b[i + 3] << 24)


def is_webp(data: bytes) -> bool:
    """RIFF/"WEBP" bytes, or a raw VP8L bitstream (VP8LCheckSignature):
    cv2 takes both as WebP."""
    return ((data[:4] == b"RIFF" and data[8:12] == b"WEBP")
            or (len(data) >= 5 and data[0] == 0x2F and data[4] >> 5 == 0))


def _vp8_info(b: bytes, chunk_size: int) -> tuple[int, int]:
    """VP8GetInfo: (width, height) of a VP8 key frame's first 10 bytes."""
    if len(b) < 10 or b[3:6] != b"\x9d\x01\x2a":
        raise WebPError("not a VP8 key frame")
    bits = _le24(b, 0)
    w, h = _le16(b, 6) & 0x3FFF, _le16(b, 8) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size:
        raise WebPError("bad VP8 frame tag")
    if w == 0 or h == 0:
        raise WebPError("zero VP8 size")
    return w, h


def _vp8l_info(b: bytes) -> tuple[int, int, bool]:
    """VP8LGetInfo: (width, height, has_alpha) from a VP8L header."""
    if len(b) < 5 or b[0] != 0x2F or b[4] >> 5:
        raise WebPError("not a VP8L bitstream")
    v = _le32(b, 1)
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def _parse_headers(data: bytes, have_all_data: bool, features: bool = False) -> dict:
    """webp_dec.c ParseHeadersInternal. With `features` (WebPGetFeatures,
    no headers kept) an animated VP8X answers from its canvas, and a VP8X
    file that runs out of bytes still answers its canvas size. Returns
    width, height, has_alpha, animation, vp8x flags, and for the image:
    lossless, offset (its bitstream's first byte), riff_size. Raises
    _NotEnoughData or WebPError as the parse fails."""
    n = len(data)
    if n < 12:
        raise _NotEnoughData("fewer than 12 bytes")
    pos = riff_size = 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise WebPError("a RIFF file that is not WEBP")
        size = _le32(data, 4)
        if size < 12 or size > _MAX_CHUNK_PAYLOAD:
            raise WebPError(f"RIFF size {size}")
        if have_all_data and size > n - 8:
            raise _NotEnoughData("the RIFF size runs past the bytes")
        riff_size, pos = size, 12
    info = dict(flags=0, animation=False, has_alpha=False, riff_size=riff_size)
    if n - pos < 8:
        raise _NotEnoughData("no chunk header")
    vp8x = data[pos:pos + 4] == b"VP8X"
    if vp8x:
        if _le32(data, pos + 4) != 10:
            raise WebPError("VP8X size")
        if n - pos < 18:
            raise _NotEnoughData("short VP8X")
        flags = _le32(data, pos + 8)
        w, h = 1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15)
        if w * h >= 1 << 32:
            raise WebPError("VP8X canvas too large")
        pos += 18
        if not riff_size:
            raise WebPError("VP8X without RIFF")
        info.update(flags=flags, animation=bool(flags & VP8X_ANIMATION),
                    has_alpha=bool(flags & VP8X_ALPHA), width=w, height=h)
        if info["animation"] and features:
            return info
    try:
        if n - pos < 4:
            raise _NotEnoughData("no image chunk")
        if (riff_size and vp8x) or (not riff_size and not vp8x
                                   and data[pos:pos + 4] == b"ALPH"):
            # ParseOptionalChunks: skip to the VP8/VP8L chunk
            total = 4 + 8 + 10
            while True:
                if n - pos < 8:
                    raise _NotEnoughData("no image chunk")
                size = _le32(data, pos + 4)
                if size > _MAX_CHUNK_PAYLOAD:
                    raise WebPError("chunk size")
                disk = (8 + size + 1) & ~1
                total += disk
                if riff_size and total > riff_size:
                    raise WebPError("a chunk runs past the RIFF size")
                if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                    break
                if n - pos < disk:
                    raise _NotEnoughData("a chunk runs past the bytes")
                if data[pos:pos + 4] == b"ALPH":   # the last one counts
                    info.update(has_alpha=True, alpha=(pos + 8, size))
                pos += disk
        # ParseVP8Header
        if n - pos < 8:
            raise _NotEnoughData("no image chunk header")
        tag = data[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            size = _le32(data, pos + 4)
            if riff_size >= 12 and size > riff_size - 12:
                raise WebPError("the image chunk runs past the RIFF size")
            if have_all_data and size > n - pos - 8:
                raise _NotEnoughData("the image chunk runs past the bytes")
            lossless, chunk_size = tag == b"VP8L", size
            pos += 8
        else:   # a raw bitstream
            lossless = n - pos >= 5 and data[pos] == 0x2F and data[pos + 4] >> 5 == 0
            chunk_size = n - pos
        if chunk_size > _MAX_CHUNK_PAYLOAD:
            raise WebPError("chunk size")
        body = data[pos:]
        if lossless:
            if len(body) < 5:
                raise _NotEnoughData("short VP8L header")
            w, h, alpha = _vp8l_info(body)
            info["has_alpha"] |= alpha
        else:
            if len(body) < 10:
                raise _NotEnoughData("short VP8 header")
            w, h = _vp8_info(body, chunk_size)
    except _NotEnoughData:
        if vp8x and features:
            return info
        raise
    if vp8x and (w, h) != (info["width"], info["height"]):
        raise WebPError("the image size differs from the VP8X canvas")
    info.update(width=w, height=h, lossless=lossless, offset=pos)
    return info


def _chunks(data: bytes, pos: int, end: int):
    """(tag, payload start, payload size) of each whole chunk in
    data[pos:end], padding skipped; stops at a chunk the bytes cut."""
    while pos + 8 <= end:
        size = _le32(data, pos + 4)
        if pos + 8 + size > end:
            return
        yield data[pos:pos + 4], pos + 8, size
        pos += 8 + size + (size & 1)


def webp_header(data: bytes) -> dict:
    """What cv2 reads of a WebP before decoding it: width, height (of the
    canvas, before the EXIF orientation), kind ("lossy", "lossless" or
    "animated"), has_alpha and the EXIF orientation (1 when absent).
    Raises WebPError for bytes cv2 does not take as WebP, and for an image
    over OpenCV's size limits."""
    if len(data) < SIGNATURE_BYTES:
        raise WebPError(f"fewer than {SIGNATURE_BYTES} bytes")
    info = _parse_headers(data[:SIGNATURE_BYTES], have_all_data=False, features=True)
    too_big = size_refusal(info["width"], info["height"])
    if too_big:
        raise WebPError(too_big)
    if info["animation"]:
        kind = "animated"
    else:
        kind = "lossless" if _parse_headers(data, True)["lossless"] else "lossy"
    info.update(kind=kind, orientation=_orientation(data, info))
    return info


def _orientation(data: bytes, info: dict) -> int:
    """The orientation tag of the first "EXIF" chunk of a VP8X file whose
    EXIF flag is set (what libwebp's demuxer hands cv2), else 1."""
    if data[:4] != b"RIFF" or data[12:16] != b"VP8X" or not info["flags"] & VP8X_EXIF:
        return 1
    end = min(len(data), 8 + _le32(data, 4))
    for tag, start, size in _chunks(data, 30, end):
        if tag == b"EXIF":
            return parse_exif_orientation(data[start:start + size])
    return 1


# -- VP8L, lossless --------------------------------------------------------


def _windows_le(data: bytes) -> list:
    """w[i] = the 64 bits from byte i on, little-endian, as Python ints,
    zero past the end (bits there are read only to fail the decode)."""
    pad = np.zeros(len(data) + 16, np.uint8)
    pad[:len(data)] = np.frombuffer(data, np.uint8)
    w = np.zeros(len(data) + 8, np.uint64)
    for j in range(8):
        w |= pad[j:j + len(w)].astype(np.uint64) << np.uint64(8 * j)
    return w.tolist()


class _Bits:
    """VP8L's LSB-first bit reader over the bytes: `read(n)` for n <= 32;
    `p` may run past the end (zeros there), `check()` then fails."""

    __slots__ = ("w", "p", "end")

    def __init__(self, data: bytes, p: int = 0):
        self.w, self.p, self.end = _windows_le(data), p, 8 * len(data)

    def read(self, n: int) -> int:
        p = self.p
        if (p >> 3) >= len(self.w) - 1:
            raise WebPError("VP8L: read past the end")
        self.p = p + n
        return (self.w[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.p > self.end:
            raise WebPError("VP8L: the bitstream ends early")


def _reverse(code: int, length: int) -> int:
    return int(f"{code:0{length}b}"[::-1], 2) if length else 0


def _prefix_table(lengths) -> tuple[list, int]:
    """A prefix code from its code lengths, as huffman_utils.c
    BuildHuffmanTable takes them: (lookup by the next `bits` bits read, of
    (symbol << 4) | code length; bits). One used symbol is a code of 0
    bits; otherwise the code must be complete and not over-subscribed."""
    lengths = np.asarray(lengths, np.int64)
    used = np.flatnonzero(lengths)
    if len(used) == 0 or lengths.max() > 15:
        raise WebPError("VP8L: bad code lengths")
    if len(used) == 1:
        return [int(used[0]) << 4], 0
    counts = np.bincount(lengths[used], minlength=16)
    left = 1
    for n in counts[1:].tolist():
        left = 2 * left - n
        if left < 0:
            raise WebPError("VP8L: over-subscribed prefix code")
    if left:
        raise WebPError("VP8L: incomplete prefix code")
    bits = int(lengths.max())
    table = np.zeros(1 << bits, np.int64)
    order = used[np.lexsort((used, lengths[used]))]
    code = 0
    prev = 0
    for sym in order.tolist():
        n = int(lengths[sym])
        code <<= n - prev
        prev = n
        table[_reverse(code, n)::1 << n] = (sym << 4) | n
        code += 1
    return table.tolist(), bits


def _read_code(br: _Bits, alphabet: int) -> tuple[list, int]:
    """vp8l_dec.c ReadHuffmanCode: a simple or a normal prefix code."""
    lengths = [0] * alphabet
    if br.read(1):   # simple: one or two symbols of length 1
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        picked = [first] + ([br.read(8)] if n == 2 else [])
        for s in picked:
            if s < alphabet:
                lengths[s] = 1
    else:
        ccl = [0] * 19
        for i in range(br.read(4) + 4):
            ccl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        table, bits = _prefix_table(ccl)
        mask = (1 << bits) - 1
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise WebPError("VP8L: max_symbol past the alphabet")
        else:
            max_symbol = alphabet
        sym, prev = 0, 8
        while sym < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            e = table[(br.w[br.p >> 3] >> (br.p & 7)) & mask]
            br.p += e & 15
            code_len = e >> 4
            if code_len < 16:
                lengths[sym] = code_len
                sym += 1
                if code_len:
                    prev = code_len
            else:
                slot = code_len - 16
                repeat = br.read(_REPEAT_BITS[slot]) + _REPEAT_OFFSET[slot]
                if sym + repeat > alphabet:
                    raise WebPError("VP8L: code-length repeat past the alphabet")
                fill = prev if code_len == 16 else 0
                lengths[sym:sym + repeat] = [fill] * repeat
                sym += repeat
    br.check()
    return _prefix_table(lengths)


def _prefix_value(sym: int, br: _Bits) -> int:
    """GetCopyDistance / GetCopyLength: a length or distance prefix symbol
    and its extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _decode_stream(br: _Bits, xsize: int, ysize: int, level0: bool,
                   transforms: list | None = None) -> np.ndarray:
    """DecodeImageStream + DecodeImageData: (ysize, xsize) ARGB uint32 of an
    entropy-coded image. At level 0 the transforms are read first (into
    `transforms`, each with the width it applies at), and the image is the
    transformed one, of their last width."""
    if level0:
        seen = 0
        while br.read(1):
            kind = br.read(2)
            if seen & (1 << kind):
                raise WebPError("VP8L: a transform twice")
            seen |= 1 << kind
            t = dict(kind=kind, xsize=xsize)
            if kind in (0, 1):   # predictor, cross-colour: a sub-sampled image
                t["bits"] = br.read(3) + 2
                size = 1 << t["bits"]
                t["data"] = _decode_stream(br, -(-xsize // size), -(-ysize // size), False)
            elif kind == 3:      # colour indexing: a palette, bundled pixels
                n = br.read(8) + 1
                t["bits"] = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                pal = _decode_stream(br, n, 1, False).reshape(-1)
                raw = pal.view(np.uint8).reshape(n, 4)
                full = np.zeros((1 << (8 >> t["bits"]), 4), np.uint8)
                full[:n] = np.cumsum(raw, axis=0, dtype=np.uint8)   # ExpandColorMap
                t["data"] = full.view(np.uint32).reshape(-1)
                xsize = -(-xsize // (1 << t["bits"]))
            transforms.append(t)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise WebPError("VP8L: colour cache bits")
    meta, meta_bits = None, 0
    n_groups = 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        size = 1 << meta_bits
        meta = (_decode_stream(br, -(-xsize // size), -(-ysize // size), False)
                >> np.uint32(8)) & np.uint32(0xFFFF)
        n_groups = int(meta.max()) + 1
    br.check()
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, a + ((1 << cache_bits) if j == 0 and cache_bits else 0))
                       for j, a in enumerate(_ALPHABETS)])
    return _decode_pixels(br, xsize, ysize, groups, meta, meta_bits, cache_bits)


def _decode_pixels(br, width, height, groups, meta, meta_bits, cache_bits) -> np.ndarray:
    """DecodeImageData: literals, backward references and colour-cache hits,
    each read with the prefix-code group of its pixel's tile."""
    total = width * height
    out = [0] * total
    w, p = br.w, br.p
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cache_limit = 280 + (1 << cache_bits if cache_bits else 0)
    meta_rows = meta.tolist() if meta is not None else None
    tile_mask = (1 << meta_bits) - 1 if meta is not None else -1
    limit = len(w) - 4
    pos = x = y = 0
    green = red = blue = alpha = dist = None
    while pos < total:
        if x & tile_mask == 0 or green is None:
            g = groups[meta_rows[y >> meta_bits][x >> meta_bits]] if meta_rows else groups[0]
            (green, gb), (red, rb), (blue, bb), (alpha, ab), (dist, db) = g
            gm, rm, bm, am, dm = ((1 << b) - 1 for b in (gb, rb, bb, ab, db))
        if p >> 3 >= limit:
            raise WebPError("VP8L: the bitstream ends early")
        e = green[(w[p >> 3] >> (p & 7)) & gm]
        p += e & 15
        code = e >> 4
        if code < 256:
            e = red[(w[p >> 3] >> (p & 7)) & rm]
            p += e & 15
            r = e >> 4
            e = blue[(w[p >> 3] >> (p & 7)) & bm]
            p += e & 15
            b = e >> 4
            e = alpha[(w[p >> 3] >> (p & 7)) & am]
            p += e & 15
            argb = ((e >> 4) << 24) | (r << 16) | (code << 8) | b
            out[pos] = argb
            if cache is not None:
                cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
            pos += 1
            x += 1
            if x == width:
                x, y = 0, y + 1
        elif code < 280:
            br.p = p
            length = _prefix_value(code - 256, br)
            e = dist[(w[br.p >> 3] >> (br.p & 7)) & dm]
            br.p += e & 15
            dcode = _prefix_value(e >> 4, br)
            p = br.p
            if dcode > 120:
                d = dcode - 120
            else:
                plane = _CODE_TO_PLANE[dcode - 1]
                d = max(1, (plane >> 4) * width + 8 - (plane & 15))
            if d > pos or length > total - pos:
                raise WebPError("VP8L: a backward reference out of the image")
            if d >= length:
                out[pos:pos + length] = out[pos - d:pos - d + length]
            else:
                for i in range(pos, pos + length):
                    out[i] = out[i - d]
            if cache is not None:
                for argb in out[pos:pos + length]:
                    cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
            pos += length
            x += length
            while x >= width:
                x -= width
                y += 1
            green = None   # the tile may have changed
        elif code < cache_limit:
            argb = cache[code - 280]
            out[pos] = argb
            cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
            pos += 1
            x += 1
            if x == width:
                x, y = 0, y + 1
        else:
            raise WebPError("VP8L: a symbol past the alphabet")
    br.p = p
    br.check()
    return np.array(out, np.uint32).reshape(height, width)


def _add_pixels(a, b):
    """VP8LAddPixels: per-byte sums mod 256 of packed ARGB (Python ints or
    int64 arrays)."""
    ag = (a & 0xFF00FF00) + (b & 0xFF00FF00)
    rb = (a & 0x00FF00FF) + (b & 0x00FF00FF)
    return (ag & 0xFF00FF00) | (rb & 0x00FF00FF)


def _average2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(v: int) -> tuple:
    return (v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255)


def _pack(c) -> int:
    return (c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3]


def _predict(mode: int, left: int, top: int, tl: int, tr: int) -> int:
    """VP8LPredictors[mode] on packed ARGB Python ints (modes 14 and 15
    are mode 0)."""
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _average2(_average2(left, tr), top)
    if mode == 6:
        return _average2(left, tl)
    if mode == 7:
        return _average2(left, top)
    if mode == 8:
        return _average2(tl, top)
    if mode == 9:
        return _average2(top, tr)
    if mode == 10:
        return _average2(_average2(left, tl), _average2(top, tr))
    if mode == 11:   # Select
        t, lf, c = _channels(top), _channels(left), _channels(tl)
        d = sum(abs(b - z) - abs(a - z) for a, b, z in zip(t, lf, c))
        return top if d <= 0 else left
    if mode == 12:   # ClampedAddSubtractFull
        return _pack([min(255, max(0, a + b - c)) for a, b, c in
                      zip(_channels(left), _channels(top), _channels(tl))])
    if mode == 13:   # ClampedAddSubtractHalf
        ave = _channels(_average2(left, top))
        return _pack([min(255, max(0, a + int((a - c) / 2))) for a, c in
                      zip(ave, _channels(tl))])
    return 0xFF000000


_LEFT_FREE = {0, 2, 3, 4, 8, 9, 14, 15}   # modes that do not read the left pixel


def _inverse_predictor(img: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    """PredictorInverseTransform: row 0 adds black then the left pixel,
    column 0 the top pixel, the rest each tile's mode. The top-right of the
    last column is the current row's first pixel."""
    h, w = img.shape
    out = np.empty_like(img)
    row = img[0].astype(np.int64).tolist()
    prev = 0xFF000000
    for x in range(w):
        prev = _add_pixels(row[x], prev)
        row[x] = prev
    out[0] = row
    mode_rows = ((modes >> np.uint32(8)) & np.uint32(15)).astype(np.int64)
    tile = 1 << bits
    col_mode = np.repeat(np.arange(mode_rows.shape[1]), tile)[:w]
    for y in range(1, h):
        m = mode_rows[y >> bits][col_mode]
        top = out[y - 1].astype(np.int64)
        cur = img[y].astype(np.int64)
        first = int(_add_pixels(cur[0], top[0]))   # column 0: the top pixel
        # the modes that do not read the left pixel, at once; the last
        # column's top-right is this row's first pixel
        tr = np.append(top[1:], first)
        tl = np.append(top[:1], top[:-1])
        pred = np.full(w, 0xFF000000, np.int64)
        for mode, value in ((2, top), (3, tr), (4, tl), (8, _average2(tl, top)),
                            (9, _average2(top, tr))):
            sel = m == mode
            pred[sel] = value[sel]
        pred[0] = top[0]
        free = np.isin(m, list(_LEFT_FREE))
        free[0] = True
        res = np.zeros(w, np.int64)
        res[free] = _add_pixels(cur[free], pred[free])
        if not free.all():
            r = res.tolist()
            tops, cs, ms = top.tolist(), cur.tolist(), m.tolist()
            tops.append(first)   # the last column's top-right
            for x in np.flatnonzero(~free).tolist():
                mode, left = ms[x], r[x - 1]
                # the averaging modes inline (_average2), the rest by _predict
                if mode == 10:
                    a, b = left, tops[x - 1]
                    a = (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)
                    b, t = tops[x], tops[x + 1]
                    b = (((b ^ t) & 0xFEFEFEFE) >> 1) + (b & t)
                    pr = (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)
                elif mode == 1:
                    pr = left
                elif mode == 7:
                    t = tops[x]
                    pr = (((left ^ t) & 0xFEFEFEFE) >> 1) + (left & t)
                elif mode == 6:
                    t = tops[x - 1]
                    pr = (((left ^ t) & 0xFEFEFEFE) >> 1) + (left & t)
                else:
                    pr = _predict(mode, left, tops[x], tops[x - 1], tops[x + 1])
                a = cs[x]
                r[x] = ((((a & 0xFF00FF00) + (pr & 0xFF00FF00)) & 0xFF00FF00)
                        | (((a & 0x00FF00FF) + (pr & 0x00FF00FF)) & 0x00FF00FF))
            res = np.array(r, np.int64)
        out[y] = res
    return out


def _inverse_transforms(img: np.ndarray, transforms: list) -> np.ndarray:
    """The transforms undone in reverse order, each at the width it was
    applied at."""
    for t in reversed(transforms):
        kind = t["kind"]
        if kind == 0:
            img = _inverse_predictor(img, t["bits"], t["data"])
        elif kind == 1:   # cross-colour (TransformColorInverse)
            size = 1 << t["bits"]
            h, w = img.shape
            code = np.repeat(np.repeat(t["data"], size, 0), size, 1)[:h, :w]
            g2r = (code & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
            g2b = ((code >> np.uint32(8)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
            r2b = ((code >> np.uint32(16)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
            green = ((img >> np.uint32(8)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
            red = ((img >> np.uint32(16)) & 0xFF).astype(np.int32)
            blue = (img & 0xFF).astype(np.int32)
            red = (red + ((g2r * green) >> 5)) & 0xFF
            red8 = red.astype(np.uint8).view(np.int8).astype(np.int32)
            blue = (blue + ((g2b * green) >> 5) + ((r2b * red8) >> 5)) & 0xFF
            img = (img & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << np.uint32(16)) \
                | blue.astype(np.uint32)
        elif kind == 2:   # subtract green
            green = (img >> np.uint32(8)) & np.uint32(0xFF)
            rb = ((img & np.uint32(0x00FF00FF)) + ((green << np.uint32(16)) | green)) \
                & np.uint32(0x00FF00FF)
            img = (img & np.uint32(0xFF00FF00)) | rb
        else:             # colour indexing, bundled pixels unpacked
            bits, w = t["bits"], t["xsize"]
            index = (img >> np.uint32(8)) & np.uint32(0xFF)
            if bits:
                per = 1 << bits
                bpp = 8 >> bits
                shifts = (np.arange(per, dtype=np.uint32) * bpp)
                index = ((index[:, :, None] >> shifts) & np.uint32((1 << bpp) - 1))
                index = index.reshape(img.shape[0], -1)[:, :w]
            img = t["data"][index]
    return img


def _decode_vp8l(payload: bytes) -> np.ndarray:
    """A VP8L bitstream -> (H, W, 3) uint8 RGB (alpha dropped)."""
    width, height, _ = _vp8l_info(payload)
    too_big = size_refusal(width, height)
    if too_big:
        raise WebPError(too_big)
    br = _Bits(payload, 40)
    transforms: list = []
    img = _decode_stream(br, width, height, True, transforms)
    argb = _inverse_transforms(img, transforms).astype(np.uint32)
    rgb = np.stack([(argb >> np.uint32(16)) & 0xFF, (argb >> np.uint32(8)) & 0xFF,
                    argb & 0xFF], -1)
    return rgb.astype(np.uint8)


# -- VP8, lossy: headers, modes and tokens ---------------------------------


def _vp8_parse(data: bytes, start: int) -> dict:
    """VP8GetHeaders, then every macroblock's modes (partition 0) and
    tokens (the token partitions) row by row, as ParseFrame reads them.
    Raises WebPError where libwebp fails, a read past a used partition's
    bytes included."""
    size = len(data) - start
    if size < 4:
        raise WebPError("VP8: truncated header")
    tag = _le24(data, start)
    part0 = tag >> 5
    if tag & 1 or (tag >> 1) & 7 > 3 or not (tag >> 4) & 1:
        raise WebPError("VP8: not a shown key frame")
    pos, size = start + 3, size - 3
    if size < 7 or data[pos:pos + 3] != b"\x9d\x01\x2a":
        raise WebPError("VP8: bad start code")
    width, height = _le16(data, pos + 3) & 0x3FFF, _le16(data, pos + 5) & 0x3FFF
    pos, size = pos + 7, size - 7
    if part0 > size:
        raise WebPError("VP8: bad partition length")
    br = _BoolReader(data, pos, part0)
    pos, size = pos + part0, size - part0
    br.bit(0x80)   # colour space
    br.bit(0x80)   # clamping type
    # segment header
    use_segment = update_map = False
    absolute, seg_q, seg_f, seg_probs = True, [0] * 4, [0] * 4, [255] * 3
    if br.bit(0x80):
        use_segment = True
        update_map = bool(br.bit(0x80))
        if br.bit(0x80):
            absolute = bool(br.bit(0x80))
            seg_q = [br.signed_value(7) if br.bit(0x80) else 0 for _ in range(4)]
            seg_f = [br.signed_value(6) if br.bit(0x80) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.value_bits(8) if br.bit(0x80) else 255 for _ in range(3)]
    # filter header
    simple = br.bit(0x80)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_lf_delta = br.bit(0x80)
    if use_lf_delta and br.bit(0x80):
        for deltas in (ref_delta, mode_delta):
            for i in range(4):
                if br.bit(0x80):
                    deltas[i] = br.signed_value(6)
    if br.eof:
        raise WebPError("VP8: cannot parse the headers")
    # token partitions
    n_parts = 1 << br.value_bits(2)
    if size < 3 * (n_parts - 1):
        raise WebPError("VP8: cannot read the partition sizes")
    part_start = pos + 3 * (n_parts - 1)
    left, end = size - 3 * (n_parts - 1), pos + size
    parts = []
    for p in range(n_parts - 1):
        psize = min(_le24(data, pos + 3 * p), left)
        parts.append(_BoolReader(data, part_start, psize))
        part_start += psize
        left -= psize
    parts.append(_BoolReader(data, part_start, left))
    if part_start >= end:
        raise WebPError("VP8: the last partition is empty")
    # quantizers (VP8ParseQuant)
    base_q = br.value_bits(7)
    dq = [br.signed_value(4) if br.bit(0x80) else 0 for _ in range(5)]
    quant = [_quantizers((seg_q[s] + (0 if absolute else base_q)) if use_segment else base_q, dq)
             for s in range(4)]
    br.bit(0x80)   # update_proba, ignored
    # VP8ParseProba
    proba = _COEFFS_PROBA0.astype(np.int64).copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(_COEFFS_UPDATE_PROBA[t, b, c, p])):
                        proba[t, b, c, p] = br.value_bits(8)
    bands = _token_bands(proba)
    skip_p = br.value_bits(8) if br.bit(0x80) else None
    # filter strengths (PrecomputeFilterStrengths)
    filter_type = 0 if level == 0 else 1 if simple else 2
    strengths = []
    for s in range(4):
        base = level
        if use_segment:
            base = seg_f[s] + (0 if absolute else level)
        row = []
        for i4x4 in (0, 1):
            lvl = base + (ref_delta[0] + (mode_delta[0] if i4x4 else 0) if use_lf_delta else 0)
            lvl = max(0, min(63, lvl))
            if lvl > 0:
                ilevel = lvl
                if sharpness > 0:
                    ilevel >>= 2 if sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * lvl + ilevel, ilevel, 2 if lvl >= 40 else 1 if lvl >= 15 else 0))
            else:
                row.append((0, 0, 0))
        strengths.append(row)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    n_mb = mb_w * mb_h
    coeffs = [0] * (n_mb * 384)
    mbs = []
    intra_t = [0] * (4 * mb_w)
    nz_top = [[0, 0] for _ in range(mb_w)]   # per column: 4 luma + 2 u + 2 v bits, the Y2 bit
    for mb_y in range(mb_h):
        # ParseIntraModeRow
        intra_l = [0] * 4
        row = []
        for mb_x in range(mb_w):
            segment = 0
            if update_map:
                segment = (2 + br.bit(seg_probs[2])) if br.bit(seg_probs[0]) else br.bit(seg_probs[1])
            skip = br.bit(skip_p) if skip_p is not None else 0
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            i4x4, modes = _key_intra_modes(br, top, intra_l)
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            uvmode = _uv_mode(br, _KEY_UVMODE_PROBA)
            row.append(dict(segment=segment, skip=skip, i4x4=i4x4, modes=modes, uvmode=uvmode))
        if br.eof:
            raise WebPError("VP8: premature end of partition 0")
        # the tokens of the row
        tbr = parts[mb_y & (n_parts - 1)]
        nz_left = [0, 0]
        for mb_x, mb in enumerate(row):
            skip = mb["skip"]
            if not skip:
                non_zero, _ = _mb_coeffs(tbr, coeffs, (mb_y * mb_w + mb_x) * 384, bands,
                                         quant[mb["segment"]], not mb["i4x4"], nz_top[mb_x],
                                         nz_left)
                skip = not non_zero
            else:
                nz_top[mb_x][0] = nz_left[0] = 0
                if not mb["i4x4"]:
                    nz_top[mb_x][1] = nz_left[1] = 0
            if tbr.eof:
                raise WebPError("VP8: premature end of file")
            limit, ilevel, hev = strengths[mb["segment"]][int(mb["i4x4"])]
            mb["filter"] = (limit, ilevel, hev, bool(mb["i4x4"]) or not skip)
            mbs.append(mb)
    return dict(width=width, height=height, mb_w=mb_w, mb_h=mb_h, mbs=mbs, partitions=n_parts,
                coeffs=np.array(coeffs, np.int32).reshape(n_mb, 24, 16),
                filter_type=filter_type)


# -- VP8, lossy: output ----------------------------------------------------


def _upsample(c: np.ndarray, height: int, width: int) -> np.ndarray:
    """UpsampleRgbLinePair's chroma, for one plane, at full size: rows in
    pairs (2k+1, 2k+2) from chroma rows k and k+1, the first row (and the
    last of an even height) from one chroma row; columns likewise, with
    its diag_12 / diag_03 rounding."""
    c = c.astype(np.int32)
    uh, uw = (height + 1) // 2, (width + 1) // 2
    c = c[:uh, :uw]
    out = np.empty((height, width), np.int32)

    def line_pair(top, cur):
        """(top output row, bottom output row) from chroma rows top, cur."""
        n = top.shape[0]
        t_row = np.empty((n, width), np.int32)
        b_row = np.empty((n, width), np.int32)
        t_row[:, 0] = (3 * top[:, 0] + cur[:, 0] + 2) >> 2
        b_row[:, 0] = (3 * cur[:, 0] + top[:, 0] + 2) >> 2
        last = (width - 1) >> 1
        if last:
            tl, t = top[:, :last], top[:, 1:last + 1]
            lf, u = cur[:, :last], cur[:, 1:last + 1]
            avg = tl + t + lf + u + 8
            d12 = (avg + 2 * (t + lf)) >> 3
            d03 = (avg + 2 * (tl + u)) >> 3
            t_row[:, 1:2 * last:2] = (d12 + tl) >> 1
            t_row[:, 2:2 * last + 1:2] = (d03 + t) >> 1
            b_row[:, 1:2 * last:2] = (d03 + lf) >> 1
            b_row[:, 2:2 * last + 1:2] = (d12 + u) >> 1
        if not width & 1:
            tl, lf = top[:, last], cur[:, last]
            t_row[:, width - 1] = (3 * tl + lf + 2) >> 2
            b_row[:, width - 1] = (3 * lf + tl + 2) >> 2
        return t_row, b_row

    out[0] = line_pair(c[:1], c[:1])[0][0]
    n_pairs = (height - 1) // 2
    if n_pairs:
        t_rows, b_rows = line_pair(c[:n_pairs], c[1:n_pairs + 1])
        out[1:2 * n_pairs:2] = t_rows
        out[2:2 * n_pairs + 1:2] = b_rows
    if not height & 1:
        out[height - 1] = line_pair(c[uh - 1:uh], c[uh - 1:uh])[0][0]
    return out


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """yuv.h VP8YUVToR/G/B: 14-bit MultHi, 6-bit fixed point, clipped."""
    def mult_hi(a, k):
        return (a * k) >> 8

    def clip8(a):
        return np.where((a & ~16383) == 0, a >> 6, np.where(a < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _decode_vp8(data: bytes, start: int) -> np.ndarray:
    """A VP8 key frame from data[start:] on -> (H, W, 3) uint8 RGB."""
    fr = _vp8_parse(data, start)
    too_big = size_refusal(fr["width"], fr["height"])
    if too_big:
        raise WebPError(too_big)
    planes = _loop_filter(fr, _reconstruct(fr))
    h, w = fr["height"], fr["width"]
    y = planes[0][:h, :w]
    u = _upsample(planes[1], h, w)
    v = _upsample(planes[2], h, w)
    return _yuv_to_rgb(y, u, v)


# -- the whole file --------------------------------------------------------


def _check_alpha(data: bytes, alpha: tuple, width: int, height: int) -> None:
    """alpha_dec.c ALPHInit and the alpha plane's decode, for their
    failures alone: libwebp decodes a VP8 image's ALPH chunk whatever the
    output (a bad one fails the decode, in BGR too), and cv2's IMREAD_COLOR
    then drops the plane. Header byte: method (0 raw, 1 VP8L stream),
    filter, pre-processing (0 or 1), two reserved bits (0)."""
    start, size = alpha
    if size < 1:
        raise WebPError("ALPH: empty")
    head = data[start]
    method, pre, reserved = head & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or reserved:
        raise WebPError("ALPH: bad header")
    if method == 0:
        if size - 1 < width * height:
            raise WebPError("ALPH: short raw plane")
        return
    _decode_stream(_Bits(data[start + 1:start + size]), width, height, True, [])


def _decode_bitstream(data: bytes, head: dict) -> np.ndarray:
    """The image of a header parse: VP8L from its bitstream on; VP8 from
    its frame on, its ALPH chunk (if any) decoded and dropped."""
    start = head["offset"]
    if head["lossless"]:
        return _decode_vp8l(data[start:])
    rgb = _decode_vp8(data, start)
    if "alpha" in head:
        _check_alpha(data, head["alpha"], rgb.shape[1], rgb.shape[0])
    return rgb


def _first_frame(data: bytes, info: dict) -> np.ndarray:
    """WebPAnimDecoder's first frame of an animated file: its bitstream
    ("ALPH" and "VP8 " or "VP8L" inside the first "ANMF") decoded onto a
    zero canvas at the frame's offset, as WebPDemux validates the file."""
    if info["flags"] & ~_VP8X_VALID:
        raise WebPError("VP8X flags outside the format")
    cw, ch = info["width"], info["height"]
    end = 8 + _le32(data, 4)
    anim = False
    for tag, start, size in _chunks(data, 30, end):
        if tag == b"ANIM":
            if size < 6:
                raise WebPError("short ANIM")
            anim = True
        elif tag == b"ANMF":
            if not anim or size < 16:
                raise WebPError("ANMF without ANIM, or short")
            x, y = 2 * _le24(data, start), 2 * _le24(data, start + 3)
            subs = list(_chunks(data, start + 16, start + size))
            image = [i for i, (t, _, _) in enumerate(subs) if t in (b"VP8 ", b"VP8L")]
            if not image:
                raise WebPError("a frame without an image chunk")
            first = subs[0] if subs[0][0] == b"ALPH" and image[0] > 0 else subs[image[0]]
            frag_end = subs[image[0]][1] + subs[image[0]][2]
            frag = data[first[1] - 8:frag_end]
            head = _parse_headers(frag, True)
            fw, fh = head["width"], head["height"]
            if x + fw > cw or y + fh > ch:
                raise WebPError("a frame outside the canvas")
            canvas = np.zeros((ch, cw, 3), np.uint8)
            canvas[y:y + fh, x:x + fw] = _decode_bitstream(frag, head)
            return canvas
    raise WebPError("an animation without frames")


def decode_webp(data: bytes) -> tuple[np.ndarray, int]:
    """WebP bytes -> ((H, W, 3) uint8 RGB in stored order, the EXIF
    orientation): cv2.imdecode(IMREAD_COLOR) + BGR2RGB before cv2 applies
    the orientation. Raises WebPError where cv2 gives None (or raises, for
    an image over its size limits)."""
    info = webp_header(data)
    if info["animation"]:
        rgb = _first_frame(data, info)
    else:
        head = _parse_headers(data, True)
        rgb = _decode_bitstream(data, head)
        if rgb.shape[:2] != (info["height"], info["width"]):
            raise WebPError("the bitstream's size differs from the header's")
    return rgb, info["orientation"]
