"""TIFF decode without OpenCV: cv2.imdecode(IMREAD_COLOR) + BGR2RGB of a
TIFF's first page, bit for bit, in numpy and the standard library.

The reference is OpenCV 5's grfmt_tiff.cpp over its built-in libtiff 4.7.1,
as cv2 runs them. For an 8-bit result (IMREAD_COLOR without ANYDEPTH)
OpenCV reads every strip or tile through libtiff's TIFFReadRGBAStrip /
TIFFReadRGBATile (tif_getimage.c), so libtiff's own colour rules decide
the pixels:

- The file: "II" or "MM", version 42 or BigTIFF's 43; the first IFD.
  OpenCV's readHeader takes 1 to 4 samples a pixel and bits a sample of
  1, 8, 10, 12, 14, 16, 32 or 64 (4 only with a palette); libtiff's
  TIFFRGBAImageOK then refuses all but 1, 2, 4, 8 and 16, IEEE floats
  (a float32 TIFF gives None), and the photometric interpretations it
  has no conversion for. Compressions: none (1), CCITT Group 4 (4), LZW
  (5), JPEG (7), Deflate (8 and 32946), PackBits (32773); LZMA, ZSTD and
  every other codec give None (this libtiff has neither LZMA nor ZSTD).
  A FillOrder of 2 reverses each byte's bits before decoding. Predictor 2
  (horizontal differencing of 8- and 16-bit samples) follows LZW and
  Deflate; libtiff ignores it under no compression and PackBits.
- Strips and tiles, PlanarConfig 1 and 2 (a single sample is always read
  as contiguous). Each strip or tile decodes into a zeroed buffer of the
  rows it holds; a codec that fails part way (data that ends early or is
  corrupt) leaves what it decoded before the failure and zeros after it,
  without undoing the predictor, and the image goes on (TIFFReadRGBA*
  runs with stop_on_error 0). A strip or tile that lies past the end of
  the bytes refuses the file, as do tiles that fail libtiff's byte count
  checks on the read that allocates its buffer (a contiguous tile, or a
  tile's first plane): its raw buffer (the largest count read so far,
  rounded up to 1024) must equal an uncompressed tile's size, and hold at
  least a thousandth of a compressed one whose read allocates over 10^8
  bytes. A count over 1 MiB is cut to ten times the strip's or tile's
  size plus 4096. libtiff repairs the byte counts of contiguous
  uncompressed pages: a single strip's count that is missing, zero, past
  the end of the bytes or short becomes the image's size, and where more
  than two strips' or tiles' first two counts differ, every count becomes
  the scanline times height // strips, or the tile's size.
- OpenCV refuses a tile, or a strip as wide as the image and RowsPerStrip
  tall, over 1 << 24 on a side or of 1 GiB or more as RGBA words, and a
  RowsPerStrip of 0.
- Colour (tif_getimage.c): grey (MinIsBlack, MinIsWhite inverted) of 1, 2,
  4, 8 bits scaled by x * 255 / (2^bits - 1) and of 16 bits by its high
  byte; RGB of 8 bits as it is and of 16 bits as (v + 128) // 257; an
  unassociated alpha (ExtraSamples 2) premultiplies RGB ((v x a + 127) //
  255); any other extra sample is dropped; a palette of 1, 2, 4 or 8
  bits, its 16-bit map taken by the high byte unless every entry is below
  256; CMYK (InkSet 1, 8 bits) as (255 - k) x (255 - c) // 255; YCbCr
  under JPEG through libjpeg's own conversion to RGB (the strip's stream
  after the JPEGTables, decoded by decode.py). A JPEG in any other
  photometric is taken as its raw components.
- Orientation (tag 274): libtiff mirrors each strip or tile that a
  mirrored orientation (2, 3, 6, 7) asks for, in its place; OpenCV turns
  and flips the rest. For strips that is the EXIF orientation applied to
  the stored image (decode.apply_orientation); tiles are mirrored one by
  one first.
- libtiff's put functions for grey of 16 bits or with extra samples, and
  for an 8-bit palette with extra samples, skip the part of a right-edge
  tile past the image by bytes, not pixels: from its second row on such a
  tile is read from the wrong place, and so it is here (_skewed).

Left out, where cv2 takes them: libtiff's own YCbCr conversion of an
uncompressed or non-JPEG YCbCr file, CIE L*a*b*, CCITT RLE and Group 3,
old-style JPEG (6), old-style LZW and the other codecs libtiff carries
(NeXT, ThunderScan, PixarLog, SGILog); each gives None here.
"""

from __future__ import annotations

import array
import struct
import zlib

import numpy as np

from vision_kit_tpu_torch.data.decode import size_refusal


class TiffError(ValueError):
    """Bytes that cv2 does not decode as TIFF; decode_image answers None."""


SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
NONE, CCITT4, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 4, 5, 7, 8, 32946, 32773
CODECS = (NONE, CCITT4, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS)
MINISWHITE, MINISBLACK, RGB, PALETTE, SEPARATED, YCBCR = 0, 1, 2, 3, 5, 6

_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 17: "q", 13: "I", 18: "Q"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
          13: 4, 16: 8, 17: 8, 18: 8}


def is_tiff(data: bytes) -> bool:
    """TiffDecoder's signature (classic and BigTIFF)."""
    return data[:4] in SIGNATURES


def _ifd(data: bytes) -> tuple[dict, str]:
    """The first IFD's tags as {tag: tuple of values} (integers, or bytes for
    ASCII and UNDEFINED), and the byte order."""
    end = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    try:
        if big:
            if struct.unpack(end + "HH", data[4:8]) != (8, 0):
                raise TiffError("BigTIFF header")
            pos = struct.unpack(end + "Q", data[8:16])[0]
            (n,) = struct.unpack(end + "Q", data[pos:pos + 8])
            pos += 8
            esize, head = 20, end + "HHQ"
        else:
            pos = struct.unpack(end + "I", data[4:8])[0]
            (n,) = struct.unpack(end + "H", data[pos:pos + 2])
            pos += 2
            esize, head = 12, end + "HHI"
    except struct.error:
        raise TiffError("TIFF: no first IFD") from None
    inline = 8 if big else 4
    tags = {}
    for i in range(n):
        e = pos + esize * i
        if e + esize > len(data):
            raise TiffError("TIFF: the IFD ends early")
        tag, typ, count = struct.unpack(head, data[e:e + esize - inline])
        size = _SIZES.get(typ)
        if size is None:
            continue
        nbytes = size * count
        if nbytes <= inline:
            raw = data[e + esize - inline:e + esize - inline + nbytes]
        else:
            off = struct.unpack(end + ("Q" if big else "I"), data[e + esize - inline:e + esize])[0]
            if off + nbytes > len(data):
                continue                       # libtiff drops the tag
            raw = data[off:off + nbytes]
        if typ in (2, 7):
            tags[tag] = raw
        elif typ in _TYPES:
            tags[tag] = struct.unpack(end + _TYPES[typ] * count, raw)
    return tags, end


def _one(tags: dict, tag: int, default=None):
    v = tags.get(tag)
    return default if not v else v[0]


def tiff_header(data: bytes) -> dict:
    """The first page's geometry and fields, checked as OpenCV's
    readHeader and libtiff's TIFFRGBAImageOK / TIFFRGBAImageBegin check
    them for an 8-bit read; raises TiffError for what cv2 refuses."""
    if not is_tiff(data):
        raise TiffError("not a TIFF file")
    tags, end = _ifd(data)
    width, height = _one(tags, 256, 0), _one(tags, 257, 0)
    if width <= 0 or height <= 0:
        raise TiffError(f"TIFF of {width}x{height}")
    bits_all = tags.get(258) or (1,)
    bits = bits_all[0]
    if any(b != bits for b in bits_all):
        raise TiffError("TIFF: different bits per sample")
    spp = _one(tags, 277, 1)
    fmt = _one(tags, 339, 1)
    photometric = _one(tags, 262)
    compression = _one(tags, 259, NONE)
    planar = _one(tags, 284, 1)
    extra = tags.get(338) or ()
    if photometric is None:                # OpenCV's readHeader requires the tag
        raise TiffError("TIFF: no photometric interpretation")
    if any(e > 2 for e in extra):
        raise TiffError("TIFF: an ExtraSamples value past 2")
    if photometric == PALETTE and 320 not in tags:
        # TIFFReadDirectory: a palette image without a colour map is read
        # as RGB (3 samples) or grey from 8 bits on, and refused below
        if bits < 8:
            raise TiffError("TIFF: a palette image without its colour map")
        photometric = RGB if spp == 3 else MINISBLACK
    # OpenCV's readHeader
    if not 1 <= spp <= 4:
        raise TiffError(f"TIFF: {spp} samples a pixel")
    if bits == 4 and photometric != PALETTE:
        raise TiffError("TIFF: 4 bits a sample without a palette")
    if bits in (1, 4, 8, 10, 12, 14, 16):
        ok_fmt = fmt in (1, 2)
    elif bits == 32:
        ok_fmt = fmt in (2, 3)
    elif bits == 64:
        ok_fmt = fmt == 3
    else:
        raise TiffError(f"TIFF: {bits} bits a sample")
    if not ok_fmt:
        raise TiffError(f"TIFF: sample format {fmt} at {bits} bits")
    # libtiff's TIFFRGBAImageOK and TIFFRGBAImageBegin
    if compression not in CODECS:
        raise TiffError(f"TIFF: compression {compression} (not decoded here)")
    if bits not in (1, 2, 4, 8, 16) or fmt == 3:
        raise TiffError(f"TIFF: libtiff's RGBA read takes no {bits}-bit samples")
    colour = spp - len(extra)
    ycbcr_jpeg = photometric == YCBCR
    contig = planar == 1 or spp == 1
    alpha = 0
    if extra:
        if extra[0] == 0 and spp > 3:
            alpha = 1
        elif extra[0] in (1, 2):
            alpha = extra[0]
    elif spp == 4 and photometric == RGB:
        alpha, colour = 1, 3
    if photometric in (MINISWHITE, MINISBLACK, PALETTE):
        if contig and spp != 1 and bits < 8:
            raise TiffError("TIFF: packed samples with extra channels")
    if photometric == YCBCR:
        if not (compression == JPEG and contig):
            raise TiffError("TIFF: YCbCr outside JPEG (not decoded here)")
        photometric = RGB            # libjpeg converts it (JPEGCOLORMODE_RGB)
    if photometric == RGB:
        if colour < 3 or bits not in (8, 16):
            raise TiffError(f"TIFF: RGB with {colour} colour channels at {bits} bits")
    elif photometric == PALETTE:
        cmap = tags.get(320)
        if bits == 16 or cmap is None or len(cmap) != 3 << bits or not contig:
            raise TiffError("TIFF: palette layout libtiff does not read")
    elif photometric == SEPARATED:
        if _one(tags, 332, 1) != 1 or spp < 4 or bits != 8 or (not contig and spp != 4):
            raise TiffError("TIFF: a separated image other than 8-bit CMYK")
    elif photometric not in (MINISWHITE, MINISBLACK):
        raise TiffError(f"TIFF: photometric {photometric} (not decoded here)")
    elif not contig and bits not in (8, 16):
        raise TiffError("TIFF: separate grey planes below 8 bits")
    if compression == CCITT4 and (bits != 1 or spp != 1):
        raise TiffError("TIFF: Group 4 of more than one bit")
    predictor = _one(tags, 317, 1)
    if compression in (LZW, DEFLATE, ADOBE_DEFLATE):
        if predictor == 2 and bits not in (8, 16):
            raise TiffError(f"TIFF: horizontal differencing of {bits}-bit samples")
        if predictor not in (1, 2):
            raise TiffError(f"TIFF: predictor {predictor}")
    else:
        predictor = 1
    tiled = 322 in tags
    if tiled:
        tw, th = _one(tags, 322, 0), _one(tags, 323, 0)
        offsets, counts = tags.get(324), tags.get(325)
        if tw <= 0 or th <= 0 or tw % 16 or th % 16:
            raise TiffError("TIFF: tile size")
        tall = th
    else:
        rps = _one(tags, 278, height)
        if rps == 0:
            raise TiffError("TIFF: zero rows a strip")
        tall = height if rps == 0xFFFFFFFF else rps
        tw, th = width, min(tall, height)
        offsets, counts = tags.get(273), tags.get(279)
    # OpenCV's readData: a tile (a strip: the width by RowsPerStrip) over
    # 1 << 24 on a side, or of 1 GiB or more as the RGBA words that
    # TIFFReadRGBA* writes, is refused before any buffer is allocated
    if tw > 1 << 24 or tall > 1 << 24 or tw * tall * 4 >= 1 << 30:
        raise TiffError(f"TIFF: a {tw}x{tall} tile over OpenCV's tile limits")
    if not offsets:
        raise TiffError("TIFF: no strip or tile offsets")
    if compression == NONE and planar == 1:
        # TIFFReadDirectory's repairs of uncompressed byte counts
        # (EstimateStripByteCounts: a tile's size, or the scanline times
        # height // strips)
        scan = (width * spp * bits + 7) // 8
        if tiled:
            n, each = -(-height // th) * -(-width // tw), th * ((tw * spp * bits + 7) // 8)
        else:
            n = -(-height // th)
            each = scan * (height // n)
        if not tiled and n == 1 and (not counts or (counts[0] == 0 and offsets[0] != 0)
                                     or (offsets[0] <= len(data)
                                         and counts[0] > len(data) - offsets[0])
                                     or counts[0] < scan * height):
            counts = (scan * height,)                  # a missing or "bogus" count
        elif (n > 2 and counts and len(counts) > 1 and counts[0] != counts[1]
              and counts[0] and counts[1]):
            counts = (each,) * len(counts)             # "wrong" counts
    return dict(width=width, height=height, bits=bits, spp=spp, photometric=photometric,
                compression=compression, contig=contig, alpha=alpha, predictor=predictor,
                tiled=tiled, tile=(th, tw), offsets=offsets,
                counts=counts, order=end, fill=_one(tags, 266, 1), cmap=tags.get(320),
                jpeg_tables=tags.get(347), ycbcr_jpeg=ycbcr_jpeg,
                orientation=_one(tags, 274, 1))


# -- codecs ------------------------------------------------------------------

_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _lzw(raw: bytes, occ: int) -> tuple[bytes, bool]:
    """libtiff's LZWDecode: MSB-first codes, 9 to 12 bits with the early
    change, clear 256 and end 257. (output, ok): on a corrupt code or data
    that ends before `occ` bytes the output decoded so far and False."""
    if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
        raise TiffError("TIFF: old-style LZW (not decoded here)")
    # the big-endian 32-bit word at every byte: a code of up to 12 bits
    # at bit p is (words[p >> 3] >> (32 - (p & 7) - nbits)) & mask
    padded = np.frombuffer(raw + b"\0\0\0\0", np.uint8).astype(np.uint32)
    words = array.array("I", ((padded[:-3] << 24) | (padded[1:-2] << 16)
                              | (padded[2:-1] << 8) | padded[3:]).tobytes())
    end_bit = 8 * len(raw)
    roots = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(roots)
    append = table.append
    out = []
    push = out.append
    count = 0
    nbits, mask, grow = 9, 511, 511
    p = 0
    prev = False           # no table yet: the stream must open with a clear code
    while count < occ:
        if p + nbits > end_bit:
            return b"".join(out), False
        code = (words[p >> 3] >> (32 - (p & 7) - nbits)) & mask
        p += nbits
        if code == 256:
            table = list(roots)
            append = table.append
            nbits, mask, grow = 9, 511, 511
            prev = None
            continue
        if code == 257:
            break
        size = len(table)
        if prev is False:
            return b"".join(out), False
        if prev is None:
            if code > 256:
                return b"".join(out), False
            entry = table[code]
        elif code < size:
            entry = table[code]
            append(prev + entry[:1])
            size += 1
        elif code == size:
            entry = prev + prev[:1]
            append(entry)
            size += 1
        else:
            return b"".join(out), False
        if size >= grow:
            if size > 5119:                            # past libtiff's code table
                return b"".join(out), False
            if nbits < 12:
                nbits += 1
                mask = (1 << nbits) - 1
                grow = mask
        push(entry)
        count += len(entry)
        prev = entry
    data = b"".join(out)[:occ]
    return data, len(data) == occ


def _deflate(raw: bytes, occ: int) -> tuple[bytes, bool]:
    d = zlib.decompressobj()
    try:
        out = d.decompress(raw, occ)
        return out, len(out) == occ
    except zlib.error:
        pass
    d, out = zlib.decompressobj(), bytearray()   # the output before the error
    for i in range(len(raw)):
        try:
            out += d.decompress(raw[i:i + 1], occ - len(out))
        except zlib.error:
            break
        if len(out) >= occ:
            break
    return bytes(out), False


def _packbits(raw: bytes, occ: int) -> tuple[bytes, bool]:
    """libtiff's PackBitsDecode, with its truncations."""
    out = bytearray()
    pos, n = 0, len(raw)
    while pos < n and len(out) < occ:
        c = raw[pos]
        pos += 1
        if c > 128:
            if pos >= n:
                break
            out += raw[pos:pos + 1] * min(257 - c, occ - len(out))
            pos += 1
        elif c < 128:
            k = min(c + 1, occ - len(out))
            if pos + k > n:
                break
            out += raw[pos:pos + k]
            pos += k
    return bytes(out), len(out) == occ


def _jpeg(raw: bytes, tables, rows: int, cols: int, ycbcr: bool) -> np.ndarray:
    """A JPEG strip or tile (its JPEGTables spliced in front) as (rows,
    cols, components) uint8, YCbCr converted to RGB by libjpeg's tables."""
    from vision_kit_tpu_torch.data import decode

    if tables and len(tables) > 4 and raw[:2] == b"\xff\xd8":
        raw = tables[:-2] + raw[2:]
    info = decode.jpeg_header(raw)
    if decode.jpeg_refusal(info) or info["sof"] not in decode.SOF_HUFFMAN:
        raise TiffError("TIFF: a JPEG strip libjpeg refuses")
    if info["width"] < cols or info["height"] < rows:
        raise TiffError("TIFF: a JPEG strip smaller than its strip")
    parts = decode._coefficients(raw, info)
    planes = decode._planes(info, *parts, 1)
    if ycbcr and len(planes) == 3:
        px = decode.ycc_to_rgb(*planes)
    else:
        px = np.stack(planes, -1)
    return px[:rows, :cols]


def _predict(buf: np.ndarray, rows: int, row_bytes: int, samples: int, bits: int,
             order: str) -> np.ndarray:
    """Undo horizontal differencing: each row's samples summed along it,
    modulo 2^bits."""
    if bits == 8:
        v = buf[:rows * row_bytes].reshape(rows, -1, samples).astype(np.uint8)
        return np.cumsum(v, axis=1, dtype=np.uint8).reshape(-1)
    v = np.frombuffer(buf[:rows * row_bytes].tobytes(), order + "u2").reshape(rows, -1, samples)
    return np.cumsum(v, axis=1, dtype=np.uint16).astype(order + "u2").view(np.uint8).reshape(-1)


def _byte_count(info: dict, i: int, full: int) -> int:
    """Strip or tile i's byte count as libtiff reads it: TIFFFillStrip and
    TIFFFillTile cut a count over 1 MiB that exceeds ten times the full
    strip's or tile's size (`full` bytes) plus 4096 to that."""
    counts = info["counts"]
    cnt = counts[i] if counts and i < len(counts) else 0
    if cnt > 1 << 20 and (cnt - 4096) // 10 > full:
        cnt = full * 10 + 4096
    return cnt


def _chunk(data: bytes, info: dict, i: int, rows: int, cols: int, samples: int,
           fatal: bool = True, raw_size: int = 0, buf_size: int = 0):
    """Strip or tile i as a zero-filled buffer of rows x row_bytes with what
    its codec decoded (see the module docstring); a JPEG one as pixels. One
    that lies past the end of the bytes, or a tile that fails libtiff's
    byte count checks, refuses the file when `fatal` (the first plane,
    whose read allocates libtiff's buffer) and stays zero otherwise. For a
    tile, raw_size is libtiff's raw buffer after its read and buf_size the
    buffer its read allocates."""
    off = info["offsets"][i] if i < len(info["offsets"]) else 0
    row_bytes = (cols * samples * info["bits"] + 7) // 8
    occ = rows * row_bytes
    cnt = _byte_count(info, i, info["tile"][0] * row_bytes)
    comp = info["compression"]
    buf = np.zeros(occ, np.uint8)
    if comp == NONE and not fatal and not info["tiled"]:
        # gtStripSeparate's TIFFReadEncodedStrip reads an uncompressed plane
        # straight from the file, the strip's own size whatever its byte
        # count, keeping what a short read got (a tile's plane goes through
        # TIFFFillTile, as below)
        part = data[off:off + occ]
        if len(part) == occ:
            if info["fill"] == 2:
                part = part.translate(_REVERSE)
            buf[:] = np.frombuffer(part, np.uint8)
        else:                       # neither bit-reversed nor swabbed
            buf[:len(part)] = np.frombuffer(part, np.uint8)
            if info["bits"] == 16 and info["order"] == ">":
                buf = buf.reshape(-1, 2)[:, ::-1].reshape(-1).copy()
        return buf.reshape(rows, row_bytes)
    # _TIFFReadEncodedTileAndAllocBuffer's checks, on the read that
    # allocates the buffer (a contiguous tile, or a tile's first plane),
    # against a byte count that cannot fill the tile: libtiff's raw buffer
    # (the largest count read so far, rounded up to 1 KiB) must be the
    # tile's size when uncompressed, and at least a thousandth of it when
    # the read allocates over 10^8 bytes
    short = info["tiled"] and fatal and (
        raw_size != occ if comp == NONE else buf_size > 100_000_000 and raw_size < occ // 1000)
    if cnt <= 0 or off + cnt > len(data) or short:
        if fatal:
            raise TiffError("TIFF: a strip or tile past the end of the bytes, or a tile "
                            "whose byte count libtiff 4.7.1 refuses")
        return buf.reshape(rows, row_bytes)
    raw = data[off:off + cnt]
    if info["fill"] == 2:
        raw = raw.translate(_REVERSE)
    if comp == JPEG:
        return _jpeg(raw, info["jpeg_tables"], rows, cols, info["ycbcr_jpeg"])
    if comp == NONE:
        out, ok = (raw[:occ], True) if len(raw) >= occ else (b"", False)
    elif comp == LZW:
        out, ok = _lzw(raw, occ)
    elif comp == PACKBITS:
        out, ok = _packbits(raw, occ)
    elif comp == CCITT4:
        from vision_kit_tpu_torch.data import ccitt

        out, ok = ccitt.decode_g4(raw, cols, rows)
    else:
        out, ok = _deflate(raw, occ)
    buf[:len(out)] = np.frombuffer(out, np.uint8)
    if ok and info["predictor"] == 2:
        buf = _predict(buf, rows, row_bytes, samples, info["bits"], info["order"])
    if not ok and info["bits"] == 16 and info["order"] == ">":
        # libtiff swabs 16-bit samples to the host's order only after a
        # decode that succeeds: a failed one stays as stored
        buf = buf.reshape(-1, 2)[:, ::-1].reshape(-1).copy()
    return buf.reshape(rows, row_bytes)


def _samples(rows: np.ndarray, cols: int, samples: int, bits: int, order: str) -> np.ndarray:
    """(rows, row_bytes) bytes -> (rows, cols, samples) integer samples."""
    r = rows.shape[0]
    if bits == 8:
        return rows[:, :cols * samples].reshape(r, cols, samples)
    if bits == 16:
        return np.ascontiguousarray(rows[:, :cols * samples * 2]).view(order + "u2").reshape(
            r, cols, samples)
    unpacked = np.unpackbits(rows, axis=1)[:, :cols * samples * bits].reshape(r, -1, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (unpacked * weights).sum(-1, dtype=np.uint8).reshape(r, cols, samples)


def _skewed(chunk: np.ndarray, visible: int, tw: int, per: int, bits: int,
            order: str) -> np.ndarray:
    """The rows of a right-edge contiguous tile as libtiff's put16bitbwtile,
    putgreytile, putagreytile and put8bitcmaptile walk them: after each row
    of `visible` pixels they skip tw - visible BYTES, not that many pixels,
    so from the second row on they read from the wrong place (16-bit
    samples as the host's little-endian words at any byte offset)."""
    size = bits // 8
    flat = chunk.reshape(-1)
    if size == 2 and order == ">":
        flat = flat.reshape(-1, 2)[:, ::-1].reshape(-1)     # libtiff's swab to the host
    step = visible * per * size + (tw - visible)
    starts = np.arange(chunk.shape[0]) * step
    idx = starts[:, None] + np.arange(visible * per * size)[None, :]
    rows = flat[idx]
    if size == 2:
        return np.frombuffer(rows.tobytes(), "<u2").reshape(chunk.shape[0], visible, per)
    return rows.reshape(chunk.shape[0], visible, per)


def _stored(data: bytes, info: dict) -> np.ndarray:
    """Every sample of the page in stored order, (H, W, samples), or
    (H, W, 3) RGB for a JPEG page."""
    w, h, spp, bits = info["width"], info["height"], info["spp"], info["bits"]
    th, tw = info["tile"]
    planes = 1 if info["contig"] else spp
    per = spp if info["contig"] else 1
    jpeg = info["compression"] == JPEG
    # the put functions whose right-edge tiles libtiff misreads
    skew = (info["tiled"] and not jpeg and info["contig"]
            and ((info["photometric"] in (MINISWHITE, MINISBLACK) and (bits == 16 or spp > 1))
                 or (info["photometric"] == PALETTE and bits == 8 and spp > 1)))
    # the planes libtiff reads: the colour ones and an alpha one
    colour = {MINISWHITE: 1, MINISBLACK: 1, RGB: 3, SEPARATED: 4}.get(info["photometric"], 1)
    read = set(range(colour)) | ({colour} if info["alpha"] else set())
    raw_sizes, buf_size = {}, 0
    if info["tiled"]:
        # libtiff's raw buffer through the reads in its order (tile by tile,
        # each tile's planes in turn) and the buffer gtTileContig or
        # gtTileSeparate allocates: the tile, or room for 3 planes (4 with
        # alpha or CMYK's black)
        tile_bytes = th * ((tw * per * bits + 7) // 8)
        buf_size = tile_bytes if planes == 1 else tile_bytes * (
            4 if info["alpha"] or info["photometric"] == SEPARATED else 3)
        n = -(-h // th) * -(-w // tw)
        largest = 0
        for k in range(n):
            for plane in range(planes):
                if planes == 1 or plane in read:
                    largest = max(largest, _byte_count(info, plane * n + k, tile_bytes))
                    raw_sizes[plane * n + k] = -(-largest // 1024) * 1024
    out = None
    i = 0
    for plane in range(planes):
        for y in range(0, h, th):
            for x in range(0, w, tw):
                if info["tiled"]:
                    rows, cols = th, tw
                else:
                    rows, cols = min(th, h - y), w
                i += 1
                if planes > 1 and plane not in read:
                    continue
                chunk = _chunk(data, info, i - 1, rows, cols, per, fatal=plane == 0,
                               raw_size=raw_sizes.get(i - 1, 0), buf_size=buf_size)
                if jpeg:
                    px = chunk
                elif skew and w - x < tw:
                    px = _skewed(chunk, w - x, tw, per, bits, info["order"])
                else:
                    px = _samples(chunk, cols, per, bits, info["order"])
                if out is None:
                    out = np.zeros((h, w, px.shape[2] * planes), px.dtype)
                blk = px[:h - y, :w - x]
                out[y:y + blk.shape[0], x:x + blk.shape[1],
                    plane * px.shape[2]:(plane + 1) * px.shape[2]] = blk
    return out


_UA_TO_AA = ((np.arange(256)[:, None] * np.arange(256)[None, :] + 127) // 255).astype(np.uint8)


def _to8(v: np.ndarray) -> np.ndarray:
    """libtiff's Bitdepth16To8: (v + 128) // 257."""
    return ((v.astype(np.int64) + 128) // 257).astype(np.uint8)


def _rgb(s: np.ndarray, info: dict) -> np.ndarray:
    """tif_getimage.c's put* conversion of stored samples to RGB."""
    ph, bits, alpha = info["photometric"], info["bits"], info["alpha"]
    if ph in (MINISWHITE, MINISBLACK) and (info["contig"] or info["spp"] == 1):
        g = s[:, :, 0].astype(np.int64)
        if bits == 16:
            g = g >> 8
            rng = 255
        else:
            rng = (1 << bits) - 1
        v = (g * 255 // rng) if ph == MINISBLACK else ((rng - g) * 255 // rng)
        return np.repeat(v.astype(np.uint8)[:, :, None], 3, 2)
    if ph == PALETTE:
        cmap = np.asarray(info["cmap"], np.int64).reshape(3, -1)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[s[:, :, 0]]
    if ph == SEPARATED:
        c = s[:, :, :4].astype(np.int64)
        k = 255 - c[:, :, 3:4]
        return (k * (255 - c[:, :, :3]) // 255).astype(np.uint8)
    # RGB, and grey planes read the way libtiff reads RGB planes
    rgb = s[:, :, [0, 0, 0]] if ph in (MINISWHITE, MINISBLACK) else s[:, :, :3]
    if bits == 16:
        rgb = _to8(rgb)
    if alpha == 2 and s.shape[2] > 3 - 2 * (ph in (MINISWHITE, MINISBLACK)):
        a = s[:, :, 1 if ph in (MINISWHITE, MINISBLACK) else 3]
        a = _to8(a) if bits == 16 else a
        rgb = _UA_TO_AA[a[:, :, None], rgb]
    return np.ascontiguousarray(rgb.astype(np.uint8))


def decode_tiff(data: bytes) -> tuple[np.ndarray, int]:
    """cv2.imdecode(IMREAD_COLOR) of a TIFF's first page as (H, W, 3) RGB in
    stored order, and its orientation (see the module docstring). Raises
    TiffError where cv2 gives None or raises."""
    info = tiff_header(data)
    if size_refusal(info["width"], info["height"]):
        raise TiffError(size_refusal(info["width"], info["height"]))
    rgb = _rgb(_stored(data, info), info)
    orientation = info["orientation"] if 1 <= info["orientation"] <= 8 else 1
    if orientation in (2, 3, 6, 7) and info["tiled"]:
        # libtiff mirrors each tile where it lies; OpenCV does the rest
        th, tw = info["tile"]
        for x in range(0, info["width"], tw):
            rgb[:, x:x + tw] = rgb[:, x:x + tw][:, ::-1]
        orientation = {2: 1, 3: 4, 6: 7, 7: 6}[orientation]
    return rgb, orientation
