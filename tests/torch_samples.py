"""The encoded sample images of vision_kit_tpu_torch/data/samples/.

The card's machine has no image encoder, so the port's decode and serving
checks there read encoded bytes from the repository. They are written here
with cv2 from seeded smooth synthetic scenes (the JPEG 2000 ones by
tests/torch_jp2_samples.py); what cv2 does not write by
hand (the palette PNG with zlib, the 4-bit and RLE8 BMPs, the WebP
containers with EXIF and ICCP, animations with offset frames), with PIL
(the CMYK and RGB JPEGs, the palette BMP), with the libwebp that Pillow
bundles (WebPs with encoder settings cv2 does not expose) or with its
libjpeg-turbo (arithmetic-coded, lossless and 12-bit JPEGs). MANIFEST.json
lists each file's sha256, size, kind and the shape it decodes to (null
where the decoders refuse it), for a WebP, an arithmetic-coded and a
lossless JPEG the sha256 of cv2's decoded RGB (rgb_sha256), which the
card checks its decode against, and for a truncated JPEG (and the
arithmetic one without its EOI) the sha256 of the file the JAX package's
integrity scan writes over it (restored_sha256), which the card checks
its restore against.
tests/test_torch_decode.py checks the manifest and each file against
cv2.imdecode.

    python tests/torch_samples.py     # rewrites the folder
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "vision_kit_tpu_torch", "data", "samples")


def scene(h: int, w: int, seed: int, noise: float = 2.0) -> np.ndarray:
    """(h, w, 3) uint8 RGB: two gradients, a few filled rectangles and
    discs, mild noise."""
    rng = np.random.default_rng(seed)

    def draw(lo, hi):   # an empty range (a tiny image) gives lo
        return rng.integers(lo, max(hi, lo + 1))

    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(40, 200, 3)
    img = (base + np.stack([x / w * 60, y / h * 60, (x + y) / (w + h) * -50], -1))
    for _ in range(6):
        color = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            x0, y0 = draw(0, w - w // 8), draw(0, h - h // 8)
            x1 = x0 + draw(w // 16, w // 3)
            y1 = y0 + draw(h // 16, h // 3)
            img[y0:y1, x0:x1] = color
        else:
            cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(h / 16, h / 4)
            img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = color
    img = img + rng.normal(0, noise, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def jpeg(rgb: np.ndarray, quality: int = 90, sampling=None, **flags) -> bytes:
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    for key, value in flags.items():
        params += [getattr(cv2, key), value]
    src = rgb if rgb.ndim == 2 else cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    ok, enc = cv2.imencode(".jpg", src, params)
    assert ok
    return enc.tobytes()


def with_exif(data: bytes, orientation: int) -> bytes:
    """`data` with an APP1 Exif segment (little-endian TIFF, IFD0 holding
    only tag 0x0112) after SOI."""
    tiff = (b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    app1 = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def palette_png(index: np.ndarray, palette: np.ndarray) -> bytes:
    """Colour type 3, depth 8, every row filtered with Sub."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    h, w = index.shape
    rows = index.astype(np.int16)
    sub = (rows - np.concatenate([np.zeros((h, 1), np.int16), rows[:, :-1]], 1)) & 255
    raw = b"".join(b"\x01" + r.astype(np.uint8).tobytes() for r in sub)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", palette.astype(np.uint8).tobytes())
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def jpeg_scans(data: bytes) -> list[int]:
    """Offsets of the SOS markers of a JPEG."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            out.append(pos)
            pos += 2 + length
            while not (data[pos] == 0xFF and data[pos + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
        elif marker == 0xD9:
            break
        else:
            pos += 2 + length
    return out


def cut_after_scans(data: bytes, k: int) -> bytes:
    """The first k scans of a progressive JPEG, closed by an EOI marker."""
    return data[:jpeg_scans(data)[k]] + b"\xff\xd9"


def pil_jpeg(arr: np.ndarray, mode: str, **kw) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def with_adobe_transform(data: bytes, transform: int) -> bytes:
    """`data` with the transform byte of its Adobe APP14 segment set."""
    at = data.index(b"\xff\xee")
    return data[:at + 15] + bytes([transform]) + data[at + 16:]


def without_tables(data: bytes, slots=(0, 1, 2, 3)) -> bytes:
    """The JPEG with the Huffman tables of `slots` taken out of its DHT
    segments (a segment left empty goes too): a Motion-JPEG camera's frame
    carries none, and libjpeg then takes the standard ones for slots 0
    and 1."""
    from vision_kit_tpu_torch.data import decode

    out = bytearray(data[:2])
    for m, a, b, end in decode._walk(data):
        if m == decode.EOI:
            out += data[a - 2:a]
        elif m != decode.DHT:
            out += data[a - 4:end if m == decode.SOS else b]
        else:
            seg, i, kept = data[a:b], 0, b""
            while i < len(seg):
                n = 17 + sum(seg[i + 1:i + 17])
                if seg[i] & 15 not in slots:
                    kept += seg[i:i + n]
                i += n
            if kept:
                out += struct.pack(">BBH", 0xFF, decode.DHT, len(kept) + 2) + kept
    return bytes(out)


def optimised_luma_only(rgb: np.ndarray) -> bytes:
    """A baseline 4:2:0 JPEG whose slot 0 holds Pillow's optimised tables
    and whose slot 1 is undefined: PIL's optimize=True file, its scan
    coded again with the optimised luma tables and the standard chroma
    ones (the port's encoder stages over its own coefficients), so that
    only the standard tables read it right."""
    from vision_kit_tpu_torch.data import decode, encode

    src = pil_jpeg(rgb, "RGB", quality=90, optimize=True)
    info = decode.jpeg_header(src)
    frame, coefs, *_ = decode._coefficients(src, info)
    bases, _ = decode._block_order(frame, [(0, 0, 0), (1, 1, 1), (2, 1, 1)])
    blocks = coefs[bases.reshape(-1)[:, None] + decode.ZIGZAG[None, :64]].astype(np.int64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), len(bases))
    luma = {}
    for m, a, b, _ in decode._walk(src):
        i = 0
        while m == decode.DHT and i < b - a:
            n = sum(src[a + i + 1:a + i + 17])
            if src[a + i] & 15 == 0:
                luma[src[a + i] >> 4] = encode._code_table(
                    src[a + i + 1:a + i + 17], src[a + i + 17:a + i + 17 + n])
            i += 17 + n
    saved = [c.copy() for c in encode._CODES]
    try:
        for ac in (0, 1):
            encode._CODES[ac][:, 0] = np.stack(luma[ac])
        scan = encode._entropy(blocks, np.minimum(comp, 1), comp)
    finally:
        encode._CODES[:] = saved
    head = without_tables(src, (1,))
    start, end = next((b, e) for m, _, b, e in decode._walk(head) if m == decode.SOS)
    return head[:start] + scan + head[end:]


def bmp_file(w: int, h: int, bpp: int, pixels: bytes, palette=None,
             compression: int = 0) -> bytes:
    """A BMP with a 40-byte BITMAPINFOHEADER, bottom-up, the palette given
    as (n, 3) RGB."""
    pal = b""
    if palette is not None:
        pal = np.concatenate([np.asarray(palette, np.uint8)[:, ::-1],
                              np.zeros((len(palette), 1), np.uint8)], 1).tobytes()
    head = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, compression, len(pixels),
                       2835, 2835, len(palette) if palette is not None else 0, 0)
    offset = 14 + len(head) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + head + pal + pixels)


def bmp_rows(index: np.ndarray, bpp: int) -> bytes:
    """Bottom-up rows of palette indices at `bpp` bits, padded to 4 bytes."""
    out = b""
    for row in index[::-1]:
        bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bpp:]
        packed = np.packbits(bits.reshape(-1)).tobytes()
        out += packed + bytes(-len(packed) % 4)
    return out


def rle8(index: np.ndarray, skip: tuple) -> bytes:
    """RLE8 of bottom-up rows: runs of equal indices, absolute runs of 3 or
    more others, an end of line after each row, an end of bitmap; the
    pixels of the (row, x0, x1) in `skip` (file order) jumped over with a
    delta escape (the decoder paints them with palette entry 0)."""
    out = bytearray()
    rows = index[::-1]
    for y, row in enumerate(rows):
        x = 0
        while x < len(row):
            if skip[0] == y and x == skip[1]:
                out += bytes([0, 2, skip[2] - skip[1], 0])
                x = skip[2]
                continue
            stop = len(row) if skip[0] != y or x > skip[1] else skip[1]
            n = 1
            while x + n < stop and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 2 or stop - x < 3:
                out += bytes([n, row[x]])
                x += n
                continue
            m = 1
            while x + m < stop and m < 255 and row[x + m] != row[x + m - 1]:
                m += 1
            if m < 3:
                out += bytes([1, row[x]])
                x += 1
                continue
            out += bytes([0, m]) + row[x:x + m].astype(np.uint8).tobytes() + bytes(m & 1)
            x += m
        out += b"\x00\x00"
    return bytes(out) + b"\x00\x01"


# -- libjpeg-turbo through ctypes --------------------------------------------

# jpeg_compress_struct's fields as libjpeg's 6.2 ABI lays them out on
# x86-64 (offsetof over jpeglib.h with gcc; libjpeg-turbo 3.1 keeps the
# layout), and jpeg_component_info's (96 bytes each)
_CINFO = dict(size=520, err=0, image_width=48, image_height=52, input_components=56,
              in_color_space=60, data_precision=72, num_components=76, comp_info=88,
              arith_dc_L=192, arith_dc_U=208, arith_ac_K=224, arith_code=260,
              restart_interval=280, restart_in_rows=284)
_COMP = dict(size=96, h_samp_factor=8, v_samp_factor=12)
_JCS = {"grey": 1, "rgb": 2, "ycc": 3, "cmyk": 4, "ycck": 5}


def _libjpeg():
    """The libjpeg-turbo that the Pillow wheel bundles (3.1 with Pillow
    12.1): its encoder writes arithmetic-coded, lossless and 12-bit JPEGs,
    which cv2.imencode does not."""
    import ctypes
    import glob

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    paths = glob.glob(os.path.join(libs, "libjpeg-*.so*"))
    if not paths:
        raise RuntimeError(f"no libjpeg in {libs}")
    return ctypes.CDLL(paths[0])


def libjpeg_encode(pixels: np.ndarray, quality: int = 90, *, arith: bool = False,
                   progressive: bool = False, lossless: tuple | None = None,
                   restart: int = 0, restart_rows: int = 0, sampling=None,
                   precision: int = 8, dac: dict | None = None) -> bytes:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) CMYK samples -> JPEG bytes
    from libjpeg's compressor with jpeg_set_defaults and jpeg_set_quality,
    then: arithmetic coding (`dac`: {"L": [...], "U": [...], "K": [...]}
    conditioning values by table), jpeg_simple_progression, lossless
    (predictor, point transform) through jpeg_enable_lossless, which writes
    the input's colour space with 1x1 sampling whatever else is asked, a
    restart interval in MCUs or rows, (h, v) sampling factors by component,
    and 12-bit samples (int16 `pixels`, jpeg12_write_scanlines). libjpeg's
    error exit ends the process, so the settings must be ones it takes."""
    import ctypes as C

    lib = _libjpeg()
    cinfo = C.create_string_buffer(1024)
    err = C.create_string_buffer(512)
    lib.jpeg_std_error.restype = C.c_void_p
    C.c_void_p.from_buffer(cinfo, _CINFO["err"]).value = lib.jpeg_std_error(err)

    def field(name, ctype=C.c_int):
        return ctype.from_buffer(cinfo, _CINFO[name])

    lib.jpeg_CreateCompress(cinfo, 62, _CINFO["size"])
    h, w = pixels.shape[:2]
    ch = 1 if pixels.ndim == 2 else pixels.shape[2]
    field("image_width", C.c_uint).value = w
    field("image_height", C.c_uint).value = h
    field("input_components").value = ch
    field("in_color_space").value = {1: _JCS["grey"], 3: _JCS["rgb"], 4: _JCS["cmyk"]}[ch]
    field("data_precision").value = precision
    lib.jpeg_set_defaults(cinfo)
    field("data_precision").value = precision
    lib.jpeg_set_quality(cinfo, quality, 1)
    if lossless:
        lib.jpeg_enable_lossless(cinfo, *lossless)
    if progressive:
        lib.jpeg_simple_progression(cinfo)
    if arith:
        field("arith_code").value = 1
    field("restart_interval", C.c_uint).value = restart
    field("restart_in_rows").value = restart_rows
    if sampling:
        comp = field("comp_info", C.c_void_p).value
        for ci, (hs, vs) in enumerate(sampling):
            C.c_int.from_address(comp + _COMP["size"] * ci + _COMP["h_samp_factor"]).value = hs
            C.c_int.from_address(comp + _COMP["size"] * ci + _COMP["v_samp_factor"]).value = vs
    for key, values in (dac or {}).items():
        base = _CINFO[{"L": "arith_dc_L", "U": "arith_dc_U", "K": "arith_ac_K"}[key]]
        for t, v in enumerate(values):
            C.c_uint8.from_buffer(cinfo, base + t).value = v
    buf, size = C.c_void_p(), C.c_ulong()
    lib.jpeg_mem_dest(cinfo, C.byref(buf), C.byref(size))
    lib.jpeg_start_compress(cinfo, 1)
    px = np.ascontiguousarray(pixels, np.uint8 if precision == 8 else np.int16)
    rows = (C.c_void_p * h)(*[px.ctypes.data + r * px.strides[0] for r in range(h)])
    (lib.jpeg_write_scanlines if precision == 8 else lib.jpeg12_write_scanlines)(cinfo, rows, h)
    lib.jpeg_finish_compress(cinfo)
    out = C.string_at(buf, size.value)
    lib.jpeg_destroy_compress(cinfo)
    C.CDLL(None).free(buf)
    return out


# -- WebP ------------------------------------------------------------------


def _libwebp():
    """The libwebp that the Pillow wheel bundles (1.6.0 with Pillow 12.1),
    through ctypes: its encoder takes the settings cv2.imencode does not
    expose."""
    import ctypes
    import glob

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    paths = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    if not paths:
        raise RuntimeError(f"no libwebp in {libs}")
    for dep in glob.glob(os.path.join(libs, "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)   # libwebp's own dependency
    return ctypes.CDLL(paths[0])


def _webp_structs():
    import ctypes as C

    class Config(C.Structure):   # encode.h WebPConfig
        _fields_ = [(n, t) for n, t in (
            ("lossless", C.c_int), ("quality", C.c_float), ("method", C.c_int),
            ("image_hint", C.c_int), ("target_size", C.c_int), ("target_PSNR", C.c_float),
            ("segments", C.c_int), ("sns_strength", C.c_int), ("filter_strength", C.c_int),
            ("filter_sharpness", C.c_int), ("filter_type", C.c_int), ("autofilter", C.c_int),
            ("alpha_compression", C.c_int), ("alpha_filtering", C.c_int),
            ("alpha_quality", C.c_int), ("pass_", C.c_int), ("show_compressed", C.c_int),
            ("preprocessing", C.c_int), ("partitions", C.c_int),
            ("partition_limit", C.c_int), ("emulate_jpeg_size", C.c_int),
            ("thread_level", C.c_int), ("low_memory", C.c_int), ("near_lossless", C.c_int),
            ("exact", C.c_int), ("use_delta_palette", C.c_int), ("use_sharp_yuv", C.c_int),
            ("qmin", C.c_int), ("qmax", C.c_int), ("pad", C.c_uint32 * 1))]

    ptr = C.c_void_p

    class Picture(C.Structure):  # encode.h WebPPicture
        _fields_ = [
            ("use_argb", C.c_int), ("colorspace", C.c_int), ("width", C.c_int),
            ("height", C.c_int), ("y", ptr), ("u", ptr), ("v", ptr), ("y_stride", C.c_int),
            ("uv_stride", C.c_int), ("a", ptr), ("a_stride", C.c_int),
            ("pad1", C.c_uint32 * 2), ("argb", ptr), ("argb_stride", C.c_int),
            ("pad2", C.c_uint32 * 3), ("writer", ptr), ("custom_ptr", ptr),
            ("extra_info_type", C.c_int), ("extra_info", ptr), ("stats", ptr),
            ("error_code", C.c_int), ("progress_hook", ptr), ("user_data", ptr),
            ("pad3", C.c_uint32 * 3), ("pad4", ptr), ("pad5", ptr),
            ("pad6", C.c_uint32 * 8), ("memory_", ptr), ("memory_argb_", ptr),
            ("pad7", ptr * 2)]

    class MemoryWriter(C.Structure):
        _fields_ = [("mem", C.POINTER(C.c_uint8)), ("size", C.c_size_t),
                    ("max_size", C.c_size_t), ("pad", C.c_uint32 * 1)]

    return Config, Picture, MemoryWriter


def libwebp_encode(pixels: np.ndarray, quality: float = 75.0, **settings) -> bytes:
    """(H, W, 3) RGB or (H, W, 4) RGBA uint8 -> WebP bytes from libwebp's
    WebPEncode with WebPConfig fields set from `settings` (lossless, method,
    segments, sns_strength, filter_strength, filter_sharpness, filter_type,
    partitions, use_sharp_yuv, near_lossless, exact, ...)."""
    import ctypes as C

    lib = _libwebp()
    Config, Picture, MemoryWriter = _webp_structs()
    abi = 0x0210
    config, pic, writer = Config(), Picture(), MemoryWriter()
    if not lib.WebPConfigInitInternal(C.byref(config), 0, C.c_float(quality), abi):
        raise RuntimeError("WebPConfigInit failed")
    for name, value in settings.items():
        if not hasattr(config, name):
            raise KeyError(name)
        setattr(config, name, value)
    if not lib.WebPValidateConfig(C.byref(config)):
        raise ValueError(f"libwebp refuses the settings {settings}")
    if not lib.WebPPictureInitInternal(C.byref(pic), abi):
        raise RuntimeError("WebPPictureInit failed")
    h, w, ch = pixels.shape
    pic.width, pic.height = w, h
    pic.use_argb = int(bool(config.lossless))
    rgb = np.ascontiguousarray(pixels, np.uint8)
    imp = lib.WebPPictureImportRGBA if ch == 4 else lib.WebPPictureImportRGB
    if not imp(C.byref(pic), rgb.ctypes.data_as(C.c_void_p), w * ch):
        raise RuntimeError("WebPPictureImport failed")
    lib.WebPMemoryWriterInit(C.byref(writer))
    pic.writer = C.cast(lib.WebPMemoryWrite, C.c_void_p)
    pic.custom_ptr = C.cast(C.pointer(writer), C.c_void_p)
    try:
        if not lib.WebPEncode(C.byref(config), C.byref(pic)):
            raise RuntimeError(f"WebPEncode failed: error {pic.error_code}")
        return C.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(C.byref(pic))
        lib.WebPMemoryWriterClear(C.byref(writer))


class _LsbBits:
    """An LSB-first bit writer, as VP8L reads."""

    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, v: int, n: int) -> None:
        self.value |= (v & ((1 << n) - 1)) << self.n
        self.n += n

    def code8(self, v: int) -> None:   # a symbol of an all-8-bit prefix code
        for k in range(7, -1, -1):
            self.put((v >> k) & 1, 1)

    def bytes(self) -> bytes:
        return self.value.to_bytes((self.n + 7) // 8, "little")


def _vp8l_image(bw: _LsbBits, argb: np.ndarray, level0: bool) -> None:
    """An entropy-coded image with no colour cache and no meta codes: every
    literal through 8-bit prefix codes (the code-length code holds the one
    length 8), the distance code one symbol of 0 bits."""
    bw.put(0, 1)                  # no colour cache
    if level0:
        bw.put(0, 1)              # no meta prefix codes
    for alphabet in (280, 256, 256, 256):
        bw.put(0, 1)              # a normal code
        bw.put(12 - 4, 4)         # kCodeLengthCodeOrder up to the 8 at index 11
        for i in range(12):
            bw.put(1 if i == 11 else 0, 3)
        if alphabet == 280:       # max_symbol 256: lengths 8 for the literals only
            bw.put(1, 1)
            bw.put(3, 3)
            bw.put(254, 8)
        else:
            bw.put(0, 1)
    bw.put(1, 1)                  # distance: a simple code of one 1-bit symbol, 0
    bw.put(0, 1)
    bw.put(0, 1)
    bw.put(0, 1)
    for v in np.asarray(argb, np.uint32).reshape(-1).tolist():
        bw.code8((v >> 8) & 255)
        bw.code8((v >> 16) & 255)
        bw.code8(v & 255)
        bw.code8(v >> 24)


def vp8l_raw(pixels: np.ndarray, transforms: list[tuple[int, int, np.ndarray]]) -> bytes:
    """A VP8L file (RIFF) of (h, w) ARGB uint32 coded pixels after
    `transforms`, each (kind, bits, sub-image): predictor (0) with its mode
    tiles in the green byte, cross-colour (1) with its multipliers,
    subtract-green (2, no sub-image). The data need not come from any
    image: the decoders undo whatever is there, and must agree."""
    h, w = pixels.shape
    bw = _LsbBits()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(0, 1)
    bw.put(0, 3)
    for kind, bits, sub in transforms:
        bw.put(1, 1)
        bw.put(kind, 2)
        if kind in (0, 1):
            bw.put(bits - 2, 3)
            _vp8l_image(bw, sub, False)
    bw.put(0, 1)
    _vp8l_image(bw, pixels, True)
    return riff((b"VP8L", bw.bytes()))


def riff(*chunks: tuple[bytes, bytes]) -> bytes:
    """A RIFF/WEBP file of (tag, payload) chunks, each padded to even."""
    body = b"".join(tag + struct.pack("<I", len(p)) + p + bytes(len(p) & 1)
                    for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def webp_chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """The (tag, payload) chunks of a RIFF/WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def vp8x(w: int, h: int, flags: int) -> tuple[bytes, bytes]:
    """A VP8X chunk: flags, canvas width and height minus one (24 bits)."""
    return b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little") \
        + (h - 1).to_bytes(3, "little")


def exif_tiff(orientation: int) -> bytes:
    """A little-endian TIFF body with one IFD0 entry: the orientation."""
    return b"II*\0" + struct.pack("<IH", 8, 1) + struct.pack("<HHIHH", 0x0112, 3, 1,
                                                             orientation, 0) + bytes(4)


def webp_with(data: bytes, exif: bytes | None = None, icc: bytes | None = None) -> bytes:
    """A still WebP rewritten as VP8X with EXIF and ICCP chunks (the canvas
    from the image's own header, alpha flagged where an ALPH chunk or the
    VP8L header says so)."""
    import cv2

    chunks = [c for c in webp_chunks(data) if c[0] != b"VP8X"]
    h, w = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED).shape[:2]
    alpha = any(t == b"ALPH" for t, _ in chunks) or any(
        t == b"VP8L" and p[4] & 0x10 for t, p in chunks)
    flags = (0x10 if alpha else 0) | (0x08 if exif else 0) | (0x20 if icc else 0)
    out = [vp8x(w, h, flags)]
    if icc:
        out.append((b"ICCP", icc))
    out += chunks
    if exif:
        out.append((b"EXIF", exif))
    return riff(*out)


def animation(frames: list[tuple[bytes, int, int]], w: int, h: int) -> bytes:
    """An animated WebP on a w x h canvas: each frame (still WebP bytes, x,
    y offset, even) as an ANMF chunk holding the still file's ALPH and
    image chunks."""
    import cv2

    out = [vp8x(w, h, 0x02 | 0x10), (b"ANIM", bytes(4) + struct.pack("<H", 0))]
    for data, x, y in frames:
        fh, fw = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED).shape[:2]
        subs = b"".join(t + struct.pack("<I", len(p)) + p + bytes(len(p) & 1)
                        for t, p in webp_chunks(data) if t in (b"ALPH", b"VP8 ", b"VP8L"))
        head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, fw - 1, fh - 1, 100))
        out.append((b"ANMF", head + b"\x00" + subs))
    return riff(*out)


# -- the still-image kinds beside JPEG, PNG, BMP and WebP --------------------


def lzw_gif(index: np.ndarray, min_size: int) -> bytes:
    """GIF LZW of a flat array of colour indices: LSB-first codes, a clear
    code first and whenever the table fills, the end code last."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits, size = bytearray(), 0, 0, min_size + 1

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    table, nxt, cur = {}, end + 1, None
    put(clear)
    for k in index.tolist():
        if cur is None:
            cur = (k,)
            continue
        if cur + (k,) in table:
            cur += (k,)
            continue
        put(table[cur] if len(cur) > 1 else cur[0])
        if nxt < 4096:
            table[cur + (k,)] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            put(clear)
            table, nxt, size = {}, end + 1, min_size + 1
        cur = (k,)
    if cur is not None:
        put(table[cur] if len(cur) > 1 else cur[0])
    put(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def _gif_table(colours: np.ndarray) -> tuple[int, bytes]:
    bits = max(1, int(np.ceil(np.log2(len(colours)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(colours)] = colours
    return bits - 1, table.tobytes()


def gif_file(w: int, h: int, frames: list[dict], colours=None, background: int = 0) -> bytes:
    """A GIF89a screen of w x h with a global colour table (None for none)
    and frames of dicts: "index" (fh, fw) colour indices, optional "x",
    "y", "colours" (a local table), "interlace", "transparent" (index) and
    "disposal", "min_size" (LZW minimum code size, 8 by default)."""
    flags = 0
    table = b""
    if colours is not None:
        bits, table = _gif_table(np.asarray(colours, np.uint8))
        flags = 0x80 | bits | bits << 4
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, flags, background, 0) + table
    for f in frames:
        index = np.asarray(f["index"], np.uint8)
        fh, fw = index.shape
        if "transparent" in f or "disposal" in f:
            t = f.get("transparent")
            packed = (f.get("disposal", 0) & 7) << 2 | (t is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHBB", packed, 10, t or 0, 0)
        lflags, local = 0, b""
        if f.get("colours") is not None:
            bits, local = _gif_table(np.asarray(f["colours"], np.uint8))
            lflags = 0x80 | bits
        rows = index
        if f.get("interlace"):
            lflags |= 0x40
            rows = index[np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                         np.arange(2, fh, 4), np.arange(1, fh, 2)])]
        m = f.get("min_size", 8)
        out += (b"\x2c" + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), fw, fh, lflags)
                + local + bytes([m]) + _sub_blocks(lzw_gif(rows.reshape(-1), m)))
    return out + b"\x3b"


def lzw_tiff(data: bytes) -> bytes:
    """TIFF LZW as libtiff's LZWEncode writes it: MSB-first codes of 9 to 12
    bits with the early change, clear 256 first and at 4094, end 257 last."""
    out, acc, nbits, size = bytearray(), 0, 0, 9

    def put(code):
        nonlocal acc, nbits
        acc = acc << size | code
        nbits += size
        while nbits >= 8:
            out.append(acc >> (nbits - 8) & 255)
            nbits -= 8
        acc &= (1 << nbits) - 1

    def grow():
        nonlocal nxt, size
        nxt += 1
        if nxt == 4094:
            put(256)
            table.clear()
            table.update(roots)
            nxt, size = 258, 9
        elif nxt > (1 << size) - 1:
            size += 1

    roots = {bytes([i]): i for i in range(256)}
    table, nxt, cur = dict(roots), 258, b""
    put(256)
    for k in data:
        s = cur + bytes([k])
        if s in table or not cur:
            cur = s
            continue
        put(table[cur])
        table[s] = nxt
        grow()
        cur = bytes([k])
    if cur:
        put(table[cur])
        grow()
    put(257)
    if nbits:
        out.append(acc << (8 - nbits) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, literal spans of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1) & 255, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q"}


def tiff_file(samples: np.ndarray, bits: int = 8, photometric: int | None = None,
              compression: int = 1, rows_per_strip: int | None = None, tile=None,
              planar: int = 1, predictor: int = 1, extra=None, order: str = "<",
              big: bool = False, tags: dict | None = None, short: dict | None = None) -> bytes:
    """A one-page TIFF of (h, w, samples) integer samples (a 2-D array is
    one sample): strips of rows_per_strip rows or tiles of (th, tw),
    PlanarConfig 1 or 2, compression 1 (none), 5 (LZW), 8 or 32946
    (Deflate) or 32773 (PackBits) with predictor 1 or 2, bits of 1, 4, 8
    or 16, byte order "<" or ">", classic or BigTIFF; extra tags as {tag:
    (type, values)}, which replace the written ones (tile or strip size
    too); `short` {strip or tile: bytes} states other byte counts than were
    written for those (fewer: a codec stream cut short). The IFD follows
    the pixels."""
    a = np.asarray(samples)
    a = a[:, :, None] if a.ndim == 2 else a
    h, w, c = a.shape
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [compression]),
              262: (3, [photometric if photometric is not None else (2 if c >= 3 else 1)]),
              277: (3, [c]), 284: (3, [planar])}
    if extra is not None:
        fields[338] = (3, list(extra))
    if predictor != 1:
        fields[317] = (3, [predictor])
    dtype = np.dtype(order + ("u2" if bits == 16 else "u1"))

    def pack(block):
        if predictor == 2:
            block = block.astype(np.int64)
            block[:, 1:] -= block[:, :-1].copy()
            block &= (1 << bits) - 1
        if bits >= 8:
            return block.astype(dtype).tobytes()
        rows = block.reshape(block.shape[0], -1).astype(np.uint8)
        unpacked = (rows[:, :, None] >> np.arange(bits - 1, -1, -1)) & 1
        return np.packbits(unpacked.reshape(rows.shape[0], -1), axis=1).tobytes()

    planes = [a] if planar == 1 else [a[:, :, i:i + 1] for i in range(c)]
    chunks = []
    if tile:
        th, tw = tile
        fields[322], fields[323] = (3, [tw]), (3, [th])
        for p in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    block = np.zeros((th, tw, p.shape[2]), a.dtype)
                    part = p[y:y + th, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    chunks.append(pack(block))
    else:
        rps = rows_per_strip or h
        fields[278] = (4, [rps])
        chunks = [pack(p[y:y + rps]) for p in planes for y in range(0, h, rps)]
    codec = {1: bytes, 5: lzw_tiff, 8: zlib.compress, 32946: zlib.compress,
             32773: packbits}[compression]
    chunks = [codec(c_) for c_ in chunks]
    head = 16 if big else 8
    offsets, pos = [], head
    for chunk in chunks:
        offsets.append(pos)
        pos += len(chunk)
    long_type = 16 if big else 4
    fields[324 if tile else 273] = (long_type, offsets)
    counts = [len(chunk) for chunk in chunks]
    for i, n in (short or {}).items():
        counts[i] = n
    fields[325 if tile else 279] = (long_type, counts)
    fields.update(tags or {})
    ifd = pos + (pos & 1)
    inline = 8 if big else 4
    entries = sorted(fields.items())
    extra_pos = ifd + (8 if big else 2) + (20 if big else 12) * len(entries) + inline
    ents, extra_data = bytearray(), bytearray()
    for tag, (typ, values) in entries:
        raw = struct.pack(order + _TIFF_TYPES[typ] * len(values), *values)
        if len(raw) <= inline:
            value = raw.ljust(inline, b"\0")
        else:
            value = struct.pack(order + ("Q" if big else "I"), extra_pos + len(extra_data))
            extra_data += raw + b"\0" * (len(raw) & 1)
        ents += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, len(values)) + value
    start = ((b"II" if order == "<" else b"MM")
             + (struct.pack(order + "HHHQ", 43, 8, 0, ifd) if big
                else struct.pack(order + "HI", 42, ifd)))
    return (start + b"".join(chunks) + b"\0" * (ifd - pos)
            + struct.pack(order + ("Q" if big else "H"), len(entries)) + ents
            + b"\0" * inline + extra_data)


def pil_tiff(arr: np.ndarray, mode: str | None = None, **kw) -> bytes:
    """Pillow's TIFF (through its libtiff) of an array, in `mode`."""
    import io

    from PIL import Image

    img = Image.fromarray(arr)
    if mode is not None:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def pil_gif(images: list, **kw) -> bytes:
    """Pillow's GIF of palette images (the first, then the rest as frames)."""
    import io

    buf = io.BytesIO()
    images[0].save(buf, "GIF", save_all=len(images) > 1, append_images=images[1:], **kw)
    return buf.getvalue()


def netpbm_ascii(magic: bytes, values: np.ndarray, w: int, h: int, maxval: int | None,
                 per_line: int = 12, comment: bytes = b"# a comment\n") -> bytes:
    """An ASCII Netpbm file (P1, P2, P3) with a comment in its header."""
    head = magic + b"\n" + comment + b"%d %d\n" % (w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    flat = [b"%d" % v for v in np.asarray(values).reshape(-1).tolist()]
    lines = [b" ".join(flat[i:i + per_line]) for i in range(0, len(flat), per_line)]
    return head + b"\n".join(lines) + b"\n"


def sun_raster(w: int, h: int, depth: int, pixels: bytes, colours=None) -> bytes:
    """A Sun raster file, RT_STANDARD, rows padded to 16 bits by the caller;
    an RMT_EQUAL_RGB map of `colours` ((n, 3)) where given."""
    cmap = b"" if colours is None else np.asarray(colours, np.uint8).T.tobytes()
    return struct.pack(">8i", 0x59A66A95, w, h, depth, len(pixels), 1,
                       0 if colours is None else 1, len(cmap)) + cmap + pixels


def sun_rows(px: np.ndarray, depth: int) -> bytes:
    """Rows of (h, w) indices or (h, w, bytes) pixels padded to 16 bits."""
    h = px.shape[0]
    if depth == 1:
        rows = np.packbits(px.astype(np.uint8), axis=1)
    else:
        rows = np.asarray(px, np.uint8).reshape(h, -1)
    pad = rows.shape[1] & 1
    return np.concatenate([rows, np.zeros((h, pad), np.uint8)], 1).tobytes()


def image_kinds() -> dict[str, tuple[bytes, str, tuple | None]]:
    """The Netpbm/PAM, PFM, Sun raster, Radiance HDR, GIF and TIFF samples:
    {file name: (bytes, kind, decoded (h, w))}. Each kind starts with its
    decode route's name (host_<pxm, pfm, sunras, hdr, gif, tiff>)."""
    import cv2

    from PIL import Image

    files = {}
    bgr = cv2.cvtColor(scene(48, 64, 80), cv2.COLOR_RGB2BGR)
    grey = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    rng = np.random.default_rng(81)
    # Netpbm and PAM
    files["p6_48x64.ppm"] = (cv2.imencode(".ppm", bgr)[1].tobytes(), "pxm_p6", (48, 64))
    files["p5_48x64.pgm"] = (cv2.imencode(".pgm", grey)[1].tobytes(), "pxm_p5", (48, 64))
    bw = (cv2.resize(grey, (83, 61)) > 110).astype(np.uint8) * 255
    files["p4_61x83.pbm"] = (cv2.imencode(".pbm", bw)[1].tobytes(), "pxm_p4", (61, 83))
    small = cv2.resize(bgr, (32, 24), interpolation=cv2.INTER_AREA)
    files["p3_24x32.ppm"] = (cv2.imencode(".ppm", small, [cv2.IMWRITE_PXM_BINARY, 0])[1]
                             .tobytes(), "pxm_p3", (24, 32))
    level = cv2.resize(grey, (32, 24), interpolation=cv2.INTER_AREA) * 110 // 255
    files["p2_maxval100_24x32.pgm"] = (netpbm_ascii(b"P2", level, 32, 24, 100), "pxm_p2",
                                       (24, 32))
    files["p1_24x32.pbm"] = (netpbm_ascii(b"P1", level > 50, 32, 24, None, per_line=40),
                             "pxm_p1", (24, 32))
    deep = (cv2.resize(grey, (40, 30)).astype(np.int64) * 4 + rng.integers(0, 4, (30, 40)))
    files["p5_16bit_maxval1000_30x40.pgm"] = (
        b"P5\n40 30\n1000\n" + deep.astype(">u2").tobytes(), "pxm_p5_16bit", (30, 40))
    colour60 = cv2.resize(bgr, (40, 30), interpolation=cv2.INTER_AREA)
    files["pam_rgb_30x40.pam"] = (cv2.imencode(".pam", colour60)[1].tobytes(), "pxm_pam_rgb",
                                  (30, 40))
    files["pam_grey_30x40.pam"] = (
        cv2.imencode(".pam", cv2.cvtColor(colour60, cv2.COLOR_BGR2GRAY))[1].tobytes(),
        "pxm_pam_grey", (30, 40))
    bits = np.packbits(bw > 0, axis=1)   # BLACKANDWHITE: a row of w bytes, read as bits
    rows = np.concatenate([bits, np.zeros((61, 83 - bits.shape[1]), np.uint8)], 1)
    files["pam_bw_61x83.pam"] = (
        b"P7\nWIDTH 83\nHEIGHT 61\nDEPTH 1\nMAXVAL 1\nTUPLTYPE BLACKANDWHITE\nENDHDR\n"
        + rows.tobytes(), "pxm_pam_bw", (61, 83))
    # PFM: cv2's own, and a big-endian one with NaN, infinities and halves
    values = scene(30, 40, 82).astype(np.float32) + rng.uniform(-0.5, 0.5, (30, 40, 3)).astype(
        np.float32)
    files["pfm_30x40.pfm"] = (cv2.imencode(".pfm", values[:, :, ::-1].copy())[1].tobytes(),
                              "pfm_rgb", (30, 40))
    special = (rng.integers(0, 1100, (20, 30, 3)) / 2).astype(np.float32)
    special[0, :6] = [[np.nan, np.inf, -np.inf], [3e9, -3e9, 2.5], [0.5, 1.5, 254.5],
                      [255.5, -0.5, 1e-30], [7, 8, 9], [1, 2, 3]]
    files["pfm_bigendian_20x30.pfm"] = (
        b"PF\n30 20\n0.5\n" + (special[::-1] * 2).astype(">f4").tobytes(), "pfm_rgb_be",
        (20, 30))
    # Sun raster: cv2's 24- and 8-bit, and by hand 1, 8 (with maps) and 32 bits
    odd = cv2.resize(bgr, (41, 30), interpolation=cv2.INTER_AREA)
    files["sunras_24_30x41.ras"] = (cv2.imencode(".ras", odd)[1].tobytes(), "sunras_24",
                                    (30, 41))
    files["sunras_8_30x41.ras"] = (
        cv2.imencode(".ras", cv2.cvtColor(odd, cv2.COLOR_BGR2GRAY))[1].tobytes(), "sunras_8",
        (30, 41))
    index = cv2.resize(grey, (41, 30)) // 32
    files["sunras_8map_30x41.ras"] = (
        sun_raster(41, 30, 8, sun_rows(index, 8), rng.integers(0, 256, (8, 3))),
        "sunras_8map", (30, 41))
    files["sunras_1map_30x43.ras"] = (
        sun_raster(43, 30, 1, sun_rows(cv2.resize(grey, (43, 30)) > 110, 1),
                   [[20, 40, 200], [250, 230, 10]]), "sunras_1map", (30, 43))
    xbgr = np.concatenate([rng.integers(0, 256, (30, 41, 1)), odd], 2).astype(np.uint8)
    files["sunras_32_30x41.ras"] = (sun_raster(41, 30, 32, sun_rows(xbgr, 32)), "sunras_32",
                                    (30, 41))
    # Radiance HDR: cv2's run-length file, and a flat one under #?RGBE
    radiance = (scene(30, 40, 83).astype(np.float32) / 255) ** 2 * 3
    files["hdr_rle_30x40.hdr"] = (cv2.imencode(".hdr", radiance[:, :, ::-1].copy())[1]
                                  .tobytes(), "hdr_rle", (30, 40))
    rgbe = rng.integers(0, 256, (30, 7, 4), dtype=np.uint8)
    rgbe[:, :, 3] = rng.choice([0, 128, 130, 134, 136, 137], (30, 7))
    files["hdr_flat_30x7.hdr"] = (
        b"#?RGBE\n# a comment\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=1.0\n\n-Y 30 +X 7\n"
        + rgbe.tobytes(), "hdr_flat", (30, 7))
    # GIF: the 720p timing file, Pillow's interlaced, transparent and
    # animated files, a frame off the screen's corner, cv2's own
    big = Image.fromarray(scene(720, 1280, 30, noise=0.0)).quantize(256)
    files["gif_720x1280.gif"] = (pil_gif([big]), "gif_720p", (720, 1280))
    pal = Image.fromarray(scene(60, 80, 84)).quantize(32)
    files["gif_interlaced_60x80.gif"] = (
        pil_gif([pal], interlace=True, transparency=5, background=3), "gif_interlaced",
        (60, 80))
    movie = [Image.fromarray(scene(48, 64, s)).quantize(16) for s in (85, 86, 87)]
    files["gif_animated_48x64.gif"] = (pil_gif(movie, duration=100, loop=0),
                                        "gif_animated", (48, 64))
    sub = (cv2.resize(grey, (35, 25)) // 16).astype(np.uint8)
    files["gif_offset_45x60.gif"] = (
        gif_file(60, 45, [dict(index=sub, x=15, y=10, transparent=0, disposal=2,
                                min_size=4, colours=rng.integers(0, 256, (16, 3))),
                           dict(index=sub[::-1])],
                 colours=rng.integers(0, 256, (16, 3)), background=7),
        "gif_offset", (45, 60))
    files["gif_cv2_48x64.gif"] = (cv2.imencode(".gif", bgr)[1].tobytes(), "gif_cv2",
                                    (48, 64))
    # TIFF: the 720p timing file (LZW, predictor 2), Pillow's codecs and
    # modes through its libtiff, and by hand tiles, planes, MM and BigTIFF
    smooth = scene(720, 1280, 30, noise=0.0)
    files["tiff_lzw_pred2_720x1280.tif"] = (
        pil_tiff(smooth, compression="tiff_lzw", tiffinfo={317: 2}), "tiff_720p", (720, 1280))
    rgb = scene(48, 64, 88)
    files["tiff_raw_48x64.tif"] = (pil_tiff(rgb), "tiff_raw", (48, 64))
    files["tiff_deflate_48x64.tif"] = (pil_tiff(rgb, compression="tiff_adobe_deflate"),
                                       "tiff_deflate", (48, 64))
    files["tiff_jpeg_48x64.tif"] = (pil_tiff(rgb, compression="jpeg", quality=85),
                                    "tiff_jpeg", (48, 64))
    files["tiff_cmyk_lzw_48x64.tif"] = (pil_tiff(rgb, "CMYK", compression="tiff_lzw"),
                                        "tiff_cmyk", (48, 64))
    alpha = np.concatenate([rgb, (np.arange(64) * 255 // 63)[None, :, None].repeat(48, 0)],
                           2).astype(np.uint8)
    files["tiff_rgba_48x64.tif"] = (pil_tiff(alpha, compression="tiff_deflate"),
                                    "tiff_rgba", (48, 64))
    deep16 = (cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(np.uint16) * 257
              + rng.integers(0, 256, (48, 64)).astype(np.uint16))
    files["tiff_grey16_packbits_48x64.tif"] = (
        tiff_file(deep16, bits=16, compression=32773, rows_per_strip=16), "tiff_grey16",
        (48, 64))
    files["tiff_group4_121x163.tif"] = (
        pil_tiff(cv2.resize(grey, (163, 121)) > 120, compression="group4"), "tiff_group4",
        (121, 163))
    cmap = rng.integers(0, 65536, 48)
    files["tiff_palette4_lzw_48x64.tif"] = (
        tiff_file(cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) // 16, bits=4, photometric=3,
                  compression=5, rows_per_strip=20, tags={320: (3, cmap.tolist())}),
        "tiff_palette", (48, 64))
    files["tiff_tiles_planar_mm_48x64.tif"] = (
        tiff_file(rgb, compression=8, predictor=2, tile=(32, 48), planar=2, order=">"),
        "tiff_tiled", (48, 64))
    files["tiff_orientation6_37x53.tif"] = (
        tiff_file(scene(37, 53, 89), compression=5, tags={274: (3, [6])}),
        "tiff_orientation", (53, 37))
    files["bigtiff_packbits_30x40.tif"] = (
        tiff_file(colour60[:, :, ::-1], compression=32773, rows_per_strip=7, big=True),
        "tiff_bigtiff", (30, 40))
    return files


def build() -> dict[str, tuple[bytes, str, tuple | None]]:
    """{file name: (bytes, kind, decoded (h, w) or None)}"""
    import cv2

    files = {}
    for i in range(3):
        files[f"frame{i}_720x1280_420_q90.jpg"] = (
            jpeg(scene(720, 1280, i), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
            "jpeg_720p", (720, 1280))
    small = scene(240, 320, 10)
    files["s444_240x320.jpg"] = (jpeg(small, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                                 "jpeg_444", (240, 320))
    files["s422_240x320.jpg"] = (jpeg(small, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                                 "jpeg_422", (240, 320))
    files["grey_240x320.jpg"] = (jpeg(cv2.cvtColor(small, cv2.COLOR_RGB2GRAY), 90),
                                 "jpeg_grey", (240, 320))
    files["restart4_240x320.jpg"] = (
        jpeg(scene(240, 320, 11), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             IMWRITE_JPEG_RST_INTERVAL=4), "jpeg_restart", (240, 320))
    files["odd_333x517.jpg"] = (jpeg(scene(333, 517, 12), 90), "jpeg_odd", (333, 517))
    base = jpeg(scene(200, 300, 13), 90)
    files["exif6_200x300.jpg"] = (with_exif(base, 6), "jpeg_exif", (300, 200))
    files["exif3_200x300.jpg"] = (with_exif(base, 3), "jpeg_exif", (200, 300))
    progressive = jpeg(scene(240, 320, 14), 90, IMWRITE_JPEG_PROGRESSIVE=1)
    files["progressive_240x320.jpg"] = (progressive, "jpeg_progressive", (240, 320))
    files["progressive_720x1280_420_q90.jpg"] = (
        jpeg(scene(720, 1280, 18), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             IMWRITE_JPEG_PROGRESSIVE=1), "jpeg_progressive_720p", (720, 1280))
    files["progressive_4of10_240x320.jpg"] = (
        cut_after_scans(progressive, 4), "jpeg_progressive_early", (240, 320))
    colour = scene(120, 160, 19)
    cmyk = np.concatenate([255 - colour, np.minimum(colour.min(2, keepdims=True), 60)], 2)
    files["cmyk_120x160.jpg"] = (pil_jpeg(cmyk, "CMYK", quality=90), "jpeg_cmyk", (120, 160))
    files["ycck_120x160.jpg"] = (with_adobe_transform(pil_jpeg(cmyk, "CMYK", quality=90), 2),
                                 "jpeg_ycck", (120, 160))
    files["adobe_rgb_120x160.jpg"] = (pil_jpeg(colour, "RGB", quality=90, keep_rgb=True),
                                      "jpeg_rgb", (120, 160))
    full = jpeg(scene(240, 320, 15), 90)
    files["truncated_240x320.jpg"] = (full[:len(full) * 3 // 5], "jpeg_truncated", None)
    # truncated JPEGs the integrity scan restores (restored_sha256): a
    # baseline 4:2:0 one with EXIF orientation 6, a progressive one cut
    # inside the header of its sixth scan, a grey one
    exif6 = with_exif(jpeg(scene(200, 300, 23), 90), 6)
    files["truncated_exif6_200x300.jpg"] = (exif6[:len(exif6) * 2 // 3], "jpeg_truncated",
                                            None)
    files["truncated_progressive_240x320.jpg"] = (
        progressive[:jpeg_scans(progressive)[5] + 7], "jpeg_truncated", None)
    grey = jpeg(cv2.cvtColor(scene(240, 320, 24), cv2.COLOR_RGB2GRAY), 90)
    files["truncated_grey_240x320.jpg"] = (grey[:len(grey) * 3 // 4], "jpeg_truncated",
                                           None)
    # Huffman tables left to libjpeg's standard ones: a 720p frame without
    # any DHT (Motion-JPEG), and a frame with an optimised slot 0 and no slot 1
    files["nodht_720x1280_420_q90.jpg"] = (
        without_tables(jpeg(scene(720, 1280, 25), 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)),
        "jpeg_no_dht", (720, 1280))
    files["stdslot1_240x320.jpg"] = (optimised_luma_only(scene(240, 320, 26)),
                                     "jpeg_std_slot1", (240, 320))
    ok, png = cv2.imencode(".png", cv2.cvtColor(scene(120, 160, 16, noise=1.0),
                                                cv2.COLOR_RGB2BGR))
    assert ok
    files["rgb_120x160.png"] = (png.tobytes(), "png_rgb", (120, 160))
    rng = np.random.default_rng(17)
    index = (scene(120, 160, 17, noise=0.0)[:, :, 0] // 16).astype(np.uint8)
    files["palette_120x160.png"] = (palette_png(index, rng.integers(0, 256, (16, 3))),
                                    "png_palette", (120, 160))
    bmp_scene = scene(120, 160, 20, noise=1.0)
    ok, bmp24 = cv2.imencode(".bmp", cv2.cvtColor(bmp_scene, cv2.COLOR_RGB2BGR))
    assert ok
    files["rgb24_120x160.bmp"] = (bmp24.tobytes(), "bmp_24", (120, 160))
    grid = (scene(120, 160, 21, noise=0.0)[:, :, 1] // 16).astype(np.uint8)
    pal16 = rng.integers(0, 256, (16, 3))
    files["palette8_120x160.bmp"] = (
        bmp_file(160, 120, 8, bmp_rows(grid * 3, 8), np.concatenate(
            [pal16, rng.integers(0, 256, (240, 3))])), "bmp_palette8", (120, 160))
    files["palette4_120x160.bmp"] = (bmp_file(160, 120, 4, bmp_rows(grid, 4), pal16),
                                     "bmp_palette4", (120, 160))
    noisy = grid.copy()   # a band of noise, for absolute runs
    noisy[50:54] = np.random.default_rng(22).integers(0, 16, (4, 160))
    files["rle8_120x160.bmp"] = (
        bmp_file(160, 120, 8, rle8(noisy, (7, 40, 90)), pal16, compression=1),
        "bmp_rle8", (120, 160))
    bgr = cv2.cvtColor(scene(240, 320, 60), cv2.COLOR_RGB2BGR)
    files["lossy_240x320.webp"] = (
        cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes(),
        "webp_lossy", (240, 320))
    small = cv2.cvtColor(scene(120, 160, 61), cv2.COLOR_RGB2BGR)
    lossless = cv2.imencode(".webp", small)[1].tobytes()
    files["lossless_120x160.webp"] = (lossless, "webp_lossless", (120, 160))
    files["lossless_240x320.webp"] = (
        cv2.imencode(".webp", cv2.cvtColor(scene(240, 320, 66, noise=1.0),
                                           cv2.COLOR_RGB2BGR))[1].tobytes(),
        "webp_lossless", (240, 320))
    alpha = np.concatenate([small, (np.arange(160)[None, :, None] * 3 % 256).repeat(
        120, 0).astype(np.uint8)], 2)
    files["alpha_120x160.webp"] = (
        cv2.imencode(".webp", alpha, [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes(),
        "webp_alpha", (120, 160))
    files["exif6_120x160.webp"] = (webp_with(lossless, exif=exif_tiff(6)), "webp_exif",
                                   (160, 120))
    movie = cv2.Animation()
    movie.frames = [cv2.cvtColor(scene(96, 128, s), cv2.COLOR_RGB2BGR) for s in (62, 63, 64)]
    movie.durations = [100, 100, 100]
    files["animated_96x128.webp"] = (cv2.imencodeanimation(".webp", movie)[1].tobytes(),
                                     "webp_animated", (96, 128))
    # one colour at 2048x2048, lossy: a 7.5 KB body that the plain decoder
    # takes seconds over (the server's host-decode pool)
    files["large_2048x2048.webp"] = (
        libwebp_encode(np.full((2048, 2048, 3), (90, 140, 200), np.uint8), 75),
        "webp_large", (2048, 2048))
    files["simple4_240x320.webp"] = (
        libwebp_encode(scene(240, 320, 65), 80, filter_type=0, filter_strength=60,
                       partitions=2, segments=4, method=0), "webp_simple", (240, 320))
    # arithmetic-coded and lossless JPEGs from libjpeg's own encoder, small
    # and odd-sized (the plain decoder's arithmetic decoder and lossless
    # walk are Python loops), and the frames cv2 refuses
    a = scene(117, 163, 70)
    for name, kw in (("grey", dict(pixels=a[:, :, 1])), ("444", dict(sampling=[(1, 1)] * 3)),
                     ("420_rst3", dict(restart=3)), ("progressive", dict(progressive=True)),
                     ("dac", dict(dac={"L": [2, 1], "U": [5, 3], "K": [2, 30]}))):
        files[f"arith_{name}_117x163.jpg"] = (
            libjpeg_encode(kw.pop("pixels", a), 90, arith=True, **kw), "jpeg_arith", (117, 163))
    cut = libjpeg_encode(scene(117, 163, 71), 90, arith=True)
    files["arith_noeoi_117x163.jpg"] = (cut[:-2], "jpeg_arith_no_eoi", None)
    b = scene(117, 163, 72)
    for name, kw in (("p1", dict(lossless=(1, 0))), ("p4_pt2", dict(lossless=(4, 2))),
                     ("p6_rst", dict(lossless=(6, 0), restart_rows=16)),
                     ("p7", dict(lossless=(7, 0)))):
        files[f"lossless_{name}_117x163.jpg"] = (libjpeg_encode(b, **kw), "jpeg_lossless",
                                                 (117, 163))
    files["lossless_grey_117x163.jpg"] = (libjpeg_encode(b[:, :, 0], lossless=(1, 0)),
                                          "jpeg_lossless_grey", None)
    files["refused_12bit_117x163.jpg"] = (
        libjpeg_encode(b.astype(np.int16) * 16, precision=12), "jpeg_refused", None)
    files["refused_sof11_117x163.jpg"] = (
        libjpeg_encode(b, lossless=(1, 0)).replace(b"\xff\xc3", b"\xff\xcb", 1),
        "jpeg_refused", None)
    files.update(image_kinds())
    from torch_jp2_samples import jp2_files

    files.update(jp2_files())
    return files


# the kinds whose manifest entry carries cv2's pixels (rgb_sha256): the
# card's machine has no cv2 to compare them with
HASHED_JPEGS = ("jpeg_arith", "jpeg_lossless")
IMAGE_KINDS = ("pxm", "pfm", "sunras", "hdr", "gif", "tiff", "jp2")


def rgb_sha256(data: bytes) -> str:
    """sha256 of cv2.imdecode(IMREAD_COLOR) + BGR2RGB of `data`, C order."""
    import cv2

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return hashlib.sha256(np.ascontiguousarray(bgr[:, :, ::-1]).tobytes()).hexdigest()


def restored_sha256(data: bytes) -> str:
    """sha256 of the file the JAX package's integrity scan (_check_img:
    PIL's truncated read, exif_transpose, save at quality 100 4:4:4)
    writes over a copy of `data`."""
    import tempfile

    from vision_kit_tpu.data.datasets import YOLODataset

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cut.jpg")
        with open(path, "wb") as f:
            f.write(data)
        assert YOLODataset._check_img(path) is None
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()


def write(out_dir: str = SAMPLES) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"files": {}}
    for name, (data, kind, shape) in build().items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        manifest["files"][name] = {
            "sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
            "kind": kind, "shape": list(shape) if shape else None}
        if shape and (kind.startswith(("webp", *IMAGE_KINDS)) or kind in HASHED_JPEGS):
            manifest["files"][name]["rgb_sha256"] = rgb_sha256(data)   # the card has no cv2
        if kind in ("jpeg_truncated", "jpeg_arith_no_eoi"):   # nor PIL
            manifest["files"][name]["restored_sha256"] = restored_sha256(data)
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    m = write()
    total = sum(v["bytes"] for v in m["files"].values())
    print(f"{len(m['files'])} files, {total} bytes in {SAMPLES}")
