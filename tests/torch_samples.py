"""The encoded sample images of vision_kit_tpu_torch/data/samples/.

The card's machine has no image encoder, so the port's decode and serving
checks there read encoded bytes from the repository. They are written here
with cv2 from seeded smooth synthetic scenes; what cv2 does not write by
hand (the palette PNG with zlib, the 4-bit and RLE8 BMPs) or with PIL (the
CMYK and RGB JPEGs, the palette BMP). MANIFEST.json lists each file's
sha256, size, kind and the shape it decodes to (null where the decoders
refuse it). tests/test_torch_decode.py checks the manifest and each file
against cv2.imdecode.

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
    return files


def write(out_dir: str = SAMPLES) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"files": {}}
    for name, (data, kind, shape) in build().items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        manifest["files"][name] = {
            "sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
            "kind": kind, "shape": list(shape) if shape else None}
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    m = write()
    total = sum(v["bytes"] for v in m["files"].values())
    print(f"{len(m['files'])} files, {total} bytes in {SAMPLES}")
