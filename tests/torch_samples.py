"""The encoded sample images of vision_kit_tpu_torch/data/samples/.

The card's machine has no image encoder, so the port's decode and serving
checks there read encoded bytes from the repository. They are written here
with cv2 (the palette PNG, which cv2 does not write, with zlib) from seeded
smooth synthetic scenes, and listed in MANIFEST.json with each file's
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
    files["progressive_240x320.jpg"] = (
        jpeg(scene(240, 320, 14), 90, IMWRITE_JPEG_PROGRESSIVE=1),
        "jpeg_progressive", None)
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
