"""The port's image decode and letterbox against cv2 and the JAX package.

vision_kit_tpu_torch/data/decode.py:decode_image must equal
cv2.imdecode(IMREAD_COLOR) + BGR2RGB bit for bit on the JPEG and PNG kinds
it takes, and give None on the ones it refuses; ops/letterbox.py:
letterbox_u8 must equal vision_kit_tpu/ops/letterbox.py:letterbox_np (cv2's
resize and border) bit for bit, with the same ratio and pad. The samples the
card reads (data/samples/) are checked against their manifest and cv2.
"""

import hashlib
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vision_kit_tpu.ops.letterbox import letterbox_np
from vision_kit_tpu_torch.data.decode import (
    apply_orientation,
    decode_image,
    jpeg_header,
    jpeg_refusal,
)
from vision_kit_tpu_torch.ops.letterbox import letterbox_u8
from fixture_lib import build_rectangle_dataset
from torch_samples import SAMPLES, jpeg, palette_png, scene, with_exif

torch.set_num_threads(2)

SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}


def cv2_rgb(data: bytes):
    if not data:
        return None
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_decodes_like_cv2(data: bytes):
    got, want = decode_image(data), cv2_rgb(data)
    assert want is not None, "cv2 refused the bytes"
    assert got is not None, "the plain decoder refused bytes cv2 decodes"
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def encode(rgb, quality=90, sampling="420", restart=0, **flags):
    if sampling == "grey":
        rgb = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        return jpeg(rgb, quality, IMWRITE_JPEG_RST_INTERVAL=restart, **flags)
    return jpeg(rgb, quality, SAMPLING[sampling], IMWRITE_JPEG_RST_INTERVAL=restart,
                **flags)


# -- JPEG ------------------------------------------------------------------


def test_fixture_dataset_jpegs_decode_like_cv2(tmp_path):
    build_rectangle_dataset(str(tmp_path))
    files = sorted((tmp_path / "images" / "train").glob("*.jpg"))
    assert len(files) == 12
    for path in files:
        assert_decodes_like_cv2(path.read_bytes())


@settings(max_examples=25, derandomize=True, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), quality=st.integers(10, 100),
       sampling=st.sampled_from(["444", "422", "420", "grey"]),
       restart=st.sampled_from([0, 1, 3]), seed=st.integers(0, 2**16))
def test_jpeg_sweep_decodes_like_cv2(h, w, quality, sampling, restart, seed):
    assert_decodes_like_cv2(encode(scene(h, w, seed), quality, sampling, restart))


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411", "grey"])
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (17, 33), (61, 47)])
def test_jpeg_samplings_and_edges_decode_like_cv2(sampling, hw):
    for quality, restart in ((20, 0), (95, 2)):
        assert_decodes_like_cv2(encode(scene(*hw, seed=hw[0]), quality, sampling,
                                       restart))


def test_jpeg_720p_decodes_like_cv2():
    assert_decodes_like_cv2(encode(scene(720, 1280, 3), 90, "420"))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("endian", ["<", ">"])
def test_exif_orientations_like_cv2(orientation, endian):
    data = encode(scene(24, 40, 5), 90, "420")
    if endian == "<":
        data = with_exif(data, orientation)
    else:   # a big-endian TIFF header
        tiff = (b"MM\0*" + struct.pack(">I", 8) + struct.pack(">H", 1)
                + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
                + struct.pack(">I", 0))
        app1 = b"Exif\0\0" + tiff
        data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]
    assert jpeg_header(data)["orientation"] == orientation
    assert_decodes_like_cv2(data)


def test_apply_orientation_is_cv2s_transform():
    img = np.arange(2 * 3 * 1, dtype=np.uint8).reshape(2, 3, 1)
    want = {1: img, 2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1],
            5: img.transpose(1, 0, 2), 6: img.transpose(1, 0, 2)[:, ::-1],
            7: img.transpose(1, 0, 2)[::-1, ::-1], 8: img.transpose(1, 0, 2)[::-1]}
    for o, w in want.items():
        np.testing.assert_array_equal(apply_orientation(torch.from_numpy(img), o).numpy(), w)


def test_refused_kinds_and_junk_give_none():
    """A progressive JPEG decodes; the same bytes marked arithmetic-coded
    lossless (SOF11) or hierarchical (SOF5, SOF13), which libjpeg-turbo
    does not decode, are refused, as cv2 refuses them; junk gives None on
    both."""
    data = encode(scene(40, 56, 6), 90, "420", IMWRITE_JPEG_PROGRESSIVE=1)
    assert_decodes_like_cv2(data)
    assert jpeg_refusal(jpeg_header(data)) is None
    sof = data.index(b"\xff\xc2")
    for marker, name in ((0xCB, "SOF11"), (0xC5, "SOF5"), (0xCD, "SOF13")):
        patched = data[:sof + 1] + bytes([marker]) + data[sof + 2:]
        assert decode_image(patched) is None and cv2_rgb(patched) is None
        assert jpeg_refusal(jpeg_header(patched)).startswith(name)
    for junk in (b"", b"garbage", b"\xff\xd8", b"\xff\xd8\xff", bytes(100),
                 b"\x89PNG\r\n\x1a\n"):
        assert decode_image(junk) is None
        assert cv2_rgb(junk) is None


def test_truncated_jpegs_like_cv2():
    """Bytes that end inside the scan: cv2 gives None (libjpeg suspends for
    more input), so does the plain decoder. Cut and closed by an EOI marker:
    libjpeg reads the missing bits as zeros, finishes the MCU where they ran
    out and leaves the rest grey, and the plain decoder does the same."""
    data = encode(scene(64, 96, 7), 90, "420")
    for cut in (len(data) // 3, len(data) // 2, len(data) - 3):
        assert cv2_rgb(data[:cut]) is None
        assert decode_image(data[:cut]) is None
        assert_decodes_like_cv2(data[:cut] + b"\xff\xd9")
    rst = encode(scene(64, 96, 8), 90, "420", restart=2)
    for cut in (len(rst) // 3, len(rst) // 2):
        assert decode_image(rst[:cut]) is None and cv2_rgb(rst[:cut]) is None
        assert_decodes_like_cv2(rst[:cut] + b"\xff\xd9")


# -- PNG -------------------------------------------------------------------


def png(samples, ctype, depth):
    """cv2's PNG for grey, RGB and RGBA; grey + alpha (which cv2 does not
    write) by hand, filter type 0."""
    if ctype in (0, 2, 6):
        src = samples if ctype == 0 else cv2.cvtColor(
            samples, cv2.COLOR_RGB2BGR if ctype == 2 else cv2.COLOR_RGBA2BGRA)
        ok, enc = cv2.imencode(".png", src)
        assert ok
        return enc.tobytes()
    h, w, c = samples.shape
    raw = b"".join(b"\0" + r.tobytes() for r in samples.reshape(h, w * c))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["grey", "rgb", "palette", "grey_alpha", "rgba",
                                  "rgb16", "grey16"])
def test_png_colour_types_like_cv2(kind):
    rgb = scene(21, 34, 9)
    rng = np.random.default_rng(9)
    if kind == "grey":
        data = png(cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY), 0, 8)
    elif kind == "rgb":
        data = png(rgb, 2, 8)
    elif kind == "palette":
        data = palette_png(rgb[..., 0] // 32, rng.integers(0, 256, (8, 3)))
    elif kind == "grey_alpha":
        data = png(np.stack([rgb[..., 0], rgb[..., 1]], -1), 4, 8)
    elif kind == "rgba":
        data = png(np.concatenate([rgb, rgb[..., :1]], -1), 6, 8)
    elif kind == "rgb16":
        data = png(rgb.astype(np.uint16) * 257 + 77, 2, 16)
    else:
        data = png(cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(np.uint16) * 250, 0, 16)
    assert_decodes_like_cv2(data)


def test_png_exif_orientation_like_cv2():
    data = png(scene(10, 6, 10), 2, 8)
    tiff = (b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, 6, 0) + struct.pack("<I", 0))
    chunk = (struct.pack(">I", len(tiff)) + b"eXIf" + tiff
             + struct.pack(">I", zlib.crc32(b"eXIf" + tiff)))
    data = data[:33] + chunk + data[33:]
    assert decode_image(data).shape == (6, 10, 3)
    assert_decodes_like_cv2(data)


def test_png_corrupt_critical_chunk_gives_none():
    data = bytearray(png(scene(8, 8, 11), 2, 8))
    data[20] ^= 0xFF    # inside IHDR: its CRC no longer matches
    assert decode_image(bytes(data)) is None
    assert cv2_rgb(bytes(data)) is None


# -- the committed samples -------------------------------------------------


def _manifest():
    with open(os.path.join(SAMPLES, "MANIFEST.json")) as f:
        return json.load(f)["files"]


def test_samples_match_their_manifest():
    files = _manifest()
    on_disk = sorted(f for f in os.listdir(SAMPLES) if f != "MANIFEST.json")
    assert on_disk == sorted(files)
    total = 0
    for name, meta in files.items():
        with open(os.path.join(SAMPLES, name), "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == meta["sha256"], name
        assert len(data) == meta["bytes"], name
        total += len(data)
    assert total < 1_500_000
    kinds = {m["kind"] for m in files.values()}
    assert {"jpeg_720p", "jpeg_444", "jpeg_422", "jpeg_grey", "jpeg_restart",
            "jpeg_odd", "jpeg_exif", "jpeg_progressive", "png_rgb", "png_palette",
            "jpeg_truncated", "jpeg_progressive_720p", "jpeg_progressive_early",
            "jpeg_cmyk", "jpeg_ycck", "jpeg_rgb", "bmp_24", "bmp_palette8",
            "bmp_palette4", "bmp_rle8"} <= kinds


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_sample_decodes_like_cv2(name):
    meta = _manifest()[name]
    with open(os.path.join(SAMPLES, name), "rb") as f:
        data = f.read()
    got = decode_image(data)
    if meta["shape"] is None:    # cut mid-scan, or a frame cv2 refuses: None on both
        assert got is None and cv2_rgb(data) is None
    else:
        assert got.shape == (*meta["shape"], 3)
        assert_decodes_like_cv2(data)


# -- letterbox_u8 against letterbox_np -------------------------------------

LETTERBOX_SHAPES = [(720, 1280), (1080, 1920), (480, 640), (100, 100), (5, 7),
                    (333, 517), (1280, 1280), (1000, 3), (3, 1000), (640, 480),
                    (17, 1), (1, 29)]
# every (source, destination) pair whose resized image is not empty (cv2
# refuses a resize to zero width or height: (1000, 3) and (3, 1000) at 64)
LETTERBOX_CASES = [(hw, dst) for hw in LETTERBOX_SHAPES for dst in (64, 640)
                   if min(round(hw[0] * min(dst / hw[0], dst / hw[1])),
                          round(hw[1] * min(dst / hw[0], dst / hw[1]))) > 0]


@pytest.mark.parametrize("src_hw,dst", LETTERBOX_CASES)
def test_letterbox_u8_equals_letterbox_np(src_hw, dst):
    img = np.random.default_rng(sum(src_hw)).integers(0, 256, (*src_hw, 3), np.uint8)
    want, (w_ratio, w_pad) = letterbox_np(img, dst)
    got, (ratio, pad) = letterbox_u8(torch.from_numpy(img), dst)
    assert (ratio, pad) == (w_ratio, w_pad)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_letterbox_u8_identity_at_equal_size():
    img = np.random.default_rng(1).integers(0, 256, (64, 64, 3), np.uint8)
    got, (ratio, pad) = letterbox_u8(torch.from_numpy(img), 64)
    assert (ratio, pad) == (1.0, (0.0, 0.0))
    np.testing.assert_array_equal(got.numpy(), img)
