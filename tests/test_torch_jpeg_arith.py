"""Arithmetic-coded JPEGs (SOF9, SOF10; data/jpeg_arith.py through
data/decode.py) against cv2.imdecode bit for bit: the committed fixtures
(grey, 4:4:4, 4:2:0 with restarts, progressive 4:2:0, a DAC segment, one
without its EOI) at full size and at 1/2, 1/4 and 1/8; each cut at ten
points with and without an EOI after it (the decoder reads zeros past a
marker, and the IDCTs wrap and saturate as libjpeg-turbo's SIMD code on
the garbage that gives); the QM coder's state table against libjpeg's own;
DAC conditioning; probe_jpeg against the JAX package's _probe_jpeg; the
route."""

from __future__ import annotations

import json
import os

import cv2
import numpy as np
import pytest

import torch_samples as ts
from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu_torch.data import decode, jpeg_arith

FLAGS = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
         8: cv2.IMREAD_REDUCED_COLOR_8}
with open(os.path.join(ts.SAMPLES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)["files"]
NAMES = sorted(n for n, m in MANIFEST.items() if m["kind"].startswith("jpeg_arith"))
DECODED = [n for n in NAMES if MANIFEST[n]["shape"] is not None]
CUTS = np.linspace(0.05, 0.98, 10)


def read(name: str) -> bytes:
    with open(os.path.join(ts.SAMPLES, name), "rb") as f:
        return f.read()


def cv2_rgb(data: bytes, scale: int = 1):
    """cv2.imdecode at 1/scale as RGB, None where cv2 refuses (None or an
    exception)."""
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[scale])
    except cv2.error:
        return None
    return None if bgr is None else bgr[:, :, ::-1]


def port_rgb(data: bytes, scale: int = 1):
    return decode.decode_image(data) if scale == 1 else decode.decode_jpeg_reduced(data, scale)


def assert_like_cv2(data: bytes, scale: int = 1, got=None, what: str = "") -> None:
    want = cv2_rgb(data, scale)
    got = port_rgb(data, scale) if got is None else got
    if want is None:
        assert got is None, f"{what} at 1/{scale}: the port decodes what cv2 refuses"
        return
    assert got is not None, f"{what} at 1/{scale}: the port refuses what cv2 decodes"
    np.testing.assert_array_equal(got, want, err_msg=f"{what} at 1/{scale}")


@pytest.fixture(scope="module")
def decoded():
    """Each fixture's full-size decode, once (the arithmetic decoder is a
    Python loop)."""
    return {name: decode.decode_image(read(name)) for name in NAMES}


def test_aritab_is_libjpegs():
    """The 114 (Qe, next LPS, next MPS, switch) states equal jaricom.c's
    jpeg_aritab, read from the libjpeg-turbo that Pillow bundles."""
    import ctypes

    table = (ctypes.c_long * 114).in_dll(ts._libjpeg(), "jpeg_aritab")
    libjpeg = [(v >> 16, v & 0x7F, (v >> 8) & 0xFF, (v >> 7) & 1) for v in table]
    assert [tuple(r) for r in jpeg_arith._ARITAB] == libjpeg


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_cv2_at_every_scale(name, decoded):
    """Full size and 1/2, 1/4, 1/8, bit for bit; the one without its EOI is
    refused by both (the decoder needs bytes past the end); the manifest's
    rgb_sha256 (the card's check) is cv2's."""
    data = read(name)
    assert_like_cv2(data, 1, decoded[name], name)
    for scale in (2, 4, 8):
        assert_like_cv2(data, scale, what=name)
    meta = MANIFEST[name]
    if meta["shape"] is not None:
        assert decoded[name].shape == (*meta["shape"], 3)
        assert meta["rgb_sha256"] == ts.rgb_sha256(data)
    else:
        assert decoded[name] is None


@pytest.mark.parametrize("name", DECODED)
def test_cuts_with_and_without_an_eoi_equal_cv2(name):
    """Each fixture cut at ten points: closed by an EOI (every scale; the
    scans decode from zeros past the marker), and bare (None on both: the
    decoder needs a byte past the end)."""
    data = read(name)
    for frac in CUTS:
        cut = data[:int(len(data) * frac)]
        for scale in (1, 2, 4, 8):
            assert_like_cv2(cut + b"\xff\xd9", scale, what=f"{name} cut at {frac:.2f} + EOI")
        assert_like_cv2(cut, what=f"{name} cut at {frac:.2f}")


def test_dac_conditioning_and_its_refusals():
    """The DAC fixture's conditioning values in the header (the defaults
    L 0, U 1, Kx 5 elsewhere); a DAC whose L exceeds U, or whose table is
    past 31, is refused as libjpeg's error exit refuses it."""
    info = decode.jpeg_header(read("arith_dac_117x163.jpg"))
    cond = info["conditioning"]
    assert (cond["L"][:3], cond["U"][:3], cond["K"][:3]) == ([2, 1, 0], [5, 3, 1], [2, 30, 5])
    plain = decode.jpeg_header(read("arith_444_117x163.jpg"))["conditioning"]
    assert plain == {"L": [0] * 16, "U": [1] * 16, "K": [5] * 16}
    data = read("arith_dac_117x163.jpg")
    at = data.index(b"\xff\xcc")
    for pair in (b"\x00\x12", b"\x20\x05"):   # L 2 > U 1; table 32
        bad = data[:at + 4] + pair + data[at + 6:]
        assert decode.decode_image(bad) is None and cv2_rgb(bad) is None, pair


def test_probe_equals_jax(tmp_path):
    """probe_jpeg reads SOF9 and SOF10 frames as the JAX package's
    _probe_jpeg does (the fast_decode gate)."""
    for name in NAMES:
        path = tmp_path / name
        path.write_bytes(read(name))
        assert decode.probe_jpeg(read(name)) == jax_ds._probe_jpeg(str(path)) == (117, 163,
                                                                                 False)


def test_route_is_host_arith():
    """Arithmetic-coded files decode on the host on every device
    ("host_arith": nvJPEG reads none), and decode_to counts them there."""
    before = decode.route_counts["host_arith"]
    for name in NAMES:
        data = read(name)
        assert decode.decode_route(data, "cuda", decode.scans_short) == "host_arith"
        assert decode.decode_route(data, "cpu") == "host_arith"
        got = decode.decode_to(data, "cpu")
        assert (got is None) == (MANIFEST[name]["shape"] is None)
    assert decode.route_counts["host_arith"] - before == len(NAMES)


def test_sequential_scan_parameters_are_a_warning():
    """A sequential arithmetic scan whose Ss/Se/Ah/Al are not 0/63/0/0 is
    decoded all the same (jdarith.c only warns), as cv2 decodes it."""
    data = read("arith_444_117x163.jpg")
    sos = data.index(b"\xff\xda")
    ns = data[sos + 4]
    at = sos + 5 + 2 * ns
    odd = data[:at] + bytes([1, 40, 0x01]) + data[at + 3:]
    assert_like_cv2(odd, what="Ss 1, Se 40, Al 1")
