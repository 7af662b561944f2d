"""Lossless JPEGs (SOF3; data/jpeg_lossless.py through data/decode.py)
against cv2.imdecode bit for bit: the committed fixtures (RGB with
predictors 1, 4 (point transform 2), 6 (restart intervals) and 7, and a
grey one, which cv2's IMREAD_COLOR refuses), at full size under every
reduced flag (libjpeg does not scale a lossless frame); every predictor
and point transform from libjpeg's encoder; the colour rule (libjpeg-turbo
converts no colour in lossless mode) on relabelled headers; each fixture
cut at ten points with and without an EOI; probe_jpeg and
_fast_decode_resized against the JAX package's; the route."""

from __future__ import annotations

import json
import os

import cv2
import numpy as np
import pytest
import torch

import torch_samples as ts
from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu_torch.data import datasets as port_ds
from vision_kit_tpu_torch.data import decode

FLAGS = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
         8: cv2.IMREAD_REDUCED_COLOR_8}
with open(os.path.join(ts.SAMPLES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)["files"]
NAMES = sorted(n for n, m in MANIFEST.items() if m["kind"].startswith("jpeg_lossless"))
CUTS = np.linspace(0.05, 0.98, 10)


def read(name: str) -> bytes:
    with open(os.path.join(ts.SAMPLES, name), "rb") as f:
        return f.read()


def cv2_rgb(data: bytes, scale: int = 1):
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS[scale])
    except cv2.error:
        return None
    return None if bgr is None else bgr[:, :, ::-1]


def assert_like_cv2(data: bytes, scale: int = 1, got=None, what: str = "") -> None:
    want = cv2_rgb(data, scale)
    if got is None:
        got = decode.decode_image(data) if scale == 1 else decode.decode_jpeg_reduced(data, scale)
    if want is None:
        assert got is None, f"{what} at 1/{scale}: the port decodes what cv2 refuses"
        return
    assert got is not None, f"{what} at 1/{scale}: the port refuses what cv2 decodes"
    np.testing.assert_array_equal(got, want, err_msg=f"{what} at 1/{scale}")


@pytest.fixture(scope="module")
def decoded():
    """Each fixture's decode, once."""
    return {name: decode.decode_image(read(name)) for name in NAMES}


def with_adobe(data: bytes, transform: int | None) -> bytes:
    """`data` (libjpeg's lossless output: an Adobe APP14 and no JFIF) with
    its Adobe transform byte set, or its APP14 dropped (None)."""
    at = data.index(b"\xff\xee")
    length = (data[at + 2] << 8) | data[at + 3]
    if transform is None:
        return data[:at] + data[at + 2 + length:]
    return data[:at + 15] + bytes([transform]) + data[at + 16:]


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_cv2_at_every_scale(name, decoded):
    """cv2's pixels at full size under IMREAD_COLOR and under every reduced
    flag; the grey file is refused under all of them, as cv2 refuses it."""
    data = read(name)
    assert_like_cv2(data, 1, decoded[name], name)
    for scale in (2, 4, 8):
        assert_like_cv2(data, scale, what=name)
        if decoded[name] is not None:
            assert decode.decode_jpeg_reduced(data, scale).shape == decoded[name].shape
    meta = MANIFEST[name]
    if meta["shape"] is None:
        assert decoded[name] is None
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE) is not None
    else:
        assert meta["rgb_sha256"] == ts.rgb_sha256(data)


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt", [0, 3])
def test_every_predictor_and_point_transform(psv, pt):
    """libjpeg's encoder at each predictor selection value 1-7 and point
    transform 0 and 3, on a noisy odd-sized scene, equal to cv2."""
    rgb = ts.scene(37, 53, 100 + psv, noise=6.0)
    assert_like_cv2(ts.libjpeg_encode(rgb, lossless=(psv, pt)), what=f"psv {psv} pt {pt}")


def test_colour_rule_and_sampling():
    """libjpeg-turbo's lossless mode converts no colour, so cv2's
    IMREAD_COLOR decodes an RGB frame (Adobe transform 0, or 'R','G','B'
    ids without Adobe or JFIF) and a CMYK one (through OpenCV's CMYK ->
    BGR), not a YCbCr (Adobe transform 1, or JFIF), YCCK or grey one.
    libjpeg's encoder writes the input's colour space at 1x1 whatever it
    is asked, so the subsampled file is the RGB one with its luma sampling
    rewritten to 2x2 (libjpeg replicates the chroma, no fancy filter)."""
    rgb = ts.scene(57, 71, 110)
    data = ts.libjpeg_encode(rgb, lossless=(1, 0))
    assert decode.jpeg_colour(decode.jpeg_header(data)) == "rgb"
    np.testing.assert_array_equal(decode.decode_image(data), rgb)   # lossless indeed
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    cases = {"RGB ids": with_adobe(data, None), "Adobe YCbCr": with_adobe(data, 1),
             "JFIF": data[:2] + jfif + with_adobe(data, None)[2:]}
    cmyk = ts.libjpeg_encode(np.concatenate([rgb, rgb[:, :, :1]], 2), lossless=(6, 0))
    cases.update({"CMYK": cmyk, "YCCK": with_adobe(cmyk, 2)})
    sof = data.index(b"\xff\xc3")
    cases["luma 2x2"] = data[:sof + 11] + b"\x22" + data[sof + 12:]
    want_none = {"Adobe YCbCr", "JFIF", "YCCK"}
    for what, blob in cases.items():
        assert_like_cv2(blob, what=what)
        assert (decode.decode_image(blob) is None) == (what in want_none), what
    grey = ts.libjpeg_encode(rgb[:, :, 1], lossless=(2, 1))
    assert decode.decode_image(grey) is None and cv2_rgb(grey) is None
    assert "lossless grey" in decode.jpeg_refusal(decode.jpeg_header(grey))
    assert decode.jpeg_refusal(decode.jpeg_header(grey), pillow=True) is None


@pytest.mark.parametrize("name", [n for n in NAMES if MANIFEST[n]["shape"] is not None])
def test_cuts_with_and_without_an_eoi_equal_cv2(name):
    """Each fixture cut at ten points: closed by an EOI (zero bits past the
    data for the row where they run out, mid grey after it), and bare
    (None on both: libjpeg suspends)."""
    data = read(name)
    for frac in CUTS:
        cut = data[:int(len(data) * frac)]
        assert_like_cv2(cut + b"\xff\xd9", what=f"{name} cut at {frac:.2f} + EOI")
        assert_like_cv2(cut, what=f"{name} cut at {frac:.2f}")


def test_bad_scan_parameters_are_refused():
    """A predictor outside 1-7 or a point transform past 7 is libjpeg's
    error exit (cv2 gives None); so is a restart interval that is not whole
    MCU rows."""
    data = read("lossless_p1_117x163.jpg")
    sos = data.index(b"\xff\xda")
    at = sos + 5 + 2 * data[sos + 4]
    for ss, ahal in ((0, 0), (8, 0), (1, 8)):
        bad = data[:at] + bytes([ss, 0, ahal]) + data[at + 3:]
        assert decode.decode_image(bad) is None and cv2_rgb(bad) is None, (ss, ahal)
    rst = read("lossless_p6_rst_117x163.jpg")
    dri = rst.index(b"\xff\xdd")
    odd = rst[:dri + 4] + (163 * 16 + 1).to_bytes(2, "big") + rst[dri + 6:]
    assert decode.decode_image(odd) is None and cv2_rgb(odd) is None


def test_probe_fast_decode_and_route(tmp_path, monkeypatch):
    """probe_jpeg equals JAX's _probe_jpeg; _fast_decode_resized falls back
    to the full decode as JAX's does (the reduced decode comes out at full
    size, which fails its shape check); the route is host_lossless on every
    device, refused for the grey file."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")
    for name in NAMES:
        data = read(name)
        path = tmp_path / name
        path.write_bytes(data)
        assert decode.probe_jpeg(data) == jax_ds._probe_jpeg(str(path)) == (117, 163, False)
        assert port_ds._fast_decode_resized(data, (48, 48), "cpu") is None
        assert jax_ds._fast_decode_resized(str(path), (48, 48)) is None
        want = "refused" if MANIFEST[name]["shape"] is None else "host_lossless"
        assert decode.decode_route(data, "cuda", decode.scans_short) == want
        assert decode.decode_route(data, "cpu") == want
    got = decode.decode_to(read("lossless_p7_117x163.jpg"), "cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (117, 163, 3)
