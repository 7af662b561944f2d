"""data/encode.py:encode_webp, the lossless (VP8L) WebP writer of the
demo's .webp output: each file decodes to its input bit for bit in
cv2.imdecode and in the port's data/webp.py, on the committed samples'
pixels, a flat image, noise, thin and 1x1 images; its container and
header are VP8L's; and its size beside cv2.imencode('.webp')'s (libwebp's
method-4 lossless encoder), which it does not copy byte for byte."""

from __future__ import annotations

import os
import struct

import cv2
import numpy as np
import pytest

import torch_samples as ts
from vision_kit_tpu_torch.data import decode, webp
from vision_kit_tpu_torch.data.encode import encode_webp

SAMPLE_NAMES = ["odd_333x517.jpg", "s444_240x320.jpg", "palette_120x160.png",
                "rle8_120x160.bmp", "lossless_120x160.webp", "arith_444_117x163.jpg",
                "lossless_p4_pt2_117x163.jpg", "exif6_200x300.jpg"]


def images():
    rng = np.random.default_rng(3)
    out = {name: decode.decode_image(open(os.path.join(ts.SAMPLES, name), "rb").read())
           for name in SAMPLE_NAMES}
    out.update({
        "flat": np.full((70, 90, 3), (12, 200, 77), np.uint8),
        "noise": rng.integers(0, 256, (61, 83, 3), dtype=np.uint8),
        "1x1": np.array([[[250, 3, 128]]], np.uint8),
        "1x40": rng.integers(0, 256, (1, 40, 3), dtype=np.uint8),
        "33x1": rng.integers(0, 256, (33, 1, 3), dtype=np.uint8),
        "stripes": np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 19, 0).repeat(3, 2),
        "scene": ts.scene(97, 131, 5),
    })
    return out


IMAGES = images()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_round_trips_bit_for_bit(name):
    rgb = IMAGES[name]
    data = encode_webp(rgb)
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(bgr[:, :, ::-1], rgb)
    got, orientation = webp.decode_webp(data)
    np.testing.assert_array_equal(got, rgb)
    assert orientation == 1
    np.testing.assert_array_equal(decode.decode_image(data), rgb)


def test_container_header_and_size():
    """RIFF/WEBP around one VP8L chunk: the signature 0x2f, 14-bit width
    and height minus one, no alpha, version 0; an odd chunk is padded. The
    size lies within 1.5x of libwebp's (cv2.imencode('.webp')) on a scene,
    as the encoder's simpler choices cost."""
    rgb = IMAGES["scene"]
    data = encode_webp(rgb)
    assert data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8L"
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    size = struct.unpack("<I", data[16:20])[0]
    assert len(data) == 20 + size + size % 2
    bits = int.from_bytes(data[21:25], "little")
    assert data[20] == 0x2F
    assert (bits & 0x3FFF, (bits >> 14) & 0x3FFF, (bits >> 28) & 1, bits >> 29) == (130, 96, 0, 0)
    libwebp = cv2.imencode(".webp", rgb[:, :, ::-1].copy())[1]
    assert len(data) < 1.5 * len(libwebp)


def test_refuses_what_vp8l_cannot_hold():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8),
                np.zeros((1, 16385, 3), np.uint8)):
        with pytest.raises(ValueError):
            encode_webp(bad)
