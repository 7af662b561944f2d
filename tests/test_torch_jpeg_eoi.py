"""JPEGs that lack their last bytes, with no marker after the scan: every
committed EOI-terminated JPEG, cut 1 to 16 bytes short, against
cv2.imdecode. libjpeg suspends for more input wherever its entropy
decoder reads past the bytes (OpenCV's source cannot refill, so cv2 gives
None), and a one-scan file whose decoder never does decodes whole:
decode._suspends models jdhuff.c's 64-bit bit buffer (decode_mcu_fast's
6-byte loads while 512 bytes a block are left, jpeg_fill_bit_buffer's
fills to 57 bits after), jdarith.c's byte reads and jdlhuff.c's fills.
frame1_720x1280_420_q90.jpg cut 1 or 2 bytes short is such a file. On the
card such a file takes the host route "host_cut", never nvJPEG."""

from __future__ import annotations

import json
import os

import cv2
import numpy as np
import pytest

import torch_samples as ts
from vision_kit_tpu_torch.data import decode

with open(os.path.join(ts.SAMPLES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)["files"]


def read(name: str) -> bytes:
    with open(os.path.join(ts.SAMPLES, name), "rb") as f:
        return f.read()


WHOLE = sorted(n for n in MANIFEST if n.endswith(".jpg") and read(n)[-2:] == b"\xff\xd9")


def cv2_rgb(data: bytes):
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    return None if bgr is None else bgr[:, :, ::-1]


@pytest.mark.parametrize("name", WHOLE)
def test_cut_1_to_16_bytes_short_gives_cv2s_answer(name):
    data = read(name)
    decoded = []
    for k in range(1, 17):
        cut = data[:-k]
        want, got = cv2_rgb(cut), decode.decode_image(cut)
        if want is None:
            assert got is None, f"{name} cut {k} short: the port decodes what cv2 refuses"
            continue
        assert got is not None, f"{name} cut {k} short: the port refuses what cv2 decodes"
        np.testing.assert_array_equal(got, want, err_msg=f"{name} cut {k} short")
        decoded.append(k)
    if name == "frame1_720x1280_420_q90.jpg":
        assert decoded == [1, 2]
        np.testing.assert_array_equal(decode.decode_image(data[:-2]),
                                      decode.decode_image(data))


def test_an_open_scan_takes_the_host_route():
    """A one-scan file that the bytes end inside routes to "host_cut" on the
    card from its header (whether libjpeg suspends is the decoder's to
    find), a multi-scan one is refused (libjpeg reads it to its EOI)."""
    frame = read("frame1_720x1280_420_q90.jpg")
    info = decode.jpeg_header(frame[:-2])
    assert info["open_scan"] and not info["eoi"]
    assert decode.decode_route(frame[:-2], "cuda", decode.scans_short) == "host_cut"
    assert decode.decode_route(frame[:-5], "cuda", decode.scans_short) == "host_cut"
    assert decode.decode_route(frame[:-2], "cpu") == "host_jpeg"
    progressive = read("progressive_240x320.jpg")
    assert decode.decode_route(progressive[:-2], "cuda", decode.scans_short) == "refused"


def test_suspension_model_on_a_hand_made_stream():
    """_suspends on codes whose fills are known: the slow path fills to 57
    bits, so 8 bytes carry a 57-bit fill and 7 do not; the fast path never
    suspends while its 512 bytes a block are left."""
    codes = [(8, 0)] * 7            # 56 bits, one 8-bit code an MCU
    starts = list(range(8))
    assert not decode._suspends(codes, starts, 8)
    assert decode._suspends(codes, starts, 7)
    assert not decode._suspends(codes, starts, 7, lambda read: 10 ** 6, 1)
