"""The integrity scan's restore of a truncated JPEG against the JAX
package's _check_img on the CPU: the same files kept and dropped at every
cut point, and where kept, the same bytes written over the file (PIL's
LOAD_TRUNCATED_IMAGES read, ImageOps.exif_transpose, save at quality 100
4:4:4). Then the encoder stages it rests on against cv2.imencode and PIL's
save byte for byte, the committed samples' restored_sha256 (the card's
check), and the datasets after a restore (items equal JAX's, caches
rebuilt)."""

import hashlib
import io
import json
import logging
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from torch_samples import SAMPLES, jpeg_scans, pil_jpeg, scene
from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu_torch.data import datasets as port_ds
from vision_kit_tpu_torch.data import decode
from vision_kit_tpu_torch.data.encode import (SAMPLING_FACTOR_420, SAMPLING_FACTOR_444,
                                              encode_jpeg, encode_jpeg_cmyk)

torch.set_num_threads(2)

CUT_SAMPLES = ["odd_333x517.jpg", "progressive_240x320.jpg", "grey_240x320.jpg",
               "exif6_200x300.jpg", "cmyk_120x160.jpg", "ycck_120x160.jpg"]


def read(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def both(tmp_path, data: bytes) -> tuple:
    """((JAX's verdict, its file after), (the port's, its file after)) on
    two copies of `data`."""
    out = []
    for side, check in (("jax", jax_ds.YOLODataset._check_img),
                        ("port", lambda p: port_ds.check_image(p)[0])):
        path = tmp_path / f"{side}.jpg"
        path.write_bytes(data)
        out.append((check(str(path)), path.read_bytes()))
    return tuple(out)


def assert_same_restores(tmp_path, data: bytes, cuts) -> dict:
    counts = {"kept": 0, "dropped": 0}
    for c in cuts:
        (jv, jb), (pv, pb) = both(tmp_path, data[:c])
        assert (jv is None) == (pv is None), (c, jv, pv)
        assert pb == jb, c
        counts["kept" if jv is None else "dropped"] += 1
    return counts


@pytest.mark.parametrize("name", CUT_SAMPLES)
def test_restore_equals_jax_at_41_cuts(tmp_path, name):
    """41 cut points from the SOI to the last byte: the headers' cuts dropped
    by both, every other cut restored to JAX's bytes (EXIF orientation 6
    turned and dropped, grey as one component, CMYK and YCCK as Adobe CMYK)."""
    data = read(name)
    counts = assert_same_restores(tmp_path, data,
                                  np.linspace(2, len(data) - 1, 41).astype(int))
    assert counts["kept"] >= 35 and counts["dropped"] >= 2, counts


def test_restore_equals_jax_at_every_cut_of_a_progressive_file(tmp_path):
    """Pillow's optimised progressive file (a DHT before every scan) cut at
    every other byte after its first scan's header: cuts inside a later
    scan's header, a DHT between scans or a marker's two bytes leave libjpeg
    suspended before any row (Pillow's black image), cuts inside a scan
    give the scans before it."""
    rng = np.random.default_rng(3)
    img = np.kron(rng.integers(0, 255, (4, 6, 3), np.uint8), np.ones((8, 8, 1), np.uint8))
    data = pil_jpeg(img, "RGB", progressive=True, quality=90, optimize=True)
    first = jpeg_scans(data)[0]
    counts = assert_same_restores(tmp_path, data, range(first + 1, len(data) - 1, 2))
    assert counts["dropped"] > 0 and counts["kept"] > 100, counts


def test_restore_keeps_the_comment_and_drops_exif_and_icc(tmp_path):
    """A baseline file with EXIF (orientation 8), an ICC profile, two COMs
    and no EOI: JAX writes the last comment back and neither the EXIF nor
    the ICC; the port writes the same bytes."""
    base = pil_jpeg(scene(60, 90, 4), "RGB", quality=85, icc_profile=b"\0" * 300,
                    comment=b"first")
    tiff = (b"MM\0*\0\0\0\x08\0\x01" + b"\x01\x12\0\x03\0\0\0\x01\0\x08\0\0" + b"\0\0\0\0")
    app1 = b"Exif\0\0" + tiff
    data = (base[:2] + b"\xff\xe1" + len(app1 + b"..").to_bytes(2, "big") + app1
            + b"\xff\xfe\0\x08second" + base[2:-2])
    (jv, jb), (pv, pb) = both(tmp_path, data)
    assert jv is None and pv is None and pb == jb
    markers = [m for m, *_ in decode._walk(pb)]
    # "second" comes first in the file: the last COM, "first", is written
    assert 0xE1 not in markers and 0xE2 not in markers
    assert b"first" in pb and b"second" not in pb
    assert decode.jpeg_header(pb)["width"] == 60   # orientation 8 turned it


# arithmetic-coded and lossless files, and frames libjpeg decodes to
# nothing, which PIL opens all the same: JAX restores them too (zeros where
# libjpeg stops before any row)
NEW_KINDS = ["arith_420_rst3_117x163.jpg", "arith_progressive_117x163.jpg",
             "arith_grey_117x163.jpg", "lossless_p6_rst_117x163.jpg",
             "lossless_grey_117x163.jpg", "refused_sof11_117x163.jpg"]


@pytest.mark.parametrize("name", NEW_KINDS)
def test_arithmetic_and_lossless_cuts_restore_like_jax(tmp_path, name):
    """Each cut at ten points, kept or dropped as _check_img does and, where
    kept, rewritten to its bytes: an arithmetic-coded scan cannot wait for
    Pillow's EOI (rows before the iMCU row where it needed a byte past the
    cut, zeros after; none in a progressive file), a lossless one reads
    zeros past it (a grey one as "L"), SOF11 decodes to zeros."""
    data = read(name)
    counts = assert_same_restores(tmp_path, data, [int(len(data) * f) for f in
                                                   np.linspace(0.05, 0.98, 10)])
    assert counts["kept"] >= 8, counts


def test_frames_pil_keeps_whole_are_kept(tmp_path):
    """Whole files the port and cv2 give None for, which PIL opens (a grey
    lossless one, SOF11), are kept as JAX keeps them, untouched; a 12-bit
    one is dropped by both."""
    for name, kept in (("lossless_grey_117x163.jpg", True), ("refused_sof11_117x163.jpg", True),
                       ("refused_12bit_117x163.jpg", False)):
        data = read(name)
        (jv, jb), (pv, pb) = both(tmp_path, data)
        assert (jv is None) == (pv is None) == kept, (name, jv, pv)
        assert jb == pb == data


def test_what_pil_refuses_is_dropped_and_left_alone(tmp_path):
    """A cut before the first scan's data, a 12-bit frame and a
    two-component one: dropped by both, the file untouched."""
    data = read("s444_240x320.jpg")
    start = jpeg_scans(data)[0]
    for cut in (data[:start + 5], data[:20]):
        (jv, jb), (pv, pb) = both(tmp_path, cut)
        assert jv is not None and pv is not None and pb == jb == cut
    twelve = data[:start].replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1)
    (jv, _), (pv, pb) = both(tmp_path, twelve + data[start:-100])
    assert jv is not None and pv is not None and "12-bit" in pv
    sof = data.index(b"\xff\xc0")
    two = (data[:sof] + b"\xff\xc0\x00\x0e" + data[sof + 4:sof + 9] + b"\x02"
           + data[sof + 10:sof + 16] + data[sof + 19:start] + data[start:-100])
    (jv, _), (pv, pb) = both(tmp_path, two)
    assert jv is not None and pv is not None and "2 components" in pv and pb == two


@pytest.mark.parametrize("quality", [1, 50, 100])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_encoder_equals_cv2_and_pil(quality, sampling):
    """encode_jpeg at 4:4:4 and 4:2:0 against cv2.imencode, grey against
    cv2's (H, W) encode, on the odd 333x517 sample; at 4:4:4 also against
    PIL's save(subsampling=0), "RGB" and "L"; encode_jpeg_cmyk against
    PIL's "CMYK" save."""
    rgb = decode.decode_image(read("odd_333x517.jpg"))
    sf, flag = {"444": (SAMPLING_FACTOR_444, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                "420": (SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)}[sampling]
    _, want = cv2.imencode(".jpg", rgb[..., ::-1].copy(), [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    assert encode_jpeg(rgb, quality, sf) == want.tobytes()
    grey = rgb[..., 1].copy()
    _, want = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert encode_jpeg(grey, quality, sf) == want.tobytes()
    if sampling == "444":
        for arr, mode in ((rgb, "RGB"), (grey, "L")):
            assert encode_jpeg(arr, quality, sf) == pil_jpeg(arr, mode, quality=quality,
                                                             subsampling=0)
        cmyk = np.concatenate([rgb, grey[..., None]], 2)
        buf = io.BytesIO()
        Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=quality, subsampling=0)
        assert encode_jpeg_cmyk(255 - cmyk, quality) == buf.getvalue()
    with pytest.raises(ValueError, match="sampling_factor"):
        encode_jpeg(rgb, quality, 0x211111)


def test_committed_samples_restore_to_their_manifest():
    """Each truncated sample restores to restored_sha256, the bytes JAX's
    _check_img wrote (the card's check, where there is no PIL)."""
    with open(os.path.join(SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    cut = {n: m for n, m in files.items()
           if m["kind"] in ("jpeg_truncated", "jpeg_arith_no_eoi")}
    assert len(cut) == 5
    for name, meta in cut.items():
        got = port_ds.restore_truncated_jpeg(read(name))
        assert hashlib.sha256(got).hexdigest() == meta["restored_sha256"], name


def test_datasets_train_on_the_restored_files(tmp_path, caplog, monkeypatch):
    """A YOLO set holding the truncated samples: the port and JAX keep and
    rewrite the same files, every decoder and fast_decode setting reads
    the restored bytes (items equal JAX's), the log says which files were
    restored, and a disk image cache built before a file was cut again is
    rebuilt rather than serving its old pixels."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path
    names = sorted(n for n in os.listdir(SAMPLES) if n.startswith("truncated"))
    for root in ("port", "jax"):
        (tmp_path / root / "images").mkdir(parents=True)
        (tmp_path / root / "labels").mkdir()
        for i, name in enumerate(names + ["s444_240x320.jpg"]):
            (tmp_path / root / "images" / f"{i}.jpg").write_bytes(read(name))
            (tmp_path / root / "labels" / f"{i}.txt").write_text("0 0.5 0.5 0.3 0.3")
    with caplog.at_level(logging.WARNING, logger="vision_kit_tpu_torch"):
        got = port_ds.YOLODataset(str(tmp_path / "port"), img_size=96, device="cpu",
                                  cache_images="disk")
    assert sum("corrupt JPEG restored and saved" in r.message for r in caplog.records) == 4
    assert any("4 of them truncated JPEGs restored" in r.message for r in caplog.records)
    for fast in (False, True):
        want = jax_ds.YOLODataset(str(tmp_path / "jax"), img_size=96, fast_decode=fast)
        assert len(want) == len(got) == len(names) + 1
        for i in range(len(want)):
            assert (tmp_path / "port" / "images" / f"{i}.jpg").read_bytes() == (
                tmp_path / "jax" / "images" / f"{i}.jpg").read_bytes()
        for decoder in ("plain", "auto"):
            ds = got if (decoder, fast) == ("auto", False) else port_ds.YOLODataset(
                str(tmp_path / "port"), img_size=96, device="cpu", decoder=decoder,
                fast_decode=fast)
            for i in range(len(want)):
                np.testing.assert_array_equal(ds.pull_item(i)[0].numpy(), want.pull_item(i)[0])
    # the file cut again and the label cache gone: the scan restores it once
    # more, and the disk cache it invalidated serves the new pixels
    old = got.pull_item(0)[0].numpy().copy()
    (tmp_path / "port" / "images" / "0.jpg").write_bytes(read("s444_240x320.jpg")[:5000])
    for stale in (tmp_path / "port").glob(".vkt_labels_*"):
        stale.unlink()
    again = port_ds.YOLODataset(str(tmp_path / "port"), img_size=96, device="cpu",
                                cache_images="disk")
    plain = port_ds.YOLODataset(str(tmp_path / "port"), img_size=96, device="cpu")
    np.testing.assert_array_equal(again.pull_item(0)[0].numpy(), plain.pull_item(0)[0].numpy())
    assert not np.array_equal(again.pull_item(0)[0].numpy(), old)
