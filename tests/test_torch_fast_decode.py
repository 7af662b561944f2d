"""data.fast_decode in the port against cv2 and the JAX package on the CPU:
decode.probe_jpeg against the JAX package's _probe_jpeg, the reduced-scale
decode (decode.decode_jpeg_reduced) against cv2.imdecode's
IMREAD_REDUCED_COLOR_2/4/8 bit for bit over every sampling the decoder
takes, datasets._fast_decode_resized against the JAX one, and
YOLODataset(fast_decode=True) against the JAX dataset, item for item."""

import os

import cv2
import numpy as np
import pytest
import torch

from torch_samples import jpeg, scene, with_exif
from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu_torch.data import datasets as port_ds
from vision_kit_tpu_torch.data.decode import decode_jpeg_reduced, probe_jpeg

torch.set_num_threads(2)

SAMPLES = os.path.join(os.path.dirname(port_ds.__file__), "samples")
REDUCED = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
           8: cv2.IMREAD_REDUCED_COLOR_8}
SAMPLE_JPEGS = sorted(f for f in os.listdir(SAMPLES) if f.endswith(".jpg"))


def read(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def cv2_reduced(data: bytes, f: int) -> np.ndarray | None:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), REDUCED[f])
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def test_probe_equals_jax(tmp_path):
    """Every committed sample, a PNG, a missing file, EXIF, fill bytes
    before a marker, and a SOF past the first 256 KiB (None on both)."""
    paths = [os.path.join(SAMPLES, f) for f in sorted(os.listdir(SAMPLES))]
    base = jpeg(scene(40, 60, seed=3))
    app = b"\xff\xe2" + (65535).to_bytes(2, "big") + bytes(65533)
    cases = {
        "exif.jpg": with_exif(base, 6),
        "fill.jpg": base[:2] + b"\xff\xff\xff" + base[2:],
        "far_sof.jpg": base[:2] + app * 5 + base[2:],
        "near_sof.jpg": base[:2] + app * 3 + base[2:],
        "sos_first.jpg": base[:2] + b"\xff\xda\x00\x02" + base[2:],
        "short.jpg": base[:3],
    }
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    paths.append(str(tmp_path / "missing.jpg"))
    got_some = 0
    for path in paths:
        want = jax_ds._probe_jpeg(path)
        data = open(path, "rb").read() if os.path.exists(path) else b""
        assert probe_jpeg(data) == want, path
        got_some += want is not None
    assert probe_jpeg(cases["exif.jpg"]) == (40, 60, True)
    assert probe_jpeg(cases["far_sof.jpg"]) is None
    assert probe_jpeg(cases["near_sof.jpg"]) == (40, 60, False)
    assert got_some >= len(SAMPLE_JPEGS) + 3


def sampling_cases():
    small = scene(240, 320, 10)
    return {
        "frame0": read("frame0_720x1280_420_q90.jpg"),
        "s422": read("s422_240x320.jpg"),
        "s444": read("s444_240x320.jpg"),
        "grey": read("grey_240x320.jpg"),
        "odd_333x517": read("odd_333x517.jpg"),
        "restart4": read("restart4_240x320.jpg"),
        "s440": jpeg(small, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "s440_odd_37x29": jpeg(scene(37, 29, 4), 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "s422_odd_35x33": jpeg(scene(35, 33, 5), 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "s420_17x9": jpeg(scene(9, 17, 6), 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "s411": jpeg(small, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    }


CASES = sampling_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_reduced_decode_equals_cv2(name):
    data = CASES[name]
    for f in (2, 4, 8):
        want = cv2_reduced(data, f)
        got = decode_jpeg_reduced(data, f)
        assert got is not None and got.shape == want.shape, (f, got is None)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} at 1/{f}")


def test_reduced_decode_orientation_and_refusals():
    """EXIF orientation applied as cv2 applies it; a progressive JPEG
    reduced as cv2 reduces it; a lossless (SOF3) JPEG, truncated and
    non-JPEG bytes give None; a scale outside 2/4/8 raises."""
    for name in ("exif6_200x300.jpg", "exif3_200x300.jpg", "progressive_240x320.jpg"):
        data = read(name)
        for f in (2, 8):
            np.testing.assert_array_equal(decode_jpeg_reduced(data, f), cv2_reduced(data, f))
    progressive = read("progressive_240x320.jpg")
    sof = progressive.index(b"\xff\xc2")
    assert decode_jpeg_reduced(progressive[:sof + 1] + b"\xc3" + progressive[sof + 2:], 2) is None
    assert decode_jpeg_reduced(read("truncated_240x320.jpg"), 2) is None
    assert decode_jpeg_reduced(read("rgb_120x160.png"), 2) is None
    with pytest.raises(ValueError, match="scale"):
        decode_jpeg_reduced(read("grey_240x320.jpg"), 3)


@pytest.mark.parametrize("size", [640, 600, 320, 160])
def test_fast_decode_resized_equals_jax(size):
    """Both sides on every committed sample but two of the 720p frames:
    None together (r >= 1, EXIF, PNG, BMP), else bit-equal images and (h0,
    w0), the progressive samples and those without Huffman tables too. The
    truncated samples give None in the port (its decoders refuse bytes that
    end inside a scan, as the full decode does), where cv2.imread decodes
    them (a dataset restores them first: test_torch_restore.py)."""
    n_fast = 0
    for name in sorted(os.listdir(SAMPLES)):
        if name.startswith(("frame1", "frame2")) or name.endswith(".json"):
            continue
        path = os.path.join(SAMPLES, name)
        want = jax_ds._fast_decode_resized(path, (size, size))
        got = port_ds._fast_decode_resized(read(name), (size, size))
        if name.startswith("truncated") and want is not None:
            assert got is None
            continue
        assert (got is None) == (want is None), name
        if want is not None:
            n_fast += 1
            np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg=name)
            assert got[1] == want[1]
    if size == 160:   # 240x320 and 333x517 reduce; EXIF, the PNGs and BMPs do not
        assert n_fast == 11
    else:             # the 720p frame, its progressive twin and the one without DHTs
        assert n_fast == 3


@pytest.fixture(scope="module")
def fast_dir(tmp_path_factory):
    """A YOLO set whose JPEGs reduce at 1/2, 1/4 and 1/8 at size 48, beside
    ones that do not (EXIF, a PNG, one smaller than the size)."""
    root = tmp_path_factory.mktemp("fast")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(7)
    shapes = [(100, 150), (200, 300), (400, 380), (333, 517), (120, 90), (40, 30), (90, 90)]
    for i, (h, w) in enumerate(shapes):
        img = scene(h, w, seed=20 + i)
        path = root / "images" / f"im{i}"
        if i == 4:
            path.with_suffix(".jpg").write_bytes(with_exif(jpeg(img), 6))
        elif i == 6:
            cv2.imwrite(str(path.with_suffix(".png")), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        else:
            sampling = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422 if i == 2 else
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444 if i == 3 else None)
            path.with_suffix(".jpg").write_bytes(jpeg(img, 90, sampling))
        rows = [f"{int(rng.integers(0, 3))} {rng.uniform(0.2, 0.8):.6f} "
                f"{rng.uniform(0.2, 0.8):.6f} {rng.uniform(0.05, 0.3):.6f} "
                f"{rng.uniform(0.05, 0.3):.6f}" for _ in range(int(rng.integers(1, 4)))]
        (root / "labels" / f"im{i}.txt").write_text("\n".join(rows))
    return str(root)


@pytest.mark.parametrize("size", [48, (60, 40)])
def test_yolo_fast_decode_equals_jax(fast_dir, size):
    want = jax_ds.YOLODataset(fast_dir, img_size=size, cache=False, fast_decode=True)
    got = port_ds.YOLODataset(fast_dir, img_size=size, cache=False, fast_decode=True,
                              device="cpu")
    full = port_ds.YOLODataset(fast_dir, img_size=size, cache=False, device="cpu")
    assert len(got) == len(want) == 7 and got.decoder == "plain"
    n_differ = 0
    for i in range(len(want)):
        w, g = want.pull_item(i), got.pull_item(i)
        np.testing.assert_array_equal(g[0].numpy(), w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert tuple(g[2]) == tuple(w[2]) and g[3] == w[3]
        n_differ += not torch.equal(g[0], full.pull_item(i)[0])
    assert n_differ >= 3   # the reduced decode is not the full one
    for w, g in zip(want.batch_pull_items([5, 0, 3]), got.batch_pull_items([5, 0, 3])):
        np.testing.assert_array_equal(g[0].numpy(), w[0])


def test_fast_decode_disk_cache_and_decoder_option(fast_dir, caplog):
    """A fast and a full disk cache of one file list are two caches; neither
    adopts the other. decoder 'nvjpeg' with fast_decode raises."""
    fast = port_ds.YOLODataset(fast_dir, img_size=48, cache_images="disk",
                               fast_decode=True, device="cpu")
    full = port_ds.YOLODataset(fast_dir, img_size=48, cache_images="disk", device="cpu")
    assert fast._mm_path != full._mm_path and full._mm_rows is None
    want = jax_ds.YOLODataset(fast_dir, img_size=48, cache=False, fast_decode=True)
    for i in range(len(want)):
        np.testing.assert_array_equal(fast.pull_item(i)[0].numpy(), want.pull_item(i)[0])
    again = port_ds.YOLODataset(fast_dir, img_size=48, cache_images="disk",
                                fast_decode=True, device="cpu")
    assert again._mm_path == fast._mm_path
    with pytest.raises(ValueError, match="nvJPEG has no DCT scaling"):
        port_ds.YOLODataset(fast_dir, img_size=48, fast_decode=True, decoder="nvjpeg",
                            device="cpu")
