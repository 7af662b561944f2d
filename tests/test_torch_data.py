"""Port (vision_kit_tpu_torch.data.datasets) vs JAX package on the CPU: the
YOLO, COCO and concatenated datasets' items bit for bit, the label cache,
the RAM and disk image caches and the restartable disk build, and the
PIL-free integrity scan (sizes after EXIF, the files the port drops with
their reasons, and the user's files left as they were).

The JAX datasets decode with cv2 (or its native twin, held equal to cv2 by
tests/test_native.py); the port's with data/decode.py's plain decoder and
ops/letterbox.py:resize_u8, equal to cv2 bit for bit. So every item is
compared exactly: pixels, labels, (h0, w0) and the item id.
"""

import glob
import json
import logging
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest
import torch

from fixture_lib import build_rectangle_dataset
from torch_samples import jpeg, scene, with_exif
from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu_torch.data import datasets as port_ds
from vision_kit_tpu_torch.data.decode import decode_image, encode_png, png_header
from vision_kit_tpu_torch.utils.general import exif_size

torch.set_num_threads(2)

SAMPLES = os.path.join(os.path.dirname(port_ds.__file__), "samples")


def assert_items_equal(want, got):
    """A JAX item (numpy image) against a port item (tensor image)."""
    assert isinstance(got[0], torch.Tensor) and got[0].dtype == torch.uint8
    np.testing.assert_array_equal(want[0], got[0].numpy())
    np.testing.assert_array_equal(want[1], got[1])
    assert want[1].dtype == got[1].dtype
    assert tuple(want[2]) == tuple(got[2])
    assert want[3] == got[3]


@pytest.fixture(scope="module")
def rect_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rect"))
    build_rectangle_dataset(root)
    return root


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    """Images of several sizes: cv2 JPEGs (4:2:0 and 4:4:4), an EXIF-rotated
    JPEG, a PNG from cv2 and one from the port's writer, each with 1-3
    labels."""
    root = tmp_path_factory.mktemp("mixed")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    for i in range(7):
        h, w = int(rng.integers(60, 200)), int(rng.integers(60, 200))
        img = scene(h, w, seed=i)
        path = root / "images" / f"im{i}"
        if i in (0, 1, 2):
            data = jpeg(img, sampling=None if i else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
            (path.with_suffix(".jpg")).write_bytes(data)
        elif i == 3:
            (path.with_suffix(".jpg")).write_bytes(with_exif(jpeg(img), 6))
        elif i == 4:
            cv2.imwrite(str(path.with_suffix(".png")), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        else:
            (path.with_suffix(".png")).write_bytes(encode_png(img))
        rows = [f"{int(rng.integers(0, 3))} {rng.uniform(0.2, 0.8):.6f} "
                f"{rng.uniform(0.2, 0.8):.6f} {rng.uniform(0.05, 0.3):.6f} "
                f"{rng.uniform(0.05, 0.3):.6f}" for _ in range(int(rng.integers(1, 4)))]
        (root / "labels" / f"im{i}.txt").write_text("\n".join(rows))
    return str(root)


@pytest.mark.parametrize("size", [48, 64, 100])
def test_yolo_items_equal_jax(rect_root, size):
    """The rectangle set at a shrink, the same size and an enlargement:
    pull_item and batch_pull_items bit-equal to JAX's."""
    split = os.path.join(rect_root, "images", "train")
    want = jax_ds.YOLODataset(split, img_size=size)
    got = port_ds.YOLODataset(split, img_size=size, device="cpu")
    assert [os.path.basename(f) for f in got.img_files] == \
        [os.path.basename(f) for f in want.img_files]
    for i in range(len(want)):
        assert_items_equal(want.pull_item(i), got.pull_item(i))
    idxs = [3, 0, 7, 7]
    for w, g in zip(want.batch_pull_items(idxs), got.batch_pull_items(idxs)):
        assert_items_equal(w, g)


@pytest.mark.parametrize("size", [(64, 64), (96, 80)])
def test_mixed_sizes_formats_and_exif_equal_jax(mixed_dir, size):
    want = jax_ds.YOLODataset(mixed_dir, img_size=size, cache=False)
    got = port_ds.YOLODataset(mixed_dir, img_size=size, cache=False, device="cpu")
    assert len(got) == len(want) == 7
    for i in range(len(want)):
        assert_items_equal(want.pull_item(i), got.pull_item(i))
    # the EXIF-rotated JPEG decodes in display orientation, on both sides
    i = next(i for i, f in enumerate(got.img_files) if f.endswith("im3.jpg"))
    stored = cv2.imread(os.path.join(mixed_dir, "images", "im3.jpg"),
                        cv2.IMREAD_IGNORE_ORIENTATION)
    assert got.pull_item(i)[2] == (stored.shape[1], stored.shape[0])


def test_filter_classes_and_concat_equal_jax(rect_root):
    dirs = [os.path.join(rect_root, "images", s) for s in ("train", "val")]
    want = jax_ds.ConcatDataset([jax_ds.YOLODataset(d, img_size=48, filter_classes=[1])
                                 for d in dirs])
    got = port_ds.ConcatDataset([port_ds.YOLODataset(d, img_size=48, filter_classes=[1],
                                                     device="cpu") for d in dirs])
    assert len(got) == len(want) == 24
    for i in (0, 5, 11, 12, 23, -1):
        assert_items_equal(want.pull_item(i), got.pull_item(i))
        np.testing.assert_array_equal(want.load_anno(i), got.load_anno(i))
    assert (got.pull_item(3)[1][:, 4] == 1).all()
    mixed = port_ds.MixConcatDataset(got.datasets)
    assert_items_equal(want.pull_item(13), mixed.pull_item((True, 13)))


def _coco_root(tmp_path):
    """tests/test_data.py's COCO fixture, with images of two sizes."""
    root = tmp_path / "coco"
    (root / "annotations").mkdir(parents=True)
    (root / "val").mkdir()
    sizes = [(100, 200), (120, 90), (100, 200)]
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(root / "val" / f"im{i}.jpg"),
                    cv2.cvtColor(scene(h, w, seed=10 + i), cv2.COLOR_RGB2BGR))
    coco = {
        "images": [{"id": 10 + i, "file_name": f"im{i}.jpg", "height": h, "width": w}
                   for i, (h, w) in enumerate(sizes)],
        "categories": [{"id": 1, "name": "a"}, {"id": 7, "name": "b"}],
        "annotations": [
            {"image_id": 10, "category_id": 7, "bbox": [10, 20, 50, 40], "iscrowd": 0},
            {"image_id": 10, "category_id": 1, "bbox": [0, 0, -5, 10], "iscrowd": 0},
            {"image_id": 11, "category_id": 1, "bbox": [5, 5, 20, 20], "iscrowd": 1},
            {"image_id": 11, "category_id": 7, "bbox": [3, 4, 30, 60], "iscrowd": 0},
            {"image_id": 12, "category_id": 1, "bbox": [30, 10, 40, 70], "iscrowd": 0},
        ],
    }
    with open(root / "annotations" / "instances_val.json", "w") as f:
        json.dump(coco, f)
    return str(root)


@pytest.mark.parametrize("filter_classes", [(), (1,)])
def test_coco_equal_jax(tmp_path, filter_classes):
    root = _coco_root(tmp_path)
    kw = dict(json_file="instances_val.json", name="val", img_size=64,
              filter_classes=filter_classes)
    want = jax_ds.COCODataset(root, **kw)
    got = port_ds.COCODataset(root, device="cpu", **kw)
    assert got.class_names == want.class_names == ["a", "b"]
    assert got.class_ids == want.class_ids and got.cat_ids == want.cat_ids
    assert len(got) == len(want) == 3
    for i in range(3):
        assert_items_equal(want.pull_item(i), got.pull_item(i))
        np.testing.assert_array_equal(want.load_anno(i), got.load_anno(i))
    assert got.pull_item(0)[3] == 10


def test_label_cache_roundtrip_and_port_names(rect_root, tmp_path):
    """The label cache round-trips, and a JAX and a port dataset over one
    directory keep their caches under names of their own."""
    root = tmp_path / "ds"
    shutil.copytree(os.path.join(rect_root, "images", "train"), root / "images")
    shutil.copytree(os.path.join(rect_root, "labels", "train"), root / "labels")
    a = port_ds.YOLODataset(str(root), img_size=48, device="cpu")
    assert len(glob.glob(str(root / ".vkt_labels_*.npz"))) == 1
    assert not glob.glob(str(root / ".vk_labels_*"))
    b = port_ds.YOLODataset(str(root), img_size=48, device="cpu")   # from the cache
    for x, y in zip(a.labels, b.labels):
        np.testing.assert_array_equal(x, y)
        assert y.dtype == np.float32 and y.shape[1] == 5
    j = jax_ds.YOLODataset(str(root), img_size=48)
    assert len(glob.glob(str(root / ".vk_labels_*.npz"))) == 1
    for x, y in zip(j.labels, b.labels):
        np.testing.assert_array_equal(x, y)
    # disk caches too: the JAX one and the port's, each keyed its own way
    jax_ds.YOLODataset(str(root), img_size=48, cache_images="disk")
    port_ds.YOLODataset(str(root), img_size=48, cache_images="disk", device="cpu")
    assert len(glob.glob(str(root / ".vk_imgcache_*.dat"))) == 1
    assert len(glob.glob(str(root / ".vkt_imgcache_*.dat"))) == 1
    with open(glob.glob(str(root / ".vkt_imgcache_*.entries.json"))[0]) as f:
        assert json.load(f)["decoder"] == "plain"


def test_duplicate_and_bad_labels_equal_jax(tmp_path):
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for i in range(3):
        cv2.imwrite(str(tmp_path / "images" / f"{i}.jpg"), np.full((80, 120, 3), 100, np.uint8))
    (tmp_path / "labels" / "0.txt").write_text(
        "0 0.5 0.5 0.4 0.4\n0 0.5 0.5 0.4 0.4\n1 0.25 0.25 0.2 0.2")
    (tmp_path / "labels" / "1.txt").write_text("0 0.5 0.5 1.4 0.4")    # not normalised
    (tmp_path / "labels" / "2.txt").write_text("")
    want = jax_ds.YOLODataset(str(tmp_path), img_size=64, cache=False)
    got = port_ds.YOLODataset(str(tmp_path), img_size=64, cache=False, device="cpu")
    assert len(got.labels[0]) == 2 and len(got.labels[1]) == 0
    for x, y in zip(want.labels, got.labels):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["ram", "disk"])
def test_image_cache_equals_uncached(mixed_dir, tmp_path, mode):
    """RAM and disk caches give the uncached items, survive pickling (the
    loader workers' copy, which lands on the CPU), and a second disk
    dataset reads the cache without decoding."""
    root = tmp_path / "ds"
    shutil.copytree(mixed_dir, root)
    plain = port_ds.YOLODataset(str(root), img_size=80, device="cpu")
    cached = port_ds.YOLODataset(str(root), img_size=80, device="cpu", cache_images=mode)
    for i in range(len(plain)):
        a, b = plain.pull_item(i), cached.pull_item(i)
        assert torch.equal(a[0], b[0]) and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
    clone = pickle.loads(pickle.dumps(cached))
    assert clone._ram_cache is None and clone.device == torch.device("cpu")
    assert torch.equal(clone.pull_item(3)[0], plain.pull_item(3)[0])
    if mode == "disk":
        again = port_ds.YOLODataset(str(root), img_size=80, device="cpu", cache_images="disk")
        again.load_image = None   # raises if the decode path were taken
        assert torch.equal(again.pull_item(5)[0], plain.pull_item(5)[0])


def _rect_set(root, n=8):
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(n):
        h, w = int(rng.integers(100, 200)), int(rng.integers(100, 200))
        img = np.full((h, w, 3), 64, np.uint8)
        img[10:40, 10:50] = (200, 60, 30)
        cv2.imwrite(str(root / "images" / f"r{i}.jpg"), img)
        (root / "labels" / f"r{i}.txt").write_text("0 0.3 0.25 0.3 0.3")


def test_disk_cache_build_is_restartable(tmp_path, monkeypatch):
    """A disk build killed after two 3-image chunks resumes at the first
    unbuilt row, decoding only the missing ones, and then equals the
    uncached items; the port's build equals JAX's built cache's items."""
    _rect_set(tmp_path)
    plain = port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu")
    monkeypatch.setattr(port_ds.YOLODataset, "cache_build_chunk", 3)
    calls = {"n": 0}
    orig = port_ds.YOLODataset._decode_resized_batch

    def dying(self, idxs):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("simulated kill")
        return orig(self, idxs)

    monkeypatch.setattr(port_ds.YOLODataset, "_decode_resized_batch", dying)
    with pytest.raises(RuntimeError, match="simulated kill"):
        port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu", cache_images="disk")
    meta = np.load(glob.glob(str(tmp_path / ".vkt_imgcache_*.meta.npy"))[0])
    assert (meta[:, 0] > 0).sum() == 6

    decoded = []

    def counting(self, idxs):
        decoded.extend(idxs)
        return orig(self, idxs)

    monkeypatch.setattr(port_ds.YOLODataset, "_decode_resized_batch", counting)
    ds = port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu", cache_images="disk")
    assert sorted(decoded) == np.flatnonzero(meta[:, 0] == 0).tolist()
    want = jax_ds.YOLODataset(str(tmp_path), img_size=96, cache_images="disk")
    for i in range(len(plain)):
        assert torch.equal(plain.pull_item(i)[0], ds.pull_item(i)[0])
        assert_items_equal(want.pull_item(i), ds.pull_item(i))


def test_disk_cache_damage_rebuilds_and_never_serves_black(tmp_path, monkeypatch):
    """A truncated .dat under a complete meta rebuilds; a crash after the
    rebuild's zero-filling open but before its first chunk leaves no meta
    claiming the zeroed rows."""
    _rect_set(tmp_path, n=4)
    plain = port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu")
    expect = [plain.pull_item(i)[0].clone() for i in range(4)]
    port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu", cache_images="disk")
    dat = glob.glob(str(tmp_path / ".vkt_imgcache_*.dat"))[0]
    with open(dat, "r+b") as f:
        f.truncate(1024)

    def dying(self, idxs):
        raise RuntimeError("simulated kill mid-rebuild")

    with monkeypatch.context() as m:
        m.setattr(port_ds.YOLODataset, "_decode_resized_batch", dying)
        with pytest.raises(RuntimeError, match="simulated kill"):
            port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu",
                                cache_images="disk")
    ds = port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu", cache_images="disk")
    for i in range(4):
        assert torch.equal(expect[i], ds.pull_item(i)[0])


def test_disk_cache_shared_across_subset_split(tmp_path, monkeypatch):
    _rect_set(tmp_path)
    full = port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu", cache_images="disk")
    expect = {i: full.pull_item(i)[0].clone() for i in range(8)}
    for k in (2, 5):
        os.remove(str(tmp_path / "images" / f"r{k}.jpg"))
        os.remove(str(tmp_path / "labels" / f"r{k}.txt"))

    def no_decode(self, idxs):
        raise AssertionError("a subset split must not decode again")

    monkeypatch.setattr(port_ds.YOLODataset, "_decode_resized_batch", no_decode)
    sub = port_ds.YOLODataset(str(tmp_path), img_size=96, device="cpu", cache_images="disk")
    assert len(sub) == 6 and sub._mm_rows is not None
    for j, i in enumerate(k for k in range(8) if k not in (2, 5)):
        assert torch.equal(expect[i], sub.pull_item(j)[0])
    assert torch.equal(pickle.loads(pickle.dumps(sub)).pull_item(0)[0], expect[0])


def test_scan_drops_what_the_port_cannot_decode(tmp_path, caplog):
    """The scan's verdicts beside JAX's: a truncated JPEG (both restore it
    in place, to the same bytes, and keep it), a progressive JPEG and a BMP
    (both keep them, and their items are equal), garbage and an image under
    10 px (both drop). Each drop is logged with its reason, the restore
    with JAX's words, and the verdicts are cached with the labels."""
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (80, 120, 3), dtype=np.uint8) for _ in range(3)]
    for root in (tmp_path / "port", tmp_path / "jax"):
        (root / "images").mkdir(parents=True)
        (root / "labels").mkdir()
        for i, img in enumerate(imgs):
            cv2.imwrite(str(root / "images" / f"{i}.jpg"), img)
        data = (root / "images" / "1.jpg").read_bytes()
        (root / "images" / "1.jpg").write_bytes(data[:-60])
        shutil.copy(os.path.join(SAMPLES, "progressive_240x320.jpg"),
                    root / "images" / "prog.jpg")
        cv2.imwrite(str(root / "images" / "b.bmp"), np.full((40, 50, 3), 9, np.uint8))
        (root / "images" / "junk.jpg").write_bytes(b"not an image at all")
        cv2.imwrite(str(root / "images" / "tiny.png"), np.zeros((8, 30, 3), np.uint8))
        for p in (root / "images").iterdir():
            (root / "labels" / (p.stem + ".txt")).write_text("0 0.5 0.5 0.4 0.4")
    truncated = (tmp_path / "port" / "images" / "1.jpg").read_bytes()

    with caplog.at_level(logging.WARNING, logger="vision_kit_tpu_torch"):
        got = port_ds.YOLODataset(str(tmp_path / "port"), img_size=64, device="cpu")
    want = jax_ds.YOLODataset(str(tmp_path / "jax"), img_size=64)
    names = lambda ds: sorted(os.path.basename(f) for f in ds.img_files)  # noqa: E731
    assert names(got) == names(want) == ["0.jpg", "1.jpg", "2.jpg", "b.bmp", "prog.jpg"]
    restored = (tmp_path / "port" / "images" / "1.jpg").read_bytes()
    assert restored != truncated and restored[-2:] == b"\xff\xd9"
    assert restored == (tmp_path / "jax" / "images" / "1.jpg").read_bytes()
    log = caplog.text
    for name, reason in (("1.jpg", "corrupt JPEG restored and saved"),
                         ("junk.jpg", "not a JPEG, PNG, BMP or WebP"), ("tiny.png", "30x8 < 10")):
        assert any(name in r.message and reason in r.message for r in caplog.records), \
            (name, log)
    again = port_ds.YOLODataset(str(tmp_path / "port"), img_size=64, device="cpu")
    assert again.img_files == got.img_files
    jax_names = [os.path.basename(f) for f in want.img_files]
    for i, f in enumerate(got.img_files):
        w = want.pull_item(jax_names.index(os.path.basename(f)))
        g = got.pull_item(i)
        np.testing.assert_array_equal(w[0], g[0].numpy())
        np.testing.assert_array_equal(w[1], g[1])


def test_scan_refusals_by_header(tmp_path):
    """image_refusal on a JPEG whose scan is followed by a marker segment
    but no EOI (restored in place, to the bytes JAX's _check_img writes),
    on one cut inside its header (dropped, as PIL refuses it) and on a PNG
    with a broken CRC."""
    img = scene(40, 60, seed=3)
    data = jpeg(img)
    cases = {"no_eoi.jpg": data[:-2] + b"\xff\xfe\x00\x04ok", "ok.jpg": data,
             "bad_crc.png": encode_png(img)[:40] + b"\0" + encode_png(img)[41:],
             "ok.png": encode_png(img), "header.jpg": data[:100]}
    for name, blob in cases.items():
        (tmp_path / name).write_bytes(blob)
    (tmp_path / "jax.jpg").write_bytes(cases["no_eoi.jpg"])
    assert port_ds.image_refusal(str(tmp_path / "no_eoi.jpg")) is None
    assert jax_ds.YOLODataset._check_img(str(tmp_path / "jax.jpg")) is None
    assert (tmp_path / "no_eoi.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()
    assert "inside the header" in port_ds.image_refusal(str(tmp_path / "header.jpg"))
    assert (tmp_path / "header.jpg").read_bytes() == data[:100]
    assert "CRC" in port_ds.image_refusal(str(tmp_path / "bad_crc.png"))
    assert port_ds.image_refusal(str(tmp_path / "ok.jpg")) is None
    assert port_ds.image_refusal(str(tmp_path / "ok.png")) is None
    assert "No such file" in port_ds.image_refusal(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("orientation", [1, 3, 5, 6, 8])
def test_exif_size_from_the_header(orientation):
    """(width, height) as displayed: the transposing orientations swap."""
    data = with_exif(jpeg(scene(30, 50, seed=1)), orientation)
    want = (30, 50) if orientation in (5, 6, 7, 8) else (50, 30)
    assert exif_size(data) == want
    assert decode_image(data).shape[:2] == (want[1], want[0])


def test_png_writer_round_trips():
    img = scene(37, 53, seed=2)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_image(data), img)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                                            cv2.IMREAD_COLOR),
                                               cv2.COLOR_BGR2RGB), img)
    assert png_header(data) == {"orientation": 1, "width": 53, "height": 37}


def test_fast_decode_and_the_card_without_cuda_raise(rect_root):
    split = os.path.join(rect_root, "images", "train")
    with pytest.raises(ValueError, match="fast_decode"):
        port_ds.YOLODataset(split, img_size=48, fast_decode=True, decoder="nvjpeg",
                            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_ds.YOLODataset(split, img_size=48)


NEW_KINDS = ["arith_420_rst3_117x163.jpg", "arith_progressive_117x163.jpg",
             "arith_grey_117x163.jpg", "lossless_p1_117x163.jpg",
             "lossless_p4_pt2_117x163.jpg", "lossless_p7_117x163.jpg"]


@pytest.fixture(scope="module")
def new_kinds_dir(tmp_path_factory):
    """The arithmetic-coded and lossless fixtures as a YOLO set, with a
    grey lossless file (PIL opens it, cv2 does not decode it) apart."""
    root = tmp_path_factory.mktemp("kinds")
    rng = np.random.default_rng(9)
    for sub, names in (("ok", NEW_KINDS), ("grey", NEW_KINDS[:1] + ["lossless_grey_117x163.jpg"])):
        (root / sub / "images").mkdir(parents=True)
        (root / sub / "labels").mkdir()
        for name in names:
            shutil.copy(os.path.join(SAMPLES, name), root / sub / "images" / name)
            (root / sub / "labels" / name.replace(".jpg", ".txt")).write_text(
                f"{int(rng.integers(0, 2))} 0.5 0.5 {rng.uniform(0.1, 0.6):.6f} 0.3")
    return root


@pytest.mark.parametrize("fast_decode", [False, True])
@pytest.mark.parametrize("size", [48, 128])
def test_arithmetic_and_lossless_items_equal_jax(new_kinds_dir, fast_decode, size, monkeypatch):
    """Items equal JAX's with and without fast_decode (at 48 the arithmetic
    files decode at 1/2 in the DCT; the lossless ones fall back to the full
    decode on both, as libjpeg does not scale them)."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path
    root = str(new_kinds_dir / "ok")
    want = jax_ds.YOLODataset(root, img_size=size, cache=False, fast_decode=fast_decode)
    got = port_ds.YOLODataset(root, img_size=size, cache=False, fast_decode=fast_decode,
                              device="cpu")
    assert [os.path.basename(f) for f in got.img_files] == \
        [os.path.basename(f) for f in want.img_files] == sorted(NEW_KINDS)
    for i in range(len(want)):
        assert_items_equal(want.pull_item(i), got.pull_item(i))


def test_grey_lossless_is_kept_and_its_item_raises_as_jax(new_kinds_dir, monkeypatch):
    """The integrity scan keeps a grey lossless JPEG, as JAX's _check_img
    keeps it (PIL opens it as "L"); cv2's IMREAD_COLOR gives None for it,
    so JAX's load_image raises IOError, and so does the port's."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")
    root = str(new_kinds_dir / "grey")
    want = jax_ds.YOLODataset(root, img_size=64, cache=False)
    got = port_ds.YOLODataset(root, img_size=64, cache=False, device="cpu")
    names = [os.path.basename(f) for f in got.img_files]
    assert names == [os.path.basename(f) for f in want.img_files]
    i = names.index("lossless_grey_117x163.jpg")
    assert_items_equal(want.pull_item(1 - i), got.pull_item(1 - i))
    for ds in (want, got):
        with pytest.raises(IOError, match="image unreadable"):
            ds.pull_item(i)
