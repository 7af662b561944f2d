"""Port (vision_kit_tpu_torch.data.loader, data/device_aug.py's planner) vs
JAX package on the CPU: the index stream, DeviceAugPlanner's plan and
finalize over several seeds with and without mixup, the device-augmentation
TrainLoader's batches (tile regions, the slot-4 fill, tile_hw, params,
targets) with 0 and 2 workers, the host-augmentation TrainLoader's batches
(images and targets, with mixup, rotation and shear, no_aug) with 0 and 2
workers and after seek, seek/close/re-iterate, a worker's crash on either
route, and ValLoader's batches with the last one padded. Everything is
compared exactly: on the CPU the port's datasets equal JAX's bit for bit
(tests/test_torch_data.py).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from fixture_lib import build_rectangle_dataset
from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu.data import device_aug as jax_aug
from vision_kit_tpu.data import loader as jax_loader
from vision_kit_tpu_torch.data import datasets as port_ds
from vision_kit_tpu_torch.data import device_aug as port_aug
from vision_kit_tpu_torch.data import loader as port_loader

torch.set_num_threads(2)

SIZE = 48
MIXUP = {"enable_mixup": True, "mixup_prob": 0.7, "mixup_scale": [0.5, 1.5]}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The rectangle set's train split (12 images) twice: JAX's and the
    port's, at 48 px (a shrink of the 64 px images)."""
    root = str(tmp_path_factory.mktemp("rect"))
    build_rectangle_dataset(root)
    split = os.path.join(root, "images", "train")
    return (jax_ds.YOLODataset(split, img_size=SIZE),
            port_ds.YOLODataset(split, img_size=SIZE, device="cpu"), split)


def assert_batches_equal(want, got):
    """A JAX device-aug batch against the port's: the tiles' valid regions
    and slot 4's whole canvas (114 outside its image) exactly."""
    for key in ("tile_hw", "params", "targets"):
        np.testing.assert_array_equal(want[key], got[key], err_msg=key)
        assert want[key].dtype == got[key].dtype
    tiles = got["tiles"]
    assert isinstance(tiles, torch.Tensor) and tiles.dtype == torch.uint8
    tiles = tiles.numpy()
    assert tiles.shape == want["tiles"].shape
    for k in range(tiles.shape[0]):
        for t in range(tiles.shape[1]):
            h, w = want["tile_hw"][k, t]
            if t == 4 and h:
                np.testing.assert_array_equal(want["tiles"][k, 4], tiles[k, 4])
            np.testing.assert_array_equal(want["tiles"][k, t, :h, :w], tiles[k, t, :h, :w])


def test_index_stream_equal_jax():
    for shard, num_shards, shuffle in ((0, 1, True), (1, 3, True), (0, 2, False)):
        want = jax_loader.infinite_indices(13, seed=4, shard=shard, num_shards=num_shards,
                                           shuffle=shuffle)
        got = port_loader.infinite_indices(13, seed=4, shard=shard, num_shards=num_shards,
                                           shuffle=shuffle)
        assert [next(want) for _ in range(40)] == [next(got) for _ in range(40)]
    with pytest.raises(ValueError, match="empty"):
        port_loader._IndexStream(2, shard=2, num_shards=3)


@pytest.mark.parametrize("aug", [{}, MIXUP, {"enable_mosaic": False, "flip_ud_prob": 0.5}],
                         ids=["mosaic", "mixup", "plain"])
@pytest.mark.parametrize("seed", [0, 7, 21])
def test_planner_equal_jax(datasets, aug, seed):
    """plan's tile indices and draws, and finalize's params, tile_hw and
    labels, for 12 samples a seed."""
    jds, pds, _ = datasets
    kw = dict(img_size=SIZE, enable_mosaic=aug.get("enable_mosaic", True),
              enable_mixup=aug.get("enable_mixup", False),
              mixup_prob=aug.get("mixup_prob", 1.0),
              flip_ud_prob=aug.get("flip_ud_prob", 0.0))
    jp, pp = jax_aug.DeviceAugPlanner(jds, **kw), port_aug.DeviceAugPlanner(pds, **kw)
    assert pp.n_tiles == jp.n_tiles
    for sid in range(12):
        jt, jd = jp.plan(np.random.default_rng([seed, 77, sid]), sid % len(jds))
        pt, pd = pp.plan(np.random.default_rng([seed, 77, sid]), sid % len(pds))
        assert jt == pt
        assert {k: v for k, v in jd.items() if k != "_rng"} == \
            {k: v for k, v in pd.items() if k != "_rng"}
        jout = jp.finalize(jd, [jds.pull_item(i) for i in jt])
        pout = pp.finalize(pd, [pds.pull_item(i) for i in pt])
        for a, b in zip(jout[:3], pout[:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert [x is None for x in jout[3]] == [x is None for x in pout[3]]
    assert jp._label_counts == pp._label_counts


def test_planner_rejects_rotation(datasets):
    with pytest.raises(ValueError, match="degrees=0, shear=0"):
        port_aug.DeviceAugPlanner(datasets[1], degrees=5.0)


@pytest.mark.parametrize("aug", [{}, MIXUP], ids=["mosaic", "mixup"])
def test_train_loader_batches_equal_jax(datasets, aug):
    jds, pds, _ = datasets
    want = jax_loader.TrainLoader(jds, 4, img_size=SIZE, aug_cfg=aug, seed=3,
                                  device_aug=True)
    got = port_loader.TrainLoader(pds, 4, img_size=SIZE, aug_cfg=aug, seed=3,
                                  device_aug=True)
    assert got.steps_per_epoch == want.steps_per_epoch == 3
    try:
        for bid, (w, g) in enumerate(zip(want, got)):
            assert_batches_equal(w, g)
            if bid == 3:
                break
    finally:
        want.close()
        got.close()


def test_train_loader_workers_equal_jax(datasets):
    """Two spawned workers (each with a CPU copy of the dataset) give the
    single-thread stream, and JAX's."""
    jds, pds, _ = datasets
    want = jax_loader.TrainLoader(jds, 4, img_size=SIZE, aug_cfg=MIXUP, seed=3,
                                  device_aug=True)
    got = port_loader.TrainLoader(pds, 4, img_size=SIZE, aug_cfg=MIXUP, seed=3,
                                  num_workers=2, device_aug=True)
    try:
        it_w, it_g = iter(want), iter(got)
        for _ in range(4):
            assert_batches_equal(next(it_w), next(it_g))
    finally:
        want.close()
        got.close()
    assert not got._procs


def test_seek_close_reiterate(datasets):
    """seek(b) on an idle loader continues at batch b; after close() a
    re-iterate starts a fresh producer at the stream's position; seek on a
    running loader raises."""
    _, pds, _ = datasets
    ref = port_loader.TrainLoader(pds, 4, img_size=SIZE, seed=9, device_aug=True)
    it = iter(ref)
    stream = [next(it) for _ in range(6)]
    ref.close()

    lo = port_loader.TrainLoader(pds, 4, img_size=SIZE, seed=9, device_aug=True)
    lo.seek(2)
    it = iter(lo)
    for b in (2, 3):
        np.testing.assert_array_equal(next(it)["params"], stream[b]["params"])
    with pytest.raises(RuntimeError, match="idle loader"):
        lo.seek(0)
    lo.close()
    assert lo._next_bid == 4
    it = iter(lo)
    for b in (4, 5):
        got = next(it)
        np.testing.assert_array_equal(got["params"], stream[b]["params"])
        assert torch.equal(got["tiles"][:, :, :4, :4], stream[b]["tiles"][:, :, :4, :4])
    lo.close()
    with pytest.raises(ValueError):
        lo.seek(-1)


@pytest.mark.parametrize("num_workers", [0, 1])
def test_loader_error_propagates(datasets, tmp_path, num_workers):
    """A batch that fails to build (the images vanish after the scan)
    surfaces as a RuntimeError in the consumer, from the thread or a
    worker, not as a hang."""
    _, _, split = datasets
    root = tmp_path / "ds"
    shutil.copytree(os.path.dirname(os.path.dirname(split)), root)
    ds = port_ds.YOLODataset(str(root / "images" / "train"), img_size=SIZE, device="cpu")
    for f in (root / "images" / "train").glob("*.jpg"):
        f.write_bytes(b"not a jpeg")
    lo = port_loader.TrainLoader(ds, 2, img_size=SIZE, num_workers=num_workers,
                                 device_aug=True)
    with pytest.raises(RuntimeError, match="worker"):
        next(iter(lo))
    lo.close()


@pytest.mark.parametrize("num_workers", [0, 1])
def test_host_augmentation_route_raises(datasets, tmp_path, num_workers):
    """A host-route batch that fails to build (the images vanish after the
    scan) raises a RuntimeError in the consumer, from the thread or a
    worker."""
    _, _, split = datasets
    root = tmp_path / "ds"
    shutil.copytree(os.path.dirname(os.path.dirname(split)), root)
    ds = port_ds.YOLODataset(str(root / "images" / "train"), img_size=SIZE, device="cpu")
    for f in (root / "images" / "train").glob("*.jpg"):
        f.write_bytes(b"not a jpeg")
    lo = port_loader.TrainLoader(ds, 2, img_size=SIZE, num_workers=num_workers)
    with pytest.raises(RuntimeError, match="worker"):
        next(iter(lo))
    lo.close()


HOST_AUGS = {"mosaic": {}, "mixup_rotate_shear": dict(MIXUP, degrees=10.0, shear=4.0),
             "flip_ud": {"flip_ud_prob": 0.5, "mosaic_prob": 0.5}}


@pytest.mark.parametrize("aug", HOST_AUGS, ids=list(HOST_AUGS))
def test_host_route_batches_equal_jax(datasets, aug):
    """4 batches of 4 with the prefetch thread: images (B, S, S, 3) uint8
    tensors and targets equal JAX's."""
    jds, pds, _ = datasets
    want = jax_loader.TrainLoader(jds, 4, img_size=SIZE, aug_cfg=HOST_AUGS[aug], seed=3)
    got = port_loader.TrainLoader(pds, 4, img_size=SIZE, aug_cfg=HOST_AUGS[aug], seed=3)
    assert got.steps_per_epoch == want.steps_per_epoch == 3
    try:
        for _, w, g in zip(range(4), want, got):
            assert set(g) == {"image", "targets"}
            assert isinstance(g["image"], torch.Tensor) and g["image"].dtype == torch.uint8
            np.testing.assert_array_equal(g["image"].numpy(), w["image"])
            np.testing.assert_array_equal(g["targets"], w["targets"])
    finally:
        want.close()
        got.close()


def test_host_route_workers_and_seek_equal_jax(datasets):
    """Two spawned workers give JAX's stream from batch 0; a loader sought to
    batch 3 gives JAX's batches 3 and 4; no_aug gives JAX's padded items."""
    jds, pds, _ = datasets
    aug = HOST_AUGS["mixup_rotate_shear"]
    want = jax_loader.TrainLoader(jds, 4, img_size=SIZE, aug_cfg=aug, seed=3)
    got = port_loader.TrainLoader(pds, 4, img_size=SIZE, aug_cfg=aug, seed=3, num_workers=2)
    sought = port_loader.TrainLoader(pds, 4, img_size=SIZE, aug_cfg=aug, seed=3)
    sought.seek(3)
    try:
        stream = [next(it) for it in [iter(want)] for _ in range(5)]
        it = iter(got)
        for w in stream:
            g = next(it)
            np.testing.assert_array_equal(g["image"].numpy(), w["image"])
            np.testing.assert_array_equal(g["targets"], w["targets"])
        it = iter(sought)
        for w in stream[3:]:
            g = next(it)
            np.testing.assert_array_equal(g["image"].numpy(), w["image"])
            np.testing.assert_array_equal(g["targets"], w["targets"])
    finally:
        for lo in (want, got, sought):
            lo.close()
    assert not got._procs
    want = jax_loader.TrainLoader(jds, 4, img_size=SIZE, aug_cfg=aug, seed=3, no_aug=True)
    got = port_loader.TrainLoader(pds, 4, img_size=SIZE, aug_cfg=aug, seed=3, no_aug=True)
    w, g = want._make_batch(1), got._make_batch(1)
    np.testing.assert_array_equal(g["image"].numpy(), w["image"])
    np.testing.assert_array_equal(g["targets"], w["targets"])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_val_loader_equal_jax(datasets, prefetch):
    """5 batches of 5 over 12 images at 64 px (the 48 px dataset items
    letterboxed up), the last padded with its final image: images,
    targets, infos and counts."""
    jds, pds, _ = datasets
    want = list(jax_loader.ValLoader(jds, 5, img_size=64))
    got = list(port_loader.ValLoader(pds, 5, img_size=64, prefetch=prefetch))
    assert len(got) == len(want) == len(port_loader.ValLoader(pds, 5)) == 3
    for w, g in zip(want, got):
        assert isinstance(g["image"], torch.Tensor)
        np.testing.assert_array_equal(w["image"], g["image"].numpy())
        np.testing.assert_array_equal(w["targets"], g["targets"])
        assert w["info"] == g["info"] and w["count"] == g["count"]
    assert got[-1]["count"] == 2
    assert torch.equal(got[-1]["image"][1], got[-1]["image"][4])


def test_pad_targets_equal_jax():
    rng = np.random.default_rng(0)
    labels = [np.concatenate([rng.uniform(0, 30, (n, 4)).astype(np.float32),
                              rng.integers(0, 3, (n, 1)).astype(np.float32)], 1)
              for n in (0, 3, 200)]
    np.testing.assert_array_equal(jax_loader.pad_targets(labels, (48, 64)),
                                  port_loader.pad_targets(labels, (48, 64)))
