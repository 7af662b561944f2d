"""Port (vision_kit_tpu_torch.data.mosaic) vs JAX package
(vision_kit_tpu/data/mosaic.py) on the CPU: MosaicMixupDataset.getitem
with mosaic, mixup, rotation and shear, from the same numpy-seeded
generators over the same files, images and labels bit for bit; the
placement rectangles; mixup's fallback when no draw has labels.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu.data import mosaic as jax_mosaic
from vision_kit_tpu_torch.data import datasets as port_ds
from vision_kit_tpu_torch.data import mosaic as port_mosaic

torch.set_num_threads(2)

SIZE = 64
SHAPES = ((64, 96), (80, 48), (50, 50), (120, 90), (40, 130), (64, 64))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """12 images of six shapes (JPEG and PNG) with 0-3 seeded boxes each
    (one image has none): JAX's dataset and the port's, at 64 px."""
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(0)
    img_dir, lbl_dir = root / "images" / "train", root / "labels" / "train"
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    for i in range(12):
        h, w = SHAPES[i % len(SHAPES)]
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([yy * 3 % 256, xx * 5 % 256, (yy + xx) % 256], -1).astype(np.uint8)
        lines = []
        for _ in range(0 if i == 5 else int(rng.integers(1, 4))):
            bw, bh = rng.uniform(0.2, 0.6, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            c = int(rng.integers(0, 2))
            x0, y0 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
            img[y0:y0 + int(bh * h), x0:x0 + int(bw * w)] = (200, 40, 40) if c else (40, 200, 60)
            lines.append(f"{c} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        ext = ".png" if i % 2 else ".jpg"
        cv2.imwrite(str(img_dir / f"im{i:02d}{ext}"), img[..., ::-1])
        (lbl_dir / f"im{i:02d}.txt").write_text("\n".join(lines))
    split = str(img_dir)
    return (jax_ds.YOLODataset(split, img_size=SIZE),
            port_ds.YOLODataset(split, img_size=SIZE, device="cpu"))


def test_mosaic_coordinate_equal_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        args = (int(rng.integers(0, 4)), int(rng.integers(32, 96)), int(rng.integers(32, 96)),
                int(rng.integers(1, 80)), int(rng.integers(1, 80)), 64, 64)
        assert port_mosaic.mosaic_coordinate(*args) == jax_mosaic.mosaic_coordinate(*args)


CASES = {
    "mosaic": {},
    "mixup": {"enable_mixup": True, "mixup_prob": 1.0},
    "rotate_shear_mixup": {"enable_mixup": True, "mixup_prob": 0.5, "degrees": 10.0,
                           "shear": 4.0},
    "no_mosaic": {"enable_mosaic": False},
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_getitem_equal_jax(datasets, case):
    """12 samples a case, each from default_rng([3, 77, sid]) on both
    sides: the image and the labels (values and dtype)."""
    jds, pds = datasets
    kw = dict(img_size=SIZE, enable_mosaic=True, enable_mixup=False, translate=0.1,
              mosaic_scale=(0.5, 1.5), mixup_scale=(0.5, 1.5))
    kw.update(CASES[case])
    want_ds = jax_mosaic.MosaicMixupDataset(jds, **kw)
    got_ds = port_mosaic.MosaicMixupDataset(pds, **kw)
    assert len(got_ds) == len(want_ds) == 12
    for sid in range(12):
        wi, wl = want_ds.getitem(np.random.default_rng([3, 77, sid]), sid)
        gi, gl = got_ds.getitem(np.random.default_rng([3, 77, sid]), sid)
        assert isinstance(gi, torch.Tensor) and gi.dtype == torch.uint8
        np.testing.assert_array_equal(gi.numpy(), wi, err_msg=f"{case} sample {sid}")
        np.testing.assert_array_equal(gl, wl, err_msg=f"{case} sample {sid}")
        assert gl.dtype == wl.dtype


class NoLabels:
    """A dataset view whose load_anno is empty everywhere (no label table):
    mixup's 30 draws find nothing and it returns the mosaic unchanged."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def load_anno(self, idx):
        return np.zeros((0, 5), np.float32)

    def pull_item(self, idx):
        return self.ds.pull_item(idx)


def test_mixup_without_labelled_draws_equal_jax(datasets):
    jds, pds = datasets
    want_ds = jax_mosaic.MosaicMixupDataset(NoLabels(jds), img_size=SIZE, enable_mixup=True)
    got_ds = port_mosaic.MosaicMixupDataset(NoLabels(pds), img_size=SIZE, enable_mixup=True)
    for sid in range(3):
        rng_w, rng_g = np.random.default_rng(sid), np.random.default_rng(sid)
        w_img, w_lab = want_ds.mosaic(rng_w, sid)
        g_img, g_lab = got_ds.mosaic(rng_g, sid)
        wi, wl = want_ds.mixup(rng_w, w_img, w_lab)
        gi, gl = got_ds.mixup(rng_g, g_img, g_lab)
        assert gi is g_img
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl, wl)
        assert rng_w.random() == rng_g.random()   # the same 30 draws taken
