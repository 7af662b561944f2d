"""Port (vision_kit_tpu_torch.ops.imgproc, data/augment.py) vs OpenCV and
the JAX package on the CPU: each cv2 op of the host-augmentation route
against cv2 itself, and each augmentation against JAX's
(vision_kit_tpu/data/augment.py) from the same numpy-seeded generator.
Everything is compared bit for bit: every op here equals cv2 exactly,
the Lab conversions and CLAHE included.
"""

import math

import cv2
import numpy as np
import pytest
import torch

from vision_kit_tpu.data import augment as jax_aug
from vision_kit_tpu_torch.data import augment as port_aug
from vision_kit_tpu_torch.ops import imgproc

torch.set_num_threads(2)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def scene(rng, h, w):
    """Noise over smooth gradients and flat rectangles: flat runs, edges and
    every level, for the filters and the warp."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                    (yy + xx) * 127 // max(h + w - 2, 1)], -1).astype(np.int64)
    img = img + rng.integers(-20, 21, (h, w, 3))
    for _ in range(4):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + h // 4, x:x + w // 4] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def colours(n, seed=0):
    """n seeded RGB triples plus the greys and the primaries, as (k, 1, 3)."""
    rng = np.random.default_rng(seed)
    g = np.arange(256, dtype=np.uint8)
    corners = np.array([[a, b, c] for a in (0, 255) for b in (0, 255) for c in (0, 255)],
                       np.uint8)
    return np.concatenate([rng.integers(0, 256, (n, 3), dtype=np.uint8),
                           np.stack([g, g, g], 1), corners])[:, None, :]


@pytest.mark.parametrize("src_hw,dsize,degrees,shear,scales", [
    ((160, 160), (96, 96), 10.0, 5.0, (0.5, 0.9)),      # square, shrink
    ((120, 200), (160, 96), 30.0, 10.0, (1.2, 1.8)),    # non-square, enlarge
    ((96, 64), (80, 112), 0.0, 0.0, (0.5, 1.5)),        # translate and scale only
    ((1280, 1280), (640, 640), 5.0, 2.0, (0.5, 1.5)),   # the mosaic canvas at 640
], ids=["square", "non_square", "no_rotation", "canvas_640"])
@pytest.mark.parametrize("seed", [0, 1])
def test_warp_affine_equal_cv2(src_hw, dsize, degrees, shear, scales, seed):
    rng = np.random.default_rng(seed)
    img = scene(rng, *src_hw)
    M, _ = jax_aug.get_affine_matrix(rng, dsize, degrees, 0.1, scales, shear)
    want = cv2.warpAffine(img, M, dsize=dsize, borderValue=(114, 114, 114))
    got = imgproc.warp_affine_u8(t(img), M, dsize, 114)
    np.testing.assert_array_equal(got.numpy(), want)


def test_warp_affine_any_width_equal_cv2():
    """300 seeded output sizes from 1 to 130 wide: OpenCV's vector body
    takes 16 pixels a step and its scalar code the rest of each row, with
    another order of the coordinate's fma (imgproc.WARP_BLOCK)."""
    rng = np.random.default_rng(7)
    img = scene(rng, 70, 90)
    for _ in range(300):
        dsize = (int(rng.integers(1, 131)), int(rng.integers(1, 41)))
        M, _ = jax_aug.get_affine_matrix(rng, dsize, 10.0, 0.1, (0.5, 1.5), 5.0)
        want = cv2.warpAffine(img, M, dsize=dsize, borderValue=(114, 114, 114))
        np.testing.assert_array_equal(imgproc.warp_affine_u8(t(img), M, dsize).numpy(),
                                      want, err_msg=str(dsize))


def test_affine_matrix_equal_cv2_and_jax():
    """getRotationMatrix2D at the origin, and get_affine_matrix's draws and
    matrix, equal bit for bit."""
    rng = np.random.default_rng(0)
    for angle, scale in zip(rng.uniform(-180, 180, 50), rng.uniform(0.3, 2.0, 50)):
        want = cv2.getRotationMatrix2D(angle=float(angle), center=(0, 0), scale=float(scale))
        got = port_aug.rotation_matrix(float(angle), float(scale))
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
    for seed in range(5):
        for kw in ({}, {"degrees": 0.0, "shear": 0.0, "scales": (0.5, 1.5)}):
            want = jax_aug.get_affine_matrix(np.random.default_rng(seed), (64, 48), **kw)
            got = port_aug.get_affine_matrix(np.random.default_rng(seed), (64, 48), **kw)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
    M = np.array([[1.2, 0.3, 5.0], [-0.1, 0.8, -3.0]])
    np.testing.assert_array_equal(imgproc.invert_affine(M), cv2.invertAffineTransform(M))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_affine_equal_jax(seed):
    rng = np.random.default_rng(100 + seed)
    img = scene(rng, 128, 128)
    labels = np.concatenate([rng.uniform(0, 60, (5, 2)), rng.uniform(60, 128, (5, 2)),
                             rng.integers(0, 3, (5, 1))], 1).astype(np.float32)
    labels = labels[:, [0, 1, 2, 3, 4]]
    kw = dict(target_size=(64, 64), degrees=10.0, translate=0.1, scales=(0.5, 1.5),
              shear=3.0)
    want_img, want_lab = jax_aug.random_affine(np.random.default_rng(seed), img, labels, **kw)
    got_img, got_lab = port_aug.random_affine(np.random.default_rng(seed), t(img), labels, **kw)
    np.testing.assert_array_equal(got_img.numpy(), want_img)
    np.testing.assert_array_equal(got_lab, want_lab)
    assert got_lab.dtype == want_lab.dtype == np.float32


def test_rgb2hsv_equal_cv2():
    """1 M seeded colours, the greys and the primaries."""
    c = colours(1 << 20)
    np.testing.assert_array_equal(imgproc.rgb2hsv_u8(t(c)).numpy(),
                                  cv2.cvtColor(c, cv2.COLOR_RGB2HSV))


def test_hsv2rgb_equal_cv2():
    """1 M seeded (h, s, v) triples with h over 0..255 (a LUT's hue wraps
    past 180), and every hue at s, v in {0, 1, 254, 255}."""
    rng = np.random.default_rng(1)
    edge = np.array([[h, s, v] for h in range(256) for s in (0, 1, 254, 255)
                     for v in (0, 1, 254, 255)], np.uint8)
    hsv = np.concatenate([rng.integers(0, 256, (1 << 20, 3), dtype=np.uint8), edge])[:, None]
    np.testing.assert_array_equal(imgproc.hsv2rgb_u8(t(hsv)).numpy(),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_hsv2rgb_any_width_equal_cv2():
    """Widths 1 to 70 and 427: OpenCV's vector body (32 pixels a step)
    truncates, the scalar code that takes each row's tail rounds."""
    rng = np.random.default_rng(8)
    for w in list(range(1, 71)) + [427]:
        hsv = rng.integers(0, 256, (40, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(imgproc.hsv2rgb_u8(t(hsv)).numpy(),
                                      cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), err_msg=str(w))


def test_lut_equal_cv2():
    rng = np.random.default_rng(2)
    img = scene(rng, 40, 50)
    luts = [rng.integers(0, 256, 256, dtype=np.uint8) for _ in range(3)]
    want = cv2.merge([cv2.LUT(ch, lut) for ch, lut in zip(cv2.split(img), luts)])
    np.testing.assert_array_equal(imgproc.lut_u8(t(img), luts).numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_augment_hsv_equal_jax(seed):
    img = scene(np.random.default_rng(seed), 96, 80)
    want = jax_aug.augment_hsv(np.random.default_rng(seed), img)
    got = port_aug.augment_hsv(np.random.default_rng(seed), t(img))
    np.testing.assert_array_equal(got.numpy(), want)


def test_flips_and_pad_equal_jax():
    rng = np.random.default_rng(5)
    img = scene(rng, 30, 44)
    labels = np.array([[1.5, 2.0, 20.25, 17.0, 1.0], [0.0, 0.0, 44.0, 30.0, 0.0]], np.float32)
    for fn in ("flip_lr", "flip_ud"):
        wi, wl = getattr(jax_aug, fn)(img, labels)
        gi, gl = getattr(port_aug, fn)(t(img), labels)
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl, wl)
    for dst in ((30, 44), (64, 64), (31, 80), (20, 50)):
        wi, wl = jax_aug.pad_to(img, labels, dst)
        gi, gl = port_aug.pad_to(t(img), labels, dst)
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl, wl)
    empty = np.zeros((0, 5), np.float32)
    assert port_aug.flip_lr(t(img), empty)[1].shape == (0, 5)
    want = cv2.copyMakeBorder(img, 1, 2, 3, 4, cv2.BORDER_CONSTANT, value=(114,) * 3)
    np.testing.assert_array_equal(imgproc.copy_make_border_u8(t(img), 1, 2, 3, 4).numpy(),
                                  want)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_blur_and_median_equal_cv2(k):
    rng = np.random.default_rng(k)
    for h, w in ((64, 64), (37, 53), (9, 8)):
        img = scene(rng, h, w)
        np.testing.assert_array_equal(imgproc.blur_u8(t(img), (k, k)).numpy(),
                                      cv2.blur(img, (k, k)))
        np.testing.assert_array_equal(imgproc.median_blur_u8(t(img), k).numpy(),
                                      cv2.medianBlur(img, k))


def test_gray_equal_cv2():
    c = colours(1 << 20, seed=3)
    gray = imgproc.rgb2gray_u8(t(c))
    np.testing.assert_array_equal(gray.numpy(), cv2.cvtColor(c, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(imgproc.gray2rgb_u8(gray).numpy(),
                                  cv2.cvtColor(gray.numpy(), cv2.COLOR_GRAY2RGB))


def test_lab_equal_cv2():
    """RGB2LAB over 1 M seeded colours with the greys and primaries, and
    LAB2RGB over 1 M seeded (L, a, b) triples with the grey axis."""
    c = colours(1 << 20, seed=4)
    np.testing.assert_array_equal(imgproc.rgb2lab_u8(t(c)).numpy(),
                                  cv2.cvtColor(c, cv2.COLOR_RGB2LAB))
    g = np.arange(256, dtype=np.uint8)
    grey = np.stack([g, np.full_like(g, 128), np.full_like(g, 128)], 1)
    lab = np.concatenate([np.random.default_rng(5).integers(0, 256, (1 << 20, 3),
                                                            dtype=np.uint8), grey])[:, None]
    np.testing.assert_array_equal(imgproc.lab2rgb_u8(t(lab)).numpy(),
                                  cv2.cvtColor(lab, cv2.COLOR_LAB2RGB))


@pytest.mark.parametrize("hw", [(64, 64), (100, 77), (37, 320), (320, 200)])
def test_clahe_equal_cv2(hw):
    """clipLimit 4, 8x8 tiles: sides that divide into the grid and sides
    that are padded (reflect-101), on noise and on a smooth scene."""
    rng = np.random.default_rng(hw[0])
    clahe = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8))
    for gray in (rng.integers(0, 256, hw, dtype=np.uint8),
                 cv2.cvtColor(scene(rng, *hw), cv2.COLOR_RGB2GRAY)):
        np.testing.assert_array_equal(imgproc.clahe_u8(t(gray), 4.0, (8, 8)).numpy(),
                                      clahe.apply(gray))


class ZeroRandom:
    """A Generator whose random() is 0.0, so that every p-gate fires; its
    other draws are the wrapped generator's."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def random(self, *args, **kwargs):
        return 0.0

    def __getattr__(self, name):
        return getattr(self.rng, name)


@pytest.mark.parametrize("seed", range(3))
def test_train_pipeline_all_gates_equal_jax(seed):
    """TrainAugPipeline with blur, median, gray, CLAHE, HSV and both flips
    all firing, then the pad to 96x80."""
    rng = np.random.default_rng(seed)
    img = scene(rng, 64, 72)
    labels = np.array([[3.0, 4.5, 30.0, 40.0, 1.0], [10.0, 0.0, 72.0, 20.5, 0.0]], np.float32)
    kw = dict(flip_lr_prob=0.5, flip_ud_prob=0.5, hsv_prob=1.0, img_sz=(96, 80))
    wi, wl = jax_aug.TrainAugPipeline(**kw)(ZeroRandom(seed), img, labels)
    gi, gl = port_aug.TrainAugPipeline(**kw)(ZeroRandom(seed), t(img), labels)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("seed", range(3))
def test_pixel_augs_clahe_on_colour_equal_jax(seed):
    """CLAHE through Lab on a colour image (gray skipped): draws in the
    JAX order, gates by a scripted random()."""

    class Scripted(ZeroRandom):
        def __init__(self, seed, values):
            super().__init__(seed)
            self.values = list(values)

        def random(self, *args, **kwargs):
            return self.values.pop(0)

    img = scene(np.random.default_rng(seed), 80, 64)
    gates = (0.0, 0.5, 0.5, 0.0)   # blur, no median, no gray, CLAHE
    want = jax_aug.pixel_augs(Scripted(seed, gates), img)
    got = port_aug.pixel_augs(Scripted(seed, gates), t(img))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rand_and_bboxes_equal_jax():
    for value, center in ((10.0, 0.0), ((0.5, 1.5), 1.0), (3, 1.0)):
        assert port_aug._rand(np.random.default_rng(0), value, center) == \
            jax_aug._rand(np.random.default_rng(0), value, center)
    rng = np.random.default_rng(6)
    boxes = np.sort(rng.uniform(0, 100, (7, 4)).astype(np.float32).reshape(7, 2, 2), 1)
    boxes = boxes.transpose(0, 2, 1).reshape(7, 4)[:, [0, 2, 1, 3]]
    M = np.array([[math.cos(0.3), math.sin(0.3), 4.0], [-math.sin(0.3), math.cos(0.3), -2.0]])
    np.testing.assert_array_equal(port_aug.apply_affine_to_bboxes(boxes, (80, 60), M),
                                  jax_aug.apply_affine_to_bboxes(boxes, (80, 60), M))
