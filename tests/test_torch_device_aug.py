"""Port (vision_kit_tpu_torch) vs JAX package on the CPU: the device
augmentation warp_augment on seeded tiles and parameter rows, in f32.

Cases: integer and fractional affine mosaics with ragged tiles, a plain
centre-padded sample, mixup with and without its flip, HSV, flips, a
4-slot buffer (mixup skipped), and a 4-image batch mixing them all. The
outputs are on the [0, 1] scale; tolerance 1e-5 (products of 0-255 pixels
by bilinear weights summed in another order, and HSV's divisions)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_kit_tpu.data import device_aug as jda
from vision_kit_tpu_torch.data import device_aug as tda
from vision_kit_tpu_torch.utils.stream_bench import daug_batch

torch.set_num_threads(2)

S = 48
TOL = 1e-5


def test_layout_constants_match_jax():
    names = [n for n in dir(jda) if n.startswith("P_")] + ["N_PARAMS", "N_TILES",
                                                            "PAD_VALUE"]
    assert len(names) == 20
    for name in names:
        assert getattr(tda, name) == getattr(jda, name), name


def base_params():
    p = np.zeros(tda.N_PARAMS, np.float32)
    p[tda.P_SCALE] = 1.0
    p[[tda.P_HSV_H, tda.P_HSV_S, tda.P_HSV_V]] = 1.0
    p[tda.P_MIX_JIT] = 1.0
    p[tda.P_MIX_OW] = p[tda.P_MIX_OH] = S
    return p


def sample(rng, case):
    """(tiles (N_TILES, S, S, 3) u8, tile_hw (N_TILES, 2), params) of one
    image for `case`."""
    tiles = rng.integers(0, 255, (tda.N_TILES, S, S, 3), dtype=np.uint8)
    hw = np.full((tda.N_TILES, 2), S, np.int32)
    hw[1] = (S - 7, S)
    hw[2] = (S, S - 11)
    hw[3] = (S - 3, S - 5)
    p = base_params()
    p[tda.P_XC] = rng.integers(S // 2, 3 * S // 2)
    p[tda.P_YC] = rng.integers(S // 2, 3 * S // 2)
    if case == "integer_affine":
        p[tda.P_TX], p[tda.P_TY] = -5.0, 7.0
    elif case in ("fractional_affine", "mixup", "mixup_flip", "hsv"):
        p[tda.P_SCALE] = rng.uniform(0.6, 1.4)
        p[tda.P_TX], p[tda.P_TY] = rng.uniform(-0.1, 0.1, 2) * S
    if case == "plain":
        h, w = 30, S
        hw[0] = (h, w)
        p[tda.P_XC], p[tda.P_YC] = 2 * S, 2 * S
        p[tda.P_TX] = (S - w) // 2 - (2 * S - w)
        p[tda.P_TY] = (S - h) // 2 - (2 * S - h)
    if case.startswith("mixup"):
        jit = 1.3 if case == "mixup" else 0.7
        p[tda.P_MIX_W] = 0.5
        p[tda.P_MIX_JIT] = jit
        p[tda.P_MIX_OW] = p[tda.P_MIX_OH] = int(S * jit)
        p[tda.P_MIX_XOFF] = max(int(S * jit) - S, 0) // 2
        p[tda.P_MIX_YOFF] = max(int(S * jit) - S, 0) // 3
        p[tda.P_MIX_FLIP] = float(case == "mixup_flip")
    if case == "hsv":
        p[[tda.P_HSV_H, tda.P_HSV_S, tda.P_HSV_V]] = [1.012, 1.31, 0.78]
    if case == "flips":
        p[tda.P_FLIP_LR] = p[tda.P_FLIP_UD] = 1.0
    return tiles, hw, p


def both(tiles, hw, params):
    want = np.asarray(jda.warp_augment(jnp.asarray(tiles), jnp.asarray(hw),
                                       jnp.asarray(params)))
    got = tda.warp_augment(torch.from_numpy(tiles), torch.from_numpy(hw),
                           torch.from_numpy(params))
    assert got.dtype == torch.float32 and got.shape == want.shape
    return want, got.numpy()


CASES = ["integer_affine", "fractional_affine", "plain", "mixup", "mixup_flip",
         "hsv", "flips"]


@pytest.mark.parametrize("case", CASES)
def test_warp_augment_matches_jax(case):
    tiles, hw, p = sample(np.random.default_rng(CASES.index(case)), case)
    want, got = both(tiles[None], hw[None], p[None])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert 0.0 <= got.min() and got.max() <= 1.0 + TOL


def test_warp_augment_batch_matches_jax():
    """Four images, each its own case, in one call; and the same batch on a
    4-slot buffer (the mixup resample skipped)."""
    rng = np.random.default_rng(11)
    rows = [sample(rng, c) for c in ("fractional_affine", "mixup_flip", "hsv", "plain")]
    tiles, hw, p = (np.stack(x) for x in zip(*rows))
    want, got = both(tiles, hw, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    want4, got4 = both(np.ascontiguousarray(tiles[:, :4]), hw[:, :4], p)
    np.testing.assert_allclose(got4, want4, rtol=0, atol=TOL)


def test_bench_daug_batch_matches_jax():
    """tools/bench_train.py's daug regime (daug_batch): fractional affine,
    HSV and mixup on every image."""
    b = daug_batch(np.random.default_rng(3), 2, S)
    want, got = both(b["tiles"], b["tile_hw"], b["params"])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_unity_sample_passes_pixels_through():
    """Plain sample, no HSV or flip: the output is the tile / 255 exactly
    where it covers the frame, 114 / 255 elsewhere."""
    rng = np.random.default_rng(4)
    tiles, hw, p = sample(rng, "plain")
    got = tda.warp_augment(torch.from_numpy(tiles[None]), torch.from_numpy(hw[None]),
                           torch.from_numpy(p[None]))[0].numpy() * 255.0
    top = (S - 30) // 2
    np.testing.assert_allclose(got[top:top + 30], tiles[0, :30].astype(np.float32),
                               atol=1e-3)
    np.testing.assert_allclose(got[:top], 114.0, atol=1e-3)
