"""Port letterbox and Predictor vs the JAX package on the CPU, and the
entry points' device rule: CUDA by default, raise when it is absent."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_kit_tpu.ops.letterbox import letterbox_device as jax_letterbox
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu_torch.models import build_model
from vision_kit_tpu_torch.ops.letterbox import letterbox_device, scale_coords
from vision_kit_tpu_torch.predictor import Predictor, load_predictor_from_config
from vision_kit_tpu_torch.utils.config import load_config
from test_torch_model import REPO, jax_v5, port_v5
from test_torch_nms import assert_same_detections

torch.set_num_threads(2)


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((720, 1280), (360, 640)),
    ((1080, 1920), (360, 640)),
    ((240, 320), (480, 640)),
    ((480, 640), (480, 640)),
])
def test_letterbox_matches_jax(src_hw, dst_hw):
    img = np.random.default_rng(1).integers(0, 255, (*src_hw, 3), dtype=np.uint8)
    want, (w_ratio, w_pad) = jax_letterbox(jnp.asarray(img), dst_hw,
                                           normalize=False)
    got, (ratio, pad) = letterbox_device(torch.from_numpy(img)[None], dst_hw,
                                         normalize=False)
    assert (ratio, pad) == (w_ratio, w_pad)
    assert tuple(got.shape) == (1, *dst_hw, 3)
    # on the 0-255 scale; without antialiasing the downscales differ by ~170
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_scale_coords_clips_and_passes_extra_columns():
    coords = torch.tensor([[-10.0, 8.0, 70.0, 40.0, 0.9, 3.0]])
    out = scale_coords((64, 64), coords, (96, 128))
    gain = 0.5
    pad = (0.0, (64 - 96 * gain) / 2)
    want = [0.0, (8.0 - pad[1]) / gain, 128.0, (40.0 - pad[1]) / gain, 0.9, 3.0]
    np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("src_hw", [(96, 128), (32, 48)])
def test_predictor_matches_jax(src_hw):
    jm, v = jax_v5("n", 64)
    tm = port_v5("n", v)
    imgs = np.random.default_rng(3).integers(0, 255, (2, *src_hw, 3),
                                             dtype=np.uint8)
    want, _ = JaxPredictor(jm, v, img_size=64, approx_topk=False).predict_batch(imgs)
    got, ms = Predictor(tm, img_size=64, device="cpu").predict_batch(imgs)
    assert ms > 0 and len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert len(w) > 10
        assert_same_detections(w, g)
        assert np.all(g[:, [0, 2]] <= src_hw[1]) and np.all(g[:, :4] >= 0)


def test_predictor_single_image_call():
    _, v = jax_v5("n", 64)
    pred = Predictor(port_v5("n", v), img_size=64, device="cpu")
    img = np.random.default_rng(4).integers(0, 255, (50, 70, 3), dtype=np.uint8)
    dets, _ = pred(img)
    batch, _ = pred.predict_batch(img[None])
    np.testing.assert_array_equal(dets, batch[0])


def test_load_predictor_from_config_on_cpu():
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version, cfg.model.input_size = "n", [64, 64]
    pred = load_predictor_from_config(cfg, device="cpu", conf_thres=0.001)
    assert pred.img_size == (64, 64)
    dets, _ = pred.predict_batch(np.zeros((1, 64, 64, 3), np.uint8))
    assert dets[0].shape[1] == 6
    with pytest.raises(ValueError, match="requires a mesh"):
        Predictor(pred.model, device="cpu", spatial=True)
    multi = Predictor(pred.model, img_size=64, device="cpu", multi_label=True,
                      conf_thres=0.001, max_cand=256)
    dets, _ = multi.predict_batch(np.zeros((1, 64, 64, 3), np.uint8))
    assert dets[0].shape[1] == 6


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the error path of a host without CUDA")
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version = "n"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_predictor_from_config(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model)
