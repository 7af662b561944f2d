"""The JAX package's Flax msgpack weights in the port, and the port's in
JAX, on the CPU (vision_kit_tpu_torch/utils/flax_msgpack.py, the inverse
bridge convert.jax_variables_from_state_dict, load_weights' `.msgpack`
and run_export's msgpack leg).

- flax.serialization.to_bytes of v5n, v7 base and v7 x variables reads
  into the tree JAX wrote, and bridges into the same state_dict, exactly.
- A JAX Trainer's best-weights tree (the EMA tree of ema_init), bf16
  leaves and chunked leaves (flax's MAX_CHUNK_SIZE made small) read; the
  port's bytes of the same trees equal flax's and flax reads them back.
- The inverse bridge equals JAX's torch_to_flax on v5n and v7 (training
  and deploy structure), and bridges back to the same state_dict.
- A model served from JAX's msgpack gives JAX's Predictor's detections;
  the port's export msgpack served by JAX's load_weights gives the port's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import msgpack
from flax import serialization

from test_torch_model import REPO, jax_v5, port_v5
from test_torch_nms import assert_same_detections
from test_torch_v7 import v7_variables
from vision_kit_tpu.convert import torch_to_flax
from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu.predictor import load_weights as jax_load_weights
from vision_kit_tpu.train.ema import ema_init
from vision_kit_tpu_torch import export
from vision_kit_tpu_torch.convert import (
    deploy_state_dict,
    jax_variables_from_state_dict,
    state_dict_from_jax_variables,
)
from vision_kit_tpu_torch.models import YOLOV5, YOLOV7, build_model
from vision_kit_tpu_torch.predictor import load_predictor_from_config, load_weights
from vision_kit_tpu_torch.utils import flax_msgpack
from vision_kit_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

SIZE = 64


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def assert_same_tree(want, got, path=""):
    """Two trees equal: the same keys, and leaves of one dtype, shape and
    value (a bf16 leaf on either side compared as its bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), path
        for k in want:
            assert_same_tree(want[k], got[k], f"{path}/{k}")
        return
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16, path
        got = got.view(torch.int16).numpy()
        want = np.asarray(want).view(np.int16)
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def assert_same_state_dict(want: dict, got: dict):
    assert set(want) == set(got)
    for k, t in want.items():
        assert torch.equal(got[k], t), k


@pytest.mark.parametrize("variant", ["v5n", "v7base", "v7x"])
def test_reads_jax_to_bytes(variant):
    if variant == "v5n":
        _, v = jax_v5("n", SIZE)
    else:
        v = v7_variables(variant[2:])
    data = serialization.to_bytes(v)
    got = flax_msgpack.msgpack_restore(data)
    assert_same_tree(numpy_tree(v), got)
    assert_same_state_dict(state_dict_from_jax_variables(v),
                           state_dict_from_jax_variables(flax_msgpack.variables_of(got)))
    # the port writes the bytes flax writes, and flax reads them back
    assert flax_msgpack.to_bytes(got) == data
    assert_same_tree(numpy_tree(v), serialization.msgpack_restore(flax_msgpack.to_bytes(got)))


def test_reads_trainer_ema_tree_bf16_and_chunked_leaves(tmp_path, monkeypatch):
    _, v = jax_v5("n", SIZE)
    ema = ema_init({"params": v["params"], "batch_stats": v["batch_stats"]})
    # the JAX Trainer's best weights: to_bytes of the EMA tree
    path = str(tmp_path / "best-map50_0.5000.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(jax.device_get(ema.tree)))
    model = YOLOV5("n")
    load_weights(path, model)
    want = port_v5("n", v).state_dict()
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k]), k

    # bf16 leaves, a numpy scalar, a complex, int keys and nesting
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    tree = {"params": bf["params"], "batch_stats": bf["batch_stats"],
            "step": np.int32(7), "z": 1.5 - 2j, "flag": True, "name": "ema"}
    data = serialization.to_bytes(tree)
    got = flax_msgpack.msgpack_restore(data)
    assert_same_tree(numpy_tree(bf), {k: got[k] for k in ("params", "batch_stats")})
    assert got["step"] == 7 and got["step"].dtype == np.int32
    assert got["z"] == 1.5 - 2j and got["flag"] is True and got["name"] == "ema"
    assert flax_msgpack.to_bytes(got) == data
    model16 = YOLOV5("n")
    bfpath = str(tmp_path / "bf16.msgpack")
    with open(bfpath, "wb") as f:
        f.write(data)
    load_weights(bfpath, model16)
    for k, t in model16.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, want[k].bfloat16().float()), k
    # int keys, as flax's msgpack_serialize (not to_bytes) keeps them
    ints = msgpack.packb({1: np.arange(3), "k": [1, -2, 300]},
                         default=serialization._msgpack_ext_pack, strict_types=True)
    got = flax_msgpack.msgpack_restore(ints)
    np.testing.assert_array_equal(got[1], np.arange(3))
    assert got["k"] == [1, -2, 300]

    # a chunked leaf, hand-built by flax with a small chunk size, both ways
    big = {"w": np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32),
           "b": jnp.asarray(np.arange(40), jnp.bfloat16)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    data = serialization.to_bytes(big)
    assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.msgpack_restore(data)
    assert_same_tree(numpy_tree(big), got)
    mine = flax_msgpack.to_bytes(got)
    assert mine == data
    assert_same_tree(numpy_tree(big), serialization.msgpack_restore(mine))


def test_refuses_what_is_not_flax_msgpack(tmp_path):
    with pytest.raises(ValueError, match="ends at byte"):
        flax_msgpack.msgpack_restore(serialization.to_bytes({"a": np.ones(3)})[:-2])
    with pytest.raises(ValueError, match="after the msgpack object"):
        flax_msgpack.msgpack_restore(serialization.to_bytes({"a": 1}) + b"\x00")
    path = str(tmp_path / "x.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes({"weights": np.ones(3)}))
    with pytest.raises(ValueError, match="not a Flax variables tree"):
        load_weights(path, YOLOV5("n"))


@pytest.mark.parametrize("variant", ["v5n", "v7base", "v7base_deploy"])
def test_inverse_bridge_matches_jax_torch_to_flax(variant):
    if variant == "v5n":
        _, v = jax_v5("n", SIZE)
        sd = port_v5("n", v).state_dict()
    else:
        sd = state_dict_from_jax_variables(v7_variables("base"))
        if variant.endswith("deploy"):
            sd = deploy_state_dict(sd)
            model = YOLOV7("base", deploy=True)
            model.load_state_dict(sd, strict=True)
            sd = model.state_dict()
    got = jax_variables_from_state_dict(sd)
    assert_same_tree(numpy_tree(torch_to_flax(sd)), got)
    back = state_dict_from_jax_variables(got)
    assert_same_state_dict({k: t.float() if t.is_floating_point() else t
                            for k, t in sd.items()}, back)


def test_served_from_jax_msgpack_matches_jax_predictor(tmp_path):
    """JAX's msgpack served by the port equals JAX's Predictor on it; the
    port's export msgpack read by JAX's load_weights serves the port's
    detections in JAX."""
    jm, v = jax_v5("n", SIZE)
    path = str(tmp_path / "yolov5_n.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(v))
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes, cfg.model.input_size = "n", 80, [SIZE, SIZE]
    pred = load_predictor_from_config(cfg, weights=path, device="cpu", seed=3)
    imgs = np.random.default_rng(5).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    got, _ = pred.predict_batch(imgs)
    want, _ = JaxPredictor(jm, v, img_size=SIZE, approx_topk=False).predict_batch(imgs)
    for w, g in zip(want, got):
        assert len(w) > 10
        assert_same_detections(w, g)

    res = export.run_export(cfg, pred.model, str(tmp_path / "export"), onnx=False,
                            torchscript=False)
    assert res.checks["msgpack"] == 0.0
    template = numpy_tree(JaxYOLOV5(variant="n", num_classes=80).init(
        jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)), training=False))
    jv = jax_load_weights(res.artifacts["msgpack"], template)
    assert_same_tree(numpy_tree(v), numpy_tree(jv))
    again, _ = JaxPredictor(jm, jv, img_size=SIZE, approx_topk=False).predict_batch(imgs)
    for w, g in zip(again, got):
        assert_same_detections(w, g)


def test_export_msgpack_leg_of_a_bf16_model(tmp_path):
    """The leg writes f32 Flax variables of any model dtype, reloaded exactly
    and equal to the model's weights."""
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version, cfg.model.input_size = "n", [SIZE, SIZE]
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16, seed=2)
    res = export.run_export(cfg, model, str(tmp_path), onnx=False, torchscript=False)
    assert res.checks["msgpack"] == 0.0
    tree = flax_msgpack.read_file(res.artifacts["msgpack"])
    assert tree["params"]["backbone"]["stem"]["conv"]["kernel"].dtype == np.float32
    back = state_dict_from_jax_variables(tree)
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t.float()), k
