"""Checkpoints and weight import: the port's readers, load_weights and key
order against the JAX package on the CPU, and the port's TrainState
checkpoint.

Every `.pt` is written inside the test from seeded JAX variables through
the JAX package's own flax_to_torch: a plain state_dict, one under
"model", a Lightning checkpoint (`model.` weights beside `ema_model.` EMA
weights, which win), an upstream-ordered file (upstream-style names in the
reference order, fp16, with anchors and anchor_grid), and v7 training
weights loaded into a deploy model. Each file is loaded by both packages
(vision_kit_tpu.predictor.load_weights and the port's) and the two models'
outputs compared, as test_torch_model compares them (1e-4).

The key-order test hands JAX's vision_kit_key_order the Flax tree exactly
as init builds it: the tree is captured inside the traced init, because
jax.eval_shape, jax.jit and jax.device_get return dicts with sorted keys
(and a sorted tree starts at backbone.stage1.0.bn.weight)."""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.convert import flax_to_torch
from vision_kit_tpu.convert import load_upstream_checkpoint as jax_load_upstream
from vision_kit_tpu.convert import torch_to_flax
from vision_kit_tpu.convert import upstream_to_vision_kit as jax_upstream_to_vk
from vision_kit_tpu.convert import vision_kit_key_order as jax_key_order
from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
from vision_kit_tpu.models import YOLOV7 as JaxYOLOV7
from vision_kit_tpu.predictor import load_weights as jax_load_weights
from vision_kit_tpu_torch.convert import (
    deploy_state_dict,
    load_upstream_checkpoint,
    state_dict_from_jax_variables,
    upstream_to_vision_kit,
    vision_kit_key_order,
)
from vision_kit_tpu_torch.models import YOLOV5, YOLOV7, build_model
from vision_kit_tpu_torch.predictor import Predictor, load_predictor_from_config, load_weights
from vision_kit_tpu_torch.train import optim
from vision_kit_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from vision_kit_tpu_torch.train.losses import YoloLoss
from vision_kit_tpu_torch.train.step import create_train_state, make_train_step
from vision_kit_tpu_torch.utils.config import load_config
from vision_kit_tpu_torch.utils.stream_bench import TRAIN_HYP, train_state_tensors
from test_torch_model import REPO, randomize_bn
from test_torch_nms import assert_same_detections
from test_torch_train import step_batches
from test_torch_v7 import fill_variables, v7_shapes

torch.set_num_threads(2)

SIZE = 64
TOL = 1e-4


def init_tree(jm, size=SIZE):
    """The Flax variables as `jm.init` builds them, keys in insertion
    order, captured inside an abstract trace (no compile; the leaves are
    tracers, and only the tree's structure is read)."""
    box = {}

    def init(x):
        box["tree"] = jm.init(jax.random.PRNGKey(0), x, training=False)
        return 0

    jax.eval_shape(init, jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    return box["tree"]


@functools.cache
def seeded_v5n(num_classes=80):
    """A JAX v5n@64 and numpy variables with crowded detections: jit init,
    random BatchNorm, zero head biases and head kernels scaled to unit
    logit spread (test_torch_model.jax_v5's recipe, jitted)."""
    jm = JaxYOLOV5(variant="n", num_classes=num_classes)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, training=False))(
        jnp.zeros((1, SIZE, SIZE, 3)))
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    randomize_bn(v, np.random.default_rng(0))
    head = v["params"]["head"]
    for i in range(3):
        head[f"m_{i}"]["bias"] = np.zeros_like(head[f"m_{i}"]["bias"])
    probe = np.random.default_rng(1).integers(0, 255, (1, SIZE, SIZE, 3), np.uint8)
    _, raws = jax_apply(jm)(v, probe)
    for i, raw in enumerate(raws):
        head[f"m_{i}"]["kernel"] = (head[f"m_{i}"]["kernel"]
                                    / np.asarray(raw).std()).astype(np.float32)
    return jm, v


@functools.cache
def jax_apply(jm):
    fn = jax.jit(lambda v, x: jm.apply(v, x, training=False))
    return lambda v, x: fn(v, jnp.asarray(x))


def frames(seed=7, n=2):
    return np.random.default_rng(seed).integers(0, 255, (n, SIZE, SIZE, 3), np.uint8)


def assert_outputs_agree(jm, jvars, model, x, tol=TOL):
    """JAX's decoded output and raw maps equal the port's."""
    jd, jr = jax_apply(jm)(jvars, x)
    with torch.no_grad():
        td, tr = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol, atol=tol)


def torch_sd(variables, half=False):
    return {k: torch.from_numpy(np.ascontiguousarray(a))
            for k, a in flax_to_torch(variables, half=half).items()}


def jax_template(num_classes=80):
    """Numpy variables of a JAX v5n@64 of num_classes, filled from a seed
    (their values are only kept where a load skips)."""
    jm = JaxYOLOV5(variant="n", num_classes=num_classes)
    return fill_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), training=False)))


# -- key order ---------------------------------------------------------------

@pytest.mark.parametrize("family,variant", [
    ("v5", "n"), ("v5", "s"), ("v5", "m"), ("v5", "l"), ("v5", "x"),
    ("v7", "base"), ("v7", "x")])
def test_key_order_matches_jax(family, variant):
    """The port's vision_kit_key_order of its own model equals JAX's of the
    init tree, key for key; for v5 the port's registration order differs
    (its C3 registers m before conv3), so the reorder is needed."""
    if family == "v5":
        jm, model = JaxYOLOV5(variant=variant), YOLOV5(variant)
    else:
        jm, model = JaxYOLOV7(variant=variant), YOLOV7(variant)
    want = jax_key_order(init_tree(jm))
    assert vision_kit_key_order(model) == want
    assert vision_kit_key_order(model.state_dict().keys()) == want
    own = list(model.state_dict())
    assert sorted(own) == sorted(want)
    if family == "v5":
        assert own[24] == "backbone.stage1.1.m.0.conv1.conv.weight"
        assert want[24] == "backbone.stage1.1.conv3.conv.weight"


def test_sorted_tree_gives_another_order():
    """Why init_tree: a tree with sorted keys (what jax.eval_shape returns)
    gives JAX's function another order."""
    jm = JaxYOLOV5(variant="n")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), training=False))
    assert jax_key_order(shapes)[0] == "backbone.stage1.0.bn.weight"
    assert jax_key_order(init_tree(jm))[0] == "backbone.stem.conv.weight"


# -- checkpoint forms in both packages ---------------------------------------

def _write(path, form, variables):
    sd = torch_sd(variables)
    if form == "plain":
        torch.save(sd, path)
    elif form == "model":
        torch.save({"model": sd, "epoch": 3}, path)
    elif form == "lightning":
        # the training weights (head kernels halved) beside the EMA, which wins
        stale = {k: v * 0.5 if k.startswith("head.m.") else v for k, v in sd.items()}
        state = {f"model.{k}": v for k, v in stale.items()}
        state.update({f"ema_model.module.{k}": v for k, v in sd.items()})
        torch.save({"state_dict": state, "epoch": 3, "global_step": 30}, path)
    else:
        raise ValueError(form)


@pytest.mark.parametrize("form", ["plain", "model", "lightning"])
def test_checkpoint_forms_load_alike(tmp_path, form):
    jm, v = seeded_v5n()
    path = str(tmp_path / "w.pt")
    _write(path, form, v)
    jvars = jax_load_weights(path, jax_template())
    model = load_weights(path, YOLOV5("n"))
    assert_outputs_agree(jm, jvars, model, frames())
    # and both equal the variables written
    assert_outputs_agree(jm, v, model, frames(8))


def upstream_file(path, variables, jm):
    """An upstream-style fp16 state_dict: `model.<i>.<leaf>` names in the
    reference's declaration order, with the head's anchors and anchor_grid
    buffers ahead of its convs, as a Detect module registers them."""
    sd = flax_to_torch(variables, half=True)
    order = jax_key_order(init_tree(jm))
    out = {}
    for i, key in enumerate(order):
        if key == "head.m.0.weight":
            out["model.24.anchors"] = torch.ones(3, 3, 2, dtype=torch.float16)
            out["model.24.anchor_grid"] = torch.ones(3, 1, 3, 1, 1, 2,
                                                     dtype=torch.float16)
        out[f"model.{i}.{key.rsplit('.', 1)[1]}"] = torch.from_numpy(
            np.ascontiguousarray(sd[key]))
    torch.save({"model": out}, path)


def test_upstream_checkpoint_loads_alike(tmp_path):
    """The positional zip-map in both packages: the same fp16 values land
    on the same keys, and the models agree."""
    jm, v = seeded_v5n()
    path = str(tmp_path / "upstream.pt")
    upstream_file(path, v, jm)
    raw = load_upstream_checkpoint(path)
    assert list(raw)[:2] == ["model.0.weight", "model.1.weight"]
    assert all(t.dtype == torch.float32 for t in raw.values())
    model = YOLOV5("n")
    sd = upstream_to_vision_kit(raw, model)
    want = jax_upstream_to_vk(jax_load_upstream(path), init_tree(jm))
    assert list(sd) == list(want)
    for k, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    model.load_state_dict(sd, strict=True)
    jvars = torch_to_flax(want, template=jax_template(), strict=True)
    assert_outputs_agree(jm, jvars, model, frames())
    # a count mismatch names the leftovers, as JAX's does
    del raw[list(raw)[5]]
    with pytest.raises(ValueError, match="347 tensors but the model expects 348"):
        upstream_to_vision_kit(raw, model)


def test_v7_training_weights_into_deploy(tmp_path):
    """v7 base training weights load into a deploy model with the RepConv
    and implicit folds, in both packages; v7 x (whose deploy structure
    lacks only the implicits) folds the same way: its load equals the
    in-memory deploy_state_dict (to 1e-6: the fold's matrix product may
    round otherwise on other memory)."""
    v = fill_variables(v7_shapes("base"), seed=1)
    path = str(tmp_path / "v7.pt")
    torch.save({"model": torch_sd(v)}, path)
    jm = JaxYOLOV7(variant="base", num_classes=80, deploy=True)
    jvars = jax_load_weights(path, fill_variables(v7_shapes("base", deploy=True)))
    model = load_weights(path, YOLOV7("base", deploy=True))
    assert_outputs_agree(jm, jvars, model, frames(), tol=1e-3)

    vx = fill_variables(v7_shapes("x"), seed=2)
    torch.save({"model": torch_sd(vx)}, path)
    model = load_weights(path, YOLOV7("x", deploy=True))
    want = deploy_state_dict(state_dict_from_jax_variables(vx))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, t in want.items():
        torch.testing.assert_close(got[k], t, rtol=1e-6, atol=1e-6, msg=k)


# -- partial and strict loads --------------------------------------------------

def _skip_count(message):
    return int(re.search(r"cover the model: (\d+)", message).group(1))


@pytest.mark.parametrize("case", ["80_to_3_classes", "missing_entries"])
def test_strict_load_miss_count_equals_jax(tmp_path, case):
    """A strict load raises with the count of missed or mis-shaped entries,
    the count JAX gives for the same file."""
    _, v = seeded_v5n()
    sd = torch_sd(v)
    nc = 3 if case == "80_to_3_classes" else 80
    if case == "missing_entries":
        for k in list(sd)[10:15] + ["backbone.stage1.0.bn.num_batches_tracked"]:
            del sd[k]
    path = str(tmp_path / "w.pt")
    torch.save(sd, path)
    with pytest.raises(ValueError) as jax_err:
        jax_load_weights(path, jax_template(nc))
    with pytest.raises(ValueError) as port_err:
        load_weights(path, YOLOV5("n", num_classes=nc))
    want = _skip_count(str(jax_err.value))
    assert want == (6 if nc == 3 else 5)
    assert _skip_count(str(port_err.value)) == want


def test_partial_load_80_to_3_classes(tmp_path):
    """partial=True copies every entry whose shape matches and keeps the
    model's own head (the fine-tune path), in both packages."""
    _, v = seeded_v5n()
    path = str(tmp_path / "w.pt")
    torch.save({"model": torch_sd(v)}, path)
    template = jax_template(3)
    jvars = state_dict_from_jax_variables(jax_load_weights(path, template, partial=True))
    model = YOLOV5("n", num_classes=3)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    load_weights(path, model, partial=True)
    got, ckpt = model.state_dict(), torch_sd(v)
    head = {f"head.m.{i}.{p}" for i in range(3) for p in ("weight", "bias")}
    for k, t in got.items():
        if k in head:
            assert torch.equal(t, init[k]), k
            np.testing.assert_array_equal(
                jvars[k].numpy(), state_dict_from_jax_variables(template)[k].numpy())
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(t, ckpt[k]) and torch.equal(jvars[k], ckpt[k]), k


def test_flax_files_are_refused(tmp_path):
    """An orbax directory is refused; a Flax .msgpack (flax.serialization.
    to_bytes of the variables) loads, equal to the bridge of the same
    tree."""
    from flax import serialization

    model = YOLOV5("n")
    with pytest.raises(ValueError, match="orbax"):
        load_weights(str(tmp_path), model)
    _, v = seeded_v5n()
    path = str(tmp_path / "w.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(v))
    load_weights(path, model)
    want = state_dict_from_jax_variables(v)
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, want[k]), k


def test_load_predictor_from_config_loads_weights(tmp_path):
    """load_predictor_from_config(weights=...) serves the file's weights,
    not the seed's."""
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes, cfg.model.input_size = "n", 80, [SIZE, SIZE]
    _, v = seeded_v5n()
    model = YOLOV5("n")
    model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    path = str(tmp_path / "w.pt")
    torch.save({"model": model.state_dict()}, path)
    pred = load_predictor_from_config(cfg, weights=path, device="cpu", seed=5)
    imgs = frames(9)
    got, _ = pred.predict_batch(imgs)
    want, _ = Predictor(model.to(memory_format=torch.channels_last), img_size=SIZE,
                        device="cpu").predict_batch(imgs)
    for w, g in zip(want, got):
        assert len(w) > 10
        assert_same_detections(w, g)


# -- the port's TrainState checkpoint -----------------------------------------

def _train_setup(seed):
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes, cfg.model.input_size = "n", 80, [SIZE, SIZE]
    model = build_model(cfg, device="cpu", seed=seed).train()
    tx = optim.make_optimizer(model, TRAIN_HYP, 3, 10)
    step = make_train_step(model, YoloLoss(80, model.head.grid_anchors, TRAIN_HYP), tx)
    return model, create_train_state(model, tx), step


def _snapshot(state):
    return {part: {k: t.clone() for k, t in tensors.items()}
            for part, tensors in train_state_tensors(state).items()}


def _assert_equal_states(a, b):
    for part in a:
        assert set(a[part]) == set(b[part]), part
        for k, t in a[part].items():
            assert torch.equal(t, b[part][k]), (part, k)


def test_train_state_round_trip_and_next_step(tmp_path):
    """Save after one step; restore into a fresh state of a model built
    from another seed: every tensor and count bit-equal, the meta as
    written; one more step after the restore equals the uninterrupted
    run's next step. load_weights reads the file's EMA (updated once)."""
    batches = step_batches(2)
    model, state, step = _train_setup(seed=0)
    state, _ = step(state, batches[0])
    path = str(tmp_path / "last.pt")
    save_checkpoint(path, state, epoch=0, best_map50=0.25, epochs_no_improve=1,
                    val_pending=True)
    saved = _snapshot(state)
    state, _ = step(state, batches[1])
    uninterrupted = _snapshot(state)

    model2, fresh, step2 = _train_setup(seed=1)
    restored, meta = load_checkpoint(path, fresh)
    _assert_equal_states(saved, _snapshot(restored))
    assert (restored.step, restored.ema.updates) == (1, 1)
    assert optim.sgd_state(restored.opt_state).step == 1
    assert meta == {"epoch": 0, "step": 1, "best_map50": 0.25,
                    "epochs_no_improve": 1, "val_pending": True}
    restored, _ = step2(restored, batches[1])
    _assert_equal_states(uninterrupted, _snapshot(restored))

    served = load_weights(path, YOLOV5("n"))
    for k, t in served.state_dict().items():
        if k in saved["ema"]:
            assert torch.equal(t, saved["ema"][k]), k


def test_train_state_without_ema_updates_serves_params(tmp_path):
    model, state, _ = _train_setup(seed=0)
    with torch.no_grad():
        for t in state.ema.tree.values():
            t.add_(1.0)          # an EMA never updated is not read
    path = str(tmp_path / "init.pt")
    save_checkpoint(path, state)
    served = load_weights(path, YOLOV5("n"))
    for k, t in served.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, model.state_dict()[k]), k
    with pytest.raises(ValueError, match="not a TrainState"):
        torch.save({"model": model.state_dict()}, path)
        load_checkpoint(path, state)
