"""Port (vision_kit_tpu_torch.train.trainer.Trainer) vs JAX package on the
CPU, v5n@64 in f32 on the rectangle set, device augmentation:

- from JAX's Trainer state carried by convert.load_jax_train_state, the
  port's Trainer.validate() equals JAX's (mAP within 1e-6), and one epoch of
  fit (3 steps of batch 4, the same batches: the loaders are bit-equal)
  gives losses and a state within tests/test_torch_train.py's tolerances;
- the same epoch on the host-augmentation route, reached as JAX reaches it
  from data.device_aug with degrees and shear set: both sides warn and fall
  back, train on bit-equal batches with losses within the same tolerances,
  and end in a state within HOST_STEP_REL of JAX's (see there);
- the multi-scale size draws equal JAX's;
- port only: a crash mid-epoch and one inside a validation, each resumed,
  end bit-identical to an uninterrupted run (the counterparts of
  tests/test_round3.py); the early-stop counter survives a resume and
  still stops the run; the eval step sees restored weights; the best
  weights, sample grids, log and profile trace are written.

One JAX Trainer is built and run once for the module (its compiles cost
tens of seconds on this CPU).
"""

import copy
import glob
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from fixture_lib import build_rectangle_dataset
from vision_kit_tpu.parallel.mesh import make_mesh, replicated_sharding
from vision_kit_tpu.train import trainer as jax_trainer_mod
from vision_kit_tpu.train.trainer import Trainer as JaxTrainer
from vision_kit_tpu.utils.config import ConfigNode as JaxConfigNode
from vision_kit_tpu_torch.convert import load_jax_train_state, train_state_tensors_from_jax
from vision_kit_tpu_torch.predictor import load_weights
from vision_kit_tpu_torch.train import step as port_step
from vision_kit_tpu_torch.train import trainer as port_trainer_mod
from vision_kit_tpu_torch.train.trainer import Trainer
from vision_kit_tpu_torch.utils.config import ConfigNode
from vision_kit_tpu_torch.utils.stream_bench import (
    STATE_PARTS,
    state_disagreements,
    train_state_tensors,
)

torch.set_num_threads(2)

HYP = {"lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 0.0005,
       "warmup_epochs": 0.0, "warmup_bias_lr": 0.1, "warmup_momentum": 0.8,
       "box": 0.05, "cls": 0.5, "obj": 1.0, "cls_pw": 1.0, "obj_pw": 1.0,
       "iou_t": 0.2, "anchor_t": 4.0, "fl_gamma": 0.0, "label_smoothing": 0.0}
AUG = {"degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0,
       "flip_ud_prob": 0.0, "flip_lr_prob": 0.5, "mosaic_prob": 1.0,
       "mixup_prob": 0.5, "hsv_prob": 1.0, "mosaic_scale": [0.5, 1.5],
       "mixup_scale": [0.5, 1.5], "enable_mixup": True, "enable_mosaic": True}
# test_torch_train.py's tolerances of a training step's results, f32
METRIC_RTOL = {"loss": 1e-4, "loss_box": 1e-4, "loss_obj": 1e-4, "loss_cls": 1e-4,
               "grad_norm": 1e-3}


def cfg_dict(root, out, batch=4, epochs=1, val_interval=100, **data):
    d = {"model": {"name": "YOLOv5", "version": "n", "num_classes": 2,
                   "input_size": [64, 64], "act": "silu", "deploy": False,
                   "weight": "", "precision": "fp32"},
         "data": {"data_format": "yolo", "data_dir": str(root), "output_dir": str(out),
                  "train_path": "images/train", "val_path": "images/val",
                  "batch_size": batch, "max_epochs": epochs, "num_workers": 0,
                  "filter_classes": [], "class_labels": ["red", "green"],
                  "device_aug": True, "ckpt_interval": 1},
         "testing": {"conf_thresh": 0.001, "iou_thresh": 0.6,
                     "val_interval": val_interval},
         "hypermeters": dict(HYP), "augmentations": dict(AUG)}
    d["data"].update(data)
    return d


def port_trainer(d, **kw):
    return Trainer(ConfigNode.wrap(copy.deepcopy(d)), use_tensorboard=False, seed=5,
                   device="cpu", **kw)


def spread_head(model, tree):
    """`tree` (a JAX variables tree) with the head's biases zeroed and its
    kernels scaled to unit raw-logit spread on a probe batch, so that the
    scores of neighbouring anchors lie apart and neither side's NMS turns
    on an f32 near-tie (see test_torch_eval.py:spread_v5n)."""
    tree = jax.tree_util.tree_map(np.array, tree)
    head = tree["params"]["head"]
    for i in range(3):
        head[f"m_{i}"]["bias"] = np.zeros_like(head[f"m_{i}"]["bias"])
    probe = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    _, raws = jax.jit(lambda v, x: model.apply(v, x, training=False))(tree, probe)
    for i, raw in enumerate(raws):
        head[f"m_{i}"]["kernel"] = (head[f"m_{i}"]["kernel"]
                                    / np.asarray(raw).std()).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's Trainer: its initial state, its validate() over a spread EMA,
    and one epoch of fit from the initial state with each step's metrics."""
    root = tmp_path_factory.mktemp("rect")
    build_rectangle_dataset(str(root))
    d = cfg_dict(root, root / "jax_out")
    mesh = make_mesh(n_data=1, n_model=1)
    tr = JaxTrainer(JaxConfigNode.wrap(copy.deepcopy(d)), mesh=mesh,
                    use_tensorboard=False, seed=5)
    try:
        state0 = jax.device_get(tr.state)
        eval_state = state0._replace(ema=state0.ema._replace(
            tree=spread_head(tr.model, state0.ema.tree)))
        tr.state = jax.device_put(eval_state, replicated_sharding(mesh))
        val = tr.validate()
        tr.state = jax.device_put(state0, replicated_sharding(mesh))
        metrics, orig = [], tr.train_step

        def recording(state, batch):
            state, m = orig(state, batch)
            metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
            return state, m

        tr.train_step = recording
        tr.fit()
        state1 = jax.device_get(tr.state)
    finally:
        tr.train_loader.close()
    return {"root": root, "cfg": d, "state0": state0, "eval_state": eval_state,
            "val": val, "metrics": metrics, "state1": state1, "trainer": tr}


FALLBACK = "data.device_aug disabled: degrees/shear require the host augmentation pipeline"
# The host route's epoch: state_disagreements' share of each tensor's change
# (test_torch_train.py's 2e-3 stays for its value_rel). The step is the
# device route's, its uint8 input equals float x / 255 bit for bit on both
# sides and the batches are bit-equal (asserted below); but on these
# batches the two frameworks' f32 gradients (batch-statistics BN at B=4)
# differ by up to 2.6e-3 of a tensor's change after one step (median 9e-4),
# against 1.1e-3 on the device route's batches, and after 3 steps by up to
# 1.6x of the 2e-3.
HOST_STEP_REL = 5e-3


def host_cfg(d, out):
    """`d` with degrees 5 and shear 2 under data.device_aug: true."""
    return dict(d, data=dict(d["data"], output_dir=str(out)),
                augmentations=dict(d["augmentations"], degrees=5.0, shear=2.0))


@pytest.fixture(scope="module")
def jax_host_run(jax_run):
    """JAX's Trainer on host_cfg: the fallback's warning, and one epoch of
    fit from jax_run's initial state with each step's metrics."""
    d = host_cfg(jax_run["cfg"], jax_run["root"] / "jax_host_out")
    mesh = make_mesh(n_data=1, n_model=1)
    with mock.patch.object(jax_trainer_mod.logger, "warning") as warn:
        tr = JaxTrainer(JaxConfigNode.wrap(copy.deepcopy(d)), mesh=mesh,
                        use_tensorboard=False, seed=5)
    try:
        tr.state = jax.device_put(jax_run["state0"], replicated_sharding(mesh))
        metrics, batches, orig = [], [], tr.train_step

        def recording(state, batch):
            batches.append({k: np.array(v) for k, v in batch.items()})
            state, m = orig(state, batch)
            metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
            return state, m

        tr.train_step = recording
        tr.fit()
        state1 = jax.device_get(tr.state)
    finally:
        tr.train_loader.close()
    return {"cfg": d, "warnings": [c.args[0] for c in warn.call_args_list],
            "device_aug": tr.device_aug, "metrics": metrics, "batches": batches,
            "state1": state1}


def test_validate_equals_jax(jax_run):
    tr = port_trainer(jax_run["cfg"])
    tr.use_state(load_jax_train_state(tr.model, tr.tx, jax_run["eval_state"]))
    got, want = tr.validate(), jax_run["val"]
    assert want["map50"] > 0.0
    for key in ("map50", "map50_95", "map75", "mp", "mr"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert [r["class"] for r in got["per_class"]] == [r["class"] for r in want["per_class"]]
    for g, w in zip(got["per_class"], want["per_class"]):
        assert g["ap50"] == pytest.approx(w["ap50"], abs=1e-6)
        assert g["targets"] == w["targets"] and g["images"] == w["images"]


def test_fit_epoch_equals_jax(jax_run):
    """One epoch of fit from the carried initial state: each step's losses
    and gradient norm, and the final state (params, statistics, momentum,
    EMA) within test_torch_train.py's per-tensor tolerances (1e-4 of a
    tensor's magnitude plus 2e-3 of the change JAX's epoch made to it)."""
    d = dict(jax_run["cfg"], data=dict(jax_run["cfg"]["data"],
                                       output_dir=str(jax_run["root"] / "port_out")))
    tr = port_trainer(d)
    tr.use_state(load_jax_train_state(tr.model, tr.tx, jax_run["state0"]))
    metrics, orig = [], tr.train_step

    def recording(state, batch):
        state, m = orig(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    tr.train_step = recording
    tr.fit()
    assert tr.global_step == tr.state.step == 3
    assert len(metrics) == len(jax_run["metrics"]) == 3
    for g, w in zip(metrics, jax_run["metrics"]):
        for k, rtol in METRIC_RTOL.items():
            assert g[k] == pytest.approx(w[k], rel=rtol), k
    want = train_state_tensors_from_jax(jax_run["state1"])
    before = train_state_tensors_from_jax(jax_run["state0"])
    got = train_state_tensors(tr.state)
    assert state_disagreements({p: want[p] for p in STATE_PARTS}, got,
                               {p: before[p] for p in STATE_PARTS}) == []
    assert tr.state.ema.updates == want["ema_updates"] == 3
    meta = json.load(open(os.path.join(d["data"]["output_dir"], "ckpts",
                                       "last.meta.json")))
    assert meta["step"] == 3 and meta["epoch"] == 0
    assert os.path.exists(os.path.join(d["data"]["output_dir"], "train.jpg"))


def test_host_route_fit_epoch_equals_jax(jax_run, jax_host_run):
    """data.device_aug with degrees and shear: both Trainers warn, take the
    host-augmentation loader, feed their steps bit-equal batches, and one
    epoch of fit from the carried initial state gives each step's losses
    within METRIC_RTOL and a state within HOST_STEP_REL."""
    d = dict(jax_host_run["cfg"], data=dict(jax_host_run["cfg"]["data"],
                                            output_dir=str(jax_run["root"] / "port_host")))
    with mock.patch.object(port_trainer_mod.logger, "warning") as warn:
        tr = port_trainer(d)
    assert [c.args[0] for c in warn.call_args_list] == jax_host_run["warnings"] == [FALLBACK]
    assert tr.device_aug is jax_host_run["device_aug"] is False
    assert not tr.train_loader.device_aug
    tr.use_state(load_jax_train_state(tr.model, tr.tx, jax_run["state0"]))
    metrics, batches, orig = [], [], tr.train_step

    def recording(state, batch):
        batches.append(batch)
        state, m = orig(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    tr.train_step = recording
    tr.fit()
    assert tr.global_step == tr.state.step == len(jax_host_run["metrics"]) == 3
    for g, w in zip(batches, jax_host_run["batches"]):
        assert set(g) == set(w) == {"image", "targets"}
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        np.testing.assert_array_equal(g["targets"], w["targets"])
    for g, w in zip(metrics, jax_host_run["metrics"]):
        for k, rtol in METRIC_RTOL.items():
            assert g[k] == pytest.approx(w[k], rel=rtol), k
    want = train_state_tensors_from_jax(jax_host_run["state1"])
    before = train_state_tensors_from_jax(jax_run["state0"])
    assert state_disagreements({p: want[p] for p in STATE_PARTS}, train_state_tensors(tr.state),
                               {p: before[p] for p in STATE_PARTS},
                               step_rel=HOST_STEP_REL) == []
    assert os.path.exists(os.path.join(d["data"]["output_dir"], "train.jpg"))


def test_multiscale_draws_equal_jax(jax_run, monkeypatch):
    """The size each global step trains at, for the default size set and
    an explicit list, against JAX's _train_step_for (both make_train_steps
    replaced by a recorder: no step is built)."""
    jtr = jax_run["trainer"]
    monkeypatch.setattr(jax_trainer_mod, "make_train_step",
                        lambda *a, scale_to=None, **k: ("sized", scale_to))
    monkeypatch.setattr(port_step, "make_train_step",
                        lambda *a, scale_to=None, **k: ("sized", scale_to))
    tr = port_trainer(jax_run["cfg"])
    for ms in (True, [32, 96, 128]):
        jcfg = JaxConfigNode.wrap(dict(jax_run["cfg"], data=dict(jax_run["cfg"]["data"],
                                                                 multiscale=ms)))
        pcfg = ConfigNode.wrap(dict(jax_run["cfg"], data=dict(jax_run["cfg"]["data"],
                                                              multiscale=ms)))
        jtr.ms_sizes, jtr._ms_steps = jtr._parse_multiscale(jcfg), {}
        tr.ms_sizes, tr._ms_steps = tr._parse_multiscale(pcfg), {}
        assert tr.ms_sizes == jtr.ms_sizes
        sizes = []
        for g in range(0, 400, 7):
            want, got = jtr._train_step_for(g), tr._train_step_for(g)
            want = "base" if want is jtr.train_step else want
            got = "base" if got is tr.train_step else got
            assert got == want, g
            sizes.append(got)
        assert "base" in sizes and len(set(sizes)) > 2
    jtr.ms_sizes = None
    with pytest.raises(ValueError, match="multiple of 32"):
        tr._parse_multiscale(ConfigNode.wrap({"data": {"multiscale": [48]}}))


# -- port only: checkpoints and resume -----------------------------------


def crash_after(trainer, n_steps):
    """trainer.train_step raises after n_steps calls."""
    calls = {"n": 0}
    orig = trainer.train_step

    def exploding(state, batch):
        calls["n"] += 1
        if calls["n"] > n_steps:
            raise RuntimeError("boom")
        return orig(state, batch)

    trainer.train_step = exploding


def assert_states_identical(a, b):
    ta, tb = train_state_tensors(a.state), train_state_tensors(b.state)
    for part in STATE_PARTS:
        for k in ta[part]:
            assert torch.equal(ta[part][k], tb[part][k]), (part, k)
    assert (a.state.step, a.state.ema.updates) == (b.state.step, b.state.ema.updates)
    assert a.global_step == b.global_step


@pytest.fixture(scope="module")
def resume_cfg(jax_run):
    """Batch 2 over the 12 train images: 6 steps an epoch, 3 epochs."""
    return cfg_dict(jax_run["root"], jax_run["root"] / "ref", batch=2, epochs=3)


@pytest.fixture(scope="module")
def uninterrupted(resume_cfg):
    tr = port_trainer(resume_cfg)
    tr.fit()
    return tr


def with_out(d, out, **testing):
    return dict(d, data=dict(d["data"], output_dir=str(out)),
                testing=dict(d["testing"], **testing))


def test_mid_epoch_crash_resume_bit_identical(resume_cfg, uninterrupted, tmp_path):
    """A crash 2 steps into epoch 2 saves step 8; the resume continues at
    batch 8 and ends bit-identical to the uninterrupted run."""
    d = with_out(resume_cfg, tmp_path)
    tr = port_trainer(d)
    crash_after(tr, 8)
    with pytest.raises(RuntimeError, match="boom"):
        tr.fit()
    path = os.path.join(str(tmp_path), "ckpts", "last")
    meta = json.load(open(path + ".meta.json"))
    assert meta["step"] == 8 and meta["val_pending"] is False
    resumed = port_trainer(d)
    seen = []
    orig = resumed.train_step

    def recording(state, batch):
        seen.append(resumed.train_loader._next_bid - 1)
        return orig(state, batch)

    resumed.train_step = recording
    resumed.fit(resume=path)
    assert seen == list(range(8, 18))
    assert_states_identical(uninterrupted, resumed)


def test_mid_validation_crash_resume_bit_identical(resume_cfg, tmp_path):
    """A crash inside epoch 1's validation saves step 12 with the
    validation pending; the resume re-runs it (best mAP and patience as an
    uninterrupted run has them), then trains epoch 2 bit-identically."""
    d = with_out(resume_cfg, tmp_path / "a", val_interval=1)
    ref = port_trainer(d)
    ref.fit()
    d = with_out(resume_cfg, tmp_path / "b", val_interval=1)
    tr = port_trainer(d)
    calls = {"n": 0}
    orig_validate = tr.validate

    def exploding_validate(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("valboom")
        return orig_validate(*a, **k)

    tr.validate = exploding_validate
    with pytest.raises(RuntimeError, match="valboom"):
        tr.fit()
    path = os.path.join(str(tmp_path / "b"), "ckpts", "last")
    meta = json.load(open(path + ".meta.json"))
    assert meta["step"] == 12 and meta["val_pending"] is True
    resumed = port_trainer(d)
    resumed.fit(resume=path)
    assert resumed.best_map50 == ref.best_map50
    assert resumed.epochs_no_improve == ref.epochs_no_improve
    assert_states_identical(ref, resumed)
    # the best weights: a Flax msgpack that load_weights takes, the f32 EMA
    # that ckpts/best holds
    best = glob.glob(os.path.join(str(tmp_path / "b"), "weights", "best-map50_*.msgpack"))
    assert os.path.basename(max(best)) == f"best-map50_{resumed.best_map50:.4f}.msgpack"
    model = load_weights(max(best), port_trainer(d).model)
    want = load_weights(os.path.join(str(tmp_path / "b"), "ckpts", "best"),
                        port_trainer(d).model).state_dict()
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            assert v.dtype == torch.float32 and torch.equal(v, want[k]), k
    assert os.path.exists(os.path.join(str(tmp_path / "b"), "val.jpg"))


def test_early_stop_counter_survives_resume(resume_cfg, tmp_path):
    """epochs_no_improve and best_map50 are checkpoint meta: a run that
    crashes after its first validation (the 4th without improvement, of a
    patience of 5) resumes counting there and stops after its next
    validation, where an uninterrupted run stops."""
    d = with_out(resume_cfg, tmp_path, val_interval=1, patience=5)
    d["data"]["max_epochs"] = 5
    tr = port_trainer(d)
    crash_after(tr, 6)
    tr.best_map50, tr.epochs_no_improve = 2.0, 3   # no mAP beats 2.0
    with pytest.raises(RuntimeError, match="boom"):
        tr.fit()
    path = os.path.join(str(tmp_path), "ckpts", "last")
    probe = port_trainer(d)
    assert probe.load_checkpoint(path) == 6
    assert probe.epochs_no_improve == 4 and probe.best_map50 == 2.0
    resumed = port_trainer(d)
    resumed.fit(resume=path)
    assert resumed.epochs_no_improve == 5
    assert resumed.global_step == 12     # one more epoch: patience spent


def test_eval_step_sees_restored_weights(resume_cfg, uninterrupted, tmp_path):
    fresh = port_trainer(with_out(resume_cfg, tmp_path))
    images = np.random.default_rng(4).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    before = fresh.eval_step(images)[0]
    fresh.load_checkpoint(os.path.join(resume_cfg["data"]["output_dir"], "ckpts", "last"))
    after = fresh.eval_step(images)[0]
    want = uninterrupted.eval_step(images)[0]
    assert torch.equal(after, want)
    assert not torch.equal(before, after)


def test_profile_and_guards(resume_cfg, tmp_path):
    tr = port_trainer(with_out(resume_cfg, tmp_path))
    path = tr.profile(steps=1)
    assert os.path.getsize(path) > 0
    # a mesh is a parallel.mesh.Mesh (tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="mesh"):
        port_trainer(resume_cfg, mesh=object())
    # rotation or shear under data.device_aug, and device_aug false, both
    # build the host-augmentation loader
    for key, value in (("degrees", 5.0), ("shear", 2.0)):
        d = copy.deepcopy(resume_cfg)
        d["augmentations"][key] = value
        with mock.patch.object(port_trainer_mod.logger, "warning") as warn:
            tr = port_trainer(d)
        assert [c.args[0] for c in warn.call_args_list] == [FALLBACK]
        assert not tr.device_aug and not tr.train_loader.device_aug
    d = copy.deepcopy(resume_cfg)
    d["data"]["device_aug"] = False
    tr = port_trainer(d)
    assert not tr.device_aug and set(next(iter(tr.train_loader))) == {"image", "targets"}
    tr.train_loader.close()


def test_two_rank_fit_is_identical_across_ranks_and_resumes_exactly(tmp_path):
    """Trainer.fit on 2 gloo ranks (tests/torch_dist_lib.py:fit_worker) for
    one epoch of 3 steps of the global batch 4 on a fresh copy of the
    rectangle set, validating at its end: the ranks' states are
    bit-identical; rank 0 alone writes the label caches, the checkpoints,
    the best weights and the sample grids, ckpts/last an orbax directory
    that every rank reads past the barrier of the waits; a crash of both
    ranks after step 1, resumed from ckpts/last, ends bit-identical to the
    uninterrupted run."""
    from torch_dist_lib import run_ranks

    root = tmp_path / "rect"
    build_rectangle_dataset(str(root))
    d = cfg_dict(str(root), str(tmp_path / "out"), batch=4, epochs=1, val_interval=1)
    got = run_ranks(2, "torch_dist_lib:fit_worker", {"cfg": d, "crash_after": 1})
    run = [r["run"] for r in got]
    resumed = [r["resumed"] for r in got]
    assert run[0]["step"] == run[1]["step"] == resumed[0]["step"] == 3
    assert run[0]["digest"] == run[1]["digest"]
    assert resumed[0]["digest"] == resumed[1]["digest"] == run[0]["digest"]
    assert run[0]["best_map50"] == run[1]["best_map50"] >= 0
    assert run[1]["writes"] == [] and resumed[1]["writes"] == []
    out = os.path.join(str(tmp_path / "out"), "run")
    written = sorted((what, os.path.relpath(path, str(tmp_path)))
                     for what, path in run[0]["writes"])
    labels = [p for w, p in written if w == "savez_compressed"]
    assert len(labels) == 2 and all(".vkt_labels_" in p for p in labels)
    assert [p for w, p in written if w == "grid_save"] == ["out/run/train.jpg",
                                                           "out/run/val.jpg"]
    saved = [p for w, p in written if w == "write_checkpoint"]
    assert "out/run/ckpts/last" in saved and "out/run/ckpts/best" in saved
    assert [w for w, p in written if p.startswith("out/run/weights/best-map50_")] == [
        "write_file"]
    assert not [p for w, p in written if w == "torch.save"]
    # each rank found ckpts/last an orbax directory as its fit returned
    assert [r["last_is_orbax"] for r in run] == [True, True]
    assert [r["last_is_orbax"] for r in resumed] == [True, True]
    for path in ("ckpts/last.meta.json", "train.jpg", "val.jpg"):
        assert os.path.exists(os.path.join(out, path)), path
