"""The serving and eval postprocesses on YOLOv7 output: the port against the
JAX package on the CPU, on one v7 base forward at 128 on each side.

The weights: test_torch_v7's seeded fill, then (in the port, by
stream_bench's calibrate_bn and calibrate_head, as on the card) BatchNorm
statistics from a probe batch with the BN scale at 0.25 and the head
calibrated to unit logit spread, carried back to JAX by the JAX package's
own torch_to_flax. With the fill's statistics alone, v7's depth leaves
every anchor of a level with nearly the same score (the spatial variation
decays to ~1e-7 of the features), and which of two such rivals NMS keeps
differs between the frameworks; normalised this way, neighbouring anchors
score apart.

Boxes are held to 1e-3 px + 1e-4 of the box's longer side: the v7 size
decode (2 sigmoid)^2 * anchor turns the frameworks' ~5e-5 apart in a logit
at this depth into a few 1e-3 px on the 459x401 anchor."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.classes import COCO as JAX_COCO
from vision_kit_tpu.convert import torch_to_flax
from vision_kit_tpu.models import YOLOV7 as JaxYOLOV7
from vision_kit_tpu.ops.nms import postprocess as jax_postprocess
from vision_kit_tpu.ops.nms import postprocess_raw as jax_postprocess_raw
from vision_kit_tpu.train.evaluator import DetEvaluator as JaxDetEvaluator
from vision_kit_tpu_torch.classes import COCO
from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
from vision_kit_tpu_torch.ops.head_scores import head_scores
from vision_kit_tpu_torch.ops.nms import postprocess, postprocess_raw
from vision_kit_tpu_torch.train import trainer
from vision_kit_tpu_torch.train.evaluator import DetEvaluator
from vision_kit_tpu_torch.train.step import EVAL_POSTPROCESS, make_eval_step
from vision_kit_tpu_torch.utils.stream_bench import calibrate_bn, calibrate_head, pseudo_targets
from test_torch_nms import assert_same_detections
from test_torch_v7 import fill_variables, port_v7, v7_shapes

torch.set_num_threads(2)

SIZE = 128
BOX_RTOL = 1e-4


@functools.cache
def spread_v7():
    """(JAX model, JAX variables, port model, frames, JAX outputs, port
    outputs) for v7 base at 128 on 2 seeded frames."""
    shapes = v7_shapes("base", size=SIZE)
    model = port_v7("base", fill_variables(shapes, seed=3))
    calibrate_bn(model, SIZE, seed=2)
    calibrate_head(model, SIZE, seed=1)
    v = torch_to_flax(model.state_dict(), template=shapes)
    v = jax.tree_util.tree_map(np.asarray, v)
    jm = JaxYOLOV7(variant="base", num_classes=80)
    x = np.random.default_rng(9).integers(0, 255, (2, SIZE, SIZE, 3), dtype=np.uint8)
    jd, jr = jax.jit(lambda v, x: jm.apply(v, x, training=False))(v, jnp.asarray(x))
    with torch.no_grad():
        td, tr = model(torch.from_numpy(x))
    return jm, v, model, x, (np.asarray(jd), [np.asarray(r) for r in jr]), (td, tr)


def test_spread_v7_outputs_agree():
    """The carried weights give the same network on both sides, and
    anchors of a level score apart."""
    *_, (jd, jr), (td, tr) = spread_v7()
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4)
        assert a[..., 4].std(axis=(1, 2)).mean() > 0.3
    # decoded centres carry up to 16x a logit's difference (2 sigmoid' *
    # stride 32), sizes far more: scores to 1e-4, boxes to 1e-4 relative
    np.testing.assert_allclose(td[..., 4:].numpy(), jd[..., 4:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(td[..., :4].numpy(), jd[..., :4], rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("mode", ["default", "agnostic", "classes"])
def test_postprocess_raw_on_v7_matches_jax(mode):
    jm, _, model, _, (_, jr), (_, tr) = spread_v7()
    classes = np.arange(80) % 3 == 0 if mode == "classes" else None
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, max_cand=512,
              agnostic=mode == "agnostic")
    jd, jv = jax_postprocess_raw(
        [jnp.asarray(r) for r in jr], jm.anchors_px, approx_topk=False,
        classes=None if classes is None else jnp.asarray(classes), **kw)
    before = head_scores.launches, greedy_keep.launches
    td, tv = postprocess_raw(
        tr, model.anchors_px, strides=model.strides,
        classes=None if classes is None else torch.from_numpy(classes), **kw)
    assert (head_scores.launches, greedy_keep.launches) == before
    np.testing.assert_array_equal(model.anchors_px, np.asarray(jm.anchors_px))
    jd, jv = np.asarray(jd), np.asarray(jv)
    assert td.shape == jd.shape and tv.shape == jv.shape
    for i in range(2):
        assert jv[i].sum() > 10
        assert_same_detections(jd[i][jv[i]], td[i][tv[i]].numpy(), BOX_RTOL)


def test_eval_postprocess_on_v7_matches_jax():
    *_, (jd, _), (td, _) = spread_v7()
    kw = {**EVAL_POSTPROCESS, "max_cand": 512}
    want_d, want_v = jax_postprocess(jnp.asarray(jd), **kw)
    got_d, got_v = postprocess(td, **kw)
    want_d, want_v = np.asarray(want_d), np.asarray(want_v)
    for i in range(2):
        assert want_v[i].sum() > 50
        assert_same_detections(want_d[i][want_v[i]], got_d[i][got_v[i]].numpy(), BOX_RTOL)


def test_eval_slice_on_v7_matches_jax():
    """The port's make_eval_step over its v7 and trainer.validate/test
    against the JAX eval postprocess of the JAX v7's output and the JAX
    evaluator, on ground truth jittered from the JAX detections."""
    _, _, model, x, (jd, _), _ = spread_v7()
    post = {"max_cand": 512}
    want_d, want_v = jax_postprocess(jnp.asarray(jd), **{**EVAL_POSTPROCESS, **post})
    want_d, want_v = np.asarray(want_d), np.asarray(want_v)
    rng = np.random.default_rng(31)
    batch = {"image": x, "targets": pseudo_targets(want_d, want_v, (SIZE, SIZE), rng),
             "info": [(SIZE, SIZE, 1.0, (0.0, 0.0), i) for i in range(2)], "count": 2}
    step = make_eval_step(model, postprocess_kwargs=post)
    outs = []

    def recording_step(images):
        dets, valid = step(images)
        outs.append((dets.numpy(), valid.numpy()))
        return dets, valid

    got = trainer.test(recording_step, [batch], DetEvaluator(COCO, img_size=SIZE))
    theirs = JaxDetEvaluator(JAX_COCO, img_size=SIZE)
    theirs.reset(collect_coco=True)
    theirs.update(want_d, want_v, batch["targets"], batch["info"], 2)
    want, want_coco = theirs.summarize(), theirs.summarize_coco()
    (td, tv), = outs
    for i in range(2):
        assert_same_detections(want_d[i][want_v[i]], td[i][tv[i]], BOX_RTOL)
    assert 0 < got["map50_95"] < 1
    for k in ("map50", "map50_95"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    for k in want_coco:
        assert got["coco"][k] == pytest.approx(want_coco[k], abs=1e-6), k


@pytest.mark.parametrize("deploy", [False, True])
def test_load_predictor_from_v7_config(deploy):
    """configs/yolov7.yaml builds a v7 base Predictor in the structure that
    model.deploy names; it serves through postprocess_raw and, with
    multi_label, through postprocess."""
    import os

    from vision_kit_tpu_torch.predictor import Predictor, load_predictor_from_config
    from vision_kit_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs/yolov7.yaml"))
    cfg.model.deploy, cfg.model.input_size = deploy, [64, 64]
    pred = load_predictor_from_config(cfg, device="cpu", conf_thres=0.001)
    assert pred.img_size == (64, 64) and pred.model.head.deploy == deploy
    frames = np.random.default_rng(0).integers(0, 255, (2, 48, 80, 3), dtype=np.uint8)
    for p in (pred, Predictor(pred.model, img_size=64, device="cpu",
                              multi_label=True, conf_thres=0.001, max_cand=256)):
        dets, _ = p.predict_batch(frames)
        assert len(dets) == 2 and all(d.shape[1] == 6 for d in dets)
        assert all(np.isfinite(d).all() for d in dets)
