"""Port eval path vs the JAX package on the CPU: the decoded-output
postprocess and batched_nms, the mAP evaluator, the eval step with the
validate/test loop, and Predictor(multi_label=True).

v5n@64 in f32 with the same weights on both sides (test_torch_model's
jax_v5 / port_v5, and spread_v5n below). K stays at or below 512 candidates: the plain greedy
keep is a K-step Python loop."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vision_kit_tpu.classes import COCO as JAX_COCO
from vision_kit_tpu.data.loader import pad_targets as jax_pad_targets
from vision_kit_tpu.ops.letterbox import scale_coords as jax_scale_coords
from vision_kit_tpu.ops.nms import batched_nms as jax_batched_nms
from vision_kit_tpu.ops.nms import postprocess as jax_postprocess
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu.train.evaluator import DetEvaluator as JaxDetEvaluator
from vision_kit_tpu.train.step import create_train_state
from vision_kit_tpu.train.step import make_eval_step as jax_make_eval_step
from vision_kit_tpu.utils.general import coco80_to_coco91_class as jax_coco91
from vision_kit_tpu_torch.classes import COCO
from vision_kit_tpu_torch.data.loader import pad_targets
from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
from vision_kit_tpu_torch.ops.letterbox import scale_coords
from vision_kit_tpu_torch.ops import nms as nms_port
from vision_kit_tpu_torch.ops.nms import batched_nms, postprocess
from vision_kit_tpu_torch.predictor import Predictor
from vision_kit_tpu_torch.train import trainer
from vision_kit_tpu_torch.train.evaluator import DetEvaluator
from vision_kit_tpu_torch.train.step import EVAL_POSTPROCESS, make_eval_step
from vision_kit_tpu_torch.utils.general import coco80_to_coco91_class
from vision_kit_tpu_torch.utils.stream_bench import pseudo_targets
from test_torch_model import jax_v5, port_v5
from test_torch_nms import assert_same_detections

torch.set_num_threads(2)

METRICS = ("map50", "map50_95", "map75", "mp", "mr")


@functools.cache
def decoded_v5n():
    """The JAX v5n@64's decoded output (2, 252, 85) on seeded frames."""
    jm, v = jax_v5("n", 64)
    x = np.random.default_rng(9).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    decoded, _ = jm.apply(v, jnp.asarray(x), training=False)
    return np.asarray(decoded)


POSTPROCESS_MODES = {
    "single_label": {},
    "multi_label": {"multi_label": True},
    "multi_label_top5": {"multi_label": True, "multi_label_top": 5},
    "merge": {"multi_label": True, "merge": True},
    "classes": {"multi_label": True, "classes": np.arange(80) % 3 == 0},
    "agnostic": {"multi_label": True, "agnostic": True},
}


@pytest.mark.parametrize("conf", [0.001, 0.25])
@pytest.mark.parametrize("mode", list(POSTPROCESS_MODES))
def test_postprocess_matches_jax(mode, conf):
    preds = decoded_v5n()
    kw = dict(POSTPROCESS_MODES[mode], conf_thres=conf, iou_thres=0.6,
              max_cand=512, max_det=100)
    classes = kw.pop("classes", None)
    jd, jv = jax_postprocess(
        jnp.asarray(preds), classes=None if classes is None else jnp.asarray(classes),
        **kw)
    td, tv = postprocess(
        torch.from_numpy(preds),
        classes=None if classes is None else torch.from_numpy(classes), **kw)
    jd, jv = np.asarray(jd), np.asarray(jv)
    assert td.shape == jd.shape and tv.shape == jv.shape
    for i in range(len(jd)):
        assert jv[i].sum() > 10
        assert_same_detections(jd[i][jv[i]], td[i][tv[i]].numpy())
        if classes is not None:
            assert classes[td[i][tv[i]][:, 5].long().numpy()].all()


@pytest.mark.parametrize("mode", ["default", "merge", "agnostic", "agnostic_merge"])
def test_batched_nms_matches_jax(mode):
    rng = np.random.default_rng(17)
    x1y1 = rng.uniform(0, 200, (200, 2))
    boxes = np.concatenate([x1y1, x1y1 + rng.uniform(10, 80, (200, 2))], 1)
    boxes = boxes.astype(np.float32)
    # scores on a 1/64 grid: ties, which both sides order by index
    scores = (rng.integers(1, 64, 200) / 64).astype(np.float32)
    cls = rng.integers(0, 3, 200)
    kw = dict(iou_thres=0.45, max_det=150, agnostic="agnostic" in mode,
              merge="merge" in mode)
    jd, jv = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(cls), **kw)
    td, tv = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(cls), **kw)
    jd, jv = np.asarray(jd), np.asarray(jv)
    assert td.shape == jd.shape == (150, 6)
    assert 10 < jv.sum() < 200
    assert_same_detections(jd[jv], td[tv].numpy())


def test_merge_nms_single_candidate_kept():
    """A single over-threshold candidate survives merge=True, as the
    reference's n == 1 case keeps its detection as it is."""
    boxes = torch.tensor([[10.0, 10.0, 50.0, 60.0]])
    dets, valid = batched_nms(boxes, torch.tensor([0.9]), torch.tensor([2]),
                              iou_thres=0.5, max_det=1, merge=True)
    assert valid.sum() == 1
    np.testing.assert_allclose(dets[0, :4].numpy(), boxes[0].numpy(), atol=1e-4)
    assert dets[0, 5] == 2


def test_merge_nms_single_candidate_through_postprocess():
    nc = 4
    preds = torch.zeros(1, 32, 5 + nc)
    preds[0, :, :4] = torch.tensor([100.0, 100.0, 40.0, 40.0])  # cxcywh
    preds[0, 0, 4] = 0.9                  # one anchor above conf
    preds[0, 0, 5] = 0.9
    _, valid = postprocess(preds, conf_thres=0.25, iou_thres=0.5, max_det=10,
                           max_cand=32, merge=True)
    assert valid[0].sum() == 1


def test_postprocess_clamps_candidates_to_the_pool():
    """max_cand beyond N*L, and max_det beyond max_cand, shrink to the pool
    (the JAX version's clamp order)."""
    preds = torch.rand(1, 60, 85, generator=torch.Generator().manual_seed(0)) * 100
    dets, valid = postprocess(preds, conf_thres=0.001, iou_thres=0.6,
                              multi_label=True, max_det=300, max_cand=2048,
                              multi_label_top=2)
    assert dets.shape == (1, 120, 6) and valid.shape == (1, 120)


def test_host_helpers_match_jax():
    assert coco80_to_coco91_class() == jax_coco91()
    assert COCO == JAX_COCO
    rng = np.random.default_rng(3)
    labels = [np.concatenate([rng.uniform(0, 300, (n, 2)), rng.uniform(300, 600, (n, 2)),
                              rng.integers(0, 80, (n, 1))], 1).astype(np.float32)
              for n in (0, 3, 200)]
    np.testing.assert_array_equal(pad_targets(labels, (480, 640)),
                                  jax_pad_targets(labels, (480, 640)))
    coords = np.concatenate([rng.uniform(-40, 700, (20, 4)), rng.uniform(0, 1, (20, 2))],
                            1).astype(np.float32)
    want = jax_scale_coords((640, 640), coords, (480, 1280), ratio_pad=((0.5,), (0.0, 160.0)))
    got = scale_coords((640, 640), coords, (480, 1280), ratio_pad=((0.5,), (0.0, 160.0)))
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def evaluator_batches(rng):
    """Two padded batches of 4 letterboxed 640x640 frames from 960x1280
    sources (ratio 0.5, pad (0, 80)): detections near the ground truth and
    elsewhere; frame 1 has no labels, frame 2 no detections, and the last
    batch holds 3 real frames."""
    batches = []
    for bi, count in enumerate((4, 3)):
        dets = np.zeros((4, 50, 6), np.float32)
        valid = rng.uniform(size=(4, 50)) < 0.8
        labels = []
        for i in range(4):
            n = rng.integers(3, 12)
            x1y1 = rng.uniform([0, 80], [560, 480], (n, 2))
            gt = np.concatenate([x1y1, x1y1 + rng.uniform(8, 200, (n, 2))], 1)
            gcls = rng.integers(0, 5, n)
            pick = rng.integers(0, n, 50)
            near = gt[pick] + rng.normal(0, 6, (50, 4))
            far = rng.uniform(0, 600, (50, 4))
            far[:, 2:] = far[:, :2] + rng.uniform(8, 100, (50, 2))
            boxes = np.where(rng.uniform(size=(50, 1)) < 0.7, near, far)
            dets[i] = np.concatenate([boxes, rng.uniform(0.01, 1, (50, 1)),
                                      np.where(rng.uniform(size=50) < 0.85, gcls[pick],
                                               rng.integers(0, 5, 50))[:, None]], 1)
            labels.append(np.concatenate([gt, gcls[:, None]], 1).astype(np.float32))
        if bi == 0:
            labels[1] = np.zeros((0, 5), np.float32)
            valid[2] = False
        infos = [(960, 1280, 0.5, (0.0, 80.0), 10 * bi + i) for i in range(4)]
        batches.append(dict(dets=dets, valid=valid, infos=infos, count=count,
                            targets=pad_targets(labels, (640, 640))))
    return batches


def assert_summaries_agree(want, got, tol):
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], abs=tol), k
    assert len(got["per_class"]) == len(want["per_class"])
    for w, g in zip(want["per_class"], got["per_class"]):
        assert w.keys() == g.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=tol), (w["class"], k)


def test_det_evaluator_matches_jax():
    batches = evaluator_batches(np.random.default_rng(23))
    ours, theirs = DetEvaluator(COCO), JaxDetEvaluator(JAX_COCO)
    assert ours.class_ids == theirs.class_ids == coco80_to_coco91_class()
    for ev in (ours, theirs):
        ev.reset(collect_coco=True)
        for b in batches:
            ev.update(b["dets"], b["valid"], b["targets"], b["infos"], b["count"])
    assert ours.seen == theirs.seen == 7
    want, got = theirs.summarize(), ours.summarize()
    assert 0 < got["map50_95"] < got["map50"] < 1
    assert_summaries_agree(want, got, 1e-12)
    want_coco, got_coco = theirs.summarize_coco(), ours.summarize_coco()
    assert got_coco.keys() == want_coco.keys()
    for k in want_coco:
        assert got_coco[k] == pytest.approx(want_coco[k], abs=1e-12), k
    assert 0 < got_coco["map"] < 1


@functools.cache
def spread_v5n():
    """jax_v5("n", 64) with the BatchNorm shifts (bias, running mean)
    zeroed and the head recalibrated. With them, the random-init signal
    decays onto the BN biases and many anchors of a class score closer
    together than the two models' obj*cls agree (a few f32 ulps): which
    of two such rivals survives NMS, and their order in the AP ranking,
    then differs between the sides. Without them the scores of
    neighbouring anchors lie apart."""
    jm, v = jax_v5("n", 64)

    def walk(params, stats):
        for name, node in params.items():
            if "scale" in node:
                node["bias"] = np.zeros_like(node["bias"])
                stats[name]["mean"] = np.zeros_like(stats[name]["mean"])
            elif isinstance(node, dict):
                walk(node, stats.get(name, {}))

    walk(v["params"], v["batch_stats"])
    head = v["params"]["head"]
    probe = np.random.default_rng(1).integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    _, raws = jm.apply(v, jnp.asarray(probe), training=False)
    for i, raw in enumerate(raws):
        head[f"m_{i}"]["kernel"] = (head[f"m_{i}"]["kernel"]
                                    / np.asarray(raw).std()).astype(np.float32)
    return jm, v


def test_eval_slice_matches_jax():
    """JAX make_eval_step + DetEvaluator against the port's make_eval_step +
    validate/test: 2 batches of 2 frames, ground truth from the JAX
    detections, jittered. The eval protocol but for max_cand=512."""
    post = {"max_cand": 512}
    jm, v = spread_v5n()
    state = create_train_state(v, optax.sgd(0.01))
    jax_step = jax_make_eval_step(jm, postprocess_kwargs=post)
    rng = np.random.default_rng(31)
    batches, jax_dets = [], []
    for bi in range(2):
        images = rng.integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
        jd, jv = jax_step(state, jnp.asarray(images))
        jd, jv = np.asarray(jd), np.asarray(jv)
        jax_dets.append((jd, jv))
        batches.append({"image": images, "targets": pseudo_targets(jd, jv, (64, 64), rng),
                        "info": [(64, 64, 1.0, (0.0, 0.0), 2 * bi + i) for i in range(2)],
                        "count": 2})

    port_step = make_eval_step(port_v5("n", v), postprocess_kwargs=post)
    port_dets = []

    def recording_step(images):
        dets, valid = port_step(images)
        port_dets.append((dets.numpy(), valid.numpy()))
        return dets, valid

    evaluator = DetEvaluator(COCO, img_size=64)
    got = trainer.validate(recording_step, batches, evaluator)
    got_test = trainer.test(recording_step, batches, evaluator)

    theirs = JaxDetEvaluator(JAX_COCO, img_size=64)
    theirs.reset(collect_coco=True)
    for b, (jd, jv) in zip(batches, jax_dets):
        theirs.update(jd, jv, b["targets"], b["info"], b["count"])
    want, want_coco = theirs.summarize(), theirs.summarize_coco()

    assert len(port_dets) == 4
    for (jd, jv), (td, tv) in zip(jax_dets * 2, port_dets):
        for i in range(2):
            assert jv[i].sum() > 10
            assert_same_detections(jd[i][jv[i]], td[i][tv[i]])
    assert 0 < got["map50_95"] < 1
    for result in (got, got_test):
        for k in ("map50", "map50_95"):
            assert result[k] == pytest.approx(want[k], abs=1e-6), k
    for k in want_coco:
        assert got_test["coco"][k] == pytest.approx(want_coco[k], abs=1e-6), k


def test_eval_step_defaults_and_device():
    assert EVAL_POSTPROCESS == dict(conf_thres=0.001, iou_thres=0.6, multi_label=True,
                                    max_det=300, max_cand=2048, multi_label_top=20)
    _, v = jax_v5("n", 64)
    model = port_v5("n", v).train()
    step = make_eval_step(model, postprocess_kwargs={"max_cand": 256, "max_det": 50})
    assert not model.training
    before = greedy_keep.launches
    dets, valid = step(np.zeros((1, 64, 64, 3), np.uint8))
    assert dets.shape == (1, 50, 6) and valid.shape == (1, 50)
    assert dets.device.type == "cpu" and not torch.is_inference_mode_enabled()
    assert greedy_keep.launches == before


def test_predictor_multi_label_matches_jax():
    jm, v = spread_v5n()
    imgs = np.random.default_rng(5).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    kw = dict(img_size=64, multi_label=True, max_cand=512)
    want, _ = JaxPredictor(jm, v, approx_topk=False, **kw).predict_batch(imgs)
    got, _ = Predictor(port_v5("n", v), device="cpu", **kw).predict_batch(imgs)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert len(w) > 10
        assert_same_detections(w, g)
        assert np.all(g[:, [0, 2]] <= 128) and np.all(g[:, [1, 3]] <= 96)


@pytest.mark.parametrize("route", ["topk_stable", "_topk_by_sort", "_topk_by_int64"])
@pytest.mark.parametrize("width,k", [(2100, 300), (80, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_stable_matches_lax_top_k(dtype, width, k, route):
    """Values on a coarse grid, signed zeros, negatives and the NEG_INF
    gate value: equal values come out lower index first, as in JAX, by
    topk_stable and by each of its routes (the sort that it takes for
    short rows and the int64 top-k that it takes for long ones) at both
    widths."""
    rng = np.random.default_rng(2)
    x = np.round(rng.normal(0, 2, (3, width)) * 2) / 2
    x[:, ::7] = -1e9
    x[:, 3::11] = -0.0
    x[:, 5::13] = 0.0
    xt = torch.from_numpy(x).to(dtype)
    want_v, want_i = jax.lax.top_k(jnp.asarray(xt.float().numpy()), k)
    got_v, got_i = getattr(nms_port, route)(xt, k)
    assert got_v.dtype == dtype
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(want_v))
