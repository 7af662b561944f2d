"""Spatial partitioning of the port (vision_kit_tpu_torch/parallel/spatial.py:
the mesh's model axis, height bands with halo exchange) on the CPU over
gloo ranks, against the port unsharded and against JAX's spatial runs on
the conftest's fake CPU devices.

- The band plan and JAX's size check; spatial=True without a mesh raises.
- On a 1x2 mesh (two ranks, n_model 2): Predictor(spatial=True) at v5n@192
  on a 200x300 frame and on a batch of 2 against the port unsharded and
  against JAX's Predictor(mesh=make_mesh(n_data=1, n_model=2),
  spatial=True), as detection sets within rtol 1e-5 and atol 1e-4
  (tests/test_e2e.py's tolerance; assert_same_set); a Focus/SPP v5n at 128, whose
  13-pool halo (6 rows) outgrows the 2-row bands of the stride-32 map,
  banded against unbanded (raw maps exact; parameter gradients); the
  spatial train step against the port's unsharded step (losses at
  test_torch_train.METRIC_RTOL, the state, BatchNorm statistics included,
  at its VALUE_REL / STEP_REL) and against JAX's spatial step at
  test_torch_distributed.MESH_STEP_REL, with accum_steps 2 and remat, and
  with YoloLossOTA; make_eval_step(spatial=True) against unsharded; an
  InferenceServer over the spatial Predictor answering as one process.
- On a 1x3 mesh: a halo that spans two bands, against the padded whole
  map, with its gradient; the Focus/SPP v5n at 192 banded in three.
- On a 2x2 mesh (four ranks): the Predictor at batch 4, the train step and
  the eval step against unsharded; the step without spatial (replicated
  over the model axis) against unsharded.

The ranks run as processes (tests/torch_dist_lib.py), started before the
JAX side compiles and joined after it.
"""

import os

import numpy as np
import pytest
import torch

import jax

from test_torch_distributed import MESH_STEP_REL, jit_v5n
from test_torch_mesh_serve import SAMPLES, SERVER_IMAGES, assert_same_answer
from test_torch_model import port_v5
from test_torch_train import EPOCHS, METRIC_RTOL, STEP_REL, STEPS_PER_EPOCH, VALUE_REL
from torch_dist_lib import Ranks, post_image, serving_frames
from vision_kit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu.train import optim as jax_optim
from vision_kit_tpu.train.losses import YoloLoss as JaxYoloLoss
from vision_kit_tpu.train.step import create_train_state as jax_create_train_state
from vision_kit_tpu.train.step import make_train_step as jax_make_train_step
from vision_kit_tpu_torch.convert import (
    state_dict_from_jax_variables,
    train_state_tensors_from_jax,
)
from vision_kit_tpu_torch.parallel.mesh import Mesh
from vision_kit_tpu_torch.parallel.spatial import band_plan, check_height
from vision_kit_tpu_torch.predictor import Predictor
from vision_kit_tpu_torch.serve import InferenceServer
from vision_kit_tpu_torch.train import optim
from vision_kit_tpu_torch.train.losses import YoloLoss
from vision_kit_tpu_torch.train.step import make_eval_step, make_train_step
from vision_kit_tpu_torch.utils.stream_bench import (
    STATE_PARTS,
    TRAIN_HYP,
    bench_targets,
    state_disagreements,
)

torch.set_num_threads(2)

SIZE, FRAME_HW = 192, (200, 300)   # tests/test_e2e.py:test_predict_spatial_multichip
KW = dict(conf_thres=0.01, max_cand=256, max_det=50)
TRAIN_SIZE, STEPS = 128, 2         # >= 64 rows a band (the size check)
SERVE_SIZE = 128
EVAL_POST = {"max_cand": 256}
RTOL, ATOL = 1e-5, 1e-4            # tests/test_e2e.py:test_predict_spatial_multichip


def train_batches(seed: int, batch: int):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 255, (batch, TRAIN_SIZE, TRAIN_SIZE, 3),
                                   dtype=np.uint8),
             "targets": bench_targets(rng, batch)[:, :8]} for _ in range(STEPS)]


def train_case(state_path, batches_path, loss="yolo", **step_kw):
    return {"target": "torch_dist_lib:train_worker",
            "kwargs": dict(state_path=state_path, batches_path=batches_path, hyp=TRAIN_HYP,
                           epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH, loss=loss,
                           step_kw={"spatial": True, **step_kw}, one_process=True,
                           value_rel=VALUE_REL, step_rel=STEP_REL)}


def jax_spatial_run(jm, v, batches):
    """JAX's spatial step on a 1x2 mesh of the fake CPU devices: each step's
    metrics, and the state before the last step and after it, under the
    port's names."""
    mesh = jax_make_mesh(n_data=1, n_model=2)
    tx = jax_optim.make_optimizer(v["params"], TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    state = jax_create_train_state(v, tx)
    step = jax_make_train_step(jm, JaxYoloLoss(80, jm.grid_anchors, TRAIN_HYP,
                                               layout="native"),
                               tx, mesh=mesh, donate=False, spatial=True)
    metrics = []
    for b in batches:
        before = state
        state, m = step(state, b)
        metrics.append({k: float(x) for k, x in m.items()})

    def parts(s):
        t = train_state_tensors_from_jax(jax.device_get(s))
        return {p: t[p] for p in STATE_PARTS}

    return {"metrics": metrics, "before_last": parts(before), "last": parts(state)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 1x2, 1x3 and 2x2 rank runs, started together; JAX's spatial
    Predictor and step meanwhile."""
    tmp = str(tmp_path_factory.mktemp("spatial"))
    # training on jit_v5n's weights, serving and eval on its spread ones,
    # whose scores lie apart (crowded ones tie exactly on the letterbox's
    # constant border, and which of the tied boxes a max_det cut keeps
    # turns on the last ulp of the maps)
    jm, v = jit_v5n()
    state_path = os.path.join(tmp, "v5n.pt")
    torch.save(state_dict_from_jax_variables(v), state_path)
    _, spread = jit_v5n(spread=True)
    spread_path = os.path.join(tmp, "spread.pt")
    torch.save(state_dict_from_jax_variables(spread), spread_path)
    batches = {"b2": train_batches(21, 2), "b4": train_batches(22, 4)}
    paths = {}
    for name, b in batches.items():
        paths[name] = os.path.join(tmp, f"{name}.pt")
        torch.save(b, paths[name])
    images = [os.path.join(SAMPLES, n) for n in SERVER_IMAGES]
    predict = {"target": "torch_dist_lib:spatial_predictor_worker",
               "kwargs": dict(state_path=spread_path, size=SIZE, hw=list(FRAME_HW), n=2,
                              kw=KW)}
    one_by_two = {
        "predict": predict,
        "focus": {"target": "torch_dist_lib:spatial_forward_worker",
                  "kwargs": dict(size=128)},
        "train": train_case(state_path, paths["b2"]),
        "accum_remat": train_case(state_path, paths["b2"], accum_steps=2, remat=True),
        "ota": train_case(state_path, paths["b2"], loss="ota"),
        "eval": {"target": "torch_dist_lib:spatial_eval_worker",
                 "kwargs": dict(state_path=spread_path, size=TRAIN_SIZE, n=2,
                                post=EVAL_POST)},
        "server": {"target": "torch_dist_lib:server_worker",
                   "kwargs": dict(state_path=spread_path, size=SERVE_SIZE, batch_size=2,
                                  images=images, kw={**KW, "spatial": True})},
    }
    one_by_three = {
        "halo_two_bands": {"target": "torch_dist_lib:halo_worker",
                           "kwargs": dict(height=192, top=6, bottom=6, edge=6)},
        "halo_strided": {"target": "torch_dist_lib:halo_worker",
                         "kwargs": dict(height=224, top=1, bottom=0, edge=1)},
        "focus": {"target": "torch_dist_lib:spatial_forward_worker",
                  "kwargs": dict(size=192, batch=1)},
    }
    two_by_two = {
        "predict": {"target": "torch_dist_lib:spatial_predictor_worker",
                    "kwargs": dict(state_path=spread_path, size=SIZE, hw=list(FRAME_HW),
                                   n=4, kw=KW)},
        "train": train_case(state_path, paths["b4"]),
        "replicated": train_case(state_path, paths["b4"], spatial=False),
        "eval": {"target": "torch_dist_lib:spatial_eval_worker",
                 "kwargs": dict(state_path=spread_path, size=TRAIN_SIZE, n=4,
                                post=EVAL_POST)},
    }
    started = {"1x2": Ranks(2, "torch_dist_lib:cases_worker", {"cases": one_by_two},
                            n_model=2),
               "1x3": Ranks(3, "torch_dist_lib:cases_worker", {"cases": one_by_three},
                            threads=1, n_model=3),
               "2x2": Ranks(4, "torch_dist_lib:cases_worker", {"cases": two_by_two},
                            threads=1, n_model=2)}
    try:
        jax_pred = JaxPredictor(jm, spread, img_size=SIZE, approx_topk=False, spatial=True,
                                mesh=jax_make_mesh(n_data=1, n_model=2), **KW)
        want_jax = {"single": jax_pred(serving_frames(7, 1, FRAME_HW)[0])[0],
                    "batch": jax_pred.predict_batch(serving_frames(8, 2, FRAME_HW))[0],
                    "train": jax_spatial_run(jm, v, batches["b2"])}
    finally:
        got = {name: r.results(timeout=600) for name, r in started.items()}
    return {"got": got, "jax": want_jax, "spread": spread}


def assert_same_set(want, got):
    """Detection sets (n, 6) equal within RTOL and ATOL: the same count, and
    each wanted row matches a distinct got row of its class. Scores that tie
    exactly (boxes on the letterbox's constant border) come in either
    order: a band's convolutions round an ulp otherwise than the whole
    image's, and so do JAX's."""
    assert want.shape == got.shape, (want.shape, got.shape)
    free = np.ones(len(got), bool)
    for row in want:
        ok = free & (got[:, 5] == row[5]) & np.isclose(got, row, rtol=RTOL,
                                                       atol=ATOL).all(axis=1)
        assert ok.any(), (row, got)
        free[np.argmax(ok)] = False


def assert_same_eval(got, want):
    """Eval-step outputs (dets, valid) equal as detection sets, image by
    image."""
    (gd, gv), (wd, wv) = got, want
    np.testing.assert_array_equal(gv.sum(1), wv.sum(1))
    for i in range(len(wv)):
        assert_same_set(wd[i][wv[i]], gd[i][gv[i]])


def case(runs, mesh, name):
    results = [r[name] for r in runs["got"][mesh]]
    for r in results:
        assert "error" not in r, r.get("error")
    return results


def check_train(results):
    """The ranks bit-identical, rank 0 against its one-process run."""
    assert all(r["digest"] == results[0]["digest"] for r in results), \
        "the ranks' states differ"
    assert all(r["metrics"] == results[0]["metrics"] for r in results)
    main = results[0]
    for got, want in zip(main["metrics"], main["one_process_metrics"]):
        for k, rtol in METRIC_RTOL.items():
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert main["one_process_disagreements"] == []


@pytest.mark.parametrize("height,n_model,want", [
    (640, 3, [(0, 224), (224, 448), (448, 640)]),
    (640, 2, [(0, 320), (320, 640)]),
    (128, 2, [(0, 64), (64, 128)]),
    (200, 3, [(0, 64), (64, 128), (128, 200)]),
])
def test_band_plan(height, n_model, want):
    """Bands start on multiples of 32, as even as multiples of 32 allow;
    the last takes the tail."""
    assert band_plan(height, n_model) == want


def test_size_check_and_missing_mesh_raise():
    """tests/test_round2.py:test_predictor_spatial_size_check's case, and
    spatial=True without a mesh, in each entry point."""
    _, v = jit_v5n()
    model = port_v5("n", v)
    mesh = Mesh(n_data=4, rank=0, device=torch.device("cpu"), n_model=2)
    with pytest.raises(ValueError, match="spatial"):
        Predictor(model, img_size=96, mesh=mesh, spatial=True)
    with pytest.raises(ValueError, match="spatial"):
        check_height(127, 2)
    check_height(128, 2)
    with pytest.raises(ValueError, match="mesh"):
        Predictor(model, img_size=SIZE, device="cpu", spatial=True)
    tx = optim.make_optimizer(model, TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    loss = YoloLoss(80, model.head.grid_anchors, TRAIN_HYP)
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(model, loss, tx, spatial=True)
    with pytest.raises(ValueError, match="mesh"):
        make_eval_step(model, spatial=True)


def test_spatial_predictor_matches_unsharded_and_jax(runs):
    one = Predictor(port_v5("n", runs["spread"]), img_size=SIZE, device="cpu", **KW)
    single = one(serving_frames(7, 1, FRAME_HW)[0])[0]
    batch = one.predict_batch(serving_frames(8, 2, FRAME_HW))[0]
    results = case(runs, "1x2", "predict")
    for r in results:
        assert len(r["single"]) > 10
        assert_same_set(single, r["single"])
        assert_same_set(runs["jax"]["single"], r["single"])
        for g, w, j, run in zip(r["batch"], batch, runs["jax"]["batch"], r["run"]):
            assert_same_set(w, g)
            assert_same_set(j, g)
            np.testing.assert_array_equal(g, run)


@pytest.mark.parametrize("mesh", ["1x2", "1x3"])
def test_focus_spp_halo_spans_bands(runs, mesh):
    """The 13-pool's 6-row halo at the stride-32 map, where a band holds 2
    rows: on 1x2 it runs past the neighbour into the border, on 1x3 it
    takes rows of two bands."""
    for r in case(runs, mesh, "focus"):
        assert r["eval_max_rel"] <= 1e-6, r["eval_max_rel"]
        # f32 sums of the BatchNorm statistics and of the gradients in
        # another order: test_torch_train.VALUE_REL of a tensor's largest
        assert r["grad_max_rel"] <= VALUE_REL, r["grad_max_rel"]


@pytest.mark.parametrize("name", ["halo_two_bands", "halo_strided"])
def test_halo_rows_and_gradient(runs, name):
    results = case(runs, "1x3", name)
    kw = {"halo_two_bands": (6, 6), "halo_strided": (1, 1)}[name]
    top, below = kw
    grad = results[0]["grad"]
    want = torch.zeros((*grad.shape[:2], grad.shape[2] + top + below, grad.shape[3]))
    for r in results:
        assert r["max_diff"] == 0.0
        torch.testing.assert_close(r["grad"], grad, rtol=0, atol=0)
        rows = r["g"].shape[2]
        want[:, :, r["start"]:r["start"] + rows] += r["g"]
    torch.testing.assert_close(grad, want[:, :, top:top + grad.shape[2]], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["train", "accum_remat", "ota"])
def test_spatial_step_matches_unsharded(runs, name):
    check_train(case(runs, "1x2", name))


def test_spatial_step_matches_jax(runs):
    main = case(runs, "1x2", "train")[0]
    want = runs["jax"]["train"]
    for got, w in zip(main["metrics"], want["metrics"]):
        for k, rtol in METRIC_RTOL.items():
            np.testing.assert_allclose(got[k], w[k], rtol=rtol, err_msg=k)
    assert state_disagreements(want["last"], main["last"], want["before_last"],
                               VALUE_REL, MESH_STEP_REL) == []


def test_spatial_eval_step_matches_unsharded(runs):
    for r in case(runs, "1x2", "eval"):
        assert r["want"][1].sum() > 10
        assert_same_eval(r["got"], r["want"])


def test_server_over_spatial_predictor_answers_like_one_process(runs):
    images = [os.path.join(SAMPLES, n) for n in SERVER_IMAGES]
    srv = InferenceServer(Predictor(port_v5("n", runs["spread"]), img_size=SERVE_SIZE,
                                    device="cpu", **KW),
                          batch_size=2, max_wait_ms=200.0, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/predict"
        want = []
        for p in images:
            with open(p, "rb") as f:
                want.append(post_image(url, f.read()))
    finally:
        srv.stop()
    r0, r1 = case(runs, "1x2", "server")
    assert r1["port"] is None and r0["port"] is not None
    for w, g in zip(want, r0["sequential"]):
        assert_same_answer(w, g)
    for w, g in zip(want, r0["concurrent"]):
        assert_same_answer(w, g)


def test_two_by_two_mesh(runs):
    """A 2x2 mesh: the batch of 4 shards over the data axis (2 frames a
    model group), each image's height over the model axis; and the step
    without spatial, which the model axis replicates (its sums run over
    the data axis alone), as JAX's step over such a mesh does."""
    one = Predictor(port_v5("n", runs["spread"]), img_size=SIZE, device="cpu", **KW)
    batch = one.predict_batch(serving_frames(8, 4, FRAME_HW))[0]
    for r in case(runs, "2x2", "predict"):
        assert sum(len(d) for d in r["batch"]) > 40
        for g, w, run in zip(r["batch"], batch, r["run"]):
            assert_same_set(w, g)
            np.testing.assert_array_equal(g, run)
    check_train(case(runs, "2x2", "train"))
    check_train(case(runs, "2x2", "replicated"))
    for r in case(runs, "2x2", "eval"):
        assert_same_eval(r["got"], r["want"])
