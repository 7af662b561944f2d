"""Data-parallel serving of the port on the CPU: Predictor(mesh=...) on two
gloo ranks against one process and against JAX's Predictor on a 2-device
mesh, and InferenceServer over the 2-rank Predictor against the
one-process server.

- A batch that divides by the mesh (4 frames): each rank runs its 2 rows
  and every rank gets the whole batch; the rows a rank ran equal the same
  rows run alone by one process, exactly. A batch that does not divide (3
  frames) and a single frame run whole on every rank.
- Against one process on the whole batch and against JAX's mesh
  Predictor: counts and classes exact, the rest within rtol 1e-5 and atol
  1e-4 (tests/test_e2e.py:test_predict_batch_multichip's tolerance).
- The server: rank 0 alone binds HTTP; its answers, one request at a time
  and all at once, equal the one-process server's within the JSON's
  rounding (scores to 5 decimals, boxes to 2).

The ranks run as two processes at two threads each (tests/torch_dist_lib.py),
started before the JAX side compiles and joined after it.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_model import jax_v5, port_v5
from torch_dist_lib import Ranks, post_image, run_ranks, serving_frames
from vision_kit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu_torch.convert import state_dict_from_jax_variables
from vision_kit_tpu_torch.predictor import Predictor
from vision_kit_tpu_torch.serve import InferenceServer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "vision_kit_tpu_torch", "data", "samples")
SIZE = 64
KW = dict(max_cand=256, max_det=50)
BATCHES = {"divides": (11, 4), "does_not_divide": (12, 3)}
SERVER_IMAGES = ("grey_240x320.jpg", "s422_240x320.jpg", "s444_240x320.jpg",
                 "restart4_240x320.jpg", "odd_333x517.jpg")


@pytest.fixture(scope="module")
def v5n(tmp_path_factory):
    """JAX's v5n@64 with crowded detections, its numpy variables and the
    same weights as a port state_dict file."""
    jm, v = jax_v5("n", SIZE)
    path = str(tmp_path_factory.mktemp("mesh_serve") / "v5n.pt")
    torch.save(state_dict_from_jax_variables(v), path)
    return jm, v, path


def assert_close(want, got):
    """Counts and classes exact, the rest within rtol 1e-5, atol 1e-4."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_array_equal(w[:, 5], g[:, 5])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def test_mesh_predictor_matches_one_process_and_jax(v5n):
    jm, v, path = v5n
    ranks = Ranks(2, "torch_dist_lib:predictor_worker",
                  {"state_path": path, "size": SIZE, "batches": BATCHES, "kw": KW})
    jax_mesh = JaxPredictor(jm, v, img_size=SIZE, approx_topk=False,
                            mesh=jax_make_mesh(n_data=2), **KW)
    want_jax = {name: jax_mesh.predict_batch(serving_frames(seed, n))[0]
                for name, (seed, n) in BATCHES.items()}
    one = Predictor(port_v5("n", v), img_size=SIZE, device="cpu", **KW)
    r0, r1 = ranks.results()
    for name, (seed, n) in BATCHES.items():
        whole = one.predict_batch(serving_frames(seed, n))[0]
        for r in (r0, r1):
            got = r[name]["predict_batch"]
            assert len(got) == n and sum(len(d) for d in got) > 10
            # every rank holds the whole batch, and run() gives predict_batch's
            assert_close(r0[name]["predict_batch"], got)
            for a, b in zip(got, r[name]["run"]):
                np.testing.assert_array_equal(a, b)
            assert_close(whole, got)
            assert_close(want_jax[name], got)
        if name == "divides":
            for rank, r in enumerate((r0, r1)):
                assert r[name]["rows"] == list(range(rank * n // 2, (rank + 1) * n // 2))
                for i, row in enumerate(r[name]["rows"]):
                    np.testing.assert_array_equal(r[name]["alone"][i],
                                                  r[name]["predict_batch"][row])
        else:
            assert "rows" not in r0[name]
    want_single = one(serving_frames(99, 1)[0])[0]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["single"], want_single)


def test_predictor_mesh_options(v5n):
    _, v, _ = v5n
    model = port_v5("n", v)
    with pytest.raises(ValueError, match="requires a mesh"):
        Predictor(model, img_size=SIZE, device="cpu", spatial=True)
    with pytest.raises(TypeError, match="make_mesh"):
        Predictor(model, img_size=SIZE, device="cpu", mesh="data")


def _rows(payload):
    return np.array([d["box"] + [d["score"], d["class"]] for d in payload["detections"]],
                    np.float64).reshape(-1, 6)


def assert_same_answer(want, got):
    """Two /predict answers equal within the JSON's rounding."""
    (ws, wp), (gs, gp) = want, got
    assert ws == gs == 200
    assert (wp["width"], wp["height"]) == (gp["width"], gp["height"])
    w, g = _rows(wp), _rows(gp)
    assert w.shape == g.shape
    np.testing.assert_array_equal(w[:, 5], g[:, 5])
    np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=2e-5)
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=0.011)


def test_server_over_mesh_predictor_answers_like_one_process(v5n):
    _, v, path = v5n
    images = [os.path.join(SAMPLES, n) for n in SERVER_IMAGES]
    ranks = Ranks(2, "torch_dist_lib:server_worker",
                  {"state_path": path, "size": SIZE, "batch_size": 4, "images": images,
                   "kw": KW})
    srv = InferenceServer(Predictor(port_v5("n", v), img_size=SIZE, device="cpu", **KW),
                          batch_size=4, max_wait_ms=200.0, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/predict"
        want = []
        for p in images:
            with open(p, "rb") as f:
                want.append(post_image(url, f.read()))
    finally:
        srv.stop()
    r0, r1 = ranks.results()
    assert isinstance(r0["port"], int) and r1["port"] is None
    assert sum(len(a[1]["detections"]) for a in want) > 10
    for w, seq, conc in zip(want, r0["sequential"], r0["concurrent"]):
        assert_same_answer(w, seq)
        assert_same_answer(w, conc)
    assert r0["healthz"] == {"ok": True, "platform": "cpu", "img_size": [SIZE, SIZE],
                             "batch_size": 4}
    assert r0["stats"]["requests"] == 2 * len(images) and r0["stats"]["errors"] == 0


def test_server_follower_binds_no_port(v5n):
    """A follower rank never binds: two ranks serve one port between them."""
    _, _, path = v5n
    r0, r1 = run_ranks(2, "torch_dist_lib:server_worker",
                       {"state_path": path, "size": SIZE, "batch_size": 2,
                        "images": [os.path.join(SAMPLES, SERVER_IMAGES[0])], "kw": KW})
    assert r1["port"] is None and r0["sequential"][0][0] == 200
    assert r0["stats"]["batches"] == 2
