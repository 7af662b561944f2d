"""The port's data parallelism (vision_kit_tpu_torch.parallel) on the CPU,
over gloo, against one process and against JAX's step on a 2-device mesh.

- init_distributed: the counterparts of tests/test_distributed.py's gating
  tests (no-op, explicit arguments, the environment, torchrun's variables,
  explicit over environment), with init_process_group replaced by a
  recorder; a rendezvous that fails raises (by design, where the JAX
  version stays single-host).
- The synced BatchNorm2d on 2 ranks equals one process on the whole
  batch: output, input and weight gradients, running statistics, to 1e-6
  of each tensor's largest magnitude.
- A 2-rank train step of v5n@64 in f32, each rank holding its rows of
  global batches of 4 over 3 steps, against (a) the port on the global
  batch in one process and (b) JAX's step on a 2-device CPU mesh: losses
  within test_torch_train.METRIC_RTOL, the state within its VALUE_REL and
  STEP_REL of the last step's change against one process (MESH_STEP_REL
  against JAX, see there), the ranks bit-identical. One global
  batch gives rank 1 no targets at all: the global normalisers match JAX,
  and an average of per-rank losses (what DDP would train on) does not.
  Remat with multi-scale, and device augmentation, against one process.
  (tests/test_torch_distributed_options.py: YoloLossOTA and accum_steps 2.)
- 2-rank validate equals 1-process validate, with an uneven last batch
  that leaves rank 1 only padding.

The ranks run as two processes at two threads each (tests/torch_dist_lib.py),
started before the JAX step compiles and joined after it.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from fixture_lib import build_rectangle_dataset
from test_torch_model import randomize_bn
from test_torch_train import EPOCHS, METRIC_RTOL, STEP_REL, STEPS_PER_EPOCH, VALUE_REL
from torch_dist_lib import (
    DIST_ENV,
    Ranks,
    bn_inputs,
    bn_module,
    bn_step,
    free_port,
    port_v5n,
    run_ranks,
)
from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
from vision_kit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vision_kit_tpu.parallel.mesh import shard_batch as jax_shard_batch
from vision_kit_tpu.train import optim as jax_optim
from vision_kit_tpu.train.losses import YoloLoss as JaxYoloLoss
from vision_kit_tpu.train.ota import YoloLossOTA as JaxYoloLossOTA
from vision_kit_tpu.train.step import create_train_state as jax_create_train_state
from vision_kit_tpu.train.step import make_train_step as jax_make_train_step
from vision_kit_tpu_torch.convert import (
    state_dict_from_jax_variables,
    train_state_tensors_from_jax,
)
from vision_kit_tpu_torch.data.datasets import YOLODataset
from vision_kit_tpu_torch.data.loader import ValLoader
from vision_kit_tpu_torch.parallel import distributed as pdist
from vision_kit_tpu_torch.parallel import mesh as pmesh
from vision_kit_tpu_torch.train import trainer
from vision_kit_tpu_torch.train.evaluator import DetEvaluator
from vision_kit_tpu_torch.train.losses import YoloLoss
from vision_kit_tpu_torch.train.step import make_eval_step
from vision_kit_tpu_torch.utils.stream_bench import (
    STATE_PARTS,
    TRAIN_HYP,
    bench_targets,
    daug_batch,
    state_disagreements,
)

torch.set_num_threads(2)

# synced BatchNorm against one process, of a tensor's max, by dtype
BN_REL = {"float32": 1e-6, "float64": 1e-12}
# JAX's step on the 2-device mesh against JAX's own 1-device step on these
# batches (gradient norms ~2000, clipped to 10) already differs by up to
# 1.8x test_torch_train's STEP_REL of the last step's change (reductions
# over the batch in another order), and so does the port in one process:
# the mesh comparison with JAX holds the state to MESH_STEP_REL. Against
# the port in one process the 2-rank run keeps STEP_REL.
MESH_STEP_REL = 5e-3
VAL_ATOL = 1e-9    # 2-rank validate against one process
WORLD, BATCH, STEPS = 2, 4, 3


# -- init_distributed ----------------------------------------------------------

@pytest.fixture()
def clean_env(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


class _Recorder:
    def __init__(self, fail=None):
        self.calls = []
        self.fail = fail

    def __call__(self, *a, **kw):
        self.calls.append((a, kw))
        if self.fail is not None:
            raise self.fail


def _patch(monkeypatch, fail=None):
    rec = _Recorder(fail)
    monkeypatch.setattr(dist, "init_process_group", rec)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    return rec


def _call(address, world, rank, backend="gloo"):
    return ((backend,), dict(init_method=f"tcp://{address}", world_size=world, rank=rank))


def test_single_process_is_noop(clean_env):
    rec = _patch(clean_env)
    assert pdist.init_distributed() is False
    clean_env.setenv("WORLD_SIZE", "1")          # torchrun --nproc_per_node 1
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("MASTER_PORT", "29500")
    assert pdist.init_distributed() is False
    assert rec.calls == []


def test_explicit_args_forwarded(clean_env):
    rec = _patch(clean_env)
    assert pdist.init_distributed("127.0.0.1:1234", num_processes=2, process_id=0,
                                  backend="gloo") is True
    assert rec.calls == [_call("127.0.0.1:1234", 2, 0)]
    # an explicit address joins even a world of one
    assert pdist.init_distributed("127.0.0.1:1235", 1, 0, backend="gloo") is True
    assert rec.calls[-1] == _call("127.0.0.1:1235", 1, 0)


def test_torchrun_env_parsed(clean_env):
    rec = _patch(clean_env)
    for k, v in (("MASTER_ADDR", "127.0.0.2"), ("MASTER_PORT", "29511"),
                 ("WORLD_SIZE", "4"), ("RANK", "3"), ("LOCAL_RANK", "3")):
        clean_env.setenv(k, v)
    assert pdist.init_distributed(backend="gloo") is True
    assert rec.calls == [_call("127.0.0.2:29511", 4, 3)]


def test_jax_env_parsed(clean_env):
    rec = _patch(clean_env)
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:7777")
    clean_env.setenv("JAX_NUM_PROCESSES", "4")
    clean_env.setenv("JAX_PROCESS_ID", "3")
    assert pdist.init_distributed() is True       # no CUDA here: gloo
    assert rec.calls == [_call("127.0.0.1:7777", 4, 3)]


def test_explicit_args_beat_env(clean_env):
    rec = _patch(clean_env)
    for k, v in (("MASTER_ADDR", "127.0.0.2"), ("MASTER_PORT", "1"),
                 ("WORLD_SIZE", "16"), ("RANK", "9")):
        clean_env.setenv(k, v)
    assert pdist.init_distributed("127.0.0.1:2", num_processes=2, process_id=1,
                                  backend="gloo") is True
    assert rec.calls == [_call("127.0.0.1:2", 2, 1)]


def test_failed_rendezvous_raises(clean_env):
    """A launch that asks for two processes never goes on alone: a
    rendezvous that fails raises, one without an address raises, and a
    real one at a port already taken raises."""
    rec = _patch(clean_env, fail=RuntimeError("rendezvous unreachable"))
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    clean_env.setenv("JAX_NUM_PROCESSES", "2")
    clean_env.setenv("JAX_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="unreachable"):
        pdist.init_distributed()
    assert len(rec.calls) == 1
    clean_env.delenv("JAX_COORDINATOR_ADDRESS")
    with pytest.raises(RuntimeError, match="rendezvous address"):
        pdist.init_distributed()
    clean_env.undo()
    for k in DIST_ENV:
        clean_env.delenv(k, raising=False)
    import socket

    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        with pytest.raises(Exception):
            pdist.init_distributed(f"127.0.0.1:{port}", 2, 0, backend="gloo")
    assert not dist.is_initialized()


def test_free_ports_are_this_workers_own(monkeypatch):
    """Rank groups meet at ports of their pytest-xdist worker's own block,
    below the ephemeral range, one after another, never one that is taken;
    the blocks of two workers of one run do not overlap, and another run's
    id shifts them."""
    import socket

    import torch_dist_lib

    monkeypatch.setenv("PYTEST_XDIST_TESTRUNUID", "run-a")
    blocks = {}
    for worker in ("gw0", "gw5"):
        monkeypatch.setenv("PYTEST_XDIST_WORKER", worker)
        base = torch_dist_lib.port_block()
        taken = base + (next(torch_dist_lib._next_port) + 1) % torch_dist_lib.PORTS_PER_WORKER
        with socket.socket() as held:     # the next port in turn: skipped
            held.bind(("127.0.0.1", taken))
            ports = [free_port() for _ in range(6)]
        assert len(set(ports)) == 6 and taken not in ports
        assert all(torch_dist_lib.PORT_BASE <= base <= p < base + torch_dist_lib.PORTS_PER_WORKER
                   < 32768 for p in ports)
        blocks[worker] = set(ports)
    assert not blocks["gw0"] & blocks["gw5"]
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw0")
    here = torch_dist_lib.port_block()
    shifts = set()
    for run in ("run-b", "run-c", "run-d"):
        monkeypatch.setenv("PYTEST_XDIST_TESTRUNUID", run)
        shifts.add(torch_dist_lib.port_block())
    assert shifts - {here}


def test_mesh_needs_a_group_and_one_model_shard():
    """make_mesh needs a process group whose world is n_data * n_model: a
    model axis of 2 over a world of 1 raises naming the world size."""
    if dist.is_initialized():
        pytest.skip("a process group is initialised in this process")
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(device="cpu")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="world size"):
            pmesh.make_mesh(n_model=2, device="cpu")
        with pytest.raises(ValueError, match="world size"):
            pmesh.make_mesh(n_data=2, device="cpu")
        mesh = pmesh.make_mesh(n_data=1, n_model=1, device="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        assert (mesh.data_index, mesh.model_index) == (0, 0)
    finally:
        dist.destroy_process_group()
    with pytest.raises(TypeError):
        pmesh.check_mesh(object())


def test_shard_rows_follow_the_jax_microbatch_split():
    """Rank r's rows: its share of each microbatch, microbatch by
    microbatch, as JAX's step reshapes (A, B/A) and shards each over the
    data axis."""
    rows = [pmesh.shard_rows(pmesh.Mesh(2, r, torch.device("cpu")), 8, 2).tolist()
            for r in range(2)]
    assert rows == [[0, 1, 4, 5], [2, 3, 6, 7]]
    rows = [pmesh.shard_rows(pmesh.Mesh(2, r, torch.device("cpu")), 4).tolist()
            for r in range(2)]
    assert rows == [[0, 1], [2, 3]]
    with pytest.raises(ValueError):
        pmesh.shard_rows(pmesh.Mesh(2, 0, torch.device("cpu")), 6, 2)


def test_shards_draw_their_augmentation_by_global_row():
    """A shard's row k of batch b draws with the key of its row in the global
    batch, so two shards never draw alike; one shard keeps JAX's keys."""
    from vision_kit_tpu_torch.data.loader import _SampleIds

    shards = [_SampleIds(2, r, 2).rows(3) for r in range(2)]
    assert shards == [[(6, 12), (7, 13)], [(6, 14), (7, 15)]]
    assert [key for rows in shards for _, key in rows] == [k for _, k in
                                                           _SampleIds(4).rows(3)]
    assert _SampleIds(4).rows(3) == [(12, 12), (13, 13), (14, 14), (15, 15)]


# -- the runs: JAX's 2-device mesh step, and the port's two ranks -------------

def jit_v5n(spread: bool = False):
    """jax_v5("n", 64)'s weights (test_torch_model) from a jitted init and
    apply (~10 s, not ~20 s eager); spread: test_torch_eval.spread_v5n's
    zeroed BatchNorm shifts, for an eval whose scores lie apart."""
    jm = JaxYOLOV5(variant="n", num_classes=80)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3)), training=False))(
        jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    randomize_bn(v, np.random.default_rng(0))
    if spread:
        def walk(params, stats):
            for name, node in params.items():
                if "scale" in node:
                    node["bias"] = np.zeros_like(node["bias"])
                    stats[name]["mean"] = np.zeros_like(stats[name]["mean"])
                elif isinstance(node, dict):
                    walk(node, stats.get(name, {}))

        walk(v["params"], v["batch_stats"])
    head = v["params"]["head"]
    for i in range(3):
        head[f"m_{i}"]["bias"] = np.zeros_like(head[f"m_{i}"]["bias"])
    probe = np.random.default_rng(1).integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    _, raws = jax.jit(lambda v, x: jm.apply(v, x, training=False))(v, probe)
    for i, raw in enumerate(raws):
        head[f"m_{i}"]["kernel"] = (head[f"m_{i}"]["kernel"]
                                    / np.asarray(raw).std()).astype(np.float32)
    return jm, v


def global_batches(seed: int, empty_rank: int | None = None, device_aug=False):
    """STEPS global batches of BATCH: uint8 64x64 images (or device
    augmentation batches) and bench_targets' labels; empty_rank: that
    rank's rows carry no target."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        if device_aug:
            b = daug_batch(rng, BATCH, 64)
            b["targets"] = b["targets"][:, :8]
        else:
            b = {"image": rng.integers(0, 255, (BATCH, 64, 64, 3), dtype=np.uint8),
                 "targets": bench_targets(rng, BATCH)[:, :8]}
        if empty_rank is not None:
            share = BATCH // WORLD
            b["targets"][empty_rank * share:(empty_rank + 1) * share] = -1
        out.append(b)
    return out


def jax_run(jm, v, batches, loss="yolo", accum_steps=1):
    """JAX's step on a 2-device mesh over the global batches: each step's
    metrics, and the state before the last step and after it, under the
    port's names."""
    mesh = jax_make_mesh(WORLD, 1)
    tx = jax_optim.make_optimizer(v["params"], TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    state = jax_create_train_state(v, tx)
    loss_cls = {"yolo": JaxYoloLoss, "ota": JaxYoloLossOTA}[loss]
    step = jax_make_train_step(jm, loss_cls(80, jm.grid_anchors, TRAIN_HYP), tx,
                               mesh=mesh, donate=False, accum_steps=accum_steps)
    metrics = []
    for b in batches:
        before = state
        state, m = step(state, jax_shard_batch(mesh, b))
        metrics.append({k: float(x) for k, x in m.items()})

    def parts(s):
        t = train_state_tensors_from_jax(jax.device_get(s))
        return {p: t[p] for p in STATE_PARTS}

    return {"metrics": metrics, "before_last": parts(before), "last": parts(state)}


def train_case(state_path, batches_path, loss="yolo", **step_kw):
    return {"target": "torch_dist_lib:train_worker",
            "kwargs": dict(state_path=state_path, batches_path=batches_path,
                           hyp=TRAIN_HYP, epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH,
                           loss=loss, step_kw=step_kw, one_process=True,
                           value_rel=VALUE_REL, step_rel=STEP_REL)}


def start_cases(tmp, jax_cases: dict, port_cases: dict = (), extra: dict = ()):
    """Save v5n's weights and each case's global batches under tmp, start the
    two ranks on every case, and run JAX's mesh step on the JAX cases
    meanwhile. Returns (per-rank results by case, JAX results by case,
    the batches by case)."""
    jm, v = jit_v5n()
    state_path = os.path.join(tmp, "v5n.pt")
    torch.save(state_dict_from_jax_variables(v), state_path)
    cases, batches = {}, {}
    for name, (spec, kw) in {**jax_cases, **dict(port_cases)}.items():
        batches[name] = global_batches(**spec)
        path = os.path.join(tmp, f"{name}.pt")
        torch.save(batches[name], path)
        cases[name] = train_case(state_path, path, **kw)
    cases.update(extra)
    ranks = Ranks(WORLD, "torch_dist_lib:cases_worker", {"cases": cases})
    try:
        want = {name: jax_run(jm, v, batches[name], **kw)
                for name, (_, kw) in jax_cases.items()}
    finally:
        got = ranks.results(timeout=600)
    return {name: [r[name] for r in got] for name in cases}, want, batches


def check_ranks(results):
    for r in results:
        assert "error" not in r, r.get("error")
    assert all(r["digest"] == results[0]["digest"] for r in results), \
        "the ranks' states differ"
    assert all(r["metrics"] == results[0]["metrics"] for r in results)


def check_one_process(results):
    """The 2-rank run against the same run in one process on the global
    batches (compared in rank 0)."""
    main = results[0]
    for got, want in zip(main["metrics"], main["one_process_metrics"]):
        for k, rtol in METRIC_RTOL.items():
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert main["one_process_disagreements"] == []


def check_jax(results, want):
    main = results[0]
    for got, w in zip(main["metrics"], want["metrics"]):
        for k, rtol in METRIC_RTOL.items():
            np.testing.assert_allclose(got[k], w[k], rtol=rtol, err_msg=k)
    assert state_disagreements(want["last"], main["last"], want["before_last"],
                               VALUE_REL, MESH_STEP_REL) == []


JAX_CASES = {"plain": (dict(seed=5), {}),
             "no_targets_on_rank1": (dict(seed=6, empty_rank=1), {})}
PORT_CASES = {"remat_multiscale": (dict(seed=7), dict(remat=True, scale_to=96)),
              "device_aug": (dict(seed=8, device_aug=True), dict(device_aug=True))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ddp"))
    data = os.path.join(tmp, "rect")
    build_rectangle_dataset(data)
    _, spread = jit_v5n(spread=True)
    torch.save(state_dict_from_jax_variables(spread), os.path.join(tmp, "spread.pt"))
    extra = {"validate": {"target": "torch_dist_lib:validate_worker",
                          "kwargs": dict(state_path=os.path.join(tmp, "spread.pt"),
                                         data_dir=os.path.join(data, "images", "val"),
                                         batch=8)}}
    got, want, batches = start_cases(tmp, JAX_CASES, PORT_CASES, extra)
    return {"got": got, "want": want, "batches": batches, "tmp": tmp,
            "val_dir": os.path.join(data, "images", "val")}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_synced_batchnorm_equals_one_process(dtype):
    """Output, gradients and running statistics of the synced BatchNorm2d
    on 2 ranks against one process on the whole batch, in the input's
    dtype (a float64 batch is not rounded to f32 under the mesh)."""
    got = run_ranks(WORLD, "torch_dist_lib:bn_worker", {"seed": 0, "dtype": dtype})
    dt = getattr(torch, dtype)
    inp = bn_inputs(0)
    want = bn_step(bn_module(inp, dt), torch.from_numpy(inp["x"]).to(dt),
                   torch.from_numpy(inp["gy"]).to(dt))
    for k, w in want.items():
        if k in ("y", "x_grad"):         # each rank's rows, in rank order
            g = torch.cat([r[k] for r in got])
        else:                            # the same on every rank
            g = got[0][k]
            assert torch.equal(got[1][k], g), k
        assert g.dtype == dt, (k, g.dtype)
        torch.testing.assert_close(g, w, rtol=0, atol=BN_REL[dtype] * float(w.abs().max()),
                                   msg=k)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_two_rank_step_matches_jax_and_one_process(runs, case):
    results = runs["got"][case]
    check_ranks(results)
    check_one_process(results)
    check_jax(results, runs["want"][case])


def test_per_rank_averaging_would_differ(runs):
    """On the batch that gives rank 1 no target, the global box loss (JAX's,
    and the 2-rank step's) is twice an average of the ranks' own losses,
    which DDP's gradient averaging would train on."""
    got = runs["got"]["no_targets_on_rank1"][0]["metrics"][0]
    want = runs["want"]["no_targets_on_rank1"]["metrics"][0]
    batch = runs["batches"]["no_targets_on_rank1"][0]
    model = port_v5n(os.path.join(runs["tmp"], "v5n.pt"))
    loss = YoloLoss(80, model.head.grid_anchors, TRAIN_HYP)
    share = BATCH // WORLD
    per_rank = []
    with torch.no_grad():
        for r in range(WORLD):
            rows = slice(r * share, (r + 1) * share)
            raws = model(torch.from_numpy(batch["image"][rows]), decode=False)
            per_rank.append(loss(raws, torch.from_numpy(batch["targets"][rows]))[1])
    averaged = torch.stack(per_rank).mean(0)
    np.testing.assert_allclose(got["loss_box"], want["loss_box"],
                               rtol=METRIC_RTOL["loss_box"])
    assert float(per_rank[1][0]) == 0.0
    assert abs(float(averaged[0]) - want["loss_box"]) > 0.3 * want["loss_box"]


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_two_rank_step_options_match_one_process(runs, case):
    results = runs["got"][case]
    check_ranks(results)
    check_one_process(results)


def test_two_rank_validate_equals_one_process(runs):
    """12 val images at batch 8: rank 0 holds 4 real rows of each batch,
    rank 1 4 of the first and none of the last (only padding)."""
    results = runs["got"]["validate"]
    for r in results:
        assert "error" not in r, r.get("error")
    assert [r["counts"] for r in results] == [[4, 4], [4, 0]]
    model = port_v5n(os.path.join(runs["tmp"], "spread.pt")).eval()
    ds = YOLODataset(runs["val_dir"], img_size=64, device="cpu")
    want = trainer.validate(make_eval_step(model, {"max_cand": 512}),
                            ValLoader(ds, 8, img_size=64),
                            DetEvaluator([str(i) for i in range(80)], (64, 64)))
    assert want["map50"] > 0
    for r in results:
        got = r["result"]
        for k in ("map50", "map50_95"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=VAL_ATOL, err_msg=k)
        assert len(got["per_class"]) == len(want["per_class"])
        for g, w in zip(got["per_class"], want["per_class"]):
            assert g["class"] == w["class"] and g["targets"] == w["targets"]
            for k in ("precision", "recall", "ap50", "ap"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=VAL_ATOL, err_msg=k)
