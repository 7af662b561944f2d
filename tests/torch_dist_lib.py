"""Data-parallel runs of the port on the CPU: N processes over gloo, each a
rank of a vision_kit_tpu_torch.parallel mesh.

    results = run_ranks(2, "torch_dist_lib:bn_worker", {"seed": 0})

(or Ranks(...), which returns at once, and its results() later) starts
one process a rank (python tests/torch_dist_lib.py ...), each at
two intra-op threads, joins the process group at a free localhost port
of the pytest-xdist worker's own block (free_port), checks that every
rank holds the launcher's token (no ranks of another group joined),
builds make_mesh(n_model=n_model, device="cpu") (n_model 1 unless given:
a world of 4 at n_model 2 is a 2x2 mesh), calls the named function as fn(mesh,
**kwargs) and saves what it returns (torch.save); run_ranks returns the
ranks' results in rank order, and raises with a rank's stderr when one
fails. The worker functions below import torch and the port only: a rank
starts in about two seconds.
"""

from __future__ import annotations

import hashlib
import importlib
import itertools
import json
import os
import secrets
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
            "JAX_PROCESS_ID")


# Rendezvous ports: each pytest-xdist worker takes its own block of
# PORTS_PER_WORKER ports below Linux's ephemeral range (32768 on), which no
# port-0 bind hands out, and walks it with a counter, skipping any port
# that is taken now. Two rank groups started at once by different workers
# of one run therefore never pick one port, as a bind to port 0 released
# before rank 0 binds it again could (a race the token check of _main also
# catches). The blocks are shifted by a hash of the run's id
# (PYTEST_XDIST_TESTRUNUID, one for all workers of a run; a random shift
# in a plain process) and each process starts its counter at a random
# place in its block, so two runs on one machine seldom meet either.
PORT_BASE, PORTS_PER_WORKER, PORT_BLOCKS = 20000, 200, 60
_next_port = itertools.count(secrets.randbelow(PORTS_PER_WORKER))
_PLAIN_SHIFT = secrets.randbelow(PORT_BLOCKS)


def _worker_index() -> int:
    """gwN -> N + 1 under pytest-xdist, 0 in a plain process."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    return int(worker[2:]) + 1 if worker.startswith("gw") and worker[2:].isdigit() else 0


def port_block() -> int:
    """The first port of this worker's block in this run."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    shift = (int(hashlib.sha256(run.encode()).hexdigest(), 16) % PORT_BLOCKS if run
             else _PLAIN_SHIFT)
    return PORT_BASE + PORTS_PER_WORKER * ((shift + _worker_index()) % PORT_BLOCKS)


def free_port() -> int:
    """The next port of this worker's block that is free at this moment."""
    base = port_block()
    for _ in range(PORTS_PER_WORKER):
        port = base + next(_next_port) % PORTS_PER_WORKER
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {base}..{base + PORTS_PER_WORKER - 1}")


class Ranks:
    """`world` processes running target ("module:function") as gloo ranks,
    started at construction; results() waits for them."""

    def __init__(self, world: int, target: str, kwargs: dict, threads: int = 2,
                 n_model: int = 1):
        port = free_port()
        token = secrets.randbits(62)   # this group's: see _main
        env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
        env["PYTHONPATH"] = os.pathsep.join([REPO, TESTS, env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = str(threads)
        self._tmp = tempfile.TemporaryDirectory()
        self._outs = [os.path.join(self._tmp.name, f"rank{r}.pt") for r in range(world)]
        self._procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), target, str(r), str(world),
             str(port), str(threads), str(n_model), self._outs[r], json.dumps(kwargs),
             str(token)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]

    def results(self, timeout: float = 300.0) -> list:
        """Each rank's result, in rank order; raises with a failed rank's
        stderr. Every process has ended when it returns."""
        try:
            logs = [p.communicate(timeout=timeout) for p in self._procs]
            for r, (p, (_, err)) in enumerate(zip(self._procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} exited {p.returncode}:\n{err[-6000:]}")
            return [torch.load(o, weights_only=False) for o in self._outs]
        finally:
            for p in self._procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self._tmp.cleanup()


def run_ranks(world: int, target: str, kwargs: dict, timeout: float = 300.0,
              threads: int = 2, n_model: int = 1) -> list:
    """Run target on `world` gloo ranks; returns each rank's result."""
    return Ranks(world, target, kwargs, threads, n_model).results(timeout)


def _same_group(token: int, port: str) -> None:
    """All-gather the launcher's token: every rank must hold this group's,
    or ranks of two groups met at one port (a foreign rank's gradients
    would be summed in silently), and the run fails here instead."""
    mine = torch.tensor([token], dtype=torch.int64)
    tokens = [torch.zeros_like(mine) for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(tokens, mine)
    if any(int(t) != token for t in tokens):
        raise RuntimeError(f"ranks of another group joined this one at port {port}: "
                           f"tokens {[int(t) for t in tokens]}")


def _main(argv) -> int:
    target, rank, world, port, threads, n_model, out, kwargs, token = argv
    torch.set_num_threads(int(threads))
    from vision_kit_tpu_torch.parallel import init_distributed, make_mesh

    assert init_distributed(f"127.0.0.1:{port}", int(world), int(rank), backend="gloo")
    try:
        _same_group(int(token), port)
        mesh = make_mesh(n_model=int(n_model), device="cpu")
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        torch.save(fn(mesh, **json.loads(kwargs)), out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


# -- worker functions: fn(mesh, **kwargs) -> a picklable result -------------

def bn_inputs(seed: int = 0, n: int = 4, c: int = 6, hw: int = 5):
    """A global batch for a BatchNorm2d, its weight and bias, and the
    gradient of its output (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(0.5, 2.0, (n, c, hw, hw)).astype(np.float32),
            "weight": rng.normal(1.0, 0.2, c).astype(np.float32),
            "bias": rng.normal(0.0, 0.5, c).astype(np.float32),
            "gy": rng.normal(0.0, 1.0, (n, c, hw, hw)).astype(np.float32)}


def bn_step(bn, x, gy, mesh=None):
    """Two training forwards of `bn` on x (the running statistics updated
    twice), the backward of sum(y * gy) after the second; returns y, x's
    gradient, the weight and bias gradients and the running statistics.
    Under a mesh the weight and bias gradients are summed over the ranks,
    as the training step sums a parameter's gradient."""
    from vision_kit_tpu_torch.parallel import mesh as pmesh

    bn.train()
    bn.mesh = mesh
    try:
        bn(x.detach())
        x = x.detach().requires_grad_(True)
        y = bn(x)
        (y * gy).sum().backward()
    finally:
        bn.mesh = None
    grads = [bn.weight.grad, bn.bias.grad]
    if mesh is not None:
        pmesh.all_reduce_(mesh, grads)
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": grads[0],
            "bias_grad": grads[1], "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def bn_module(inputs, dtype=torch.float32):
    from vision_kit_tpu_torch.models.layers import batch_norm

    bn = batch_norm(inputs["x"].shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["weight"]))
        bn.bias.copy_(torch.from_numpy(inputs["bias"]))
    return bn.to(dtype)


def bn_worker(mesh, seed: int = 0, dtype: str = "float32"):
    """The synced BatchNorm2d on this rank's rows (bn_step), in `dtype`."""
    from vision_kit_tpu_torch.parallel.mesh import shard_rows

    dt = getattr(torch, dtype)
    inputs = bn_inputs(seed)
    rows = shard_rows(mesh, len(inputs["x"])).numpy()
    return bn_step(bn_module(inputs, dt), torch.from_numpy(inputs["x"][rows]).to(dt),
                   torch.from_numpy(inputs["gy"][rows]).to(dt), mesh)


def port_v5n(state_path: str):
    """The v5n (80 classes) of a saved state_dict, in training mode."""
    from vision_kit_tpu_torch.models import YOLOV5

    model = YOLOV5(variant="n", num_classes=80)
    model.load_state_dict(torch.load(state_path, weights_only=True), strict=True)
    return model.train()


def state_digest(tensors: dict) -> str:
    """A digest of a train_state_tensors layout, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for part in sorted(tensors):
        for k in sorted(tensors[part]):
            h.update(k.encode())
            h.update(tensors[part][k].numpy().tobytes())
    return h.hexdigest()


def train_run(model, batches: list, hyp: dict, epochs: int, steps_per_epoch: int,
              loss: str = "yolo", mesh=None, **step_kw):
    """make_train_step over `batches` (this rank's rows under a mesh) from a
    fresh state of `model`; returns each step's metrics, the state before
    the last step and after it (train_state_tensors)."""
    from vision_kit_tpu_torch.train import optim
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.train.ota import YoloLossOTA
    from vision_kit_tpu_torch.train.step import create_train_state, make_train_step
    from vision_kit_tpu_torch.utils.stream_bench import train_state_tensors

    tx = optim.make_optimizer(model, hyp, epochs, steps_per_epoch)
    state = create_train_state(model, tx, mesh=mesh)
    loss_cls = {"yolo": YoloLoss, "ota": YoloLossOTA}[loss]
    # explicit layout: a multi-scale grid may be exactly na cells wide
    step = make_train_step(model, loss_cls(80, model.head.grid_anchors, hyp,
                                           layout="native"), tx, mesh=mesh, **step_kw)
    metrics = []
    for batch in batches:
        before = train_state_tensors(state)
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "before_last": before,
            "last": train_state_tensors(state)}


def train_worker(mesh, state_path: str, batches_path: str, hyp: dict, epochs: int,
                 steps_per_epoch: int, loss: str = "yolo", step_kw: dict | None = None,
                 one_process: bool = False, value_rel: float = 1e-4,
                 step_rel: float = 2e-3):
    """train_run on this rank's rows (shard_batch) of saved global batches.
    Every rank returns its metrics and the digest of its final state; rank
    0 also the state before its last step and after it, and with
    one_process the same run without a mesh (nor spatial) on the global batches: its
    metrics and the mesh run's disagreements with it
    (stream_bench.state_disagreements at value_rel, step_rel)."""
    from vision_kit_tpu_torch.parallel.mesh import shard_batch
    from vision_kit_tpu_torch.utils.stream_bench import state_disagreements

    step_kw = dict(step_kw or {})
    batches = torch.load(batches_path, weights_only=False)
    local = [shard_batch(mesh, b, step_kw.get("accum_steps", 1)) for b in batches]
    run = train_run(port_v5n(state_path), local, hyp, epochs, steps_per_epoch, loss,
                    mesh, **step_kw)
    out = {"metrics": run["metrics"], "digest": state_digest(run["last"])}
    if mesh.is_main:
        out.update(before_last=run["before_last"], last=run["last"])
        if one_process:
            one_kw = {k: v for k, v in step_kw.items() if k != "spatial"}
            ref = train_run(port_v5n(state_path), batches, hyp, epochs, steps_per_epoch,
                            loss, **one_kw)
            out["one_process_metrics"] = ref["metrics"]
            out["one_process_disagreements"] = state_disagreements(
                ref["last"], run["last"], ref["before_last"], value_rel, step_rel)
    return out


def cases_worker(mesh, cases: dict):
    """Each case {"target": "module:function", "kwargs": {...}} in turn on
    this rank; returns {name: result, or {"error": traceback}}. A case that
    fails on one rank fails on all (their collectives pair up), so a
    failure leaves the group usable only when it raised before any."""
    import traceback

    out = {}
    for name, case in cases.items():
        module, fn = case["target"].split(":")
        try:
            out[name] = getattr(importlib.import_module(module), fn)(mesh, **case["kwargs"])
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def validate_worker(mesh, state_path: str, data_dir: str, batch: int, size: int = 64,
                    num_classes: int = 80):
    """trainer.validate of the saved model on a YOLO split through
    ValLoader(shard=rank) and make_eval_step(mesh=mesh); returns the result
    and this rank's batch counts."""
    from vision_kit_tpu_torch.data.datasets import YOLODataset
    from vision_kit_tpu_torch.data.loader import ValLoader
    from vision_kit_tpu_torch.train import trainer
    from vision_kit_tpu_torch.train.evaluator import DetEvaluator
    from vision_kit_tpu_torch.train.step import make_eval_step

    model = port_v5n(state_path).eval()
    ds = YOLODataset(data_dir, img_size=size, device="cpu")
    loader = ValLoader(ds, batch, img_size=size, shard=mesh.rank, num_shards=mesh.n_data)
    counts = [b["count"] for b in loader]
    ev = DetEvaluator([str(i) for i in range(num_classes)], (size, size))
    result = trainer.validate(make_eval_step(model, {"max_cand": 512}, mesh=mesh),
                              loader, ev, mesh=mesh)
    return {"result": result, "counts": counts}


class CrashingLoader:
    """A TrainLoader whose iterator raises after `after` batches."""

    def __init__(self, loader, after: int):
        self.loader, self.after = loader, after

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.after:
                raise RuntimeError("crash injected")
            yield batch


def fit_worker(mesh, cfg: dict, crash_after: int, seed: int = 5):
    """Trainer(mesh=mesh).fit on cfg (its output_dir a directory every rank
    shares): an uninterrupted run under <out>/run, then a run under
    <out>/crash whose loader raises on every rank after crash_after
    batches, resumed from its ckpts/last by a new Trainer. Returns the two
    final states' digests and steps, whether ckpts/last was an orbax
    directory as fit returned, and the files this rank wrote (the calls of
    torch.save, orbax.write_checkpoint, flax_msgpack.write_file,
    numpy.savez_compressed and grid_save) in each."""
    import copy
    from unittest import mock

    from vision_kit_tpu_torch.train.trainer import Trainer
    from vision_kit_tpu_torch.utils import drawing, flax_msgpack, orbax
    from vision_kit_tpu_torch.utils.config import ConfigNode
    from vision_kit_tpu_torch.utils.stream_bench import train_state_tensors

    writes = []

    def record(fn, what, path_arg):
        def call(*a, **kw):
            writes.append((what, str(a[path_arg])))
            return fn(*a, **kw)
        return call

    def trainer(out):
        d = copy.deepcopy(cfg)
        d["data"]["output_dir"] = out
        return Trainer(ConfigNode.wrap(d), use_tensorboard=False, seed=seed, device="cpu",
                       mesh=mesh)

    root = cfg["data"]["output_dir"]
    out = {}
    def last_is_orbax(tr):
        return orbax.is_checkpoint(os.path.join(tr.output_dir, "ckpts", "last"))

    with mock.patch.object(torch, "save", record(torch.save, "torch.save", 1)), \
            mock.patch.object(orbax, "write_checkpoint",
                              record(orbax.write_checkpoint, "write_checkpoint", 0)), \
            mock.patch.object(flax_msgpack, "write_file",
                              record(flax_msgpack.write_file, "write_file", 0)), \
            mock.patch.object(np, "savez_compressed",
                              record(np.savez_compressed, "savez_compressed", 0)), \
            mock.patch.object(drawing, "grid_save",
                              record(drawing.grid_save, "grid_save", 2)):
        ref = trainer(os.path.join(root, "run"))
        ref.fit()
        out["run"] = {"digest": state_digest(train_state_tensors(ref.state)),
                      "step": ref.global_step, "writes": list(writes),
                      "best_map50": ref.best_map50, "last_is_orbax": last_is_orbax(ref)}
        writes.clear()
        crashed = trainer(os.path.join(root, "crash"))
        crashed.train_loader = CrashingLoader(crashed.train_loader, crash_after)
        try:
            crashed.fit()
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        crashed.train_loader.close()
        resumed = trainer(os.path.join(root, "crash"))
        resumed.fit(resume=os.path.join(root, "crash", "ckpts", "last"))
        out["resumed"] = {"digest": state_digest(train_state_tensors(resumed.state)),
                          "step": resumed.global_step, "writes": list(writes),
                          "last_is_orbax": last_is_orbax(resumed)}
    return out


def serving_frames(seed: int, n: int, hw=(96, 128)) -> np.ndarray:
    """n seeded (h, w, 3) uint8 frames."""
    return np.random.default_rng(seed).integers(0, 255, (n, *hw, 3), dtype=np.uint8)


def predictor_worker(mesh, state_path: str, size: int, batches: dict, kw: dict,
                     device: str = "cpu"):
    """Predictor(mesh=mesh) of the saved v5n (eval mode) on each named batch
    {name: (seed, n)} of serving_frames, through predict_batch and run, and
    on one frame through __call__; and, as one process would, the same
    Predictor without a mesh on this rank's rows alone. Returns, by batch,
    the detections of each route and the rows this rank ran. device
    "cuda": every rank on the one card (gloo carries CUDA tensors)."""
    import dataclasses

    from vision_kit_tpu_torch.parallel.mesh import shard_rows
    from vision_kit_tpu_torch.predictor import Predictor

    if device != "cpu":
        mesh = dataclasses.replace(mesh, device=torch.device(device, 0))
    model = port_v5n(state_path).eval()
    pred = Predictor(model, img_size=size, mesh=mesh, **kw)
    alone = Predictor(model, img_size=size, device=mesh.device, **kw)
    out = {}
    for name, (seed, n) in batches.items():
        imgs = serving_frames(seed, n)
        dets, _ = pred.predict_batch(imgs)
        d, v = pred.run(torch.from_numpy(imgs).to(mesh.device))
        rec = {"predict_batch": dets,
               "run": [d[i][v[i]].cpu().numpy() for i in range(n)]}
        if n % mesh.n_data == 0 and n > 1:
            rows = shard_rows(mesh, n).numpy()
            rec["rows"] = rows.tolist()
            rec["alone"] = alone.predict_batch(imgs[rows])[0]
        out[name] = rec
    out["single"] = pred(serving_frames(99, 1)[0])[0]
    return out


def spatial_predictor_worker(mesh, state_path: str, size: int, hw: list, n: int, kw: dict,
                             device: str = "cpu"):
    """Predictor(mesh=mesh, spatial=True) of the saved v5n (eval mode) at
    img_size `size` on one seeded frame of `hw` (serving_frames(7, 1)),
    through __call__, and on n such frames (serving_frames(8, n)) through
    predict_batch and run. Returns each route's detections, and the
    kernels' launches in the __call__ (on the card they launch; on the
    CPU the plain versions run and nothing counts). device "cuda": every
    rank on the one card."""
    import dataclasses

    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
    from vision_kit_tpu_torch.ops.head_scores import head_scores
    from vision_kit_tpu_torch.predictor import Predictor

    if device != "cpu":
        mesh = dataclasses.replace(mesh, device=torch.device(device, 0))
    pred = Predictor(port_v5n(state_path).eval(), img_size=size, mesh=mesh, spatial=True,
                     **kw)
    imgs = serving_frames(8, n, tuple(hw))
    d, v = pred.run(torch.from_numpy(imgs).to(mesh.device))
    frame = serving_frames(7, 1, tuple(hw))[0]
    pred(frame)
    greedy_keep.launches = head_scores.launches = 0
    single = pred(frame)[0]
    return {"single": single, "batch": pred.predict_batch(imgs)[0],
            "run": [d[i][v[i]].cpu().numpy() for i in range(n)],
            "launches": [greedy_keep.launches, head_scores.launches]}


def spatial_eval_worker(mesh, state_path: str, size: int, n: int, post: dict):
    """make_eval_step(mesh=mesh, spatial=True) of the saved v5n on this data
    shard's rows of n seeded size x size frames (serving_frames(9, n)),
    and make_eval_step without a mesh on all n. Returns both (dets, valid)."""
    from vision_kit_tpu_torch.parallel.mesh import shard_rows
    from vision_kit_tpu_torch.train.step import make_eval_step

    model = port_v5n(state_path).eval()
    imgs = serving_frames(9, n, (size, size))
    rows = shard_rows(mesh, n).numpy()
    got = make_eval_step(model, post, mesh=mesh, spatial=True)(imgs[rows])
    want = make_eval_step(model, post)(imgs)
    return {"got": [t.numpy() for t in got], "want": [t.numpy() for t in want]}


def focus_v5n(seed: int = 0):
    """A seeded v5n whose backbone has the Focus stem and the SPP (5, 9,
    13) tail (CSPDarknet(with_focus=True)), in f32 and eval mode."""
    from vision_kit_tpu_torch.models import YOLOV5
    from vision_kit_tpu_torch.models.architectures import init_weights
    from vision_kit_tpu_torch.models.backbones import CSPDarknet

    model = YOLOV5(variant="n", num_classes=80)
    model.backbone = CSPDarknet(0.33, 0.25, with_focus=True)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(memory_format=torch.channels_last).eval()


def spatial_forward_worker(mesh, size: int, batch: int = 2, seed: int = 0):
    """focus_v5n's raw maps at `size` banded over the model axis against the
    same forward unbanded (eval mode), and the gradient of a seeded
    linear function of the training-mode maps with respect to every
    parameter, summed over the model axis as the step sums it, against the
    unbanded one. Returns the largest differences over each tensor's
    largest magnitude."""
    from vision_kit_tpu_torch.parallel.mesh import MODEL_AXIS, all_reduce_
    from vision_kit_tpu_torch.parallel.spatial import banded
    from vision_kit_tpu_torch.train.step import _synced

    model = focus_v5n(seed)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x, decode=False)
        with banded(mesh, size) as bands:
            got = model(bands.rows(x), decode=False)
    out = {"eval_max_rel": max(float((g - w).abs().max() / w.abs().max())
                               for g, w in zip(got, want)),
           "shapes": [tuple(g.shape) for g in got]}

    weights = [torch.from_numpy(rng.normal(0, 1, tuple(w.shape)).astype(np.float32))
               for w in want]
    model.train()

    def grads(banded_run):
        for p in model.parameters():
            p.grad = None
        with _synced(model, mesh, None):
            if banded_run:
                with banded(mesh, size) as bands:
                    raws = model(bands.rows(x), decode=False)
                    sum((r * w).sum() for r, w in zip(raws, weights)).backward()
            else:
                raws = model(x, decode=False)
                sum((r * w).sum() for r, w in zip(raws, weights)).backward()
        g = [p.grad.clone() for p in model.parameters()]
        return g

    state = {k: v.clone() for k, v in model.state_dict().items()}
    mine = grads(True)
    all_reduce_(mesh, mine, MODEL_AXIS)
    model.load_state_dict(state)
    # the whole images on every rank: the synced statistics count each
    # image n_model times, which leaves them as one image's
    whole = grads(False)
    out["grad_max_rel"] = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                              for g, w in zip(mine, whole))
    return out


def halo_worker(mesh, height: int, top: int, bottom: int, edge: int):
    """Bands.halo at the stride-32 map of a `height`-row input (height a
    multiple of 32): a seeded (1, 2, height / 32, 3) map's band with its
    halo, against the rows of the whole map padded with zeros (`top` rows
    above, max(edge, bottom) below) that it must hold; and the gradient of
    sum(halo * g) with respect to the whole map, summed over the model
    axis. Returns the difference, the gradient, this rank's g and band."""
    from vision_kit_tpu_torch.parallel.mesh import MODEL_AXIS, all_reduce_
    from vision_kit_tpu_torch.parallel.spatial import TOTAL_STRIDE, Bands

    rng = np.random.default_rng(height)
    whole = torch.from_numpy(rng.normal(0, 1, (1, 2, height // TOTAL_STRIDE, 3))
                             .astype(np.float32))
    bands = Bands(mesh, height)
    start, stop = (r // TOTAL_STRIDE for r in bands.spans[bands.index])
    x = whole[:, :, start:stop].clone().requires_grad_(True)
    got = bands.halo(x, top, bottom, 0.0, edge)
    padded = torch.nn.functional.pad(whole, (0, 0, top, max(edge, bottom)))
    below = edge if bands.index == mesh.n_model - 1 else bottom
    want = padded[:, :, start:stop + top + below]
    g = torch.from_numpy(rng.normal(0, 1, tuple(got.shape)).astype(np.float32))
    (got * g).sum().backward()
    grad = torch.zeros_like(whole)
    grad[:, :, start:stop] = x.grad
    all_reduce_(mesh, [grad], MODEL_AXIS)
    return {"max_diff": float((got.detach() - want).abs().max())
            if got.shape == want.shape else float("inf"),
            "grad": grad, "g": g, "start": start}


def post_image(url: str, data: bytes, timeout: float = 120.0):
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def server_worker(mesh, state_path: str, size: int, batch_size: int, images: list,
                  kw: dict):
    """InferenceServer over Predictor(mesh=mesh) of the saved v5n: every rank
    calls start(); rank 0 posts each image file to its own /predict, one
    at a time and then all at once from a thread each, and stops the server,
    which ends the other ranks' follow loops. Returns rank 0's answers
    ({"sequential": [...], "concurrent": [...], "healthz", "stats"}) and
    each rank's port (None but on rank 0)."""
    import threading
    import urllib.request

    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.serve import InferenceServer

    pred = Predictor(port_v5n(state_path).eval(), img_size=size, mesh=mesh, device="cpu",
                     **kw)
    srv = InferenceServer(pred, batch_size=batch_size, max_wait_ms=200.0, port=0)
    out = {"port": srv.port}
    if not mesh.is_main:
        srv.serve_forever()   # returns once rank 0 stops
        return out
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        bodies = []
        for path in images:
            with open(path, "rb") as f:
                bodies.append(f.read())
        out["sequential"] = [post_image(url + "/predict", b) for b in bodies]
        out["concurrent"] = [None] * len(bodies)

        def client(i):
            out["concurrent"][i] = post_image(url + "/predict", bodies[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            out["healthz"] = json.loads(resp.read())
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            out["stats"] = json.loads(resp.read())
    finally:
        srv.stop()
    return out


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
