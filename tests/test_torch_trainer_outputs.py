"""The port's Trainer writes the JAX Trainer's run directory, on the CPU
(v5n@64 f32 on the rectangle set; tests/test_torch_trainer.py's jax_run,
one 3-step epoch of batch 4):

- a port fit that crashes after step 2 leaves ckpts/last, an orbax
  directory with the JAX meta; a JAX Trainer resumes it (step, best mAP,
  patience and pending validation read as JAX reads them) and ends the
  epoch within test_torch_trainer.py's tolerances of JAX's uninterrupted
  epoch;
- the port's ckpts/best, restored by the JAX Trainer's load_checkpoint, is
  the port's state bit for bit, and the JAX Trainer's own best-weights
  export of it is the port's best-map50_*.msgpack byte for byte; the JAX
  predictor serves that file with the port's detections; the export CLI
  takes the port's ckpts/best and .msgpack;
- the sample grids: grid_save writes the JAX grid_save's bytes and canvas
  (cv2.imwrite's JPEG), draw_rectangle is cv2.rectangle pixel for pixel;
- train/checkpoint.py:AsyncCheckpointer: one outstanding save, the
  snapshot taken before save() returns, an error raised at the next wait,
  blocking=True, a failed write failing fit after its crash-save, and the
  port's earlier `.pt` checkpoints and fp16 best weights still read.
"""

import copy
import glob
import json
import os
import threading

import cv2
import numpy as np
import pytest
import torch

import jax

from test_torch_trainer import (  # noqa: F401  (jax_run is a fixture)
    crash_after,
    jax_run,
    port_trainer,
    with_out,
)
from vision_kit_tpu.parallel.mesh import make_mesh
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu.predictor import load_weights as jax_load_weights
from vision_kit_tpu.train.trainer import Trainer as JaxTrainer
from vision_kit_tpu.utils.config import ConfigNode as JaxConfigNode
from vision_kit_tpu.utils.drawing import grid_save as jax_grid_save
from vision_kit_tpu_torch.convert import load_jax_train_state, train_state_tensors_from_jax
from vision_kit_tpu_torch.predictor import load_predictor_from_config, load_weights
from vision_kit_tpu_torch.train import checkpoint
from vision_kit_tpu_torch.train.checkpoint import AsyncCheckpointer, load_checkpoint
from vision_kit_tpu_torch.utils import orbax
from vision_kit_tpu_torch.utils.drawing import class_color, draw_rectangle, grid_save
from vision_kit_tpu_torch.utils.stream_bench import (
    STATE_PARTS,
    same_detections,
    state_disagreements,
    train_state_tensors,
)

torch.set_num_threads(2)

WAIT_S = 60   # the longest any test waits on a thread


def from_state0(d, jax_run):
    tr = port_trainer(d)
    tr.use_state(load_jax_train_state(tr.model, tr.tx, jax_run["state0"]))
    return tr


@pytest.fixture(scope="module")
def port_crash(jax_run, tmp_path_factory):
    """A port fit from JAX's initial state that crashes after step 2."""
    out = tmp_path_factory.mktemp("port_crash")
    tr = from_state0(with_out(jax_run["cfg"], out), jax_run)
    crash_after(tr, 2)
    with pytest.raises(RuntimeError, match="boom"):
        tr.fit()
    return os.path.join(str(out), "ckpts", "last")


@pytest.fixture(scope="module")
def port_best(jax_run, tmp_path_factory):
    """A port fit from JAX's initial state that validates after its epoch:
    ckpts/best and the best weights."""
    out = tmp_path_factory.mktemp("port_best")
    tr = from_state0(with_out(jax_run["cfg"], out, val_interval=1), jax_run)
    tr.fit()
    (weights,) = glob.glob(os.path.join(str(out), "weights", "best-map50_*.msgpack"))
    return tr, os.path.join(str(out), "ckpts", "best"), weights


@pytest.fixture(scope="module")
def jax_side(jax_run, tmp_path_factory):
    """One JAX Trainer on jax_run's config, writing under its own directory."""
    d = with_out(jax_run["cfg"], tmp_path_factory.mktemp("jax_side"))
    tr = JaxTrainer(JaxConfigNode.wrap(copy.deepcopy(d)), mesh=make_mesh(n_data=1, n_model=1),
                    use_tensorboard=False, seed=5)
    yield tr
    tr.train_loader.close()


def test_jax_trainer_resumes_a_port_crash(jax_run, port_crash, jax_side):
    assert orbax.is_checkpoint(port_crash) and not glob.glob(port_crash + "*.pt")
    with open(port_crash + ".meta.json") as f:
        assert json.load(f) == {"epoch": -1, "step": 2, "best_map50": -1.0,
                                "epochs_no_improve": 0, "val_pending": False}
    jtr = jax_side
    read, orig_load = [], jtr.load_checkpoint

    def recording_load(path):
        step = orig_load(path)
        read.append((step, jtr.global_step, jtr.best_map50, jtr.epochs_no_improve,
                     jtr._val_pending))
        return step

    jtr.load_checkpoint = recording_load
    try:
        jtr.fit(resume=port_crash)
    finally:
        del jtr.load_checkpoint
    assert read == [(2, 2, -1.0, 0, False)]
    state = jax.device_get(jtr.state)
    assert jtr.global_step == int(state.step) == 3 and int(state.ema.updates) == 3
    want = train_state_tensors_from_jax(jax_run["state1"])
    before = train_state_tensors_from_jax(jax_run["state0"])
    assert state_disagreements({p: want[p] for p in STATE_PARTS},
                               train_state_tensors_from_jax(state),
                               {p: before[p] for p in STATE_PARTS}) == []


def test_jax_trainer_loads_the_port_best(port_best, jax_side):
    tr, best, weights = port_best
    assert orbax.is_checkpoint(best)
    assert os.path.basename(weights) == f"best-map50_{tr.best_map50:.4f}.msgpack"
    jtr = jax_side
    assert jtr.load_checkpoint(best) == 3
    assert (jtr.global_step, jtr.best_map50, jtr.epochs_no_improve, jtr._val_pending) == (
        3, tr.best_map50, 0, False)
    state = jax.device_get(jtr.state)
    assert (int(state.step), int(state.ema.updates)) == (tr.state.step, tr.state.ema.updates)
    got, want = train_state_tensors_from_jax(state), train_state_tensors(tr.state)
    for part in STATE_PARTS:
        assert got[part].keys() == want[part].keys(), part
        for k, t in want[part].items():
            assert torch.equal(got[part][k], t), (part, k)
    # the JAX Trainer's own export of the state it restored
    jtr._export_best_weights(tr.best_map50)
    with open(os.path.join(jtr.output_dir, "weights", os.path.basename(weights)), "rb") as f, \
            open(weights, "rb") as g:
        assert f.read() == g.read()


def test_jax_predictor_serves_the_port_best_weights(port_best, jax_side):
    tr, _, weights = port_best
    template = jax.device_get(jax_side.state.ema.tree)
    jv = jax_load_weights(weights, template)
    frames = np.random.default_rng(7).integers(0, 255, (3, 80, 96, 3), dtype=np.uint8)
    want, _ = JaxPredictor(jax_side.model, jv, img_size=64, conf_thres=0.001,
                           approx_topk=False).predict_batch(frames)
    pred = load_predictor_from_config(tr.cfg, weights=weights, device="cpu",
                                      conf_thres=0.001)
    got, _ = pred.predict_batch(frames)
    ema = {k: v.float() for k, v in tr.state.ema.tree.items()}
    for k, v in pred.model.state_dict().items():
        if k in ema:
            assert torch.equal(v, ema[k]), k
    assert sum(len(w) for w in want) > 10
    for w, g in zip(want, got):
        assert same_detections(np.asarray(w), g), (w, g)


@pytest.mark.parametrize("what", ["ckpts/best", "msgpack"])
def test_export_cli_takes_the_port_run(port_best, what, tmp_path, monkeypatch):
    """`python -m vision_kit_tpu_torch export --ckpt` of the port's
    ckpts/best and of its best .msgpack: the model handed to run_export
    holds the f32 EMA (the export itself is test_torch_export's)."""
    from vision_kit_tpu_torch import __main__ as cli
    from vision_kit_tpu_torch import export
    from vision_kit_tpu_torch.utils.config import save_config

    tr, best, weights = port_best
    cfg_path = str(tmp_path / "cfg.yaml")
    save_config(tr.cfg, cfg_path)
    seen = {}

    def fake_export(cfg, model, save_dir, **kw):
        seen["sd"] = model.state_dict()
        return export.ExportResult()

    monkeypatch.setattr(export, "run_export", fake_export)
    assert cli.main(["export", "-c", cfg_path, "--ckpt", best if what == "ckpts/best"
                     else weights, "--output-dir", str(tmp_path), "--device", "cpu"]) == 0
    for k, t in tr.state.ema.tree.items():
        assert torch.equal(seen["sd"][k], t), k


# -- the sample grids --------------------------------------------------------


def batch(rng, kind, b, h=48, w=40):
    if kind == "uint8":
        images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    else:
        images = rng.uniform(-0.2, 1.2, (b, h, w, 3)).astype(kind)
    targets = np.full((b, 6, 5), -1.0, np.float32)
    for i in range(b):
        k = int(rng.integers(0, 7))
        targets[i, :k, 0] = rng.integers(0, 30, k)
        targets[i, :k, 1:3] = rng.uniform(-0.2, 1.2, (k, 2))    # centres over the edges
        targets[i, :k, 3:] = rng.uniform(0.0, 1.5, (k, 2))
    return images, targets


@pytest.mark.parametrize("kind", ["uint8", "float32", "float64"])
def test_grid_save_equals_jax(kind, tmp_path):
    """For 1 to 20 images (a grid of up to 16), boxes crossing and leaving
    the frame: the canvas and the .jpg's bytes equal the JAX grid_save's;
    the caller's images are not drawn on; a .png holds the same canvas."""
    rng = np.random.default_rng(["uint8", "float32", "float64"].index(kind))
    for b in (1, 3, 5, 16, 20):
        images, targets = batch(rng, kind, b)
        kept = images.copy()
        want = jax_grid_save(images, targets, str(tmp_path / "jax.jpg"))
        got = grid_save(torch.from_numpy(images) if kind == "float32" else images, targets,
                        str(tmp_path / "port.jpg"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(images, kept)
        assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()
    png = grid_save(images, targets, str(tmp_path / "port.png"))
    drawn = cv2.imread(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(drawn[..., ::-1], png)
    with pytest.raises(ValueError, match=".jpg or .png"):
        grid_save(images, targets, str(tmp_path / "grid.bmp"))


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_draw_rectangle_equals_cv2(thickness):
    """400 seeded boxes on seeded images: inside, crossing and outside the
    frame, of zero width or height, corners in either order."""
    rng = np.random.default_rng(100 + thickness)
    for i in range(400):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        x1, y1, x2, y2 = (int(v) for v in rng.integers(-40, 110, 4))
        if i % 5 == 0:
            x2 = x1
        if i % 7 == 0:
            y2 = y1
        want = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = want.copy()
        color = class_color(i)
        cv2.rectangle(want, (x1, y1), (x2, y2), color, thickness)
        draw_rectangle(got, (x1, y1), (x2, y2), color, thickness)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, x1, y1, x2, y2)))
    with pytest.raises(ValueError, match="thickness"):
        draw_rectangle(want, (1, 1), (5, 5), color, 0)


# -- the background writer ---------------------------------------------------


@pytest.fixture
def small_state(jax_run, tmp_path):
    """A port Trainer's state (v5n, JAX's initial state) and the Trainer."""
    tr = from_state0(with_out(jax_run["cfg"], tmp_path / "run"), jax_run)
    yield tr, tr.state
    tr.train_loader.close()


def snapshot_of(state):
    return {p: {k: t.clone() for k, t in part.items()}
            for p, part in train_state_tensors(state).items()}


def restored(tr, path):
    """(tensors, meta, state) of load_checkpoint(path) into a fresh
    Trainer's state of tr's config (another initialisation than tr's)."""
    fresh = port_trainer(with_out(tr.cfg.to_dict(), os.path.join(tr.output_dir, "fresh")))
    try:
        state, meta = load_checkpoint(path, fresh.state)
        return snapshot_of(state), meta, state
    finally:
        fresh.train_loader.close()


def assert_same(a, b):
    for p in a:
        for k, t in a[p].items():
            assert torch.equal(t, b[p][k]), (p, k)


def test_one_outstanding_save_and_the_snapshot(small_state, tmp_path, monkeypatch):
    """The second save waits for the first; each holds the state as it was
    when save() returned, though the state is changed in place meanwhile."""
    tr, state = small_state
    log, release = [], threading.Event()
    write = checkpoint._write

    def slow_write(path, snap, meta):
        log.append(("start", os.path.basename(path)))
        assert release.wait(WAIT_S)
        write(path, snap, meta)
        log.append(("end", os.path.basename(path)))

    monkeypatch.setattr(checkpoint, "_write", slow_write)
    ckptr = AsyncCheckpointer()
    first = snapshot_of(state)
    ckptr.save(str(tmp_path / "a"), state, epoch=0)
    with torch.no_grad():
        for t in state.params.values():
            t.add_(1.0)            # as the next train step does, in place
    second = snapshot_of(state)
    timer = threading.Timer(0.3, release.set)
    timer.start()
    ckptr.save(str(tmp_path / "b"), state, epoch=1)
    assert log[:2] == [("start", "a"), ("end", "a")]    # a finished before b began
    ckptr.wait_until_finished()
    timer.join(WAIT_S)
    assert not timer.is_alive()
    assert log == [("start", "a"), ("end", "a"), ("start", "b"), ("end", "b")]
    assert [os.path.basename(r["path"]) for r in ckptr.records] == ["a", "b"]
    assert all(r["blocked_s"] >= 0 and r["write_s"] > 0 for r in ckptr.records)
    for name, want, epoch in (("a", first, 0), ("b", second, 1)):
        assert orbax.is_checkpoint(str(tmp_path / name))
        got, meta, _ = restored(tr, str(tmp_path / name))
        assert_same(want, got)
        assert meta["epoch"] == epoch


def test_write_error_raised_at_the_next_wait(small_state, tmp_path, monkeypatch):
    tr, state = small_state

    def failing(path, tree):
        raise OSError("no space left on the disk")

    monkeypatch.setattr(orbax, "write_checkpoint", failing)
    ckptr = AsyncCheckpointer()
    ckptr.save(str(tmp_path / "a"), state)          # returns: the write is behind it
    with pytest.raises(OSError, match="no space"):
        ckptr.wait_until_finished()
    ckptr.wait_until_finished()                     # raised once
    assert not os.path.exists(str(tmp_path / "a.meta.json"))
    assert ckptr.records[0]["write_s"] is None
    ckptr.save(str(tmp_path / "b"), state)
    with pytest.raises(OSError, match="no space"):  # the next save's own wait
        ckptr.save(str(tmp_path / "c"), state)
    monkeypatch.undo()
    ckptr.save(str(tmp_path / "d"), state, blocking=True)
    assert ckptr._thread is None and orbax.is_checkpoint(str(tmp_path / "d"))
    assert os.path.exists(str(tmp_path / "d.meta.json"))


def test_failed_background_write_fails_fit(jax_run, tmp_path, monkeypatch):
    """The epoch's ckpts/last fails on the writer thread: fit raises its
    error at the wait before it returns, after the crash-save (blocking)
    wrote ckpts/last."""
    calls = []
    write = orbax.write_checkpoint

    def first_fails(path, tree):
        calls.append(os.path.basename(path))
        if len(calls) == 1:
            raise OSError("injected write failure")
        write(path, tree)

    monkeypatch.setattr(orbax, "write_checkpoint", first_fails)
    tr = from_state0(with_out(jax_run["cfg"], tmp_path), jax_run)
    with pytest.raises(OSError, match="injected"):
        tr.fit()
    assert calls == ["last", "last"]
    last = str(tmp_path / "ckpts" / "last")
    assert orbax.is_checkpoint(last)
    with open(last + ".meta.json") as f:
        assert json.load(f)["step"] == 3
    got, _, _ = restored(tr, last)
    assert_same(snapshot_of(tr.state), got)


def test_pt_checkpoints_and_weights_still_load(small_state, tmp_path):
    """A `.pt` path keeps the port's torch.save file, through
    save_checkpoint and the background writer, and both read back bit for
    bit; a Trainer resumes such a file at its step, also under an earlier
    run's name ckpts/last; the earlier fp16 {"model": state_dict} best
    weights still load."""
    tr, state = small_state
    state = state._replace(step=7)
    want = snapshot_of(state)
    checkpoint.save_checkpoint(str(tmp_path / "sync.pt"), state, epoch=0)
    ckptr = AsyncCheckpointer()
    ckptr.save(str(tmp_path / "async.pt"), state, epoch=0, best_map50=0.5)
    ckptr.wait_until_finished()
    for name in ("sync.pt", "async.pt"):
        assert checkpoint.is_train_state(torch.load(str(tmp_path / name), weights_only=True))
        got, meta, _ = restored(tr, str(tmp_path / name))
        assert_same(want, got)
        assert meta["epoch"] == 0
    os.remove(str(tmp_path / "async.pt.meta.json"))
    assert tr.load_checkpoint(str(tmp_path / "async.pt")) == tr.state.step == 7
    # an earlier port run's ckpts/last: the same file without a suffix
    os.makedirs(str(tmp_path / "ckpts"))
    os.replace(str(tmp_path / "sync.pt"), str(tmp_path / "ckpts" / "last"))
    os.replace(str(tmp_path / "sync.pt.meta.json"), str(tmp_path / "ckpts" / "last.meta.json"))
    assert tr.load_checkpoint(str(tmp_path / "ckpts" / "last")) == 7
    assert_same(want, snapshot_of(tr.state))
    sd = {k: v.half() for k, v in tr.model.state_dict().items() if v.is_floating_point()}
    torch.save({"model": sd}, str(tmp_path / "best-map50_0.5000.pt"))
    other = port_trainer(with_out(tr.cfg.to_dict(), tmp_path / "other"))
    try:
        load_weights(str(tmp_path / "best-map50_0.5000.pt"), other.model)
        for k, v in other.model.state_dict().items():
            if k in sd:
                assert torch.equal(v, sd[k].float()), k
    finally:
        other.train_loader.close()
