"""The JAX Trainer's orbax checkpoints in the port, on the CPU: the OCDBT
store (utils/ocdbt.py) against tensorstore, read_checkpoint
(utils/orbax.py) against `ocp.StandardCheckpointer().restore` leaf for
leaf and bit for bit in both layouts (the committed fixtures of
data/checkpoint_samples/, zarr arrays tensorstore chunks), refusals (a
bad crc32c, use_zarr3, unknown layouts), write_checkpoint restored by
orbax; then a v5n@64 JAX TrainState after one JAX step, saved by the JAX
Trainer's own calls: Trainer.load_checkpoint gives the state that
convert.load_jax_train_state gives of the JAX state, bit for bit, the
port's next step matches JAX's at test_torch_train's tolerance, the meta
is read as JAX reads it, and load_weights(dir) equals JAX's
load_weights(dir) for an EMA-updated and a fresh state."""

import functools
import hashlib
import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest
import torch

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")
pytest.importorskip("zstandard")

import jax  # noqa: E402

import torch_orbax_samples as samples  # noqa: E402
from test_torch_model import port_v5  # noqa: E402
from test_torch_train import (  # noqa: E402
    EPOCHS,
    STEPS_PER_EPOCH,
    TRAIN_HYP,
    compare_states,
    step_batches,
)
from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5  # noqa: E402
from vision_kit_tpu.predictor import load_weights as jax_load_weights  # noqa: E402
from vision_kit_tpu.train import optim as jax_optim  # noqa: E402
from vision_kit_tpu.train.losses import YoloLoss as JaxYoloLoss  # noqa: E402
from vision_kit_tpu.train.step import create_train_state as jax_create_train_state  # noqa: E402
from vision_kit_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from vision_kit_tpu_torch import convert, predictor  # noqa: E402
from vision_kit_tpu_torch.models import YOLOV5  # noqa: E402
from vision_kit_tpu_torch.train import optim, trainer  # noqa: E402
from vision_kit_tpu_torch.train.losses import YoloLoss  # noqa: E402
from vision_kit_tpu_torch.train.step import create_train_state, make_train_step  # noqa: E402
from vision_kit_tpu_torch.utils import ocdbt, orbax  # noqa: E402
from vision_kit_tpu_torch.utils.stream_bench import train_state_tensors  # noqa: E402

torch.set_num_threads(2)

SAMPLES = samples.OUT
with open(os.path.join(SAMPLES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)
LAYOUTS = ("orbax_ocdbt", "orbax_plain")


def flat(tree, prefix=()):
    """{path tuple: leaf} of a tree of dicts, tuples and lists (empty
    containers as leaves)."""
    if isinstance(tree, dict) and tree:
        return {k: v for key, child in tree.items()
                for k, v in flat(child, prefix + (str(key),)).items()}
    if isinstance(tree, (tuple, list)) and tree:
        return {k: v for i, child in enumerate(tree)
                for k, v in flat(child, prefix + (str(i),)).items()}
    return {prefix: tree}


def raw(leaf):
    """(dtype name, shape, bytes) of an array leaf; the leaf itself for
    None, scalars and empty containers."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return "bfloat16", tuple(leaf.shape), leaf.view(torch.int16).numpy().tobytes()
    if isinstance(leaf, (np.ndarray, np.generic)) or hasattr(leaf, "dtype"):
        arr = np.asarray(leaf)
        return str(arr.dtype), arr.shape, arr.tobytes()
    return leaf


def assert_same_tree(got, want):
    """Leaf for leaf and bit for bit; sequences compared as tuples (orbax
    restores lists)."""
    fg, fw = flat(got), flat(want)
    assert sorted(fg) == sorted(fw)
    for path in fw:
        w = fw[path]
        w = tuple(w) if isinstance(w, list) else w
        assert raw(fg[path]) == raw(w), path


def orbax_restore(path):
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


# -- the committed fixtures --------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_fixture_equals_orbax_restore(layout):
    path = os.path.join(SAMPLES, layout)
    got = orbax.read_checkpoint(path)
    assert_same_tree(got, orbax_restore(path))
    leaves = {str(k): v for k, v in flat(got).items() if raw(v) is not v}
    assert sorted(leaves) == sorted(MANIFEST["leaves"])
    for key, meta in MANIFEST["leaves"].items():
        dtype, shape, data = raw(leaves[key])
        assert (dtype, list(shape)) == (meta["dtype"], meta["shape"]), key
        assert hashlib.sha256(data).hexdigest() == meta["sha256"], key
    # the TrainState's shape: the empty clip state, 0-d int32 counts, bf16
    assert got["opt_state"][0] is None and got["step"].shape == ()
    assert got["ema"]["updates"].dtype == np.int32
    assert got["params"]["head"]["m_0"]["kernel"].dtype == torch.bfloat16


def test_fixture_btree_has_more_than_one_level():
    path = os.path.join(SAMPLES, "orbax_ocdbt")
    kv = ocdbt.KvStore(path)
    assert kv.version.root_height == samples.root_height(path) >= 1
    assert kv.config.max_decoded_node_bytes == samples.NODE_BYTES
    want = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/"}
                           ).result()
    keys = sorted(k.decode() for k in want.list().result())
    assert kv.keys() == keys
    for k in keys:
        assert kv.read(k) == want.read(k).result().value, k
    assert kv.read("no/such/key") is None


def write_store(path, config, n, batch, value=lambda j: b"x" * (j % 50)):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/", "config": config}
                         ).result()
    for i in range(0, n, batch):
        txn = ts.Transaction()
        for j in range(i, min(n, i + batch)):
            kv.with_transaction(txn)[f"k{j:04d}/.zarray"] = value(j)
        txn.commit_sync()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 400, "compression": {"id": "zstd", "level": 7}},
    {"compression": None, "max_inline_value_bytes": 8},
    {"manifest_kind": "numbered"},
])
def test_ocdbt_store_equals_tensorstore(tmp_path, config):
    """Multi-level trees, values inline and in data files, uncompressed
    nodes, a numbered manifest: the same keys and values as tensorstore."""
    want = write_store(str(tmp_path), config, 150, 50,
                       value=lambda j: bytes([j % 251]) * (j % 40 if j % 9 else 3000))
    kv = ocdbt.KvStore(str(tmp_path))
    assert dict(kv.items()) == want
    assert kv.config.manifest_kind == (1 if config.get("manifest_kind") else 0)


def test_written_database_read_by_tensorstore(tmp_path):
    """ocdbt.write_database: keys sharing prefixes, given out of order,
    values empty, inline (up to 100 bytes) and in the data file, read back
    by tensorstore (keys, values, its dump of the manifest) and by the
    port's reader; a key given twice and no key at all are refused."""
    rng = np.random.default_rng(3)
    items = {f"{p}/{'x' * (i % 5)}{i}": rng.bytes(int(rng.choice([0, 1, 100, 101, 5000])))
             for i, p in enumerate(["a", "ab", "b.c", "params.m_0"] * 40)}
    order = list(items.items())[::-1]
    size = ocdbt.write_database(str(tmp_path / "db"), order)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path / 'db'}/"}).result()
    assert sorted(k.decode() for k in kv.list().result()) == sorted(items)
    for k, v in items.items():
        assert kv.read(k).result().value == v, k
    dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path / 'db'}/").result()).result()
    (version,) = dump["versions"]
    assert version["generation_number"] == 1 and version["root_height"] == 0
    stats = version["root"]["statistics"]
    assert stats["num_keys"] == len(items)
    assert stats["num_indirect_value_bytes"] == sum(len(v) for v in items.values()
                                                    if len(v) > 100)
    assert dump["config"]["max_inline_value_bytes"] == ocdbt.MAX_INLINE_VALUE_BYTES
    (data,) = os.listdir(tmp_path / "db" / "d")
    assert os.path.getsize(tmp_path / "db" / "d" / data) == size
    assert dict(ocdbt.KvStore(str(tmp_path / "db")).items()) == items
    with pytest.raises(ValueError, match="twice"):
        ocdbt.write_database(str(tmp_path / "twice"), [("k", b"1"), ("k", b"2")])
    with pytest.raises(ValueError, match="at least one"):
        ocdbt.write_database(str(tmp_path / "none"), [])


def test_version_tree_nodes(tmp_path):
    """40 commits: the manifest keeps the newest versions inline and the
    older ones in version tree nodes. The reader takes the newest inline
    version, and walking the nodes reaches the newest version they hold,
    the one tensorstore's dump reaches."""
    root = str(tmp_path)
    want = write_store(root, {}, 40, 1)
    kv = ocdbt.KvStore(root)
    assert dict(kv.items()) == want
    _, versions, nodes = kv._manifest()
    assert nodes and kv.version == max(versions, key=lambda v: v.generation)
    from_nodes = kv._latest([], nodes)
    base = ts.KvStore.open({"driver": "file", "path": root + "/"}).result()
    dump = ts.ocdbt.dump(base).result()
    def newest(entries):
        return max(entries, key=lambda e: e["generation_number"])

    node = ts.ocdbt.dump(base, newest(dump["version_tree_nodes"])["location"]).result()
    while node["height"] > 0:
        node = ts.ocdbt.dump(base, newest(node["entries"])["location"]).result()
    newest = newest(node["entries"])
    assert from_nodes.generation == newest["generation_number"] < kv.version.generation
    path, offset, length = from_nodes.root
    assert newest["root"]["location"] == f"btreenode::{path}:{offset}:{length}"


# -- zarr arrays -------------------------------------------------------------

def orbax_dir(path, arrays, use_ocdbt):
    """An orbax-layout checkpoint of {name: zarr metadata, data} written by
    tensorstore's zarr driver (chunks as given; a chunk left unwritten
    where `data` is a masked array), with orbax's _METADATA by hand."""
    md = {}
    for name, (meta, data) in arrays.items():
        kvstore = ({"driver": "ocdbt", "base": f"file://{path}/", "path": name + "/"}
                   if use_ocdbt else {"driver": "file", "path": f"{path}/{name}/"})
        arr = ts.open({"driver": "zarr", "kvstore": kvstore, "metadata": meta,
                       "create": True}).result()
        if isinstance(data, np.ma.MaskedArray):
            # write every chunk but the first
            c = meta["chunks"]
            arr[c[0]:].write(data.data[c[0]:]).result()
            arr[:c[0], c[1]:].write(data.data[:c[0], c[1]:]).result()
        else:
            arr.write(data).result()
        md[str((name,))] = {"key_metadata": [{"key": name, "key_type": 2}],
                            "value_metadata": {"value_type": "np.ndarray",
                                               "skip_deserialize": False}}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": md, "use_ocdbt": use_ocdbt, "use_zarr3": False}, f)


@pytest.mark.parametrize("use_ocdbt", [False, True])
def test_chunked_zarr_arrays(tmp_path, use_ocdbt):
    """Chunk grids with partial edge chunks, order C and F, separators "."
    and "/", compressor zstd and null, 0-d arrays, a missing chunk filled
    as tensorstore fills it: equal to tensorstore's read of each array."""
    rng = np.random.default_rng(4)

    def meta(shape, chunks, dtype, **kw):
        return {"shape": list(shape), "chunks": list(chunks), "dtype": dtype,
                "compressor": {"id": "zstd", "level": 3}, "fill_value": None, **kw}

    a = rng.standard_normal((7, 10, 3)).astype(np.float32)
    arrays = {
        "edge_c": (meta(a.shape, (3, 4, 2), "<f4"), a),
        "edge_f": (meta(a.shape, (2, 3, 3), "<f4", order="F", dimension_separator="/"), a),
        "plain": (meta((5, 6), (4, 4), "<i4", compressor=None),
                  rng.integers(-9, 9, (5, 6)).astype(np.int32)),
        "missing": (meta((6, 5), (4, 3), "<f8"),
                    np.ma.MaskedArray(rng.standard_normal((6, 5)))),
        "missing_fill": (meta((6, 5), (4, 3), "<i2", fill_value=-7),
                         np.ma.MaskedArray(rng.integers(0, 9, (6, 5)).astype(np.int16))),
        "scalar": (meta((), (), "<i4"), np.asarray(11, np.int32)),
        "flags": (meta((9,), (4,), "|b1"), rng.integers(0, 2, 9).astype(bool)),
    }
    root = str(tmp_path)
    orbax_dir(root, arrays, use_ocdbt)
    got = orbax.read_checkpoint(root)
    for name, (m, _) in arrays.items():
        kvstore = ({"driver": "ocdbt", "base": f"file://{root}/", "path": name + "/"}
                   if use_ocdbt else {"driver": "file", "path": f"{root}/{name}/"})
        want = ts.open({"driver": "zarr", "kvstore": kvstore}).result().read().result()
        assert raw(got[name]) == raw(want), name
    assert np.all(got["missing"][:4, :3] == 0)
    assert np.all(got["missing_fill"][:4, :3] == -7)


# -- refusals ----------------------------------------------------------------

def copy_fixture(tmp_path, layout):
    dst = os.path.join(str(tmp_path), layout)
    shutil.copytree(os.path.join(SAMPLES, layout), dst)
    return dst


def flip(path, pos):
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0x10]))


def test_bad_crc32c_refused(tmp_path):
    path = copy_fixture(tmp_path, "orbax_ocdbt")
    flip(os.path.join(path, "manifest.ocdbt"), 20)
    with pytest.raises(ocdbt.OcdbtError, match="crc32c"):
        orbax.read_checkpoint(path)
    path = copy_fixture(tmp_path / "node", "orbax_ocdbt")
    (node,) = os.listdir(os.path.join(path, "d"))
    flip(os.path.join(path, "d", node), 30)
    with pytest.raises(ocdbt.OcdbtError, match="crc32c"):
        orbax.read_checkpoint(path)
    assert ocdbt.crc32c(b"123456789") == 0xE3069283      # the Castagnoli check value


@pytest.mark.parametrize("change", [{"use_zarr3": True}, {"use_ocdbt": None},
                                    {"use_ocdbt": "sometimes"}])
def test_unknown_layouts_refused(tmp_path, change):
    path = copy_fixture(tmp_path, "orbax_plain")
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    meta.update(change)
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(orbax.OrbaxError):
        orbax.read_checkpoint(path)


# -- writing -----------------------------------------------------------------

class Pair(NamedTuple):
    first: object
    second: object


def test_write_checkpoint_restored_by_orbax(tmp_path):
    tree = orbax.read_checkpoint(os.path.join(SAMPLES, "orbax_ocdbt"))
    path = str(tmp_path / "written")
    orbax.write_checkpoint(path, tree)
    assert_same_tree(orbax_restore(path), tree)
    assert_same_tree(orbax.read_checkpoint(path), tree)
    # orbax's default layout: one OCDBT database, not a directory an array
    with open(os.path.join(path, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is True
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA", "d",
                                        "manifest.ocdbt"]
    rng = np.random.default_rng(1)
    other = {"named": Pair(torch.randn(3, 4).to(torch.bfloat16),
                           rng.standard_normal((2, 2, 300)).astype(np.float32)),
             "counts": [np.int64(3), 7, 2.5], "empty": {}, "none": None,
             "big": rng.standard_normal(70_000).astype(np.float32)}    # > one block
    orbax.write_checkpoint(path, other)     # replaces the earlier one
    want = {"named": {"first": other["named"].first, "second": other["named"].second},
            "counts": (np.asarray(3, np.int64), 7, 2.5), "empty": {}, "none": None,
            "big": other["big"]}
    assert_same_tree(orbax_restore(path), want)
    assert_same_tree(orbax.read_checkpoint(path), want)


# -- a JAX Trainer's TrainState ----------------------------------------------

@functools.cache
def jax_states():
    """(fresh, after one step, after two steps) JAX TrainStates of v5n@64
    on test_torch_train's batches, the numpy variables and the batches.
    The variables are a seeded port model's, bridged to Flax (an eager JAX
    init of v5n costs ~20 s here)."""
    torch.manual_seed(0)
    v = convert.jax_variables_from_state_dict(YOLOV5(variant="n", num_classes=80)
                                              .state_dict())
    jm = JaxYOLOV5(variant="n", num_classes=80)
    jtx = jax_optim.make_optimizer(v["params"], TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    step = jax_make_train_step(jm, JaxYoloLoss(80, jm.grid_anchors, TRAIN_HYP), jtx,
                               donate=False)
    batches = step_batches(2)
    s0 = jax_create_train_state(v, jtx)
    s1, _ = step(s0, batches[0])
    s2, _ = step(s1, batches[1])
    return tuple(jax.device_get(s) for s in (s0, s1, s2)), v, batches


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A JAX run's ckpts/: `last` after one step with the meta the JAX
    Trainer writes beside it, `fresh` before any step."""
    root = tmp_path_factory.mktemp("run") / "ckpts"
    (s0, s1, _), _, _ = jax_states()
    samples.save_like_trainer(str(root / "last"), s1)
    samples.save_like_trainer(str(root / "fresh"), s0)
    with open(str(root / "last") + ".meta.json", "w") as f:
        json.dump({"epoch": -1, "step": 1, "best_map50": 0.25, "epochs_no_improve": 2,
                   "val_pending": True}, f)
    return root


class TrainerStub:
    """What Trainer.load_checkpoint reads and sets on a Trainer."""

    def __init__(self, state, steps_per_epoch=STEPS_PER_EPOCH):
        self.state, self.steps_per_epoch = state, steps_per_epoch
        self.best_map50, self.epochs_no_improve, self._val_pending = -1.0, 0, False
        self.global_step = None

    def use_state(self, state):
        self.state = state


def port_pair(v):
    model = port_v5("n", v).train()
    tx = optim.make_optimizer(model, TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    return model, tx


def test_trainer_resumes_a_jax_checkpoint(ckpts):
    (_, s1, s2), v, batches = jax_states()
    model, tx = port_pair(v)
    stub = TrainerStub(create_train_state(model, tx))
    assert trainer.Trainer.load_checkpoint(stub, str(ckpts / "last")) == 1
    assert (stub.global_step, stub.best_map50, stub.epochs_no_improve,
            stub._val_pending) == (1, 0.25, 2, True)
    restored = stub.state
    ref_model, ref_tx = port_pair(v)
    want = convert.load_jax_train_state(ref_model, ref_tx, s1)
    assert (restored.step, restored.ema.updates, optim.sgd_state(restored.opt_state).step) \
        == (want.step, want.ema.updates, optim.sgd_state(want.opt_state).step) == (1, 1, 1)
    got_t, want_t = train_state_tensors(restored), train_state_tensors(want)
    for part in want_t:
        assert got_t[part].keys() == want_t[part].keys()
        for k in want_t[part]:
            assert torch.equal(got_t[part][k], want_t[part][k]), (part, k)
    for k, t in model.state_dict().items():           # the model's own tensors too
        assert torch.equal(t, ref_model.state_dict()[k]), k
    # the port's next step against JAX's
    pstep = make_train_step(model, YoloLoss(80, model.head.grid_anchors, TRAIN_HYP), tx)
    prev = convert.train_state_tensors_from_jax(s1)
    pstate, _ = pstep(restored, batches[1])
    compare_states(s2, pstate, {p: prev[p] for p in want_t})


@pytest.mark.parametrize("meta, step", [
    (None, 0),                                               # JAX resumes at 0
    ({"epoch": 2, "best_map50": 0.5}, 3 * STEPS_PER_EPOCH),  # before the step was kept
    ({"epoch": 2, "step": 17}, 17),
])
def test_trainer_reads_the_meta_as_jax(tmp_path, meta, step):
    """A port state written as a JAX Trainer directory (write_checkpoint of
    convert.jax_train_state_tree) with each kind of meta beside it."""
    (_, s1, _), v, _ = jax_states()
    model, tx = port_pair(v)
    state = convert.load_jax_train_state(model, tx, s1)
    path = str(tmp_path / "last")
    orbax.write_checkpoint(path, convert.jax_train_state_tree(state))
    if meta is None:
        assert_same_tree(orbax.read_checkpoint(path), orbax_restore(path))
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    fresh_model, fresh_tx = port_pair(v)
    stub = TrainerStub(create_train_state(fresh_model, fresh_tx))
    assert trainer.Trainer.load_checkpoint(stub, path) == step == stub.global_step
    assert stub.best_map50 == (meta or {}).get("best_map50", -1.0)
    got = train_state_tensors(stub.state)
    for part, tensors in train_state_tensors(state).items():
        for k, t in tensors.items():
            assert torch.equal(got[part][k], t), (part, k)


@pytest.mark.parametrize("name, ema", [("last", True), ("fresh", False)])
def test_load_weights_equals_jax(ckpts, name, ema):
    """The EMA of an updated state, the raw params of a fresh one: the
    port's load_weights(dir) equals JAX's load_weights(dir) bridged."""
    (s0, s1, _), v, _ = jax_states()
    path = str(ckpts / name)
    want = convert.state_dict_from_jax_variables(jax_load_weights(path, v))
    model = port_v5("n", v)
    predictor.load_weights(path, model)
    got = model.state_dict()
    for k, t in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], t), k
    state = s1 if ema else s0
    src = state.ema.tree["params"] if ema else state.params
    kernel = src["head"]["m_0"]["kernel"]
    assert torch.equal(got["head.m.0.weight"],
                       torch.from_numpy(np.asarray(kernel).transpose(3, 2, 0, 1).copy()))


def test_export_cli_takes_a_jax_ckpts_dir(ckpts, tmp_path, monkeypatch):
    """`python -m vision_kit_tpu_torch export --ckpt <JAX ckpts/last>`: the
    model handed to run_export holds the directory's EMA weights (the
    export itself is test_torch_export's)."""
    from vision_kit_tpu_torch import __main__ as cli
    from vision_kit_tpu_torch import export
    from vision_kit_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(os.path.join(samples.REPO, "configs", "yolov5.yaml"))
    cfg.model.update(version="n", num_classes=80, input_size=[64, 64], weight="")
    cfg_path = str(tmp_path / "cfg.yaml")
    save_config(cfg, cfg_path)
    seen = {}

    def fake_export(cfg, model, save_dir, **kw):
        seen["sd"] = model.state_dict()
        return export.ExportResult()

    monkeypatch.setattr(export, "run_export", fake_export)
    assert cli.main(["export", "-c", cfg_path, "--ckpt", str(ckpts / "last"),
                     "--output-dir", str(tmp_path), "--device", "cpu"]) == 0
    (_, s1, _), _, _ = jax_states()
    want = convert.state_dict_from_jax_variables(s1.ema.tree)
    for k, t in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(seen["sd"][k], t), k
