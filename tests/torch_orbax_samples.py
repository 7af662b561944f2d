"""Writes the committed zstd and orbax fixtures that the port's checkpoint
readers are held to (vision_kit_tpu_torch/data/checkpoint_samples/),
with sha256s in its MANIFEST.json. Run in an environment that has
`zstandard`, `orbax-checkpoint` and `tensorstore` (and JAX):

    JAX_PLATFORMS=cpu python tests/torch_orbax_samples.py

The directory sits beside data/samples/, whose files are images that the
decode tests and the demo read one by one. It holds:

  * zstd/*.zst: frames from `zstandard` at levels -5, 1, 3, 9 and 19,
    each with and without the content checksum and the content size; one
    of over 128 KB of content (several blocks, matches across them); one
    concatenated pair with a skippable frame between. The manifest gives
    each frame's bytes and the sha256 of its decoded content;
  * orbax_ocdbt/ and orbax_plain/: one synthetic TrainState-shaped tree
    (the JAX package's TrainState, SGDState, EMAState and optax's empty
    clip state; f32, bf16, i32 and 0-d leaves) saved as the JAX Trainer
    saves (ocp.AsyncCheckpointer(ocp.StandardCheckpointHandler()),
    ocp.args.StandardSave), in orbax's OCDBT layout and in its plain one.
    The OCDBT save lowers max_decoded_node_bytes from orbax's 100 MB to
    1 KB, so that its B-tree has more than one level (tensorstore's own
    dump reports the root's height). The manifest gives each file's
    sha256 and, for each stored leaf of the tree (the same in both), the
    dtype, shape and sha256 of the bytes orbax restores.

The OCDBT files carry a random uuid, random data-file names and commit
times: a rewrite gives other bytes (and a new manifest).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "vision_kit_tpu_torch", "data", "checkpoint_samples")
LEVELS = (-5, 1, 3, 9, 19)
NODE_BYTES = 1024        # the OCDBT save's max_decoded_node_bytes


def frame_contents() -> dict[str, bytes]:
    """The contents the frames compress: text, float weights, a run-heavy
    mix (seeded), and a 200 KB one that spans several blocks."""
    rng = np.random.default_rng(18)
    text = b"".join(b"%d:%s;" % (i, b"orbax zarr ocdbt"[: i % 16]) for i in range(160))
    weights = (rng.standard_normal(500) * 0.02).astype(np.float32).tobytes()
    runs = bytes(rng.integers(0, 4, 1500, dtype=np.uint8)) + bytes(300) + b"ab" * 300
    big = b"".join([text, weights, runs] * 28)
    return {"mixed": text + weights + runs, "big": big}


def frames() -> dict[str, tuple[bytes, bytes]]:
    """{file name: (frame bytes, content)}."""
    import zstandard

    contents = frame_contents()
    out = {}
    for level in LEVELS:
        for checksum in (False, True):
            for size in (False, True):
                c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=size)
                name = f"l{level}{'_ck' if checksum else ''}{'_cs' if size else ''}.zst"
                out[name] = (c.compress(contents["mixed"]), contents["mixed"])
    out["big_l3_ck_cs.zst"] = (zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(contents["big"]), contents["big"])
    a, b = contents["mixed"][:4000], contents["mixed"][4000:]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"skip!"
    pair = (zstandard.ZstdCompressor(level=1).compress(a) + skip
            + zstandard.ZstdCompressor(level=9, write_checksum=True).compress(b))
    out["pair_skippable.zst"] = (pair, a + b)
    return out


def train_state():
    """A TrainState-shaped tree of the JAX package's own types: 6 conv
    blocks (HWIO kernels and BN scale/bias in f32), a bf16 head, BN
    statistics, SGD momentum, an updated EMA and int32 0-d counts."""
    import jax
    import jax.numpy as jnp
    import optax

    from vision_kit_tpu.train.ema import EMAState
    from vision_kit_tpu.train.optim import SGDState
    from vision_kit_tpu.train.step import TrainState

    rng = np.random.default_rng(7)

    def f32(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    params, stats = {"backbone": {}}, {"backbone": {}}
    for i in range(6):
        cin, cout = 3 if i == 0 else 4 + i, 5 + i
        params["backbone"][f"stage{i // 3}_{i % 3}"] = {
            "conv": {"kernel": f32(3, 3, cin, cout)},
            "bn": {"scale": f32(cout), "bias": f32(cout)}}
        stats["backbone"][f"stage{i // 3}_{i % 3}"] = {
            "bn": {"mean": f32(cout), "var": np.abs(f32(cout)) + 1}}
    params["head"] = {"m_0": {"kernel": jnp.asarray(f32(1, 1, 10, 21), jnp.bfloat16),
                              "bias": jnp.asarray(f32(21), jnp.bfloat16)}}
    momentum = jax.tree_util.tree_map(lambda v: v * 0.5, params)
    ema_tree = {"params": params, "batch_stats": stats}
    return TrainState(
        params=params, batch_stats=stats,
        opt_state=(optax.EmptyState(), SGDState(step=np.asarray(5, np.int32),
                                                momentum_buf=momentum)),
        ema=EMAState(updates=np.asarray(5, np.int32), tree=ema_tree),
        step=np.asarray(5, np.int32))


def save_like_trainer(path: str, state, use_ocdbt: bool = True) -> None:
    """The JAX Trainer's save (train/trainer.py:save_checkpoint): an
    AsyncCheckpointer over a StandardCheckpointHandler, StandardSave of the
    host state, waited for."""
    import jax
    import orbax.checkpoint as ocp

    handler = (ocp.StandardCheckpointHandler() if use_ocdbt
               else ocp.StandardCheckpointHandler(use_ocdbt=False))
    ckptr = ocp.AsyncCheckpointer(handler)
    ckptr.save(os.path.abspath(path), args=ocp.args.StandardSave(jax.device_get(state)),
               force=True)
    ckptr.wait_until_finished()
    ckptr.close()


class small_nodes:
    """orbax's OCDBT write options with max_decoded_node_bytes lowered, so
    that a small tree's B-tree grows more than one level."""

    def __init__(self, node_bytes: int = NODE_BYTES):
        self.node_bytes = node_bytes

    def __enter__(self):
        from orbax.checkpoint._src.serialization import tensorstore_utils as tu

        self.tu, self.orig = tu, tu.add_ocdbt_write_options

        def patched(spec, *args, **kwargs):
            self.orig(spec, *args, **kwargs)
            spec["config"]["max_decoded_node_bytes"] = self.node_bytes

        tu.add_ocdbt_write_options = patched
        return self

    def __exit__(self, *exc):
        self.tu.add_ocdbt_write_options = self.orig


def restored_leaves(path: str) -> dict:
    """{str(path tuple): {dtype, shape, sha256}} of the stored leaves that
    orbax's untyped restore gives."""
    import jax
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().restore(os.path.abspath(path))
    out = {}
    for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in keys)
        arr = np.asarray(leaf)
        out[str(names)] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                           "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    return out


def root_height(path: str) -> int:
    """The latest version's B-tree height, as tensorstore's dump gives it."""
    import tensorstore as ts

    base = ts.KvStore.open({"driver": "file", "path": os.path.abspath(path) + "/"}).result()
    return ts.ocdbt.dump(base).result()["versions"][-1]["root_height"]


def write(out_dir: str = OUT) -> dict:
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(os.path.join(out_dir, "zstd"))
    manifest: dict = {"files": {}, "frames": {}, "checkpoints": {}, "leaves": None}
    for name, (data, content) in frames().items():
        with open(os.path.join(out_dir, "zstd", name), "wb") as f:
            f.write(data)
        manifest["frames"][f"zstd/{name}"] = {
            "bytes": len(data), "content_bytes": len(content),
            "content_sha256": hashlib.sha256(content).hexdigest()}
    state = train_state()
    with small_nodes():
        save_like_trainer(os.path.join(out_dir, "orbax_ocdbt"), state)
    save_like_trainer(os.path.join(out_dir, "orbax_plain"), state, use_ocdbt=False)
    for name in ("orbax_ocdbt", "orbax_plain"):
        path = os.path.join(out_dir, name)
        leaves = restored_leaves(path)
        if manifest["leaves"] not in (None, leaves):
            raise SystemExit("orbax restores the two layouts differently")
        manifest["leaves"] = leaves
        entry = {}
        if name == "orbax_ocdbt":
            entry["root_height"] = root_height(path)
            if entry["root_height"] < 1:
                raise SystemExit("the OCDBT fixture's B-tree has one level")
        manifest["checkpoints"][name] = entry
    for root, _, files in os.walk(out_dir):
        for fname in files:
            full = os.path.join(root, fname)
            with open(full, "rb") as f:
                data = f.read()
            manifest["files"][os.path.relpath(full, out_dir)] = {
                "bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    m = write()
    total = sum(v["bytes"] for v in m["files"].values())
    print(f"{len(m['files'])} files, {total} bytes in {OUT}; OCDBT root height "
          f"{m['checkpoints']['orbax_ocdbt']['root_height']}")
