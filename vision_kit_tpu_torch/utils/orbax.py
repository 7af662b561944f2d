"""The JAX package's orbax checkpoints, read and written without orbax,
tensorstore or zstandard.

The JAX Trainer saves its TrainState with
`ocp.AsyncCheckpointer(ocp.StandardCheckpointHandler())` and
`ocp.args.StandardSave(jax.device_get(state))`. Such a directory holds:

  * `_METADATA`, JSON: `tree_metadata` maps each leaf's path to its
    `key_metadata` (key_type 2 a dict key or NamedTuple field, 1 a
    sequence index) and `value_metadata` (value_type `np.ndarray`,
    `jax.Array` or `scalar` for stored values; `None`, `Dict`, `Tuple` or
    `List` with skip_deserialize for empty nodes, such as optax's empty
    clip state); `use_ocdbt` and `use_zarr3` name the layout;
  * `_CHECKPOINT_METADATA`, JSON (timestamps, the handler's name);
  * each stored leaf as a zarr v2 array named by its path joined with ".":
    `<name>/.zarray` and chunks `<name>/<i.j.k>` (`0` for a 0-d array),
    each chunk a zstd frame of the chunk's bytes (compressor "zstd") or
    the bytes themselves (compressor null). With `use_ocdbt` (orbax's
    default) those keys live in an OCDBT database (utils/ocdbt.py) at the
    directory's root; without it they are files.

read_checkpoint rebuilds the tree (dicts and tuples) with numpy leaves,
bfloat16 as torch.bfloat16 tensors (numpy has no bfloat16), Python
scalars for "scalar" leaves. write_checkpoint writes orbax's default
(OCDBT) layout, which orbax and the JAX package restore: the same
`_METADATA` and `.zarray`s, each array one chunk, a zstd frame of raw
blocks, in one OCDBT database.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import time

import numpy as np
import torch

from vision_kit_tpu_torch.utils import ocdbt, zstd

METADATA, CHECKPOINT_METADATA = "_METADATA", "_CHECKPOINT_METADATA"
KEY_DICT, KEY_SEQUENCE = 2, 1
# stored values: numpy and scalars, and JAX arrays (value type `jax.Array`)
ARRAY_TYPES = ("np.ndarray", "scalar")
EMPTY = {"None": None, "Dict": {}, "Tuple": (), "List": ()}
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


class OrbaxError(ValueError):
    """A directory that is not an orbax checkpoint of a layout this reader takes."""


def is_checkpoint(path: str) -> bool:
    """Whether `path` is a directory with orbax's `_METADATA`."""
    return os.path.isfile(os.path.join(path, METADATA))


# -- reading -----------------------------------------------------------------

class _Files:
    """The plain layout: each zarr key a file under the directory."""

    def __init__(self, root: str):
        self.root = root

    def read(self, key: str) -> bytes | None:
        try:
            with open(os.path.join(self.root, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None


def _metadata(path: str) -> dict:
    try:
        with open(os.path.join(path, METADATA)) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise OrbaxError(f"{path}: no {METADATA}; not an orbax checkpoint") from None
    if not isinstance(meta.get("tree_metadata"), dict):
        raise OrbaxError(f"{path}/{METADATA}: no tree_metadata")
    if meta.get("use_zarr3", False) is not False:
        raise OrbaxError(f"{path}: use_zarr3 {meta.get('use_zarr3')!r}; this reader takes "
                         "zarr v2 (orbax's default, use_zarr3 false)")
    if meta.get("use_ocdbt") not in (True, False):
        raise OrbaxError(f"{path}: use_ocdbt {meta.get('use_ocdbt')!r}; this reader takes "
                         "the layouts use_ocdbt true (OCDBT) and false (files)")
    return meta


def _fill(fill_value, dtype: str):
    """A zarr v2 fill_value as the chunk's value (null: zeros, as
    tensorstore fills it)."""
    if fill_value is None:
        return 0
    if isinstance(fill_value, str):
        return {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[fill_value]
    return fill_value


class _Array:
    """A zarr v2 array's metadata and its chunks' stored bytes (None where
    a chunk is missing), read before any is decompressed."""

    def __init__(self, store, name: str):
        raw = store.read(f"{name}/.zarray")
        if raw is None:
            raise OrbaxError(f"{name}: no .zarray")
        z = json.loads(raw)
        if z.get("zarr_format") != 2:
            raise OrbaxError(f"{name}: zarr_format {z.get('zarr_format')!r}, not 2")
        if z.get("filters"):
            raise OrbaxError(f"{name}: zarr filters {z['filters']!r} are not read")
        comp = z.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise OrbaxError(f"{name}: compressor {comp.get('id')!r} (zstd or null)")
        self.order = z.get("order", "C")
        sep = z.get("dimension_separator", ".")
        if self.order not in ("C", "F") or sep not in (".", "/"):
            raise OrbaxError(f"{name}: order {self.order!r}, dimension_separator {sep!r}")
        self.shape, self.chunks = tuple(z["shape"]), tuple(z["chunks"])
        if len(self.shape) != len(self.chunks) or any(c <= 0 for c in self.chunks):
            raise OrbaxError(f"{name}: chunks {self.chunks} for shape {self.shape}")
        self.name, self.compressed = name, comp is not None
        self.bf16 = z["dtype"] == "bfloat16"
        self.dtype = np.dtype("<u2") if self.bf16 else np.dtype(z["dtype"])
        self.fill = _fill(z.get("fill_value"), z["dtype"])
        if self.bf16:
            self.fill = int(torch.tensor(self.fill, dtype=torch.bfloat16)
                            .view(torch.int16)) & 0xFFFF
        grid = (range(-(-s // c)) for s, c in zip(self.shape, self.chunks))
        self.stored = [(idx, store.read(f"{name}/{sep.join(map(str, idx)) or '0'}"))
                       for idx in itertools.product(*grid)]

    def assemble(self, chunks: list) -> np.ndarray | torch.Tensor:
        """The array from its chunks' bytes (decompressed; None: missing)."""
        out = np.empty(self.shape, self.dtype)
        nbytes = math.prod(self.chunks) * self.dtype.itemsize
        for (idx, _), data in zip(self.stored, chunks):
            region = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(idx, self.chunks, self.shape))
            if data is None:
                out[region] = self.fill
                continue
            if len(data) != nbytes:
                raise OrbaxError(f"{self.name}: chunk {idx} holds {len(data)} bytes, "
                                 f"{nbytes} expected")
            block = np.frombuffer(data, self.dtype).reshape(self.chunks, order=self.order)
            out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
        out = out.astype(self.dtype.newbyteorder("="), copy=False)
        if self.bf16:
            return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
        return out


def _read_arrays(store, names: list[str], device) -> list:
    """The arrays `names` of `store`, every compressed chunk of all of them
    decompressed in one utils/zstd.py call (the plain decoder walks their
    Huffman literals together)."""
    arrays = [_Array(store, name) for name in names]
    packed = [data for a in arrays if a.compressed for _, data in a.stored
              if data is not None]
    unpacked = iter(zstd.decompress_many(packed, device=device))
    out = []
    for a in arrays:
        chunks = [data if data is None or not a.compressed else next(unpacked)
                  for _, data in a.stored]
        out.append(a.assemble(chunks))
    return out


class _Seq(dict):
    """A sequence node while the tree is rebuilt: {index: child}."""


def _finish(node):
    if isinstance(node, _Seq):
        items = [None] * (max(node) + 1 if node else 0)
        for i, child in node.items():
            items[i] = _finish(child)
        return tuple(items)
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    return node


def read_checkpoint(path: str, device="cpu", select=None):
    """The tree of the orbax checkpoint directory `path`: dicts for dict
    keys and NamedTuple fields, tuples for sequences, None / {} / () for
    the empty nodes orbax skips, numpy arrays for stored leaves
    (torch.bfloat16 tensors for bfloat16; Python scalars for "scalar"
    leaves).

    device: where chunks are decompressed; "cuda" takes the host C
    decoder (csrc/zstd_decode.cu), which must build and load, and any
    other device the plain Python decoder. select(path tuple) -> bool, when
    given, reads only the stored leaves it accepts; the others are None in
    the tree, which keeps its whole structure."""
    meta = _metadata(path)
    store = ocdbt.KvStore(path, device=device) if meta["use_ocdbt"] else _Files(path)
    leaves, wanted = [], []
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        vm = entry["value_metadata"]
        kind = vm.get("value_type")
        names = tuple(str(k["key"]) for k in keys)
        if vm.get("skip_deserialize"):
            if kind not in EMPTY:
                raise OrbaxError(f"{path}: leaf {names} skipped with value type {kind!r}")
            leaves.append((keys, EMPTY[kind]))
        elif kind in ARRAY_TYPES or str(kind).endswith(".Array"):
            if select is not None and not select(names):
                leaves.append((keys, None))
            else:
                leaves.append((keys, str(kind)))
                wanted.append(".".join(names))
        else:
            raise OrbaxError(f"{path}: leaf {names} has value type {kind!r}")
    arrays = iter(_read_arrays(store, wanted, device))
    root: dict = {}
    for keys, value in leaves:
        if isinstance(value, str):          # a stored value's type
            value = next(arrays).item() if value == "scalar" else next(arrays)
        node = root
        for i, k in enumerate(keys):
            key_type = k.get("key_type")
            if key_type == KEY_SEQUENCE:
                key = int(k["key"])
            elif key_type == KEY_DICT:
                key = str(k["key"])
            else:
                raise OrbaxError(f"{path}: leaf {tuple(str(x['key']) for x in keys)} has "
                                 f"key type {key_type!r}")
            if i == len(keys) - 1:
                node[key] = value
                break
            nxt = keys[i + 1].get("key_type")
            child = node.get(key)
            if child is None:
                child = node[key] = _Seq() if nxt == KEY_SEQUENCE else {}
            node = child
    return _finish(root)


# -- writing -----------------------------------------------------------------

def _leaves(tree, prefix=()):
    """(key_metadata, value) pairs of a tree of dicts, NamedTuples, tuples
    and lists, in orbax's flattening order (dict keys as given)."""
    if hasattr(tree, "_fields"):
        tree = dict(zip(tree._fields, tree))
    if isinstance(tree, dict):
        if not tree:
            yield prefix, tree
        for k, v in tree.items():
            yield from _leaves(v, prefix + ((str(k), KEY_DICT),))
    elif isinstance(tree, (tuple, list)):
        if not tree:
            yield prefix, tree
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + ((str(i), KEY_SEQUENCE),))
    else:
        yield prefix, tree


def _host_array(value) -> tuple[np.ndarray, str, str]:
    """(array, zarr dtype, value type) of a stored leaf (tobytes() gives
    its C-order bytes)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy(), "bfloat16", "np.ndarray"
        return value.numpy(), value.numpy().dtype.str, "np.ndarray"
    if isinstance(value, (bool, int, float)) and not isinstance(value, np.generic):
        arr = np.asarray(value, np.int64 if isinstance(value, int) else np.float64)
        return arr, arr.dtype.str, "scalar"
    arr = np.asarray(value)
    if arr.dtype == object:
        raise TypeError(f"cannot store a leaf of type {type(value).__name__}")
    return arr, arr.dtype.str, "np.ndarray"


def write_checkpoint(path: str, tree) -> None:
    """Write `tree` (dicts, NamedTuples, tuples, lists; numpy arrays and
    scalars, torch tensors including bfloat16, Python int and float; None
    and empty nodes) as orbax's StandardSave does in its default layout
    (use_ocdbt true: the zarr keys in one OCDBT database,
    utils/ocdbt.py:write_database, a data file and a manifest where the
    plain layout makes a directory and two files an array), replacing
    `path`. The directory is written under a temporary name and renamed
    when complete."""
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_md = {}
    t0 = time.time_ns()

    def zarr_items():
        """Each array's .zarray and its one chunk, a zstd frame of raw
        blocks; tree_md filled on the way."""
        for keys, value in _leaves(tree):
            if not keys:
                raise ValueError("the checkpoint's tree must be a container")
            names = tuple(k for k, _ in keys)
            entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys]}
            tree_md[str(names)] = entry
            if value is None or (isinstance(value, (dict, tuple, list)) and not value):
                kind = ("None" if value is None else "Dict" if isinstance(value, dict)
                        else "List" if isinstance(value, list) else "Tuple")
                entry["value_metadata"] = {"value_type": kind, "skip_deserialize": True}
                continue
            arr, dtype, kind = _host_array(value)
            if arr.size == 0:
                raise ValueError(f"{names}: orbax does not store arrays with zero size")
            name = ".".join(names)
            zarray = {"chunks": list(arr.shape),
                      "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                      "filters": None, "order": "C", "shape": list(arr.shape),
                      "zarr_format": 2}
            yield f"{name}/.zarray", json.dumps(zarray, separators=(",", ":"),
                                                sort_keys=True).encode()
            chunk = ".".join("0" for _ in arr.shape) or "0"
            yield f"{name}/{chunk}", zstd.raw_frame(arr.tobytes())
            entry["value_metadata"] = {"value_type": kind, "skip_deserialize": False}

    ocdbt.write_database(tmp, zarr_items())
    # json.dumps, not json.dump: dump streams through the Python encoder,
    # which holds the interpreter lock ~0.2 s on a v5s tree (a background
    # writer's caller is training meanwhile)
    with open(os.path.join(tmp, METADATA), "w") as f:
        f.write(json.dumps({"tree_metadata": tree_md, "use_ocdbt": True,
                            "use_zarr3": False,
                            "store_array_data_equal_to_fill_value": True,
                            "custom_metadata": None}))
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)
    os.replace(tmp, path)
