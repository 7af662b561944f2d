"""Flax's msgpack checkpoint format, read and written with the standard
library and numpy.

The JAX package writes its weights with flax.serialization.to_bytes (its
export's `.msgpack` and its Trainer's best weights) and reads them with
msgpack_restore. This module is the port's copy of that format, without
the `msgpack` or `flax` packages:

  * the tree is msgpack: maps (str or int keys), arrays, str, bin, ints,
    floats, bool and nil, with msgpack's big-endian width prefixes
    (fixmap/map16/map32, bin8/16/32, ext8/16/32, fixext1..16, ...);
  * an ndarray leaf is ext type 1 whose payload is the msgpack array
    [shape, dtype name, raw C-order bytes in the host's byte order];
  * a numpy scalar is ext type 3 with the same payload (a 0-d array), a
    Python complex ext type 2 with [real, imag];
  * a leaf over 2**30 bytes is stored as {"__msgpack_chunked_array__":
    True, "shape": {"0": d0, ...}, "chunks": {"0": flat chunk, ...}}.

numpy here has no bfloat16, so a "bfloat16" leaf is read as a
torch.bfloat16 tensor (its bytes through a uint16 view); every other leaf
is a numpy array. `to_bytes` writes numpy arrays, numpy scalars and torch
tensors (bfloat16 included) the way flax writes the same values, so the
bytes of a tree of plain dicts equal flax's.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30


# -- reading -----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack data ends at byte {len(self.data)}, inside an "
                             f"object that needs {end}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = _FIXED.get(b)
        if fixed is not None:
            return self.unpack(fixed)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(_WIDTH[b - 0xC4])))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(_WIDTH[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(_WIDTH[b - 0xDB]))]
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(_WIDTH[b - 0xDD]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(_WIDTH[b - 0xC7])
            return _ext(self.unpack(">b"), self.take(n))
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} is not used")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


_WIDTH = (">B", ">H", ">I")
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _array(payload) -> np.ndarray | torch.Tensor:
    """An ndarray ext's payload -> a numpy array (a torch.bfloat16 tensor
    for a "bfloat16" leaf)."""
    r = _Reader(payload)
    shape, name, buf = r.read()
    if r.pos != len(payload):
        raise ValueError("ndarray payload has trailing bytes")
    shape = tuple(shape)
    if name == "bfloat16":
        u16 = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(u16).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, payload):
    if code == EXT_NDARRAY:
        return _array(payload)
    if code == EXT_NPSCALAR:
        arr = _array(payload)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        real, imag = _Reader(payload).read()
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _unchunk(node):
    """Chunked-array dicts back into arrays, everywhere in the tree."""
    if isinstance(node, dict):
        if CHUNKED in node:
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def msgpack_restore(data: bytes):
    """The counterpart of flax.serialization.msgpack_restore: the tree in
    `data`, its leaves numpy arrays (torch.bfloat16 tensors for bfloat16
    leaves), numpy scalars and Python values."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


def read_file(path: str):
    """msgpack_restore of a file's bytes."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# -- writing -----------------------------------------------------------------

def _head(out: bytearray, fix: int, fix_max: int, codes: tuple, n: int) -> None:
    """A length or count prefix: the fix form below fix_max, else the
    narrowest of the 8/16/32-bit forms whose codes are given (None where the
    form does not exist)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, _WIDTH, (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _array_payload(arr) -> bytes:
    """The ndarray ext payload [shape, dtype name, bytes] of a numpy array
    or a torch tensor."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            shape, name, raw = tuple(arr.shape), "bfloat16", arr.view(torch.int16).numpy()
        else:
            arr = arr.numpy()
            shape, name, raw = arr.shape, arr.dtype.name, arr
    else:
        if arr.dtype.kind in "OV":
            raise TypeError(f"dtype {arr.dtype} is not written by flax's msgpack")
        shape, name, raw = arr.shape, arr.dtype.name, arr
    out = bytearray()
    _pack(out, [list(shape), name, np.ascontiguousarray(raw).tobytes("C")])
    return bytes(out)


def _ext_out(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        out.append(0xD4 + n.bit_length() - 1)
    else:
        _head(out, None, 0, (0xC7, 0xC8, 0xC9), n)
    out += struct.pack(">b", code)
    out += payload


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _chunk(arr) -> dict:
    """The chunked form flax gives an array leaf over MAX_CHUNK_SIZE bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = arr.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[s:s + size]
                       for j, s in enumerate(range(0, n, size))}}


def _pack(out: bytearray, x) -> None:
    t = type(x)
    if x is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if x else 0xC2)
    elif t is int:
        _int(out, x)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif t is str:
        raw = x.encode("utf-8")
        _head(out, 0xA0, 32, (0xD9, 0xDA, 0xDB), len(raw))
        out += raw
    elif t in (bytes, bytearray, memoryview):
        raw = bytes(x)
        _head(out, None, 0, (0xC4, 0xC5, 0xC6), len(raw))
        out += raw
    elif isinstance(x, Mapping):
        _head(out, 0x80, 16, (None, 0xDE, 0xDF), len(x))
        for k, v in x.items():
            if type(k) not in (str, int):
                raise TypeError(f"map key {k!r}: flax's msgpack keys are str or int")
            _pack(out, k)
            _pack(out, _chunk(v) if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE else v)
    elif t in (list, tuple):
        _head(out, 0x90, 16, (None, 0xDC, 0xDD), len(x))
        for v in x:
            _pack(out, v)
    elif _is_array(x):
        _ext_out(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _ext_out(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    elif t is complex:
        payload = bytearray()
        _pack(payload, [x.real, x.imag])
        _ext_out(out, EXT_COMPLEX, bytes(payload))
    else:
        raise TypeError(f"{t.__name__} is not written by flax's msgpack")


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def to_bytes(tree) -> bytes:
    """The counterpart of flax.serialization.to_bytes, for a tree of dicts
    (str keys) with numpy, numpy-scalar or torch-tensor leaves; arrays over
    2**30 bytes are chunked as flax chunks them."""
    out = bytearray()
    _pack(out, _chunk(tree) if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE
          else tree)
    return bytes(out)


def sorted_keys(tree):
    """`tree` with every dict's keys in sorted order, as jax.device_get (a
    tree_map) returns a JAX tree, so that to_bytes gives the bytes of
    flax's to_bytes of that tree."""
    if isinstance(tree, Mapping):
        return {k: sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


def write_file(path: str, tree) -> None:
    with open(path, "wb") as f:
        f.write(to_bytes(tree))


def variables_of(tree: Any, path: str = "") -> dict:
    """The {"params", "batch_stats"} of a restored Flax tree: the variables
    of a model, as the JAX export writes them, or the EMA tree of a JAX
    Trainer's best weights, which has the same two collections."""
    if not isinstance(tree, dict) or "params" not in tree:
        keys = list(tree)[:5] if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path}: not a Flax variables tree (no 'params'; "
                         f"top level {keys})")
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}
