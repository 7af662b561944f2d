"""An OCDBT key-value store, read and written without tensorstore.

An orbax checkpoint written with `use_ocdbt` (orbax's default) keeps its
zarr keys in tensorstore's OCDBT database: a copy-on-write B-tree whose
nodes and values live in data files. This module reads that format
("OCDBT on-disk format", tensorstore's kvstore/ocdbt), as this port's
tests hold it against tensorstore, and writes a new database of one
version (write_database):

  * every file (manifest, B-tree node, version tree node) is an envelope:
    a 4-byte big-endian magic, the file's u64 length, a varint format
    version (0), a varint compression (0 none, 1 zstd), the body, and a
    crc32c (Castagnoli) of everything before it, verified;
  * the manifest holds the config (uuid, manifest kind, inline-value and
    node-size limits, the version tree's arity, the compression), a
    data-file table and the version tree: the latest versions inline,
    older ones in version tree nodes. A "numbered" manifest keeps them in
    manifest.<16 digits> files beside it; the highest number is read;
  * a version names its B-tree root: (data file, offset, length) and the
    root's height. Interior nodes hold each child's first key, the
    length of the prefix all its keys share (stripped from the keys in
    the child) and the child's location; leaves hold each key and its
    value, inline in the node or a (data file, offset, length) reference;
  * every field is stored column-wise: all entries' first field, then all
    entries' second, and so on; numbers are LEB128 varints, commit times
    u64; keys are prefix-compressed against the entry before;
  * a data file is base path + relative path, relative to the database's
    directory (so a merged checkpoint's root node reaches into
    ocdbt.process_N/d/).

Values are read by seek, not by loading whole data files. Nodes and
manifests decompress through utils/zstd.py on `device` (the host C
decoder on "cuda").
"""

from __future__ import annotations

import os
import re
import struct
import time
from dataclasses import dataclass

from vision_kit_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_NODE_MAGIC = 0x0CDB1234
NO_ROOT = (1 << 64) - 1          # the offset and length of an empty tree's root


class OcdbtError(ValueError):
    """Bytes that are not a valid OCDBT database of a kind this reader takes."""


# -- crc32c (Castagnoli) -----------------------------------------------------

def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- byte cursor -------------------------------------------------------------

class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: ends inside a field")

    def u8(self) -> int:
        self.need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def u64(self) -> int:
        self.need(8)
        self.pos += 8
        return struct.unpack_from("<Q", self.data, self.pos - 8)[0]

    def i32(self) -> int:
        self.need(4)
        self.pos += 4
        return struct.unpack_from("<i", self.data, self.pos - 4)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint over 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        self.need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} bytes after "
                             "its last field")


def decode_envelope(data: bytes, magic: int, what: str, device="cpu") -> bytes:
    """The body of an OCDBT file (manifest or node), its checksum verified
    and decompressed."""
    if len(data) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{what}: {len(data)} bytes, too short for an OCDBT file")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{what}: length field {length}, file has {len(data)} bytes")
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    if crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{what}: crc32c mismatch")
    c = _Cursor(data[:-4], what)
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (this reader takes 0)")
    body = data[c.pos:-4]
    if compression == 1:
        return zstd.decompress(body, device=device)
    if compression != 0:
        raise OcdbtError(f"{what}: compression {compression} (0 none or 1 zstd)")
    return body


# -- the formats -------------------------------------------------------------

@dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int            # 0 single, 1 numbered
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: str              # "none" or "zstd"
    zstd_level: int | None


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: tuple[str, int, int] | None     # (data file, offset, length); None: empty
    num_keys: int
    commit_time: int


def _config(c: _Cursor) -> Config:
    uuid = c.take(16)
    kind = c.varint()
    max_inline, max_node = c.varint(), c.varint()
    arity = c.u8()
    method = c.varint()
    if method == 0:
        comp, level = "none", None
    elif method == 1:
        comp, level = "zstd", c.i32()
    else:
        raise OcdbtError(f"{c.what}: compression method {method} in the config")
    if kind not in (0, 1):
        raise OcdbtError(f"{c.what}: manifest kind {kind}")
    return Config(uuid, kind, max_inline, max_node, arity, comp, level)


def _data_files(c: _Cursor) -> list[str]:
    n = c.varint()
    prefix = c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        shared = prefix[i - 1] if i else 0
        if shared > len(prev):
            raise OcdbtError(f"{c.what}: data file path shares more than the one before")
        path = prev[:shared] + c.take(suffix[i])
        if base[i] > len(path):
            raise OcdbtError(f"{c.what}: data file base path longer than its path")
        paths.append(path.decode())
        prev = path
    return paths


def _location(files: list[str], file_id: int, offset: int, length: int, what: str):
    if offset == NO_ROOT and length == NO_ROOT:
        return None
    if file_id >= len(files):
        raise OcdbtError(f"{what}: data file {file_id} of {len(files)}")
    return files[file_id], offset, length


def _version_leaves(c: _Cursor, files: list[str]) -> list[Version]:
    n = c.varint()
    gen = c.varints(n)
    height = [c.u8() for _ in range(n)]
    file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
    num_keys = c.varints(n)
    c.varints(n)                  # num_tree_bytes
    c.varints(n)                  # num_indirect_value_bytes
    commit = [c.u64() for _ in range(n)]
    return [Version(gen[i], height[i], _location(files, file_id[i], offset[i], length[i],
                                                 c.what), num_keys[i], commit[i])
            for i in range(n)]


def _version_refs(c: _Cursor, files: list[str], height: int | None):
    """Version tree node references: [(generation, location, height)];
    `height` is the children's height in a version node (None in the
    manifest, which stores a height for each)."""
    n = c.varint()
    gen = c.varints(n)
    file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
    c.varints(n)                  # num_generations
    [c.u64() for _ in range(n)]   # commit times
    heights = [c.u8() for _ in range(n)] if height is None else [height] * n
    return [(gen[i], _location(files, file_id[i], offset[i], length[i], c.what), heights[i])
            for i in range(n)]


class KvStore:
    """The latest version of the OCDBT database in directory `root`:
    keys() in order, read(key), items()."""

    def __init__(self, root: str, device="cpu"):
        self.root, self.device = root, device
        self.config, versions, nodes = self._manifest()
        self.version = self._latest(versions, nodes)
        self._entries = None

    # -- manifest and versions
    def _file(self, name: str, what: str) -> bytes:
        path = os.path.join(self.root, name)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise OcdbtError(f"{what}: {path} is missing") from None

    def _manifest(self):
        body = decode_envelope(self._file("manifest.ocdbt", "manifest"), MANIFEST_MAGIC,
                               f"{self.root}/manifest.ocdbt", self.device)
        c = _Cursor(body, f"{self.root}/manifest.ocdbt")
        config = _config(c)
        if config.manifest_kind == 1:
            c.end()
            numbered = sorted(n for n in os.listdir(self.root)
                              if re.fullmatch(r"manifest\.[0-9a-f]{16}", n))
            if not numbered:
                raise OcdbtError(f"{self.root}: a numbered manifest with no "
                                 "manifest.<number> file")
            name = numbered[-1]
            body = decode_envelope(self._file(name, "manifest"), MANIFEST_MAGIC,
                                   f"{self.root}/{name}", self.device)
            c = _Cursor(body, f"{self.root}/{name}")
            if _config(c).uuid != config.uuid:     # written with kind 0 (single)
                raise OcdbtError(f"{self.root}/{name}: another database's manifest")
        files = _data_files(c)
        versions = _version_leaves(c, files)
        nodes = _version_refs(c, files, None)
        c.end()
        return config, versions, nodes

    def _latest(self, versions: list[Version], nodes) -> Version:
        best = max(versions, key=lambda v: v.generation, default=None)
        node_gen = max((g for g, _, _ in nodes), default=-1)
        if best is not None and best.generation > node_gen:
            return best
        # the latest generation sits in a version tree node
        gen, loc, height = max(nodes, key=lambda r: r[0])
        while True:
            if loc is None:
                raise OcdbtError(f"{self.root}: version tree node without a location")
            body = self._node(loc, VERSION_NODE_MAGIC, "version tree node")
            c = _Cursor(body, f"version tree node in {loc[0]}")
            c.u8()                               # arity log2
            h = c.u8()
            files = _data_files(c)
            if h == 0:
                leaves = _version_leaves(c, files)
                c.end()
                return max(leaves, key=lambda v: v.generation)
            gen, loc, height = max(_version_refs(c, files, h - 1), key=lambda r: r[0])
            c.end()

    # -- B-tree
    def _read_at(self, path: str, offset: int, length: int) -> bytes:
        full = os.path.join(self.root, path)
        try:
            with open(full, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except FileNotFoundError:
            raise OcdbtError(f"{self.root}: data file {path} is missing") from None
        if len(data) != length:
            raise OcdbtError(f"{self.root}: {path} ends before byte {offset + length}")
        return data

    def _node(self, loc, magic: int, what: str) -> bytes:
        path, offset, length = loc
        return decode_envelope(self._read_at(path, offset, length), magic,
                               f"{what} in {path}@{offset}", self.device)

    def _walk(self, loc, height: int, prefix: bytes, out: list) -> None:
        body = self._node(loc, BTREE_MAGIC, "B-tree node")
        c = _Cursor(body, f"B-tree node in {loc[0]}@{loc[1]}")
        h = c.u8()
        if h != height:
            raise OcdbtError(f"{c.what}: height {h}, its parent says {height}")
        files = _data_files(c)
        n = c.varint()
        if n == 0:
            raise OcdbtError(f"{c.what}: a node with no entries")
        shared = c.varints(n - 1)
        suffix = c.varints(n)
        common = c.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            k = shared[i - 1] if i else 0
            if k > len(prev):
                raise OcdbtError(f"{c.what}: key shares more than the key before")
            prev = prev[:k] + c.take(suffix[i])
            keys.append(prev)
        if height:
            file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
            c.varints(n), c.varints(n), c.varints(n)     # the subtrees' statistics
            c.end()
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise OcdbtError(f"{c.what}: subtree prefix longer than its key")
                child = _location(files, file_id[i], offset[i], length[i], c.what)
                if child is None:
                    raise OcdbtError(f"{c.what}: a child without a location")
                self._walk(child, height - 1, prefix + keys[i][:common[i]], out)
            return
        lengths = c.varints(n)
        kinds = c.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{c.what}: value kind other than 0 (inline) or 1")
        file_id = c.varints(len(indirect))
        offset = c.varints(len(indirect))
        refs = dict(zip(indirect, zip(file_id, offset)))
        for i in range(n):
            if kinds[i] == 0:
                value = c.take(lengths[i])
            else:
                fid, off = refs[i]
                value = _location(files, fid, off, lengths[i], c.what)
                if value is None:
                    raise OcdbtError(f"{c.what}: an indirect value without a location")
            out.append((prefix + keys[i], value))
        c.end()

    def _all(self) -> list:
        if self._entries is None:
            out: list = []
            if self.version.root is not None:
                self._walk(self.version.root, self.version.root_height, b"", out)
            if len(out) != self.version.num_keys:
                raise OcdbtError(f"{self.root}: {len(out)} keys, the version says "
                                 f"{self.version.num_keys}")
            keys = [k for k, _ in out]
            if any(a >= b for a, b in zip(keys, keys[1:])):
                raise OcdbtError(f"{self.root}: keys out of order")
            self._entries = {k.decode(): v for k, v in out}
        return self._entries

    def keys(self) -> list[str]:
        return list(self._all())

    def read(self, key: str) -> bytes | None:
        """The value of `key`, None when the database does not hold it."""
        value = self._all().get(key)
        if value is None or isinstance(value, bytes):
            return value
        return self._read_at(*value)

    def items(self):
        for key in self._all():
            yield key, self.read(key)


# -- writing -----------------------------------------------------------------

# tensorstore's defaults for a new database
MAX_INLINE_VALUE_BYTES = 100
MAX_DECODED_NODE_BYTES = 8 << 20
VERSION_TREE_ARITY_LOG2 = 4


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def encode_envelope(magic: int, body: bytes) -> bytes:
    """decode_envelope's inverse: the body uncompressed (compression 0)."""
    head = struct.pack(">I", magic) + struct.pack("<Q", 4 + 8 + 2 + len(body) + 4)
    data = head + _varint(0) + _varint(0) + body
    return data + struct.pack("<I", crc32c(data))


def _data_file_table(paths: list[str]) -> bytes:
    """_data_files' inverse for paths with no base path and no shared
    prefix recorded (both valid; tensorstore shares what it finds)."""
    raw = [p.encode() for p in paths]
    return (_varint(len(raw)) + _varints([0] * max(len(raw) - 1, 0))
            + _varints(len(r) for r in raw) + _varints([0] * len(raw)) + b"".join(raw))


def write_database(root: str, items) -> int:
    """Write a new OCDBT database of one version into the empty directory
    `root`: manifest.ocdbt and one data file d/<32 hex digits> holding the
    values (a value of up to MAX_INLINE_VALUE_BYTES inline in its leaf
    instead) and then the B-tree, a single leaf of every key in byte order.
    `items` yields (key str, value bytes), each key once, in any order; the
    values are written as they come. No compression, tensorstore's default
    limits. Returns the data file's size."""
    name = "d/" + os.urandom(16).hex()
    os.makedirs(os.path.join(root, "d"))
    entries = {}
    indirect_bytes = 0
    with open(os.path.join(root, name), "wb") as f:
        offset = 0
        for key, value in items:
            key = key.encode()
            if key in entries:
                raise ValueError(f"key {key!r} given twice")
            if len(value) <= MAX_INLINE_VALUE_BYTES:
                entries[key] = bytes(value)
            else:
                f.write(value)
                entries[key] = (offset, len(value))
                offset += len(value)
                indirect_bytes += len(value)
        if not entries:
            raise ValueError("write_database writes at least one key")
        keys = sorted(entries)
        shared = [0] + [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
        refs = [entries[k] for k in keys]
        body = (bytes([0]) + _data_file_table([name]) + _varint(len(keys))
                + _varints(shared[1:]) + _varints(len(k) - s for k, s in zip(keys, shared))
                + b"".join(k[s:] for k, s in zip(keys, shared))
                + _varints(len(r) if isinstance(r, bytes) else r[1] for r in refs)
                + _varints(0 if isinstance(r, bytes) else 1 for r in refs)
                + _varints(0 for r in refs if not isinstance(r, bytes))
                + _varints(r[0] for r in refs if not isinstance(r, bytes))
                + b"".join(r for r in refs if isinstance(r, bytes)))
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"{len(keys)} keys make a {len(body)}-byte leaf, over "
                             f"{MAX_DECODED_NODE_BYTES}: split B-trees are not written")
        node = encode_envelope(BTREE_MAGIC, body)
        f.write(node)
    config = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
              + _varint(0))
    version = (_varint(1) + _varint(1) + bytes([0]) + _varint(0) + _varint(offset)
               + _varint(len(node)) + _varint(len(keys)) + _varint(len(node))
               + _varint(indirect_bytes) + struct.pack("<Q", time.time_ns()))
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(encode_envelope(MANIFEST_MAGIC, config + _data_file_table([name])
                                + version + _varint(0)))
    return offset + len(node)
