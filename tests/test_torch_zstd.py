"""The port's Zstandard decoders (vision_kit_tpu_torch/utils/zstd.py, the
plain one, and csrc/zstd_decode.cu, the host C++ one the card's path
takes) against the `zstandard` package (libzstd) on the CPU: equal bytes
on hypothesis inputs (repetitive, random and mixed, at levels -5 to 19,
with and without the content checksum and size, up to several blocks),
on the committed frames (data/checkpoint_samples/MANIFEST.json: sha256 of
each frame's content), and the same refusal as libzstd on truncated and
corrupted frames; a frame that names a dictionary is refused. The C
decoder is compiled here with the host compiler (g++) for the same
comparisons; on the card chip_smoke builds it with nvcc."""

import contextlib
import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vision_kit_tpu_torch import _cuda_build
from vision_kit_tpu_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "vision_kit_tpu_torch", "data", "checkpoint_samples")
LEVELS = (-5, 1, 3, 9, 19)

with open(os.path.join(SAMPLES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)
FRAMES = sorted(MANIFEST["frames"])


def frame_bytes(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def reference(data: bytes) -> bytes:
    """libzstd's decode of every frame in `data` (skippable frames passed
    over); raises zstandard.ZstdError where libzstd refuses."""
    dobj = zstandard.ZstdDecompressor()
    out, rest = [], data
    while rest:
        d = dobj.decompressobj()
        out.append(d.decompress(rest))
        if not d.eof:
            raise zstandard.ZstdError("truncated frame")
        rest = d.unused_data
    return b"".join(out)


@functools.cache
def c_library():
    """csrc/zstd_decode.cu built with g++ into the tests' temporary
    directory (host code with a C interface), or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"vk_zstd_{os.getpid()}.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    _cuda_build.source_path("zstd_decode"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    os.remove(out)              # the loaded library stays mapped
    return lib


@pytest.fixture
def c_decoder(monkeypatch):
    lib = c_library()
    if lib is None:
        pytest.skip("no g++ to build csrc/zstd_decode.cu on the host")
    monkeypatch.setitem(_cuda_build._libs, "zstd_decode", lib)
    return lib


def both(data: bytes, c_lib) -> bytes:
    """The plain and the C decode of `data`, which must agree (both bytes,
    or both a refusal of the same kind); the plain one's result."""
    try:
        plain = zstd.decompress(data)
    except zstd.ZstdError as e:
        with pytest.raises(type(e)):
            zstd.decompress(data, device="cuda")
        raise
    assert zstd.decompress(data, device="cuda") == plain
    return plain


part = st.one_of(
    st.binary(min_size=0, max_size=600),                                   # random
    st.tuples(st.binary(min_size=1, max_size=4), st.integers(1, 3000)).map(
        lambda t: t[0] * t[1]),                                            # repetitive
    st.integers(0, 2 ** 32 - 1).map(lambda s: (np.random.default_rng(s).standard_normal(
        300) * 0.05).astype(np.float32).tobytes()),                        # weights
    st.integers(0, 400).map(lambda n: b"".join(b"key%d/.zarray " % i for i in range(n))),
)


@settings(max_examples=60, derandomize=True, deadline=None)
@given(parts=st.lists(part, min_size=0, max_size=8), level=st.sampled_from(LEVELS),
       checksum=st.booleans(), size=st.booleans())
def test_plain_decoder_equals_libzstd(parts, level, checksum, size):
    data = b"".join(parts)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=size).compress(data)
    assert zstd.decompress(frame) == data == reference(frame)


@contextlib.contextmanager
def lockstep_always():
    """decompress_many's lockstep walk of the Huffman streams from one
    stream on (it takes over from LOCKSTEP_LANES streams)."""
    saved = zstd.LOCKSTEP_LANES
    zstd.LOCKSTEP_LANES = 1
    try:
        yield
    finally:
        zstd.LOCKSTEP_LANES = saved


@settings(max_examples=30, derandomize=True, deadline=None)
@given(items=st.lists(st.tuples(st.lists(part, max_size=6), st.sampled_from(LEVELS),
                                st.booleans()), min_size=1, max_size=5))
def test_lockstep_walk_equals_libzstd(items):
    """Several frames at once, their literals' streams walked together."""
    frames, want = [], []
    for parts, level, checksum in items:
        data = b"".join(parts)
        frames.append(zstandard.ZstdCompressor(level=level, write_checksum=checksum)
                      .compress(data))
        want.append(data)
    with lockstep_always():
        assert zstd.decompress_many(frames) == want


def test_lockstep_walk_on_committed_frames_and_refusals():
    frames = [frame_bytes(n) for n in FRAMES]
    want = [reference(f) for f in frames]
    with lockstep_always():
        assert zstd.decompress_many(frames) == want
        big = frame_bytes("zstd/big_l3_ck_cs.zst")
        for cut in range(0, len(big), len(big) // 40):
            with pytest.raises(zstd.ZstdError):
                zstd.decompress_many([frames[0], big[:cut]])
        bad = bytearray(frame_bytes("zstd/l19_ck_cs.zst"))
        bad[len(bad) // 2] ^= 0x08
        with pytest.raises(zstd.ZstdError):
            zstd.decompress_many([bytes(bad)])
    # a weights-like chunk of many blocks takes the lockstep walk by itself
    rng = np.random.default_rng(5)
    data = (rng.standard_normal(600_000) * 0.02).astype(np.float32).tobytes()
    frame = zstandard.ZstdCompressor(level=1).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("level", LEVELS)
def test_multi_block_frames(level):
    """Over 128 KB of content: several blocks, the Huffman table and the
    sequence tables repeated across them, matches reaching back into
    earlier blocks, 4-stream literals."""
    rng = np.random.default_rng(level + 10)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(300)]
    text = b" ".join(words[i] for i in rng.integers(0, 300, 40000))
    weights = (rng.standard_normal(30000) * 0.02).astype(np.float32).tobytes()
    data = text[:150000] + weights + text[:60000]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("name", FRAMES)
def test_committed_frames(name):
    data = frame_bytes(name)
    got = zstd.decompress(data)
    meta = MANIFEST["frames"][name]
    assert len(got) == meta["content_bytes"]
    assert hashlib.sha256(got).hexdigest() == meta["content_sha256"]
    assert got == reference(data)


def test_committed_files_match_the_manifest():
    on_disk = sorted(os.path.relpath(os.path.join(r, f), SAMPLES)
                     for r, _, files in os.walk(SAMPLES) for f in files)
    assert on_disk == sorted([*MANIFEST["files"], "MANIFEST.json"])
    total = 0
    for name, meta in MANIFEST["files"].items():
        data = frame_bytes(name)
        assert hashlib.sha256(data).hexdigest() == meta["sha256"], name
        total += len(data)
    assert total + os.path.getsize(os.path.join(SAMPLES, "MANIFEST.json")) < 400_000


@pytest.mark.parametrize("name", ["zstd/l1_ck_cs.zst", "zstd/l19_ck.zst",
                                  "zstd/pair_skippable.zst", "zstd/big_l3_ck_cs.zst"])
def test_truncated_frames_raise(name):
    """Every cut of a frame raises (never short output)."""
    data = frame_bytes(name)
    for cut in range(0, len(data), max(1, len(data) // 97)):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(data[:cut])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(data + b"\x00")


@pytest.mark.parametrize("name", ["zstd/l1_ck_cs.zst", "zstd/l9_ck.zst", "zstd/l-5_ck.zst"])
def test_corrupt_frames_refused_as_libzstd_refuses(name):
    """A flipped bit anywhere in a checksummed frame: libzstd and the plain
    decoder both refuse it, or both give the same bytes."""
    data = bytearray(frame_bytes(name))
    rng = np.random.default_rng(len(data))
    refused = 0
    for pos in rng.choice(len(data), 80, replace=False):
        bad = bytearray(data)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            want = reference(bytes(bad))
        except zstandard.ZstdError:
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(bytes(bad))
            refused += 1
            continue
        assert zstd.decompress(bytes(bad)) == want
    assert refused > 40


def dictionary_frame(dict_id: int, flag: int) -> bytes:
    """A raw-block frame whose header names dictionary `dict_id` in a
    `flag`-sized field (1, 2 or 4 bytes)."""
    fhd = 0x20 | {1: 1, 2: 2, 4: 3}[flag]
    return (zstd.MAGIC.to_bytes(4, "little") + bytes([fhd])
            + dict_id.to_bytes(flag, "little") + bytes([5])
            + (1 | (5 << 3)).to_bytes(3, "little") + b"hello")


@pytest.mark.parametrize("flag", [1, 2, 4])
def test_dictionary_frames_refused(flag):
    with pytest.raises(zstd.DictionaryError):
        zstd.decompress(dictionary_frame(7, flag))
    assert zstd.decompress(dictionary_frame(0, flag)) == b"hello"


def test_raw_frames_are_zstd():
    for data in (b"", b"x", bytes(range(256)) * 1100):
        frame = zstd.raw_frame(data)
        assert reference(frame) == data == zstd.decompress(frame)


def test_xxh64_equals_libzstd_checksums():
    """The content checksum is XXH64's low 32 bits: zstandard's frame
    trailer for contents of every length class (stripes, 8, 4, 1)."""
    rng = np.random.default_rng(3)
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")


# -- the host C decoder ------------------------------------------------------

@settings(max_examples=40, derandomize=True, deadline=None)
@given(parts=st.lists(part, min_size=0, max_size=8), level=st.sampled_from(LEVELS),
       checksum=st.booleans(), size=st.booleans())
def test_c_decoder_equals_plain(parts, level, checksum, size):
    lib = c_library()
    if lib is None:
        pytest.skip("no g++ to build csrc/zstd_decode.cu on the host")
    data = b"".join(parts)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=size).compress(data)
    _cuda_build._libs["zstd_decode"] = lib
    try:
        assert both(frame, lib) == data
    finally:
        _cuda_build._libs.pop("zstd_decode", None)


def test_c_decoder_on_committed_frames_and_refusals(c_decoder):
    before = zstd.c_calls()
    for name in FRAMES:
        assert both(frame_bytes(name), c_decoder) == reference(frame_bytes(name))
    assert zstd.c_calls() == before + len(FRAMES)
    data = frame_bytes("zstd/big_l3_ck_cs.zst")
    for cut in range(0, len(data), len(data) // 50):
        with pytest.raises(zstd.ZstdError):
            both(data[:cut], c_decoder)
    bad = bytearray(frame_bytes("zstd/l3_ck_cs.zst"))
    bad[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError):
        both(bytes(bad), c_decoder)
    for flag in (1, 2, 4):
        with pytest.raises(zstd.DictionaryError):
            both(dictionary_frame(9, flag), c_decoder)


def test_the_card_path_never_falls_back(monkeypatch):
    """device="cuda" takes the C decoder only: a library that cannot be
    built or loaded raises, and the plain decoder is not tried."""
    def no_library(name):
        raise RuntimeError(f"nvcc not found: cannot build {name}")

    monkeypatch.setattr(_cuda_build, "load", no_library)
    frame = frame_bytes("zstd/l1_ck_cs.zst")
    with pytest.raises(RuntimeError, match="zstd_decode"):
        zstd.decompress(frame, device="cuda")
    assert zstd.decompress(frame, device="cpu") == reference(frame)
