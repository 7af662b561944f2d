"""data/vp9.py on the CPU: the plain VP9 decoder against cv2.VideoCapture
(libavcodec's vp9 decoder, swscale's conversion), frame for frame and bit
for bit, through the port's VideoReader: clips cv2 writes (VP90 in WebM,
Matroska, AVI, IVF and MP4), random streams that use every profile-0
option (tests/torch_vp9_samples.py's StreamWriter: backward adaptation on
and off, compound prediction with sign biases, segmentation with its tree
and temporal prediction and every feature, tile columns and rows,
intra-only frames, hidden frames in superframes and frames showing a
reference, every interpolation filter, lossless frames, odd sizes, full
range, vectors far past the edges), seeded cut and flipped frames, and the
committed fixtures; the default tables against libvpx's symbols.

cv2 runs with OPENCV_FFMPEG_THREADS=1 on the random and damaged streams
(the port follows the single-threaded decoder, as for VP8). At an odd
height cv2's RGB comes from another swscale path: such streams are held to
cv2's Y planes."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from torch_mpeg4_samples import moving
from torch_vp9_samples import (HD_WEBM, SMALL_WEBM, VIDEO_SAMPLES, StreamWriter, cut, flipped,
                               random_stream, read_cv2, read_cv2_y, rgb, superframe, webm,
                               write_cv2, write_ivf)
from vision_kit_tpu_torch.data import vp9
from vision_kit_tpu_torch.utils.readers import VideoReader, open_movie

torch.set_num_threads(2)

CONTAINERS = ("webm", "mkv", "avi", "ivf", "mp4")


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("OPENCV_FFMPEG_THREADS", "1")


def port_frames(path: str) -> tuple:
    reader = VideoReader(path, device="cpu", use_thread=False)
    return [f.numpy() for ok, f in reader if ok], reader


def assert_same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.array_equal(a, b), i


@pytest.mark.parametrize("ext", CONTAINERS)
@pytest.mark.parametrize("kind,h,w,n,fps", [("pan", 48, 64, 8, 25.0), ("pan", 54, 38, 5, 15.0)])
def test_cv2_clips(tmp_path, ext, kind, h, w, n, fps):
    path = str(tmp_path / f"clip.{ext}")
    write_cv2(path, moving(kind, h, w, n, seed=h), fps)
    want, cfps, count = read_cv2(path)
    got, reader = port_frames(path)
    assert_same(got, want)
    assert (reader.fps, len(reader), reader.decoder) == (cfps, count, "plain")
    assert open_movie(path).codec == "vp9"


def _check_stream(tmp_path, frames, shown, w, h, name="s") -> None:
    """The decoder equals the writer's own decode (the stream holds what
    the writer meant), and cv2 (its Y planes; its RGB at an even height)."""
    dec = vp9.Vp9Decoder()
    planes = [p for p in map(dec.decode, frames) if p is not None]
    assert len(planes) == len(shown)
    for p, q in zip(planes, shown):
        assert all(np.array_equal(a, b) for a, b in zip(p, q))
    path = str(tmp_path / f"{name}.ivf")
    write_ivf(path, frames, w, h)
    ys = read_cv2_y(path)
    assert len(ys) == len(shown)
    for i, (y, p) in enumerate(zip(ys, shown)):
        assert np.array_equal(y, p[0]), i
    if h % 2 == 0:
        want, _, _ = read_cv2(path)
        got, _ = port_frames(path)
        assert_same(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_random_streams(tmp_path, one_thread, seed):
    """Every option at random (see torch_vp9_samples.random_stream), in IVF
    and WebM."""
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(8, 90)), 2 * int(rng.integers(4, 36))
    frames, shown = random_stream(seed, w, h, 8, key_every=int(rng.integers(0, 6)))
    _check_stream(tmp_path, frames, shown, w, h)
    path = str(tmp_path / "s.webm")
    webm(path, frames, w, h)
    want, _, count = read_cv2(path)
    got, reader = port_frames(path)
    assert_same(got, want)
    assert len(reader) == count == len(frames)


@pytest.mark.parametrize("seed", range(10, 16))
def test_random_odd_sizes(tmp_path, one_thread, seed):
    """Odd widths and heights (intra edges past the 8-aligned frame, the
    loop filter's half superblocks), held to cv2's Y planes."""
    rng = np.random.default_rng(seed)
    w, h = 2 * int(rng.integers(4, 40)) + 1, int(rng.integers(9, 70))
    frames, shown = random_stream(seed, w, h, 6)
    _check_stream(tmp_path, frames, shown, w, h)


@pytest.mark.parametrize("seed,option", enumerate([
    dict(lossless=0.7),                                  # the WHT, tx mode ONLY_4X4
    dict(compound=1.0, error_res=0.0),                   # compound prediction, every ref context
    dict(parallel=0.0, refresh_ctx=1.0, error_res=0.0),  # backward adaptation every frame
    dict(seg=1.0, skip_feature=True),                    # segmentation with every feature
    dict(error_res=0.6),                                 # error-resilient frames
    dict(hp=1.0, parallel=1.0),                          # high-precision vectors, no adaptation
]))
def test_every_option(tmp_path, one_thread, seed, option):
    frames, shown = random_stream(300 + seed, 40, 34, 7, key_every=4, **option)
    _check_stream(tmp_path, frames, shown, 40, 34)


def test_tiles(tmp_path, one_thread):
    """Four tile columns (a 1030-pixel-wide frame) and tile rows: contexts
    cleared at each tile column, kept across tile rows."""
    frames, shown = random_stream(77, 1030, 12, 3, key_every=2, existing=0.0, hidden=0.0,
                                  intra_only=0.0, tiles=1.0)
    dec = vp9.Vp9Decoder()
    for f in frames:
        dec.decode(f)
    assert dec.h["log2_cols"] >= 1
    _check_stream(tmp_path, frames, shown, 1030, 12)


def test_superframes_and_shown_references(tmp_path, one_thread):
    """Hidden frames (a golden refresh, intra-only frames) packed with the
    next shown one into a superframe, and frames that show a reference
    slot: cv2 returns one frame a packet, and the count of packets."""
    frames, shown = random_stream(5, 32, 24, 10, hidden=0.4, intra_only=0.3, existing=0.3)
    assert any(f[-1] & 0xE0 == 0xC0 for f in frames)
    assert any(len(f) == 1 for f in frames)
    _check_stream(tmp_path, frames, shown, 32, 24)
    assert len(superframe([frames[0]])) == len(frames[0]) + 6


@pytest.mark.parametrize("seed", (20, 21))
def test_full_range(tmp_path, one_thread, seed):
    """Key frames whose color_range is set: libavcodec tags the frames
    after them AVCOL_RANGE_JPEG (an intra-only frame, BT.601 limited, tags
    those after it otherwise), and cv2 converts with swscale's full-range
    coefficients."""
    frames, shown = random_stream(seed, 48, 32, 7, key_every=3, full_range=True)
    path = str(tmp_path / "full.webm")
    webm(path, frames, 48, 32)
    want, _, _ = read_cv2(path)
    got, _ = port_frames(path)
    assert_same(got, want)
    assert np.array_equal(got[0], rgb(shown[0], True))
    assert not np.array_equal(got[0], rgb(shown[0]))


def test_damaged_frames(tmp_path, one_thread):
    """Seeded cut and flipped frames: a frame libavcodec refuses ends the
    stream in cv2 and in the port; the frames it decodes are cv2's."""
    refused = 0
    for seed in range(24):
        rng = np.random.default_rng(seed)
        w, h = int(rng.integers(8, 60)), 2 * int(rng.integers(4, 24))
        frames, _ = random_stream(seed, w, h, 5)
        i = int(rng.integers(0, 5))
        if rng.random() < 0.5:
            frames[i] = cut(frames[i], int(rng.integers(0, len(frames[i]))))
        else:
            frames[i] = flipped(frames[i], rng, int(rng.integers(1, 4)))
        path = str(tmp_path / f"damaged{seed}.ivf")
        write_ivf(path, frames, w, h)
        want, _, _ = read_cv2(path)
        got, _ = port_frames(path)
        assert_same(got, want)
        refused += len(got) < 5 - (len(frames[i]) == 0)
    assert refused >= 5


def test_empty_and_refused_packets(tmp_path, one_thread):
    """An empty packet is skipped, a refused one ends the stream (in WebM
    and IVF alike); len() stays the container's count."""
    frames, _ = random_stream(7, 32, 32, 8, hidden=0.0, existing=0.0, intra_only=0.0)
    cases = {"empty": frames[:3] + [b""] + frames[4:],
             "refused": frames[:3] + [b"\x00"] + frames[4:]}
    for name, fs in cases.items():
        for ext, write in (("ivf", write_ivf), ("webm", webm)):
            path = str(tmp_path / f"{name}.{ext}")
            write(path, fs, 32, 32)
            want, _, count = read_cv2(path)
            got, reader = port_frames(path)
            assert_same(got, want)
            assert (len(got), len(reader), count) == (3 if name == "refused" else 7, 8, 8)


def test_decoder_refusals():
    """libavcodec's refusals (Vp9Error) and the port's (Vp9Unsupported),
    each naming what it refuses."""
    frames, _ = random_stream(3, 32, 32, 2, hidden=0.0, existing=0.0, intra_only=0.0)
    key = frames[0]
    for data, kind, what in (
            (b"\x00", vp9.Vp9Error, "invalid frame marker"),
            (bytes([0xA8]), vp9.Vp9Unsupported, "VP9 profile 1"),        # show-existing headers
            (bytes([0x98]), vp9.Vp9Unsupported, "VP9 profile 2"),
            (bytes([key[0]]) + b"\x00\x00\x00" + key[4:], vp9.Vp9Error, "invalid sync code"),
            (frames[1], vp9.Vp9Error, "not all references are available"),
            (bytes([0x89]), vp9.Vp9Error, "requested reference 1 not available"),
            (bytes([0x88, 0x00]), vp9.Vp9Error, "reference 0 not available"),
            (key[:4], vp9.Vp9Error, "bitstream ended"),
            (key + bytes([0, 0xC0]), vp9.Vp9Error, "frame_marker: bitstream ended"),
            (key + bytes([len(key), 0xC0]), vp9.Vp9Error, "frame 0 too large in superframe")):
        with pytest.raises(kind, match=what):
            vp9.Vp9Decoder().decode(data)
    w = StreamWriter(4)
    data, _ = w.frame("key", True, 32, 32)
    bits = sum(n for _, _, n in w.header.fields)
    assert bits % 8
    padded = bytearray(data)
    padded[bits // 8] |= 0x80 >> (bits % 8)              # cbs_vp9 reads the padding as zeros
    with pytest.raises(vp9.Vp9Error, match="a bit that pads the uncompressed header is set"):
        vp9.Vp9Decoder().decode(bytes(padded))
    with pytest.raises(vp9.Vp9Unsupported, match="a frame of 48x32 after frames of 32x32"):
        w.frame("key", True, 48, 32)
    w = StreamWriter(4)
    w.frame("key", True, 32, 32)
    with pytest.raises(vp9.Vp9Unsupported, match="scaled motion compensation"):
        w.frame("inter", True, found_ref=0, width_minus_1=47)
    with pytest.raises(vp9.Vp9Error, match="invalid reference dimensions"):
        w.frame("inter", True, found_ref=0, width_minus_1=599)
    for cs, name in ((2, "BT.709"), (5, "BT.2020")):
        with pytest.raises(vp9.Vp9Unsupported, match=name):
            StreamWriter(5, color_spaces=(cs,)).frame("key", True, 32, 32)
    with pytest.raises(vp9.Vp9Error, match="RGB not supported in profile 0"):
        StreamWriter(5, color_spaces=(7,)).frame("key", True, 32, 32)
    with pytest.raises(vp9.Vp9Error, match="invalid frame size 0 in a superframe"):
        vp9.split_superframe(key + bytes([0xC1, 0, 0, 0xC1]))


def test_committed_fixtures():
    """The small committed clip through VideoReader and the first two
    frames of the 720x1280 one (four tile columns) through the plain
    decoder, at the sha256 of cv2's frames in MANIFEST.json."""
    with open(os.path.join(VIDEO_SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    got, reader = port_frames(os.path.join(VIDEO_SAMPLES, SMALL_WEBM))
    meta = files[SMALL_WEBM]
    assert (len(got), reader.fps) == (meta["frames"], meta["fps"])
    assert [hashlib.sha256(g.tobytes()).hexdigest() for g in got] == meta["rgb_sha256"]
    movie = open_movie(os.path.join(VIDEO_SAMPLES, HD_WEBM))
    dec = vp9.Vp9Decoder()
    with open(movie.path, "rb") as f:
        for i in range(2):
            planes = dec.decode(movie.read_frame(f, i))
            assert hashlib.sha256(rgb(planes).tobytes()).hexdigest() == \
                files[HD_WEBM]["rgb_sha256"][i]
    assert dec.h["log2_cols"] == 2


def test_tables_equal_libvpx():
    """data/vp9_tables.py against libvpx v1.15.2 in cv2's wheel: every table
    byte for byte from the symbol named beside it, each typed default's
    bytes where libvpx folds them into code, and csrc/vp9_tables.cuh the
    same tables as C arrays."""
    import torch_vp9_tables as gen
    from vision_kit_tpu_torch.data import vp9_tables

    with open(gen.OUT_CUH) as f:
        assert f.read() == gen.render_cuh()
    lib = gen.library()
    if lib is None:
        pytest.skip("no libvpx in this cv2's wheel")
    tables = gen.read_symbols(lib)
    for name, sym, dtype, shape, _ in gen.SYMBOLS:
        got = getattr(vp9_tables, name)
        assert got.dtype == np.dtype(dtype) and got.shape == shape, name
        assert got.tobytes() == tables[name][2], (name, sym)
    blob = gen.folded_blob(lib)
    for name, dtype, shape, values, pieces in gen.FOLDED:
        assert getattr(vp9_tables, name).reshape(-1).tolist() == values
        for piece in pieces:
            assert bytes(piece) in blob, (name, piece)
    with open(gen.OUT) as f:
        assert f.read() == gen.render(lib)
