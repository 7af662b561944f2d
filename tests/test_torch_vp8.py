"""data/vp8.py on the CPU: the plain VP8 decoder against cv2.VideoCapture
(libavcodec's vp8 decoder, swscale's conversion), frame for frame and bit
for bit, through the port's VideoReader: clips cv2 writes (VP80 in WebM,
Matroska, AVI and IVF), random streams that use every option of the
syntax (tests/torch_vp8_samples.py's StreamWriter: versions 0-3, 1-8
partitions, segmentation, loop-filter deltas, golden and altref copies
with sign biases, refresh_entropy_probs 0, every mode and split, vectors
far past the edges, hidden frames, odd sizes, full range), frame-tag
mutations of cv2's own stream, seeded cut and flipped frames, and the
committed fixtures.

cv2 runs with OPENCV_FFMPEG_THREADS=1 on the random and damaged streams:
with libavcodec's frame threads its output depends on the thread count
and on timing there (a thread keeps the colour range of the last key frame
it decoded itself; a vector far above the frame reads a reference row
before its thread has filtered it), and the port follows the
single-threaded decoder. cv2's own clips decode alike either way. At an
odd height cv2's RGB comes from another swscale path (the port's MPEG-4
frames show the same known difference): such streams are held to cv2's
Y planes."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from torch_mpeg4_samples import moving
from torch_vp8_samples import (HD_WEBM, SMALL_WEBM, VIDEO_SAMPLES, StreamWriter, cut, flipped,
                               random_stream, read_cv2, read_cv2_y, rgb, webm, with_tag,
                               write_cv2, write_ivf)
from vision_kit_tpu_torch.data import vp8, webp
from vision_kit_tpu_torch.utils.readers import VideoReader, open_movie

torch.set_num_threads(2)

CONTAINERS = ("webm", "mkv", "avi", "ivf")


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


def test_stages_are_shared_with_webp():
    """WebP's VP8 key frames run on vp8.py's stages, not copies of them."""
    assert webp._BoolReader is vp8.BoolReader and webp._token_bands is vp8.token_bands
    assert webp._reconstruct is vp8.reconstruct and webp._loop_filter is vp8.loop_filter
    assert webp._mb_coeffs is vp8.mb_coeffs and webp._key_intra_modes is vp8.key_intra_modes
    for name in ("_coeffs", "_residuals", "_pred4", "_filter_lines", "_wht", "_pred_block"):
        assert not hasattr(webp, name), name


@pytest.mark.parametrize("ext", CONTAINERS)
@pytest.mark.parametrize("kind,h,w,n,fps", [("pan", 48, 64, 8, 25.0), ("noise", 96, 112, 4, 30.0),
                                           ("pan", 54, 37, 5, 15.0)])
def test_cv2_clips(tmp_path, ext, kind, h, w, n, fps):
    path = str(tmp_path / f"clip.{ext}")
    write_cv2(path, moving(kind, h, w, n, seed=h), fps)
    want, cfps, count = read_cv2(path)
    got, reader = port_frames(path)
    assert_same(got, want)
    assert (reader.fps, len(reader), reader.decoder) == (cfps, count, "plain")
    assert open_movie(path).codec == "vp8"


@pytest.mark.parametrize("seed", range(10))
def test_random_streams(tmp_path, one_thread, seed):
    """Every option at random, in IVF and WebM: the decoder equals cv2 and
    the writer's own decode (the stream holds what the writer meant)."""
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(8, 90)), 2 * int(rng.integers(4, 36))
    frames, shown = random_stream(seed, w, h, 10, versions=(0, 1, 2, 3), hidden=0.2,
                                  key_every=int(rng.integers(0, 6)))
    dec = vp8.Vp8Decoder()
    planes = [p for p in map(dec.decode, frames) if p is not None]
    assert len(planes) == len(shown) and all(
        all(np.array_equal(a, b) for a, b in zip(p, q)) for p, q in zip(planes, shown))
    for name, write in (("s.ivf", write_ivf), ("s.webm", webm)):
        path = str(tmp_path / name)
        write(path, frames, w, h)
        want, _, count = read_cv2(path)
        got, reader = port_frames(path)
        assert_same(got, want)
        assert len(reader) == count == len(frames)


@pytest.mark.parametrize("seed", range(10, 16))
def test_random_odd_sizes(tmp_path, one_thread, seed):
    """Odd widths and heights, held to cv2's Y planes and, where the height
    is even, its RGB."""
    rng = np.random.default_rng(seed)
    w, h = 2 * int(rng.integers(4, 40)) + 1, int(rng.integers(9, 70))
    frames, shown = random_stream(seed, w, h, 6, versions=(0, 1, 2, 3), hidden=0.2)
    path = str(tmp_path / "odd.ivf")
    write_ivf(path, frames, w, h)
    ys = read_cv2_y(path)
    assert len(ys) == len(shown)
    for i, (y, p) in enumerate(zip(ys, shown)):
        assert np.array_equal(y, p[0]), i
    if h % 2 == 0:
        want, _, _ = read_cv2(path)
        assert_same([rgb(p) for p in shown], want)


@pytest.mark.parametrize("seed", (20, 21))
def test_full_range(tmp_path, one_thread, seed):
    """Key frames whose clamping bit is set: libavcodec tags them and the
    frames after them AVCOL_RANGE_JPEG, and cv2 converts with swscale's
    full-range coefficients (mpeg4.FULL_RANGE_COEFFS)."""
    frames, shown = random_stream(seed, 48, 32, 7, versions=(0, 3), key_every=3,
                                  full_range=True)
    path = str(tmp_path / "full.webm")
    webm(path, frames, 48, 32)
    want, _, _ = read_cv2(path)
    got, _ = port_frames(path)
    assert_same(got, want)
    assert_same(got, [rgb(p, True) for p in shown])
    assert not np.array_equal(got[0], rgb(shown[0]))


def test_tag_mutations(tmp_path):
    """cv2's own stream with every frame's version rewritten to 1-7
    (bilinear prediction; full-pixel chroma at 3; libavcodec warns of an
    invalid profile from 4 and decodes it as 1), and with show_frame
    cleared on frame 3 (cv2 returns one frame fewer)."""
    path = str(tmp_path / "clip.ivf")
    write_cv2(path, moving("pan", 48, 64, 30, seed=5))
    movie = open_movie(path)
    with open(path, "rb") as f:
        frames = [movie.read_frame(f, i) for i in range(len(movie.frames))]
    base, _ = port_frames(path)
    for version in range(1, 8):
        out = str(tmp_path / f"v{version}.ivf")
        write_ivf(out, [with_tag(fr, version=version) for fr in frames], 64, 48)
        want, _, _ = read_cv2(out)
        got, _ = port_frames(out)
        assert_same(got, want)
        assert sum(not np.array_equal(a, b) for a, b in zip(got, base)) >= 20
    out = str(tmp_path / "hidden.ivf")
    write_ivf(out, frames[:3] + [with_tag(frames[3], show=False)] + frames[4:], 64, 48)
    want, _, count = read_cv2(out)
    got, reader = port_frames(out)
    assert_same(got, want)
    assert (len(got), len(reader), count) == (29, 30, 30)


def test_damaged_frames(tmp_path, one_thread):
    """Seeded cut and flipped frames: a frame libavcodec refuses ends the
    stream in cv2 and in the port; the frames it decodes (from partitions
    read past their end, zeros after the frame) are cv2's."""
    refused = 0
    for seed in range(40):
        rng = np.random.default_rng(seed)
        w, h = int(rng.integers(8, 70)), 2 * int(rng.integers(4, 30))
        frames, _ = random_stream(seed, w, h, 6, versions=(0, 1, 2, 3))
        i = int(rng.integers(0, 6))
        if rng.random() < 0.5:
            frames[i] = cut(frames[i], int(rng.integers(0, len(frames[i]))))
        else:
            frames[i] = flipped(frames[i], rng, int(rng.integers(1, 4)))
        path = str(tmp_path / f"damaged{seed}.ivf")
        write_ivf(path, frames, w, h)
        want, _, _ = read_cv2(path)
        got, _ = port_frames(path)
        assert_same(got, want)
        refused += len(got) < 6 - (len(frames[i]) == 0)
    assert refused >= 10


@pytest.mark.parametrize("seed", (86, 132))
def test_idct_beyond_16_bits(tmp_path, one_thread, seed):
    """Flipped bits that give coefficients past 16 bits
    (tests/torch_vp8_fuzz.py's damaged streams 86 and 132): the residuals
    wrap as libavcodec's 16-bit SSE IDCT wraps them; within range the two
    arithmetics agree."""
    from torch_vp8_fuzz import stream

    frames, w, h = stream("damaged", seed)
    path = str(tmp_path / "overflow.ivf")
    write_ivf(path, frames, w, h)
    want, _, _ = read_cv2(path)
    got, _ = port_frames(path)
    assert_same(got, want)
    rng = np.random.default_rng(seed)
    small = rng.integers(-2048, 2048, (64, 16))
    assert np.array_equal(vp8.residuals(small), vp8.residuals(small, lanes16=True))
    big = rng.integers(-32768, 32768, (64, 16))
    assert not np.array_equal(vp8.residuals(big), vp8.residuals(big, lanes16=True))


def test_empty_hidden_and_refused_frames(tmp_path, one_thread):
    """An empty frame and a hidden one are skipped, a refused one ends the
    stream (in WebM and IVF alike); len() stays the container's count."""
    frames, _ = random_stream(7, 32, 32, 8)
    cases = {"empty": frames[:3] + [b""] + frames[4:],
             "hidden": frames[:3] + [with_tag(frames[3], show=False)] + frames[4:],
             "refused": frames[:3] + [frames[3][:2]] + frames[4:]}
    for name, fs in cases.items():
        for ext, write in (("ivf", write_ivf), ("webm", webm)):
            path = str(tmp_path / f"{name}.{ext}")
            write(path, fs, 32, 32)
            want, _, count = read_cv2(path)
            got, reader = port_frames(path)
            assert_same(got, want)
            assert (len(got), len(reader), count) == (3 if name == "refused" else 7, 8, 8)


def test_decoder_refusals():
    frames, _ = random_stream(3, 32, 32, 2)
    dec = vp8.Vp8Decoder()
    dec.decode(frames[0])
    dec.decode(frames[1])
    with pytest.raises(vp8.Vp8Unsupported, match="key frame of 48x32 after frames of 32x32"):
        dec.decode(StreamWriter(4).frame(True, 48, 32)[0])
    for data, what in ((b"\x00\x00", "short of its tag"),
                       (frames[1], "a frame of 0x0"),
                       (frames[0][:3] + b"\x00" + frames[0][4:], "start code 00012a"),
                       (frames[0][:12], "first partition of")):
        with pytest.raises(vp8.Vp8Error, match=what):
            vp8.Vp8Decoder().decode(data)


def test_committed_fixtures():
    """The small committed clip through VideoReader and the first two
    frames of the 720x1280 one through the plain decoder, at the sha256 of
    cv2's frames in MANIFEST.json."""
    with open(os.path.join(VIDEO_SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    got, reader = port_frames(os.path.join(VIDEO_SAMPLES, SMALL_WEBM))
    meta = files[SMALL_WEBM]
    assert (len(got), reader.fps) == (meta["frames"], meta["fps"])
    assert [hashlib.sha256(g.tobytes()).hexdigest() for g in got] == meta["rgb_sha256"]
    movie = open_movie(os.path.join(VIDEO_SAMPLES, HD_WEBM))
    dec = vp8.Vp8Decoder()
    with open(movie.path, "rb") as f:
        for i in range(2):
            planes = dec.decode(movie.read_frame(f, i))
            assert hashlib.sha256(rgb(planes).tobytes()).hexdigest() == \
                files[HD_WEBM]["rgb_sha256"][i]
