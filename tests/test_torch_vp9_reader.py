"""VP9 around the decoder on the CPU: csrc/vp9_decode.cu, compiled here
with the host compiler (g++) as nvcc compiles it on the card, held to the
plain decoder (data/vp9.py) on every kind of stream, refusals and their
messages included, and to the committed clips' manifest; the containers
(a V_MS/VFW/FOURCC VP90 track, WebM without DefaultDuration, IVF's header
and timestamps, MP4's vp09) against cv2's fps and frame count; VP8 in MP4
(a vp08 sample entry with its vpcC) against cv2; JAX's VideoReader on the
same files; `demo -p clip.webm` against JAX's Predictor; and the
refusals (profiles 1-3, the nvjpeg decoder on VP9)."""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_demo import SIZE, demo_setup  # noqa: F401  (the fixture)
from test_torch_video import same_detections
from torch_mkv_samples import bitmapinfoheader, build
from torch_mpeg4_samples import moving
from torch_vp9_samples import (HD_WEBM, SMALL_WEBM, VIDEO_SAMPLES, cut, flipped, random_stream,
                               read_cv2, rgb, vpx_mp4, webm, write_cv2, write_ivf)
from vision_kit_tpu.utils.readers import VideoReader as JaxVideoReader
from vision_kit_tpu_torch import _cuda_build
from vision_kit_tpu_torch.data import vp9
from vision_kit_tpu_torch.utils import mkv, readers
from vision_kit_tpu_torch.utils.readers import VideoReader, open_movie

torch.set_num_threads(2)


def c_library():
    """csrc/vp9_decode.cu built with g++ (host code with a C interface),
    or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"vk_vp9_{os.getpid()}.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    _cuda_build.source_path("vp9_decode"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    os.remove(out)
    return lib


@pytest.fixture(scope="module")
def c_decoder():
    lib = c_library()
    if lib is None:
        pytest.skip("no g++ to build csrc/vp9_decode.cu on the host")
    old = _cuda_build._libs.get("vp9_decode")
    _cuda_build._libs["vp9_decode"] = lib
    yield lib
    if old is None:
        _cuda_build._libs.pop("vp9_decode", None)
    else:
        _cuda_build._libs["vp9_decode"] = old


def outcomes(device: str, frames: list) -> list:
    """Each packet's planes and range, None, or its refusal (class, message)."""
    dec = vp9.Vp9Decoder(device)
    out = []
    for data in frames:
        try:
            planes = dec.decode(data)
            out.append(None if planes is None else
                       (tuple(p.tobytes() for p in planes), dec.range()))
        except vp9.Vp9Error as e:
            out.append((type(e).__name__, str(e)))
    dec.close()
    return out


def test_twin_equals_the_plain_decoder(c_decoder, tmp_path):
    """Random streams (odd sizes, every option, superframes, full range),
    the same streams cut and flipped, a size change and cv2's own stream:
    the C++ decoder's planes, ranges and refusals are the plain decoder's,
    message for message."""
    cases = []
    for seed in range(10):
        rng = np.random.default_rng(seed)
        w, h = int(rng.integers(8, 80)), int(rng.integers(8, 64))
        frames, _ = random_stream(seed, w, h, 6, key_every=int(rng.integers(0, 4)),
                                  full_range=bool(seed & 1), lossless=0.2, skip_feature=True)
        cases.append(frames)
        damaged = list(frames)
        for i in range(len(damaged)):
            r = rng.random()
            if r < 0.2:
                damaged[i] = cut(damaged[i], int(rng.integers(0, len(damaged[i]) + 1)))
            elif r < 0.4:
                damaged[i] = flipped(damaged[i], rng, int(rng.integers(1, 5)))
        cases.append(damaged)
    frames, _ = random_stream(30, 32, 32, 2, hidden=0.0, existing=0.0)
    big, _ = random_stream(31, 48, 32, 1)
    cases.append(frames + big + [b"\x00", bytes([0xA8]), b"\x89", b"\x8C", frames[0][:-1] + b"\xC0"])
    path = str(tmp_path / "cv2.ivf")
    write_cv2(path, moving("noise", 64, 80, 5, seed=2))
    movie = open_movie(path)
    with open(path, "rb") as f:
        cases.append([movie.read_frame(f, i) for i in range(len(movie.frames))])
    refusals = 0
    for frames in cases:
        plain = outcomes("cpu", frames)
        assert outcomes("cuda", frames) == plain
        refusals += sum(isinstance(o, tuple) and isinstance(o[0], str) for o in plain)
    assert refusals >= 8
    assert vp9.c_calls() > 0


def test_twin_on_the_committed_clips(c_decoder):
    """Both fixtures through VideoReader's C++ decoder ("host_cpp" on the
    card, here a g++ build) at cv2's sha256 on every frame."""
    with open(os.path.join(VIDEO_SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    for name in (SMALL_WEBM, HD_WEBM):
        meta = files[name]
        dec = vp9.Vp9Decoder("cuda")
        movie = open_movie(os.path.join(VIDEO_SAMPLES, name))
        with open(movie.path, "rb") as f:
            got = [hashlib.sha256(rgb(dec.decode(movie.read_frame(f, i))).tobytes()).hexdigest()
                   for i in range(len(movie.frames))]
        assert got == meta["rgb_sha256"] and (movie.fps, len(got)) == (meta["fps"],
                                                                        meta["frames"])


def test_containers(tmp_path, monkeypatch):
    """fps and frame count as cv2 reads them: a V_MS/VFW/FOURCC VP90 track,
    WebM without DefaultDuration (libavformat's rate fit), IVF headers with
    plausible and implausible time bases and lengths, and MP4's vp09."""
    monkeypatch.setenv("OPENCV_FFMPEG_THREADS", "1")
    frames, shown = random_stream(40, 48, 32, 10, hidden=0.0, existing=0.0, intra_only=0.0)
    want = [rgb(p) for p in shown]
    keys = [not f[0] & 0x04 for f in frames]
    cases = []
    path = str(tmp_path / "vfw.mkv")
    build(path, frames, keys, 48, 32, codec_id=mkv.VFW,
          private=bitmapinfoheader(48, 32, b"VP90"), fps=24.0)
    cases.append(path)
    path = str(tmp_path / "no_duration.webm")
    webm(path, frames, 48, 32, fps=None, times=[round(i * 1000 / 25) for i in range(10)])
    cases.append(path)
    for i, kw in enumerate([dict(rate=25), dict(rate=30000, scale=1001), dict(rate=1000)]):
        path = str(tmp_path / f"case{i}.ivf")
        write_ivf(path, frames, 48, 32, **kw)
        cases.append(path)
    path = str(tmp_path / "vp09.mp4")
    vpx_mp4(path, frames, 48, 32, 20.0, b"vp09", keys)
    cases.append(path)
    for path in cases:
        got_want, fps, count = read_cv2(path)
        reader = VideoReader(path, device="cpu", use_thread=False)
        got = [f.numpy() for ok, f in reader if ok]
        assert (reader.fps, len(reader)) == (fps, count), path
        assert len(got) == len(got_want) == len(want)
        assert all(np.array_equal(a, b) and np.array_equal(a, c)
                   for a, b, c in zip(got, got_want, want)), path


def test_vp8_in_mp4(tmp_path):
    """A cv2 VP8 IVF's frames remuxed into an MP4 with a vp08 sample entry
    and its vpcC: cv2 reads it (though its writer makes none), and the
    port gives cv2's frames, fps and count."""
    import torch_vp8_samples

    src = str(tmp_path / "vp8.ivf")
    torch_vp8_samples.write_cv2(src, moving("pan", 48, 64, 7, seed=3), 25.0)
    movie = open_movie(src)
    with open(src, "rb") as f:
        frames = [movie.read_frame(f, i) for i in range(len(movie.frames))]
    path = str(tmp_path / "vp08.mp4")
    vpx_mp4(path, frames, 64, 48, 25.0, b"vp08", [not f[0] & 1 for f in frames])
    want, fps, count = read_cv2(path)
    reader = VideoReader(path, device="cpu", use_thread=False)
    got = [f.numpy() for ok, f in reader if ok]
    assert (open_movie(path).codec, reader.fps, len(reader), len(got)) == ("vp8", fps, count, 7)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_jax_reader_reads_the_same(tmp_path):
    """JAX's VideoReader (cv2) on cv2's VP90 clips: the same frames (BGR
    there), fps and length as the port's."""
    for ext in ("webm", "mkv", "avi", "ivf", "mp4"):
        path = str(tmp_path / f"clip.{ext}")
        write_cv2(path, moving("pan", 64, 80, 6, seed=9), 24.0)
        jax_reader = JaxVideoReader(path, use_thread=False)
        want = [f[..., ::-1] for ok, f in jax_reader if ok]
        reader = VideoReader(path, device="cpu")
        got = [f.numpy() for ok, f in reader if ok]
        assert (reader.fps, len(reader)) == (jax_reader.fps, len(jax_reader))
        assert len(got) == len(want) == 6
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), ext
        jax_reader.stop()


def test_refusals(tmp_path, monkeypatch):
    """A profile-1 header and a BT.709 key frame raise from the iteration,
    naming what they are; the nvjpeg decoder on VP9 raises."""
    frames, _ = random_stream(1, 32, 32, 3, hidden=0.0, existing=0.0, intra_only=0.0)
    path = str(tmp_path / "profile1.ivf")
    write_ivf(path, frames[:2] + [bytes([0xA8])], 32, 32)   # a profile-1 show-existing header
    reader = VideoReader(path, device="cpu", use_thread=False)
    with pytest.raises(vp9.Vp9Unsupported, match="VP9 profile 1"):
        list(reader)
    bt709 = str(tmp_path / "bt709.ivf")            # the key frame's color_space 1 -> 2
    key = bytearray(frames[0])
    key[4] = (key[4] & 0x1F) | (2 << 5)
    write_ivf(bt709, [bytes(key)] + frames[1:], 32, 32)
    with pytest.raises(vp9.Vp9Unsupported, match="colour space BT.709"):
        list(VideoReader(bt709, device="cpu", use_thread=False))
    monkeypatch.setattr(readers, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="decoder 'nvjpeg' decodes JPEGs, and this is VP9"):
        VideoReader(path, decoder="nvjpeg")


def test_demo_cli_on_a_webm_matches_jax(demo_setup, tmp_path, capsys):  # noqa: F811
    """demo -p clip.webm (VP9) on v5n@64 carried from JAX: each frame's
    detections equal JAX's Predictor on cv2's decode of the cv2-written
    clip."""
    from test_torch_video import FPS, N_FRAMES
    from torch_samples import scene
    from vision_kit_tpu.predictor import Predictor as JaxPredictor
    from vision_kit_tpu_torch import __main__ as cli

    jm, v, weights, cfg_path, _ = demo_setup
    clip = str(tmp_path / "clip.webm")
    write_cv2(clip, [scene(240, 320, seed=50 + i) for i in range(N_FRAMES)], FPS)
    assert open_movie(clip).codec == "vp9"
    results = []
    run = cli.demo_video
    cli.demo_video = lambda *a, **kw: results.append(run(*a, **kw)) or results[-1]
    try:
        assert cli.main(["demo", "-p", clip, "-c", cfg_path, "-w", weights,
                         "--device", "cpu"]) == 0
    finally:
        cli.demo_video = run
    (res,) = results
    assert f"over {N_FRAMES} frames" in capsys.readouterr().out
    assert res["fps"] == FPS and len(res["detections"]) == N_FRAMES
    decoded, _, _ = read_cv2(clip)
    jpred = JaxPredictor(jm, v, img_size=SIZE, approx_topk=False)
    gain = min(SIZE / 240, SIZE / 320)
    n = 0
    for i, (frame, dets) in enumerate(zip(decoded, res["detections"])):
        want, _ = jpred(frame)
        assert same_detections(want, dets, box_tol=1e-3 / gain), (i, want, dets)
        n += len(dets)
    assert n > 5
