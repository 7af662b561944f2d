"""VP8 around the decoder on the CPU: csrc/vp8_decode.cu, compiled here
with the host compiler (g++) as nvcc compiles it on the card, held to the
plain decoder (data/vp8.py) on every kind of stream, refusals and their
messages included, and to the committed 720x1280 clip's manifest; the
containers (a V_MS/VFW/FOURCC VP80 track, WebM without DefaultDuration,
IVF's header and timestamps) against cv2's fps and frame count; JAX's
VideoReader on the same files; `demo -p clip.webm` against JAX's
Predictor; VP8 in MP4 (a vp08 entry) against cv2; and the refusals (AV1,
H.264, the nvjpeg decoder)."""

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
from torch_vp8_samples import (HD_WEBM, VIDEO_SAMPLES, StreamWriter, cut, flipped,
                               random_stream, read_cv2, rgb, webm, with_tag, write_cv2, write_ivf)
from vision_kit_tpu.utils.readers import VideoReader as JaxVideoReader
from vision_kit_tpu_torch import _cuda_build
from vision_kit_tpu_torch.data import vp8
from vision_kit_tpu_torch.utils import mkv, readers
from vision_kit_tpu_torch.utils.readers import VideoReader, open_movie

torch.set_num_threads(2)


def c_library():
    """csrc/vp8_decode.cu built with g++ (host code with a C interface),
    or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"vk_vp8_{os.getpid()}.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    _cuda_build.source_path("vp8_decode"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    os.remove(out)
    return lib


@pytest.fixture(scope="module")
def c_decoder():
    lib = c_library()
    if lib is None:
        pytest.skip("no g++ to build csrc/vp8_decode.cu on the host")
    old = _cuda_build._libs.get("vp8_decode")
    _cuda_build._libs["vp8_decode"] = lib
    yield lib
    if old is None:
        _cuda_build._libs.pop("vp8_decode", None)
    else:
        _cuda_build._libs["vp8_decode"] = old


def outcomes(device: str, frames: list) -> list:
    """Each frame's planes and range, None, or its refusal (class, message)."""
    dec = vp8.Vp8Decoder(device)
    out = []
    for data in frames:
        try:
            planes = dec.decode(data)
            out.append(None if planes is None else
                       (tuple(p.tobytes() for p in planes), dec.range()))
        except vp8.Vp8Error as e:
            out.append((type(e).__name__, str(e)))
    dec.close()
    return out


def test_twin_equals_the_plain_decoder(c_decoder, tmp_path):
    """Random streams (odd sizes, every version, hidden frames, full range),
    the same streams cut and flipped, tag mutations, a size change and
    cv2's own stream: the C++ decoder's planes, ranges and refusals are
    the plain decoder's, message for message."""
    cases = []
    for seed in range(12):
        rng = np.random.default_rng(seed)
        w, h = int(rng.integers(8, 80)), int(rng.integers(8, 64))
        frames, _ = random_stream(seed, w, h, 7, versions=(0, 1, 2, 3), hidden=0.2,
                                  key_every=int(rng.integers(0, 4)), full_range=bool(seed & 1))
        cases.append(frames)
        damaged = list(frames)
        for i in range(len(damaged)):
            r = rng.random()
            if r < 0.2:
                damaged[i] = cut(damaged[i], int(rng.integers(0, len(damaged[i]) + 1)))
            elif r < 0.4:
                damaged[i] = flipped(damaged[i], rng, int(rng.integers(1, 5)))
        cases.append(damaged)
        cases.append([with_tag(f, version=int(rng.integers(0, 8))) for f in frames])
    frames, _ = random_stream(30, 32, 32, 2)
    cases.append(frames + [StreamWriter(31).frame(True, 48, 32)[0], b"", b"\x00\x00"])
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
    assert refusals >= 10
    assert vp8.c_calls() > 0


def test_twin_on_the_committed_clip(c_decoder):
    """The 720x1280 fixture through VideoReader on the C++ decoder (its
    "host_cpp" route, here with a g++ build) at cv2's sha256 on every frame."""
    with open(os.path.join(VIDEO_SAMPLES, "MANIFEST.json")) as f:
        meta = json.load(f)["files"][HD_WEBM]
    dec = vp8.Vp8Decoder("cuda")
    movie = open_movie(os.path.join(VIDEO_SAMPLES, HD_WEBM))
    with open(movie.path, "rb") as f:
        got = [hashlib.sha256(rgb(dec.decode(movie.read_frame(f, i))).tobytes()).hexdigest()
               for i in range(len(movie.frames))]
    assert got == meta["rgb_sha256"] and (movie.fps, len(got)) == (meta["fps"], meta["frames"])


def test_containers(tmp_path, monkeypatch):
    """fps and frame count as cv2 reads them: a V_MS/VFW/FOURCC VP80 track,
    WebM without DefaultDuration (libavformat's rate fit), and IVF headers
    with plausible and implausible time bases, lengths and timestamps."""
    monkeypatch.setenv("OPENCV_FFMPEG_THREADS", "1")
    frames, shown = random_stream(40, 48, 32, 12)
    want = [rgb(p) for p in shown]
    cases = []
    path = str(tmp_path / "vfw.mkv")
    build(path, frames, [not f[0] & 1 for f in frames], 48, 32, codec_id=mkv.VFW,
          private=bitmapinfoheader(48, 32, b"VP80"), fps=24.0)
    cases.append(path)
    path = str(tmp_path / "no_duration.webm")
    webm(path, frames, 48, 32, fps=None, times=[round(i * 1000 / 25) for i in range(12)])
    cases.append(path)
    for i, kw in enumerate([dict(rate=25), dict(rate=30000, scale=1001),
                            dict(rate=1000, pts=[round(t * 1000 / 30) for t in range(12)]),
                            dict(rate=90000, pts=[3000 * t for t in range(12)], length=36000),
                            dict(pts=[2 * t for t in range(12)], length=24), dict(length=0),
                            dict(length=5)]):
        path = str(tmp_path / f"case{i}.ivf")
        write_ivf(path, frames, 48, 32, **kw)
        cases.append(path)
    for path in cases:
        got_want, fps, count = read_cv2(path)
        reader = VideoReader(path, device="cpu", use_thread=False)
        got = [f.numpy() for ok, f in reader if ok]
        assert (reader.fps, len(reader)) == (fps, count), path
        assert len(got) == len(got_want) == len(want)
        assert all(np.array_equal(a, b) and np.array_equal(a, c)
                   for a, b, c in zip(got, got_want, want)), path


def test_jax_reader_reads_the_same(tmp_path):
    """JAX's VideoReader (cv2) on cv2's VP80 clips: the same frames (BGR
    there), fps and length as the port's."""
    for ext in ("webm", "mkv", "avi", "ivf"):
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
    """AV1 in WebM, Matroska, IVF and MP4 (av01), H.264 in IVF and the
    nvjpeg decoder on VP8 raise naming what they are (VP9 in WebM and IVF
    and VP8 in MP4 now open); a key frame that changes the size raises from
    the iteration."""
    from torch_mpeg4_samples import write_cv2 as write_mp4v

    path = str(tmp_path / "vp8.webm")
    write_cv2(path, moving("pan", 48, 64, 2, seed=1))
    path9 = str(tmp_path / "vp9b.webm")
    write_mp4v(path9, moving("pan", 48, 64, 2, seed=1), "VP90")
    assert open_movie(path9).codec == "vp9"      # VP9 decodes (data/vp9.py)
    av1b = str(tmp_path / "av1b.webm")           # the same file, its CodecID V_AV1
    with open(path9, "rb") as f, open(av1b, "wb") as g:
        g.write(f.read().replace(b"V_VP9", b"V_AV1"))
    with pytest.raises(ValueError, match=r"'V_AV1' \(AV1\)"):
        open_movie(av1b)
    frames, _ = random_stream(1, 32, 32, 2)
    av1 = str(tmp_path / "av1.mkv")
    build(av1, frames, [True, False], 32, 32, codec_id="V_AV1")
    with pytest.raises(ValueError, match=r"'V_AV1' \(AV1\)"):
        open_movie(av1)
    for fourcc, name in ((b"H264", "H.264"), (b"AV01", "AV1"), (b"VP90", None)):
        ivf = str(tmp_path / f"{fourcc.decode()}.ivf")
        write_ivf(ivf, frames, 32, 32)
        with open(ivf, "r+b") as f:
            f.seek(8)
            f.write(fourcc)
        if name is None:                          # VP9 opens (data/vp9.py)
            assert open_movie(ivf).codec == "vp9"
            continue
        with pytest.raises(ValueError, match=rf"'{fourcc.decode()}' \({name}\)"):
            open_movie(ivf)
    mp4 = str(tmp_path / "clip.mp4")
    write_mp4v(mp4, moving("pan", 48, 64, 2, seed=1), "mp4v")
    data = open(mp4, "rb").read()
    vp08 = str(tmp_path / "vp08.mp4")            # VP8 in MP4 opens (see test_vp8_in_mp4)
    with open(vp08, "wb") as f:
        f.write(data.replace(b"mp4v", b"vp08"))
    assert open_movie(vp08).codec == "vp8"
    av01 = str(tmp_path / "av01.mp4")
    with open(av01, "wb") as f:
        f.write(data.replace(b"mp4v", b"av01"))
    with pytest.raises(ValueError, match=r"AV1 \(av01\)"):
        open_movie(av01)
    monkeypatch.setattr(readers, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="decoder 'nvjpeg' decodes JPEGs, and this is VP8"):
        VideoReader(path, decoder="nvjpeg")
    monkeypatch.undo()
    resized = str(tmp_path / "resized.ivf")
    write_ivf(resized, frames + [StreamWriter(2).frame(True, 48, 32)[0]], 32, 32)
    reader = VideoReader(resized, device="cpu", use_thread=False)
    with pytest.raises(vp8.Vp8Unsupported, match="key frame of 48x32"):
        list(reader)


def test_demo_cli_on_a_webm_matches_jax(demo_setup, tmp_path, capsys):  # noqa: F811
    """demo -p clip.webm on v5n@64 carried from JAX: each frame's detections
    equal JAX's Predictor on cv2's decode of the cv2-written clip."""
    from test_torch_video import FPS, N_FRAMES
    from torch_samples import scene
    from vision_kit_tpu.predictor import Predictor as JaxPredictor
    from vision_kit_tpu_torch import __main__ as cli

    jm, v, weights, cfg_path, _ = demo_setup
    clip = str(tmp_path / "clip.webm")
    write_cv2(clip, [scene(240, 320, seed=50 + i) for i in range(N_FRAMES)], FPS)
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
