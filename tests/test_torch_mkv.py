"""utils/mkv.py on the CPU: Matroska read and written as cv2 (FFMPEG's
libavformat) reads and writes it, for the JAX demo's VideoReader and its
mp4v writer.

Every frame of every fixture equals cv2.VideoCapture's bit for bit
(data/mpeg4.py's plain decoder at MPEG4_TOLERANCE zero; a V_MJPEG frame
equal to libjpeg's decode of its packet, cv2.imdecode, as the port's
Motion-JPEG AVIs equal CAP_OPENCV_MJPEG's: cv2's FFMPEG capture decodes
MJPEG otherwise, a ROADMAP known difference), and fps
and the frame count equal cv2's: files cv2 writes (mp4v, XVID and MJPG at
sizes off the MB grid and 15/24/30 fps), and files built by hand
(tests/torch_mkv_samples.py) in layouts cv2 never writes but reads: each
lacing, BlockGroups, unknown-size Segment and Clusters, V_MS/VFW/FOURCC
tracks, header stripping and zlib, an audio track first, no
DefaultDuration. MkvWriter's files read back in cv2 as the encoder's
reconstruction; `demo -p clip.mkv -o out.mkv` gives the JAX demo's
detections; VP9 WebM and H.264 in Matroska raise naming their
CodecID."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from test_torch_demo import SIZE, demo_setup  # noqa: F401  (the fixture)
from test_torch_video import same_detections
from torch_mkv_samples import bitmapinfoheader, build
from torch_mpeg4_samples import (HD_MKV, MJPEG_MKV, VIDEO_SAMPLES, moving, random_stream,
                                 raw_packets, read_cv2, write_cv2)
from vision_kit_tpu_torch.data import mpeg4
from vision_kit_tpu_torch.data.decode import decode_image, pixel_agreement
from vision_kit_tpu_torch.utils import mkv
from vision_kit_tpu_torch.utils.readers import VideoReader, open_movie

torch.set_num_threads(2)

# (name, (h, w), content, fourcc, fps, frames): sizes off the MB grid
CV2_CLIPS = [("mp4v_100x150_24.mkv", (100, 150), "pan", "mp4v", 24.0, 14),
             ("xvid_90x118_30.mkv", (90, 118), "noise", "XVID", 30.0, 5),
             ("mp4v_72x88_15.mkv", (72, 88), "static", "mp4v", 15.0, 4),
             ("mjpg_72x88_15.mkv", (72, 88), "pan", "MJPG", 15.0, 4),
             ("mjpg_100x150_30.mkv", (100, 150), "noise", "MJPG", 30.0, 3)]


@pytest.fixture(scope="module")
def cv2_clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mkv")
    out = {}
    for k, (name, (h, w), kind, fourcc, fps, n) in enumerate(CV2_CLIPS):
        path = str(tmp / name)
        write_cv2(path, moving(kind, h, w, n, seed=60 + k), fourcc, fps)
        out[name] = path
    return out


def rgb(planes) -> np.ndarray:
    return mpeg4.yuv420_to_rgb(*(torch.from_numpy(p) for p in planes)).numpy()


def port_frames(path: str) -> tuple:
    """(movie, RGB frames) by the plain decoders."""
    movie = open_movie(path)
    out = []
    with open(path, "rb") as f:
        if movie.codec == "mpeg4":
            dec = mpeg4.Mpeg4Decoder(movie.config or None, codec_tag=movie.tag)
            for i in range(len(movie.frames)):
                planes = dec.decode(movie.read_frame(f, i))
                if planes is not None:
                    out.append(rgb(planes))
        else:
            out = [decode_image(movie.read_frame(f, i)) for i in range(len(movie.frames))]
    return movie, out


def assert_as_cv2(path: str) -> mkv.MkvMovie:
    """Every frame, fps and the frame count as cv2 gives them."""
    want, count, fps = read_cv2(path)
    movie, got = port_frames(path)
    assert (movie.fps, movie.frame_count, len(got)) == (fps, count, len(want))
    if movie.codec == "mpeg4":
        for i, (g, w) in enumerate(zip(got, want)):
            a = pixel_agreement(torch.from_numpy(g), w)
            assert mpeg4.within_mpeg4_tolerance(a), (i, a)
    else:
        for i, (g, pkt) in enumerate(zip(got, raw_packets(path))):
            lib = cv2.cvtColor(cv2.imdecode(np.frombuffer(pkt, np.uint8), cv2.IMREAD_COLOR),
                               cv2.COLOR_BGR2RGB)
            assert np.array_equal(g, lib), i
    return movie


@pytest.mark.parametrize("name", [c[0] for c in CV2_CLIPS])
def test_cv2_written_clips_read_as_cv2_reads_them(cv2_clips, name):
    path = cv2_clips[name]
    movie = assert_as_cv2(path)
    assert movie.codec_id == ("V_MJPEG" if "mjpg" in name else "V_MPEG4/ISO/ASP")
    assert (movie.height, movie.width) == next(c[1] for c in CV2_CLIPS if c[0] == name)
    # the demuxed frames are cv2's packets
    with open(path, "rb") as f:
        assert [movie.read_frame(f, i) for i in range(len(movie.frames))] == raw_packets(path)


def test_committed_clips_match_their_manifest():
    """The Matroska fixtures chip_smoke reads on the card: the plain
    decoders give the manifest's frames (cv2's for mp4v, libjpeg's for
    Motion-JPEG)."""
    import hashlib

    with open(os.path.join(VIDEO_SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    for name, key in ((HD_MKV, "rgb_sha256"), (MJPEG_MKV, "imdecode_rgb_sha256")):
        meta = files[name]
        path = os.path.join(VIDEO_SAMPLES, name)
        with open(path, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == meta["sha256"]
        movie, got = port_frames(path) if name == MJPEG_MKV else (open_movie(path), None)
        if got is None:           # the 720p clip's first GOP and the next I-VOP
            dec = mpeg4.Mpeg4Decoder(movie.config)
            with open(path, "rb") as f:
                got = [rgb(dec.decode(movie.read_frame(f, i))) for i in range(9)]
        assert (movie.fps, len(movie.frames)) == (meta["fps"], meta["frames"])
        assert [hashlib.sha256(g.tobytes()).hexdigest() for g in got] == \
            meta[key][:len(got)]


def stream(seed: int = 2, n: int = 7, w: int = 80, h: int = 64) -> tuple:
    headers, vops = random_stream(seed, w, h, n)
    return headers, [v for v, _ in vops], [k for _, k in vops]


# hand-built layouts: (name, build() keyword arguments)
HAND = [("xiph", {"blocks": "xiph", "lace": 3}),
        ("ebml", {"blocks": "ebml", "lace": 3}),
        ("fixed", {"blocks": "fixed", "lace": 3}),
        ("group", {"blocks": "group"}),
        ("unknown_sizes", {"unknown_segment": True, "unknown_cluster": True,
                           "cluster_frames": 3}),
        ("vfw_xvid", {"codec_id": mkv.VFW, "fourcc": b"XVID"}),
        ("vfw_fmp4", {"codec_id": mkv.VFW, "fourcc": b"FMP4"}),
        ("header_stripping", {"encoding": (1, 3, b"\0\0\1\xb6")}),
        ("zlib", {"encoding": (3, 0, b"")}),
        ("audio_first", {"extra_tracks": True}),
        ("no_default_duration", {"fps": None}),
        ("webm_doctype", {"doc": "webm"}),
        ("read_version_3", {"read_version": 3})]


@pytest.mark.parametrize("name,kw", HAND, ids=[h[0] for h in HAND])
def test_hand_built_layouts_read_as_cv2_reads_them(tmp_path, name, kw):
    headers, frames, keys = stream()
    kw = dict(kw)
    private = headers
    if "fourcc" in kw:
        private = bitmapinfoheader(80, 64, kw.pop("fourcc"), headers)
    if name == "fixed":              # a fixed-size lace needs frames of one size
        size = max(len(f) for f in frames)
        frames = [f + bytes(size - len(f)) for f in frames]
    path = str(tmp_path / f"{name}.mkv")
    build(path, frames, keys, 80, 64, private=private, **kw)
    movie = assert_as_cv2(path)
    assert len(movie.frames) == len(frames)
    if name == "group":             # a Block without a ReferenceBlock is a keyframe
        assert movie.keyframes == keys


def test_vfw_motion_jpeg_and_rates_without_default_duration(tmp_path):
    """A V_MS/VFW/FOURCC MJPG track, and V_MJPEG tracks without a
    DefaultDuration whose timestamps keep 15, 24, 29.97 and 30 fps, where
    libavformat fits a standard rate to the timestamps."""
    from vision_kit_tpu_torch.data.encode import encode_jpeg

    jpegs = [encode_jpeg(f) for f in moving("pan", 64, 80, 12, seed=3)]
    path = str(tmp_path / "vfw_mjpg.mkv")
    build(path, jpegs[:4], [True] * 4, 80, 64, codec_id=mkv.VFW,
          private=bitmapinfoheader(80, 64, b"MJPG"))
    assert open_movie(path).codec == "mjpeg"
    assert_as_cv2(path)
    for rate in (15.0, 24.0, 30000 / 1001, 30.0):
        for n in (5, 12):
            path = str(tmp_path / f"rate_{rate:.2f}_{n}.mkv")
            build(path, jpegs[:n], [True] * n, 80, 64, codec_id="V_MJPEG", fps=None,
                  times=[round(i * 1000 / rate) for i in range(n)])
            cap = cv2.VideoCapture(path)
            assert open_movie(path).fps == cap.get(cv2.CAP_PROP_FPS), (rate, n)
            cap.release()


def test_mkv_writer_reads_back_in_cv2_as_the_reconstruction(tmp_path):
    for (h, w), fps, n in (((100, 150), 24.0, 14), ((90, 118), 30000 / 1001, 5)):
        frames = moving("pan", h, w, n, seed=5)
        enc = mpeg4.Mp4vEncoder(w, h, fps)
        path = str(tmp_path / f"out_{w}.mkv")
        recon = []
        with mkv.MkvWriter(path, fps) as out:
            for f in frames:
                vop, key = enc.encode(f)
                out.write(vop, key, w, h, enc.headers())
                recon.append(rgb(tuple(np.ascontiguousarray(p[:(h + k) >> k, :(w + k) >> k])
                                       for k, p in zip((0, 1, 1), enc.recon))))
        back, count, cfps = read_cv2(path)
        assert (count, cfps, len(back)) == (n, fps, n)
        for i, (b, r) in enumerate(zip(back, recon)):
            assert np.array_equal(b, r), i
        movie = mkv.read_mkv(path)
        assert movie.config == enc.headers() and movie.keyframes == [
            i % mpeg4.KEY_INTERVAL == 0 for i in range(n)]


def test_refusals_name_the_codec(tmp_path):
    path = str(tmp_path / "clip_VP90.webm")      # VP9 decodes (data/vp9.py)
    write_cv2(path, moving("pan", 64, 80, 2, seed=1), "VP90")
    assert len([f for ok, f in VideoReader(path, device="cpu", use_thread=False) if ok]) == 2
    av1 = str(tmp_path / "clip_AV1.webm")        # the same file, its CodecID V_AV1
    with open(path, "rb") as f, open(av1, "wb") as g:
        g.write(f.read().replace(b"V_VP9", b"V_AV1"))
    with pytest.raises(ValueError, match=r"'V_AV1' \(AV1\)"):
        VideoReader(av1, device="cpu")
    path = str(tmp_path / "clip_VP80.webm")      # VP8 decodes (data/vp8.py)
    write_cv2(path, moving("pan", 64, 80, 2, seed=1), "VP80")
    assert len([f for ok, f in VideoReader(path, device="cpu", use_thread=False) if ok]) == 2
    headers, frames, keys = stream(n=2)
    for codec_id, name in (("V_MPEG4/ISO/AVC", "H.264"), ("V_MPEGH/ISO/HEVC", "HEVC"),
                           ("V_AV1", "AV1")):
        path = str(tmp_path / "other.mkv")
        build(path, frames, keys, 80, 64, codec_id=codec_id, private=headers)
        with pytest.raises(ValueError, match=rf"'{codec_id}' \({name}\)"):
            open_movie(path)
    path = str(tmp_path / "vfw_h264.mkv")
    build(path, frames, keys, 80, 64, codec_id=mkv.VFW,
          private=bitmapinfoheader(80, 64, b"H264"))
    with pytest.raises(ValueError, match=r"'H264' \(H\.264\)"):
        open_movie(path)
    for kw, what in (({"read_version": 4}, "DocTypeReadVersion 4"),
                     ({"encoding": (1, 1, b"")}, "bzlib")):
        path = str(tmp_path / "refused.mkv")
        build(path, frames, keys, 80, 64, private=headers, **kw)
        with pytest.raises(ValueError, match=what):
            open_movie(path)
    with pytest.raises(ValueError, match="damaged Matroska"):
        path = str(tmp_path / "junk.mkv")
        with open(path, "wb") as f:
            f.write(b"\x1a\x45\xdf\xa3" + bytes(60))
        open_movie(path)
    with pytest.raises(ValueError, match="out.webm: WebM holds VP8, VP9 or AV1 only"):
        VideoReader(path, save_path=str(tmp_path / "out.webm"), device="cpu")


def test_demo_cli_on_an_mkv_matches_jax(demo_setup, tmp_path, capsys):  # noqa: F811
    """demo -p clip.mkv -o out.mkv on v5n@64 carried from JAX: each frame's
    detections equal JAX's Predictor on cv2's decode of the cv2-written
    clip (which the port's decoder equals), and out.mkv's blocks are
    Mp4vEncoder's VOPs of the drawn frames, its CodecPrivate the encoder's
    VOL, read back by cv2 as the encoder's reconstruction."""
    from test_torch_video import FPS, N_FRAMES
    from torch_samples import scene
    from vision_kit_tpu.predictor import Predictor as JaxPredictor
    from vision_kit_tpu_torch import __main__ as cli
    from vision_kit_tpu_torch.utils.drawing import Drawing

    jm, v, weights, cfg_path, _ = demo_setup
    frames = [scene(240, 320, seed=40 + i) for i in range(N_FRAMES)]
    clip, out = str(tmp_path / "clip.mkv"), str(tmp_path / "demo_out.mkv")
    write_cv2(clip, frames, "mp4v", FPS)
    results = []
    run = cli.demo_video
    cli.demo_video = lambda *a, **kw: results.append(run(*a, **kw)) or results[-1]
    try:
        assert cli.main(["demo", "-p", clip, "-o", out, "-c", cfg_path, "-w", weights,
                         "--device", "cpu"]) == 0
    finally:
        cli.demo_video = run
    (res,) = results
    assert f"over {N_FRAMES} frames" in capsys.readouterr().out
    assert res["fps"] == FPS and all(len(t) == N_FRAMES for t in res["ms"].values())
    decoded, _, _ = read_cv2(clip)
    jpred = JaxPredictor(jm, v, img_size=SIZE, approx_topk=False)
    gain = min(SIZE / 240, SIZE / 320)
    drawer = Drawing([f"c{i}" for i in range(80)])
    enc = mpeg4.Mp4vEncoder(320, 240, FPS)
    movie = mkv.read_mkv(out)
    assert (len(movie.frames), movie.fps, movie.width, movie.height) == (N_FRAMES, FPS, 320, 240)
    assert movie.config == enc.headers()
    back, count, _ = read_cv2(out)
    assert count == len(back) == N_FRAMES
    n = 0
    with open(out, "rb") as f:
        for i, (frame, dets) in enumerate(zip(decoded, res["detections"])):
            want, _ = jpred(frame)
            assert same_detections(want, dets, box_tol=1e-3 / gain), (i, want, dets)
            vop, _ = enc.encode(drawer.draw(frame, dets))
            assert movie.read_frame(f, i) == vop
            recon = rgb(tuple(np.ascontiguousarray(p[:240 >> k, :320 >> k])
                              for k, p in zip((0, 1, 1), enc.recon)))
            assert np.array_equal(recon, back[i]), i
            n += len(dets)
    assert n > 5
