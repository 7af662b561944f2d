"""The demo's video mode in the port on the CPU: data/encode.py:encode_jpeg
against cv2.imencode byte for byte, utils/avi.py and readers.VideoReader
against cv2.VideoCapture on Motion-JPEG AVIs that cv2 writes (and cv2's
readers on the ones the port writes; a clip whose frames carry no Huffman
tables), the refusals, and `python -m vision_kit_tpu_torch demo -p
clip.avi -o out.avi` and `demo -p clip.mp4 -o out.mp4` (MPEG-4 Part 2, the
JAX demo's own format) against JAX's Predictor on the same frames."""

import os
import struct

import cv2
import numpy as np
import pytest
import torch

from test_torch_demo import SIZE, demo_setup  # noqa: F401  (the fixture)
from torch_samples import scene
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu.utils.readers import VideoReader as JaxVideoReader
from vision_kit_tpu_torch import __main__ as cli
from vision_kit_tpu_torch.data.decode import decode_image, pixel_agreement
from vision_kit_tpu_torch.data.encode import encode_jpeg
from vision_kit_tpu_torch.utils.avi import AviWriter, _chunk, _list, read_avi
from vision_kit_tpu_torch.utils.drawing import Drawing
from vision_kit_tpu_torch.utils.readers import VideoReader
from vision_kit_tpu_torch.utils.stream_bench import same_detections

torch.set_num_threads(2)

SAMPLES = os.path.join(os.path.dirname(cli.__file__), "data", "samples")
BACKENDS = {"opencv_mjpeg": cv2.CAP_OPENCV_MJPEG, "ffmpeg": cv2.CAP_FFMPEG}
N_FRAMES, FPS = 5, 25.0
# FFMPEG's MJPEG decoder (the JAX VideoReader's default backend) against
# libjpeg's (cv2.imdecode, CAP_OPENCV_MJPEG, the port's plain decoder) on
# the 240x320 scenes of `clips`, per frame: largest |difference| 95, mean
# 1.37, share more than 2 apart 0.066 (OpenCV 5.0.0, avcodec 62)
FFMPEG_TOLERANCE = {"max_abs": 128, "mean_abs": 2.0, "share_over_2": 0.1}


def cv2_frames(path: str, api: int) -> tuple[list, float, float]:
    """(RGB frames, CAP_PROP_FRAME_COUNT, CAP_PROP_FPS) through one backend."""
    cap = cv2.VideoCapture(path, api)
    assert cap.isOpened(), path
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    count, fps = cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, count, fps


def read_all(reader) -> list:
    items = list(reader)
    assert items[-1] == (False, None) and all(ok for ok, _ in items[:-1])
    return [frame for _, frame in items[:-1]]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Seeded 240x320 scenes as Motion-JPEG AVIs from both of cv2's writers."""
    tmp = tmp_path_factory.mktemp("clips")
    frames = [scene(240, 320, seed=40 + i) for i in range(N_FRAMES)]
    paths = {}
    for name, api in BACKENDS.items():
        path = str(tmp / f"{name}.avi")
        writer = cv2.VideoWriter(path, api, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (320, 240))
        assert writer.isOpened()
        for rgb in frames:
            writer.write(cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        writer.release()
        paths[name] = path
    return tmp, frames, paths


@pytest.mark.parametrize("shape", [(720, 1280), (333, 517), (17, 9), (1, 1)])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_encode_jpeg_equals_cv2(shape, quality):
    if shape == (720, 1280):
        with open(os.path.join(SAMPLES, "frame0_720x1280_420_q90.jpg"), "rb") as f:
            rgb = decode_image(f.read())
    else:
        rgb = scene(*shape, seed=sum(shape))
    ok, want = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                            [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok and encode_jpeg(rgb, quality) == want.tobytes()


def test_encode_jpeg_default_and_refusals():
    rgb = np.random.default_rng(1).integers(0, 256, (31, 47, 3), dtype=np.uint8)
    _, want = cv2.imencode(".jpg", rgb[..., ::-1].copy())
    assert encode_jpeg(rgb) == want.tobytes()   # cv2's default quality, 95
    _, grey = cv2.imencode(".jpg", rgb[..., 0].copy())   # (H, W): one component
    assert encode_jpeg(rgb[..., 0].copy()) == grey.tobytes()
    with pytest.raises(ValueError, match="uint8 RGB"):
        encode_jpeg(rgb[..., :2])
    with pytest.raises(ValueError, match="uint8 RGB"):
        encode_jpeg(rgb.astype(np.float32))


@pytest.mark.parametrize("writer", sorted(BACKENDS))
@pytest.mark.parametrize("use_thread", [True, False])
def test_reader_equals_cv2_opencv_mjpeg(clips, writer, use_thread):
    """Count, fps, size and every frame bit for bit as CAP_OPENCV_MJPEG
    reads the file, threaded and not; len() is the count."""
    _, _, paths = clips
    want, count, fps = cv2_frames(paths[writer], cv2.CAP_OPENCV_MJPEG)
    reader = VideoReader(paths[writer], use_thread=use_thread, device="cpu")
    assert (len(reader), reader.fps, reader.org_width, reader.org_height) == (
        count, fps, 320, 240) == (N_FRAMES, FPS, 320, 240)
    got = read_all(reader)
    assert len(got) == len(want) == N_FRAMES
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    reader.stop()


def test_written_avi_reads_back_in_both_cv2_backends(clips):
    """The port's AVI: cv2's two readers give its count and fps, libjpeg's
    its frames, and each frame's chunk holds encode_jpeg's bytes; a dropped
    (empty) frame repeats the one before, as CAP_OPENCV_MJPEG gives it."""
    tmp, frames, _ = clips
    path = str(tmp / "port.avi")
    jpegs = [encode_jpeg(rgb) for rgb in frames]
    with AviWriter(path, 29.97) as writer:
        for i, data in enumerate(jpegs):
            writer.write(data, 320, 240)
            if i == 1:
                writer.write(b"", 320, 240)
    movie = read_avi(path)
    assert (movie.rate, movie.scale) == (2997, 100)
    with open(path, "rb") as f:
        chunks = [movie.read_frame(f, i) for i in range(len(movie.frames))]
    assert chunks == jpegs[:2] + jpegs[1:]
    for name, api in BACKENDS.items():
        got, count, fps = cv2_frames(path, api)
        assert fps == pytest.approx(29.97) and count == N_FRAMES + 1, name
    want, _, _ = cv2_frames(path, cv2.CAP_OPENCV_MJPEG)
    ours = read_all(VideoReader(path, device="cpu"))
    assert len(ours) == len(want) == N_FRAMES + 1
    for g, w in zip(ours, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_opendml_continuation_and_rec_lists(tmp_path):
    """A RIFF AVIX after the first RIFF (FFMPEG's past 1 GiB), an ix00 index,
    JUNK and a LIST rec inside movi: every frame in order, as FFMPEG counts
    them."""
    jpegs = [encode_jpeg(scene(48, 64, seed=60 + i)) for i in range(4)]
    path = tmp_path / "odml.avi"
    with AviWriter(str(path), 30.0) as writer:
        for data in jpegs[:2]:
            writer.write(data, 64, 48)
    movi = _list(b"movi", _chunk(b"ix00", bytes(32))
                 + _list(b"rec ", _chunk(b"00dc", jpegs[2])) + _chunk(b"JUNK", bytes(7))
                 + _chunk(b"01wb", bytes(5)) + _chunk(b"00dc", jpegs[3]))
    with open(path, "ab") as f:
        f.write(b"RIFF" + struct.pack("<I", len(movi) + 4) + b"AVIX" + movi)
    reader = VideoReader(str(path), device="cpu", use_thread=False)
    assert len(reader) == 4
    for got, data in zip(read_all(reader), jpegs):
        np.testing.assert_array_equal(got.numpy(), decode_image(data))
    assert len(cv2_frames(str(path), cv2.CAP_FFMPEG)[0]) == 4


def without_huffman_tables(data: bytes) -> bytes:
    """The JPEG with its DHT segments dropped, as a Motion-JPEG camera
    writes its frames (libjpeg then takes the standard tables)."""
    from vision_kit_tpu_torch.data import decode

    out = bytearray(data[:2])
    for m, a, b, end in decode._walk(data):
        if m == decode.EOI:
            out += data[a - 2:a]
        elif m != decode.DHT:
            out += data[a - 4:end if m == decode.SOS else b]
    return bytes(out)


def test_clip_without_huffman_tables_plays_to_its_end(tmp_path):
    """A Motion-JPEG AVI of the 720p frame samples without their DHTs,
    written by the port: VideoReader plays every frame, threaded and not,
    equal to CAP_OPENCV_MJPEG's bit for bit and within FFMPEG_TOLERANCE of
    FFMPEG's (the JAX reader's backend), which both read the clip."""
    frames = []
    for i in (0, 1, 2, 1):
        with open(os.path.join(SAMPLES, f"frame{i}_720x1280_420_q90.jpg"), "rb") as f:
            frames.append(without_huffman_tables(f.read()))
    path = str(tmp_path / "nodht.avi")
    with AviWriter(path, FPS) as writer:
        for data in frames:
            writer.write(data, 1280, 720)
    want, count, _ = cv2_frames(path, cv2.CAP_OPENCV_MJPEG)
    ffmpeg, _, _ = cv2_frames(path, cv2.CAP_FFMPEG)
    assert count == len(want) == len(ffmpeg) == len(frames)
    for use_thread in (True, False):
        got = read_all(VideoReader(path, use_thread=use_thread, device="cpu"))
        assert len(got) == len(frames)
        for g, w, ff in zip(got, want, ffmpeg):
            np.testing.assert_array_equal(g.numpy(), w)
            agreement = pixel_agreement(g, ff)
            assert all(agreement[k] <= v for k, v in FFMPEG_TOLERANCE.items()), agreement


def test_jax_reader_on_the_same_file(clips):
    """JAX's VideoReader (cv2's default backend, FFMPEG) on cv2's MJPEG
    file: the same count, len() and fps; its frames, decoded by FFMPEG,
    within FFMPEG_TOLERANCE of the port's (libjpeg's)."""
    _, _, paths = clips
    path = paths["opencv_mjpeg"]
    theirs = JaxVideoReader(path, use_thread=False)
    ours = VideoReader(path, device="cpu")
    assert (len(theirs), theirs.fps) == (len(ours), ours.fps) == (N_FRAMES, FPS)
    assert (theirs.org_width, theirs.org_height) == (ours.org_width, ours.org_height)
    want = [cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB) for ok, bgr in theirs if ok]
    theirs.stop()
    got = read_all(ours)
    assert len(got) == len(want) == N_FRAMES
    for g, w in zip(got, want):
        agreement = pixel_agreement(g, w)
        assert all(agreement[k] <= v for k, v in FFMPEG_TOLERANCE.items()), agreement


def test_refusals_name_what_they_refuse(clips):
    """mp4v now reads (tests/test_torch_mpeg4.py); what is still refused
    names itself: an H.264 fourcc and sample entry, a B-VOP, Matroska, a
    webcam, an output container the port does not write, nvJPEG on the
    CPU, and the card without CUDA."""
    tmp, frames, paths = clips
    for ext, fourcc in ((".mp4", "mp4v"), (".avi", "mp4v"), (".avi", "XVID")):
        path = str(tmp / f"{fourcc}{ext}")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), FPS, (320, 240))
        for rgb in frames[:2]:
            writer.write(rgb)
        writer.release()
        reader = VideoReader(path, device="cpu")      # reads now
        assert len(read_all(reader)) == 2
        with open(path, "rb") as f:
            data = f.read()
        h264 = str(tmp / f"h264_{fourcc}{ext}")
        with open(h264, "wb") as f:
            f.write(data.replace(b"mp4v", b"avc1") if ext == ".mp4" else
                    data.replace(fourcc.encode(), b"H264"))
        with pytest.raises(ValueError, match=r"avc1" if ext == ".mp4" else r"H\.264"):
            VideoReader(h264, device="cpu")
    bvop = str(tmp / "bvop.avi")
    with open(str(tmp / "mp4v.avi"), "rb") as f:
        data = f.read()
    vop = data.find(b"\0\0\1\xb6", data.find(b"\0\0\1\xb6") + 4) + 4   # the P-VOP
    with open(bvop, "wb") as f:
        f.write(data[:vop] + bytes([(data[vop] & 0x3F) | 0x80]) + data[vop + 1:])
    with pytest.raises(ValueError, match=r"B \(Advanced Simple Profile\)-VOP"):
        read_all(VideoReader(bvop, device="cpu", use_thread=False))
    from torch_mpeg4_samples import write_cv2

    webm = str(tmp / "clip.webm")
    write_cv2(webm, [np.zeros((64, 96, 3), np.uint8)] * 2, "VP90")
    assert len(read_all(VideoReader(webm, device="cpu", use_thread=False))) == 2   # VP9 decodes
    av1 = str(tmp / "av1.webm")                  # the same file, its CodecID V_AV1
    with open(webm, "rb") as f, open(av1, "wb") as g:
        g.write(f.read().replace(b"V_VP9", b"V_AV1"))
    with pytest.raises(ValueError, match=r"'V_AV1' \(AV1\)"):
        VideoReader(av1, device="cpu")
    with pytest.raises(NotImplementedError, match="webcam 0"):
        VideoReader("0", device="cpu")
    out = str(tmp / "out.webm")
    with pytest.raises(ValueError, match="out.webm: WebM holds VP8, VP9 or AV1 only"):
        VideoReader(paths["ffmpeg"], save_path=out, device="cpu")
    assert not os.path.exists(out)
    with pytest.raises(ValueError, match="nvjpeg"):
        VideoReader(paths["ffmpeg"], device="cpu", decoder="nvjpeg")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VideoReader(paths["ffmpeg"])


def test_demo_cli_on_a_clip_matches_jax(demo_setup, clips, capsys):  # noqa: F811
    """demo -p clip.avi -o out.avi on v5n@64 carried from JAX: each frame's
    detections equal JAX's Predictor on the same RGB frame, and out.avi
    holds mp4v as the JAX writer writes it (handler and biCompression
    mp4v): Mp4vEncoder's VOP of each drawn frame, the VOL headers before
    the first, which cv2 reads back as the encoder's reconstruction."""
    from torch_mpeg4_samples import read_cv2
    from vision_kit_tpu_torch.data import mpeg4

    jm, v, weights, cfg_path, _ = demo_setup
    tmp, _, paths = clips
    out = str(tmp / "demo_out.avi")
    results = []
    run = cli.demo_video
    cli.demo_video = lambda *a, **kw: results.append(run(*a, **kw)) or results[-1]
    try:
        assert cli.main(["demo", "-p", paths["opencv_mjpeg"], "-o", out, "-c", cfg_path,
                         "-w", weights, "--device", "cpu"]) == 0
    finally:
        cli.demo_video = run
    (res,) = results
    assert f"avg {sum(res['ms']['predict']) / N_FRAMES:.2f} ms/frame over {N_FRAMES} frames" in \
        capsys.readouterr().out
    assert res["fps"] == FPS and all(len(t) == N_FRAMES for t in res["ms"].values())
    frames, _, _ = cv2_frames(paths["opencv_mjpeg"], cv2.CAP_OPENCV_MJPEG)
    jpred = JaxPredictor(jm, v, img_size=SIZE, approx_topk=False)
    gain = min(SIZE / 240, SIZE / 320)
    drawer = Drawing([f"c{i}" for i in range(80)])
    movie = read_avi(out)
    assert (len(movie.frames), movie.fps, movie.width, movie.height) == (N_FRAMES, FPS, 320, 240)
    with open(out, "rb") as f:
        data = f.read()
    assert data[data.find(b"strh") + 8:][4:8] == b"mp4v"       # the handler
    assert data[data.find(b"strf") + 8:][16:20] == b"mp4v"     # biCompression
    assert movie.codec == "mpeg4" and movie.tag == b"mp4v"
    back, count, _ = read_cv2(out)
    assert count == len(back) == N_FRAMES
    enc = mpeg4.Mp4vEncoder(320, 240, FPS)
    n = 0
    with open(out, "rb") as f:
        for i, (rgb, dets) in enumerate(zip(frames, res["detections"])):
            want, _ = jpred(rgb)
            assert same_detections(want, dets, box_tol=1e-3 / gain), (i, want, dets)
            vop, _ = enc.encode(drawer.draw(rgb, dets))
            assert movie.read_frame(f, i) == (enc.headers() if i == 0 else b"") + vop
            y, u, v = (np.ascontiguousarray(p[:(240 >> k), :(320 >> k)])
                       for k, p in zip((0, 1, 1), enc.recon))
            recon = mpeg4.yuv420_to_rgb(*(torch.from_numpy(p) for p in (y, u, v))).numpy()
            assert np.array_equal(recon, back[i]), i
            n += len(dets)
    assert n > 5


def test_demo_cli_on_an_mp4_matches_jax(demo_setup, tmp_path, capsys):  # noqa: F811
    """demo -p clip.mp4 -o out.mp4 on v5n@64 carried from JAX: each frame's
    detections equal JAX's Predictor on the same RGB frame (cv2's decode of
    the cv2-written clip, which the port's decoder equals), and out.mp4
    reads back in cv2 (every frame) and in the port, equal to the encoder's
    reconstruction of each drawn frame."""
    from torch_mpeg4_samples import read_cv2, write_cv2
    from vision_kit_tpu_torch.data import mpeg4
    from vision_kit_tpu_torch.utils.mp4 import read_mp4

    jm, v, weights, cfg_path, _ = demo_setup
    frames = [scene(240, 320, seed=40 + i) for i in range(N_FRAMES)]
    clip, out = str(tmp_path / "clip.mp4"), str(tmp_path / "demo_out.mp4")
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
    dec = mpeg4.Mpeg4Decoder(enc.headers())
    movie = read_mp4(out)
    assert (len(movie.frames), movie.fps, movie.width, movie.height) == (N_FRAMES, FPS, 320, 240)
    back, count, _ = read_cv2(out)
    assert count == len(back) == N_FRAMES
    n = 0
    with open(out, "rb") as f:
        for i, (rgb, dets) in enumerate(zip(decoded, res["detections"])):
            want, _ = jpred(rgb)
            assert same_detections(want, dets, box_tol=1e-3 / gain), (i, want, dets)
            vop, _ = enc.encode(drawer.draw(rgb, dets))
            assert movie.read_frame(f, i) == vop
            planes = dec.decode(vop)
            port = mpeg4.yuv420_to_rgb(*(torch.from_numpy(p) for p in planes)).numpy()
            assert np.array_equal(port, back[i])
            n += len(dets)
    assert n > 5
