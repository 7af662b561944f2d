"""The video files whose codec the port already decoded behind tags and
containers it refused, on the CPU: VideoReader (utils/readers.py) on every
(fourcc, extension) that cv2.VideoWriter writes and cv2.VideoCapture reads
back here (tests/torch_video_tag_samples.py's PAIRS) against the JAX
package's VideoReader (cv2) on the same file, and on the files cv2 reads no
frame from (EMPTY); the new demultiplexers (utils/mjpeg.py, utils/y4m.py),
data/rawvideo.py and data/jp2.py's video mode (the plain decoder and its
g++-built C++ twin) on their own; the committed fixtures the card reads
against cv2; and `demo -p` on a raw I420 AVI and a Motion JPEG 2000 .mov
against JAX's Predictor."""

import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest
import torch

from test_torch_demo import REPO, SIZE
from test_torch_eval import spread_v5n
from test_torch_jp2 import twin  # noqa: F401  (the fixture)
from test_torch_video import FFMPEG_TOLERANCE
from torch_mpeg4_samples import read_cv2, write_cv2
from torch_samples import scene
from torch_video_tag_samples import EMPTY, FPS, PAIRS, TAG_SAMPLES, clip
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu.utils.readers import VideoReader as JaxVideoReader
from vision_kit_tpu_torch import __main__ as cli
from vision_kit_tpu_torch.data import decode, jp2, rawvideo
from vision_kit_tpu_torch.data.decode import decode_image, pixel_agreement
from vision_kit_tpu_torch.utils import mjpeg, video_bench as vb
from vision_kit_tpu_torch.utils.readers import VideoReader, open_movie
from vision_kit_tpu_torch.utils.stream_bench import same_detections
from vision_kit_tpu_torch.utils.y4m import read_y4m

torch.set_num_threads(2)

H, W, N = 64, 96, 3


@pytest.fixture(scope="module")
def spread_demo(tmp_path_factory):
    """test_torch_eval's spread_v5n (v5n@64 with its BatchNorm shifts zeroed:
    neighbouring anchors' scores lie apart, so no near-tie at NMS or the
    max_det cut turns on the frameworks' f32 rounding; the Motion JPEG 2000
    frames, a few levels off cv2's, made such ties with jax_v5's weights) as
    a Flax msgpack, and test_torch_demo's config naming it."""
    import yaml
    from flax import serialization

    jm, v = spread_v5n()
    tmp = tmp_path_factory.mktemp("tags_demo")
    weights = str(tmp / "v5n.msgpack")
    with open(weights, "wb") as f:
        f.write(serialization.to_bytes(v))
    with open(os.path.join(REPO, "configs", "yolov5.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(version="n", num_classes=80, input_size=[SIZE, SIZE])
    cfg["data"]["class_labels"] = [f"c{i}" for i in range(80)]
    cfg_path = str(tmp / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return jm, v, weights, cfg_path


def frames_for(codec: str, seed: int) -> list:
    """Noise, or for Motion-JPEG a panning 240x320 scene, the kind and size
    FFMPEG_TOLERANCE was measured at (libavcodec's MJPEG decoder lies
    further from libjpeg's on a busier 96x64 scene: mean 2.6-2.8 levels,
    share over 2 0.21-0.23, largest 73)."""
    if codec == "mjpeg":
        return clip(240, 320, N, seed)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(N)]


def jax_read(path: str) -> tuple:
    """(RGB frames, total_frames, fps, (org_width, org_height)) of the JAX
    package's VideoReader."""
    reader = JaxVideoReader(path, use_thread=False)
    frames = [cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB) for ok, bgr in reader if ok]
    reader.stop()
    return frames, reader.total_frames, reader.fps, (reader.org_width, reader.org_height)


def port_read(path: str, use_thread: bool = True, **kw) -> tuple:
    reader = VideoReader(path, use_thread=use_thread, device="cpu", **kw)
    items = list(iter(reader))          # len() raises for cv2's negative counts
    assert items[-1] == (False, None) and all(ok for ok, _ in items[:-1])
    reader.stop()
    frames = [f.numpy() for _, f in items[:-1]]
    return frames, reader.total_frames, reader.fps, (reader.org_width, reader.org_height)


def within(got: np.ndarray, want: np.ndarray, tolerance: dict) -> bool:
    agreement = pixel_agreement(torch.from_numpy(got), want)
    return all(agreement[k] <= v for k, v in tolerance.items())


@pytest.mark.parametrize("fourcc,ext,codec", PAIRS, ids=[f"{c.strip()}{e}" for c, e, _ in PAIRS])
def test_reads_as_cv2(tmp_path, fourcc, ext, codec):
    """Count, fps, size and frames as the JAX reader (cv2) gives them:
    raw, PNG, MPEG-4 Part 2 and Motion JPEG 2000 bit for bit; Motion-JPEG
    within FFMPEG_TOLERANCE (libavcodec's decoder against libjpeg's) and
    equal to decode_image of each frame's bytes."""
    path = str(tmp_path / f"clip{ext}")
    write_cv2(path, frames_for(codec, sum(map(ord, fourcc + ext))), fourcc, FPS)
    want, count, fps, size = jax_read(path)
    got, got_count, got_fps, got_size = port_read(path)
    assert open_movie(path).codec == codec
    assert (got_count, got_fps, got_size) == (count, fps, size) and len(want) == N
    assert len(got) == len(want)
    if codec != "mjpeg":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert all(within(g, w, FFMPEG_TOLERANCE) for g, w in zip(got, want))
        movie = open_movie(path)
        with open(path, "rb") as f:
            for i, g in enumerate(got):
                np.testing.assert_array_equal(g, decode_image(movie.read_frame(f, i)))
    unthreaded, *_ = port_read(path, use_thread=False)
    assert all(np.array_equal(a, b) for a, b in zip(unthreaded, got))


@pytest.mark.parametrize("fourcc,ext", EMPTY, ids=[f"{c}{e}" for c, e in EMPTY])
def test_files_cv2_reads_no_frame_from(tmp_path, fourcc, ext):
    """UYVY and YUY2 AVIs (packets of I420 planes, short of a frame) and
    I420/IYUV/Y800 QuickTime files (a 'raw ' entry of depth 12, which cv2
    does not open): no frame and no error, the JAX reader's count, fps and
    size (-1 where cv2 opened nothing)."""
    path = str(tmp_path / f"clip{ext}")
    write_cv2(path, frames_for("raw", 1), fourcc, FPS)
    want, count, fps, size = jax_read(path)
    got, got_count, got_fps, got_size = port_read(path)
    assert want == got == [] and (got_count, got_fps, got_size) == (count, fps, size)


def test_demo_on_files_without_frames(spread_demo, tmp_path, capsys):
    """`demo -p` on each EMPTY file ends without a frame and exits 0."""
    _, _, weights, cfg_path = spread_demo
    for fourcc, ext in EMPTY:
        path = str(tmp_path / f"{fourcc}{ext}")
        write_cv2(path, frames_for("raw", 1), fourcc, FPS)
        assert cli.main(["demo", "-p", path, "-c", cfg_path, "-w", weights,
                         "--device", "cpu"]) == 0
    assert "frames" not in capsys.readouterr().out


def test_raw_motion_jpeg_frames_split_as_libavcodec():
    """utils/mjpeg.py's parser: a frame starts at an SOI followed by a
    marker; an SOI inside a marker segment (an EXIF thumbnail), stuffed
    bytes and RSTs start nothing; cv2's fps and its estimate of the count."""
    ok, a = cv2.imencode(".jpg", np.full((16, 24, 3), 90, np.uint8))
    ok2, b = cv2.imencode(".jpg", np.full((16, 24, 3), 200, np.uint8),
                          [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    a, b = a.tobytes(), b.tobytes()
    thumb = b"Exif\0\0" + a                     # a whole JPEG inside APP1
    with_thumb = a[:2] + b"\xff\xe1" + struct.pack(">H", len(thumb) + 2) + thumb + a[2:]
    data = a + with_thumb + b
    assert mjpeg.frame_starts(data) == [0, len(a), len(a) + len(with_thumb)]
    assert mjpeg.frame_starts(b"\xff\xd8\xff") == [] and mjpeg.FRAME_COUNT == -192153584101141
    assert mjpeg.RATE == 25.0


def test_mjpeg_file_with_a_thumbnail_reads_as_cv2(tmp_path):
    ok, a = cv2.imencode(".jpg", clip(240, 320, 1, 5)[0][..., ::-1].copy())
    a = a.tobytes()
    thumb = b"Exif\0\0" + a
    path = str(tmp_path / "thumb.mjpeg")
    with open(path, "wb") as f:
        f.write((a[:2] + b"\xff\xe1" + struct.pack(">H", len(thumb) + 2) + thumb + a[2:]) * 2)
    want, count, fps, size = jax_read(path)
    got, got_count, got_fps, got_size = port_read(path)
    # libavformat's jpeg_pipe demuxer wins this file's probe (cv2 counts
    # INT64_MIN frames); the port counts as the mjpeg demuxer, which cv2's
    # own .mjpeg files get (ROADMAP, Known differences)
    assert count == -(1 << 63) and got_count == mjpeg.FRAME_COUNT
    assert len(got) == len(want) == 2 and (got_fps, got_size) == (fps, size)
    assert all(within(g, w, FFMPEG_TOLERANCE) for g, w in zip(got, want))


def y4m_file(path: str, header: str, frames: list) -> None:
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 {header}\n".encode())
        for data in frames:
            f.write(b"FRAME\n" + data)


@pytest.mark.parametrize("header", ["W48 H32 F30000:1001 C420mpeg2",
                                    "W48 H32 F25:1 C420paldv XCOLORRANGE=FULL",
                                    "W48 H32 F12:1 Cmono", "W48 H32 F24:1 Ip A1:1"])
def test_y4m_headers_as_cv2(tmp_path, header):
    """Hand-written YUV4MPEG2 headers: 4:2:0 under its names (full range
    too), grey, no C (4:2:0), frame parameters, a frame cut short at the
    end; cv2's count, fps and frames bit for bit."""
    rng = np.random.default_rng(len(header))
    size = rawvideo.frame_bytes("gray" if "mono" in header else "yuv420p", 48, 32)
    frames = [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(3)]
    path = str(tmp_path / "hand.y4m")
    y4m_file(path, header, frames)
    with open(path, "ab") as f:
        f.write(b"FRAME Ixyz\n" + frames[0][:size // 2])      # cut short
    want, count, fps, size_ = jax_read(path)
    got, got_count, got_fps, got_size = port_read(path)
    assert (got_count, got_fps, got_size) == (count, fps, size_) and len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_refusals_name_the_layout(tmp_path):
    """Layouts cv2 converts and the port does not raise naming them."""
    path = str(tmp_path / "c444.y4m")
    y4m_file(path, "W16 H16 F25:1 C444", [bytes(16 * 16 * 3)])
    with pytest.raises(ValueError, match="C444"):
        read_y4m(path)
    nv12 = bytes(rawvideo.frame_bytes("nv12", 16, 16))
    with pytest.raises(rawvideo.RawVideoUnsupported, match="nv12"):
        rawvideo.to_rgb(nv12, "nv12", 16, 16)
    assert rawvideo.to_rgb(nv12[:-1], "nv12", 16, 16) is None       # short: skipped
    path = str(tmp_path / "nv12.avi")
    write_cv2(path, frames_for("raw", 2), "NV12", FPS)
    with pytest.raises(rawvideo.RawVideoUnsupported, match="nv12"):
        port_read(path)
    mov = str(tmp_path / "i420.mov")          # 'raw ' of depth 12: cv2 opens nothing
    write_cv2(mov, frames_for("raw", 2), "I420", FPS)
    data = open(mov, "rb").read()
    at = data.find(b"raw ") + 4 + 74
    deep = str(tmp_path / "rgb24.mov")
    with open(deep, "wb") as f:
        f.write(data[:at] + struct.pack(">H", 24) + data[at + 2:])
    with pytest.raises(ValueError, match=r"'raw ' of depth 24 \(rgb24\)"):
        open_movie(deep)


def test_jp2_video_mode_and_its_twin(tmp_path, twin):  # noqa: F811
    """A Motion JPEG 2000 frame (4:2:0) is refused by decode_image, as
    cv2.imdecode refuses it, and decoded by the video mode: the plain
    decoder and the g++-built twin give the same planes; the video mode
    counts in jp2.video_counts, never in decode.route_counts; the twin
    refuses what the plain mode refuses with the same message; a 2x2
    frame (a chroma component of one sample) is refused by name."""
    path = str(tmp_path / "clip.avi")
    write_cv2(path, frames_for("jpeg2000", 3), "MJ2C", FPS)
    movie = open_movie(path)
    with open(path, "rb") as f:
        data = movie.read_frame(f, 0)
    assert decode_image(data) is None and decode_image(data, native=True) is None
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    before, stills = dict(jp2.video_counts), decode.route_counts["host_jp2"]
    plain, native = jp2.decode_jp2_planes(data), jp2.decode_jp2_planes_c(data)
    assert [p.shape for p in plain] == [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
    assert all(np.array_equal(a, b) for a, b in zip(plain, native))
    reader = VideoReader(path, device="cpu", use_thread=False)
    assert len([f for ok, f in reader if ok]) == N
    assert jp2.video_counts == {"plain": before["plain"] + 1 + N,
                                "host_cpp": before["host_cpp"] + 1}
    assert decode.route_counts["host_jp2"] == stills
    still = open(os.path.join(os.path.dirname(cli.__file__), "data", "samples",
                              "j2k_53_rct_48x64.j2k"), "rb").read()
    for bad, kind in ((still, jp2.Jp2Unsupported), (still[:4] + b"\0" * 40, jp2.Jp2Error),
                      (data[:len(data) // 2], None)):
        said = []
        for fn in (jp2.decode_jp2_planes, jp2.decode_jp2_planes_c):
            try:
                said.append([p.tobytes() for p in fn(bad)])
            except (jp2.Jp2Error, jp2.Jp2Unsupported) as e:
                said.append((type(e), str(e)))
        assert said[0] == said[1] and (kind is None or said[0][0] is kind), said
    assert "sampled 1x1, 1x1, 1x1" in said_unsupported(still)
    tiny = str(tmp_path / "tiny.avi")
    write_cv2(tiny, [np.zeros((2, 2, 3), np.uint8)], "MJ2C", FPS)
    with pytest.raises(jp2.Jp2Unsupported, match="a component of a single sample"):
        port_read(tiny)


def said_unsupported(data: bytes) -> str:
    with pytest.raises(jp2.Jp2Unsupported) as e:
        jp2.decode_jp2_planes(data)
    return str(e.value)


def test_committed_fixtures_match_cv2():
    """data/video_samples/tags/ as the card reads it: each file's bytes,
    cv2's count, fps and frames at the manifest's sha256, the port's plain
    Motion-JPEG and Motion JPEG 2000 frames at theirs and within max_abs of
    cv2's; video_bench.tag_disagreements on the CPU finds nothing."""
    with open(os.path.join(TAG_SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    assert vb.MJ2_MOV in files and {m["codec"] for m in files.values()} == {
        "mjpeg", "mpeg4", "png", "jpeg2000", "raw"}
    for name, meta in files.items():
        path = os.path.join(TAG_SAMPLES, name)
        with open(path, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == meta["sha256"]
        got, count, fps = read_cv2(path)
        assert (int(count), fps, len(got)) == (meta["frames"], meta["fps"], meta["read"])
        assert [hashlib.sha256(g.tobytes()).hexdigest() for g in got] == meta["rgb_sha256"]
        if "max_abs" in meta:
            plain, *_ = port_read(path, use_thread=False)
            assert [hashlib.sha256(p.tobytes()).hexdigest() for p in plain] == \
                meta["plain_rgb_sha256"]
            assert max(int(np.abs(p.astype(np.int16) - g).max())
                       for p, g in zip(plain, got)) == meta["max_abs"]
    bad, info = vb.tag_disagreements("cpu")
    assert bad == [] and set(info) == set(files)


@pytest.mark.parametrize("fourcc,ext", [("I420", ".avi"), ("mjp2", ".mov")])
def test_demo_cli_matches_jax(spread_demo, tmp_path, capsys, fourcc, ext):
    """`demo -p` on a raw I420 AVI and a Motion JPEG 2000 .mov on v5n@64
    carried from JAX: the reader's frames equal cv2's, and each frame's
    detections JAX's Predictor's on the same RGB frame, as test_torch_demo
    compares them."""
    jm, v, weights, cfg_path = spread_demo
    path = str(tmp_path / f"clip{ext}")
    write_cv2(path, [scene(240, 320, seed=40 + i) for i in range(N)], fourcc, FPS)
    results = []
    run = cli.demo_video
    cli.demo_video = lambda *a, **kw: results.append(run(*a, **kw)) or results[-1]
    try:
        assert cli.main(["demo", "-p", path, "-c", cfg_path, "-w", weights,
                         "--device", "cpu"]) == 0
    finally:
        cli.demo_video = run
    (res,) = results
    assert f"over {N} frames" in capsys.readouterr().out and res["fps"] == FPS
    frames, *_ = port_read(path, use_thread=False)
    want, *_ = jax_read(path)
    assert all(np.array_equal(f, w) for f, w in zip(frames, want))
    jpred = JaxPredictor(jm, v, img_size=SIZE, approx_topk=False)
    gain = min(SIZE / 240, SIZE / 320)
    n = 0
    for i, (rgb, dets) in enumerate(zip(frames, res["detections"])):
        expected, _ = jpred(rgb)
        assert same_detections(expected, dets, box_tol=1e-3 / gain), (i, expected, dets)
        n += len(dets)
    assert len(res["detections"]) == N and n > 0
