"""The port's demo and its helpers on the CPU: utils/metrics.py against the
JAX package's copy, utils/readers.py, utils/drawing.py:Drawing, and
`python -m vision_kit_tpu_torch demo` on the committed samples against
JAX's Predictor on the same weights."""

import json
import os

import cv2
import numpy as np
import pytest
import torch
import yaml

from flax import serialization

from test_torch_model import REPO, jax_v5
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu.utils import metrics as jax_metrics
from vision_kit_tpu.utils.readers import ImageReader as JaxImageReader
from vision_kit_tpu_torch import __main__ as cli
from vision_kit_tpu_torch.data.decode import decode_image
from vision_kit_tpu_torch.data.encode import encode_jpeg
from vision_kit_tpu_torch.utils import metrics
from vision_kit_tpu_torch.utils.drawing import Drawing, class_color, text_mask
from vision_kit_tpu_torch.utils.readers import IMAGE_EXT, ImageReader, VideoReader
from vision_kit_tpu_torch.utils.stream_bench import same_detections

torch.set_num_threads(2)

SAMPLES = os.path.join(REPO, "vision_kit_tpu_torch", "data", "samples")
SIZE = 64
# the committed samples of IMAGE_EXT (what a directory lists) that every
# reader refuses (JPEGs cut short, frames cv2 gives None for): decoded shape
# null in the manifest
with open(os.path.join(SAMPLES, "MANIFEST.json")) as _f:
    REFUSED = [n for n, m in json.load(_f)["files"].items()
               if m["shape"] is None and os.path.splitext(n)[1].lower() in IMAGE_EXT]


def test_meters_equal_jax_on_a_seeded_stream():
    rng = np.random.default_rng(0)
    stream = rng.normal(size=200) * 10
    ours, theirs = metrics.AverageMeter(window_size=30), jax_metrics.AverageMeter(30)
    for i, x in enumerate(stream):
        ours.update(x)
        theirs.update(x)
        if i % 17 == 0:
            ours.clear()
            theirs.clear()
        for name in ("median", "avg", "global_avg", "latest", "total"):
            np.testing.assert_equal(getattr(ours, name), getattr(theirs, name))
    ours.reset()
    theirs.reset()
    assert ours.global_avg == theirs.global_avg == 0.0 and np.isnan(ours.latest)

    mb, jb = metrics.MeterBuffer(window_size=7), jax_metrics.MeterBuffer(7)
    for i, x in enumerate(stream[:60]):
        values = {"iter_time": x, "data_time": x / 2, "loss": -x}
        mb.update(dict(values), lr=float(i))
        jb.update(dict(values), lr=float(i))
    assert set(mb) == set(jb) == {"iter_time", "data_time", "loss", "lr"}
    assert set(mb.get_filtered_meter()) == set(jb.get_filtered_meter()) == {
        "iter_time", "data_time"}
    for k in mb:
        assert (mb[k].median, mb[k].avg, mb[k].global_avg) == (
            jb[k].median, jb[k].avg, jb[k].global_avg), k
    mb.clear_meters()
    assert mb["loss"].avg == 0.0 and mb["loss"].global_avg == jb["loss"].global_avg
    assert metrics.smooth is not None and metrics.smooth_bce(0.1) == jax_metrics.smooth_bce(0.1)


def test_image_reader_gives_decode_image_pixels(tmp_path):
    ours, theirs = ImageReader(SAMPLES), JaxImageReader(SAMPLES)
    assert ours.files == theirs.files and len(ours) == len(theirs) > 10
    n_read = 0
    for (ok, rgb), (_, bgr), path in zip(ours, theirs, ours.files):
        with open(path, "rb") as f:
            want = decode_image(f.read())
        assert ok == (want is not None)
        if ok:
            n_read += 1
            np.testing.assert_array_equal(rgb, want)
            np.testing.assert_array_equal(rgb, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    assert n_read == len(ours) - len(REFUSED)
    one = ImageReader(os.path.join(SAMPLES, "odd_333x517.jpg"), save_path=str(tmp_path))
    assert one.files == [os.path.join(SAMPLES, "odd_333x517.jpg")]
    _, img = next(iter(one))
    out = one.save(img, "odd_333x517.jpg")
    assert out == str(tmp_path / "odd_333x517_res.jpg")
    # the bytes JAX's reader writes (cv2.imwrite) for the same pixels
    jax_out = JaxImageReader(SAMPLES, save_path=str(tmp_path / "jax")).save(
        cv2.cvtColor(img, cv2.COLOR_RGB2BGR), "odd_333x517.jpg")
    with open(out, "rb") as f, open(jax_out, "rb") as g:
        assert f.read() == g.read()
    # an mp4v clip reads as cv2 reads it; an H.264 sample entry raises
    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
    writer.write(np.zeros((48, 64, 3), np.uint8))
    writer.release()
    frames = [frame for ok, frame in VideoReader(clip, device="cpu") if ok]
    ok, bgr = cv2.VideoCapture(clip).read()
    assert ok and len(frames) == 1
    np.testing.assert_array_equal(frames[0].numpy(), cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    h264 = str(tmp_path / "h264.mp4")
    with open(clip, "rb") as f, open(h264, "wb") as g:
        g.write(f.read().replace(b"mp4v", b"avc1"))
    with pytest.raises(ValueError, match=r"H\.264 \(avc1\)"):
        VideoReader(h264, device="cpu")


def test_drawing_boxes_and_labels():
    img = np.full((60, 80, 3), 7, np.uint8)
    dets = np.array([[10, 30, 50, 55, 0.87, 2], [-5, -5, 70, 50, 0.5, 99]], np.float32)
    out = Drawing(["red", "green", "blue"], line_thickness=2).draw(img, dets)
    assert np.all(img == 7) and out.shape == img.shape
    color = class_color(2)
    # the box's left edge below the label strip: cv2.rectangle's thickness 2,
    # x = 9..11 around x = 10
    assert np.all(out[36:48, 9:12] == color) and np.all(out[36:48, 12] == 7)
    mask = text_mask("blue 0.87")
    assert mask.shape == (7, 6 * 9 - 1)
    # the strip above the box: the box's colour, the text white inside it
    strip = out[30 - 11:30, 10:10 + mask.shape[1] + 2]
    white = np.all(strip == 255, axis=-1)
    assert white.sum() == mask.sum()
    assert np.all(strip[~white] == color)
    # a box past the frame is clipped (its top, left and label lie outside),
    # a class out of the labels named by its id
    other = class_color(99)
    assert np.all(out[2:20, 69:71] == other) and np.all(out[49:51, 20:60] == other)
    assert np.all(out[2:20, 0:8] == 7)
    assert text_mask("").shape == (7, 0)
    assert np.array_equal(text_mask("a"), text_mask("A"))
    assert np.array_equal(text_mask("~"), text_mask("?"))


@pytest.fixture(scope="module")
def demo_setup(tmp_path_factory):
    """JAX's v5n@64 (crowded detections), its variables as a Flax msgpack
    and a config naming the model, 80 classes at 64."""
    tmp = tmp_path_factory.mktemp("demo")
    jm, v = jax_v5("n", SIZE)
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
    return jm, v, weights, cfg_path, tmp


def test_demo_cli_on_the_samples_matches_jax(demo_setup, monkeypatch, capsys):
    jm, v, weights, cfg_path, tmp = demo_setup
    results = []
    run = cli.demo_images
    monkeypatch.setattr(cli, "demo_images",
                        lambda *a, **kw: results.append(run(*a, **kw)) or results[-1])
    out_dir = str(tmp / "out")
    assert cli.main(["demo", "-p", SAMPLES, "-o", out_dir, "-c", cfg_path, "-w", weights,
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    (rows,) = results
    files = sorted(os.path.join(r, f) for r, _, names in os.walk(SAMPLES) for f in names
                   if os.path.splitext(f)[1].lower() in IMAGE_EXT)
    assert [r[0] for r in rows] == files
    written = sorted(os.listdir(out_dir))
    read = [r for r in rows if r[1] is not None]
    assert written == sorted(os.path.basename(r[2]) for r in read)
    assert len(read) == len(files) - len(REFUSED)
    jpred = JaxPredictor(jm, v, img_size=SIZE, approx_topk=False)
    drawer = Drawing([f"c{i}" for i in range(80)])
    n = 0
    for path, dets, out_path in rows:
        if dets is None:
            assert f"cannot read {path}" in printed
            continue
        assert f"{path}: {len(dets)} detections in " in printed
        rgb = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        want, _ = jpred(rgb)
        # 1e-3 px of the model's 64x64 frame, in the source frame's pixels
        gain = min(SIZE / rgb.shape[0], SIZE / rgb.shape[1])
        assert same_detections(want, dets, box_tol=1e-3 / gain), (path, want, dets)
        n += len(dets)
        # the image as drawn, in encode_jpeg's (cv2.imwrite's) bytes
        with open(out_path, "rb") as f:
            assert f.read() == encode_jpeg(drawer.draw(rgb, dets))
    assert n > 20


def test_demo_single_file_output_and_video(demo_setup, capsys):
    _, _, weights, cfg_path, tmp = demo_setup
    src = os.path.join(SAMPLES, "grey_240x320.jpg")
    out = str(tmp / "single" / "result.jpg")
    assert cli.main(["demo", "-p", src, "-o", out, "-c", cfg_path, "-w", weights,
                     "--device", "cpu"]) == 0
    assert os.listdir(tmp / "single") == ["result.jpg"]
    assert f"saved {out}" in capsys.readouterr().out
    with open(out, "rb") as f:
        assert decode_image(f.read()).shape == (240, 320, 3)
    # a .bmp output: the bytes cv2.imwrite writes for the drawn image
    bmp_out = str(tmp / "single" / "result.bmp")
    assert cli.main(["demo", "-p", src, "-o", bmp_out, "-c", cfg_path, "-w", weights,
                     "--device", "cpu"]) == 0
    with open(out, "rb") as f, open(bmp_out, "rb") as g:
        jpg, bmp = f.read(), g.read()
    drawn = decode_image(bmp)
    assert bmp == cv2.imencode(".bmp", cv2.cvtColor(drawn, cv2.COLOR_RGB2BGR))[1].tobytes()
    assert jpg == encode_jpeg(drawn)   # the same drawn image as the .jpg output
    # a .webp output: lossless, cv2 reads back the drawn frame bit for bit
    webp_out = str(tmp / "single" / "result.webp")
    assert cli.main(["demo", "-p", src, "-o", webp_out, "-c", cfg_path, "-w", weights,
                     "--device", "cpu"]) == 0
    with open(webp_out, "rb") as f:
        back = cv2.imdecode(np.frombuffer(f.read(), np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(back, cv2.cvtColor(drawn, cv2.COLOR_RGB2BGR))
    # the video run: a Motion-JPEG AVI in, one drawn frame out per frame,
    # as mp4v in the .avi (the JAX writer's fourcc for any name)
    clip = str(tmp / "clip.avi")
    writer = cv2.VideoWriter(clip, cv2.CAP_OPENCV_MJPEG, cv2.VideoWriter_fourcc(*"MJPG"),
                             10.0, (96, 64))
    for i in range(3):
        writer.write(np.full((64, 96, 3), 40 * i, np.uint8))
    writer.release()
    assert cli.main(["demo", "-p", clip, "-o", str(tmp / "clip_out.avi"), "-c", cfg_path,
                     "-w", weights, "--device", "cpu"]) == 0
    assert "over 3 frames" in capsys.readouterr().out
    back = VideoReader(str(tmp / "clip_out.avi"), device="cpu")
    assert len(back) == 3 and back.movie.codec == "mpeg4" and back.movie.tag == b"mp4v"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["demo", "-p", src, "-o", str(tmp), "-c", cfg_path])
