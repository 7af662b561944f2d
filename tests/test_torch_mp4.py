"""utils/mp4.py and the MPEG-4 side of utils/avi.py on the CPU: the port's
demultiplexers against cv2's own packets (CAP_PROP_FORMAT -1) and counts
on clips this environment's cv2 writes (mp4v in .mp4, .mov and AVI under
each MPEG-4 fourcc), the port's Mp4Writer read back by cv2 and by the
port, and the container refusals."""

import os
import struct

import numpy as np
import pytest
import torch

from torch_mpeg4_samples import (HD_CLIP, HD_MKV, MJPEG_MKV, SMALL_CLIP, VIDEO_SAMPLES,
                                 XVID_AVI, moving, raw_packets, read_cv2, write_cv2)
from vision_kit_tpu.utils.readers import VideoReader as JaxVideoReader
from vision_kit_tpu_torch.data import mpeg4
from vision_kit_tpu_torch.utils.avi import AviWriter, read_avi
from vision_kit_tpu_torch.utils.mp4 import Mp4Writer, read_mp4
from vision_kit_tpu_torch.utils.readers import open_movie

torch.set_num_threads(2)

# (file name, size, content, fourcc, fps)
CLIPS = [("pan.mp4", (96, 128), "pan", "mp4v", 30.0),
         ("odd.mp4", (70, 90), "pan", "mp4v", 25.0),
         ("static.mov", (64, 80), "static", "mp4v", 24.0),
         ("fmp4.avi", (48, 64), "pan", "FMP4", 30.0),
         ("xvid.avi", (48, 64), "noise", "XVID", 15.0),
         ("divx.avi", (48, 64), "pan", "DIVX", 30.0),
         ("mp4v.avi", (48, 64), "static", "mp4v", 30.0)]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp4")
    out = {}
    for k, (name, (h, w), kind, fourcc, fps) in enumerate(CLIPS):
        path = str(tmp / name)
        write_cv2(path, moving(kind, h, w, 6, seed=k), fourcc, fps)
        out[name] = path
    return tmp, out


@pytest.mark.parametrize("name", [c[0] for c in CLIPS])
def test_demux_equals_cv2_packets(clips, name):
    """Each frame's bytes are cv2's packet; the count, fps and size are
    the JAX VideoReader's."""
    _, paths = clips
    path = paths[name]
    movie = open_movie(path)
    assert movie.codec == "mpeg4"
    with open(path, "rb") as f:
        ours = [movie.read_frame(f, i) for i in range(len(movie.frames))]
    assert ours == raw_packets(path)
    jax = JaxVideoReader(path, use_thread=False)
    assert (len(movie.frames), movie.fps or 30.0) == (len(jax), jax.fps)
    jax.stop()
    if name.endswith((".mp4", ".mov")):
        assert (movie.width, movie.height) == CLIPS[[c[0] for c in CLIPS].index(name)][1][::-1]
        assert mpeg4.read_vol(movie.config).width == movie.width
        assert movie.brand == (b"qt  " if name.endswith(".mov") else b"isom")


def test_committed_clips_match_their_manifest():
    import hashlib
    import json

    with open(os.path.join(VIDEO_SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    assert sorted(files) == sorted([HD_CLIP, SMALL_CLIP, HD_MKV, MJPEG_MKV, XVID_AVI,
                                    "vp8_144x176_10f.webm", "vp8_720x1280_12f.webm",
                                    "vp9_144x176_10f.webm", "vp9_720x1280_12f.webm"])
    for name, meta in files.items():
        path = os.path.join(VIDEO_SAMPLES, name)
        with open(path, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == meta["sha256"]
        movie = open_movie(path)
        assert (len(movie.frames), movie.fps) == (meta["frames"], meta["fps"])
    assert read_mp4(os.path.join(VIDEO_SAMPLES, HD_CLIP)).keyframes == [0, 8, 16]


@pytest.mark.parametrize("fps", [30.0, 25.0, 29.97, 12.5])
def test_mp4_writer_reads_back_in_cv2(clips, tmp_path, fps):
    """cv2's samples rewritten by Mp4Writer: cv2 decodes the same frames,
    at the same count and fps, and the port reads the samples back."""
    _, paths = clips
    src = read_mp4(paths["pan.mp4"])
    out = str(tmp_path / "re.mp4")
    with open(src.path, "rb") as f, Mp4Writer(out, fps) as w:
        samples = [src.read_frame(f, i) for i in range(len(src.frames))]
        for i, s in enumerate(samples):
            w.write(s, i in src.keyframes, src.width, src.height, src.config)
    want, _, _ = read_cv2(paths["pan.mp4"])
    got, count, got_fps = read_cv2(out)
    assert count == len(samples) and len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert abs(got_fps - fps) < 1e-6
    back = read_mp4(out)
    with open(out, "rb") as f:
        assert [back.read_frame(f, i) for i in range(len(back.frames))] == samples
    assert back.config == src.config and back.keyframes == src.keyframes
    assert abs(back.fps - fps) < 1e-6


def test_mp4_with_moov_first_and_co64(clips, tmp_path):
    """The same samples with moov before mdat and 64-bit chunk offsets."""
    _, paths = clips
    src = read_mp4(paths["pan.mp4"])
    with open(src.path, "rb") as f:
        samples = [src.read_frame(f, i) for i in range(len(src.frames))]
    tmp = str(tmp_path / "t.mp4")
    with Mp4Writer(tmp, 30.0) as w:
        for i, s in enumerate(samples):
            w.write(s, i in src.keyframes, src.width, src.height, src.config)
    data = open(tmp, "rb").read()
    mdat = data.find(b"mdat") - 4
    moov = data.find(b"moov") - 4
    mdat_box, moov_box = data[mdat:moov], data[moov:]
    head = data[:mdat]
    # co64 in place of stco, offsets moved past the moov that now comes first
    i = moov_box.find(b"stco") - 4
    n = struct.unpack(">I", moov_box[i + 12:i + 16])[0]
    old = struct.unpack(f">{n}I", moov_box[i + 16:i + 16 + 4 * n])
    grow = 4 * n
    body_start = len(head) + len(moov_box) + grow + 8
    co64 = (struct.pack(">I4sI", 16 + 8 * n, b"co64", 0) + struct.pack(">I", n)
            + b"".join(struct.pack(">Q", o - (mdat + 8) + body_start) for o in old))
    new_moov = moov_box[:i] + co64 + moov_box[i + 16 + 4 * n:]
    for box in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
        j = new_moov.find(box) - 4
        size = struct.unpack(">I", new_moov[j:j + 4])[0]
        new_moov = new_moov[:j] + struct.pack(">I", size + grow) + new_moov[j + 4:]
    out = str(tmp_path / "moov_first.mp4")
    with open(out, "wb") as f:
        f.write(head + new_moov + mdat_box)
    movie = read_mp4(out)
    with open(out, "rb") as f:
        assert [movie.read_frame(f, i) for i in range(len(movie.frames))] == samples
    assert len(read_cv2(out)[0]) == len(samples)


def test_avi_writer_fmp4_reads_back(clips, tmp_path):
    _, paths = clips
    src = read_avi(paths["fmp4.avi"])
    out = str(tmp_path / "re.avi")
    with open(src.path, "rb") as f, AviWriter(out, 30.0, b"FMP4") as w:
        samples = [src.read_frame(f, i) for i in range(len(src.frames))]
        for i, s in enumerate(samples):
            w.write(s, src.width, src.height, keyframe=i == 0)
    want, _, _ = read_cv2(paths["fmp4.avi"])
    got, count, _ = read_cv2(out)
    assert count == len(samples) and all(np.array_equal(a, b) for a, b in zip(got, want))
    back = read_avi(out)
    assert back.codec == "mpeg4" and back.fps == 30.0


def _patched(path: str, tmp_path, old: bytes, new: bytes, name: str) -> str:
    data = open(path, "rb").read()
    assert old in data
    out = str(tmp_path / name)
    with open(out, "wb") as f:
        f.write(data.replace(old, new))
    return out


def test_container_refusals_name_themselves(clips, tmp_path):
    _, paths = clips
    avc1 = _patched(paths["pan.mp4"], tmp_path, b"mp4v", b"avc1", "h264.mp4")
    with pytest.raises(ValueError, match=r"H\.264 \(avc1\)"):
        open_movie(avc1)
    hevc = _patched(paths["pan.mp4"], tmp_path, b"mp4v", b"hvc1", "hevc.mp4")
    with pytest.raises(ValueError, match=r"HEVC \(hvc1\)"):
        open_movie(hevc)
    h264_avi = _patched(paths["fmp4.avi"], tmp_path, b"FMP4", b"H264", "h264.avi")
    with pytest.raises(ValueError, match=r"'H264' \(H\.264\)"):
        open_movie(h264_avi)
    webm = str(tmp_path / "clip.webm")
    write_cv2(webm, [np.zeros((48, 64, 3), np.uint8)] * 2, "VP90")
    assert open_movie(webm).codec == "vp9"       # VP9 decodes (data/vp9.py)
    av1 = _patched(webm, tmp_path, b"V_VP9", b"V_AV1", "av1.webm")
    with pytest.raises(ValueError, match=r"'V_AV1' \(AV1\)"):
        open_movie(av1)
    vp09 = str(tmp_path / "vp09.mp4")
    write_cv2(vp09, [np.zeros((48, 64, 3), np.uint8)] * 2, "VP90")
    assert open_movie(vp09).codec == "vp9"
    av01 = _patched(vp09, tmp_path, b"vp09", b"av01", "av01.mp4")
    with pytest.raises(ValueError, match=r"AV1 \(av01\)"):
        open_movie(av01)
    # an esds whose objectTypeIndication names a codec the port does not
    # decode (0x6C, JPEG, is Motion-JPEG now: tests/test_torch_video_tags.py)
    data = open(paths["pan.mp4"], "rb").read()
    i = data.find(b"esds")
    j = data.find(b"\x04\x80\x80\x80", i) + 5
    other = str(tmp_path / "h264_in_mp4v.mp4")
    with open(other, "wb") as f:
        f.write(data[:j] + b"\x21" + data[j + 1:])
    with pytest.raises(ValueError, match="the mp4v track holds H.264"):
        open_movie(other)
    with open(other, "wb") as f:
        f.write(data[:j] + b"\x6c" + data[j + 1:])
    assert open_movie(other).codec == "mjpeg"
