"""data/mpeg4.py on the CPU: the plain decoder against cv2.VideoCapture
(the JAX VideoReader) on mp4v clips this environment's cv2 writes, within
MPEG4_TOLERANCE (bit-equal); csrc/mpeg4_decode.cu, compiled here with the
host compiler (g++) as nvcc compiles it on the card, held to the plain
decoder frame for frame and refusal for refusal; the mp4v encoder
(encoder -> decoder bit-exact, cv2 reading the port's .mp4 and .avi, PSNR
against cv2's own mp4v of the same frames); the refusals; and
readers.VideoReader on MPEG-4 clips."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from torch_mpeg4_samples import (HD_CLIP, VIDEO_SAMPLES, moving, random_stream, read_cv2,
                                 write_cv2)
from vision_kit_tpu.utils.readers import VideoReader as JaxVideoReader
from vision_kit_tpu_torch import _cuda_build
from vision_kit_tpu_torch.data import mpeg4
from vision_kit_tpu_torch.data.decode import pixel_agreement
from vision_kit_tpu_torch.utils.avi import AviWriter
from vision_kit_tpu_torch.utils.mp4 import Mp4Writer, read_mp4
from vision_kit_tpu_torch.utils.readers import VideoReader, open_movie

torch.set_num_threads(2)

# (name, (h, w), content, fourcc, frames): sizes that are and are not
# multiples of 16; 14 frames for an I-VOP after cv2's GOP of 12
CLIPS = [("pan_144x176.mp4", (144, 176), "pan", "mp4v", 6),
         ("pan_100x150.mp4", (100, 150), "pan", "mp4v", 14),
         ("static_120x200.mov", (120, 200), "static", "mp4v", 4),
         ("noise_96x112.mp4", (96, 112), "noise", "mp4v", 4),
         ("pan_90x118.avi", (90, 118), "pan", "FMP4", 5),
         ("noise_64x80.avi", (64, 80), "noise", "XVID", 4)]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mpeg4")
    out = {}
    for k, (name, (h, w), kind, fourcc, n) in enumerate(CLIPS):
        frames = moving(kind, h, w, n, seed=20 + k)
        path = str(tmp / name)
        write_cv2(path, frames, fourcc)
        out[name] = (path, frames)
    return tmp, out


def decode_all(path: str, device: str = "cpu") -> list:
    """(Y, U, V) of every frame of a clip by Mpeg4Decoder."""
    movie = open_movie(path)
    dec = mpeg4.Mpeg4Decoder(movie.config or None, device)
    out = []
    with open(path, "rb") as f:
        for i in range(len(movie.frames)):
            planes = dec.decode(movie.read_frame(f, i))
            if planes is not None:
                out.append(planes)
    dec.close()
    return out


def rgb(planes) -> np.ndarray:
    return mpeg4.yuv420_to_rgb(*(torch.from_numpy(p) for p in planes)).numpy()


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255 ** 2 / mse) if mse else float("inf")


@pytest.mark.parametrize("name", [c[0] for c in CLIPS])
def test_plain_decoder_equals_cv2(clips, name):
    """Every frame within MPEG4_TOLERANCE of the JAX VideoReader's (bit-
    equal); the last P-VOP before an I-VOP no further from cv2 than the
    I-VOP."""
    _, paths = clips
    path, _ = paths[name]
    jax = JaxVideoReader(path, use_thread=False)
    want = [np.ascontiguousarray(bgr[..., ::-1]) for ok, bgr in jax if ok]
    jax.stop()
    got = [rgb(p) for p in decode_all(path)]
    assert len(got) == len(want) == len(jax)
    agreements = [pixel_agreement(torch.from_numpy(g), w) for g, w in zip(got, want)]
    for i, a in enumerate(agreements):
        assert mpeg4.within_mpeg4_tolerance(a), (i, a)
    movie = open_movie(path)
    keys = getattr(movie, "keyframes", [0])
    for k in keys[1:]:
        assert agreements[k - 1]["mean_abs"] <= agreements[k]["mean_abs"]


def test_hd_clip_first_gop_equals_cv2():
    """The committed 720p clip's first GOP and the next I-VOP, decoded by
    the plain decoder, hash to cv2's frames (MANIFEST.json)."""
    import hashlib
    import json

    with open(os.path.join(VIDEO_SAMPLES, "MANIFEST.json")) as f:
        meta = json.load(f)["files"][HD_CLIP]
    movie = read_mp4(os.path.join(VIDEO_SAMPLES, HD_CLIP))
    dec = mpeg4.Mpeg4Decoder(movie.config)
    with open(movie.path, "rb") as f:
        for i in range(9):
            got = rgb(dec.decode(movie.read_frame(f, i)))
            assert hashlib.sha256(got.tobytes()).hexdigest() == meta["rgb_sha256"][i], i


def c_library():
    """csrc/mpeg4_decode.cu built with g++ (host code with a C interface),
    or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"vk_mpeg4_{os.getpid()}.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    _cuda_build.source_path("mpeg4_decode"), "-o", out], check=True)
    lib = ctypes.CDLL(out)
    os.remove(out)
    return lib


@pytest.fixture(scope="module")
def c_decoder():
    lib = c_library()
    if lib is None:
        pytest.skip("no g++ to build csrc/mpeg4_decode.cu on the host")
    old = _cuda_build._libs.get("mpeg4_decode")
    _cuda_build._libs["mpeg4_decode"] = lib
    yield lib
    if old is None:
        _cuda_build._libs.pop("mpeg4_decode", None)
    else:
        _cuda_build._libs["mpeg4_decode"] = old


@pytest.mark.parametrize("name", [c[0] for c in CLIPS])
def test_c_decoder_equals_plain(clips, c_decoder, name):
    _, paths = clips
    path, _ = paths[name]
    calls = mpeg4.c_calls()
    plain, native = decode_all(path), decode_all(path, "cuda")
    assert len(plain) == len(native) > 0
    for a, b in zip(plain, native):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    movie = open_movie(path)
    assert mpeg4.c_calls() - calls == len(movie.frames) + bool(movie.config)


@pytest.mark.parametrize("size", [(144, 176), (100, 150), (37, 61), (16, 16)])
@pytest.mark.parametrize("key_interval", [1, 4, 12])
def test_encoder_decoder_bit_exact(size, key_interval):
    h, w = size
    frames = moving("pan", h, w, 6, seed=h + key_interval)
    enc = mpeg4.Mp4vEncoder(w, h, key_interval=key_interval)
    dec = mpeg4.Mpeg4Decoder(enc.headers())
    for i, f in enumerate(frames):
        vop, key = enc.encode(f)
        assert key == (i % key_interval == 0)
        got = dec.decode(vop)
        ch, cw = (h + 1) // 2, (w + 1) // 2
        want = (enc.recon[0][:h, :w], enc.recon[1][:ch, :cw], enc.recon[2][:ch, :cw])
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), i


@pytest.mark.parametrize("kind", ["pan", "static", "noise"])
@pytest.mark.parametrize("container", ["mp4", "avi"])
def test_cv2_reads_the_port_encoder(tmp_path, kind, container):
    """cv2 reads every frame of the port's .mp4 and FMP4 .avi, equal to the
    port's own decode, and at no lower PSNR against the written frames than
    cv2's mp4v of the same frames (sizes reported as a ratio)."""
    h, w = 96, 128
    frames = moving(kind, h, w, 6, seed=3)
    enc = mpeg4.Mp4vEncoder(w, h, 30.0, key_interval=4)
    path = str(tmp_path / f"port.{container}")
    if container == "mp4":
        with Mp4Writer(path, 30.0) as out:
            for f in frames:
                vop, key = enc.encode(f)
                out.write(vop, key, w, h, enc.headers())
    else:
        with AviWriter(path, 30.0, b"FMP4") as out:
            for i, f in enumerate(frames):
                vop, key = enc.encode(f)
                out.write((enc.headers() if i == 0 else b"") + vop, w, h, key)
    got, count, _ = read_cv2(path)
    assert count == len(got) == len(frames)
    ours = [rgb(p) for p in decode_all(path)]
    assert all(np.array_equal(a, b) for a, b in zip(got, ours))
    ref = str(tmp_path / f"cv2.{container}")
    write_cv2(ref, frames, "mp4v")
    theirs, _, _ = read_cv2(ref)
    mine = np.mean([psnr(g, f) for g, f in zip(got, frames)])
    cv2_psnr = np.mean([psnr(g, f) for g, f in zip(theirs, frames)])
    assert mine >= cv2_psnr, (mine, cv2_psnr, os.path.getsize(path) / os.path.getsize(ref))


@pytest.mark.parametrize("seed", range(12))
def test_random_streams_equal_cv2(tmp_path, c_decoder, seed):
    """Random valid streams (torch_mpeg4_samples.random_stream: 4MV, intra
    MBs in P-VOPs, dquant, AC prediction, the intra DC as a TCOEF, MCBPC
    stuffing, every escape, rounding 1, fcode 1-3, MVs far past the edges;
    video packets on odd seeds, MPEG quantisation with loaded matrices on
    every third) at sizes that are and are not multiples of 16: cv2 reads
    each frame as the plain decoder does, bit for bit, and the C++ decoder
    equals the plain one."""
    rng = np.random.default_rng(1000 + seed)
    w = int(rng.integers(2, 12)) * 8 + int(rng.integers(0, 2)) * 2
    h = int(rng.integers(2, 10)) * 8
    headers, vops = random_stream(seed, w, h, 6, resync=bool(seed % 2),
                                  mpeg_quant=seed % 3 == 0)
    path = str(tmp_path / "random.mp4")
    with Mp4Writer(path, 30.0) as out:
        for vop, key in vops:
            out.write(vop, key, w, h, headers)
    want, count, _ = read_cv2(path)
    assert count == len(want) == len(vops)
    plain = mpeg4.Mpeg4Decoder(headers)
    native = mpeg4.Mpeg4Decoder(headers, "cuda")
    for i, ((vop, _), frame) in enumerate(zip(vops, want)):
        got = plain.decode(vop)
        assert np.array_equal(rgb(got), frame), i
        assert all(np.array_equal(a, b) for a, b in zip(got, native.decode(vop))), i
    native.close()


def _with_vop_kind(vop: bytes, kind: int) -> bytes:
    i = vop.find(b"\0\0\1\xb6") + 4
    return vop[:i] + bytes([(vop[i] & 0x3F) | kind << 6]) + vop[i + 1:]


def vol_with(verid: int = 1, quarter_sample: int = 0, interlaced: int = 0,
             sprite: int = 0, not_8_bit: int = 0, shape: int = 0, partitioned: int = 0,
             complexity: int = 0, width: int = 64, height: int = 48) -> bytes:
    """A VOS/VO/VOL with the given fields (the rest as Mp4vEncoder writes
    them), cut after the field a refusal names."""
    w = mpeg4._BitWriter()
    w.put(0x1B0, 32), w.put(1, 8), w.put(0x100, 32), w.put(0x120, 32)
    w.put(0, 1), w.put(1, 8), w.put(1, 1), w.put(verid, 4), w.put(1, 3), w.put(1, 4)
    w.put(0, 1), w.put(shape, 2), w.put(1, 1), w.put(30, 16), w.put(1, 1), w.put(0, 1)
    w.put(1, 1), w.put(width, 13), w.put(1, 1), w.put(height, 13), w.put(1, 1)
    w.put(interlaced, 1), w.put(1, 1), w.put(sprite, 1 if verid == 1 else 2)
    w.put(not_8_bit, 1), w.put(0, 1)
    if verid != 1:
        w.put(quarter_sample, 1)
    w.put(1 - complexity, 1), w.put(1, 1), w.put(partitioned, 1)
    if verid != 1:
        w.put(0, 1), w.put(0, 1)
    w.put(0, 1)
    w.stuff()
    return w.bytes()


@pytest.mark.parametrize("fields, message", [
    ({"verid": 2, "quarter_sample": 1}, "quarter-pel"),
    ({"interlaced": 1}, "interlaced"),
    ({"sprite": 1}, "sprites/GMC"),
    ({"not_8_bit": 1}, "not_8_bit"),
    ({"shape": 1}, "non-rectangular shape"),
    ({"partitioned": 1}, "data partitioning"),
    ({"complexity": 1}, "complexity estimation"),
])
def test_vol_refusals_name_themselves(c_decoder, fields, message):
    vol = vol_with(**fields)
    with pytest.raises(mpeg4.Mpeg4Error, match=message):
        mpeg4.read_vol(vol)
    for device in ("cpu", "cuda"):
        with pytest.raises(mpeg4.Mpeg4Error, match=message):
            mpeg4.Mpeg4Decoder(vol, device)
    assert mpeg4.read_vol(vol_with()).width == 64   # the same VOL without it reads


def test_vop_and_stream_refusals(c_decoder):
    enc = mpeg4.Mp4vEncoder(64, 48)
    frames = moving("pan", 48, 64, 2, seed=1)
    i_vop, _ = enc.encode(frames[0])
    p_vop, _ = enc.encode(frames[1])
    for device in ("cpu", "cuda"):
        dec = mpeg4.Mpeg4Decoder(enc.headers(), device)
        with pytest.raises(mpeg4.Mpeg4Error, match="P-VOP before any I-VOP"):
            dec.decode(p_vop)
        dec.decode(i_vop)
        with pytest.raises(mpeg4.Mpeg4Error, match=r"B \(Advanced Simple Profile\)-VOP"):
            dec.decode(_with_vop_kind(p_vop, mpeg4.B_VOP))
        with pytest.raises(mpeg4.Mpeg4Error, match="sprite/GMC"):
            dec.decode(_with_vop_kind(p_vop, mpeg4.S_VOP))
        with pytest.raises(mpeg4.Mpeg4Error, match="short video header"):
            dec.decode(b"\0\0\x80\x02" + bytes(20))
        with pytest.raises(mpeg4.Mpeg4Error, match="without start codes"):
            dec.decode(b"\x12\x34\x56\x78")
    # a VOP cut short: the same refusal from both decoders
    messages = []
    for device in ("cpu", "cuda"):
        with pytest.raises(mpeg4.Mpeg4Error) as err:
            mpeg4.Mpeg4Decoder(enc.headers(), device).decode(i_vop[:len(i_vop) // 2])
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "invalid TCOEF code" in messages[0] or "runs past the end" in messages[0]
    with pytest.raises(mpeg4.Mpeg4Error, match="short video header"):
        mpeg4.read_vol(b"\0\0\x80\x02" + bytes(20))


def test_yuv420_to_rgb_device_agnostic_and_odd_sizes():
    rng = np.random.default_rng(0)
    for h, w in ((7, 9), (2, 2), (33, 64)):
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        u = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
        v = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
        out = rgb((y, u, v))
        assert out.shape == (h, w, 3) and out.dtype == np.uint8
        # each chroma sample serves its 2x2 luma samples
        same = rgb((y, np.repeat(np.repeat(u, 2, 0), 2, 1)[::2, ::2],
                    np.repeat(np.repeat(v, 2, 0), 2, 1)[::2, ::2]))
        assert np.array_equal(out, same)


@pytest.mark.parametrize("use_thread", [False, True])
def test_video_reader_on_mpeg4(clips, use_thread):
    _, paths = clips
    for name in ("pan_100x150.mp4", "pan_90x118.avi"):
        path, _ = paths[name]
        reader = VideoReader(path, use_thread=use_thread, device="cpu")
        jax = JaxVideoReader(path, use_thread=False)
        assert (len(reader), reader.fps, reader.org_width, reader.org_height) == (
            len(jax), jax.fps, jax.org_width, jax.org_height)
        want = [np.ascontiguousarray(bgr[..., ::-1]) for ok, bgr in jax if ok]
        jax.stop()
        items = list(reader)
        reader.stop()
        assert items[-1] == (False, None) and len(items) == len(want) + 1
        for (ok, got), w in zip(items, want):
            assert ok and got.dtype == torch.uint8 and np.array_equal(got.numpy(), w)


def test_video_reader_raises_a_refused_vop(clips, tmp_path):
    """A B-VOP in the stream raises from the iteration (threaded too)."""
    _, paths = clips
    src = read_mp4(paths["pan_144x176.mp4"][0])
    out = str(tmp_path / "bvop.mp4")
    with open(src.path, "rb") as f, Mp4Writer(out, 30.0) as w:
        for i in range(len(src.frames)):
            s = src.read_frame(f, i)
            w.write(_with_vop_kind(s, mpeg4.B_VOP) if i == 2 else s, i == 0, src.width,
                    src.height, src.config)
    for use_thread in (False, True):
        reader = VideoReader(out, use_thread=use_thread, device="cpu")
        got = []
        with pytest.raises(mpeg4.Mpeg4Error, match="B \\(Advanced Simple Profile\\)"):
            for ok, frame in reader:
                got.append(frame)
        reader.stop()
        assert len(got) == 2
