"""The demo's video mode and data.fast_decode on the card: a Motion-JPEG
clip of the committed samples, VideoReader's frames held to the plain
decoder's, a fast_decode dataset's items on the card held to the CPU's, and
each decode route's ms an image. chip_smoke.py's demo and fit phases and
tests/test_torch_cuda.py share them; each check returns its disagreements,
empty when it passes."""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from vision_kit_tpu_torch.data import decode
from vision_kit_tpu_torch.ops.letterbox import resize_u8
from vision_kit_tpu_torch.utils.avi import AviWriter
from vision_kit_tpu_torch.utils.serve_bench import sample_bytes


def write_sample_clip(path: str, n_frames: int = 24, fps: float = 30.0) -> list:
    """A Motion-JPEG AVI of the committed 720x1280 samples in turn, their
    bytes as they are, `n_frames` long; returns each frame's JPEG bytes."""
    samples = sample_bytes("jpeg_720p")
    frames = [samples[i % len(samples)] for i in range(n_frames)]
    with AviWriter(path, fps) as writer:
        for data in frames:
            info = decode.jpeg_header(data)
            writer.write(data, info["width"], info["height"])
    return frames


def reader_disagreements(path: str, jpegs: list, fps: float, device) -> list:
    """VideoReader on `path` (written by write_sample_clip from `jpegs`) on
    `device`: the plain decoder's first frames (each distinct JPEG once; a
    720p plain decode takes ~0.3 s) equal decode_image of each bit for bit,
    and on the card nvJPEG's frames, all of them, lie within
    decode.NVJPEG_TOLERANCE of them, threaded and unthreaded alike; the
    count and the fps are the clip's."""
    from vision_kit_tpu_torch.utils.readers import VideoReader

    bad = []
    want = {data: decode.decode_image(data) for data in set(jpegs)}

    def frames(n=None, **kw):
        reader = VideoReader(path, device=device, **kw)
        if (len(reader), reader.fps) != (len(jpegs), fps):
            bad.append(f"{kw}: {len(reader)} frames at {reader.fps} fps, not "
                       f"{len(jpegs)} at {fps}")
        items = list(itertools.islice(reader, n))
        reader.stop()
        if n is None and (items[-1] != (False, None)
                          or not all(ok for ok, _ in items[:-1])):
            bad.append(f"{kw}: the stream did not end with one (False, None)")
        return [f for ok, f in items if ok]

    plain = frames(len(want), decoder="plain", use_thread=False)
    for i, (got, data) in enumerate(zip(plain, jpegs)):
        if (got.device.type != torch.device(device).type
                or not np.array_equal(got.cpu().numpy(), want[data])):
            bad.append(f"plain frame {i} differs from decode_image")
    if torch.device(device).type == "cuda":
        threaded, unthreaded = frames(), frames(use_thread=False)
        for i, (a, b, data) in enumerate(zip(threaded, unthreaded, jpegs)):
            if not torch.equal(a, b):
                bad.append(f"nvJPEG frame {i}: threaded and unthreaded differ")
            agreement = decode.pixel_agreement(a, want[data])
            if not decode.within_nvjpeg_tolerance(agreement):
                bad.append(f"nvJPEG frame {i} outside NVJPEG_TOLERANCE: {agreement}")
    return bad


def fast_decode_disagreements(data_dir: str, sizes=(640, 320, 160), idxs=range(24)):
    """YOLODataset(fast_decode=True) over `data_dir` on the card against the
    same on the CPU at each size: items `idxs`, and every item whose file
    name holds "progressive", (image, labels, (h0, w0)) bit-equal. Returns
    (disagreements, {size: items that took the reduced decode}, the file
    names that took it at some size)."""
    from vision_kit_tpu_torch.data.datasets import YOLODataset, _fast_decode_resized

    bad, reduced, files = [], {}, set()
    for size in sizes:
        card = YOLODataset(data_dir, img_size=size, fast_decode=True, device="cuda")
        cpu = YOLODataset(data_dir, img_size=size, fast_decode=True, device="cpu")
        reduced[size] = 0
        extra = [i for i, f in enumerate(card.img_files) if "progressive" in f]
        for i in sorted(set(idxs) | set(extra)):
            (gi, gl, ghw, _), (wi, wl, whw, _) = card.pull_item(i), cpu.pull_item(i)
            if gi.device.type != "cuda" or not torch.equal(gi.cpu(), wi):
                bad.append(f"{size}: item {i} ({card.img_files[i]}) image differs")
            if tuple(ghw) != tuple(whw) or not np.array_equal(gl, wl):
                bad.append(f"{size}: item {i} labels or (h0, w0) differ")
            with open(card.img_files[i], "rb") as f:
                if _fast_decode_resized(f.read(), (size, size)) is not None:
                    reduced[size] += 1
                    files.add(os.path.basename(card.img_files[i]))
    return bad, reduced, sorted(files)


def decode_route_ms(data: bytes, size: int, device, reps: int = 3) -> dict:
    """Median ms (host clock, synchronised) to bring one JPEG to its
    min-ratio size `size` on `device` by each route: "reduced" (fast_decode:
    the plain decoder at 1/f, uploaded, resize_u8), "full" (the plain
    decoder whole, uploaded, resize_u8), and on the card "nvjpeg" (nvJPEG,
    then resize_u8)."""
    from vision_kit_tpu_torch.data.datasets import _fast_decode_resized

    device = torch.device(device)
    info = decode.jpeg_header(data)
    h0, w0 = info["height"], info["width"]
    r = min(size / h0, size / w0)
    shape = (int(w0 * r), int(h0 * r))

    def full():
        return resize_u8(torch.from_numpy(decode.decode_image(data)).to(device), shape)

    routes = {"reduced": lambda: _fast_decode_resized(data, (size, size), device)[0],
              "full": full}
    if device.type == "cuda":
        routes["nvjpeg"] = lambda: resize_u8(decode.decode_jpeg_cuda(data, device), shape)
    out = {}
    for name, run in routes.items():
        times = []
        for _ in range(reps + 1):   # the first call warms up
            t0 = time.perf_counter()
            img = run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1000)
            if tuple(img.shape[:2]) != (shape[1], shape[0]):
                raise RuntimeError(f"{name} gave {tuple(img.shape)} for {shape}")
        out[name] = float(np.median(times[1:]))
    return out
