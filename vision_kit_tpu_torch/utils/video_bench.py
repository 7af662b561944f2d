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
    decode.NVJPEG_TOLERANCE of them, threaded and unthreaded alike, and
    alike again when the reader's decodes queue behind ~0.1 s of work on the
    card (nvJPEG's staged buffers reused before their decode ran show
    there); the count and the fps are the clip's."""
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
        big = torch.ones(8192, 8192, device=device)
        for _ in range(6):      # the threaded reader's stream waits for these
            big @ big
        behind = frames()
        for i, (a, b, c, data) in enumerate(zip(threaded, unthreaded, behind, jpegs)):
            if not torch.equal(a, b):
                bad.append(f"nvJPEG frame {i}: threaded and unthreaded differ")
            if not torch.equal(c, b):
                bad.append(f"nvJPEG frame {i}: read behind queued work differs")
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


# -- MPEG-4 Part 2 -------------------------------------------------------------

VIDEO_SAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "data", "video_samples")
HD_CLIP, SMALL_CLIP = "mp4v_720x1280_24f.mp4", "mp4v_144x176_fmp4.avi"
HD_MKV, MJPEG_MKV, XVID_AVI = "mp4v_720x1280_24f.mkv", "mjpg_144x176_10f.mkv", "xvid_144x176_6f.avi"


def video_manifest() -> dict:
    """data/video_samples/MANIFEST.json's files (tests/torch_mpeg4_samples.py):
    each clip's frames, fps, size and the sha256 of every frame cv2 reads."""
    import json

    with open(os.path.join(VIDEO_SAMPLES, "MANIFEST.json")) as f:
        return json.load(f)["files"]


def mpeg4_disagreements(plain_frames: dict, device="cuda") -> tuple:
    """The committed MPEG-4 clips through the host C++ decoder
    (Mpeg4Decoder(device="cuda")) and the plain one, each with its
    container's codec tag: every C++ frame,
    converted by yuv420_to_rgb on `device`, at the manifest's sha256 of
    cv2's frame; the first plain_frames[name] frames of each clip equal to
    the C++ planes bit for bit. Returns (disagreements, {"cpp": {"I": ms,
    "P": ms}, "plain": {...}}: median host-clock ms a 720p VOP of each
    kind (the HD clip's)."""
    import hashlib

    from vision_kit_tpu_torch.data import mpeg4
    from vision_kit_tpu_torch.utils.readers import open_movie

    bad, ms = [], {"cpp": {"I": [], "P": []}, "plain": {"I": [], "P": []}}
    manifest = video_manifest()
    for name, n_plain in plain_frames.items():
        movie = open_movie(os.path.join(VIDEO_SAMPLES, name))
        meta = manifest[name]
        keys = set(getattr(movie, "keyframes", [0]))
        cpp = mpeg4.Mpeg4Decoder(movie.config or None, "cuda", codec_tag=movie.tag)
        plain = mpeg4.Mpeg4Decoder(movie.config or None, "cpu", codec_tag=movie.tag)
        with open(movie.path, "rb") as f:
            for i in range(len(movie.frames)):
                data = movie.read_frame(f, i)
                kind = "I" if i in keys else "P"
                t0 = time.perf_counter()
                planes = cpp.decode(data)
                t1 = time.perf_counter()
                if name in (HD_CLIP, HD_MKV):
                    ms["cpp"][kind].append((t1 - t0) * 1000)
                rgb = mpeg4.yuv420_to_rgb(*(torch.from_numpy(p).to(device) for p in planes))
                digest = hashlib.sha256(rgb.cpu().numpy().tobytes()).hexdigest()
                if digest != meta["rgb_sha256"][i]:
                    bad.append(f"{name} frame {i}: the C++ decoder's RGB is not cv2's")
                if i < n_plain:
                    t0 = time.perf_counter()
                    want = plain.decode(data)
                    if name in (HD_CLIP, HD_MKV):
                        ms["plain"][kind].append((time.perf_counter() - t0) * 1000)
                    if not all(np.array_equal(a, b) for a, b in zip(planes, want)):
                        bad.append(f"{name} frame {i}: the C++ planes differ from the plain")
        cpp.close()
    return bad, {route: {k: float(np.median(v)) if v else None for k, v in kinds.items()}
                 for route, kinds in ms.items()}


def encode_ms(frames: list) -> dict:
    """Median host-clock ms of Mp4vEncoder.encode a frame of each kind over
    `frames` (an I-VOP first, P-VOPs after), and the bytes written."""
    from vision_kit_tpu_torch.data import mpeg4

    h, w = frames[0].shape[:2]
    times = {"I": [], "P": []}
    size = 0
    enc = mpeg4.Mp4vEncoder(w, h)
    for rgb in frames:
        t0 = time.perf_counter()
        vop, key = enc.encode(rgb)
        times["I" if key else "P"].append((time.perf_counter() - t0) * 1000)
        size += len(vop)
    return {"I": float(np.median(times["I"])), "P": float(np.median(times["P"])),
            "bytes": size}


def idct_ms(name: str = HD_MKV, reps: int = 2) -> dict:
    """Median host-clock ms a VOP of each kind that the C++ decoder takes
    on a committed 720p clip with libavcodec's simple IDCT (the clip as cv2
    wrote it, Lavc user data in its configuration) and with its XviD IDCT
    (the same VOPs, that user data rewritten as XviD0050: a build past
    every workaround's range; the frames are then not cv2's), `reps`
    passes over the clip each: {"simple": {"I", "P"}, "xvid": {...}}."""
    from vision_kit_tpu_torch.data import mpeg4
    from vision_kit_tpu_torch.utils.readers import open_movie

    movie = open_movie(os.path.join(VIDEO_SAMPLES, name))
    keys = set(movie.keyframes)
    user = movie.config.find(b"\0\0\1\xb2")
    configs = {"simple": movie.config,
               "xvid": movie.config[:user + 4] + b"XviD0050" if user >= 0 else movie.config}
    with open(movie.path, "rb") as f:
        samples = [movie.read_frame(f, i) for i in range(len(movie.frames))]
    out = {}
    for route, config in configs.items():
        times = {"I": [], "P": []}
        for _ in range(reps):
            dec = mpeg4.Mpeg4Decoder(config, "cuda", codec_tag=movie.tag)
            for i, data in enumerate(samples):
                t0 = time.perf_counter()
                dec.decode(data)
                times["I" if i in keys else "P"].append((time.perf_counter() - t0) * 1000)
            if dec.identity()["xvid_idct"] != (route == "xvid"):
                raise RuntimeError(f"{route}: the decoder inferred {dec.identity()}")
            dec.close()
        out[route] = {k: float(np.median(v)) for k, v in times.items()}
    return out


def demux_ms(path: str, reps: int = 3) -> float:
    """Median host-clock ms a frame to demultiplex a clip: open_movie's
    index of the file and each frame's bytes read, over the frame count."""
    from vision_kit_tpu_torch.utils.readers import open_movie

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        movie = open_movie(path)
        with open(path, "rb") as f:
            for i in range(len(movie.frames)):
                movie.read_frame(f, i)
        times.append((time.perf_counter() - t0) * 1000 / max(len(movie.frames), 1))
    return float(np.median(times))


def movie_frames(path: str) -> list:
    """Each coded frame of a clip, as its container holds it."""
    from vision_kit_tpu_torch.utils.readers import open_movie

    movie = open_movie(path)
    with open(path, "rb") as f:
        return [movie.read_frame(f, i) for i in range(len(movie.frames))]


# -- VP8 and VP9 ------------------------------------------------------------------

VP8_HD, VP8_SMALL = "vp8_720x1280_12f.webm", "vp8_144x176_10f.webm"
VP9_HD, VP9_SMALL = "vp9_720x1280_12f.webm", "vp9_144x176_10f.webm"


def vp8_disagreements(device="cuda", reps: int = 3) -> tuple:
    """The committed VP8 clips (cv2's VP80 in WebM) through the host C++
    decoder (Vp8Decoder(device="cuda")), `reps` passes: every frame's RGB,
    converted by yuv420_to_rgb on `device`, at the manifest's sha256 of
    cv2's frame; the small clip's planes and range equal to the plain
    decoder's bit for bit. Returns (disagreements, {"cpp": {"key": ms,
    "inter": ms} of a 720p frame, each frame's best of the passes (the
    median of those over the frames of a kind), "plain": the same of a
    144x176 frame, one pass}), host-clock ms."""
    from vision_kit_tpu_torch.data import vp8

    return _vpx_disagreements(vp8.Vp8Decoder, VP8_HD, VP8_SMALL, lambda f: not f[0] & 1,
                              device, reps)


def vp9_disagreements(device="cuda", reps: int = 3) -> tuple:
    """vp8_disagreements for the committed VP9 clips (cv2's VP90 in WebM,
    the 720p one in four tile columns) and Vp9Decoder."""
    from vision_kit_tpu_torch.data import vp9

    return _vpx_disagreements(vp9.Vp9Decoder, VP9_HD, VP9_SMALL,
                              lambda f: f[0] >> 6 == 2 and not f[0] & 0x0C, device, reps)


def _vpx_disagreements(decoder, hd: str, small_clip: str, is_key, device, reps) -> tuple:
    import hashlib

    from vision_kit_tpu_torch.data import mpeg4

    bad, ms, small = [], {}, []
    manifest = video_manifest()
    for name, route in ((hd, "cpp"), (small_clip, "cpp"), (small_clip, "plain")):
        frames = movie_frames(os.path.join(VIDEO_SAMPLES, name))
        best = [float("inf")] * len(frames)
        for p in range(reps if route == "cpp" else 1):
            dec = decoder("cuda" if route == "cpp" else "cpu")
            for i, data in enumerate(frames):
                t0 = time.perf_counter()
                planes = dec.decode(data)
                best[i] = min(best[i], (time.perf_counter() - t0) * 1000)
                if p:
                    continue
                if route == "plain":
                    if not (all(np.array_equal(a, b) for a, b in zip(planes, small[i][0]))
                            and dec.range() == small[i][1]):
                        bad.append(f"{name} frame {i}: the C++ planes differ from the plain")
                    continue
                if name == small_clip:
                    small.append((planes, dec.range()))
                rgb = mpeg4.yuv420_to_rgb(*(torch.from_numpy(q).to(device) for q in planes),
                                          dec.range())
                digest = hashlib.sha256(rgb.cpu().numpy().tobytes()).hexdigest()
                if digest != manifest[name]["rgb_sha256"][i]:
                    bad.append(f"{name} frame {i}: the C++ decoder's RGB is not cv2's")
            dec.close()
        if name == hd or route == "plain":
            keys = [is_key(f) for f in frames]
            ms[route] = {kind: float(np.median([b for b, k in zip(best, keys) if k == want]))
                         for kind, want in (("key", True), ("inter", False))}
    return bad, ms


# -- the tags and containers of the codecs above -------------------------------

TAG_SAMPLES = os.path.join(VIDEO_SAMPLES, "tags")
MJ2_MOV = "mjp2_64x96.mov"          # the demo's Motion JPEG 2000 run on the card


def tag_manifest() -> dict:
    """data/video_samples/tags/MANIFEST.json's files
    (tests/torch_video_tag_samples.py): each fixture's cv2 count, fps,
    frames read and their sha256; for Motion-JPEG the port's plain frames'
    sha256 and their largest difference from cv2's."""
    import json

    with open(os.path.join(TAG_SAMPLES, "MANIFEST.json")) as f:
        return json.load(f)["files"]


def tag_disagreements(device="cuda") -> tuple:
    """Every fixture of data/video_samples/tags/ through VideoReader on
    `device`, threaded and unthreaded: cv2's count (len) and fps, cv2's
    number of frames and then one (False, None); the plain read on the CPU
    at the manifest's sha256 (cv2's frames; for Motion-JPEG the port's
    plain frames, libjpeg's, within the manifest's max_abs of cv2's);
    the device's frames equal to the plain ones bit for bit (nvJPEG's
    Motion-JPEG within decode.NVJPEG_TOLERANCE). On a CUDA device the
    Motion JPEG 2000 frames go through the host C++ twin in its video mode
    (jp2.video_counts["host_cpp"]) and none counts as a still image
    (decode.route_counts["host_jp2"]). Returns (disagreements, {name:
    {"codec", "route": the reader's decoder, "frames", "s": host-clock
    seconds of the three reads}})."""
    import hashlib

    from vision_kit_tpu_torch.data import jp2
    from vision_kit_tpu_torch.utils.readers import VideoReader

    def digests(frames):
        return [hashlib.sha256(f.cpu().numpy().tobytes()).hexdigest() for f in frames]

    def read(path, what, **kw):
        reader = VideoReader(path, **kw)
        meta_count = (reader.total_frames, reader.fps)
        items = list(iter(reader))      # len() raises for cv2's negative counts
        reader.stop()
        if items[-1] != (False, None) or not all(ok for ok, _ in items[:-1]):
            bad.append(f"{what}: the stream did not end with one (False, None)")
        return reader, meta_count, [f for ok, f in items if ok]

    bad, info = [], {}
    card = torch.device(device).type == "cuda"
    stills, twin = decode.route_counts["host_jp2"], jp2.video_counts["host_cpp"]
    for name, meta in tag_manifest().items():
        path = os.path.join(TAG_SAMPLES, name)
        t0 = time.perf_counter()
        _, _, plain = read(path, f"{name} plain", device="cpu", use_thread=False)
        key = "plain_rgb_sha256" if "plain_rgb_sha256" in meta else "rgb_sha256"
        if digests(plain) != meta[key]:
            bad.append(f"{name}: the plain read is not the manifest's {key}")
        for use_thread in (True, False):
            what = f"{name} on {device}, use_thread={use_thread}"
            reader, (count, fps), frames = read(path, what, device=device,
                                                use_thread=use_thread)
            if (count, fps, len(frames)) != (meta["frames"], meta["fps"], meta["read"]):
                bad.append(f"{what}: {len(frames)} frames, count {count} at {fps} fps, not "
                           f"the manifest's {meta['read']}, {meta['frames']} at {meta['fps']}")
            for i, (got, want) in enumerate(zip(frames, plain)):
                if got.device.type != torch.device(device).type:
                    bad.append(f"{what}: frame {i} on {got.device}")
                elif reader.decoder == "nvjpeg":
                    agreement = decode.pixel_agreement(got, want.numpy())
                    if any(agreement[k] > v for k, v in decode.NVJPEG_TOLERANCE.items()):
                        bad.append(f"{what}: nvJPEG frame {i} {agreement}")
                elif not torch.equal(got.cpu(), want):
                    bad.append(f"{what}: frame {i} differs from the plain read")
        info[name] = {"codec": meta["codec"], "route": reader.decoder, "frames": len(frames),
                      "s": time.perf_counter() - t0}
    if card and jp2.video_counts["host_cpp"] == twin:
        bad.append("the Motion JPEG 2000 frames did not go through the C++ twin")
    if decode.route_counts["host_jp2"] != stills:
        bad.append("a video-mode JPEG 2000 decode counted as a host_jp2 still image")
    return bad, info
