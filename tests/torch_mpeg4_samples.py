"""The MPEG-4 Part 2 clips that the port's video path is held to on the
card (vision_kit_tpu_torch/data/video_samples/), written with this
environment's cv2 (OpenCV 5.0.0's FFMPEG writer, libavcodec 62), and the
clip helpers the CPU tests share. The card's machine has no cv2, so the
clips and the sha256 of cv2's decode of every frame are committed:

    python tests/torch_mpeg4_samples.py     # rewrites the folder

The folder sits beside data/samples/, whose files are images that the
decode tests and the demo read one by one. It holds:

  * mp4v_720x1280_24f.mp4: the three committed 720x1280 JPEG samples, eight
    frames each, shifted 3 columns and 2 rows a frame (cv2.VideoWriter,
    fourcc mp4v, 30 fps): I-VOPs at frames 0, 8 and 16, P-VOPs between;
  * mp4v_144x176_fmp4.avi: a seeded 144x176 scene panning 2 columns a
    frame, 10 frames, fourcc FMP4 in AVI (the VOL in the first chunk);
  * mp4v_720x1280_24f.mkv: the 720p clip's 24 frames in Matroska
    (cv2.VideoWriter, fourcc mp4v, 30 fps: V_MPEG4/ISO/ASP, the VOL in
    CodecPrivate);
  * mjpg_144x176_10f.mkv: the small clip's 10 frames as Motion-JPEG in
    Matroska (fourcc MJPG: V_MJPEG);
  * xvid_144x176_6f.avi: random_stream(5, 176, 144, 6) in an AVI tagged
    XVID without user data (utils/avi.py's AviWriter), which libavcodec
    decodes with its XviD IDCT and edge and DC workarounds.

MANIFEST.json gives each file's sha256, bytes, frame count, fps and size
and `rgb_sha256`: the sha256 of each frame that cv2.VideoCapture reads
(BGR2RGB), which the port's MPEG-4 decoders equal bit for bit; a
Motion-JPEG file also has `imdecode_rgb_sha256`, libjpeg's frames
(cv2.imdecode of each packet), which the port's plain JPEG decoder equals.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO_SAMPLES = os.path.join(REPO, "vision_kit_tpu_torch", "data", "video_samples")
SAMPLES = os.path.join(REPO, "vision_kit_tpu_torch", "data", "samples")
HD_CLIP, SMALL_CLIP = "mp4v_720x1280_24f.mp4", "mp4v_144x176_fmp4.avi"
HD_MKV, MJPEG_MKV, XVID_AVI = "mp4v_720x1280_24f.mkv", "mjpg_144x176_10f.mkv", "xvid_144x176_6f.avi"


def write_cv2(path: str, frames: list, fourcc: str = "mp4v", fps: float = 30.0) -> None:
    """RGB frames through cv2.VideoWriter's FFMPEG backend."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), fps,
                             (w, h))
    assert writer.isOpened(), path
    for rgb in frames:
        writer.write(np.ascontiguousarray(rgb[..., ::-1]))
    writer.release()


def read_cv2(path: str) -> tuple:
    """(RGB frames, CAP_PROP_FRAME_COUNT, CAP_PROP_FPS) of cv2.VideoCapture."""
    import cv2

    cap = cv2.VideoCapture(path)
    assert cap.isOpened(), path
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(bgr[..., ::-1]))
    out = frames, cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return out


def raw_packets(path: str) -> list:
    """cv2's undecoded packets (CAP_PROP_FORMAT -1), one per frame."""
    import cv2

    cap = cv2.VideoCapture(path)
    assert cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, packet = cap.read()
        if not ok:
            break
        out.append(packet.ravel().tobytes())
    cap.release()
    return out


def moving(kind: str, h: int, w: int, n: int, seed: int) -> list:
    """n RGB frames of a seeded scene: "static" (the same frame), "pan"
    (shifted 2 columns and 1 row a frame), "noise" (the scene under fresh
    Gaussian noise, sigma 12, each frame)."""
    from torch_samples import scene

    rng = np.random.default_rng(seed)
    base = scene(h + n, w + 2 * n, seed)
    frames = []
    for i in range(n):
        if kind == "static":
            f = base[:h, :w]
        elif kind == "pan":
            f = base[i:i + h, 2 * i:2 * i + w]
        else:
            f = np.clip(base[:h, :w] + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        frames.append(np.ascontiguousarray(f))
    return frames


def hd_frames() -> list:
    """The 24 frames of mp4v_720x1280_24f.mp4."""
    import sys

    sys.path.insert(0, REPO)
    from vision_kit_tpu_torch.data.decode import decode_image

    names = [f"frame{i}_720x1280_420_q90.jpg" for i in range(3)]
    imgs = []
    for name in names:
        with open(os.path.join(SAMPLES, name), "rb") as f:
            imgs.append(decode_image(f.read()))
    return [np.ascontiguousarray(np.roll(imgs[i // 8], (2 * (i % 8), 3 * (i % 8)), axis=(0, 1)))
            for i in range(24)]


def random_avi(path: str, seed: int, width: int, height: int, n: int,
               fourcc: bytes = b"XVID", user_data: bytes = b"", fps: float = 30.0) -> None:
    """random_stream(seed, width, height, n, user_data=user_data) in an AVI
    of `fourcc` (the headers in the first chunk)."""
    import sys

    sys.path.insert(0, REPO)
    from vision_kit_tpu_torch.utils.avi import AviWriter

    headers, vops = random_stream(seed, width, height, n, user_data=user_data)
    with AviWriter(path, fps, fourcc) as w:
        for i, (vop, key) in enumerate(vops):
            w.write((headers if i == 0 else b"") + vop, width, height, key)


def write() -> dict:
    os.makedirs(VIDEO_SAMPLES, exist_ok=True)
    small = moving("pan", 144, 176, 10, seed=7)
    clips = {HD_CLIP: (hd_frames(), "mp4v"), SMALL_CLIP: (small, "FMP4"),
             HD_MKV: (hd_frames(), "mp4v"), MJPEG_MKV: (small, "MJPG"), XVID_AVI: None}
    files = {}
    for name, clip in clips.items():
        path = os.path.join(VIDEO_SAMPLES, name)
        if clip is None:
            random_avi(path, 5, 176, 144, 6)
        else:
            write_cv2(path, *clip)
        got, count, fps = read_cv2(path)
        with open(path, "rb") as f:
            data = f.read()
        files[name] = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
                       "frames": int(count), "fps": fps,
                       "width": int(got[0].shape[1]), "height": int(got[0].shape[0]),
                       "rgb_sha256": [hashlib.sha256(g.tobytes()).hexdigest() for g in got]}
        if clip is not None and clip[1] == "MJPG":
            # libjpeg's frames (cv2.imdecode of each packet), which the port's
            # plain JPEG decoder equals; cv2's FFMPEG capture decodes MJPEG
            # otherwise
            import cv2

            files[name]["imdecode_rgb_sha256"] = [
                hashlib.sha256(cv2.cvtColor(cv2.imdecode(np.frombuffer(pkt, np.uint8),
                                                         cv2.IMREAD_COLOR),
                                            cv2.COLOR_BGR2RGB).tobytes()).hexdigest()
                for pkt in raw_packets(path)]
    path = os.path.join(VIDEO_SAMPLES, "MANIFEST.json")
    others = {}
    if os.path.exists(path):   # the entries other writers keep (torch_vp8_samples.py)
        with open(path) as f:
            others = {k: v for k, v in json.load(f)["files"].items() if k not in clips}
    manifest = {"writer": "cv2.VideoWriter (OpenCV 5.0.0, FFMPEG, libavcodec 62)",
                "files": {**others, **files}}
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


# -- random streams: every syntax element cv2's mp4v writer leaves out --------

def random_stream(seed: int, width: int, height: int, n_frames: int,
                  resync: bool = False, mpeg_quant: bool = False, bright: bool = False,
                  user_data: bytes = b"") -> tuple:
    """(VOS/VO/VOL headers, VOPs) of a random but valid MPEG-4 Simple
    Profile stream: I-VOPs then P-VOPs with random MB types (not coded,
    inter 1MV and 4MV, intra, each with and without dquant), MCBPC
    stuffing, AC prediction, random intra_dc_vlc_thr (the intra DC coded as
    a TCOEF above it), vop_rounding_type and fcode 1-3, random motion
    vector data, coefficients of every escape mode, video packets after
    resync markers (`resync`), MPEG quantisation with loaded matrices
    (`mpeg_quant`). `bright`: every intra DC is VLC-coded, the first of
    each VOP 200-255 above its prediction and every other one equal to
    its prediction, so that a DC past 2047 spreads through the VOP by
    prediction alone (libavcodec's DC clip bug keeps it there; a DC
    below 0, which libavcodec refuses, never comes).
    `user_data` goes into a user_data() after the VOL. Its pixels mean
    nothing; decoders must agree on them."""
    from vision_kit_tpu_torch.data import mpeg4 as m

    rng = np.random.default_rng(seed)
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    n_mb = mbw * mbh
    mb_bits = max((n_mb - 1).bit_length(), 1)
    h = m._BitWriter()
    h.put(0x1B0, 32), h.put(1, 8), h.put(0x100, 32), h.put(0x120, 32)
    h.put(0, 1), h.put(1, 8), h.put(0, 1), h.put(1, 4)            # verid 1
    h.put(0, 1), h.put(0, 2), h.put(1, 1), h.put(30, 16), h.put(1, 1), h.put(0, 1)
    h.put(1, 1), h.put(width, 13), h.put(1, 1), h.put(height, 13), h.put(1, 1)
    h.put(0, 1), h.put(1, 1), h.put(0, 1), h.put(0, 1)          # progressive, 8-bit
    h.put(int(mpeg_quant), 1)
    mmax = 39                                                    # the largest entry
    if mpeg_quant:
        for _ in range(2):                                       # load both matrices
            h.put(1, 1)
            vals = rng.integers(8, mmax + 1, 64)
            cut = int(rng.integers(20, 64))
            for v in vals[:cut]:
                h.put(int(v), 8)
            if cut < 64:
                h.put(0, 8)
    h.put(1, 1), h.put(0 if resync else 1, 1), h.put(0, 1), h.put(0, 1)
    h.stuff()
    headers = h.bytes() + (b"\0\0\1\xb2" + user_data if user_data else b"")

    def vlc(w, table, key):
        code, n = m._bits(table[key])
        w.put(code, n)

    def coefficients(w, start, intra, big_ok, q):
        """Random run/levels from scan index `start`: mostly small levels,
        some past LMAX (escape 1), long runs (escape 2) and big ones
        (escape 3, away from the first row and column when `big_ok` is
        False: AC prediction sums them along a row of MBs), each within
        what a real encoder sends (dequantised below 1024; libavcodec's
        x86 IDCT saturates a row where the plain C one wraps)."""
        levels = np.zeros(64, np.int64)
        k = int(rng.integers(1, 7))
        pos = np.sort(rng.choice(np.arange(start, 64), size=min(k, 64 - start),
                                 replace=False))
        for p in pos:
            r = rng.random()
            mag = (int(rng.integers(1, 4)) if r < 0.6 else int(rng.integers(4, 16))
                   if r < 0.9 else int(rng.integers(16, 60)))
            if not big_ok and p < 8 + 8:
                mag = min(mag, 3)
            cap = 1024 * 16 // (2 * q * mmax) if mpeg_quant else (1024 - q) // (2 * q)
            mag = max(1, min(mag, cap))
            levels[p] = mag * (1 if rng.random() < 0.5 else -1)
        blk, idx, c, n = m._tcoef_codes(levels[None], start,
                                        m._INTRA_ENC if intra else m._INTER_ENC)
        for code, length in zip(c, n):
            w.put(int(code), int(length))

    vops = []
    for f in range(n_frames):
        intra_vop = f == 0 or rng.random() < 0.15
        w = m._BitWriter()
        q = int(rng.integers(2, 16))
        fcode = int(rng.integers(1, 4))
        thr = 0 if bright else int(rng.integers(0, 8))
        first_dc = bright
        w.put(0x1B6, 32), w.put(0 if intra_vop else 1, 2), w.put(0, 1), w.put(1, 1)
        w.put(f % 30, 5), w.put(1, 1), w.put(1, 1)
        if not intra_vop:
            w.put(int(rng.integers(0, 2)), 1)
        w.put(thr, 3), w.put(q, 5)
        if not intra_vop:
            w.put(fcode, 3)
        threshold = m.DC_THRESHOLD[thr]
        for i in range(n_mb):
            if resync and i and rng.random() < 0.08:
                w.stuff()
                marker = 17 if intra_vop else 16 + fcode
                w.put(1, marker), w.put(i, mb_bits)
                q = int(rng.integers(2, 16))
                w.put(q, 5), w.put(0, 1)
            if not intra_vop:
                if rng.random() < 0.05:
                    w.put(0, 1), vlc(w, m.MCBPC_P, "stuff")
                if rng.random() < 0.2:
                    w.put(1, 1)                                  # not coded
                    continue
                w.put(0, 1)
                mb_type = int(rng.choice(5, p=[0.4, 0.15, 0.2, 0.15, 0.1]))
            else:
                if rng.random() < 0.05:
                    vlc(w, m.MCBPC_I, "stuff")
                mb_type = int(rng.integers(3, 5))
            cbpc, cbpy = int(rng.integers(0, 4)), int(rng.integers(0, 16))
            vlc(w, m.MCBPC_P if not intra_vop else m.MCBPC_I, (mb_type, cbpc))
            intra = mb_type >= 3
            ac_pred = int(rng.integers(0, 2)) if intra else 0
            if intra:
                w.put(ac_pred, 1)
            vlc(w, dict(enumerate(m.CBPY)), cbpy if intra else 15 - cbpy)
            use_dc_vlc = q < threshold
            if mb_type in (1, 4):
                d = int(rng.integers(0, 4))
                w.put(d, 2)
                q = min(max(q + m.DQUANT[d], 1), 31)
            if not intra:
                for _ in range(4 if mb_type == 2 else 1):
                    for _ in range(2):
                        k = int(rng.choice(33, p=np.r_[[0.3, 0.2, 0.15, 0.1, 0.08],
                                                       np.full(28, 0.17 / 28)]))
                        vlc(w, dict(enumerate(m.MVD)), k)
                        if k:
                            w.put(int(rng.integers(0, 2)), 1)
                            if fcode > 1:
                                w.put(int(rng.integers(0, 1 << (fcode - 1))), fcode - 1)
            cbp = cbpy << 2 | cbpc
            for n in range(6):
                coded = bool(cbp & (32 >> n))
                if intra and use_dc_vlc:
                    size = 8 if first_dc else 0 if bright else int(rng.integers(0, 3))
                    vlc(w, dict(enumerate(m.DC_SIZE_LUMA if n < 4 else m.DC_SIZE_CHROMA)), size)
                    if size:
                        w.put(int(rng.integers(200, 256) if first_dc else
                                  rng.integers(0, 1 << size)), size)
                    first_dc = False
                if coded:
                    coefficients(w, 1 if intra and use_dc_vlc else 0, intra, not ac_pred, q)
        w.stuff()
        vops.append((w.bytes(), intra_vop))
    return headers, vops


if __name__ == "__main__":
    m = write()
    print({k: v["bytes"] for k, v in m["files"].items()})
