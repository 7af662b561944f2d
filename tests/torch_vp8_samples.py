"""VP8 streams and clips for the port's VP8 tests (tests/test_torch_vp8*.py)
and the committed fixtures.

- `write_cv2(path, frames)`: cv2.VideoWriter's VP80 (libvpx) in the
  container the name gives (.webm, .mkv, .avi, .ivf); `read_cv2(path)`
  gives cv2.VideoCapture's RGB frames, fps and frame count.
- `StreamWriter`: random VP8 frames that use every option of the syntax.
  It is the port's decoder run over recording readers
  (data/vp8.py:Vp8Decoder with its readers and token decode replaced):
  where the decoder reads a decision, the writer draws it (a bit at the
  decision's own probability, so headers, modes and vectors come out as
  often as a coder's probabilities make them), records it with its
  probability, and the recorded decisions are coded by `BoolWriter`
  (libvpx's boolean encoder). The coefficient tokens are drawn small
  enough for the IDCT's 16-bit SIMD paths (`_tokens`). The frame tag's
  version, show_frame and a key frame's size are the caller's. cv2 is the
  judge: a parse that differs from libavcodec's reads the stream otherwise.
- `write_ivf(path, frames, width, height)` and `webm(path, frames, ...)`
  (tests/torch_mkv_samples.py's builder with a V_VP8 track) hold them.
- `with_tag(frame, version=, show=)` rewrites a frame tag; `cut`,
  `flipped` damage a frame.

`python tests/torch_vp8_samples.py` rewrites the committed clips in
vision_kit_tpu_torch/data/video_samples/ and their MANIFEST.json entries.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vision_kit_tpu_torch.data import vp8  # noqa: E402
from vision_kit_tpu_torch.utils.video_bench import (  # noqa: E402
    VIDEO_SAMPLES, VP8_HD as HD_WEBM, VP8_SMALL as SMALL_WEBM)



class BoolWriter:
    """libvpx's vp8_encode_bool, with vp8_stop_encode's 32 padding bits."""

    def __init__(self):
        self.low, self.range, self.count, self.buf = 0, 255, -24, bytearray()

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        rng, low = split, self.low
        if bit:
            low += split
            rng = self.range - split
        shift = vp8.NORM[rng]
        rng <<= shift
        count = self.count + shift
        if count >= 0:
            offset = shift - count
            if (low << (offset - 1)) & 0x80000000:
                x = len(self.buf) - 1
                while x >= 0 and self.buf[x] == 0xFF:
                    self.buf[x] = 0
                    x -= 1
                self.buf[x] += 1
            self.buf.append((low >> (24 - offset)) & 0xFF)
            low = (low << offset) & 0xFFFFFF
            shift = count
            count -= 8
        self.low = (low << shift) & 0xFFFFFFFF
        self.count, self.range = count, rng

    def finish(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        return bytes(self.buf)


def encode(decisions: list) -> bytes:
    w = BoolWriter()
    for bit, prob in decisions:
        w.put(bit, prob)
    return w.finish()


class Recorder:
    """Stands for a partition's reader: draws each decision at its own
    probability (or takes `forced` values first) and records it."""

    def __init__(self, rng: np.random.Generator):
        self.rng, self.decisions, self.forced = rng, [], []

    def put(self, bit: int, prob: int) -> int:
        self.decisions.append((bit, prob))
        return bit

    def bit(self, prob: int) -> int:
        if self.forced:
            return self.put(self.forced.pop(0), prob)
        return self.put(int(self.rng.random() * 256 >= prob), prob)

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _token_bits(rec: Recorder, probs, ctx: int, n: int, values: list) -> int:
    """One block's tokens for `values` (16 signed token values by position)
    from position n on, the way vp8.coeffs reads them; returns what it
    returns."""
    first = n
    nonzero = [i for i in range(n, 16) if values[i]]
    last = nonzero[-1] if nonzero else -1
    p = probs[n][ctx]
    while True:
        if n > last:
            rec.put(0, p[0])
            return n if n > first else first
        rec.put(1, p[0])
        while not values[n]:
            rec.put(0, p[1])
            n += 1
            p = probs[n][0]
        rec.put(1, p[1])
        v = abs(values[n])
        if v == 1:
            rec.put(0, p[2])
            nxt = 1
        else:
            rec.put(1, p[2])
            if v <= 4:
                rec.put(0, p[3])
                rec.put(int(v > 2), p[4])
                if v > 2:
                    rec.put(v - 3, p[5])
            elif v <= 10:
                rec.put(1, p[3])
                rec.put(0, p[6])
                rec.put(int(v > 6), p[7])
                if v > 6:
                    rec.put((v - 7) >> 1, 165)
                    rec.put((v - 7) & 1, 145)
                else:
                    rec.put(v - 5, 159)
            else:
                rec.put(1, p[3])
                rec.put(1, p[6])
                cat = 0 if v <= 18 else 1 if v <= 34 else 2 if v <= 66 else 3
                rec.put(cat >> 1, p[8])
                rec.put(cat & 1, p[9 + (cat >> 1)])
                extra, probs_cat = v - 3 - (8 << cat), vp8.CAT3456[cat]
                for i, prob in enumerate(probs_cat):
                    rec.put((extra >> (len(probs_cat) - 1 - i)) & 1, prob)
            nxt = 2
        rec.put(int(values[n] < 0), 0x80)
        n += 1
        if n == 16:
            return 16
        p = probs[n][nxt]


class StreamWriter(vp8.Vp8Decoder):
    """Random VP8 frames (see the module docstring): `frame(key, ...)`
    gives one frame's bytes and the planes the decoder's own run gave
    (None for a hidden frame)."""

    def __init__(self, seed: int, big_tokens: bool = True):
        super().__init__("cpu")
        self.rng = np.random.default_rng(seed)
        self.big_tokens = big_tokens
        self.recorders = []

    def _bool(self, data, start, size):
        r = Recorder(self.rng)
        self.recorders.append(r)
        return r

    def _partitions(self, data, pos, size, n):
        return [self._bool(data, 0, 0) for _ in range(n)]

    def _is_end(self, r) -> bool:
        return False

    def _coeffs(self, br, out, base, bands, q, y2, top, left) -> int:
        return vp8.mb_coeffs(br, out, base, bands, q, y2, top, left, block=self._tokens)[1]

    def _tokens(self, rec, probs, ctx, dq, n, out, base) -> int:
        """A block's random tokens: empty a third of the time, else each
        position non-zero with a chance falling with its index; values
        mostly 1-4, some categories, all bounded by 1500 / the step so that
        no dequantised value nears the IDCTs' 16-bit range."""
        rng = self.rng
        values = [0] * 16
        if rng.random() > 0.33:
            for i in range(n, 16):
                if rng.random() < (0.5 if i < 3 else 0.15):
                    top = max(1, 1500 // dq[i > 0]) if self.big_tokens else 2
                    r = rng.random()
                    mag = 1 if r < 0.55 else int(rng.integers(2, 5)) if r < 0.8 else \
                        int(rng.integers(5, 11)) if r < 0.9 else int(rng.integers(11, 2115))
                    values[i] = min(mag, top) * (1 if rng.random() < 0.5 else -1)
        result = _token_bits(rec, probs, ctx, n, values)
        for i in range(n, 16):
            v = values[i] * dq[i > 0]
            out[base + vp8.ZIGZAG[i]] = ((v + 32768) & 0xFFFF) - 32768
        return result

    def frame(self, key: bool, width: int = 0, height: int = 0, version: int = 0,
              show: bool = True, forced: list | None = None, full_range: bool = False) -> tuple:
        """One frame: (its bytes, the decoder's planes or None). `forced`
        gives the first decisions of the first partition (after the colour
        space and clamping bits of a key frame, the clamping bit
        `full_range`)."""
        self.recorders = []
        fake = bytes([(0 if key else 1) | version << 1 | int(show) << 4 | 1 << 5, 0, 0])
        if key:
            fake += vp8.START_CODE + struct.pack("<HH", width, height)
        fake += bytes(16)
        pending = list(forced or [])
        orig_bool = self._bool

        def first(data, start, size):
            r = orig_bool(data, start, size)
            r.forced = ([int(self.rng.integers(2)), int(full_range)] if key else []) + pending
            self._bool = orig_bool
            return r

        self._bool = first
        try:
            planes = self._decode_plain(fake)
        finally:
            self._bool = orig_bool
        p0, *parts = (encode(r.decisions) for r in self.recorders)
        tag = (0 if key else 1) | version << 1 | int(show) << 4 | len(p0) << 5
        out = tag.to_bytes(3, "little")
        if key:
            out += vp8.START_CODE + struct.pack("<HH", width, height)
        out += p0 + b"".join(len(p).to_bytes(3, "little") for p in parts[:-1]) + b"".join(parts)
        return out, planes


def random_stream(seed: int, width: int, height: int, n: int, *, versions=(0,),
                  hidden: float = 0.0, key_every: int = 0, full_range: bool = False) -> tuple:
    """n random frames (a key frame first, then inter frames, a key frame
    every `key_every` when set, each of a version drawn from `versions`, a
    share `hidden` of the inter frames with show_frame 0, the key frames'
    clamping bit `full_range`): (frames, the writer's own planes of each
    shown frame)."""
    w = StreamWriter(seed)
    rng = np.random.default_rng(seed + 1)
    frames, shown = [], []
    for i in range(n):
        key = i == 0 or (key_every and i % key_every == 0)
        version = int(rng.choice(versions))
        show = key or rng.random() >= hidden
        data, planes = w.frame(key, width, height, version, show, full_range=full_range)
        frames.append(data)
        if planes is not None:
            shown.append(planes)
    return frames, shown


def with_tag(frame: bytes, version: int | None = None, show: bool | None = None) -> bytes:
    """`frame` with its tag's version or show_frame rewritten."""
    tag = frame[0]
    if version is not None:
        tag = (tag & ~0x0E) | version << 1
    if show is not None:
        tag = (tag & ~0x10) | int(show) << 4
    return bytes([tag]) + frame[1:]


def cut(frame: bytes, keep: int) -> bytes:
    return frame[:keep]


def flipped(frame: bytes, rng: np.random.Generator, n: int = 1) -> bytes:
    """`frame` with n random bits past its tag flipped."""
    b = bytearray(frame)
    for _ in range(n):
        i = int(rng.integers(3 if len(b) > 3 else 0, len(b)))
        b[i] ^= 1 << int(rng.integers(8))
    return bytes(b)


def write_ivf(path: str, frames: list, width: int, height: int, rate: int = 30,
              scale: int = 1, pts: list | None = None, length: int | None = None) -> None:
    """An IVF file as libavformat's ivf muxer writes one: the 32-byte DKIF
    header (version 0, fourcc VP80, the size, rate and scale, the length)
    and a 12-byte header a frame (size, 64-bit pts)."""
    pts = list(range(len(frames))) if pts is None else pts
    with open(path, "wb") as f:
        f.write(b"DKIF" + struct.pack("<HH4sHHIIII", 0, 32, b"VP80", width, height, rate, scale,
                                      len(frames) if length is None else length, 0))
        for data, t in zip(frames, pts):
            f.write(struct.pack("<IQ", len(data), t) + data)


def webm(path: str, frames: list, width: int, height: int, fps: float | None = 30.0,
         **kw) -> None:
    """A WebM file of VP8 frames (a V_VP8 track, one SimpleBlock a frame,
    keyframe flags from the frame tags)."""
    from torch_mkv_samples import build

    keys = [bool(f) and not f[0] & 1 for f in frames]
    build(path, frames, keys, width, height, codec_id="V_VP8", fps=fps, doc="webm", **kw)


def write_cv2(path: str, frames: list, fps: float = 30.0) -> None:
    """cv2.VideoWriter's VP80 of RGB frames."""
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"VP80"), fps, (w, h))
    assert wr.isOpened(), path
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()


def read_cv2(path: str) -> tuple:
    """cv2.VideoCapture's (RGB frames, CAP_PROP_FPS, CAP_PROP_FRAME_COUNT)."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(np.ascontiguousarray(f[..., ::-1]))
    cap.release()
    return frames, fps, count


def read_cv2_y(path: str) -> list:
    """cv2.VideoCapture's Y planes (CAP_PROP_CONVERT_RGB 0 hands the
    decoder's luma on as one 8-bit channel), which isolate the decode from
    swscale's conversion: at an odd height its RGB differs from
    yuv420_to_rgb (a known difference of the port's MPEG-4 frames too)."""
    import cv2

    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    planes = []
    while True:
        ok, y = cap.read()
        if not ok:
            break
        planes.append(y.reshape(y.shape[0], -1))
    cap.release()
    return planes


def rgb(planes, full_range: bool = False) -> np.ndarray:
    import torch

    from vision_kit_tpu_torch.data import mpeg4

    return mpeg4.yuv420_to_rgb(*(torch.from_numpy(p) for p in planes), full_range).numpy()


def write() -> dict:
    """Write the committed VP8 clips (cv2's VP80 in WebM: a small pan and
    12 frames of the 720x1280 samples) and return their manifest entries
    (cv2's frames' sha256)."""
    from torch_mpeg4_samples import hd_frames, moving

    out = {}
    for name, frames in ((SMALL_WEBM, moving("pan", 144, 176, 10, 3)),
                         (HD_WEBM, hd_frames()[:12])):
        path = os.path.join(VIDEO_SAMPLES, name)
        write_cv2(path, frames)
        got, fps, count = read_cv2(path)
        with open(path, "rb") as f:
            data = f.read()
        h, w = got[0].shape[:2]
        out[name] = dict(sha256=hashlib.sha256(data).hexdigest(), bytes=len(data), fps=fps,
                         frames=int(count), height=h, width=w,
                         rgb_sha256=[hashlib.sha256(f.tobytes()).hexdigest() for f in got])
    return out


if __name__ == "__main__":
    path = os.path.join(VIDEO_SAMPLES, "MANIFEST.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["files"].update(write())
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
