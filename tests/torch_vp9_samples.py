"""VP9 streams and clips for the port's VP9 tests (tests/test_torch_vp9*.py)
and the committed fixtures.

- `write_cv2(path, frames)`: cv2.VideoWriter's VP90 (libvpx) in the
  container the name gives (.webm, .mkv, .avi, .ivf, .mp4); `read_cv2`
  gives cv2.VideoCapture's RGB frames, fps and frame count.
- `StreamWriter`: random VP9 frames that use every profile-0 option of the
  syntax. It is the port's decoder run over recording readers
  (data/vp9.py:Vp9Decoder with its readers replaced): where the decoder
  reads a boolean decision, the writer draws it at the decision's own
  probability and records it; where it reads a header field, the writer
  picks a value (`_pick`) and records its bits. The recorded decisions are
  coded by libvpx's boolean encoder (tests/torch_vp8_samples.py's
  BoolWriter, vpx_writer's arithmetic, with vpx_stop_encode's padding and
  its guard byte). Coefficient tokens are chosen small (`_token_values`),
  as an encoder's are, so that no inverse transform leaves 16 bits. cv2 is
  the judge: a parse that differs from libavcodec's reads the stream
  otherwise.
- `superframe(frames)` packs frames behind a superframe index;
  `show_existing(idx)` is a frame that shows reference slot idx.
- `write_ivf(path, frames, width, height)` and `webm(path, frames, ...)`
  (tests/torch_mkv_samples.py's builder with a V_VP9 track) hold them.

`python tests/torch_vp9_samples.py` rewrites the committed clips in
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

from torch_vp8_samples import BoolWriter, read_cv2, read_cv2_y, rgb  # noqa: E402,F401
from vision_kit_tpu_torch.data import vp9  # noqa: E402
from vision_kit_tpu_torch.utils.video_bench import (  # noqa: E402
    VIDEO_SAMPLES, VP9_HD as HD_WEBM, VP9_SMALL as SMALL_WEBM)


def encode(decisions: list) -> bytes:
    """vpx_start_encode .. vpx_stop_encode over the recorded decisions (the
    first of them the marker bit)."""
    w = BoolWriter()
    for bit, prob in decisions:
        w.put(bit, prob)
    out = bytearray(w.finish())
    if out and out[-1] & 0xE0 == 0xC0:
        out.append(0)
    return bytes(out)


class Recorder:
    """Stands for a boolean decoder: takes `forced` bits first, then draws
    each decision at its own probability, and records it."""

    def __init__(self, rng: np.random.Generator, forced=None):
        self.rng, self.decisions, self.forced = rng, [], list(forced or [])

    def bit(self, prob: int) -> int:
        b = self.forced.pop(0) if self.forced else int(self.rng.random() * 256 >= prob)
        self.decisions.append((b, prob))
        return b

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v


class HeaderRecorder:
    """Stands for the uncompressed header's bit reader: each field's value
    comes from the writer's `_pick` and is recorded with its width."""

    def __init__(self, pick):
        self.pick, self.fields = pick, []

    def f(self, n: int, name: str = "") -> int:
        v = self.pick(name, n)
        self.fields.append([name, v, n])
        return v

    def su(self, n: int, name: str = "") -> int:
        v = self.f(n, name)
        return -v if self.f(1, name + "_sign") else v

    def byte_pos(self) -> int:
        return 0

    def bytes(self, header_size: int) -> bytes:
        bits = []
        for name, v, n in self.fields:
            if name == "header_size_in_bytes":
                v = header_size
            bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        bits += [0] * (-len(bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def token_bits(values: list) -> list:
    """The decisions that code `values` (signed token values in scan order,
    the last non-zero one last) the way Vp9Decoder._tokens reads them."""
    bits = []
    n, i = len(values), 0
    max_eob = None
    while True:
        if i >= n:
            bits.append(0)                          # end of block
            break
        bits.append(1)
        while values[i] == 0:
            bits.append(0)
            i += 1
        bits.append(1)
        v = abs(values[i])
        if v == 1:
            bits.append(0)
        else:
            bits.append(1)
            if v <= 4:
                bits += {2: [0, 0], 3: [0, 1, 0], 4: [0, 1, 1]}[v]
            else:
                cat = next(k for k in range(5, -1, -1) if v >= vp9.CAT_BASE[k])
                bits += ([1, 0, 0], [1, 0, 1], [1, 1, 0, 0], [1, 1, 0, 1], [1, 1, 1, 0],
                         [1, 1, 1, 1])[cat]
                extra, nb = v - vp9.CAT_BASE[cat], len(vp9.CAT_PROBS[cat])
                bits += [(extra >> (nb - 1 - k)) & 1 for k in range(nb)]
        bits.append(int(values[i] < 0))
        i += 1
        if max_eob is not None and i >= max_eob:
            break
    return bits


class StreamWriter(vp9.Vp9Decoder):
    """Random VP9 frames (see the module docstring): `frame(...)` gives one
    frame's bytes and the planes the decoder's own run gave (None for a
    hidden frame). `opts` bias the draws (each a share of frames or of
    fields): lossless, error_res, seg (segmentation), compound (sign
    biases that allow it), hp, parallel, refresh_ctx, tiles (each tile
    increment), skip_feature (allow the segment skip feature),
    color_spaces (those drawn), big (the coefficients' bound)."""

    def __init__(self, seed: int, **opts):
        super().__init__("cpu")
        self.rng = np.random.default_rng(seed)
        self.opts = dict(lossless=0.0, error_res=0.15, seg=0.5, compound=0.5, big=600,
                         hp=0.5, parallel=0.5, refresh_ctx=0.7, skip_feature=False,
                         color_spaces=(0,), tiles=0.5)
        self.opts.update(opts)
        self.recorders = []
        self.want = {}

    # -- the readers ------------------------------------------------------------------
    def _bits(self, data):
        self.header = HeaderRecorder(self._pick)
        return self.header

    def _bool(self, data, start, size):
        r = Recorder(self.rng, [0])
        self.recorders.append(r)
        return r

    def _tile_readers(self, data, pos, rows, cols):
        self.tiles = []
        for _ in range(rows * cols):
            r = Recorder(self.rng, [0])
            self.tiles.append(r)
        out = list(self.tiles)
        for r in out:
            r.bit(128)        # the marker the decoder checks (already forced to 0)
        return out

    def _is_end(self, br) -> bool:
        return False

    def _header_end(self, r, data) -> None:
        """The header's padding is zeros (HeaderRecorder.bytes)."""

    def _pick(self, name: str, n: int) -> int:
        rng, want, o = self.rng, self.want, self.opts
        if name in want:
            v = want[name]
            if isinstance(v, list):
                return v.pop(0)
            return v
        r = rng.random()
        if name == "frame_marker":
            return 2
        if name in ("profile_low", "profile_high", "reserved_zero", "show_existing_frame"):
            return 0
        if name == "sync_code":
            return vp9.SYNC_CODE
        if name == "color_space":
            return int(rng.choice(o["color_spaces"]))
        if name == "error_resilient_mode":
            return int(r < o["error_res"])
        if name in ("width_minus_1",):
            return self.size[0] - 1
        if name in ("height_minus_1",):
            return self.size[1] - 1
        if name == "base_q_idx":
            return 0 if r < o["lossless"] else int(rng.integers(1, 256))
        if name == "delta_coded":
            base = [v for f, v, _ in self.header.fields if f == "base_q_idx"]
            return 0 if base and base[-1] == 0 else int(r < 0.3)
        if name == "delta_q":
            return int(rng.integers(0, 16))
        if name == "segmentation_enabled":
            return int(r < o["seg"])
        if name == "feature_enabled":
            self._feat = getattr(self, "_feat", -1) + 1
            j = self._feat % 4
            if j == 3 and not o["skip_feature"]:
                return 0
            return int(r < 0.35)
        if name == "feature_value":
            return int(rng.integers(0, 1 << n)) if n else 0
        if name == "loop_filter_level":
            return int(rng.integers(0, 64)) if r < 0.85 else 0
        if name in ("loop_filter_ref_delta", "loop_filter_mode_delta"):
            return int(rng.integers(0, 20))
        if name == "allow_high_precision_mv":
            return int(r < o["hp"])
        if name == "frame_parallel_decoding_mode":
            return int(r < o["parallel"])
        if name == "refresh_frame_context":
            return int(r < o["refresh_ctx"])
        if name == "sign_bias":
            return int(r < o["compound"] * 0.6)
        if name == "header_size_in_bytes":
            return 1
        if name in ("increment_tile_cols_log2", "tile_rows_log2", "increment_tile_rows_log2"):
            return int(r < o["tiles"])
        if name == "found_ref":
            return int(r < 0.6)
        if name in ("segment_prob", "segment_pred_prob"):
            return int(rng.integers(1, 256))
        return int(rng.integers(0, 1 << n))

    # -- the tokens -------------------------------------------------------------------
    def _token_values(self, count: int, dq: tuple) -> list:
        """A block's random token values in scan order: empty a third of the
        time, else a few mostly small values, the dequantised ones bounded."""
        rng = self.rng
        if rng.random() < 0.33:
            return []
        n = int(min(count, rng.geometric(0.25)))
        out = []
        budget = self.opts["big"] * 4
        for i in range(n):
            if rng.random() < (0.6 if i < 3 else 0.35):
                r = rng.random()
                mag = 1 if r < 0.55 else int(rng.integers(2, 5)) if r < 0.8 else \
                    int(rng.integers(5, 19)) if r < 0.93 else int(rng.integers(19, 200))
                step = dq[0 if i == 0 else 1]
                mag = max(1, min(mag, self.opts["big"] // max(step, 1), budget // max(step, 1)))
                budget -= mag * step
                out.append(mag if rng.random() < 0.5 else -mag)
            else:
                out.append(0)
            if budget <= 0:
                break
        while out and out[-1] == 0:
            out.pop()
        return out

    def _tokens(self, br, tx, ptype, ref, ctx, scan, nb, dq, out):
        values = self._token_values(16 << (tx << 1), dq)
        bits = token_bits(values)
        if len(values) == 16 << (tx << 1):
            bits = bits[:-1]                       # no end-of-block after the last position
        br.forced = bits + br.forced
        return super()._tokens(br, tx, ptype, ref, ctx, scan, nb, dq, out)

    # -- frames -------------------------------------------------------------------------
    def frame(self, kind: str = "inter", show: bool = True, width: int = 0, height: int = 0,
              full_range: bool = False, **want) -> tuple:
        """One frame (`kind` key, inter or intra_only): (its bytes, the
        decoder's planes or None). `want` fixes header fields by name."""
        if kind == "key":
            self.size = (width, height)
        self.want = dict(want)
        self.want.setdefault("frame_type", 0 if kind == "key" else 1)
        self.want.setdefault("show_frame", int(show))
        if kind != "key":
            self.want.setdefault("intra_only", int(kind == "intra_only"))
        self.want.setdefault("color_range", int(full_range))
        self._feat = -1
        self.recorders = []
        self.tiles = []
        planes = self._decode_frame(b"\0" * 16)
        comp = encode(self.recorders[0].decisions)
        tiles = [encode(t.decisions) for t in self.tiles]
        out = self.header.bytes(len(comp)) + comp
        for t in tiles[:-1]:
            out += struct.pack(">I", len(t)) + t
        out += tiles[-1]
        return out, planes


def superframe(frames: list) -> bytes:
    """frames behind libvpx's superframe index (sizes in 4 bytes)."""
    mag = 3
    marker = 0xC0 | (mag << 3) | (len(frames) - 1)
    index = bytes([marker]) + b"".join(struct.pack("<I", len(f)) for f in frames) + bytes([marker])
    return b"".join(frames) + index


def show_existing(idx: int) -> bytes:
    """A frame header that shows reference slot idx (frame_marker 2,
    profile 0, show_existing_frame 1)."""
    return bytes([0b10001000 | (idx & 7)])


def random_stream(seed: int, width: int, height: int, n: int, *, key_every: int = 0,
                  hidden: float = 0.15, intra_only: float = 0.1, existing: float = 0.1,
                  full_range: bool = False, **opts) -> tuple:
    """n random packets (a key frame first, then inter frames, intra-only
    frames, hidden frames packed with the next shown one into a superframe,
    and frames showing an existing reference): (packets, the writer's own
    planes of each shown frame)."""
    w = StreamWriter(seed, **opts)
    rng = np.random.default_rng(seed + 1)
    packets, shown = [], []
    pending = []
    i = 0
    while len(packets) < n:
        key = i == 0 or (key_every and i % key_every == 0)
        i += 1
        if not key and not pending and rng.random() < existing:
            slot = int(rng.integers(0, 8))
            if w.refs[slot] is not None:
                data = show_existing(slot)
                planes = w._cropped(w.refs[slot])
                packets.append(data)
                shown.append(planes)
                continue
        if key:
            data, planes = w.frame("key", True, width, height, full_range)
        elif rng.random() < intra_only:
            data, planes = w.frame("intra_only", False)
        else:
            data, planes = w.frame("inter", rng.random() >= hidden)
        if planes is None:
            pending.append(data)
            continue
        packets.append(superframe(pending + [data]) if pending else data)
        pending = []
        shown.append(planes)
    return packets, shown


def write_ivf(path: str, frames: list, width: int, height: int, rate: int = 30,
              scale: int = 1) -> None:
    """An IVF file (fourcc VP90) of the packets, as libavformat's muxer
    writes one."""
    with open(path, "wb") as f:
        f.write(b"DKIF" + struct.pack("<HH4sHHIIII", 0, 32, b"VP90", width, height, rate, scale,
                                      len(frames), 0))
        for t, data in enumerate(frames):
            f.write(struct.pack("<IQ", len(data), t) + data)


def webm(path: str, frames: list, width: int, height: int, fps: float | None = 30.0,
         **kw) -> None:
    """A WebM file of VP9 packets (a V_VP9 track, one SimpleBlock each)."""
    from torch_mkv_samples import build

    keys = [bool(f) and f[0] >> 6 == 2 and not f[0] & 0x0C for f in frames]
    build(path, frames, keys, width, height, codec_id="V_VP9", fps=fps, doc="webm", **kw)


def write_cv2(path: str, frames: list, fps: float = 30.0) -> None:
    """cv2.VideoWriter's VP90 of RGB frames."""
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"VP90"), fps, (w, h))
    assert wr.isOpened(), path
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()


def cut(frame: bytes, keep: int) -> bytes:
    return frame[:keep]


def flipped(frame: bytes, rng: np.random.Generator, n: int = 1) -> bytes:
    """`frame` with n random bits past its first byte flipped."""
    b = bytearray(frame)
    for _ in range(n):
        i = int(rng.integers(1 if len(b) > 1 else 0, len(b)))
        b[i] ^= 1 << int(rng.integers(8))
    return bytes(b)


def write() -> dict:
    """Write the committed VP9 clips (cv2's VP90 in WebM: a small pan and 12
    frames of the 720x1280 samples) and return their manifest entries."""
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


def vpx_mp4(path: str, frames: list, width: int, height: int, fps: float = 30.0,
            entry: bytes = b"vp08", keys: list | None = None) -> None:
    """An MP4 of VP8 or VP9 packets with a `vp08`/`vp09` sample entry and
    its vpcC box (profile 0, 8 bits, 4:2:0 colocated, limited range,
    BT.601), laid out as utils/mp4.py's Mp4Writer lays out mp4v: cv2 reads
    such a file, though its writer makes none for VP8."""
    from vision_kit_tpu_torch.utils import mp4

    class Writer(mp4.Mp4Writer):
        def _moov(self) -> bytes:
            moov = super()._moov()
            start = moov.index(b"mp4v") - 4
            size = struct.unpack(">I", moov[start:start + 4])[0]
            old = moov[start:start + size]
            vpcc = mp4._full(b"vpcC", 1, 0, bytes([0, 10, (8 << 4) | (1 << 1), 6, 6, 6]),
                             struct.pack(">H", 0))
            new = mp4._box(entry, old[8:8 + 78], vpcc)
            out = moov[:start] + new + moov[start + size:]
            grow = len(new) - len(old)
            for kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"stsd"):
                at = out.index(kind) - 4
                n = struct.unpack(">I", out[at:at + 4])[0]
                out = out[:at] + struct.pack(">I", n + grow) + out[at + 4:]
            return out

    w = Writer(path, fps)
    for i, data in enumerate(frames):
        w.write(data, (keys[i] if keys else i == 0), width, height)
    w.close()
