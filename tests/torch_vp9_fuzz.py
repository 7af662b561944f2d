"""Seeded VP9 streams against cv2.VideoCapture, by the thousand: a sweep
beyond tests/test_torch_vp9.py's cases (a few minutes a few hundred seeds
here).

    python tests/torch_vp9_fuzz.py random 400 1000     # seeds 400..999
    python tests/torch_vp9_fuzz.py damaged 0 1000

"random": torch_vp9_samples.random_stream with every option (hidden
frames in superframes, intra-only frames, frames showing a reference,
key frames every 0-5, lossless frames, the segment skip feature, even
heights), 8 packets in IVF. "damaged": 6 such packets, one of them cut or
bit-flipped. Each stream goes through the port's VideoReader (the plain
decoder) and cv2 with OPENCV_FFMPEG_THREADS=1 (the single-threaded decoder
the port follows); the script prints each differing seed and the counts.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

os.environ.setdefault("OPENCV_FFMPEG_THREADS", "1")
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_vp9_samples import cut, flipped, random_stream, read_cv2, write_ivf  # noqa: E402
from vision_kit_tpu_torch.utils.readers import VideoReader  # noqa: E402


def stream(kind: str, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(8, 80)), 2 * int(rng.integers(4, 32))
    if kind == "random":
        frames, _ = random_stream(seed, w, h, 8, key_every=int(rng.integers(0, 6)),
                                  lossless=0.2, skip_feature=True)
        return frames, w, h
    frames, _ = random_stream(seed, w, h, 6)
    i = int(rng.integers(0, 6))
    if rng.random() < 0.5:
        frames[i] = cut(frames[i], int(rng.integers(0, len(frames[i]))))
    else:
        frames[i] = flipped(frames[i], rng, int(rng.integers(1, 4)))
    return frames, w, h


def main(kind: str, first: int, last: int) -> None:
    differ = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.ivf")
        for seed in range(first, last):
            frames, w, h = stream(kind, seed)
            write_ivf(path, frames, w, h)
            want, _, _ = read_cv2(path)
            try:
                got = [f.numpy() for ok, f in VideoReader(path, device="cpu", use_thread=False)
                       if ok]
            except ValueError as e:       # a refusal by name (vp9.Vp9Unsupported)
                differ.append(seed)
                print(f"seed {seed}: refused ({e}); cv2 gives {len(want)} frames", flush=True)
                continue
            if len(got) != len(want) or not all(np.array_equal(a, b)
                                                for a, b in zip(got, want)):
                differ.append(seed)
                print(f"seed {seed}: {len(got)} frames against cv2's {len(want)}, equal "
                      f"{[bool(np.array_equal(a, b)) for a, b in zip(got, want)]}", flush=True)
    print(f"{kind} seeds {first}..{last - 1}: {len(differ)} of {last - first} differ {differ}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
