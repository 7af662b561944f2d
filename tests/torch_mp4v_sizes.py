"""Sizes and PSNR of data/mpeg4.py:Mp4vEncoder's mp4v beside cv2's own
mp4v writer (the JAX demo's cv2.VideoWriter) on the same RGB frames: the
24 frames of the committed 720x1280 clip's source (the three samples
shifted a few pixels a frame) and seeded 240x320 clips (static, panning,
noisy). Each file is written into an MP4 and read back by cv2, whose
frames give the PSNR against the frames written.

    python tests/torch_mp4v_sizes.py
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vision_kit_tpu_torch.data import mpeg4  # noqa: E402
from vision_kit_tpu_torch.utils.mp4 import Mp4Writer  # noqa: E402
from torch_mpeg4_samples import hd_frames, moving, read_cv2, write_cv2  # noqa: E402


def psnr(got: list, want: list) -> float:
    mse = np.mean([np.mean((g.astype(np.float64) - w) ** 2) for g, w in zip(got, want)])
    return float(10 * np.log10(255 ** 2 / mse))


def main() -> None:
    clips = {"720x1280 samples, 24 frames": hd_frames()}
    for kind in ("static", "pan", "noise"):
        clips[f"240x320 {kind}, 12 frames"] = moving(kind, 240, 320, 12, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        ours_path, cv2_path = os.path.join(tmp, "port.mp4"), os.path.join(tmp, "cv2.mp4")
        for name, frames in clips.items():
            h, w = frames[0].shape[:2]
            enc = mpeg4.Mp4vEncoder(w, h)
            with Mp4Writer(ours_path, 30.0) as out:
                for rgb in frames:
                    vop, key = enc.encode(rgb)
                    out.write(vop, key, w, h, enc.headers())
            write_cv2(cv2_path, frames)
            ours, theirs = read_cv2(ours_path)[0], read_cv2(cv2_path)[0]
            a, b = os.path.getsize(ours_path), os.path.getsize(cv2_path)
            print(f"{name}: port {a} B, PSNR {psnr(ours, frames):.2f} dB; cv2 {b} B, "
                  f"PSNR {psnr(theirs, frames):.2f} dB; size ratio {a / b:.4f}")


if __name__ == "__main__":
    main()
