"""Sizes of data/encode.py:encode_webp's lossless WebPs beside
cv2.imencode('.webp') (libwebp's lossless encoder at its defaults, which
the JAX demo's cv2.imwrite writes) on the pixels of every committed sample
the port decodes (the demo's inputs), with each file's encode time on this
host. Both round-trip bit for bit (tests/test_torch_webp_encode.py).

    python tests/torch_webp_sizes.py
"""

from __future__ import annotations

import os
import sys
import time

import cv2

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vision_kit_tpu_torch.data import decode  # noqa: E402
from vision_kit_tpu_torch.data.encode import encode_webp  # noqa: E402
from torch_samples import SAMPLES  # noqa: E402


def main() -> None:
    ours = theirs = 0
    ratios = []
    for name in sorted(os.listdir(SAMPLES)):
        with open(os.path.join(SAMPLES, name), "rb") as f:
            rgb = decode.decode_image(f.read())
        if rgb is None:
            continue
        t0 = time.perf_counter()
        n = len(encode_webp(rgb))
        ms = (time.perf_counter() - t0) * 1e3
        m = len(cv2.imencode(".webp", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))[1])
        ours, theirs = ours + n, theirs + m
        ratios.append(n / m)
        print(f"{name} {rgb.shape[1]}x{rgb.shape[0]}: encode_webp {n} B ({ms:.1f} ms), "
              f"cv2 {m} B, ratio {n / m:.4f}")
    ratios.sort()
    print(f"{len(ratios)} images: total {ours} B against cv2's {theirs} B, ratio "
          f"{ours / theirs:.4f}; per image min {ratios[0]:.4f}, median "
          f"{ratios[len(ratios) // 2]:.4f}, max {ratios[-1]:.4f}")


if __name__ == "__main__":
    main()
