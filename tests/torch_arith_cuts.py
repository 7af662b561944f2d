"""A sweep of arithmetic-coded JPEGs cut and closed by an EOI, against
cv2.imdecode at full size and 1/2, 1/4, 1/8: the scans decode from zeros
past the cut, which gives coefficients far outside a valid file's, where
cv2's pixels are libjpeg-turbo's SIMD IDCTs' (decode._idct_plane,
_idct_scaled). Seven encoder settings (4:2:0, 4:4:4, progressive, 4:2:2,
4:4:0, restarts, grey) on six seeded scenes, 25 cut points each. Prints
each disagreement and the count.

    python tests/torch_arith_cuts.py
"""

from __future__ import annotations

import os
import sys

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_samples as ts  # noqa: E402
from vision_kit_tpu_torch.data import decode  # noqa: E402

FLAGS = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
         8: cv2.IMREAD_REDUCED_COLOR_8}
SETTINGS = [{}, {"sampling": [(1, 1)] * 3}, {"progressive": True},
            {"sampling": [(2, 1), (1, 1), (1, 1)]}, {"sampling": [(1, 2), (1, 1), (1, 1)]},
            {"restart": 5}, {"grey": True}]


def main() -> None:
    n = bad = 0
    for seed in range(200, 206):
        rgb = ts.scene(97, 131, seed, noise=4.0)
        for setting in SETTINGS:
            kw = dict(setting)
            pixels = rgb[:, :, 0] if kw.pop("grey", False) else rgb
            data = ts.libjpeg_encode(pixels, 85, arith=True, **kw)
            for frac in np.linspace(0.03, 0.99, 25):
                cut = data[:int(len(data) * frac)] + b"\xff\xd9"
                for scale, flag in FLAGS.items():
                    want = cv2.imdecode(np.frombuffer(cut, np.uint8), flag)
                    got = (decode.decode_image(cut) if scale == 1
                           else decode.decode_jpeg_reduced(cut, scale))
                    n += 1
                    if (want is None) != (got is None) or (
                            want is not None and not np.array_equal(want[:, :, ::-1], got)):
                        bad += 1
                        print(f"differs: seed {seed} {setting} cut at {frac:.3f} 1/{scale}")
    print(f"{n} decodes, {bad} differ from cv2")


if __name__ == "__main__":
    main()
