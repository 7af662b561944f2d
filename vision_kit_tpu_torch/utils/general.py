"""General helpers: variant multipliers, device resolution and the COCO
class-id table.

Counterpart of vision_kit_tpu/utils/general.py (the subset the serving and
eval paths need).
"""

from __future__ import annotations

import torch


def dw_multiple_generator(version: str = "s") -> tuple[float, float]:
    """(width_mul, depth_mul) for YOLOv5 variants.

    n=(0.25, 0.33), s=(0.50, 0.33), m=(0.75, 0.67), l=(1.00, 1.00),
    x=(1.25, 1.33).
    """
    width, depth = 0.25, 0.33
    v = version.lower()
    if v == "s":
        depth *= 1.01
        width *= 2
    elif v == "m":
        depth *= 2.02
        width *= 3
    elif v == "l":
        depth *= 3.03
        width *= 4
    elif v == "x":
        depth *= 4.04
        width *= 5
    elif v == "n":
        pass
    else:
        raise ValueError(f"YOLOv5 variant {version!r} is not supported")
    return width, round(depth, 2)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without CUDA raises:
    nothing silently carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run the "
            "plain PyTorch path on the CPU"
        )
    return device


def coco80_to_coco91_class() -> list[int]:
    """Map contiguous 80-class index -> original COCO-91 category id
    (reference utils/dataset_utils.py:10-33)."""
    return [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
        21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
        41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
        59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
        80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ]
