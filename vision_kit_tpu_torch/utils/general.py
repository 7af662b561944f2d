"""General helpers: variant multipliers, device resolution, run
directories, loss-gain scaling, the EXIF-corrected image size and the COCO
class-id table.

Counterpart of vision_kit_tpu/utils/general.py.
"""

from __future__ import annotations

import os
from datetime import datetime

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


#: cuBLAS's workspace setting under which its kernels are deterministic;
#: it must be in the environment before CUDA starts
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def deterministic_mode() -> None:
    """Deterministic algorithms for this process (torch's, cuDNN's without
    its autotuner), so that a training run on the card repeats bit for bit
    from its seed. Sets CUBLAS_WORKSPACE_CONFIG when CUDA has not started,
    and raises when it has without the variable (cuBLAS read its workspace
    setting then)."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (CUBLAS_WORKSPACE_CONFIG, ":16:8"):
        if torch.cuda.is_initialized():
            raise RuntimeError(
                f"deterministic mode needs CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE_CONFIG} "
                "in the environment before CUDA starts, and CUDA started without it: set "
                "the variable before the process starts (python -m vision_kit_tpu_torch "
                "train --deterministic does)")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE_CONFIG
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def update_loss_cfg(cfg, nl: int | None = None):
    """Scale the loss gains by level count, class count and image size
    (the reference's general.py:9-15). Mutates and returns cfg. nl, the
    number of detection levels, comes from the model's anchor table unless
    given."""
    if nl is None:
        from vision_kit_tpu_torch.models.heads import V5_ANCHORS, V7_ANCHORS

        anchors = {"yolov5": V5_ANCHORS, "yolov7": V7_ANCHORS}.get(
            str(cfg.model.name).lower())
        if anchors is None:
            raise ValueError(f"update_loss_cfg cannot derive nl for model "
                             f"{cfg.model.name!r}; pass nl= explicitly")
        nl = len(anchors)
    if nl < 1:
        raise ValueError(f"nl must be >= 1, got {nl}")
    cfg.hypermeters.box *= 3 / nl
    cfg.hypermeters.cls *= cfg.model.num_classes / 80 * 3 / nl
    cfg.hypermeters.obj *= (cfg.model.input_size[0] / 640) ** 2 * 3 / nl
    return cfg


def mk_output_dir(path: str, model_name: str, task: str) -> str:
    """<path>/<model>/<task>/<YYYYmmddHHMM>, created."""
    out = os.path.join(path, model_name, task, datetime.now().strftime("%Y%m%d%H%M"))
    os.makedirs(out, exist_ok=True)
    return out


def exif_size(data: bytes) -> tuple[int, int]:
    """(width, height) of an encoded JPEG, PNG, BMP or WebP as it is
    displayed, from its header alone (a WebP's canvas and the orientation
    of its EXIF chunk): EXIF orientations 5-8 (a transpose) swap the stored
    dimensions. Counterpart of the PIL-based exif_size; raises ValueError
    for bytes that are none of these, or whose header is malformed."""
    from vision_kit_tpu_torch.data import decode, webp

    kind = decode.image_kind(data)
    if kind == "jpeg":
        info = decode.jpeg_header(data)
    elif kind == "png":
        info = decode.png_header(data)
    elif kind == "bmp":
        info = decode.bmp_header(data)
    elif kind == "webp":
        info = webp.webp_header(data)
    else:
        raise ValueError("not a JPEG, PNG, BMP or WebP")
    w, h = info["width"], info["height"]
    return (h, w) if info["orientation"] in (5, 6, 7, 8) else (w, h)


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
