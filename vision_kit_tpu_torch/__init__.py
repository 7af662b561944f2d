"""PyTorch/CUDA port of vision_kit_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module layout (models/, ops/, predictor.py, ...)
so each module has an obvious counterpart. Public functions keep the JAX
layouts: images NHWC uint8, raw head maps (B, ny, nx, na, 5+nc),
detections (B, max_det, 6) plus a (B, max_det) validity mask.

The port imports torch, numpy, yaml and the standard library only. Entry
points default to device="cuda" and raise when CUDA is absent; tests pass
device="cpu", where each hand-written kernel's plain PyTorch version runs.
"""

__version__ = "0.1.0"
