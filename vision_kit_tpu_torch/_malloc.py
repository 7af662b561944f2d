"""glibc malloc tuning for the batch-buffer hot path.

Batch image buffers (B, S, S, 3) are tens of MB — far above glibc's default
M_MMAP_THRESHOLD (128 KB), so every loader batch is served by a fresh
mmap() and returned with munmap() on free. Each batch therefore faults its
whole buffer in from the kernel again, and on the VMs this framework runs
on those faults are intermittently pathological (measured here: a 37 MB
np.stack that normally costs ~14 ms stalling for 0.8-4.3 s, recurring in
steady state; see DESIGN.md "Host allocation behavior").

Raising M_MMAP_THRESHOLD (and M_TRIM_THRESHOLD, so the grown heap is not
returned) makes batch-sized allocations come from the main arena, which is
reused across batches: one warmup fault, then a steady ~7 ms/batch with no
stalls. Process-wide cost is a slightly larger resident heap (a few batch
buffers), which is irrelevant next to the image caches.

The port's copy of vision_kit_tpu/_malloc.py. The loaders call
prefault_arena (which tunes the allocator first) when they build batches on
the host, in the parent and in each spawned worker; importing this module
changes nothing. No-op outside glibc/Linux.
"""

from __future__ import annotations

import sys

# glibc malloc.h parameter codes
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_applied = False


# Largest allocation still served from the arena. Must cover the biggest
# recurring batch buffer: device-aug tiles at b64@640 are 64*5*640*640*3
# = 393 MB, so 512 MB (the old 256 MB silently sent those to mmap).
_MMAP_THRESHOLD = 512 << 20
# Never trim: the trim threshold must exceed the prefault working set
# (cap + headroom below), otherwise free()ing the prefault block creates a
# top chunk above the threshold and glibc gives the pages straight back.
# Capped near INT_MAX (mallopt takes a C int).
_TRIM_THRESHOLD = 0x7FFF0000


def tune_for_batch_buffers(threshold: int = _MMAP_THRESHOLD) -> bool:
    """Serve allocations below `threshold` from the reusable main arena.

    Returns True if mallopt was reached and accepted both settings."""
    global _applied
    if _applied:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, threshold))
        # keep the grown heap: trimming would munmap and re-fault next batch
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, _TRIM_THRESHOLD)) and ok
        _applied = ok
        return ok
    except (OSError, AttributeError):
        return False


_prefaulted = 0

# Below this, growth faults are negligible (tests, tiny images) — skip.
_PREFAULT_MIN = 8 << 20
# Headroom over the requested buffers: per-sample mosaic canvases, label
# arrays, pickle buffers on the mp-queue path.
_PREFAULT_HEADROOM = 64 << 20
_PREFAULT_CAP = 1 << 30


def prefault_arena(nbytes: int) -> int:
    """Grow and touch the malloc arena up to `nbytes` + headroom, once per
    process high-water mark.

    First-touch page faults can be pathological on a virtual machine,
    recurring every time the heap grows. Loaders call this at construction
    so the whole batch working set is faulted once, up front, and every
    later batch allocation is a plain arena reuse. Returns bytes newly
    prefaulted (0 = no-op)."""
    global _prefaulted
    import os

    if nbytes < _PREFAULT_MIN or os.environ.get("VK_NO_PREFAULT"):
        return 0
    if not tune_for_batch_buffers():
        return 0  # without arena reuse the touched pages would be unmapped
    total = min(nbytes + _PREFAULT_HEADROOM, _PREFAULT_CAP)
    if total <= _prefaulted:
        return 0
    import numpy as np

    # Allocate in chunks BELOW the mmap threshold, held simultaneously: a
    # single >=threshold block would be served by mmap and unmapped on free
    # (prefaulting nothing). Freed chunks stay mapped because the trim
    # threshold exceeds the whole working set.
    chunk_sz = _MMAP_THRESHOLD // 4
    chunks = []
    left = total
    while left > 0:
        block = np.empty(min(left, chunk_sz), np.uint8)
        block[::4096] = 1  # touch every page
        chunks.append(block)
        left -= len(block)
    grown = total - _prefaulted
    _prefaulted = total
    del chunks  # stays in the arena: M_TRIM_THRESHOLD keeps it mapped
    return grown
