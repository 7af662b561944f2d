"""Head-map candidate scores: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of the TPU kernel in tools/archive/bench_pallas_score.py (the
inner `kernel` of `main()`, launched by `pallas_scores`), which computes
stage 1 of vision_kit_tpu/ops/nms.py:postprocess_raw: for each anchor of
each cell, best class = first index of the max class logit, and score =
sigmoid(obj) * sigmoid(best logit) in f32.

Fused here: the optional `classes` mask (masked logits become -inf) and the
conf gate (a score <= conf becomes -1e9), so the top-k reads the kernel's
output directly. Output: (B, N) f32 scores and (B, N) i32 classes over all
levels, each level at its offset in native (iy, ix, ia) order.

The kernel is csrc/head_scores.cu, one launch for all levels; its note
says what bounds it on the H100 and how the design meets that.
`head_scores` takes the plain version for a CPU tensor only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from vision_kit_tpu_torch import _cuda_build

NEG_INF = -1e9
TILE_ROWS = 64      # rows of one level per tile (csrc/head_scores.cu)
MAX_LEVELS = 4
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def head_scores_reference(raws, conf_thres: float,
                          classes: torch.Tensor | None = None):
    """Plain version, transcribing postprocess_raw stage 1 plus the gate.
    raws: per-level (B, ny, nx, na, 5+nc) maps. Returns (scores f32,
    classes i32), both (B, N)."""
    score_parts, cls_parts = [], []
    for raw in raws:
        b = raw.shape[0]
        logits = raw[..., 5:]
        if classes is not None:
            logits = logits.masked_fill(~classes.to(torch.bool), float("-inf"))
        best_cls = logits.argmax(dim=-1).reshape(b, -1)
        best_logit = logits.amax(dim=-1).reshape(b, -1)
        obj = raw[..., 4].reshape(b, -1)
        score = torch.sigmoid(obj.float()) * torch.sigmoid(best_logit.float())
        score_parts.append(score)
        cls_parts.append(best_cls.to(torch.int32))
    scores = torch.cat(score_parts, dim=1)
    gated = torch.where(scores > conf_thres, scores,
                        torch.full_like(scores, NEG_INF))
    return gated, torch.cat(cls_parts, dim=1)


class LevelTable(NamedTuple):
    """The kernel's view of the levels: per level its rows (B * ny * nx),
    cells (ny * nx), first output column and first tile of the flat tile
    list that the kernel's blocks walk; then the output width N and the
    number of tiles."""
    rows: list[int]
    cells: list[int]
    out_offsets: list[int]
    tile_begin: list[int]
    n_total: int
    n_tiles: int


def level_table(shapes, tile_rows: int = TILE_ROWS) -> LevelTable:
    """LevelTable for per-level map shapes (B, ny, nx, na, no)."""
    rows, cells, offsets, begins = [], [], [], []
    n_total = n_tiles = 0
    for b, ny, nx, na, _ in shapes:
        rows.append(b * ny * nx)
        cells.append(ny * nx)
        offsets.append(n_total)
        begins.append(n_tiles)
        n_total += ny * nx * na
        n_tiles += -(-b * ny * nx // tile_rows)
    return LevelTable(rows, cells, offsets, begins, n_total, n_tiles)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("head_scores")
    i64p = ctypes.POINTER(ctypes.c_longlong)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.head_scores_launch.argtypes = [
        i64p, i64p, i32p, i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.head_scores_launch.restype = ctypes.c_int
    return lib


def _check(raws, classes):
    dev = raws[0].device
    b, dtype = raws[0].shape[0], raws[0].dtype
    na, no = raws[0].shape[3], raws[0].shape[4]
    if not 1 <= len(raws) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels expected, got {len(raws)}")
    for raw in raws:
        if raw.dim() != 5 or raw.shape[0] != b or tuple(raw.shape[3:]) != (na, no):
            raise ValueError(f"raw maps (B, ny, nx, {na}, {no}) expected, "
                             f"got {tuple(raw.shape)}")
        if raw.device != dev or raw.dtype != dtype or dtype not in _DTYPE_CODES:
            raise ValueError(f"raw maps must share one float type (bf16, f16 "
                             f"or f32) and device {dev}")
        if not raw.is_contiguous():
            raise ValueError("raw maps must be contiguous NHWC views with "
                             "channel stride 1 (the channels_last conv "
                             f"output); got strides {raw.stride()}")
        if raw.data_ptr() % 16:
            raise ValueError("raw maps must start on a 16-byte boundary (the "
                             "kernel copies whole tiles with TMA); got "
                             f"address {raw.data_ptr():#x}")
        if raw.shape[0] * raw.shape[1] * raw.shape[2] >= 2 ** 31:
            raise ValueError(f"a level of {tuple(raw.shape)} has too many rows")
    if classes is not None and classes.shape != (no - 5,):
        raise ValueError(f"classes must be ({no - 5},), got {tuple(classes.shape)}")


def _launch(raws, conf_thres: float, classes: torch.Tensor | None):
    _check(raws, classes)
    dev = raws[0].device
    b, na, no = raws[0].shape[0], raws[0].shape[3], raws[0].shape[4]
    table = level_table([tuple(r.shape) for r in raws])
    scores = torch.empty(b, table.n_total, dtype=torch.float32, device=dev)
    cls = torch.empty(b, table.n_total, dtype=torch.int32, device=dev)
    if classes is not None:
        classes = classes.to(device=dev, dtype=torch.uint8).contiguous()
    n = len(raws)
    with torch.cuda.device(dev):
        err = _lib().head_scores_launch(
            (ctypes.c_longlong * n)(*[r.data_ptr() for r in raws]),
            (ctypes.c_longlong * n)(*table.rows),
            (ctypes.c_int * n)(*table.cells),
            (ctypes.c_int * n)(*table.out_offsets),
            (ctypes.c_int * n)(*table.tile_begin),
            n, table.n_tiles, TILE_ROWS,
            None if classes is None else classes.data_ptr(),
            scores.data_ptr(), cls.data_ptr(), _DTYPE_CODES[raws[0].dtype],
            na, no, table.n_total, conf_thres,
            torch.cuda.current_stream().cuda_stream)
    if err == -1:
        raise ValueError(f"rows of {na} x {no} {raws[0].dtype} do not fit two "
                         f"{TILE_ROWS}-row tiles in the shared memory of a block")
    if err == -2:
        raise ValueError(f"the kernel does not take na={na}, no={no}")
    if err != 0:
        raise RuntimeError(f"head_scores_launch failed: CUDA error {err}")
    head_scores.launches += 1
    return scores, cls


def head_scores(raws, conf_thres: float, classes: torch.Tensor | None = None):
    """Gated candidate scores and best classes over all levels.

    raws: per-level (B, ny, nx, na, 5+nc) maps (views of channels_last conv
    outputs on the card). Returns ((B, N) f32, (B, N) i32). CPU tensors take
    the plain version; CUDA tensors launch the kernel, once for all
    levels."""
    dev = raws[0].device
    if dev.type == "cpu":
        return head_scores_reference(raws, conf_thres, classes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(raws, conf_thres, classes)


head_scores.launches = 0
