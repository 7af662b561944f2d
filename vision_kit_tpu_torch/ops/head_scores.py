"""Head-map candidate scores: a hand-written Triton kernel and its plain
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

Bound on the H100: bytes. Each 255-wide row (3 anchors x 85) is read once
in the head conv's channels_last layout, in place, and 8 bytes per anchor
are written; the arithmetic (three 80-wide max/first-argmax reductions
and two sigmoids per anchor) is far below the card's rate. The kernel therefore
reads a tile of rows once, does all three anchors' reductions from it in
registers and writes only the gated score and class.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9
# a few rows per one-warp program: measured fastest on the H100 at the
# v5s@640 b128 shapes (chip_smoke.py's kernel phase times this setting)
BLOCK_ROWS = 4
NUM_WARPS = 1


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


_kernel = None


def _triton_kernel():
    """Define the kernel on first use: triton is imported only here."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    # rows are 255 elements apart, so no row start is vector-aligned: keep
    # Triton from assuming divisibility of the integer arguments
    @triton.jit(do_not_specialize=["n_rows", "out_stride_b", "out_offset",
                                   "cells"])
    def head_scores_kernel(
        x_ptr, classes_ptr, score_ptr, cls_ptr,
        n_rows, cells, out_stride_b, out_offset, conf,
        NA: tl.constexpr, NO: tl.constexpr, NC: tl.constexpr,
        ROW_PAD: tl.constexpr, BLOCK: tl.constexpr, HAS_CLASSES: tl.constexpr,
    ):
        # one tile = BLOCK whole rows of NA*NO channels: a single contiguous
        # span of memory, read once, coalesced
        pid = tl.program_id(0)
        rows = pid * BLOCK + tl.arange(0, BLOCK)
        rmask = rows < n_rows
        cols = tl.arange(0, ROW_PAD)
        ptrs = x_ptr + rows.to(tl.int64)[:, None] * (NA * NO) + cols[None, :]
        x = tl.load(ptrs, mask=rmask[:, None] & (cols < NA * NO)[None, :],
                    other=float("-inf")).to(tl.float32)
        b = rows // cells
        out_base = b.to(tl.int64) * out_stride_b + out_offset \
            + (rows - b * cells) * NA
        for a in tl.static_range(NA):
            lo = a * NO + 5
            in_cls = (cols >= lo) & (cols < lo + NC)
            if HAS_CLASSES:
                allowed = tl.load(classes_ptr + (cols - lo), mask=in_cls,
                                  other=0) != 0
                in_cls = in_cls & allowed
            xa = tl.where(in_cls[None, :], x, float("-inf"))
            best = tl.max(xa, axis=1)
            # first class index attaining the max, as argmax does on ties;
            # a row with every class masked gives class 0, as argmax does
            hit = tl.where((xa == best[:, None]) & (cols >= lo)[None, :],
                           cols[None, :] - lo, NC)
            best_cls = tl.min(hit, axis=1)
            obj = tl.sum(tl.where((cols == lo - 1)[None, :], x, 0.0), axis=1)
            s_obj = libdevice.div_rn(1.0, 1.0 + libdevice.exp(-obj))
            s_cls = libdevice.div_rn(1.0, 1.0 + libdevice.exp(-best))
            score = s_obj * s_cls
            score = tl.where(score > conf, score, -1e9)
            tl.store(score_ptr + out_base + a, score, mask=rmask)
            tl.store(cls_ptr + out_base + a, best_cls.to(tl.int32), mask=rmask)

    _kernel = head_scores_kernel
    return _kernel


def _launch(raws, conf_thres: float, classes: torch.Tensor | None):
    dev = raws[0].device
    b = raws[0].shape[0]
    na, no = raws[0].shape[3], raws[0].shape[4]
    nc = no - 5
    for raw in raws:
        if raw.dim() != 5 or raw.shape[0] != b or tuple(raw.shape[3:]) != (na, no):
            raise ValueError(f"raw maps (B, ny, nx, {na}, {no}) expected, "
                             f"got {tuple(raw.shape)}")
        if raw.device != dev or raw.dtype not in (torch.bfloat16, torch.float16,
                                                  torch.float32):
            raise ValueError(f"raw maps must be float on {dev}")
        if not raw.is_contiguous():
            raise ValueError("raw maps must be contiguous NHWC views with "
                             "channel stride 1 (the channels_last conv "
                             f"output); got strides {raw.stride()}")
    n_total = sum(r.shape[1] * r.shape[2] * na for r in raws)
    scores = torch.empty(b, n_total, dtype=torch.float32, device=dev)
    cls = torch.empty(b, n_total, dtype=torch.int32, device=dev)
    if classes is not None:
        if classes.shape != (nc,):
            raise ValueError(f"classes must be ({nc},), got {tuple(classes.shape)}")
        classes = classes.to(device=dev, dtype=torch.uint8).contiguous()
    kernel = _triton_kernel()
    row_pad = 1 << (na * no - 1).bit_length()
    offset = 0
    with torch.cuda.device(dev):
        for raw in raws:
            _, ny, nx = raw.shape[:3]
            n_rows = b * ny * nx
            grid = ((n_rows + BLOCK_ROWS - 1) // BLOCK_ROWS,)
            kernel[grid](
                raw, classes if classes is not None else scores, scores, cls,
                n_rows, ny * nx, n_total, offset, float(conf_thres),
                NA=na, NO=no, NC=nc, ROW_PAD=row_pad, BLOCK=BLOCK_ROWS,
                HAS_CLASSES=classes is not None, num_warps=NUM_WARPS,
            )
            head_scores.launches += 1
            offset += ny * nx * na
    return scores, cls


def head_scores(raws, conf_thres: float, classes: torch.Tensor | None = None):
    """Gated candidate scores and best classes over all levels.

    raws: per-level (B, ny, nx, na, 5+nc) maps (views of channels_last conv
    outputs on the card). Returns ((B, N) f32, (B, N) i32). CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    dev = raws[0].device
    if dev.type == "cpu":
        return head_scores_reference(raws, conf_thres, classes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(raws, conf_thres, classes)


head_scores.launches = 0
