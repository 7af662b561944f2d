"""Port NMS path vs the JAX package on the CPU: the greedy keep mask's plain
version against the Pallas kernel (interpret mode) and the XLA blocked
scan, the head-score plain version against postprocess_raw's stage 1, and
the whole postprocess_raw."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.ops import boxes as jax_boxes
from vision_kit_tpu.ops.nms import _greedy_keep_blocked
from vision_kit_tpu.ops.nms import postprocess_raw as jax_postprocess_raw
from vision_kit_tpu.ops.pallas_nms import pallas_greedy_keep
from vision_kit_tpu_torch.ops.boxes import box_iou_pairwise, cxcywh_to_xyxy
from vision_kit_tpu_torch.ops.greedy_nms import (
    greedy_keep, greedy_keep_reference, mask_scratch_shape)
from vision_kit_tpu_torch.ops.head_scores import (
    TILE_ROWS, head_scores, head_scores_reference, level_table)
from vision_kit_tpu_torch.ops.nms import postprocess_raw
from vision_kit_tpu_torch.utils.stream_bench import same_detections
from test_torch_model import jax_v5, port_v5

torch.set_num_threads(2)


def make_boxes(rng, b, k, case):
    """(B, K, 4) xyxy f32 in score order and (B, K) valid. `crowded` puts
    every box near one of a few centres, with the class offset of one of
    two classes added, so suppression chains are long."""
    if case == "crowded":
        centres = rng.uniform(50, 400, (b, 6, 2))
        pick = rng.integers(0, 6, (b, k))
        c = np.take_along_axis(centres, pick[..., None], axis=1)
        c = c + rng.normal(0, 6, (b, k, 2))
        wh = rng.uniform(30, 60, (b, k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
        boxes = boxes + (rng.integers(0, 2, (b, k, 1)) * 7680.0)
    else:
        x1y1 = rng.uniform(0, 500, (b, k, 2))
        wh = rng.uniform(10, 150, (b, k, 2))
        boxes = np.concatenate([x1y1, x1y1 + wh], -1)
    valid = np.ones((b, k), bool)
    if case == "invalid_tail":
        valid[:, k - k // 3:] = False
    elif case == "all_invalid":
        valid[:] = False
    elif case == "invalid_rows":
        valid[:, 64:128] = False          # one whole 64-row block
        valid[:, 3::7] = False
    return boxes.astype(np.float32), valid


@pytest.mark.parametrize("eps", [1e-6, 1e-9])
def test_boxes_match_jax(eps):
    """cxcywh -> xyxy and the pairwise IoU, zero-area boxes included (where
    the union clamp decides), equal the JAX package's bit for bit."""
    rng = np.random.default_rng(13)
    cxcywh = np.concatenate([rng.uniform(0, 300, (2, 40, 2)),
                             rng.uniform(0, 80, (2, 40, 2))], -1).astype(np.float32)
    cxcywh[:, :5, 2] = 0.0
    want_xyxy = np.asarray(jax_boxes.cxcywh_to_xyxy(jnp.asarray(cxcywh)))
    got_xyxy = cxcywh_to_xyxy(torch.from_numpy(cxcywh)).numpy()
    np.testing.assert_array_equal(got_xyxy, want_xyxy)
    want = np.asarray(jax_boxes.box_iou_pairwise(
        jnp.asarray(want_xyxy), jnp.asarray(want_xyxy[:, ::-1]), eps=eps))
    got = box_iou_pairwise(torch.from_numpy(got_xyxy),
                           torch.from_numpy(got_xyxy[:, ::-1].copy()), eps=eps)
    assert got.shape == (2, 40, 40)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["random", "invalid_tail"])
def test_greedy_reference_matches_pallas_kernel(case):
    rng = np.random.default_rng(11)
    boxes, valid = make_boxes(rng, 3, 96, case)
    want = np.asarray(pallas_greedy_keep(jnp.asarray(boxes), jnp.asarray(valid),
                                         0.5, interpret=True))
    got = greedy_keep_reference(torch.from_numpy(boxes),
                                torch.from_numpy(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [252, 512])
@pytest.mark.parametrize("case", ["random", "crowded", "invalid_tail"])
def test_greedy_reference_matches_blocked_scan(k, case):
    rng = np.random.default_rng(k)
    boxes, valid = make_boxes(rng, 4, k, case)
    want = np.asarray(jax.vmap(
        lambda bx, v: _greedy_keep_blocked(bx, v, 0.45))(boxes, valid)) & valid
    got = greedy_keep_reference(torch.from_numpy(boxes),
                                torch.from_numpy(valid), 0.45).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


def test_greedy_keep_on_cpu_is_the_plain_version():
    boxes, valid = make_boxes(np.random.default_rng(2), 2, 64, "crowded")
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    before = greedy_keep.launches
    assert torch.equal(greedy_keep(bt, vt, 0.45),
                       greedy_keep_reference(bt, vt, 0.45))
    assert greedy_keep.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        greedy_keep(bt.to("meta"), vt.to("meta"), 0.45)


def blocked_walk_numpy(boxes, valid, thres, seed=0):
    """numpy transcription of csrc/greedy_nms.cu. The mask build writes, for
    each valid row i and each 64-column block cb at or above i's block, the
    64-bit word mask[b, i, cb] with bit c set iff column j = 64 cb + c has
    IoU > thres (f32, the kernel's operation order), for j > i off the
    diagonal and j != i on it; every other word of the (B, 64 W, W)
    scratch keeps the garbage it was allocated with. The walk then resolves
    one 64-row block at a time: each step keeps every live row that no live
    earlier row of the block overlaps, and clears those rows and the later
    rows they overlap from live, until none is left; the kept rows' words
    then mark the later blocks removed."""
    b, k = valid.shape
    _, rows, words = mask_scratch_shape(b, k)
    garbage = np.random.default_rng(seed).integers(0, 2 ** 63, (b, rows, words))
    mask = [[[int(x) for x in row] for row in img] for img in garbage]
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    area = (x2 - x1) * (y2 - y1)
    iw = np.maximum(np.minimum(x2[:, :, None], x2[:, None, :])
                    - np.maximum(x1[:, :, None], x1[:, None, :]), np.float32(0))
    ih = np.maximum(np.minimum(y2[:, :, None], y2[:, None, :])
                    - np.maximum(y1[:, :, None], y1[:, None, :]), np.float32(0))
    inter = iw * ih
    union = (area[:, :, None] + area[:, None, :]) - inter
    over = inter / np.maximum(union, np.float32(1e-9)) > np.float32(thres)
    for img in range(b):
        for i in np.flatnonzero(valid[img]).tolist():
            for cb in range(i // 64, words):
                cols = [j for j in range(64 * cb, min(64 * cb + 64, k))
                        if j > i or (cb == i // 64 and j != i)]
                mask[img][i][cb] = sum(1 << (j - 64 * cb) for j in cols
                                       if over[img, i, j])
    keep = np.zeros((b, k), bool)
    for img in range(b):
        removed = [0] * words
        for w in range(words):
            block = valid[img, 64 * w:64 * w + 64]
            live = sum(1 << c for c in np.flatnonzero(block).tolist()) & ~removed[w]
            kept = 0
            diag = [mask[img][64 * w + c][w] for c in range(64)]
            while live:
                safe = [c for c in range(64) if live >> c & 1
                        and not diag[c] & ((1 << c) - 1) & live]
                assert safe and safe[0] == (live & -live).bit_length() - 1
                gone = 0
                for c in safe:
                    gone |= diag[c] & ~((1 << (c + 1)) - 1)
                    kept |= 1 << c
                live &= ~(sum(1 << c for c in safe) | gone)
            for w2 in range(w + 1, words):
                for c in range(64):
                    if kept >> c & 1:
                        removed[w2] |= mask[img][64 * w + c][w2]
            for c in range(len(block)):
                keep[img, 64 * w + c] = bool(kept >> c & 1)
    return keep


@pytest.mark.parametrize("k,case", [(150, "random"), (150, "crowded"),
                                    (200, "invalid_tail"), (200, "invalid_rows"),
                                    (64, "all_invalid"), (1, "random")])
def test_blocked_walk_matches_plain_version(k, case):
    boxes, valid = make_boxes(np.random.default_rng(k + len(case)), 3, k, case)
    want = greedy_keep_reference(torch.from_numpy(boxes),
                                 torch.from_numpy(valid), 0.45).numpy()
    np.testing.assert_array_equal(blocked_walk_numpy(boxes, valid, 0.45), want)
    if case == "crowded":
        assert 0 < want.sum() < valid.sum() // 2


@pytest.mark.parametrize("case", ["random", "crowded", "invalid_rows"])
def test_blocked_walk_matches_pallas_kernel(case):
    boxes, valid = make_boxes(np.random.default_rng(21), 2, 160, case)
    want = np.asarray(pallas_greedy_keep(jnp.asarray(boxes), jnp.asarray(valid),
                                         0.5, interpret=True))
    np.testing.assert_array_equal(blocked_walk_numpy(boxes, valid, 0.5), want)


def test_mask_scratch_shape():
    assert mask_scratch_shape(8, 1024) == (8, 1024, 16)
    assert mask_scratch_shape(128, 512) == (128, 512, 8)
    assert mask_scratch_shape(2, 2048) == (2, 2048, 32)
    assert mask_scratch_shape(3, 65) == (3, 128, 2)
    # every 64-row block is one strip of 64 W words, 16-byte multiple
    for k in (1, 63, 64, 65, 252, 1280):
        _, rows, words = mask_scratch_shape(1, k)
        assert rows % 64 == 0 and rows >= k and words * 64 == rows
        assert (64 * words * 8) % 16 == 0


def test_level_table_v5s_at_640():
    shapes = [(8, n, n, 3, 85) for n in (80, 40, 20)]
    t = level_table(shapes)
    assert t.rows == [51200, 12800, 3200]
    assert t.cells == [6400, 1600, 400]
    assert t.out_offsets == [0, 19200, 24000]
    assert t.n_total == 25200
    assert t.tile_begin == [0, 800, 1000] and t.n_tiles == 1050
    # a tile of 64 bf16 or f32 rows is a 16-byte multiple: the bulk copy
    # of every whole tile needs no plain tail
    for itemsize in (2, 4):
        assert TILE_ROWS * 255 * itemsize % 16 == 0


def test_level_table_ragged_tiles():
    t = level_table([(1, 5, 5, 3, 85), (3, 7, 3, 3, 85), (2, 1, 1, 3, 85)])
    assert t.rows == [25, 63, 2]
    assert t.tile_begin == [0, 1, 2] and t.n_tiles == 3
    assert t.out_offsets == [0, 75, 138] and t.n_total == 141
    # the last tile of each level holds the rows left over
    for rows, begin, end in zip(t.rows, t.tile_begin, t.tile_begin[1:] + [t.n_tiles]):
        assert (end - begin - 1) * TILE_ROWS < rows <= (end - begin) * TILE_ROWS


def _jax_stage1(raws, conf, classes=None):
    """postprocess_raw stage 1 (vision_kit_tpu/ops/nms.py), plus the gate."""
    score_parts, cls_parts = [], []
    for raw in raws:
        b = raw.shape[0]
        cls_logits = raw[..., 5:]
        if classes is not None:
            cls_logits = jnp.where(classes.reshape(1, 1, 1, 1, -1), cls_logits,
                                   -jnp.inf)
        cls_parts.append(jnp.argmax(cls_logits, axis=-1).reshape(b, -1))
        best = jnp.max(cls_logits, axis=-1).reshape(b, -1)
        obj = raw[..., 4].reshape(b, -1)
        score_parts.append(jax.nn.sigmoid(obj.astype(jnp.float32))
                           * jax.nn.sigmoid(best.astype(jnp.float32)))
    s = jnp.concatenate(score_parts, axis=1)
    return np.asarray(s), np.asarray(jnp.concatenate(cls_parts, axis=1))


@pytest.mark.parametrize("with_classes", [False, True])
def test_head_scores_reference_matches_jax_stage1(with_classes):
    rng = np.random.default_rng(5)
    # logits on a 0.25 grid: many exact ties, which must pick the first index
    raws = [np.round(rng.normal(0, 2, (2, n, n, 3, 85)) * 4).astype(np.float32) / 4
            for n in (8, 4, 2)]
    classes = rng.uniform(size=80) < 0.5 if with_classes else None
    conf = 0.25
    want_s, want_c = _jax_stage1([jnp.asarray(r) for r in raws], conf,
                                 None if classes is None else jnp.asarray(classes))
    got_s, got_c = head_scores(
        [torch.from_numpy(r) for r in raws], conf,
        None if classes is None else torch.from_numpy(classes))
    got_s, got_c = got_s.numpy(), got_c.numpy()
    assert got_c.dtype == np.int32
    np.testing.assert_array_equal(got_c, want_c)
    near = np.abs(want_s - conf) <= 1e-6
    gate = want_s > conf
    np.testing.assert_array_equal((got_s > -1)[~near], gate[~near])
    np.testing.assert_allclose(got_s[gate & ~near], want_s[gate & ~near],
                               rtol=1e-6, atol=0)
    assert np.all(got_s[~gate & ~near] == -1e9)


def assert_same_detections(want, got, box_rtol=0.0):
    """Detection sets equal: class exact, score within 1e-5, every box
    coordinate within 1e-3 px + box_rtol of the box's longer side."""
    assert same_detections(want, got, box_rtol=box_rtol), (want, got)


@pytest.mark.parametrize("mode", ["default", "agnostic", "classes"])
def test_postprocess_raw_matches_jax(mode):
    jm, v = jax_v5("n", 64)
    tm = port_v5("n", v)
    x = np.random.default_rng(9).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    _, jr = jm.apply(v, jnp.asarray(x), training=False)
    with torch.no_grad():
        _, tr = tm(torch.from_numpy(x))
    classes = np.arange(80) % 3 == 0 if mode == "classes" else None
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, max_cand=512,
              agnostic=mode == "agnostic")
    jd, jv = jax_postprocess_raw(
        jr, jm.anchors_px, approx_topk=False,
        classes=None if classes is None else jnp.asarray(classes), **kw)
    td, tv = postprocess_raw(
        tr, tm.anchors_px,
        classes=None if classes is None else torch.from_numpy(classes), **kw)
    jd, jv = np.asarray(jd), np.asarray(jv)
    assert td.shape == jd.shape and tv.shape == jv.shape
    for i in range(2):
        assert jv[i].sum() > 10
        assert_same_detections(jd[i][jv[i]], td[i][tv[i]].numpy())
