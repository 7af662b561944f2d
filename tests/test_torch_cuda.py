"""The port's hand-written kernels against their plain versions on a CUDA
card. Every test here skips on a host without CUDA; on the card run

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(--noconftest: the suite's conftest imports JAX, which this file does not
need.)
"""

import numpy as np
import pytest
import torch

from vision_kit_tpu_torch.ops.boxes import box_iou_pairwise
from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep, greedy_keep_reference
from vision_kit_tpu_torch.ops.head_scores import head_scores, head_scores_reference
from vision_kit_tpu_torch.utils.kernel_bench import head_maps, head_scores_agree, make_boxes


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b", [8, 128])
@pytest.mark.parametrize("k", [252, 512, 1024, 1280, 2048])
@pytest.mark.parametrize("case", ["random", "crowded", "invalid_tail", "all_invalid"])
def test_greedy_kernel_bit_equal_to_plain(cuda, b, k, case):
    boxes, valid = make_boxes(np.random.default_rng(k), b, k, case, device=cuda)
    before = greedy_keep.launches
    got = greedy_keep(boxes, valid, 0.45)
    assert greedy_keep.launches == before + 1
    assert torch.equal(got, greedy_keep_reference(boxes, valid, 0.45))


def test_greedy_kernel_bit_equal_at_the_threshold(cuda):
    # integer boxes on a small grid give exact IoU ties; thresholds at,
    # just below and just above those values test the kernel's IoU
    # comparison where it is tightest
    boxes, valid = make_boxes(np.random.default_rng(7), 8, 300, "grid", device=cuda)
    ious = torch.unique(box_iou_pairwise(boxes[:1], boxes[:1], eps=1e-9))
    for t in ious[(ious > 0.05) & (ious < 0.95)][::7].tolist():
        for thres in np.nextafter(np.float32(t), [np.float32(0), np.float32(1)]).tolist() + [t]:
            assert torch.equal(greedy_keep(boxes, valid, thres),
                               greedy_keep_reference(boxes, valid, thres)), thres


def test_greedy_kernel_rejects_bad_input(cuda):
    boxes = torch.zeros(2, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        greedy_keep(boxes, torch.ones(2, 8, dtype=torch.bool, device=cuda), 0.5)
    shifted = torch.zeros(2 * 8 * 4 + 1, device=cuda)[1:].view(2, 8, 4)
    with pytest.raises(ValueError, match="16-byte"):
        greedy_keep(shifted, torch.ones(2, 8, dtype=torch.bool, device=cuda), 0.5)


def test_greedy_kernel_refuses_k_beyond_shared_memory(cuda):
    # two 64-row strips of the mask (512 W bytes each) must fit in a block
    k = 15000
    before = greedy_keep.launches
    with pytest.raises(ValueError, match="shared memory"):
        greedy_keep(torch.zeros(1, k, 4, device=cuda),
                    torch.ones(1, k, dtype=torch.bool, device=cuda), 0.5)
    assert greedy_keep.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch,grids", [
    (8, [(80, 80), (40, 40), (20, 20)]),     # the request path at 640
    (128, [(80, 80), (40, 40), (20, 20)]),   # the throughput path at 640
    (1, [(5, 5), (7, 3), (1, 1)]),           # ragged last tiles: 25, 21, 1 rows
    (3, [(16, 16), (8, 8), (4, 4)]),
])
def test_head_scores_kernel_matches_plain(cuda, dtype, masked, batch, grids):
    gen = torch.Generator(device=cuda).manual_seed(batch)
    raws = head_maps(gen, batch, dtype, grids)
    classes = (torch.arange(80, device=cuda) % 3 != 1) if masked else None
    before = head_scores.launches
    got = head_scores(raws, 0.25, classes)
    assert head_scores.launches == before + 1
    head_scores_agree(got, head_scores_reference(raws, 0.25, classes), 0.25)


def test_head_scores_kernel_every_class_masked(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    raws = head_maps(gen, 2, torch.bfloat16, [(8, 8), (4, 4)])
    classes = torch.zeros(80, dtype=torch.bool, device=cuda)
    ks, kc = head_scores(raws, 0.0, classes)
    rs, rc = head_scores_reference(raws, 0.0, classes)
    assert torch.equal(kc, rc) and torch.equal(ks, rs)


def test_head_scores_kernel_rejects_relayout(cuda):
    raw = torch.zeros(1, 85, 3, 4, 4, device=cuda).permute(0, 3, 4, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        head_scores([raw], 0.25)


def test_head_scores_kernel_rejects_misaligned_base(cuda):
    n = 2 * 4 * 4 * 255
    raw = torch.zeros(n + 1, device=cuda, dtype=torch.bfloat16)[1:]
    raw = raw.view(2, 4, 4, 3, 85)
    assert raw.is_contiguous() and raw.data_ptr() % 16
    before = head_scores.launches
    with pytest.raises(ValueError, match="16-byte"):
        head_scores([raw], 0.25)
    assert head_scores.launches == before


def test_eval_postprocess_kernel_equals_plain_keep(cuda, monkeypatch):
    """The eval protocol's postprocess at B=4 (K=2048 candidates of a
    crowded decoded map of v5s@640's shape) through the greedy-NMS kernel
    equals the same call on the plain keep."""
    from vision_kit_tpu_torch.ops import nms
    from vision_kit_tpu_torch.train.step import EVAL_POSTPROCESS

    gen = torch.Generator(device=cuda).manual_seed(11)
    b, n = 4, 25200
    cxcy = torch.rand(b, n, 2, generator=gen, device=cuda) * 640
    wh = 10 + torch.rand(b, n, 2, generator=gen, device=cuda) * 190
    conf = torch.rand(b, n, 81, generator=gen, device=cuda)
    preds = torch.cat([cxcy, wh, conf], dim=-1)
    before = greedy_keep.launches
    got = nms.postprocess(preds, **EVAL_POSTPROCESS)
    assert greedy_keep.launches == before + 1
    monkeypatch.setattr(nms, "greedy_keep", greedy_keep_reference)
    want = nms.postprocess(preds, **EVAL_POSTPROCESS)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert int(got[1].sum(1).min()) > 100


@pytest.mark.parametrize("shape,k", [((256, 80), 20), ((64, 2048), 300),
                                     ((4, 504000), 2048)])
def test_topk_stable_orders_ties_on_the_card(cuda, shape, k):
    """Both routes of topk_stable, and the choice between them, give a
    stable argsort's order of ties on the card as on the CPU, at the eval
    path's widths (80 classes, a 2048-candidate max_det cut, 504,000
    candidates)."""
    from vision_kit_tpu_torch.ops import nms

    rng = np.random.default_rng(3)
    x = (rng.integers(0, 8, shape) / 8).astype(np.float32)
    x[rng.random(shape) < 0.15] = nms.NEG_INF
    want = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    xt = torch.from_numpy(x)
    for fn in (nms._topk_by_sort, nms._topk_by_int64, nms.topk_stable):
        np.testing.assert_array_equal(fn(xt.to(cuda), k)[1].cpu().numpy(), want)
        np.testing.assert_array_equal(fn(xt, k)[1].numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v7_deploy_predictor_kernels_equal_plain(cuda, dtype, monkeypatch):
    """A deploy v7 base folded from a calibrated training structure (as
    chip_smoke's v7 phase makes it), behind Predictor at 128: both
    structures' raw maps pass head_scores' layout check, each kernel
    launches once a request, and the detections equal those of the plain
    versions."""
    from vision_kit_tpu_torch.convert import deploy_state_dict
    from vision_kit_tpu_torch.models import YOLOV7
    from vision_kit_tpu_torch.models.architectures import init_weights
    from vision_kit_tpu_torch.ops import nms
    from vision_kit_tpu_torch.ops.head_scores import _check
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.utils.stream_bench import (
        calibrate_bn,
        calibrate_head,
        same_detections,
    )

    train = YOLOV7("base")
    init_weights(train, torch.Generator().manual_seed(0))
    train = train.to(cuda, memory_format=torch.channels_last).eval()
    calibrate_bn(train, 128, seed=2)
    calibrate_head(train, 128, seed=1)
    deploy = YOLOV7("base", deploy=True)
    deploy.load_state_dict(deploy_state_dict(train.state_dict()), strict=True)
    deploy = deploy.to(cuda, dtype, memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 255, (2, 128, 128, 3), dtype=np.uint8)).to(cuda)
    with torch.no_grad():
        for model in (train, deploy):
            _check(model(x, decode=False), None)

    pred = Predictor(deploy, img_size=128, device=cuda)
    frames = rng.integers(0, 255, (2, 96, 160, 3), dtype=np.uint8)
    before = greedy_keep.launches, head_scores.launches
    got, _ = pred.predict_batch(frames)
    assert (greedy_keep.launches, head_scores.launches) == (before[0] + 1, before[1] + 1)
    monkeypatch.setattr(nms, "head_scores", head_scores_reference)
    monkeypatch.setattr(nms, "greedy_keep", greedy_keep_reference)
    want, _ = pred.predict_batch(frames)
    assert sum(len(w) for w in want) > 20
    for w, g in zip(want, got):
        assert same_detections(w, g), (w, g)
