"""The port's hand-written kernels against their plain versions on a CUDA
card. Every test here skips on a host without CUDA; on the card run

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(--noconftest: the suite's conftest imports JAX, which this file does not
need.)
"""

import numpy as np
import pytest
import torch

from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep, greedy_keep_reference
from vision_kit_tpu_torch.ops.head_scores import head_scores, head_scores_reference


pytestmark = pytest.mark.cuda


def make_boxes(rng, b, k, case):
    """(B, K, 4) xyxy f32 in score order and (B, K) valid; `crowded`
    clusters boxes of two classes (class offset added) around few centres."""
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
    return boxes.astype(np.float32), valid


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("k", [252, 512, 1024, 1280])
@pytest.mark.parametrize("case", ["random", "crowded", "invalid_tail"])
def test_greedy_kernel_bit_equal_to_plain(cuda, k, case):
    boxes, valid = make_boxes(np.random.default_rng(k), 8, k, case)
    bt = torch.from_numpy(boxes).to(cuda)
    vt = torch.from_numpy(valid).to(cuda)
    before = greedy_keep.launches
    got = greedy_keep(bt, vt, 0.45)
    assert greedy_keep.launches == before + 1
    assert torch.equal(got, greedy_keep_reference(bt, vt, 0.45))


def test_greedy_kernel_rejects_bad_input(cuda):
    boxes = torch.zeros(2, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        greedy_keep(boxes, torch.ones(2, 8, dtype=torch.bool, device=cuda), 0.5)


def test_greedy_kernel_refuses_k_beyond_shared_memory(cuda):
    boxes = torch.zeros(2, 2048, 4, device=cuda)
    before = greedy_keep.launches
    with pytest.raises(ValueError, match="shared memory"):
        greedy_keep(boxes, torch.ones(2, 2048, dtype=torch.bool, device=cuda), 0.5)
    assert greedy_keep.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
def test_head_scores_kernel_matches_plain(cuda, dtype, masked):
    gen = torch.Generator(device=cuda).manual_seed(0)
    raws = [(torch.randn(2, n, n, 255, generator=gen, device=cuda) * 2)
            .to(dtype).view(2, n, n, 3, 85) for n in (16, 8, 4)]
    classes = (torch.arange(80, device=cuda) % 3 != 1) if masked else None
    before = head_scores.launches
    ks, kc = head_scores(raws, 0.25, classes)
    assert head_scores.launches == before + 3
    rs, rc = head_scores_reference(raws, 0.25, classes)
    assert torch.equal(kc, rc)
    both = (ks > -1) & (rs > -1)
    flip = (ks > -1) != (rs > -1)
    assert bool(((torch.where(ks > -1, ks, rs)[flip] - 0.25).abs() <= 1e-6).all())
    torch.testing.assert_close(ks[both], rs[both], rtol=1e-6, atol=0)


def test_head_scores_kernel_rejects_relayout(cuda):
    raw = torch.zeros(1, 85, 3, 4, 4, device=cuda).permute(0, 3, 4, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        head_scores([raw], 0.25)
