"""Port (vision_kit_tpu_torch) vs JAX package on the CPU: the IoU family,
YoloLoss and YoloLossOTA, their gradients, and the SimOTA assignment.

The same numpy-seeded maps and targets go through both; the JAX losses run
eagerly. SimOTA's assignment (fg mask and matched label) is compared for
equality: the JAX one is read from inside its call by a jax proxy whose
vmap records the assignment's outputs, the port's by wrapping its
`assign` method."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.models.heads import V5_ANCHORS, V7_ANCHORS, normalized_anchors
from vision_kit_tpu.ops import boxes as jax_boxes
from vision_kit_tpu.train import losses as jax_losses
from vision_kit_tpu.train import ota as jax_ota
from vision_kit_tpu_torch.ops import boxes
from vision_kit_tpu_torch.train.losses import YoloLoss, bce_with_logits, focal_bce_with_logits
from vision_kit_tpu_torch.train.ota import YoloLossOTA

torch.set_num_threads(2)

HYP = {"box": 0.05, "obj": 1.0, "cls": 0.5, "cls_pw": 1.0, "obj_pw": 1.0,
       "anchor_t": 4.0, "label_smoothing": 0.0}
STRIDES = (8.0, 16.0, 32.0)
NC = 7


# -- IoU family --------------------------------------------------------------

def random_boxes(rng, n, fmt):
    """n boxes in `fmt`, some disjoint, some nested, some degenerate."""
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(0, 30, (n, 2))
    wh[::9] = 0.0
    if fmt == "xyxy":
        b = np.concatenate([xy, xy + wh], 1)
    elif fmt == "xywh":
        b = np.concatenate([xy, wh], 1)
    else:
        b = np.concatenate([xy + wh / 2, wh], 1)
    return b.astype(np.float32)


@pytest.mark.parametrize("fmt", ["xyxy", "xywh", "cxcywh"])
@pytest.mark.parametrize("mode", ["iou", "iof", "giou", "diou", "ciou"])
def test_box_iou_aligned_matches_jax(mode, fmt):
    rng = np.random.default_rng(1)
    b1, b2 = random_boxes(rng, 200, fmt), random_boxes(rng, 200, fmt)
    b2[:40] = b1[:40] + rng.normal(0, 2, (40, 4)).astype(np.float32)
    want = jax_boxes.box_iou_aligned(jnp.asarray(b1), jnp.asarray(b2), fmt, mode)
    got = boxes.box_iou_aligned(torch.from_numpy(b1), torch.from_numpy(b2), fmt, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    pair_want = jax_boxes.box_iou_pairwise(jnp.asarray(b1[:30]), jnp.asarray(b2[:20]),
                                           fmt, mode)
    pair_got = boxes.box_iou_pairwise(torch.from_numpy(b1[:30]),
                                      torch.from_numpy(b2[:20]), fmt, mode)
    np.testing.assert_allclose(pair_got.numpy(), np.asarray(pair_want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["giou", "diou", "ciou"])
def test_box_iou_gradient_matches_jax(mode):
    """CIoU's alpha carries no gradient in either framework."""
    rng = np.random.default_rng(2)
    b1 = random_boxes(rng, 64, "cxcywh") + 1.0
    b2 = b1 + rng.normal(0, 3, b1.shape).astype(np.float32)
    want = jax.grad(lambda a: jax_boxes.box_iou_aligned(
        a, jnp.asarray(b2), "cxcywh", mode).sum())(jnp.asarray(b1))
    t1 = torch.from_numpy(b1).requires_grad_()
    boxes.box_iou_aligned(t1, torch.from_numpy(b2), "cxcywh", mode).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# -- YoloLoss ----------------------------------------------------------------

def make_maps(rng, b, img, nc, layout, scale=1.0):
    """Per-level raw maps, anchor-major or native, as numpy f32."""
    out = []
    for s in STRIDES:
        g = img // int(s)
        m = rng.normal(0, scale, (b, 3, g, g, nc + 5)).astype(np.float32)
        out.append(m if layout == "anchor_major" else
                   np.ascontiguousarray(m.transpose(0, 2, 3, 1, 4)))
    return out


def make_targets(rng, b, m, n, nc, edge=False):
    """(b, m, 5) padded targets with n labels an image; edge=True puts
    labels on the image border and the corner (their offsets clip to the
    centre's cell: duplicate candidates) and a repeated label (conflicts)."""
    t = np.full((b, m, 5), -1, np.float32)
    t[:, :n, 0] = rng.integers(0, nc, (b, n))
    t[:, :n, 1:3] = rng.uniform(0.05, 0.95, (b, n, 2))
    t[:, :n, 3:5] = rng.uniform(0.05, 0.5, (b, n, 2))
    if edge:
        t[:, 0, 1:3] = 1.0
        t[:, 1, 1] = 1.0
        t[:, 2, 2] = 0.0
        t[:, 3] = t[:, 4]
    return t


def run_both(jloss, ploss, maps, targets, dtype=np.float32, recorder=None):
    """((total, parts, grads), (total, parts, grads)) of the JAX and the
    port loss; the JAX side under one jit of the loss and its gradient,
    which also returns the assignment `recorder` saw, if any."""
    tdtype = torch.bfloat16 if dtype != np.float32 else torch.float32
    tmaps = [torch.from_numpy(m).to(tdtype).requires_grad_() for m in maps]
    jt = jnp.asarray(targets)

    def total(ms):
        t, parts = jloss(ms, jt)
        return t, (parts, recorder.outputs[-1] if recorder else None)

    (jtotal, (jparts, assign)), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [jnp.asarray(m, dtype) for m in maps])
    if recorder:
        recorder.outputs[-1] = assign
    ttotal, tparts = ploss(tmaps, torch.from_numpy(targets))
    ttotal.backward()
    return (jtotal, jparts, jgrads), (ttotal.detach(), tparts, [m.grad for m in tmaps])


def assert_losses_agree(jax_out, port_out, rtol=1e-5, atol=1e-6, grad_atol=1e-6):
    (jtotal, jparts, jgrads), (ttotal, tparts, tgrads) = jax_out, port_out
    assert ttotal.dtype == torch.float32 and tparts.dtype == torch.float32
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tparts.numpy(), np.asarray(jparts), rtol=rtol, atol=atol)
    for jg, tg in zip(jgrads, tgrads):
        assert tg.dtype == (torch.bfloat16 if jg.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_allclose(tg.float().numpy(), np.asarray(jg, np.float32),
                                   rtol=rtol, atol=grad_atol)


V5 = normalized_anchors(V5_ANCHORS, STRIDES)
V7 = normalized_anchors(V7_ANCHORS, STRIDES)


@pytest.mark.parametrize("case", ["native", "anchor_major", "auto_native", "empty",
                                  "focal", "smoothing", "edge"])
def test_yolo_loss_matches_jax(case):
    """Loss, parts and the gradient on every map against jax.grad, f32:
    1e-5 relative."""
    rng = np.random.default_rng(3)
    layout = "anchor_major" if case == "anchor_major" else "native"
    hyp = dict(HYP, fl_gamma=1.5) if case == "focal" else (
        dict(HYP, label_smoothing=0.1) if case == "smoothing" else HYP)
    jloss = jax_losses.YoloLoss(NC, V5, hyp, layout="auto" if case == "auto_native" else layout)
    ploss = YoloLoss(NC, V5, hyp, layout="auto" if case == "auto_native" else layout)
    maps = make_maps(rng, 2, 160, NC, layout)
    targets = make_targets(rng, 2, 10, 0 if case == "empty" else 7, NC, edge=case == "edge")
    jax_out, port_out = run_both(jloss, ploss, maps, targets)
    assert_losses_agree(jax_out, port_out)
    if case == "empty":
        assert float(port_out[1][0]) == 0.0 and float(port_out[1][2]) == 0.0
    else:
        assert float(port_out[1][0]) > 0.0


def test_yolo_loss_bf16_maps_match_jax():
    """bf16 maps: the objectness targets and the candidate count in bf16,
    the box term in f32, as under JAX's promotion; a bf16 gradient on each
    map. Tolerance 1e-2 relative: bf16 rounds at 2^-8, and the frameworks
    may round a bf16 sum or mean in another order."""
    rng = np.random.default_rng(4)
    jloss = jax_losses.YoloLoss(NC, V5, HYP, layout="native")
    ploss = YoloLoss(NC, V5, HYP, layout="native")
    maps = make_maps(rng, 2, 160, NC, "native")
    targets = make_targets(rng, 2, 10, 6, NC)
    jax_out, port_out = run_both(jloss, ploss, maps, targets, dtype=jnp.bfloat16)
    assert_losses_agree(jax_out, port_out, rtol=1e-2, atol=1e-3, grad_atol=2e-4)


def test_yolo_loss_layouts_agree():
    """Native and anchor-major maps give the same loss in the port."""
    rng = np.random.default_rng(5)
    maps = make_maps(rng, 2, 160, NC, "anchor_major")
    targets = torch.from_numpy(make_targets(rng, 2, 10, 6, NC))
    am = YoloLoss(NC, V5, HYP, layout="anchor_major")(
        [torch.from_numpy(m) for m in maps], targets)
    nat = YoloLoss(NC, V5, HYP)(
        [torch.from_numpy(m).permute(0, 2, 3, 1, 4) for m in maps], targets)
    torch.testing.assert_close(nat[1], am[1], rtol=1e-6, atol=1e-7)


def test_bce_helpers_match_jax():
    x = np.linspace(-30, 30, 121).astype(np.float32)
    t = (np.cos(x) * 0.5 + 0.5).astype(np.float32)
    for pw in (1.0, 2.5):
        np.testing.assert_allclose(
            bce_with_logits(torch.from_numpy(x), torch.from_numpy(t), pw).numpy(),
            np.asarray(jax_losses.bce_with_logits(jnp.asarray(x), jnp.asarray(t), pw)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            focal_bce_with_logits(torch.from_numpy(x), torch.from_numpy(t), pw).numpy(),
            np.asarray(jax_losses.focal_bce_with_logits(jnp.asarray(x), jnp.asarray(t), pw)),
            rtol=1e-5, atol=1e-6)


# -- SimOTA ------------------------------------------------------------------

class _VmapRecorder:
    """Stands in for the jax module inside the JAX ota module: its vmap
    records what the mapped function (the per-image assignment) returns."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kwargs):
        mapped = jax.vmap(fn, *args, **kwargs)

        def run(*xs):
            out = mapped(*xs)
            self.outputs.append(out)
            return out
        return run


def ota_both(maps, targets, monkeypatch, dtype=np.float32, layout="native", **kw):
    """(JAX outputs, port outputs, JAX assignment, port assignment)."""
    recorder = _VmapRecorder()
    monkeypatch.setattr(jax_ota, "jax", recorder)
    jloss = jax_ota.YoloLossOTA(NC, V7, dict(HYP, **kw), strides=STRIDES, layout=layout)
    ploss = YoloLossOTA(NC, V7, dict(HYP, **kw), strides=STRIDES, layout=layout)
    port_assign = []
    assign = ploss.assign

    def recording_assign(*args):
        out = assign(*args)
        port_assign.append(out)
        return out

    ploss.assign = recording_assign
    jax_out, port_out = run_both(jloss, ploss, maps, targets, dtype, recorder)
    fg, mg = recorder.outputs[0]
    return jax_out, port_out, (np.asarray(fg), np.asarray(mg)), port_assign[0]


def assert_same_assignment(jax_assign, port_assign):
    fg, mg = jax_assign
    pfg, pmg = (t.numpy() for t in port_assign)
    np.testing.assert_array_equal(pfg, fg)
    np.testing.assert_array_equal(pmg[fg], mg[fg])
    assert fg.sum() > 0


@pytest.mark.parametrize("case", ["random", "anchor_major", "edge_ties", "focal"])
def test_ota_matches_jax(case, monkeypatch):
    """The assignment equal (fg mask and each foreground candidate's
    label); loss, parts and gradients to 1e-5 relative, f32. edge_ties:
    labels on the border and corner give candidates that clip to one cell
    (equal costs: the lower index must win, as in jax.lax.top_k), and a
    repeated label gives claims of equal cost (the first label wins)."""
    rng = np.random.default_rng(6)
    layout = "anchor_major" if case == "anchor_major" else "native"
    maps = make_maps(rng, 2, 160, NC, layout)
    targets = make_targets(rng, 2, 8, 6, NC, edge=case == "edge_ties")
    kw = {"fl_gamma": 1.5} if case == "focal" else {}
    jax_out, port_out, ja, pa = ota_both(maps, targets, monkeypatch, layout=layout, **kw)
    assert_same_assignment(ja, pa)
    assert_losses_agree(jax_out, port_out)


def test_ota_edge_labels_give_tied_candidates():
    """The tie case is real: valid candidates of one label and anchor that
    clip to one cell (and so carry the same features and cost)."""
    targets = torch.from_numpy(make_targets(np.random.default_rng(6), 2, 8, 6, NC,
                                            edge=True))
    ploss = YoloLossOTA(NC, V7, HYP, strides=STRIDES)
    n_tied = 0
    for level, g in enumerate((20, 10, 5)):
        c = ploss._candidates(targets, torch.from_numpy(V7[level]), g, g)
        cells = torch.stack([c["gi"], c["gj"]], -1)              # (B, M, na, 5, 2)
        for b, m, a in zip(*torch.nonzero(c["valid"].any(-1), as_tuple=True)):
            v = c["valid"][b, m, a]
            n_tied += int(v.sum()) - len(torch.unique(cells[b, m, a][v], dim=0))
    assert n_tied > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ota_saturated_logits_match_jax(dtype, monkeypatch):
    """Saturated logits (|z| = 40) keep the classification cost finite in
    both (the stable log identities): the same assignment, a finite loss
    and gradient."""
    targets = np.full((2, 8, 5), -1, np.float32)
    targets[:, 0] = [1, 0.5, 0.5, 0.25, 0.25]
    maps = []
    for s in STRIDES:
        g = 160 // int(s)
        p = np.zeros((2, g, g, 3, NC + 5), np.float32)
        p[..., 4] = 40.0
        p[..., 5:] = -40.0
        p[..., 6] = 40.0
        maps.append(p)
    jdtype = jnp.bfloat16 if dtype == "bf16" else np.float32
    jax_out, port_out, ja, pa = ota_both(maps, targets, monkeypatch, dtype=jdtype)
    assert_same_assignment(ja, pa)
    assert np.isfinite(float(port_out[0]))
    assert all(torch.isfinite(g.float()).all() for g in port_out[2])
    np.testing.assert_allclose(float(port_out[0]), float(jax_out[0]), rtol=1e-2)


def test_ota_conflict_reassigns_to_argmin():
    """A candidate claimed by labels 1 and 2 goes to label 0, the least
    cost, though it never claimed it; a single claim stays (the JAX test's
    case, batched)."""
    mm = np.array([[False, False], [True, True], [True, False]])
    cost = np.array([[1.0, 5.0], [2.0, 4.0], [3.0, 9.0]], np.float32)
    want = np.asarray(jax_ota.YoloLossOTA._resolve_conflicts(jnp.asarray(mm),
                                                             jnp.asarray(cost)))
    got = YoloLossOTA._resolve_conflicts(torch.from_numpy(mm)[None],
                                         torch.from_numpy(cost)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], [True, False, False])


def test_ota_empty_targets_match_jax(monkeypatch):
    rng = np.random.default_rng(7)
    maps = make_maps(rng, 2, 160, NC, "native")
    targets = np.full((2, 8, 5), -1, np.float32)
    recorder = _VmapRecorder()
    monkeypatch.setattr(jax_ota, "jax", recorder)
    jloss = jax_ota.YoloLossOTA(NC, V7, HYP, strides=STRIDES)
    ploss = YoloLossOTA(NC, V7, HYP, strides=STRIDES)
    jax_out, port_out = run_both(jloss, ploss, maps, targets)
    assert_losses_agree(jax_out, port_out)
    assert float(port_out[1][0]) == 0.0 and float(port_out[1][1]) > 0.0

