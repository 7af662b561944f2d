"""Serving a decode_order="reference" model: the port against the JAX
package on the CPU (v5n@64, seeded weights with crowded detections).

The reference-order raw maps are (B, na, ny, nx, no) permuted views of the
same conv output; postprocess_raw(anchor_major=True) takes them with the
candidates' indices in (ia, iy, ix) order, as JAX's does, and Predictor
picks the order from the model. Detections are compared as sets (class
exact, score 1e-5, box 1e-3 px: test_torch_nms.assert_same_detections)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
from vision_kit_tpu.ops.nms import postprocess_raw as jax_postprocess_raw
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu_torch.ops.head_scores import head_scores, native_views
from vision_kit_tpu_torch.ops.nms import postprocess_raw
from vision_kit_tpu_torch.predictor import Predictor
from test_torch_checkpoint import jax_apply, seeded_v5n
from test_torch_model import port_v5
from test_torch_nms import assert_same_detections

torch.set_num_threads(2)


def reference_pair():
    jm, v = seeded_v5n()
    jm_ref = JaxYOLOV5(variant="n", num_classes=80, decode_order="reference")
    return jm_ref, v, port_v5("n", v, decode_order="reference")


@pytest.mark.parametrize("mode", ["default", "classes"])
def test_postprocess_raw_anchor_major_matches_jax(mode):
    jm, v, tm = reference_pair()
    x = np.random.default_rng(9).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    _, jr = jax_apply(jm)(v, x)
    with torch.no_grad():
        _, tr = tm(torch.from_numpy(x))
    assert tuple(tr[0].shape) == (2, 3, 8, 8, 85)
    assert [tuple(t.shape) for t in tr] == [np.shape(r) for r in jr]
    classes = np.arange(80) % 3 == 0 if mode == "classes" else None
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, max_cand=512)
    jd, jv = jax_postprocess_raw(
        jr, jm.anchors_px, approx_topk=False, anchor_major=True,
        classes=None if classes is None else jnp.asarray(classes), **kw)
    td, tv = postprocess_raw(
        tr, tm.anchors_px, anchor_major=True,
        classes=None if classes is None else torch.from_numpy(classes), **kw)
    # the native order of the same maps gives the same detection sets
    nd, nv = postprocess_raw(
        [r.permute(0, 2, 3, 1, 4) for r in tr], tm.anchors_px,
        classes=None if classes is None else torch.from_numpy(classes), **kw)
    jd, jv = np.asarray(jd), np.asarray(jv)
    for i in range(2):
        assert jv[i].sum() > 10
        assert_same_detections(jd[i][jv[i]], td[i][tv[i]].numpy())
        assert_same_detections(nd[i][nv[i]].numpy(), td[i][tv[i]].numpy())


def test_predictor_on_reference_order_matches_jax():
    jm, v, tm = reference_pair()
    imgs = np.random.default_rng(3).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    want, _ = JaxPredictor(jm, v, img_size=64, approx_topk=False).predict_batch(imgs)
    got, _ = Predictor(tm, img_size=64, device="cpu").predict_batch(imgs)
    for w, g in zip(want, got):
        assert len(w) > 10
        assert_same_detections(w, g)


def test_head_scores_anchor_major_columns():
    """The anchor-major columns are the native ones in (ia, iy, ix) order;
    native_views hands the kernel the native memory and refuses a view of
    any other."""
    rng = np.random.default_rng(4)
    native = [torch.from_numpy(rng.normal(0, 2, (2, n, n, 3, 85)).astype(np.float32))
              for n in (4, 2)]
    views = [r.permute(0, 3, 1, 2, 4) for r in native]
    s_nat, c_nat = head_scores(native, 0.25)
    s_am, c_am = head_scores(views, 0.25, anchor_major=True)
    off = 0
    for r in native:
        b, ny, nx, na, _ = r.shape
        n = ny * nx * na
        perm = lambda t: t[:, off:off + n].reshape(b, ny, nx, na).permute(0, 3, 1, 2)
        # scores to 1e-6: the CPU's sigmoid rounds a strided read otherwise
        torch.testing.assert_close(s_am[:, off:off + n], perm(s_nat).reshape(b, n),
                                   rtol=1e-6, atol=0)
        assert torch.equal(c_am[:, off:off + n], perm(c_nat).reshape(b, n))
        off += n
    assert all(a.data_ptr() == b.data_ptr() and a.is_contiguous()
               for a, b in zip(native_views(views), native))
    with pytest.raises(ValueError, match="permuted views"):
        native_views([v.contiguous() for v in views])
