"""The port's public `ops` and `models` namespaces against the JAX
package's, name for name, and the helpers only they hold: the six box
conversions and clip_boxes on tests/test_boxes.py's cases against JAX's
functions, and letterbox_np against JAX's (cv2) bit for bit over each
option."""

import numpy as np
import pytest
import torch

import vision_kit_tpu.models as jax_models
import vision_kit_tpu.ops as jax_ops
import vision_kit_tpu_torch.models as port_models
import vision_kit_tpu_torch.ops as port_ops
from vision_kit_tpu.ops import boxes as jax_boxes
from vision_kit_tpu.ops.letterbox import letterbox_np as jax_letterbox_np
from vision_kit_tpu_torch.ops.letterbox import letterbox_np

torch.set_num_threads(2)


@pytest.mark.parametrize("port,jax", [(port_ops, jax_ops), (port_models, jax_models)])
def test_namespaces_export_the_jax_names(port, jax):
    assert port.__all__ == jax.__all__
    for name in port.__all__:
        assert callable(getattr(port, name)), name


def rand_xyxy(n: int, seed: int) -> np.ndarray:
    """test_boxes.py's boxes: corners in [0, 300), sizes in [1, 200)."""
    rng = np.random.default_rng(seed)
    x1y1 = rng.uniform(0, 300, size=(n, 2))
    wh = rng.uniform(1, 200, size=(n, 2))
    return np.concatenate([x1y1, x1y1 + wh], axis=-1).astype(np.float32)


CONVERSIONS = [("xyxy_to_cxcywh", {}), ("xyxy_to_xywh", {}), ("xywh_to_cxcywh", {}),
               ("xywhn_to_xyxy", {"w": 640, "h": 480, "padw": 3.5, "padh": -2.0}),
               ("xywhn_to_xyxy", {}), ("xyxy_to_xywhn", {"w": 640, "h": 480}),
               ("xyxy_to_xywhn", {}), ("cxcywh_to_xyxy", {}), ("xywh_to_xyxy", {})]


@pytest.mark.parametrize("name,kw", CONVERSIONS)
def test_box_conversions_equal_jax(name, kw):
    """Each conversion on 64 random boxes and on a (2, 8, 4) batch, within
    1e-6 of JAX's."""
    for b in (rand_xyxy(64, 0), rand_xyxy(16, 1).reshape(2, 8, 4)):
        if name.startswith("xywhn"):
            b = b / 700.0
        want = np.asarray(getattr(jax_boxes, name)(b, **kw))
        got = getattr(port_ops, name)(torch.from_numpy(b), **kw)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * max(
            1.0, float(np.abs(want).max())))


def test_round_trips_and_clip_as_test_boxes():
    """test_boxes.py's round trips and clip case, and clip_boxes against
    JAX's on boxes that cross every edge."""
    b = torch.from_numpy(rand_xyxy(64, 2))
    np.testing.assert_allclose(port_ops.cxcywh_to_xyxy(port_ops.xyxy_to_cxcywh(b)), b,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(port_ops.xywh_to_xyxy(port_ops.xyxy_to_xywh(b)), b,
                               rtol=1e-5, atol=1e-4)
    n = port_ops.xyxy_to_xywhn(b, w=640, h=480)
    np.testing.assert_allclose(port_ops.xywhn_to_xyxy(n, w=640, h=480), b, rtol=1e-4,
                               atol=1e-3)
    c = port_ops.clip_boxes(torch.tensor([[-5.0, -5.0, 700.0, 500.0]]), (480, 640))
    np.testing.assert_allclose(c.numpy(), [[0.0, 0.0, 640.0, 480.0]])
    wide = rand_xyxy(64, 3) * 3 - 200
    np.testing.assert_allclose(port_ops.clip_boxes(torch.from_numpy(wide), (300, 400)),
                               np.asarray(jax_boxes.clip_boxes(wide, (300, 400))),
                               rtol=0, atol=1e-6)


LETTERBOX_OPTIONS = [{}, {"auto": True}, {"auto": True, "stride": 64},
                     {"scaleup": False}, {"letterbox": False},
                     {"letterbox": False, "auto": True}, {"color": (0, 50, 255)},
                     {"scaleup": False, "auto": True, "color": (1, 2, 3)}]


@pytest.mark.parametrize("kw", LETTERBOX_OPTIONS)
@pytest.mark.parametrize("src_hw,dst", [((333, 517), 640), ((720, 1280), (384, 640)),
                                        ((100, 60), 64), ((48, 64), (96, 128)),
                                        ((17, 9), 32)])
def test_letterbox_np_equals_jax(src_hw, dst, kw):
    img = np.random.default_rng(sum(src_hw)).integers(0, 256, (*src_hw, 3), np.uint8)
    want, (w_ratio, w_pad) = jax_letterbox_np(img, dst, **kw)
    got, (ratio, pad) = letterbox_np(img, dst, **kw)
    assert (ratio, pad) == (w_ratio, w_pad)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_letterbox_np_on_grey_equals_jax():
    img = np.random.default_rng(5).integers(0, 256, (50, 70), np.uint8)
    want, meta = jax_letterbox_np(img, 64, color=(9, 9, 9))
    got, got_meta = letterbox_np(img, 64, color=(9, 9, 9))
    assert got_meta == meta
    np.testing.assert_array_equal(got, want)
