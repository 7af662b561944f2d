"""Weight bridge: the port's state_dict_from_jax_variables against the JAX
package's own flax_to_torch, and strict loading into the port's YOLOV5 and
YOLOV7 (training and deploy structure)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.convert import flax_to_torch
from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
from vision_kit_tpu.models import YOLOV7 as JaxYOLOV7
from vision_kit_tpu_torch.convert import state_dict_from_jax_variables
from vision_kit_tpu_torch.models import YOLOV5, YOLOV7

torch.set_num_threads(2)


@pytest.mark.parametrize("family,variant,deploy", [
    pytest.param("v5", "n", False, id="n"),
    pytest.param("v5", "s", False, id="s"),
    pytest.param("v7", "base", False, id="v7-base"),
    pytest.param("v7", "base", True, id="v7-base-deploy"),
    pytest.param("v7", "x", False, id="v7-x"),
    pytest.param("v7", "x", True, id="v7-x-deploy"),
])
def test_state_dict_equals_flax_to_torch(family, variant, deploy):
    if family == "v5":
        jm = JaxYOLOV5(variant=variant, num_classes=80)
        v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 64, 64, 3)), training=False))
        model = YOLOV5(variant=variant, num_classes=80)
        probe = "backbone.stage1.0.conv.weight"
    else:
        # a v7 init costs half a minute here: random values on its shapes
        jm = JaxYOLOV7(variant=variant, num_classes=80, deploy=deploy)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=False))
        rng = np.random.default_rng(0)
        v = jax.tree_util.tree_map(
            lambda s: rng.normal(0, 1, s.shape).astype(np.float32), shapes)
        model = YOLOV7(variant, num_classes=80, deploy=deploy)
        probe = "backbone.stage2_1.conv3.conv.weight"
        assert ("head.ia.0.implicit" in flax_to_torch(v)) != deploy
    got = state_dict_from_jax_variables(v)
    want = flax_to_torch(v)
    assert set(got) == set(want)
    for key, arr in want.items():
        t = got[key]
        assert t.dtype == torch.from_numpy(np.asarray(arr)).dtype, key
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=key)
    model.load_state_dict(got, strict=True)
    assert model.state_dict()[probe].shape == got[probe].shape
    assert "head.m.0.bias" in got


def test_root_level_leaves_and_transposed_kernel():
    """Leaves of a module at the root (an Implicit, a DWConvTranspose2d)
    get bare torch names; the (k, k, 1, O) transposed kernel loads into a
    grouped ConvTranspose2d."""
    from vision_kit_tpu_torch.models.layers import DWConvTranspose2d, Implicit

    imp = np.arange(6, dtype=np.float32).reshape(1, 1, 1, 6)
    sd = state_dict_from_jax_variables({"params": {"implicit": imp}})
    assert list(sd) == ["implicit"] and tuple(sd["implicit"].shape) == (1, 6, 1, 1)
    Implicit(6).load_state_dict(sd, strict=True)
    kernel = np.arange(2 * 2 * 8, dtype=np.float32).reshape(2, 2, 1, 8)
    sd = state_dict_from_jax_variables({"params": {"kernel": kernel,
                                                   "bias": np.zeros(8, np.float32)}})
    assert tuple(sd["weight"].shape) == (8, 1, 2, 2)
    mod = DWConvTranspose2d(4, 8, 2, 2)
    mod.load_state_dict(sd, strict=True)
    assert torch.equal(mod.weight.reshape(8, 1, 2, 2), sd["weight"])


@pytest.mark.parametrize("shape", [(2, 4, 2, 2), (1, 8, 2, 2), (8, 1, 4, 1)])
def test_transposed_kernel_of_another_layout_is_refused(shape):
    """Only the bridged (O, 1, k, k) layout is reshaped on load: a weight
    of the same size in any other shape fails the strict load."""
    from vision_kit_tpu_torch.models.layers import DWConvTranspose2d

    mod = DWConvTranspose2d(4, 8, 2, 2)
    sd = {"weight": torch.zeros(shape), "bias": torch.zeros(8)}
    with pytest.raises(RuntimeError, match="size mismatch"):
        mod.load_state_dict(sd, strict=True)


def test_sibling_aware_split():
    """`base_N` splits into `base.N` only beside a `base_0` sibling."""
    v = {"params": {
        "stage2_1": {"conv": {"kernel": np.ones((1, 1, 2, 3), np.float32)}},
        "m_0": {"bias": np.zeros(3, np.float32)},
        "m_1": {"bias": np.ones(3, np.float32)},
    }}
    sd = state_dict_from_jax_variables(v)
    assert sorted(sd) == ["m.0.bias", "m.1.bias", "stage2_1.conv.weight"]
    assert tuple(sd["stage2_1.conv.weight"].shape) == (3, 2, 1, 1)


def test_bn_statistics_and_counter():
    v = {
        "params": {"bn": {"scale": np.full(4, 2.0, np.float32),
                          "bias": np.full(4, 0.5, np.float32)}},
        "batch_stats": {"bn": {"mean": np.arange(4, dtype=np.float32),
                               "var": np.full(4, 3.0, np.float32)}},
    }
    sd = state_dict_from_jax_variables(v)
    assert torch.equal(sd["bn.running_mean"], torch.arange(4.0))
    assert torch.equal(sd["bn.running_var"], torch.full((4,), 3.0))
    assert torch.equal(sd["bn.weight"], torch.full((4,), 2.0))
    assert sd["bn.num_batches_tracked"].dtype == torch.int64
