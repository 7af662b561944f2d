"""Weight bridge: the port's state_dict_from_jax_variables against the JAX
package's own flax_to_torch, and strict loading into the port's YOLOV5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.convert import flax_to_torch
from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
from vision_kit_tpu_torch.convert import state_dict_from_jax_variables
from vision_kit_tpu_torch.models import YOLOV5

torch.set_num_threads(2)


@pytest.mark.parametrize("variant", ["n", "s"])
def test_state_dict_equals_flax_to_torch(variant):
    jm = JaxYOLOV5(variant=variant, num_classes=80)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 64, 64, 3)), training=False))
    got = state_dict_from_jax_variables(v)
    want = flax_to_torch(v)
    assert set(got) == set(want)
    for key, arr in want.items():
        t = got[key]
        assert t.dtype == torch.from_numpy(np.asarray(arr)).dtype, key
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=key)
    model = YOLOV5(variant=variant, num_classes=80)
    model.load_state_dict(got, strict=True)
    assert model.state_dict()["backbone.stage1.0.conv.weight"].shape == \
        got["backbone.stage1.0.conv.weight"].shape
    assert "head.m.0.bias" in got


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
