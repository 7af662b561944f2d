"""Port (vision_kit_tpu_torch) vs JAX package: blocks and whole YOLOv5
models on the CPU, with the same weights carried across by
state_dict_from_jax_variables.

The helpers here are shared by the other test_torch_* files.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
from vision_kit_tpu.models import layers as jl
from vision_kit_tpu_torch.convert import state_dict_from_jax_variables
from vision_kit_tpu_torch.models import YOLOV5, build_model
from vision_kit_tpu_torch.models import layers as tl
from vision_kit_tpu_torch.models.heads import head_bias_prior
from vision_kit_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def randomize_bn(tree, rng):
    """Non-trivial BatchNorm weights and statistics, in place, so that eps
    and the affine terms matter. Returns tree."""
    def walk(params, stats):
        for name, node in params.items():
            if not isinstance(node, dict):
                continue
            if "scale" in node:
                c = node["scale"].shape
                node["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
                node["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[name]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            else:
                walk(node, stats.get(name, {}))
    walk(tree["params"], tree.get("batch_stats", {}))
    return tree


def _numpy_tree(variables):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(variables))


def jax_v5(variant="n", size=64, num_classes=80, seed=0):
    """A JAX YOLOv5 and numpy variables in which detections are crowded:
    random BatchNorm, zero head biases (the random-init priors push every
    score below conf) and head kernels scaled so the raw logits have unit
    spread (random-init features are tiny)."""
    jm = JaxYOLOV5(variant=variant, num_classes=num_classes)
    v = _numpy_tree(jm.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, size, size, 3)), training=False))
    randomize_bn(v, np.random.default_rng(seed))
    head = v["params"]["head"]
    for i in range(3):
        head[f"m_{i}"]["bias"] = np.zeros_like(head[f"m_{i}"]["bias"])
    probe = np.random.default_rng(seed + 1).integers(
        0, 255, (1, size, size, 3), dtype=np.uint8)
    _, raws = jm.apply(v, jnp.asarray(probe), training=False)
    for i, raw in enumerate(raws):
        head[f"m_{i}"]["kernel"] = (
            head[f"m_{i}"]["kernel"] / np.asarray(raw).std()
        ).astype(np.float32)
    return jm, v


def port_v5(variant, variables, num_classes=80, decode_order="native"):
    model = YOLOV5(variant=variant, num_classes=num_classes,
                   decode_order=decode_order)
    model.load_state_dict(state_dict_from_jax_variables(variables), strict=True)
    return model.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _block_pair(jax_block, torch_block, x_nhwc, seed=0):
    v = _numpy_tree(jax_block.init(jax.random.PRNGKey(seed),
                                   jnp.asarray(x_nhwc), training=False))
    randomize_bn(v, np.random.default_rng(seed))
    want = np.asarray(jax_block.apply(v, jnp.asarray(x_nhwc), training=False))
    torch_block.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    torch_block.eval()
    with torch.no_grad():
        got = torch_block(_nchw(x_nhwc)).permute(0, 2, 3, 1).numpy()
    return want, got


@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_conv_bn_act_matches_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "uint8":
        x = rng.integers(0, 255, (2, 16, 16, 3), dtype=np.uint8)
        jb, tb = jl.ConvBnAct(8, 6, 2, 2), tl.ConvBnAct(3, 8, 6, 2, 2)
    else:
        x = rng.normal(0, 1, (2, 16, 16, 5)).astype(np.float32)
        jb, tb = jl.ConvBnAct(8, 3, 2), tl.ConvBnAct(5, 8, 3, 2)
    want, got = _block_pair(jb, tb, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sppf_matches_jax():
    x = np.random.default_rng(4).normal(0, 1, (2, 12, 12, 16)).astype(np.float32)
    want, got = _block_pair(jl.SPPF(24), tl.SPPF(16, 24), x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shortcut", [True, False])
def test_c3_bottleneck_matches_jax(shortcut):
    x = np.random.default_rng(5).normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    want, got = _block_pair(jl.C3Bottleneck(16, n=2, shortcut=shortcut),
                            tl.C3Bottleneck(16, 16, n=2, shortcut=shortcut), x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _compare_models(variant, size, batch, tol, decode_order="native"):
    jm, v = jax_v5(variant, size)
    if decode_order != "native":
        jm = JaxYOLOV5(variant=variant, num_classes=80,
                       decode_order=decode_order)
    tm = port_v5(variant, v, decode_order=decode_order)
    x = np.random.default_rng(7).integers(0, 255, (batch, size, size, 3),
                                          dtype=np.uint8)
    jd, jr = jm.apply(v, jnp.asarray(x), training=False)
    with torch.no_grad():
        td, tr = tm(torch.from_numpy(x))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)
    assert len(tr) == len(jr) == 3
    for a, b in zip(jr, tr):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol, atol=tol)


@pytest.mark.parametrize("decode_order", ["native", "reference"])
def test_v5n_64_matches_jax(decode_order):
    _compare_models("n", 64, 2, 1e-4, decode_order)


def test_v5s_640_matches_jax():
    # 1e-3: at 640 the convolutions sum over more terms, in another order
    _compare_models("s", 640, 1, 1e-3)


@pytest.mark.parametrize("variant", ["n", "s", "m", "l", "x"])
def test_all_v5_variants_build(variant):
    """The port's parameter tree equals the JAX one, key and shape, for
    every variant (JAX side by shape only, no compile)."""
    from vision_kit_tpu.convert import flax_to_torch

    jm = JaxYOLOV5(variant=variant, num_classes=80)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                        training=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k: tuple(np.shape(a)) for k, a in flax_to_torch(zeros).items()}
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = variant, 80
    model = build_model(cfg, device="cpu")
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want


def test_build_model_is_seeded_and_channels_last():
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version = "n"
    a = build_model(cfg, device="cpu", seed=1)
    b = build_model(cfg, device="cpu", seed=1)
    c = build_model(cfg, device="cpu", seed=2)
    for (k, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), k
    w = a.backbone.stem.conv.weight
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert not torch.equal(w, c.backbone.stem.conv.weight)
    assert not a.training


def test_build_model_v7_tiny_raises():
    """The reference's v7 "tiny" has a backbone table but no neck or
    anchors: building it fails at construction, as in the JAX package."""
    cfg = load_config(os.path.join(REPO, "configs/yolov7.yaml"))
    cfg.model.version = "tiny"
    with pytest.raises(ValueError, match="tiny"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("variant", ["base", "x"])
def test_build_model_v7_is_seeded_and_channels_last(variant):
    cfg = load_config(os.path.join(REPO, "configs/yolov7.yaml"))
    cfg.model.version, cfg.model.deploy = variant, True
    a = build_model(cfg, device="cpu", seed=1)
    b = build_model(cfg, device="cpu", seed=1)
    for (k, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), k
    cfg.model.deploy = False
    train = build_model(cfg, device="cpu", seed=1)
    assert not a.training and not train.training
    w = train.backbone.stem.conv.weight
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(w, a.backbone.stem.conv.weight)
    head = train.head
    assert "ia" not in dict(a.head.named_children())
    ia = torch.cat([m.implicit.detach().flatten() for m in head.ia])
    im = torch.cat([m.implicit.detach().flatten() for m in head.im])
    assert abs(float(ia.mean())) < 0.005 and abs(float(im.mean()) - 1) < 0.005
    assert 0.015 < float(ia.std()) < 0.025 and 0.015 < float(im.std()) < 0.025
    for i, conv in enumerate(head.m):
        prior = head_bias_prior(head.stride[i], head.na, head.num_classes)
        np.testing.assert_array_equal(conv.bias.detach().numpy(), prior)
    if variant == "base":
        assert not a.neck.pan_conv0.rbr_reparam.bias.any()
