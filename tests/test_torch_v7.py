"""Port (vision_kit_tpu_torch) vs JAX package on the CPU: the YOLOv7 blocks,
the rest of layers.py (and the CSPDarknet/PAFPN options that use it), the
v7 networks, the weight bridge's v7 leaves and the deploy folds.

JAX variables come from `jax.eval_shape` of init, filled from a numpy seed
(a real v7 init costs half a minute on the CPU), and the JAX side runs
under jit (one compile is cheaper than eager ops at a new shape)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.convert import flax_to_torch, fuse_repconv_params, reparameterize_v7
from vision_kit_tpu.models import YOLOV7 as JaxYOLOV7
from vision_kit_tpu.models import backbones as jb
from vision_kit_tpu.models import layers as jl
from vision_kit_tpu.models import necks as jn
from vision_kit_tpu_torch.convert import deploy_state_dict, state_dict_from_jax_variables
from vision_kit_tpu_torch.models import YOLOV7
from vision_kit_tpu_torch.models import backbones as tb
from vision_kit_tpu_torch.models import layers as tl
from vision_kit_tpu_torch.models import necks as tn
from test_torch_model import randomize_bn

torch.set_num_threads(2)


def fill_variables(shapes, seed=0):
    """Numpy variables for an eval_shape tree: conv kernels uniform
    +-1/sqrt(fan_in), biases N(0, 0.05), implicits N(mean, 0.1) (mean 1
    under an `im` module, else 0), BatchNorm randomized."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, k)
            elif k == "kernel":
                bound = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
                out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
            elif k == "implicit":
                mean = 1.0 if name.startswith("im") else 0.0
                out[k] = rng.normal(mean, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
        return out

    tree = walk(shapes, "")
    return randomize_bn(tree, rng) if "params" in tree else tree


def jax_variables(module, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return fill_variables(shapes, seed)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def block_pair(jax_block, torch_block, x, training_arg=True):
    """(JAX output, port output), NHWC numpy, of the same block on the same
    variables; a tuple output gives lists."""
    kw = {"training": False} if training_arg else {}
    v = jax_variables(jax_block, jnp.asarray(x), **kw)
    want = jax.jit(functools.partial(jax_block.apply, **kw))(v, jnp.asarray(x))
    torch_block.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    with torch.no_grad():
        got = torch_block.eval()(_nchw(x))
    if isinstance(got, tuple):
        return [np.asarray(w) for w in want], [_nhwc(g) for g in got]
    return np.asarray(want), _nhwc(got)


def feature(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def assert_close(want, got, tol=1e-5):
    if isinstance(want, list):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert_close(w, g, tol)
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- blocks ----------------------------------------------------------------

BLOCKS = {
    "conv_bn": (lambda: jl.ConvBn(12, 3, 2), lambda: tl.ConvBn(8, 12, 3, 2), 8),
    "conv_bn_groups": (lambda: jl.ConvBn(8, 3, 1, groups=4),
                       lambda: tl.ConvBn(8, 8, 3, 1, groups=4), 8),
    "repconv_identity": (lambda: jl.RepConv(8), lambda: tl.RepConv(8, 8), 8),
    "repconv_no_identity": (lambda: jl.RepConv(12), lambda: tl.RepConv(8, 12), 8),
    "repconv_stride2": (lambda: jl.RepConv(8, stride=2),
                        lambda: tl.RepConv(8, 8, stride=2), 8),
    "repconv_deploy": (lambda: jl.RepConv(12, deploy=True),
                       lambda: tl.RepConv(8, 12, deploy=True), 8),
    "sppcspc": (lambda: jl.SPPCSPC(16), lambda: tl.SPPCSPC(12, 16), 12),
    "mpx3conv": (lambda: jl.MPx3Conv(8), lambda: tl.MPx3Conv(12, 8), 12),
    "spp": (lambda: jl.SPP(16), lambda: tl.SPP(12, 16), 12),
    "focus": (lambda: jl.Focus(16, kernel=3), lambda: tl.Focus(4, 16, kernel=3), 4),
    "dwconv_module": (lambda: jl.DWConvModule(16, 3, 2),
                      lambda: tl.DWConvModule(8, 16, 3, 2), 8),
    "dwconv": (lambda: jl.DWConv(16, 3, 1), lambda: tl.DWConv(8, 16, 3, 1), 8),
    "bottleneck_depthwise": (lambda: jl.StandardBottleneck(8, depthwise=True),
                             lambda: tl.StandardBottleneck(8, 8, depthwise=True), 8),
    "c3_depthwise": (lambda: jl.C3Bottleneck(16, n=2, depthwise=True),
                     lambda: tl.C3Bottleneck(12, 16, n=2, depthwise=True), 12),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    make_jax, make_torch, ins = BLOCKS[name]
    want, got = block_pair(make_jax(), make_torch(), feature((2, 12, 12, ins)))
    assert_close(want, got)


@pytest.mark.parametrize("depth", [2, 4, 6])
@pytest.mark.parametrize("hidden", [8, 16])
def test_elan_matches_jax(depth, hidden):
    """hidden == outs (16) halves the 3x3 convs' width, and at depth 4
    concatenates all six branches."""
    want, got = block_pair(jl.ELAN(hidden, 16, depth=depth),
                           tl.ELAN(12, hidden, 16, depth=depth),
                           feature((2, 8, 8, 12)))
    assert_close(want, got)


@pytest.mark.parametrize("ops", ["add", "multiply"])
def test_implicit_matches_jax(ops):
    want, got = block_pair(jl.Implicit(8, ops), tl.Implicit(8, ops),
                           feature((2, 5, 5, 8)), training_arg=False)
    assert_close(want, got)


def test_focus_takes_uint8_like_the_stem():
    x = np.random.default_rng(2).integers(0, 255, (2, 16, 16, 3), dtype=np.uint8)
    want, got = block_pair(jl.Focus(16, kernel=3), tl.Focus(3, 16, kernel=3), x)
    assert_close(want, got)


@pytest.mark.parametrize("outs,k,s,p,po", [(8, 4, 2, 1, 0), (16, 3, 2, 1, 1),
                                           (8, 1, 1, 0, 0)])
def test_dwconv_transpose_matches_jax(outs, k, s, p, po):
    """torch's grouped transposed conv against the JAX input-dilated
    correlation with the flipped kernel; outs = 2 * ins reshapes the
    bridged (O, 1, k, k) weight on load."""
    want, got = block_pair(
        jl.DWConvTranspose2d(outs, kernel=k, stride=s, padding=p, padding_out=po),
        tl.DWConvTranspose2d(8, outs, k, s, p, po), feature((2, 7, 7, 8)),
        training_arg=False)
    assert_close(want, got)


@pytest.mark.parametrize("kind", ["mp", "sp3", "sp5_stride2"])
def test_pools_match_jax(kind):
    jax_block, torch_block = {
        "mp": (jl.MP(), tl.MP()),
        "sp3": (jl.SP(3, 1), tl.SP(3, 1)),
        "sp5_stride2": (jl.SP(5, 2), tl.SP(5, 2)),
    }[kind]
    want, got = block_pair(jax_block, torch_block, feature((2, 9, 9, 4)),
                           training_arg=False)
    assert_close(want, got, tol=0)


def test_concat_matches_jax():
    xs = [feature((2, 4, 4, c), seed=c) for c in (3, 5)]
    want = jl.Concat().apply({}, [jnp.asarray(x) for x in xs])
    got = tl.Concat()([_nchw(x) for x in xs])
    assert_close(np.asarray(want), _nhwc(got), tol=0)


@pytest.mark.parametrize("with_focus,depthwise", [(True, False), (False, True),
                                                  (True, True)])
def test_cspdarknet_options_match_jax(with_focus, depthwise):
    x = np.random.default_rng(4).integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    jm = jb.CSPDarknet(0.33, 0.25, with_focus=with_focus, depthwise=depthwise)
    tm = tb.CSPDarknet(0.33, 0.25, with_focus=with_focus, depthwise=depthwise)
    want, got = block_pair(jm, tm, x)
    assert_close(want, got)


def test_pafpn_depthwise_matches_jax():
    feats = [feature((1, n, n, c), seed=c) for n, c in ((8, 64), (4, 128), (2, 256))]
    jm = jn.PAFPN(0.33, 0.25, depthwise=True)
    tm = tn.PAFPN(0.33, 0.25, (64, 128, 256), depthwise=True)
    jfeats = tuple(jnp.asarray(f) for f in feats)
    v = jax_variables(jm, jfeats, training=False)
    want = jax.jit(functools.partial(jm.apply, training=False))(v, jfeats)
    tm.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(tuple(_nchw(f) for f in feats))
    assert_close([np.asarray(w) for w in want], [_nhwc(g) for g in got])


# -- whole v7 networks -----------------------------------------------------

def v7_shapes(variant, deploy=False, size=64):
    jm = JaxYOLOV7(variant=variant, num_classes=80, deploy=deploy)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, size, size, 3)),
                                          training=False))


@functools.cache
def v7_variables(variant="base"):
    return fill_variables(v7_shapes(variant), seed=1)


def port_v7(variant, variables, deploy=False, decode_order="native"):
    model = YOLOV7(variant, num_classes=80, deploy=deploy,
                   decode_order=decode_order)
    sd = state_dict_from_jax_variables(variables)
    if deploy:
        sd = deploy_state_dict(sd)
    model.load_state_dict(sd, strict=True)
    return model.eval().to(memory_format=torch.channels_last)


@pytest.mark.parametrize("decode_order", ["native", "reference"])
def test_v7_base_64_matches_jax(decode_order):
    v = v7_variables()
    jm = JaxYOLOV7(variant="base", num_classes=80, decode_order=decode_order)
    x = np.random.default_rng(7).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    jd, jr = jax.jit(functools.partial(jm.apply, training=False))(v, jnp.asarray(x))
    with torch.no_grad():
        td, tr = port_v7("base", v, decode_order=decode_order)(torch.from_numpy(x))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    assert len(tr) == len(jr) == 3
    for a, b in zip(jr, tr):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)
    # spread enough that the comparison is not between constants
    assert np.asarray(jr[0]).std() > 1e-3


@pytest.mark.parametrize("fold", ["fuse_repconv_params", "reparameterize_v7",
                                  "deploy_state_dict"])
@pytest.mark.parametrize("variant", ["base", "x"])
def test_folds_match_jax(variant, fold):
    """The port's folds on a port state_dict equal the JAX package's
    fuse_repconv_params and reparameterize_v7 on the same variables."""
    from vision_kit_tpu_torch import convert

    v = v7_variables(variant)
    jax_folds = {
        "fuse_repconv_params": fuse_repconv_params,
        "reparameterize_v7": reparameterize_v7,
        "deploy_state_dict": lambda v: reparameterize_v7(fuse_repconv_params(v)),
    }
    want = flax_to_torch(jax.device_get(jax_folds[fold](v)))
    got = getattr(convert, fold)(state_dict_from_jax_variables(v))
    assert set(got) == set(want)
    n_reparam = sum(k.endswith("rbr_reparam.weight") for k in got)
    assert n_reparam == (3 if variant == "base" and fold != "reparameterize_v7" else 0)
    assert any(".ia." in k for k in got) == (fold == "fuse_repconv_params")
    for key, arr in want.items():
        np.testing.assert_allclose(got[key].numpy(), arr, rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_deploy_model_matches_training_model():
    v = v7_variables()
    x = torch.from_numpy(np.random.default_rng(8).integers(
        0, 255, (2, 64, 64, 3), dtype=np.uint8))
    with torch.no_grad():
        want, want_raws = port_v7("base", v)(x)
        got, got_raws = port_v7("base", v, deploy=True)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)
    for w, g in zip(want_raws, got_raws):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3, atol=2e-3)


def test_deploy_state_dict_leaves_v5_alone():
    from vision_kit_tpu_torch.models import YOLOV5

    sd = YOLOV5("n").state_dict()
    out = deploy_state_dict(sd)
    assert out.keys() == sd.keys()
    assert all(out[k] is sd[k] for k in sd)


@pytest.mark.parametrize("deploy", [False, True])
@pytest.mark.parametrize("variant", ["base", "x"])
def test_v7_variants_build(variant, deploy):
    """build_model's parameter tree equals the JAX one, key and shape (JAX
    side by shape only, no compile)."""
    import os

    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.utils.config import load_config

    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                   v7_shapes(variant, deploy))
    want = {k: tuple(np.shape(a)) for k, a in flax_to_torch(zeros).items()}
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs/yolov7.yaml"))
    cfg.model.version, cfg.model.deploy = variant, deploy
    model = build_model(cfg, device="cpu")
    assert {k: tuple(t.shape) for k, t in model.state_dict().items()} == want
    assert ("neck.pan_conv0.rbr_reparam.weight" in want) == (deploy and variant == "base")


def test_raw_maps_are_channels_last_views_in_both_structures():
    """The head's raw maps are NHWC views of the conv output, with no copy,
    also after the implicit multiply: what head_scores' kernel demands."""
    for deploy in (False, True):
        model = YOLOV7("base", deploy=deploy).eval().to(memory_format=torch.channels_last)
        f = torch.zeros(1, 256, 4, 4).to(memory_format=torch.channels_last)
        with torch.no_grad():
            y = model.head.level_map(0, f)
            raws = model.head([f, torch.zeros(1, 512, 2, 2).to(
                memory_format=torch.channels_last), torch.zeros(1, 1024, 1, 1)],
                decode=False)
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert raws[0].is_contiguous() and raws[0]._base is not None
