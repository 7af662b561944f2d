"""Port (vision_kit_tpu_torch) vs JAX package on the CPU: the optimizer
(parameter groups, schedules, SGD update, clipping), the EMA, the
BatchNorm running statistics of a training forward, and the training step
on v5n@64, B=2, for 3 steps from one carried TrainState, and the eval
step on a state's EMA weights.

Both sides start from the same numpy state: the JAX TrainState goes
across through convert.load_jax_train_state, and after each step every
part of both states is compared under the port's names
(convert.train_state_tensors_from_jax). The JAX step runs under jit. The
steps train test_torch_model's jax_v5 weights; the eval comparison uses
test_torch_eval's spread_v5n, whose scores lie apart, so that it does not
turn on near-ties (its head, scaled for eval, makes a training step blow
the losses up)."""

import functools

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from vision_kit_tpu.train import ema as jax_ema
from vision_kit_tpu.train import optim as jax_optim
from vision_kit_tpu.train.losses import YoloLoss as JaxYoloLoss
from vision_kit_tpu.train.step import create_train_state as jax_create_train_state
from vision_kit_tpu.train.step import make_eval_step as jax_make_eval_step
from vision_kit_tpu.train.step import make_train_step as jax_make_train_step
from vision_kit_tpu_torch.convert import (
    load_jax_train_state,
    state_dict_from_jax_variables,
    train_state_tensors_from_jax,
)
from vision_kit_tpu_torch.models import layers as tl
from vision_kit_tpu_torch.train import ema, optim
from vision_kit_tpu_torch.train.losses import YoloLoss
from vision_kit_tpu_torch.train.step import make_eval_step, make_train_step
from vision_kit_tpu_torch.utils.stream_bench import (
    STATE_PARTS,
    TRAIN_HYP,
    bench_targets,
    state_disagreements,
    train_state_tensors,
)
from test_torch_eval import spread_v5n
from test_torch_model import jax_v5, port_v5
from test_torch_nms import assert_same_detections

torch.set_num_threads(2)

EPOCHS, STEPS_PER_EPOCH = 3, 10    # warmup nw = 100 steps; lr from step 1

# Tolerances of a step's results, f32 on the CPU. The two forwards in
# training mode agree to ~3e-5 of a raw map's largest value, each as far
# from an f64 forward as the other (rounding, grown through 25 batch norms
# of a batch of 2); backpropagated, the gradients agree to ~7e-4 of each
# tensor's largest element. So each state tensor is held to 1e-4 of its
# largest magnitude plus STEP_REL of the largest change the JAX step made
# to it; the losses to 1e-4 relative, the gradient norm to 1e-3. The
# carried state before the first step is equal.
METRIC_RTOL = {"loss": 1e-4, "loss_box": 1e-4, "loss_obj": 1e-4, "loss_cls": 1e-4,
               "grad_norm": 1e-3}
VALUE_REL, STEP_REL = 1e-4, 2e-3


# -- optimizer and EMA -------------------------------------------------------

class Tiny(nn.Module):
    """A conv with a bias, a BatchNorm and an Implicit: every group."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 4, 3, bias=True)
        self.bn = tl.BatchNorm2d(4)
        self.imp = tl.Implicit(4)


def tiny_params(rng):
    return {"conv": {"kernel": rng.normal(0, 1, (3, 3, 2, 4)).astype(np.float32),
                     "bias": rng.normal(0, 1, 4).astype(np.float32)},
            "bn": {"scale": rng.normal(1, 0.1, 4).astype(np.float32),
                   "bias": rng.normal(0, 1, 4).astype(np.float32)},
            "imp": {"implicit": rng.normal(0, 1, (1, 1, 1, 4)).astype(np.float32)}}


def torch_named(tree):
    """A JAX param tree (numpy leaves) under the port's parameter names."""
    sd = state_dict_from_jax_variables({"params": tree})
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def test_label_params_match_jax():
    _, v = spread_v5n()
    code = {"weight": 0.0, "norm": 1.0, "bias": 2.0}
    coded = jax.tree_util.tree_map(lambda label, a: np.full(np.shape(a), code[label],
                                                            np.float32),
                                   jax_optim.label_params(v["params"]), v["params"])
    want = {k: int(t.reshape(-1)[0]) for k, t in torch_named(coded).items()}
    got = optim.label_params(port_v5("n", v))
    assert got == {k: ["weight", "norm", "bias"][c] for k, c in want.items()}
    assert sorted(set(got.values())) == ["bias", "norm", "weight"]
    assert optim.label_params(Tiny()) == {"conv.weight": "weight", "conv.bias": "bias",
                                          "bn.weight": "norm", "bn.bias": "bias",
                                          "imp.implicit": "norm"}


@pytest.mark.parametrize("cosine", [False, True])
def test_lr_schedules_match_jax(cosine):
    """At the warmup's ends (step 0, nw - 1, nw, nw + 1) and later, to
    1e-6 relative (the JAX schedule computes in f32)."""
    for spe in (10, 100):
        nw = max(3 * spe, 100)
        want = jax_optim.lr_schedules(TRAIN_HYP, 30, spe, cosine)
        got = optim.lr_schedules(TRAIN_HYP, 30, spe, cosine)
        for step in (0, 1, nw - 1, nw, nw + 1, 7 * spe + 3, 30 * spe):
            for w, g in zip(want, got):
                assert g(step) == pytest.approx(float(w(jnp.int32(step))), rel=1e-6,
                                                abs=1e-9), (spe, step)


def test_sgd_update_and_clipping_match_jax():
    """Four updates of make_optimizer on the three groups, through the
    warmup, with gradients above and below the clip norm: parameters and
    momentum to 1e-6."""
    rng = np.random.default_rng(0)
    params = tiny_params(rng)
    hyp = dict(TRAIN_HYP, warmup_bias_lr=0.05)
    jtx = jax_optim.make_optimizer(params, hyp, EPOCHS, STEPS_PER_EPOCH)
    jstate, jparams = jtx.init(params), params
    model = Tiny()
    tparams = dict(model.named_parameters())
    with torch.no_grad():
        for k, t in torch_named(params).items():
            tparams[k].copy_(t)
    ttx = optim.make_optimizer(model, hyp, EPOCHS, STEPS_PER_EPOCH)
    tstate = ttx.init(tparams)
    for scale in (30.0, 0.5, 12.0, 2.0):      # global norms above and below 10
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(0, 1, a.shape) * scale).astype(np.float32), params)
        updates, jstate = jtx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        with torch.no_grad():
            tstate = ttx.update(torch_named(grads), tstate, tparams)
        for k, want in torch_named(jax.device_get(jparams)).items():
            np.testing.assert_allclose(tparams[k].detach().numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        jbuf = torch_named(jax.device_get(jstate[1].momentum_buf))
        for k, want in jbuf.items():
            np.testing.assert_allclose(optim.sgd_state(tstate).momentum_buf[k].numpy(),
                                       want.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    assert optim.sgd_state(tstate).step == 4


def test_clip_keeps_small_gradients_exact():
    g = {"a": torch.tensor([3.0, 4.0])}                 # norm 5
    optim.clip_by_global_norm(5.0).update(g, None)
    assert torch.equal(g["a"], torch.tensor([3.0, 4.0]) * (5.0 / 5.0))
    optim.clip_by_global_norm(10.0).update(g, None)
    assert torch.equal(g["a"], torch.tensor([3.0, 4.0]))
    optim.clip_by_global_norm(1.0).update(g, None)
    torch.testing.assert_close(g["a"], torch.tensor([0.6, 0.8]))


def test_ema_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32)}
    jstate = jax_ema.ema_init(tree)
    tstate = ema.ema_init({"w": torch.from_numpy(tree["w"])})
    for _ in range(5):
        new = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32)}
        jstate = jax_ema.ema_update(jstate, new)
        tstate = ema.ema_update(tstate, {"w": torch.from_numpy(new["w"])})
    assert tstate.updates == int(jstate.updates) == 5
    np.testing.assert_allclose(tstate.tree["w"].numpy(), np.asarray(jstate.tree["w"]),
                               rtol=1e-6, atol=1e-7)


# -- BatchNorm statistics ----------------------------------------------------

def test_bn_running_stats_follow_flax(monkeypatch):
    """One training forward of v5n@64, B=2: every running statistic equals
    Flax's to 1e-5 relative. Torch's own update (the unbiased variance)
    misses it at the 2x2 levels, where n = 8: the subclass is needed."""
    jm, v = spread_v5n()
    x = np.random.default_rng(2).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    _, mutated = jm.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
    want = {k: v for k, v in state_dict_from_jax_variables(
        {"batch_stats": jax.device_get(mutated["batch_stats"])}).items()
        if k.endswith(("running_mean", "running_var"))}

    def stats_after_forward():
        model = port_v5("n", v).train()
        with torch.no_grad():
            model(torch.from_numpy(x), decode=False)
        return {k: b for k, b in model.named_buffers() if k in want}

    got = stats_after_forward()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    monkeypatch.setattr(tl.BatchNorm2d, "forward", nn.BatchNorm2d.forward)
    unbiased = stats_after_forward()
    worst = max(float(((unbiased[k] - want[k]).abs() / want[k].abs()).max())
                for k in want if k.endswith("running_var"))
    assert worst > 1e-3


def test_bn_subclass_eval_is_batchnorm2d():
    bn = tl.BatchNorm2d(6, eps=1e-3, momentum=0.03)
    ref = nn.BatchNorm2d(6, eps=1e-3, momentum=0.03)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for mod in (bn, ref):
            mod.weight.copy_(torch.from_numpy(rng.normal(1, 0.1, 6).astype(np.float32)))
        ref.load_state_dict(bn.state_dict())
    x = torch.from_numpy(rng.normal(0, 2, (2, 6, 5, 5)).astype(np.float32))
    assert torch.equal(bn.eval()(x), ref.eval()(x))


# -- the training step ---------------------------------------------------------

def step_batches(n, size=64, batch=2, seed=5):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8),
             "targets": bench_targets(rng, batch)[:, :8]} for _ in range(n)]


def compare_states(jstate, pstate, prev=None, step_rel=STEP_REL):
    """Every part of the two states under the port's names; prev: the JAX
    state's parts before the step (None: require equality). Returns the
    JAX state's parts."""
    want = train_state_tensors_from_jax(jax.device_get(jstate))
    assert pstate.step == want["step"] and pstate.ema.updates == want["ema_updates"]
    assert optim.sgd_state(pstate.opt_state).step == want["opt_step"]
    want = {part: want[part] for part in STATE_PARTS}
    got = train_state_tensors(pstate)
    if prev is None:
        assert state_disagreements(want, got, want, 0.0, 0.0) == []
    else:
        assert state_disagreements(want, got, prev, VALUE_REL, step_rel) == []
    return want


def compare_metrics(jm_, pm_):
    for k, rtol in METRIC_RTOL.items():
        np.testing.assert_allclose(float(pm_[k]), float(jm_[k]), rtol=rtol, err_msg=k)


@functools.cache
def train_v5n():
    return jax_v5("n", 64)


def v5n_pair():
    """(JAX module, numpy variables, port model) of the v5n steps, and the
    loss classes' extra arguments."""
    jm, v = train_v5n()
    return jm, v, port_v5("n", v), {}


def run_pair(n_steps, batches, pair=v5n_pair, jax_loss=JaxYoloLoss, port_loss=YoloLoss,
             cosine=False, step_rel=STEP_REL, **step_kw):
    """Both frameworks' steps from one state; each step's metrics and the
    whole state after it compared. Returns (JAX state, port state, JAX
    module, port model)."""
    jm, v, model, loss_kw = pair()
    jtx = jax_optim.make_optimizer(v["params"], TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH,
                                   cosine=cosine)
    jstate = jax_create_train_state(v, jtx)
    jstep = jax_make_train_step(jm, jax_loss(80, jm.grid_anchors, TRAIN_HYP, **loss_kw),
                                jtx, donate=False, **step_kw)
    ptx = optim.make_optimizer(model, TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH, cosine=cosine)
    pstate = load_jax_train_state(model, ptx, jax.device_get(jstate))
    prev = compare_states(jstate, pstate)
    pstep = make_train_step(model, port_loss(80, model.head.grid_anchors, TRAIN_HYP,
                                             **loss_kw), ptx, **step_kw)
    for batch in batches[:n_steps]:
        jstate, jmetrics = jstep(jstate, batch)
        pstate, pmetrics = pstep(pstate, batch)
        compare_metrics(jmetrics, pmetrics)
        prev = compare_states(jstate, pstate, prev, step_rel)
    return jstate, pstate, jm, model


@functools.cache
def plain_run():
    return run_pair(3, step_batches(3))


def test_train_step_matches_jax():
    """Three plain steps (uint8 images, clipping active: the gradient norm
    is above 10): loss and its parts, grad norm, and after each step every
    parameter, BatchNorm statistic, momentum buffer and EMA tensor."""
    jstate, pstate, _, _ = plain_run()
    assert pstate.step == 3


def test_eval_step_on_ema_matches_jax():
    """make_eval_step with a TrainState evaluates its EMA weights (the
    default) or its own, as JAX's does: 2 frames at the eval protocol but
    for max_cand 512. The state's EMA tree is its weights with the head
    kernels 1.2 times as large, so the two evaluations differ."""
    jm, v = spread_v5n()
    ema_tree = jax.tree_util.tree_map(np.array, v)
    for i in range(3):
        ema_tree["params"]["head"][f"m_{i}"]["kernel"] *= np.float32(1.2)
    jtx = jax_optim.make_optimizer(v["params"], TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    jstate = jax_create_train_state(v, jtx)
    jstate = jstate._replace(ema=jax_ema.EMAState(updates=jnp.int32(7), tree=ema_tree))
    model = port_v5("n", v)
    pstate = load_jax_train_state(model, optim.make_optimizer(
        model, TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH), jax.device_get(jstate))
    assert pstate.ema.updates == 7
    post = {"max_cand": 512}
    x = np.random.default_rng(9).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    got = {}
    for use_ema in (True, False):
        jd, jv = jax_make_eval_step(jm, use_ema=use_ema, postprocess_kwargs=post)(
            jstate, jnp.asarray(x))
        td, tv = make_eval_step(model, post, state=pstate, use_ema=use_ema)(x)
        jd, jv = np.asarray(jd), np.asarray(jv)
        for i in range(2):
            assert jv[i].sum() > 10
            assert_same_detections(jd[i][jv[i]], td[i][tv[i]].numpy())
        got[use_ema] = td[tv].numpy()
    assert got[True].shape != got[False].shape or not np.allclose(got[True], got[False])
    # without a state the step evaluates the model's own weights
    td, tv = make_eval_step(model, post)(x)
    np.testing.assert_array_equal(td[tv].numpy(), got[False])


def test_train_step_rejects_a_mesh():
    _, v = spread_v5n()
    model = port_v5("n", v)
    tx = optim.make_optimizer(model, TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    loss = YoloLoss(80, model.head.grid_anchors, TRAIN_HYP)
    # the mesh is ported (tests/test_torch_distributed.py,
    # tests/test_torch_spatial.py); it is a parallel.mesh.Mesh, and spatial
    # partitioning needs one, as in JAX
    with pytest.raises(TypeError):
        make_train_step(model, loss, tx, mesh=object())
    with pytest.raises(ValueError, match="requires a mesh"):
        make_train_step(model, loss, tx, spatial=True)
