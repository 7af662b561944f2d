"""bf16 against JAX on the CPU: one training step of v5n@64 (the port's
torch.autocast over f32 parameters against JAX's step with a bf16 model),
and the EMA eval in the compute dtype (make_eval_step(compute_dtype=bf16)
against JAX's eval step on a bf16 model).

bf16 keeps 8 bits of mantissa, and the two frameworks round at other
places (autocast rounds each conv's output; a bf16 Flax model rounds every
activation). Gradients taken through ~60 batch norms of a batch of 2 are
then noise-level in bf16: JAX's own bf16 step differs from its f32 step by
~60 % of a tensor's largest gradient element (median over tensors). So
each bf16 result is held to the bf16 rounding spread, measured in the test
as the distance of JAX's bf16 result from its f32 result on the same
input: the port's bf16 result must lie within SPREAD times that distance of
JAX's bf16 result, plus a small share of the value. Two independent bf16
roundings of one f32 computation lie about sqrt(2) times that distance
apart, with a tail: the largest ratio seen over the ~350 state tensors is
2.8."""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.convert import torch_to_flax
from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
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
from vision_kit_tpu_torch.models import build_model
from vision_kit_tpu_torch.ops.nms import postprocess
from vision_kit_tpu_torch.train import optim
from vision_kit_tpu_torch.train.losses import YoloLoss
from vision_kit_tpu_torch.train.step import EVAL_POSTPROCESS, make_eval_step, make_train_step
from vision_kit_tpu_torch.utils.config import load_config
from vision_kit_tpu_torch.utils.stream_bench import (
    STATE_PARTS,
    TRAIN_HYP,
    state_disagreements,
    train_state_tensors,
)
from test_torch_eval import spread_v5n
from test_torch_model import REPO, port_v5
from test_torch_train import EPOCHS, STEPS_PER_EPOCH, step_batches

torch.set_num_threads(2)

SPREAD = 4.0        # times JAX's own bf16-vs-f32 distance
VALUE_REL = 1e-3    # plus this share of the tensor's largest magnitude
METRIC_REL = 1e-2   # a metric: plus this share of its value


def seeded_v5n_variables():
    """The port's seeded v5n@64 init (the state a training run starts
    from) as Flax variables."""
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes, cfg.model.input_size = "n", 80, [64, 64]
    sd = build_model(cfg, device="cpu", seed=0).state_dict()
    return jax.tree_util.tree_map(np.array, torch_to_flax(sd))


def test_bf16_train_step_matches_jax():
    """One step of v5n@64, B=2, from one carried state: the port with
    compute_dtype=bf16 against JAX's step with a bf16 model. Each metric
    within METRIC_REL of JAX's bf16 value plus SPREAD times JAX's
    bf16-vs-f32 distance; each state tensor (state_disagreements, whose
    `before` is here JAX's f32 result) within VALUE_REL of its magnitude
    plus SPREAD times JAX's bf16-vs-f32 distance of it."""
    v = seeded_v5n_variables()
    jtx = jax_optim.make_optimizer(v["params"], TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    jstate = jax_create_train_state(v, jtx)
    batch = step_batches(1)[0]
    states, metrics = {}, {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm = JaxYOLOV5(variant="n", num_classes=80, dtype=dtype)
        step = jax_make_train_step(jm, JaxYoloLoss(80, jm.grid_anchors, TRAIN_HYP),
                                   jtx, donate=False)
        out, m = step(jstate, batch)
        parts = train_state_tensors_from_jax(jax.device_get(out))
        states[name] = {p: parts[p] for p in STATE_PARTS}
        metrics[name] = {k: float(x) for k, x in m.items()}

    model = port_v5("n", v)
    ptx = optim.make_optimizer(model, TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
    pstate = load_jax_train_state(model, ptx, jax.device_get(jstate))
    pstep = make_train_step(model, YoloLoss(80, model.head.grid_anchors, TRAIN_HYP),
                            ptx, compute_dtype=torch.bfloat16)
    pstate, pmetrics = pstep(pstate, batch)
    assert pstate.step == 1

    for k, want in metrics["bf16"].items():
        spread = abs(want - metrics["f32"][k])
        got = float(pmetrics[k])
        assert abs(got - want) <= METRIC_REL * abs(want) + SPREAD * spread, (k, got, want)
    bad = state_disagreements(states["bf16"], train_state_tensors(pstate),
                              states["f32"], VALUE_REL, SPREAD)
    assert bad == [], bad[:5]


def test_bf16_ema_eval_matches_jax():
    """make_eval_step(state=..., compute_dtype=bf16) applies the f32 EMA
    tree through a bf16 forward, as JAX's Trainer evaluates its bf16
    model. v5n@64, 2 frames, the eval protocol but for max_cand 512; the
    state's EMA tree is its weights with the head kernels 1.2 times as
    large, so it differs from the model's own.

    The step equals the eval protocol on the autocast forward of the EMA
    tree exactly, and differs from the f32 eval. Against JAX: the decoded
    outputs of the bf16 forwards (boxes, then probabilities) within 2
    times JAX's own bf16-vs-f32 distance. bf16 rounding moves NMS
    decisions (JAX's own bf16 eval finds 96-98 % of its f32 eval's
    detections and the other way round), so the detections are held as
    shares: of either side's detections with score >= 0.5, the other holds
    (class exact, score 0.03, box 3 px of a 64-px frame: found_share) at
    least 0.9, and at least the share that JAX's bf16 and f32 evals find of
    each other less 0.02."""
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
    post = {"max_cand": 512}
    x = np.random.default_rng(9).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)

    td, tv = make_eval_step(model, post, state=pstate, compute_dtype=torch.bfloat16)(x)
    td32, tv32 = make_eval_step(model, post, state=pstate)(x)
    assert not torch.equal(td, td32)
    tree = {k: t.float() for k, t in pstate.ema.tree.items()}
    with torch.inference_mode(), torch.autocast("cpu", dtype=torch.bfloat16):
        decoded, raws = torch.func.functional_call(model, tree, (torch.from_numpy(x),),
                                                   strict=False)
    assert all(r.dtype == torch.bfloat16 for r in raws)
    wd, wv = postprocess(decoded, **{**EVAL_POSTPROCESS, **post})
    assert torch.equal(td, wd) and torch.equal(tv, wv)

    jdec, jdets = {}, {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jmx = JaxYOLOV5(variant="n", num_classes=80, dtype=dtype)
        apply = jax.jit(lambda t, im, m=jmx: m.apply(t, im, training=False)[0])
        jdec[name] = np.asarray(apply(ema_tree, jnp.asarray(x)), np.float32)
        jd, jv = jax_make_eval_step(jmx, postprocess_kwargs=post)(jstate, jnp.asarray(x))
        jd, jv = np.asarray(jd), np.asarray(jv)
        jdets[name] = [jd[i][jv[i]] for i in range(2)]
    got = decoded.float().numpy()
    for cols in (slice(0, 4), slice(4, None)):
        err = np.abs(got[..., cols] - jdec["bf16"][..., cols]).max()
        spread = np.abs(jdec["bf16"][..., cols] - jdec["f32"][..., cols]).max()
        assert err <= 2 * spread, (cols, err, spread)

    port = [td[i][tv[i]].numpy() for i in range(2)]
    for i in range(2):
        assert (jdets["bf16"][i][:, 4] >= 0.5).sum() > 5
        spread = min(found_share(jdets["bf16"][i], jdets["f32"][i]),
                     found_share(jdets["f32"][i], jdets["bf16"][i]))
        for a, b in ((jdets["bf16"][i], port[i]), (port[i], jdets["bf16"][i])):
            share = found_share(a, b)
            assert share >= max(0.9, spread - 0.02), (i, share, spread)


def found_share(dets, others, score_tol=0.03, box_tol=3.0):
    """The share of `dets` with score >= 0.5 that `others` holds within the
    bf16 tolerance: the same class, the score within score_tol and every
    box coordinate within box_tol px."""
    rows = dets[dets[:, 4] >= 0.5]
    found = [bool(((others[:, 5] == r[5]) & (np.abs(others[:, 4] - r[4]) <= score_tol)
                   & (np.abs(others[:, :4] - r[:4]).max(axis=1) <= box_tol)).any())
             for r in rows]
    return float(np.mean(found))
