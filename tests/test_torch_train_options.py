"""Port (vision_kit_tpu_torch) vs JAX package on the CPU: the training
step's options, each for 3 steps from one carried TrainState on v5n@64,
with test_torch_train's comparison of the metrics and of every part of the
state after each step: gradient accumulation, activation checkpointing,
multi-scale resize and device augmentation. Then YOLOv7 base in the
training structure with the SimOTA loss, port only (a JAX v7 step compiles
for minutes on this CPU; tests/test_torch_loss.py holds the OTA loss,
assignment and gradient against JAX's): its steps descend."""

import numpy as np
import torch

from vision_kit_tpu_torch.models import build_model
from vision_kit_tpu_torch.train import optim
from vision_kit_tpu_torch.train.losses import YoloLoss
from vision_kit_tpu_torch.train.ota import YoloLossOTA
from vision_kit_tpu_torch.train.step import create_train_state, make_train_step
from vision_kit_tpu_torch.utils.config import load_config
from vision_kit_tpu_torch.utils.stream_bench import TRAIN_HYP, daug_batch
from test_torch_model import REPO, port_v5
from test_torch_train import EPOCHS, STEPS_PER_EPOCH, run_pair, step_batches, train_v5n

torch.set_num_threads(2)


def test_accumulation_matches_jax():
    """accum_steps=2 on batches of 4: two microbatches of 2 in turn, the
    mean gradient, the statistics updated after each microbatch."""
    _, pstate, _, _ = run_pair(3, step_batches(3, batch=4), accum_steps=2)
    assert pstate.step == 3


def test_remat_matches_jax():
    run_pair(3, step_batches(3), remat=True)


def test_remat_updates_statistics_once():
    """The recompute leaves the running statistics alone: after each of 3
    steps they equal the plain step's exactly, and so do the parameters."""
    _, v = train_v5n()
    states, steps = [], []
    for remat in (False, True):
        model = port_v5("n", v)
        tx = optim.make_optimizer(model, TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH)
        loss = YoloLoss(80, model.head.grid_anchors, TRAIN_HYP)
        states.append(create_train_state(model, tx))
        steps.append(make_train_step(model, loss, tx, remat=remat))
    for batch in step_batches(3):
        states = [step(s, batch)[0] for step, s in zip(steps, states)]
        plain, remat = states
        for k, t in plain.batch_stats.items():
            assert torch.equal(remat.batch_stats[k], t), k
        for k, t in plain.params.items():
            assert torch.equal(remat.params[k], t), k


def test_scale_to_matches_jax():
    """96x96 uint8 batches resized on the device to 64 (a downscale, so the
    antialiased bilinear of jax.image.resize)."""
    run_pair(3, step_batches(3, size=96), scale_to=64)


def test_device_aug_matches_jax():
    """tools/bench_train.py's daug regime at 64 px: mosaic, fractional
    affine, mixup and HSV on the device at the head of the step."""
    rng = np.random.default_rng(12)
    batches = [daug_batch(rng, 2, 64) for _ in range(3)]
    run_pair(3, batches, device_aug=True)


def test_v7_ota_step_descends():
    """v7 base, training structure, SimOTA, 64 px, B=2, 6 steps on one
    batch: finite, and the loss of the last below the first's."""
    cfg = load_config(f"{REPO}/configs/yolov7.yaml")
    cfg.model.num_classes, cfg.model.deploy = 80, False
    model = build_model(cfg, device="cpu", seed=0)
    tx = optim.make_optimizer(model, TRAIN_HYP, EPOCHS, STEPS_PER_EPOCH, cosine=True)
    loss = YoloLossOTA(80, model.head.grid_anchors, TRAIN_HYP, strides=model.strides)
    state = create_train_state(model, tx)
    step = make_train_step(model, loss, tx)
    batch = step_batches(1)[0]
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch)
        assert all(torch.isfinite(m) for m in metrics.values())
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert float(metrics["loss_box"]) > 0
