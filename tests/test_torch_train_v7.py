"""Port (vision_kit_tpu_torch) vs JAX package on the CPU: YOLOv7 base in
the training structure with the SimOTA loss (configs/yolov7.yaml's
loss_ota: 1), 2 steps at 64 px, B=2, from one carried TrainState, with
test_torch_train's comparison of the metrics and of every part of the
state after each step, and the cosine schedule. The v7 network is deeper
than v5n: its gradients agree to ~2e-3 of each tensor's largest element,
so a step's change is held to 5e-3 (test_torch_train's STEP_REL is 2e-3).

The JAX variables are test_torch_v7's numpy-filled eval_shape tree (a real
v7 init costs half a minute here); the JAX step's one compile takes ~30 s
of this file's ~45 s."""

import torch

from vision_kit_tpu.models import YOLOV7 as JaxYOLOV7
from vision_kit_tpu.train.ota import YoloLossOTA as JaxYoloLossOTA
from vision_kit_tpu_torch.train.ota import YoloLossOTA
from test_torch_train import run_pair, step_batches
from test_torch_v7 import port_v7, v7_variables

torch.set_num_threads(2)


def v7_pair():
    v = v7_variables()
    return (JaxYOLOV7("base", num_classes=80), v, port_v7("base", v),
            {"strides": (8.0, 16.0, 32.0)})


def test_v7_ota_train_step_matches_jax():
    _, pstate, _, _ = run_pair(2, step_batches(2), pair=v7_pair,
                               jax_loss=JaxYoloLossOTA, port_loss=YoloLossOTA,
                               cosine=True, step_rel=5e-3)
    assert pstate.step == 2
