"""Exponential moving average of the model's state.

Counterpart of vision_kit_tpu/train/ema.py:

    decay(t) = base_decay * (1 - exp(-t / 2000))
    ema      = decay * ema + (1 - decay) * value

over the parameters and the BatchNorm running statistics, in f32. The EMA
owns its tensors (clones); integer buffers such as num_batches_tracked are
not averaged, as the JAX tree has none. Evaluating with the EMA is applying
the model with these tensors in place of its own
(train/step.py:make_eval_step).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch


class EMAState(NamedTuple):
    updates: int                     # host-side update count
    tree: dict[str, torch.Tensor]    # averaged params and running statistics


def ema_init(tree: Mapping[str, torch.Tensor]) -> EMAState:
    return EMAState(updates=0, tree={k: v.detach().clone()
                                     for k, v in tree.items()})


def ema_update(state: EMAState, tree: Mapping[str, torch.Tensor],
               base_decay: float = 0.9999) -> EMAState:
    """One update, in place on state.tree."""
    updates = state.updates + 1
    d = base_decay * (1.0 - math.exp(-updates / 2000.0))
    ema = list(state.tree.values())
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, [tree[k].detach() for k in state.tree], alpha=1.0 - d)
    return EMAState(updates=updates, tree=state.tree)
