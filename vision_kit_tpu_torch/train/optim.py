"""Optimizer: three-group Nesterov SGD with warmup and decay schedules, as
plain functions over tensor lists with the state explicit.

Counterpart of vision_kit_tpu/train/optim.py:
  * group "bias":   every bias (conv, head, BatchNorm shift): no weight
                    decay, lr warms from warmup_bias_lr down to the schedule;
  * group "norm":   BatchNorm weights and Implicit layers: no weight decay;
  * group "weight": conv kernels: weight decay;
  * momentum warms from warmup_momentum to momentum over the warmup steps;
  * after warmup the lr follows a linear (v5) or cosine (v7) decay.

The schedules are read from the step count, which the state keeps on the
host, so the per-step lr and momentum are Python floats and no step waits
for the device. Updates run in place through torch._foreach_* over each
group's tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple

import torch
from torch import nn

from vision_kit_tpu_torch.models.layers import Implicit

GROUPS = ("weight", "norm", "bias")


def label_params(model: nn.Module) -> dict[str, str]:
    """{parameter name: "bias" | "norm" | "weight"} by module type: torch
    names a conv kernel and a BatchNorm scale both `weight`."""
    labels = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{name}" if mod_name else name
            if name == "bias":
                labels[key] = "bias"
            elif isinstance(mod, (nn.BatchNorm2d, Implicit)):
                labels[key] = "norm"
            else:
                labels[key] = "weight"
    return labels


def lr_schedules(hyp: dict, max_epochs: int, steps_per_epoch: int,
                 cosine: bool = False) -> tuple[Callable, Callable, Callable]:
    """(lr_weight(step), lr_bias(step), momentum(step)).

    Warmup length nw = max(warmup_epochs * steps_per_epoch, 100). During
    warmup the lr interpolates 0 -> schedule (bias: warmup_bias_lr ->
    schedule) and the momentum warmup_momentum -> momentum."""
    lr0 = float(hyp["lr0"])
    lrf = float(hyp["lrf"])
    mom = float(hyp.get("momentum", 0.937))
    wmom = float(hyp.get("warmup_momentum", 0.8))
    wbias = float(hyp.get("warmup_bias_lr", 0.1))
    nw = max(int(float(hyp.get("warmup_epochs", 3.0)) * steps_per_epoch), 100)

    def epoch_factor(step):
        e = step / steps_per_epoch
        if cosine:
            return ((1 - math.cos(e * math.pi / max_epochs)) / 2) * (lrf - 1) + 1
        return (1 - e / max_epochs) * (1.0 - lrf) + lrf

    def frac(step):
        return min(max(step / nw, 0.0), 1.0)

    def lr_weight(step):
        target = lr0 * epoch_factor(step)
        return frac(step) * target if step < nw else target

    def lr_bias(step):
        target = lr0 * epoch_factor(step)
        return wbias + frac(step) * (target - wbias) if step < nw else target

    def momentum(step):
        return wmom + frac(step) * (mom - wmom) if step < nw else mom

    return lr_weight, lr_bias, momentum


class SGDState(NamedTuple):
    step: int                              # host-side count of updates
    momentum_buf: dict[str, torch.Tensor]  # by parameter name


class GradientTransformation(NamedTuple):
    """init(params) -> state; update(grads, state, params, g_norm=None) ->
    state', which applies the update to `params` (and `grads`) in place.
    g_norm: the gradients' global norm where the caller has computed it
    (train/step.py reports it), else None."""
    init: Callable
    update: Callable


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    tensors = list(tensors)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale the gradients by max_norm / g_norm where g_norm >= max_norm,
    optax's rule (no epsilon on the norm, so not
    torch.nn.utils.clip_grad_norm_), without a host sync."""

    def update(grads: Mapping[str, torch.Tensor], state, params=None, g_norm=None):
        g = list(grads.values())
        if g_norm is None:
            g_norm = global_norm(g)
        scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
        torch._foreach_mul_(g, scale)
        return state

    return GradientTransformation(lambda params: None, update)


def yolo_sgd(model: nn.Module, hyp: dict, max_epochs: int,
             steps_per_epoch: int, cosine: bool = False) -> GradientTransformation:
    """Nesterov SGD with grouped lr and decay and the warmup read from the
    step count, torch.optim.SGD(nesterov=True)'s update:
      g' = g (+ wd * p in the weight group); buf = mu * buf + g'
      p -= lr * (g' + mu * buf)."""
    labels = label_params(model)
    lr_w, lr_b, mom_fn = lr_schedules(hyp, max_epochs, steps_per_epoch, cosine)
    wd = float(hyp.get("weight_decay", 0.0))

    def init(params: Mapping[str, torch.Tensor]) -> SGDState:
        return SGDState(step=0, momentum_buf={k: torch.zeros_like(p)
                                              for k, p in params.items()})

    def update(grads, state: SGDState, params, g_norm=None) -> SGDState:
        mu = mom_fn(state.step)
        lrs = {"weight": lr_w(state.step), "norm": lr_w(state.step),
               "bias": lr_b(state.step)}
        for group in GROUPS:
            keys = [k for k in grads if labels[k] == group]
            if not keys:
                continue
            g = [grads[k] for k in keys]
            p = [params[k] for k in keys]
            buf = [state.momentum_buf[k] for k in keys]
            if group == "weight" and wd:
                torch._foreach_add_(g, p, alpha=wd)
            torch._foreach_mul_(buf, mu)
            torch._foreach_add_(buf, g)
            torch._foreach_add_(g, buf, alpha=mu)         # nesterov direction
            torch._foreach_add_(p, g, alpha=-lrs[group])
        return SGDState(step=state.step + 1, momentum_buf=state.momentum_buf)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Apply the transforms in turn; the state is the tuple of theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params, g_norm=None):
        return tuple(t.update(grads, s, params, g_norm)
                     for t, s in zip(transforms, state))

    return GradientTransformation(init, update)


def make_optimizer(model: nn.Module, hyp: dict, max_epochs: int,
                   steps_per_epoch: int, cosine: bool = False,
                   grad_clip: float = 10.0) -> GradientTransformation:
    """Global-norm clipping (the reference trainer's gradient_clip_val=10),
    then the grouped SGD."""
    return chain(clip_by_global_norm(grad_clip),
                 yolo_sgd(model, hyp, max_epochs, steps_per_epoch, cosine))


def sgd_state(opt_state) -> SGDState:
    """The SGDState inside an optimizer state (make_optimizer's is a tuple)."""
    if isinstance(opt_state, SGDState):
        return opt_state
    return next(s for s in opt_state if isinstance(s, SGDState))
