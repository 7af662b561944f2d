"""Weight bridge (JAX/Flax variables -> a state_dict for the port's
modules) and the deploy-time folds over a port state_dict.

The port's module names mirror the torch keys that the JAX package's
converter emits, so a Flax {"params", "batch_stats"} tree (as numpy arrays,
what `jax.device_get` returns) maps key for key onto
`model.load_state_dict(..., strict=True)`. Kernels go HWIO -> OIHW (a
RepConv's `rbr_reparam` and a DWConvTranspose2d's (k, k, 1, O) kernel
included); BN {scale, bias} + {mean, var} -> {weight, bias, running_mean,
running_var}, plus the zero `num_batches_tracked` that torch BatchNorm
carries; an Implicit's (1, 1, 1, C) -> (1, C, 1, 1).

The folds are counterparts of vision_kit_tpu/convert.py:fuse_conv_bn,
fuse_repconv_params and reparameterize_v7, on torch keys and OIHW kernels;
`deploy_state_dict` applies whichever of them a state_dict needs.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from vision_kit_tpu_torch.models.layers import BN_EPS

_DIGIT_SUFFIX = re.compile(r"^(.*)_(\d+)$")


def _untranslate_name(name: str, siblings: set[str]) -> list[str]:
    """One Flax module name -> torch dotted parts.

    Flax names a Sequential/ModuleList child `base_N`; a literal attribute
    may also end in `_N`. A container index always has an index-0 sibling,
    so `base_N` splits into `base.N` only when `base_0` is among the node's
    siblings (`stage1_1` splits because `stage1_0` exists)."""
    m = _DIGIT_SUFFIX.match(name)
    if m and f"{m.group(1)}_0" in siblings:
        return [m.group(1), m.group(2)]
    return [name]


def state_dict_from_jax_variables(variables: Mapping[str, Any]) -> dict:
    """Flax variables (numpy leaves) -> {torch key: float32 tensor}."""
    sd: dict = {}
    bn_paths = set()

    def emit(parts, leaf, value, stats):
        arr = np.asarray(value, dtype=np.float32)
        key = ".".join(parts)

        def put(name, a):
            sd[f"{key}.{name}" if key else name] = a

        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"non-conv kernel at {key}: ndim {arr.ndim}")
            put("weight", arr.transpose(3, 2, 0, 1))
        elif leaf == "scale":
            put("weight", arr)
            bn_paths.add(key)
        elif leaf == "bias":
            put("bias", arr)
        elif leaf == "implicit":
            put("implicit", arr.transpose(0, 3, 1, 2))
        elif leaf == "mean" and stats:
            put("running_mean", arr)
            bn_paths.add(key)
        elif leaf == "var" and stats:
            put("running_var", arr)
            bn_paths.add(key)
        else:
            raise ValueError(f"Unhandled flax leaf {key}/{leaf}")

    def walk(node, prefix, stats):
        siblings = set(node.keys())
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, prefix + _untranslate_name(name, siblings), stats)
            else:
                emit(prefix, name, child, stats)

    walk(variables.get("params", {}), [], stats=False)
    walk(variables.get("batch_stats", {}), [], stats=True)

    out = {k: torch.tensor(v) for k, v in sd.items()}
    for key in bn_paths:
        name = f"{key}.num_batches_tracked" if key else "num_batches_tracked"
        out[name] = torch.zeros((), dtype=torch.int64)
    return out


def fuse_conv_bn(weight: torch.Tensor, bn_weight: torch.Tensor,
                 bn_bias: torch.Tensor, bn_mean: torch.Tensor,
                 bn_var: torch.Tensor):
    """Fold a BatchNorm into the bias-free OIHW conv before it:
    (weight', bias')."""
    factor = bn_weight / torch.sqrt(bn_var + BN_EPS)        # (O,)
    return weight * factor[:, None, None, None], bn_bias - bn_mean * factor


def _bn(sd, prefix):
    return tuple(sd[f"{prefix}{k}"] for k in
                 ("weight", "bias", "running_mean", "running_var"))


def _fuse_repconv(sd: Mapping[str, torch.Tensor], p: str):
    """The 3x3 conv (weight, bias) equal to the RepConv whose keys start
    with `p`: fuse(dense) + pad1(fuse(1x1)) + pad1(fuse(identity kernel,
    identity BN)). The identity kernel is the JAX fold's corrected one (a 1
    at [i, i] for every channel i), not the reference's."""
    dk, db = fuse_conv_bn(sd[p + "rbr_dense.conv.weight"],
                          *_bn(sd, p + "rbr_dense.bn."))
    ok, ob = fuse_conv_bn(sd[p + "rbr_1x1.conv.weight"],
                          *_bn(sd, p + "rbr_1x1.bn."))
    weight = dk + torch.nn.functional.pad(ok, (1, 1, 1, 1))
    bias = db + ob
    if p + "rbr_identity.weight" in sd:
        ins = dk.shape[1]
        ident = torch.zeros_like(ok)
        ident[torch.arange(ins), torch.arange(ins)] = 1.0
        ik, ib = fuse_conv_bn(ident, *_bn(sd, p + "rbr_identity."))
        weight = weight + torch.nn.functional.pad(ik, (1, 1, 1, 1))
        bias = bias + ib
    return weight, bias


# the prefix group is empty or ends in "."
_REPCONV = re.compile(r"^((?:.*\.)?)rbr_dense\.conv\.weight$")
_HEAD_IA = re.compile(r"^((?:.*\.)?)ia\.(\d+)\.implicit$")


def fuse_repconv_params(sd: Mapping[str, torch.Tensor]) -> dict:
    """Every RepConv of a state_dict folded: its branches' keys (and their
    BN statistics) replaced by `rbr_reparam.{weight, bias}`."""
    out = dict(sd)
    for key in sd:
        m = _REPCONV.match(key)
        if m:
            p = m.group(1)
            weight, bias = _fuse_repconv(sd, p)
            for k in [k for k in out if k.startswith(p + "rbr_")]:
                del out[k]
            out[p + "rbr_reparam.weight"] = weight
            out[p + "rbr_reparam.bias"] = bias
    return out


def reparameterize_v7(sd: Mapping[str, torch.Tensor]) -> dict:
    """Every head's implicit pair ia_i/im_i folded into its 1x1 conv m_i:
    im * (W @ (x + ia) + b) = (im * W) @ x + im * (W @ ia + b)."""
    out = dict(sd)
    for key in sd:
        m = _HEAD_IA.match(key)
        if m:
            p, i = m.groups()
            ia = out.pop(f"{p}ia.{i}.implicit").reshape(-1)        # (I,)
            im = out.pop(f"{p}im.{i}.implicit").reshape(-1)        # (O,)
            weight, bias = out[f"{p}m.{i}.weight"], out[f"{p}m.{i}.bias"]
            out[f"{p}m.{i}.bias"] = (bias + weight[:, :, 0, 0] @ ia) * im
            out[f"{p}m.{i}.weight"] = weight * im[:, None, None, None]
    return out


def deploy_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """A training-structure state_dict -> the deploy structure's, which a
    model built with deploy=True loads with strict=True: whichever of the
    two folds apply (v7 base has RepConvs and head implicits, v7 x only
    the implicits), as the JAX predictor's load-time `_maybe_deploy_fold`
    does. A state_dict that needs neither comes back as a copy."""
    return reparameterize_v7(fuse_repconv_params(sd))
