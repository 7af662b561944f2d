"""Weight bridge: JAX/Flax variables -> a state_dict for the port's modules.

The port's module names mirror the torch keys that the JAX package's
converter emits, so a Flax {"params", "batch_stats"} tree (as numpy arrays,
what `jax.device_get` returns) maps key for key onto
`model.load_state_dict(..., strict=True)`. Kernels go HWIO -> OIHW; BN
{scale, bias} + {mean, var} -> {weight, bias, running_mean, running_var},
plus the zero `num_batches_tracked` that torch BatchNorm carries.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

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
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"non-conv kernel at {key}: ndim {arr.ndim}")
            sd[key + ".weight"] = arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            sd[key + ".weight"] = arr
            bn_paths.add(key)
        elif leaf == "bias":
            sd[key + ".bias"] = arr
        elif leaf == "mean" and stats:
            sd[key + ".running_mean"] = arr
            bn_paths.add(key)
        elif leaf == "var" and stats:
            sd[key + ".running_var"] = arr
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
        out[key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out
