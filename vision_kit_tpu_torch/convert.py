"""Weight bridge (JAX/Flax variables -> a state_dict for the port's
modules, and back) and the deploy-time folds over a port state_dict.

The port's module names mirror the torch keys that the JAX package's
converter emits, so a Flax {"params", "batch_stats"} tree (as numpy arrays,
what `jax.device_get` returns) maps key for key onto
`model.load_state_dict(..., strict=True)`. Kernels go HWIO -> OIHW (a
RepConv's `rbr_reparam` and a DWConvTranspose2d's (k, k, 1, O) kernel
included); BN {scale, bias} + {mean, var} -> {weight, bias, running_mean,
running_var}, plus the zero `num_batches_tracked` that torch BatchNorm
carries; an Implicit's (1, 1, 1, C) -> (1, C, 1, 1).
`jax_variables_from_state_dict` is the inverse (the counterpart of
vision_kit_tpu/convert.py:torch_to_flax): the Flax tree of a port
state_dict, which flax_msgpack writes as the JAX package's `.msgpack`.

The folds are counterparts of vision_kit_tpu/convert.py:fuse_conv_bn,
fuse_repconv_params and reparameterize_v7, on torch keys and OIHW kernels;
`deploy_state_dict` applies whichever of them a state_dict needs.

The checkpoint readers are counterparts of vision_kit_tpu/convert.py's:
`load_torch_checkpoint` (vision_kit-format files, Lightning wrappers and
prefixes), `load_upstream_checkpoint` with `upstream_to_vision_kit`
(ultralytics / WongKinYiu state_dicts zipped by position onto
`vision_kit_key_order`). The port's keys are the reference's, so a
vision_kit-format state_dict loads with no translation.
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Mapping

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
    """Flax variables (numpy leaves, or torch tensors such as
    utils/flax_msgpack.py's bfloat16 leaves) -> {torch key: float32
    tensor}."""
    sd: dict = {}
    bn_paths = set()

    def emit(parts, leaf, value, stats):
        arr = (value.detach().float().cpu().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value, dtype=np.float32))
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


def jax_variables_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """A port state_dict -> the Flax variables {"params", "batch_stats"}
    of the same model, as float32 numpy copies (never views of `sd`'s
    tensors, which a train step updates in place; the JAX package's
    torch_to_flax without a template): a dotted key's numeric parts join
    their parent as Flax's `name_N`; a 4-d weight goes OIHW -> HWIO, a 1-d
    weight is a BatchNorm's scale, running_mean/var its statistics, an
    Implicit's (1, C, 1, 1) -> (1, 1, 1, C); num_batches_tracked has no
    Flax counterpart and is dropped."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        path: list[str] = []
        for p in parts[:-1]:
            if p.isdigit() and path:
                path[-1] = f"{path[-1]}_{p}"
            else:
                path.append(p)
        arr = value.detach().to("cpu", torch.float32, copy=True).numpy()
        name = parts[-1]
        if name == "weight" and arr.ndim == 4:
            col, leaf, arr = "params", "kernel", arr.transpose(2, 3, 1, 0)
        elif name == "weight" and arr.ndim == 1:
            col, leaf = "params", "scale"
        elif name == "bias":
            col, leaf = "params", "bias"
        elif name in ("running_mean", "running_var"):
            col, leaf = "batch_stats", name[len("running_"):]
        elif name == "implicit":
            col, leaf, arr = "params", "implicit", arr.transpose(0, 2, 3, 1)
        else:
            raise ValueError(f"no Flax counterpart for {key} (shape {tuple(arr.shape)})")
        node = out[col]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out


def _split(sd: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """A bridged state_dict -> (params, running statistics), without
    num_batches_tracked."""
    params = {k: v for k, v in sd.items()
              if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    return params, stats


def _part(node, name: str):
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _has(node, name: str) -> bool:
    return name in node if isinstance(node, Mapping) else hasattr(node, name)


def train_state_tensors_from_jax(state) -> dict:
    """A JAX TrainState (train/step.py, numpy leaves as `jax.device_get`
    returns them), or the same state as a tree of dicts and tuples (an
    orbax checkpoint restored without a target: utils/orbax.py's
    read_checkpoint or orbax's untyped restore) -> its parts under the
    port's names: {"params", "batch_stats", "momentum" (the SGD momentum
    buffers, by parameter), "ema" (the averaged params and statistics),
    "ema_updates", "opt_step", "step"}. The optimizer state may be the SGD
    state or a sequence holding it (make_optimizer's chain, whose clip
    state is empty: None in a restored tree)."""
    params, stats = _split(state_dict_from_jax_variables(
        {"params": _part(state, "params"), "batch_stats": _part(state, "batch_stats")}))
    opt = _part(state, "opt_state")
    sgd = opt if _has(opt, "momentum_buf") else next(
        s for s in opt if s is not None and _has(s, "momentum_buf"))
    momentum, _ = _split(state_dict_from_jax_variables(
        {"params": _part(sgd, "momentum_buf")}))
    ema = _part(state, "ema")
    ema_params, ema_stats = _split(state_dict_from_jax_variables(_part(ema, "tree")))
    return {"params": params, "batch_stats": stats, "momentum": momentum,
            "ema": {**ema_params, **ema_stats},
            "ema_updates": int(_part(ema, "updates")), "opt_step": int(_part(sgd, "step")),
            "step": int(_part(state, "step"))}


def jax_train_state_tree(state) -> dict:
    """The port's TrainState (train/step.py) as the JAX TrainState's tree,
    in the layout the JAX Trainer's orbax checkpoints hold: {"params",
    "batch_stats", "opt_state": (None, {"step", "momentum_buf"}) (optax's
    empty clip state, then the SGD state), "ema": {"updates", "tree"},
    "step"}, float32 numpy arrays under Flax's names and int32 counts.
    utils/orbax.py:write_checkpoint writes it; the JAX package restores
    it."""
    from vision_kit_tpu_torch.train.optim import sgd_state

    sgd = sgd_state(state.opt_state)
    variables = jax_variables_from_state_dict({**state.params, **state.batch_stats})
    return {"params": variables["params"], "batch_stats": variables["batch_stats"],
            "opt_state": (None, {
                "step": np.asarray(sgd.step, np.int32),
                "momentum_buf": jax_variables_from_state_dict(sgd.momentum_buf)["params"]}),
            "ema": {"updates": np.asarray(state.ema.updates, np.int32),
                    "tree": jax_variables_from_state_dict(state.ema.tree)},
            "step": np.asarray(state.step, np.int32)}


def train_state_weights_prefix(tree):
    """Where the model weights of a restored JAX tree lie: None for a bare
    variables tree (the tree itself), ("ema", "tree") once the EMA has been
    updated, else () (the top-level params and batch_stats). The checks of
    vision_kit_tpu/predictor.py:_extract_weights_from_train_state."""
    if not isinstance(tree, Mapping) or "params" not in tree:
        return None
    if not ("ema" in tree and "opt_state" in tree):
        return None
    ema = tree.get("ema")
    if isinstance(ema, Mapping) and "tree" in ema:
        updates = np.asarray(ema.get("updates", 0))
        if updates.size == 1 and int(updates) > 0:
            return ("ema", "tree")
    return ()


def weights_from_jax_train_state(tree):
    """The model weights {"params", "batch_stats"} of a restored JAX
    Trainer checkpoint tree, as the JAX predictor's
    _extract_weights_from_train_state picks them: the EMA tree once the
    EMA has been updated (eval and export use the EMA model), else the raw
    params and statistics; a bare variables tree passes through."""
    prefix = train_state_weights_prefix(tree)
    if prefix is None:
        return tree
    node = tree
    for key in prefix:
        node = node[key]
    return {"params": node["params"], "batch_stats": node.get("batch_stats", {})}


def load_jax_train_state(model: torch.nn.Module, tx, state):
    """The port's TrainState (train/step.py) equal to a JAX TrainState: its
    params and statistics loaded into `model` (strict), the momentum
    buffers, the EMA and the step counts carried across. `tx` is the port's
    optimizer (train/optim.py)."""
    from vision_kit_tpu_torch.train.ema import EMAState
    from vision_kit_tpu_torch.train.optim import SGDState
    from vision_kit_tpu_torch.train.step import create_train_state

    parts = train_state_tensors_from_jax(state)
    sd = {**parts["params"], **parts["batch_stats"]}
    sd.update({k: v for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")})
    model.load_state_dict(sd, strict=True)
    out = create_train_state(model, tx)
    dev = next(model.parameters()).device
    sgd = SGDState(step=parts["opt_step"], momentum_buf={
        k: parts["momentum"][k].to(dev) for k in out.params})
    opt_state = (tuple(sgd if isinstance(s, SGDState) else s for s in out.opt_state)
                 if isinstance(out.opt_state, tuple) else sgd)
    ema = EMAState(updates=parts["ema_updates"],
                   tree={k: parts["ema"][k].to(dev) for k in out.ema.tree})
    return out._replace(opt_state=opt_state, ema=ema, step=parts["step"])


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


# ---------------------------------------------------------------------------
# Checkpoint readers
# ---------------------------------------------------------------------------

_CONV_CHILD = re.compile(r"^conv(\d+)$")
_HEAD_RANK = {"m": 0, "ia": 1, "im": 2}


def _declaration_order(node: dict) -> list[str]:
    """The children of one module, by name, in the reference's
    registration order.

    The port registers children as its blocks are built; the reference
    declares them otherwise in three blocks (vision_kit_tpu/convert.py:
    _declaration_order): C3Bottleneck declares conv1, conv2, conv3, then m
    (the port builds m before conv3); SPPCSPC declares conv1..conv7 in
    numeric order; YoloV7Head declares m before ia and im. A module whose
    children are all `conv<N>` and a container `m` (children 0, 1, ...)
    takes the first order, one whose children are among m, ia, im the
    last; every other keeps the port's."""
    names = [n for n, child in node.items() if isinstance(child, dict)]

    def container(n):
        return all(k.isdigit() for k, v in node[n].items() if isinstance(v, dict))

    if names and all(_CONV_CHILD.match(n) or (n == "m" and container(n))
                     for n in names):
        return sorted(names, key=lambda n: (1, 0) if n == "m"
                      else (0, int(_CONV_CHILD.match(n).group(1))))
    if names and all(n in _HEAD_RANK for n in names):
        return sorted(names, key=_HEAD_RANK.get)
    return names


def vision_kit_key_order(keys: Iterable[str] | torch.nn.Module) -> list[str]:
    """The reference torch model's state_dict key order for a port model
    (or its state_dict keys): each module's own tensors in the port's order
    (weight, bias, implicit, running_mean, running_var,
    num_batches_tracked, as torch and the reference emit them), then its
    children in `_declaration_order`. Equal to
    vision_kit_tpu/convert.py:vision_kit_key_order of the same model's
    Flax init tree (tests/test_torch_checkpoint.py): the order the
    upstream positional zip-map needs."""
    if isinstance(keys, torch.nn.Module):
        keys = keys.state_dict().keys()
    tree: dict = {}
    for key in keys:
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = key

    out: list[str] = []

    def walk(node):
        out.extend(v for v in node.values() if isinstance(v, str))
        for name in _declaration_order(node):
            walk(node[name])

    walk(tree)
    return out


def upstream_to_vision_kit(upstream_sd: Mapping[str, Any],
                           model: Iterable[str] | torch.nn.Module) -> dict:
    """Positional zip-map of an upstream (ultralytics YOLOv5 / WongKinYiu
    YOLOv7) state_dict onto the port's keys: the `anchors`/`anchor_grid`
    buffers are dropped, then the values are zipped in order onto
    `vision_kit_key_order(model)`. A count mismatch (wrong variant or
    family, extra buffers) raises, naming the leftovers; the shapes are
    checked where the result is loaded."""
    up_items = [(k, v) for k, v in upstream_sd.items()
                if not k.endswith((".anchors", ".anchor_grid"))]
    vk_keys = vision_kit_key_order(model)
    if len(up_items) != len(vk_keys):
        up_tail = [k for k, _ in up_items[len(vk_keys):]][:5]
        vk_tail = vk_keys[len(up_items):][:5]
        raise ValueError(
            f"upstream checkpoint has {len(up_items)} tensors but the model "
            f"expects {len(vk_keys)} — wrong variant/family? "
            f"(unmatched upstream: {up_tail or 'none'}, "
            f"unmatched model: {vk_tail or 'none'})")
    return {new: val for new, (_, val) in zip(vk_keys, up_items)}


def _torch_load(path: str):
    """torch.load on the CPU of tensors, dicts, lists and numbers only
    (weights_only: unpickling runs no code, so a pickled nn.Module, the
    torch.hub form, is refused; save its state_dict instead)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_upstream_checkpoint(path: str) -> dict:
    """A local upstream `.pt` (a state_dict, or one under "ema", "model" or
    "state_dict") as an order-preserving {key: f32 tensor}, for
    `upstream_to_vision_kit`. No prefix is stripped and nothing is merged:
    any re-keying would scramble the order the zip-map relies on."""
    obj = _torch_load(path)
    if isinstance(obj, dict):
        for key in ("ema", "model", "state_dict"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: no state_dict found in checkpoint")
    out = {k: v.detach().float() for k, v in obj.items()
           if isinstance(v, torch.Tensor)}
    if not out:
        raise ValueError(f"{path}: checkpoint contains no tensors")
    return out


def checkpoint_state_dict(ckpt) -> dict:
    """A loaded vision_kit-format checkpoint -> flat {key: f32 tensor}: the
    state_dict under "model", "state_dict" or "ema" when it is wrapped, the
    Lightning prefixes stripped (`model.`, and `ema_model.` with an inner
    `module.`), and the EMA's entries winning over the model's (the
    reference evaluates the EMA)."""
    if isinstance(ckpt, dict):
        for key in ("model", "state_dict", "ema"):
            if isinstance(ckpt.get(key), dict):
                ckpt = ckpt[key]
                break
    sd, ema = {}, {}
    for k, v in ckpt.items():
        if not isinstance(v, torch.Tensor):
            continue
        v = v.detach().float()
        if k.startswith("ema_model."):
            k = k[len("ema_model."):]
            if k.startswith("module."):
                k = k[len("module."):]
            ema[k] = v
        elif k.startswith("model."):
            sd[k[len("model."):]] = v
        else:
            sd[k] = v
    sd.update(ema)
    return sd


def load_torch_checkpoint(path: str) -> dict:
    """A vision_kit-format `.pt`/`.pth`/`.ckpt` file as flat {key: f32
    tensor} (`checkpoint_state_dict`)."""
    return checkpoint_state_dict(_torch_load(path))
