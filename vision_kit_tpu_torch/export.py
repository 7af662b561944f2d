"""Deployment export with a numeric check of every artifact.

Counterpart of vision_kit_tpu/export.py (the reference's export task:
ONNX opset 13 and a TorchScript trace). The exported function is the
reference's interface: NCHW float32 images in [0, 1] in, the decoded
(B, N, 5+nc) output in the reference's anchor-major order out
(`ExportModel`, a port model built with decode_order="reference" in f32).
Artifacts, each replayed from disk on a fixed probe and compared with the
port's eager forward before it counts:

  * msgpack: the weights as Flax variables ({"params", "batch_stats"},
    convert.jax_variables_from_state_dict) in flax.serialization.to_bytes'
    format (utils/flax_msgpack.py), the JAX export's first artifact, which
    the JAX package's load_weights reads; reloaded from disk and compared
    leaf by leaf, exactly;
  * weights: `{"model": state_dict}` `.pt` (the form the JAX package's
    scripts/convert.py --to-torch writes), reloaded and compared entry by
    entry, exactly;
  * torch.export: the program with a dynamic batch, saved with
    torch.export.save, loaded with torch.export.load and replayed at batch
    1 and 2 (the jax.export leg's counterpart); its text dump stands for
    the StableHLO text and is written once the program passed;
  * ONNX: opset 13, input "images", output "output", dynamic batch,
    replayed with onnxruntime where it imports;
  * TorchScript: a trace, replayed from disk at batch 1 and batch 2.

There is no TensorFlow in the port, so `skipped["savedmodel"]` says so.
No unchecked artifact stays on disk: a run first removes the artifacts an
earlier export of the same model left in `save_dir`; an artifact that
cannot be replayed is removed (in "auto" mode the leg is then recorded in
`skipped` with its reason); one that fails its check is renamed
`<path>.failed` and the export raises ExportCheckError.

Export runs on the device the model is on.
"""

from __future__ import annotations

import os
import shutil
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from vision_kit_tpu_torch.utils.logging_utils import logger

#: A replay of the same graph against the eager forward: |delta| within
#: REPLAY_ATOL + REPLAY_RTOL * |eager| (a few f32 ulps of the pixel-valued
#: boxes, which reach ~1500 px; the same ops may be fused or ordered
#: otherwise by the replaying runtime).
REPLAY_ATOL, REPLAY_RTOL = 1e-4, 1e-5
#: The port's eager forward against JAX's reference-order forward (the
#: tests): another framework computes the same graph.
TORCH_ATOL = 5e-3


class ExportCheckError(AssertionError):
    """An exported artifact disagreed with the eager forward."""


@dataclass
class ExportResult:
    artifacts: dict = field(default_factory=dict)  # kind -> path
    checks: dict = field(default_factory=dict)     # kind -> max |delta|
    skipped: dict = field(default_factory=dict)    # kind -> reason


def _remove_artifact(path: str) -> None:
    """Delete a file-or-directory artifact whose numeric check never ran."""
    try:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    except OSError as e:
        logger.warning("could not remove unchecked artifact %s: %s", path, e)


def _quarantine_artifact(path: str) -> None:
    """Rename an artifact that failed its numeric check to `<path>.failed`,
    so that a deploy script globbing save_dir cannot pick it up, while its
    bytes stay for diagnosis."""
    try:
        if os.path.exists(path):
            failed = path + ".failed"
            _remove_artifact(failed)
            os.replace(path, failed)
            logger.warning("artifact failed its check; quarantined as %s", failed)
    except OSError as e:
        logger.warning("could not quarantine failed artifact %s: %s", path, e)


def probe_input(size, device) -> torch.Tensor:
    """The fixed probe: a (1, 3, H, W) float32 batch in [0, 1), the JAX
    export's numpy-seeded probe (its NHWC array, transposed)."""
    h, w = size
    probe = np.random.default_rng(1234).random((1, h, w, 3), np.float32)
    return torch.from_numpy(probe.transpose(0, 3, 1, 2).copy()).to(device)


class ExportModel(nn.Module):
    """The exported function: (B, 3, H, W) float32 images in [0, 1] ->
    decoded (B, N, 5+nc), N in the reference's (ia, iy, ix) order per
    level. `model` is a port model built with decode_order="reference"."""

    def __init__(self, model: nn.Module):
        super().__init__()
        if model.decode_order != "reference":
            raise ValueError("the exported model decodes in the reference "
                             "order; build it with decode_order='reference'")
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images.permute(0, 2, 3, 1))[0]


def export_model(cfg, model: nn.Module) -> ExportModel:
    """ExportModel of `model`'s weights: cfg's model built in f32 with
    decode_order="reference" on model's device, loaded (strict) from
    model's state_dict, in eval mode."""
    from vision_kit_tpu_torch.models import build_model

    device = next(model.parameters()).device
    ref = build_model(cfg, device=device, dtype=torch.float32,
                      decode_order="reference")
    ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in model.state_dict().items()}, strict=True)
    return ExportModel(ref).eval()


def _check_replay(kind: str, got: torch.Tensor, want: torch.Tensor,
                  res: ExportResult, check: bool) -> None:
    """Record max |got - want| as res.checks[kind]; with `check`, raise
    ExportCheckError beyond the replay tolerance."""
    got = got.to(want.device, torch.float32)
    if got.shape != want.shape:
        res.checks[kind] = float("inf")
        if check:
            raise ExportCheckError(f"{kind} replay gives shape {tuple(got.shape)}, "
                                   f"the eager forward {tuple(want.shape)}")
        return
    delta = float((got - want).abs().max())
    res.checks[kind] = delta
    logger.info("%s check: max |delta| = %.3e", kind, delta)
    if check and not torch.allclose(got, want, rtol=REPLAY_RTOL, atol=REPLAY_ATOL):
        raise ExportCheckError(
            f"{kind} replay deviates from the eager forward: max |delta| "
            f"{delta:.3e} beyond {REPLAY_ATOL} + {REPLAY_RTOL} * |eager|")


def _weights_leg(model, path, res, check) -> None:
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": sd}, path)
    reloaded = torch.load(path, map_location="cpu", weights_only=True)["model"]
    delta = 0.0
    if set(reloaded) != set(sd):
        delta = float("inf")
    else:
        for k, v in sd.items():
            r = reloaded[k]
            if r.dtype != v.dtype or r.shape != v.shape:
                delta = float("inf")
            elif not torch.equal(r, v):
                delta = max(delta, float((r.double() - v.double()).abs().max()))
    res.checks["weights"] = delta
    if check and delta > 0.0:
        _quarantine_artifact(path)
        raise ExportCheckError(f"weights round trip is not lossless: max "
                               f"|delta| = {delta:.3e}")
    res.artifacts["weights"] = path


def _msgpack_leg(model, path, res, check) -> None:
    from vision_kit_tpu_torch.convert import jax_variables_from_state_dict
    from vision_kit_tpu_torch.utils import flax_msgpack

    variables = jax_variables_from_state_dict(model.state_dict())
    flax_msgpack.write_file(path, variables)
    reloaded = flax_msgpack.read_file(path)
    delta = _tree_delta(variables, reloaded)
    res.checks["msgpack"] = delta
    if check and delta > 0.0:
        _quarantine_artifact(path)
        raise ExportCheckError(f"msgpack weights round trip is not lossless: max "
                               f"|delta| = {delta:.3e}")
    res.artifacts["msgpack"] = path


def _tree_delta(want, got) -> float:
    """max |got - want| over two trees of numpy leaves; inf where their
    keys, shapes or dtypes differ."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            return float("inf")
        return max((_tree_delta(want[k], got[k]) for k in want), default=0.0)
    if (not isinstance(got, np.ndarray) or got.dtype != want.dtype
            or got.shape != want.shape):
        return float("inf")
    if np.array_equal(got, want):
        return 0.0
    return float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())


def _torch_export_leg(wrapper, probes, want, path, text_path, res, check) -> None:
    from torch.export import Dim

    try:
        program = torch.export.export(
            wrapper, (probes[1],),
            dynamic_shapes={"images": {0: Dim("batch", min=1, max=4096)}})
        torch.export.save(program, path)
        replay = torch.export.load(path).module()
        with torch.no_grad():
            outs = [replay(p) for p in probes]
    except Exception as e:  # exporter or runtime skew: no numeric verdict
        _remove_artifact(path)
        res.skipped["torch_export"] = f"torch.export leg failed: {e}"
        logger.warning("torch.export artifact skipped: %s", e)
        return
    try:
        for kind, got, w in zip(("torch_export", "torch_export_batch2"), outs, want):
            _check_replay(kind, got, w, res, check)
    except ExportCheckError:
        _quarantine_artifact(path)
        raise
    with open(text_path, "w") as f:
        f.write(str(program))
    res.artifacts["torch_export"] = path
    res.artifacts["exported_program_text"] = text_path


def _onnx_leg(wrapper, probes, want, path, res, check) -> None:
    torch.onnx.export(
        wrapper, (probes[0],), path, opset_version=13, input_names=["images"],
        output_names=["output"],
        dynamic_axes={"images": {0: "batch"}, "output": {0: "batch"}},
        dynamo=False)
    try:
        import onnxruntime as ort
    except ImportError as e:
        raise RuntimeError(f"onnxruntime is not installed ({e}); the ONNX file "
                           "cannot be replayed and checked") from e
    sess = ort.InferenceSession(path, providers=["CPUExecutionProvider"])
    outs = [torch.from_numpy(sess.run(["output"], {"images": p.cpu().numpy()})[0])
            for p in probes]
    for kind, got, w in zip(("onnx_runtime", "onnx_runtime_batch2"), outs, want):
        _check_replay(kind, got, w, res, check)
    res.artifacts["onnx"] = path


def _torchscript_leg(wrapper, probes, want, path, res, check) -> None:
    # the tracer warns that the decode grids become constants: they are, at
    # the export size (batch is the trace's only free axis, as in the
    # reference's trace), and the batch-2 replay checks that
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        traced = torch.jit.trace(wrapper, (probes[0],))
    torch.jit.save(traced, path)
    replay = torch.jit.load(path, map_location=probes[0].device).eval()
    with torch.no_grad():
        outs = [replay(p) for p in probes]
    for kind, got, w in zip(("torchscript", "torchscript_batch2"), outs, want):
        _check_replay(kind, got, w, res, check)
    res.artifacts["torchscript"] = path


def _interchange_leg(kind, mode, leg, path, res) -> None:
    """Run an interchange leg (ONNX, TorchScript) under its mode: False
    skips it; "auto" records a machinery failure in res.skipped; True
    raises it. A failed check always raises, with the artifact renamed
    `.failed`; an artifact without a verdict is removed."""
    if mode is False:
        res.skipped[kind] = "disabled"
        return
    try:
        leg()
    except ExportCheckError:
        _quarantine_artifact(path)
        res.artifacts.pop(kind, None)
        raise
    except Exception as e:
        _remove_artifact(path)
        if mode is True:
            raise
        res.skipped[kind] = f"{kind} leg failed: {e}"
        logger.warning("%s export skipped: %s", kind, e)


def run_export(cfg, model: nn.Module, save_dir: str, onnx: str | bool = "auto",
               torchscript: str | bool = "auto", check: bool = True) -> ExportResult:
    """Write the export artifacts of `model` (a port model of cfg.model, in
    either decode order and any dtype) into `save_dir`, on model's device.

    onnx / torchscript: True (required: a leg that cannot run raises),
    False (skip), or "auto" (export where the machinery runs, else record
    why in `skipped`). check=True raises ExportCheckError on any numeric
    disagreement; the max deltas are always returned in `checks`."""
    res = ExportResult()
    os.makedirs(save_dir, exist_ok=True)
    stem = os.path.join(save_dir, f"{cfg.model.name.lower()}_{cfg.model.version}")
    paths = {"msgpack": stem + ".msgpack", "weights": stem + ".pt",
             "torch_export": stem + ".pt2",
             "exported_program_text": stem + ".exported.txt",
             "onnx": stem + ".onnx", "torchscript": stem + ".torchscript.pt"}
    for path in paths.values():
        _remove_artifact(path)

    _msgpack_leg(model, paths["msgpack"], res, check)
    _weights_leg(model, paths["weights"], res, check)

    wrapper = export_model(cfg, model)
    probe = probe_input(tuple(cfg.model.input_size), next(wrapper.parameters()).device)
    probes = (probe, torch.cat([probe, probe.flip(3)]))   # batch 1, batch 2
    with torch.no_grad():
        want = [wrapper(p) for p in probes]

    _torch_export_leg(wrapper, probes, want, paths["torch_export"],
                      paths["exported_program_text"], res, check)
    res.skipped["savedmodel"] = ("no TensorFlow in the port: the SavedModel "
                                 "leg belongs to the JAX package")
    _interchange_leg("onnx", onnx, lambda: _onnx_leg(
        wrapper, probes, want, paths["onnx"], res, check), paths["onnx"], res)
    _interchange_leg("torchscript", torchscript, lambda: _torchscript_leg(
        wrapper, probes, want, paths["torchscript"], res, check),
        paths["torchscript"], res)
    return res
