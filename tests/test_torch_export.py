"""The port's checked export (export.py) and its command line on the CPU.

v5n@64 with seeded JAX weights: every artifact is replayed from disk and
checked against the eager forward (REPLAY_ATOL + REPLAY_RTOL of the value),
the batch-2 replays included; the eager export model (reference order,
NCHW float in [0, 1]) equals JAX's decode_order="reference" export forward
within TORCH_ATOL, the bound JAX's export holds across frameworks. A
corrupted replay is quarantined `.failed` and raises; an artifact that
cannot be replayed is removed; ONNX is skipped with the exporter's reason
where `onnx` (or onnxruntime) is absent, as in this sandbox."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from vision_kit_tpu.models import YOLOV5 as JaxYOLOV5
from vision_kit_tpu_torch import __main__ as cli
from vision_kit_tpu_torch import export
from vision_kit_tpu_torch.convert import state_dict_from_jax_variables
from vision_kit_tpu_torch.models import YOLOV5, build_model
from vision_kit_tpu_torch.utils.config import load_config
from test_torch_checkpoint import seeded_v5n, upstream_file
from test_torch_model import REPO

torch.set_num_threads(2)

SIZE = 64


def v5n_config(output_dir="outputs"):
    cfg = load_config(os.path.join(REPO, "configs/yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = "n", 80
    cfg.model.input_size = [SIZE, SIZE]
    cfg.data.output_dir = str(output_dir)
    return cfg


def seeded_port(cfg):
    _, v = seeded_v5n()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    return model


def test_run_export_checks_every_artifact(tmp_path):
    cfg = v5n_config()
    model = seeded_port(cfg)
    save_dir = str(tmp_path / "weights")
    os.makedirs(save_dir)
    stale = os.path.join(save_dir, "yolov5_n.onnx")
    with open(stale, "w") as f:
        f.write("an earlier, unchecked export")
    res = export.run_export(cfg, model, save_dir)

    assert set(res.artifacts) >= {"msgpack", "weights", "torch_export",
                                  "exported_program_text", "torchscript"}
    for kind in ("torch_export", "torch_export_batch2", "torchscript",
                 "torchscript_batch2"):
        assert res.checks[kind] <= export.REPLAY_ATOL, (kind, res.checks[kind])
    assert res.checks["weights"] == 0.0 and res.checks["msgpack"] == 0.0
    assert "TensorFlow" in res.skipped["savedmodel"]
    if "onnx" in res.artifacts:
        assert res.checks["onnx_runtime_batch2"] <= export.REPLAY_ATOL
    else:
        assert res.skipped["onnx"] and not os.path.exists(stale)
    on_disk = set(os.listdir(save_dir))
    assert on_disk == {os.path.basename(p) for p in res.artifacts.values()}
    weights = torch.load(res.artifacts["weights"], weights_only=True)["model"]
    for k, t in model.state_dict().items():
        assert torch.equal(weights[k], t), k
    with open(res.artifacts["exported_program_text"]) as f:
        assert "ExportedProgram" in f.read()

    # the exported program's batch is dynamic: batch 3 replays too
    program = torch.export.load(res.artifacts["torch_export"]).module()
    x = torch.rand(3, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    wrapper = export.export_model(cfg, model)
    with torch.no_grad():
        torch.testing.assert_close(program(x), wrapper(x), rtol=export.REPLAY_RTOL,
                                   atol=export.REPLAY_ATOL)


def test_eager_export_model_matches_jax_reference_order():
    """The exported function against JAX's: the JAX package's export model
    (export=True, decode_order="reference") on the NHWC probe, the port's
    on its NCHW transpose."""
    cfg = v5n_config()
    _, v = seeded_v5n()
    wrapper = export.export_model(cfg, seeded_port(cfg))
    probe = export.probe_input((SIZE, SIZE), "cpu")
    probe2 = torch.cat([probe, probe.flip(3)])
    jm = JaxYOLOV5(variant="n", num_classes=80, export=True, decode_order="reference")
    fwd = jax.jit(lambda x: jm.apply(v, x, training=False)[0])
    for p in (probe, probe2):
        want = np.asarray(fwd(jnp.asarray(p.permute(0, 2, 3, 1).numpy())))
        with torch.no_grad():
            got = wrapper(p).numpy()
        assert got.shape == want.shape == (p.shape[0], 252, 85)
        assert np.abs(got - want).max() <= export.TORCH_ATOL
    with pytest.raises(ValueError, match="reference"):
        export.ExportModel(YOLOV5("n"))


class _Corrupt:
    """A replayed module whose output is off by one."""

    def __init__(self, module):
        self.module = module

    def eval(self):
        return self

    def __call__(self, x):
        return self.module(x) + 1.0


def test_corrupted_replay_is_quarantined(tmp_path, monkeypatch):
    cfg = v5n_config()
    load = torch.jit.load
    monkeypatch.setattr(torch.jit, "load", lambda *a, **k: _Corrupt(load(*a, **k)))
    save_dir = str(tmp_path)
    with pytest.raises(export.ExportCheckError, match="torchscript"):
        export.run_export(cfg, seeded_port(cfg), save_dir, onnx=False)
    path = os.path.join(save_dir, "yolov5_n.torchscript.pt")
    assert os.path.exists(path + ".failed") and not os.path.exists(path)


def test_unreplayable_artifacts_are_removed(tmp_path, monkeypatch):
    cfg = v5n_config()

    def refuse(*args, **kwargs):
        raise RuntimeError("cannot load here")

    monkeypatch.setattr(torch.export, "load", refuse)
    monkeypatch.setattr(torch.jit, "load", refuse)
    save_dir = str(tmp_path)
    res = export.run_export(cfg, seeded_port(cfg), save_dir, onnx=False)
    assert "cannot load here" in res.skipped["torch_export"]
    assert "cannot load here" in res.skipped["torchscript"]
    assert res.skipped["onnx"] == "disabled"
    assert sorted(os.listdir(save_dir)) == ["yolov5_n.msgpack", "yolov5_n.pt"]
    with pytest.raises(RuntimeError, match="cannot load here"):
        export.run_export(cfg, seeded_port(cfg), save_dir, onnx=False,
                          torchscript=True)
    assert sorted(os.listdir(save_dir)) == ["yolov5_n.msgpack", "yolov5_n.pt"]


def test_cli_convert_then_export(tmp_path, capsys):
    """`convert --from-upstream` of an upstream-ordered file, then
    `export --ckpt` of the converted file; train raises."""
    jm, v = seeded_v5n()
    upstream = str(tmp_path / "upstream.pt")
    upstream_file(upstream, v, jm)
    converted = str(tmp_path / "v5n_port.pt")
    assert cli.main(["convert", upstream, "-m", "yolov5", "-v", "n",
                     "--from-upstream", "-o", converted]) == 0
    sd = torch.load(converted, weights_only=True)["model"]
    want = state_dict_from_jax_variables({k: jax.tree_util.tree_map(
        lambda a: a.astype(np.float16).astype(np.float32), v[k]) for k in v})
    for k, t in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], t), k

    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(v5n_config(tmp_path / "out"))), f)
    assert cli.main(["export", "-c", cfg_path, "--ckpt", converted,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"loaded weights from {converted}" in out
    assert "exported torchscript" in out and "export savedmodel skipped" in out
    weights = torch.load(str(tmp_path / "out" / "weights" / "yolov5_n.pt"),
                         weights_only=True)["model"]
    for k, t in sd.items():
        assert torch.equal(weights[k], t), k
    # train runs on the card unless --device cpu is given
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "-c", cfg_path])
