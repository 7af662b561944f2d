"""Two options that close faults of the port, on the CPU:

- Trainer(deterministic=True) and `train --deterministic`: two fits from
  one seed end bit-identical; the mode sets CUBLAS_WORKSPACE_CONFIG when
  CUDA has not started and raises when it started without it; the CLI
  flag reaches the Trainer.
- The datasets' `decoder` option ("auto", "plain", "nvjpeg"): "plain"
  gives the default's items on the CPU, "nvjpeg" needs a card, and a
  TrainLoader with workers refuses an "nvjpeg" dataset. (On the card:
  tests/test_torch_cuda.py.)
"""

import os

import numpy as np
import pytest
import torch

from fixture_lib import build_rectangle_dataset
from test_torch_trainer import assert_states_identical, cfg_dict, port_trainer
from vision_kit_tpu_torch import __main__ as cli
from vision_kit_tpu_torch.data.datasets import ConcatDataset, YOLODataset
from vision_kit_tpu_torch.data.loader import TrainLoader
from vision_kit_tpu_torch.train import trainer as port_trainer_mod
from vision_kit_tpu_torch.utils.general import deterministic_mode

torch.set_num_threads(2)


@pytest.fixture
def restore_determinism(monkeypatch):
    """Deterministic mode is set for the process: put it back after the
    test (and CUBLAS_WORKSPACE_CONFIG, through monkeypatch)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")   # restored at teardown
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    yield
    torch.use_deterministic_algorithms(saved[0])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("faults_ds")
    build_rectangle_dataset(str(root))
    return root


def test_deterministic_fit_is_bit_identical_twice(dataset_root, tmp_path,
                                                  restore_determinism):
    runs = []
    for name in ("a", "b"):
        tr = port_trainer(cfg_dict(dataset_root, tmp_path / name, batch=4, epochs=2,
                                   val_interval=1), deterministic=True)
        tr.fit()
        tr.train_loader.close()
        runs.append(tr)
    assert torch.are_deterministic_algorithms_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert runs[0].global_step == 6
    assert_states_identical(*runs)


def test_deterministic_mode_needs_its_variable_before_cuda(monkeypatch,
                                                           restore_determinism):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG=:4096:8"):
        deterministic_mode()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    deterministic_mode()
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark


def test_cli_train_deterministic_reaches_the_trainer(tmp_path, monkeypatch,
                                                     restore_determinism):
    """`train --deterministic` sets the variable first and hands the flag to
    the Trainer; `train` without it does not."""
    import yaml

    seen = []

    class Recorder:
        def __init__(self, cfg, **kw):
            seen.append((kw.get("deterministic"), os.environ.get("CUBLAS_WORKSPACE_CONFIG")))
            raise SystemExit(0)

    monkeypatch.setattr(port_trainer_mod, "Trainer", Recorder)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(cfg_dict(tmp_path, tmp_path / "out")))
    for flags in ([], ["--deterministic"]):
        with pytest.raises(SystemExit):
            cli.main(["train", "-c", str(cfg), "--device", "cpu", *flags])
    assert seen == [(False, None), (True, ":4096:8")]


def test_dataset_decoder_option_on_cpu(dataset_root):
    split = os.path.join(str(dataset_root), "images", "train")
    auto = YOLODataset(split, img_size=64, device="cpu")
    plain = YOLODataset(split, img_size=64, device="cpu", decoder="plain")
    assert auto.decoder == plain.decoder == "plain"
    assert plain.decode_with == "plain" and auto.decode_with == "auto"
    for i in range(len(auto)):
        a, b = auto.pull_item(i), plain.pull_item(i)
        assert torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        YOLODataset(split, img_size=64, device="cpu", decoder="nvjpeg")
    with pytest.raises(ValueError, match="decoder must be one of"):
        YOLODataset(split, img_size=64, device="cpu", decoder="cv2")


def test_loader_refuses_nvjpeg_with_workers(dataset_root):
    """The loader reads the option of every part of a dataset: an "nvjpeg"
    part (whose decoder the card alone runs; its option set by hand here)
    with spawned workers raises before anything starts."""
    split = os.path.join(str(dataset_root), "images", "train")
    ds = YOLODataset(split, img_size=64, device="cpu")
    ds.decode_with = "nvjpeg"
    for data in (ds, ConcatDataset([YOLODataset(split, img_size=64, device="cpu"), ds])):
        with pytest.raises(ValueError, match="'nvjpeg'"):
            TrainLoader(data, 4, img_size=64, num_workers=2)
        TrainLoader(data, 4, img_size=64, num_workers=0).close()
