"""The port's train and eval commands (python -m vision_kit_tpu_torch) on
the CPU, as a subprocess on the rectangle set at v5n@64: train exits 0,
honours the config's data.seed, logs mAP@.5 and writes its run directory
(log.log, ckpts/, the best weights); eval -d reads the result. The
repo's default config, configs/yolov5.yaml (no data.device_aug: the
host-augmentation route, spawned workers, bf16), trains too. Without
--device cpu, and with no card, both raise. Under torchrun (python -m
torch.distributed.run, two processes over gloo) train runs data-parallel:
one run directory, written by rank 0.
"""

import glob
import os
import subprocess
import sys

import pytest
import torch
import yaml

from fixture_lib import build_rectangle_dataset
from vision_kit_tpu_torch import __main__ as cli
from vision_kit_tpu_torch.utils import orbax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_cfg(path, ds, out, seed=None):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "yolov5_tpu.yaml")))
    cfg["model"].update(version="n", num_classes=2, input_size=[64, 64], weight="",
                        precision="fp32")
    cfg["data"].update(data_dir=ds, output_dir=out, train_path="images/train",
                       val_path="images/val", test_path="images/val", batch_size=4,
                       max_epochs=1, class_labels=["red", "green"])
    if seed is not None:
        cfg["data"]["seed"] = seed
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)


def run_cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2", COLUMNS="200")
    return subprocess.run([sys.executable, "-m", "vision_kit_tpu_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def test_train_then_eval_on_the_cpu(tmp_path):
    ds, out = str(tmp_path / "ds"), str(tmp_path / "out")
    build_rectangle_dataset(ds)
    cfg = str(tmp_path / "cfg.yaml")
    write_cfg(cfg, ds, out, seed=7)
    r = run_cli("train", "-c", cfg, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    runs = glob.glob(os.path.join(out, "YOLOv5", "train", "*"))
    assert len(runs) == 1
    run = runs[0]
    log = open(os.path.join(run, "log.log")).read()
    assert "Global seed set to 7" in log
    assert "mAP@.5" in log and "Average Precision" in log
    assert orbax.is_checkpoint(os.path.join(run, "ckpts", "last"))
    assert os.path.exists(os.path.join(run, "ckpts", "last.meta.json"))
    assert glob.glob(os.path.join(run, "weights", "best-map50_*.msgpack"))
    assert os.path.exists(os.path.join(run, "train.jpg"))

    r = run_cli("eval", "-c", cfg, "-d", os.path.join(run, "ckpts"), "--device", "cpu",
                "-s", "3")
    assert r.returncode == 0, r.stderr[-3000:]
    evals = glob.glob(os.path.join(out, "YOLOv5", "eval", "*", "log.log"))
    assert len(evals) == 1
    log = open(evals[0]).read()
    assert "Global seed set to 3" in log and "mAP@.5" in log


def test_train_under_torchrun_on_the_cpu(tmp_path):
    """torchrun --nproc_per_node 2 -m vision_kit_tpu_torch train --device cpu:
    both ranks join (init_distributed reads torchrun's variables), train one
    epoch of the global batch 4 and test; rank 0 alone names the run
    directory and writes the log, the checkpoints and the grid."""
    ds, out = str(tmp_path / "ds"), str(tmp_path / "out")
    build_rectangle_dataset(ds)
    cfg = str(tmp_path / "cfg.yaml")
    write_cfg(cfg, ds, out, seed=7)
    env = dict(os.environ, OMP_NUM_THREADS="1", COLUMNS="200")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "2", "-m", "vision_kit_tpu_torch", "train",
                        "-c", cfg, "--device", "cpu"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    runs = glob.glob(os.path.join(out, "YOLOv5", "train", "*"))
    assert len(runs) == 1
    log = open(os.path.join(runs[0], "log.log")).read()
    assert "mAP@.5" in log and log.count("Start Training") == 1
    assert orbax.is_checkpoint(os.path.join(runs[0], "ckpts", "last"))
    for path in ("ckpts/last.meta.json", "train.jpg"):
        assert os.path.exists(os.path.join(runs[0], path)), path


def test_train_default_config_on_the_cpu(tmp_path):
    """configs/yolov5.yaml with its model cut to v5n@64 and 2 classes, its
    data and output paths on the rectangle set, 1 epoch of batch 4 and 2
    of its 8 workers: the host-augmentation route trains and tests."""
    ds, out = str(tmp_path / "ds"), str(tmp_path / "out")
    build_rectangle_dataset(ds)
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs", "yolov5.yaml")))
    assert "device_aug" not in cfg["data"]
    cfg["model"].update(version="n", num_classes=2, input_size=[64, 64], weight="")
    cfg["data"].update(data_dir=ds, output_dir=out, train_path="images/train",
                       val_path="images/val", test_path="images/val", batch_size=4,
                       max_epochs=1, num_workers=2, class_labels=["red", "green"])
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    r = run_cli("train", "-c", path, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    logs = glob.glob(os.path.join(out, "YOLOv5", "train", "*", "log.log"))
    assert len(logs) == 1
    log = open(logs[0]).read()
    assert "epoch 1/1 loss" in log and "mAP@.5" in log and "device_aug" not in log
    assert os.path.exists(os.path.join(os.path.dirname(logs[0]), "train.jpg"))


@pytest.mark.parametrize("task", ["train", "eval"])
def test_the_card_is_the_default(tmp_path, task):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    cfg = str(tmp_path / "cfg.yaml")
    write_cfg(cfg, str(tmp_path / "ds"), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([task, "-c", cfg])
    assert not os.path.exists(str(tmp_path / "out"))
