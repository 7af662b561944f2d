"""The port stands alone: no JAX, Flax or vision_kit_tpu import in its
sources or in chip_smoke.py, and importing and running it loads no jax.

Comments may name a JAX counterpart by file path (vision_kit_tpu/ops/...);
a dotted module name of the JAX package, which an import would need, may not
appear at all."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|vision_kit_tpu(?!_torch))\b", re.M)
DOTTED = re.compile(r"\bvision_kit_tpu\.|[\"']vision_kit_tpu[\"']|[\"'](jax|flax)[\"'.]")


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    pkg = os.path.join(REPO, "vision_kit_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def test_sources_import_no_jax_flax_or_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not FORBIDDEN.search(text), path
        assert not DOTTED.search(text), path


def test_forbidden_pattern_catches_the_jax_package():
    assert FORBIDDEN.search("from vision_kit_tpu.ops import nms")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from vision_kit_tpu_torch.ops import nms")
    assert DOTTED.search('importlib.import_module("vision_kit_tpu.ops.nms")')
    assert DOTTED.search("__import__('jax')")
    assert not DOTTED.search("# counterpart of vision_kit_tpu/ops/nms.py")


def test_port_runs_without_loading_jax():
    code = (
        "import sys, importlib, pkgutil, torch\n"
        "torch.set_num_threads(2)\n"
        "import vision_kit_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from vision_kit_tpu_torch.models import YOLOV5\n"
        "m = YOLOV5('n').eval()\n"
        "with torch.no_grad():\n"
        "    d, r = m(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))\n"
        "assert d.shape == (1, 252, 85)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vision_kit_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
