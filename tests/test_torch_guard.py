"""The port stands alone: no JAX, Flax, vision_kit_tpu, OpenCV (cv2) or PIL
import in its sources or in chip_smoke.py (the card's machine has neither
OpenCV nor PIL, so such an import would fail only there), and importing
and running it loads none of them.

Comments may name a JAX counterpart by file path (vision_kit_tpu/ops/...);
a dotted module name of the JAX package, which an import would need, may not
appear at all."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|msgpack|cv2|PIL|orbax|tensorstore|zstandard"
    r"|vision_kit_tpu(?!_torch))\b", re.M)
# a quoted module name, as importlib and __import__ take it; a docstring
# may begin with a cv2 function's name ("""cv2.warpAffine ...)
DOTTED = re.compile(r"\bvision_kit_tpu\.|[\"']vision_kit_tpu[\"']|[\"'](jax|flax)[\"'.]"
                    r"|[\"']cv2[\"']|[\"']PIL[\"'.]"
                    r"|[\"'](orbax\.checkpoint|tensorstore|zstandard)[\"']")


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
    names = {os.path.relpath(p, REPO) for p in sources}
    assert {"vision_kit_tpu_torch/parallel/mesh.py",
            "vision_kit_tpu_torch/parallel/distributed.py"} <= names
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
    # flax's msgpack format is read and written by the port's own code
    # (an artifact named "msgpack" is no import: the module check below)
    assert FORBIDDEN.search("import msgpack")
    assert FORBIDDEN.search("    from msgpack import packb")
    assert not FORBIDDEN.search("from vision_kit_tpu_torch.utils import flax_msgpack")


def test_forbidden_pattern_catches_the_checkpoint_libraries():
    """orbax's checkpoints are read and written by the port's own code
    (utils/zstd.py, utils/ocdbt.py, utils/orbax.py)."""
    assert FORBIDDEN.search("import orbax.checkpoint as ocp")
    assert FORBIDDEN.search("    import tensorstore as ts")
    assert FORBIDDEN.search("import zstandard")
    assert DOTTED.search('importlib.import_module("orbax.checkpoint")')
    assert not FORBIDDEN.search("from vision_kit_tpu_torch.utils import orbax, zstd")
    assert not DOTTED.search("# an orbax checkpoint's zstd chunks")
    assert not DOTTED.search('timed("orbax", phase_orbax, smi)')


def test_forbidden_pattern_catches_opencv_and_pil():
    assert FORBIDDEN.search("import cv2")
    assert FORBIDDEN.search("    import cv2  # in a function")
    assert FORBIDDEN.search("from PIL import Image")
    assert FORBIDDEN.search("import PIL.Image")
    assert DOTTED.search('importlib.import_module("cv2")')
    assert DOTTED.search("__import__('PIL.Image')")
    assert not FORBIDDEN.search("# cv2.warpAffine's counterpart")
    assert not DOTTED.search('"""cv2.warpAffine of an (H, W, C) uint8 tensor"""')
    assert not FORBIDDEN.search("from vision_kit_tpu_torch.ops import imgproc")


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
        "from vision_kit_tpu_torch.utils import orbax\n"
        "t = orbax.read_checkpoint('vision_kit_tpu_torch/data/checkpoint_samples/orbax_ocdbt')\n"
        "assert int(t['step']) == 5\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'vision_kit_tpu', 'cv2', 'PIL', 'orbax', "
        "'tensorstore', 'zstandard')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
