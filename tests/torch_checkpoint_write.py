"""Where utils/orbax.py:write_checkpoint's time goes on this machine: a
v5s@640 TrainState (80 classes, 87 MB) as the JAX Trainer's tree, written
to a temporary directory three times; the filesystem of / and /tmp (from
/proc/mounts); a copy and a removal of the directory; a cProfile of one
write; torch.save of three copies of the parameters (86.9 MB) in one
file; the 762 leaves as one directory and two files each (the plain
layout's file count), in one thread and in eight; and the leaves' bytes
in one file. Nothing of it needs a card:

    python tests/torch_checkpoint_write.py
"""
import cProfile
import concurrent.futures as cf
import os
import pstats
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

if __name__ == "__main__":
    import numpy as np
    import torch

    from vision_kit_tpu_torch.convert import jax_train_state_tree
    from vision_kit_tpu_torch.models import YOLOV5
    from vision_kit_tpu_torch.train import optim
    from vision_kit_tpu_torch.train.step import create_train_state
    from vision_kit_tpu_torch.utils import orbax, zstd
    from vision_kit_tpu_torch.utils.stream_bench import TRAIN_HYP

    tmp = tempfile.mkdtemp()
    print("tmp", tmp, flush=True)
    with open("/proc/mounts") as f:
        for line in f:
            if " / " in line or "/tmp" in line:
                print("mount", line.strip(), flush=True)
    m = YOLOV5(variant="s", num_classes=80)
    st = create_train_state(m, optim.make_optimizer(m, TRAIN_HYP, 10, 10))
    t = time.perf_counter(); tree = jax_train_state_tree(st)
    print(f"snapshot (CPU state) {time.perf_counter() - t:.3f} s", flush=True)
    for i in range(3):
        t = time.perf_counter(); orbax.write_checkpoint(os.path.join(tmp, "a"), tree)
        print(f"write_checkpoint #{i} {time.perf_counter() - t:.3f} s", flush=True)
    t = time.perf_counter(); shutil.copytree(os.path.join(tmp, "a"), os.path.join(tmp, "c"))
    print(f"copytree {time.perf_counter() - t:.3f} s", flush=True)
    t = time.perf_counter(); shutil.rmtree(os.path.join(tmp, "c"))
    print(f"rmtree {time.perf_counter() - t:.3f} s", flush=True)
    cProfile.run('orbax.write_checkpoint(os.path.join(tmp, "a"), tree)', os.path.join(tmp, "p"))
    pstats.Stats(os.path.join(tmp, "p")).sort_stats("tottime").print_stats(14)
    sd = {k: v.detach().clone() for k, v in st.params.items()}
    big = {"p": sd, "m": {k: v.clone() for k, v in sd.items()},
           "e": {k: v.clone() for k, v in sd.items()}}
    t = time.perf_counter(); torch.save(big, os.path.join(tmp, "x.pt"))
    print(f"torch.save of 3 x params {time.perf_counter() - t:.3f} s, "
          f"{os.path.getsize(os.path.join(tmp, 'x.pt')) / 1e6:.1f} MB", flush=True)
    # many small files alone, and in 8 threads
    leaves = [(k, np.asarray(v)) for k, v in orbax._leaves(tree) if hasattr(v, "shape")]
    def one(item, root):
        i, (k, arr) = item
        d = os.path.join(root, str(i))
        os.makedirs(d)
        with open(os.path.join(d, ".zarray"), "w") as f:
            f.write("{}")
        with open(os.path.join(d, "0"), "wb") as f:
            f.write(zstd.raw_frame(arr.tobytes()))
    for threads in (1, 8):
        root = os.path.join(tmp, f"t{threads}")
        os.makedirs(root)
        t = time.perf_counter()
        if threads == 1:
            for item in enumerate(leaves):
                one(item, root)
        else:
            with cf.ThreadPoolExecutor(threads) as ex:
                list(ex.map(lambda it: one(it, root), enumerate(leaves)))
        print(f"{len(leaves)} leaves as files, {threads} thread(s): "
              f"{time.perf_counter() - t:.3f} s", flush=True)
    t = time.perf_counter()
    with open(os.path.join(tmp, "one.bin"), "wb") as f:
        for _, arr in leaves:
            f.write(arr.tobytes())
    print(f"the same bytes in one file {time.perf_counter() - t:.3f} s", flush=True)
    shutil.rmtree(tmp)
