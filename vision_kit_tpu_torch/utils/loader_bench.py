"""Loader throughput and the card's loaders against the plain ones.

Counterpart of tools/bench_trainloader.py and tools/bench_valloader.py. On
a YOLO dataset (write_dataset's, by default):

- the device-augmentation TrainLoader's batches a second, uncached (every
  tile decoded: nvJPEG on the card) and from the RAM cache, each with its
  prefetch thread, and the ms of one batch built alone on the caller's
  thread (_make_batch, synchronised);
- the host-augmentation TrainLoader (configs/yolov5.yaml's route, with
  degrees and shear), uncached, at batch 8 and --batch: its batches a
  second with its prefetch thread (the warp on the dataset's device) and
  the ms of one batch alone, and with `workers` spawned workers (on the
  host) in the steady state (host_route_rates);
- ValLoader's images a second over the val split, uncached.

    python -m vision_kit_tpu_torch.utils.loader_bench [--train 128] [--val 64]
        [--batch 64] [--size 640] [--batches 4] [--workers 8] [--device cuda]
        [--json PATH]

write_dataset also makes the YOLO dataset that chip_smoke.py trains on: the
committed samples (data/samples/) copied under several names, and seeded
rectangle scenes written as PNGs, with seeded labels; the truncated 240x320
samples go into the train split once each, for the integrity scan to
restore (restore_disagreements holds them to the bytes the JAX package
writes; png_only: scenes alone, nothing truncated). loader_disagreements
holds a card dataset's device-route TrainLoader and ValLoader batches
against a CPU dataset's; host_loader_disagreements its host-route batches;
imgproc_disagreements each ops/imgproc.py op on the card against the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from vision_kit_tpu_torch.data.decode import (
    decode_route,
    encode_png,
    pixel_agreement,
    within_nvjpeg_tolerance,
)

SCENE_HW = ((480, 640), (720, 1280), (512, 384))
SCENE_COLORS = ((220, 40, 40), (40, 200, 60))   # class 0, class 1
# configs/yolov5.yaml's augmentations with rotation and shear on, as
# chip_smoke's fit-host phase trains
HOST_AUG = {"degrees": 5.0, "translate": 0.1, "shear": 2.0, "flip_ud_prob": 0.0,
            "flip_lr_prob": 0.5, "mosaic_prob": 1.0, "mixup_prob": 1.0, "hsv_prob": 1.0,
            "mosaic_scale": (0.5, 1.5), "mixup_scale": (0.5, 1.5), "enable_mixup": False,
            "enable_mosaic": True}


def _scene(rng, hw) -> tuple[np.ndarray, list[str]]:
    """A gradient background with 1-4 filled rectangles of two classes, and
    their YOLO label lines."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.integers(40, 160, 3)
    img = (base + 40 * np.stack([yy / h, xx / w, (yy + xx) / (h + w)], -1)).astype(np.uint8)
    lines = []
    for _ in range(int(rng.integers(1, 5))):
        bw, bh = int(rng.integers(w // 10, w // 3)), int(rng.integers(h // 10, h // 3))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        c = int(rng.integers(0, 2))
        img[y:y + bh, x:x + bw] = SCENE_COLORS[c]
        lines.append(f"{c} {(x + bw / 2) / w:.6f} {(y + bh / 2) / h:.6f} "
                     f"{bw / w:.6f} {bh / h:.6f}")
    return img, lines


# the WebP samples the train split holds: the plain decoder takes a quarter
# of a second over each, in every dataset built on the files (the serve
# phase checks every WebP sample by its hash)
DATASET_WEBPS = ("lossless_120x160.webp", "lossy_240x320.webp")


def write_dataset(root: str, n_train: int = 128, n_val: int = 64, seed: int = 0,
                  png_only: bool = False) -> dict:
    """A YOLO dataset under root/{train,valid}/{images,labels}: even
    indices are the committed samples the decoders take, in turn
    (progressive, CMYK/YCCK/RGB JPEGs, JPEGs without Huffman tables and
    BMPs among them; of the WebPs, the two of DATASET_WEBPS, once each at
    the head of the train split), with 1-3 seeded boxes; odd ones rectangle
    scenes written as PNGs, labelled by their rectangles. The train split
    also holds the truncated 240x320 samples, which the integrity scan
    restores in place. With png_only every index is a scene and nothing
    is truncated. Returns {"train": n, "valid": n, "restored": {file name:
    the sha256 its restore must have (the manifest's restored_sha256)}}."""
    from vision_kit_tpu_torch.utils.serve_bench import samples

    rng = np.random.default_rng(seed)
    taken = [(name, data) for name, meta, data in samples()   # the datasets' IMG_EXTS
             if meta["shape"] and meta["kind"].startswith(("jpeg", "png", "bmp"))]
    webps = [(name, data) for name, _, data in samples() if name in DATASET_WEBPS]
    truncated = [] if png_only else [
        (name, data, meta["restored_sha256"]) for name, meta, data in samples()
        if meta["kind"] == "jpeg_truncated" and "240x320" in name]
    for split, n in (("train", n_train), ("valid", n_val)):
        img_dir, lbl_dir = (os.path.join(root, split, d) for d in ("images", "labels"))
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        heads = webps if split == "train" else []
        for i in range(n):
            stem = f"{split}{i:04d}"
            if i % 2 == 0 and not png_only:
                k = i // 2
                name, data = heads[k] if k < len(heads) else taken[(k - len(heads)) % len(taken)]
                stem += "_" + os.path.splitext(name)[0]
                ext = os.path.splitext(name)[1]
                lines = [f"{int(rng.integers(0, 2))} {rng.uniform(0.3, 0.7):.6f} "
                         f"{rng.uniform(0.3, 0.7):.6f} {rng.uniform(0.1, 0.5):.6f} "
                         f"{rng.uniform(0.1, 0.5):.6f}" for _ in range(int(rng.integers(1, 4)))]
            else:
                img, lines = _scene(rng, SCENE_HW[(i // 2) % len(SCENE_HW)])
                data, ext = encode_png(img), ".png"
            with open(os.path.join(img_dir, stem + ext), "wb") as f:
                f.write(data)
            with open(os.path.join(lbl_dir, stem + ".txt"), "w") as f:
                f.write("\n".join(lines))
    restored = {}
    for name, data, sha in truncated:
        with open(os.path.join(root, "train", "images", name), "wb") as f:
            f.write(data)
        restored[name] = sha
    return {"train": n_train, "valid": n_val, "restored": restored}


def restore_disagreements(root: str, restored: dict) -> list[str]:
    """Each of write_dataset's truncated files that the scan did not rewrite
    to its manifest's restored_sha256 (the JAX package's _check_img's
    bytes): empty when every restore agrees."""
    import hashlib

    bad = []
    for name, sha in restored.items():
        with open(os.path.join(root, "train", "images", name), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != sha:
            bad.append(f"{name}: restored to {got[:12]}, JAX's {sha[:12]}")
    return bad


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loader_rate(dataset, batch: int, size: int, n_batches: int, seed: int = 0,
                      aug: dict | None = None, device_aug: bool = True) -> dict:
    """{"img_s": the TrainLoader's images a second over n_batches after two
    warm batches (median gap, with its prefetch thread), "batch_ms": the ms
    of one batch built alone on this thread}."""
    from vision_kit_tpu_torch.data.loader import TrainLoader

    loader = TrainLoader(dataset, batch, img_size=size, aug_cfg=aug, seed=seed,
                         device_aug=device_aug)
    dev = loader.device
    try:
        it = iter(loader)
        next(it)
        next(it)
        gaps, last = [], time.perf_counter()
        for _ in range(n_batches):
            next(it)
            _sync(dev)   # the batch's tiles are ready on the consumer's stream
            now = time.perf_counter()
            gaps.append(now - last)
            last = now
    finally:
        loader.close()
    alone = []
    for bid in range(n_batches):
        _sync(dev)
        t0 = time.perf_counter()
        loader._make_batch(1000 + bid)
        _sync(dev)
        alone.append(time.perf_counter() - t0)
    return {"img_s": batch / float(np.median(gaps)),
            "batch_ms": 1e3 * float(np.median(alone))}


def val_loader_rate(dataset, batch: int, size: int) -> float:
    """ValLoader's images a second over the whole dataset (prefetching)."""
    from vision_kit_tpu_torch.data.loader import ValLoader

    loader = ValLoader(dataset, batch, img_size=size)
    t0 = time.perf_counter()
    n = 0
    for b in loader:
        n += b["count"]
    _sync(loader.device)
    return n / (time.perf_counter() - t0)


def worker_rounds(dataset, batch: int, size: int, workers: int, rounds: int,
                  aug: dict | None = None, device_aug: bool = False) -> list[float]:
    """Seconds from iter() to the arrival of each round's last batch, over
    `rounds` rounds of a TrainLoader with `workers` spawned workers: worker
    w makes batches w, w + W, ..., so a round of W batches arrives together
    and takes one worker's time a batch (the first round adds the spawn)."""
    from vision_kit_tpu_torch.data.loader import TrainLoader

    loader = TrainLoader(dataset, batch, img_size=size, aug_cfg=aug, seed=0,
                         device_aug=device_aug, num_workers=workers)
    out = []
    try:
        t0 = time.perf_counter()
        it = iter(loader)
        for _ in range(rounds):
            for _ in range(workers):
                next(it)
            _sync(loader.device)
            out.append(time.perf_counter() - t0)
    finally:
        loader.close()
    return out


def host_route_rates(dataset, batches=(8, 64), size: int = 640, n_batches: int = 2,
                     workers: int = 8) -> dict:
    """The host-augmentation TrainLoader (HOST_AUG) on `dataset` at each
    batch size: with its prefetch thread ("thread": img/s and the ms of a
    batch alone) and with `workers` spawned workers ("workers"). The
    workers' img/s is W * B over a round in the steady state: two rounds
    at the first batch size give the round's time and, by difference, the
    spawn's; a larger batch runs one round (a round of 64-image batches
    costs tens of seconds) less that spawn time, and its img/s is None when
    the spawn's variance leaves no positive time."""
    out, spawn_s = {}, None
    for b in batches:
        rounds = worker_rounds(dataset, b, size, workers, 2 if spawn_s is None else 1,
                               aug=HOST_AUG)
        if spawn_s is None:
            round_s = rounds[1] - rounds[0]
            spawn_s = rounds[0] - round_s
        else:
            round_s = rounds[0] - spawn_s
        out[b] = {"thread": train_loader_rate(dataset, b, size, n_batches, aug=HOST_AUG,
                                              device_aug=False),
                  "workers": {"img_s": workers * b / round_s if round_s > 0 else None,
                              "round_s": round_s, "first_round_s": rounds[0],
                              "spawn_s": spawn_s}}
    return out


def run(data_dir: str, batch: int = 64, size: int = 640, n_batches: int = 4,
        device: str = "cuda", workers: int = 8) -> dict:
    """The loader numbers on `device` (see the module docstring)."""
    from vision_kit_tpu_torch.data.datasets import YOLODataset

    train_dir, val_dir = (os.path.join(data_dir, s) for s in ("train", "valid"))
    out = {"device": str(device), "batch": batch, "size": size}
    t0 = time.perf_counter()
    plain = YOLODataset(train_dir, img_size=size, device=device, cache=False)
    out["scan_s"] = time.perf_counter() - t0
    out["uncached"] = train_loader_rate(plain, batch, size, n_batches)
    out["host_route"] = host_route_rates(plain, (8, batch), size, n_batches, workers)
    t0 = time.perf_counter()
    cached = YOLODataset(train_dir, img_size=size, device=device, cache_images="ram")
    _sync(cached.device)
    out["ram_cache_build_s"] = time.perf_counter() - t0
    out["ram_cache"] = train_loader_rate(cached, batch, size, n_batches)
    out["val_img_s"] = val_loader_rate(YOLODataset(val_dir, img_size=size, device=device),
                                       batch, size)
    return out


def _tile_sources(loader, batch_id: int) -> list[list[int]]:
    """The dataset index behind each tile slot of batch `batch_id`: the
    planner's draws replayed (plan has no side effect but its label-count
    memo)."""
    out = []
    for k in range(loader.batch_size):
        sid = batch_id * loader.batch_size + k
        rng = np.random.default_rng([loader.seed, 77, sid])
        out.append(loader.planner.plan(rng, loader.index_stream.at(sid))[0])
    return out


def _image_disagreement(got: torch.Tensor, want: torch.Tensor, path: str) -> str | None:
    """Pixels bit-equal where the card decodes on the host (decode_route:
    PNG, BMP, CMYK/YCCK/RGB JPEG, a progressive JPEG that ends early),
    within decode.NVJPEG_TOLERANCE where nvJPEG decodes."""
    if got.shape != want.shape:
        return f"shape {tuple(got.shape)} != {tuple(want.shape)}"
    with open(path, "rb") as f:
        route = decode_route(f.read(), "cuda")
    if not route.startswith("nvjpeg"):
        return None if torch.equal(got.cpu(), want.cpu()) else f"{route} pixels differ"
    agreement = pixel_agreement(got, want.cpu().numpy())
    return None if within_nvjpeg_tolerance(agreement) else f"JPEG pixels {agreement}"


def loader_disagreements(card_ds, plain_ds, batch: int, size: int, seed: int = 0,
                         n_batches: int = 2, aug: dict | None = None) -> list[str]:
    """A card dataset's TrainLoader and ValLoader against a CPU dataset's
    over the same files: params, tile_hw, targets and ValLoader infos
    exactly equal; each tile's valid region (and the letterboxed val
    images) bit-equal for a PNG and within decode.NVJPEG_TOLERANCE for a
    JPEG. Returns the disagreements, empty when they agree."""
    from vision_kit_tpu_torch.data.loader import TrainLoader, ValLoader

    out = []
    if card_ds.img_files != plain_ds.img_files:
        return ["the datasets hold other files"]
    loaders = [TrainLoader(ds, batch, img_size=size, aug_cfg=aug, seed=seed, prefetch=1,
                           device_aug=True) for ds in (card_ds, plain_ds)]
    try:
        its = [iter(lo) for lo in loaders]
        for bid in range(n_batches):
            got, want = next(its[0]), next(its[1])
            for key in ("params", "tile_hw", "targets"):
                if not np.array_equal(got[key], want[key]):
                    out.append(f"train batch {bid}: {key} differ")
            for k, srcs in enumerate(_tile_sources(loaders[1], bid)):
                for t, idx in enumerate(srcs):
                    h, w = (int(v) for v in want["tile_hw"][k, t])
                    if not h:
                        continue   # planned but unused (a mixup on no labels)
                    bad = _image_disagreement(got["tiles"][k, t, :h, :w],
                                              want["tiles"][k, t, :h, :w],
                                              plain_ds.img_files[idx])
                    if bad:
                        out.append(f"train batch {bid} sample {k} tile {t}: {bad}")
    finally:
        for lo in loaders:
            lo.close()
    vals = [ValLoader(ds, batch, img_size=size) for ds in (card_ds, plain_ds)]
    for bid, (got, want) in enumerate(zip(*vals)):
        if got["info"] != want["info"] or got["count"] != want["count"]:
            out.append(f"val batch {bid}: info or count differ")
        if not np.array_equal(got["targets"], want["targets"]):
            out.append(f"val batch {bid}: targets differ")
        for k in range(want["count"]):
            idx = bid * batch + k
            bad = _image_disagreement(got["image"][k], want["image"][k],
                                      plain_ds.img_files[idx])
            if bad:
                out.append(f"val batch {bid} image {k}: {bad}")
        if bid + 1 >= n_batches:
            break
    return out


def _scene_image(rng, h: int, w: int) -> np.ndarray:
    """Gradients, seeded noise and flat rectangles: every level, flat runs
    and edges, for the filters and the warp."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 255 // (h - 1), xx * 255 // (w - 1), (yy + xx) * 127 // (h + w - 2)],
                   -1) + rng.integers(-24, 25, (h, w, 3))
    for _ in range(6):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y:y + h // 5, x:x + w // 5] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def imgproc_disagreements(device, sizes=(640, 1280), seed: int = 0) -> list[str]:
    """Each op of the host route (ops/imgproc.py, through data/augment.py
    where it draws its parameters) on `device` against the CPU, bit for
    bit, on a seeded S x S image per size: the warp under rotation, shear
    and translation (to 640 x 640), HSV at three gain draws, blur and
    median at ksize 3, 5 and 7, gray, RGB2Lab, CLAHE, Lab2RGB, the pad.
    Returns the ops that differ, empty when all agree."""
    from vision_kit_tpu_torch.data import augment
    from vision_kit_tpu_torch.ops import imgproc

    rng = np.random.default_rng(seed)
    out = []
    for size in sizes:
        host = torch.from_numpy(_scene_image(rng, size, size))
        card = host.to(device)
        labels = np.zeros((0, 5), np.float32)
        ops = {}
        for k in range(3):
            draw = int(rng.integers(1 << 30))
            ops[f"warp {k}"] = lambda x, d=draw: augment.random_affine(
                np.random.default_rng(d), x, labels, (640, 640), degrees=10.0,
                translate=0.1, scales=(0.5, 1.5), shear=5.0)[0]
            ops[f"hsv {k}"] = lambda x, d=draw: augment.augment_hsv(np.random.default_rng(d), x)
        for k in (3, 5, 7):
            ops[f"blur {k}"] = lambda x, k=k: imgproc.blur_u8(x, (k, k))
            ops[f"median {k}"] = lambda x, k=k: imgproc.median_blur_u8(x, k)
        ops["gray"] = lambda x: imgproc.gray2rgb_u8(imgproc.rgb2gray_u8(x))
        ops["lab"] = imgproc.rgb2lab_u8
        ops["clahe"] = lambda x: imgproc.clahe_u8(x[..., 0].contiguous())
        ops["lab2rgb"] = imgproc.lab2rgb_u8
        ops["pad"] = lambda x: augment.pad_to(x[: size // 2], labels, (size, size + 8))[0]
        for name, op in ops.items():
            got, want = op(card), op(host)
            if got.device.type != card.device.type:
                out.append(f"{name} at {size}: ran on {got.device}")
            elif not torch.equal(got.cpu(), want):
                n = int((got.cpu() != want).sum())
                out.append(f"{name} at {size}: {n} of {want.numel()} values differ")
    return out


def host_loader_disagreements(card_ds, plain_ds, batch: int, size: int, seed: int = 0,
                              n_batches: int = 2, aug: dict | None = None) -> list[str]:
    """The host-augmentation TrainLoader over a card dataset (num_workers
    0: every op on the card) against the same files on the CPU: images and
    targets bit-equal (the datasets must decode alike: PNGs). Returns the
    disagreements, empty when they agree."""
    from vision_kit_tpu_torch.data.loader import TrainLoader

    if card_ds.img_files != plain_ds.img_files:
        return ["the datasets hold other files"]
    out = []
    loaders = [TrainLoader(ds, batch, img_size=size, aug_cfg=aug, seed=seed, prefetch=1)
               for ds in (card_ds, plain_ds)]
    try:
        its = [iter(lo) for lo in loaders]
        for bid in range(n_batches):
            got, want = next(its[0]), next(its[1])
            if got["image"].device.type != card_ds.device.type:
                out.append(f"batch {bid}: images on {got['image'].device}")
            if not np.array_equal(got["targets"], want["targets"]):
                out.append(f"batch {bid}: targets differ")
            if not torch.equal(got["image"].cpu(), want["image"]):
                n = int((got["image"].cpu() != want["image"]).sum())
                out.append(f"batch {bid}: {n} pixel values differ")
    finally:
        for lo in loaders:
            lo.close()
    return out


def workers_disagreements(dataset, batch: int, size: int, workers: int = 8,
                          seed: int = 0, n_batches: int = 2, aug: dict | None = None,
                          device_aug: bool = False) -> list[str]:
    """A TrainLoader over `dataset` with num_workers 0 (every op on the
    dataset's device) against the same loader with `workers` spawned
    workers (decode and augmentation on the host): the batches' bytes equal
    (images or tiles, targets, and the device route's params and tile
    sizes). A card dataset must decode with decoder "plain" for them to.
    Returns the disagreements, empty when they agree."""
    from vision_kit_tpu_torch.data.loader import TrainLoader

    out = []
    loaders = [TrainLoader(dataset, batch, img_size=size, aug_cfg=aug, seed=seed,
                           num_workers=w, device_aug=device_aug)
               for w in (0, workers)]
    try:
        its = [iter(lo) for lo in loaders]
        for bid in range(n_batches):
            got, want = next(its[0]), next(its[1])
            for key in sorted(want):
                a, b = got[key], want[key]
                if isinstance(a, torch.Tensor):
                    if a.device != b.device:
                        out.append(f"batch {bid}: {key} on {a.device} and {b.device}")
                    same = torch.equal(a.cpu(), b.cpu())
                else:
                    same = np.array_equal(np.asarray(a), np.asarray(b))
                if not same:
                    out.append(f"batch {bid}: {key} differs")
    finally:
        for lo in loaders:
            lo.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", help="a YOLO dataset with train/ and valid/ "
                    "(default: write_dataset's, in a temporary directory)")
    ap.add_argument("--train", type=int, default=128)
    ap.add_argument("--val", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--workers", type=int, default=8,
                    help="spawned workers of the host route's second rate")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the numbers here too")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = args.data_dir
        if data_dir is None:
            data_dir = tmp
            write_dataset(tmp, args.train, args.val)
        rec = run(data_dir, args.batch, args.size, args.batches, args.device, args.workers)
    print(json.dumps(rec))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
