"""Input pipeline: seeded infinite sampling, fixed-shape batches, prefetch.

Counterpart of vision_kit_tpu/data/loader.py. The index stream is the JAX
package's (per-epoch permutations from default_rng([seed, epoch]), strided
over shards), and each batch is a pure function of its batch id (a
sample's augmentation draws from default_rng([seed, 77, key]), the key its
row in the global batch: _SampleIds), so a resume at step s only needs
seek(s), and with one shard the batches equal JAX's for one seed.

TrainLoader takes one of two routes. The host-augmentation route
(device_aug=False, the default) builds each sample as the JAX package does:
mosaic and mixup (data/mosaic.py), the affine warp, HSV, pixel augs, flips
and pad (data/augment.py), through ops/imgproc.py's cv2-exact ops on the
dataset's device, and yields the finished (B, S, S, 3) images. The
device-augmentation route (device_aug=True) draws each sample's parameters
and labels on the host (data/device_aug.py:DeviceAugPlanner), gathers the
tiles where the dataset decodes them, and leaves the pixel warp to the
training step (make_train_step(device_aug=True)). With a dataset on the
card either route's pixels are made on the card, on the prefetch thread's
own stream; an event recorded after them travels with the batch, and the
consumer's stream waits on it, so no pixel crosses the bus. Spawned
workers (num_workers > 0) never touch CUDA: they decode and augment on the
host with a CPU copy of the dataset and ship numpy pixels, which the
consumer uploads. A batch is the same for any worker count, and on the
CPU equals JAX's bit for bit.

ValLoader yields letterboxed images (ops/letterbox.py:letterbox_u8 on the
dataset's device), padded targets, and the info each image needs to map
detections back to its original frame.
"""

from __future__ import annotations

import queue
import threading
import traceback
from functools import partial
from typing import Iterator

import numpy as np
import torch

from vision_kit_tpu_torch import _malloc
from vision_kit_tpu_torch.data.augment import TrainAugPipeline, ValAugPipeline
from vision_kit_tpu_torch.data.device_aug import N_PARAMS, DeviceAugPlanner
from vision_kit_tpu_torch.data.mosaic import MosaicMixupDataset
from vision_kit_tpu_torch.utils.logging_utils import logger

MAX_LABELS = 160


class _IndexStream:
    """Random-access view of the infinite_indices stream: position p ->
    dataset index, computable from any worker without consuming a shared
    iterator (epoch permutations are recomputed and cached per epoch)."""

    def __init__(self, n, seed=0, shard=0, num_shards=1, shuffle=True):
        self.n, self.seed = n, seed
        self.shard, self.num_shards, self.shuffle = shard, num_shards, shuffle
        self.shard_len = len(range(shard, n, num_shards))
        if self.shard_len == 0:
            raise ValueError(f"shard {shard}/{num_shards} is empty: dataset has only "
                             f"{n} samples — fewer than the shard count")
        self._epoch = -1
        self._slice = None

    def at(self, p: int) -> int:
        epoch, off = divmod(p, self.shard_len)
        if epoch != self._epoch:
            if self.shuffle:
                perm = np.random.default_rng([self.seed, epoch]).permutation(self.n)
            else:
                perm = np.arange(self.n)
            self._slice = perm[self.shard::self.num_shards]
            self._epoch = epoch
        return int(self._slice[off])


def pad_targets(labels_list, img_hw, max_labels=MAX_LABELS):
    """abs-xyxy+cls label arrays -> (B, M, 5) [cls, cxn, cyn, wn, hn],
    padded with cls = -1."""
    b = len(labels_list)
    h, w = img_hw
    out = np.full((b, max_labels, 5), -1, np.float32)
    for i, lab in enumerate(labels_list):
        n = min(len(lab), max_labels)
        if n == 0:
            continue
        lab = lab[:n]
        out[i, :n, 0] = lab[:, 4]
        out[i, :n, 1] = (lab[:, 0] + lab[:, 2]) / 2 / w
        out[i, :n, 2] = (lab[:, 1] + lab[:, 3]) / 2 / h
        out[i, :n, 3] = (lab[:, 2] - lab[:, 0]) / w
        out[i, :n, 4] = (lab[:, 3] - lab[:, 1]) / h
    return out


def infinite_indices(n: int, seed: int = 0, shard: int = 0, num_shards: int = 1,
                     shuffle=True) -> Iterator[int]:
    """Seeded infinite index stream, strided over shards."""
    stream = _IndexStream(n, seed=seed, shard=shard, num_shards=num_shards,
                          shuffle=shuffle)
    p = 0
    while True:
        yield stream.at(p)
        p += 1


def dataset_device(dataset) -> torch.device:
    """The device a dataset decodes to (a ConcatDataset's first part's)."""
    parts = getattr(dataset, "datasets", None)
    return dataset_device(parts[0]) if parts else getattr(
        dataset, "device", torch.device("cpu"))


def dataset_decoders(dataset) -> set:
    """The decoder options ("auto", "plain", "nvjpeg") of a dataset and of
    every part of a ConcatDataset."""
    parts = getattr(dataset, "datasets", None)
    if parts:
        return set().union(*(dataset_decoders(p) for p in parts))
    return {getattr(dataset, "decode_with", "auto")}


def _side_stream(device: torch.device):
    """A stream for a prefetch thread on the card (None on the CPU), ordered
    after the work the caller has queued so far: a RAM cache built on the
    caller's stream is complete before the thread reads it."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def _on_stream(stream, make):
    """make() on `stream` (None: the current one), and the event recorded
    after it on the card (None on the CPU)."""
    if stream is None:
        return make(), None
    with torch.cuda.stream(stream):
        out = make()
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


def _await(tensor: torch.Tensor, ready) -> None:
    """Make the consumer's current stream wait for a batch made on another
    stream, and keep the allocator from reusing its memory before the
    consumer's work on it is done."""
    if ready is not None:
        stream = torch.cuda.current_stream(tensor.device)
        stream.wait_event(ready)
        tensor.record_stream(stream)


class TrainLoader:
    """Infinite training batches.

    device_aug=False (the host-augmentation route) yields {"image": (B, S,
    S, 3) uint8 tensor on the dataset's device, "targets": (B, M, 5)
    float32 numpy}: make_train_step's plain batch. device_aug=True yields
    {"tiles": (B, T, S, S, 3) uint8 tensor on the dataset's device,
    "tile_hw": (B, T, 2) int32, "params": (B, N_PARAMS) float32, "targets"}
    (numpy but the tiles), with T = 5 with mixup, else 4:
    make_train_step(device_aug=True)'s batch."""

    def __init__(self, dataset, batch_size: int, img_size=(640, 640),
                 aug_cfg: dict | None = None, seed: int = 21, shard: int = 0,
                 num_shards: int = 1, max_labels: int = MAX_LABELS,
                 prefetch: int = 3, no_aug: bool = False, num_workers: int = 0,
                 device_aug: bool = False):
        aug = dict(aug_cfg or {})
        self.dataset = dataset
        self.img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.batch_size = batch_size
        self.max_labels = max_labels
        self.seed = seed
        self.no_aug = no_aug
        self.index_stream = _IndexStream(len(dataset), seed=seed, shard=shard,
                                         num_shards=num_shards)
        self.steps_per_epoch = max(len(dataset) // (batch_size * num_shards), 1)
        # the key of a sample's draws is its row in the global batch
        # (batch_size is the shard's share), so shards draw apart
        self._sid = _SampleIds(batch_size, shard, num_shards)
        self.device_aug = bool(device_aug)
        geometry = dict(
            mosaic_prob=float(aug.get("mosaic_prob", 1.0)),
            mixup_prob=float(aug.get("mixup_prob", 1.0)),
            degrees=float(aug.get("degrees", 0.0)),
            translate=float(aug.get("translate", 0.1)),
            mosaic_scale=tuple(aug.get("mosaic_scale", (0.5, 1.5))),
            mixup_scale=tuple(aug.get("mixup_scale", (0.5, 1.5))),
            shear=float(aug.get("shear", 0.0)))
        if self.device_aug:
            self.planner = DeviceAugPlanner(
                dataset, img_size=self.img_size,
                enable_mosaic=bool(aug.get("enable_mosaic", True)),
                enable_mixup=bool(aug.get("enable_mixup", False)),
                flip_lr_prob=float(aug.get("flip_lr_prob", 0.5)),
                flip_ud_prob=float(aug.get("flip_ud_prob", 0.0)),
                hsv_prob=float(aug.get("hsv_prob", 1.0)),
                no_aug=no_aug, **geometry)
            self._batch_fn = partial(_make_device_batch, self.planner)
            self._pixels, slots = "tiles", self.planner.n_tiles
        else:
            self.mosaic_ds = MosaicMixupDataset(
                dataset, img_size=self.img_size,
                enable_mosaic=bool(aug.get("enable_mosaic", True)) and not no_aug,
                enable_mixup=bool(aug.get("enable_mixup", False)) and not no_aug,
                **geometry)
            self.pipeline = TrainAugPipeline(
                flip_lr_prob=0.0 if no_aug else float(aug.get("flip_lr_prob", 0.5)),
                flip_ud_prob=0.0 if no_aug else float(aug.get("flip_ud_prob", 0.0)),
                hsv_prob=0.0 if no_aug else float(aug.get("hsv_prob", 1.0)),
                img_sz=self.img_size)
            self._batch_fn = partial(_make_batch, self.mosaic_ds, self.pipeline)
            self._pixels, slots = "image", 1
        self.device = dataset_device(dataset)
        self.num_workers = int(num_workers)
        # queue.Queue(maxsize=0) is unbounded; prefetch <= 0 means one
        # queued batch and one in production
        self.prefetch = max(1, int(prefetch))
        if self.num_workers and "nvjpeg" in dataset_decoders(dataset):
            raise ValueError(
                f"num_workers {self.num_workers} with a dataset whose decoder is "
                "'nvjpeg': spawned workers decode on the host with the plain decoder, "
                "and a run would mix the two; use decoder 'plain' (or 'auto'), or "
                "num_workers 0")
        if self.num_workers and self.device.type == "cuda":
            logger.warning(
                "TrainLoader: %d spawned workers decode and augment on the host "
                "(JPEGs with the plain decoder) and ship numpy pixels, which are "
                "uploaded to %s; num_workers: 0 builds them on the card",
                self.num_workers, self.device)
        if self.num_workers or self.device.type != "cuda":
            # the batch working set on the host (queued, in production and
            # held by the consumer), faulted in once
            _malloc.prefault_arena((self.prefetch + 3) * batch_size * slots
                                   * self.img_size[0] * self.img_size[1] * 3)
        self._queue: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # created per __iter__
        self._started = False
        self._procs: list = []
        self._mp_queues: list = []
        self._next_bid = 0

    def seek(self, batch_id: int) -> None:
        """Position the stream so the next produced batch is `batch_id`.
        Only valid while no producer runs (before the first iteration, or
        after close())."""
        if self._started or self._procs:
            raise RuntimeError("seek() requires an idle loader — call it before "
                               "iterating or after close()")
        if batch_id < 0:
            raise ValueError(f"batch_id must be >= 0, got {batch_id}")
        self._next_bid = int(batch_id)

    def _make_batch(self, batch_id: int):
        return self._batch_fn(self.index_stream, self._sid, self.img_size,
                              self.max_labels, self.seed, batch_id)

    def _worker(self, out_q: queue.Queue, stop: threading.Event, bid: int, stream):
        """Producer thread. `out_q`/`stop` are captured per thread (not read
        from self): after close() and a re-iterate, a previous producer that
        is still finishing a batch talks to its own dead queue and event,
        and can never leak a stale batch into the restarted stream."""
        while not stop.is_set():
            try:
                item = _on_stream(stream, partial(self._make_batch, bid))
            except Exception:
                item = ("__error__", traceback.format_exc())
            bid += 1
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if item[0] == "__error__":
                return  # stop after shipping the error

    def _start_procs(self):
        import multiprocessing as mp

        # spawn: a forked child would inherit the parent's CUDA context and
        # the locks of its threads mid-held
        ctx = mp.get_context("spawn")
        self._qbase = self._next_bid  # worker w owns bids qbase + w + i*W
        for w in range(self.num_workers):
            q = ctx.Queue(maxsize=max(self.prefetch // self.num_workers, 1))
            p = ctx.Process(
                target=_worker_main,
                args=(q, self._batch_fn, self.index_stream, self._sid,
                      self.img_size, self.max_labels, self.seed,
                      self._next_bid + w, self.num_workers),
                daemon=True)
            p.start()
            self._procs.append(p)
            self._mp_queues.append(q)

    def _get_checked(self, q, worker_idx):
        """Queue get with worker liveness checks and error propagation."""
        while True:
            try:
                item = q.get(timeout=5.0)
                break
            except queue.Empty:
                p = self._procs[worker_idx]
                if not p.is_alive():
                    raise RuntimeError(f"data worker {worker_idx} died "
                                       f"(exitcode {p.exitcode})") from None
        if isinstance(item, tuple) and item[0] == "__error__":
            raise RuntimeError(f"data worker {worker_idx} failed:\n{item[1]}")
        return item

    def __iter__(self):
        if self.num_workers > 0:
            # worker w produces batches w, w+W, w+2W, ... after the bid it
            # started at; round-robin consumption keeps the single-thread
            # order, and _next_bid persists across iter() calls
            if not self._procs:
                self._start_procs()
            while True:
                w = (self._next_bid - self._qbase) % self.num_workers
                batch = self._get_checked(self._mp_queues[w], w)
                batch[self._pixels] = torch.from_numpy(batch[self._pixels]).to(self.device)
                self._next_bid += 1
                yield batch
        if not self._started:
            # a fresh queue and stop event per producer generation: leftover
            # batches of a closed producer would duplicate the restarted
            # producer's bids, and the old thread keeps its own (set) event
            if self._thread is not None and self._thread.is_alive():
                self._thread.join(timeout=60.0)
            stream = _side_stream(self.device)
            self._stop = threading.Event()
            self._queue = queue.Queue(maxsize=self.prefetch)
            self._thread = threading.Thread(
                target=self._worker,
                args=(self._queue, self._stop, self._next_bid, stream), daemon=True)
            self._thread.start()
            self._started = True
        while True:
            batch, ready = self._queue.get()
            if batch == "__error__":
                # the producer exited after shipping this; reset so that a
                # caller who catches the error and re-iterates gets a fresh
                # producer instead of a silent deadlock
                self._started = False
                raise RuntimeError(f"data worker failed:\n{ready}")
            _await(batch[self._pixels], ready)
            self._next_bid += 1
            yield batch

    def close(self):
        self._stop.set()
        self._started = False
        # join the producer so that a seek() and re-iterate cannot race a
        # thread still inside _make_batch (it shares the index stream's
        # epoch cache)
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=60.0)
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=10.0)
        self._procs.clear()
        self._mp_queues.clear()


def _worker_main(out_q, batch_fn, index_stream, sids, img_size,
                 max_labels, seed, first_bid, stride):
    """Spawned worker: batches first_bid, first_bid + stride, ... with numpy
    pixels (deterministic per batch id for any worker count), on one
    intra-op thread. Its dataset came pickled onto the CPU
    (datasets.py:__getstate__). An exception is shipped to the consumer as
    an ("__error__", traceback) item."""
    torch.set_num_threads(1)
    device_route = batch_fn.func is _make_device_batch
    key = "tiles" if device_route else "image"
    slots = batch_fn.args[0].n_tiles if device_route else 1
    _malloc.prefault_arena(4 * slots * sids.batch_size * img_size[0] * img_size[1] * 3)
    bid = first_bid
    try:
        while True:
            batch = batch_fn(index_stream, sids, img_size, max_labels, seed, bid)
            batch[key] = batch[key].numpy()
            out_q.put(batch)
            bid += stride
    except Exception:
        out_q.put(("__error__", traceback.format_exc()))


class _SampleIds:
    """Row k of a shard's batch bid: its index-stream position bid*B + k,
    and the key of its draws, its row in the global batch,
    (bid*num_shards + shard)*B + k. One shard: both are bid*B + k."""

    def __init__(self, batch_size: int, shard: int = 0, num_shards: int = 1):
        self.batch_size, self.shard, self.num_shards = batch_size, shard, num_shards

    def rows(self, batch_id: int):
        """(position, draw key) of each row of batch batch_id."""
        b = self.batch_size
        key0 = (batch_id * self.num_shards + self.shard) * b
        return [(batch_id * b + k, key0 + k) for k in range(b)]


def _make_batch(mosaic_ds, pipeline, index_stream, sids, img_size, max_labels,
                seed, batch_id):
    """Deterministic host-augmentation batch `batch_id`: index-stream
    positions [bid*B, (bid+1)*B), each sample augmented with
    default_rng([seed, 77, key]) (mosaic and mixup, then the pipeline), key
    its row in the global batch (_SampleIds), on the device the dataset
    decodes to."""
    imgs, labels = [], []
    for pos, key in sids.rows(batch_id):
        idx = index_stream.at(pos)
        rng = np.random.default_rng([seed, 77, key])
        img, lab = mosaic_ds.getitem(rng, idx)
        img, lab = pipeline(rng, img, lab)
        imgs.append(img)
        labels.append(lab)
    return {"image": torch.stack(imgs),
            "targets": pad_targets(labels, img_size, max_labels)}


def _make_device_batch(planner, index_stream, sids, img_size, max_labels,
                       seed, batch_id):
    """Deterministic device-augmentation batch `batch_id`: index-stream
    positions [bid*B, (bid+1)*B), per-sample default_rng([seed, 77, key])
    draws (key as _make_batch's). The tiles are gathered on the device the dataset decodes to;
    bytes outside each tile's valid region are left as they were (the warp
    never samples them), but slot 4, the mixup source, reads 114 gray in
    its canvas margin."""
    n_tiles = planner.n_tiles
    h_sz, w_sz = img_size
    batch_size = sids.batch_size
    plans, decode_idxs, spans = [], [], []
    for pos, key in sids.rows(batch_id):
        idx = index_stream.at(pos)
        rng = np.random.default_rng([seed, 77, key])
        tile_idxs, draws = planner.plan(rng, idx)
        spans.append((len(decode_idxs), len(tile_idxs)))
        decode_idxs.extend(tile_idxs)
        plans.append(draws)

    ds = planner.dataset
    puller = getattr(ds, "batch_pull_items", None)
    items = puller(decode_idxs) if puller is not None else [ds.pull_item(i)
                                                             for i in decode_idxs]

    tiles = torch.empty((batch_size, n_tiles, h_sz, w_sz, 3), dtype=torch.uint8,
                        device=items[0][0].device)
    tile_hw = np.zeros((batch_size, n_tiles, 2), np.int32)
    params = np.zeros((batch_size, N_PARAMS), np.float32)
    labels_list = []
    for k, (draws, (off, n)) in enumerate(zip(plans, spans)):
        p_row, hw_row, labels, tile_imgs = planner.finalize(draws, items[off:off + n])
        params[k] = p_row
        tile_hw[k] = hw_row
        labels_list.append(labels)
        for t, img in enumerate(tile_imgs):
            if img is None:
                continue
            if t == 4:
                tiles[k, 4] = 114
            th, tw = img.shape[:2]
            tiles[k, t, :th, :tw] = img
    return {"tiles": tiles, "tile_hw": tile_hw, "params": params,
            "targets": pad_targets(labels_list, img_size, max_labels)}


class ValLoader:
    """Sequential validation batches with letterbox preprocessing.

    Yields {"image": (B, S, S, 3) uint8 tensor on the dataset's device,
    "targets": (B, M, 5), "info": list of (h0, w0, ratio, pad, img_id),
    "count"}: the info maps detections back to each original frame. The
    last partial batch is padded by repeating its final sample; "count" is
    the number of real images. A background thread builds the next batch
    (on its own stream on the card) while the consumer runs the current one.

    shard/num_shards (one process per rank of a data-parallel mesh): each
    global batch of batch_size rows, padded as above, yields this shard's
    equal share of its rows, shard-major (parallel/mesh.py:shard_rows);
    "count" is the shard's real rows, so the shards' counts sum to the
    global batch's, and a shard whose rows are all padding yields count 0.
    Every shard yields len(self) batches.
    """

    def __init__(self, dataset, batch_size: int, img_size=(640, 640),
                 max_labels: int = MAX_LABELS, prefetch: int = 2, shard: int = 0,
                 num_shards: int = 1):
        if batch_size % num_shards:
            raise ValueError(f"batch {batch_size} does not split over {num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard, self.num_shards = shard, num_shards
        self.img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.pipeline = ValAugPipeline(img_sz=self.img_size)
        self.max_labels = max_labels
        self.prefetch = prefetch
        self.device = dataset_device(dataset)
        if self.device.type != "cuda":
            _malloc.prefault_arena((prefetch + 3) * (batch_size // num_shards)
                                   * self.img_size[0] * self.img_size[1] * 3)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, start: int):
        n = len(self.dataset)
        idxs = list(range(start, min(start + self.batch_size, n)))
        count = len(idxs)
        while len(idxs) < self.batch_size:
            idxs.append(idxs[-1])
        share = self.batch_size // self.num_shards
        first = self.shard * share
        idxs = idxs[first:first + share]
        count = min(max(count - first, 0), share)
        puller = getattr(self.dataset, "batch_pull_items", None)
        items = puller(idxs) if puller is not None else [self.dataset.pull_item(i)
                                                         for i in idxs]
        imgs, labels, infos = [], [], []
        for img, lab, (h0, w0), img_id in items:
            # the dataset resized by r0; the letterbox does the rest, and the
            # rescale info comes from the transform it applied
            img2, lab2, (r1, pad) = self.pipeline.apply(img, lab)
            r0 = min(self.img_size[0] / h0, self.img_size[1] / w0)
            imgs.append(img2)
            labels.append(lab2)
            infos.append((h0, w0, r0 * r1, pad, img_id))
        return {"image": torch.stack(imgs),
                "targets": pad_targets(labels, self.img_size, self.max_labels),
                "info": infos, "count": count}

    def __iter__(self):
        starts = list(range(0, len(self.dataset), self.batch_size))
        if self.prefetch <= 0:
            for s in starts:
                yield self._make_batch(s)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()
        stream = _side_stream(self.device)

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for s in starts:
                    if not _put(_on_stream(stream, partial(self._make_batch, s))):
                        return
                _put(done)
            except Exception:
                _put(("__error__", traceback.format_exc()))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                batch, ready = item
                if batch == "__error__":
                    raise RuntimeError(f"val loader failed:\n{ready}")
                _await(batch["image"], ready)
                yield batch
        finally:
            stop.set()  # a producer mid-batch exits at its next put
            t.join(timeout=60.0)
