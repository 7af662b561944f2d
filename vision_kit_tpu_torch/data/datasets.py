"""Datasets: YOLO-format (images/ + labels/*.txt) and COCO-format (json).

Counterpart of vision_kit_tpu/data/datasets.py, without OpenCV or PIL. The
sample contract is the JAX package's:

    pull_item(idx) -> (img (h, w, 3) uint8 RGB tensor, labels (n, 5) float32
                       [x1, y1, x2, y2, cls] in absolute pixels of img,
                       (h0, w0), item id)

Each dataset lives on a `device`. An image is read from disk, decoded, and
resized by ops/letterbox.py:resize_u8 (cv2.resize INTER_LINEAR, bit for
bit, on either device) to (int(w0 * r), int(h0 * r)) with r = min(S / h0,
S / w0) on the device. The `decoder` option picks the decoder:

  * "plain": data/decode.py:decode_image on the host (equal to cv2.imread
    + BGR2RGB bit for bit), uploaded to the device. Every item then equals
    the JAX dataset's on either device, and a TrainLoader's batches are the
    same bytes whatever its num_workers: the canonical route.
  * "nvjpeg": on the card the route decode.decode_to picks from the header:
    a baseline, extended or complete progressive JPEG through nvJPEG,
    faster, its pixels within decode.NVJPEG_TOLERANCE of the plain
    decoder's; a PNG, a BMP, a WebP, an arithmetic-coded or lossless JPEG,
    a CMYK, YCCK or RGB JPEG, a progressive one that ends early and one
    whose scans run out of bits on the host, bit-equal to the plain
    decoder. Spawned loader workers cannot use it (they never touch CUDA),
    so a TrainLoader with num_workers > 0 refuses such a dataset.
  * "auto" (the default): "nvjpeg" on the card, "plain" on the CPU, and
    "plain" in spawned workers; the dataset logs which decoder each route
    takes.

`fast_decode=True` (cfg.data.fast_decode) is the counterpart of the JAX
package's reduced-scale decode (_fast_decode_resized): a JPEG without EXIF
whose load-time ratio is below 1/2 decodes at 1/8, 1/4 or 1/2 scale in the
DCT (decode.decode_jpeg_reduced, cv2.imread(IMREAD_REDUCED_COLOR_f) bit for
bit), then resize_u8 takes it the rest of the way; other images take the
full decode. nvJPEG does not scale in the DCT, so with the option every
image decodes with the plain decoder on the host, on the card too:
"auto" resolves to "plain" and "nvjpeg" raises. Items then equal the JAX
dataset's with fast_decode on either device.

The integrity scan (YOLO datasets, as in the JAX package) reads headers
(decode.jpeg_header, png_header, bmp_header, webp.webp_header): the size
after EXIF orientation, the < 10 px gate, and a drop, with its reason
logged, of every file PIL refuses (a 12-bit JPEG, ...) and of an image
over OpenCV's size limits. A JPEG frame that PIL opens is kept, as JAX
keeps it, also where cv2 and the port give None for it (a grey lossless
JPEG, SOF11): its item then raises IOError, as the JAX loader's does. A
JPEG that does not end in its EOI marker is restored in place, as the JAX
package's _check_img does with PIL: decoded as Pillow's
LOAD_TRUNCATED_IMAGES reads it (decode.decode_truncated_jpeg: baseline,
progressive, arithmetic-coded and lossless, and zeros where libjpeg
decodes nothing), turned as ImageOps.exif_transpose turns it, and written
over the file as Pillow's save(subsampling=0, quality=100) writes it
(encode.encode_jpeg at 4:4:4, or encode_jpeg_cmyk), the same bytes
(restore_truncated_jpeg); it is dropped where PIL raises (the file ends
inside its header). The log names each file restored and each file
dropped with its reason, and a restore invalidates the disk image caches
that hold the file. Progressive, arithmetic-coded, lossless, CMYK, YCCK
and RGB JPEGs, BMPs and WebPs (lossy, lossless, with alpha, animated) are
kept, as JAX keeps them; a WebP decodes on the host whatever the decoder
option (no library on the card decodes it), and fast_decode takes its
full decode, as JAX's _fast_decode_resized does for anything that is not
a JPEG (and for a lossless JPEG, which libjpeg does not scale).

Caches live under the port's own names (.vkt_labels_*, .vkt_imgcache_*),
and the disk cache's key holds the decoder in use ("plain" or "nvjpeg") and
"|fast" with fast_decode, so a JAX run and a port run, a CPU run and a card
run, or a fast and a full decode never read each other's.
`cache_images: ram` keeps each resized image where it was decoded (device
memory on the card); `disk` is a host memmap either way.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import struct
import time
from glob import glob

import numpy as np
import torch

from vision_kit_tpu_torch.data import decode
from vision_kit_tpu_torch.data.encode import (SAMPLING_FACTOR_444, encode_jpeg,
                                              encode_jpeg_cmyk)
from vision_kit_tpu_torch.ops.letterbox import resize_u8
from vision_kit_tpu_torch.utils.general import exif_size, resolve_device
from vision_kit_tpu_torch.utils.logging_utils import logger

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
DECODERS = ("auto", "plain", "nvjpeg")


def _remove_stale_meta(meta_path: str) -> None:
    """Delete an on-disk image-cache meta before its .dat is recreated with
    'w+' (zero-filled): a crash between the two must present as an EMPTY
    cache on the next construction, never as a built one over zeroed pixels."""
    try:
        if os.path.exists(meta_path):
            os.remove(meta_path)
    except OSError as e:
        logger.warning("could not remove stale cache meta %s: %s", meta_path, e)


def _img2label_path(img_path: str) -> str:
    sa = os.sep + "images" + os.sep
    sb = os.sep + "labels" + os.sep
    # the LAST /images/ occurrence: an ancestor directory named "images"
    # must not hijack the mapping
    base, _ = os.path.splitext(sb.join(img_path.rsplit(sa, 1)))
    return base + ".txt"


def restore_truncated_jpeg(data: bytes) -> bytes:
    """The bytes the JAX package's _check_img writes over a JPEG that does
    not end in its EOI marker: Pillow's LOAD_TRUNCATED_IMAGES read
    (decode.decode_truncated_jpeg), ImageOps.exif_transpose (orientations
    2-8), then save(path, "JPEG", subsampling=0, quality=100): baseline
    4:4:4 JFIF at quality 100 for "RGB", one component for "L", Adobe CMYK
    for "CMYK", with the source's last comment and no EXIF or ICC. Raises
    JpegError where that path raises or the port refuses the frame."""
    mode, samples, meta = decode.decode_truncated_jpeg(data)
    img = decode.apply_orientation(torch.from_numpy(samples), meta["orientation"]).numpy()
    if mode == "CMYK":
        return encode_jpeg_cmyk(img, 100, meta["comment"])
    return encode_jpeg(img[..., 0] if mode == "L" else img, 100, SAMPLING_FACTOR_444,
                       meta["comment"])


def image_refusal(path: str) -> str | None:
    """Why the integrity scan drops the image at `path`, or None when the
    port decodes it: the counterpart of the JAX package's PIL-based
    _check_img, from headers, but for a JPEG without its EOI marker, which
    it restores in place (check_image)."""
    return check_image(path)[0]


def check_image(path: str) -> tuple[str | None, bool]:
    """(image_refusal's answer, whether the file was restored). A JPEG that
    does not end in FFD9 is rewritten as restore_truncated_jpeg gives it,
    under a temporary name in its directory and then renamed over it, so
    that no reader sees half a file; a restore that fails, or an image
    under 10 pixels, leaves the file as it is and drops it. Under a mesh
    the Trainer scans on rank 0 before the others (_rank0_first); ranks
    that scan one file at once write the same bytes, each under a name of
    its own."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        return str(e), False
    if decode.image_kind(data) == "jpeg" and data[-2:] != b"\xff\xd9":
        try:
            data = restore_truncated_jpeg(data)
        except (ValueError, IndexError, struct.error) as e:
            return f"truncated JPEG, restore failed: {e}", False
        why = _header_refusal(path, data)
        if why:
            return why, False
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError as e:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            return f"truncated JPEG, restore failed: {e}", False
        logger.warning("%s: corrupt JPEG restored and saved", path)
        return None, True
    return _header_refusal(path, data), False


def _header_refusal(path: str, data: bytes) -> str | None:
    """image_refusal of a file holding `data`, from its header alone."""
    kind = decode.image_kind(data)
    if kind not in decode.TRAIN_KINDS:
        ext = os.path.splitext(path)[1].lower()
        return (f"not a JPEG, PNG, BMP or WebP ({ext or 'no extension'}): the port "
                "decodes only those")
    try:
        if kind == "jpeg":
            # PIL opens every 8-bit JPEG frame of 1, 3 or 4 components, so
            # JAX keeps those that cv2 gives None for (a grey lossless one,
            # SOF11) and its loader raises on them, as the port's does
            info = decode.jpeg_header(data)
            refusal = decode.pil_refusal(info) or decode.jpeg_size_refusal(info)
            if refusal:
                return f"JPEG the port does not decode: {refusal}"
        w, h = exif_size(data)
    except (ValueError, IndexError, struct.error) as e:
        return f"corrupt {kind.upper()}: {e}"
    if w < 10 or h < 10:
        return f"image size {w}x{h} < 10 pixels"
    return None


def _invalidate_disk_caches(base_dir: str, paths) -> None:
    """Mark every disk image cache under `base_dir` that holds one of
    `paths` unbuilt (its meta removed), so that none serves a restored
    file's old pixels."""
    paths = set(paths)
    for entries_path in glob(os.path.join(base_dir, ".vkt_imgcache_*.entries.json")):
        try:
            with open(entries_path) as f:
                entries = json.load(f)["entries"]
        except (OSError, ValueError, KeyError):
            continue
        if paths.intersection(entries):
            _remove_stale_meta(entries_path[: -len(".entries.json")] + ".meta.npy")


def _fast_decode_resized(data: bytes, max_hw, device: str | torch.device = "cpu"):
    """Reduced-scale JPEG decode and min-ratio resize (the _decode_resized
    geometry): the counterpart of the JAX package's _fast_decode_resized.
    None when the fast path does not apply: EXIF (orientation), a header
    decode.probe_jpeg cannot read, a ratio r >= 1, no scale f in 8, 4, 2
    with ceil(h0 / f) >= int(h0 * r) and ceil(w0 / f) >= int(w0 * r), or a
    decode that refuses the bytes or disagrees with the probe's shape. Else
    (resized (h, w, 3) uint8 tensor on `device`, (h0, w0)): decoded at 1/f
    on the host, uploaded, and resize_u8 unless already at its size."""
    probe = decode.probe_jpeg(data)
    if probe is None or probe[2]:
        return None
    h0, w0, _ = probe
    r = min(max_hw[0] / h0, max_hw[1] / w0)
    if r >= 1.0:
        return None
    new_w, new_h = int(w0 * r), int(h0 * r)
    f = next((f for f in (8, 4, 2)
              if -(-h0 // f) >= new_h and -(-w0 // f) >= new_w), 1)
    if f < 2:
        return None
    rgb = decode.decode_jpeg_reduced(data, f)
    if rgb is None or rgb.shape[:2] != (-(-h0 // f), -(-w0 // f)):
        return None
    img = torch.from_numpy(rgb).to(device)
    if img.shape[:2] != (new_h, new_w):
        img = resize_u8(img, (new_w, new_h))
    return img, (h0, w0)


class _ImageCacheMixin:
    """RAM/disk cache of the load-time-resized images (counterpart of the
    JAX package's _ImageCacheMixin).

    `cache_images` in {None, "ram", "disk"}. Both modes store the image
    after the load-time min-ratio resize. "ram" keeps each as the tensor it
    was decoded to, on the dataset's device. "disk" is one host memmap of
    shape (n, max_h, max_w, 3) plus an int32 (n, 4) meta array [h, w, h0,
    w0], keyed by the file list, the input size, the decoder and
    fast_decode, reused across runs and across spawned loader workers (the
    memmap handle is dropped on pickling and reopened lazily in the
    worker).

    The disk build is RESTARTABLE (meta rows are published atomically per
    chunk, after their pixels are flushed; a killed build resumes at the
    first unbuilt row) and SHARED across splits: a complete cache of
    another dataset whose entry list is a superset of ours (same size,
    decoder and fast_decode) is adopted read-only through a row map."""

    cache_build_chunk = 64

    def _init_device(self, device, fast_decode: bool, decoder: str = "auto") -> None:
        if decoder not in DECODERS:
            raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
        if decoder == "nvjpeg" and fast_decode:
            raise ValueError("decoder 'nvjpeg' with fast_decode: nvJPEG has no DCT "
                             "scaling; fast_decode decodes with the plain decoder")
        self.device = resolve_device(device)
        if decoder == "nvjpeg" and self.device.type != "cuda":
            raise ValueError(f"decoder 'nvjpeg' needs a CUDA device, not {self.device}")
        self.fast_decode = bool(fast_decode)
        self.decode_with = "plain" if fast_decode else decoder
        if fast_decode and decoder == "auto" and self.device.type == "cuda":
            logger.info("decoder auto with fast_decode: plain, every image decoded "
                        "on the host (reduced in the DCT where the ratio allows) and "
                        "uploaded to %s", self.device)
        elif decoder == "auto" and self.device.type == "cuda":
            logger.info("decoder auto: JPEGs through nvJPEG on %s in this process; "
                        "spawned loader workers decode with the plain decoder "
                        "(decoder 'plain' makes both the plain one)", self.device)

    @property
    def decoder(self) -> str:
        """The decoder in use: "nvjpeg" on the card unless the option is
        "plain" (JPEGs; PNGs decode on the host), else "plain"."""
        return ("nvjpeg" if self.device.type == "cuda" and self.decode_with != "plain"
                else "plain")

    def _init_img_cache(self, cache_images, cache_key: str, base_dir: str,
                        entries: list):
        if cache_images not in (None, "", False, "ram", "disk"):
            raise ValueError(
                f"cache_images must be None, 'ram' or 'disk', got {cache_images!r}")
        self.cache_images = cache_images or None
        self._ram_cache = None
        self._mm = None
        self._mm_meta = None
        self._mm_rows = None
        if not self.cache_images:
            return
        maxh, maxw = self.input_dim
        chunk = int(self.cache_build_chunk)
        if self.cache_images == "ram":
            self._ram_cache = []
            for s in range(0, len(self), chunk):
                self._ram_cache.extend(
                    self._decode_resized_batch(range(s, min(s + chunk, len(self)))))
            logger.info("cached %d images in RAM on %s", len(self), self.device)
            return
        assert len(entries) == len(self)
        fast = "|fast" if self.fast_decode else ""
        tag = hashlib.md5(
            f"{cache_key}|{maxh}x{maxw}|{self.decoder}{fast}".encode()).hexdigest()[:12]
        self._mm_path = os.path.join(base_dir, f".vkt_imgcache_{tag}.dat")
        self._mm_shape = (len(self), maxh, maxw, 3)
        meta_path = self._mm_path + ".meta.npy"

        # exact reuse / restartable resume of this dataset's own cache. A
        # meta row of zeros marks an unbuilt entry (every decoded image has
        # h >= 1), so a build killed mid-way resumes where it stopped:
        # pixels are flushed BEFORE the meta rows naming them are published
        meta = None
        if os.path.exists(self._mm_path) and os.path.exists(meta_path):
            try:
                meta = np.load(meta_path)
                if meta.shape != (len(self), 4):
                    meta = None
            except (OSError, ValueError):
                meta = None
            if meta is None:
                logger.warning("disk image cache unreadable, rebuilding")
        if meta is not None and (meta[:, 0] > 0).all():
            # the .dat itself can be truncated while its meta survived
            try:
                mm = np.memmap(self._mm_path, np.uint8, "r", shape=self._mm_shape)
            except (OSError, ValueError):
                logger.warning("disk image cache .dat unreadable, rebuilding")
                meta = None
            else:
                self._mm_meta, self._mm = meta, mm
                logger.info("reusing disk image cache %s", self._mm_path)
                return

        if meta is None:
            # a built cache of another split whose entries are a superset of
            # ours (same size and decoder) is referenced, not re-decoded
            if self._find_superset_cache(base_dir, entries, maxh, maxw) is not None:
                return
            # a stale meta must not survive the zero-filling 'w+' open: a
            # crash before the first chunk republishes meta would leave
            # zeroed pixels under a meta claiming them built
            _remove_stale_meta(meta_path)
            mm = np.memmap(self._mm_path, np.uint8, "w+", shape=self._mm_shape)
            meta = np.zeros((len(self), 4), np.int32)
        else:
            # size check BEFORE r+: numpy's r+ silently GROWS a truncated
            # file with zeros, which would resume into black rows
            try:
                if os.path.getsize(self._mm_path) < int(np.prod(self._mm_shape)):
                    raise ValueError("disk cache .dat smaller than its shape")
                mm = np.memmap(self._mm_path, np.uint8, "r+", shape=self._mm_shape)
            except (OSError, ValueError):
                # the meta claiming rows built goes FIRST: 'w+' zero-fills
                _remove_stale_meta(meta_path)
                logger.warning("disk image cache .dat unreadable, rebuilding")
                mm = np.memmap(self._mm_path, np.uint8, "w+", shape=self._mm_shape)
                meta = np.zeros((len(self), 4), np.int32)
            else:
                logger.info("resuming disk image cache build %s (%d/%d done)",
                            self._mm_path, int((meta[:, 0] > 0).sum()), len(self))

        with open(self._mm_path + ".entries.json", "w") as f:
            json.dump({"entries": entries, "maxh": maxh, "maxw": maxw,
                       "decoder": self.decoder, "fast": self.fast_decode}, f)

        todo = np.flatnonzero(meta[:, 0] == 0)
        t0, done0 = time.monotonic(), len(self) - len(todo)
        last_log = t0
        for s in range(0, len(todo), chunk):
            idxs = todo[s:s + chunk].tolist()
            for i, (img, (h0, w0)) in zip(idxs, self._decode_resized_batch(idxs)):
                h, w = img.shape[:2]
                mm[i, :h, :w] = img.cpu().numpy()
                meta[i] = (h, w, h0, w0)
            # durability order: pixels first, then the meta rows naming them
            mm.flush()
            # a name of this process's own: two builders never share one
            tmp = f"{meta_path}.{os.getpid()}.tmp.npy"
            np.save(tmp, meta)
            os.replace(tmp, meta_path)
            now = time.monotonic()
            if now - last_log > 30:
                built = done0 + s + len(idxs)
                rate = (built - done0) / max(now - t0, 1e-9)
                logger.info("disk image cache %d/%d (%.0f img/s, ETA %.0fs)",
                            built, len(self), rate, (len(self) - built) / max(rate, 1e-9))
                last_log = now
        del mm
        self._mm_meta = meta
        self._mm = np.memmap(self._mm_path, np.uint8, "r", shape=self._mm_shape)
        logger.info("built disk image cache %s", self._mm_path)

    def _find_superset_cache(self, base_dir, entries, maxh, maxw):
        """Adopt a COMPLETE existing cache (same size, decoder and
        fast_decode) whose entry list contains every one of ours: map our
        indices into its rows. Returns the adopted path or None."""
        for sc_path in sorted(glob(os.path.join(base_dir, ".vkt_imgcache_*.entries.json"))):
            dat = sc_path[: -len(".entries.json")]
            if dat == self._mm_path:
                continue
            try:
                with open(sc_path) as f:
                    sc = json.load(f)
                if ((sc["maxh"], sc["maxw"], sc["decoder"], sc.get("fast", False))
                        != (maxh, maxw, self.decoder, self.fast_decode)):
                    continue
                pos = {e: i for i, e in enumerate(sc["entries"])}
                rows = [pos.get(e, -1) for e in entries]
                if min(rows, default=-1) < 0:
                    continue
                meta = np.load(dat + ".meta.npy")
                if meta.shape != (len(sc["entries"]), 4):
                    continue
                rows = np.asarray(rows, np.int64)
                if not (meta[rows, 0] > 0).all():
                    continue  # needed rows not built yet
                # the .dat itself is validated before any self mutation: a
                # bad candidate is skipped, not fatal
                shape = (len(sc["entries"]), maxh, maxw, 3)
                mm = np.memmap(dat, np.uint8, "r", shape=shape)
            except (OSError, ValueError, KeyError, TypeError):
                continue
            self._mm_path, self._mm_shape, self._mm_rows = dat, shape, rows
            self._mm_meta, self._mm = meta[rows], mm
            logger.info("sharing disk image cache %s (%d/%d rows)", dat,
                        len(rows), len(sc["entries"]))
            return dat
        return None

    def _get_resized(self, idx: int):
        """(resized (h, w, 3) uint8 tensor on the device, (h0, w0)) through
        the cache if enabled. A RAM-cached image is the cached tensor itself:
        callers copy before they write."""
        if self._ram_cache is not None:
            return self._ram_cache[idx]
        if self.cache_images == "disk":
            if self._mm is None:  # reopened lazily after pickling to a worker
                self._mm = np.memmap(self._mm_path, np.uint8, "r", shape=self._mm_shape)
                if self._mm_meta is None:
                    meta = np.load(self._mm_path + ".meta.npy")
                    self._mm_meta = meta if self._mm_rows is None else meta[self._mm_rows]
            row = idx if self._mm_rows is None else int(self._mm_rows[idx])
            h, w, h0, w0 = (int(v) for v in self._mm_meta[idx])
            img = torch.from_numpy(np.array(self._mm[row, :h, :w]))
            return img.to(self.device), (h0, w0)
        return self._decode_resized(idx)

    def _decode_resized(self, idx: int):
        """Decode and min-ratio resize of one image on the device: r =
        min(max / src), C-style truncation of w*r and h*r, cv2's
        INTER_LINEAR (the JAX package's _decode_resized_py). With
        fast_decode, _fast_decode_resized first; the full decode where it
        does not apply. The decoders return fresh memory, so an image
        already at its size is returned as decoded."""
        if self.fast_decode:
            with open(self._image_path(idx), "rb") as f:
                out = _fast_decode_resized(f.read(), self.input_dim, self.device)
            if out is not None:
                return out
        img = self.load_image(idx)
        h0, w0 = img.shape[:2]
        r = min(self.input_dim[0] / h0, self.input_dim[1] / w0)
        if r != 1:
            img = resize_u8(img, (int(w0 * r), int(h0 * r)))
        return img, (h0, w0)

    def _decode_resized_batch(self, idxs):
        """_decode_resized of each index: the cache build's unit of work."""
        return [self._decode_resized(i) for i in idxs]

    def load_image(self, idx: int) -> torch.Tensor:
        """Raw (h0, w0, 3) uint8 RGB pixels on the device, EXIF orientation
        applied (the _decode_resized hook)."""
        path = self._image_path(idx)
        with open(path, "rb") as f:
            data = f.read()
        if self.decoder == "nvjpeg":
            img = decode.decode_to(data, self.device)
        else:
            rgb = decode.decode_image(data)
            img = None if rgb is None else torch.from_numpy(rgb).to(self.device)
        if img is None:
            raise IOError(f"image unreadable: {path}")
        return img

    def batch_pull_items(self, idxs):
        """pull_item of each index: the loaders' per-batch entry."""
        return [self.pull_item(i) for i in idxs]

    def pull_item(self, idx: int):
        img, hw0 = self._get_resized(idx)
        return img, self._labels_resized(idx, img.shape[:2], hw0), hw0, self._item_id(idx)

    def __getstate__(self):
        """What a spawned loader worker receives: no memmap handle (reopened
        lazily), no RAM cache (pickling it would copy the decoded dataset
        into every worker) and the CPU as the device (a worker never touches
        CUDA: it decodes with the plain decoder; the loader refuses workers
        for decoder "nvjpeg")."""
        state = dict(self.__dict__)
        state["_mm"] = None
        state["_ram_cache"] = None
        state["device"] = torch.device("cpu")
        return state


class YOLODataset(_ImageCacheMixin):
    """YOLO-format dataset (counterpart of the JAX package's YOLODataset)."""

    def __init__(self, data_dir: str, img_size=(640, 640), filter_classes=(),
                 cache: bool = True, cache_images: str | None = None,
                 fast_decode: bool = False, device: str | torch.device = "cuda",
                 decoder: str = "auto"):
        self._init_device(device, fast_decode, decoder)
        self.data_dir = data_dir
        self.input_dim = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.filter_classes = list(filter_classes)
        self.img_files = sorted(
            p for p in glob(os.path.join(data_dir, "**", "*.*"), recursive=True)
            if p.lower().endswith(IMG_EXTS) and (os.sep + "images" + os.sep) in p)
        if not self.img_files:
            # also accept flat dirs of images with labels alongside
            self.img_files = sorted(
                p for p in glob(os.path.join(data_dir, "*.*"))
                if p.lower().endswith(IMG_EXTS))
        if not self.img_files:
            raise FileNotFoundError(f"No images found under {data_dir}")
        self.labels = self._load_labels(cache)
        self._init_img_cache(cache_images, "\n".join(self.img_files), self.data_dir,
                             entries=list(self.img_files))

    # -- label cache + integrity scan -------------------------------------
    def _cache_path(self) -> str:
        h = hashlib.md5("\n".join(self.img_files).encode()).hexdigest()[:12]
        return os.path.join(self.data_dir, f".vkt_labels_{h}.npz")

    def _load_labels(self, cache: bool):
        """Label parse + image integrity scan. Images the port cannot decode
        are logged and DROPPED (self.img_files shrinks) instead of crashing
        the loader mid-epoch; verdicts are cached in the .npz keyed by the
        original file list."""
        path = self._cache_path()
        if cache and os.path.exists(path):
            try:
                with np.load(path, allow_pickle=True) as z:
                    files = [str(f) for f in z["files"]]
                    labels = [np.asarray(lab, np.float32).reshape(-1, 5)
                              for lab in z["labels"]]
                if len(files) == len(labels):
                    self.img_files = files
                    return labels
                logger.warning("label cache stale, rebuilding: %s", path)
            except (OSError, ValueError, KeyError):
                logger.warning("label cache unreadable, rebuilding: %s", path)
        labels, kept, restored = [], [], []
        n_missing = n_dropped = 0
        for img_path in self.img_files:
            reason, was_restored = check_image(img_path)
            if reason is not None:
                n_dropped += 1
                logger.warning("dropping image %s: %s", img_path, reason)
                continue
            if was_restored:
                restored.append(img_path)
            lp = _img2label_path(img_path)
            rows = np.zeros((0, 5), np.float32)
            if os.path.exists(lp):
                try:
                    rows = _read_label_file(lp)
                except (OSError, ValueError) as e:  # drop the labels, keep the image
                    logger.warning("bad label file %s: %s", lp, e)
            else:
                n_missing += 1
            kept.append(img_path)
            labels.append(rows)
        if not kept:
            raise RuntimeError(f"no readable images under {self.data_dir} "
                               f"({n_dropped} dropped)")
        if n_missing == len(kept):
            logger.warning("No labels found under %s", self.data_dir)
        if n_dropped or restored:
            logger.warning("integrity scan of %s: %d images kept (%d of them truncated "
                           "JPEGs restored in place), %d dropped", self.data_dir,
                           len(kept), len(restored), n_dropped)
        if restored:
            _invalidate_disk_caches(self.data_dir, restored)
        self.img_files = kept
        if cache:
            # a 1-D object array explicitly: np.asarray(labels, object) would
            # build a 3-D array whenever every image has the same label count
            arr = np.empty(len(labels), dtype=object)
            for i, lab in enumerate(labels):
                arr[i] = lab
            # complete under a name of this process's own, then renamed into
            # place: a reader never sees a half-written cache
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            try:
                np.savez_compressed(tmp, labels=arr, files=np.asarray(kept))
                os.replace(tmp, path)
            except OSError as e:
                logger.warning("could not write the label cache %s: %s", path, e)
        return labels

    # -- sample access ----------------------------------------------------
    def __len__(self):
        return len(self.img_files)

    def load_anno(self, idx: int) -> np.ndarray:
        """(n, 5) [x1, y1, x2, y2, cls] in the resized frame of pull_item."""
        return self.pull_item(idx)[1]

    def _image_path(self, idx: int) -> str:
        return self.img_files[idx]

    def _item_id(self, idx: int):
        return idx

    def _labels_resized(self, idx: int, img_hw, hw0) -> np.ndarray:
        """Normalized label rows -> absolute xyxy+cls in the resized frame."""
        h, w = img_hw
        rows = self.labels[idx]
        out = np.zeros((len(rows), 5), np.float32)
        if len(rows):
            cx, cy, bw, bh = (rows[:, 1] * w, rows[:, 2] * h, rows[:, 3] * w, rows[:, 4] * h)
            out[:, 0] = cx - bw / 2
            out[:, 1] = cy - bh / 2
            out[:, 2] = cx + bw / 2
            out[:, 3] = cy + bh / 2
            out[:, 4] = rows[:, 0]
            if self.filter_classes:
                out = out[np.isin(out[:, 4], self.filter_classes)]
        return out


def _read_label_file(path: str) -> np.ndarray:
    """(n, 5) [cls, cx, cy, w, h] rows of a YOLO label file, duplicates
    removed with a warning; ValueError for a malformed file."""
    raw = np.loadtxt(path, ndmin=2, dtype=np.float32)
    if not raw.size:
        return np.zeros((0, 5), np.float32)
    if raw.shape[1] != 5:
        raise ValueError(f"labels need 5 cols: {path}")
    if not (raw >= 0).all():
        raise ValueError(f"negative values: {path}")
    if not (raw[:, 1:] <= 1).all():
        raise ValueError(f"non-normalized coords: {path}")
    _, uniq = np.unique(raw, axis=0, return_index=True)
    if len(uniq) < len(raw):
        logger.warning("%s: %d duplicate labels removed", path, len(raw) - len(uniq))
        raw = raw[np.sort(uniq)]
    return raw


class COCODataset(_ImageCacheMixin):
    """COCO-json dataset (counterpart of the JAX package's COCODataset),
    parsed with stdlib json. Annotations are cleaned (w > 0, h > 0, crowds
    dropped) and scaled to the load-time resize in pull_item.

    `filter_classes` holds CONTIGUOUS class indices (the position of the
    category in the json's sorted category-id list), not raw COCO category
    ids. Labels of other classes are dropped; images keep their slot."""

    def __init__(self, data_dir: str, json_file: str = "instances_train2017.json",
                 name: str = "train2017", img_size=(640, 640), filter_classes=(),
                 cache_images: str | None = None, fast_decode: bool = False,
                 device: str | torch.device = "cuda", decoder: str = "auto"):
        self._init_device(device, fast_decode, decoder)
        self.data_dir = data_dir
        self.name = name
        self.input_dim = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        ann_path = (json_file if os.path.isabs(json_file)
                    else os.path.join(data_dir, "annotations", json_file))
        if not os.path.exists(ann_path):
            raise FileNotFoundError(f"annotation file missing: {ann_path}")
        with open(ann_path) as f:
            coco = json.load(f)

        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in cats]
        self.class_ids = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.class_names = [c["name"] for c in cats]

        anns_by_img: dict[int, list] = {}
        for a in coco.get("annotations", []):
            if not a.get("iscrowd", 0):
                anns_by_img.setdefault(a["image_id"], []).append(a)
        self.items = []
        for im in coco["images"]:
            rows = []
            for a in anns_by_img.get(im["id"], []):
                x, y, w, h = a["bbox"]
                if w <= 0 or h <= 0:
                    continue
                cls = self.class_ids[a["category_id"]]
                if filter_classes and cls not in filter_classes:
                    continue
                rows.append([x, y, x + w, y + h, cls])
            self.items.append({"id": im["id"], "file_name": im["file_name"],
                               "height": im["height"], "width": im["width"],
                               "labels": np.asarray(rows, np.float32).reshape(-1, 5)})
        self._init_img_cache(
            cache_images,
            self.name + "\n" + "\n".join(i["file_name"] for i in self.items),
            self.data_dir,
            entries=[self._image_path(i) for i in range(len(self.items))])

    def __len__(self):
        return len(self.items)

    def load_anno(self, idx: int) -> np.ndarray:
        item = self.items[idx]
        r = min(self.input_dim[0] / item["height"], self.input_dim[1] / item["width"])
        labels = item["labels"].copy()
        labels[:, :4] *= r
        return labels

    def _image_path(self, idx: int) -> str:
        return os.path.join(self.data_dir, self.name, self.items[idx]["file_name"])

    def _item_id(self, idx: int):
        return self.items[idx]["id"]

    def _labels_resized(self, idx: int, img_hw, hw0) -> np.ndarray:
        h0, w0 = hw0
        r = min(self.input_dim[0] / h0, self.input_dim[1] / w0)
        labels = self.items[idx]["labels"].copy()
        labels[:, :4] *= r
        return labels


class ConcatDataset:
    """Concatenation of datasets sharing the pull_item contract; the item
    id is the index into the concatenation."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()
        self.input_dim = self.datasets[0].input_dim

    def __len__(self):
        return self.cum[-1]

    def _locate(self, idx: int):
        if idx < 0:
            idx += len(self)
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else self.cum[ds - 1]
        return self.datasets[ds], idx - prev

    def load_anno(self, idx: int):
        d, i = self._locate(idx)
        return d.load_anno(i)

    def pull_item(self, idx: int):
        d, i = self._locate(idx)
        img, labels, hw0, _ = d.pull_item(i)
        return img, labels, hw0, idx


class MixConcatDataset(ConcatDataset):
    """ConcatDataset whose indices may arrive as (flag, idx) tuples from a
    mosaic-toggling batch sampler (the tuple's last element is the index)."""

    def pull_item(self, index):
        idx = index[-1] if isinstance(index, (tuple, list)) else index
        return super().pull_item(idx)


class CustomDataset(YOLODataset):
    """Extension template: subclass and override `_load_labels` /
    `pull_item` for bespoke on-disk formats; everything downstream (planner,
    loaders, evaluator) only uses the pull_item contract."""
