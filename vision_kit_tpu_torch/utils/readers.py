"""Demo inputs: image files and directories, and Motion-JPEG video.

Counterpart of vision_kit_tpu/utils/readers.py without OpenCV. Images are
read through data/decode.py:decode_image (the plain JPEG/PNG/BMP/WebP
decoder, equal to cv2.imdecode + BGR2RGB bit for bit), so an ImageReader
yields RGB where the JAX one yields cv2.imread's BGR, and a file that
neither decodes (a grey lossless or 12-bit JPEG, ...) yields (False,
None). `save` writes `<name>_res.jpg` through data/encode.py's encode_jpeg,
the bytes cv2.imwrite writes.

VideoReader reads a Motion-JPEG AVI (utils/avi.py) where the JAX one opens
any file or webcam with cv2.VideoCapture: its frames are RGB uint8 tensors
on the device, each a whole JPEG decoded on the card by the route
data/decode.py:decode_to picks from its header (nvJPEG for a baseline
frame) or by the plain decoder. A webcam index, and any other codec or container (MPEG-4
Part 2 or H.264, in AVI or MP4), raise naming what they are. Its writer
writes Motion-JPEG AVI through encode_jpeg where the JAX one writes mp4v.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from vision_kit_tpu_torch.data import decode
from vision_kit_tpu_torch.data.datasets import DECODERS
from vision_kit_tpu_torch.data.encode import encode_jpeg
from vision_kit_tpu_torch.data.loader import _await, _on_stream, _side_stream
from vision_kit_tpu_torch.utils.avi import AviWriter, read_avi
from vision_kit_tpu_torch.utils.general import resolve_device
from vision_kit_tpu_torch.utils.logging_utils import logger

IMAGE_EXT = (".jpg", ".jpeg", ".webp", ".bmp", ".png")
VIDEO_EXT = (".mp4", ".avi", ".mov", ".mkv")


class ImageReader:
    """Iterate (ok, rgb_image) over a single image or a directory tree."""

    def __init__(self, image_path: str, save_path: str | None = None):
        self.image_path = image_path
        if os.path.isdir(image_path):
            self.files = sorted(
                os.path.join(root, f)
                for root, _, names in os.walk(image_path)
                for f in names
                if os.path.splitext(f)[1].lower() in IMAGE_EXT
            )
        else:
            self.files = [image_path]
        self.save_path = save_path
        if save_path:
            os.makedirs(save_path, exist_ok=True)

    def save(self, image, filename: str) -> str:
        """Write an RGB image as <save_path>/<filename's stem>_res.jpg."""
        name = os.path.splitext(os.path.basename(filename))[0] + "_res.jpg"
        out = os.path.join(self.save_path, name)
        with open(out, "wb") as f:
            f.write(encode_jpeg(image))
        return out

    def __iter__(self):
        for path in self.files:
            with open(path, "rb") as f:
                img = decode.decode_image(f.read())
            yield (img is not None), img

    def __len__(self):
        return len(self.files)


class VideoReader:
    """Iterate (ok, rgb_frame) over a Motion-JPEG AVI, ending with one
    (False, None), optionally prefetching frames on a reader thread so that
    reading and decoding overlap inference.

    Frames are (H, W, 3) uint8 RGB tensors on `device`. decoder "nvjpeg"
    (the default "auto" on the card) decodes each through decode.decode_to
    (nvJPEG, or the host for a frame nvJPEG does not take), "plain" (the
    default on the CPU) with data/decode.py:decode_image, uploaded. On the
    card the thread decodes on a stream of its own, and the consumer's
    stream waits on an event recorded after each frame. A frame the decoder
    refuses ends the stream there with a logged warning, as a failed
    cv2.VideoCapture.read does; it is not handed to the other decoder.
    `save(frame)` appends an RGB frame (numpy or tensor) to the Motion-JPEG
    AVI `save_path`, opened on the first frame at the input's fps."""

    def __init__(self, video_path: str = "0", use_thread: bool = True,
                 save_path: str | None = None, prefetch: int = 4,
                 device: str | torch.device = "cuda", decoder: str = "auto"):
        if str(video_path).isnumeric():
            raise NotImplementedError(
                f"webcam {video_path}: the port reads no camera (there is no capture "
                "device on either machine it runs on); give a Motion-JPEG AVI")
        if save_path is not None and not save_path.lower().endswith(".avi"):
            raise ValueError(f"{save_path}: the port writes Motion-JPEG AVI only (the "
                             "JAX demo writes mp4v, which the port has no encoder for); "
                             "name the output .avi")
        if decoder not in DECODERS:
            raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
        self.device = resolve_device(device)
        if decoder == "nvjpeg" and self.device.type != "cuda":
            raise ValueError(f"decoder 'nvjpeg' needs a CUDA device, not {self.device}")
        self.decoder = ("nvjpeg" if self.device.type == "cuda" and decoder != "plain"
                        else "plain")
        self.movie = read_avi(str(video_path))
        self.org_width, self.org_height = self.movie.width, self.movie.height
        self.fps = self.movie.fps or 30.0
        self.total_frames = len(self.movie.frames)
        self.use_thread = use_thread
        self.save_path = save_path
        self.video_writer = None
        self.prefetch = prefetch
        self._stop = threading.Event()
        self._thread = None

    def _frames(self, stream=None):
        """(True, frame, ready event or None) per frame in order, then one
        (False, None, None); decoded on `stream` when given."""
        with open(self.movie.path, "rb") as f:
            for i in range(self.total_frames):
                if self._stop.is_set():
                    break
                data = self.movie.read_frame(f, i)
                frame, ready = _on_stream(stream, lambda: self._decode(data))
                if frame is None:
                    logger.warning("%s: frame %d does not decode (%s decoder): the "
                                   "stream ends there", self.movie.path, i, self.decoder)
                    break
                yield True, frame, ready
        yield False, None, None

    def _decode(self, data: bytes) -> torch.Tensor | None:
        if self.decoder == "nvjpeg":
            return decode.decode_to(data, self.device)
        rgb = decode.decode_image(data) if decode.image_kind(data) == "jpeg" else None
        return None if rgb is None else torch.from_numpy(rgb).to(self.device)

    def _reader(self, out: queue.Queue, stream):
        for item in self._frames(stream):
            while not self._stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def save(self, frame) -> None:
        """Append `frame` ((H, W, 3) uint8 RGB) to save_path as one JPEG
        (encode_jpeg, quality 95, cv2's default)."""
        if not self.save_path:
            return
        rgb = frame.cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)
        if self.video_writer is None:
            self.video_writer = AviWriter(self.save_path, self.fps)
        self.video_writer.write(encode_jpeg(rgb), rgb.shape[1], rgb.shape[0])

    def stop(self) -> None:
        """Close the writer and end the reader thread."""
        if self.video_writer is not None:
            self.video_writer.close()
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def __iter__(self):
        if not self.use_thread:
            for ok, frame, _ in self._frames():
                yield ok, frame
            return
        if self._thread is not None:
            raise RuntimeError("a threaded VideoReader is iterated once")
        frames: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stream = _side_stream(self.device)
        self._thread = threading.Thread(target=self._reader, args=(frames, stream),
                                        daemon=True)
        self._thread.start()
        while True:
            ok, frame, ready = frames.get()
            if ok:
                _await(frame, ready)
            yield ok, frame
            if not ok:
                return

    def __len__(self):
        return self.total_frames
