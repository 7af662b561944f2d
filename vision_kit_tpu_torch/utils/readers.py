"""Demo inputs: image files and directories, and video files.

Counterpart of vision_kit_tpu/utils/readers.py without OpenCV. Images are
read through data/decode.py:decode_image (the plain JPEG/PNG/BMP/WebP
decoder, equal to cv2.imdecode + BGR2RGB bit for bit), so an ImageReader
yields RGB where the JAX one yields cv2.imread's BGR, and a file that
neither decodes (a grey lossless or 12-bit JPEG, ...) yields (False,
None). `save` writes `<name>_res.jpg` through data/encode.py's encode_jpeg,
the bytes cv2.imwrite writes.

VideoReader reads what the JAX one reads from a video file through
cv2.VideoCapture, as far as the port has decoders: the container is
sniffed (RIFF AVI by utils/avi.py, ISO BMFF .mp4/.mov by utils/mp4.py,
Matroska/WebM by utils/mkv.py, IVF by utils/ivf.py, YUV4MPEG2 by
utils/y4m.py, a raw Motion-JPEG stream by utils/mjpeg.py), each mapping
its tags to a codec as libavformat does, then the codec routes each
frame. A Motion-JPEG frame (MJPG, JPGL, LJPG and riff.c's other tags in
AVI; `jpeg` or an esds of JPEG in MP4/QuickTime; V_MJPEG) is a whole JPEG,
decoded on the card by the route data/decode.py:decode_to picks from its
header (nvJPEG for a baseline frame) or by the plain decoder; an MPEG-4
Part 2 frame (cv2's mp4v, XVID or DIVX, in AVI, Matroska, MP4 or
QuickTime) is a VOP that data/mpeg4.py's decoder takes in order, with the
container's codec tag for libavcodec's XviD rule, as host C++ on the card
(csrc/mpeg4_decode.cu) or in numpy, its planes converted to RGB by
mpeg4.yuv420_to_rgb on the device; a VP8 frame (cv2's VP80 in WebM,
Matroska, AVI or IVF, or a vp08 track in MP4) goes to data/vp8.py's
decoder in order and a VP9 packet (cv2's VP90 in WebM, Matroska, AVI,
IVF or MP4's vp09) to data/vp9.py's, as host C++ on the card
(csrc/vp8_decode.cu, csrc/vp9_decode.cu) or in Python, its planes
converted by yuv420_to_rgb in the range its key frame gives. A PNG frame
(png, MPNG) decodes by the plain PNG decoder on the host; a Motion JPEG
2000 frame (MJ2C, mjp2) by data/jp2.py's video mode (its 4:2:0 or grey
planes, no OpenCV refusal; the host C++ twin on the card), converted by
yuv420_to_rgb on the device; a raw frame (I420, IYUV, YV12, J420, Y800,
RGBA; YUV4MPEG2's 4:2:0 and mono) goes to the device as bytes and
converts there (data/rawvideo.py). A file cv2 reads no frame from (UYVY
or YUY2 AVIs whose packets are short of a frame, a QuickTime 'raw ' entry
of depth 12, which cv2 does not open) yields no frame and raises nothing,
with cv2's count and fps (-1 where it opens nothing). Frames are RGB
uint8 tensors on the device. A webcam index, AV1, H.264/HEVC (in any
container), the MPEG-4 tools the decoder refuses (B-VOPs, quarter-pel,
...), the VP9 the port refuses (profiles 1-3, scaled references, a
change of size, colour matrices other than BT.601) and the layouts cv2
converts and the port does not (NV12, UYVY, 4:4:4 JPEG 2000, YUV4MPEG2
C444, ...) raise naming what they are. Its writer writes
mp4v into the container the output's name gives, as the JAX one writes
(cv2.VideoWriter, fourcc mp4v): data/mpeg4.py's Mp4vEncoder's VOPs in an
MP4 (.mp4, .mov; utils/mp4.py's Mp4Writer), an AVI (.avi; utils/avi.py's
AviWriter, fourcc mp4v as cv2 tags it, the VOL headers before the first
VOP) or Matroska (.mkv; utils/mkv.py's MkvWriter). A .webm output raises: WebM holds VP8, VP9 or
AV1 only, and the JAX writer opens nothing for it (it writes no file).
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from vision_kit_tpu_torch.data import decode, jp2, mpeg4, rawvideo, vp8, vp9
from vision_kit_tpu_torch.data.datasets import DECODERS
from vision_kit_tpu_torch.data.encode import encode_jpeg
from vision_kit_tpu_torch.data.loader import _await, _on_stream, _side_stream
from vision_kit_tpu_torch.utils.avi import AviWriter, read_avi
from vision_kit_tpu_torch.utils.ivf import read_ivf
from vision_kit_tpu_torch.utils.mjpeg import SIGNATURE as MJPEG_SIGNATURE, read_mjpeg
from vision_kit_tpu_torch.utils.mkv import MkvMovie, MkvWriter, read_mkv
from vision_kit_tpu_torch.utils.mp4 import Mp4Writer, file_kind, read_mp4
from vision_kit_tpu_torch.utils.y4m import SIGNATURE as Y4M_SIGNATURE, read_y4m
from vision_kit_tpu_torch.utils.general import resolve_device
from vision_kit_tpu_torch.utils.logging_utils import logger

IMAGE_EXT = (".jpg", ".jpeg", ".webp", ".bmp", ".png")
CODEC_NAMES = {"mpeg4": "MPEG-4 Part 2", "vp8": "VP8", "vp9": "VP9", "png": "PNG",
               "jpeg2000": "Motion JPEG 2000", "raw": "raw"}
VIDEO_EXT = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".ivf", ".y4m", ".mjpeg", ".mjpg")
# the containers an output's name picks, each written as mp4v (the JAX
# writer's fourcc for any name)
VIDEO_OUT = {".mp4": Mp4Writer, ".mov": Mp4Writer, ".avi": AviWriter, ".mkv": MkvWriter}


def open_movie(path: str):
    """The video track of an AVI, MP4/QuickTime, Matroska/WebM, IVF,
    YUV4MPEG2 or raw Motion-JPEG file, sniffed from its first bytes
    (utils/avi.py:AviMovie, utils/mp4.py:Mp4Movie, utils/mkv.py:MkvMovie,
    utils/ivf.py:IvfMovie, utils/y4m.py:Y4mMovie or utils/mjpeg.py:
    MjpegMovie); ValueError naming anything else."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF":
        return read_avi(path)
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return read_mkv(path)
    if head[:4] == b"DKIF":
        return read_ivf(path)
    if head.startswith(Y4M_SIGNATURE):
        return read_y4m(path)
    if head.startswith(MJPEG_SIGNATURE):
        return read_mjpeg(path)
    kind = file_kind(head)
    if kind is None:
        return read_mp4(path)
    raise ValueError(f"{path}: {kind}: the port reads AVI, MP4/QuickTime, Matroska, IVF, "
                     "YUV4MPEG2 and raw Motion-JPEG video only")


def video_writer(path: str):
    """The writer class for an output's name (VIDEO_OUT); ValueError for a
    name that gives none."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".webm":
        raise ValueError(f"{path}: WebM holds VP8, VP9 or AV1 only, and the demo writes "
                         "mp4v (the JAX writer opens nothing for a .webm and writes no "
                         "file); name the output .mkv, .mp4, .mov or .avi")
    if ext not in VIDEO_OUT:
        raise ValueError(f"{path}: the port writes mp4v in .mp4, .mov, .avi or .mkv; "
                         "name the output so")
    return VIDEO_OUT[ext]


class ImageReader:
    """Iterate (ok, rgb_image) over a single image or a directory tree.
    A directory lists the files of IMAGE_EXT; a single path is read
    whatever its kind, as cv2.imread reads it (a .jp2 or .j2k file
    included). On a CUDA `device` JPEG 2000 decodes by the host C++ twin of
    the plain decoder (csrc/j2k_decode.cu), on the CPU by the plain one:
    the same pixels."""

    def __init__(self, image_path: str, save_path: str | None = None,
                 device: str | torch.device = "cuda"):
        self.image_path = image_path
        self.device = torch.device(device)
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
                data = f.read()
            native = (decode.image_kind(data) == "jp2"
                      and resolve_device(self.device).type == "cuda")
            img = decode.decode_image(data, native)
            yield (img is not None), img

    def __len__(self):
        return len(self.files)


class VideoReader:
    """Iterate (ok, rgb_frame) over a video file (see the module
    docstring), ending with one (False, None), optionally prefetching
    frames on a reader thread so that reading and decoding overlap
    inference.

    Frames are (H, W, 3) uint8 RGB tensors on `device`. decoder "auto" (on
    the card) decodes Motion-JPEG through decode.decode_to (nvJPEG, or the
    host for a frame nvJPEG does not take), and MPEG-4, VP8, VP9 and JPEG
    2000 with the host C++ decoders; "plain" (and everything on the CPU)
    with data/decode.py's, data/mpeg4.py's, data/vp8.py's, data/vp9.py's
    and data/jp2.py's plain decoders; "nvjpeg" names the JPEG route and
    needs the card. PNG decodes on the host and raw video converts on the
    device whatever the decoder (`decoder` reads "plain" and "raw"). On the card the thread decodes on a stream of its own,
    and the consumer's stream waits on an event recorded after each frame.
    A Motion-JPEG frame the decoder refuses ends the stream there with a
    logged warning, as a failed cv2.VideoCapture.read does; it is not
    handed to the other decoder. An MPEG-4 stream the decoder refuses
    raises its Mpeg4Error: at construction when its VOL says so, else from
    the iteration at the VOP. A VP8 stream skips its hidden and empty
    frames, as cv2 does, and ends with a logged warning at a frame
    libavcodec refuses (vp8.Vp8Error), as cv2's read fails there; a frame
    the port refuses (vp8.Vp8Unsupported: a key frame that changes the
    size) raises. VP9 does the same with vp9.Vp9Error and
    vp9.Vp9Unsupported; a superframe shows at most one frame. `len()` is
    cv2's CAP_PROP_FRAME_COUNT for VP8 and VP9 (the container's count,
    hidden frames included), and for PNG, JPEG 2000 and raw video, as for
    a raw Motion-JPEG stream (OpenCV's estimate from no duration,
    -192153584101141: len() then raises, as the JAX reader's does). A PNG
    or JPEG 2000 frame that does not decode ends the stream with a logged
    warning; a raw packet short of a frame is skipped, as cv2 skips it.
    `save(frame)` appends an
    RGB frame (numpy or tensor) to `save_path` at the input's fps as mp4v,
    in the container its name gives (VIDEO_OUT)."""

    def __init__(self, video_path: str = "0", use_thread: bool = True,
                 save_path: str | None = None, prefetch: int = 4,
                 device: str | torch.device = "cuda", decoder: str = "auto"):
        if str(video_path).isnumeric():
            raise NotImplementedError(
                f"webcam {video_path}: the port reads no camera (there is no capture "
                "device on either machine it runs on); give a video file")
        if save_path is not None:
            video_writer(save_path)
        if decoder not in DECODERS:
            raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
        self.device = resolve_device(device)
        if decoder == "nvjpeg" and self.device.type != "cuda":
            raise ValueError(f"decoder 'nvjpeg' needs a CUDA device, not {self.device}")
        self.movie = open_movie(str(video_path))
        on_card = self.device.type == "cuda" and decoder != "plain"
        codec = self.movie.codec
        if codec not in ("mjpeg", "none") and decoder == "nvjpeg":
            raise ValueError(f"{video_path}: decoder 'nvjpeg' decodes JPEGs, and this is "
                             f"{CODEC_NAMES[codec]} video; use 'auto' or 'plain'")
        if codec in ("mpeg4", "vp8", "vp9", "jpeg2000"):
            self.decoder = "host_cpp" if on_card else "plain"
            if codec == "mpeg4":
                self._check_headers()
        elif codec == "mjpeg":
            self.decoder = "nvjpeg" if on_card else "plain"
        else:   # PNG (the plain decoder, on the host), raw (converted on the device)
            self.decoder = "plain" if codec == "png" else codec
        self.org_width, self.org_height = self.movie.width, self.movie.height
        self.fps = self.movie.fps or 30.0
        self.total_frames = len(self.movie.frames)
        count = getattr(self.movie, "frame_count", None)
        if count is not None and not (isinstance(self.movie, MkvMovie)
                                      and codec in ("mjpeg", "mpeg4")):
            self.total_frames = count
        if codec == "none":     # cv2 opens nothing: its properties read -1
            self.org_width = self.org_height = self.total_frames = -1
            self.fps = -1.0
        self.use_thread = use_thread
        self.save_path = save_path
        self.video_writer = None
        self.encoder = None
        self.prefetch = prefetch
        self._stop = threading.Event()
        self._thread = None

    def _check_headers(self) -> None:
        """Parse the MPEG-4 headers (the MP4's esds, or the AVI's first
        chunk) so that a VOL the decoder refuses raises here."""
        data = self.movie.config
        if not data and self.movie.frames:
            with open(self.movie.path, "rb") as f:
                data = self.movie.read_frame(f, 0)
        vol = mpeg4.read_vol(data)
        if vol is not None:
            self.movie.width, self.movie.height = vol.width, vol.height

    def _frames(self, stream=None):
        """(True, frame, ready event or None) per frame in order, then one
        (False, None, None); decoded on `stream` when given."""
        codec = None
        device = "cuda" if self.decoder == "host_cpp" else "cpu"
        if self.movie.codec == "mpeg4":
            codec = mpeg4.Mpeg4Decoder(self.movie.config or None, device,
                                       codec_tag=self.movie.tag)
        elif self.movie.codec == "vp8":
            codec = vp8.Vp8Decoder(device)
        elif self.movie.codec == "vp9":
            codec = vp9.Vp9Decoder(device)
        # a movie cv2 cannot open ("none") reads no frame
        n = 0 if self.movie.codec == "none" else len(self.movie.frames)
        try:
            with open(self.movie.path, "rb") as f:
                for i in range(n):
                    if self._stop.is_set():
                        break
                    data = self.movie.read_frame(f, i)
                    if isinstance(codec, (vp8.Vp8Decoder, vp9.Vp9Decoder)):
                        if not data:                # cv2 skips an empty frame
                            continue
                        try:
                            planes = codec.decode(data)
                        except (vp8.Vp8Unsupported, vp9.Vp9Unsupported):
                            raise
                        except (vp8.Vp8Error, vp9.Vp9Error) as e:
                            logger.warning("%s: frame %d does not decode (%s): the stream "
                                           "ends there", self.movie.path, i, e)
                            break
                        if planes is None:          # show_frame 0 (a hidden frame)
                            continue
                        full = codec.range()
                        frame, ready = _on_stream(stream, lambda: self._rgb(planes, full))
                    elif codec is not None:
                        planes = codec.decode(data)
                        if planes is None:          # headers only
                            continue
                        frame, ready = _on_stream(stream, lambda: self._rgb(planes))
                    elif self.movie.codec == "jpeg2000":
                        try:
                            planes = self._jp2_planes(data)
                        except jp2.Jp2Error as e:
                            logger.warning("%s: frame %d does not decode (%s): the stream "
                                           "ends there", self.movie.path, i, e)
                            break
                        frame, ready = _on_stream(stream, lambda: self._rgb(planes))
                    elif self.movie.codec == "raw":
                        frame, ready = _on_stream(stream, lambda: rawvideo.to_rgb(
                            data, self.movie.pix_fmt, self.movie.width, self.movie.height,
                            self.device))
                        if frame is None:           # shorter than a frame: cv2 skips it
                            continue
                    else:
                        frame, ready = _on_stream(stream, lambda: self._decode(data))
                        if frame is None:
                            logger.warning("%s: frame %d does not decode (%s decoder): the "
                                           "stream ends there", self.movie.path, i,
                                           self.decoder)
                            break
                    yield True, frame, ready
        finally:
            if codec is not None:
                codec.close()
        yield False, None, None

    def _rgb(self, planes, full_range: bool = False) -> torch.Tensor:
        """MPEG-4, VP8, VP9 or JPEG 2000 planes to RGB on the device (uploaded
        first): 4:2:0 by yuv420_to_rgb, one grey plane in all three channels."""
        planes = [torch.from_numpy(p).to(self.device, non_blocking=True) for p in planes]
        if len(planes) == 1:
            return planes[0][..., None].expand(*planes[0].shape, 3).contiguous()
        return mpeg4.yuv420_to_rgb(*planes, full_range)

    def _jp2_planes(self, data: bytes) -> list:
        """A Motion JPEG 2000 frame's planes: the host C++ twin on the card
        (it raises if it does not build or load), else the plain decoder."""
        if self.decoder == "host_cpp":
            return jp2.decode_jp2_planes_c(data)
        return jp2.decode_jp2_planes(data)

    def _decode(self, data: bytes) -> torch.Tensor | None:
        """A Motion-JPEG frame (nvJPEG's route or the plain decoder) or a
        PNG frame (the plain decoder) on the device; None where it does not
        decode."""
        if self.decoder == "nvjpeg":
            return decode.decode_to(data, self.device)
        kind = "png" if self.movie.codec == "png" else "jpeg"
        rgb = decode.decode_image(data) if decode.image_kind(data) == kind else None
        return None if rgb is None else torch.from_numpy(rgb).to(self.device)

    def _reader(self, out: queue.Queue, stream):
        try:
            for item in self._frames(stream):
                self._put(out, item)
        except Exception as e:   # handed to the consumer, which raises it
            self._put(out, (None, e, None))

    def _put(self, out: queue.Queue, item) -> None:
        while not self._stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def save(self, frame) -> None:
        """Append `frame` ((H, W, 3) uint8 RGB) to save_path: one VOP of
        mpeg4.Mp4vEncoder (I every KEY_INTERVAL frames) in the container the
        name gives (an AVI's first chunk carries the VOL headers too)."""
        if not self.save_path:
            return
        rgb = frame.cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)
        h, w = rgb.shape[:2]
        if self.video_writer is None:
            self.encoder = mpeg4.Mp4vEncoder(w, h, self.fps)
            kind = video_writer(self.save_path)
            self.video_writer = (kind(self.save_path, self.fps, b"mp4v") if kind is AviWriter
                                 else kind(self.save_path, self.fps))
        vop, key = self.encoder.encode(rgb)
        if isinstance(self.video_writer, AviWriter):
            first = not self.video_writer.index
            self.video_writer.write((self.encoder.headers() if first else b"") + vop, w, h, key)
        else:
            self.video_writer.write(vop, key, w, h, self.encoder.headers())

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
            if ok is None:
                self.stop()
                raise frame
            if ok:
                _await(frame, ready)
            yield ok, frame
            if not ok:
                return

    def __len__(self):
        return self.total_frames
