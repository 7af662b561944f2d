"""YUV4MPEG2 in: the demultiplexer of the demo's raw .y4m video.

cv2.VideoWriter writes a `.y4m` name (fourcc I420, IYUV or YV12: the
same bytes) through libavformat's yuv4mpegpipe muxer, and cv2.VideoCapture
reads it through yuv4mpegdec.c. `read_y4m(path)` reads it as that
demuxer does:

- the stream header: "YUV4MPEG2", then space-separated tokens up to a
  newline: W (width), H (height), F (frame rate num:den; 25:1 when
  absent or not positive), C (the chroma layout), I (interlacing), A
  (aspect), X (extensions: XCOLORRANGE=FULL or LIMITED; an XYSCSS=
  layout stands where there is no C). Unknown tokens are skipped.
- C: 420jpeg, 420mpeg2, 420paldv and 420 are 4:2:0 (yuv420p: the chroma
  siting, which swscale does not read, is their only difference; the
  default without C), mono is grey; every other layout libavformat knows
  (411, 422, 444, 444alpha, mono16 and the high bit depths) raises naming
  it: the port has no swscale conversion of it.
- each frame: "FRAME", its own parameters up to a newline, then the
  frame's bytes (data/rawvideo.py:frame_bytes), to the end of the file.

`fps` is cv2's CAP_PROP_FPS (F's num / den), `frame_count` its
CAP_PROP_FRAME_COUNT: the bytes after the header over a frame and its
6-byte "FRAME\\n" (libavformat's duration), and a frame cut short by the
end of the file gives none.
"""

from __future__ import annotations

import dataclasses
import os

from vision_kit_tpu_torch.data import rawvideo

SIGNATURE = b"YUV4MPEG2"
MAX_HEADER = 128          # yuv4mpegdec.c's MAX_YUV4_HEADER
FRAME_MAGIC = b"FRAME"
LAYOUTS = {"420jpeg": "yuv420p", "420mpeg2": "yuv420p", "420paldv": "yuv420p",
           "420": "yuv420p", "mono": "gray"}


@dataclasses.dataclass
class Y4mMovie:
    """A YUV4MPEG2 file's frames: `frames` holds each frame's (file offset,
    size); `pix_fmt` their layout (data/rawvideo.py; "yuvj420p" for
    4:2:0 under XCOLORRANGE=FULL)."""

    path: str
    width: int
    height: int
    rate: int
    scale: int
    frames: list
    frame_count: int
    pix_fmt: str = "yuv420p"
    codec: str = "raw"
    tag: bytes = b""
    config: bytes = b""

    @property
    def fps(self) -> float:
        return self.rate / self.scale

    def read_frame(self, f, i: int) -> bytes:
        offset, size = self.frames[i]
        f.seek(offset)
        return f.read(size)


def read_y4m(path: str) -> Y4mMovie:
    """The header and frames of the YUV4MPEG2 file at `path` (see the
    module docstring); ValueError for anything else."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(MAX_HEADER)
        end = head.find(b"\n")
        if not head.startswith(SIGNATURE) or end < 0:
            raise ValueError(f"{path}: not a YUV4MPEG2 file (no header line)")
        width = height = 0
        rate, scale = 25, 1
        layout, alt, full = None, None, False
        for token in head[len(SIGNATURE):end].decode("latin-1").split():
            key, value = token[0], token[1:]
            if key == "W":
                width = int(value)
            elif key == "H":
                height = int(value)
            elif key == "F":
                num, _, den = value.partition(":")
                if int(num) > 0 and int(den or 0) > 0:
                    rate, scale = int(num), int(den)
            elif key == "C":
                layout = value
            elif key == "X" and value.startswith("YSCSS="):
                alt = value[6:].lower()
            elif key == "X" and value.startswith("COLORRANGE="):
                full = value[11:] == "FULL"
        layout = layout or alt or "420jpeg"
        if layout not in LAYOUTS:
            raise ValueError(f"{path}: YUV4MPEG2 chroma layout C{layout}: the port reads "
                             f"{', '.join('C' + k for k in LAYOUTS)} only")
        if width <= 0 or height <= 0:
            raise ValueError(f"{path}: a YUV4MPEG2 header of {width}x{height}")
        pix_fmt = LAYOUTS[layout]
        frame = rawvideo.frame_bytes(pix_fmt, width, height)
        start = end + 1
        count = (size - start) // (frame + len(FRAME_MAGIC) + 1)
        frames, pos = [], start
        while pos + len(FRAME_MAGIC) <= size:
            f.seek(pos)
            line = f.read(MAX_HEADER)
            stop = line.find(b"\n")
            if not line.startswith(FRAME_MAGIC) or stop < 0:
                break
            pos += stop + 1
            if pos + frame > size:
                break
            frames.append((pos, frame))
            pos += frame
    if full and pix_fmt == "yuv420p":
        pix_fmt = "yuvj420p"
    return Y4mMovie(path, width, height, rate, scale, frames, count, pix_fmt)
