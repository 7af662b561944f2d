"""Raw Motion-JPEG in: the demultiplexer of the demo's `.mjpeg` video.

cv2.VideoWriter writes an `.mjpeg` or `.mjpg` name (fourcc MJPG) through
libavformat's raw mjpeg muxer: the frames' JPEGs back to back, with no
container. cv2.VideoCapture reads it through the raw mjpeg demuxer and
libavcodec's mjpeg parser, which `read_mjpeg(path)` follows:

- a frame starts at an SOI followed by a marker (FF D8 FF C0..FF, the
  parser's window of four bytes) and runs to the next such start or the
  end of the file. The walk skips each marker segment's payload by its
  length (a marker other than SOI, EOI and the RSTs), so an SOI inside a
  segment (an EXIF thumbnail) starts nothing, and reads scan data a byte
  at a time (stuffed FF 00 and RST markers start nothing).
- `fps` is the raw demuxer's default frame rate, 25, as cv2 reports it;
  `frame_count` is cv2's CAP_PROP_FRAME_COUNT: libavformat knows no
  duration, and OpenCV's estimate from it (AV_NOPTS_VALUE times the time
  base 1/1200000, times 25, rounded) is -192153584101141. The JAX reader
  reports that count; a frame count the file does not give.
- the size is the first frame's SOF.
"""

from __future__ import annotations

import dataclasses
import math

RATE = 25.0                 # libavformat's raw video demuxers' default framerate
TIME_BASE = 1 / 1200000     # the raw mjpeg demuxer's
NOPTS = -(1 << 63)          # AV_NOPTS_VALUE
# cv2's CAP_PROP_FRAME_COUNT with no duration known (cap_ffmpeg_impl.hpp:
# floor(duration_sec * fps + 0.5), the duration AV_NOPTS_VALUE x time base)
FRAME_COUNT = math.floor(float(NOPTS) * TIME_BASE * RATE + 0.5)
SIGNATURE = b"\xff\xd8\xff"


@dataclasses.dataclass
class MjpegMovie:
    """A raw Motion-JPEG file's frames: each frame's (file offset, size)."""

    path: str
    width: int
    height: int
    frames: list
    fps: float = RATE
    frame_count: int = FRAME_COUNT
    codec: str = "mjpeg"
    tag: bytes = b""
    config: bytes = b""

    def read_frame(self, f, i: int) -> bytes:
        offset, size = self.frames[i]
        f.seek(offset)
        return f.read(size)


def frame_starts(data: bytes) -> list:
    """Where libavcodec's mjpeg parser starts each frame of `data`."""
    starts, i, n = [], 0, len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 3 >= n:
            return starts
        m = data[j + 1]
        if m < 0xC0 or m == 0xFF:
            i = j + 1
        elif m == 0xD8 and data[j + 2] == 0xFF and data[j + 3] >= 0xC0:
            starts.append(j)
            i = j + 2               # the marker after the SOI
        elif 0xD0 <= m <= 0xD9:     # RSTn, a lone SOI, EOI: no length
            i = j + 1
        else:
            size = (data[j + 2] << 8 | data[j + 3]) - 1
            i = j + 3 + size if size > 0 else j + 1


def read_mjpeg(path: str) -> MjpegMovie:
    """The frames of the raw Motion-JPEG file at `path` (see the module
    docstring); ValueError when it holds none."""
    from vision_kit_tpu_torch.data.decode import JpegError, jpeg_header

    with open(path, "rb") as f:
        data = f.read()
    starts = frame_starts(data)
    if not starts:
        raise ValueError(f"{path}: no JPEG frame (an SOI followed by a marker)")
    frames = [(a, b - a) for a, b in zip(starts, starts[1:] + [len(data)])]
    try:
        info = jpeg_header(data[frames[0][0]:frames[0][0] + frames[0][1]])
        width, height = info["width"], info["height"]
    except JpegError:
        width = height = 0
    return MjpegMovie(path, width, height, frames)
