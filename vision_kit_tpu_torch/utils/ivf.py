"""IVF in: the demultiplexer of the demo's VP8 and VP9 video modes.

IVF is libvpx's raw container, which cv2.VideoWriter writes for an `.ivf`
name (fourcc VP80 or VP90) and cv2.VideoCapture reads through libavformat's ivf
demuxer (ivfdec.c). `read_ivf(path)` reads it as that demuxer does:

- the 32-byte header: "DKIF", a version and a header size (both ignored:
  the frames always start at byte 32), the fourcc (mapped to a codec by
  libavformat's BMP tags, exactly or in upper case: VP80 is VP8 and VP90
  VP9, which the port decodes; AV01 and the rest raise naming what they
  are),
  the width and height, the time base's denominator and numerator (a
  zero in either is refused, as libavformat refuses it), and the length
  (the stream's nb_frames);
- then frames of a 12-byte header (a 32-bit size, a 64-bit pts) and their
  bytes, to the end of the file (a frame cut short by the end keeps the
  bytes there are).

`fps` is cv2's CAP_PROP_FPS (libavformat's r_frame_rate): the inverse
time base when it is a plausible frame rate (5 to 100 frames a second,
tb_unreliable false), else the standard rate ff_rfps_calculate fits to the
first timestamps (utils/mkv.py:_rfps), falling back to the inverse time
base. `frame_count` is cv2's CAP_PROP_FRAME_COUNT: the header's length.
"""

from __future__ import annotations

import dataclasses
import fractions
import os
import struct

from vision_kit_tpu_torch.utils.mkv import RFPS_PACKETS, _rfps

SIGNATURE = b"DKIF"
# fourccs of libavformat's BMP tags that IVF files carry, by codec name
CODECS = {b"VP80": "vp8", b"VP90": "vp9"}
OTHER_FOURCCS = {b"AV01": "AV1", b"H264": "H.264", b"HEVC": "HEVC",
                 b"VP70": "VP7", b"VP60": "VP6", b"VP40": "VP4", b"VP30": "VP3"}


@dataclasses.dataclass
class IvfMovie:
    """An IVF file's frames: `frames` holds each frame's (file offset,
    size), `pts` its timestamp in time-base units (`rate` / `scale` ticks a
    second)."""

    path: str
    width: int
    height: int
    rate: int
    scale: int
    length: int
    frames: list
    pts: list
    tag: bytes = b"VP80"
    codec: str = "vp8"
    config: bytes = b""

    @property
    def fps(self) -> float:
        """CAP_PROP_FPS as cv2 reads it (see the module docstring)."""
        if 5 * self.scale <= self.rate < 101 * self.scale:
            return self.rate / self.scale
        fit = _rfps(self.pts[:RFPS_PACKETS], fractions.Fraction(self.scale, self.rate))
        return fit or self.rate / self.scale

    @property
    def frame_count(self) -> int:
        """CAP_PROP_FRAME_COUNT as cv2 reads it: the header's length."""
        return self.length

    def read_frame(self, f, i: int) -> bytes:
        offset, size = self.frames[i]
        f.seek(offset)
        return f.read(size)


def read_ivf(path: str) -> IvfMovie:
    """The frames of the IVF file at `path` (see the module docstring);
    ValueError for anything else."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(32)
        if len(head) < 32 or head[:4] != SIGNATURE:
            raise ValueError(f"{path}: not an IVF file (no 32-byte DKIF header)")
        tag = head[8:12]
        width, height, rate, scale, length = struct.unpack("<HHIII", head[12:28])
        codec = CODECS.get(tag, CODECS.get(tag.upper()))
        if codec is None:
            name = OTHER_FOURCCS.get(tag.upper(), "")
            raise ValueError(f"{path}: the IVF video is {tag.decode('latin-1')!r}"
                             f"{' (' + name + ')' if name else ''}: the port decodes VP8 "
                             "and VP9 only in IVF")
        if not rate or not scale:
            raise ValueError(f"{path}: an IVF time base of {scale}/{rate}")
        frames, pts = [], []
        pos = 32
        while pos + 12 <= size:
            f.seek(pos)
            n, t = struct.unpack("<IQ", f.read(12))
            frames.append((pos + 12, min(n, size - pos - 12)))
            pts.append(t - (1 << 64) if t >> 63 else t)
            pos += 12 + n
    return IvfMovie(path, width, height, rate, scale, length, frames, pts, tag, codec)
