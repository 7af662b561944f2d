"""Raw (uncompressed) video frames as cv2.VideoCapture gives them:
libavcodec's rawvideo decoder, then swscale to BGR (here RGB).

A container names a raw frame's layout by a fourcc (an AVI's
BITMAPINFOHEADER, a QuickTime sample entry, a Matroska track's
ColourSpace) or by its header (YUV4MPEG2's C field). libavformat maps
that to a pixel format (raw.c's tables); the rawvideo decoder refuses a
packet shorter than a frame of that format (cv2's read then skips it:
cv2 writes UYVY and YUY2 AVIs whose packets hold I420 planes, and reads
no frame from them) and reads the frame from the packet's first bytes (a
Y800 AVI from cv2 holds I420 planes: the grey frame is their Y plane).

The layouts the port converts are those whose swscale conversion it
reproduces bit for bit (checked against cv2 on this cv2's files):

- "yuv420p" (I420, IYUV) and "yvu420p" (YV12: V before U), limited range,
  and "yuvj420p" (J420), full range: the planes through
  data/mpeg4.py:yuv420_to_rgb;
- "gray" (Y800, 'Y8  ', GREY): the samples in all three channels;
- "rgba" (RGBA): R, G, B, A top-down; the first three channels.

A full frame of another layout libavformat maps (NV12, NV21, YUY2, UYVY,
YV16, BGRA) raises naming it (RawVideoUnsupported); a short packet of any
layout gives no frame, as in cv2.
"""

from __future__ import annotations

import torch

from vision_kit_tpu_torch.data.mpeg4 import yuv420_to_rgb

# the AVI fourccs (exact or upper case, as libavformat matches them) of
# raw.c's PIX_FMT_LIST_AVI that this cv2 writes, by pixel format
AVI_FOURCCS = {b"I420": "yuv420p", b"IYUV": "yuv420p", b"YV12": "yvu420p",
               b"J420": "yuvj420p", b"Y800": "gray", b"Y8  ": "gray", b"GREY": "gray",
               b"RGBA": "rgba", b"BGRA": "bgra", b"NV12": "nv12", b"NV21": "nv21",
               b"YUY2": "yuyv422", b"UYVY": "uyvy422", b"YV16": "yvu422p"}
CONVERTED = ("yuv420p", "yvu420p", "yuvj420p", "gray", "rgba")


class RawVideoUnsupported(ValueError):
    """A raw frame whose layout cv2 reads and the port does not convert."""


def fourcc_format(tag: bytes) -> str | None:
    """The pixel format libavformat gives `tag` (exact, then upper case)."""
    if tag in AVI_FOURCCS:
        return AVI_FOURCCS[tag]
    return next((fmt for cc, fmt in AVI_FOURCCS.items() if cc.upper() == tag.upper()), None)


def frame_bytes(fmt: str, width: int, height: int) -> int:
    """The bytes of one frame of `fmt` (av_image_get_buffer_size, align 1)."""
    cw, ch = (width + 1) // 2, (height + 1) // 2
    if fmt in ("yuv420p", "yvu420p", "yuvj420p", "nv12", "nv21"):
        return width * height + 2 * cw * ch
    if fmt == "gray":
        return width * height
    if fmt in ("rgba", "bgra"):
        return 4 * width * height
    if fmt in ("yuyv422", "uyvy422"):
        return 4 * cw * height
    if fmt == "yvu422p":
        return width * height + 2 * cw * height
    raise ValueError(f"no raw video layout {fmt!r}")


def to_rgb(data: bytes, fmt: str, width: int, height: int,
           device: str | torch.device = "cpu") -> torch.Tensor | None:
    """(H, W, 3) uint8 RGB of a raw frame, as cv2 reads it: the packet's
    bytes uploaded to `device` and converted there; None for a packet
    shorter than a frame (libavcodec refuses it, and cv2 skips it);
    RawVideoUnsupported for a full frame of a layout not in CONVERTED."""
    n = frame_bytes(fmt, width, height)
    if len(data) < n:
        return None
    if fmt not in CONVERTED:
        raise RawVideoUnsupported(
            f"raw video in {fmt} (cv2 reads it through swscale's {fmt} -> BGR24): the port "
            f"converts {', '.join(CONVERTED)} only")
    flat = torch.frombuffer(bytearray(data[:n]), dtype=torch.uint8).to(device)
    if fmt == "gray":
        return flat.view(height, width, 1).expand(height, width, 3).contiguous()
    if fmt == "rgba":
        return flat.view(height, width, 4)[..., :3].contiguous()
    cw, ch = (width + 1) // 2, (height + 1) // 2
    y = flat[:width * height].view(height, width)
    a = flat[width * height:width * height + cw * ch].view(ch, cw)
    b = flat[width * height + cw * ch:].view(ch, cw)
    u, v = (b, a) if fmt == "yvu420p" else (a, b)
    return yuv420_to_rgb(y, u, v, fmt == "yuvj420p")
