"""The video files whose codec the port decodes behind the tags and
containers cv2 writes for them (Motion-JPEG in MP4/QuickTime, raw
`.mjpeg`, XVID/DIVX in `.mov`, JPGL/LJPG in AVI, PNG frames, Motion JPEG
2000 and raw video in AVI, Matroska, QuickTime and YUV4MPEG2), written
with this environment's cv2 (OpenCV 5.0.0's FFMPEG writer, libavformat
62), and the committed fixtures the card reads them from
(vision_kit_tpu_torch/data/video_samples/tags/). The card's machine has
no cv2, so the clips and the sha256 of cv2's decode of every frame are
committed:

    python tests/torch_video_tag_samples.py     # rewrites the folder

PAIRS is every (fourcc, extension) of the probe that cv2 writes and reads
back and that the port now reads, with the port's codec; EMPTY the ones
cv2 writes and reads no frame from. MANIFEST.json gives each fixture's
sha256, bytes, cv2's CAP_PROP_FRAME_COUNT ("frames"; a raw .mjpeg's is
OpenCV's estimate from no duration) and CAP_PROP_FPS, the frames cv2
reads ("read"), the size, the port's codec and `rgb_sha256` (cv2's frames,
BGR2RGB), which the port's frames equal. A Motion-JPEG fixture also has
`plain_rgb_sha256`, the port's plain read of each frame (libjpeg's), and
`max_abs`, its largest difference from cv2's frames (libavcodec's
decoder).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

from torch_mpeg4_samples import moving, read_cv2, write_cv2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG_SAMPLES = os.path.join(REPO, "vision_kit_tpu_torch", "data", "video_samples", "tags")
FPS = 10.0

PAIRS = [("MJPG", ".mp4", "mjpeg"), ("JPGL", ".mp4", "mjpeg"), ("LJPG", ".mp4", "mjpeg"),
         ("MJPG", ".mov", "mjpeg"), ("LJPG", ".mov", "mjpeg"), ("JPGL", ".avi", "mjpeg"),
         ("LJPG", ".avi", "mjpeg"), ("MJPG", ".mjpeg", "mjpeg"), ("MJPG", ".mjpg", "mjpeg"),
         ("XVID", ".mov", "mpeg4"), ("DIVX", ".mov", "mpeg4"),
         ("png ", ".avi", "png"), ("MPNG", ".avi", "png"), ("png ", ".mkv", "png"),
         ("png ", ".mp4", "png"), ("png ", ".mov", "png"),
         ("MJ2C", ".avi", "jpeg2000"), ("MJ2C", ".mkv", "jpeg2000"),
         ("mjp2", ".mp4", "jpeg2000"), ("mjp2", ".mov", "jpeg2000"),
         ("I420", ".avi", "raw"), ("IYUV", ".avi", "raw"), ("YV12", ".avi", "raw"),
         ("J420", ".avi", "raw"), ("Y800", ".avi", "raw"), ("GREY", ".avi", "raw"),
         ("RGBA", ".avi", "raw"), ("I420", ".mkv", "raw"), ("Y800", ".mkv", "raw"),
         ("RGBA", ".mkv", "raw"), ("RGBA", ".mov", "raw"), ("I420", ".y4m", "raw"),
         ("YV12", ".y4m", "raw")]
EMPTY = [("UYVY", ".avi"), ("YUY2", ".avi"), ("I420", ".mov"), ("IYUV", ".mov"),
         ("Y800", ".mov")]
# the committed fixtures: name -> (fourcc, height, width, frames)
FIXTURES = {
    "mjpg_144x176.mp4": ("MJPG", 144, 176, 4), "mjpg_144x176.mov": ("MJPG", 144, 176, 4),
    "jpgl_144x176.avi": ("JPGL", 144, 176, 4), "mjpg_144x176.mjpeg": ("MJPG", 144, 176, 4),
    "xvid_144x176.mov": ("XVID", 144, 176, 4),
    "png_64x96.avi": ("png ", 64, 96, 3), "png_64x96.mkv": ("png ", 64, 96, 3),
    "png_64x96.mp4": ("png ", 64, 96, 3), "png_64x96.mov": ("png ", 64, 96, 3),
    "mj2c_64x96.avi": ("MJ2C", 64, 96, 3), "mj2c_64x96.mkv": ("MJ2C", 64, 96, 3),
    "mjp2_64x96.mp4": ("mjp2", 64, 96, 3), "mjp2_64x96.mov": ("mjp2", 64, 96, 6),
    "i420_64x96.avi": ("I420", 64, 96, 3), "y800_64x96.avi": ("Y800", 64, 96, 3),
    "rgba_64x96.avi": ("RGBA", 64, 96, 3), "i420_64x96.mkv": ("I420", 64, 96, 3),
    "rgba_64x96.mov": ("RGBA", 64, 96, 3), "i420_64x96.y4m": ("I420", 64, 96, 3),
    "uyvy_64x96.avi": ("UYVY", 64, 96, 3),
}


def clip(h: int, w: int, n: int, seed: int = 3) -> list:
    """A seeded scene panning 2 columns and 1 row a frame."""
    return moving("pan", h, w, n, seed)


def port_plain(path: str) -> list:
    """The port's frames of `path` through its plain decoders on the CPU."""
    sys.path.insert(0, REPO)
    from vision_kit_tpu_torch.utils.readers import VideoReader

    reader = VideoReader(path, use_thread=False, device="cpu")
    return [f.numpy() for ok, f in reader if ok]


def write() -> dict:
    from vision_kit_tpu_torch.utils.readers import open_movie

    os.makedirs(TAG_SAMPLES, exist_ok=True)
    files = {}
    for name, (fourcc, h, w, n) in FIXTURES.items():
        path = os.path.join(TAG_SAMPLES, name)
        write_cv2(path, clip(h, w, n), fourcc, FPS)
        got, count, fps = read_cv2(path)
        with open(path, "rb") as f:
            data = f.read()
        files[name] = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
                       "frames": int(count), "fps": fps, "read": len(got),
                       "width": w, "height": h, "codec": open_movie(path).codec,
                       "rgb_sha256": [hashlib.sha256(g.tobytes()).hexdigest() for g in got]}
        if files[name]["codec"] == "mjpeg":
            plain = port_plain(path)
            files[name]["plain_rgb_sha256"] = [hashlib.sha256(p.tobytes()).hexdigest()
                                               for p in plain]
            files[name]["max_abs"] = max(int(np.abs(p.astype(np.int16) - g).max())
                                         for p, g in zip(plain, got))
    manifest = {"writer": "cv2.VideoWriter (OpenCV 5.0.0, FFMPEG, libavformat 62)",
                "files": files}
    with open(os.path.join(TAG_SAMPLES, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, REPO)
    for name, meta in write()["files"].items():
        print(name, meta["bytes"], meta["frames"], meta["read"], meta["fps"],
              meta.get("max_abs", ""))
