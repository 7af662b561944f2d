"""Demo inputs: image files and directories.

Counterpart of vision_kit_tpu/utils/readers.py without OpenCV. Images are
read through data/decode.py:decode_image (the plain JPEG/PNG decoder,
equal to cv2.imdecode + BGR2RGB bit for bit), so an ImageReader yields RGB
where the JAX one yields cv2.imread's BGR, and a file the port does not
decode (WebP, BMP, a progressive JPEG, ...) yields (False, None) where cv2
may read it. `save` writes a PNG (`<name>_res.png`, decode.encode_png),
where the JAX reader writes a cv2 JPEG (`<name>_res.jpg`): the port has no
JPEG encoder. Video and webcam input (VideoReader) needs cv2.VideoCapture
and is not ported.
"""

from __future__ import annotations

import os

from vision_kit_tpu_torch.data.decode import decode_image, encode_png

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
        """Write an RGB image as <save_path>/<filename's stem>_res.png."""
        name = os.path.splitext(os.path.basename(filename))[0] + "_res.png"
        out = os.path.join(self.save_path, name)
        with open(out, "wb") as f:
            f.write(encode_png(image))
        return out

    def __iter__(self):
        for path in self.files:
            with open(path, "rb") as f:
                img = decode_image(f.read())
            yield (img is not None), img

    def __len__(self):
        return len(self.files)


class VideoReader:
    """Video files and webcams: not ported (they need cv2.VideoCapture)."""

    def __init__(self, video_path: str = "0", *args, **kwargs):
        raise NotImplementedError(
            f"{video_path}: video and webcam input is not ported: it needs a video "
            "decoder (cv2.VideoCapture); see ROADMAP.md, Queue 1")
