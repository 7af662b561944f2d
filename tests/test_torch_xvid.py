"""libavcodec's encoder identification in data/mpeg4.py (EncoderId) and
csrc/mpeg4_decode.cu: a stream libavcodec takes as XviD's decodes with its
XviD IDCT (the SSE2 version cv2's x86-64 build runs), and the edge and DC
clip workarounds its rule switches on change a Simple Profile picture.

Random valid streams (torch_mpeg4_samples.random_stream) at sizes off the
MB grid, tagged XVID / XVIX or carrying XviD<n>, DivX, Lavc or FFmpeg user
data, in an AVI and in Matroska (a V_MS/VFW/FOURCC track for the tag,
V_MPEG4/ISO/ASP for user data), decode as cv2.VideoCapture decodes them at
MPEG4_TOLERANCE zero, in the plain decoder and in the C++ one built here
with g++ (test_torch_mpeg4.py:c_decoder); every fourcc of
utils/avi.py:MPEG4_FOURCCS reads as cv2 reads it."""

import numpy as np
import pytest
import torch

from test_torch_mpeg4 import c_decoder  # noqa: F401  (the fixture)
from torch_mkv_samples import bitmapinfoheader, build
from torch_mpeg4_samples import random_avi, random_stream, read_cv2
from vision_kit_tpu_torch.data import mpeg4
from vision_kit_tpu_torch.utils.avi import MPEG4_FOURCCS, OTHER_FOURCCS
from vision_kit_tpu_torch.utils.mkv import VFW
from vision_kit_tpu_torch.utils.readers import open_movie

torch.set_num_threads(2)


def decode(path: str, device: str = "cpu") -> list:
    """RGB frames of a clip by Mpeg4Decoder, with the container's tag."""
    movie = open_movie(path)
    dec = mpeg4.Mpeg4Decoder(movie.config or None, device, codec_tag=movie.tag)
    out = []
    with open(path, "rb") as f:
        for i in range(len(movie.frames)):
            planes = dec.decode(movie.read_frame(f, i))
            if planes is not None:
                out.append(mpeg4.yuv420_to_rgb(*(torch.from_numpy(p) for p in planes)).numpy())
    dec.close()
    return out


def assert_as_cv2(path: str) -> list:
    want, _, _ = read_cv2(path)
    got = decode(path)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (i, int(np.abs(g.astype(int) - w).max()))
    return got


# (tag, user data, what libavcodec infers): the rows of the XviD probe, the
# builds at the edges of each workaround, and the other encoders' user data
CASES = [(b"XVID", b"", "xvid 0"), (b"xvid", b"", "xvid 0"), (b"XVIX", b"", "xvid 0"),
         (b"RMP4", b"", "xvid 0"), (b"FMP4", b"XviD0050", "xvid 50"),
         (b"FMP4", b"XviD0002", "xvid 2"), (b"FMP4", b"XviD0012", "xvid 12"),
         (b"FMP4", b"XviD0013", "xvid 13"), (b"FMP4", b"XviD0032", "xvid 32"),
         (b"FMP4", b"XviD0033", "xvid 33"), (b"XVID", b"Lavc62.0.0", "lavc"),
         (b"XVID", b"DivX503b1393p", "divx 503"), (b"FMP4", b"DivX400b200", "divx 400"),
         (b"FMP4", b"ffmpeg", "lavc 4600"), (b"DIVX", b"", "none"), (b"FMP4", b"", "none")]


@pytest.mark.parametrize("container", ["avi", "mkv"])
@pytest.mark.parametrize("tag,user,what", CASES, ids=[f"{t.decode()}-{u.decode() or 'none'}"
                                                      for t, u, _ in CASES])
def test_tagged_streams_decode_as_cv2(tmp_path, c_decoder, container, tag, user, what):
    """Two streams of each case, 150x100 (the edge workaround shows off
    the MB grid): one with video packets, one whose intra DCs run past 2047
    (the DC clip workaround). In Matroska the tag rides a VFW track, or
    without one (user data alone) a V_MPEG4/ISO/ASP track."""
    for seed, kw in ((1, {"resync": True}), (2, {"bright": True})):
        path = str(tmp_path / f"s{seed}.{container}")
        headers, vops = random_stream(seed, 150, 100, 6, user_data=user, **kw)
        frames, keys = [v for v, _ in vops], [k for _, k in vops]
        if container == "avi":
            from vision_kit_tpu_torch.utils.avi import AviWriter

            with AviWriter(path, 30.0, tag) as w:
                for i, (vop, key) in enumerate(vops):
                    w.write((headers if i == 0 else b"") + vop, 150, 100, key)
        elif tag in (b"FMP4",) and user:
            build(path, frames, keys, 150, 100, private=headers, fps=30.0)
        else:
            build(path, frames, keys, 150, 100, codec_id=VFW, fps=30.0,
                  private=bitmapinfoheader(150, 100, tag, headers))
        plain = assert_as_cv2(path)
        native = decode(path, "cuda")
        assert all(np.array_equal(a, b) for a, b in zip(plain, native))
        movie = open_movie(path)
        decs = [mpeg4.Mpeg4Decoder(device=d, codec_tag=movie.tag) for d in ("cpu", "cuda")]
        with open(path, "rb") as f:
            for i in range(len(movie.frames)):
                data = (movie.config if i == 0 else b"") + movie.read_frame(f, i)
                for dec in decs:
                    dec.decode(data)
        assert decs[0].identity() == decs[1].identity()
        decs[1].close()
        e = decs[0].encoder
        kind, _, n = what.partition(" ")
        if kind == "xvid":
            assert (e.xvid_build, e.xvid_idct) == (int(n), True)
            assert e.edge_bug == (int(n) <= 12) and e.dc_clip_bug == (int(n) <= 32)
        else:
            assert not e.xvid_idct and e.xvid_build == -1
            assert e.edge_bug == (what in ("divx 400", "lavc 4600"))
            assert e.dc_clip_bug == (what == "lavc 4600")


@pytest.mark.parametrize("fourcc", MPEG4_FOURCCS)
def test_every_mpeg4_fourcc_reads_as_cv2(tmp_path, fourcc):
    path = str(tmp_path / "clip.avi")
    random_avi(path, 3, 80, 64, 3, fourcc)
    assert_as_cv2(path)


def test_geovision_fourccs_are_refused(tmp_path):
    """GEOV and GEOX map to MPEG-4 in libavformat, whose decoder treats
    them otherwise (its frames differ from the plain decode); the port
    refuses them by name."""
    for fourcc in (b"GEOV", b"GEOX"):
        assert fourcc not in MPEG4_FOURCCS and fourcc in OTHER_FOURCCS
        path = str(tmp_path / "geo.avi")
        random_avi(path, 3, 80, 64, 2, b"FMP4")
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data.replace(b"FMP4", fourcc))
        with pytest.raises(ValueError, match="GeoVision"):
            open_movie(path)


def test_user_data_parse():
    """libavcodec's decode_user_data, whose sscanf formats EncoderId's
    _scanf follows, on the strings encoders write."""
    cases = {b"XviD0050": (50, -1, -1), b"XviD0002": (2, -1, -1),
             b"DivX503b1393p": (-1, 503, -1), b"DivX999Build1920": (-1, 999, -1),
             b"Lavc62.0.0": (-1, -1, 62 << 16),
             b"Lavc57.107.100": (-1, -1, (57 << 16) + (107 << 8) + 100),
             b"Lavc62.0": (-1, -1, -1), b"ffmpeg": (-1, -1, 4600),
             b"FFmpeg0.4.9-pre1b4718": (-1, -1, 4718),
             b"FFmpeg v0.4.9 / libavcodec build: 4712": (-1, -1, 4712),
             b"XviD": (-1, -1, -1), b"DivX": (-1, -1, -1), b"": (-1, -1, -1),
             b"XviD0050\0Lavc62.0.0": (50, -1, -1)}
    for text, want in cases.items():
        e = mpeg4.EncoderId()
        e.user_data(text)
        assert (e.xvid_build, e.divx_version, e.lavc_build) == want, text
    # the codec tag decides only without user data of any of the three
    for tag, user, idct in ((b"XVID", b"", True), (b"xvix", b"", True),
                            (b"XVID", b"Lavc62.0.0", False), (b"MP4V", b"", False)):
        e = mpeg4.EncoderId(tag)
        e.user_data(user)
        e.at_vop(mpeg4.Vol())
        assert e.xvid_idct == idct, (tag, user)


def test_xvid_idct_saturates_as_sse2():
    """Rows saturate to int16 (packssdw) and columns add in saturating
    16-bit arithmetic: a block of extreme coefficients stays in range and
    its DC-only row gives the row pass's rounders."""
    dc = np.zeros((1, 64), np.int64)
    dc[0, 0] = 64
    out = mpeg4.xvid_idct(dc)
    assert out.shape == (1, 8, 8) and np.all(out == out[0, 0, 0])
    big = np.full((1, 64), 32767, np.int64)
    out = mpeg4.xvid_idct(big)
    assert out.min() >= -512 and out.max() <= 511
    zero = mpeg4.xvid_idct(np.zeros((1, 64), np.int64))
    assert np.all(zero == 0)
