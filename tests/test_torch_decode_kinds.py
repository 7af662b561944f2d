"""The plain decoder on every kind of file the JAX package decodes, against
cv2 (the JAX package's decoder) bit for bit on the CPU: progressive JPEGs
(cv2's and PIL's, every subsampling, restart intervals, files that end
early), CMYK, YCCK and RGB JPEGs, BMPs of every header, depth and
compression cv2 reads, the reduced-scale decode of progressive files, the
BMP writer, the routes decode_to takes, and JPEGs without Huffman tables
(libjpeg's standard ones in sequential slots 0 and 1) on every entry. Then
the JAX functions themselves: decode_request_bytes, _fast_decode_resized,
the datasets, and a served request with a progressive JPEG and a BMP.
"""

import io
import json
import os
import struct
import tracemalloc

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_serve import _post, _rows, server, weights  # noqa: F401
from torch_samples import (SAMPLES, cut_after_scans, jpeg, jpeg_scans, pil_jpeg, rle8,
                           scene, with_adobe_transform, without_tables)
from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu.serve import decode_request_bytes as jax_decode_request_bytes
from vision_kit_tpu_torch.data import datasets as port_ds
from vision_kit_tpu_torch.data import decode
from vision_kit_tpu_torch.data.decode import decode_image, decode_jpeg_reduced
from vision_kit_tpu_torch.ops.letterbox import scale_coords
from vision_kit_tpu_torch.serve import decode_request_bytes
from vision_kit_tpu_torch.utils.serve_bench import cut_inside_last_scan

torch.set_num_threads(2)

IMG_SIZE = (64, 64)
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
REDUCED = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
           8: cv2.IMREAD_REDUCED_COLOR_8}


def cv2_rgb(data: bytes) -> np.ndarray | None:
    """cv2.imdecode + BGR2RGB, None where cv2 refuses: it gives None, or
    raises for an image over its size limits (validateInputImageSize)."""
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def assert_like_cv2(data: bytes, what: str = "") -> None:
    """decode_image equals cv2.imdecode + BGR2RGB, or both give None."""
    got, want = decode_image(data), cv2_rgb(data)
    assert (got is None) == (want is None), (what, got is None, want is None)
    if want is not None:
        assert got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)


def read(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


# -- progressive JPEG --------------------------------------------------------


def pil_progressive(rgb: np.ndarray, quality: int, subsampling=None, optimize=False,
                    grey=False) -> bytes:
    kw = dict(quality=quality, progressive=True, optimize=optimize)
    if subsampling is not None:
        kw["subsampling"] = subsampling
    if grey:
        return pil_jpeg(cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY), "L", **kw)
    return pil_jpeg(rgb, "RGB", **kw)


def progressive_cases() -> dict[str, bytes]:
    """cv2's progressive JPEGs (libjpeg's 10-scan script with successive
    approximation) and PIL's, with and without optimize, over subsamplings,
    grey, odd sizes down to one block, and restart intervals."""
    out = {}
    for h, w in ((99, 131), (9, 17), (8, 8), (1, 1), (23, 9), (7, 130), (50, 13)):
        img = scene(h, w, h * 7 + w)
        tag = f"{h}x{w}"
        for s in ("420", "422", "444"):
            out[f"cv_{s}_{tag}"] = jpeg(img, 85, SAMPLING[s], IMWRITE_JPEG_PROGRESSIVE=1)
        out[f"cv_grey_{tag}"] = jpeg(cv2.cvtColor(img, cv2.COLOR_RGB2GRAY), 90,
                                     IMWRITE_JPEG_PROGRESSIVE=1)
        out[f"cv_420_rst2_{tag}"] = jpeg(img, 92, SAMPLING["420"], IMWRITE_JPEG_PROGRESSIVE=1,
                                         IMWRITE_JPEG_RST_INTERVAL=2)
        out[f"cv_444_rst1_{tag}"] = jpeg(img, 75, SAMPLING["444"], IMWRITE_JPEG_PROGRESSIVE=1,
                                         IMWRITE_JPEG_RST_INTERVAL=1)
        out[f"pil_420_{tag}"] = pil_progressive(img, 90, 2)
        out[f"pil_422_{tag}"] = pil_progressive(img, 80, 1)
        out[f"pil_444_opt_{tag}"] = pil_progressive(img, 95, 0, optimize=True)
        out[f"pil_grey_opt_{tag}"] = pil_progressive(img, 90, grey=True, optimize=True)
    return out


PROGRESSIVE = progressive_cases()


@pytest.mark.parametrize("name", sorted(PROGRESSIVE))
def test_progressive_like_cv2(name):
    data = PROGRESSIVE[name]
    assert decode.jpeg_header(data)["sof"] == decode.SOF_PROGRESSIVE
    assert_like_cv2(data, name)


@pytest.mark.parametrize("name", sorted(n for n in PROGRESSIVE if n.endswith(
    ("99x131", "9x17", "50x13"))))
def test_progressive_ended_after_every_scan_like_cv2(name):
    """The first k scans and an EOI: libjpeg smooths the blocks whose first
    coefficients are not fully known (after the DC scans alone it also
    re-estimates DC), and so does the plain decoder."""
    data = PROGRESSIVE[name]
    n = len(jpeg_scans(data))
    assert n >= 6, n
    for k in range(1, n):
        early = cut_after_scans(data, k)
        assert not decode.jpeg_header(early)["complete"]
        assert_like_cv2(early, f"{name} after {k} scans")


@pytest.mark.parametrize("name", ["cv_420_99x131", "cv_420_rst2_99x131", "pil_420_99x131",
                                  "cv_444_rst1_50x13"])
def test_progressive_cut_inside_a_scan_like_cv2(name):
    """Cut at 40 places inside the scans and closed by an EOI: the bits that
    run out read as zeros to the end of their MCU, the rest of the restart
    interval stays as the earlier scans left it, the first MCU of an
    interval missing after a complete one decodes from zero bits, and the
    smoothing takes the coefficient bits from before the last scan past the
    last iMCU row that scan began. Cut without the EOI, both give None."""
    data = PROGRESSIVE[name]
    for cut in np.linspace(jpeg_scans(data)[0] + 20, len(data) - 3, 40).astype(int):
        assert_like_cv2(data[:cut] + b"\xff\xd9", f"{name} cut at {cut}")
        assert decode_image(data[:cut]) is None and cv2_rgb(data[:cut]) is None


def test_progressive_reduced_like_cv2_imread(tmp_path):
    """decode_jpeg_reduced against cv2.imread(IMREAD_REDUCED_COLOR_f) on the
    progressive samples, whole and ended early (smoothing at 1/2, 1/4 and
    1/8 as at full size)."""
    names = ["progressive_240x320.jpg", "progressive_4of10_240x320.jpg",
             "progressive_720x1280_420_q90.jpg"]
    cases = {n: read(n) for n in names}
    cases["early_2"] = cut_after_scans(read("progressive_240x320.jpg"), 2)
    cases["cv_422_rst2"] = PROGRESSIVE["cv_420_rst2_99x131"]
    for name, data in cases.items():
        path = str(tmp_path / "f.jpg")
        with open(path, "wb") as f:
            f.write(data)
        for f in (2, 4, 8):
            want = cv2.cvtColor(cv2.imread(path, REDUCED[f]), cv2.COLOR_BGR2RGB)
            got = decode_jpeg_reduced(data, f)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} at 1/{f}")


def test_bad_progressions_are_refused():
    """Scan parameters that jdphuff.c's start_pass rejects (libjpeg's error
    exit; cv2 gives None), and a multi-scan file whose bytes end before its
    EOI (libjpeg suspends for more input)."""
    data = PROGRESSIVE["cv_420_99x131"]
    sos = jpeg_scans(data)[1]   # the first AC scan: Ns 1, Ss 1, Se 5, Ah 0, Al 2
    spec = sos + 7              # Ss, Se, Ah/Al after Ls, Ns, Cs, Td/Ta
    bad = {"Ss>Se": (spec, bytes([6, 5])), "Se>63": (spec, bytes([1, 64])),
           "Al>13": (spec + 2, bytes([0x0E])), "Ah!=Al+1": (spec + 2, bytes([0x30]))}
    for what, (at, patch) in bad.items():
        patched = data[:at] + patch + data[at + len(patch):]
        assert decode_image(patched) is None and cv2_rgb(patched) is None, what
    last = jpeg_scans(data)[-1]
    dht = data.rindex(b"\xff\xc4", 0, last)
    end = dht + 2 + ((data[dht + 2] << 8) | data[dht + 3])
    no_eoi = data[:end - 2] + b"\xff\xd9"   # the EOI read as the table's last bytes
    assert "EOI" in decode.jpeg_refusal(decode.jpeg_header(no_eoi))
    assert decode_image(no_eoi) is None and cv2_rgb(no_eoi) is None


# -- JPEG colour -------------------------------------------------------------


def colour_cases() -> dict[str, bytes]:
    out = {}
    rng = np.random.default_rng(0)
    for h, w in ((40, 56), (33, 65), (9, 17)):
        rgb = scene(h, w, h)
        cmyk = np.concatenate([255 - rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
        for tag, kw in (("q90", dict(quality=90)), ("prog", dict(quality=85, progressive=True)),
                        ("420", dict(quality=90, subsampling=2))):
            data = pil_jpeg(cmyk, "CMYK", **kw)
            at = data.index(b"\xff\xee")
            out[f"cmyk_{tag}_{h}x{w}"] = data
            out[f"ycck_{tag}_{h}x{w}"] = with_adobe_transform(data, 2)
            out[f"cmyk_no_adobe_{tag}_{h}x{w}"] = data[:at] + data[at + 2 + data[at + 3]:]
        out[f"rgb_keep_{h}x{w}"] = pil_jpeg(rgb, "RGB", quality=90, keep_rgb=True)
        for prog in (0, 1):   # 'R', 'G', 'B' ids without JFIF: RGB, subsampled
            data = jpeg(rgb, 90, SAMPLING["420"], IMWRITE_JPEG_PROGRESSIVE=prog)
            data = bytearray(data[:2] + data[4 + ((data[4] << 8) | data[5]):])
            sof = data.index(b"\xff\xc2" if prog else b"\xff\xc0")
            for k in range(3):
                data[sof + 10 + 3 * k] = b"RGB"[k]
            for sos in jpeg_scans(bytes(data)):
                for k in range(data[sos + 4]):
                    data[sos + 5 + 2 * k] = b"RGB"[data[sos + 5 + 2 * k] - 1]
            out[f"rgb_ids_{'prog' if prog else 'base'}_{h}x{w}"] = bytes(data)
    return out


COLOUR = colour_cases()


@pytest.mark.parametrize("name", sorted(COLOUR))
def test_colour_jpegs_like_cv2(name):
    data = COLOUR[name]
    want = {"cmyk": "cmyk", "ycck": "ycck", "rgb": "rgb"}[name.split("_")[0]]
    assert decode.jpeg_colour(decode.jpeg_header(data)) == want
    assert_like_cv2(data, name)
    for f in (2, 8):
        want_small = cv2.imdecode(np.frombuffer(data, np.uint8), REDUCED[f])
        np.testing.assert_array_equal(decode_jpeg_reduced(data, f),
                                      cv2.cvtColor(want_small, cv2.COLOR_BGR2RGB))


# -- BMP ---------------------------------------------------------------------


def bmp(w, h, bpp, pixels, comp=0, palette=None, hsize=40, top_down=False, masks=None,
        clrused=0):
    """A BMP with any header size: the 12-byte core header (3-byte palette
    entries), or an info header of `hsize` bytes with the bit masks inside
    it from 52 bytes on and after it below; `palette` (n, 4) BGRA."""
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bpp)
        pal = b"" if palette is None else palette[:, :3].tobytes()
        tail = b""
    else:
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bpp, comp,
                           len(pixels), 2835, 2835, clrused, 0)
        inside = struct.pack("<IIII", *(masks or (0, 0, 0, 0)))[:max(0, hsize - 40)]
        head += inside + bytes(hsize - 40 - len(inside))
        pal = b"" if palette is None else palette.tobytes()
        tail = struct.pack("<III", *masks[:3]) if masks and hsize == 40 else b""
    offset = 14 + len(head) + len(tail) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + head + tail + pal + pixels)


def padded(rows) -> bytes:
    return b"".join(bytes(r) + bytes(-len(bytes(r)) % 4) for r in rows)


def packed_rows(index: np.ndarray, bpp: int) -> list:
    bits = np.unpackbits(index.astype(np.uint8)[..., None], axis=-1)[..., 8 - bpp:]
    return [np.packbits(r.reshape(-1)).tobytes() for r in bits]


def bmp_cases() -> dict[str, bytes]:
    rng = np.random.default_rng(1)
    out = {}
    for w, h in ((1, 1), (5, 3), (17, 9)):
        bgr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        bgra = np.concatenate([bgr, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
        for hs in (12, 40, 52, 56, 108, 124):
            for td in (False, True) if hs != 12 else (False,):
                order = slice(None) if td else slice(None, None, -1)
                tag = f"{w}x{h}_h{hs}{'_td' if td else ''}"
                out[f"24_{tag}"] = bmp(w, h, 24, padded(bgr[order].reshape(h, -1)),
                                       hsize=hs, top_down=td)
                out[f"32_{tag}"] = bmp(w, h, 32, padded(bgra[order].reshape(h, -1)),
                                       hsize=hs, top_down=td)
                for bpp in (1, 4, 8):
                    n = 1 << bpp
                    pal = np.concatenate([rng.integers(0, 256, (n, 3), dtype=np.uint8),
                                          np.zeros((n, 1), np.uint8)], 1)
                    idx = rng.integers(0, n, (h, w))
                    out[f"pal{bpp}_{tag}"] = bmp(w, h, bpp, padded(packed_rows(idx[order], bpp)),
                                                 palette=pal, hsize=hs, top_down=td)
                if hs == 12:
                    continue
                out[f"32bf_{tag}"] = bmp(w, h, 32, padded(bgra[order].reshape(h, -1)), comp=3,
                                         hsize=hs, top_down=td,
                                         masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
                px = rng.integers(0, 65536, (h, w), dtype=np.uint16)
                raw = padded(r.astype("<u2").tobytes() for r in px[order])
                out[f"555_{tag}"] = bmp(w, h, 16, raw, hsize=hs, top_down=td)
                for name, m in (("565bf", (0xF800, 0x7E0, 0x1F, 0)),
                                ("555bf", (0x7C00, 0x3E0, 0x1F, 0)),
                                ("444bf", (0xF00, 0xF0, 0xF, 0))):
                    out[f"{name}_{tag}"] = bmp(w, h, 16, raw, comp=3, hsize=hs, top_down=td,
                                               masks=m)
    # fewer palette colours than the depth holds; indices past them
    pal = np.concatenate([rng.integers(0, 256, (5, 3), dtype=np.uint8),
                          np.zeros((5, 1), np.uint8)], 1)
    idx = rng.integers(0, 8, (6, 7))
    out["pal8_clrused5"] = bmp(7, 6, 8, padded(idx[::-1]), palette=pal, clrused=5)
    # RLE8 and RLE4 with every escape: runs, absolute runs, end of line,
    # delta, end of bitmap; a run past its line and bytes ending early
    grid = (scene(20, 24, 30, noise=0.0)[:, :, 0] // 16).astype(np.uint8)
    pal16 = np.concatenate([rng.integers(0, 256, (16, 3), dtype=np.uint8),
                            np.zeros((16, 1), np.uint8)], 1)
    stream = rle8(grid, (4, 3, 11))
    out["rle8"] = bmp(24, 20, 8, stream, comp=1, palette=pal16)
    out["rle8_top_down"] = bmp(24, 20, 8, stream, comp=1, palette=pal16, top_down=True)
    out["rle8_no_eob"] = bmp(24, 20, 8, stream[:-2], comp=1, palette=pal16)
    out["rle8_cut"] = bmp(24, 20, 8, stream[:len(stream) // 2], comp=1, palette=pal16)
    out["rle8_overrun"] = bmp(4, 2, 8, bytes([3, 1, 2, 2, 0, 1]), comp=1, palette=pal16)
    out["rle8_eol_after_full_run"] = bmp(4, 3, 8, bytes([4, 1, 0, 0, 2, 3, 0, 0, 0, 1]),
                                         comp=1, palette=pal16)
    rle4 = bytes([4, 0x12, 0, 5, 0x34, 0x56, 0x70, 0, 0, 0, 0, 2, 2, 1, 3, 0xAB, 0, 0,
                  6, 0xCD, 0, 1, 0, 1, 0, 1, 0, 1])
    out["rle4"] = bmp(9, 4, 4, rle4, comp=2, palette=pal16)
    out["rle4_eob_ends_a_line"] = bmp(9, 6, 4, bytes([9, 0x11, 0, 1, 0, 1]), comp=2,
                                      palette=pal16)
    out["rle4_overrun"] = bmp(3, 2, 4, bytes([4, 0x12, 0, 1]), comp=2, palette=pal16)
    # headers cv2 refuses, and bytes ending inside the pixels
    full = out["24_17x9_h40"]
    out["truncated_pixels"] = full[:len(full) - 40]
    out["truncated_header"] = full[:30]
    out["compression_4"] = full[:30] + struct.pack("<I", 4) + full[34:]
    out["header_20"] = full[:14] + struct.pack("<I", 20) + full[18:]
    out["width_0"] = full[:18] + struct.pack("<i", 0) + full[22:]
    out["bpp_2"] = full[:28] + struct.pack("<H", 2) + full[30:]
    # sizes at and over OpenCV's limits (a side of 1 << 20, 1 << 30 pixels)
    # in a few bytes of RLE8 that end the bitmap at once
    eob = bytes([0, 1])
    for tag, w, h, td in (("40000x40000_td", 40000, 40000, True),
                          ("40000x40000", 40000, 40000, False),
                          ("width_over", (1 << 20) + 1, 1, False),
                          ("height_over_td", 1, (1 << 20) + 1, True),
                          ("width_at", 1 << 20, 1, True),
                          ("height_at_td", 1, 1 << 20, True)):
        out[f"size_{tag}"] = bmp(w, h, 8, eob, comp=1, palette=pal16, top_down=td)
    return out


BMPS = bmp_cases()


@pytest.mark.parametrize("name", sorted(BMPS))
def test_bmp_like_cv2(name):
    data = BMPS[name]
    assert decode.image_kind(data) == "bmp"
    assert_like_cv2(data, name)


def test_bmp_from_cv2_and_pil_like_cv2():
    for h, w in ((7, 5), (40, 64)):
        rgb = scene(h, w, 3)
        for src in (cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)):
            assert_like_cv2(cv2.imencode(".bmp", src)[1].tobytes())
        for mode in ("RGB", "P", "L", "1", "RGBA"):
            buf = io.BytesIO()
            Image.fromarray(rgb).convert(mode).save(buf, "BMP")
            assert_like_cv2(buf.getvalue(), mode)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (40, 64), (3, 101)])
def test_bmp_writer_is_cv2_imwrite(shape, tmp_path):
    rgb = scene(*shape, 5)
    path = str(tmp_path / "x.bmp")
    cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    with open(path, "rb") as f:
        assert decode.encode_bmp(rgb) == f.read()
    np.testing.assert_array_equal(decode_image(decode.encode_bmp(rgb)), rgb)


def test_bmp_sample_streams_hold_every_escape():
    """The committed RLE8 sample holds runs, absolute runs, end of line,
    delta and end of bitmap; its pixels equal cv2's."""
    data = read("rle8_120x160.bmp")
    stream = data[decode.bmp_header(data)["offset"]:]
    seen, pos = set(), 0
    while pos < len(stream):
        n, code = stream[pos], stream[pos + 1]
        pos += 2
        if n:
            seen.add("run")
        elif code > 2:
            seen.add("absolute")
            pos += (code + 1) & ~1
        else:
            seen.add(("eol", "eob", "delta")[code])
            pos += 2 if code == 2 else 0
    assert seen == {"run", "absolute", "eol", "eob", "delta"}
    assert_like_cv2(data)
    palette4 = read("palette4_120x160.bmp")
    assert decode.bmp_header(palette4)["bpp"] == 4
    assert_like_cv2(palette4)


# -- routes ------------------------------------------------------------------


def test_routes_from_the_header():
    """decode_to's route for each committed sample on the card and on the
    CPU, from the header and the scans' walk (nothing touches CUDA; the
    walk is the plain decoder's scans_short here, where the card runs the
    C walk of csrc/jpeg_walk.cu)."""
    want = {"jpeg_720p": "nvjpeg", "jpeg_444": "nvjpeg", "jpeg_422": "nvjpeg",
            "jpeg_grey": "nvjpeg", "jpeg_restart": "nvjpeg", "jpeg_odd": "nvjpeg",
            "jpeg_exif": "nvjpeg", "jpeg_progressive": "nvjpeg_progressive",
            "jpeg_progressive_720p": "nvjpeg_progressive",
            "jpeg_progressive_early": "host_smoothed", "jpeg_cmyk": "host_colour",
            "jpeg_ycck": "host_colour", "jpeg_rgb": "host_colour",
            "jpeg_truncated": "host_cut", "png_rgb": "host_png", "png_palette": "host_png",
            "bmp_24": "host_bmp", "bmp_palette8": "host_bmp", "bmp_palette4": "host_bmp",
            "bmp_rle8": "host_bmp", "jpeg_no_dht": "nvjpeg", "jpeg_std_slot1": "nvjpeg",
            "jpeg_arith": "host_arith", "jpeg_arith_no_eoi": "host_arith",
            "jpeg_lossless": "host_lossless", "jpeg_lossless_grey": "refused",
            "jpeg_refused": "refused"}
    want.update({k: "host_webp" for k in ("webp_lossy", "webp_lossless", "webp_alpha",
                                         "webp_exif", "webp_animated", "webp_simple",
                                         "webp_large")})
    import json
    walk = decode.scans_short
    with open(os.path.join(SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    # Netpbm/PAM, PFM, Sun raster, HDR, GIF, TIFF and JPEG 2000: host_<kind>
    # everywhere
    want.update({m["kind"]: "host_" + m["kind"].split("_")[0] for m in files.values()
                 if m["kind"].startswith(("pxm_", "pfm_", "sunras_", "hdr_", "gif_", "tiff_",
                                          "jp2_"))})
    # a one-scan JPEG that the bytes end inside takes the host route (libjpeg
    # may decode it); the progressive one, cut inside a later scan's
    # header, does not parse
    by_name = {"truncated_progressive_240x320.jpg": "refused"}
    for name, meta in files.items():
        data = read(name)
        want[name] = by_name.get(name, want[meta["kind"]])
        assert decode.decode_route(data, "cuda", walk) == want[name], name
        cpu = decode.decode_route(data, "cpu")
        assert cpu == ("host_jpeg" if want[name] in (
            "nvjpeg", "nvjpeg_progressive", "host_smoothed", "host_colour", "host_cut")
            else want[name]), name
    assert decode.decode_route(b"junk", "cuda", walk) == "refused"
    sof11 = read("progressive_240x320.jpg").replace(b"\xff\xc2", b"\xff\xcb", 1)
    assert decode.decode_route(sof11, "cuda", walk) == "refused"
    # a cut inside the last scan, closed by an EOI, is not in the header:
    # the walk finds it and the host decodes it, as cv2 and the plain
    # decoder decode it alike
    for name in ("progressive_240x320.jpg", "frame0_720x1280_420_q90.jpg"):
        cut = cut_inside_last_scan(read(name))
        assert decode.decode_route(cut, "cuda", walk) == "host_cut", name
        assert_like_cv2(cut, name)


# -- scans_short: which scans run out of bits ---------------------------------


with open(os.path.join(SAMPLES, "MANIFEST.json")) as _f:
    # the committed JPEGs that decode, but the lossless ones (no DCT scans)
    JPEG_SAMPLES = sorted(n for n, m in json.load(_f)["files"].items()
                          if n.endswith(".jpg") and m["shape"] is not None
                          and m["kind"] != "jpeg_lossless")


def test_scans_short_of_complete_files():
    """Zero for every scan of every committed JPEG and progressive case."""
    for name in JPEG_SAMPLES:
        short = decode.scans_short(read(name))
        assert short and not any(short), (name, short)
    for name in sorted(PROGRESSIVE)[::3]:
        assert not any(decode.scans_short(PROGRESSIVE[name])), name
    with pytest.raises(decode.JpegError):
        decode.scans_short(read("truncated_240x320.jpg"))


def _rst_positions(data: bytes) -> list[int]:
    """Where each RST marker of the last scan starts."""
    start, end = [(b, end) for m, _, b, end in decode._walk(data) if m == decode.SOS][-1]
    body = np.frombuffer(data, np.uint8, end - start, start)
    ff = np.flatnonzero(body[:-1] == 0xFF)
    return [start + int(i) for i in ff if 0xD0 <= body[i + 1] <= 0xD7]


@pytest.mark.parametrize("name", ["restart4_240x320.jpg", "cv_420_rst2_99x131",
                                  "cv_444_rst1_50x13"])
def test_scans_short_at_every_restart_interval(name):
    """Cut just before the k-th RST marker of the last scan (every one of a
    baseline file's, every third of a progressive file's) and closed by an
    EOI: that scan's intervals after the k-th are missing, so exactly their
    MCUs are short; the earlier scans are whole. Decoded like cv2."""
    data = PROGRESSIVE[name] if name in PROGRESSIVE else read(name)
    info = decode.jpeg_header(data)
    restart = next(((data[b] << 8) | data[b + 1]) for m, a, b, _ in decode._walk(data)
                   if m == decode.DRI for b in [a])
    whole = decode.scans_short(data)
    rsts = _rst_positions(data)
    # the last scan's MCUs: whole MCUs of an interleaved scan, blocks of a
    # one-component one
    last = [seg for m, a, b, _ in decode._walk(data) if m == decode.SOS
            for seg in [data[a:b]]][-1]
    comps = info["components"]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    if last[0] > 1:
        n_mcus = -(-info["width"] // (8 * hmax)) * -(-info["height"] // (8 * vmax))
    else:
        c = next(c for c in comps if c[0] == last[1])
        n_mcus = (-(-(-(-info["width"] * c[1] // hmax)) // 8)
                  * -(-(-(-info["height"] * c[2] // vmax)) // 8))
    assert len(rsts) == -(-n_mcus // restart) - 1
    step = 1 if info["sof"] != decode.SOF_PROGRESSIVE else 3   # a progressive walk is slower
    for k, pos in list(enumerate(rsts))[::step] + [(len(rsts) - 1, rsts[-1])]:
        cut = data[:pos] + b"\xff\xd9"
        short = decode.scans_short(cut)
        assert short[:-1] == whole[:-1], (name, k)
        assert short[-1] == n_mcus - (k + 1) * restart, (name, k, short)
        if k == 0 or k == len(rsts) // 2:
            assert_like_cv2(cut, f"{name} cut at RST {k}")
    assert info["height"] > 0


def test_scans_short_of_cuts_inside_the_last_scan():
    """cut_inside_last_scan: only the last scan is short, by about half its
    MCUs, for baseline, restart-interval and progressive files."""
    for name in ("frame0_720x1280_420_q90.jpg", "s444_240x320.jpg", "grey_240x320.jpg",
                 "restart4_240x320.jpg", "progressive_240x320.jpg",
                 "progressive_720x1280_420_q90.jpg"):
        data = read(name)
        whole = decode.scans_short(data)
        short = decode.scans_short(cut_inside_last_scan(data))
        assert len(short) == len(whole) and not any(short[:-1]), name
        assert short[-1] > 0, name
    for name in ("cv_420_99x131", "pil_444_opt_99x131", "cv_grey_99x131"):
        data = PROGRESSIVE[name]
        cut = cut_inside_last_scan(data)
        short = decode.scans_short(cut)
        assert short[-1] > 0 and not any(short[:-1]), name
        assert_like_cv2(cut, name)


# -- OpenCV's size limits on a JPEG ------------------------------------------


def with_size(data: bytes, h: int, w: int) -> bytes:
    """The JPEG with its SOF claiming h x w."""
    i = next(a for m, a, _, _ in decode._walk(data) if m in decode.SOF_ALL)
    return data[:i + 1] + struct.pack(">HH", h, w) + data[i + 5:]


def traced_peak(fn, *args):
    tracemalloc.start()
    try:
        out = fn(*args)
        return out, tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


@pytest.mark.parametrize("hw", [(40000, 40000), (65535, 65535), (46341, 46341),
                                (100, 65501)])
def test_size_limits_refuse_before_allocating(hw, tmp_path):
    """A few hundred bytes whose SOF claims more than OpenCV's 1 << 30
    pixels (or a side over libjpeg's 65500): refused by decode_image,
    decode_jpeg_reduced at full size, decode_route and the integrity scan,
    none tracing more than 64 MB."""
    for base in (read("s444_240x320.jpg"), read("progressive_240x320.jpg")):
        data = with_size(base, *hw)
        assert cv2_rgb(data) is None
        got, peak = traced_peak(decode_image, data)
        assert got is None and peak < 64 << 20, peak
        assert decode.decode_route(data, "cuda", decode.scans_short) == "refused"
        assert decode.decode_route(data, "cpu") == "refused"
        assert decode.probe_jpeg(data) is None or hw[0] * hw[1] <= 65500 ** 2
        path = tmp_path / "big.jpg"
        path.write_bytes(data)
        why, peak = traced_peak(port_ds.image_refusal, str(path))
        assert why and peak < 64 << 20
        assert ("size limits" in why) or ("65500" in why), why


def without_huffman_tables(data: bytes) -> bytes:
    """The JPEG with its DHT segments dropped: libjpeg fails at the first
    scan, before it touches a coefficient."""
    out = bytearray(data[:2])
    for m, a, b, end in decode._walk(data):
        if m == decode.EOI:
            out += data[a - 2:a]
        elif m != decode.DHT:
            out += data[a - 4:end if m == decode.SOS else b]
    return bytes(out)


def test_size_limit_applies_at_the_reduced_size():
    """cv2 applies its limits to the decoded size: a 40000x40000 progressive
    file raises at full size and not at 1/2, 1/4 or 1/8 (there it fails at
    the first scan, which names no defined Huffman table). jpeg_refusal
    says the same, and decode_jpeg_reduced refuses the file without its EOI
    at every scale within 64 MB traced."""
    whole = with_size(read("progressive_240x320.jpg"), 40000, 40000)
    info = decode.jpeg_header(whole)
    tableless = without_huffman_tables(whole)
    with pytest.raises(cv2.error):
        cv2.imdecode(np.frombuffer(tableless, np.uint8), cv2.IMREAD_COLOR)
    assert "size limits" in decode.jpeg_refusal(info)
    for f, flag in REDUCED.items():
        assert cv2.imdecode(np.frombuffer(tableless, np.uint8), flag) is None
        assert decode.jpeg_refusal(info, f) is None   # the whole file decodes at 1/f
        got, peak = traced_peak(decode_jpeg_reduced, whole[:-2], f)   # no EOI
        assert got is None and peak < 64 << 20
    # a complete file at 46341 x 46341 (2.1e9 pixels) is over at full size
    # and under from 1/2 on; no JPEG (sides <= 65500) is over at 1/2 and not
    # at 1/8
    info = decode.jpeg_header(with_size(read("s444_240x320.jpg"), 46341, 46341))
    assert "size limits" in decode.jpeg_refusal(info)
    assert all(decode.jpeg_refusal(info, f) is None for f in (2, 4, 8))


def test_decode_to_counts_routes_on_the_cpu():
    before = dict(decode.route_counts)
    for name in ("progressive_240x320.jpg", "palette4_120x160.bmp", "cmyk_120x160.jpg",
                 "truncated_240x320.jpg", "refused_sof11_117x163.jpg"):
        data = read(name)
        got = decode.decode_to(data, "cpu")
        want = decode_image(data)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), want)
    after = decode.route_counts
    # the truncated one's header reads (libjpeg would decode it, did its
    # bit buffer not read past the bytes): the host route, then None
    assert after["host_jpeg"] - before["host_jpeg"] == 3
    assert after["host_bmp"] - before["host_bmp"] == 1
    assert after["refused"] - before["refused"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            decode.decode_jpeg_cuda(read("progressive_240x320.jpg"), "cpu")


# -- against the JAX package's functions ------------------------------------

JAX_SAMPLES = ["progressive_240x320.jpg", "progressive_4of10_240x320.jpg",
               "progressive_720x1280_420_q90.jpg", "cmyk_120x160.jpg", "ycck_120x160.jpg",
               "adobe_rgb_120x160.jpg", "rgb24_120x160.bmp", "palette8_120x160.bmp",
               "palette4_120x160.bmp", "rle8_120x160.bmp", "nodht_720x1280_420_q90.jpg",
               "stdslot1_240x320.jpg"]


@pytest.mark.parametrize("name", JAX_SAMPLES)
def test_decode_request_bytes_equals_jax(name, monkeypatch):
    data = read(name)
    got = decode_request_bytes(data, IMG_SIZE, "cpu")
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path: ratio in f64
    want = jax_decode_request_bytes(data, IMG_SIZE)
    assert got is not None and want is not None
    img, (ratio, pad), hw0 = got
    np.testing.assert_array_equal(img.numpy(), want[0])
    assert (ratio, pad) == want[1]
    assert tuple(hw0) == tuple(want[2])


@pytest.mark.parametrize("size", [160, 60])
def test_fast_decode_resized_equals_jax_on_progressive(size):
    """Reduced at 1/2 to 1/8 on both sides (the CMYK one only at 60), bit
    for bit."""
    n = 0
    for name in ("progressive_240x320.jpg", "progressive_4of10_240x320.jpg",
                 "progressive_720x1280_420_q90.jpg", "cmyk_120x160.jpg"):
        want = jax_ds._fast_decode_resized(os.path.join(SAMPLES, name), (size, size))
        got = port_ds._fast_decode_resized(read(name), (size, size))
        assert (got is None) == (want is None), name
        if want is not None:
            n += 1
            np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg=name)
            assert got[1] == want[1]
    assert n == (3 if size == 160 else 4)


def test_served_progressive_and_bmp_equal_jax(server, monkeypatch):  # noqa: F811
    """A progressive JPEG, one that ends early, a CMYK JPEG and two BMPs
    POSTed to the port's v5n@64 InferenceServer: its detections equal the
    Predictor's on the JAX package's decode of the same bytes (its cv2
    letterbox and ratio), classes exact, scores within 1e-5 and boxes
    within 1e-3 px beyond the response's rounding (5 and 2 decimals)."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path: ratio in f64
    n = 0
    for name in ("progressive_240x320.jpg", "progressive_4of10_240x320.jpg",
                 "cmyk_120x160.jpg", "rgb24_120x160.bmp", "rle8_120x160.bmp"):
        data = read(name)
        status, payload = _post(f"http://127.0.0.1:{server.port}/predict", data)
        assert status == 200, name
        lb, (ratio, pad), hw0 = jax_decode_request_bytes(data, IMG_SIZE)
        imgs = torch.zeros((4, *IMG_SIZE, 3), dtype=torch.uint8)
        imgs[0] = torch.from_numpy(np.ascontiguousarray(lb))
        dets, valid = server.predictor.run(imgs)
        want = scale_coords(IMG_SIZE, dets[0][valid[0]].numpy(), tuple(hw0),
                            ratio_pad=(ratio, pad))
        got = _rows(payload)
        assert (payload["height"], payload["width"]) == tuple(hw0)
        assert len(got) == len(want), name
        np.testing.assert_array_equal(got[:, 5], want[:, 5])
        np.testing.assert_allclose(got[:, 4], want[:, 4], atol=5e-6 + 1e-5, rtol=0)
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=5e-3 + 1e-3, rtol=0)
        n += len(got)
    assert n > 0


def test_served_oversize_jpeg_answers_as_jax(server):  # noqa: F811
    """A JPEG over OpenCV's size limits POSTed to the port's server: 400, as
    the JAX server answers with its native decoder (vkio catches
    cv2.imdecode's exception and reports no image); its cv2 path would
    raise. The server stays up."""
    import urllib.error

    from vision_kit_tpu.data import native

    data = with_size(read("s444_240x320.jpg"), 40000, 40000)
    assert native.available()
    assert jax_decode_request_bytes(data, IMG_SIZE) is None
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"http://127.0.0.1:{server.port}/predict", data)
    assert err.value.code == 400
    status, _ = _post(f"http://127.0.0.1:{server.port}/predict", read("s444_240x320.jpg"))
    assert status == 200


# -- JPEGs without Huffman tables --------------------------------------------

# libjpeg's jdhuff.c gives a sequential scan's undefined slots 0 and 1 the
# standard tables (Motion-JPEG frames carry no DHT); jdphuff.c gives none
NO_DHT_FROM = ["frame1_720x1280_420_q90.jpg", "restart4_240x320.jpg", "grey_240x320.jpg",
               "s444_240x320.jpg", "odd_333x517.jpg", "exif6_200x300.jpg"]
NO_DHT = {**{f"{n} without DHT": without_huffman_tables(read(n)) for n in NO_DHT_FROM},
          "nodht_720x1280_420_q90.jpg": read("nodht_720x1280_420_q90.jpg"),
          "stdslot1_240x320.jpg": read("stdslot1_240x320.jpg")}


def with_table_ids(data: bytes, tables: int) -> bytes:
    """The JPEG with every component of its first scan naming DC and AC
    table `tables` (the SOS's table byte)."""
    at = next(a for m, a, _, _ in decode._walk(data) if m == decode.SOS)
    out = bytearray(data)
    for k in range(data[at]):
        out[at + 2 + 2 * k] = tables
    return bytes(out)


@pytest.mark.parametrize("name", sorted(NO_DHT))
def test_jpeg_without_huffman_tables_like_cv2(name):
    """decode_image, decode_jpeg_reduced at 1/2, 1/4 and 1/8 against cv2 bit
    for bit; probe_jpeg reads the header; scans_short finds every scan
    whole, and the card's route is nvJPEG (the standard tables spliced in
    front of it, with_standard_tables)."""
    data = NO_DHT[name]
    assert_like_cv2(data, name)
    assert decode_image(data) is not None
    for f, flag in REDUCED.items():
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        np.testing.assert_array_equal(decode_jpeg_reduced(data, f),
                                      cv2.cvtColor(want, cv2.COLOR_BGR2RGB), err_msg=f"{f}")
    info = decode.jpeg_header(data)
    assert decode.probe_jpeg(data)[:2] == (info["height"], info["width"])
    assert decode.scans_short(data) == [0]
    assert decode.decode_route(data, "cuda", decode.scans_short) == "nvjpeg"
    spliced = decode.with_standard_tables(data, info)
    assert sorted(decode.jpeg_header(spliced)["huffman"]) == sorted(decode.STD_HUFFMAN)
    np.testing.assert_array_equal(decode_image(spliced), decode_image(data))


def test_optimised_slot_0_keeps_its_table():
    """Pillow's optimised tables in slot 0 and no slot 1: only slot 1 takes
    the standard tables. The pixels are those of Pillow's file with both of
    its optimised tables (the same coefficients), as cv2 gives them."""
    data = read("stdslot1_240x320.jpg")
    info = decode.jpeg_header(data)
    assert info["huffman"] == {(0, 0), (1, 0)}
    src = pil_jpeg(scene(240, 320, 26), "RGB", quality=90, optimize=True)
    np.testing.assert_array_equal(decode_image(data), decode_image(src))
    assert_like_cv2(data)
    # libjpeg's standard tables in slot 0 too misread it
    assert not np.array_equal(cv2_rgb(without_huffman_tables(data)), decode_image(data))


@pytest.mark.parametrize("tables", [0x22, 0x33, 0x02, 0x30])
def test_undefined_slots_2_and_3_stay_refused(tables):
    """A scan naming a table 2 or 3 that no DHT defines: None, as cv2
    gives, on every route, with or without the file's own tables."""
    for data in (read("s444_240x320.jpg"), NO_DHT["s444_240x320.jpg without DHT"]):
        bad = with_table_ids(data, tables)
        assert cv2_rgb(bad) is None
        assert decode_image(bad) is None
        assert decode_jpeg_reduced(bad, 2) is None
        with pytest.raises(decode.JpegError):
            decode.scans_short(bad)
        assert decode.decode_route(bad, "cuda", decode.scans_short) == "host_cut"


@pytest.mark.parametrize("slots", [(0, 1, 2, 3), (1,), (0,)])
def test_progressive_without_tables_like_cv2(slots):
    """jdphuff.c fills no table: a progressive file without its DHTs (or
    without slot 0 or 1) gives cv2's None at full size and reduced."""
    data = without_tables(read("progressive_240x320.jpg"), slots)
    for flag in (cv2.IMREAD_COLOR, *REDUCED.values()):
        try:
            assert cv2.imdecode(np.frombuffer(data, np.uint8), flag) is None
        except cv2.error:
            pass
    assert decode_image(data) is None
    assert all(decode_jpeg_reduced(data, f) is None for f in REDUCED)
    assert decode.with_standard_tables(data, decode.jpeg_header(data)) == data
    assert decode.decode_route(data, "cuda", decode.scans_short) == "host_cut"


@pytest.mark.parametrize("fast", [False, True])
def test_datasets_keep_jpegs_without_tables_like_jax(tmp_path, monkeypatch, fast):
    """The integrity scan keeps them and every dataset decoder (plain and
    auto, the full decode and fast_decode) gives JAX's items."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path
    for root in ("port", "jax"):
        (tmp_path / root / "images").mkdir(parents=True)
        (tmp_path / root / "labels").mkdir()
        for i, name in enumerate(["nodht_720x1280_420_q90.jpg", "stdslot1_240x320.jpg",
                                  "grey_240x320.jpg without DHT"]):
            (tmp_path / root / "images" / f"{i}.jpg").write_bytes(NO_DHT[name])
            (tmp_path / root / "labels" / f"{i}.txt").write_text("0 0.5 0.5 0.2 0.2")
    want = jax_ds.YOLODataset(str(tmp_path / "jax"), img_size=160, fast_decode=fast)
    assert len(want) == 3
    for decoder in ("plain", "auto"):
        got = port_ds.YOLODataset(str(tmp_path / "port"), img_size=160, device="cpu",
                                  decoder=decoder, fast_decode=fast)
        assert len(got) == 3
        for i in range(3):
            g, w = got.pull_item(i), want.pull_item(i)
            np.testing.assert_array_equal(g[0].numpy(), w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert tuple(g[2]) == tuple(w[2])
