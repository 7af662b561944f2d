"""The port's Netpbm/PAM, PFM, Sun raster, Radiance HDR, GIF and TIFF
decoders (vision_kit_tpu_torch/data/{pxm,pfm,sunras,hdr,gif,tiff,ccitt}.py)
against cv2 on the CPU: decode_image equals cv2.imdecode(IMREAD_COLOR) +
BGR2RGB bit for bit, or both give None, on the committed samples, on
seeded random files of each kind, on cut and corrupt ones and on headers
over OpenCV's size limits (cv2 raises there). Then the JAX package's
functions on the same bytes: decode_request_bytes, a served request and
ImageReader on a single .tif.

Files come from cv2.imencode, Pillow (its libtiff and GIF writer) and the
writers of tests/torch_samples.py (gif_file, tiff_file, netpbm_ascii,
sun_raster), which write what neither of those does (GIF frames off the
screen's corner, TIFF tiles, planes, big-endian and BigTIFF files, strips
cut short).
"""

import functools
import hashlib
import json
import os
import struct
import urllib.error

import cv2
import numpy as np
import pytest
import torch

import torch_samples as ts
from test_torch_serve import _post, _rows, server, weights  # noqa: F401
from vision_kit_tpu.serve import decode_request_bytes as jax_decode_request_bytes
from vision_kit_tpu.utils.readers import ImageReader as JaxImageReader
from vision_kit_tpu_torch.data import decode, gif, hdr, pfm, pxm, sunras, tiff
from vision_kit_tpu_torch.ops.letterbox import scale_coords
from vision_kit_tpu_torch.serve import decode_request_bytes
from vision_kit_tpu_torch.utils.readers import ImageReader

torch.set_num_threads(2)

IMG_SIZE = (64, 64)
KINDS = ("pxm", "pfm", "sunras", "hdr", "gif", "tiff")

with open(os.path.join(ts.SAMPLES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)["files"]


def committed(kind: str) -> dict[str, bytes]:
    out = {}
    for name, meta in MANIFEST.items():
        if meta["kind"].split("_")[0] == kind:
            with open(os.path.join(ts.SAMPLES, name), "rb") as f:
                out[name] = f.read()
    return out


def cv2_rgb(data: bytes) -> np.ndarray | None:
    """cv2.imdecode + BGR2RGB, None where cv2 gives None or raises (its
    size limits). cv2 gives a grey PFM ("Pf") as one channel even under
    IMREAD_COLOR; it is taken in all three, as decode_pfm gives it."""
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    if bgr is None:
        return None
    if bgr.ndim == 2:
        assert data[:2] == b"Pf"
        bgr = np.repeat(bgr[:, :, None], 3, 2)
    return np.ascontiguousarray(bgr[:, :, ::-1])


def assert_like_cv2(data: bytes, what="") -> np.ndarray | None:
    want, got = cv2_rgb(data), decode.decode_image(data)
    assert (got is None) == (want is None), (what, got is None, want is None)
    if want is not None:
        assert got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=str(what))
    return want


def flip(data: bytes, rng, start: int = 0) -> bytes:
    out = bytearray(data)
    i = int(rng.integers(start, len(out)))
    out[i] ^= int(rng.integers(1, 256))
    return bytes(out)


# -- seeded random files of each kind ----------------------------------------


def _pnm(rng) -> bytes:
    code = int(rng.integers(1, 7))
    w, h = int(rng.integers(1, 14)), int(rng.integers(1, 7))
    maxval = int(rng.choice([255, 100, 15, 1000, 65535]))
    sep = lambda: [b" ", b"\n", b"\t", b"\r\n", b"\n# c\n", b"  "][rng.integers(6)]  # noqa: E731
    head = b"P%d" % code + sep() + b"%d" % w + sep() + b"%d" % h
    if code not in (1, 4):
        head += sep() + b"%d" % maxval
    head += b"\n"
    nch = 3 if code in (3, 6) else 1
    n = w * h * nch
    if code == 4:
        return head + bytes(rng.integers(0, 256, (w + 7) // 8 * h, dtype=np.uint8))
    if code in (5, 6):
        return head + bytes(rng.integers(0, 256, n * (2 if maxval > 255 else 1), dtype=np.uint8))
    top = 2 if code == 1 else maxval + 30
    return head + b"".join(b"%d" % v + sep() for v in rng.integers(0, top, n))


def _pam(rng) -> bytes:
    tupl = rng.choice(["GRAYSCALE", "RGB", "BLACKANDWHITE", ""])
    depth = {"GRAYSCALE": 1, "RGB": 3, "BLACKANDWHITE": 1, "": int(rng.choice([1, 3]))}[tupl]
    maxval = 1 if tupl == "BLACKANDWHITE" else int(rng.choice([255, 100, 1000, 65535]))
    if tupl == "" and maxval > 255:
        maxval = 255
    w, h = int(rng.integers(1, 14)), int(rng.integers(1, 7))
    lines = [b"WIDTH %d" % w, b"HEIGHT %d" % h, b"DEPTH %d" % depth, b"MAXVAL %d" % maxval]
    if tupl:
        lines.append(b"TUPLTYPE " + tupl.encode())
    rng.shuffle(lines)
    lines.insert(int(rng.integers(0, len(lines))), b"# comment")
    size = 2 if maxval > 255 else 1
    return (b"P7\n" + b"\n".join(lines) + b"\nENDHDR\n"
            + bytes(rng.integers(0, 256, w * h * depth * size, dtype=np.uint8)))


def _pxm(rng) -> bytes:
    return _pam(rng) if rng.random() < 0.3 else _pnm(rng)


def _pfm(rng) -> bytes:
    grey = rng.random() < 0.4
    w, h = int(rng.integers(1, 12)), int(rng.integers(1, 6))
    scale = rng.choice([b"-1.0", b"-2", b"-0.3", b"1", b"7.5", b"-1e-3", b"-inf"])
    n = w * h * (1 if grey else 3)
    x = rng.choice([rng.uniform(-5, 300, n), rng.integers(0, 40, n) / 2,
                    rng.choice([np.nan, np.inf, -np.inf, 3e9, 255.5, 0.5, 1.5], n)])
    order = "<" if scale.startswith(b"-") else ">"
    return ((b"Pf" if grey else b"PF") + b"\n%d %d\n" % (w, h) + scale + b"\n"
            + x.astype(order + "f4").tobytes())


def _sunras(rng) -> bytes:
    w, h = int(rng.integers(1, 14)), int(rng.integers(1, 6))
    depth = int(rng.choice([1, 8, 24, 32]))
    colours = None
    if depth <= 8 and rng.random() < 0.6:
        colours = rng.integers(0, 256, (int(rng.integers(1, (1 << depth) + 1)), 3))
    if depth == 1:
        px = rng.integers(0, 2, (h, w))
    elif depth == 8:
        px = rng.integers(0, 256, (h, w))
    else:
        px = rng.integers(0, 256, (h, w, depth // 8))
    return ts.sun_raster(w, h, depth, ts.sun_rows(px, depth), colours)


def _rle_channel(rng, row) -> bytes:
    out, x = bytearray(), 0
    while x < len(row):
        n = int(min(rng.integers(1, 128), len(row) - x))
        if rng.random() < 0.5:
            out += bytes([128 + n, row[x]])
        else:
            out += bytes([n]) + bytes(row[x:x + n])
        x += n
    return bytes(out)


def _hdr(rng) -> bytes:
    w, h = int(rng.choice([3, 7, 8, 20, 130])), int(rng.integers(1, 4))
    head = rng.choice([b"#?RADIANCE\n", b"#?RGBE\n"]) + b"GAMMA=1\nFORMAT=32-bit_rle_rgbe\n"
    head += rng.choice([b"", b"EXPOSURE=1.0\n", b"# note\n"]) + b"\n-Y %d +X %d\n" % (h, w)
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    px[:, :, 3] = rng.choice([0, 120, 128, 136, 137, 150, 160], (h, w))
    px[:, ::2] = px[:, :1]
    body = b""
    for y in range(h):
        if 8 <= w and rng.random() < 0.7:
            body += bytes([2, 2, w >> 8, w & 255]) + b"".join(
                _rle_channel(rng, px[y, :, c]) for c in range(4))
        else:
            body += px[y].tobytes()
    return head + body


def _gif(rng) -> bytes:
    W, H = int(rng.integers(1, 24)), int(rng.integers(1, 16))
    fw, fh = int(rng.integers(1, W + 1)), int(rng.integers(1, H + 1))
    n_global = int(rng.choice([0, 4, 16, 256]))
    n_local = int(rng.choice([0, 0, 8, 256]))
    colours = rng.integers(0, 256, (n_global, 3)) if n_global else None
    size = max(n_global, n_local, 2 if not (n_global or n_local) else 0) or 256
    index = rng.integers(0, size, (fh, fw))
    index[:, ::2] = index[:, :1]
    frame = dict(index=index, x=int(rng.integers(0, W - fw + 1)),
                 y=int(rng.integers(0, H - fh + 1)), interlace=bool(rng.random() < 0.4),
                 colours=rng.integers(0, 256, (n_local, 3)) if n_local else None,
                 min_size=max(2, int(np.ceil(np.log2(size)))) if rng.random() < 0.5 else 8)
    if rng.random() < 0.5:
        frame.update(transparent=int(rng.integers(0, 4)), disposal=int(rng.integers(0, 4)))
    frames = [frame] + ([dict(index=index[::-1])] if rng.random() < 0.3 else [])
    return ts.gif_file(W, H, frames, colours, int(rng.integers(0, max(n_global, 1))))


def _tiff_params(rng) -> dict:
    kind = rng.choice(["rgb", "rgba", "grey", "greya", "palette", "cmyk", "bilevel"])
    h, w = int(rng.integers(1, 36)), int(rng.integers(1, 36))
    bits, photometric, extra, tags = 8, None, None, {}
    if kind in ("rgb", "rgba"):
        c, bits = (3 if kind == "rgb" else 4), int(rng.choice([8, 16]))
        if kind == "rgba" and rng.random() < 0.8:
            extra = [int(rng.integers(0, 3))]
    elif kind in ("grey", "greya"):
        c, bits, photometric = (1 if kind == "grey" else 2), int(rng.choice([8, 16])), \
            int(rng.integers(0, 2))
        extra = [int(rng.integers(0, 3))] if kind == "greya" else None
    elif kind == "palette":
        c, bits, photometric = 1, int(rng.choice([1, 4, 8])), 3
        top = 256 if rng.random() < 0.5 else 65536
        tags[320] = (3, rng.integers(0, top, 3 << bits).tolist())
    elif kind == "cmyk":
        c, photometric = 4, 5
    else:
        c, bits, photometric = 1, 1, int(rng.integers(0, 2))
    a = rng.integers(0, 1 << bits, (h, w, c)).astype(np.uint16 if bits == 16 else np.uint8)
    a[:, ::2] = a[:, :1]
    if rng.random() < 0.3:
        tags[274] = (3, [int(rng.integers(1, 9))])
    return dict(samples=a, bits=bits, photometric=photometric, extra=extra, tags=tags,
                compression=int(rng.choice([1, 5, 8, 32946, 32773])),
                predictor=2 if bits >= 8 and rng.random() < 0.3 else 1,
                planar=2 if c > 1 and rng.random() < 0.3 else 1,
                tile=((int(rng.choice([16, 32])), int(rng.choice([16, 32, 64])))
                      if rng.random() < 0.3 else None),
                rows_per_strip=int(rng.integers(1, h + 3)), order=str(rng.choice(["<", ">"])),
                big=bool(rng.random() < 0.2))


def _tiff(rng) -> bytes:
    return ts.tiff_file(**_tiff_params(rng))


GENERATORS = {"pxm": _pxm, "pfm": _pfm, "sunras": _sunras, "hdr": _hdr, "gif": _gif,
              "tiff": _tiff}
CASES = {"pxm": 150, "pfm": 100, "sunras": 100, "hdr": 60, "gif": 100, "tiff": 120}


# -- against cv2 ---------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_committed_samples_like_cv2(kind):
    """Each committed sample of the kind equals cv2's decode and its
    manifest's rgb_sha256 (the card's check), by decode_to's host_<kind>
    route, counted in route_counts, on the card's route table too."""
    files = committed(kind)
    assert len(files) >= 2
    route = f"host_{kind}"
    before = decode.route_counts[route]
    for name, data in files.items():
        want = assert_like_cv2(data, name)
        assert want.shape == (*MANIFEST[name]["shape"], 3), name
        got = decode.decode_to(data, "cpu")
        assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == MANIFEST[name]["rgb_sha256"]
        assert decode.decode_route(data, "cuda") == decode.decode_route(data, "cpu") == route
    assert decode.route_counts[route] - before == len(files)


@pytest.mark.parametrize("kind", KINDS)
def test_seeded_files_like_cv2(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    decoded = 0
    for i in range(CASES[kind]):
        data = GENERATORS[kind](rng)
        decoded += assert_like_cv2(data, (kind, i)) is not None
    assert decoded >= CASES[kind] // 2


@pytest.mark.parametrize("kind", KINDS)
def test_cut_and_corrupt_like_cv2(kind):
    """Each kind's seeded files cut short and with a byte changed; a TIFF's
    strips also cut short inside the file (fewer bytes stated than its codec
    wrote: libtiff keeps what it decoded and zeros the rest)."""
    rng = np.random.default_rng(10 + KINDS.index(kind))
    for i in range(CASES[kind] // 2):
        data = GENERATORS[kind](rng)
        assert_like_cv2(data[:int(rng.integers(0, len(data)))], (kind, i, "cut"))
        start, end = 0, len(data)
        if kind == "tiff":   # the pixels (libtiff's repairs of a corrupt IFD are not followed)
            tags = tiff._ifd(data)[0]
            offsets, counts = tags.get(273) or tags.get(324), tags.get(279) or tags.get(325)
            start, end = min(offsets), max(o + c for o, c in zip(offsets, counts))
        assert_like_cv2(flip(data[:end], rng, start) + data[end:], (kind, i, "corrupt"))
    if kind == "tiff":
        partial = 0
        for i in range(40):
            p = _tiff_params(rng)
            if p["compression"] == 1:
                p["compression"] = 5
            whole = ts.tiff_file(**p)
            counts = tiff.tiff_header(whole)["counts"]
            k = int(rng.integers(0, len(counts)))
            data = ts.tiff_file(**p, short={k: int(rng.integers(0, counts[k]))})
            want = assert_like_cv2(data, ("tiff", i, "short strip"))
            partial += want is not None
        assert partial > 20


SIZE_LIMITS = {
    "pxm": b"P5 1048577 1 255\n" + bytes(64),
    "pfm": b"PF\n33000 33000\n-1\n" + bytes(64),
    "sunras": struct.pack(">8i", 0x59A66A95, 1 << 21, 1, 8, 0, 1, 0, 0) + bytes(64),
    "hdr": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 40000 +X 40000\n" + bytes(64),
    "gif": ts.gif_file(65535, 65535, [dict(index=np.zeros((2, 2), np.uint8))],
                       np.zeros((2, 3), np.uint8)),
    "tiff": ts.tiff_file(np.zeros((2, 2, 3), np.uint8), tags={256: (4, [1 << 21])}),
}


@pytest.mark.parametrize("kind", KINDS)
def test_size_limits(kind):
    """A header over OpenCV's limits (a side over 1 << 20, more than 1 << 30
    pixels): cv2.imdecode raises before any allocation, decode_image gives
    None before any allocation its header sizes."""
    data = SIZE_LIMITS[kind]
    assert decode.image_kind(data) == kind
    with pytest.raises(cv2.error):
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert decode.decode_image(data) is None


def test_pam_alpha_tuples():
    """GRAYSCALE_ALPHA and RGB_ALPHA: OpenCV's basic_conversion converts
    ceil(width / depth) pixels of each row and leaves the rest as the
    allocator gave them; those pixels equal cv2's, the rest are zero."""
    rng = np.random.default_rng(20)
    for tupl, depth in (("GRAYSCALE_ALPHA", 2), ("RGB_ALPHA", 4)):
        for maxval in (255, 65535):
            w, h = 9, 3
            data = (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\nTUPLTYPE %s\nENDHDR\n"
                    % (w, h, depth, maxval, tupl.encode())
                    + bytes(rng.integers(0, 256, w * h * depth * (2 if maxval > 255 else 1),
                                         dtype=np.uint8)))
            want, got = cv2_rgb(data), decode.decode_image(data)
            n = -(-w // depth)
            np.testing.assert_array_equal(got[:, :n], want[:, :n])
            assert not got[:, n:].any()


def test_grey_pfm_is_one_channel_in_cv2():
    """cv2 gives a "Pf" file as a (H, W) image under IMREAD_COLOR, which
    BGR2RGB refuses; decode_pfm puts its values in all three channels."""
    data = b"Pf\n3 2\n-1\n" + np.array([0.5, 1.5, 2.5, 3.5, 254.5, 300],
                                        "<f4").tobytes()
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR).shape == (2, 3)
    got = decode.decode_image(data)
    np.testing.assert_array_equal(got[:, :, 0], [[4, 254, 255], [0, 2, 2]])   # bottom-up
    assert (got == got[:, :, :1]).all()
    assert_like_cv2(data)


def _refused_tiffs() -> dict[str, bytes]:
    rgb = ts.scene(20, 30, 21)
    return {
        "float32": ts.pil_tiff(rgb[:, :, 0].astype(np.float32) / 255),
        "lzma": ts.pil_tiff(rgb, compression="lzma"),
        "zstd": ts.pil_tiff(rgb, compression="zstd"),
        "grey4": ts.tiff_file(rgb[:, :, :1] // 16, bits=4),
        "grey12": ts.tiff_file(rgb[:, :, :1].astype(np.uint16), bits=16,
                               tags={258: (3, [12])}),
        "cmyk16": ts.tiff_file(rgb[:, :, [0, 1, 2, 0]].astype(np.uint16), bits=16,
                               photometric=5),
        "five_samples": ts.tiff_file(rgb[:, :, [0, 1, 2, 0, 1]]),
    }


@pytest.mark.parametrize("name", sorted(_refused_tiffs()))
def test_tiffs_cv2_refuses(name):
    """None on both: float samples, LZMA and ZSTD (this libtiff has neither
    codec), 4-bit grey, 12-bit samples, 16-bit CMYK, five samples."""
    data = _refused_tiffs()[name]
    assert decode.image_kind(data) == "tiff"
    assert cv2_rgb(data) is None and decode.decode_image(data) is None


@functools.cache
def _tiff_counts_and_tiles() -> dict[str, tuple[bytes, bool]]:
    """{name: (file, whether cv2 decodes it)}: OpenCV's tile limits, and
    libtiff's checks, cuts and repairs of byte counts."""
    rgb = np.random.default_rng(23).integers(0, 256, (64, 64, 3), np.uint8)

    def sized(side, **kw):            # a 16x16 image in one tile of side (h, w)
        return ts.tiff_file(rgb[:16, :16], compression=5, tile=(16, 16),
                            tags={322: (4, [side[1]]), 323: (4, [side[0]])}, **kw)

    def counts(data, n):              # room after the file for n stated bytes
        return data + bytes(max(0, n + 16 - len(data)))

    def strips(rps, **kw):
        return ts.tiff_file(rgb, rows_per_strip=64, tags={278: (4, [rps])}, **kw)

    big = 5776 * 5776 * 3              # a tile whose read allocates over 10^8 bytes
    return {
        # OpenCV's readData: a side over 1 << 24, or 1 GiB or more as RGBA
        "tile_side_over_1<<24": (sized(((1 << 24) + 16, 16)), False),
        "tile_16384x16384_rgb8": (sized((16384, 16384)), False),
        "tile_32768x32768_grey16": (ts.tiff_file(
            rgb[:16, :16, 0].astype(np.uint16) << 8, bits=16, compression=5, tile=(16, 16),
            tags={322: (4, [32768]), 323: (4, [32768])}), False),
        "strip_rows_over_1<<24": (strips(1 << 25), False),
        "strip_64_wide_rows_1<<22": (strips(1 << 22), False),
        "strip_64_wide_rows_1<<21": (strips(1 << 21), True),
        "strip_rows_zero": (strips(0), False),
        "strip_rows_0xffffffff": (strips(0xFFFFFFFF), True),
        # a compressed tile: raw buffer under a thousandth of the tile
        "tile_1e8_short_count": (counts(sized((5776, 5776), short={0: 99328}), 99328), False),
        "tile_1e8_count_rounds_up": (counts(sized((5776, 5776), short={0: 99329}), 99329),
                                     True),
        # an uncompressed tile: raw buffer (largest count so far, in KiB) = tile
        "tile_raw_count_over": (counts(ts.tiff_file(rgb[:32, :32], tile=(32, 32),
                                                    short={0: 3100}), 3100), False),
        "tile_raw_count_under": (ts.tiff_file(rgb[:32, :32], tile=(32, 32),
                                              short={0: 3000}), True),
        "tile_raw_second_over": (counts(ts.tiff_file(rgb[:32], tile=(32, 32),
                                                     short={1: 3100}), 3100), False),
        "tile_raw_second_under": (ts.tiff_file(rgb[:32], tile=(32, 32), short={1: 2000}), True),
        # a count over 1 MiB is cut to ten tiles or strips plus 4096
        "tile_count_cut": (counts(sized((32, 32), short={0: 2_000_000}), 34816), True),
        "strip_count_cut": (counts(ts.tiff_file(rgb, compression=5, short={0: 2_000_000}),
                                   10 * 64 * 192 + 4096), True),
        # uncompressed strips' repaired counts
        "strip_single_count_zero": (ts.tiff_file(rgb, short={0: 0}), True),
        "strip_single_count_past_end": (ts.tiff_file(rgb, short={0: 10 ** 6}), True),
        "strips_first_two_differ": (ts.tiff_file(rgb[:40], rows_per_strip=16,
                                                 short={0: 60000}) + bytes(60000), True),
        "strips_first_short": (ts.tiff_file(rgb[:40], rows_per_strip=16,
                                            short={0: 1535}) + bytes(4000), True),
        "strips_repaired_past_end": (ts.tiff_file(rgb[:40], rows_per_strip=16,
                                                  short={0: 1535}), False),
    }


@pytest.mark.parametrize("name", sorted(_tiff_counts_and_tiles()))
def test_tiff_tile_limits_and_byte_counts(name):
    """OpenCV refuses a tile (or width x RowsPerStrip) over 1 << 24 on a side
    or of 1 GiB or more as RGBA words before it allocates; libtiff refuses a
    tile whose byte count cannot fill it, cuts a count over 1 MiB, and
    repairs uncompressed strips' counts: each as cv2 does, decoded or None."""
    data, decodes = _tiff_counts_and_tiles()[name]
    assert decode.image_kind(data) == "tiff"
    assert (assert_like_cv2(data, name) is not None) == decodes


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(orientation):
    """Tag 274 on strips (the EXIF orientation) and on tiles (libtiff
    mirrors each tile in its place first)."""
    rgb = ts.scene(40, 70, 22)
    tags = {274: (3, [orientation])}
    for kw in (dict(rows_per_strip=9), dict(tile=(16, 32), compression=8)):
        assert_like_cv2(ts.tiff_file(rgb, tags=tags, **kw), (orientation, kw))


# -- against the JAX package's functions -------------------------------------


def _one_of_each() -> dict[str, bytes]:
    """The smallest committed sample of each kind (a frame off the corner
    of its screen for GIF, tiles and planes for TIFF)."""
    pick = {"pxm": "p6_48x64.ppm", "pfm": "pfm_30x40.pfm", "sunras": "sunras_24_30x41.ras",
            "hdr": "hdr_rle_30x40.hdr", "gif": "gif_offset_45x60.gif",
            "tiff": "tiff_tiles_planar_mm_48x64.tif"}
    return {k: committed(k)[name] for k, name in pick.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_decode_request_bytes_equals_jax(kind, monkeypatch):
    data = _one_of_each()[kind]
    img, (ratio, pad), hw0 = decode_request_bytes(data, IMG_SIZE, "cpu")
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path: ratio in f64
    want = jax_decode_request_bytes(data, IMG_SIZE)
    np.testing.assert_array_equal(img.numpy(), want[0])
    assert (ratio, pad) == want[1] and tuple(hw0) == tuple(want[2])


def test_served_kinds_equal_predictor(server, monkeypatch):  # noqa: F811
    """One body of each kind POSTed to the port's v5n@64 InferenceServer
    (decoded in its host-decode pool): its detections equal the
    Predictor's on the JAX package's decode of the same bytes, classes
    exact, scores within 1e-5 and boxes within 1e-3 px beyond the
    response's rounding; a cut TIFF answers 400, as JAX's server does."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")
    n = 0
    for kind, data in _one_of_each().items():
        status, payload = _post(f"http://127.0.0.1:{server.port}/predict", data)
        assert status == 200, kind
        lb, (ratio, pad), hw0 = jax_decode_request_bytes(data, IMG_SIZE)
        imgs = torch.zeros((4, *IMG_SIZE, 3), dtype=torch.uint8)
        imgs[0] = torch.from_numpy(np.ascontiguousarray(lb))
        dets, valid = server.predictor.run(imgs)
        want = scale_coords(IMG_SIZE, dets[0][valid[0]].numpy(), tuple(hw0),
                            ratio_pad=(ratio, pad))
        got = _rows(payload)
        assert (payload["height"], payload["width"]) == tuple(hw0)
        assert len(got) == len(want), kind
        np.testing.assert_array_equal(got[:, 5], want[:, 5])
        np.testing.assert_allclose(got[:, 4], want[:, 4], atol=5e-6 + 1e-5, rtol=0)
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=5e-3 + 1e-3, rtol=0)
        n += len(got)
    assert n > 0
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"http://127.0.0.1:{server.port}/predict", _one_of_each()["tiff"][:300])
    assert err.value.code == 400


def test_image_reader_on_a_tif_equals_jax(tmp_path):
    """ImageReader on one .tif path: the JAX reader's cv2.imread frame, in
    RGB; a cut one is (False, None) in both."""
    whole = tmp_path / "page.tif"
    whole.write_bytes(committed("tiff")["tiff_lzw_pred2_720x1280.tif"])
    cut = tmp_path / "cut.tif"
    cut.write_bytes(whole.read_bytes()[:5000])
    for path, ok in ((whole, True), (cut, False)):
        (got_ok, got), = list(ImageReader(str(path)))
        (want_ok, want), = list(JaxImageReader(str(path)))
        assert got_ok == want_ok == ok
        if ok:
            np.testing.assert_array_equal(got, want[:, :, ::-1])
        else:
            assert got is None and want is None


def test_kind_modules_import_no_jax():
    """The decoders stand alone: no JAX, nothing of the JAX package."""
    for module in (gif, hdr, pfm, pxm, sunras, tiff):
        with open(module.__file__) as f:
            source = f.read()
        assert "import jax" not in source and "vision_kit_tpu." not in source
