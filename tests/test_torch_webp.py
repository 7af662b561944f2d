"""The port's WebP decoder (vision_kit_tpu_torch/data/webp.py) against cv2
on the CPU: decode_image equals cv2.imdecode(IMREAD_COLOR) + BGR2RGB bit
for bit, or both give None, on lossy files of every quality, loop filter,
sharpness, segment count and partition count, lossless files of every
method (every transform and the colour cache), alpha, VP8X files with
EXIF orientations and ICCP, animations, cut and corrupted files. Files
come from cv2.imencode, from libwebp's own encoder (torch_samples.
libwebp_encode) and from containers packed here. Then the JAX package's
functions on the same bytes: decode_request_bytes, its dataset's items
(fast_decode on and off), its integrity scan, and a served request.
"""

import os
import struct
import tracemalloc
import urllib.error

import cv2
import numpy as np
import pytest
import torch

import torch_samples as ts
from test_torch_serve import _post, _rows, server, weights  # noqa: F401
from vision_kit_tpu.data import datasets as jax_ds
from vision_kit_tpu.serve import decode_request_bytes as jax_decode_request_bytes
from vision_kit_tpu.utils.general import exif_size as jax_exif_size
from vision_kit_tpu_torch.data import datasets as port_ds
from vision_kit_tpu_torch.data import decode, webp
from vision_kit_tpu_torch.ops.letterbox import scale_coords
from vision_kit_tpu_torch.serve import decode_request_bytes
from vision_kit_tpu_torch.utils.general import exif_size

torch.set_num_threads(2)

IMG_SIZE = (64, 64)


def cv2_rgb(data: bytes) -> np.ndarray | None:
    """cv2.imdecode + BGR2RGB, None where cv2 gives None or raises (its
    size limits)."""
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    return None if bgr is None else np.ascontiguousarray(bgr[:, :, ::-1])


def assert_like_cv2(data: bytes, what: str = "") -> np.ndarray | None:
    want, got = cv2_rgb(data), decode.decode_image(data)
    assert (got is None) == (want is None), (what, got is None, want is None)
    if want is not None:
        assert got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    return want


def bgr(rgb: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(rgb[..., [2, 1, 0, 3][:rgb.shape[2]]])


def with_alpha(rgb: np.ndarray) -> np.ndarray:
    """RGBA: a ramp of alpha across the columns, zero in a band."""
    h, w = rgb.shape[:2]
    a = (np.arange(w)[None, :] * 5 % 256).repeat(h, 0).astype(np.uint8)
    a[:, w // 3:w // 2] = 0
    return np.concatenate([rgb, a[:, :, None]], 2)


# -- cv2's own files -------------------------------------------------------

SIZES = [(1, 1), (2, 3), (17, 31), (40, 60), (120, 160)]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("quality", [1, 50, 90, 100, "lossless"])
def test_cv2_files(hw, quality):
    img = bgr(ts.scene(*hw, seed=hw[0] * 7 + hw[1]))
    params = [] if quality == "lossless" else [cv2.IMWRITE_WEBP_QUALITY, quality]
    data = cv2.imencode(".webp", img, params)[1].tobytes()
    assert data[12:16] == (b"VP8L" if quality == "lossless" else b"VP8 ")
    assert assert_like_cv2(data, f"{hw} {quality}") is not None


def test_cv2_alpha_files():
    """A BGRA input gives VP8X + ALPH (lossy) or a VP8L with alpha: the
    colour planes as decoded, no blend."""
    img = with_alpha(ts.scene(48, 70, seed=3))
    for params in ([cv2.IMWRITE_WEBP_QUALITY, 80], []):
        data = cv2.imencode(".webp", bgr(img), params)[1].tobytes()
        assert assert_like_cv2(data, str(params)) is not None
    lossless = cv2.imencode(".webp", bgr(img))[1].tobytes()
    seen = img[:, :, 3] > 0   # the encoder may drop the colour where alpha is 0
    np.testing.assert_array_equal(decode.decode_image(lossless)[seen], img[:, :, :3][seen])


# -- libwebp's encoder settings --------------------------------------------

LOSSY = ([dict(filter_type=t, filter_strength=60, filter_sharpness=s)
          for t in (0, 1) for s in range(8)]
         + [dict(filter_strength=0), dict(filter_strength=100), dict(segments=1),
            dict(segments=4), dict(sns_strength=0), dict(sns_strength=100),
            dict(use_sharp_yuv=1), dict(autofilter=1)]
         # libwebp writes token partitions with method 0 or low_memory only
         + [dict(partitions=p, filter_type=p & 1, filter_strength=40, method=0)
            for p in range(4)]
         + [dict(partitions=3, low_memory=1, segments=4)])


@pytest.mark.parametrize("settings", LOSSY, ids=str)
def test_lossy_settings(settings):
    data = ts.libwebp_encode(ts.scene(70, 90, seed=5), 80, **settings)
    assert assert_like_cv2(data, str(settings)) is not None


def test_lossy_headers_seen():
    """The settings above reach every header branch: simple and normal
    filters, 1-4 segments with their own quantizers and filter levels, 1, 2,
    4 and 8 token partitions."""
    seen = set()
    smooth = ts.scene(70, 90, seed=5, noise=0.0)
    for img, settings in [(ts.scene(70, 90, seed=5), s) for s in LOSSY] + [(smooth, {})]:
        data = ts.libwebp_encode(img, 80, **settings)
        fr = webp._vp8_parse(data, 20)
        segs = {mb["segment"] for mb in fr["mbs"]}
        seen.add(("filter", fr["filter_type"]))
        seen.add(("segments", len(segs)))
        seen.update(("i4x4", bool(mb["i4x4"])) for mb in fr["mbs"])
        seen.add(("partitions", fr["partitions"]))
    assert {("filter", 1), ("filter", 2), ("i4x4", True), ("i4x4", False)} <= seen
    assert {("partitions", n) for n in (1, 2, 4, 8)} <= seen
    assert max(n for k, n in seen if k == "segments") == 4


@pytest.mark.parametrize("method", range(7))
def test_lossless_methods(method):
    img = ts.scene(60, 90, seed=6)
    for quality in (0, 75, 100):
        data = ts.libwebp_encode(img, quality, lossless=1, method=method)
        want = assert_like_cv2(data, f"method {method} q{quality}")
        np.testing.assert_array_equal(want, img)


@pytest.mark.parametrize("settings", [dict(near_lossless=n) for n in (0, 40, 60, 80)]
                         + [dict(exact=e, alpha=True) for e in (0, 1)]
                         + [dict(exact=e, alpha=True, lossless=0) for e in (0, 1)],
                         ids=str)
def test_lossless_options_and_alpha(settings):
    settings = dict(settings)
    img = ts.scene(50, 64, seed=8)
    if settings.pop("alpha", False):
        img = with_alpha(img)
    settings.setdefault("lossless", 1)
    assert assert_like_cv2(ts.libwebp_encode(img, 75, **settings), str(settings)) is not None


@pytest.mark.parametrize("n_colours", [2, 3, 4, 11, 16, 17, 200])
def test_palettes(n_colours):
    """Colour indexing with 1-, 2- and 4-bit bundling and without."""
    pal = np.random.default_rng(n_colours).integers(0, 256, (n_colours, 3)).astype(np.uint8)
    idx = ts.scene(45, 77, seed=n_colours)[:, :, 0].astype(int) * n_colours // 256
    data = ts.libwebp_encode(pal[idx], 75, lossless=1, method=4)
    np.testing.assert_array_equal(assert_like_cv2(data, str(n_colours)), pal[idx])


def test_every_lossless_transform_and_the_colour_cache(monkeypatch):
    """Across libwebp's lossless files of the tests above, every transform,
    most predictor modes and the colour cache occur (the modes its encoder
    never picks are in test_every_predictor_mode)."""
    kinds, modes, caches = set(), set(), set()
    inverse, pixels = webp._inverse_transforms, webp._decode_pixels

    def record_transforms(img, transforms):
        for t in transforms:
            kinds.add(t["kind"])
            if t["kind"] == 0:
                modes.update(((t["data"] >> 8) & 15).reshape(-1).tolist())
        return inverse(img, transforms)

    def record_pixels(br, width, height, groups, meta, meta_bits, cache_bits):
        caches.add(cache_bits)
        return pixels(br, width, height, groups, meta, meta_bits, cache_bits)

    monkeypatch.setattr(webp, "_inverse_transforms", record_transforms)
    monkeypatch.setattr(webp, "_decode_pixels", record_pixels)
    pal = np.random.default_rng(1).integers(0, 256, (300, 3)).astype(np.uint8)
    imgs = [ts.scene(60, 90, seed=6), ts.scene(97, 131, seed=9, noise=6.0),
            ts.scene(96, 128, seed=3, noise=0.0),
            pal[np.random.default_rng(2).integers(0, 300, (64, 64))]]   # > 256 colours
    for img in imgs:
        for method in (0, 1, 3, 4, 5, 6):
            for quality in (0, 75, 100):
                data = ts.libwebp_encode(img, quality, lossless=1, method=method)
                np.testing.assert_array_equal(assert_like_cv2(data, str(method)), img)
    pal = np.random.default_rng(4).integers(0, 256, (4, 3)).astype(np.uint8)
    webp.decode_webp(ts.libwebp_encode(pal[ts.scene(30, 30, 1)[:, :, 0] % 4], 75, lossless=1))
    assert kinds == {0, 1, 2, 3}
    assert set(range(1, 12)) | {13} <= modes, sorted(modes)
    assert max(caches) > 0


@pytest.mark.parametrize("hwb", [(9, 13, 2), (1, 1, 2), (5, 1, 2), (1, 7, 3), (33, 17, 2),
                                 (20, 40, 4)])
def test_every_predictor_mode(hwb):
    """VP8L files written here (torch_samples.vp8l_raw): random coded pixels
    under random tiles of all 16 predictor modes (14 and 15 act as 0), with
    cross-colour and subtract-green in either order, at widths down to 1
    (the last column's top-right is the row's first pixel)."""
    h, w, bits = hwb
    rng = np.random.default_rng(h * 100 + w)
    px = rng.integers(0, 2 ** 32, (h, w), dtype=np.uint64).astype(np.uint32)
    tiles = (-(-h // (1 << bits)), -(-w // (1 << bits)))
    modes = (np.arange(tiles[0] * tiles[1]).reshape(tiles) % 16).astype(np.uint32)
    modes = (rng.permutation(modes.reshape(-1)).reshape(tiles) << 8) | np.uint32(0xFF000000)
    cross = rng.integers(0, 2 ** 32, tiles, dtype=np.uint64).astype(np.uint32)
    for transforms in ([(0, bits, modes)],
                       [(2, 0, None), (0, bits, modes), (1, bits, cross)],
                       [(1, bits, cross), (0, bits, modes), (2, 0, None)]):
        assert assert_like_cv2(ts.vp8l_raw(px, transforms), str(hwb)) is not None


# -- the container: VP8X, EXIF, ICCP, animation ---------------------------


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_exif_orientation(orientation, kind):
    img = ts.scene(40, 60, seed=orientation)
    if kind == "alpha":
        data = cv2.imencode(".webp", bgr(with_alpha(img)), [cv2.IMWRITE_WEBP_QUALITY, 80])[1]
    else:
        data = cv2.imencode(".webp", bgr(img),
                            [cv2.IMWRITE_WEBP_QUALITY, 80] if kind == "lossy" else [])[1]
    data = ts.webp_with(data.tobytes(), exif=ts.exif_tiff(orientation), icc=b"\0" * 99)
    want = assert_like_cv2(data, f"{kind} {orientation}")
    assert want.shape[:2] == ((60, 40) if orientation in (6, 8) else (40, 60))
    h, w = want.shape[:2]
    assert exif_size(data) == (w, h)


def test_exif_chunks_cv2_ignores():
    """The orientation comes from the first EXIF chunk of a VP8X file whose
    EXIF flag is set, a TIFF body: cv2 ignores the chunk otherwise, and an
    "Exif\\0\\0" prefix."""
    base = cv2.imencode(".webp", bgr(ts.scene(30, 50, seed=2)))[1].tobytes()
    flagged = ts.webp_with(base, exif=ts.exif_tiff(6))
    chunks = ts.webp_chunks(flagged)
    unflagged = ts.riff(ts.vp8x(50, 30, 0), *chunks[1:])
    two = ts.riff(chunks[0], (b"EXIF", ts.exif_tiff(3)), *chunks[1:])
    prefixed = ts.webp_with(base, exif=b"Exif\0\0" + ts.exif_tiff(6))
    for data, orientation in ((flagged, 6), (unflagged, 1), (two, 3), (prefixed, 1)):
        assert webp.webp_header(data)["orientation"] == orientation
        assert_like_cv2(data, str(orientation))


def test_animations():
    """cv2.imencodeanimation's files (lossless and lossy) and packed ones
    whose first frame is smaller and offset, with alpha, at the canvas's
    edge or past it: the first frame on a zero canvas."""
    movie = cv2.Animation()
    movie.frames = [bgr(ts.scene(48, 64, seed=s)) for s in (30, 31, 32)]
    movie.durations = [100, 100, 100]
    for params in ([], [cv2.IMWRITE_WEBP_QUALITY, 70]):
        data = cv2.imencodeanimation(".webp", movie, params)[1].tobytes()
        assert webp.webp_header(data)["kind"] == "animated"
        want = assert_like_cv2(data, str(params))
        assert want.shape == (48, 64, 3)
    f1 = cv2.imencode(".webp", bgr(ts.scene(20, 30, seed=40)))[1].tobytes()
    f2 = cv2.imencode(".webp", bgr(ts.scene(30, 40, seed=41)),
                      [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes()
    fa = cv2.imencode(".webp", bgr(with_alpha(ts.scene(20, 30, seed=42))),
                      [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes()
    for frames, ok in (([(f1, 10, 6), (f2, 0, 0)], True), ([(f2, 4, 2), (f1, 0, 0)], True),
                       ([(fa, 2, 2)], True), ([(f2, 24, 18)], True),
                       ([(f2, 30, 20)], False)):
        want = assert_like_cv2(ts.animation(frames, 64, 48), str(frames[0][1:]))
        assert (want is not None) == ok
        if ok:
            x, y = frames[0][1:]
            assert not want[:y].any() and not want[:, :x].any()
    # an animation's EXIF orientation applies; the animation flag on a
    # still file (no ANIM, no ANMF) fails
    head, *rest = ts.webp_chunks(ts.animation([(f1, 0, 0)], 30, 20))
    flags = int.from_bytes(head[1][:4], "little")
    rotated = ts.riff((b"VP8X", (flags | 0x08).to_bytes(4, "little") + head[1][4:]), *rest,
                      (b"EXIF", ts.exif_tiff(6)))
    assert assert_like_cv2(rotated, "rotated animation").shape == (30, 20, 3)
    head, *rest = ts.webp_chunks(ts.webp_with(f1))
    flags = int.from_bytes(head[1][:4], "little")
    assert assert_like_cv2(ts.riff((b"VP8X", (flags | 0x02).to_bytes(4, "little")
                                    + head[1][4:]), *rest), "flagged still") is None


# -- cut, corrupt and odd files --------------------------------------------


def _files():
    img = ts.scene(64, 80, seed=3)
    return {"lossless": cv2.imencode(".webp", bgr(img))[1].tobytes(),
            "lossy": cv2.imencode(".webp", bgr(img), [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes(),
            "lossy_4p": ts.libwebp_encode(img, 80, partitions=2, method=0),
            "alpha": cv2.imencode(".webp", bgr(with_alpha(img)),
                                  [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes()}


@pytest.mark.parametrize("name", ["lossless", "lossy", "lossy_4p", "alpha"])
def test_cut_files(name):
    """Cut at several points (None on both: the RIFF size runs past the
    bytes), and cut with the RIFF and chunk sizes patched to the cut, so
    that the bitstream itself runs out: libwebp's end of data in every
    partition."""
    data = _files()[name]
    for frac in (0.05, 0.2, 0.4, 0.6, 0.8, 0.95, 0.99):
        cut = data[:max(webp.SIGNATURE_BYTES, int(len(data) * frac))]
        assert decode.decode_image(cut) is None
        assert_like_cv2(cut, f"{name} {frac}")
        patched = bytearray(cut)
        patched[4:8] = struct.pack("<I", len(cut) - 8)
        last = ts.webp_chunks(bytes(cut))[-1][0]
        pos = bytes(cut).rfind(last)
        patched[pos + 4:pos + 8] = struct.pack("<I", len(cut) - pos - 8)
        assert_like_cv2(bytes(patched), f"{name} {frac} patched")
    assert_like_cv2(data[:webp.SIGNATURE_BYTES - 1], "31 bytes")


@pytest.mark.parametrize("name", ["lossless", "lossy", "lossy_4p", "alpha"])
def test_corrupt_files(name):
    data = _files()[name]
    rng = np.random.default_rng(len(name))
    for _ in range(12):
        bad = bytearray(data)
        i = int(rng.integers(12, len(data)))
        bad[i] ^= 1 << int(rng.integers(0, 8))
        assert_like_cv2(bytes(bad), f"{name} bit at {i}")


def test_alpha_chunks():
    """libwebp decodes a VP8 image's ALPH chunk whatever the output, so a bad
    one gives None under cv2 (with or without the VP8X alpha flag); the
    last ALPH chunk counts; a raw plane must cover the image."""
    data = _files()["alpha"]
    vp8x, (_, alph), image = ts.webp_chunks(data)
    assert alph[0] & 3 == 1   # a VP8L-compressed plane
    w, h = 80, 64
    cases = {
        "reserved bits": (vp8x, (b"ALPH", bytes([alph[0] | 0xC0]) + alph[1:]), image),
        "method 2": (vp8x, (b"ALPH", bytes([alph[0] & ~3 | 2]) + alph[1:]), image),
        "pre-processing 2": (vp8x, (b"ALPH", bytes([alph[0] | 0x20]) + alph[1:]), image),
        "cut": (vp8x, (b"ALPH", alph[:len(alph) // 2]), image),
        "zeros": (vp8x, (b"ALPH", alph[:1] + bytes(len(alph) - 1)), image),
        "raw, short": (vp8x, (b"ALPH", b"\0" + bytes(w * h - 1)), image),
        "raw": (vp8x, (b"ALPH", b"\0" + bytes(w * h)), image),
        "no alpha flag, cut": (ts.vp8x(w, h, 0), (b"ALPH", alph[:len(alph) // 2]), image),
        "two, the first bad": (vp8x, (b"ALPH", alph[:5]), (b"ALPH", alph), image),
        "two, the second bad": (vp8x, (b"ALPH", alph), (b"ALPH", alph[:5]), image),
    }
    for name, chunks in cases.items():
        assert_like_cv2(ts.riff(*chunks), name)
    rng = np.random.default_rng(9)
    for _ in range(10):
        bad = bytearray(alph)
        bad[int(rng.integers(1, len(alph)))] ^= 1 << int(rng.integers(0, 8))
        assert_like_cv2(ts.riff(vp8x, (b"ALPH", bytes(bad)), image), "flipped bit")


def test_container_sizes_and_raw_bitstreams():
    """RIFF and chunk sizes as libwebp checks them (odd, short, past the
    bytes, with trailing bytes), and raw bitstreams: cv2 takes a VP8L one,
    not a VP8 one."""
    files = _files()
    for name in ("lossless", "lossy"):
        data = files[name]
        riff_size = struct.unpack("<I", data[4:8])[0]
        chunk = struct.unpack("<I", data[16:20])[0]
        variants = {
            "riff+1": data[:4] + struct.pack("<I", riff_size + 1) + data[8:],
            "riff-1": data[:4] + struct.pack("<I", riff_size - 1) + data[8:],
            "riff+2 padded": data[:4] + struct.pack("<I", riff_size + 2) + data[8:] + b"\0\0",
            "riff 12": data[:4] + struct.pack("<I", 12) + data[8:],
            "chunk+1": data[:16] + struct.pack("<I", chunk + 1) + data[20:],
            "chunk-1": data[:16] + struct.pack("<I", chunk - 1) + data[20:],
            "trailing": data + b"\0" * 7,
            "raw": data[20:],
            "not WEBP": data[:8] + b"WEBQ" + data[12:],
        }
        for tag, variant in variants.items():
            assert_like_cv2(variant, f"{name} {tag}")
    assert decode.image_kind(files["lossless"][20:]) == "webp"
    assert decode.decode_image(files["lossy"][20:]) is None


def test_size_limit():
    """A VP8X canvas over OpenCV's size limits is refused before any
    allocation its size would make (cv2 raises)."""
    frame = cv2.imencode(".webp", bgr(ts.scene(16, 16, seed=1)))[1].tobytes()
    movie = ts.webp_chunks(ts.animation([(frame, 0, 0)], 16, 16))
    big = ts.riff(ts.vp8x(40000, 40000, 0x12), *movie[1:])
    tracemalloc.start()
    try:
        assert decode.decode_image(big) is None
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 64 << 20
    assert cv2_rgb(big) is None
    with pytest.raises(webp.WebPError, match="size limits"):
        webp.webp_header(big)


# -- the committed samples and the routes ----------------------------------


def test_committed_samples():
    """Each WebP sample decodes to its manifest's rgb_sha256 (the card's
    check), by decode_to's host_webp route."""
    import hashlib
    import json

    with open(os.path.join(ts.SAMPLES, "MANIFEST.json")) as f:
        files = json.load(f)["files"]
    webps = {n: m for n, m in files.items() if m["kind"].startswith("webp")}
    assert len(webps) == 8   # the 2048x2048 one of the server's decode pool too
    before = decode.route_counts["host_webp"]
    for name, meta in webps.items():
        with open(os.path.join(ts.SAMPLES, name), "rb") as f:
            data = f.read()
        got = decode.decode_to(data, "cpu")
        assert got.shape == (*meta["shape"], 3)
        assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == meta["rgb_sha256"], name
        assert meta["rgb_sha256"] == ts.rgb_sha256(data)
        assert decode.decode_route(data, "cuda") == "host_webp"
    assert decode.route_counts["host_webp"] - before == len(webps)


# -- against the JAX package's functions -----------------------------------


def _webp_set():
    img = ts.scene(90, 130, seed=11)
    return {
        "lossy.webp": cv2.imencode(".webp", bgr(img), [cv2.IMWRITE_WEBP_QUALITY, 85])[1],
        "lossless.webp": cv2.imencode(".webp", bgr(ts.scene(70, 50, seed=12)))[1],
        "alpha.webp": cv2.imencode(".webp", bgr(with_alpha(ts.scene(80, 80, seed=13))),
                                   [cv2.IMWRITE_WEBP_QUALITY, 75])[1],
        "exif6.webp": ts.webp_with(
            cv2.imencode(".webp", bgr(ts.scene(60, 100, seed=14)))[1].tobytes(),
            exif=ts.exif_tiff(6)),
        "simple.webp": ts.libwebp_encode(ts.scene(100, 60, seed=15), 70, filter_type=0,
                                         partitions=3, method=0, segments=4),
        "tiny.webp": cv2.imencode(".webp", bgr(ts.scene(8, 40, seed=16)))[1],
        "cut.webp": cv2.imencode(".webp", bgr(img))[1][:400],
    }


@pytest.mark.parametrize("name", sorted(_webp_set()))
def test_decode_request_bytes_equals_jax(name, monkeypatch):
    data = bytes(_webp_set()[name])
    got = decode_request_bytes(data, IMG_SIZE, "cpu")
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path: ratio in f64
    want = jax_decode_request_bytes(data, IMG_SIZE)
    assert (got is None) == (want is None)
    if want is not None:
        img, (ratio, pad), hw0 = got
        np.testing.assert_array_equal(img.numpy(), want[0])
        assert (ratio, pad) == want[1] and tuple(hw0) == tuple(want[2])


@pytest.fixture(scope="module")
def webp_dir(tmp_path_factory):
    """A YOLO set of WebPs (beside a JPEG), one too small and one cut,
    which the integrity scans drop."""
    root = tmp_path_factory.mktemp("webp")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(3)
    files = dict(_webp_set())
    files["plain.jpg"] = ts.jpeg(ts.scene(70, 90, seed=17))
    for name, data in files.items():
        (root / "images" / name).write_bytes(bytes(data))
        rows = [f"{int(rng.integers(0, 3))} {rng.uniform(0.2, 0.8):.6f} "
                f"{rng.uniform(0.2, 0.8):.6f} {rng.uniform(0.05, 0.3):.6f} "
                f"{rng.uniform(0.05, 0.3):.6f}" for _ in range(int(rng.integers(1, 4)))]
        (root / "labels" / (os.path.splitext(name)[0] + ".txt")).write_text("\n".join(rows))
    return str(root)


def test_integrity_scan_equals_jax(webp_dir):
    """Kept and dropped alike, each kept file at JAX's EXIF size."""
    for name in sorted(os.listdir(os.path.join(webp_dir, "images"))):
        path = os.path.join(webp_dir, "images", name)
        want, got = jax_ds.YOLODataset._check_img(path), port_ds.image_refusal(path)
        assert (want is None) == (got is None), (name, want, got)
        if got is None:
            from PIL import Image

            with open(path, "rb") as f:
                data = f.read()
            with Image.open(path) as im:
                assert exif_size(data) == jax_exif_size(im), name


@pytest.mark.parametrize("fast", [False, True])
def test_dataset_items_equal_jax(webp_dir, fast, monkeypatch):
    """Item for item. JAX's cv2 path: its native vkio, built against its
    own OpenCV, does not apply a WebP's EXIF orientation, where cv2 5 does
    and the port follows cv2."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")
    want = jax_ds.YOLODataset(webp_dir, img_size=48, cache=False, fast_decode=fast)
    got = port_ds.YOLODataset(webp_dir, img_size=48, cache=False, fast_decode=fast,
                              device="cpu")
    names = [os.path.basename(f) for f in got.img_files]
    assert names == [os.path.basename(f) for f in want.img_files]
    assert "cut.webp" not in names and "tiny.webp" not in names
    assert sum(n.endswith(".webp") for n in names) == 5
    for i in range(len(want)):
        w, g = want.pull_item(i), got.pull_item(i)
        np.testing.assert_array_equal(g[0].numpy(), w[0], err_msg=names[i])
        np.testing.assert_array_equal(g[1], w[1])
        assert tuple(g[2]) == tuple(w[2]) and g[3] == w[3]


def test_served_webp_equals_jax(server, monkeypatch):  # noqa: F811
    """WebPs POSTed to the port's v5n@64 InferenceServer: its detections
    equal the Predictor's on the JAX package's decode of the same bytes,
    classes exact, scores within 1e-5 and boxes within 1e-3 px beyond the
    response's rounding; a cut one answers 400, as JAX's server does."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path: ratio in f64
    files = _webp_set()
    n = 0
    for name in ("lossy.webp", "exif6.webp", "alpha.webp"):
        data = bytes(files[name])
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
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"http://127.0.0.1:{server.port}/predict", bytes(files["cut.webp"]))
    assert err.value.code == 400
