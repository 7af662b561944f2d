"""data/jp2.py on the CPU: JPEG 2000 (JP2 and raw J2K) against
cv2.imdecode(IMREAD_COLOR) + BGR2RGB, which runs OpenJPEG 2.5.3, bit for
bit and refusal for refusal: the committed samples, seeded images written
by Pillow and by OpenJPEG's own encoder over their settings, marker and
box mutations, cut and corrupt files. csrc/j2k_decode.cu, compiled here
with the host compiler (g++, no contraction of float multiplies and adds,
as nvcc builds it with -ffp-contract=off) is held to the plain decoder on
every file, refusal messages included; the bulk of the fuzz goes through
both on small images so that the file stays fast. Then the entry points:
the JAX package's decode_request_bytes (its cv2 path) and ImageReader
against the port's, the routes, and the server's answer to JPEG 2000
bodies."""

import ctypes
import functools
import hashlib
import json
import os
import shutil
import struct
import subprocess
import urllib.error

import cv2
import numpy as np
import pytest
import torch

from test_torch_serve import _post
from torch_jp2_samples import (box, cdef, cmap, colr, header_boxes, insert_segment, marker_at,
                               opj_encode, pack_headers, patch, pclr, pil_grey16, pil_jp2,
                               pil_la, poc, split_tile_parts, top_boxes, with_header)
from torch_samples import SAMPLES, scene
from vision_kit_tpu.serve import decode_request_bytes as jax_decode_request_bytes
from vision_kit_tpu.utils.readers import ImageReader as JaxImageReader
from vision_kit_tpu_torch import _cuda_build
from vision_kit_tpu_torch.data import decode, jp2
from vision_kit_tpu_torch.serve import decode_request_bytes
from vision_kit_tpu_torch.utils.readers import ImageReader

torch.set_num_threads(2)
cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)

with open(os.path.join(SAMPLES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)["files"]
SAMPLE_NAMES = sorted(n for n, m in MANIFEST.items() if m["kind"].startswith("jp2"))


def sample(name: str) -> bytes:
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def cv2_rgb(data: bytes) -> np.ndarray | None:
    """cv2.imdecode + BGR2RGB; None where cv2 gives None or raises."""
    try:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    return None if bgr is None else np.ascontiguousarray(bgr[:, :, ::-1])


def c_library():
    """csrc/j2k_decode.cu built with g++ (host code with a C interface), or
    None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"vk_j2k_{os.getpid()}.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                    "-x", "c++", _cuda_build.source_path("j2k_decode"), "-o", out],
                   check=True)
    lib = ctypes.CDLL(out)
    os.remove(out)
    return lib


@pytest.fixture(scope="module")
def twin():
    lib = c_library()
    if lib is None:
        pytest.skip("no g++ to build csrc/j2k_decode.cu on the host")
    old = _cuda_build._libs.get("j2k_decode")
    _cuda_build._libs["j2k_decode"] = lib
    yield lib
    if old is None:
        _cuda_build._libs.pop("j2k_decode", None)
    else:
        _cuda_build._libs["j2k_decode"] = old


def outcome(fn, data: bytes):
    """The decode's RGB, or its refusal's message."""
    try:
        return fn(data)[0]
    except jp2.Jp2Error as e:
        return str(e)


def judge(data: bytes, plain: bool = True) -> np.ndarray | None:
    """The twin and (with `plain`) the plain decoder on `data`, held to cv2
    and to each other; returns cv2's RGB."""
    want = cv2_rgb(data)
    got = outcome(jp2.decode_jp2_c, data)
    if plain:
        ref = outcome(jp2.decode_jp2, data)
        if isinstance(ref, str) or isinstance(got, str):
            assert ref == got
        else:
            np.testing.assert_array_equal(got, ref)
    if want is None:
        assert isinstance(got, str), "decoded where cv2 refuses"
    else:
        assert not isinstance(got, str), got
        np.testing.assert_array_equal(got, want)
    return want


def image(h: int, w: int, seed: int, noise: float = 12.0) -> np.ndarray:
    return scene(h, w, seed, noise=noise)


# -- the committed samples ---------------------------------------------------------

@pytest.mark.parametrize("name", SAMPLE_NAMES)
def test_samples(twin, name):
    """Each committed JPEG 2000 sample: decode_image equals cv2 and the
    manifest's rgb_sha256 (the card's check), decode_image(native=True)
    equals it (the 720p ones through the twin alone here; test_torch_decode
    holds decode_image of every sample to cv2), refusals alike."""
    data, meta = sample(name), MANIFEST[name]
    big = meta["kind"] == "jp2_720p"
    want = judge(data, plain=not big)
    if meta["shape"] is None:
        assert want is None and decode.decode_image(data) is None
        return
    assert want.shape == (*meta["shape"], 3)
    got = decode.decode_image(data, native=True)
    assert hashlib.sha256(got.tobytes()).hexdigest() == meta["rgb_sha256"]
    if not big:
        np.testing.assert_array_equal(decode.decode_image(data), got)
    assert decode.image_kind(data) == "jp2" and jp2.is_jp2(data)


def test_sample_set():
    kinds = {MANIFEST[n]["kind"] for n in SAMPLE_NAMES}
    assert {"jp2_53", "jp2_97", "jp2_j2k", "jp2_tiles", "jp2_lrcp", "jp2_rlcp", "jp2_rpcl",
            "jp2_pcrl", "jp2_cprl", "jp2_grey", "jp2_la", "jp2_rgba", "jp2_grey16",
            "jp2_signed", "jp2_cv2", "jp2_styles", "jp2_roi", "jp2_tileparts",
            "jp2_poc", "jp2_ppt", "jp2_ppm", "jp2_720p"} <= kinds
    added = sum(MANIFEST[n]["bytes"] for n in SAMPLE_NAMES)
    assert added < 600_000
    assert all(MANIFEST[n]["bytes"] <= 200_000 for n in SAMPLE_NAMES)


# -- Pillow's and OpenJPEG's settings ------------------------------------------------

PILLOW = [dict(), dict(no_jp2=True), dict(irreversible=True, mct=1),
          dict(quality_layers=[40, 12, 0], mct=1),
          dict(irreversible=True, quality_mode="rates", quality_layers=[30, 10, 4]),
          dict(quality_mode="dB", quality_layers=[28, 36]),
          dict(tile_size=(16, 12), num_resolutions=2),
          dict(tile_size=(13, 11), num_resolutions=3, quality_layers=[20, 0]),
          dict(tile_size=(16, 12), irreversible=True, num_resolutions=2, mct=1),
          dict(num_resolutions=1), dict(num_resolutions=5, codeblock_size=(16, 16)),
          dict(codeblock_size=(4, 4), num_resolutions=3),
          dict(codeblock_size=(16, 4), num_resolutions=3, irreversible=True),
          *(dict(progression=p, precinct_size=(16, 16), num_resolutions=3,
                 codeblock_size=(4, 4), quality_layers=[24, 8, 0])
            for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")),
          dict(progression="RPCL", tile_size=(20, 14), precinct_size=(16, 16),
               num_resolutions=2, quality_layers=[20, 0]),
          dict(plt=True, quality_layers=[20, 0]), dict(signed=True),
          dict(comment=b"a comment")]


@pytest.mark.parametrize("case", range(len(PILLOW)))
def test_pillow_settings(twin, case):
    kw = PILLOW[case]
    rng = np.random.default_rng(100 + case)
    h, w = rng.integers(20, 41, 2)
    rgb = image(int(h), int(w), 100 + case)
    judge(pil_jp2(rgb, **kw))
    judge(pil_jp2(rgb[:, :, 0], **kw))   # grey


def test_pillow_modes(twin):
    """Grey, LA and RGBA (3 channels out; the alpha dropped), 16-bit grey
    (>> 8), a raw J2K of 1 or 2 components (refused: OpenCV assumes sRGB),
    cv2's own writer."""
    rgb = image(30, 26, 7)
    v16 = rgb[:, :, 0].astype(np.uint16) * 257 + np.arange(26, dtype=np.uint16)
    for data in (pil_la(rgb[:, :, 0], rgb[:, :, 1]), pil_jp2(np.dstack([rgb, rgb[:, :, :1]])),
                 pil_grey16(v16), pil_grey16(v16, irreversible=True)):
        assert judge(data) is not None
    for data in (pil_jp2(rgb[:, :, 0], no_jp2=True), pil_la(rgb[:, :, 0], rgb[:, :, 1],
                                                            no_jp2=True)):
        assert judge(data) is None
    np.testing.assert_array_equal(judge(pil_grey16(v16))[:, :, 0], (v16 >> 8).astype(np.uint8))
    ok, buf = cv2.imencode(".jp2", cv2.cvtColor(image(40, 48, 8), cv2.COLOR_RGB2BGR))
    judge(buf.tobytes())


OPENJPEG = [dict(mode=m, irreversible=irr, rates=(30, 10) if irr else (20, 0))
            for m in (1, 2, 4, 8, 16, 32, 1 | 4, 1 | 2 | 8 | 16, 4 | 16 | 32)
            for irr in (False, True)] + [
    dict(roi=(0, 3)), dict(roi=(1, 7), irreversible=True, rates=(30,)),
    dict(roi=(2, 20), irreversible=True, rates=(30,)),
    dict(csty=6, rates=(20, 5, 0)), dict(csty=2, mode=1, rates=(12, 0)),
    dict(tile=(16, 16), tile_parts="R", rates=(20, 5, 0)),
    dict(tile=(16, 16), tile_parts="L", rates=(20, 5, 0), csty=4),
    dict(tile=(24, 16), tile_parts="C", rates=(20, 0)),
    dict(extra=("TLM=YES",)), dict(extra=("PLT=YES",), rates=(10, 0)),
    *(dict(extra=(f"GUARD_BITS={g}",), irreversible=True, rates=(10,)) for g in (0, 1, 4, 7)),
    dict(prog=2, rates=(20, 0)), dict(prog=4, tile=(16, 16), rates=(20, 0))]


@pytest.mark.parametrize("case", range(len(OPENJPEG)))
def test_openjpeg_settings(twin, case):
    """Code-block styles (lazy, reset, termall, vertically causal,
    predictable termination, segmentation symbols), ROI, SOP and EPH,
    tile-parts, TLM and PLT, guard bits, by OpenJPEG's encoder."""
    kw = dict(OPENJPEG[case])
    rgb = image(32, 36, 200 + case)
    judge(opj_encode([rgb[:, :, i] for i in range(3)], numres=3, cblk=(8, 8), **kw))


# -- marker and box mutations --------------------------------------------------------

def _bases():
    rgb = image(24, 28, 300)
    planes = [rgb[:, :, i] for i in range(3)]
    return {"rev": opj_encode(planes, numres=3, cblk=(8, 8), rates=(20, 0)),
            "irr": opj_encode(planes, numres=3, cblk=(8, 8), irreversible=True,
                              rates=(20, 5)),
            "pil": pil_jp2(rgb, num_resolutions=3, codeblock_size=(8, 8), no_jp2=True,
                           quality_layers=[20, 5], mct=1)}


# (marker, byte of its body, values); the COD's code-block style byte (8)
# without bit 0x40 (High Throughput, refused by name)
MUTATIONS = {
    "cod_scod": (0xFF52, 0, [1, 2, 4, 6, 8]), "cod_progression": (0xFF52, 1, range(8)),
    "cod_layers": (0xFF52, 3, [0, 1, 3, 9]), "cod_mct": (0xFF52, 4, [0, 1, 2]),
    "cod_levels": (0xFF52, 5, range(9)), "cod_xcb": (0xFF52, 6, [0, 1, 2, 4, 8, 9]),
    "cod_style": (0xFF52, 8, [v for v in range(128) if not v & 0x40]),
    "cod_transform": (0xFF52, 9, [0, 1, 2]),
    "qcd_style_guard": (0xFF5C, 0, range(256)),
    "qcd_steps": (0xFF5C, 1, [0, 0x08, 0x10, 0x40, 0x80, 0xFF]),
    "siz_precision": (0xFF51, 36, [0, 3, 6, 7, 8, 9, 11, 15, 0x87, 30, 31, 40]),
    "siz_subsampling": (0xFF51, 37, [0, 1, 2]),
}


@pytest.mark.parametrize("family", sorted(MUTATIONS))
def test_marker_mutations(twin, family):
    code, offset, values = MUTATIONS[family]
    for data in _bases().values():
        for v in values:
            judge(patch(data, code, offset, v))


def test_spliced_markers(twin):
    """RGN (a max-shift ROI), COC and QCC restating and changing the COD and
    QCD, COM and CRG and an unknown marker in the main header, a tile split
    into more tile-parts, a layer count past the stream's packets."""
    for data in _bases().values():
        cod = marker_at(data, 0xFF52)
        spcod = data[cod + 9:cod + 2 + struct.unpack_from(">H", data, cod + 2)[0]]
        qcd = marker_at(data, 0xFF5C)
        sqcd = data[qcd + 4:qcd + 2 + struct.unpack_from(">H", data, qcd + 2)[0]]
        cases = [insert_segment(data, 0xFF5C, 0xFF5E, bytes([c, 0, s]))
                 for c, s in ((0, 2), (1, 6), (2, 31), (3, 1))]
        cases += [insert_segment(data, 0xFF5C, 0xFF53, bytes([c, 0]) + spcod)
                  for c in (0, 1, 2, 3)]
        cases += [insert_segment(data, 0xFF5C, 0xFF53, bytes([1, 0]) + spcod[:3]
                                 + bytes([spcod[3] ^ k]) + spcod[4:]) for k in (1, 8, 0x20)]
        cases += [insert_segment(data, 0xFF52, 0xFF5D, bytes([c]) + sqcd) for c in (1, 2, 5)]
        cases += [insert_segment(data, 0xFF5C, 0xFF5D, bytes([2, sqcd[0] ^ 0x20]) + sqcd[1:])]
        cases += [insert_segment(data, 0xFF5C, 0xFF64, b"\x00\x01hello"),
                  insert_segment(data, 0xFF5C, 0xFF63, bytes(12)),
                  insert_segment(data, 0xFF5C, 0xFF63, bytes(8)),
                  insert_segment(data, 0xFF5C, 0xFF30, b"xyz"),
                  insert_segment(data, 0xFF5C, 0xFF58, b"\x00\x05")]
        cases += [split_tile_parts(data, [0.5]), split_tile_parts(data, [0.1, 0.6, 0.9])]
        for case in cases:
            judge(case)


POCS = [[(0, 0, 3, 3, 3, 0)], [(0, 0, 3, 3, 3, 1)], [(0, 0, 3, 2, 3, 0), (2, 0, 3, 3, 3, 0)],
        [(0, 0, 3, 3, 3, 2)], [(0, 0, 3, 3, 3, 4)], [(0, 0, 3, 1, 3, 0), (1, 0, 3, 3, 3, 2)],
        [(0, 0, 1, 3, 3, 0), (0, 0, 3, 3, 3, 0)], [(0, 0, 3, 3, 1, 0), (0, 1, 3, 3, 3, 1)],
        [(0, 0, 3, 3, 3, 7)], [(0, 5, 3, 3, 3, 0)], [(0, 0, 3, 33, 9, 0)], [(2, 0, 3, 1, 3, 0)],
        [(0, 0, 3, 2, 3, 0)], [(0, 0, 3, 1, 3, 0)], [(0, 0, 3, 2, 1, 0), (0, 1, 3, 3, 3, 0)]]


@pytest.mark.parametrize("base", ["lrcp", "rpcl_precincts", "tiles"])
def test_poc(twin, base):
    """POC markers spliced into the main header: records that restate the
    progression, reorder it (the packets then read in another order than
    written: cv2's garbage, equal), leave resolutions or components out
    (each component then decodes to the highest resolution it had, at
    that resolution's coordinates) or are invalid; and seeded random
    records."""
    rgb = image(32, 36, 600)
    planes = [rgb[:, :, i] for i in range(3)]
    data = {"lrcp": opj_encode(planes, numres=3, cblk=(8, 8), rates=(20, 5, 0)),
            "rpcl_precincts": opj_encode(planes, numres=3, cblk=(4, 4), prog=2, rates=(20, 0)),
            "tiles": opj_encode(planes, numres=3, cblk=(8, 8), tile=(16, 16),
                                rates=(20, 0))}[base]
    rng = np.random.default_rng(sum(map(ord, base)))
    records = POCS + [[tuple(int(v) for v in rng.integers(0, [4, 4, 4, 5, 5, 6]))
                       for _ in range(int(rng.integers(1, 4)))] for _ in range(15)]
    restated = poc((0, 0, 3, 3, 3, 2 if base == "rpcl_precincts" else 0))
    # decomposition levels that leave a tile's low resolutions without
    # samples, so that their packets are skipped (OpenJPEG's resno_decoded)
    for lv in (0, 5, 7, 8, 11):
        for recs in ([(0, 0, 2, 2, 3, 0), (2, 0, 2, 3, 3, 0)], [(0, 0, 2, 1, 3, 0),
                                                              (1, 0, 2, 5, 3, 2)]):
            judge(patch(insert_segment(data, 0xFF5C, 0xFF5F, poc(*recs)), 0xFF52, 5, lv))
    np.testing.assert_array_equal(judge(insert_segment(data, 0xFF5C, 0xFF5F, restated)),
                                  cv2_rgb(data))
    for recs in records:
        judge(insert_segment(data, 0xFF5C, 0xFF5F, poc(*recs)))


@pytest.mark.parametrize("where", ["ppt", "ppm"])
def test_packed_headers(twin, where):
    """Packet headers packed into PPT markers (each tile-part's) or PPM
    markers (the main header's), with SOP and EPH, layers, tiles and
    tile-parts: cv2 decodes each to the original's pixels, and so do both
    decoders; then the same files with a PPM or PPT marker of a wrong
    length or order."""
    rgb = image(40, 44, 700)
    planes = [rgb[:, :, i] for i in range(3)]
    for kw in (dict(csty=4), dict(csty=6), dict(csty=4, tile=(16, 16)),
               dict(csty=6, tile=(24, 24), tile_parts="R"), dict(csty=4, rates=(30, 10, 0)),
               dict(csty=4, irreversible=True, rates=(20, 5))):
        data = opj_encode(planes, numres=3, cblk=(8, 8), extra=("PLT=YES",),
                          **{"rates": (20, 0), **kw})
        packed = pack_headers(data, where)
        np.testing.assert_array_equal(judge(packed), cv2_rgb(data))
        code = 0xFF61 if where == "ppt" else 0xFF60
        at = packed.index(struct.pack(">H", code))
        for off in (4, 5, 6, 8):
            judge(packed[:at + off] + bytes([packed[at + off] ^ 0x5A]) + packed[at + off + 1:])
        judge(packed[:at + 4] + bytes([1]) + packed[at + 5:])   # Zppx 1 without a 0


@pytest.mark.parametrize("tiles", [None, (16, 16)])
def test_tile_part_counts(twin, tiles):
    """A tile's data split into 2 or 3 tile-parts with every TNsot from 0
    to 3 in each: OpenJPEG's repair of a TNsot one short (the next
    tile-part of a tile completed by a later tile-part than its first has
    TPsot == TNsot), its premature decode otherwise, and its refusals."""
    import itertools

    rgb = image(24, 28, 300)
    data = opj_encode([rgb[:, :, i] for i in range(3)], numres=2, cblk=(8, 8), rates=(20, 0),
                      tile=tiles)
    at = data.index(b"\xff\x90")
    psot = struct.unpack_from(">I", data, at + 6)[0]
    body = data[at + 14:at + psot]
    assert data[at + 12:at + 14] == b"\xff\x93"
    for n in (2, 3):
        cuts = [len(body) * k // n for k in range(n + 1)]
        for counts in itertools.product(range(4), repeat=n):
            parts = b"".join(
                struct.pack(">HHHIBB", 0xFF90, 10, 0, 14 + cuts[k + 1] - cuts[k], k, counts[k])
                + b"\xff\x93" + body[cuts[k]:cuts[k + 1]] for k in range(n))
            judge(data[:at] + parts + data[at + psot:])


def test_refused_by_name(twin):
    """What no fixture here exercises is refused by both decoders with a
    message that names it: High Throughput code-blocks and the CAP marker
    (Part 15), and Part 2's MCC marker."""
    data = _bases()["rev"]
    named = {"High Throughput": [patch(data, 0xFF52, 8, 0x40), patch(data, 0xFF52, 8, 0x41),
                                 insert_segment(data, 0xFF5C, 0xFF50, bytes(6))],
             "Part 2": [insert_segment(data, 0xFF5C, 0xFF75, bytes(4))]}
    for name, cases in named.items():
        for case in cases:
            for fn in (jp2.decode_jp2, jp2.decode_jp2_c):
                message = outcome(fn, case)
                assert isinstance(message, str) and name in message, (name, message)
            assert decode.decode_image(case) is None


def _jp2_base():
    rgb = image(20, 24, 400)
    grey = rgb[:, :, 0]
    return pil_jp2(rgb, mct=1), pil_jp2(grey), pil_jp2(np.dstack([rgb, grey]))


def test_colour_boxes(twin):
    """colr (sRGB, grey, sYCC, e-sYCC, CMYK, CIELab, unknown, ICC, method
    3, a second colr), pclr with cmap (8, 12, 16-bit columns, direct use,
    short palettes, mismatched maps), cdef (swaps, alpha first, incomplete
    and out-of-range definitions), bpcc and misplaced boxes."""
    rgb, grey, rgba = _jp2_base()
    ihdr = header_boxes(rgb)[0]
    gihdr = header_boxes(grey)[0]
    ihdr4 = header_boxes(rgba)[0]
    ent = [(i, (i * 7) % 256, 255 - i) for i in range(256)]
    cases = []
    for cs in (16, 17, 18, 24, 12, 14, 0, 99):
        cases += [with_header(rgb, [ihdr, colr(cs)]), with_header(grey, [gihdr, colr(cs)])]
    cases += [with_header(rgb, [ihdr, colr(meth=2)]),
              with_header(rgb, [ihdr, (b"colr", b"\x03\x00\x00")]),
              with_header(rgb, [ihdr]), with_header(rgb, [ihdr, colr(17), colr(16)]),
              with_header(rgb, [ihdr, (b"colr", b"\x03\x00\x00"), colr(17)]),
              with_header(rgb, [ihdr, (b"colr", b"\x01\x00")]),
              with_header(rgb, [ihdr, colr(16), (b"bpcc", b"\x07\x07\x07")]),
              with_header(rgb, [ihdr, colr(16), (b"bpcc", b"\x07\x07")]),
              with_header(rgb, [colr(16)]),
              with_header(rgb, [ihdr, (b"xxxx", b"abc"), colr(16)])]
    maps3 = cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    cases += [with_header(grey, [gihdr, colr(16), pclr(ent, [8, 8, 8]), maps3]),
              with_header(grey, [gihdr, colr(16), pclr(ent[:100], [8, 8, 8]), maps3]),
              with_header(grey, [gihdr, colr(16), pclr([(i * 250, i, i * 2) for i in range(256)],
                                                       [16, 8, 12]), maps3]),
              with_header(grey, [gihdr, colr(17), pclr(ent, [8, 8, 8])]),
              with_header(grey, [gihdr, colr(16), pclr(ent, [8, 8, 8]),
                                 cmap([(0, 1, 1), (0, 1, 1), (0, 1, 2)])]),
              with_header(grey, [gihdr, colr(16), pclr(ent, [8, 8, 8]),
                                 cmap([(0, 0, 0), (0, 1, 1), (0, 1, 2)])]),
              with_header(grey, [gihdr, colr(16), pclr(ent, [8, 8, 8]),
                                 cmap([(0, 0, 0), (0, 0, 0), (0, 0, 0)])]),
              with_header(grey, [gihdr, colr(17), pclr([(i * 16,) for i in range(16)], [8]),
                                 cmap([(0, 1, 0)])]),
              with_header(grey, [gihdr, colr(16), maps3, pclr(ent, [8, 8, 8])]),
              with_header(rgb, [ihdr, colr(16), pclr(ent, [8, 8, 8]),
                                cmap([(1, 1, 0), (0, 1, 1), (2, 1, 2)])])]
    for d in ([(0, 0, 3), (1, 0, 2), (2, 0, 1)], [(0, 0, 2), (1, 0, 1), (2, 0, 3)],
              [(0, 0, 1), (1, 0, 2)], [(0, 0, 1), (1, 0, 2), (2, 0, 3), (5, 0, 1)],
              [(2, 0, 1), (1, 0, 2), (0, 0, 3)], [(0, 1, 0), (1, 0, 2), (2, 0, 3)],
              [(0, 0, 0xFFFF), (1, 0, 2), (2, 0, 3)], [(0, 0, 1), (1, 0, 2), (2, 0, 9)]):
        cases.append(with_header(rgb, [ihdr, colr(16), cdef(d)]))
    cases += [with_header(rgba, [ihdr4, colr(16), cdef([(0, 1, 0), (1, 0, 1), (2, 0, 2),
                                                         (3, 0, 3)])]),
              with_header(rgba, [ihdr4, colr(16), cdef([(3, 0, 1), (1, 0, 2), (2, 0, 3),
                                                         (0, 1, 0)])])]
    parts = top_boxes(rgb)
    join = functools.partial(b"".join)
    cases += [join(box(*p) for p in parts[:2] + [(b"uuid", b"0" * 20)] + parts[2:]),
              join(box(*p) for p in parts[:3] + [colr(17)] + parts[3:]),
              join(box(*p) for p in parts[:2] + [colr(17)] + parts[2:]),
              join(box(*p) for p in parts[:1] + parts[2:]),
              join(box(*p) for p in parts) + box(b"uuid", b"1234")]
    for case in cases:
        judge(case)


# -- cut and corrupt files -----------------------------------------------------------------

def _fuzz_bases():
    rgb = image(20, 18, 500)
    planes = [rgb[:, :, i] for i in range(3)]
    return {"pil53": pil_jp2(rgb, num_resolutions=3, codeblock_size=(8, 8), mct=1),
            "pil97_j2k": pil_jp2(rgb, irreversible=True, num_resolutions=2, no_jp2=True,
                                 quality_layers=[12, 4], mct=1),
            "pil_rpcl_tiles": pil_jp2(rgb, num_resolutions=2, tile_size=(12, 10),
                                      progression="RPCL", precinct_size=(16, 16),
                                      quality_layers=[12, 0]),
            "opj_styles": opj_encode(planes, numres=2, cblk=(8, 8), mode=1 | 2 | 8 | 32,
                                     csty=6, rates=(10, 3)),
            "opj_tileparts": opj_encode(planes, numres=2, tile=(16, 16), tile_parts="R",
                                        rates=(10, 0)),
            "grey16": pil_grey16(rgb[:, :, 0].astype(np.uint16) * 257),
            "poc_ppt": pack_headers(insert_segment(
                opj_encode(planes, numres=2, cblk=(8, 8), csty=4, rates=(10, 0),
                           extra=("PLT=YES",)), 0xFF5C, 0xFF5F,
                poc((0, 0, 2, 1, 3, 0), (1, 0, 2, 2, 3, 1))), "ppt"),
            "ppm": pack_headers(opj_encode(planes, numres=2, cblk=(8, 8), csty=6,
                                           rates=(10, 0), extra=("PLT=YES",)), "ppm")}


@pytest.mark.parametrize("base", ["pil53", "pil97_j2k", "pil_rpcl_tiles", "opj_styles",
                                  "opj_tileparts", "grey16", "poc_ppt", "ppm"])
@pytest.mark.parametrize("how", ["truncate", "header_flip", "data_flip", "overwrite"])
def test_fuzz(twin, base, how):
    """Seeded truncations, bit flips in the headers (before the first SOD)
    and in the packet data, and short overwrites: the twin and the plain
    decoder against cv2 on each."""
    data = _fuzz_bases()[base]
    sod = data.index(b"\xff\x93") + 2
    rng = np.random.default_rng(sum(map(ord, base + how)))
    for _ in range(24):
        b = bytearray(data)
        if how == "truncate":
            b = b[:int(rng.integers(1, len(b)))]
        elif how == "header_flip":
            b[int(rng.integers(0, sod))] ^= 1 << int(rng.integers(8))
        elif how == "data_flip":
            b[int(rng.integers(sod, len(b)))] ^= 1 << int(rng.integers(8))
        else:
            i = int(rng.integers(0, len(b)))
            n = int(rng.integers(1, 8))
            b[i:i + n] = rng.integers(0, 256, len(b[i:i + n])).astype(np.uint8).tobytes()
        judge(bytes(b))


# -- the entry points ------------------------------------------------------------------

@pytest.mark.parametrize("name", SAMPLE_NAMES)
def test_decode_request_bytes_equals_jax(twin, name, monkeypatch):
    """The port's serve.decode_request_bytes on the CPU (the 720p samples
    with the twin as its host decode, for time) against the JAX server's
    cv2 path: the letterboxed image bit-equal, ratio, pad and hw0 equal."""
    monkeypatch.setenv("VK_NO_NATIVE", "1")
    data = sample(name)
    want = jax_decode_request_bytes(data, (640, 640))
    host = (functools.partial(decode.decode_image, native=True)
            if MANIFEST[name]["kind"] == "jp2_720p" else None)
    got = decode_request_bytes(data, (640, 640), device="cpu", host_decode=host)
    if want is None:
        assert got is None
        return
    img, (ratio, pad), hw0 = got
    np.testing.assert_array_equal(img.numpy(), want[0])
    assert ratio == want[1][0] and tuple(pad) == tuple(want[1][1])
    assert tuple(hw0) == tuple(want[2])


def test_image_reader_equals_jax(tmp_path):
    """A single .jp2 or .j2k path through the port's ImageReader (on the
    CPU, the plain decoder) against the JAX one (cv2.imread); a directory
    still lists only IMAGE_EXT."""
    for name in ("jp2_53_rct_48x64.jp2", "j2k_53_rct_48x64.j2k", "jp2_signed_48x64.jp2"):
        path = os.path.join(SAMPLES, name)
        (ok, got), = list(ImageReader(path, device="cpu"))
        (want_ok, want), = list(JaxImageReader(path))
        assert ok == want_ok, name
        if ok:
            np.testing.assert_array_equal(got, want[:, :, ::-1])
    (tmp_path / "a.jp2").write_bytes(sample("jp2_53_rct_48x64.jp2"))
    assert ImageReader(str(tmp_path), device="cpu").files == []


def test_routes(twin):
    """host_jp2 on either device, read from the header alone; decode_to
    counts it and takes the twin as its host decode when asked."""
    data = sample("jp2_97_ict_layers_48x64.jp2")
    assert decode.decode_route(data, "cuda") == decode.decode_route(data, "cpu") == "host_jp2"
    assert decode.decode_route(sample("j2k_53_rct_48x64.j2k"), "cuda") == "host_jp2"
    assert "host_jp2" in decode.ROUTES and "jp2" in decode.MODULE_KINDS
    assert "jp2" not in decode.TRAIN_KINDS
    before, calls = decode.route_counts["host_jp2"], jp2.c_calls()
    plain = decode.decode_to(data, "cpu")
    native = decode.decode_to(data, "cpu",
                              host_decode=functools.partial(decode.decode_image, native=True))
    assert torch.equal(plain, native)
    assert decode.route_counts["host_jp2"] - before == 2 and jp2.c_calls() - calls == 1
    assert decode.decode_to(sample("jp2_signed_48x64.jp2"), "cpu") is None


@pytest.fixture(scope="module")
def server():
    """The port's server on the CPU over a seeded v5n@64 (no JAX model)."""
    from vision_kit_tpu_torch.models.architectures import build_model
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.serve import InferenceServer
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(SAMPLES), "..", "..", "configs",
                                   "yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = "n", 2
    pred = Predictor(build_model(cfg, device="cpu", seed=3), img_size=(64, 64),
                     conf_thres=0.0, device="cpu")
    srv = InferenceServer(pred, batch_size=2, max_wait_ms=50.0, port=0)
    try:
        srv.start()
        yield srv
    finally:
        srv.stop()


def test_served_jp2(server):
    """The port's v5n@64 server on the CPU answers a JP2 body with the same
    detections as the same image posted as a PNG, and an HT codestream
    (refused by name) with 400."""
    data = sample("jp2_53_rct_48x64.jp2")
    url = f"http://127.0.0.1:{server.port}/predict"
    status, payload = _post(url, data)
    png = decode.encode_png(decode.decode_image(data))
    status_png, payload_png = _post(url, png)
    assert status == status_png == 200
    assert payload["detections"] == payload_png["detections"] and payload["detections"]
    assert (payload["height"], payload["width"]) == (48, 64)
    ht = patch(_bases()["rev"], 0xFF52, 8, 0x40)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, ht)
    assert err.value.code == 400
