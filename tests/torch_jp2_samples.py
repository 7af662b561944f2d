"""JPEG 2000 fixtures: the committed samples (jp2_files, written into
vision_kit_tpu_torch/data/samples/ by tests/torch_samples.py) and the
helpers tests/test_torch_jp2.py builds its cases with.

Files come from Pillow's JPEG 2000 writer, cv2.imencode('.jp2') and, for
what neither exposes (the code-block styles, ROI, SOP/EPH markers,
tile-parts, TLM, PLT, guard bits), from the OpenJPEG library that Pillow
bundles, driven through ctypes (opj_encode). The JP2 box and marker
helpers splice colour boxes and marker segments (POC among them) into
those files; pack_headers moves a codestream's packet headers into PPT
or PPM markers, which no encoder here writes.
"""

from __future__ import annotations

import ctypes
import glob
import io
import os
import struct
import tempfile

import numpy as np

from torch_samples import scene


# -- Pillow and cv2 ---------------------------------------------------------

def pil_jp2(arr, mode: str | None = None, **kw) -> bytes:
    """Pillow's JPEG 2000 (OpenJPEG 2.5.4) of an array; no_jp2=True gives a
    raw J2K codestream."""
    from PIL import Image

    im = arr if isinstance(arr, Image.Image) else Image.fromarray(arr, mode)
    out = io.BytesIO()
    im.save(out, "JPEG2000", **kw)
    return out.getvalue()


def pil_grey16(values: np.ndarray, **kw) -> bytes:
    from PIL import Image

    h, w = values.shape
    return pil_jp2(Image.frombytes("I;16", (w, h), values.astype("<u2").tobytes()), **kw)


def pil_la(grey: np.ndarray, alpha: np.ndarray, **kw) -> bytes:
    from PIL import Image

    return pil_jp2(Image.merge("LA", [Image.fromarray(grey), Image.fromarray(alpha)]), **kw)


def cv2_jp2(rgb: np.ndarray, x1000: int | None = None) -> bytes:
    import cv2

    params = [] if x1000 is None else [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000]
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(rgb[:, :, ::-1]), params)
    assert ok
    return buf.tobytes()


# -- OpenJPEG's encoder through ctypes ----------------------------------------

_PARAMS_SIZE = 1 << 16   # more than sizeof(opj_cparameters_t)


def _openjp2():
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                   "libopenjp2*"))
    assert found, "Pillow bundles no libopenjp2"
    lib = ctypes.CDLL(found[0])
    for name in ("opj_image_create", "opj_create_compress",
                 "opj_stream_create_default_file_stream"):
        getattr(lib, name).restype = ctypes.c_void_p
    return lib


def _numres_offset(lib) -> int:
    """Where opj_cparameters_t's numresolution lies: the defaults of
    numresolution, cblockw_init, cblockh_init, mode, irreversible,
    roi_compno and roi_shift (6, 64, 64, 0, 0, -1, 0) follow each other."""
    buf = ctypes.create_string_buffer(_PARAMS_SIZE)
    lib.opj_set_default_encoder_parameters(buf)
    ints = np.frombuffer(buf.raw, np.int32)
    for i in range(len(ints) - 7):
        if list(ints[i:i + 7]) == [6, 64, 64, 0, 0, -1, 0]:
            return 4 * i
    raise RuntimeError("opj_cparameters_t's layout is not the expected one")


def opj_encode(planes: list, *, jp2: bool = False, numres: int = 6, cblk=(64, 64),
               mode: int = 0, irreversible: bool = False, roi=None, csty: int = 0,
               prog: int = 0, rates=(0,), tile=None, tile_parts: str | None = None,
               extra=()) -> bytes:
    """OpenJPEG's codestream (or JP2) of 8-bit component planes (lists of
    (H, W) arrays): `mode` the code-block style bits, `roi` (component,
    shift), `csty` the coding style (2 SOP, 4 EPH), `rates` the layers'
    compression ratios (0 lossless), `tile` (w, h), `tile_parts` "R", "L"
    or "C" (a new tile-part at each resolution, layer or component),
    `extra` opj_encoder_set_extra_options strings (TLM=YES, PLT=YES,
    GUARD_BITS=n)."""
    lib = _openjp2()
    nr = _numres_offset(lib)
    h, w = planes[0].shape
    n = len(planes)
    cm = (ctypes.c_uint32 * (9 * n))()   # opj_image_cmptparm_t: dx dy w h x0 y0 prec bpp sgnd
    for i in range(n):
        cm[9 * i:9 * i + 9] = [1, 1, w, h, 0, 0, 8, 8, 0]
    image = lib.opj_image_create(ctypes.c_uint32(n), cm, ctypes.c_int(1 if n >= 3 else 2))
    ctypes.memmove(image, struct.pack("<4I", 0, 0, w, h), 16)   # x0 y0 x1 y1
    comps = ctypes.c_void_p.from_address(image + 24).value   # opj_image_t.comps
    for i in range(n):   # opj_image_comp_t: 64 bytes, data at 48
        data = ctypes.c_void_p.from_address(comps + 64 * i + 48).value
        np.ctypeslib.as_array((ctypes.c_int32 * (w * h)).from_address(data))[:] = (
            np.asarray(planes[i], np.int32).ravel())
    p = ctypes.create_string_buffer(_PARAMS_SIZE)
    lib.opj_set_default_encoder_parameters(p)
    struct.pack_into("<iiii", p, nr, numres, cblk[0], cblk[1], mode)
    struct.pack_into("<i", p, nr + 16, int(irreversible))
    if roi:
        struct.pack_into("<ii", p, nr + 20, *roi)
    struct.pack_into("<ii", p, 48, csty, prog)   # csty, prog_order
    struct.pack_into("<i", p, 20, 1)   # cp_disto_alloc
    struct.pack_into("<i", p, nr - 804, len(rates))   # tcp_numlayers, then tcp_rates
    struct.pack_into(f"<{len(rates)}f", p, nr - 800, *rates)
    if tile:
        struct.pack_into("<iiiii", p, 0, 1, 0, 0, *tile)   # tile_size_on, tx0, ty0, tdx, tdy
    assert struct.unpack_from("<ii", p, nr + 12596) == (1, 1)   # subsampling_dx, _dy
    if tile_parts:
        struct.pack_into("<bb", p, nr + 13096, 1, ord(tile_parts))   # tp_on, tp_flag
    codec = ctypes.c_void_p(lib.opj_create_compress(ctypes.c_int(2 if jp2 else 0)))
    if extra:
        opts = (ctypes.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None)
        assert lib.opj_encoder_set_extra_options(codec, opts)
    image = ctypes.c_void_p(image)
    assert lib.opj_setup_encoder(codec, p, image)
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    stream = ctypes.c_void_p(lib.opj_stream_create_default_file_stream(path.encode(),
                                                                       ctypes.c_int(0)))
    ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
          and lib.opj_end_compress(codec, stream))
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(image)
    with open(path, "rb") as f:
        data = f.read()
    os.remove(path)
    assert ok, "OpenJPEG failed to encode"
    return data


# -- JP2 boxes and codestream markers ------------------------------------------

def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def top_boxes(data: bytes) -> list[tuple[bytes, bytes]]:
    """[(type, body)] of a JP2's top-level boxes."""
    out, pos = [], 0
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        n = n or len(data) - pos
        out.append((kind, data[pos + 8:pos + n]))
        pos += n
    return out


def header_boxes(data: bytes) -> list[tuple[bytes, bytes]]:
    """[(type, body)] of the boxes inside a JP2's jp2h."""
    body = dict(top_boxes(data))[b"jp2h"]
    out, pos = [], 0
    while pos < len(body):
        n, kind = struct.unpack_from(">I4s", body, pos)
        out.append((kind, body[pos + 8:pos + n]))
        pos += n
    return out


def with_header(data: bytes, subs: list[tuple[bytes, bytes]]) -> bytes:
    """The JP2 with its jp2h holding the boxes `subs`."""
    return b"".join(box(k, b if k != b"jp2h" else b"".join(box(*s) for s in subs))
                    for k, b in top_boxes(data))


def colr(enumcs: int = 16, meth: int = 1) -> tuple[bytes, bytes]:
    return b"colr", bytes([meth, 0, 0]) + (struct.pack(">I", enumcs) if meth == 1 else b"ICC")


def pclr(entries: list, sizes: list) -> tuple[bytes, bytes]:
    body = struct.pack(">HB", len(entries), len(sizes)) + bytes(s - 1 for s in sizes)
    for entry in entries:
        for v, s in zip(entry, sizes):
            body += int(v).to_bytes((s + 7) // 8, "big")
    return b"pclr", body


def cmap(maps: list) -> tuple[bytes, bytes]:
    return b"cmap", b"".join(struct.pack(">HBB", *m) for m in maps)


def cdef(defs: list) -> tuple[bytes, bytes]:
    return b"cdef", struct.pack(">H", len(defs)) + b"".join(struct.pack(">HHH", *d)
                                                            for d in defs)


def marker_at(data: bytes, code: int) -> int | None:
    """Where the main header's first `code` marker segment starts."""
    pos = data.index(b"\xff\x4f\xff\x51") + 2
    while pos + 4 <= len(data):
        m, n = struct.unpack_from(">HH", data, pos)
        if m == code:
            return pos
        if m == 0xFF90:
            return None
        pos += 2 + n
    return None


def patch(data: bytes, code: int, offset: int, value: int) -> bytes:
    """`data` with byte `offset` of marker `code`'s body (past its length)
    set to `value`."""
    at = marker_at(data, code) + 4 + offset
    return data[:at] + bytes([value]) + data[at + 1:]


def poc(*records) -> bytes:
    """A POC marker's body for fewer than 257 components: each record
    (resno0, compno0, layno1, resno1, compno1, progression)."""
    return b"".join(struct.pack(">BBHBBB", *r) for r in records)


def insert_segment(data: bytes, before: int, code: int, body: bytes) -> bytes:
    """`data` with a marker segment `code` inserted before marker `before`
    of the main header."""
    at = marker_at(data, before)
    return data[:at] + struct.pack(">HH", code, len(body) + 2) + body + data[at:]


def split_tile_parts(data: bytes, cuts: list[float]) -> bytes:
    """A one-tile-part codestream with its tile's data split into more
    tile-parts at the given fractions of the data (TNsot set to their
    count)."""
    sot = data.index(b"\xff\x90")
    psot = struct.unpack_from(">I", data, sot + 6)[0]
    head_end = data.index(b"\xff\x93", sot) + 2
    body = data[head_end:sot + psot]
    bounds = [0, *(int(len(body) * f) for f in cuts), len(body)]
    parts = len(bounds) - 1
    out = data[:sot]
    for k in range(parts):
        chunk = body[bounds[k]:bounds[k + 1]]
        hdr = data[sot + 12:head_end - 2] if k == 0 else b""
        out += (struct.pack(">HHHIBB", 0xFF90, 10, 0, 12 + len(hdr) + 2 + len(chunk), k, parts)
                + hdr + b"\xff\x93" + chunk)
    return out + data[sot + psot:]


# -- the committed samples ---------------------------------------------------------

def hd_scene(seed: int) -> np.ndarray:
    """A 720x1280 RGB frame: torch_samples.scene's gradients and shapes."""
    return scene(720, 1280, seed)


def jp2_files() -> dict[str, tuple[bytes, str, tuple | None]]:
    """The JPEG 2000 samples: {file name: (bytes, kind, decoded (h, w) or
    None)}. Each kind starts with "jp2" (route host_jp2)."""
    rgb = scene(48, 64, 90)
    planes = [rgb[:, :, i] for i in range(3)]
    grey = rgb[:, :, 1]
    files = {}

    def put(name, data, kind, shape=(48, 64)):
        files[name] = (data, kind, shape)

    put("jp2_53_rct_48x64.jp2", pil_jp2(rgb, mct=1), "jp2_53")
    put("j2k_53_rct_48x64.j2k", pil_jp2(rgb, mct=1, no_jp2=True), "jp2_j2k")
    put("jp2_97_ict_layers_48x64.jp2",
        pil_jp2(rgb, irreversible=True, mct=1, quality_mode="rates",
                quality_layers=[40, 20, 8]), "jp2_97")
    put("jp2_53_mct0_48x64.jp2", pil_jp2(rgb, quality_layers=[10]), "jp2_mct0")
    put("jp2_97_mct0_48x64.j2k", pil_jp2(rgb, irreversible=True, no_jp2=True,
                                         quality_layers=[20]), "jp2_97")
    put("jp2_tiles_48x64.jp2", pil_jp2(rgb, tile_size=(24, 20), num_resolutions=3,
                                      quality_layers=[12]),
        "jp2_tiles")
    put("jp2_res1_cb16_48x64.jp2", pil_jp2(rgb, num_resolutions=1, codeblock_size=(16, 16),
                                            quality_layers=[10]),
        "jp2_res1")
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        put(f"jp2_{prog.lower()}_precincts_48x64.jp2",
            pil_jp2(rgb, progression=prog, num_resolutions=3, precinct_size=(32, 32),
                    codeblock_size=(8, 8), quality_layers=[30, 10]), f"jp2_{prog.lower()}")
    put("jp2_plt_48x64.jp2", pil_jp2(rgb, plt=True, quality_layers=[20, 8]), "jp2_plt")
    put("jp2_grey_48x64.jp2", pil_jp2(grey), "jp2_grey")
    put("jp2_la_48x64.jp2", pil_la(grey, rgb[:, :, 2]), "jp2_la")
    put("jp2_rgba_48x64.jp2", pil_jp2(np.dstack([rgb, grey]), quality_layers=[10]), "jp2_rgba")
    put("jp2_grey16_48x64.jp2",
        pil_grey16(grey.astype(np.uint16) * 251 + np.arange(64, dtype=np.uint16)),
        "jp2_grey16")
    put("jp2_signed_48x64.jp2", pil_jp2(rgb, signed=True, quality_layers=[20]), "jp2_signed",
        None)
    put("jp2_cv2_48x64.jp2", cv2_jp2(rgb), "jp2_cv2")
    put("j2k_styles_lazy_reset_vsc_48x64.j2k",
        opj_encode(planes, numres=3, cblk=(16, 16), mode=1 | 2 | 8, rates=(12, 4)),
        "jp2_styles")
    put("j2k_styles_termall_pterm_segsym_48x64.j2k",
        opj_encode(planes, numres=3, cblk=(16, 16), mode=4 | 16 | 32, rates=(12, 3)),
        "jp2_styles")
    put("j2k_roi_sop_eph_48x64.j2k",
        opj_encode(planes, numres=3, cblk=(16, 16), roi=(0, 5), csty=6, irreversible=True,
                   rates=(16, 6)), "jp2_roi")
    put("j2k_tileparts_tlm_48x64.j2k",
        opj_encode(planes, numres=3, tile=(32, 32), tile_parts="R", rates=(10, 3),
                   extra=("TLM=YES",)), "jp2_tileparts")
    put("j2k_poc_48x64.j2k",
        insert_segment(opj_encode(planes, numres=3, cblk=(16, 16), rates=(12, 4)), 0xFF5C,
                       0xFF5F, poc((0, 0, 2, 2, 3, 0), (2, 0, 2, 3, 3, 0))), "jp2_poc")
    packed = opj_encode(planes, numres=3, cblk=(16, 16), csty=6, rates=(12, 4),
                        extra=("PLT=YES",))
    put("j2k_ppt_48x64.j2k", pack_headers(packed, "ppt"), "jp2_ppt")
    put("j2k_ppm_48x64.j2k", pack_headers(packed, "ppm"), "jp2_ppm")
    # two 720p frames: 9/7 in three layers, and 5/3 rate-limited by its layers
    put("jp2_97_layers_720x1280.jp2",
        pil_jp2(hd_scene(91), irreversible=True, mct=1, quality_mode="rates",
                quality_layers=[400, 200, 100]), "jp2_720p", (720, 1280))
    put("jp2_53_layers_720x1280.jp2",
        pil_jp2(hd_scene(92), mct=1, quality_mode="rates", quality_layers=[400, 200, 100]),
        "jp2_720p", (720, 1280))
    return files


def _segments(data: bytes, start: int, stop: int) -> list[tuple[int, bytes]]:
    """(marker, body) of the marker segments in data[start:stop]."""
    out, pos = [], start
    while pos < stop:
        m, n = struct.unpack_from(">HH", data, pos)
        out.append((m, data[pos + 4:pos + 2 + n]))
        pos += 2 + n
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def _plt_lengths(body: bytes) -> list[int]:
    out, v = [], 0
    for b in body[1:]:
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            out.append(v)
            v = 0
    return out


def pack_headers(data: bytes, where: str) -> bytes:
    """A codestream written with EPH markers and PLT (OpenJPEG's csty 4 and
    PLT=YES) rewritten with its packet headers packed into PPT markers in
    each tile-part header (`where` "ppt") or into PPM markers in the main
    header ("ppm"), the tile-parts keeping the packets' bodies (and SOP
    markers). Each packet's header ends at its EPH marker; the PLT
    markers give where each packet ends, and are dropped."""
    first_sot = data.index(b"\xff\x90")
    main = data[:first_sot]
    parts, pos = [], first_sot
    while data[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", data, pos + 6)[0]
        sod = data.index(b"\xff\x93", pos + 12)
        segs = _segments(data, pos + 12, sod)
        body = data[sod + 2:pos + psot]
        lengths = [n for m, b in segs if m == 0xFF58 for n in _plt_lengths(b)]
        assert sum(lengths) == len(body)
        headers, bodies, at = b"", b"", 0
        for n in lengths:
            packet = body[at:at + n]
            at += n
            if packet[:2] == b"\xff\x91":   # SOP stays in the tile-part
                bodies += packet[:6]
                packet = packet[6:]
            eph = packet.index(b"\xff\x92") + 2
            headers += packet[:eph]
            bodies += packet[eph:]
        keep = b"".join(_segment(m, b) for m, b in segs if m != 0xFF58)
        parts.append((data[pos + 4:pos + 12], keep, headers, bodies))
        pos += psot
    tail = data[pos:]
    out_main = main
    if where == "ppm":
        stream = b"".join(struct.pack(">I", len(h)) + h for _, _, h, _ in parts)
        chunks = [stream[i:i + 60000] for i in range(0, len(stream), 60000)]
        at = marker_at(data, 0xFF5C)
        out_main = main[:at] + b"".join(_segment(0xFF60, bytes([z]) + c)
                                        for z, c in enumerate(chunks)) + main[at:]
    out = out_main
    zppt: dict = {}   # Zppt runs on over a tile's tile-parts
    for sot, keep, headers, bodies in parts:
        isot, _, tp, tn = struct.unpack(">HIBB", sot)
        if where == "ppt":
            chunks = [headers[i:i + 60000] for i in range(0, len(headers), 60000)] or [b""]
            for c in chunks:
                z = zppt.get(isot, 0)
                zppt[isot] = z + 1
                keep += _segment(0xFF61, bytes([z]) + c)
        psot = 12 + len(keep) + 2 + len(bodies)
        out += (struct.pack(">HHHIBB", 0xFF90, 10, isot, psot, tp, tn) + keep + b"\xff\x93"
                + bodies)
    return out + tail
