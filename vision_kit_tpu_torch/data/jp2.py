"""JPEG 2000 decode without OpenCV: cv2.imdecode(IMREAD_COLOR) + BGR2RGB of
a JP2 file or a raw J2K codestream (JPEG 2000 Part 1), bit for bit, in
numpy and the standard library.

The reference is OpenCV 5's grfmt_jpeg2000_openjpeg.cpp over OpenJPEG
2.5.3, as cv2 runs them. The stages follow OpenJPEG's files:

- jp2.c: the boxes. The signature box first, then ftyp, then jp2h (ihdr,
  colr, bpcc, pclr, cmap, cdef; ihdr is required), any other box skipped,
  up to jp2c, whose codestream runs to the end of the bytes. The first
  colr of method 1 or 2 counts (method > 2 is ignored); its enumerated
  space 16 is sRGB, 17 grey, 18 sYCC, 24 e-sYCC, 12 CMYK, anything else
  (an ICC profile included) unknown. After the codestream decodes, a
  palette (pclr with its cmap) expands its index component, each entry
  clamped to the palette, and cdef swaps colour channels into place.
- j2k.c: the codestream. SOC, SIZ, then the main header (COD, COC, QCD,
  QCC, RGN, POC, PPM, TLM, PLM, CRG, COM, MCT; an unknown marker is
  skipped by scanning 16-bit words to the next known one), then
  tile-parts: SOT, the tile-part header (COD, COC, QCD, QCC, RGN, POC,
  PPT, PLT, COM), SOD and Psot's bytes. A tile decodes when its last
  tile-part (TNsot) is read, the rest at EOC; after each tile the next
  marker must be SOT or EOC, unless the bytes end (what was read of the
  tile being decoded then decodes as it is). A tile-part longer than the
  bytes left refuses the file (OpenJPEG's strict mode). OpenJPEG repairs
  a TNsot one short (the next tile-part of a tile completed by a later
  tile-part than its first has TPsot == TNsot), looking ahead once.
- tcd.c and pi.c: tiles, resolutions, bands, precincts and code-blocks,
  and the packet order of the five progressions (LRCP, RLCP, RPCL, PCRL,
  CPRL), one iterator per POC record, each packet taken once. A tile's
  component decodes up to the highest resolution of its decoded packets
  (resno_decoded): a packet none of whose band's precincts meets the tile
  is skipped (its header read all the same), and a component whose
  packets in a POC iterator are all skipped so far decodes whole while
  resno_decoded is 0. A POC that leaves resolutions out gives that
  resolution's samples at its own coordinates and zeros elsewhere.
- t2.c and tgt.c: packet headers (SOP and EPH markers, the inclusion and
  zero-bit-plane tag trees, pass counts, Lblock), read from the tile's
  bytes or from the PPT markers of its tile-parts or the PPM markers of
  the main header (running on from tile to tile), and the code-blocks'
  bytes, segment by segment (TERMALL and the lazy mode's raw segments).
- t1.c and mqc.c: the MQ decoder with OpenJPEG's end-of-segment handling
  (an artificial 0xFFFF after each segment), significance propagation,
  magnitude refinement and cleanup with its run mode, the code-block
  styles (lazy, reset, termall, vertically causal, predictable
  termination, segmentation symbols), the ROI max-shift and the mid-point
  reconstruction of a code-block cut short by its layers (the half bit
  OpenJPEG keeps below each decoded bit plane).
- Dequantisation: the reversible path halves T1's values (C division);
  the irreversible one multiplies them by float32(0.5 * stepsize), the
  stepsize float32((1 + mant / 2048) * 2^(prec + gain - expn)) with gain 0
  for the 9/7 (OpenJPEG's BUG_WEIRD_TWO_INVK).
- dwt.c: the inverse 5/3 in integer lifting, and the inverse 9/7 in
  float32 with OpenJPEG's constants and order (L x K, H x 1.625732422,
  then delta, gamma, beta, alpha; each a separate multiply and add),
  rows first, then columns, level by level.
- mct.c and tcd.c: the inverse RCT or ICT over the first three
  components, then the DC level shift, lrintf (round half to even) for
  the 9/7, and the clamp to the component's range.
- OpenCV: every component's precision must be 8 or more and none signed,
  with no sub-sampling and no image offset. The samples are shifted right
  by the largest precision less 8 and cast to 8 bits. sRGB and unknown
  spaces take components 0, 1, 2 (1 or 2 components are refused), grey
  takes component 0 thrice, sYCC converts components 0, 1, 2 through
  OpenCV's YUV2BGR; CMYK and e-sYCC are refused.

The video mode (decode_jp2_planes, decode_jp2_planes_c) is what
cv2.VideoCapture's libavcodec jpeg2000dec gives a Motion JPEG 2000 frame:
the component planes at their own sampling, without OpenCV's refusal
(video_refusal takes 8-bit 4:2:0 and grey), the codestream read as above
but a 9/7 tile dequantised and inverted with libavcodec's float
arithmetic: its stepsize folds the 9/7's band gains (powers of K, and
X = 1/K) into the dequantisation, computed partly in double
(libav_stepsize), and its lifting scales no band, a lone sample times X
or K / 2 (jpeg2000dwt.c's sr_1d97_float). The planes then equal
libavcodec's bit for bit; through mpeg4.yuv420_to_rgb, cv2's frames.

What no fixture here can exercise is refused by name (Jp2Error's
message): High Throughput code-blocks and the CAP and CPF markers (Part
15), and Part 2's MCC, MCO and CBD markers (an MCT marker is read, and of
no effect: a COD's MCT field above 1 is refused). csrc/j2k_decode.cu is
this decoder in host C++, with the same stages and messages.
"""

from __future__ import annotations

import functools
import math
import struct

import numpy as np

from vision_kit_tpu_torch.data.decode import size_refusal

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"


class Jp2Error(ValueError):
    """Bytes that cv2 does not decode as JPEG 2000; decode_image answers
    None."""


class Jp2Unsupported(ValueError):
    """A Motion JPEG 2000 frame that cv2.VideoCapture converts (libavcodec's
    jpeg2000dec and swscale) and the video mode does not: its layout is
    named."""


def is_jp2(data: bytes) -> bool:
    """OpenCV's two JPEG 2000 signatures: the JP2 signature box or a J2K
    codestream's SOC and SIZ."""
    return data[:12] == JP2_SIGNATURE or data[:4] == J2K_SIGNATURE


def _u(data: bytes, pos: int, n: int) -> int:
    if pos + n > len(data):
        raise Jp2Error("the bytes end inside a field")
    return int.from_bytes(data[pos:pos + n], "big")


# -- jp2.c: the boxes ------------------------------------------------------

_SIGNATURE, _FILE_TYPE, _HEADER = 1, 2, 4
_IMG_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


def _box_header(data: bytes, pos: int, end: int) -> tuple[int, bytes, int] | None:
    """(length, type, header bytes) of the box at `pos`, or None when fewer
    than 8 bytes (16 for an XLBox) are left (opj_jp2_read_boxhdr)."""
    if pos + 8 > end:
        return None
    length, kind = struct.unpack_from(">I4s", data, pos)
    if length == 0:
        return end - pos, kind, 8
    if length == 1:
        if pos + 16 > end:
            return None
        hi, length = struct.unpack_from(">II", data, pos + 8)
        if hi:
            raise Jp2Error("Cannot handle box sizes higher than 2^32")
        return length, kind, 16
    return length, kind, 8


def _img_box(jp2: dict, kind: bytes, body: bytes) -> None:
    """One image header box (opj_jp2_read_ihdr, _colr, _bpcc, _pclr,
    _cmap, _cdef)."""
    if kind == b"ihdr":
        if jp2["ihdr"]:
            return
        if len(body) != 14:
            raise Jp2Error("Bad image header box (bad size)")
        h, w, nc = _u(body, 0, 4), _u(body, 4, 4), _u(body, 8, 2)
        if w < 1 or h < 1 or nc < 1:
            raise Jp2Error(f"Wrong values for: w({w}) h({h}) numcomps({nc}) (ihdr)")
        if nc > 16384:
            raise Jp2Error("Invalid number of components (ihdr)")
        jp2["ihdr"] = True
        jp2["numcomps"] = nc
        jp2["ihdr_h"], jp2["ihdr_w"] = h, w
    elif kind == b"colr":
        if len(body) < 3:
            raise Jp2Error("Bad COLR header box (bad size)")
        if jp2["has_colr"]:
            return
        meth = body[0]
        if meth == 1:
            if len(body) < 7:
                raise Jp2Error("Bad COLR header box (bad size)")
            jp2["enumcs"] = _u(body, 3, 4)
            jp2["has_colr"] = True
        elif meth == 2:
            jp2["has_colr"] = True
    elif kind == b"bpcc":
        if len(body) != jp2["numcomps"]:
            raise Jp2Error("Bad BPCC header box (bad size)")
    elif kind == b"pclr":
        if jp2["pclr"] is not None or len(body) < 3:
            raise Jp2Error("Invalid PCLR box")
        nr_entries, nr_channels = _u(body, 0, 2), body[2]
        if nr_entries == 0 or nr_entries > 1024:
            raise Jp2Error(f"Invalid PCLR box. Reports {nr_entries} entries")
        if nr_channels == 0:
            raise Jp2Error("Invalid PCLR box. Reports 0 palette columns")
        if len(body) < 3 + nr_channels:
            raise Jp2Error("Invalid PCLR box")
        sizes = [(b & 0x7F) + 1 for b in body[3:3 + nr_channels]]
        pos = 3 + nr_channels
        entries = np.zeros((nr_entries, nr_channels), np.int64)
        for j in range(nr_entries):
            for i in range(nr_channels):
                n = min((sizes[i] + 7) >> 3, 4)
                if pos + n > len(body):
                    raise Jp2Error("Invalid PCLR box")
                entries[j, i] = int.from_bytes(body[pos:pos + n], "big")
                pos += n
        jp2["pclr"] = {"entries": entries, "cmap": None}
    elif kind == b"cmap":
        pclr = jp2["pclr"]
        if pclr is None:
            raise Jp2Error("Need to read a PCLR box before the CMAP box.")
        if pclr["cmap"] is not None:
            raise Jp2Error("Only one CMAP box is allowed.")
        n = pclr["entries"].shape[1]
        if len(body) < 4 * n:
            raise Jp2Error("Insufficient data for CMAP box.")
        pclr["cmap"] = [[_u(body, 4 * i, 2), body[4 * i + 2], body[4 * i + 3]] for i in range(n)]
    elif kind == b"cdef":
        if jp2["cdef"] is not None:
            raise Jp2Error("Only one CDEF box is allowed.")
        if len(body) < 2:
            raise Jp2Error("Insufficient data for CDEF box.")
        n = _u(body, 0, 2)
        if n == 0:
            raise Jp2Error("Number of channel description is equal to zero in CDEF box.")
        if len(body) < 2 + 6 * n:
            raise Jp2Error("Insufficient data for CDEF box.")
        jp2["cdef"] = [list(struct.unpack_from(">HHH", body, 2 + 6 * i)) for i in range(n)]


def read_jp2(data: bytes) -> dict:
    """The JP2 boxes up to jp2c (opj_jp2_read_header_procedure): a dict with
    "codestream" (where jp2c's payload starts), "enumcs", "pclr", "cdef"."""
    jp2 = {"ihdr": False, "numcomps": 0, "has_colr": False, "enumcs": 0,
           "pclr": None, "cdef": None}
    end, pos, state = len(data), 0, 0
    while True:
        box = _box_header(data, pos, end)
        if box is None:
            raise Jp2Error("no codestream box")
        length, kind, hdr = box
        if kind == b"jp2c":
            if not state & _HEADER:
                raise Jp2Error("bad placed jpeg codestream")
            break
        if length < hdr:
            raise Jp2Error(f"invalid box size {length}")
        size = length - hdr
        body_at = pos + hdr
        pos = body_at + size
        top = kind in (b"jP  ", b"ftyp", b"jp2h")
        if not top and kind in _IMG_BOXES and not state & _HEADER:
            if pos > end:   # skipped, if the bytes hold it
                raise Jp2Error("Problem with skipping JPEG2000 box, stream error")
            continue
        if not top and kind not in _IMG_BOXES:
            if not state & _SIGNATURE:
                raise Jp2Error("Malformed JP2 file format: first box must be JPEG 2000 "
                               "signature box")
            if not state & _FILE_TYPE:
                raise Jp2Error("Malformed JP2 file format: second box must be file type box")
            if pos > end:
                raise Jp2Error("Problem with skipping JPEG2000 box, stream error")
            continue
        if pos > end:
            raise Jp2Error(f"Invalid box size {size} for a box")
        body = data[body_at:pos]
        if kind == b"jP  ":
            if state != 0:
                raise Jp2Error("The signature box must be the first box in the file.")
            if size != 4:
                raise Jp2Error("Error with JP signature Box size")
            if body != b"\r\n\x87\n":
                raise Jp2Error("Error with JP Signature : bad magic number")
            state |= _SIGNATURE
        elif kind == b"ftyp":
            if state != _SIGNATURE:
                raise Jp2Error("The ftyp box must be the second box in the file.")
            if size < 8 or (size - 8) & 3:
                raise Jp2Error("Error with FTYP signature Box size")
            state |= _FILE_TYPE
        elif kind == b"jp2h":
            if not state & _FILE_TYPE:
                raise Jp2Error("The  box must be the first box in the file.")
            has_ihdr, at = False, 0
            while at < size:
                if size - at < 8:
                    raise Jp2Error("Cannot handle box of less than 8 bytes")
                sub_len, sub_kind = struct.unpack_from(">I4s", body, at)
                sub_hdr = 8
                if sub_len == 1:
                    if size - at < 16:
                        raise Jp2Error("Cannot handle XL box of less than 16 bytes")
                    hi, sub_len = struct.unpack_from(">II", body, at + 8)
                    if hi:
                        raise Jp2Error("Cannot handle box sizes higher than 2^32")
                    sub_hdr = 16
                elif sub_len == 0:
                    raise Jp2Error("Cannot handle box of undefined sizes")
                if sub_len < sub_hdr:
                    raise Jp2Error("Box length is inconsistent.")
                if sub_len > size - at:
                    raise Jp2Error("Stream error while reading JP2 Header box: box length "
                                   "is inconsistent.")
                if sub_kind in _IMG_BOXES:
                    _img_box(jp2, sub_kind, body[at + sub_hdr:at + sub_len])
                has_ihdr |= sub_kind == b"ihdr"
                at += sub_len
            if not has_ihdr:
                raise Jp2Error("Stream error while reading JP2 Header box: no 'ihdr' box.")
            state |= _HEADER
        else:   # an image header box after jp2h: read anyway
            _img_box(jp2, kind, body)
    if not jp2["ihdr"]:
        raise Jp2Error("IHDR box missing. Required.")
    jp2["codestream"] = pos + hdr
    return jp2


# -- j2k.c: the codestream -------------------------------------------------

SOC, SOT, SOD, EOC, SIZ = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9, 0xFF51
COD, COC, RGN, QCD, QCC, POC = 0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F
TLM, PLM, PLT, PPM, PPT, CRG, COM = 0xFF55, 0xFF57, 0xFF58, 0xFF60, 0xFF61, 0xFF63, 0xFF64
CAP, CPF, MCT, MCC, MCO, CBD = 0xFF50, 0xFF59, 0xFF74, 0xFF75, 0xFF77, 0xFF78
_MHSIZ, _MH, _TPHSOT, _TPH = 2, 4, 8, 16
# j2k_memory_marker_handler_tab: where each marker may stand; any other
# marker (SOP, SOD, EOC, SOC, unknown ones) is "unknown", allowed in MH|TPH
_STATES = {SOT: _MH | _TPHSOT, COD: _MH | _TPH, COC: _MH | _TPH, RGN: _MH | _TPH,
           QCD: _MH | _TPH, QCC: _MH | _TPH, POC: _MH | _TPH, SIZ: _MHSIZ, TLM: _MH,
           PLM: _MH, PLT: _TPH, PPM: _MH, PPT: _TPH, 0xFF91: 0, CRG: _MH,
           COM: _MH | _TPH, MCT: _MH | _TPH, CBD: _MH, CAP: _MH, CPF: _MH,
           MCC: _MH | _TPH, MCO: _MH | _TPH}
_UNKNOWN_STATES = _MH | _TPH
# what no fixture here exercises, refused by name
_REFUSED = {CAP: "High Throughput JPEG 2000 (Part 15, CAP marker)",
            CPF: "Part 15 CPF marker", MCC: "Part 2 multiple component transforms (MCC)",
            MCO: "Part 2 multiple component transforms (MCO)",
            CBD: "Part 2 component bit depth (CBD)"}
LRCP, RLCP, RPCL, PCRL, CPRL = range(5)
# code-block style bits (predictable termination, 16, changes no decode)
CBLK_LAZY, CBLK_RESET, CBLK_TERMALL, CBLK_VSC, CBLK_SEGSYM = 1, 2, 4, 8, 32
CBLK_HT, CBLK_HTMIXED = 0x40, 0x80
MAX_RLVLS, MAX_BANDS = 33, 3 * 33 - 2


def _known(marker: int) -> bool:
    return marker in _STATES


def _states(marker: int) -> int:
    return _STATES.get(marker, _UNKNOWN_STATES)


class _Tccp:
    """A tile-component's coding parameters (opj_tccp_t)."""
    __slots__ = ("csty", "numres", "cblkw", "cblkh", "cblksty", "qmfbid", "prcw", "prch",
                 "qntsty", "numgbits", "stepsizes", "roishift")

    def __init__(self):
        self.csty = self.numres = self.cblkw = self.cblkh = self.cblksty = 0
        self.qmfbid = self.qntsty = self.numgbits = self.roishift = 0
        self.prcw = [15] * MAX_RLVLS
        self.prch = [15] * MAX_RLVLS
        self.stepsizes = [(0, 0)] * MAX_BANDS   # (expn, mant)

    def copy(self) -> "_Tccp":
        t = _Tccp()
        for k in self.__slots__:
            v = getattr(self, k)
            setattr(t, k, list(v) if isinstance(v, list) else v)
        return t


class _Tcp:
    """A tile's coding parameters (opj_tcp_t) and its tile-part state."""

    def __init__(self, numcomps: int):
        self.csty = self.prg = self.numlayers = self.mct = 0
        self.tccps = [_Tccp() for _ in range(numcomps)]
        self.pocs = []            # (prg, resno0, compno0, layno1, resno1, compno1)
        self.ppt = {}             # Zppt -> the PPT marker's packet headers
        self.data = None          # the tile-parts' bytes, joined
        self.part_number = -1     # the last TPsot read
        self.nb_parts = 0         # TNsot, once given

    def copy(self) -> "_Tcp":
        t = _Tcp(0)
        t.csty, t.prg, t.numlayers, t.mct = self.csty, self.prg, self.numlayers, self.mct
        t.tccps = [c.copy() for c in self.tccps]
        t.pocs = list(self.pocs)
        return t


def _read_siz(cs: dict, body: bytes) -> None:
    if len(body) < 36:
        raise Jp2Error("Error with SIZ marker size")
    n = (len(body) - 36)
    if n % 3:
        raise Jp2Error("Error with SIZ marker size")
    (_, x1, y1, x0, y0, tdx, tdy, tx0, ty0, csiz) = struct.unpack_from(">HIIIIIIIIH", body, 0)
    if csiz >= 16385 or csiz == 0:
        raise Jp2Error(f"Error with SIZ marker: number of component is illegal -> {csiz}")
    if csiz != n // 3:
        raise Jp2Error("Error with SIZ marker: number of component is not compatible with "
                       "the remaining number of parameters")
    if x0 >= x1 or y0 >= y1:
        raise Jp2Error("Error with SIZ marker: negative or zero image size")
    ih, iw = cs.get("ihdr", (0, 0))
    if iw > 0 and ih > 0 and (iw != x1 - x0 or ih != y1 - y0):
        raise Jp2Error(f"Error with SIZ marker: IHDR w({iw}) h({ih}) vs. SIZ w({x1 - x0}) "
                       f"h({y1 - y0})")
    if tdx == 0 or tdy == 0:
        raise Jp2Error("Error with SIZ marker: invalid tile size")
    if tx0 > x0 or ty0 > y0 or tx0 + tdx <= x0 or ty0 + tdy <= y0:
        raise Jp2Error("Error with SIZ marker: illegal tile offset")
    comps = []
    for i in range(csiz):
        ssiz, dx, dy = body[36 + 3 * i:39 + 3 * i]
        prec, sgnd = (ssiz & 0x7F) + 1, ssiz >> 7
        if not (1 <= dx <= 255 and 1 <= dy <= 255):
            raise Jp2Error(f"Invalid values for comp = {i} : dx={dx} dy={dy} (should be "
                           "between 1 and 255 according to the JPEG2000 norm)")
        if prec > 31:
            raise Jp2Error(f"Invalid values for comp = {i} : prec={prec} (should be between "
                           "1 and 38 according to the JPEG2000 norm. OpenJpeg only supports "
                           "up to 31)")
        comps.append({"prec": prec, "sgnd": sgnd, "dx": dx, "dy": dy})
    tw = -(-(x1 - tx0) // tdx)
    th = -(-(y1 - ty0) // tdy)
    if tw == 0 or th == 0 or tw > 65535 // th:
        raise Jp2Error(f"Invalid number of tiles : {tw} x {th} (maximum fixed by jpeg2000 "
                       "norm is 65535 tiles)")
    cs.update(x0=x0, y0=y0, x1=x1, y1=y1, tdx=tdx, tdy=tdy, tx0=tx0, ty0=ty0, tw=tw, th=th,
              comps=comps)
    cs["default"] = _Tcp(csiz)


def _read_spcod(tccp: _Tccp, body: bytes, at: int) -> int:
    """SPcod/SPcoc from `at` (opj_j2k_read_SPCod_SPCoc); returns the end."""
    if len(body) - at < 5:
        raise Jp2Error("Error reading SPCod SPCoc element")
    tccp.numres = body[at] + 1
    if tccp.numres > MAX_RLVLS:
        raise Jp2Error(f"Invalid value for numresolutions : {tccp.numres}, max value is set "
                       f"in openjpeg.h at {MAX_RLVLS}")
    tccp.cblkw, tccp.cblkh = body[at + 1] + 2, body[at + 2] + 2
    if tccp.cblkw > 10 or tccp.cblkh > 10 or tccp.cblkw + tccp.cblkh > 12:
        raise Jp2Error("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination")
    tccp.cblksty = body[at + 3]
    if tccp.cblksty & CBLK_HTMIXED:
        raise Jp2Error("Error reading SPCod SPCoc element. Unsupported Mixed HT code-block "
                       "style found")
    tccp.qmfbid = body[at + 4]
    if tccp.qmfbid > 1:
        raise Jp2Error("Error reading SPCod SPCoc element, Invalid transformation found")
    at += 5
    if tccp.csty & 1:
        if len(body) - at < tccp.numres:
            raise Jp2Error("Error reading SPCod SPCoc element")
        for i in range(tccp.numres):
            b = body[at + i]
            if i and (b & 0xF == 0 or b >> 4 == 0):
                raise Jp2Error("Invalid precinct size")
            tccp.prcw[i], tccp.prch[i] = b & 0xF, b >> 4
        at += tccp.numres
    else:
        tccp.prcw = [15] * MAX_RLVLS
        tccp.prch = [15] * MAX_RLVLS
    return at


def _read_sqcd(tccp: _Tccp, body: bytes, at: int) -> int:
    """SQcd/SQcc from `at` (opj_j2k_read_SQcd_SQcc); returns the end."""
    if len(body) - at < 1:
        raise Jp2Error("Error reading SQcd or SQcc element")
    tccp.qntsty, tccp.numgbits = body[at] & 0x1F, body[at] >> 5
    at += 1
    left = len(body) - at
    steps = list(tccp.stepsizes)
    if tccp.qntsty == 0:
        for b in range(left):
            if b < MAX_BANDS:
                steps[b] = (body[at + b] >> 3, 0)
        at += left
    else:
        nb = 1 if tccp.qntsty == 1 else left // 2
        if left < 2 * nb:
            raise Jp2Error("Error reading SQcd or SQcc element")
        for b in range(nb):
            v = _u(body, at + 2 * b, 2)
            if b < MAX_BANDS:
                steps[b] = (v >> 11, v & 0x7FF)
        at += 2 * nb
    if tccp.qntsty == 1:
        e0, m0 = steps[0]
        for b in range(1, MAX_BANDS):
            steps[b] = (max(e0 - (b - 1) // 3, 0), m0)
    tccp.stepsizes = steps
    return at


def _read_marker(cs: dict, marker: int, body: bytes, tcp: _Tcp) -> None:
    """One marker segment of a main or tile-part header (its handler)."""
    ncomp = len(cs["comps"]) if "comps" in cs else 0
    room = 1 if ncomp <= 256 else 2   # bytes of a component index
    if marker in _REFUSED:
        raise Jp2Error(f"{_REFUSED[marker]} is not decoded")
    if marker == SIZ:
        _read_siz(cs, body)
    elif marker == COD:
        if len(body) < 5:
            raise Jp2Error("Error reading COD marker")
        if body[0] & ~7:
            raise Jp2Error("Unknown Scod value in COD marker")
        tcp.csty = body[0]
        tcp.prg = body[1] if body[1] <= CPRL else -1
        tcp.numlayers = _u(body, 2, 2)
        if tcp.numlayers < 1:
            raise Jp2Error(f"Invalid number of layers in COD marker : {tcp.numlayers} not in "
                           "range [1-65535]")
        tcp.mct = body[4]
        if tcp.mct > 1:
            raise Jp2Error("Invalid multiple component transformation")
        t0 = tcp.tccps[0]
        t0.csty = tcp.csty & 1
        if _read_spcod(t0, body, 5) != len(body):
            raise Jp2Error("Error reading COD marker")
        for t in tcp.tccps[1:]:
            t.csty, t.numres, t.cblkw, t.cblkh = t0.csty, t0.numres, t0.cblkw, t0.cblkh
            t.cblksty, t.qmfbid = t0.cblksty, t0.qmfbid
            t.prcw, t.prch = list(t0.prcw), list(t0.prch)
    elif marker == COC:
        if len(body) < room + 1:
            raise Jp2Error("Error reading COC marker")
        c = _u(body, 0, room)
        if c >= ncomp:
            raise Jp2Error("Error reading COC marker (bad number of components)")
        tccp = tcp.tccps[c]
        tccp.csty = body[room]
        if _read_spcod(tccp, body, room + 1) != len(body):
            raise Jp2Error("Error reading COC marker")
    elif marker == QCD:
        t0 = tcp.tccps[0]
        if _read_sqcd(t0, body, 0) != len(body):
            raise Jp2Error("Error reading QCD marker")
        for t in tcp.tccps[1:]:
            t.qntsty, t.numgbits, t.stepsizes = t0.qntsty, t0.numgbits, list(t0.stepsizes)
    elif marker == QCC:
        if len(body) < room:
            raise Jp2Error("Error reading QCC marker")
        c = _u(body, 0, room)
        if c >= ncomp:
            raise Jp2Error(f"Invalid component number: {c}, regarding the number of "
                           f"components {ncomp}")
        if _read_sqcd(tcp.tccps[c], body, room) != len(body):
            raise Jp2Error("Error reading QCC marker")
    elif marker == POC:
        size = 5 + 2 * room
        n = len(body) // size
        if n <= 0 or len(body) % size:
            raise Jp2Error("Error reading POC marker")
        if len(tcp.pocs) + n >= 32:
            raise Jp2Error(f"Too many POCs {len(tcp.pocs) + n}")
        for i in range(n):
            at = i * size
            r0, c0 = body[at], _u(body, at + 1, room)
            l1, r1 = _u(body, at + 1 + room, 2), body[at + 3 + room]
            c1, prg = _u(body, at + 4 + room, room), body[at + 4 + 2 * room]
            tcp.pocs.append((prg, r0, c0, l1, r1, min(c1, ncomp)))
    elif marker == PPM:
        if len(body) < 2:
            raise Jp2Error("Error reading PPM marker")
        if body[0] in cs["ppm"]:
            raise Jp2Error(f"Zppm {body[0]} already read")
        cs["ppm"][body[0]] = body[1:]
    elif marker == PPT:
        if len(body) < 2:
            raise Jp2Error("Error reading PPT marker")
        if cs["ppm"]:
            raise Jp2Error("Error reading PPT marker: packet header have been previously "
                           "found in the main header (PPM marker).")
        if body[0] in tcp.ppt:
            raise Jp2Error(f"Zppt {body[0]} already read")
        tcp.ppt[body[0]] = body[1:]
    elif marker == RGN:
        if len(body) != 2 + room:
            raise Jp2Error("Error reading RGN marker")
        c = _u(body, 0, room)
        if c >= ncomp:
            raise Jp2Error(f"bad component number in RGN ({c} when there are only {ncomp})")
        tcp.tccps[c].roishift = body[room + 1]
    elif marker == TLM:
        if len(body) < 2:
            raise Jp2Error("Error reading TLM marker")
        st, sp = (body[1] >> 4) & 3, (body[1] >> 6) & 1
        if st != 3 and (len(body) - 2) % ((sp + 1) * 2 + st):   # ST 3: let go
            raise Jp2Error("Error reading TLM marker")
    elif marker == PLM:
        if len(body) < 1:
            raise Jp2Error("Error reading PLM marker")
    elif marker == PLT:
        if len(body) < 1:
            raise Jp2Error("Error reading PLT marker")
        packet_len = 0
        for b in body[1:]:
            packet_len |= b & 0x7F
            packet_len = packet_len << 7 if b & 0x80 else 0
        if packet_len:
            raise Jp2Error("Error reading PLT marker")
    elif marker == CRG:
        if len(body) != 4 * ncomp:
            raise Jp2Error("Error reading CRG marker")
    elif marker == MCT:   # read, and of no effect: a COD's MCT field above 1 is refused
        if len(body) < 2:
            raise Jp2Error("Error reading MCT marker")
        if _u(body, 0, 2) == 0 and len(body) <= 6:
            raise Jp2Error("Error reading MCT marker")


# -- tcd.c: the tile's structure ---------------------------------------------

def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceildivpow2(a: int, b: int) -> int:
    return -((-a) >> b)


class _TagTree:
    """tgt.c: a tag tree over w x h leaves."""

    def __init__(self, w: int, h: int):
        parents, sizes = [], [(w, h)]
        while w * h > 1:
            w, h = (w + 1) >> 1, (h + 1) >> 1
            sizes.append((w, h))
        base = [0]
        for lw, lh in sizes:
            base.append(base[-1] + lw * lh)
        for lv, (lw, lh) in enumerate(sizes):
            for j in range(lh):
                for i in range(lw):
                    if lv + 1 < len(sizes):
                        pw = sizes[lv + 1][0]
                        parents.append(base[lv + 1] + (j >> 1) * pw + (i >> 1))
                    else:
                        parents.append(-1)
        self.parent = parents
        self.value = [999] * len(parents)
        self.low = [0] * len(parents)

    def reset(self) -> None:
        n = len(self.parent)
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio: "_Bio", leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        parent, value, lows = self.parent, self.value, self.low
        while parent[node] >= 0:
            stack.append(node)
            node = parent[node]
        low = 0
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.read(1):
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if value[node] < threshold else 0


class _Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "numlenbits", "segs", "numsegs",
                 "numnewpasses", "chunks")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = self.numlenbits = self.numsegs = self.numnewpasses = 0
        self.segs = []     # [maxpasses, numpasses, len, newlen, numnewpasses]
        self.chunks = []


def _tile_structure(cs: dict, tcp: _Tcp, tileno: int) -> dict:
    """The tile's components, resolutions, bands, precincts and code-blocks
    (opj_tcd_init_tile), and the tile's bounds."""
    p, q = tileno % cs["tw"], tileno // cs["tw"]
    tx0 = max(cs["tx0"] + p * cs["tdx"], cs["x0"])
    ty0 = max(cs["ty0"] + q * cs["tdy"], cs["y0"])
    tx1 = min(cs["tx0"] + (p + 1) * cs["tdx"], cs["x1"])
    ty1 = min(cs["ty0"] + (q + 1) * cs["tdy"], cs["y1"])
    comps = []
    for c, comp in enumerate(cs["comps"]):
        tccp = tcp.tccps[c]
        cx0, cy0 = _ceildiv(tx0, comp["dx"]), _ceildiv(ty0, comp["dy"])
        cx1, cy1 = _ceildiv(tx1, comp["dx"]), _ceildiv(ty1, comp["dy"])
        numres = tccp.numres
        resolutions = []
        for r in range(numres):
            level = numres - 1 - r
            rx0, ry0 = _ceildivpow2(cx0, level), _ceildivpow2(cy0, level)
            rx1, ry1 = _ceildivpow2(cx1, level), _ceildivpow2(cy1, level)
            pdx, pdy = tccp.prcw[r], tccp.prch[r]
            px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            px1, py1 = _ceildivpow2(rx1, pdx) << pdx, _ceildivpow2(ry1, pdy) << pdy
            pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
            ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
            if pw and 0xFFFFFFFF // pw < ph:
                raise Jp2Error("Size of tile data exceeds system limits")
            if r == 0:
                cbgx, cbgy, cbgw, cbgh = px0, py0, pdx, pdy
                orients = (0,)
            else:
                cbgx, cbgy = _ceildivpow2(px0, 1), _ceildivpow2(py0, 1)
                cbgw, cbgh = pdx - 1, pdy - 1
                orients = (1, 2, 3)
            cbw, cbh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
            bands = []
            for orient in orients:
                if r == 0:
                    bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                else:
                    xb, yb = orient & 1, orient >> 1
                    bx0 = _ceildivpow2(cx0 - (xb << level), level + 1)
                    by0 = _ceildivpow2(cy0 - (yb << level), level + 1)
                    bx1 = _ceildivpow2(cx1 - (xb << level), level + 1)
                    by1 = _ceildivpow2(cy1 - (yb << level), level + 1)
                step_index = 0 if r == 0 else 3 * (r - 1) + orient
                expn, mant = tccp.stepsizes[step_index]
                gain = 0 if tccp.qmfbid == 0 else (0, 1, 1, 2)[orient]
                stepsize = np.float32((1.0 + mant / 2048.0) * 2.0 ** (comp["prec"] + gain - expn))
                band = {"orient": orient, "x0": bx0, "y0": by0, "x1": bx1, "y1": by1,
                        "numbps": expn + tccp.numgbits - 1, "stepsize": stepsize,
                        "expn": expn, "mant": mant,
                        "empty": bx0 == bx1 or by0 == by1, "precincts": []}
                for prec in range(pw * ph):
                    gx0 = cbgx + (prec % pw) * (1 << cbgw)
                    gy0 = cbgy + (prec // pw) * (1 << cbgh)
                    x0, y0 = max(gx0, bx0), max(gy0, by0)
                    x1, y1 = min(gx0 + (1 << cbgw), bx1), min(gy0 + (1 << cbgh), by1)
                    cx_start, cy_start = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                    cw = max((_ceildivpow2(x1, cbw) << cbw) - cx_start, 0) >> cbw
                    ch = max((_ceildivpow2(y1, cbh) << cbh) - cy_start, 0) >> cbh
                    cblks = []
                    for k in range(cw * ch):
                        kx0 = cx_start + (k % cw) * (1 << cbw)
                        ky0 = cy_start + (k // cw) * (1 << cbh)
                        cblks.append(_Cblk(max(kx0, x0), max(ky0, y0),
                                           min(kx0 + (1 << cbw), x1), min(ky0 + (1 << cbh), y1)))
                    band["precincts"].append({
                        "x0": x0, "y0": y0, "x1": x1, "y1": y1, "cw": cw, "ch": ch, "cblks": cblks,
                        "incl": _TagTree(cw, ch) if cw * ch else None,
                        "imsb": _TagTree(cw, ch) if cw * ch else None})
                bands.append(band)
            resolutions.append({"x0": rx0, "y0": ry0, "x1": rx1, "y1": ry1, "pw": pw, "ph": ph,
                                "pdx": pdx, "pdy": pdy, "bands": bands})
        comps.append({"x0": cx0, "y0": cy0, "x1": cx1, "y1": cy1, "numres": numres,
                      "res": resolutions, "dx": comp["dx"], "dy": comp["dy"]})
    return {"x0": tx0, "y0": ty0, "x1": tx1, "y1": ty1, "comps": comps}


# -- pi.c: the packet order ------------------------------------------------

def _packets(tile: dict, tcp: _Tcp):
    """(iterator, layno, resno, compno, precno) of every packet, in the
    tile's progression order, each once (opj_pi_next_*); the iterator is
    the POC record's index."""
    comps = tile["comps"]
    ncomp, nlayers = len(comps), tcp.numlayers
    maxres = max(c["numres"] for c in comps)
    tx0, ty0, tx1, ty1 = tile["x0"], tile["y0"], tile["x1"], tile["y1"]
    seen = set()
    prg = tcp.prg

    def once(key):
        if key in seen:
            return False
        seen.add(key)
        return True

    def steps(cs_):
        dx = dy = 0
        for comp in cs_:
            nr = comp["numres"]
            for r in range(nr):
                res = comp["res"][r]
                ex, ey = res["pdx"] + nr - 1 - r, res["pdy"] + nr - 1 - r
                if ex < 32:
                    v = comp["dx"] << ex
                    dx = v if not dx else min(dx, v)
                if ey < 32:
                    v = comp["dy"] << ey
                    dy = v if not dy else min(dy, v)
        return dx, dy

    def precinct_at(comp, r, x, y):
        """The precinct of resolution r of `comp` that position (x, y)
        starts, or None (the checks of opj_pi_next_rpcl)."""
        res = comp["res"][r]
        level = comp["numres"] - 1 - r
        dxl, dyl = comp["dx"] << level, comp["dy"] << level
        trx0, try0 = _ceildiv(tx0, dxl), _ceildiv(ty0, dyl)
        trx1, try1 = _ceildiv(tx1, dxl), _ceildiv(ty1, dyl)
        rpx, rpy = res["pdx"] + level, res["pdy"] + level
        if rpx >= 31 or rpy >= 31:
            return None
        if not (y % (comp["dy"] << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (comp["dx"] << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        if res["pw"] == 0 or res["ph"] == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceildiv(x, dxl) >> res["pdx"]) - (trx0 >> res["pdx"])
        prcj = (_ceildiv(y, dyl) >> res["pdy"]) - (try0 >> res["pdy"])
        return prci + prcj * res["pw"]

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    def progression(prg, r0, c0, l1, r1, c1):
        """One progression's packets within its bounds (one opj_pi_next_*
        iterator)."""
        if c0 >= ncomp or c1 >= ncomp + 1:   # invalid compno0/compno1
            return
        layers = range(min(l1, nlayers))
        if prg in (LRCP, RLCP):
            order = ([(l, r) for l in layers for r in range(r0, r1)] if prg == LRCP
                     else [(l, r) for r in range(r0, r1) for l in layers])
            for l, r in order:
                for c in range(c0, c1):
                    if r < comps[c]["numres"]:
                        res = comps[c]["res"][r]
                        for k in range(res["pw"] * res["ph"]):
                            if once((l, r, c, k)):
                                yield l, r, c, k
        elif prg in (RPCL, PCRL):
            dx, dy = steps(comps)
            if not dx or not dy:
                return
            if prg == RPCL:
                for r in range(r0, r1):
                    for x, y in positions(dx, dy):
                        for c in range(c0, c1):
                            if r >= comps[c]["numres"]:
                                continue
                            k = precinct_at(comps[c], r, x, y)
                            if k is None:
                                continue
                            for l in layers:
                                if once((l, r, c, k)):
                                    yield l, r, c, k
            else:
                for x, y in positions(dx, dy):
                    for c in range(c0, c1):
                        for r in range(r0, min(r1, comps[c]["numres"])):
                            k = precinct_at(comps[c], r, x, y)
                            if k is None:
                                continue
                            for l in layers:
                                if once((l, r, c, k)):
                                    yield l, r, c, k
        elif prg == CPRL:
            for c in range(c0, c1):
                dx, dy = steps([comps[c]])
                if not dx or not dy:
                    return
                for x, y in positions(dx, dy):
                    for r in range(r0, min(r1, comps[c]["numres"])):
                        k = precinct_at(comps[c], r, x, y)
                        if k is None:
                            continue
                        for l in layers:
                            if once((l, r, c, k)):
                                yield l, r, c, k

    # one iterator per POC record (opj_pi_update_decode_poc), else the
    # COD's progression over everything (opj_pi_update_decode_not_poc)
    for i, poc in enumerate(tcp.pocs or [(prg, 0, 0, nlayers, maxres, ncomp)]):
        for packet in progression(*poc):
            yield (i, *packet)


def _skipped(comp: dict, resno: int, precno: int, qmfbid: int) -> bool:
    """Whether OpenJPEG skips a packet rather than decoding it: no band of
    its resolution has that precinct in the area of interest, the whole
    tile with a margin of 2 (5/3) or 3 (9/7) samples
    (opj_tcd_is_subband_area_of_interest). A skipped packet's header is
    read all the same; its resolution does not count as decoded."""
    margin = 2 if qmfbid == 1 else 3
    numres = comp["numres"]
    nb = numres - 1 if resno == 0 else numres - resno
    for band in comp["res"][resno]["bands"]:
        xb, yb = band["orient"] & 1, band["orient"] >> 1
        box = []
        for t, b in ((comp["x0"], xb), (comp["y0"], yb), (comp["x1"], xb), (comp["y1"], yb)):
            if nb == 0:
                box.append(t)
            else:
                off = (1 << (nb - 1)) * b
                box.append(0 if t <= off else _ceildivpow2(t - off, nb))
        bx0, by0 = max(box[0] - margin, 0), max(box[1] - margin, 0)
        bx1, by1 = box[2] + margin, box[3] + margin
        prc = band["precincts"][precno]
        if prc["x0"] < bx1 and prc["y0"] < by1 and prc["x1"] > bx0 and prc["y1"] > by0:
            return False
    return True


# -- t2.c: packets ---------------------------------------------------------

class _Bio:
    """bio.c: the packet header's bit reader (a 0xFF byte is followed by 7
    bits); reads past the end give zeros."""
    __slots__ = ("data", "bp", "end", "buf", "ct", "start")

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.start, self.bp, self.end = data, start, start, end
        self.buf = self.ct = 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < self.end:
            self.buf |= self.data[self.bp]
            self.bp += 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v = (v << 1) | ((self.buf >> self.ct) & 1)
        return v

    def inalign(self) -> None:
        if self.buf & 0xFF == 0xFF:
            self._bytein()
        self.ct = 0


def _numpasses(bio: _Bio) -> int:
    if not bio.read(1):
        return 1
    if not bio.read(1):
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _init_seg(cblk: _Cblk, index: int, cblksty: int, first: bool) -> None:
    while len(cblk.segs) <= index:
        cblk.segs.append(None)
    if cblksty & CBLK_TERMALL:
        maxpasses = 1
    elif cblksty & CBLK_LAZY:
        if first:
            maxpasses = 10
        else:
            maxpasses = 2 if cblk.segs[index - 1][0] in (1, 10) else 1
    else:
        maxpasses = 109
    cblk.segs[index] = [maxpasses, 0, 0, 0, 0]


def _eph(src: bytes, pos: int, end: int, eph: int) -> int:
    """Past the EPH marker that ends a packet header, where the coding style
    has one; anything else refuses the file."""
    if eph:
        if end - pos < 2:
            raise Jp2Error("Not enough space for required EPH marker")
        if src[pos] != 0xFF or src[pos + 1] != 0x92:
            raise Jp2Error("Expected EPH marker")
        pos += 2
    return pos


def _decode_packets(tile: dict, tcp: _Tcp, src: bytes, decoded: list,
                    headers: list | None = None) -> None:
    """Every packet of the tile from its joined tile-part bytes
    (opj_t2_decode_packets), leaving each code-block's segments and
    chunks, and raising each component's resno_decoded in `decoded` to its
    decoded packets' resolutions; where an iterator's packets of a
    component are all skipped so far and resno_decoded is 0, it becomes
    the component's top resolution (OpenJPEG's first_pass_failed).
    `headers` ([bytes, position], advanced) holds the packet headers where
    PPM or PPT markers packed them."""
    pos, end = 0, len(src)
    sop, eph = tcp.csty & 2, tcp.csty & 4
    iterator, first_pass_failed = -1, []
    for pino, layno, resno, compno, precno in _packets(tile, tcp):
        comp = tile["comps"][compno]
        if pino != iterator:
            iterator, first_pass_failed = pino, [True] * len(tile["comps"])
        if _skipped(comp, resno, precno, tcp.tccps[compno].qmfbid):
            if decoded[compno] == 0 and first_pass_failed[compno]:
                decoded[compno] = comp["numres"] - 1
        else:
            first_pass_failed[compno] = False
            decoded[compno] = max(decoded[compno], resno)
        res = comp["res"][resno]
        cblksty = tcp.tccps[compno].cblksty
        bands = res["bands"]
        if layno == 0:
            for band in bands:
                if band["empty"]:
                    continue
                if precno >= len(band["precincts"]):
                    raise Jp2Error("Invalid precinct")
                prc = band["precincts"][precno]
                if prc["incl"] is not None:
                    prc["incl"].reset()
                    prc["imsb"].reset()
                for cblk in prc["cblks"]:
                    cblk.numsegs = 0
        if sop:
            if end - pos >= 6 and src[pos] == 0xFF and src[pos + 1] == 0x91:
                pos += 6
        if headers is None:
            hsrc, hpos, hend = src, pos, end
        else:
            hsrc, hpos, hend = headers[0], headers[1], len(headers[0])
        bio = _Bio(hsrc, hpos, hend)
        if not bio.read(1):
            bio.inalign()
            hpos = _eph(hsrc, bio.bp, hend, eph)
            if headers is None:
                pos = hpos
            else:
                headers[1] = hpos
            continue
        for band in bands:
            if band["empty"]:
                continue
            prc = band["precincts"][precno]
            for k, cblk in enumerate(prc["cblks"]):
                if not cblk.numsegs:
                    included = prc["incl"].decode(bio, k, layno + 1)
                else:
                    included = bio.read(1)
                if not included:
                    cblk.numnewpasses = 0
                    continue
                if not cblk.numsegs:
                    i = 0
                    while not prc["imsb"].decode(bio, k, i):
                        i += 1
                    cblk.numbps = (band["numbps"] + 1 - i) & 0xFFFFFFFF
                    cblk.numlenbits = 3
                cblk.numnewpasses = _numpasses(bio)
                increment = 0
                while bio.read(1):
                    increment += 1
                cblk.numlenbits += increment
                segno = 0
                if not cblk.numsegs:
                    _init_seg(cblk, 0, cblksty, True)
                else:
                    segno = cblk.numsegs - 1
                    if cblk.segs[segno][1] == cblk.segs[segno][0]:
                        segno += 1
                        _init_seg(cblk, segno, cblksty, False)
                n = cblk.numnewpasses
                while True:
                    seg = cblk.segs[segno]
                    seg[4] = min(seg[0] - seg[1], n)
                    bits = cblk.numlenbits + seg[4].bit_length() - 1
                    if bits > 32:
                        raise Jp2Error(f"Invalid bit number {bits} in opj_t2_read_packet_header()")
                    seg[3] = bio.read(bits)
                    n -= seg[4]
                    if n <= 0:
                        break
                    segno += 1
                    _init_seg(cblk, segno, cblksty, False)
        bio.inalign()
        hpos = _eph(hsrc, bio.bp, hend, eph)
        if headers is None:
            pos = hpos
        else:
            headers[1] = hpos
        # the packet's body (opj_t2_read_packet_data)
        for band in bands:
            if band["empty"]:
                continue
            prc = band["precincts"][precno]
            for cblk in prc["cblks"]:
                if not cblk.numnewpasses:
                    continue
                if not cblk.numsegs:
                    segno = 0
                    cblk.numsegs = 1
                else:
                    segno = cblk.numsegs - 1
                    if cblk.segs[segno][1] == cblk.segs[segno][0]:
                        segno += 1
                        cblk.numsegs += 1
                while True:
                    seg = cblk.segs[segno]
                    if pos + seg[3] > end:
                        raise Jp2Error(f"read: segment too long ({seg[3]}) with max "
                                       f"({end - pos}) for codeblock")
                    cblk.chunks.append(src[pos:pos + seg[3]])
                    pos += seg[3]
                    seg[2] += seg[3]
                    seg[1] += seg[4]
                    cblk.numnewpasses -= seg[4]
                    if cblk.numnewpasses <= 0:
                        break
                    segno += 1
                    cblk.numsegs += 1


# -- mqc.c and t1.c: code-blocks -------------------------------------------

# the MQ coder's 47 states: Qe, next state after an MPS, after an LPS, and
# whether an LPS switches the MPS
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
       0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
       0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
       0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23,
         24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
         45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
         41, 42, 43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32
# the same as 94 states s = 2 * state + mps (OpenJPEG's mqc_states)
QE2 = tuple(_QE[s >> 1] for s in range(94))
NMPS2 = tuple(2 * _NMPS[s >> 1] + (s & 1) for s in range(94))
NLPS2 = tuple(2 * _NLPS[s >> 1] + ((s & 1) ^ _SWITCH[s >> 1]) for s in range(94))
CTX_ZC, CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI = 0, 9, 14, 17, 18

# neighbour bits of a coefficient's word: NW N NE W E SW S SE, then the
# signs (1 = negative) of N, W, E, S
NW, N_, NE, W_, E_, SW, S_, SE = (1 << i for i in range(8))
SGN_N, SGN_W, SGN_E, SGN_S = 1 << 8, 1 << 9, 1 << 10, 1 << 11


def _zc_lut(orient: int) -> list:
    lut = []
    for f in range(256):
        h = bool(f & W_) + bool(f & E_)
        v = bool(f & N_) + bool(f & S_)
        d = bool(f & NW) + bool(f & NE) + bool(f & SW) + bool(f & SE)
        if orient == 1:   # HL: OpenJPEG's lut of its orientation 2
            h, v = v, h
        if orient == 3:
            hv = h + v
            if not d:
                n = 0 if not hv else 1 if hv == 1 else 2
            elif d == 1:
                n = 3 if not hv else 4 if hv == 1 else 5
            elif d == 2:
                n = 6 if not hv else 7
            else:
                n = 8
        elif not h:
            n = (0 if not d else 1 if d == 1 else 2) if not v else 3 if v == 1 else 4
        elif h == 1:
            n = (5 if not d else 6) if not v else 7
        else:
            n = 8
        lut.append(CTX_ZC + n)
    return lut


def _sc_lut() -> list:
    """(context, sign-prediction bit) by the word's bits 0-11."""
    lut = []
    for f in range(4096):
        def contrib(sig, neg):
            return 0 if not f & sig else (-1 if f & neg else 1)
        h = max(-1, min(1, contrib(W_, SGN_W) + contrib(E_, SGN_E)))
        v = max(-1, min(1, contrib(N_, SGN_N) + contrib(S_, SGN_S)))
        if h < 0:
            h, v, xor = -h, -v, 1
        elif h == 0 and v < 0:
            v, xor = -v, 1
        else:
            xor = 0
        ctx = {(0, 0): 0, (0, 1): 1, (1, -1): 2, (1, 0): 3, (1, 1): 4}[(h, v)]
        lut.append((CTX_SC + ctx, xor))
    return lut


ZC_LUTS = [_zc_lut(o) for o in range(4)]
SC_LUT = _sc_lut()


class _Mqc:
    """mqc.c: the MQ decoder over one segment, followed by an artificial
    0xFF 0xFF, with the contexts' states `st` (2 * state + mps)."""
    __slots__ = ("buf", "bp", "a", "c", "ct", "st")

    def __init__(self, st: list):
        self.st = st

    def init(self, seg: bytes) -> None:
        self.buf = seg + b"\xff\xff"
        self.bp = 0
        self.c = self.buf[0] << 16
        self.ct = 0
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def raw_init(self, seg: bytes) -> None:
        self.buf = seg + b"\xff\xff"
        self.bp = self.c = self.ct = 0

    def _bytein(self) -> None:
        buf, bp = self.buf, self.bp
        nxt = buf[bp + 1]
        if buf[bp] == 0xFF:
            if nxt > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += nxt << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += nxt << 8
            self.ct = 8
        self.c &= 0xFFFFFFFF

    def decode(self, cx: int) -> int:
        st = self.st
        s = st[cx]
        qe = QE2[s]
        a = self.a - qe
        if (self.c >> 16) < qe:
            if a < qe:
                d = s & 1
                st[cx] = NMPS2[s]
            else:
                d = (s & 1) ^ 1
                st[cx] = NLPS2[s]
            a = qe
        else:
            self.c -= qe << 16
            if a & 0x8000:
                self.a = a
                return s & 1
            if a < qe:
                d = (s & 1) ^ 1
                st[cx] = NLPS2[s]
            else:
                d = s & 1
                st[cx] = NMPS2[s]
        c, ct = self.c, self.ct
        while True:
            if ct == 0:
                self.c, self.ct = c, ct
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return d

    def raw(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self.buf[self.bp] > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c = self.buf[self.bp]
                    self.bp += 1
                    self.ct = 7
            else:
                self.c = self.buf[self.bp]
                self.bp += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


def _reset_states(st: list) -> None:
    st[:] = [0] * 19
    st[CTX_UNI] = 2 * 46
    st[CTX_AGG] = 2 * 3
    st[CTX_ZC] = 2 * 4


def t1_decode(cblk: _Cblk, orient: int, cblksty: int, roishift: int) -> np.ndarray:
    """(h, w) int64 coefficients of one code-block, with OpenJPEG's extra
    low bit (opj_t1_decode_cblk): each significant value is 2 x its
    magnitude plus the half bit below its last decoded plane, signed."""
    w, h = cblk.x1 - cblk.x0, cblk.y1 - cblk.y0
    bpno_plus_one = roishift + cblk.numbps
    bpno_plus_one = ((bpno_plus_one + 0x80000000) & 0xFFFFFFFF) - 0x80000000
    if bpno_plus_one >= 31:
        raise Jp2Error(f"opj_t1_decode_cblk(): unsupported bpno_plus_one = {bpno_plus_one} >= 31")
    W = w + 2
    size = W * (h + 2)
    data = [0] * size
    nb = [0] * size       # neighbour words
    flag = [0] * size     # 1 significant, 2 coded in this plane (pi), 4 refined (mu)
    st = [0] * 19
    _reset_states(st)
    mqc = _Mqc(st)
    zc = ZC_LUTS[orient]
    sc = SC_LUT
    vsc = bool(cblksty & CBLK_VSC)
    numbps = ((cblk.numbps + 0x80000000) & 0xFFFFFFFF) - 0x80000000
    dec = mqc.decode
    cblkdata = b"".join(cblk.chunks)
    index = 0
    passtype = 2

    def significant(p: int, y: int, neg: int) -> None:
        flag[p] |= 1
        # west and east
        nb[p - 1] |= E_ | (SGN_E if neg else 0)
        nb[p + 1] |= W_ | (SGN_W if neg else 0)
        if not (vsc and (y & 3) == 0):
            q = p - W
            nb[q] |= S_ | (SGN_S if neg else 0)
            nb[q - 1] |= SE
            nb[q + 1] |= SW
        q = p + W
        nb[q] |= N_ | (SGN_N if neg else 0)
        nb[q - 1] |= NE
        nb[q + 1] |= NW

    for segno in range(cblk.numsegs):
        seg = cblk.segs[segno]
        raw = (bpno_plus_one <= numbps - 4 and passtype < 2 and cblksty & CBLK_LAZY)
        segdata = cblkdata[index:index + seg[2]]
        index += seg[2]
        if raw:
            mqc.raw_init(segdata)
        else:
            mqc.init(segdata)
        for _ in range(seg[1]):
            if bpno_plus_one < 1:
                break
            one = 1 << bpno_plus_one
            half = one >> 1
            oneplushalf = one | half
            if passtype == 0:   # significance propagation
                for y0 in range(0, h, 4):
                    for x in range(w):
                        p = (y0 + 1) * W + x + 1
                        for y in range(y0, min(y0 + 4, h)):
                            if not flag[p] and nb[p] & 0xFF:
                                if raw:
                                    v = mqc.raw()
                                else:
                                    v = dec(zc[nb[p] & 0xFF])
                                if v:
                                    if raw:
                                        neg = mqc.raw()
                                    else:
                                        ctx, xor = sc[nb[p] & 0xFFF]
                                        neg = dec(ctx) ^ xor
                                    data[p] = -oneplushalf if neg else oneplushalf
                                    significant(p, y, neg)
                                flag[p] |= 2
                            p += W
            elif passtype == 1:   # magnitude refinement
                for y0 in range(0, h, 4):
                    for x in range(w):
                        p = (y0 + 1) * W + x + 1
                        for y in range(y0, min(y0 + 4, h)):
                            f = flag[p]
                            if f & 3 == 1:
                                if raw:
                                    v = mqc.raw()
                                else:
                                    v = dec(CTX_MAG + 2 if f & 4 else
                                            CTX_MAG + 1 if nb[p] & 0xFF else CTX_MAG)
                                val = data[p]
                                data[p] = val + (half if v ^ (val < 0) else -half)
                                flag[p] = f | 4
                            p += W
            else:   # cleanup
                for y0 in range(0, h, 4):
                    full = y0 + 4 <= h
                    for x in range(w):
                        p = (y0 + 1) * W + x + 1
                        y = y0
                        if full and not (flag[p] or nb[p] or flag[p + W] or nb[p + W]
                                         or flag[p + 2 * W] or nb[p + 2 * W]
                                         or flag[p + 3 * W] or nb[p + 3 * W]):
                            if not dec(CTX_AGG):
                                continue
                            run = dec(CTX_UNI) << 1
                            run |= dec(CTX_UNI)
                            p += run * W
                            y += run
                            ctx, xor = sc[nb[p] & 0xFFF]
                            neg = dec(ctx) ^ xor
                            data[p] = -oneplushalf if neg else oneplushalf
                            significant(p, y, neg)
                            p += W
                            y += 1
                        for y in range(y, min(y0 + 4, h)):
                            if not flag[p] & 3:
                                if dec(zc[nb[p] & 0xFF]):
                                    ctx, xor = sc[nb[p] & 0xFFF]
                                    neg = dec(ctx) ^ xor
                                    data[p] = -oneplushalf if neg else oneplushalf
                                    significant(p, y, neg)
                            p += W
                        p = (y0 + 1) * W + x + 1
                        for y in range(y0, min(y0 + 4, h)):
                            flag[p] &= ~2
                            p += W
                if cblksty & CBLK_SEGSYM:
                    for _k in range(4):
                        dec(CTX_UNI)
            if cblksty & CBLK_RESET and not raw:
                _reset_states(st)
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno_plus_one -= 1
    out = np.array(data, np.int64).reshape(h + 2, W)[1:h + 1, 1:w + 1]
    if roishift:
        if roishift >= 31:
            return np.zeros_like(out)
        mag = np.abs(out)
        shifted = np.where(mag >= (1 << roishift), mag >> roishift, mag)
        out = np.where(out < 0, -shifted, shifted)
    return out


# -- dwt.c: the inverse transforms -----------------------------------------

_K = np.float32(1.230174105)
_TWO_INVK = np.float32(1.625732422)
# libavcodec's jpeg2000dwt.h: the same K, and its inverse (not 2 / K)
_LIBAV_K, _LIBAV_X = np.float32(1.230174104914001), np.float32(0.812893066115961)
_ALPHA, _BETA = np.float32(-1.586134342), np.float32(-0.052980118)
_GAMMA, _DELTA = np.float32(0.882911075), np.float32(0.443506852)


def _idwt53_1d(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 5/3 along axis 1 of int32 rows: a[:, :sn] low-pass, the
    rest high-pass, the first sample on an even (cas 0) or odd (cas 1)
    coordinate; returns the interleaved rows. int32 arithmetic wraps, as
    OpenJPEG's does."""
    n = a.shape[1]
    dn = n - sn
    if n == 1:
        return np.where(a < 0, -((-a) >> 1), a >> 1).astype(np.int32) if cas else a
    low, high = a[:, :sn], a[:, sn:]
    out = np.empty_like(a)
    if cas == 0:
        # even positions 2i (low i): neighbours high i-1 and i, mirrored
        hl = np.concatenate([high[:, :1], high], axis=1)
        hr = np.concatenate([high, high[:, -1:]], axis=1)
        even = low - ((hl[:, :sn] + hr[:, :sn] + 2) >> 2)
        ev_r = np.concatenate([even, even[:, -1:]], axis=1) if sn == dn else even
        odd = high + ((even[:, :dn] + ev_r[:, 1:dn + 1]) >> 1)
        out[:, 0::2] = even
        out[:, 1::2] = odd
    else:
        # odd positions 2i+1 (low i): neighbours high i and i+1
        hr = np.concatenate([high, high[:, -1:]], axis=1)
        even = low - ((high[:, :sn] + hr[:, 1:sn + 1] + 2) >> 2)
        # even positions 2i (high i): neighbours low i-1 and i, mirrored
        el = np.concatenate([even[:, :1], even], axis=1)
        er = np.concatenate([even, even[:, -1:]], axis=1)
        odd = high + ((el[:, :dn] + er[:, :dn]) >> 1)
        out[:, 1::2] = even
        out[:, 0::2] = odd
    return out


def libav_stepsize(prec: int, expn: int, mant: int, orient: int, r: int,
                   numres: int) -> np.float32:
    """A 9/7 band's dequantisation step as libavcodec's jpeg2000.c
    (init_band_stepsize) computes it for its float decoder: 2^(prec - expn)
    times (1 + mant / 2048) in double, rounded to float; HL and LH times
    float(X * 2), HH times float(X * X * 4); times K^(2 (numres - r) +
    [HL, LH] - 2) in double (the 9/7's gains folded in, which its lifting
    then leaves out), rounded; halved."""
    f = np.float32(2.0 ** (prec - expn))
    f = np.float32(float(f) * (mant / 2048.0 + 1.0))
    lband = orient in (1, 2)
    if lband:
        f = np.float32(f * np.float32(_LIBAV_X * np.float32(2)))
    elif orient == 3:
        f = np.float32(f * np.float32(np.float32(_LIBAV_X * _LIBAV_X) * np.float32(4)))
    f = np.float32(float(f) * math.pow(float(_LIBAV_K), 2 * (numres - r) + lband - 2))
    return np.float32(f * np.float32(0.5))


def _idwt97_1d(a: np.ndarray, sn: int, cas: int, libav: bool = False) -> np.ndarray:
    """The inverse 9/7 along axis 1 of float32 rows (opj_v8dwt_decode), or
    with `libav` libavcodec's (jpeg2000dwt.c's sr_1d97_float: the same
    lifting steps without the band scaling, which libav_stepsize folds into
    the dequantisation; a lone sample times X, or K / 2 at an odd start)."""
    n = a.shape[1]
    dn = n - sn
    x = np.empty_like(a)
    if cas == 0:
        x[:, 0::2], x[:, 1::2] = a[:, :sn], a[:, sn:]
        la, lb = 0, 1
    else:
        x[:, 1::2], x[:, 0::2] = a[:, :sn], a[:, sn:]
        la, lb = 1, 0
    if n <= 1:
        if libav and n:
            x[:, 0] = x[:, 0] * (_LIBAV_X if cas == 0 else np.float32(_LIBAV_K / np.float32(2)))
        return x
    if not libav:
        x[:, la::2] = x[:, la::2] * _K
        x[:, lb::2] = x[:, lb::2] * _TWO_INVK

    def step2(tgt: int, count: int, m: int, c: np.float32) -> None:
        # target samples tgt + 2i, i < count; neighbours tgt + 2i -+ 1, the
        # left one mirrored at i = 0 when tgt is 0; the last, past m, twice
        # its left neighbour
        for_full = min(count, m)
        if for_full > 0:
            idx = tgt + 2 * np.arange(for_full)
            left = np.where(idx - 1 < 0, idx + 1, idx - 1)
            x[:, idx] = x[:, idx] + ((x[:, left] + x[:, idx + 1]) * c)
        if m < count:
            i = tgt + 2 * m
            x[:, i] = x[:, i] + x[:, i - 1] * (c + c)

    step2(la, sn, min(sn, dn - la), -_DELTA)
    step2(lb, dn, min(dn, sn - lb), -_GAMMA)
    step2(la, sn, min(sn, dn - la), -_BETA)
    step2(lb, dn, min(dn, sn - lb), -_ALPHA)
    return x


def _idwt(tc: np.ndarray, comp: dict, reversible: bool, top: int,
          libav: bool = False) -> np.ndarray:
    """The inverse DWT of a tile-component up to resolution `top`, level by
    level: rows, then columns (opj_dwt_decode_tile, opj_dwt_decode_tile_97;
    `libav`: libavcodec's 9/7)."""
    res = comp["res"]
    one = _idwt53_1d if reversible else functools.partial(_idwt97_1d, libav=libav)
    rw, rh = res[0]["x1"] - res[0]["x0"], res[0]["y1"] - res[0]["y0"]
    for r in range(1, top + 1):
        sn_h, sn_v = rw, rh
        rw, rh = res[r]["x1"] - res[r]["x0"], res[r]["y1"] - res[r]["y0"]
        if rw and rh:
            tc[:rh, :rw] = one(tc[:rh, :rw], sn_h, res[r]["x0"] & 1)
            tc[:rh, :rw] = one(tc[:rh, :rw].T, sn_v, res[r]["y0"] & 1).T
    return tc


# -- tcd.c: one tile -------------------------------------------------------

def _decode_tile(cs: dict, tcp: _Tcp, tileno: int, image: list, video: bool = False) -> None:
    """T2, T1, the inverse DWT, the MCT and the DC level shift of one tile,
    written into `image` (one int32 plane a component). A component of the
    tile decodes up to the highest resolution of its decoded packets
    (resno_decoded, see _decode_packets): a POC can leave resolutions out,
    and the tile's samples are then that resolution's, placed at its own
    (reduced) coordinates, the rest of the image zeros. `video`
    dequantises and inverts the 9/7 as libavcodec does (libav_stepsize,
    _idwt97_1d), the arithmetic cv2.VideoCapture's frames come from."""
    if tcp.prg < 0 and not tcp.pocs:
        raise Jp2Error("Unknown progression order in COD marker")
    tile = _tile_structure(cs, tcp, tileno)
    for tccp in tcp.tccps:
        if tccp.cblksty & CBLK_HT:
            raise Jp2Error("High Throughput JPEG 2000 (Part 15) code-blocks are not decoded")
    decoded = [0] * len(tile["comps"])
    headers = cs["ppm_data"]   # PPM's headers run on from tile to tile
    if headers is None and tcp.ppt:
        headers = [b"".join(tcp.ppt[z] for z in sorted(tcp.ppt)), 0]
    _decode_packets(tile, tcp, tcp.data, decoded, headers)
    tops = [min(decoded[c], comp["numres"] - 1) for c, comp in enumerate(tile["comps"])]
    planes = []
    for c, comp in enumerate(tile["comps"]):
        tccp = tcp.tccps[c]
        reversible = tccp.qmfbid == 1
        top = comp["res"][-1]
        tw, th = top["x1"] - top["x0"], top["y1"] - top["y0"]
        tc = np.zeros((th, tw), np.int32 if reversible else np.float32)
        for r, res in enumerate(comp["res"]):
            for band in res["bands"]:
                if band["empty"]:
                    continue
                ox, oy = band["x0"], band["y0"]
                if band["orient"] & 1:
                    prev = comp["res"][r - 1]
                    ox -= prev["x1"] - prev["x0"]
                if band["orient"] & 2:
                    prev = comp["res"][r - 1]
                    oy -= prev["y1"] - prev["y0"]
                step = (libav_stepsize(cs["comps"][c]["prec"], band["expn"], band["mant"],
                                       band["orient"], r, comp["numres"])
                        if video and not reversible
                        else np.float32(np.float32(0.5) * band["stepsize"]))
                for prc in band["precincts"]:
                    for cblk in prc["cblks"]:
                        vals = t1_decode(cblk, band["orient"], tccp.cblksty, tccp.roishift)
                        ys, xs = cblk.y0 - oy, cblk.x0 - ox
                        if reversible:
                            tc[ys:ys + vals.shape[0], xs:xs + vals.shape[1]] = np.where(
                                vals < 0, -((-vals) >> 1), vals >> 1)
                        else:
                            tc[ys:ys + vals.shape[0], xs:xs + vals.shape[1]] = (
                                vals.astype(np.int32).astype(np.float32) * step)
        planes.append(_idwt(tc, comp, reversible, tops[c], video))
    if tcp.mct:
        if len(planes) >= 3:
            nres = [tile["comps"][i]["numres"] for i in range(3)]
            if nres[0] != nres[1] or nres[0] != nres[2] or not (
                    decoded[0] == decoded[1] == decoded[2]) or not (
                    planes[0].shape == planes[1].shape == planes[2].shape):
                raise Jp2Error("Tiles don't all have the same dimension. Skip the MCT step.")
            if tcp.tccps[0].qmfbid == 1:
                if any(p.dtype != np.int32 for p in planes[:3]):
                    raise Jp2Error("an MCT over components of both transforms is not decoded")
                y, u, v = planes[:3]
                g = y - ((u + v) >> 2)
                planes[0], planes[1], planes[2] = v + g, g, u + g
            else:
                if any(p.dtype != np.float32 for p in planes[:3]):
                    raise Jp2Error("an MCT over components of both transforms is not decoded")
                y, u, v = planes[:3]
                planes[0] = y + v * np.float32(1.402)
                planes[1] = (y - u * np.float32(0.34413)) - v * np.float32(0.71414)
                planes[2] = y + u * np.float32(1.772)
    for c, comp in enumerate(tile["comps"]):
        info = cs["comps"][c]
        prec, sgnd = info["prec"], info["sgnd"]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
        shift = 0 if sgnd else 1 << (prec - 1)
        top = comp["res"][tops[c]]
        p = planes[c][:top["y1"] - top["y0"], :top["x1"] - top["x0"]]
        if p.dtype == np.int32:
            out = np.clip(p + np.int32(shift), lo, hi).astype(np.int64)
        else:
            big = p > np.float32(2147483647)
            small = p < np.float32(-2147483648)
            r = np.rint(np.where(big | small, 0, p)).astype(np.int64)
            out = np.clip(r + shift, lo, hi)
            out[big], out[small] = hi, lo
        ys = top["y0"] - _ceildiv(cs["y0"], info["dy"])
        xs = top["x0"] - _ceildiv(cs["x0"], info["dx"])
        h, w = image[c][ys:ys + out.shape[0], xs:xs + out.shape[1]].shape
        image[c][ys:ys + h, xs:xs + w] = out[:h, :w]


def _merge_ppm(markers: dict) -> list:
    """The PPM markers' packet headers, joined in Zppm order without their
    Nppm fields (opj_j2k_merge_ppm), as [bytes, read position]."""
    out, remaining = [], 0
    for z in sorted(markers):
        data = markers[z]
        if remaining >= len(data):
            remaining -= len(data)
            out.append(data)
            continue
        out.append(data[:remaining])
        at, remaining = remaining, 0
        while at < len(data):
            if len(data) - at < 4:
                raise Jp2Error("Not enough bytes to read Nppm")
            n = _u(data, at, 4)
            at += 4
            out.append(data[at:at + n])
            if len(data) - at >= n:
                at += n
            else:
                remaining = n - (len(data) - at)
                at = len(data)
    if remaining:
        raise Jp2Error("Corrupted PPM markers")
    return [b"".join(out), 0]


def _next_sot_same_tile(data: bytes, pos: int, end: int, tileno: int) -> bool:
    """opj_j2k_need_nb_tile_parts_correction: whether the next SOT of
    `tileno`, reached through the tile-parts of other tiles by their Psot,
    has TPsot == TNsot (its TNsot then counts one short)."""
    while True:
        if pos + 2 > end or _u(data, pos, 2) != SOT:
            return False
        if pos + 4 > end:
            raise Jp2Error("Stream too short")
        if _u(data, pos + 2, 2) != 10:
            raise Jp2Error("Inconsistent marker size")
        if pos + 12 > end:
            raise Jp2Error("Stream too short")
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", data, pos + 4)
        if isot == tileno:
            return tpsot == tnsot
        if psot < 14:
            return False
        pos += psot
        if pos > end:
            return False


def read_codestream(data: bytes, start: int, on_tile, ihdr=(0, 0),
                    video: bool = False) -> dict:
    """The codestream from `start` (opj_j2k_read_header_procedure, then
    opj_j2k_decode_tiles with opj_j2k_read_tile_header): each tile, once
    complete, goes to `on_tile(cs, tcp, tileno)`. Returns the header.
    `video` skips OpenCV's refusal (the video mode checks its own)."""
    end = len(data)
    cs: dict = {"ihdr": ihdr, "ppm": {}}
    if start + 2 > end or _u(data, start, 2) != SOC:
        raise Jp2Error("Expected a SOC marker")
    pos = start + 2
    if pos + 2 > end:
        raise Jp2Error("Stream too short")
    marker = _u(data, pos, 2)
    pos += 2
    state = _MHSIZ
    seen = set()
    while marker != SOT:
        if marker < 0xFF00:
            raise Jp2Error(f"A marker ID was expected (0xff--) instead of {marker:#x}")
        if not _known(marker):
            while True:   # opj_j2k_read_unk
                if pos + 2 > end:
                    raise Jp2Error("Stream too short")
                marker = _u(data, pos, 2)
                pos += 2
                if marker >= 0xFF00:
                    if not state & _states(marker):
                        raise Jp2Error("Marker is not compliant with its position")
                    if _known(marker):
                        break
            if marker == SOT:
                break
        seen.add(marker)
        if not state & _states(marker):
            raise Jp2Error("Marker is not compliant with its position")
        if pos + 2 > end:
            raise Jp2Error("Stream too short")
        size = _u(data, pos, 2)
        if size < 2:
            raise Jp2Error("Invalid marker size")
        if pos + size > end:
            raise Jp2Error("Stream too short")
        body = data[pos + 2:pos + size]
        pos += size
        _read_marker(cs, marker, body, cs.get("default"))
        if marker == SIZ:
            state = _MH
            why = (size_refusal(cs["x1"] - cs["x0"], cs["y1"] - cs["y0"])
                   or (None if video else opencv_refusal(cs["comps"], cs["x0"], cs["y0"])))
            if why:
                raise Jp2Error(why)
        if pos + 2 > end:
            raise Jp2Error("Stream too short")
        marker = _u(data, pos, 2)
        pos += 2
    if SIZ not in seen:
        raise Jp2Error("required SIZ marker not found in main header")
    if COD not in seen:
        raise Jp2Error("required COD marker not found in main header")
    if QCD not in seen:
        raise Jp2Error("required QCD marker not found in main header")
    cs["ppm_data"] = _merge_ppm(cs["ppm"]) if cs["ppm"] else None
    ntiles = cs["tw"] * cs["th"]
    tcps = [cs["default"].copy() for _ in range(ntiles)]
    single = (cs["tw"] == 1 and cs["th"] == 1 and cs["tx0"] == 0 and cs["ty0"] == 0
              and cs["x0"] == 0 and cs["y0"] == 0 and cs["x1"] == cs["tdx"]
              and cs["y1"] == cs["tdy"])
    # opj_j2k_read_tile_header / opj_j2k_decode_tile, in a loop
    st = {"state": _TPHSOT, "current": 0, "can_decode": False, "last_part": False,
          "sot_length": 0, "tpsot": 0, "checked": False, "correction": 0}
    decoded = 0

    def tile_header(pos: int) -> tuple[int, int | None]:
        """Returns (pos, tile to decode or None when there is none)."""
        marker = SOT
        if st["state"] == 256:   # EOC reached
            marker = EOC
        elif st["state"] != _TPHSOT:
            raise Jp2Error("the codestream goes on where no tile-part may start")
        while not st["can_decode"] and marker != EOC:
            while marker != SOD:
                if pos >= end:
                    st["state"] = 64   # NEOC
                    break
                if pos + 2 > end:
                    raise Jp2Error("Stream too short")
                size = _u(data, pos, 2)
                pos += 2
                if size < 2:
                    raise Jp2Error("Inconsistent marker size")
                if marker == 0x8080 and pos >= end:
                    st["state"] = 64
                    break
                if st["state"] & _TPH and st["sot_length"]:
                    if st["sot_length"] < size + 2:
                        raise Jp2Error("Sot length is less than marker size + marker ID")
                    st["sot_length"] -= size + 2
                size -= 2
                if not st["state"] & _states(marker):
                    raise Jp2Error("Marker is not compliant with its position")
                if pos + size > end:
                    raise Jp2Error("Stream too short")
                body = data[pos:pos + size]
                pos += size
                if not _known(marker):
                    raise Jp2Error("Not sure how that happened.")
                if marker == SOT:
                    _read_sot(body)
                else:
                    _read_marker(cs, marker, body, tcps[st["current"]])
                if pos + 2 > end:
                    raise Jp2Error("Stream too short")
                marker = _u(data, pos, 2)
                pos += 2
            if pos >= end and st["state"] == 64:
                break
            pos = _read_sod(pos)
            # OpenJPEG's repair of a TNsot one short, looked for once, when
            # a tile's tile-parts after its first complete it
            if st["can_decode"] and not st["checked"] and st["tpsot"] > 0:
                st["checked"] = True
                if _next_sot_same_tile(data, pos, end, st["current"]):
                    st["can_decode"] = False
                    st["correction"] = 1
                    for t in tcps:
                        if t.nb_parts:
                            t.nb_parts += 1
            if not st["can_decode"]:
                if pos + 2 > end:
                    raise Jp2Error("Stream too short")
                marker = _u(data, pos, 2)
                pos += 2
        if marker == EOC and st["state"] != 256:
            st["current"] = 0
            st["state"] = 256
        if not st["can_decode"]:
            while st["current"] < ntiles and tcps[st["current"]].data is None:
                st["current"] += 1
            if st["current"] == ntiles:
                return pos, None
        return pos, st["current"]

    def _read_sot(body: bytes) -> None:
        if len(body) != 8:
            raise Jp2Error("Error reading SOT marker")
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", body)
        if isot >= ntiles:
            raise Jp2Error(f"Invalid tile number {isot}")
        st["current"] = isot
        tcp = tcps[isot]
        if tcp.part_number + 1 != tpsot:
            raise Jp2Error(f"Invalid tile part index for tile number {isot}. Got {tpsot}, "
                           f"expected {tcp.part_number + 1}")
        tcp.part_number += 1
        if psot and psot < 14 and psot != 12:
            raise Jp2Error(f"Psot value is not correct regards to the JPEG2000 norm: {psot}.")
        if not psot:
            st["last_part"] = True
        if tcp.nb_parts and tpsot >= tcp.nb_parts:
            st["last_part"] = True
            raise Jp2Error(f"In SOT marker, TPSot ({tpsot}) is not valid regards to the "
                           f"previous number of tile-part ({tcp.nb_parts}), giving up")
        st["tpsot"] = tpsot
        if tnsot:
            tnsot += st["correction"]
            if tpsot >= tnsot:
                st["last_part"] = True
                raise Jp2Error(f"In SOT marker, TPSot ({tpsot}) is not valid regards to the "
                               f"current number of tile-part (header) ({tnsot}), giving up")
            tcp.nb_parts = tnsot
        if tcp.nb_parts and tcp.nb_parts == tpsot + 1:
            st["can_decode"] = True
        st["sot_length"] = 0 if st["last_part"] else psot - 12
        st["state"] = _TPH

    def _read_sod(pos: int) -> int:
        tcp = tcps[st["current"]]
        if st["last_part"]:
            if end - pos < 2:
                raise Jp2Error("Tile part length size inconsistent with stream length")
            st["sot_length"] = end - pos - 2
        elif st["sot_length"] >= 2:
            st["sot_length"] -= 2
        n = st["sot_length"]
        if n:
            if n > end - pos:
                raise Jp2Error("Tile part length size inconsistent with stream length")
            tcp.data = (tcp.data or b"") + data[pos:pos + n]
            pos += n
        st["state"] = _TPHSOT
        return pos

    while True:
        pos, tileno = tile_header(pos)
        if tileno is None:
            if single:
                raise Jp2Error("Failed to decode tile 1/1")
            break
        tcp = tcps[tileno]
        if tcp.data is None:
            raise Jp2Error(f"Failed to decode tile {tileno + 1}/{ntiles}")
        on_tile(cs, tcp, tileno)
        tcp.data = None
        st["can_decode"] = False
        if pos >= end and st["state"] == 64:   # the bytes ended without an EOC
            break
        if st["state"] != 256:   # the marker after the tile
            if pos + 2 > end:
                raise Jp2Error("Stream too short")
            marker = _u(data, pos, 2)
            pos += 2
            if marker == EOC:
                st["current"] = 0
                st["state"] = 256
            elif marker != SOT:
                if pos >= end:
                    st["state"] = 64
                else:
                    raise Jp2Error("Stream too short, expected SOT")
        if single or (pos >= end and st["state"] == 64):
            break
        decoded += 1
        if decoded == ntiles:
            break
    return cs


# -- OpenCV's conversion ---------------------------------------------------

def opencv_refusal(comps: list, x0: int, y0: int) -> str | None:
    """Why grfmt_jpeg2000_openjpeg.cpp refuses these components, or None."""
    for i, comp in enumerate(comps):
        if comp["sgnd"]:
            return f"OpenJPEG2000: Component {i}/{len(comps)} is signed"
    if max(c["prec"] for c in comps) < 8:
        return "OpenJPEG2000: Precision < 8 not supported"
    for comp in comps:
        if comp["dx"] != 1 or comp["dy"] != 1 or x0 or y0:
            return "OpenJPEG2000: tiles are not supported (sub-sampled or offset components)"
    return None


def _yuv2rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """OpenCV's COLOR_YUV2BGR of 8-bit samples (color_yuv: 14-bit fixed
    point), as RGB."""
    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    u, v = u - 128, v - 128
    half = 1 << 13
    b = y + ((u * 33292 + half) >> 14)
    g = y + ((v * -9519 + u * -6472 + half) >> 14)
    r = y + ((v * 18678 + half) >> 14)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def video_refusal(comps: list, x0: int, y0: int, x1: int, y1: int,
                  jp2: dict | None) -> str | None:
    """Why the video mode does not convert a frame of these components that
    libavcodec's jpeg2000dec decodes, or None: it takes 8-bit unsigned
    4:2:0 (three components, the second and third at dx = dy = 2; JP2
    colour space sYCC or none) and grey (one component; grey or none), with
    no image offset, no palette or channel definitions and no component of
    a single sample (a 2x2 frame's chroma, which libavcodec scales
    otherwise)."""
    layout = ", ".join(f"{c['dx']}x{c['dy']}" for c in comps)
    space = jp2["enumcs"] if jp2 else 0
    for i, c in enumerate(comps):
        if c["sgnd"] or c["prec"] != 8:
            return (f"JPEG 2000 video whose component {i} is {c['prec']}-bit"
                    f"{' signed' if c['sgnd'] else ''}: the port converts 8-bit unsigned "
                    "frames only")
    if x0 or y0:
        return f"JPEG 2000 video with an image offset ({x0}, {y0})"
    if jp2 and (jp2["pclr"] is not None or jp2["cdef"] is not None):
        return "JPEG 2000 video with a palette or channel definitions (pclr, cdef)"
    if any(_ceildiv(x1, c["dx"]) - _ceildiv(x0, c["dx"]) == 1
           and _ceildiv(y1, c["dy"]) - _ceildiv(y0, c["dy"]) == 1 for c in comps):
        return "JPEG 2000 video with a component of a single sample"
    grey = len(comps) == 1 and layout == "1x1" and space in (0, 17)
    yuv420 = len(comps) == 3 and layout == "1x1, 2x2, 2x2" and space in (0, 18)
    if not (grey or yuv420):
        return (f"JPEG 2000 video of {len(comps)} components sampled {layout}, colour "
                f"space {space}: the port converts 4:2:0 (sYCC) and grey frames only")
    return None


def _decode(data: bytes, video: bool) -> tuple[list, dict, dict | None]:
    """(component planes, codestream header, JP2 boxes or None)."""
    if data[:12] == JP2_SIGNATURE:
        jp2 = read_jp2(data)
        start = jp2["codestream"]
    elif data[:4] == J2K_SIGNATURE:
        jp2, start = None, 0
    else:
        raise Jp2Error("not JPEG 2000")
    image: list = []

    def on_tile(cs, tcp, tileno):
        if not image:
            if video:
                why = video_refusal(cs["comps"], cs["x0"], cs["y0"], cs["x1"], cs["y1"], jp2)
                if why:
                    raise Jp2Unsupported(why)
            for comp in cs["comps"]:
                w = _ceildiv(cs["x1"], comp["dx"]) - _ceildiv(cs["x0"], comp["dx"])
                h = _ceildiv(cs["y1"], comp["dy"]) - _ceildiv(cs["y0"], comp["dy"])
                image.append(np.zeros((h, w), np.int32))
        _decode_tile(cs, tcp, tileno, image, video)

    cs = read_codestream(data, start, on_tile,
                         (jp2["ihdr_h"], jp2["ihdr_w"]) if jp2 else (0, 0), video)
    if not image:
        raise Jp2Error("Failed to decode all used components")
    return image, cs, jp2


def decode_jp2(data: bytes) -> tuple[np.ndarray, int]:
    """JP2 or J2K bytes -> ((H, W, 3) uint8 RGB, EXIF orientation 1), as
    cv2.imdecode(IMREAD_COLOR) + BGR2RGB; raises Jp2Error where cv2 gives
    None."""
    image, cs, jp2 = _decode(data, False)
    return convert(image, cs["comps"], jp2), 1


# a video-mode decode by each decoder, apart from decode.route_counts (whose
# host_jp2 counts still images)
video_counts = {"plain": 0, "host_cpp": 0}


def decode_jp2_planes(data: bytes) -> list:
    """The video mode: a Motion JPEG 2000 frame (JP2 or J2K bytes) -> its
    component planes as uint8 arrays at their own sampling (Y, U, V of a
    4:2:0 frame; one grey plane), with no OpenCV refusal: what libavcodec's
    jpeg2000dec hands swscale: the codestream read as OpenJPEG reads it
    (the same samples before the transform), then dequantised and inverted
    with libavcodec's float 9/7 arithmetic (libav_stepsize, _idwt97_1d), so
    that yuv420_to_rgb gives cv2's frames bit for bit. Raises
    Jp2Unsupported for a layout video_refusal names,
    Jp2Error where the bytes do not decode. Reached only from the video
    route (utils/readers.py); decode_image keeps cv2.imdecode's refusal."""
    video_counts["plain"] += 1
    image, _, _ = _decode(data, True)
    return [plane.astype(np.uint8) for plane in image]


def convert(image: list, comps: list, jp2: dict | None) -> np.ndarray:
    """The decoded components -> RGB, by OpenJPEG's JP2 colour boxes and
    OpenCV's conversion (see the module docstring)."""
    max_prec = max(c["prec"] for c in comps)
    planes = list(image)
    space = 0   # OPJ_CLRSPC_UNKNOWN
    if jp2 is not None:
        space = jp2["enumcs"]
        pclr, cdef = jp2["pclr"], jp2["cdef"]
        nr_channels = len(planes)
        if cdef is not None:   # opj_jp2_check_color
            if pclr is not None and pclr["cmap"] is not None:
                nr_channels = pclr["entries"].shape[1]
            for cn, _typ, asoc in cdef:
                if cn >= nr_channels:
                    raise Jp2Error(f"Invalid component index {cn} (>= {nr_channels}).")
                if asoc != 65535 and asoc > 0 and asoc - 1 >= nr_channels:
                    raise Jp2Error(f"Invalid component index {asoc - 1} (>= {nr_channels}).")
            for k in range(nr_channels - 1, -1, -1):
                if not any(cn == k for cn, _, _ in cdef):
                    raise Jp2Error("Incomplete channel definitions.")
        if pclr is not None and pclr["cmap"] is not None:
            cmap = pclr["cmap"]
            n = len(cmap)
            sane, usage = True, [False] * n
            for cmp, _, _ in cmap:
                if cmp >= len(planes):
                    sane = False
            for i, (cmp, mtyp, pcol) in enumerate(cmap):
                if mtyp not in (0, 1) or pcol >= n:
                    sane = False
                elif usage[pcol] and mtyp == 1:
                    sane = False
                elif mtyp == 0 and pcol != 0:
                    sane = False
                elif mtyp == 1 and pcol != i:
                    sane = False
                else:
                    usage[pcol] = True
            for i in range(n):
                if not usage[i] and cmap[i][1] != 0:
                    sane = False
            if sane and len(planes) == 1 and not all(usage):
                for i in range(n):
                    cmap[i][1], cmap[i][2] = 1, i
            if not sane:
                raise Jp2Error("the JP2 component mapping (cmap) is inconsistent")
        if pclr is not None and pclr["cmap"] is not None:   # opj_jp2_apply_pclr
            entries = pclr["entries"]
            top = entries.shape[0] - 1
            new = []
            for i, (cmp, mtyp, pcol) in enumerate(pclr["cmap"]):
                src = planes[cmp]
                if mtyp == 0:
                    new.append(src.copy())
                else:
                    # int32 as OpenJPEG stores it; only low bits reach the output
                    new.append(entries[np.clip(src, 0, top), pcol].astype(np.int32))
            planes = new
        if cdef is not None:   # opj_jp2_apply_cdef
            info = [list(e) for e in cdef]
            for i, (cn, typ, asoc) in enumerate(info):
                if cn >= len(planes) or asoc in (0, 65535):
                    continue
                acn = asoc - 1
                if acn >= len(planes):
                    continue
                if cn != acn and typ == 0:
                    planes[cn], planes[acn] = planes[acn], planes[cn]
                    for e in info[i + 1:]:
                        if e[0] == cn:
                            e[0] = acn
                        elif e[0] == acn:
                            e[0] = cn
    shift = max_prec - 8
    chans = [(p >> shift).astype(np.uint8) for p in planes]
    if space in (12, 24):
        raise Jp2Error("OpenJPEG2000: Unsupported color space conversion: CMYK or e-YCC -> BGR")
    if space == 17:
        return np.stack([chans[0]] * 3, -1)
    if space == 18:
        if len(chans) < 3:
            raise Jp2Error(f"OpenJPEG2000: unsupported conversion from {len(chans)} components "
                           "to 3 for SYCC image decoding")
        return _yuv2rgb(*chans[:3])
    if len(chans) < 3:
        raise Jp2Error(f"OpenJPEG2000: unsupported conversion from {len(chans)} components "
                       "to 3 for SRGB image decoding")
    return np.stack(chans[:3], -1)


# -- the host C++ decoder --------------------------------------------------

def _lib():
    import ctypes

    from vision_kit_tpu_torch import _cuda_build

    lib = _cuda_build.load("j2k_decode")
    ptr, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.vk_j2k_create.argtypes, lib.vk_j2k_create.restype = [], ptr
    lib.vk_j2k_destroy.argtypes, lib.vk_j2k_destroy.restype = [ptr], None
    lib.vk_j2k_decode.argtypes = [ptr, ctypes.c_char_p, ctypes.c_size_t, ip, ip]
    lib.vk_j2k_decode.restype = ctypes.c_int
    lib.vk_j2k_pixels.argtypes, lib.vk_j2k_pixels.restype = [ptr, ptr], None
    lib.vk_j2k_error.argtypes, lib.vk_j2k_error.restype = [ptr], ctypes.c_char_p
    lib.vk_j2k_calls.argtypes, lib.vk_j2k_calls.restype = [], ctypes.c_longlong
    lib.vk_j2k_decode_planes.argtypes = [ptr, ctypes.c_char_p, ctypes.c_size_t, ip, ip]
    lib.vk_j2k_decode_planes.restype = ctypes.c_int
    lib.vk_j2k_plane.argtypes, lib.vk_j2k_plane.restype = [ptr, ctypes.c_int, ptr], None
    return lib


def load_c() -> None:
    """Build (nvcc, at first use) and load csrc/j2k_decode.cu; raises
    RuntimeError when it cannot be built or loaded."""
    _lib()


def c_calls() -> int:
    """How many decodes the host C++ decoder has taken in this process (its
    own count)."""
    return int(_lib().vk_j2k_calls())


def decode_jp2_c(data: bytes) -> tuple[np.ndarray, int]:
    """decode_jp2 by csrc/j2k_decode.cu (the same pixels and the same
    refusals, as Jp2Error with the same message); raises RuntimeError when
    the library cannot be built or loaded."""
    import ctypes

    lib = _lib()
    handle = lib.vk_j2k_create()
    try:
        w, h = ctypes.c_int(0), ctypes.c_int(0)
        if lib.vk_j2k_decode(handle, data, len(data), ctypes.byref(w), ctypes.byref(h)) < 0:
            raise Jp2Error(lib.vk_j2k_error(handle).decode("utf-8", "replace"))
        rgb = np.empty((h.value, w.value, 3), np.uint8)
        lib.vk_j2k_pixels(handle, rgb.ctypes.data)
        return rgb, 1
    finally:
        lib.vk_j2k_destroy(handle)


def decode_jp2_planes_c(data: bytes) -> list:
    """decode_jp2_planes by csrc/j2k_decode.cu (the same planes and the same
    refusals, Jp2Unsupported and Jp2Error with the same messages); raises
    RuntimeError when the library cannot be built or loaded."""
    import ctypes

    lib = _lib()
    video_counts["host_cpp"] += 1
    handle = lib.vk_j2k_create()
    try:
        n = ctypes.c_int(0)
        dims = (ctypes.c_int * 8)()
        rc = lib.vk_j2k_decode_planes(handle, data, len(data), ctypes.byref(n), dims)
        if rc < 0:
            why = lib.vk_j2k_error(handle).decode("utf-8", "replace")
            raise (Jp2Unsupported if rc == -2 else Jp2Error)(why)
        planes = []
        for k in range(n.value):
            plane = np.empty((dims[2 * k], dims[2 * k + 1]), np.uint8)
            lib.vk_j2k_plane(handle, k, plane.ctypes.data)
            planes.append(plane)
        return planes
    finally:
        lib.vk_j2k_destroy(handle)
