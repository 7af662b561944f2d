"""Write vision_kit_tpu_torch/data/vp9_tables.py from libvpx.

VP9's default probabilities, scans, bands, trees, filters and quantiser
tables are trained or chosen constants that cannot be derived. cv2's wheel
ships libvpx v1.15.2 (`opencv_python.libs/libvpx-*.so.11.0.1`) with its
`.symtab`: each table below is read from `.rodata` at its symbol's address
and size, in plain Python (`read_symbols`). The few small defaults the
compiler folded into the code of `vp9_setup_past_independence` and
`vp9_init_mv_probs` (the tx, skip, intra-inter, comp-inter and comp-ref
probabilities and the MV context) are typed from the VP9 bitstream
specification; `FOLDED` gives each as the runs of bytes the library
holds them in (immediates and the anonymous constants those functions load),
and tests/test_torch_vp9.py finds every run there.

    python tests/torch_vp9_tables.py   # rewrites data/vp9_tables.py, csrc/vp9_tables.cuh
"""

from __future__ import annotations

import glob
import os
import struct

import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "vision_kit_tpu_torch", "data", "vp9_tables.py")
OUT_CUH = os.path.join(ROOT, "vision_kit_tpu_torch", "csrc", "vp9_tables.cuh")
sys.path.insert(0, ROOT)

# (module name, libvpx symbol, dtype, shape); `near` picks one of several
# symbols of that name: the one whose address lies closest to `near`'s.
SYMBOLS = [
    ("COEF_PROBS_4X4", "default_coef_probs_4x4", "u1", (2, 2, 6, 6, 3), None),
    ("COEF_PROBS_8X8", "default_coef_probs_8x8", "u1", (2, 2, 6, 6, 3), None),
    ("COEF_PROBS_16X16", "default_coef_probs_16x16", "u1", (2, 2, 6, 6, 3), None),
    ("COEF_PROBS_32X32", "default_coef_probs_32x32", "u1", (2, 2, 6, 6, 3), None),
    ("PARETO8_FULL", "vp9_pareto8_full", "u1", (255, 8), None),
    ("KF_Y_MODE_PROB", "vp9_kf_y_mode_prob", "u1", (10, 10, 9), None),
    ("KF_UV_MODE_PROB", "vp9_kf_uv_mode_prob", "u1", (10, 9), None),
    ("KF_PARTITION_PROBS", "vp9_kf_partition_probs", "u1", (16, 3), None),
    ("PARTITION_PROBS", "default_partition_probs", "u1", (16, 3), None),
    ("IF_Y_PROBS", "default_if_y_probs", "u1", (4, 9), None),
    ("IF_UV_PROBS", "default_if_uv_probs", "u1", (10, 9), None),
    ("INTER_MODE_PROBS", "default_inter_mode_probs", "u1", (7, 3), None),
    ("SINGLE_REF_P", "default_single_ref_p", "u1", (5, 2), None),
    ("SWITCHABLE_INTERP_PROB", "default_switchable_interp_prob", "u1", (4, 2), None),
    ("INV_MAP_TABLE", "inv_map_table.0", "u1", (255,), None),
    ("COUNT_TO_UPDATE_FACTOR", "count_to_update_factor", "<i4", (21,), None),
    ("DC_QLOOKUP", "dc_qlookup", "<i2", (256,), "dc_qlookup_10"),
    ("AC_QLOOKUP", "ac_qlookup", "<i2", (256,), "ac_qlookup_10"),
    ("SUB_PEL_FILTERS_8", "sub_pel_filters_8", "<i2", (16, 8), None),
    ("SUB_PEL_FILTERS_8LP", "sub_pel_filters_8lp", "<i2", (16, 8), None),
    ("SUB_PEL_FILTERS_8S", "sub_pel_filters_8s", "<i2", (16, 8), None),
    ("BILINEAR_FILTERS", "bilinear_filters", "<i2", (16, 8), "sub_pel_filters_8"),
    ("DEFAULT_SCAN_4X4", "default_scan_4x4", "<i2", (16,), None),
    ("COL_SCAN_4X4", "col_scan_4x4", "<i2", (16,), None),
    ("ROW_SCAN_4X4", "row_scan_4x4", "<i2", (16,), None),
    ("DEFAULT_SCAN_8X8", "default_scan_8x8", "<i2", (64,), None),
    ("COL_SCAN_8X8", "col_scan_8x8", "<i2", (64,), None),
    ("ROW_SCAN_8X8", "row_scan_8x8", "<i2", (64,), None),
    ("DEFAULT_SCAN_16X16", "default_scan_16x16", "<i2", (256,), None),
    ("COL_SCAN_16X16", "col_scan_16x16", "<i2", (256,), None),
    ("ROW_SCAN_16X16", "row_scan_16x16", "<i2", (256,), None),
    ("DEFAULT_SCAN_32X32", "default_scan_32x32", "<i2", (1024,), None),
    ("DEFAULT_SCAN_4X4_NEIGHBORS", "default_scan_4x4_neighbors", "<i2", (17, 2), None),
    ("COL_SCAN_4X4_NEIGHBORS", "col_scan_4x4_neighbors", "<i2", (17, 2), None),
    ("ROW_SCAN_4X4_NEIGHBORS", "row_scan_4x4_neighbors", "<i2", (17, 2), None),
    ("DEFAULT_SCAN_8X8_NEIGHBORS", "default_scan_8x8_neighbors", "<i2", (65, 2), None),
    ("COL_SCAN_8X8_NEIGHBORS", "col_scan_8x8_neighbors", "<i2", (65, 2), None),
    ("ROW_SCAN_8X8_NEIGHBORS", "row_scan_8x8_neighbors", "<i2", (65, 2), None),
    ("DEFAULT_SCAN_16X16_NEIGHBORS", "default_scan_16x16_neighbors", "<i2", (257, 2), None),
    ("COL_SCAN_16X16_NEIGHBORS", "col_scan_16x16_neighbors", "<i2", (257, 2), None),
    ("ROW_SCAN_16X16_NEIGHBORS", "row_scan_16x16_neighbors", "<i2", (257, 2), None),
    ("DEFAULT_SCAN_32X32_NEIGHBORS", "default_scan_32x32_neighbors", "<i2", (1025, 2), None),
    ("COEFBAND_TRANS_4X4", "vp9_coefband_trans_4x4", "u1", (16,), None),
    ("COEFBAND_TRANS_8X8PLUS", "vp9_coefband_trans_8x8plus", "u1", (1024,), None),
    ("MV_REF_BLOCKS", "mv_ref_blocks", "<i4", (13, 8, 2), None),
    ("MODE_2_COUNTER", "mode_2_counter", "<i4", (14,), None),
    ("COUNTER_TO_CONTEXT", "counter_to_context", "<i4", (19,), None),
    ("MODE_LF_LUT", "mode_lf_lut", "<i4", (14,), None),
    ("INTRA_MODE_TREE", "vp9_intra_mode_tree", "i1", (18,), None),
    ("INTER_MODE_TREE", "vp9_inter_mode_tree", "i1", (6,), None),
    ("PARTITION_TREE", "vp9_partition_tree", "i1", (6,), None),
    ("SWITCHABLE_INTERP_TREE", "vp9_switchable_interp_tree", "i1", (4,), None),
    ("SEGMENT_TREE", "vp9_segment_tree", "i1", (14,), None),
    ("MV_JOINT_TREE", "vp9_mv_joint_tree", "i1", (6,), None),
    ("MV_CLASS_TREE", "vp9_mv_class_tree", "i1", (20,), None),
    ("MV_CLASS0_TREE", "vp9_mv_class0_tree", "i1", (2,), None),
    ("MV_FP_TREE", "vp9_mv_fp_tree", "i1", (6,), None),
    ("COEF_CON_TREE", "vp9_coef_con_tree", "i1", (22,), None),
    ("CAT1_PROB", "vp9_cat1_prob", "u1", (1,), None),
    ("CAT2_PROB", "vp9_cat2_prob", "u1", (2,), None),
    ("CAT3_PROB", "vp9_cat3_prob", "u1", (3,), None),
    ("CAT4_PROB", "vp9_cat4_prob", "u1", (4,), None),
    ("CAT5_PROB", "vp9_cat5_prob", "u1", (5,), None),
    ("CAT6_PROB", "vp9_cat6_prob", "u1", (14,), None),
    ("SEG_FEATURE_DATA_MAX", "seg_feature_data_max", "<i4", (4,), None),
    ("SEG_FEATURE_DATA_SIGNED", "seg_feature_data_signed", "<i4", (4,), None),
    ("NUM_4X4_BLOCKS_WIDE", "num_4x4_blocks_wide_lookup", "u1", (13,), None),
    ("NUM_8X8_BLOCKS_WIDE", "num_8x8_blocks_wide_lookup", "u1", (13,), None),
    ("B_WIDTH_LOG2", "b_width_log2_lookup", "u1", (13,), None),
    ("B_HEIGHT_LOG2", "b_height_log2_lookup", "u1", (13,), None),
    ("MI_WIDTH_LOG2", "mi_width_log2_lookup", "u1", (13,), None),
    ("SIZE_GROUP", "size_group_lookup", "u1", (13,), None),
    ("MAX_TXSIZE", "max_txsize_lookup", "u1", (13,), None),
    ("UV_TXSIZE", "uv_txsize_lookup", "u1", (13, 4, 2, 2), None),
    ("SUBSIZE", "subsize_lookup", "u1", (4, 13), None),
    ("SS_SIZE", "ss_size_lookup", "u1", (13, 2, 2), None),
    ("PARTITION_CONTEXT", "partition_context_lookup", "u1", (13, 2), None),
    ("INTRA_MODE_TO_TX_TYPE", "intra_mode_to_tx_type_lookup", "<i4", (10,), None),
]

# The small defaults folded into code, typed from the VP9 specification
# (section 10.5 and the default MV context), each with the runs of bytes
# libvpx keeps it in.
FOLDED = [
    ("TX_PROBS_8X8", "u1", (2, 1), [100, 66], [[100], [66, 192, 128, 64]]),
    ("TX_PROBS_16X16", "u1", (2, 2), [20, 152, 15, 101], [[20, 152, 15, 101]]),
    ("TX_PROBS_32X32", "u1", (2, 3), [3, 136, 37, 5, 52, 13], [[3, 136, 37, 5, 52, 13]]),
    ("SKIP_PROBS", "u1", (3,), [192, 128, 64], [[66, 192, 128, 64]]),
    ("INTRA_INTER_P", "u1", (4,), [9, 102, 187, 225], [[9, 102, 187, 225]]),
    ("COMP_INTER_P", "u1", (5,), [239, 183, 119, 96, 41], [[239, 183, 119, 96], [41]]),
    ("COMP_REF_P", "u1", (5,), [50, 126, 123, 221, 226], [[50, 126, 123, 221, 226]]),
    ("MV_JOINTS", "u1", (3,), [32, 64, 96], [[32, 64, 96]]),
    # per component: sign, classes[10], class0[1], bits[10], class0_fp[2][3],
    # fp[3], class0_hp, hp
    ("MV_COMP0", "u1", (33,),
     [128, 224, 144, 192, 168, 192, 176, 192, 198, 198, 245, 216,
      136, 140, 148, 160, 176, 192, 224, 234, 234, 240, 128, 128, 64, 96, 112, 64, 64, 96, 64,
      160, 128],
     [[128, 224, 144, 192, 168, 192, 176, 192, 198, 198, 245, 216, 136, 140, 148, 160, 176, 192,
       224, 234, 234, 240, 128, 128, 64, 96, 112, 64, 64], [96, 64], [160, 128]]),
    ("MV_COMP1", "u1", (33,),
     [128, 216, 128, 176, 160, 176, 176, 192, 198, 198, 208, 208,
      136, 140, 148, 160, 176, 192, 224, 234, 234, 240, 128, 128, 64, 96, 112, 64, 64, 96, 64,
      160, 128],
     [[128], [216, 128, 176, 160, 176, 176, 192, 198, 198, 208, 208, 136, 140, 148, 160, 176],
      [160, 176, 192, 224, 234, 234, 240, 128, 128, 64, 96, 112, 64, 64, 96, 64], [160, 128]]),
]
FOLDED_IN = ("vp9_setup_past_independence", "vp9_init_mv_probs")


def library() -> str | None:
    """cv2's bundled libvpx, or None where this cv2 has none."""
    try:
        import cv2
    except ImportError:
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    found = sorted(glob.glob(os.path.join(libs, "libvpx-*.so*")))
    return found[0] if found else None


def _elf(data: bytes) -> tuple:
    """(sections by name: (addr, offset, size), symbols: name -> [(addr, size)])."""
    assert data[:4] == b"\x7fELF" and data[4] == 2, "a 64-bit ELF"
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", data, 0x3A)
    heads = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + i * shentsize) for i in range(shnum)]
    names_off = heads[shstrndx][4]

    def name(off, base):
        return data[base + off:data.index(b"\0", base + off)].decode()

    sections = {name(h[0], names_off): (h[3], h[4], h[5], h) for h in heads}
    _, symoff, symsize, symh = sections[".symtab"]
    stroff = heads[symh[6]][4]
    symbols = {}
    for i in range(symsize // 24):
        st_name, _, _, _, value, size = struct.unpack_from("<IBBHQQ", data, symoff + 24 * i)
        if st_name and size:
            symbols.setdefault(name(st_name, stroff), []).append((value, size))
    return sections, symbols


def _at(data: bytes, sections: dict, addr: int, size: int) -> bytes:
    for base, off, n, _ in sections.values():
        if base and base <= addr and addr + size <= base + n:
            return data[off + addr - base:off + addr - base + size]
    raise KeyError(hex(addr))


def read_symbols(path: str) -> dict:
    """Each table's bytes from the library: name -> (symbol, address, bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    sections, symbols = _elf(data)
    out = {}
    for name, sym, dtype, shape, near in SYMBOLS:
        size = int(np.dtype(dtype).itemsize * np.prod(shape))
        cands = [(a, s) for a, s in symbols[sym] if s == size]
        assert cands, (sym, symbols.get(sym))
        if len(cands) > 1:
            if near is not None:
                ref = symbols[near][0][0]
                cands.sort(key=lambda c: abs(c[0] - ref))
            else:   # copies in several objects: they must agree
                blobs = {_at(data, sections, a, s) for a, s in cands}
                assert len(blobs) == 1, sym
        addr, _ = cands[0]
        out[name] = (sym, addr, _at(data, sections, addr, size))
    return out


def folded_blob(path: str) -> bytes:
    """The code of the functions that hold the folded defaults and the
    constants they load (the 16 bytes of a rip-relative movdqa, the 2 of a
    rip-relative movzwl)."""
    with open(path, "rb") as f:
        data = f.read()
    sections, symbols = _elf(data)
    blob = b""
    for fn in FOLDED_IN:
        addr, size = symbols[fn][0]
        code = _at(data, sections, addr, size)
        blob += code
        for i in range(len(code) - 8):
            for op, n in ((b"\x66\x0f\x6f\x05", 16), (b"\x0f\xb7\x15", 2)):
                if code[i:i + len(op)] == op:
                    disp, = struct.unpack_from("<i", code, i + len(op))
                    blob += _at(data, sections, addr + i + len(op) + 4 + disp, n)
    return blob


def _hex(b: bytes, indent: str = "    ") -> str:
    h = b.hex()
    return "\n".join(f'{indent}"{h[i:i + 72]}"' for i in range(0, len(h), 72))


def render(path: str) -> str:
    tables = read_symbols(path)
    lines = [
        '"""VP9\'s default tables (data/vp9.py reads them), written by',
        "tests/torch_vp9_tables.py from libvpx v1.15.2: each table is the bytes of",
        "the libvpx symbol named beside it (its .rodata at the symbol's address and",
        "size), and tests/test_torch_vp9.py holds them to the library byte for byte.",
        "The small defaults libvpx folds into code are typed from the VP9",
        'specification (marked "spec").',
        '"""',
        "",
        "import numpy as np",
        "",
        "",
        "def _t(hexs: str, dtype: str, shape: tuple) -> np.ndarray:",
        "    return np.frombuffer(bytes.fromhex(hexs), dtype).reshape(shape)",
        "",
    ]
    for name, sym, dtype, shape, _ in SYMBOLS:
        _, addr, raw = tables[name]
        lines.append(f"# {sym} (libvpx .rodata)")
        lines.append(f"{name} = _t(\n{_hex(raw)}, \"{dtype}\", {shape})")
    lines.append("")
    for name, dtype, shape, values, _ in FOLDED:
        lines.append(f"# spec; folded into {' / '.join(FOLDED_IN)} in libvpx")
        lines.append(f"{name} = np.array({values}, \"{dtype}\").reshape({shape})")
    return "\n".join(lines) + "\n"


def render_cuh() -> str:
    """The same tables as C arrays for csrc/vp9_decode.cu, from the
    committed module."""
    from vision_kit_tpu_torch.data import vp9_tables

    ctype = {"u1": "uint8_t", "i1": "int8_t", "<i2": "int16_t", "<i4": "int32_t"}
    lines = ["// VP9's default tables for csrc/vp9_decode.cu: data/vp9_tables.py as C",
             "// arrays, written by tests/torch_vp9_tables.py (each from the libvpx",
             "// symbol named there, or typed from the specification).", "",
             "#pragma once", "", "#include <cstdint>", "", "namespace vp9t {", ""]
    names = [(n, d, s) for n, _, d, s, _ in SYMBOLS] + [(n, d, s) for n, d, s, _, _ in FOLDED]
    for name, dtype, shape in names:
        arr = getattr(vp9_tables, name).reshape(-1).tolist()
        body = ", ".join(str(v) for v in arr)
        wrapped, line = [], ""
        for tok in body.split(", "):
            if len(line) + len(tok) > 90:
                wrapped.append(line.rstrip())
                line = ""
            line += tok + ", "
        wrapped.append(line.rstrip().rstrip(","))
        dims = "".join(f"[{d}]" for d in shape)
        lines.append(f"const {ctype[dtype]} {name}{dims} = {{")
        lines += ["    " + w for w in wrapped]
        lines.append("};")
    lines += ["", "}  // namespace vp9t", ""]
    return "\n".join(lines)


if __name__ == "__main__":
    lib = library()
    assert lib, "no libvpx in cv2's wheel"
    with open(OUT, "w") as f:
        f.write(render(lib))
    with open(OUT_CUH, "w") as f:
        f.write(render_cuh())
    print("wrote", OUT, OUT_CUH)
