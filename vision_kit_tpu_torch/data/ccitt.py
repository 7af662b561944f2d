"""CCITT Group 4 (ITU-T T.6, "MMR") decode for data/tiff.py, as libtiff's
Fax4Decode reads a strip or tile: every row coded in two dimensions
against the row above (an all-white row before the first), pass,
horizontal (two runs from the T.4 white and black code tables, make-up
codes first) and vertical (-3..+3) modes, rows padded to whole bytes
with 0 (white in MinIsWhite) bits. An EOFB or a code outside the tables
ends the strip: the row being decoded keeps its runs so far, the rows
after it stay 0; libtiff reports no error unless it ends in the first
row.
"""

from __future__ import annotations

import numpy as np

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
    "000000011111").split()


def _table(term, makeup) -> dict:
    t = {code: run for run, code in enumerate(term)}
    t.update({code: 64 * (i + 1) for i, code in enumerate(makeup)})
    t.update({code: 1792 + 64 * i for i, code in enumerate(_EXT_MAKEUP)})
    return t


WHITE = _table(_WHITE_TERM, _WHITE_MAKEUP)
BLACK = _table(_BLACK_TERM, _BLACK_MAKEUP)
_MODES = {"1": ("V", 0), "011": ("V", 1), "000011": ("V", 2), "0000011": ("V", 3),
          "010": ("V", -1), "000010": ("V", -2), "0000010": ("V", -3), "0001": ("P", 0),
          "001": ("H", 0)}


class _Bits:
    def __init__(self, data: bytes):
        self.s = np.unpackbits(np.frombuffer(data, np.uint8)).tobytes().translate(
            bytes.maketrans(b"\0\1", b"01")).decode()
        self.pos = 0

    def code(self, table: dict, longest: int):
        s, p = self.s, self.pos
        for n in range(1, longest + 1):
            v = table.get(s[p:p + n])
            if v is not None and p + n <= len(s):
                self.pos = p + n
                return v
        return None

    def run(self, table: dict):
        total = 0
        while True:
            v = self.code(table, 13)
            if v is None:
                return None
            total += v
            if v < 64:
                return total


def decode_g4(data: bytes, width: int, rows: int) -> tuple[bytes, bool]:
    """(rows x ceil(width / 8) bytes of packed bits, 1 for black, ok)."""
    row_bytes = (width + 7) // 8
    out = np.zeros((rows, row_bytes * 8), np.uint8)
    bits = _Bits(data)
    ref = [width, width]            # changing elements of the row above
    for y in range(rows):
        changes = []                # of this row
        a0, colour = -1, 0
        bad = False
        while a0 < width:
            mode = bits.code(_MODES, 7)
            if mode is None:
                bad = True
                break
            start = max(a0, 0)
            # b1: the first change above, right of a0, to the colour opposite a0's
            i = 0
            while i < len(ref) and (ref[i] <= a0 if a0 >= 0 else ref[i] < 0):
                i += 1
            if i % 2 != colour:
                i += 1
            b1 = ref[i] if i < len(ref) else width
            b2 = ref[i + 1] if i + 1 < len(ref) else width
            kind, d = mode
            if kind == "P":
                if colour:
                    out[y, start:b2] = 1
                a0 = b2
            elif kind == "H":
                r1 = bits.run(BLACK if colour else WHITE)
                r2 = None if r1 is None else bits.run(WHITE if colour else BLACK)
                if r2 is None:
                    bad = True
                    break
                a1 = min(start + r1, width)
                a2 = min(a1 + r2, width)
                if colour:
                    out[y, start:a1] = 1
                else:
                    out[y, a1:a2] = 1
                changes += [a1, a2]
                a0 = a2
            else:
                a1 = b1 + d
                if a1 < start or a1 > width:
                    bad = True
                    break
                if colour:
                    out[y, start:a1] = 1
                changes.append(a1)
                a0 = a1
                colour ^= 1
        if bad:
            packed = np.packbits(out[:y + 1], axis=1).tobytes()
            return packed, y > 0
        ref = [c for c in changes if c < width] + [width, width]
    return np.packbits(out, axis=1).tobytes(), True
