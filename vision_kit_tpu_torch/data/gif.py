"""GIF decode without OpenCV: cv2.imdecode(IMREAD_COLOR) + BGR2RGB of a GIF's
first frame, bit for bit, in numpy and the standard library.

The reference is OpenCV 5's own grfmt_gif.cpp (not giflib, not
libavcodec) as cv2 runs it:

- readHeader: "GIF87a" or "GIF89a", a logical screen of positive width
  and height, the global colour table if its flag is set (a background
  index at or past its size is refused); then the whole file is walked
  block by block to its trailer (0x3B) to count the frames: extensions
  (0x21) and images (0x2C) with their sub-blocks. Any other block type,
  or bytes that end before the trailer, refuse the file; bytes after the
  trailer are ignored.
- The first frame: the extensions before it (a graphic control extension
  must hold 4 bytes and a disposal method of 0-3, which does not matter
  for the first frame; the last one gives a transparent index where its
  flag is set), then its descriptor, which must
  lie inside the screen. The canvas starts as the global table's
  background colour, or black without a global table. The colours are the
  local table read over a copy of the global one (an index past the local
  table takes the global entry), or without either a default where index
  i is grey i but for index 1, which is white. The frame's pixels are
  painted onto the canvas at its offset, but for the transparent index,
  which leaves the canvas as it was; any other index at or past the size
  of the larger table refuses the file. Interlaced rows (passes from rows
  0, 4, 2, 1 in steps of 8, 8, 4, 2) are put back in order.
- LZW: a minimum code size of 2-11 (the first code size 3-12), codes
  LSB-first across the sub-blocks, root codes stored as a byte, the clear
  code resetting the table and code size, a code size that grows once the
  table's last code reaches 2^size - 1, a table that stops growing at 4096
  entries. The end code resets the table too; the codes after it are
  read on if more bytes follow the one it ends in (OpenCV reads on into
  its cleared table there, which is undefined behaviour in C++; with
  root codes after it the two agree). A code past the table, a table
  code that would make more pixels than the frame holds, or fewer pixels
  than it holds refuse the file. The first code that finds the frame full
  ends the decode, and the file is refused unless no byte of its LZW data
  is left unread.

An animated GIF gives its first frame, as cv2.imdecode does.
"""

from __future__ import annotations

import numpy as np

from vision_kit_tpu_torch.data.decode import _Stream, size_refusal


class GifError(ValueError):
    """Bytes that cv2 does not decode as GIF; decode_image answers None."""


def is_gif(data: bytes) -> bool:
    """GifDecoder's signature ("GIF"; the version is checked later)."""
    return data[:3] == b"GIF"


def _sub_blocks(st: _Stream) -> bytes:
    """Data sub-blocks up to their zero-length terminator, joined."""
    out = []
    n = st.byte()
    while n:
        out.append(st.take(n))
        n = st.byte()
    return b"".join(out)


def _colour_table(st: _Stream, flags: int) -> np.ndarray:
    return np.frombuffer(st.take(3 << ((flags & 7) + 1)), np.uint8).reshape(-1, 3)


def gif_header(data: bytes) -> dict:
    """Width, height, the global colour table (None without one), the
    background index, the first block's offset and orientation (1), as
    GifDecoder::readHeader reads them (with its walk to the trailer)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise GifError("not a GIF file")
    st = _Stream(data, 6, GifError)
    width, height = st.word(), st.word()
    if width <= 0 or height <= 0:
        raise GifError(f"GIF screen {width}x{height}")
    flags, bg = st.byte(), st.byte()
    st.byte()
    table = _colour_table(st, flags) if flags & 0x80 else None
    if table is not None and bg >= len(table):
        raise GifError("GIF: background index past the global colour table")
    start = st.pos
    frames = 0
    kind = st.byte()
    while kind != 0x3B:
        if kind == 0x21:
            st.byte()
            _sub_blocks(st)
        elif kind == 0x2C:
            frames += 1
            st.take(8)
            f = st.byte()
            if f & 0x80:
                _colour_table(st, f)
            st.byte()
            _sub_blocks(st)
        else:
            raise GifError(f"GIF: block type {kind:#x}")
        kind = st.byte()
    return dict(width=width, height=height, table=table, background=bg, offset=start,
                frames=frames, orientation=1)


def _lzw(stream: bytes, min_size: int, n_pixels: int) -> bytes:
    """The frame's colour indices from its LZW codes (module docstring)."""
    if not 2 <= min_size <= 11:
        raise GifError(f"GIF: LZW minimum code size {min_size}")
    clear = 1 << min_size
    end = clear + 1
    roots = [bytes([i & 255]) for i in range(clear)] + [None, None]   # stored as uchar
    table = list(roots)
    size = min_size + 1
    mask = (1 << size) - 1
    prev = None
    out = []
    count = 0
    acc = nbits = 0
    last = len(stream) - 1
    for i, byte in enumerate(stream):
        acc |= byte << nbits
        nbits += 8
        while nbits >= size:
            code = acc & mask
            acc >>= size
            nbits -= size
            if code == clear or code == end:
                table = list(roots)
                size = min_size + 1
                mask = (1 << size) - 1
                prev = None
                if code == end and i == last:   # the bits after it go unread
                    break
                continue
            if count >= n_pixels:   # OpenCV stops here: every byte must have been read
                if i != last:
                    raise GifError("GIF: LZW data past the frame's pixels")
                return b"".join(out)
            n = len(table)
            if code < n:
                entry = table[code]
                if entry is None:
                    raise GifError("GIF: an LZW code past the table")
                if prev is not None and n < 4096:
                    table.append(prev + entry[:1])
            elif code == n and prev is not None:
                entry = prev + prev[:1]
                if n < 4096:
                    table.append(entry)
            else:
                raise GifError("GIF: an LZW code past the table")
            count += len(entry)
            if count > n_pixels:
                raise GifError("GIF: too long LZW data")
            out.append(entry)
            prev = entry
            if len(table) - 1 >= mask and size < 12:
                size += 1
                mask = (1 << size) - 1
    if count < n_pixels:
        raise GifError("GIF: the LZW data ends early")
    return b"".join(out)


def _deinterlace(idx: np.ndarray) -> np.ndarray:
    h = len(idx)
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                            np.arange(1, h, 2)])
    out = np.empty_like(idx)
    out[order] = idx
    return out


_DEFAULT_TABLE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
_DEFAULT_TABLE[1] = 255


def decode_gif(data: bytes) -> tuple[np.ndarray, int]:
    """cv2.imdecode(IMREAD_COLOR) of a GIF's first frame as (H, W, 3) RGB,
    and orientation 1 (see the module docstring). Raises GifError where
    cv2 gives None or raises."""
    info = gif_header(data)
    w, h, table = info["width"], info["height"], info["table"]
    if size_refusal(w, h):
        raise GifError(size_refusal(w, h))
    st = _Stream(data, info["offset"], GifError)
    transparent = None
    kind = st.byte()
    while kind == 0x21:
        if st.byte() == 0xF9:   # graphic control: size 4, disposal 0-3
            if st.byte() != 4:
                raise GifError("GIF: a graphic control extension not of 4 bytes")
            flags, _, _, index = st.take(4)
            if (flags >> 2) & 7 > 3:
                raise GifError(f"GIF: disposal method {(flags >> 2) & 7}")
            transparent = index if flags & 1 else None
        _sub_blocks(st)
        kind = st.byte()
    if kind != 0x2C:
        raise GifError("GIF: no image after the extensions")
    left, top, fw, fh = st.word(), st.word(), st.word(), st.word()
    if not (fw > 0 and fh > 0 and left + fw <= w and top + fh <= h):
        raise GifError("GIF: the frame lies outside the screen")
    flags = st.byte()
    local = _colour_table(st, flags) if flags & 0x80 else None
    if local is None and table is None:
        colours, n_colours = _DEFAULT_TABLE, 256
    else:   # the local table read over a copy of the global one
        colours = np.zeros((256, 3), np.uint8)
        for t in (table, local):
            if t is not None:
                colours[:len(t)] = t
        n_colours = max(len(t) for t in (table, local) if t is not None)
    min_size = st.byte()
    idx = np.frombuffer(_lzw(_sub_blocks(st), min_size, fw * fh), np.uint8).reshape(fh, fw)
    if flags & 0x40:
        idx = _deinterlace(idx)
    canvas = np.zeros((h, w, 3), np.uint8)
    if table is not None:
        canvas[:] = table[info["background"]]
    frame = canvas[top:top + fh, left:left + fw]
    keep = idx != transparent if transparent is not None else np.ones(idx.shape, bool)
    if keep.any() and int(idx[keep].max()) >= n_colours:
        raise GifError("GIF: a colour index past the colour tables")
    frame[keep] = colours[idx[keep]]
    return canvas, 1
