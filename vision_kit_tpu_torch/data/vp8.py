"""VP8 (RFC 6386) without a codec library: the stages libwebp's lossy
WebP and libavcodec's VP8 video decoder share, and the video decoder.

data/webp.py decodes a WebP's VP8 key frame with the tables, the boolean
decoder, the token decode, the key-frame mode parse, the WHT and IDCT, the
intra predictors, the reconstruction and the loop filter below, as libwebp
does; the video decoder here adds what inter frames need and follows
libavcodec's vp8.c, the decoder cv2.VideoCapture (its FFMPEG backend) runs
on VP8 in WebM, Matroska, AVI and IVF. csrc/vp8_decode.cu is the same
decoder as host C++ for the card (`Vp8Decoder(device="cuda")`).

`Vp8Decoder.decode(frame)` takes one frame (a container's block or chunk)
and returns the Y, U and V planes cropped to the frame's size (chroma
(h + 1) // 2 x (w + 1) // 2), or None for a frame with show_frame 0; a
frame libavcodec refuses raises Vp8Error naming why. It covers:

- the frame tag (key frame, version 0-3, show_frame, the first
  partition's size), the key frame's start code and 14-bit sizes (the
  scale bits ignored, as libavcodec ignores them), the colour-space and
  clamping bits; segmentation (map and data updates, absolute or delta
  values, the tree probabilities, the map read from the frame decoded
  before when a frame keeps it); the loop-filter settings (type, level,
  sharpness, reference and mode deltas); 1, 2, 4 or 8 token partitions
  and the quantiser deltas; the golden and altref refresh and copy flags
  and sign biases, refresh_last; refresh_entropy_probs (the probabilities
  saved after the quantisers and restored after a frame that sets it to
  0); the coefficient, skip, intra, last, golden, y-mode, uv-mode and MV
  probability updates; the key frame's resets;
- per macroblock: the segment, the skip flag, the reference frame; intra
  macroblocks of inter frames (their sub-block modes at the fixed
  probabilities); the near-MV search of vp8_decode_mvs (sign-bias
  inversion, the mode contexts, the merge and swap of its counts), ZERO,
  NEAREST, NEAR, NEW and SPLIT (16x8, 8x16, 8x8, 4x4, sub-vectors LEFT,
  ABOVE, ZERO or NEW), the short and long MV forms, the clamp of the
  near and best vectors to 16 pixels past the frame;
- prediction: the six-tap filter for version 0, bilinear for the others,
  full-pixel chroma for version 3; chroma vectors from the luma ones (the
  sum of four, rounded as libavcodec rounds, in a 4x4 split); references
  read past their edge as libavcodec's edge emulation reads them (the
  macroblock-aligned plane's border pixels, without end); the IDCT in
  libavcodec's 16-bit SSE arithmetic (residuals' `lanes16`);
- the normal and simple loop filters with per-macroblock levels (segment
  and delta adjustments clipped once, at the end, as libavcodec does;
  libvpx clips the segment's level first), the inter-frame hev
  thresholds, the inner edges skipped for a macroblock without
  coefficients that is neither B_PRED nor SPLIT;
- the last, golden and altref references, each copy reading the
  references as they were before the frame (golden and altref can swap);
- refusals: a frame shorter than its tag or its first partition, a key
  frame without the start code or of width or height 0, partition sizes
  past the frame's end, an empty partition, an inter frame before any key
  frame (libavcodec's "Discarding interframe without a prior keyframe";
  here it has no size yet: a frame of 0x0);
- libavcodec's end of data: a partition reads the bytes of the frame that
  follow it (to an even count past its first three) and zeros after
  them, and decoding stops where vpx_rac_is_end has held 11 times on a
  partition (checked on partition 0 at each row and each macroblock, on
  the token partition at each macroblock); the macroblocks after the stop
  are left 0 (libavcodec leaves the frame buffer's old contents) and the
  stopped row unfiltered.

Rules settled on this environment's cv2 (OpenCV 5.0.0, libavcodec 62), each
held by tests/test_torch_vp8.py:

- the key frame's clamping bit is libavcodec's colour range: it tags that
  frame and the frames after it AVCOL_RANGE_JPEG, and cv2 converts them
  with swscale's full-range coefficients (mpeg4.FULL_RANGE_COEFFS: Y
  unscaled, chroma scaled by 224 / 255); the colour-space bit changes
  nothing. (With cv2's default frame threads the range reaches only the
  frames its own thread decodes; the port follows the single-threaded
  decoder, cv2 with OPENCV_FFMPEG_THREADS=1.)
- the tag's version selects the prediction filter alone (0 six-tap, 1-3
  bilinear, 3 full-pixel chroma, 4-7 as 1-2); the loop filter's type is
  the frame header's bit whatever the version;
- a frame with show_frame 0 is decoded and its references kept, and cv2
  returns no frame for it; cv2 skips an empty frame; a frame libavcodec
  refuses ends cv2's stream (VideoReader follows all three);
- a frame that keeps segmentation without a map update reads the map of
  the frame decoded before, and a frame without segmentation leaves a
  map of 0 for the next (libavcodec's fresh map a frame);
- golden and altref copies read the references as they were before the
  frame (libvpx applies the golden copy first);
- a key frame that changes the frame size comes back from cv2 at the
  first frame's size: the port refuses it by name (Vp8Unsupported);
- at an odd height cv2's RGB comes from another swscale path (the Y
  plane equals the decoder's), as for the MPEG-4 frames.

`yuv` planes convert to RGB by data/mpeg4.py:yuv420_to_rgb, cv2's swscale
arithmetic.
"""

from __future__ import annotations

import copy

import numpy as np
import torch


class Vp8Error(ValueError):
    """A VP8 frame libavcodec refuses: cv2.VideoCapture's read fails there
    and its stream ends."""


class Vp8Unsupported(Vp8Error):
    """A VP8 frame libavcodec decodes and the port refuses: a key frame
    that changes the frame size, which cv2 returns at the stream's first
    size."""


# -- tables ----------------------------------------------------------------

# tree_dec.c CoeffsProba0 (RFC 6386 13.5): default token probabilities [type][band][ctx][node]
COEFFS_PROBA0 = np.frombuffer(bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88fe"
    "ffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2"
    "ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff808080"
    "8080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faff"
    "ee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180"
    "808080805081d3ffc2e080808080800101ff8080808080808080f601ff80808080808080"
    "80ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0"
    "bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2"
    "ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7"
    "ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff808080"
    "8080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af"
    "0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba80"
    "80808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080"
    "808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501"
    "ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080"
    "808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6"
    "fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe080"
    "80809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b"
    "66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080a8aff6fc"
    "ebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff80808080808080"
    "80ee01ff8080808080808080"), np.uint8).reshape(4, 8, 3, 11)
# tree_dec.c CoeffsUpdateProba (RFC 6386 13.4): probability that each is updated
COEFFS_UPDATE_PROBA = np.frombuffer(bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ff"
    "ffffffffffffffffdff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffff"
    "ffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffff"
    "ffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefeff"
    "fffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefeff"
    "fffffffffffffff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffff"
    "fffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdffffff"
    "fffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffea"
    "fbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffff"
    "fffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffffffff"
    "fffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfd"
    "fffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffffffffffff"
    "fffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffc"
    "fdfefffffffffffffffffffefffffffffffffffffffffcfffffffffffffffffff9fffeff"
    "fffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffff"
    "ffffffffffffffffffffffff"), np.uint8).reshape(4, 8, 3, 11)
# tree_dec.c kBModesProba (RFC 6386 11.5): 4x4 mode probabilities [top][left]
BMODES_PROBA = np.frombuffer(bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98"
    "721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce47"
    "3f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b50"
    "4266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216"
    "585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d"
    "271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e172"
    "2213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d1"
    "6450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c0171952"
    "8a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39"
    "363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea020f017649"
    "4b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a"
    "39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25"
    "442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c955"
    "4b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d1"
    "2d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420"
    "654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418"), np.uint8).reshape(10, 10, 9)
# quant_dec.c kDcTable and kAcTable (RFC 6386 14.1)
DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68,
    69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
    86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
    112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143,
    145, 148, 151, 154, 157)
AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96,
    98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239,
    245, 249, 254, 259, 264, 269, 274, 279, 284)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)   # kBands, n -> band
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# kYModesIntra4: the 4x4 mode tree, -mode at the leaves
YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)

# -- VP8, lossy: the boolean decoder --------------------------------------

# shift that brings a range of 1..255 back to 128..255 (7 ^ floor(log2 r))
NORM = tuple(0 if r == 0 else 7 - (r.bit_length() - 1) for r in range(256))


class BoolReader:
    """The boolean decoder (bit_reader_utils's VP8BitReader): `rng` is the
    range minus one, `value` holds `bits` + 8 unread bits. Bytes load one
    at a time, and past `end` zero bytes, `eof` counting them: libwebp
    fails the decode at the first (VP8LoadFinalBytes' eof_), so what it
    reads after does not matter there, and libavcodec's vpx_rac reads zeros
    on (the video decoder; see `range_decoder`). `sh` is the last
    decision's normalising shift, which libavcodec applies lazily."""

    __slots__ = ("buf", "start", "pos", "end", "value", "bits", "rng", "eof", "sh", "size",
                 "end_reached")

    def __init__(self, buf: bytes, start: int, size: int):
        self.buf, self.start, self.pos, self.end = buf, start, start, start + size
        self.value, self.bits, self.rng, self.eof, self.sh = 0, -8, 254, 0, 0
        self.size, self.end_reached = size, 0
        self._load()

    def _load(self) -> None:
        if self.pos < self.end:
            self.value = (self.value << 8) | self.buf[self.pos]
            self.pos += 1
        else:
            self.value <<= 8
            self.eof += 1
        self.bits += 8

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (self.rng * prob) >> 8
        if (self.value >> pos) > split:
            r = self.rng - split
            self.value -= (split + 1) << pos
            b = 1
        else:
            r = split + 1
            b = 0
        sh = self.sh = NORM[r]
        self.rng = (r << sh) - 1
        self.bits = pos - sh
        return b

    def value_bits(self, n: int) -> int:
        """VP8GetValue: n bits at probability 1/2, most significant first."""
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed_value(self, n: int) -> int:
        """VP8GetSignedValue."""
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def coeffs(br: BoolReader, probs, ctx: int, dq: tuple, n: int, out: list, base: int) -> int:
    """GetCoeffs: one block's tokens from position n on, dequantized into
    out[base + zigzag] (as libwebp's int16 coefficients); returns the
    position after the last non-zero token (n when the first is EOB)."""
    buf, end, norm = br.buf, br.end, NORM
    value, bits, rng, pos, eof, sh = br.value, br.bits, br.rng, br.pos, br.eof, br.sh
    p = probs[n][ctx]

    def get(prob):
        nonlocal value, bits, rng, pos, eof, sh
        if bits < 0:
            if pos < end:
                value = (value << 8) | buf[pos]
                pos += 1
            else:
                value <<= 8
                eof += 1
            bits += 8
        split = (rng * prob) >> 8
        if (value >> bits) > split:
            r = rng - split
            value -= (split + 1) << bits
            b = 1
        else:
            r = split + 1
            b = 0
        sh = norm[r]
        rng = (r << sh) - 1
        bits -= sh
        return b

    result = 16
    while n < 16:
        if not get(p[0]):
            result = n   # end of block
            break
        while not get(p[1]):   # a zero
            n += 1
            if n == 16:
                break
            p = probs[n][0]
        if n == 16:
            break
        if not get(p[2]):
            v = 1
            p = probs[n + 1][1]
        else:   # GetLargeValue
            if not get(p[3]):
                v = 3 + get(p[5]) if get(p[4]) else 2
            elif not get(p[6]):
                v = 7 + 2 * get(165) + get(145) if get(p[7]) else 5 + get(159)
            else:
                b1 = get(p[8])
                cat = 2 * b1 + get(p[9 + b1])
                v = 0
                for prob in CAT3456[cat]:
                    v += v + get(prob)
                v += 3 + (8 << cat)
            p = probs[n + 1][2]
        if get(0x80):
            v = -v
        v *= dq[n > 0]
        out[base + ZIGZAG[n]] = ((v + 32768) & 0xFFFF) - 32768   # int16
        n += 1
    br.value, br.bits, br.rng, br.pos, br.eof, br.sh = value, bits, rng, pos, eof, sh
    return result


def wht(dc: list) -> list:
    """TransformWHT: the 16 luma DCs of an i16 macroblock, block order."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[3 + 4 * i], tmp[1 + 4 * i] + tmp[2 + 4 * i]
        a2, a3 = tmp[1 + 4 * i] - tmp[2 + 4 * i], d - tmp[3 + 4 * i]
        out[4 * i:4 * i + 4] = ((a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3)
    return out


def _wrap16(a):
    return ((a + 32768) & 0xFFFF) - 32768


def residuals(coeffs: np.ndarray, lanes16: bool = False) -> np.ndarray:
    """TransformOne over every block, (..., 16) raster coefficients ->
    (..., 4, 4) residuals ((v >> 3), added to the prediction with a clip).
    TransformDC and TransformAC3 give the same for the blocks they take.
    With `lanes16`, libavcodec's x86 vp8_idct_add (its SSE form, which
    cv2's build runs): every sum wraps at 16 bits and MUL_35468(a) is the
    high half of 2a (wrapped) times 17734, which give the same residuals
    unless a corrupt stream's coefficients overflow 16 bits."""
    def wrap(a):
        return _wrap16(a) if lanes16 else a

    def mul1(a):   # MUL_20091
        return wrap(((a * 20091) >> 16) + a)

    def mul2(a):   # MUL_35468
        return (wrap(2 * a) * 17734) >> 16 if lanes16 else (a * 35468) >> 16

    c = coeffs.reshape(-1, 4, 4).astype(np.int64)   # [row k, column i] = in[4k + i]
    a, b = wrap(c[:, 0] + c[:, 2]), wrap(c[:, 0] - c[:, 2])
    cc = wrap(mul2(c[:, 1]) - mul1(c[:, 3]))
    d = wrap(mul1(c[:, 1]) + mul2(c[:, 3]))
    tmp = wrap(np.stack([a + d, b + cc, b - cc, a - d], 1))   # tmp[:, j, i] = C[4i + j]
    # horizontal pass: output row i reads C[4 col + i], tmp[:, i, col]
    t = tmp
    dc = wrap(t[:, :, 0] + 4)
    a, b = wrap(dc + t[:, :, 2]), wrap(dc - t[:, :, 2])
    cc = wrap(mul2(t[:, :, 1]) - mul1(t[:, :, 3]))
    d = wrap(mul1(t[:, :, 1]) + mul2(t[:, :, 3]))
    out = wrap(np.stack([a + d, b + cc, b - cc, a - d], 2)) >> 3   # [:, row i, col]
    return out.reshape(*coeffs.shape[:-1], 4, 4)


# -- VP8, lossy: reconstruction --------------------------------------------


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def pred4(mode: int, t: list, lf: list, x: int) -> list:
    """The ten 4x4 predictors of dsp/dec.c: 16 values, row-major, from the 8
    pixels above (A..H), the 4 to the left (I..L) and the corner X."""
    A, B, C, D, E, F, G, H = t
    I, J, K, L = lf
    if mode == 0:     # DC4
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == 1:     # TM4
        return [min(255, max(0, t[c] + lf[r] - x)) for r in range(4) for c in range(4)]
    if mode == 2:     # VE4
        return [_avg3(x, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == 3:     # HE4
        rows = (_avg3(x, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))
        return [v for v in rows for _ in range(4)]
    if mode == 4:     # RD4
        d = [_avg3(J, K, L), _avg3(I, J, K), _avg3(x, I, J), _avg3(A, x, I),
             _avg3(B, A, x), _avg3(C, B, A), _avg3(D, C, B)]   # by col - row + 3
        return [d[c - r + 3] for r in range(4) for c in range(4)]
    if mode == 5:     # VR4
        o = [0] * 16
        o[0] = o[9] = (x + A + 1) >> 1
        o[1] = o[10] = (A + B + 1) >> 1
        o[2] = o[11] = (B + C + 1) >> 1
        o[3] = (C + D + 1) >> 1
        o[12] = _avg3(K, J, I)
        o[8] = _avg3(J, I, x)
        o[4] = o[13] = _avg3(I, x, A)
        o[5] = o[14] = _avg3(x, A, B)
        o[6] = o[15] = _avg3(A, B, C)
        o[7] = _avg3(B, C, D)
        return o
    if mode == 6:     # LD4
        d = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]   # by col + row
        return [d[c + r] for r in range(4) for c in range(4)]
    if mode == 7:     # VL4
        o = [0] * 16
        o[0] = (A + B + 1) >> 1
        o[1] = o[8] = (B + C + 1) >> 1
        o[2] = o[9] = (C + D + 1) >> 1
        o[3] = o[10] = (D + E + 1) >> 1
        o[4] = _avg3(A, B, C)
        o[5] = o[12] = _avg3(B, C, D)
        o[6] = o[13] = _avg3(C, D, E)
        o[7] = o[14] = _avg3(D, E, F)
        o[11] = _avg3(E, F, G)
        o[15] = _avg3(F, G, H)
        return o
    if mode == 8:     # HD4
        o = [0] * 16
        o[0] = o[6] = (I + x + 1) >> 1
        o[4] = o[10] = (J + I + 1) >> 1
        o[8] = o[14] = (K + J + 1) >> 1
        o[12] = (L + K + 1) >> 1
        o[3] = _avg3(A, B, C)
        o[2] = _avg3(x, A, B)
        o[1] = o[7] = _avg3(I, x, A)
        o[5] = o[11] = _avg3(J, I, x)
        o[9] = o[15] = _avg3(K, J, I)
        o[13] = _avg3(L, K, J)
        return o
    o = [L] * 16      # HU4
    o[0] = (I + J + 1) >> 1
    o[2] = o[4] = (J + K + 1) >> 1
    o[6] = o[8] = (K + L + 1) >> 1
    o[1] = _avg3(I, J, K)
    o[3] = o[5] = _avg3(J, K, L)
    o[7] = o[9] = _avg3(K, L, L)
    return o


def pred_block(mode: int, size: int, t: list, lf: list, x: int, mb_x: int, mb_y: int) -> list:
    """The 16x16 luma or 8x8 chroma predictor (DC with CheckMode's border
    variants, TM, VE, HE): size * size values, row-major."""
    if mode == 0:
        shift = 4 if size == 16 else 3
        if mb_x and mb_y:
            v = (sum(t) + sum(lf) + size) >> (shift + 1)
        elif mb_y:    # no left
            v = (sum(t) + (size >> 1)) >> shift
        elif mb_x:    # no top
            v = (sum(lf) + (size >> 1)) >> shift
        else:
            v = 128
        return [v] * (size * size)
    if mode == 1:
        return [min(255, max(0, t[c] + lf[r] - x)) for r in range(size) for c in range(size)]
    if mode == 2:
        return list(t) * size
    return [v for v in lf for _ in range(size)]


def reconstruct(fr: dict, inter=None) -> tuple:
    """ReconstructRow over the frame: each macroblock predicted from the
    unfiltered pixels above and to the left (127 above the frame, 129 to
    its left, 127 or 129 at the corner), its residuals added with a clip.
    A macroblock with a reference frame (`ref`, the video decoder's) takes
    its prediction from inter(mb, mb_x, mb_y) instead: its (16, 16) luma
    and two (8, 8) chroma blocks. fr["lanes16"] picks libavcodec's 16-bit
    IDCT (residuals). Returns the (16 mb_h, 16 mb_w) luma and
    two (8 mb_h, 8 mb_w) chroma planes, before the loop filter; the
    macroblocks past len(fr["mbs"]) stay 0."""
    mb_w, mb_h = fr["mb_w"], fr["mb_h"]
    # (n_mb, 24, 4, 4); beyond +-256 a residual clips the sum whatever the
    # prediction, so the clip table below covers every sum
    res = np.clip(residuals(fr["coeffs"], fr.get("lanes16", False)), -256, 256)
    Y = [[0] * (16 * mb_w) for _ in range(16 * mb_h)]
    U = [[0] * (8 * mb_w) for _ in range(8 * mb_h)]
    V = [[0] * (8 * mb_w) for _ in range(8 * mb_h)]
    clip = [0] * 256 + list(range(256)) + [255] * 512   # clip[v + 256]
    for i, mb in enumerate(fr["mbs"]):
        mb_y, mb_x = divmod(i, mb_w)
        y0, x0 = 16 * mb_y, 16 * mb_x
        r = res[i].tolist()
        if mb.get("ref"):
            preds = [p.tolist() for p in inter(mb, mb_x, mb_y)]
            for plane, pred, first, size in ((Y, preds[0], 0, 16), (U, preds[1], 16, 8),
                                             (V, preds[2], 20, 8)):
                top, left, n = y0 * size // 16, x0 * size // 16, size // 4
                for j in range(size):
                    rows = r[first + n * (j >> 2):first + n * (j >> 2) + n]
                    rj = [v for blk in rows for v in blk[j & 3]]
                    plane[top + j][left:left + size] = [clip[a + b + 256]
                                                        for a, b in zip(pred[j], rj)]
            continue
        # the work area: row 0 and column 0 hold the borders
        if mb_y:
            top = Y[y0 - 1][x0:x0 + 16]
            tr = Y[y0 - 1][x0 + 16:x0 + 20] if mb_x < mb_w - 1 else [top[15]] * 4
            corner = Y[y0 - 1][x0 - 1] if mb_x else 129
        else:
            top, tr, corner = [127] * 16, [127] * 4, 127
        left = [Y[y0 + j][x0 - 1] for j in range(16)] if mb_x else [129] * 16
        if mb["i4x4"]:
            ws = [[corner] + top + tr] + [[left[j]] + [0] * 20 for j in range(16)]
            for j in (4, 8, 12):
                ws[j][17:21] = tr
            for n, mode in enumerate(mb["modes"]):
                by, bx = divmod(n, 4)
                r0, c0 = 4 * by, 4 * bx
                p = pred4(mode, ws[r0][c0 + 1:c0 + 9],
                           [ws[r0 + 1 + j][c0] for j in range(4)], ws[r0][c0])
                blk = r[n]
                for j in range(4):
                    row = ws[r0 + 1 + j]
                    rj = blk[j]
                    for k in range(4):
                        row[c0 + 1 + k] = clip[p[4 * j + k] + rj[k] + 256]
            for j in range(16):
                Y[y0 + j][x0:x0 + 16] = ws[1 + j][1:17]
        else:
            p = pred_block(mb["modes"][0], 16, top, left, corner, mb_x, mb_y)
            for j in range(16):
                rows = r[4 * (j >> 2):4 * (j >> 2) + 4]
                rj = [v for blk in rows for v in blk[j & 3]]
                Y[y0 + j][x0:x0 + 16] = [clip[a + b + 256] for a, b in
                                         zip(p[16 * j:16 * j + 16], rj)]
        cy0, cx0 = 8 * mb_y, 8 * mb_x
        for plane, first in ((U, 16), (V, 20)):
            if mb_y:
                top = plane[cy0 - 1][cx0:cx0 + 8]
                corner = plane[cy0 - 1][cx0 - 1] if mb_x else 129
            else:
                top, corner = [127] * 8, 127
            left = [plane[cy0 + j][cx0 - 1] for j in range(8)] if mb_x else [129] * 8
            p = pred_block(mb["uvmode"], 8, top, left, corner, mb_x, mb_y)
            for j in range(8):
                rows = r[first + 2 * (j >> 2):first + 2 * (j >> 2) + 2]
                rj = [v for blk in rows for v in blk[j & 3]]
                plane[cy0 + j][cx0:cx0 + 8] = [clip[a + b + 256] for a, b in
                                               zip(p[8 * j:8 * j + 8], rj)]
    return (np.array(Y, np.int32), np.array(U, np.int32), np.array(V, np.int32))


# -- VP8, lossy: the loop filter -------------------------------------------


def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip1(v):
    return np.clip(v, 0, 255)


def filter_lines(px: np.ndarray, thresh: np.ndarray, ithresh, hev_t, kind: str) -> None:
    """One edge's filter over many lines at once, in place: `px` is (n, 8),
    p3 p2 p1 p0 q0 q1 q2 q3 of each line. `kind` "simple" (SimpleVFilter16:
    DoFilter2 where NeedsFilter), "edge" (FilterLoop26: DoFilter2 on high
    edge variance, else DoFilter6) or "inner" (FilterLoop24: DoFilter2 or
    DoFilter4); thresh is the filter's, before 2 * thresh + 1."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (px[:, k] for k in range(8))
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind == "simple":
        hev = mask
    else:
        it = ithresh
        mask &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it) & (np.abs(p1 - p0) <= it)
                 & (np.abs(q3 - q2) <= it) & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0) <= it))
        hev = mask & ((np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t))
    if hev.any():   # DoFilter2
        a = 3 * (q0 - p0) + _sclip1(p1 - q1)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        new_p0, new_q0 = _clip1(p0 + a2), _clip1(q0 - a1)
        px[hev, 3], px[hev, 4] = new_p0[hev], new_q0[hev]
    if kind == "simple":
        return
    rest = mask & ~hev
    if not rest.any():
        return
    if kind == "edge":   # DoFilter6
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        new = (_clip1(p2 + a3), _clip1(p1 + a2), _clip1(p0 + a1), _clip1(q0 - a1),
               _clip1(q1 - a2), _clip1(q2 - a3))
        for k, v in zip(range(1, 7), new):
            px[rest, k] = v[rest]
    else:                # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        new = (_clip1(p1 + a3), _clip1(p0 + a2), _clip1(q0 - a1), _clip1(q1 - a3))
        for k, v in zip(range(2, 6), new):
            px[rest, k] = v[rest]


def loop_filter(fr: dict, planes: tuple) -> tuple:
    """DoFilter over every macroblock, as FinishRow runs it in raster order:
    the left macroblock edge, the three inner vertical edges (macroblocks
    with coefficients, and i4x4 ones), the top edge, the inner horizontal
    edges; chroma likewise with one inner edge, and luma only for the
    simple filter. A macroblock's filters touch its own pixels and four
    beyond its left and top edges, so the macroblocks with the same
    mb_x + 2 mb_y run together, in that order, each step over the three
    planes at once (laid out in one array: no filtered edge lies on a
    plane's border). Returns the filtered (Y, U, V)."""
    Y, U, V = planes
    ftype = fr["filter_type"]
    if ftype == 0:
        return planes
    mb_w, mb_h = fr["mb_w"], fr["mb_h"]
    hy, wc = Y.shape[0], U.shape[1]
    canvas = np.zeros((hy + U.shape[0], Y.shape[1]), np.int32)
    canvas[:hy], canvas[hy:, :wc], canvas[hy:, wc:] = Y, U, V
    # (first row, first column, macroblock size) of each plane filtered
    layout = [(0, 0, 16)] + ([(hy, 0, 8), (hy, wc, 8)] if ftype == 2 else [])
    info = np.array([mb["filter"] for mb in fr["mbs"]], np.int64).reshape(mb_h, mb_w, 4)
    ys, xs = np.mgrid[0:mb_h, 0:mb_w]
    wave = (xs + 2 * ys).reshape(-1)
    order = np.argsort(wave, kind="stable")
    bounds = np.searchsorted(wave[order], np.arange(wave.max() + 2))
    offs = np.arange(-4, 4)
    kind_edge, kind_inner = ("simple", "simple") if ftype == 1 else ("edge", "inner")
    for t in range(len(bounds) - 1):
        sel = order[bounds[t]:bounds[t + 1]]
        my, mx = sel // mb_w, sel % mb_w
        limit, ilevel, hev_t, inner = (info[my, mx, k] for k in range(4))
        on = limit > 0
        if not on.any():
            continue
        my, mx, limit, ilevel, hev_t, inner = (a[on] for a in (my, mx, limit, ilevel, hev_t,
                                                             inner.astype(bool)))
        steps = [("h", 0, mx > 0, limit + 4, kind_edge)]
        steps += [("h", d, inner, limit, kind_inner) for d in (4, 8, 12)]
        steps += [("v", 0, my > 0, limit + 4, kind_edge)]
        steps += [("v", d, inner, limit, kind_inner) for d in (4, 8, 12)]
        for axis, d, use, thresh, kind in steps:
            if not use.any():
                continue
            rows, cols, params = [], [], []
            for r0, c0, size in layout:
                if d >= size:
                    continue
                span = np.arange(size)
                y0, x0 = r0 + size * my[use], c0 + size * mx[use]
                if axis == "h":   # a vertical edge at x0 + d: lines along rows
                    rows.append((y0[:, None] + span).reshape(-1))
                    cols.append(np.repeat(x0 + d, size))
                else:             # a horizontal edge at y0 + d: lines down columns
                    rows.append(np.repeat(y0 + d, size))
                    cols.append((x0[:, None] + span).reshape(-1))
                params.append([np.repeat(a[use], size) for a in (thresh, ilevel, hev_t)])
            rows, cols = np.concatenate(rows), np.concatenate(cols)
            if axis == "h":
                rr, cc = rows[:, None], cols[:, None] + offs
            else:
                rr, cc = rows[:, None] + offs, cols[:, None]
            px = canvas[rr, cc]
            filter_lines(px, *(np.concatenate(p) for p in zip(*params)), kind)
            canvas[rr, cc] = px
    return canvas[:hy], canvas[hy:, :wc], canvas[hy:, wc:]


# -- the shared mode and token parse ----------------------------------------

KEY_YMODE_PROBA = (145, 156, 163, 128)    # kf_ymode_prob
KEY_UVMODE_PROBA = (142, 114, 183)        # kf_uv_mode_prob


def key_intra_modes(br: BoolReader, top: list, left: list) -> tuple:
    """A key frame's luma modes (ParseIntraMode): (i4x4, modes), one 16x16
    mode (0 DC, 1 TM, 2 V, 3 H) or the 16 sub-block modes; `top` and
    `left`, the four sub-block modes above and to the left, are updated in
    place (a 16x16 mode stands for its sub-block mode)."""
    if br.bit(KEY_YMODE_PROBA[0]):
        ymode = ((1 if br.bit(KEY_YMODE_PROBA[3]) else 3) if br.bit(KEY_YMODE_PROBA[1])
                 else (2 if br.bit(KEY_YMODE_PROBA[2]) else 0))
        top[:] = [ymode] * 4
        left[:] = [ymode] * 4
        return False, [ymode]
    modes = [0] * 16
    for y in range(4):
        ym = left[y]
        for x in range(4):
            prob = BMODES_PROBA[top[x], ym]
            i = YMODES_INTRA4[br.bit(int(prob[0]))]
            while i > 0:
                i = YMODES_INTRA4[2 * i + br.bit(int(prob[i]))]
            ym = -i
            top[x] = ym
            modes[4 * y + x] = ym
        left[y] = ym
    return True, modes


def uv_mode(br: BoolReader, prob) -> int:
    """The chroma mode tree: 0 DC, 2 V, 3 H, 1 TM."""
    return 0 if not br.bit(prob[0]) else 2 if not br.bit(prob[1]) else 1 if br.bit(prob[2]) else 3


def mb_coeffs(br: BoolReader, out: list, base: int, bands: list, q: dict, y2: bool,
              top: list, left: list, block=None) -> tuple:
    """One macroblock's tokens (ParseResiduals, decode_mb_coeffs): the Y2
    block when `y2` (its WHT spread over the luma DCs), 16 luma and 8
    chroma blocks, dequantised into out[base:base + 384]. `top` and
    `left` hold the non-zero contexts ([4 luma + 2 u + 2 v bits, the Y2
    bit]) and are updated in place. Returns (libwebp's non-zero flag,
    libavcodec's nnz_total: the sum of each block's end position, 0 where
    its first token ends it). `block` stands for `coeffs`, each block's
    token decode."""
    coeffs_ = block or coeffs
    non_zero, total = False, 0
    if y2:
        dc = [0] * 16
        nz = coeffs_(br, bands[1], top[1] + left[1], q["y2"], 0, dc, 0)
        top[1] = left[1] = int(nz > 0)
        total += nz
        for i, v in enumerate(wht(dc) if nz > 1 else [(dc[0] + 3) >> 3] * 16):
            out[base + 16 * i] = ((v + 32768) & 0xFFFF) - 32768
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    tnz = top[0] & 0x0F
    lnz = left[0] & 0x0F
    for y in range(4):
        lb = lnz & 1
        for x in range(4):
            k = base + 16 * (4 * y + x)
            nz = coeffs_(br, ac, lb + (tnz & 1), q["y1"], first, out, k)
            lb = int(nz > first)
            tnz = (tnz >> 1) | (lb << 7)
            non_zero |= nz > 1 or out[k] != 0
            total += nz if nz > first else 0
        tnz >>= 4
        lnz = (lnz >> 1) | (lb << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz = top[0] >> (4 + ch)
        lnz = left[0] >> (4 + ch)
        for y in range(2):
            lb = lnz & 1
            for x in range(2):
                k = base + 256 + 16 * (2 * ch + 2 * y + x)
                nz = coeffs_(br, bands[2], lb + (tnz & 1), q["uv"], 0, out, k)
                lb = int(nz > 0)
                tnz = (tnz >> 1) | (lb << 3)
                non_zero |= nz > 1 or out[k] != 0
                total += nz
            tnz >>= 2
            lnz = (lnz >> 1) | (lb << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    top[0], left[0] = out_t, out_l
    return non_zero, total


def quantizers(q: int, deltas: list) -> dict:
    """A segment's dequantisation factors (VP8ParseQuant, vp8_get_quants)
    from its base index and the five deltas (y1 DC, y2 DC, y2 AC, uv DC, uv
    AC): (DC, AC) of each block type."""
    def clip(v, hi):
        return 0 if v < 0 else hi if v > hi else v

    y2_ac = (AC_TABLE[clip(q + deltas[2], 127)] * 101581) >> 16
    return dict(y1=(DC_TABLE[clip(q + deltas[0], 127)], AC_TABLE[clip(q, 127)]),
                y2=(DC_TABLE[clip(q + deltas[1], 127)] * 2, max(8, y2_ac)),
                uv=(DC_TABLE[clip(q + deltas[3], 117)], AC_TABLE[clip(q + deltas[4], 127)]))


def token_bands(proba) -> list:
    """The (4, 8, 3, 11) band probabilities as [type][position 0-16][ctx]."""
    proba = np.asarray(proba)
    return [[proba[t, BANDS[n]].tolist() for n in range(17)] for t in range(4)]


# -- the video decoder: tables (RFC 6386, libavcodec's vp8data.h) -----------

START_CODE = b"\x9d\x01\x2a"
# reference frames and macroblock modes as libavcodec numbers them (the
# 16x16 intra modes 0-3 in libwebp's order, as above)
NONE, CURRENT, PREVIOUS, GOLDEN, ALTREF = -1, 0, 1, 2, 3
MODE_BPRED, MODE_ZERO, MODE_MV, MODE_SPLIT = 4, 5, 6, 7   # MODE_MV: NEAREST, NEAR or NEW
SPLIT_16x8, SPLIT_8x16, SPLIT_8x8, SPLIT_4x4, SPLIT_NONE = 0, 1, 2, 3, 4
YMODE_PROBA = (112, 86, 140, 37)          # vp8_pred16x16_prob_inter
UVMODE_PROBA = (162, 101, 204)            # vp8_pred8x8c_prob_inter
BMODE_PROBA = (120, 90, 79, 133, 87, 85, 80, 111, 151)   # B_mode_prob, inter frames
MV_PROBA = ((162, 128, 225, 146, 172, 147, 214, 39, 156,
             128, 129, 132, 75, 145, 178, 206, 239, 254, 254),
            (164, 128, 204, 170, 119, 235, 140, 230, 228,
             128, 130, 130, 74, 148, 180, 203, 236, 254, 254))   # row, column
MV_UPDATE_PROBA = ((237, 246, 253, 253, 254, 254, 254, 254, 254,
                    254, 254, 254, 254, 254, 250, 250, 252, 254, 254),
                   (231, 243, 245, 253, 254, 254, 254, 254, 254,
                    254, 254, 254, 254, 254, 251, 251, 254, 254, 254))
MODE_CONTEXTS = ((7, 1, 1, 143), (14, 18, 14, 107), (135, 64, 57, 68), (60, 56, 128, 65),
                 (159, 134, 128, 34), (234, 188, 128, 28))
SUBMV_PROBA = ((147, 136, 18), (106, 145, 1), (179, 121, 1), (223, 1, 34), (208, 1, 1))
SPLIT_PROBA = (110, 111, 150)
MBSPLITS = ((0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1),
            (0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1),
            (0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3),
            tuple(range(16)),
            (0,) * 16)
MBFIRSTIDX = ((0, 8), (0, 2), (0, 2, 8, 10), tuple(range(16)))
SUBPEL_FILTERS = ((0, 6, 123, 12, 1, 0), (2, 11, 108, 36, 8, 1), (0, 9, 93, 50, 6, 0),
                  (3, 16, 77, 77, 16, 3), (0, 6, 50, 93, 9, 0), (1, 8, 36, 108, 11, 2),
                  (0, 1, 12, 123, 6, 0))   # taps 1 and 4 negative
# hev_thresh by filter level: key frames, inter frames
HEV_KEY = tuple(2 if v >= 40 else 1 if v >= 15 else 0 for v in range(64))
HEV_INTER = tuple(3 if v >= 40 else 2 if v >= 20 else 1 if v >= 15 else 0 for v in range(64))
MARGIN = 16 << 2     # how far past the frame a clamped vector may point, quarter pixels
_ZERO_MV = (0, 0)
_OUTSIDE = dict(ref=CURRENT, mode=0, mv=_ZERO_MV, bmv=[_ZERO_MV] * 16, part=SPLIT_16x8)


def range_decoder(data: bytes, start: int, size: int) -> BoolReader:
    """ff_vpx_init_range_decoder over data[start:start + size]: its first
    three bytes and then two at a time while any of the size is left, so
    the bytes it reads run to an odd count past the size's end (the next
    bytes of the frame, or the zero padding after the frame), zeros after
    them. Vp8Error for an empty partition, which libavcodec refuses."""
    if size < 1:
        raise Vp8Error("an empty partition")
    n = 3 if size <= 3 else 3 + 2 * ((size - 2) // 2)
    r = BoolReader(data, start, max(0, min(start + n, len(data)) - start))
    r.size = n
    return r


def rac_is_end(r: BoolReader) -> bool:
    """vpx_rac_is_end: counts the calls made once every byte is read and
    its bits are used (the decisions' shifts, the last one pending as
    libavcodec leaves it), true from the eleventh."""
    used = 8 * (r.pos - r.start + r.eof) - 8 - r.bits - r.sh
    if used >= 8 * r.size - 8:
        r.end_reached += 1
    return r.end_reached > 10


def read_mv(br: BoolReader, p) -> int:
    """read_mv_component: the short tree or the long form, then the sign."""
    if br.bit(p[0]):
        x = 0
        for i in range(3):
            x += br.bit(p[9 + i]) << i
        for i in range(9, 3, -1):
            x += br.bit(p[9 + i]) << i
        if not x & 0xFFF0 or br.bit(p[12]):
            x += 8
    else:
        b = br.bit(p[2])
        j, x = 3 + 3 * b, 4 * b
        b = br.bit(p[j])
        j, x = j + 1 + b, x + 2 * b
        x += br.bit(p[j])
    return -x if x and br.bit(p[1]) else x


def _submv_proba(left: tuple, above: tuple) -> tuple:
    if left == above:
        return SUBMV_PROBA[4 - (left != _ZERO_MV)]
    if above == _ZERO_MV:
        return SUBMV_PROBA[2]
    return SUBMV_PROBA[1 - (left != _ZERO_MV)]


def _filter(s: np.ndarray, f: int, n: int, axis: int, bilinear: bool) -> np.ndarray:
    """The sub-pixel filter at eighth position f along `axis` of a patch
    whose first two samples precede the block's: n outputs."""
    def tap(k):
        return s[:, 2 + k:2 + k + n] if axis else s[2 + k:2 + k + n]

    if bilinear:
        return ((8 - f) * tap(0) + f * tap(1) + 4) >> 3
    t = SUBPEL_FILTERS[f - 1]
    v = (t[0] * tap(-2) - t[1] * tap(-1) + t[2] * tap(0) + t[3] * tap(1) - t[4] * tap(2)
         + t[5] * tap(3))
    return np.clip((v + 64) >> 7, 0, 255)


def motion_block(plane: np.ndarray, x: int, y: int, bw: int, bh: int, mv: tuple,
                 luma: bool, bilinear: bool) -> np.ndarray:
    """vp8_mc_luma / vp8_mc_chroma: the (bh, bw) prediction at (x, y) moved
    by mv ((row, column) in quarter luma pixels, which are eighths of a
    chroma pixel), six-tap (horizontal first, each pass rounded and
    clipped) or bilinear, the plane's edges extended without end."""
    mvy, mvx = mv
    if luma:
        fx, fy, x, y = (mvx * 2) & 7, (mvy * 2) & 7, x + (mvx >> 2), y + (mvy >> 2)
    else:
        fx, fy, x, y = mvx & 7, mvy & 7, x + (mvx >> 3), y + (mvy >> 3)
    h, w = plane.shape
    rows = np.clip(np.arange(y - 2, y + bh + 3), 0, h - 1)
    cols = np.clip(np.arange(x - 2, x + bw + 3), 0, w - 1)
    s = plane[rows[:, None], cols]
    s = _filter(s, fx, bw, 1, bilinear) if fx else s[:, 2:2 + bw]
    return _filter(s, fy, bh, 0, bilinear) if fy else s[2:2 + bh]


# -- the video decoder ---------------------------------------------------------


class Vp8Decoder:
    """Decode the frames of one VP8 stream in order (see the module
    docstring). device "cuda" runs csrc/vp8_decode.cu's host C++ decoder
    (built with nvcc at first use; a failed build raises) and "cpu" this
    module's; either keeps its references in its own state."""

    def __init__(self, device: str = "cpu"):
        self.device = torch.device(device)
        self._c = _CDecoder() if self.device.type == "cuda" else None
        self.width = self.height = self.mb_w = self.mb_h = 0
        self.refs = [None] * 4         # by CURRENT..ALTREF: (Y, U, V) int32, macroblock-aligned
        self.prev_seg = None           # the segment map of the frame decoded before
        self.sign_bias = [0] * 4
        self.full_range = 0            # the last key frame's clamping bit
        self._reset()

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    def _reset(self) -> None:
        """A key frame's resets (vp78_reset_probability_tables and the
        defaults of the y-mode, uv-mode and MV probabilities, segmentation
        and the loop-filter deltas zeroed)."""
        self.prob = dict(token=COEFFS_PROBA0.astype(np.int64).copy(), ymode=list(YMODE_PROBA),
                         uvmode=list(UVMODE_PROBA), mv=[list(p) for p in MV_PROBA])
        self.seg = dict(enabled=0, update_map=0, absolute=0, quant=[0] * 4, lf=[0] * 4)
        self.lf_delta = dict(enabled=0, ref=[0] * 4, mode=[0] * 4)

    def decode(self, frame: bytes):
        """(Y, U, V) uint8 planes of a shown frame, None for a hidden one;
        Vp8Error where libavcodec refuses the frame."""
        if self._c is not None:
            return self._c.decode(bytes(frame))
        return self._decode_plain(bytes(frame))

    def range(self) -> bool:
        """Whether the frames are full range (the last key frame's clamping
        bit, which libavcodec reads as AVCOL_RANGE_JPEG and cv2 converts
        with full-range coefficients): yuv420_to_rgb's `full_range`."""
        if self._c is not None:
            return self._c.full_range()
        return bool(self.full_range)

    # the parse's readers and token decode, which a stream writer replaces
    def _bool(self, data: bytes, start: int, size: int) -> BoolReader:
        return range_decoder(data, start, size)

    def _is_end(self, r: BoolReader) -> bool:
        return rac_is_end(r)

    def _coeffs(self, br, out, base, bands, q, y2, top, left) -> int:
        return mb_coeffs(br, out, base, bands, q, y2, top, left)[1]

    def _partitions(self, data: bytes, pos: int, size: int, n: int) -> list:
        """setup_partitions: the sizes of the first n - 1 (3 bytes each),
        the last taking the rest."""
        at = pos
        pos, size = pos + 3 * (n - 1), size - 3 * (n - 1)
        if size < 0:
            raise Vp8Error(f"the sizes of {n} token partitions run past the frame")
        parts = []
        for i in range(n - 1):
            s = data[at + 3 * i] | data[at + 3 * i + 1] << 8 | data[at + 3 * i + 2] << 16
            if size - s < 0:
                raise Vp8Error(f"token partition {i} of {s} bytes runs past the frame")
            parts.append(self._bool(data, pos, s))
            pos, size = pos + s, size - s
        parts.append(self._bool(data, pos, size))
        return parts

    def _decode_plain(self, data: bytes):
        n = len(data)
        if n < 3:
            raise Vp8Error(f"a frame of {n} bytes, short of its tag")
        tag = data[0] | data[1] << 8 | data[2] << 16
        key, profile, show, part0 = not tag & 1, (tag >> 1) & 7, (tag >> 4) & 1, tag >> 5
        pos, size = 3, n - 3
        if part0 > size - 7 * key:
            raise Vp8Error(f"a first partition of {part0} bytes in a frame of {n}")
        width, height = self.width, self.height
        if key:
            if data[3:6] != START_CODE:
                raise Vp8Error(f"a key frame's start code {data[3:6].hex()}, not 9d012a")
            width = (data[6] | data[7] << 8) & 0x3FFF
            height = (data[8] | data[9] << 8) & 0x3FFF
            pos, size = 10, n - 10
            self._reset()
        br = self._bool(data, pos, part0)
        pos, size = pos + part0, size - part0
        if key:
            br.bit(128)   # colour space
            self.full_range = br.bit(128)   # the clamping type, libavcodec's colour range
        seg = self.seg
        seg["enabled"] = br.bit(128)
        seg_proba = [255] * 3
        if seg["enabled"]:
            seg["update_map"] = br.bit(128)
            if br.bit(128):   # update the segments' data
                seg["absolute"] = br.bit(128)
                seg["quant"] = [br.signed_value(7) if br.bit(128) else 0 for _ in range(4)]
                seg["lf"] = [br.signed_value(6) if br.bit(128) else 0 for _ in range(4)]
            if seg["update_map"]:
                seg_proba = [br.value_bits(8) if br.bit(128) else 255 for _ in range(3)]
        else:
            seg["update_map"] = 0
        simple, level, sharpness = br.bit(128), br.value_bits(6), br.value_bits(3)
        lfd = self.lf_delta
        lfd["enabled"] = br.bit(128)
        if lfd["enabled"] and br.bit(128):
            for deltas in (lfd["ref"], lfd["mode"]):
                for i in range(4):
                    if br.bit(128):
                        deltas[i] = br.signed_value(6)
        n_parts = 1 << br.value_bits(2)
        parts = self._partitions(data, pos, size, n_parts)
        if not self.mb_w or width != self.width or height != self.height:
            if self.mb_w:
                raise Vp8Unsupported(f"a key frame of {width}x{height} after frames of "
                                     f"{self.width}x{self.height}: cv2 returns it at the "
                                     "first size; the port refuses a change of size")
            # vp8_update_dimensions: every reference dropped
            self.refs, self.prev_seg = [None] * 4, None
            if not width or not height:
                raise Vp8Error(f"a frame of {width}x{height}")
            self.width, self.height = width, height
            self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4
        base_q = br.value_bits(7)
        deltas = [br.signed_value(4) if br.bit(128) else 0 for _ in range(5)]
        quant = []
        for s in range(4):
            q = (seg["quant"][s] + (0 if seg["absolute"] else base_q)) if seg["enabled"] else base_q
            quant.append(quantizers(q, deltas))
        update_golden = update_altref = CURRENT
        if not key:
            refresh_golden, refresh_altref = br.bit(128), br.bit(128)
            if not refresh_golden:
                update_golden = {1: PREVIOUS, 2: ALTREF}.get(br.value_bits(2), NONE)
            if not refresh_altref:
                update_altref = {1: PREVIOUS, 2: GOLDEN}.get(br.value_bits(2), NONE)
            self.sign_bias[GOLDEN] = br.bit(128)
            self.sign_bias[ALTREF] = br.bit(128)
        keep_probs = br.bit(128)
        saved = None if keep_probs else copy.deepcopy(self.prob)
        update_last = key or br.bit(128)
        token = self.prob["token"]
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for p in range(11):
                        if br.bit(int(COEFFS_UPDATE_PROBA[t, b, c, p])):
                            token[t, b, c, p] = br.value_bits(8)
        skip_p = br.value_bits(8) if br.bit(128) else None
        if not key:
            p_intra, p_last, p_golden = br.value_bits(8), br.value_bits(8), br.value_bits(8)
            if br.bit(128):
                self.prob["ymode"] = [br.value_bits(8) for _ in range(4)]
            if br.bit(128):
                self.prob["uvmode"] = [br.value_bits(8) for _ in range(3)]
            for i in range(2):
                for j in range(19):
                    if br.bit(MV_UPDATE_PROBA[i][j]):
                        v = br.value_bits(7) << 1
                        self.prob["mv"][i][j] = v or 1
        prev_seg, self.prev_seg = self.prev_seg, None
        fr = dict(key=key, profile=profile, skip_p=skip_p, seg_proba=seg_proba, quant=quant,
                  level=level, sharpness=sharpness, bands=token_bands(token))
        if not key:
            fr.update(p_intra=p_intra, p_last=p_last, p_golden=p_golden)
        mbs, coeff, seg_map, rows = self._macroblocks(br, parts, fr, prev_seg)
        mb_w, mb_h = self.mb_w, self.mb_h
        planes = reconstruct(dict(mb_w=mb_w, mb_h=mb_h, mbs=mbs, lanes16=True,
                                  coeffs=np.array(coeff, np.int32).reshape(-1, 24, 16)),
                             lambda mb, x, y: self._predict(mb, x, y, profile))
        off = dict(filter=(0, 0, 0, False))
        filt = [mb if i < rows * mb_w else off for i, mb in enumerate(mbs)]
        filt += [off] * (mb_w * mb_h - len(filt))
        planes = loop_filter(dict(mb_w=mb_w, mb_h=mb_h, mbs=filt,
                                  filter_type=0 if level == 0 else 1 if simple else 2), planes)
        old = self.refs
        old[CURRENT] = planes
        self.refs = [planes, planes if update_last else old[PREVIOUS],
                     old[update_golden] if update_golden != NONE else old[GOLDEN],
                     old[update_altref] if update_altref != NONE else old[ALTREF]]
        self.prev_seg = seg_map
        if saved is not None:
            self.prob = saved
        if not show:
            return None
        return self._cropped(planes)

    def _cropped(self, planes) -> tuple:
        """The frame's (Y, U, V) uint8 planes cut to its size."""
        h, w = self.height, self.width
        ch, cw = (h + 1) >> 1, (w + 1) >> 1
        return (planes[0][:h, :w].astype(np.uint8), planes[1][:ch, :cw].astype(np.uint8),
                planes[2][:ch, :cw].astype(np.uint8))

    def _macroblocks(self, br, parts, fr, prev_seg) -> tuple:
        """Every macroblock's modes (partition 0) and tokens (the row's
        token partition) in raster order, rac_is_end checked on partition 0
        at each row's start and on both partitions at each macroblock's
        (libavcodec's checks, as a corrupt stream's stops on cv2 show).
        Returns (the macroblocks decoded, the coefficients, the segment
        map, the rows decoded whole)."""
        mb_w, mb_h = self.mb_w, self.mb_h
        n_mb = mb_w * mb_h
        coeff = [0] * (n_mb * 384)
        seg_map = [0] * n_mb
        mbs = []
        top_nz = [[0, 0] for _ in range(mb_w)]
        intra_t = [0] * (4 * mb_w)
        for mb_y in range(mb_h):
            if self._is_end(br):
                return mbs, coeff, seg_map, mb_y
            cr = parts[mb_y & (len(parts) - 1)]
            left_nz = [0, 0]
            intra_l = [0] * 4
            for mb_x in range(mb_w):
                if self._is_end(br) or self._is_end(cr):
                    return mbs, coeff, seg_map, mb_y
                i = mb_y * mb_w + mb_x
                mb = self._mb_mode(br, fr, i, mb_x, mb_y, mbs, intra_t, intra_l, prev_seg)
                seg_map[i] = mb["segment"]
                y2 = mb["mode"] not in (MODE_BPRED, MODE_SPLIT)
                if not mb["skip"]:
                    total = self._coeffs(cr, coeff, 384 * i, fr["bands"],
                                         fr["quant"][mb["segment"]], y2, top_nz[mb_x], left_nz)
                    mb["skip"] = int(total == 0)
                else:
                    top_nz[mb_x][0] = left_nz[0] = 0
                    if y2:
                        top_nz[mb_x][1] = left_nz[1] = 0
                mb["filter"] = self._filter_strength(mb, fr)
                mbs.append(mb)
        return mbs, coeff, seg_map, mb_h

    def _mb_mode(self, br, fr, i, mb_x, mb_y, mbs, intra_t, intra_l, prev_seg) -> dict:
        """decode_mb_mode: segment, skip flag, reference, modes, vectors."""
        seg = self.seg
        if seg["update_map"]:
            b = br.bit(fr["seg_proba"][0])
            segment = br.bit(fr["seg_proba"][1 + b]) + 2 * b
        elif seg["enabled"] and prev_seg is not None:
            segment = prev_seg[i]
        else:
            segment = 0
        skip = br.bit(fr["skip_p"]) if fr["skip_p"] is not None else 0
        mb = dict(segment=segment, skip=skip, ref=CURRENT, mv=_ZERO_MV, bmv=[_ZERO_MV],
                  part=SPLIT_NONE)
        if fr["key"]:
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            i4x4, modes = key_intra_modes(br, top, intra_l)
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            mb.update(i4x4=i4x4, modes=modes, mode=MODE_BPRED if i4x4 else modes[0],
                      uvmode=uv_mode(br, KEY_UVMODE_PROBA))
        elif br.bit(fr["p_intra"]):
            mb["ref"] = (ALTREF if br.bit(fr["p_golden"]) else GOLDEN) if br.bit(fr["p_last"]) \
                else PREVIOUS
            mb.update(i4x4=False, modes=[0], uvmode=0)
            self._mvs(br, mb, mb_x, mb_y, mbs)
        else:
            p = self.prob["ymode"]
            if not br.bit(p[0]):
                ymode = 0
            elif not br.bit(p[1]):
                ymode = 3 if br.bit(p[2]) else 2
            else:
                ymode = MODE_BPRED if br.bit(p[3]) else 1
            modes = [ymode]
            if ymode == MODE_BPRED:
                modes = []
                for _ in range(16):
                    k = YMODES_INTRA4[br.bit(BMODE_PROBA[0])]
                    while k > 0:
                        k = YMODES_INTRA4[2 * k + br.bit(BMODE_PROBA[k])]
                    modes.append(-k)
            mb.update(i4x4=ymode == MODE_BPRED, modes=modes, mode=ymode,
                      uvmode=uv_mode(br, self.prob["uvmode"]))
        return mb

    def _mvs(self, br, mb, mb_x, mb_y, mbs) -> None:
        """vp8_decode_mvs: the mode and vector(s) of an inter macroblock."""
        mb_w = self.mb_w
        top = mbs[-mb_w] if mb_y else _OUTSIDE
        left = mbs[-1] if mb_x else _OUTSIDE
        top_left = mbs[-mb_w - 1] if mb_x and mb_y else _OUTSIDE
        near, cnt, idx = [_ZERO_MV] * 4, [0] * 4, 0
        bias = self.sign_bias[mb["ref"]]
        for n, edge in enumerate((top, left, top_left)):
            if edge["ref"] == CURRENT:
                continue
            mv = edge["mv"]
            weight = 1 if n == 2 else 2
            if mv != _ZERO_MV:
                if bias != self.sign_bias[edge["ref"]]:
                    mv = (-mv[0], -mv[1])
                if not n or mv != near[idx]:
                    idx += 1
                    near[idx] = mv
                cnt[idx] += weight
            else:
                cnt[0] += weight
        if not br.bit(MODE_CONTEXTS[cnt[0]][0]):
            mb.update(mode=MODE_ZERO, mv=_ZERO_MV, bmv=[_ZERO_MV])
            return
        mb["mode"] = MODE_MV
        if cnt[3] and near[1] == near[3]:
            cnt[1] += 1
        if cnt[2] > cnt[1]:
            cnt[1], cnt[2] = cnt[2], cnt[1]
            near[1], near[2] = near[2], near[1]
        lo_x, hi_x = -MARGIN - 64 * mb_x, ((self.mb_w - 1 - mb_x) << 6) + MARGIN
        lo_y, hi_y = -MARGIN - 64 * mb_y, ((self.mb_h - 1 - mb_y) << 6) + MARGIN

        def clamp(mv):
            return (min(max(mv[0], lo_y), hi_y), min(max(mv[1], lo_x), hi_x))

        if not br.bit(MODE_CONTEXTS[cnt[1]][1]):
            mv = clamp(near[1])
        elif not br.bit(MODE_CONTEXTS[cnt[2]][2]):
            mv = clamp(near[2])
        else:
            best = clamp(near[1 if cnt[1] >= cnt[0] else 0])
            splits = ((left["mode"] == MODE_SPLIT) + (top["mode"] == MODE_SPLIT)) * 2 + (
                top_left["mode"] == MODE_SPLIT)
            if br.bit(MODE_CONTEXTS[splits][3]):
                self._split(br, mb, best, top, left)
                return
            mv = (best[0] + read_mv(br, self.prob["mv"][0]),
                  best[1] + read_mv(br, self.prob["mv"][1]))
        mb.update(mv=mv, bmv=[mv])

    def _split(self, br, mb, best, top, left) -> None:
        """decode_splitmvs: the partitioning and each part's vector."""
        if br.bit(SPLIT_PROBA[0]):
            part = SPLIT_16x8 + br.bit(SPLIT_PROBA[2]) if br.bit(SPLIT_PROBA[1]) else SPLIT_8x8
        else:
            part = SPLIT_4x4
        cur = MBSPLITS[part]
        bmv = []
        for k in MBFIRSTIDX[part]:
            lmv = left["bmv"][MBSPLITS[left["part"]][k + 3]] if not k & 3 else bmv[cur[k - 1]]
            amv = top["bmv"][MBSPLITS[top["part"]][k + 12]] if k <= 3 else bmv[cur[k - 4]]
            p = _submv_proba(lmv, amv)
            if not br.bit(p[0]):
                bmv.append(lmv)
            elif not br.bit(p[1]):
                bmv.append(amv)
            elif not br.bit(p[2]):
                bmv.append(_ZERO_MV)
            else:
                bmv.append((best[0] + read_mv(br, self.prob["mv"][0]),
                            best[1] + read_mv(br, self.prob["mv"][1])))
        mb.update(mode=MODE_SPLIT, part=part, bmv=bmv, mv=bmv[-1])

    def _filter_strength(self, mb, fr) -> tuple:
        """filter_level_for_mb: (limit, interior limit, hev threshold,
        inner edges) of the loop filter, (0, 0, 0, False) for none."""
        seg, lfd = self.seg, self.lf_delta
        level = fr["level"]
        if seg["enabled"]:
            level = seg["lf"][mb["segment"]] + (0 if seg["absolute"] else level)
        if lfd["enabled"]:
            level += lfd["ref"][mb["ref"]]
            if mb["mode"] >= MODE_BPRED:
                level += lfd["mode"][mb["mode"] - MODE_BPRED]
        level = min(max(level, 0), 63)
        if not level:
            return 0, 0, 0, False
        interior = level
        if fr["sharpness"]:
            interior >>= (fr["sharpness"] + 3) >> 2
            interior = min(interior, 9 - fr["sharpness"])
        interior = max(interior, 1)
        hev = (HEV_KEY if fr["key"] else HEV_INTER)[level]
        inner = not mb["skip"] or mb["mode"] in (MODE_BPRED, MODE_SPLIT)
        return 2 * level + interior, interior, hev, inner

    def _predict(self, mb, mb_x, mb_y, profile) -> tuple:
        """inter_predict: the macroblock's (16, 16) luma and (8, 8) chroma
        predictions from its reference frame."""
        ref = self.refs[mb["ref"]]
        bilinear, full_pel = profile != 0, profile == 3
        x0, y0 = 16 * mb_x, 16 * mb_y
        py = np.empty((16, 16), np.int64)
        pu, pv = np.empty((8, 8), np.int64), np.empty((8, 8), np.int64)

        def chroma(bx, by, bw, bh, mv):
            if full_pel:
                mv = (mv[0] & ~7, mv[1] & ~7)
            for pred, plane in ((pu, ref[1]), (pv, ref[2])):
                pred[by:by + bh, bx:bx + bw] = motion_block(plane, x0 // 2 + bx, y0 // 2 + by,
                                                            bw, bh, mv, False, bilinear)

        part, bmv = mb["part"], mb["bmv"]
        if part == SPLIT_4x4:
            for n in range(16):
                by, bx = 4 * (n >> 2), 4 * (n & 3)
                py[by:by + 4, bx:bx + 4] = motion_block(ref[0], x0 + bx, y0 + by, 4, 4, bmv[n],
                                                        True, bilinear)
            for y in range(2):
                for x in range(2):
                    k = 8 * y + 2 * x
                    sums = [sum(bmv[j][c] for j in (k, k + 1, k + 4, k + 5)) for c in (0, 1)]
                    mv = tuple((s + 2 + (-1 if s < 0 else 0)) >> 2 for s in sums)
                    chroma(4 * x, 4 * y, 4, 4, mv)
            return py, pu, pv
        blocks = {SPLIT_NONE: ((0, 0, 16, 16),), SPLIT_16x8: ((0, 0, 16, 8), (0, 8, 16, 8)),
                  SPLIT_8x16: ((0, 0, 8, 16), (8, 0, 8, 16)),
                  SPLIT_8x8: ((0, 0, 8, 8), (8, 0, 8, 8), (0, 8, 8, 8), (8, 8, 8, 8))}[part]
        for (bx, by, bw, bh), mv in zip(blocks, bmv):
            py[by:by + bh, bx:bx + bw] = motion_block(ref[0], x0 + bx, y0 + by, bw, bh, mv,
                                                      True, bilinear)
            chroma(bx // 2, by // 2, bw // 2, bh // 2, mv)
        return py, pu, pv


# -- the host C++ decoder -------------------------------------------------------

def _lib():
    import ctypes

    from vision_kit_tpu_torch import _cuda_build

    lib = _cuda_build.load("vp8_decode")
    ptr, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.vk_vp8_create.argtypes, lib.vk_vp8_create.restype = [], ptr
    lib.vk_vp8_destroy.argtypes, lib.vk_vp8_destroy.restype = [ptr], None
    lib.vk_vp8_decode.argtypes = [ptr, ctypes.c_char_p, ctypes.c_size_t, ip, ip]
    lib.vk_vp8_decode.restype = ctypes.c_int
    lib.vk_vp8_planes.argtypes, lib.vk_vp8_planes.restype = [ptr, ptr, ptr, ptr], None
    lib.vk_vp8_error.argtypes, lib.vk_vp8_error.restype = [ptr], ctypes.c_char_p
    lib.vk_vp8_full_range.argtypes, lib.vk_vp8_full_range.restype = [ptr], ctypes.c_int
    lib.vk_vp8_calls.argtypes, lib.vk_vp8_calls.restype = [], ctypes.c_longlong
    return lib


def c_calls() -> int:
    """How many frames the host C++ decoder has taken in this process (its
    own count)."""
    return int(_lib().vk_vp8_calls())


class _CDecoder:
    """csrc/vp8_decode.cu's decoder state (nvcc-built at first use, loaded
    with ctypes); RuntimeError when it cannot be built or loaded, Vp8Error
    with the plain decoder's message on a refusal."""

    def __init__(self):
        self.lib = _lib()
        self.handle = self.lib.vk_vp8_create()

    def decode(self, data: bytes):
        import ctypes

        w, h = ctypes.c_int(0), ctypes.c_int(0)
        status = self.lib.vk_vp8_decode(self.handle, data, len(data), ctypes.byref(w),
                                        ctypes.byref(h))
        if status < 0:
            raise (Vp8Unsupported if status == -2 else Vp8Error)(
                self.lib.vk_vp8_error(self.handle).decode())
        if status == 0:
            return None
        w, h = w.value, h.value
        planes = (np.empty((h, w), np.uint8), np.empty(((h + 1) >> 1, (w + 1) >> 1), np.uint8),
                  np.empty(((h + 1) >> 1, (w + 1) >> 1), np.uint8))
        self.lib.vk_vp8_planes(self.handle, *(p.ctypes.data for p in planes))
        return planes

    def full_range(self) -> bool:
        return bool(self.lib.vk_vp8_full_range(self.handle))

    def close(self) -> None:
        if self.handle:
            self.lib.vk_vp8_destroy(self.handle)
            self.handle = None

    __del__ = close
