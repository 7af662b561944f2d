"""WebP decode without libwebp: cv2.imdecode(IMREAD_COLOR) + BGR2RGB of a
WebP file, bit for bit, in numpy and the standard library.

The reference is OpenCV 5's grfmt_webp.cpp over its built-in libwebp
(decoder ABI 0x0210), as cv2 runs them:

- The container (webp_dec.c ParseHeadersInternal): RIFF/"WEBP" with its
  size checks (a RIFF size past the bytes, a chunk past the RIFF size, an
  odd size, trailing bytes), "VP8X" (24-bit canvas size plus one, its
  flags), the optional chunks before the image ("ICCP", "ALPH", unknown
  ones, skipped with their padding), then "VP8 " or "VP8L"; a raw "VP8L"
  bitstream without a RIFF header too (cv2 sniffs the first 32 bytes with
  WebPGetFeatures and takes it). The image decodes from every byte after
  its chunk header, as WebPDecode does. The last "ALPH" chunk before a
  "VP8 " image is decoded for its failures (libwebp fails the whole decode
  on a bad one) and dropped (IMREAD_COLOR keeps the colour planes as
  decoded: no blend, no premultiplication). The EXIF orientation of the
  first "EXIF" chunk of a VP8X file that flags it is applied as cv2
  applies it; "ICCP" and "XMP " are ignored, as cv2 ignores them.
  An animated file ("ANIM" and "ANMF" chunks) gives its first frame on a
  zero canvas at its offset, as WebPAnimDecoder composes it. OpenCV's
  size limits apply (decode.size_refusal).
- VP8L, lossless (vp8l_dec.c, huffman_utils.c, lossless.c): an LSB-first
  bit reader; simple and normal prefix codes (code lengths in
  kCodeLengthCodeOrder, repeat codes 16, 17 and 18, max_symbol), each
  checked complete as BuildHuffmanTable checks it; meta prefix codes
  (the entropy image); LZ77 lengths and distances with the 120-entry
  distance map; the colour cache (hash 0x1e35a7bd); the predictor
  (modes 0-13, 14 and 15 as 0), cross-colour, subtract-green and
  colour-indexing transforms (1, 2 and 4-bit bundling) undone in reverse
  order; the bits read past the end fail the decode, as libwebp's eos_.
- VP8, lossy (RFC 6386 as libwebp implements it: vp8_dec.c, tree_dec.c,
  quant_dec.c, frame_dec.c, dsp/dec.c, upsampling.c, yuv.h): the frame
  header, segments, filter header and 1-8 token partitions; the boolean
  decoder with libwebp's end of data (any read past a partition's bytes
  fails the decode, as its eof_ checks do); dequantisation; intra modes,
  coefficient tokens with their non-zero contexts; reconstruction with
  the border values (127 above, 129 to the left), the top-right pixels of
  the 4x4 predictors, the ten 4x4, four 16x16 and four chroma predictors,
  TransformOne and the WHT; the simple and normal loop filters in
  libwebp's edge order; the fancy upsampler with its own rounding and the
  14-bit YUV -> RGB of yuv.h; the crop to the frame.

The Huffman and token loops, the intra prediction of each macroblock and
the predictor transform's modes that read the left pixel are Python; the
other transforms, the residuals' IDCT, the loop filter (in waves of
macroblocks that do not touch each other's pixels), the upsampling and
the colour conversion are numpy.
"""

from __future__ import annotations

import numpy as np

from vision_kit_tpu_torch.data.decode import parse_exif_orientation, size_refusal


class WebPError(ValueError):
    """Bytes that cv2 (libwebp) does not decode as WebP; decode_image
    answers None."""


class _NotEnoughData(WebPError):
    """VP8_STATUS_NOT_ENOUGH_DATA: the header parse ran out of bytes."""


# -- tables ----------------------------------------------------------------

# tree_dec.c CoeffsProba0 (RFC 6386 13.5): default token probabilities [type][band][ctx][node]
_COEFFS_PROBA0 = np.frombuffer(bytes.fromhex(
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
_COEFFS_UPDATE_PROBA = np.frombuffer(bytes.fromhex(
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
_BMODES_PROBA = np.frombuffer(bytes.fromhex(
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
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68,
    69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
    86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
    112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143,
    145, 148, 151, 154, 157)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96,
    98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239,
    245, 249, 254, 259, 264, 269, 274, 279, 284)
# vp8l_dec.c kCodeToPlane: distance codes 1..120 as (dy << 4) | (8 - dx)
_CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54,
    58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52,
    60, 3, 87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2,
    103, 105, 18, 30, 102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120,
    1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115,
    125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112)
# vp8l_dec.c kCodeLengthCodeOrder, and the code-length repeats 16, 17, 18
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_REPEAT_BITS, _REPEAT_OFFSET = (2, 3, 7), (3, 3, 11)
# the five alphabets of a prefix-code group: green + lengths, red, blue,
# alpha, distance
_ALPHABETS = (256 + 24, 256, 256, 256, 40)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)   # kBands, n -> band
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# kYModesIntra4: the 4x4 mode tree, -mode at the leaves
_YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)


# -- the container ---------------------------------------------------------

SIGNATURE_BYTES = 32   # grfmt_webp.cpp WEBP_HEADER_SIZE: the bytes cv2 sniffs
_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
VP8X_ANIMATION, VP8X_XMP, VP8X_EXIF, VP8X_ALPHA, VP8X_ICC = 0x02, 0x04, 0x08, 0x10, 0x20
_VP8X_VALID = VP8X_ANIMATION | VP8X_XMP | VP8X_EXIF | VP8X_ALPHA | VP8X_ICC


def _le16(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8)


def _le24(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16)


def _le32(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16) | (b[i + 3] << 24)


def is_webp(data: bytes) -> bool:
    """RIFF/"WEBP" bytes, or a raw VP8L bitstream (VP8LCheckSignature):
    cv2 takes both as WebP."""
    return ((data[:4] == b"RIFF" and data[8:12] == b"WEBP")
            or (len(data) >= 5 and data[0] == 0x2F and data[4] >> 5 == 0))


def _vp8_info(b: bytes, chunk_size: int) -> tuple[int, int]:
    """VP8GetInfo: (width, height) of a VP8 key frame's first 10 bytes."""
    if len(b) < 10 or b[3:6] != b"\x9d\x01\x2a":
        raise WebPError("not a VP8 key frame")
    bits = _le24(b, 0)
    w, h = _le16(b, 6) & 0x3FFF, _le16(b, 8) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size:
        raise WebPError("bad VP8 frame tag")
    if w == 0 or h == 0:
        raise WebPError("zero VP8 size")
    return w, h


def _vp8l_info(b: bytes) -> tuple[int, int, bool]:
    """VP8LGetInfo: (width, height, has_alpha) from a VP8L header."""
    if len(b) < 5 or b[0] != 0x2F or b[4] >> 5:
        raise WebPError("not a VP8L bitstream")
    v = _le32(b, 1)
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def _parse_headers(data: bytes, have_all_data: bool, features: bool = False) -> dict:
    """webp_dec.c ParseHeadersInternal. With `features` (WebPGetFeatures,
    no headers kept) an animated VP8X answers from its canvas, and a VP8X
    file that runs out of bytes still answers its canvas size. Returns
    width, height, has_alpha, animation, vp8x flags, and for the image:
    lossless, offset (its bitstream's first byte), riff_size. Raises
    _NotEnoughData or WebPError as the parse fails."""
    n = len(data)
    if n < 12:
        raise _NotEnoughData("fewer than 12 bytes")
    pos = riff_size = 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise WebPError("a RIFF file that is not WEBP")
        size = _le32(data, 4)
        if size < 12 or size > _MAX_CHUNK_PAYLOAD:
            raise WebPError(f"RIFF size {size}")
        if have_all_data and size > n - 8:
            raise _NotEnoughData("the RIFF size runs past the bytes")
        riff_size, pos = size, 12
    info = dict(flags=0, animation=False, has_alpha=False, riff_size=riff_size)
    if n - pos < 8:
        raise _NotEnoughData("no chunk header")
    vp8x = data[pos:pos + 4] == b"VP8X"
    if vp8x:
        if _le32(data, pos + 4) != 10:
            raise WebPError("VP8X size")
        if n - pos < 18:
            raise _NotEnoughData("short VP8X")
        flags = _le32(data, pos + 8)
        w, h = 1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15)
        if w * h >= 1 << 32:
            raise WebPError("VP8X canvas too large")
        pos += 18
        if not riff_size:
            raise WebPError("VP8X without RIFF")
        info.update(flags=flags, animation=bool(flags & VP8X_ANIMATION),
                    has_alpha=bool(flags & VP8X_ALPHA), width=w, height=h)
        if info["animation"] and features:
            return info
    try:
        if n - pos < 4:
            raise _NotEnoughData("no image chunk")
        if (riff_size and vp8x) or (not riff_size and not vp8x
                                   and data[pos:pos + 4] == b"ALPH"):
            # ParseOptionalChunks: skip to the VP8/VP8L chunk
            total = 4 + 8 + 10
            while True:
                if n - pos < 8:
                    raise _NotEnoughData("no image chunk")
                size = _le32(data, pos + 4)
                if size > _MAX_CHUNK_PAYLOAD:
                    raise WebPError("chunk size")
                disk = (8 + size + 1) & ~1
                total += disk
                if riff_size and total > riff_size:
                    raise WebPError("a chunk runs past the RIFF size")
                if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                    break
                if n - pos < disk:
                    raise _NotEnoughData("a chunk runs past the bytes")
                if data[pos:pos + 4] == b"ALPH":   # the last one counts
                    info.update(has_alpha=True, alpha=(pos + 8, size))
                pos += disk
        # ParseVP8Header
        if n - pos < 8:
            raise _NotEnoughData("no image chunk header")
        tag = data[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            size = _le32(data, pos + 4)
            if riff_size >= 12 and size > riff_size - 12:
                raise WebPError("the image chunk runs past the RIFF size")
            if have_all_data and size > n - pos - 8:
                raise _NotEnoughData("the image chunk runs past the bytes")
            lossless, chunk_size = tag == b"VP8L", size
            pos += 8
        else:   # a raw bitstream
            lossless = n - pos >= 5 and data[pos] == 0x2F and data[pos + 4] >> 5 == 0
            chunk_size = n - pos
        if chunk_size > _MAX_CHUNK_PAYLOAD:
            raise WebPError("chunk size")
        body = data[pos:]
        if lossless:
            if len(body) < 5:
                raise _NotEnoughData("short VP8L header")
            w, h, alpha = _vp8l_info(body)
            info["has_alpha"] |= alpha
        else:
            if len(body) < 10:
                raise _NotEnoughData("short VP8 header")
            w, h = _vp8_info(body, chunk_size)
    except _NotEnoughData:
        if vp8x and features:
            return info
        raise
    if vp8x and (w, h) != (info["width"], info["height"]):
        raise WebPError("the image size differs from the VP8X canvas")
    info.update(width=w, height=h, lossless=lossless, offset=pos)
    return info


def _chunks(data: bytes, pos: int, end: int):
    """(tag, payload start, payload size) of each whole chunk in
    data[pos:end], padding skipped; stops at a chunk the bytes cut."""
    while pos + 8 <= end:
        size = _le32(data, pos + 4)
        if pos + 8 + size > end:
            return
        yield data[pos:pos + 4], pos + 8, size
        pos += 8 + size + (size & 1)


def webp_header(data: bytes) -> dict:
    """What cv2 reads of a WebP before decoding it: width, height (of the
    canvas, before the EXIF orientation), kind ("lossy", "lossless" or
    "animated"), has_alpha and the EXIF orientation (1 when absent).
    Raises WebPError for bytes cv2 does not take as WebP, and for an image
    over OpenCV's size limits."""
    if len(data) < SIGNATURE_BYTES:
        raise WebPError(f"fewer than {SIGNATURE_BYTES} bytes")
    info = _parse_headers(data[:SIGNATURE_BYTES], have_all_data=False, features=True)
    too_big = size_refusal(info["width"], info["height"])
    if too_big:
        raise WebPError(too_big)
    if info["animation"]:
        kind = "animated"
    else:
        kind = "lossless" if _parse_headers(data, True)["lossless"] else "lossy"
    info.update(kind=kind, orientation=_orientation(data, info))
    return info


def _orientation(data: bytes, info: dict) -> int:
    """The orientation tag of the first "EXIF" chunk of a VP8X file whose
    EXIF flag is set (what libwebp's demuxer hands cv2), else 1."""
    if data[:4] != b"RIFF" or data[12:16] != b"VP8X" or not info["flags"] & VP8X_EXIF:
        return 1
    end = min(len(data), 8 + _le32(data, 4))
    for tag, start, size in _chunks(data, 30, end):
        if tag == b"EXIF":
            return parse_exif_orientation(data[start:start + size])
    return 1


# -- VP8L, lossless --------------------------------------------------------


def _windows_le(data: bytes) -> list:
    """w[i] = the 64 bits from byte i on, little-endian, as Python ints,
    zero past the end (bits there are read only to fail the decode)."""
    pad = np.zeros(len(data) + 16, np.uint8)
    pad[:len(data)] = np.frombuffer(data, np.uint8)
    w = np.zeros(len(data) + 8, np.uint64)
    for j in range(8):
        w |= pad[j:j + len(w)].astype(np.uint64) << np.uint64(8 * j)
    return w.tolist()


class _Bits:
    """VP8L's LSB-first bit reader over the bytes: `read(n)` for n <= 32;
    `p` may run past the end (zeros there), `check()` then fails."""

    __slots__ = ("w", "p", "end")

    def __init__(self, data: bytes, p: int = 0):
        self.w, self.p, self.end = _windows_le(data), p, 8 * len(data)

    def read(self, n: int) -> int:
        p = self.p
        if (p >> 3) >= len(self.w) - 1:
            raise WebPError("VP8L: read past the end")
        self.p = p + n
        return (self.w[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.p > self.end:
            raise WebPError("VP8L: the bitstream ends early")


def _reverse(code: int, length: int) -> int:
    return int(f"{code:0{length}b}"[::-1], 2) if length else 0


def _prefix_table(lengths) -> tuple[list, int]:
    """A prefix code from its code lengths, as huffman_utils.c
    BuildHuffmanTable takes them: (lookup by the next `bits` bits read, of
    (symbol << 4) | code length; bits). One used symbol is a code of 0
    bits; otherwise the code must be complete and not over-subscribed."""
    lengths = np.asarray(lengths, np.int64)
    used = np.flatnonzero(lengths)
    if len(used) == 0 or lengths.max() > 15:
        raise WebPError("VP8L: bad code lengths")
    if len(used) == 1:
        return [int(used[0]) << 4], 0
    counts = np.bincount(lengths[used], minlength=16)
    left = 1
    for n in counts[1:].tolist():
        left = 2 * left - n
        if left < 0:
            raise WebPError("VP8L: over-subscribed prefix code")
    if left:
        raise WebPError("VP8L: incomplete prefix code")
    bits = int(lengths.max())
    table = np.zeros(1 << bits, np.int64)
    order = used[np.lexsort((used, lengths[used]))]
    code = 0
    prev = 0
    for sym in order.tolist():
        n = int(lengths[sym])
        code <<= n - prev
        prev = n
        table[_reverse(code, n)::1 << n] = (sym << 4) | n
        code += 1
    return table.tolist(), bits


def _read_code(br: _Bits, alphabet: int) -> tuple[list, int]:
    """vp8l_dec.c ReadHuffmanCode: a simple or a normal prefix code."""
    lengths = [0] * alphabet
    if br.read(1):   # simple: one or two symbols of length 1
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        picked = [first] + ([br.read(8)] if n == 2 else [])
        for s in picked:
            if s < alphabet:
                lengths[s] = 1
    else:
        ccl = [0] * 19
        for i in range(br.read(4) + 4):
            ccl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        table, bits = _prefix_table(ccl)
        mask = (1 << bits) - 1
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise WebPError("VP8L: max_symbol past the alphabet")
        else:
            max_symbol = alphabet
        sym, prev = 0, 8
        while sym < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            e = table[(br.w[br.p >> 3] >> (br.p & 7)) & mask]
            br.p += e & 15
            code_len = e >> 4
            if code_len < 16:
                lengths[sym] = code_len
                sym += 1
                if code_len:
                    prev = code_len
            else:
                slot = code_len - 16
                repeat = br.read(_REPEAT_BITS[slot]) + _REPEAT_OFFSET[slot]
                if sym + repeat > alphabet:
                    raise WebPError("VP8L: code-length repeat past the alphabet")
                fill = prev if code_len == 16 else 0
                lengths[sym:sym + repeat] = [fill] * repeat
                sym += repeat
    br.check()
    return _prefix_table(lengths)


def _prefix_value(sym: int, br: _Bits) -> int:
    """GetCopyDistance / GetCopyLength: a length or distance prefix symbol
    and its extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _decode_stream(br: _Bits, xsize: int, ysize: int, level0: bool,
                   transforms: list | None = None) -> np.ndarray:
    """DecodeImageStream + DecodeImageData: (ysize, xsize) ARGB uint32 of an
    entropy-coded image. At level 0 the transforms are read first (into
    `transforms`, each with the width it applies at), and the image is the
    transformed one, of their last width."""
    if level0:
        seen = 0
        while br.read(1):
            kind = br.read(2)
            if seen & (1 << kind):
                raise WebPError("VP8L: a transform twice")
            seen |= 1 << kind
            t = dict(kind=kind, xsize=xsize)
            if kind in (0, 1):   # predictor, cross-colour: a sub-sampled image
                t["bits"] = br.read(3) + 2
                size = 1 << t["bits"]
                t["data"] = _decode_stream(br, -(-xsize // size), -(-ysize // size), False)
            elif kind == 3:      # colour indexing: a palette, bundled pixels
                n = br.read(8) + 1
                t["bits"] = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                pal = _decode_stream(br, n, 1, False).reshape(-1)
                raw = pal.view(np.uint8).reshape(n, 4)
                full = np.zeros((1 << (8 >> t["bits"]), 4), np.uint8)
                full[:n] = np.cumsum(raw, axis=0, dtype=np.uint8)   # ExpandColorMap
                t["data"] = full.view(np.uint32).reshape(-1)
                xsize = -(-xsize // (1 << t["bits"]))
            transforms.append(t)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise WebPError("VP8L: colour cache bits")
    meta, meta_bits = None, 0
    n_groups = 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        size = 1 << meta_bits
        meta = (_decode_stream(br, -(-xsize // size), -(-ysize // size), False)
                >> np.uint32(8)) & np.uint32(0xFFFF)
        n_groups = int(meta.max()) + 1
    br.check()
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, a + ((1 << cache_bits) if j == 0 and cache_bits else 0))
                       for j, a in enumerate(_ALPHABETS)])
    return _decode_pixels(br, xsize, ysize, groups, meta, meta_bits, cache_bits)


def _decode_pixels(br, width, height, groups, meta, meta_bits, cache_bits) -> np.ndarray:
    """DecodeImageData: literals, backward references and colour-cache hits,
    each read with the prefix-code group of its pixel's tile."""
    total = width * height
    out = [0] * total
    w, p = br.w, br.p
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cache_limit = 280 + (1 << cache_bits if cache_bits else 0)
    meta_rows = meta.tolist() if meta is not None else None
    tile_mask = (1 << meta_bits) - 1 if meta is not None else -1
    limit = len(w) - 4
    pos = x = y = 0
    green = red = blue = alpha = dist = None
    while pos < total:
        if x & tile_mask == 0 or green is None:
            g = groups[meta_rows[y >> meta_bits][x >> meta_bits]] if meta_rows else groups[0]
            (green, gb), (red, rb), (blue, bb), (alpha, ab), (dist, db) = g
            gm, rm, bm, am, dm = ((1 << b) - 1 for b in (gb, rb, bb, ab, db))
        if p >> 3 >= limit:
            raise WebPError("VP8L: the bitstream ends early")
        e = green[(w[p >> 3] >> (p & 7)) & gm]
        p += e & 15
        code = e >> 4
        if code < 256:
            e = red[(w[p >> 3] >> (p & 7)) & rm]
            p += e & 15
            r = e >> 4
            e = blue[(w[p >> 3] >> (p & 7)) & bm]
            p += e & 15
            b = e >> 4
            e = alpha[(w[p >> 3] >> (p & 7)) & am]
            p += e & 15
            argb = ((e >> 4) << 24) | (r << 16) | (code << 8) | b
            out[pos] = argb
            if cache is not None:
                cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
            pos += 1
            x += 1
            if x == width:
                x, y = 0, y + 1
        elif code < 280:
            br.p = p
            length = _prefix_value(code - 256, br)
            e = dist[(w[br.p >> 3] >> (br.p & 7)) & dm]
            br.p += e & 15
            dcode = _prefix_value(e >> 4, br)
            p = br.p
            if dcode > 120:
                d = dcode - 120
            else:
                plane = _CODE_TO_PLANE[dcode - 1]
                d = max(1, (plane >> 4) * width + 8 - (plane & 15))
            if d > pos or length > total - pos:
                raise WebPError("VP8L: a backward reference out of the image")
            if d >= length:
                out[pos:pos + length] = out[pos - d:pos - d + length]
            else:
                for i in range(pos, pos + length):
                    out[i] = out[i - d]
            if cache is not None:
                for argb in out[pos:pos + length]:
                    cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
            pos += length
            x += length
            while x >= width:
                x -= width
                y += 1
            green = None   # the tile may have changed
        elif code < cache_limit:
            argb = cache[code - 280]
            out[pos] = argb
            cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
            pos += 1
            x += 1
            if x == width:
                x, y = 0, y + 1
        else:
            raise WebPError("VP8L: a symbol past the alphabet")
    br.p = p
    br.check()
    return np.array(out, np.uint32).reshape(height, width)


def _add_pixels(a, b):
    """VP8LAddPixels: per-byte sums mod 256 of packed ARGB (Python ints or
    int64 arrays)."""
    ag = (a & 0xFF00FF00) + (b & 0xFF00FF00)
    rb = (a & 0x00FF00FF) + (b & 0x00FF00FF)
    return (ag & 0xFF00FF00) | (rb & 0x00FF00FF)


def _average2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(v: int) -> tuple:
    return (v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255)


def _pack(c) -> int:
    return (c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3]


def _predict(mode: int, left: int, top: int, tl: int, tr: int) -> int:
    """VP8LPredictors[mode] on packed ARGB Python ints (modes 14 and 15
    are mode 0)."""
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _average2(_average2(left, tr), top)
    if mode == 6:
        return _average2(left, tl)
    if mode == 7:
        return _average2(left, top)
    if mode == 8:
        return _average2(tl, top)
    if mode == 9:
        return _average2(top, tr)
    if mode == 10:
        return _average2(_average2(left, tl), _average2(top, tr))
    if mode == 11:   # Select
        t, lf, c = _channels(top), _channels(left), _channels(tl)
        d = sum(abs(b - z) - abs(a - z) for a, b, z in zip(t, lf, c))
        return top if d <= 0 else left
    if mode == 12:   # ClampedAddSubtractFull
        return _pack([min(255, max(0, a + b - c)) for a, b, c in
                      zip(_channels(left), _channels(top), _channels(tl))])
    if mode == 13:   # ClampedAddSubtractHalf
        ave = _channels(_average2(left, top))
        return _pack([min(255, max(0, a + int((a - c) / 2))) for a, c in
                      zip(ave, _channels(tl))])
    return 0xFF000000


_LEFT_FREE = {0, 2, 3, 4, 8, 9, 14, 15}   # modes that do not read the left pixel


def _inverse_predictor(img: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    """PredictorInverseTransform: row 0 adds black then the left pixel,
    column 0 the top pixel, the rest each tile's mode. The top-right of the
    last column is the current row's first pixel."""
    h, w = img.shape
    out = np.empty_like(img)
    row = img[0].astype(np.int64).tolist()
    prev = 0xFF000000
    for x in range(w):
        prev = _add_pixels(row[x], prev)
        row[x] = prev
    out[0] = row
    mode_rows = ((modes >> np.uint32(8)) & np.uint32(15)).astype(np.int64)
    tile = 1 << bits
    col_mode = np.repeat(np.arange(mode_rows.shape[1]), tile)[:w]
    for y in range(1, h):
        m = mode_rows[y >> bits][col_mode]
        top = out[y - 1].astype(np.int64)
        cur = img[y].astype(np.int64)
        first = int(_add_pixels(cur[0], top[0]))   # column 0: the top pixel
        # the modes that do not read the left pixel, at once; the last
        # column's top-right is this row's first pixel
        tr = np.append(top[1:], first)
        tl = np.append(top[:1], top[:-1])
        pred = np.full(w, 0xFF000000, np.int64)
        for mode, value in ((2, top), (3, tr), (4, tl), (8, _average2(tl, top)),
                            (9, _average2(top, tr))):
            sel = m == mode
            pred[sel] = value[sel]
        pred[0] = top[0]
        free = np.isin(m, list(_LEFT_FREE))
        free[0] = True
        res = np.zeros(w, np.int64)
        res[free] = _add_pixels(cur[free], pred[free])
        if not free.all():
            r = res.tolist()
            tops, cs, ms = top.tolist(), cur.tolist(), m.tolist()
            tops.append(first)   # the last column's top-right
            for x in np.flatnonzero(~free).tolist():
                mode, left = ms[x], r[x - 1]
                # the averaging modes inline (_average2), the rest by _predict
                if mode == 10:
                    a, b = left, tops[x - 1]
                    a = (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)
                    b, t = tops[x], tops[x + 1]
                    b = (((b ^ t) & 0xFEFEFEFE) >> 1) + (b & t)
                    pr = (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)
                elif mode == 1:
                    pr = left
                elif mode == 7:
                    t = tops[x]
                    pr = (((left ^ t) & 0xFEFEFEFE) >> 1) + (left & t)
                elif mode == 6:
                    t = tops[x - 1]
                    pr = (((left ^ t) & 0xFEFEFEFE) >> 1) + (left & t)
                else:
                    pr = _predict(mode, left, tops[x], tops[x - 1], tops[x + 1])
                a = cs[x]
                r[x] = ((((a & 0xFF00FF00) + (pr & 0xFF00FF00)) & 0xFF00FF00)
                        | (((a & 0x00FF00FF) + (pr & 0x00FF00FF)) & 0x00FF00FF))
            res = np.array(r, np.int64)
        out[y] = res
    return out


def _inverse_transforms(img: np.ndarray, transforms: list) -> np.ndarray:
    """The transforms undone in reverse order, each at the width it was
    applied at."""
    for t in reversed(transforms):
        kind = t["kind"]
        if kind == 0:
            img = _inverse_predictor(img, t["bits"], t["data"])
        elif kind == 1:   # cross-colour (TransformColorInverse)
            size = 1 << t["bits"]
            h, w = img.shape
            code = np.repeat(np.repeat(t["data"], size, 0), size, 1)[:h, :w]
            g2r = (code & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
            g2b = ((code >> np.uint32(8)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
            r2b = ((code >> np.uint32(16)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
            green = ((img >> np.uint32(8)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
            red = ((img >> np.uint32(16)) & 0xFF).astype(np.int32)
            blue = (img & 0xFF).astype(np.int32)
            red = (red + ((g2r * green) >> 5)) & 0xFF
            red8 = red.astype(np.uint8).view(np.int8).astype(np.int32)
            blue = (blue + ((g2b * green) >> 5) + ((r2b * red8) >> 5)) & 0xFF
            img = (img & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << np.uint32(16)) \
                | blue.astype(np.uint32)
        elif kind == 2:   # subtract green
            green = (img >> np.uint32(8)) & np.uint32(0xFF)
            rb = ((img & np.uint32(0x00FF00FF)) + ((green << np.uint32(16)) | green)) \
                & np.uint32(0x00FF00FF)
            img = (img & np.uint32(0xFF00FF00)) | rb
        else:             # colour indexing, bundled pixels unpacked
            bits, w = t["bits"], t["xsize"]
            index = (img >> np.uint32(8)) & np.uint32(0xFF)
            if bits:
                per = 1 << bits
                bpp = 8 >> bits
                shifts = (np.arange(per, dtype=np.uint32) * bpp)
                index = ((index[:, :, None] >> shifts) & np.uint32((1 << bpp) - 1))
                index = index.reshape(img.shape[0], -1)[:, :w]
            img = t["data"][index]
    return img


def _decode_vp8l(payload: bytes) -> np.ndarray:
    """A VP8L bitstream -> (H, W, 3) uint8 RGB (alpha dropped)."""
    width, height, _ = _vp8l_info(payload)
    too_big = size_refusal(width, height)
    if too_big:
        raise WebPError(too_big)
    br = _Bits(payload, 40)
    transforms: list = []
    img = _decode_stream(br, width, height, True, transforms)
    argb = _inverse_transforms(img, transforms).astype(np.uint32)
    rgb = np.stack([(argb >> np.uint32(16)) & 0xFF, (argb >> np.uint32(8)) & 0xFF,
                    argb & 0xFF], -1)
    return rgb.astype(np.uint8)


# -- VP8, lossy: the boolean decoder --------------------------------------

# shift that brings a range of 1..255 back to 128..255 (7 ^ floor(log2 r))
_NORM = tuple(0 if r == 0 else 7 - (r.bit_length() - 1) for r in range(256))


class _BoolReader:
    """bit_reader_utils's VP8BitReader: `rng` is the range minus one,
    `value` holds `bits` + 8 unread bits. Bytes load one at a time; the
    first load past the end appends a zero byte and sets `eof`, as
    VP8LoadFinalBytes does, and any read past that point leaves it set
    (libwebp fails the decode on it)."""

    __slots__ = ("buf", "pos", "end", "value", "bits", "rng", "eof")

    def __init__(self, buf: bytes, start: int, size: int):
        self.buf, self.pos, self.end = buf, start, start + size
        self.value, self.bits, self.rng, self.eof = 0, -8, 254, False
        self._load()

    def _load(self) -> None:
        if self.pos < self.end:
            self.value = (self.value << 8) | self.buf[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

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
        sh = _NORM[r]
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


def _coeffs(br: _BoolReader, probs, ctx: int, dq: tuple, n: int, out: list, base: int) -> int:
    """GetCoeffs: one block's tokens from position n on, dequantized into
    out[base + zigzag] (as libwebp's int16 coefficients); returns the
    position after the last non-zero token (n when the first is EOB)."""
    buf, end, norm = br.buf, br.end, _NORM
    value, bits, rng, pos, eof = br.value, br.bits, br.rng, br.pos, br.eof
    p = probs[n][ctx]

    def get(prob):
        nonlocal value, bits, rng, pos, eof
        if bits < 0:
            if pos < end:
                value = (value << 8) | buf[pos]
                pos += 1
                bits += 8
            elif not eof:
                value <<= 8
                bits += 8
                eof = True
            else:
                bits = 0
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
                for prob in _CAT3456[cat]:
                    v += v + get(prob)
                v += 3 + (8 << cat)
            p = probs[n + 1][2]
        if get(0x80):
            v = -v
        v *= dq[n > 0]
        out[base + _ZIGZAG[n]] = ((v + 32768) & 0xFFFF) - 32768   # int16
        n += 1
    br.value, br.bits, br.rng, br.pos, br.eof = value, bits, rng, pos, eof
    return result


# -- VP8, lossy: headers, modes and tokens ---------------------------------


def _vp8_parse(data: bytes, start: int) -> dict:
    """VP8GetHeaders, then every macroblock's modes (partition 0) and
    tokens (the token partitions) row by row, as ParseFrame reads them.
    Raises WebPError where libwebp fails, a read past a used partition's
    bytes included."""
    size = len(data) - start
    if size < 4:
        raise WebPError("VP8: truncated header")
    tag = _le24(data, start)
    part0 = tag >> 5
    if tag & 1 or (tag >> 1) & 7 > 3 or not (tag >> 4) & 1:
        raise WebPError("VP8: not a shown key frame")
    pos, size = start + 3, size - 3
    if size < 7 or data[pos:pos + 3] != b"\x9d\x01\x2a":
        raise WebPError("VP8: bad start code")
    width, height = _le16(data, pos + 3) & 0x3FFF, _le16(data, pos + 5) & 0x3FFF
    pos, size = pos + 7, size - 7
    if part0 > size:
        raise WebPError("VP8: bad partition length")
    br = _BoolReader(data, pos, part0)
    pos, size = pos + part0, size - part0
    br.bit(0x80)   # colour space
    br.bit(0x80)   # clamping type
    # segment header
    use_segment = update_map = False
    absolute, seg_q, seg_f, seg_probs = True, [0] * 4, [0] * 4, [255] * 3
    if br.bit(0x80):
        use_segment = True
        update_map = bool(br.bit(0x80))
        if br.bit(0x80):
            absolute = bool(br.bit(0x80))
            seg_q = [br.signed_value(7) if br.bit(0x80) else 0 for _ in range(4)]
            seg_f = [br.signed_value(6) if br.bit(0x80) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.value_bits(8) if br.bit(0x80) else 255 for _ in range(3)]
    # filter header
    simple = br.bit(0x80)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_lf_delta = br.bit(0x80)
    if use_lf_delta and br.bit(0x80):
        for deltas in (ref_delta, mode_delta):
            for i in range(4):
                if br.bit(0x80):
                    deltas[i] = br.signed_value(6)
    if br.eof:
        raise WebPError("VP8: cannot parse the headers")
    # token partitions
    n_parts = 1 << br.value_bits(2)
    if size < 3 * (n_parts - 1):
        raise WebPError("VP8: cannot read the partition sizes")
    part_start = pos + 3 * (n_parts - 1)
    left, end = size - 3 * (n_parts - 1), pos + size
    parts = []
    for p in range(n_parts - 1):
        psize = min(_le24(data, pos + 3 * p), left)
        parts.append(_BoolReader(data, part_start, psize))
        part_start += psize
        left -= psize
    parts.append(_BoolReader(data, part_start, left))
    if part_start >= end:
        raise WebPError("VP8: the last partition is empty")
    # quantizers (VP8ParseQuant)
    base_q = br.value_bits(7)
    dq = [br.signed_value(4) if br.bit(0x80) else 0 for _ in range(5)]
    quant = []

    def clip(v, hi):
        return 0 if v < 0 else hi if v > hi else v

    for s in range(4):
        q = (seg_q[s] + (0 if absolute else base_q)) if use_segment else base_q
        y2_ac = (_AC_TABLE[clip(q + dq[2], 127)] * 101581) >> 16
        quant.append(dict(
            y1=(_DC_TABLE[clip(q + dq[0], 127)], _AC_TABLE[clip(q, 127)]),
            y2=(_DC_TABLE[clip(q + dq[1], 127)] * 2, max(8, y2_ac)),
            uv=(_DC_TABLE[clip(q + dq[3], 117)], _AC_TABLE[clip(q + dq[4], 127)])))
    br.bit(0x80)   # update_proba, ignored
    # VP8ParseProba
    proba = _COEFFS_PROBA0.astype(np.int64).copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(_COEFFS_UPDATE_PROBA[t, b, c, p])):
                        proba[t, b, c, p] = br.value_bits(8)
    bands = [[proba[t, _BANDS[n]].tolist() for n in range(17)] for t in range(4)]
    skip_p = br.value_bits(8) if br.bit(0x80) else None
    # filter strengths (PrecomputeFilterStrengths)
    filter_type = 0 if level == 0 else 1 if simple else 2
    strengths = []
    for s in range(4):
        base = level
        if use_segment:
            base = seg_f[s] + (0 if absolute else level)
        row = []
        for i4x4 in (0, 1):
            lvl = base + (ref_delta[0] + (mode_delta[0] if i4x4 else 0) if use_lf_delta else 0)
            lvl = max(0, min(63, lvl))
            if lvl > 0:
                ilevel = lvl
                if sharpness > 0:
                    ilevel >>= 2 if sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * lvl + ilevel, ilevel, 2 if lvl >= 40 else 1 if lvl >= 15 else 0))
            else:
                row.append((0, 0, 0))
        strengths.append(row)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    n_mb = mb_w * mb_h
    coeffs = [0] * (n_mb * 384)
    mbs = []
    intra_t = [0] * (4 * mb_w)
    nz_top = [0] * mb_w          # per column: 4 luma + 2 u + 2 v bits
    nz_dc_top = [0] * mb_w
    for mb_y in range(mb_h):
        # ParseIntraModeRow
        intra_l = [0] * 4
        row = []
        for mb_x in range(mb_w):
            segment = 0
            if update_map:
                segment = (2 + br.bit(seg_probs[2])) if br.bit(seg_probs[0]) else br.bit(seg_probs[1])
            skip = br.bit(skip_p) if skip_p is not None else 0
            i4x4 = not br.bit(145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not i4x4:
                ymode = ((1 if br.bit(128) else 3) if br.bit(156)
                         else (2 if br.bit(163) else 0))
                modes = [ymode]
                top = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                modes = [0] * 16
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = _BMODES_PROBA[top[x], ym]
                        i = _YMODES_INTRA4[br.bit(int(prob[0]))]
                        while i > 0:
                            i = _YMODES_INTRA4[2 * i + br.bit(int(prob[i]))]
                        ym = -i
                        top[x] = ym
                        modes[4 * y + x] = ym
                    intra_l[y] = ym
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            uvmode = 0 if not br.bit(142) else 2 if not br.bit(114) else 1 if br.bit(183) else 3
            row.append(dict(segment=segment, skip=skip, i4x4=i4x4, modes=modes, uvmode=uvmode))
        if br.eof:
            raise WebPError("VP8: premature end of partition 0")
        # the tokens of the row
        tbr = parts[mb_y & (n_parts - 1)]
        nz_left = nz_dc_left = 0
        for mb_x, mb in enumerate(row):
            base = (mb_y * mb_w + mb_x) * 384
            q = quant[mb["segment"]]
            skip = mb["skip"]
            if not skip:
                non_zero = 0
                if not mb["i4x4"]:
                    dc = [0] * 16
                    nz = _coeffs(tbr, bands[1], nz_dc_top[mb_x] + nz_dc_left, q["y2"], 0, dc, 0)
                    nz_dc_top[mb_x] = nz_dc_left = int(nz > 0)
                    for i, v in enumerate(_wht(dc) if nz > 1 else [(dc[0] + 3) >> 3] * 16):
                        coeffs[base + 16 * i] = ((v + 32768) & 0xFFFF) - 32768
                    first, ac = 1, bands[0]
                else:
                    first, ac = 0, bands[3]
                tnz = nz_top[mb_x] & 0x0F
                lnz = nz_left & 0x0F
                for y in range(4):
                    lb = lnz & 1
                    for x in range(4):
                        k = base + 16 * (4 * y + x)
                        nz = _coeffs(tbr, ac, lb + (tnz & 1), q["y1"], first, coeffs, k)
                        lb = int(nz > first)
                        tnz = (tnz >> 1) | (lb << 7)
                        non_zero |= nz > 1 or coeffs[k] != 0
                    tnz >>= 4
                    lnz = (lnz >> 1) | (lb << 7)
                out_t, out_l = tnz, lnz >> 4
                for ch in (0, 2):
                    tnz = nz_top[mb_x] >> (4 + ch)
                    lnz = nz_left >> (4 + ch)
                    for y in range(2):
                        lb = lnz & 1
                        for x in range(2):
                            k = base + 256 + 16 * (2 * ch + 2 * y + x)
                            nz = _coeffs(tbr, bands[2], lb + (tnz & 1), q["uv"], 0, coeffs, k)
                            lb = int(nz > 0)
                            tnz = (tnz >> 1) | (lb << 3)
                            non_zero |= nz > 1 or coeffs[k] != 0
                        tnz >>= 2
                        lnz = (lnz >> 1) | (lb << 5)
                    out_t |= (tnz << 4) << ch
                    out_l |= (lnz & 0xF0) << ch
                nz_top[mb_x], nz_left = out_t, out_l
                skip = not non_zero
            else:
                nz_top[mb_x] = nz_left = 0
                if not mb["i4x4"]:
                    nz_dc_top[mb_x] = nz_dc_left = 0
            if tbr.eof:
                raise WebPError("VP8: premature end of file")
            limit, ilevel, hev = strengths[mb["segment"]][int(mb["i4x4"])]
            mb["filter"] = (limit, ilevel, hev, bool(mb["i4x4"]) or not skip)
            mbs.append(mb)
    return dict(width=width, height=height, mb_w=mb_w, mb_h=mb_h, mbs=mbs, partitions=n_parts,
                coeffs=np.array(coeffs, np.int32).reshape(n_mb, 24, 16),
                filter_type=filter_type)


def _wht(dc: list) -> list:
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


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _residuals(coeffs: np.ndarray) -> np.ndarray:
    """TransformOne over every block, (..., 16) raster coefficients ->
    (..., 4, 4) residuals ((v >> 3), added to the prediction with a clip).
    TransformDC and TransformAC3 give the same for the blocks they take."""
    c = coeffs.reshape(-1, 4, 4).astype(np.int64)   # [row k, column i] = in[4k + i]
    a, b = c[:, 0] + c[:, 2], c[:, 0] - c[:, 2]
    cc = _mul2(c[:, 1]) - _mul1(c[:, 3])
    d = _mul1(c[:, 1]) + _mul2(c[:, 3])
    tmp = np.stack([a + d, b + cc, b - cc, a - d], 1)   # tmp[:, j, i] = C[4i + j]
    # horizontal pass: output row i reads C[4 col + i], tmp[:, i, col]
    t = tmp
    dc = t[:, :, 0] + 4
    a, b = dc + t[:, :, 2], dc - t[:, :, 2]
    cc = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3])
    d = _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    out = np.stack([a + d, b + cc, b - cc, a - d], 2) >> 3   # [:, row i, col]
    return out.reshape(*coeffs.shape[:-1], 4, 4)


# -- VP8, lossy: reconstruction --------------------------------------------


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _pred4(mode: int, t: list, lf: list, x: int) -> list:
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


def _pred_block(mode: int, size: int, t: list, lf: list, x: int, mb_x: int, mb_y: int) -> list:
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


def _reconstruct(fr: dict) -> tuple:
    """ReconstructRow over the frame: each macroblock predicted from the
    unfiltered pixels above and to the left (127 above the frame, 129 to
    its left, 127 or 129 at the corner), its residuals added with a clip.
    Returns the (16 mb_h, 16 mb_w) luma and two (8 mb_h, 8 mb_w) chroma
    planes, before the loop filter."""
    mb_w, mb_h = fr["mb_w"], fr["mb_h"]
    # (n_mb, 24, 4, 4); beyond +-256 a residual clips the sum whatever the
    # prediction, so the clip table below covers every sum
    res = np.clip(_residuals(fr["coeffs"]), -256, 256)
    Y = [[0] * (16 * mb_w) for _ in range(16 * mb_h)]
    U = [[0] * (8 * mb_w) for _ in range(8 * mb_h)]
    V = [[0] * (8 * mb_w) for _ in range(8 * mb_h)]
    clip = [0] * 256 + list(range(256)) + [255] * 512   # clip[v + 256]
    for i, mb in enumerate(fr["mbs"]):
        mb_y, mb_x = divmod(i, mb_w)
        y0, x0 = 16 * mb_y, 16 * mb_x
        r = res[i].tolist()
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
                p = _pred4(mode, ws[r0][c0 + 1:c0 + 9],
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
            p = _pred_block(mb["modes"][0], 16, top, left, corner, mb_x, mb_y)
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
            p = _pred_block(mb["uvmode"], 8, top, left, corner, mb_x, mb_y)
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


def _filter_lines(px: np.ndarray, thresh: np.ndarray, ithresh, hev_t, kind: str) -> None:
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


def _loop_filter(fr: dict, planes: tuple) -> tuple:
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
            _filter_lines(px, *(np.concatenate(p) for p in zip(*params)), kind)
            canvas[rr, cc] = px
    return canvas[:hy], canvas[hy:, :wc], canvas[hy:, wc:]


# -- VP8, lossy: output ----------------------------------------------------


def _upsample(c: np.ndarray, height: int, width: int) -> np.ndarray:
    """UpsampleRgbLinePair's chroma, for one plane, at full size: rows in
    pairs (2k+1, 2k+2) from chroma rows k and k+1, the first row (and the
    last of an even height) from one chroma row; columns likewise, with
    its diag_12 / diag_03 rounding."""
    c = c.astype(np.int32)
    uh, uw = (height + 1) // 2, (width + 1) // 2
    c = c[:uh, :uw]
    out = np.empty((height, width), np.int32)

    def line_pair(top, cur):
        """(top output row, bottom output row) from chroma rows top, cur."""
        n = top.shape[0]
        t_row = np.empty((n, width), np.int32)
        b_row = np.empty((n, width), np.int32)
        t_row[:, 0] = (3 * top[:, 0] + cur[:, 0] + 2) >> 2
        b_row[:, 0] = (3 * cur[:, 0] + top[:, 0] + 2) >> 2
        last = (width - 1) >> 1
        if last:
            tl, t = top[:, :last], top[:, 1:last + 1]
            lf, u = cur[:, :last], cur[:, 1:last + 1]
            avg = tl + t + lf + u + 8
            d12 = (avg + 2 * (t + lf)) >> 3
            d03 = (avg + 2 * (tl + u)) >> 3
            t_row[:, 1:2 * last:2] = (d12 + tl) >> 1
            t_row[:, 2:2 * last + 1:2] = (d03 + t) >> 1
            b_row[:, 1:2 * last:2] = (d03 + lf) >> 1
            b_row[:, 2:2 * last + 1:2] = (d12 + u) >> 1
        if not width & 1:
            tl, lf = top[:, last], cur[:, last]
            t_row[:, width - 1] = (3 * tl + lf + 2) >> 2
            b_row[:, width - 1] = (3 * lf + tl + 2) >> 2
        return t_row, b_row

    out[0] = line_pair(c[:1], c[:1])[0][0]
    n_pairs = (height - 1) // 2
    if n_pairs:
        t_rows, b_rows = line_pair(c[:n_pairs], c[1:n_pairs + 1])
        out[1:2 * n_pairs:2] = t_rows
        out[2:2 * n_pairs + 1:2] = b_rows
    if not height & 1:
        out[height - 1] = line_pair(c[uh - 1:uh], c[uh - 1:uh])[0][0]
    return out


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """yuv.h VP8YUVToR/G/B: 14-bit MultHi, 6-bit fixed point, clipped."""
    def mult_hi(a, k):
        return (a * k) >> 8

    def clip8(a):
        return np.where((a & ~16383) == 0, a >> 6, np.where(a < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _decode_vp8(data: bytes, start: int) -> np.ndarray:
    """A VP8 key frame from data[start:] on -> (H, W, 3) uint8 RGB."""
    fr = _vp8_parse(data, start)
    too_big = size_refusal(fr["width"], fr["height"])
    if too_big:
        raise WebPError(too_big)
    planes = _loop_filter(fr, _reconstruct(fr))
    h, w = fr["height"], fr["width"]
    y = planes[0][:h, :w]
    u = _upsample(planes[1], h, w)
    v = _upsample(planes[2], h, w)
    return _yuv_to_rgb(y, u, v)


# -- the whole file --------------------------------------------------------


def _check_alpha(data: bytes, alpha: tuple, width: int, height: int) -> None:
    """alpha_dec.c ALPHInit and the alpha plane's decode, for their
    failures alone: libwebp decodes a VP8 image's ALPH chunk whatever the
    output (a bad one fails the decode, in BGR too), and cv2's IMREAD_COLOR
    then drops the plane. Header byte: method (0 raw, 1 VP8L stream),
    filter, pre-processing (0 or 1), two reserved bits (0)."""
    start, size = alpha
    if size < 1:
        raise WebPError("ALPH: empty")
    head = data[start]
    method, pre, reserved = head & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or reserved:
        raise WebPError("ALPH: bad header")
    if method == 0:
        if size - 1 < width * height:
            raise WebPError("ALPH: short raw plane")
        return
    _decode_stream(_Bits(data[start + 1:start + size]), width, height, True, [])


def _decode_bitstream(data: bytes, head: dict) -> np.ndarray:
    """The image of a header parse: VP8L from its bitstream on; VP8 from
    its frame on, its ALPH chunk (if any) decoded and dropped."""
    start = head["offset"]
    if head["lossless"]:
        return _decode_vp8l(data[start:])
    rgb = _decode_vp8(data, start)
    if "alpha" in head:
        _check_alpha(data, head["alpha"], rgb.shape[1], rgb.shape[0])
    return rgb


def _first_frame(data: bytes, info: dict) -> np.ndarray:
    """WebPAnimDecoder's first frame of an animated file: its bitstream
    ("ALPH" and "VP8 " or "VP8L" inside the first "ANMF") decoded onto a
    zero canvas at the frame's offset, as WebPDemux validates the file."""
    if info["flags"] & ~_VP8X_VALID:
        raise WebPError("VP8X flags outside the format")
    cw, ch = info["width"], info["height"]
    end = 8 + _le32(data, 4)
    anim = False
    for tag, start, size in _chunks(data, 30, end):
        if tag == b"ANIM":
            if size < 6:
                raise WebPError("short ANIM")
            anim = True
        elif tag == b"ANMF":
            if not anim or size < 16:
                raise WebPError("ANMF without ANIM, or short")
            x, y = 2 * _le24(data, start), 2 * _le24(data, start + 3)
            subs = list(_chunks(data, start + 16, start + size))
            image = [i for i, (t, _, _) in enumerate(subs) if t in (b"VP8 ", b"VP8L")]
            if not image:
                raise WebPError("a frame without an image chunk")
            first = subs[0] if subs[0][0] == b"ALPH" and image[0] > 0 else subs[image[0]]
            frag_end = subs[image[0]][1] + subs[image[0]][2]
            frag = data[first[1] - 8:frag_end]
            head = _parse_headers(frag, True)
            fw, fh = head["width"], head["height"]
            if x + fw > cw or y + fh > ch:
                raise WebPError("a frame outside the canvas")
            canvas = np.zeros((ch, cw, 3), np.uint8)
            canvas[y:y + fh, x:x + fw] = _decode_bitstream(frag, head)
            return canvas
    raise WebPError("an animation without frames")


def decode_webp(data: bytes) -> tuple[np.ndarray, int]:
    """WebP bytes -> ((H, W, 3) uint8 RGB in stored order, the EXIF
    orientation): cv2.imdecode(IMREAD_COLOR) + BGR2RGB before cv2 applies
    the orientation. Raises WebPError where cv2 gives None (or raises, for
    an image over its size limits)."""
    info = webp_header(data)
    if info["animation"]:
        rgb = _first_frame(data, info)
    else:
        head = _parse_headers(data, True)
        rgb = _decode_bitstream(data, head)
        if rgb.shape[:2] != (info["height"], info["width"]):
            raise WebPError("the bitstream's size differs from the header's")
    return rgb, info["orientation"]
