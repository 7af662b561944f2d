// VP8 (RFC 6386) video decoding as host C++: libavcodec's vp8.c as cv2
// runs it.
//
// Host code only (nvcc hands it to the host compiler); plain C interface,
// loaded with ctypes by data/vp8.py (_CDecoder). It is the counterpart of
// data/vp8.py's Vp8Decoder, the plain decoder, line for line, and gives the
// same planes and the same refusals (the same messages): the demo's video
// path on the card decodes each frame here, uploads the planes and
// converts them to RGB on the device (mpeg4.yuv420_to_rgb), where the
// plain decoder's Python loops take seconds a 720p frame.
//
// The same stages in the same order: the frame tag and a key frame's start
// code and size; the first partition's header (segmentation, the loop
// filter's settings and deltas, the token partitions, the quantisers, the
// reference flags, refresh_entropy_probs and refresh_last, the probability
// updates); each macroblock's modes and vectors (vp8_decode_mvs and
// decode_splitmvs) and tokens, with libavcodec's end of data (a partition
// reads the frame's bytes past its end to an odd count, zeros after, and
// a row stops where vpx_rac_is_end holds); the reconstruction (the intra
// predictors over the unfiltered frame with 127 above and 129 to the left,
// six-tap or bilinear motion compensation over the macroblock-aligned
// references, their edges extended without end, the WHT and libavcodec's
// 16-bit IDCT); the normal or simple loop filter in raster order; the
// references' update.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string msg;
  int status;  // -1 libavcodec refuses the frame, -2 the port does
};

[[noreturn]] void fail(const std::string& msg, int status = -1) { throw Failure{msg, status}; }

std::atomic<long long> g_calls{0};

// -- tables (data/vp8.py has the same, with their sources) -------------------

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128, 189, 129, 242, 255,
    227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226,
    255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134, 202, 247, 198, 180, 255, 219,
    128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128,
    128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170,
    139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254,
    255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211,
    171, 128, 128, 128, 128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128,
    128, 128, 128, 128, 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68, 47,
    146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128, 184, 141, 234, 253,
    222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197,
    242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210,
    255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231, 245, 255, 255, 128, 128,
    128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94,
    136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249,
    255, 232, 235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193,
    211, 255, 205, 128, 128, 128, 1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255,
    255, 128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128,
    128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17,
    171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250,
    211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128, 1, 24, 239, 251, 218, 219,
    255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255, 228,
    128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223, 165, 249, 255, 213, 255, 128, 128, 128, 128,
    128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128, 1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190,
    36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255,
    128, 128, 128, 128, 128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128,
    128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46,
    138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252,
    211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52, 220, 246, 198, 199,
    249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128, 24, 71, 130, 219, 154, 170, 243, 182,
    255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128,
    128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123,
    102, 209, 247, 188, 196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248,
    255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211,
    212, 255, 255, 128, 128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255,
    219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223, 241, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255,
    255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255, 234, 250,
    241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251,
    243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255, 248, 254,
    249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 252, 255, 255, 255,
    255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252,
    253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,};
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95, 175, 69, 143, 80, 85, 82,
    72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80,
    195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101,
    106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9,
    178, 241, 141, 26, 8, 107, 74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182, 183,
    21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22, 88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183,
    117, 85, 38, 35, 179, 61, 39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73, 107, 54, 32, 26, 51, 1,
    81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78,
    95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109, 88, 43, 29, 140, 166, 213,
    37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78,
    16, 255, 128, 34, 197, 171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179, 63, 59, 90, 180, 59, 166,
    93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33,
    183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54,
    53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26,
    133, 152, 116, 10, 32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21, 23, 111, 59, 205,
    45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53,
    89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114, 115, 21, 2, 10, 102, 255,
    166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15,
    36, 163, 128, 68, 1, 26, 102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163,
    85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28,
    5, 64, 255, 25, 248, 1, 56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135, 148, 224,
    45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209, 45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39,
    155, 60, 138, 23, 102, 213, 83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128, 190, 80, 35, 99, 180, 80,
    126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32, 101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15,
    176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64, 32, 41, 20, 117, 151, 142,
    20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,};
const int kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66,
    67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157,};
const int kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,};

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const int kCat3456[4][11] = {{173, 148, 140},
                             {176, 155, 140, 135},
                             {180, 157, 141, 134, 130},
                             {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129}};
const int kCatLen[4] = {3, 4, 5, 11};
const int kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
const int kKeyYModeProba[4] = {145, 156, 163, 128};
const int kKeyUVModeProba[3] = {142, 114, 183};
const int kYModeProba[4] = {112, 86, 140, 37};
const int kUVModeProba[3] = {162, 101, 204};
const int kBModeProba[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
const int kMvProba[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};
const int kMvUpdateProba[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254}};
const int kModeContexts[6][4] = {{7, 1, 1, 143},     {14, 18, 14, 107},   {135, 64, 57, 68},
                                 {60, 56, 128, 65},  {159, 134, 128, 34}, {234, 188, 128, 28}};
const int kSubmvProba[5][3] = {{147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
const int kSplitProba[3] = {110, 111, 150};
const int kMbSplits[5][16] = {{0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
                              {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
                              {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
                              {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
                              {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
const int kMbFirstIdx[4][16] = {{0, 8}, {0, 2}, {0, 2, 8, 10},
                                {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
const int kMbSplitCount[4] = {2, 2, 4, 16};
const int kSubpelFilters[7][6] = {{0, 6, 123, 12, 1, 0}, {2, 11, 108, 36, 8, 1}, {0, 9, 93, 50, 6, 0},
                                  {3, 16, 77, 77, 16, 3}, {0, 6, 50, 93, 9, 0}, {1, 8, 36, 108, 11, 2},
                                  {0, 1, 12, 123, 6, 0}};
const int kMargin = 16 << 2;

enum { NONE = -1, CURRENT = 0, PREVIOUS = 1, GOLDEN = 2, ALTREF = 3 };
enum { MODE_BPRED = 4, MODE_ZERO = 5, MODE_MV = 6, MODE_SPLIT = 7 };
enum { SPLIT_16x8 = 0, SPLIT_8x16 = 1, SPLIT_8x8 = 2, SPLIT_4x4 = 3, SPLIT_NONE = 4 };

int norm_shift(int r) {
  int s = 0;
  while (r < 128) r <<= 1, ++s;
  return s;
}

int hev_threshold(bool key, int level) {
  if (key) return level >= 40 ? 2 : level >= 15 ? 1 : 0;
  return level >= 40 ? 3 : level >= 20 ? 2 : level >= 15 ? 1 : 0;
}

int int16(long long v) { return static_cast<int>(((v + 32768) & 0xFFFF) - 32768); }

std::string hex(const uint8_t* p, int n) {
  static const char* digits = "0123456789abcdef";
  std::string s;
  for (int i = 0; i < n; ++i) s += digits[p[i] >> 4], s += digits[p[i] & 15];
  return s;
}

// -- the boolean decoder (vp8.BoolReader, vp8.range_decoder, vp8.rac_is_end) --

struct Reader {
  const uint8_t* buf = nullptr;
  long long start = 0, pos = 0, end = 0, size = 0;
  uint32_t value = 0;
  int bits = -8, rng = 254, eof = 0, sh = 0, end_reached = 0;

  void load() {
    if (pos < end) {
      value = (value << 8) | buf[pos++];
    } else {
      value <<= 8;
      ++eof;
    }
    bits += 8;
  }
  int bit(int prob) {
    if (bits < 0) load();
    int p = bits;
    uint32_t split = (static_cast<uint32_t>(rng) * static_cast<uint32_t>(prob)) >> 8;
    int r, b;
    if ((value >> p) > split) {
      r = rng - static_cast<int>(split);
      value -= (split + 1) << p;
      b = 1;
    } else {
      r = static_cast<int>(split) + 1;
      b = 0;
    }
    sh = norm_shift(r);
    rng = (r << sh) - 1;
    bits = p - sh;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit(0x80);
    return v;
  }
  int signed_value(int n) {
    int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

// ff_vpx_init_range_decoder over data[start, start + size) of a frame of n bytes
Reader range_decoder(const uint8_t* data, long long n, long long start, long long size) {
  if (size < 1) fail("an empty partition");
  long long len = size <= 3 ? 3 : 3 + 2 * ((size - 2) / 2);
  Reader r;
  r.buf = data;
  r.start = r.pos = start;
  r.end = std::max(start, std::min(start + len, n));
  r.size = len;
  r.load();
  return r;
}

bool rac_is_end(Reader& r) {
  long long used = 8 * (r.pos - r.start + r.eof) - 8 - r.bits - r.sh;
  if (used >= 8 * r.size - 8) ++r.end_reached;
  return r.end_reached > 10;
}

// -- tokens (vp8.coeffs, vp8.mb_coeffs) -----------------------------------------

typedef uint8_t Bands[4][17][3][11];

int coeffs(Reader& br, const uint8_t (*probs)[3][11], int ctx, const int dq[2], int n, int* out) {
  const uint8_t* p = probs[n][ctx];
  int result = 16;
  while (n < 16) {
    if (!br.bit(p[0])) {
      result = n;
      break;
    }
    while (!br.bit(p[1])) {
      ++n;
      if (n == 16) break;
      p = probs[n][0];
    }
    if (n == 16) break;
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = probs[n + 1][1];
    } else {
      if (!br.bit(p[3])) {
        v = br.bit(p[4]) ? 3 + br.bit(p[5]) : 2;
      } else if (!br.bit(p[6])) {
        if (br.bit(p[7])) {
          v = 7 + 2 * br.bit(165);
          v += br.bit(145);
        } else {
          v = 5 + br.bit(159);
        }
      } else {
        int b1 = br.bit(p[8]);
        int cat = 2 * b1 + br.bit(p[9 + b1]);
        v = 0;
        for (int i = 0; i < kCatLen[cat]; ++i) v += v + br.bit(kCat3456[cat][i]);
        v += 3 + (8 << cat);
      }
      p = probs[n + 1][2];
    }
    if (br.bit(0x80)) v = -v;
    out[kZigzag[n]] = int16(static_cast<long long>(v) * dq[n > 0]);
    ++n;
  }
  return result;
}

struct Quant {
  int y1[2], y2[2], uv[2];
};

std::vector<int> wht(const int* dc) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = dc[i] + dc[12 + i], a1 = dc[4 + i] + dc[8 + i];
    int a2 = dc[4 + i] - dc[8 + i], a3 = dc[i] - dc[12 + i];
    tmp[i] = a0 + a1, tmp[8 + i] = a0 - a1, tmp[4 + i] = a3 + a2, tmp[12 + i] = a3 - a2;
  }
  std::vector<int> out(16);
  for (int i = 0; i < 4; ++i) {
    int d = tmp[4 * i] + 3;
    int a0 = d + tmp[3 + 4 * i], a1 = tmp[1 + 4 * i] + tmp[2 + 4 * i];
    int a2 = tmp[1 + 4 * i] - tmp[2 + 4 * i], a3 = d - tmp[3 + 4 * i];
    out[4 * i] = (a0 + a1) >> 3, out[4 * i + 1] = (a3 + a2) >> 3;
    out[4 * i + 2] = (a0 - a1) >> 3, out[4 * i + 3] = (a3 - a2) >> 3;
  }
  return out;
}

// the libavcodec nnz_total of one macroblock's tokens; top and left: [the
// 4 luma + 2 u + 2 v context bits, the Y2 bit]
int mb_coeffs(Reader& br, int* out, const Bands& bands, const Quant& q, bool y2, int* top, int* left) {
  int total = 0, first = 0, ac = 3;
  if (y2) {
    int dc[16] = {0};
    int nz = coeffs(br, bands[1], top[1] + left[1], q.y2, 0, dc);
    top[1] = left[1] = nz > 0;
    total += nz;
    std::vector<int> vals(16, (dc[0] + 3) >> 3);
    if (nz > 1) vals = wht(dc);
    for (int i = 0; i < 16; ++i) out[16 * i] = int16(vals[i]);
    first = 1, ac = 0;
  }
  int tnz = top[0] & 0x0F, lnz = left[0] & 0x0F;
  for (int y = 0; y < 4; ++y) {
    int lb = lnz & 1;
    for (int x = 0; x < 4; ++x) {
      int k = 16 * (4 * y + x);
      int nz = coeffs(br, bands[ac], lb + (tnz & 1), q.y1, first, out + k);
      lb = nz > first;
      tnz = (tnz >> 1) | (lb << 7);
      total += nz > first ? nz : 0;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (lb << 7);
  }
  int out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch <= 2; ch += 2) {
    tnz = top[0] >> (4 + ch);
    lnz = left[0] >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int lb = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        int k = 256 + 16 * (2 * ch + 2 * y + x);
        int nz = coeffs(br, bands[2], lb + (tnz & 1), q.uv, 0, out + k);
        lb = nz > 0;
        tnz = (tnz >> 1) | (lb << 3);
        total += nz;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (lb << 5);
    }
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xF0) << ch;
  }
  top[0] = out_t, left[0] = out_l;
  return total;
}

Quant quantizers(int q, const int* deltas) {
  auto clip = [](int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; };
  Quant out;
  int y2_ac = (kAcTable[clip(q + deltas[2], 127)] * 101581) >> 16;
  out.y1[0] = kDcTable[clip(q + deltas[0], 127)], out.y1[1] = kAcTable[clip(q, 127)];
  out.y2[0] = kDcTable[clip(q + deltas[1], 127)] * 2, out.y2[1] = std::max(8, y2_ac);
  out.uv[0] = kDcTable[clip(q + deltas[3], 117)], out.uv[1] = kAcTable[clip(q + deltas[4], 127)];
  return out;
}

// -- transforms and predictors (vp8.residuals, vp8.pred4, vp8.pred_block) -----

// libavcodec's x86 vp8_idct_add (SSE): every sum wraps at 16 bits, MUL_35468(a)
// is the high half of 2a (wrapped) times 17734 (vp8.residuals with lanes16)
long long mul1(long long a) { return int16(((a * 20091) >> 16) + a); }
long long mul2(long long a) { return (static_cast<long long>(int16(2 * a)) * 17734) >> 16; }

// TransformOne: out[4 * row + column], clipped to +-256 as the reconstruction uses it
void residual(const int* in, int* out) {
  long long tmp[4][4];
  for (int i = 0; i < 4; ++i) {
    long long a = int16(in[i] + in[8 + i]), b = int16(in[i] - in[8 + i]);
    long long c = int16(mul2(in[4 + i]) - mul1(in[12 + i]));
    long long d = int16(mul1(in[4 + i]) + mul2(in[12 + i]));
    tmp[0][i] = int16(a + d), tmp[1][i] = int16(b + c), tmp[2][i] = int16(b - c), tmp[3][i] = int16(a - d);
  }
  for (int j = 0; j < 4; ++j) {
    long long dc = int16(tmp[j][0] + 4);
    long long a = int16(dc + tmp[j][2]), b = int16(dc - tmp[j][2]);
    long long c = int16(mul2(tmp[j][1]) - mul1(tmp[j][3]));
    long long d = int16(mul1(tmp[j][1]) + mul2(tmp[j][3]));
    long long v[4] = {int16(a + d) >> 3, int16(b + c) >> 3, int16(b - c) >> 3, int16(a - d) >> 3};
    for (int k = 0; k < 4; ++k) out[4 * j + k] = static_cast<int>(std::min(256LL, std::max(-256LL, v[k])));
  }
}

int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// the ten 4x4 predictors: t the 8 pixels above, lf the 4 to the left, x the corner
void pred4(int mode, const int* t, const int* lf, int x, int* o) {
  int A = t[0], B = t[1], C = t[2], D = t[3], E = t[4], F = t[5], G = t[6], H = t[7];
  int I = lf[0], J = lf[1], K = lf[2], L = lf[3];
  switch (mode) {
    case 0: {
      int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int i = 0; i < 16; ++i) o[i] = v;
      return;
    }
    case 1:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) o[4 * r + c] = clip255(t[c] + lf[r] - x);
      return;
    case 2: {
      int row[4] = {avg3(x, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 16; ++i) o[i] = row[i & 3];
      return;
    }
    case 3: {
      int rows[4] = {avg3(x, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int i = 0; i < 16; ++i) o[i] = rows[i >> 2];
      return;
    }
    case 4: {
      int d[7] = {avg3(J, K, L), avg3(I, J, K), avg3(x, I, J), avg3(A, x, I),
                  avg3(B, A, x), avg3(C, B, A), avg3(D, C, B)};
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) o[4 * r + c] = d[c - r + 3];
      return;
    }
    case 5:
      o[0] = o[9] = (x + A + 1) >> 1;
      o[1] = o[10] = (A + B + 1) >> 1;
      o[2] = o[11] = (B + C + 1) >> 1;
      o[3] = (C + D + 1) >> 1;
      o[12] = avg3(K, J, I);
      o[8] = avg3(J, I, x);
      o[4] = o[13] = avg3(I, x, A);
      o[5] = o[14] = avg3(x, A, B);
      o[6] = o[15] = avg3(A, B, C);
      o[7] = avg3(B, C, D);
      return;
    case 6: {
      int d[7] = {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E), avg3(D, E, F),
                  avg3(E, F, G), avg3(F, G, H), avg3(G, H, H)};
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) o[4 * r + c] = d[c + r];
      return;
    }
    case 7:
      o[0] = (A + B + 1) >> 1;
      o[1] = o[8] = (B + C + 1) >> 1;
      o[2] = o[9] = (C + D + 1) >> 1;
      o[3] = o[10] = (D + E + 1) >> 1;
      o[4] = avg3(A, B, C);
      o[5] = o[12] = avg3(B, C, D);
      o[6] = o[13] = avg3(C, D, E);
      o[7] = o[14] = avg3(D, E, F);
      o[11] = avg3(E, F, G);
      o[15] = avg3(F, G, H);
      return;
    case 8:
      o[0] = o[6] = (I + x + 1) >> 1;
      o[4] = o[10] = (J + I + 1) >> 1;
      o[8] = o[14] = (K + J + 1) >> 1;
      o[12] = (L + K + 1) >> 1;
      o[3] = avg3(A, B, C);
      o[2] = avg3(x, A, B);
      o[1] = o[7] = avg3(I, x, A);
      o[5] = o[11] = avg3(J, I, x);
      o[9] = o[15] = avg3(K, J, I);
      o[13] = avg3(L, K, J);
      return;
    default:
      for (int i = 0; i < 16; ++i) o[i] = L;
      o[0] = (I + J + 1) >> 1;
      o[2] = o[4] = (J + K + 1) >> 1;
      o[6] = o[8] = (K + L + 1) >> 1;
      o[1] = avg3(I, J, K);
      o[3] = o[5] = avg3(J, K, L);
      o[7] = o[9] = avg3(K, L, L);
      return;
  }
}

// the 16x16 luma or 8x8 chroma predictor (DC with its border variants, TM, V, H)
void pred_block(int mode, int size, const int* t, const int* lf, int x, int mb_x, int mb_y, int* o) {
  if (mode == 0) {
    int shift = size == 16 ? 4 : 3, v, st = 0, sl = 0;
    for (int i = 0; i < size; ++i) st += t[i], sl += lf[i];
    if (mb_x && mb_y) v = (st + sl + size) >> (shift + 1);
    else if (mb_y) v = (st + (size >> 1)) >> shift;
    else if (mb_x) v = (sl + (size >> 1)) >> shift;
    else v = 128;
    for (int i = 0; i < size * size; ++i) o[i] = v;
  } else if (mode == 1) {
    for (int r = 0; r < size; ++r)
      for (int c = 0; c < size; ++c) o[size * r + c] = clip255(t[c] + lf[r] - x);
  } else if (mode == 2) {
    for (int r = 0; r < size; ++r)
      for (int c = 0; c < size; ++c) o[size * r + c] = t[c];
  } else {
    for (int r = 0; r < size; ++r)
      for (int c = 0; c < size; ++c) o[size * r + c] = lf[r];
  }
}

// -- the loop filter (vp8.filter_lines, vp8.loop_filter) ------------------------

int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// one line across an edge: px[step * k] for k = -4..3 are p3..q3; kind 0
// simple, 1 a macroblock edge, 2 an inner edge
void filter_line(uint8_t* px, long step, int thresh, int ithresh, int hev_t, int kind) {
  int p3 = px[-4 * step], p2 = px[-3 * step], p1 = px[-2 * step], p0 = px[-step];
  int q0 = px[0], q1 = px[step], q2 = px[2 * step], q3 = px[3 * step];
  bool mask = 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= 2 * thresh + 1;
  bool hev;
  if (kind == 0) {
    hev = mask;
  } else {
    int it = ithresh;
    mask = mask && std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
    hev = mask && (std::abs(p1 - p0) > hev_t || std::abs(q1 - q0) > hev_t);
  }
  if (hev) {
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    px[-step] = static_cast<uint8_t>(clip255(p0 + a2));
    px[0] = static_cast<uint8_t>(clip255(q0 - a1));
  }
  if (kind == 0 || !mask || hev) return;
  if (kind == 1) {
    int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    px[-3 * step] = static_cast<uint8_t>(clip255(p2 + a3));
    px[-2 * step] = static_cast<uint8_t>(clip255(p1 + a2));
    px[-step] = static_cast<uint8_t>(clip255(p0 + a1));
    px[0] = static_cast<uint8_t>(clip255(q0 - a1));
    px[step] = static_cast<uint8_t>(clip255(q1 - a2));
    px[2 * step] = static_cast<uint8_t>(clip255(q2 - a3));
  } else {
    int a = 3 * (q0 - p0);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    int a3 = (a1 + 1) >> 1;
    px[-2 * step] = static_cast<uint8_t>(clip255(p1 + a3));
    px[-step] = static_cast<uint8_t>(clip255(p0 + a2));
    px[0] = static_cast<uint8_t>(clip255(q0 - a1));
    px[step] = static_cast<uint8_t>(clip255(q1 - a3));
  }
}

// -- the decoder (vp8.Vp8Decoder) ------------------------------------------------

struct Frame {
  int w, h, cw, ch;  // macroblock-aligned luma and chroma sizes
  std::vector<uint8_t> plane[3];
  Frame(int mbw, int mbh) : w(16 * mbw), h(16 * mbh), cw(8 * mbw), ch(8 * mbh) {
    plane[0].assign(static_cast<size_t>(w) * h, 0);
    plane[1].assign(static_cast<size_t>(cw) * ch, 0);
    plane[2].assign(static_cast<size_t>(cw) * ch, 0);
  }
};

struct Mv {
  int y = 0, x = 0;
  bool operator==(const Mv& o) const { return y == o.y && x == o.x; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
  bool zero() const { return !y && !x; }
};

struct Mb {
  int segment = 0, skip = 0, ref = CURRENT, mode = 0, uvmode = 0, part = SPLIT_NONE;
  bool i4x4 = false;
  int modes[16] = {0};
  Mv mv;
  Mv bmv[16];
  int filter[4] = {0, 0, 0, 0};  // limit, interior limit, hev threshold, inner edges
};

struct Probs {
  int token[4][8][3][11];
  int ymode[4], uvmode[3], mv[2][19];
};

struct FrameHeader {
  bool key;
  int profile, skip_p, p_intra, p_last, p_golden, level, sharpness;
  int seg_proba[3];
  Quant quant[4];
  Bands bands;
};

// vp8.motion_block: the (bh, bw) prediction at (x, y) moved by mv
void motion_block(const uint8_t* plane, int pw, int ph, int x, int y, int bw, int bh, Mv mv, bool luma,
                  bool bilinear, int* out, int stride) {
  int fx, fy;
  if (luma) {
    fx = (mv.x * 2) & 7, fy = (mv.y * 2) & 7, x += mv.x >> 2, y += mv.y >> 2;
  } else {
    fx = mv.x & 7, fy = mv.y & 7, x += mv.x >> 3, y += mv.y >> 3;
  }
  int s[21][21], t[21][16];
  for (int r = 0; r < bh + 5; ++r) {
    int yy = std::min(std::max(y - 2 + r, 0), ph - 1);
    for (int c = 0; c < bw + 5; ++c) s[r][c] = plane[static_cast<size_t>(yy) * pw + std::min(std::max(x - 2 + c, 0), pw - 1)];
  }
  for (int r = 0; r < bh + 5; ++r)
    for (int c = 0; c < bw; ++c) {
      if (!fx) {
        t[r][c] = s[r][c + 2];
      } else if (bilinear) {
        t[r][c] = ((8 - fx) * s[r][c + 2] + fx * s[r][c + 3] + 4) >> 3;
      } else {
        const int* f = kSubpelFilters[fx - 1];
        int v = f[0] * s[r][c] - f[1] * s[r][c + 1] + f[2] * s[r][c + 2] + f[3] * s[r][c + 3] -
                f[4] * s[r][c + 4] + f[5] * s[r][c + 5];
        t[r][c] = clip255((v + 64) >> 7);
      }
    }
  for (int r = 0; r < bh; ++r)
    for (int c = 0; c < bw; ++c) {
      int v;
      if (!fy) {
        v = t[r + 2][c];
      } else if (bilinear) {
        v = ((8 - fy) * t[r + 2][c] + fy * t[r + 3][c] + 4) >> 3;
      } else {
        const int* f = kSubpelFilters[fy - 1];
        int a = f[0] * t[r][c] - f[1] * t[r + 1][c] + f[2] * t[r + 2][c] + f[3] * t[r + 3][c] -
                f[4] * t[r + 4][c] + f[5] * t[r + 5][c];
        v = clip255((a + 64) >> 7);
      }
      out[r * stride + c] = v;
    }
}

const int* submv_proba(Mv left, Mv above) {
  if (left == above) return kSubmvProba[4 - !left.zero()];
  if (above.zero()) return kSubmvProba[2];
  return kSubmvProba[1 - !left.zero()];
}

int read_mv(Reader& br, const int* p) {
  int x = 0;
  if (br.bit(p[0])) {
    for (int i = 0; i < 3; ++i) x += br.bit(p[9 + i]) << i;
    for (int i = 9; i > 3; --i) x += br.bit(p[9 + i]) << i;
    if (!(x & 0xFFF0) || br.bit(p[12])) x += 8;
  } else {
    int b = br.bit(p[2]);
    int j = 3 + 3 * b;
    x = 4 * b;
    b = br.bit(p[j]);
    j += 1 + b, x += 2 * b;
    x += br.bit(p[j]);
  }
  return x && br.bit(p[1]) ? -x : x;
}

struct Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::shared_ptr<Frame> refs[4];
  std::vector<int> prev_seg;
  bool has_prev_seg = false;
  int sign_bias[4] = {0, 0, 0, 0};
  int full_range = 0;
  Probs prob;
  struct {
    int enabled = 0, update_map = 0, absolute = 0, quant[4] = {0}, lf[4] = {0};
  } seg;
  struct {
    int enabled = 0, ref[4] = {0}, mode[4] = {0};
  } lf_delta;
  std::string error;
  int out_w = 0, out_h = 0;
  std::shared_ptr<Frame> shown;

  Decoder() { reset(); }

  void reset() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) prob.token[t][b][c][p] = kCoeffsProba0[t][b][c][p];
    for (int i = 0; i < 4; ++i) prob.ymode[i] = kYModeProba[i];
    for (int i = 0; i < 3; ++i) prob.uvmode[i] = kUVModeProba[i];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 19; ++j) prob.mv[i][j] = kMvProba[i][j];
    seg.enabled = seg.update_map = seg.absolute = 0;
    for (int i = 0; i < 4; ++i) seg.quant[i] = seg.lf[i] = 0;
    lf_delta.enabled = 0;
    for (int i = 0; i < 4; ++i) lf_delta.ref[i] = lf_delta.mode[i] = 0;
  }

  std::vector<Reader> partitions(const uint8_t* data, long long n, long long pos, long long size, int count) {
    long long at = pos;
    pos += 3 * (count - 1), size -= 3 * (count - 1);
    if (size < 0) fail("the sizes of " + std::to_string(count) + " token partitions run past the frame");
    std::vector<Reader> parts;
    for (int i = 0; i < count - 1; ++i) {
      long long s = data[at + 3 * i] | data[at + 3 * i + 1] << 8 | data[at + 3 * i + 2] << 16;
      if (size - s < 0)
        fail("token partition " + std::to_string(i) + " of " + std::to_string(s) + " bytes runs past the frame");
      parts.push_back(range_decoder(data, n, pos, s));
      pos += s, size -= s;
    }
    parts.push_back(range_decoder(data, n, pos, size));
    return parts;
  }

  // 1 for a shown frame (its planes by vk_vp8_planes), 0 for a hidden one
  int decode(const uint8_t* data, long long n) {
    if (n < 3) fail("a frame of " + std::to_string(n) + " bytes, short of its tag");
    int tag = data[0] | data[1] << 8 | data[2] << 16;
    bool key = !(tag & 1);
    int profile = (tag >> 1) & 7, show = (tag >> 4) & 1;
    long long part0 = tag >> 5;
    long long pos = 3, size = n - 3;
    if (part0 > size - 7 * key)
      fail("a first partition of " + std::to_string(part0) + " bytes in a frame of " + std::to_string(n));
    int w = width, h = height;
    if (key) {
      if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
        fail("a key frame's start code " + hex(data + 3, 3) + ", not 9d012a");
      w = (data[6] | data[7] << 8) & 0x3FFF;
      h = (data[8] | data[9] << 8) & 0x3FFF;
      pos = 10, size = n - 10;
      reset();
    }
    Reader br = range_decoder(data, n, pos, part0);
    pos += part0, size -= part0;
    if (key) {
      br.bit(128);
      full_range = br.bit(128);
    }
    FrameHeader fr;
    fr.key = key, fr.profile = profile;
    seg.enabled = br.bit(128);
    fr.seg_proba[0] = fr.seg_proba[1] = fr.seg_proba[2] = 255;
    if (seg.enabled) {
      seg.update_map = br.bit(128);
      if (br.bit(128)) {
        seg.absolute = br.bit(128);
        for (int i = 0; i < 4; ++i) seg.quant[i] = br.bit(128) ? br.signed_value(7) : 0;
        for (int i = 0; i < 4; ++i) seg.lf[i] = br.bit(128) ? br.signed_value(6) : 0;
      }
      if (seg.update_map)
        for (int i = 0; i < 3; ++i) fr.seg_proba[i] = br.bit(128) ? br.value_bits(8) : 255;
    } else {
      seg.update_map = 0;
    }
    int simple = br.bit(128);
    fr.level = br.value_bits(6);
    fr.sharpness = br.value_bits(3);
    lf_delta.enabled = br.bit(128);
    if (lf_delta.enabled && br.bit(128)) {
      for (int i = 0; i < 4; ++i)
        if (br.bit(128)) lf_delta.ref[i] = br.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.bit(128)) lf_delta.mode[i] = br.signed_value(6);
    }
    int n_parts = 1 << br.value_bits(2);
    std::vector<Reader> parts = partitions(data, n, pos, size, n_parts);
    if (!mb_w || w != width || h != height) {
      if (mb_w)
        fail("a key frame of " + std::to_string(w) + "x" + std::to_string(h) + " after frames of " +
                 std::to_string(width) + "x" + std::to_string(height) +
                 ": cv2 returns it at the first size; the port refuses a change of size",
             -2);
      for (auto& r : refs) r.reset();
      has_prev_seg = false;
      if (!w || !h) fail("a frame of " + std::to_string(w) + "x" + std::to_string(h));
      width = w, height = h;
      mb_w = (w + 15) >> 4, mb_h = (h + 15) >> 4;
    }
    int base_q = br.value_bits(7);
    int deltas[5];
    for (int i = 0; i < 5; ++i) deltas[i] = br.bit(128) ? br.signed_value(4) : 0;
    for (int s = 0; s < 4; ++s) {
      int q = seg.enabled ? seg.quant[s] + (seg.absolute ? 0 : base_q) : base_q;
      fr.quant[s] = quantizers(q, deltas);
    }
    int update_golden = CURRENT, update_altref = CURRENT;
    if (!key) {
      int refresh_golden = br.bit(128), refresh_altref = br.bit(128);
      if (!refresh_golden) {
        int v = br.value_bits(2);
        update_golden = v == 1 ? PREVIOUS : v == 2 ? ALTREF : NONE;
      }
      if (!refresh_altref) {
        int v = br.value_bits(2);
        update_altref = v == 1 ? PREVIOUS : v == 2 ? GOLDEN : NONE;
      }
      sign_bias[GOLDEN] = br.bit(128);
      sign_bias[ALTREF] = br.bit(128);
    }
    int keep_probs = br.bit(128);
    Probs saved = prob;
    int update_last = key ? 1 : br.bit(128);
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            if (br.bit(kCoeffsUpdateProba[t][b][c][p])) prob.token[t][b][c][p] = br.value_bits(8);
    fr.skip_p = br.bit(128) ? br.value_bits(8) : -1;
    if (!key) {
      fr.p_intra = br.value_bits(8), fr.p_last = br.value_bits(8), fr.p_golden = br.value_bits(8);
      if (br.bit(128))
        for (int i = 0; i < 4; ++i) prob.ymode[i] = br.value_bits(8);
      if (br.bit(128))
        for (int i = 0; i < 3; ++i) prob.uvmode[i] = br.value_bits(8);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 19; ++j)
          if (br.bit(kMvUpdateProba[i][j])) {
            int v = br.value_bits(7) << 1;
            prob.mv[i][j] = v ? v : 1;
          }
    }
    std::vector<int> prev = prev_seg;
    bool have_prev = has_prev_seg;
    has_prev_seg = false;
    for (int t = 0; t < 4; ++t)
      for (int p = 0; p < 17; ++p)
        for (int c = 0; c < 3; ++c)
          for (int k = 0; k < 11; ++k) fr.bands[t][p][c][k] = static_cast<uint8_t>(prob.token[t][kBands[p]][c][k]);
    std::vector<Mb> mbs;
    std::vector<int> coeff;
    std::vector<int> seg_map;
    int rows = macroblocks(br, parts, fr, have_prev ? &prev : nullptr, mbs, coeff, seg_map);
    auto cur = std::make_shared<Frame>(mb_w, mb_h);
    reconstruct(*cur, mbs, coeff, profile);
    loop_filter(*cur, mbs, rows, fr.level == 0 ? 0 : simple ? 1 : 2);
    std::shared_ptr<Frame> old[4] = {cur, refs[PREVIOUS], refs[GOLDEN], refs[ALTREF]};
    refs[CURRENT] = cur;
    refs[PREVIOUS] = update_last ? cur : old[PREVIOUS];
    refs[GOLDEN] = update_golden != NONE ? old[update_golden] : old[GOLDEN];
    refs[ALTREF] = update_altref != NONE ? old[update_altref] : old[ALTREF];
    prev_seg = seg_map;
    has_prev_seg = true;
    if (!keep_probs) prob = saved;
    if (!show) return 0;
    shown = cur;
    out_w = width, out_h = height;
    return 1;
  }

  int macroblocks(Reader& br, std::vector<Reader>& parts, const FrameHeader& fr, const std::vector<int>* prev,
                  std::vector<Mb>& mbs, std::vector<int>& coeff, std::vector<int>& seg_map) {
    int n_mb = mb_w * mb_h;
    coeff.assign(static_cast<size_t>(n_mb) * 384, 0);
    seg_map.assign(n_mb, 0);
    mbs.reserve(n_mb);
    std::vector<int> top_nz(2 * mb_w, 0), intra_t(4 * mb_w, 0);
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      if (rac_is_end(br)) return mb_y;
      Reader& cr = parts[mb_y & (parts.size() - 1)];
      int left_nz[2] = {0, 0};
      int intra_l[4] = {0, 0, 0, 0};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        if (rac_is_end(br) || rac_is_end(cr)) return mb_y;
        int i = mb_y * mb_w + mb_x;
        Mb mb = mb_mode(br, fr, i, mb_x, mb_y, mbs, intra_t.data() + 4 * mb_x, intra_l, prev);
        seg_map[i] = mb.segment;
        bool y2 = mb.mode != MODE_BPRED && mb.mode != MODE_SPLIT;
        if (!mb.skip) {
          int total = mb_coeffs(cr, coeff.data() + 384 * static_cast<size_t>(i), fr.bands, fr.quant[mb.segment], y2,
                                top_nz.data() + 2 * mb_x, left_nz);
          mb.skip = total == 0;
        } else {
          top_nz[2 * mb_x] = left_nz[0] = 0;
          if (y2) top_nz[2 * mb_x + 1] = left_nz[1] = 0;
        }
        filter_strength(mb, fr);
        mbs.push_back(mb);
      }
    }
    return mb_h;
  }

  Mb mb_mode(Reader& br, const FrameHeader& fr, int i, int mb_x, int mb_y, const std::vector<Mb>& mbs, int* top,
             int* intra_l, const std::vector<int>* prev) {
    Mb mb;
    if (seg.update_map) {
      int b = br.bit(fr.seg_proba[0]);
      mb.segment = br.bit(fr.seg_proba[1 + b]) + 2 * b;
    } else if (seg.enabled && prev) {
      mb.segment = (*prev)[i];
    }
    mb.skip = fr.skip_p >= 0 ? br.bit(fr.skip_p) : 0;
    if (fr.key) {
      if (br.bit(kKeyYModeProba[0])) {
        int ymode = br.bit(kKeyYModeProba[1]) ? (br.bit(kKeyYModeProba[3]) ? 1 : 3)
                                              : (br.bit(kKeyYModeProba[2]) ? 2 : 0);
        for (int k = 0; k < 4; ++k) top[k] = intra_l[k] = ymode;
        mb.i4x4 = false, mb.modes[0] = ymode, mb.mode = ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ym = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[top[x]][ym];
            int k = kYModesIntra4[br.bit(prob[0])];
            while (k > 0) k = kYModesIntra4[2 * k + br.bit(prob[k])];
            ym = -k;
            top[x] = ym;
            mb.modes[4 * y + x] = ym;
          }
          intra_l[y] = ym;
        }
        mb.i4x4 = true, mb.mode = MODE_BPRED;
      }
      mb.uvmode = uv_mode(br, kKeyUVModeProba);
    } else if (br.bit(fr.p_intra)) {
      mb.ref = br.bit(fr.p_last) ? (br.bit(fr.p_golden) ? ALTREF : GOLDEN) : PREVIOUS;
      mb.i4x4 = false, mb.modes[0] = 0, mb.uvmode = 0;
      mvs(br, mb, mb_x, mb_y, mbs);
    } else {
      const int* p = prob.ymode;
      int ymode;
      if (!br.bit(p[0])) ymode = 0;
      else if (!br.bit(p[1])) ymode = br.bit(p[2]) ? 3 : 2;
      else ymode = br.bit(p[3]) ? MODE_BPRED : 1;
      mb.modes[0] = ymode;
      if (ymode == MODE_BPRED) {
        for (int n = 0; n < 16; ++n) {
          int k = kYModesIntra4[br.bit(kBModeProba[0])];
          while (k > 0) k = kYModesIntra4[2 * k + br.bit(kBModeProba[k])];
          mb.modes[n] = -k;
        }
      }
      mb.i4x4 = ymode == MODE_BPRED, mb.mode = ymode;
      mb.uvmode = uv_mode(br, prob.uvmode);
    }
    return mb;
  }

  static int uv_mode(Reader& br, const int* p) {
    return !br.bit(p[0]) ? 0 : !br.bit(p[1]) ? 2 : br.bit(p[2]) ? 1 : 3;
  }

  void mvs(Reader& br, Mb& mb, int mb_x, int mb_y, const std::vector<Mb>& mbs) {
    static const Mb outside = [] {
      Mb o;
      o.part = SPLIT_16x8;
      return o;
    }();
    const Mb& top = mb_y ? mbs[mbs.size() - mb_w] : outside;
    const Mb& left = mb_x ? mbs[mbs.size() - 1] : outside;
    const Mb& top_left = mb_x && mb_y ? mbs[mbs.size() - mb_w - 1] : outside;
    Mv near[4];
    int cnt[4] = {0, 0, 0, 0}, idx = 0;
    int bias = sign_bias[mb.ref];
    const Mb* edges[3] = {&top, &left, &top_left};
    for (int n = 0; n < 3; ++n) {
      const Mb& edge = *edges[n];
      if (edge.ref == CURRENT) continue;
      Mv mv = edge.mv;
      int weight = n == 2 ? 1 : 2;
      if (!mv.zero()) {
        if (bias != sign_bias[edge.ref]) mv.y = -mv.y, mv.x = -mv.x;
        if (!n || mv != near[idx]) near[++idx] = mv;
        cnt[idx] += weight;
      } else {
        cnt[0] += weight;
      }
    }
    mb.part = SPLIT_NONE;
    if (!br.bit(kModeContexts[cnt[0]][0])) {
      mb.mode = MODE_ZERO, mb.mv = Mv(), mb.bmv[0] = Mv();
      return;
    }
    mb.mode = MODE_MV;
    if (cnt[3] && near[1] == near[3]) cnt[1] += 1;
    if (cnt[2] > cnt[1]) std::swap(cnt[1], cnt[2]), std::swap(near[1], near[2]);
    int lo_x = -kMargin - 64 * mb_x, hi_x = ((mb_w - 1 - mb_x) << 6) + kMargin;
    int lo_y = -kMargin - 64 * mb_y, hi_y = ((mb_h - 1 - mb_y) << 6) + kMargin;
    auto clamp = [&](Mv v) {
      Mv o;
      o.y = std::min(std::max(v.y, lo_y), hi_y);
      o.x = std::min(std::max(v.x, lo_x), hi_x);
      return o;
    };
    Mv mv;
    if (!br.bit(kModeContexts[cnt[1]][1])) {
      mv = clamp(near[1]);
    } else if (!br.bit(kModeContexts[cnt[2]][2])) {
      mv = clamp(near[2]);
    } else {
      Mv best = clamp(near[cnt[1] >= cnt[0] ? 1 : 0]);
      int splits = ((left.mode == MODE_SPLIT) + (top.mode == MODE_SPLIT)) * 2 + (top_left.mode == MODE_SPLIT);
      if (br.bit(kModeContexts[splits][3])) {
        split(br, mb, best, top, left);
        return;
      }
      mv.y = best.y + read_mv(br, prob.mv[0]);
      mv.x = best.x + read_mv(br, prob.mv[1]);
    }
    mb.mv = mv, mb.bmv[0] = mv;
  }

  void split(Reader& br, Mb& mb, Mv best, const Mb& top, const Mb& left) {
    int part;
    if (br.bit(kSplitProba[0])) part = br.bit(kSplitProba[1]) ? SPLIT_16x8 + br.bit(kSplitProba[2]) : SPLIT_8x8;
    else part = SPLIT_4x4;
    const int* cur = kMbSplits[part];
    int num = kMbSplitCount[part];
    for (int n = 0; n < num; ++n) {
      int k = kMbFirstIdx[part][n];
      Mv lmv = !(k & 3) ? left.bmv[kMbSplits[left.part][k + 3]] : mb.bmv[cur[k - 1]];
      Mv amv = k <= 3 ? top.bmv[kMbSplits[top.part][k + 12]] : mb.bmv[cur[k - 4]];
      const int* p = submv_proba(lmv, amv);
      Mv v;
      if (!br.bit(p[0])) v = lmv;
      else if (!br.bit(p[1])) v = amv;
      else if (!br.bit(p[2])) v = Mv();
      else {
        v.y = best.y + read_mv(br, prob.mv[0]);
        v.x = best.x + read_mv(br, prob.mv[1]);
      }
      mb.bmv[n] = v;
    }
    mb.mode = MODE_SPLIT, mb.part = part, mb.mv = mb.bmv[num - 1];
  }

  void filter_strength(Mb& mb, const FrameHeader& fr) {
    int level = fr.level;
    if (seg.enabled) level = seg.lf[mb.segment] + (seg.absolute ? 0 : level);
    if (lf_delta.enabled) {
      level += lf_delta.ref[mb.ref];
      if (mb.mode >= MODE_BPRED) level += lf_delta.mode[mb.mode - MODE_BPRED];
    }
    level = std::min(std::max(level, 0), 63);
    if (!level) {
      mb.filter[0] = mb.filter[1] = mb.filter[2] = mb.filter[3] = 0;
      return;
    }
    int interior = level;
    if (fr.sharpness) {
      interior >>= (fr.sharpness + 3) >> 2;
      interior = std::min(interior, 9 - fr.sharpness);
    }
    interior = std::max(interior, 1);
    mb.filter[0] = 2 * level + interior, mb.filter[1] = interior;
    mb.filter[2] = hev_threshold(fr.key, level);
    mb.filter[3] = !mb.skip || mb.mode == MODE_BPRED || mb.mode == MODE_SPLIT;
  }

  // vp8.reconstruct with Vp8Decoder._predict for inter macroblocks
  void reconstruct(Frame& f, const std::vector<Mb>& mbs, const std::vector<int>& coeff, int profile) {
    int res[24][16];
    for (size_t i = 0; i < mbs.size(); ++i) {
      const Mb& mb = mbs[i];
      int mb_y = static_cast<int>(i) / mb_w, mb_x = static_cast<int>(i) % mb_w;
      int y0 = 16 * mb_y, x0 = 16 * mb_x;
      for (int b = 0; b < 24; ++b) residual(coeff.data() + 384 * i + 16 * b, res[b]);
      if (mb.ref != CURRENT) {
        int py[256], pu[64], pv[64];
        predict(mb, mb_x, mb_y, profile, py, pu, pv);
        add_block(f.plane[0].data(), f.w, x0, y0, 16, py, res, 0);
        add_block(f.plane[1].data(), f.cw, x0 / 2, y0 / 2, 8, pu, res, 16);
        add_block(f.plane[2].data(), f.cw, x0 / 2, y0 / 2, 8, pv, res, 20);
        continue;
      }
      uint8_t* Y = f.plane[0].data();
      int top[16], tr[4], left[16], corner;
      if (mb_y) {
        const uint8_t* above = Y + static_cast<size_t>(y0 - 1) * f.w;
        for (int k = 0; k < 16; ++k) top[k] = above[x0 + k];
        for (int k = 0; k < 4; ++k) tr[k] = mb_x < mb_w - 1 ? above[x0 + 16 + k] : top[15];
        corner = mb_x ? above[x0 - 1] : 129;
      } else {
        for (int k = 0; k < 16; ++k) top[k] = 127;
        for (int k = 0; k < 4; ++k) tr[k] = 127;
        corner = 127;
      }
      for (int j = 0; j < 16; ++j) left[j] = mb_x ? Y[static_cast<size_t>(y0 + j) * f.w + x0 - 1] : 129;
      if (mb.i4x4) {
        int ws[17][21];
        std::memset(ws, 0, sizeof(ws));
        ws[0][0] = corner;
        for (int k = 0; k < 16; ++k) ws[0][1 + k] = top[k];
        for (int k = 0; k < 4; ++k) ws[0][17 + k] = tr[k];
        for (int j = 0; j < 16; ++j) ws[1 + j][0] = left[j];
        for (int j = 4; j <= 12; j += 4)
          for (int k = 0; k < 4; ++k) ws[j][17 + k] = tr[k];
        for (int n = 0; n < 16; ++n) {
          int r0 = 4 * (n >> 2), c0 = 4 * (n & 3);
          int t[8], lf[4], p[16];
          for (int k = 0; k < 8; ++k) t[k] = ws[r0][c0 + 1 + k];
          for (int k = 0; k < 4; ++k) lf[k] = ws[r0 + 1 + k][c0];
          pred4(mb.modes[n], t, lf, ws[r0][c0], p);
          for (int j = 0; j < 4; ++j)
            for (int k = 0; k < 4; ++k) ws[r0 + 1 + j][c0 + 1 + k] = clip255(p[4 * j + k] + res[n][4 * j + k]);
        }
        for (int j = 0; j < 16; ++j)
          for (int k = 0; k < 16; ++k) Y[static_cast<size_t>(y0 + j) * f.w + x0 + k] = static_cast<uint8_t>(ws[1 + j][1 + k]);
      } else {
        int p[256];
        pred_block(mb.modes[0], 16, top, left, corner, mb_x, mb_y, p);
        add_block(Y, f.w, x0, y0, 16, p, res, 0);
      }
      int cy0 = 8 * mb_y, cx0 = 8 * mb_x;
      for (int pl = 1; pl <= 2; ++pl) {
        uint8_t* P = f.plane[pl].data();
        int ct[8], cl[8], cc;
        if (mb_y) {
          for (int k = 0; k < 8; ++k) ct[k] = P[static_cast<size_t>(cy0 - 1) * f.cw + cx0 + k];
          cc = mb_x ? P[static_cast<size_t>(cy0 - 1) * f.cw + cx0 - 1] : 129;
        } else {
          for (int k = 0; k < 8; ++k) ct[k] = 127;
          cc = 127;
        }
        for (int j = 0; j < 8; ++j) cl[j] = mb_x ? P[static_cast<size_t>(cy0 + j) * f.cw + cx0 - 1] : 129;
        int p[64];
        pred_block(mb.uvmode, 8, ct, cl, cc, mb_x, mb_y, p);
        add_block(P, f.cw, cx0, cy0, 8, p, res, pl == 1 ? 16 : 20);
      }
    }
  }

  // pred (size x size) plus the residual blocks from `first` on, clipped, into the plane
  static void add_block(uint8_t* plane, int stride, int x0, int y0, int size, const int* pred, int res[24][16],
                        int first) {
    int n = size / 4;
    for (int j = 0; j < size; ++j)
      for (int k = 0; k < size; ++k) {
        int v = pred[size * j + k] + res[first + n * (j >> 2) + (k >> 2)][4 * (j & 3) + (k & 3)];
        plane[static_cast<size_t>(y0 + j) * stride + x0 + k] = static_cast<uint8_t>(clip255(v));
      }
  }

  void predict(const Mb& mb, int mb_x, int mb_y, int profile, int* py, int* pu, int* pv) {
    const Frame& ref = *refs[mb.ref];
    bool bilinear = profile != 0, full_pel = profile == 3;
    int x0 = 16 * mb_x, y0 = 16 * mb_y;
    auto chroma = [&](int bx, int by, int bw, int bh, Mv mv) {
      if (full_pel) mv.y &= ~7, mv.x &= ~7;
      motion_block(ref.plane[1].data(), ref.cw, ref.ch, x0 / 2 + bx, y0 / 2 + by, bw, bh, mv, false, bilinear,
                   pu + 8 * by + bx, 8);
      motion_block(ref.plane[2].data(), ref.cw, ref.ch, x0 / 2 + bx, y0 / 2 + by, bw, bh, mv, false, bilinear,
                   pv + 8 * by + bx, 8);
    };
    if (mb.part == SPLIT_4x4) {
      for (int n = 0; n < 16; ++n) {
        int by = 4 * (n >> 2), bx = 4 * (n & 3);
        motion_block(ref.plane[0].data(), ref.w, ref.h, x0 + bx, y0 + by, 4, 4, mb.bmv[n], true, bilinear,
                     py + 16 * by + bx, 16);
      }
      for (int y = 0; y < 2; ++y)
        for (int x = 0; x < 2; ++x) {
          int k = 8 * y + 2 * x;
          int sy = mb.bmv[k].y + mb.bmv[k + 1].y + mb.bmv[k + 4].y + mb.bmv[k + 5].y;
          int sx = mb.bmv[k].x + mb.bmv[k + 1].x + mb.bmv[k + 4].x + mb.bmv[k + 5].x;
          Mv mv;
          mv.y = (sy + 2 + (sy < 0 ? -1 : 0)) >> 2;
          mv.x = (sx + 2 + (sx < 0 ? -1 : 0)) >> 2;
          chroma(4 * x, 4 * y, 4, 4, mv);
        }
      return;
    }
    static const int blocks[5][4][4] = {{{0, 0, 16, 8}, {0, 8, 16, 8}},
                                        {{0, 0, 8, 16}, {8, 0, 8, 16}},
                                        {{0, 0, 8, 8}, {8, 0, 8, 8}, {0, 8, 8, 8}, {8, 8, 8, 8}},
                                        {},
                                        {{0, 0, 16, 16}}};
    int count = mb.part == SPLIT_NONE ? 1 : mb.part == SPLIT_8x8 ? 4 : 2;
    for (int b = 0; b < count; ++b) {
      const int* blk = blocks[mb.part][b];
      int bx = blk[0], by = blk[1], bw = blk[2], bh = blk[3];
      motion_block(ref.plane[0].data(), ref.w, ref.h, x0 + bx, y0 + by, bw, bh, mb.bmv[b], true, bilinear,
                   py + 16 * by + bx, 16);
      chroma(bx / 2, by / 2, bw / 2, bh / 2, mb.bmv[b]);
    }
  }

  // vp8.loop_filter in raster order: the macroblocks of the rows decoded whole
  void loop_filter(Frame& f, const std::vector<Mb>& mbs, int rows, int type) {
    if (!type) return;
    int n = std::min(static_cast<int>(mbs.size()), rows * mb_w);
    for (int i = 0; i < n; ++i) {
      const Mb& mb = mbs[i];
      int limit = mb.filter[0], ilevel = mb.filter[1], hev = mb.filter[2];
      bool inner = mb.filter[3];
      if (limit <= 0) continue;
      int mb_y = i / mb_w, mb_x = i % mb_w;
      int kind_edge = type == 1 ? 0 : 1, kind_inner = type == 1 ? 0 : 2;
      int planes = type == 1 ? 1 : 3;
      for (int pl = 0; pl < planes; ++pl) {
        int size = pl ? 8 : 16, stride = pl ? f.cw : f.w;
        uint8_t* P = f.plane[pl].data();
        int x0 = size * mb_x, y0 = size * mb_y;
        auto vertical_edge = [&](int d, int thresh, int kind) {  // an edge at x0 + d: lines along rows
          for (int r = 0; r < size; ++r)
            filter_line(P + static_cast<size_t>(y0 + r) * stride + x0 + d, 1, thresh, ilevel, hev, kind);
        };
        auto horizontal_edge = [&](int d, int thresh, int kind) {
          for (int c = 0; c < size; ++c)
            filter_line(P + static_cast<size_t>(y0 + d) * stride + x0 + c, stride, thresh, ilevel, hev, kind);
        };
        if (mb_x) vertical_edge(0, limit + 4, kind_edge);
        if (inner)
          for (int d = 4; d < size; d += 4) vertical_edge(d, limit, kind_inner);
        if (mb_y) horizontal_edge(0, limit + 4, kind_edge);
        if (inner)
          for (int d = 4; d < size; d += 4) horizontal_edge(d, limit, kind_inner);
      }
    }
  }
};

}  // namespace

extern "C" {

void* vk_vp8_create() { return new Decoder(); }

void vk_vp8_destroy(void* h) { delete static_cast<Decoder*>(h); }

// Decode one frame: 1 when it is shown (its size in *w, *h; its planes by
// vk_vp8_planes), 0 for a hidden frame, -1 where libavcodec refuses it and
// -2 where the port does (the message by vk_vp8_error).
int vk_vp8_decode(void* h, const unsigned char* data, size_t n, int* w, int* hh) {
  Decoder* d = static_cast<Decoder*>(h);
  g_calls.fetch_add(1);
  try {
    int out = d->decode(data, static_cast<long long>(n));
    *w = d->out_w, *hh = d->out_h;
    return out;
  } catch (const Failure& f) {
    d->error = f.msg;
    return f.status;
  }
}

// The last shown frame's planes cropped to its size: y (h x w), u and v
// ((h + 1) / 2 x (w + 1) / 2).
void vk_vp8_planes(void* h, unsigned char* y, unsigned char* u, unsigned char* v) {
  Decoder* d = static_cast<Decoder*>(h);
  const Frame& f = *d->shown;
  int w = d->out_w, hh = d->out_h, cwo = (w + 1) / 2, cho = (hh + 1) / 2;
  for (int r = 0; r < hh; ++r) std::memcpy(y + static_cast<size_t>(r) * w, f.plane[0].data() + static_cast<size_t>(r) * f.w, w);
  for (int r = 0; r < cho; ++r) {
    std::memcpy(u + static_cast<size_t>(r) * cwo, f.plane[1].data() + static_cast<size_t>(r) * f.cw, cwo);
    std::memcpy(v + static_cast<size_t>(r) * cwo, f.plane[2].data() + static_cast<size_t>(r) * f.cw, cwo);
  }
}

const char* vk_vp8_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

// The last key frame's clamping bit, libavcodec's colour range (1: full).
int vk_vp8_full_range(void* h) { return static_cast<Decoder*>(h)->full_range; }

long long vk_vp8_calls() { return g_calls.load(); }

}  // extern "C"
