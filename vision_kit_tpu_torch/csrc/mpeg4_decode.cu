// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video decoding as host C++.
//
// Host code only (nvcc hands it to the host compiler); plain C interface,
// loaded with ctypes by data/mpeg4.py (_CDecoder). It is the counterpart of
// data/mpeg4.py's Mpeg4Decoder, the plain decoder, and gives the same
// planes and the same refusals (the same messages): the demo's video path
// on the card decodes each VOP here, uploads the planes and converts them
// to RGB on the device (mpeg4.yuv420_to_rgb), where the plain decoder's
// Python loops would take ~0.5 s a 720p VOP.
//
// The same stages in the same order: start codes; VOS, VO and VOL headers
// (the refusals of parse_vol); the VOP header; the macroblock loop (MCBPC,
// ac_pred_flag, CBPY, dquant, not-coded MBs, 1MV and 4MV with
// libavcodec's h263_pred_motion, intra DC/AC prediction with the
// quantiser rescale, TCOEF with the three escapes, H.263 and MPEG
// inverse quantisation, video packets after resync markers); then
// reconstruction of the whole VOP: libavcodec's simple IDCT, or its XviD
// IDCT (the SSE2 version) for a stream it takes as XviD's, and half-pel
// motion compensation with rounding control over the previous VOP's
// coded-size planes (its visible size under the edge workaround), every
// coordinate clamped into them (the 4MV paths' origin clamps and
// libavcodec's 8-wide rounding-1 averages as mpeg4.py describes them).
// The decoder keeps that reference in its own state. libavcodec's encoder
// identification (user data and the container's codec tag, set by
// vk_mpeg4_set_codec_tag) is mpeg4.py's EncoderId, its sscanf calls the C
// library's own.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{msg}; }

std::atomic<long long> g_calls{0};

// -- tables (data/mpeg4.py has the same, with their sources) ----------------

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const int kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const int kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const int kDefaultIntra[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const int kDefaultInter[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

const uint16_t kIntraTcoef[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint16_t kInterTcoef[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const int kIntraLmax[2][21] = {{27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1},
                               {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
const int kIntraRuns[2] = {15, 21};
const int kInterLmax[2][41] = {
    {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
const int kInterRuns[2] = {27, 41};

// (mb_type, cbpc) -> code; index 4 * type + cbpc, 20 the stuffing
const char* kMcbpcI[9] = {"1",      "001",    "010",    "011",      "0001",
                          "000001", "000010", "000011", "000000001"};
const char* kMcbpcP[21] = {"1",        "0011",      "0010",      "000101",    "011",
                           "0000111",  "0000110",   "000000101", "010",       "0000101",
                           "0000100",  "00000101",  "00011",     "00000100",  "00000011",
                           "0000011",  "000100",    "000000100", "000000011", "000000010",
                           "000000001"};
const char* kCbpy[16] = {"0011",  "00101",  "00100", "1001", "00011", "0111",
                         "000010", "1011",  "00010", "000011", "0101", "1010",
                         "0100",  "1000",   "0110",  "11"};
const char* kDcLuma[13] = {"011",      "11",        "10",         "010",     "001",
                           "0001",     "00001",     "000001",     "0000001", "00000001",
                           "000000001", "0000000001", "00000000001"};
const char* kDcChroma[13] = {"11",         "10",          "01",          "001",
                             "0001",       "00001",       "000001",      "0000001",
                             "00000001",   "000000001",   "0000000001",  "00000000001",
                             "000000000001"};
const char* kMvd[33] = {
    "1",           "01",          "001",          "0001",        "000011",     "0000101",
    "0000100",     "0000011",     "000001011",    "000001010",   "000001001",  "0000010001",
    "0000010000",  "0000001111",  "0000001110",   "0000001101",  "0000001100", "0000001011",
    "0000001010",  "0000001001",  "0000001000",   "0000000111",  "0000000110", "0000000101",
    "0000000100",  "00000000111", "00000000110",  "00000000101", "00000000100",
    "00000000011", "00000000010", "000000000011", "000000000010"};
const int kDquant[4] = {-1, -2, 1, 2};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
const char* kVopKinds[4] = {"I", "P", "B (Advanced Simple Profile)", "S (sprite/GMC)"};

const int kEscape = 102;

// A lookup table of 2^bits entries: value and code length (0: no code).
struct Lut {
  int bits = 0;
  std::vector<int> value;
  std::vector<uint8_t> length;
  void init(int nbits) {
    bits = nbits;
    value.assign(1u << nbits, -1);
    length.assign(1u << nbits, 0);
  }
  void add(int v, uint32_t code, int len) {
    uint32_t lo = code << (bits - len), n = 1u << (bits - len);
    for (uint32_t i = lo; i < lo + n; ++i) {
      value[i] = v;
      length[i] = static_cast<uint8_t>(len);
    }
  }
  void add(int v, const char* s) {
    uint32_t code = 0;
    int len = 0;
    for (; s[len]; ++len) code = code << 1 | (s[len] == '1');
    add(v, code, len);
  }
};

struct Tcoef {
  Lut lut;              // value: last << 16 | run << 8 | level, or kEscape
  int lmax[2][64];
  int rmax[2][64];
};

struct Tables {
  Lut mcbpc_i, mcbpc_p, cbpy, dc_luma, dc_chroma, mvd;
  Tcoef intra, inter;
  Tables() {
    mcbpc_i.init(9);
    for (int i = 0; i < 9; ++i) mcbpc_i.add(i == 8 ? 20 : 12 + i, kMcbpcI[i]);
    mcbpc_p.init(9);
    for (int i = 0; i < 21; ++i) mcbpc_p.add(i, kMcbpcP[i]);
    cbpy.init(6);
    for (int i = 0; i < 16; ++i) cbpy.add(i, kCbpy[i]);
    dc_luma.init(11);
    for (int i = 0; i < 13; ++i) dc_luma.add(i, kDcLuma[i]);
    dc_chroma.init(12);
    for (int i = 0; i < 13; ++i) dc_chroma.add(i, kDcChroma[i]);
    mvd.init(12);
    for (int i = 0; i < 33; ++i) mvd.add(i, kMvd[i]);
    build(intra, kIntraTcoef, kIntraLmax[0], kIntraRuns[0], kIntraLmax[1], kIntraRuns[1]);
    build(inter, kInterTcoef, kInterLmax[0], kInterRuns[0], kInterLmax[1], kInterRuns[1]);
  }
  static void build(Tcoef& t, const uint16_t (*vlc)[2], const int* lmax0, int runs0,
                    const int* lmax1, int runs1) {
    t.lut.init(12);
    int k = 0;
    for (int last = 0; last < 2; ++last) {
      const int* lmax = last ? lmax1 : lmax0;
      int runs = last ? runs1 : runs0;
      for (int r = 0; r < 64; ++r) {
        t.lmax[last][r] = r < runs ? lmax[r] : 0;
        t.rmax[last][r] = -1;
      }
      for (int run = 0; run < runs; ++run)
        for (int level = 1; level <= lmax[run]; ++level) {
          t.lut.add(last << 16 | run << 8 | level, vlc[k][0], vlc[k][1]);
          t.rmax[last][level] = std::max(t.rmax[last][level], run);
          ++k;
        }
    }
    t.lut.add(kEscape, vlc[kEscape][0], vlc[kEscape][1]);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

int luma_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
int chroma_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

// -- the bit reader ------------------------------------------------------------

struct Bits {
  const uint8_t* buf;   // padded with 8 zero bytes
  long long pos, end;
  uint32_t peek(int n) const {
    long long b = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i) v = v << 8 | buf[b + i];
    return static_cast<uint32_t>((v >> (40 - (pos & 7) - n)) & ((1ull << n) - 1));
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int bit() {
    int v = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return v;
  }
  int vlc(const Lut& lut, const char* what) {
    uint32_t i = peek(lut.bits);
    if (!lut.length[i]) fail(std::string("invalid ") + what + " code at bit " +
                             std::to_string(pos));
    pos += lut.length[i];
    return lut.value[i];
  }
  void marker(const char* what) {
    if (!bit()) fail(std::string("missing marker bit after ") + what);
  }
  void check(const std::string& what) const {
    if (pos > end) fail(what + " runs past the end of its data");
  }
};

// -- headers ---------------------------------------------------------------------

struct Vol {
  bool valid = false;
  int verid = 1, vo_type = 0, vol_control_parameters = 0, width = 0, height = 0;
  int time_resolution = 1, time_bits = 1;
  int quant_type = 0, resync_marker_disable = 1, reduced_resolution = 0;
  int intra_matrix[64], inter_matrix[64];
};

void load_matrix(Bits& r, int* out) {
  int last = 0;
  for (int i = 0; i < 64; ++i) {
    int v = r.read(8);
    if (v == 0) {
      if (i == 0) fail("a loaded quantisation matrix starts with 0");
      for (int j = i; j < 64; ++j) out[kZigzag[j]] = last;
      return;
    }
    out[kZigzag[i]] = last = v;
  }
}

int bit_length(unsigned v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void parse_vol(Bits& r, Vol& vol) {
  r.bit();
  int vot = vol.vo_type = r.read(8);
  if (vot == 0x12) fail("a fine granularity scalable VOL (not Simple Profile)");
  if (r.bit()) {
    vol.verid = r.read(4);
    r.read(3);
  }
  if (r.read(4) == 15) r.read(16);
  vol.vol_control_parameters = r.bit();
  if (vol.vol_control_parameters) {
    if (r.read(2) != 1) fail("chroma_format other than 4:2:0");
    r.bit();
    if (r.bit()) {
      r.read(15), r.marker("bit rate"), r.read(15), r.marker("bit rate");
      r.read(15), r.marker("vbv buffer"), r.read(3), r.read(11);
      r.marker("vbv occupancy"), r.read(15), r.marker("vbv occupancy");
    }
  }
  int shape = r.read(2);
  if (shape != 0)
    fail("non-rectangular shape (video_object_layer_shape " + std::to_string(shape) + ")");
  r.marker("shape");
  vol.time_resolution = r.read(16);
  if (vol.time_resolution == 0) fail("vop_time_increment_resolution 0");
  vol.time_bits = std::max(bit_length(vol.time_resolution - 1), 1);
  r.marker("vop_time_increment_resolution");
  if (r.bit()) r.read(vol.time_bits);
  r.marker("fixed_vop_rate");
  vol.width = r.read(13);
  r.marker("width");
  vol.height = r.read(13);
  r.marker("height");
  if (vol.width == 0 || vol.height == 0)
    fail("a VOL of " + std::to_string(vol.width) + "x" + std::to_string(vol.height));
  if (r.bit()) fail("interlaced video");
  r.bit();
  int sprite = r.read(vol.verid == 1 ? 1 : 2);
  if (sprite) fail("sprites/GMC (sprite_enable " + std::to_string(sprite) + ")");
  if (r.bit()) fail("not_8_bit video");
  vol.quant_type = r.bit();
  std::memcpy(vol.intra_matrix, kDefaultIntra, sizeof kDefaultIntra);
  std::memcpy(vol.inter_matrix, kDefaultInter, sizeof kDefaultInter);
  if (vol.quant_type) {
    if (r.bit()) load_matrix(r, vol.intra_matrix);
    if (r.bit()) load_matrix(r, vol.inter_matrix);
  }
  if (vol.verid != 1 && r.bit())
    fail("quarter-pel motion (quarter_sample, Advanced Simple Profile)");
  if (!r.bit()) fail("complexity estimation headers (complexity_estimation_disable 0)");
  vol.resync_marker_disable = r.bit();
  if (r.bit()) fail("data partitioning (and reversible VLCs)");
  vol.reduced_resolution = 0;
  if (vol.verid != 1) {
    if (r.bit()) fail("newpred");
    vol.reduced_resolution = r.bit();
  }
  if (r.bit()) fail("scalability");
  r.check("the VOL header");
  vol.valid = true;
}

struct Vop {
  int kind = 0, coded = 0, rounding = 0, dc_thr = 0, quant = 0, fcode = 1;
};

Vop parse_vop(Bits& r, const Vol& vol) {
  Vop vop;
  vop.kind = r.read(2);
  if (vop.kind > 1)
    fail(std::string("a ") + kVopKinds[vop.kind] +
         "-VOP: the decoder takes I- and P-VOPs (Simple Profile)");
  while (r.bit()) r.check("modulo_time_base");
  r.marker("modulo_time_base");
  r.read(vol.time_bits);
  r.marker("vop_time_increment");
  vop.coded = r.bit();
  if (!vop.coded) return vop;
  if (vop.kind == 1) vop.rounding = r.bit();
  if (vol.reduced_resolution && r.bit()) fail("a reduced-resolution VOP");
  vop.dc_thr = kDcThreshold[r.read(3)];
  vop.quant = r.read(5);
  if (vop.quant == 0) fail("vop_quant 0");
  if (vop.kind == 1) {
    vop.fcode = r.read(3);
    if (vop.fcode == 0) fail("vop_fcode_forward 0");
  }
  r.check("the VOP header");
  return vop;
}

// -- reconstruction ------------------------------------------------------------

const long long W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
                W7 = 4520;

inline void butterfly(const long long* x, long long a0, long long* out) {
  long long a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * x[2] + W4 * x[4] + W6 * x[6];
  a1 += W6 * x[2] - W4 * x[4] - W2 * x[6];
  a2 += -W6 * x[2] - W4 * x[4] + W2 * x[6];
  a3 += -W2 * x[2] + W4 * x[4] - W6 * x[6];
  long long b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7];
  long long b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7];
  long long b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7];
  long long b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7];
  out[0] = a0 + b0, out[1] = a1 + b1, out[2] = a2 + b2, out[3] = a3 + b3;
  out[4] = a3 - b3, out[5] = a2 - b2, out[6] = a1 - b1, out[7] = a0 - b0;
}

// mpeg4.idct: rows (shift 11, the DC-only shortcut, int16), then columns.
void idct(const int32_t* in, int32_t* out) {
  long long rows[64];
  for (int i = 0; i < 8; ++i) {
    long long x[8], y[8];
    bool dc_only = true;
    for (int k = 0; k < 8; ++k) {
      x[k] = in[8 * i + k];
      if (k && x[k]) dc_only = false;
    }
    if (dc_only) {
      for (int k = 0; k < 8; ++k) rows[8 * i + k] = static_cast<int16_t>(x[0] * 8);
      continue;
    }
    butterfly(x, W4 * x[0] + (1 << 10), y);
    for (int k = 0; k < 8; ++k) rows[8 * i + k] = static_cast<int16_t>(y[k] >> 11);
  }
  for (int j = 0; j < 8; ++j) {
    long long c[8], y[8];
    for (int k = 0; k < 8; ++k) c[k] = rows[8 * k + j];
    butterfly(c, W4 * (c[0] + 32), y);
    for (int k = 0; k < 8; ++k) out[8 * k + j] = static_cast<int32_t>(y[k] >> 20);
  }
}

// mpeg4.xvid_idct: rows (each row's table and rounder, 32-bit, shift 11,
// saturated to int16), then columns in 16-bit saturating arithmetic.
const int kXvidRowTables[4][7] = {{22725, 21407, 19266, 16384, 12873, 8867, 4520},
                                  {31521, 29692, 26722, 22725, 17855, 12299, 6270},
                                  {29692, 27969, 25172, 21407, 16819, 11585, 5906},
                                  {26722, 25172, 22654, 19266, 15137, 10426, 5315}};
const int kXvidRowTable[8] = {0, 1, 2, 3, 0, 3, 2, 1};
const int kXvidRounders[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
const int kTan1 = 13036, kTan2 = 27146, kTan3Less1 = 43790 - 65536, kSqrt2Half = 23170;

inline int sat16(long long x) {
  return static_cast<int>(std::min(std::max(x, -32768LL), 32767LL));
}
inline int mulhi16(int x, int c) { return (x * c) >> 16; }
inline int wrap32(long long x) { return static_cast<int32_t>(static_cast<uint32_t>(x)); }

void xvid_idct(const int32_t* in, int32_t* out) {
  int rows[64];
  for (int i = 0; i < 8; ++i) {
    const int* t = kXvidRowTables[kXvidRowTable[i]];
    long long c1 = t[0], c2 = t[1], c3 = t[2], c4 = t[3], c5 = t[4], c6 = t[5], c7 = t[6];
    const int32_t* x = in + 8 * i;
    long long k = c4 * x[0] + kXvidRounders[i];
    long long a0 = k + c2 * x[2] + c4 * x[4] + c6 * x[6];
    long long a1 = k + c6 * x[2] - c4 * x[4] - c2 * x[6];
    long long a2 = k - c6 * x[2] - c4 * x[4] + c2 * x[6];
    long long a3 = k - c2 * x[2] + c4 * x[4] - c6 * x[6];
    long long b0 = c1 * x[1] + c3 * x[3] + c5 * x[5] + c7 * x[7];
    long long b1 = c3 * x[1] - c7 * x[3] - c1 * x[5] - c5 * x[7];
    long long b2 = c5 * x[1] - c1 * x[3] + c7 * x[5] + c3 * x[7];
    long long b3 = c7 * x[1] - c5 * x[3] + c3 * x[5] - c1 * x[7];
    long long y[8] = {a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0};
    for (int j = 0; j < 8; ++j) rows[8 * i + j] = sat16(wrap32(y[j]) >> 11);
  }
  for (int j = 0; j < 8; ++j) {
    int x[8];
    for (int k = 0; k < 8; ++k) x[k] = rows[8 * k + j];
    int tm35 = sat16(sat16(mulhi16(x[3], kTan3Less1) + x[3]) - x[5]);
    int tp35 = sat16(sat16(mulhi16(x[5], kTan3Less1) + x[5]) + x[3]);
    int tp17 = sat16(mulhi16(x[7], kTan1) + x[1]);
    int tm17 = sat16(mulhi16(x[1], kTan1) - x[7]);
    int t1 = sat16(tp17 - tp35), b3 = sat16(tm17 - tm35);
    int b0 = sat16(tp35 + tp17), t2 = sat16(tm35 + tm17);
    int b1 = sat16(2 * mulhi16(sat16(t2 + t1), kSqrt2Half));
    int b2 = sat16(2 * mulhi16(sat16(t1 - t2), kSqrt2Half));
    int tp26 = sat16(mulhi16(x[6], kTan2) + x[2]);
    int tm26 = sat16(mulhi16(x[2], kTan2) - x[6]);
    int tm04 = sat16(x[0] - x[4]), tp04 = sat16(x[4] + x[0]);
    int a0 = sat16(tp26 + tp04), a3 = sat16(tp04 - tp26);
    int a1 = sat16(tm26 + tm04), a2 = sat16(tm04 - tm26);
    int y[8] = {b0 + a0, b1 + a1, b2 + a2, b3 + a3, a3 - b3, a2 - b2, a1 - b1, a0 - b0};
    for (int k = 0; k < 8; ++k) out[8 * k + j] = sat16(y[k]) >> 6;
  }
}

// mpeg4.py's EncoderId: libavcodec's decode_user_data and
// ff_mpeg4_workaround_bugs.
struct EncoderId {
  char tag[5] = {0, 0, 0, 0, 0};
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  bool xvid_idct = false, edge_bug = false, dc_clip_bug = false;

  void set_tag(const char* t) {
    for (int i = 0; i < 4; ++i) {
      char c = t[i];
      if (!c) break;
      tag[i] = (c >= 'a' && c <= 'z') ? static_cast<char>(c - 32) : c;
    }
  }

  void user_data(const uint8_t* data, size_t n) {
    char buf[256];
    size_t i = 0;
    for (; i < n && i < 255; ++i) buf[i] = static_cast<char>(data[i]);
    buf[i] = 0;
    int ver = 0, build = 0, ver2 = 0, ver3 = 0;
    char last;
    int e = std::sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = std::sscanf(buf, "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) divx_version = ver, divx_build = build;
    e = std::sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4) e = std::sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2,
                                &ver3, &build);
    if (e != 4) {
      e = std::sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && std::strcmp(buf, "ffmpeg") == 0) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (std::sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
  }

  void at_vop(const Vol& vol) {
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1) {
      static const char* xvid_tags[] = {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"};
      bool xvid_tag = false;
      for (const char* t : xvid_tags) xvid_tag |= std::memcmp(tag, t, 4) == 0;
      if (xvid_tag)
        xvid_build = 0;
      else if (std::memcmp(tag, "DIVX", 4) == 0 && vol.vo_type == 0 &&
               !vol.vol_control_parameters)
        divx_version = 400;
    }
    if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
    unsigned xvid = xvid_build, lavc = lavc_build, divx = divx_version;
    edge_bug |= xvid <= 12u || lavc < 4670u || divx < 500u;
    dc_clip_bug |= xvid <= 32u || lavc <= 4712u;
    xvid_idct |= xvid_build >= 0;
  }
};

// One 8x8 half-pel prediction from ref (a plane `stride` wide; lw x lh the
// part read: the previous VOP's coded size, or its visible size under the
// edge workaround) whose top-left full-pel sample is (ix, iy), every
// coordinate clamped into that part. `narrow`: libavcodec's 8-wide x86
// functions (chroma, a 4MV MB's luma), whose rounding-1 x2 / y2 averages
// take one sample less one, saturated (mpeg4.py's _mc).
void mc(const uint8_t* ref, int stride, int lw, int lh, int ix, int iy, int hx, int hy,
        int rounding, bool narrow, int32_t* out) {
  int xs[9], ys[9];
  for (int k = 0; k < 9; ++k) {
    xs[k] = std::min(std::max(ix + k, 0), lw - 1);
    ys[k] = std::min(std::max(iy + k, 0), lh - 1) * stride;
  }
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      int a = ref[ys[r] + xs[c]];
      int v;
      if (hx && hy) {
        int b = ref[ys[r] + xs[c + 1]], cc = ref[ys[r + 1] + xs[c]],
            d = ref[ys[r + 1] + xs[c + 1]];
        v = (a + b + cc + d + 2 - rounding) >> 2;
      } else if (hx) {
        int b = ref[ys[r] + xs[c + 1]];
        v = !rounding ? (a + b + 1) >> 1 : narrow ? (std::max(a - 1, 0) + b + 1) >> 1 : (a + b) >> 1;
      } else if (hy) {
        int b = ref[ys[r + 1] + xs[c]];
        if (!rounding) {
          v = (a + b + 1) >> 1;
        } else if (narrow) {
          v = (r & 1) ? (std::max(a - 1, 0) + b + 1) >> 1 : (a + std::max(b - 1, 0) + 1) >> 1;
        } else {
          v = (a + b) >> 1;
        }
      } else {
        v = a;
      }
      out[8 * r + c] = v;
    }
}

// mpeg4.py's _source: the full-pel origin and half-pel flags of a block at
// (x0, y0) moved by (mvx, mvy); `clip` (the 4MV paths) clamps the origin
// into [lo, hi] and drops a half-pel flag at hi.
void source(int x0, int y0, int mvx, int mvy, bool clip, int lo, int hi_x, int hi_y, int* ix,
            int* iy, int* hx, int* hy) {
  *ix = x0 + (mvx >> 1), *iy = y0 + (mvy >> 1), *hx = mvx & 1, *hy = mvy & 1;
  if (!clip) return;
  *ix = std::min(std::max(*ix, lo), hi_x);
  *iy = std::min(std::max(*iy, lo), hi_y);
  if (*ix == hi_x) *hx = 0;
  if (*iy == hi_y) *hy = 0;
}

// -- the decoder -------------------------------------------------------------------

enum { kIntra = 0, kInter = 1, kSkip = 2 };

struct Mv {
  int x = 0, y = 0;
};

int median(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

int sign_extend(int v, int bits) {
  v &= (1 << bits) - 1;
  return (v >> (bits - 1)) ? v - (1 << bits) : v;
}

struct Decoder {
  Vol vol;
  EncoderId encoder;
  std::vector<uint8_t> ref[3], cur[3];   // coded-size planes
  bool have_ref = false;
  int out_w = 0, out_h = 0;
  std::string error;
  // per VOP
  int mbw = 0, mbh = 0;
  std::vector<int8_t> kind;
  std::vector<int32_t> coef;              // (mbh, mbw, 6, 64)
  std::vector<uint8_t> coded;             // (mbh, mbw, 6)
  std::vector<uint8_t> four_mv;           // (mbh, mbw): an inter4v MB
  std::vector<Mv> mv;                     // (2 mbh, 2 mbw + 2)
  std::vector<int> dc[3];                 // with a border row and column
  std::vector<int16_t> ac[3];             // 16 a slot
  std::vector<int> qscale;
  int dc_stride[3] = {0, 0, 0};
  int resync_y = 0;                       // the current video packet's first MB row

  void reset_frame() {
    size_t n = static_cast<size_t>(mbw) * mbh;
    kind.assign(n, kSkip);
    coef.assign(n * 6 * 64, 0);
    coded.assign(n * 6, 0);
    four_mv.assign(n, 0);
    mv.assign(static_cast<size_t>(2 * mbh) * (2 * mbw + 2), Mv());
    dc_stride[0] = 2 * mbw + 1;
    dc_stride[1] = dc_stride[2] = mbw + 1;
    dc[0].assign(static_cast<size_t>(2 * mbh + 1) * dc_stride[0], 1024);
    ac[0].assign(static_cast<size_t>(2 * mbh + 1) * dc_stride[0] * 16, 0);
    for (int p = 1; p < 3; ++p) {
      dc[p].assign(static_cast<size_t>(mbh + 1) * dc_stride[p], 1024);
      ac[p].assign(static_cast<size_t>(mbh + 1) * dc_stride[p] * 16, 0);
    }
    qscale.assign(n, 0);
  }

  Mv& mv_at(int gx, int gy) { return mv[static_cast<size_t>(gy) * (2 * mbw + 2) + gx]; }

  // (plane, row, column) of block n's predictor slot (1-based)
  static void block_pos(int n, int mx, int my, int* p, int* by, int* bx) {
    if (n < 4) {
      *p = 0, *by = 2 * my + (n >> 1) + 1, *bx = 2 * mx + (n & 1) + 1;
    } else {
      *p = n - 3, *by = my + 1, *bx = mx + 1;
    }
  }

  int decode(const uint8_t* data, size_t n) {
    std::vector<uint8_t> buf(data, data + n);
    buf.resize(n + 8, 0);
    std::vector<std::pair<int, size_t>> codes;
    for (size_t i = 0; i + 3 < n; ++i)
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
        codes.push_back({data[i + 3], i + 4});
        i += 2;
      }
    if (codes.empty() && n) {
      if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xFC) == 0x80)
        fail("the short video header (H.263 baseline)");
      fail("a sample without start codes");
    }
    int out = 0;
    for (size_t k = 0; k < codes.size(); ++k) {
      int code = codes[k].first;
      size_t pos = codes[k].second;
      size_t end = k + 1 < codes.size() ? codes[k + 1].second - 4 : n;
      if (0x20 <= code && code <= 0x2F) {
        Vol v;
        Bits r{buf.data(), static_cast<long long>(8 * pos), static_cast<long long>(8 * end)};
        parse_vol(r, v);
        vol = v;
      } else if (code == 0xB2) {
        encoder.user_data(data + pos, end - pos);
      } else if (code == 0xB6) {
        if (!vol.valid) fail("a VOP before any VOL header");
        // the VOP reads up to its end; later bytes are not its bits
        std::vector<uint8_t> seg(buf.begin(), buf.begin() + end);
        seg.resize(end + 8, 0);
        Bits r{seg.data(), static_cast<long long>(8 * pos), static_cast<long long>(8 * end)};
        vop(r);
        out = 1;
      }
    }
    return out;
  }

  void vop(Bits& r) {
    Vop v = parse_vop(r, vol);
    encoder.at_vop(vol);
    int w = vol.width, h = vol.height;
    if (!v.coded) {
      if (!have_ref) fail("a not-coded VOP before any decoded one");
      out_w = w, out_h = h;
      return;
    }
    if (v.kind == 1 && !have_ref) fail("a P-VOP before any I-VOP");
    mbw = (w + 15) >> 4, mbh = (h + 15) >> 4;
    if (v.kind == 1 && ref[0].size() != static_cast<size_t>(256) * mbw * mbh)
      fail("a P-VOP of another size than its reference");
    reset_frame();
    macroblocks(r, v);
    reconstruct(v);
    for (int p = 0; p < 3; ++p) ref[p].swap(cur[p]);
    have_ref = true;
    out_w = w, out_h = h;
  }

  bool at_resync(Bits& r, const Vop& v) {
    long long pos = r.pos;
    int skip = 8 - static_cast<int>(pos & 7);
    if (r.peek(skip) != (1u << (skip - 1)) - 1) return false;
    int len = v.kind == 0 ? 17 : 16 + v.fcode;
    r.pos = pos + skip;
    if (r.pos + len <= r.end && r.peek(len) == 1) {
      r.pos += len;
      return true;
    }
    r.pos = pos;
    return false;
  }

  void clean_predictors(int mx, int my) {
    int stride = 2 * mbw + 1;
    size_t start = static_cast<size_t>(2 * my) * stride + 2 * mx;
    for (size_t i = start; i < start + 2 * stride + 1 && i * 16 < ac[0].size(); ++i)
      std::fill(ac[0].begin() + i * 16, ac[0].begin() + i * 16 + 16, 0);
    int cstride = mbw + 1;
    size_t cstart = static_cast<size_t>(my) * cstride + mx;
    for (int p = 1; p < 3; ++p)
      for (size_t i = cstart; i < cstart + cstride + 1 && i * 16 < ac[p].size(); ++i)
        std::fill(ac[p].begin() + i * 16, ac[p].begin() + i * 16 + 16, 0);
  }

  void macroblocks(Bits& r, Vop& v) {
    int n_mb = mbw * mbh;
    int mb_bits = std::max(bit_length(n_mb - 1), 1);
    int q = v.quant, rx = 0, ry = 0;
    resync_y = 0;
    for (int i = 0; i < n_mb; ++i) {
      int mx = i % mbw, my = i / mbw;
      if (i && !vol.resync_marker_disable && at_resync(r, v)) {
        int first = r.read(mb_bits);
        q = r.read(5);
        if (q == 0) fail("quant_scale 0 in a video packet header");
        if (r.bit()) {
          while (r.bit()) r.check("modulo_time_base");
          r.marker("modulo_time_base");
          r.read(vol.time_bits);
          r.marker("vop_time_increment");
          if (static_cast<int>(r.read(2)) != v.kind)
            fail("a video packet's vop_coding_type differs from its VOP's");
          r.read(3);
          if (v.kind == 1) r.read(3);
        }
        if (first != i)
          fail("a video packet starts at macroblock " + std::to_string(first) + ", not " +
               std::to_string(i));
        rx = mx, ry = my;
        resync_y = my;
        clean_predictors(mx, my);
      }
      bool first_line = my == ry || (my == ry + 1 && mx < rx);
      q = macroblock(r, v, mx, my, q, rx, first_line);
      r.check("macroblock " + std::to_string(i));
    }
  }

  void set_mv(int mx, int my, Mv m) {
    for (int k = 0; k < 4; ++k) mv_at(2 * mx + (k & 1) + 1, 2 * my + (k >> 1)) = m;
  }

  void clear_intra(int mx, int my) {
    for (int n = 0; n < 6; ++n) {
      int p, by, bx;
      block_pos(n, mx, my, &p, &by, &bx);
      size_t s = static_cast<size_t>(by) * dc_stride[p] + bx;
      dc[p][s] = 1024;
      std::fill(ac[p].begin() + s * 16, ac[p].begin() + s * 16 + 16, 0);
    }
  }

  int macroblock(Bits& r, const Vop& v, int mx, int my, int q, int rx, bool first_line) {
    const Tables& t = tables();
    size_t m = static_cast<size_t>(my) * mbw + mx;
    int mb_type, cbpc;
    if (v.kind == 1) {
      int code;
      while (true) {
        if (r.bit()) {
          kind[m] = kSkip;
          clear_intra(mx, my);
          set_mv(mx, my, Mv());
          qscale[m] = q;
          return q;
        }
        code = r.vlc(t.mcbpc_p, "MCBPC");
        if (code != 20) break;
      }
      mb_type = code >> 2, cbpc = code & 3;
    } else {
      int code;
      while (true) {
        code = r.vlc(t.mcbpc_i, "MCBPC");
        if (code != 20) break;
      }
      mb_type = code >> 2, cbpc = code & 3;
    }
    bool intra = mb_type >= 3;
    int ac_pred = intra ? r.bit() : 0;
    int cbpy = r.vlc(t.cbpy, "CBPY");
    if (!intra) cbpy = 15 - cbpy;
    int cbp = cbpy << 2 | cbpc;
    bool use_dc_vlc = q < v.dc_thr;
    if (mb_type == 1 || mb_type == 4) q = std::min(std::max(q + kDquant[r.read(2)], 1), 31);
    qscale[m] = q;
    if (intra) {
      kind[m] = kIntra;
      set_mv(mx, my, Mv());
      for (int n = 0; n < 6; ++n)
        intra_block(r, n, mx, my, q, ac_pred, cbp & (32 >> n), use_dc_vlc, rx, first_line);
      return q;
    }
    kind[m] = kInter;
    clear_intra(mx, my);
    Mv last;
    for (int n = 0; n < (mb_type == 2 ? 4 : 1); ++n) {
      Mv p = predict_mv(n, mx, my, rx, first_line);
      last.x = motion(r, p.x, v.fcode);
      last.y = motion(r, p.y, v.fcode);
      mv_at(2 * mx + (n & 1) + 1, 2 * my + (n >> 1)) = last;
    }
    if (mb_type != 2) set_mv(mx, my, last);
    four_mv[m] = mb_type == 2;
    for (int n = 0; n < 6; ++n)
      if (cbp & (32 >> n)) inter_block(r, n, mx, my, q);
    return q;
  }

  Mv predict_mv(int n, int mx, int my, int rx, bool first_line) {
    int gx = 2 * mx + (n & 1) + 1, gy = 2 * my + (n >> 1);
    Mv a = mv_at(gx - 1, gy);
    static const int kOff[4] = {2, 1, 1, -1};
    int cx = gx + kOff[n];
    if (first_line && n < 3) {
      if (n == 0) {
        if (mx == rx) return Mv();
        if (mx + 1 == rx) {
          Mv c = mv_at(cx, gy - 1);
          if (mx == 0) return c;
          return Mv{median(a.x, 0, c.x), median(a.y, 0, c.y)};
        }
        return a;
      }
      if (n == 1) {
        if (mx + 1 == rx) {
          Mv c = mv_at(cx, gy - 1);
          return Mv{median(a.x, 0, c.x), median(a.y, 0, c.y)};
        }
        return a;
      }
      if (mx == rx) a = Mv();
    }
    Mv b = mv_at(gx, gy - 1), c = mv_at(cx, gy - 1);
    return Mv{median(a.x, b.x, c.x), median(a.y, b.y, c.y)};
  }

  static int motion(Bits& r, int pred, int fcode) {
    int code = r.vlc(tables().mvd, "motion vector");
    if (code == 0) return pred;
    int sign = r.bit(), shift = fcode - 1, val = code;
    if (shift) val = (((val - 1) << shift) | static_cast<int>(r.read(shift))) + 1;
    if (sign) val = -val;
    return sign_extend(val + pred, 5 + fcode);
  }

  // Run/level pairs into block from scan index i, dequantised as
  // level * qmul + qadd (qmul 1, qadd 0: kept quantised).
  static void tcoef(Bits& r, int* block, int i, const int* scan, const Tcoef& t, int qmul,
                    int qadd) {
    while (true) {
      int e = r.vlc(t.lut, "TCOEF");
      int last, run, level;
      if (e == kEscape) {
        int mode = !r.bit() ? 1 : 2 + r.bit();
        if (mode == 3) {
          last = r.bit();
          run = r.read(6);
          r.marker("an escaped run");
          level = r.read(12);
          r.marker("an escaped level");
          if (level >= 2048) level -= 4096;
          if (level == 0) fail("an escaped level of 0");
          i += run;
          if (i > 63) fail("a block of more than 64 coefficients");
          if (qmul != 1 || qadd) {
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            level = std::min(std::max(level, -2048), 2047);
          }
          block[scan[i]] = level;
          ++i;
          if (last) return;
          continue;
        }
        e = t.lut.value[r.peek(12)];
        if (e < 0 || e == kEscape)
          fail("invalid escaped TCOEF code at bit " + std::to_string(r.pos));
        r.pos += t.lut.length[r.peek(12)];
        last = e >> 16, run = (e >> 8) & 0xFF, level = e & 0xFF;
        if (mode == 1)
          level += t.lmax[last][run];
        else
          run += t.rmax[last][level] + 1;
      } else {
        last = e >> 16, run = (e >> 8) & 0xFF, level = e & 0xFF;
      }
      if (r.bit()) level = -level;
      i += run;
      if (i > 63) fail("a block of more than 64 coefficients");
      if (qmul != 1 || qadd) level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
      block[scan[i]] = level;
      ++i;
      if (last) return;
    }
  }

  void intra_block(Bits& r, int n, int mx, int my, int q, int ac_pred, bool is_coded,
                   bool use_dc_vlc, int rx, bool first_line) {
    const Tables& t = tables();
    int p, by, bx;
    block_pos(n, mx, my, &p, &by, &bx);
    int stride = dc_stride[p];
    std::vector<int>& dcs = dc[p];
    int a = dcs[by * stride + bx - 1], b = dcs[(by - 1) * stride + bx - 1],
        c = dcs[(by - 1) * stride + bx];
    if (first_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mx == rx) b = a = 1024;
    }
    if (mx == rx && my == resync_y + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
    bool left = !(std::abs(a - b) < std::abs(b - c));
    int pred = left ? a : c;
    int scale = n < 4 ? luma_dc_scale(q) : chroma_dc_scale(q);
    int block[64] = {0};
    int start = 0;
    if (use_dc_vlc) {
      int size = r.vlc(n < 4 ? t.dc_luma : t.dc_chroma, "DC size");
      int diff = 0;
      if (size) {
        diff = r.read(size);
        if (!(diff >> (size - 1))) diff -= (1 << size) - 1;
        if (size > 8) r.marker("a DC differential");
      }
      block[0] = diff;
      start = 1;
    }
    const int* scan = ac_pred ? (left ? kAltVertical : kAltHorizontal) : kZigzag;
    if (is_coded) tcoef(r, block, start, scan, t.intra, 1, 0);
    int level = block[0] + (pred + (scale >> 1)) / scale;
    block[0] = level;
    dcs[by * stride + bx] = encoder.dc_clip_bug
                                ? static_cast<int16_t>(std::max(level * scale, 0))
                                : std::min(std::max(level * scale, 0), 2047);
    int16_t* acs = ac[p].data();
    if (ac_pred) {
      int nq;
      const int16_t* src;
      if (left) {
        nq = (mx > 0 && (n == 0 || n == 2 || n == 4 || n == 5)) ? qscale[my * mbw + mx - 1]
                                                                  : q;
        src = acs + (static_cast<size_t>(by) * stride + bx - 1) * 16;
      } else {
        nq = (my > 0 && (n == 0 || n == 1 || n == 4 || n == 5)) ? qscale[(my - 1) * mbw + mx]
                                                                  : q;
        src = acs + (static_cast<size_t>(by - 1) * stride + bx) * 16 + 8;
      }
      for (int k = 1; k < 8; ++k) {
        int val = src[k];
        if (nq != q) {
          int mag = (std::abs(val * nq) + (q >> 1)) / q;
          val = val > 0 ? mag : -mag;
        }
        block[left ? 8 * k : k] += val;
      }
    }
    int16_t* dst = acs + (static_cast<size_t>(by) * stride + bx) * 16;
    dst[0] = dst[8] = 0;
    for (int k = 1; k < 8; ++k) {
      dst[k] = static_cast<int16_t>(block[8 * k]);
      dst[8 + k] = static_cast<int16_t>(block[k]);
    }
    size_t m = static_cast<size_t>(my) * mbw + mx;
    int32_t* out = &coef[(m * 6 + n) * 64];
    if (vol.quant_type) {
      for (int pos = 1; pos < 64; ++pos) {
        int val = block[pos];
        if (!val) continue;
        int mag = (std::abs(val) * q * 2 * vol.intra_matrix[pos]) >> 4;
        out[pos] = static_cast<int16_t>(val > 0 ? mag : -mag);
      }
    } else {
      int qmul = 2 * q, qadd = (q - 1) | 1;
      for (int pos = 1; pos < 64; ++pos) {
        int val = block[pos];
        if (!val) continue;
        out[pos] = static_cast<int16_t>(val > 0 ? val * qmul + qadd : val * qmul - qadd);
      }
    }
    out[0] = static_cast<int16_t>(level * scale);
    coded[m * 6 + n] = 1;
  }

  void inter_block(Bits& r, int n, int mx, int my, int q) {
    const Tables& t = tables();
    int block[64] = {0};
    size_t m = static_cast<size_t>(my) * mbw + mx;
    int32_t* out = &coef[(m * 6 + n) * 64];
    if (vol.quant_type) {
      tcoef(r, block, 0, kZigzag, t.inter, 1, 0);
      long long total = 0;
      for (int pos = 0; pos < 64; ++pos) {
        int val = block[pos];
        if (!val) continue;
        int mag = ((2 * std::abs(val) + 1) * q * 2 * vol.inter_matrix[pos]) >> 5;
        val = static_cast<int16_t>(val > 0 ? mag : -mag);
        block[pos] = val;
        total += val;
      }
      if (!(total & 1)) block[63] ^= 1;
    } else {
      tcoef(r, block, 0, kZigzag, t.inter, 2 * q, (q - 1) | 1);
    }
    for (int k = 0; k < 64; ++k) out[k] = block[k];
    coded[m * 6 + n] = 1;
  }

  void reconstruct(const Vop& v) {
    int lw = 16 * mbw, lh = 16 * mbh, cw = 8 * mbw, ch = 8 * mbh;
    // the part of the reference motion compensation reads
    int rw = lw, rh = lh, rcw = cw, rch = ch;
    if (encoder.edge_bug)
      rw = vol.width, rh = vol.height, rcw = vol.width >> 1, rch = vol.height >> 1;
    cur[0].assign(static_cast<size_t>(lw) * lh, 0);
    cur[1].assign(static_cast<size_t>(cw) * ch, 0);
    cur[2].assign(static_cast<size_t>(cw) * ch, 0);
    int32_t res[64], pred[64];
    for (int my = 0; my < mbh; ++my)
      for (int mx = 0; mx < mbw; ++mx) {
        size_t m = static_cast<size_t>(my) * mbw + mx;
        bool intra = kind[m] == kIntra;
        int sx = 0, sy = 0;
        for (int k = 0; k < 4; ++k) {
          Mv b = mv_at(2 * mx + (k & 1) + 1, 2 * my + (k >> 1));
          sx += b.x, sy += b.y;
        }
        int cvx = kChromaRound[sx & 15] + ((sx >> 3) & ~1);
        int cvy = kChromaRound[sy & 15] + ((sy >> 3) & ~1);
        for (int n = 0; n < 6; ++n) {
          int p = n < 4 ? 0 : n - 3;
          int x0 = n < 4 ? 16 * mx + 8 * (n & 1) : 8 * mx;
          int y0 = n < 4 ? 16 * my + 8 * (n >> 1) : 8 * my;
          int pw = p ? cw : lw;
          bool has = coded[m * 6 + n];
          if (has) (encoder.xvid_idct ? xvid_idct : idct)(&coef[(m * 6 + n) * 64], res);
          if (intra) {
            for (int k = 0; k < 64; ++k) pred[k] = 0;
          } else {
            bool four = four_mv[m];
            int ix, iy, hx, hy;
            if (p == 0) {
              Mv b = mv_at(2 * mx + (n & 1) + 1, 2 * my + (n >> 1));
              source(x0, y0, b.x, b.y, four, -16, vol.width, vol.height, &ix, &iy, &hx, &hy);
              mc(ref[0].data(), lw, rw, rh, ix, iy, hx, hy, v.rounding, four, pred);
            } else {
              source(x0, y0, cvx, cvy, four, -8, vol.width >> 1, vol.height >> 1, &ix, &iy, &hx,
                     &hy);
              mc(ref[p].data(), cw, rcw, rch, ix, iy, hx, hy, v.rounding, true, pred);
            }
          }
          uint8_t* dst = cur[p].data() + static_cast<size_t>(y0) * pw + x0;
          for (int r = 0; r < 8; ++r)
            for (int c = 0; c < 8; ++c) {
              int val = pred[8 * r + c] + (has ? res[8 * r + c] : 0);
              dst[r * pw + c] = static_cast<uint8_t>(std::min(std::max(val, 0), 255));
            }
        }
      }
  }
};

}  // namespace

extern "C" {

void* vk_mpeg4_create() { return new Decoder(); }

void vk_mpeg4_destroy(void* h) { delete static_cast<Decoder*>(h); }

// The container's codec tag (up to 4 characters; empty for none), which
// the XviD rule reads: set before the first sample.
void vk_mpeg4_set_codec_tag(void* h, const char* tag) {
  static_cast<Decoder*>(h)->encoder.set_tag(tag);
}

// Decode one container sample: 1 when it gave a VOP (its size in *w, *h;
// its planes by vk_mpeg4_planes), 0 for headers only, -1 on a failure
// (the message by vk_mpeg4_error).
int vk_mpeg4_decode(void* h, const unsigned char* data, size_t n, int* w, int* hh) {
  Decoder* d = static_cast<Decoder*>(h);
  g_calls.fetch_add(1);
  try {
    int out = d->decode(data, n);
    *w = d->out_w, *hh = d->out_h;
    return out;
  } catch (const Failure& f) {
    d->error = f.msg;
    return -1;
  }
}

// The last VOP's planes cropped to its size: y (h x w), u and v
// ((h + 1) / 2 x (w + 1) / 2).
void vk_mpeg4_planes(void* h, unsigned char* y, unsigned char* u, unsigned char* v) {
  Decoder* d = static_cast<Decoder*>(h);
  int w = d->out_w, hh = d->out_h, lw = 16 * d->mbw, cw = 8 * d->mbw;
  int cwo = (w + 1) / 2, cho = (hh + 1) / 2;
  for (int r = 0; r < hh; ++r) std::memcpy(y + r * w, d->ref[0].data() + r * lw, w);
  for (int r = 0; r < cho; ++r) {
    std::memcpy(u + r * cwo, d->ref[1].data() + r * cw, cwo);
    std::memcpy(v + r * cwo, d->ref[2].data() + r * cw, cwo);
  }
}

const char* vk_mpeg4_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

// What the identification inferred so far (mpeg4.EncoderId's fields):
// out[0..5] = XviD build, DivX version, libavcodec build, and the XviD
// IDCT, edge and DC clip flags.
void vk_mpeg4_identity(void* h, int* out) {
  const EncoderId& e = static_cast<Decoder*>(h)->encoder;
  out[0] = e.xvid_build, out[1] = e.divx_version, out[2] = e.lavc_build;
  out[3] = e.xvid_idct, out[4] = e.edge_bug, out[5] = e.dc_clip_bug;
}

long long vk_mpeg4_calls() { return g_calls.load(); }

}  // extern "C"
