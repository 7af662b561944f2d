// VP9 (profile 0) video decoding as host C++: libavcodec's vp9*.c as cv2
// runs it.
//
// Host code only (nvcc hands it to the host compiler); plain C interface,
// loaded with ctypes by data/vp9.py (_CDecoder). It is the counterpart of
// data/vp9.py's Vp9Decoder, the plain decoder, line for line, and gives the
// same planes and the same refusals (the same messages): the demo's video
// path on the card decodes each frame here, uploads the planes and
// converts them to RGB on the device (mpeg4.yuv420_to_rgb), where the
// plain decoder's Python loops take seconds a 720p frame.
//
// The same stages in the same order: the superframe index; the
// uncompressed header (sizes from the references, the loop filter's and
// quantiser's settings, segmentation, tiles) and the compressed header
// (the probability updates); each tile's partitions and blocks (segment
// ids, skip, tx size, intra modes with their key-frame contexts, the
// reference contexts, find_mv_refs, the vectors), tokens with the Pareto
// model, the DCT/ADST and the WHT, the intra predictors over the unfiltered
// frame and the eight-tap filters over references repeated past their
// edges; libvpx's loop-filter masks and filters a superblock at a time; the
// backward adaptation and the saved contexts; the references' update.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "vp9_tables.cuh"

namespace {

using namespace vp9t;

struct Failure {
  std::string msg;
  int status;  // -1 libavcodec refuses the frame, -2 the port does
};

[[noreturn]] void fail(const std::string& msg, int status = -1) { throw Failure{msg, status}; }

std::atomic<long long> g_calls{0};

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, D63_PRED, TM_PRED };
enum { NEARESTMV = 10, NEARMV, ZEROMV, NEWMV };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_64X64 = 12 };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32 };
enum { ONLY_4X4, ALLOW_8X8, ALLOW_16X16, ALLOW_32X32, TX_MODE_SELECT };
enum { SINGLE_REFERENCE, COMPOUND_REFERENCE, REFERENCE_MODE_SELECT };
enum { EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE };
enum { SEG_LVL_ALT_Q, SEG_LVL_ALT_LF, SEG_LVL_REF_FRAME, SEG_LVL_SKIP };
const int LITERAL_TO_FILTER[4] = {EIGHTTAP_SMOOTH, EIGHTTAP, EIGHTTAP_SHARP, BILINEAR};
const int SEG_FEATURE_BITS[4] = {8, 6, 2, 0};
const int SYNC_CODE = 0x498342;
const int MV_BORDER = 16 << 3;
const int BH8[13] = {1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8};
const int BH4[13] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16};
const int TX_MODE_TO_BIGGEST[5] = {TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_32X32};
const int IDX_N_COLUMN_TO_SUBBLOCK[4][2] = {{1, 2}, {1, 3}, {3, 2}, {3, 3}};
const int ENERGY[12] = {0, 1, 2, 3, 3, 4, 4, 5, 5, 5, 5, 5};
const int CAT_BASE[6] = {5, 7, 11, 19, 35, 67};
const uint8_t* const CAT_PROBS[6] = {CAT1_PROB, CAT2_PROB, CAT3_PROB, CAT4_PROB, CAT5_PROB, CAT6_PROB};
const int CAT_BITS[6] = {1, 2, 3, 4, 5, 14};
const char* OTHER_MATRIX(int cs) {
  switch (cs) {
    case 2: return "BT.709";
    case 4: return "SMPTE 240M";
    case 5: return "BT.2020";
    case 6: return "reserved (6)";
    default: return nullptr;
  }
}

int bw8(int b) { return NUM_8X8_BLOCKS_WIDE[b]; }
int bw4(int b) { return NUM_4X4_BLOCKS_WIDE[b]; }
int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
int norm_shift(int r) {
  int s = 0;
  while (r < 128) r <<= 1, ++s;
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
};

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

int read_tree(Reader& br, const int8_t* tree, const uint8_t* probs) {
  int i = 0;
  while (true) {
    i = tree[i + br.bit(probs[i >> 1])];
    if (i <= 0) return -i;
  }
}

// -- the raw bits of the uncompressed header (vp9.BitReader) -----------------

struct Bits {
  const uint8_t* data;
  long long n, pos = 0;
  int f(int k) {
    int v = 0;
    for (int i = 0; i < k; ++i) {
      long long byte = pos >> 3;
      int b = byte < n ? (data[byte] >> (7 - (pos & 7))) & 1 : 0;
      v = (v << 1) | b;
      ++pos;
    }
    return v;
  }
  int su(int k) {
    int v = f(k);
    return f(1) ? -v : v;
  }
  long long byte_pos() const { return (pos + 7) >> 3; }
  // vp9.Vp9Decoder._header_end
  void end() {
    while (pos & 7)
      if (f(1)) fail("a bit that pads the uncompressed header is set");
    if (pos > 8 * n) fail("the uncompressed header runs past the frame's " + std::to_string(n) + " bytes");
  }
};

// -- cbs_vp9's checks (vp9.cbs_units, vp9.cbs_header) ---------------------------

struct StrictBits : Bits {
  int f(int k, const char* name) {
    if (pos + k > 8 * n) fail(std::string("invalid value at ") + name + ": bitstream ended");
    return Bits::f(k);
  }
};

std::vector<std::pair<long long, long long>> cbs_units(const uint8_t* data, long long n) {
  std::vector<std::pair<long long, long long>> out;
  if (!n || (data[n - 1] & 0xE0) != 0xC0) {
    out.push_back({0, n});
    return out;
  }
  int marker = data[n - 1];
  long long index = 2 + static_cast<long long>(((marker >> 3) & 3) + 1) * ((marker & 7) + 1);
  if (index > n)
    fail("a superframe index of " + std::to_string(index) + " bytes in a frame of " + std::to_string(n));
  int first = data[n - index];
  int mag = ((first >> 3) & 3) + 1, count = (first & 7) + 1;
  if (2 + mag * count > index) fail("invalid value at frame_sizes: bitstream ended");
  long long pos = 0;
  for (int i = 0; i < count; ++i) {
    long long at = n - index + 1 + static_cast<long long>(i) * mag, size = 0;
    for (int j = 0; j < mag; ++j) size |= static_cast<long long>(data[at + j]) << (8 * j);
    if (pos + size > n - index)
      fail("frame " + std::to_string(i) + " too large in superframe: " + std::to_string(size) + " bytes");
    out.push_back({pos, size});
    pos += size;
  }
  return out;
}

void cbs_header(const uint8_t* data, long long n, int (*ref_sizes)[2]) {
  StrictBits r;
  r.data = data, r.n = n;
  if (r.f(2, "frame_marker") != 2) fail("invalid frame marker");
  int profile = r.f(1, "profile_low_bit") | r.f(1, "profile_high_bit") << 1;
  if (profile == 3 && r.f(1, "reserved_zero")) fail("reserved_zero out of range");
  auto sync = [&]() {
    if (r.f(24, "frame_sync_code") != SYNC_CODE) fail("invalid sync code");
  };
  auto color_config = [&]() {
    if (profile >= 2) r.f(1, "ten_or_twelve_bit");
    int cs = r.f(3, "color_space");
    if (cs != 7) {
      r.f(1, "color_range");
      if (profile == 1 || profile == 3) {
        r.f(2, "subsampling");
        if (r.f(1, "reserved_zero")) fail("reserved_zero out of range");
      }
    } else if ((profile == 1 || profile == 3) && r.f(1, "reserved_zero")) {
      fail("reserved_zero out of range");
    }
  };
  int size[2] = {0, 0};
  auto frame_size = [&]() {
    size[0] = r.f(16, "frame_width_minus_1") + 1;
    size[1] = r.f(16, "frame_height_minus_1") + 1;
  };
  auto render_size = [&]() {
    if (r.f(1, "render_and_frame_size_different")) r.f(32, "render_size");
  };
  auto end = [&]() {
    while (r.pos & 7)
      if (r.f(1, "zero_bit")) fail("a bit that pads the uncompressed header is set");
  };
  if (r.f(1, "show_existing_frame")) {
    r.f(3, "frame_to_show_map_idx");
    end();
    return;
  }
  bool key = !r.f(1, "frame_type");
  int show = r.f(1, "show_frame"), error_res = r.f(1, "error_resilient_mode");
  int refresh;
  if (key) {
    sync();
    color_config();
    frame_size();
    render_size();
    refresh = 0xFF;
  } else {
    int intra_only = !show ? r.f(1, "intra_only") : 0;
    if (!error_res) r.f(2, "reset_frame_context");
    if (intra_only) {
      sync();
      if (profile > 0) color_config();
      refresh = r.f(8, "refresh_frame_flags");
      frame_size();
      render_size();
    } else {
      refresh = r.f(8, "refresh_frame_flags");
      int idx[3];
      for (int i = 0; i < 3; ++i) {
        idx[i] = r.f(3, "ref_frame_idx");
        r.f(1, "ref_frame_sign_bias");
      }
      bool found = false;
      for (int i = 0; i < 3; ++i)
        if (r.f(1, "found_ref")) {
          size[0] = ref_sizes[idx[i]][0], size[1] = ref_sizes[idx[i]][1];
          found = true;
          break;
        }
      if (!found) frame_size();
      render_size();
      r.f(1, "allow_high_precision_mv");
      if (!r.f(1, "is_filter_switchable")) r.f(2, "raw_interpolation_filter_type");
    }
  }
  if (!error_res) r.f(2, "refresh_and_parallel");
  r.f(2, "frame_context_idx");
  r.f(6, "loop_filter_level");
  r.f(3, "loop_filter_sharpness");
  if (r.f(1, "loop_filter_delta_enabled") && r.f(1, "loop_filter_delta_update"))
    for (int i = 0; i < 6; ++i)
      if (r.f(1, "update_delta")) r.f(7, "loop_filter_delta");
  r.f(8, "base_q_idx");
  for (int i = 0; i < 3; ++i)
    if (r.f(1, "delta_coded")) r.f(5, "delta_q");
  if (r.f(1, "segmentation_enabled")) {
    if (r.f(1, "segmentation_update_map")) {
      for (int i = 0; i < 7; ++i)
        if (r.f(1, "prob_coded")) r.f(8, "segmentation_tree_probs");
      if (r.f(1, "segmentation_temporal_update"))
        for (int i = 0; i < 3; ++i)
          if (r.f(1, "prob_coded")) r.f(8, "segmentation_pred_prob");
    }
    if (r.f(1, "segmentation_update_data")) {
      r.f(1, "segmentation_abs_or_delta_update");
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j)
          if (r.f(1, "feature_enabled") && SEG_FEATURE_BITS[j]) r.f(SEG_FEATURE_BITS[j] + (j < 2), "feature_value");
    }
  }
  int sb64_cols = (((size[0] + 7) >> 3) + 7) >> 3;
  int lo = 0;
  while ((64 << lo) < sb64_cols) ++lo;
  int hi = 1;
  while ((sb64_cols >> hi) >= 4) ++hi;
  --hi;
  while (lo < hi && r.f(1, "increment_tile_cols_log2")) ++lo;
  if (r.f(1, "increment_tile_rows_log2")) r.f(1, "increment_tile_rows_log2");
  r.f(16, "header_size_in_bytes");
  for (int i = 0; i < 8; ++i)
    if (refresh & (1 << i)) ref_sizes[i][0] = size[0], ref_sizes[i][1] = size[1];
  end();
}

// -- probabilities and counts ------------------------------------------------

struct MvComp {
  uint8_t sign, classes[10], class0[1], bits[10], class0_fp[2][3], fp[3], class0_hp, hp;
};

struct Probs {
  uint8_t coef[4][2][2][6][6][3];
  uint8_t tx8[2][1], tx16[2][2], tx32[2][3], skip[3], inter_mode[7][3], interp[4][2];
  uint8_t intra_inter[4], comp_inter[5], single_ref[5][2], comp_ref[5];
  uint8_t y_mode[4][9], uv_mode[10][9], partition[16][3], mv_joint[3];
  MvComp mv_comp[2];
};

Probs default_probs() {
  Probs p;
  std::memcpy(p.coef[0], COEF_PROBS_4X4, sizeof(p.coef[0]));
  std::memcpy(p.coef[1], COEF_PROBS_8X8, sizeof(p.coef[1]));
  std::memcpy(p.coef[2], COEF_PROBS_16X16, sizeof(p.coef[2]));
  std::memcpy(p.coef[3], COEF_PROBS_32X32, sizeof(p.coef[3]));
  std::memcpy(p.tx8, TX_PROBS_8X8, sizeof(p.tx8));
  std::memcpy(p.tx16, TX_PROBS_16X16, sizeof(p.tx16));
  std::memcpy(p.tx32, TX_PROBS_32X32, sizeof(p.tx32));
  std::memcpy(p.skip, SKIP_PROBS, 3);
  std::memcpy(p.inter_mode, INTER_MODE_PROBS, sizeof(p.inter_mode));
  std::memcpy(p.interp, SWITCHABLE_INTERP_PROB, sizeof(p.interp));
  std::memcpy(p.intra_inter, INTRA_INTER_P, 4);
  std::memcpy(p.comp_inter, COMP_INTER_P, 5);
  std::memcpy(p.single_ref, SINGLE_REF_P, sizeof(p.single_ref));
  std::memcpy(p.comp_ref, COMP_REF_P, 5);
  std::memcpy(p.y_mode, IF_Y_PROBS, sizeof(p.y_mode));
  std::memcpy(p.uv_mode, IF_UV_PROBS, sizeof(p.uv_mode));
  std::memcpy(p.partition, PARTITION_PROBS, sizeof(p.partition));
  std::memcpy(p.mv_joint, MV_JOINTS, 3);
  const uint8_t* comps[2] = {MV_COMP0, MV_COMP1};
  for (int i = 0; i < 2; ++i) {
    const uint8_t* v = comps[i];
    MvComp& c = p.mv_comp[i];
    c.sign = v[0];
    std::memcpy(c.classes, v + 1, 10);
    c.class0[0] = v[11];
    std::memcpy(c.bits, v + 12, 10);
    std::memcpy(c.class0_fp, v + 22, 6);
    std::memcpy(c.fp, v + 28, 3);
    c.class0_hp = v[31];
    c.hp = v[32];
  }
  return p;
}

struct MvCounts {
  unsigned sign[2], classes[11], class0[2], bits[10][2], class0_fp[2][4], fp[4], class0_hp[2], hp[2];
};

struct Counts {
  unsigned coef[4][2][2][6][6][4], eob[4][2][2][6][6];
  unsigned tx8[2][2], tx16[2][3], tx32[2][4], skip[3][2], inter_mode[7][4], interp[4][3];
  unsigned intra_inter[4][2], comp_inter[5][2], single_ref[5][2][2], comp_ref[5][2];
  unsigned y_mode[4][10], uv_mode[10][10], partition[16][4], mv_joint[4];
  MvCounts mv_comp[2];
};

int inv_recenter_nonneg(int v, int m) {
  if (v > 2 * m) return v;
  return (v & 1) ? m - ((v + 1) >> 1) : m + (v >> 1);
}

int update_prob(Reader& br, int p) {
  int d;
  if (!br.bit(128)) {
    d = br.value_bits(4);
  } else if (!br.bit(128)) {
    d = br.value_bits(4) + 16;
  } else if (!br.bit(128)) {
    d = br.value_bits(5) + 32;
  } else {
    d = br.value_bits(7);
    if (d >= 65) d = (d << 1) - 65 + br.bit(128);
    d += 64;
  }
  if (p <= 128) return 1 + inv_recenter_nonneg(INV_MAP_TABLE[d], p - 1);
  return 255 - inv_recenter_nonneg(INV_MAP_TABLE[d], 255 - p);
}

void diff_update(Reader& br, uint8_t& p) {
  if (br.bit(252)) p = static_cast<uint8_t>(update_prob(br, p));
}

void mv_update(Reader& br, uint8_t& p) {
  if (br.bit(252)) p = static_cast<uint8_t>((br.value_bits(7) << 1) | 1);
}

int binary_prob(unsigned n0, unsigned n1) {
  unsigned den = n0 + n1;
  if (den == 0) return 128;
  long long p = (static_cast<long long>(n0) * 256 + (den >> 1)) / den;
  return static_cast<int>(std::min<long long>(255, std::max<long long>(1, p)));
}

uint8_t merge_prob(int pre, unsigned ct0, unsigned ct1, unsigned sat, unsigned max_factor) {
  unsigned den = ct0 + ct1;
  if (den == 0) return static_cast<uint8_t>(pre);
  int prob = binary_prob(ct0, ct1);
  unsigned factor = max_factor * std::min(den, sat) / sat;
  return static_cast<uint8_t>((pre * (256 - static_cast<int>(factor)) + prob * static_cast<int>(factor) + 128) >> 8);
}

uint8_t mode_merge(int pre, const unsigned* ct) { return merge_prob(pre, ct[0], ct[1], 20, 128); }

unsigned tree_merge_walk(const int8_t* tree, int i, const uint8_t* pre, const unsigned* counts, uint8_t* out) {
  int l = tree[i];
  unsigned lc = l <= 0 ? counts[-l] : tree_merge_walk(tree, l, pre, counts, out);
  int r = tree[i + 1];
  unsigned rc = r <= 0 ? counts[-r] : tree_merge_walk(tree, r, pre, counts, out);
  unsigned ct[2] = {lc, rc};
  out[i >> 1] = mode_merge(pre[i >> 1], ct);
  return lc + rc;
}

// vpx_tree_merge_probs over n probabilities in place (the pre-frame ones
// copied first, as the Python version passes a copy)
void tree_merge(const int8_t* tree, uint8_t* probs, int n, const unsigned* counts) {
  uint8_t pre[16];
  std::memcpy(pre, probs, n);
  tree_merge_walk(tree, 0, pre, counts, probs);
}

// -- inverse transforms (vp9.idct, vp9.iadst*, vp9.iwht4) -----------------------

const int COSPI[33] = {16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426, 15137, 14811, 14449,
                       14053, 13623, 13160, 12665, 12140, 11585, 11003, 10394, 9760, 9102, 8423,
                       7723, 7005, 6270, 5520, 4756, 3981, 3196, 2404, 1606, 804, 0};
const int SINPI[5] = {0, 5283, 9929, 13377, 15212};

inline long long rs(long long x) { return (x + 8192) >> 14; }

int brev(int bits, int x) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

int cos128(int angle) {
  int a = angle & 255;
  if (a <= 64) return COSPI[a >> 1];
  if (a <= 128) return -COSPI[(128 - a) >> 1];
  if (a <= 192) return -COSPI[(a - 128) >> 1];
  return COSPI[(256 - a) >> 1];
}

struct Op {
  bool rot;
  int a, b, angle, flip;
};

std::vector<Op> idct_program(int n) {
  std::vector<Op> prog;
  auto B = [&](int a, int b, int angle, int flip) { prog.push_back({true, a, b, angle, flip}); };
  auto H = [&](int a, int b, int flip) { prog.push_back(flip ? Op{false, b, a, 0, 0} : Op{false, a, b, 0, 0}); };
  if (n >= 5) for (int i = 0; i < 8; ++i) B(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
  if (n >= 4) for (int i = 0; i < 4; ++i) B(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
  if (n >= 5) for (int i = 0; i < 8; ++i) H(16 + 2 * i, 17 + 2 * i, i & 1);
  if (n >= 3) for (int i = 0; i < 2; ++i) B(4 + i, 7 - i, 56 - 32 * i, 0);
  if (n >= 4) for (int i = 0; i < 4; ++i) H(8 + 2 * i, 9 + 2 * i, i & 1);
  if (n >= 5)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
  for (int i = 0; i < 2; ++i) B(2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i);
  if (n >= 3) for (int i = 0; i < 2; ++i) H(4 + 2 * i, 5 + 2 * i, i);
  if (n >= 4) for (int i = 0; i < 2; ++i) B(14 - i, 9 + i, 48 + 64 * i, 1);
  if (n >= 5)
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 2; ++j) H(16 + 4 * i + j, 19 + 4 * i - j, i & 1);
  for (int i = 0; i < 2; ++i) H(i, 3 - i, 0);
  if (n >= 3) B(6, 5, 32, 1);
  if (n >= 4)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) H(8 + 4 * i + j, 11 + 4 * i - j, i);
  if (n >= 5) for (int i = 0; i < 4; ++i) B(29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
  if (n >= 3) for (int i = 0; i < 4; ++i) H(i, 7 - i, 0);
  if (n >= 4) for (int i = 0; i < 2; ++i) B(13 - i, 10 + i, 32, 1);
  if (n >= 5)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j) H(16 + i * 8 + j, 23 + i * 8 - j, i);
  if (n >= 4) for (int i = 0; i < 8; ++i) H(i, 15 - i, 0);
  if (n >= 5) for (int i = 0; i < 4; ++i) B(27 - i, 20 + i, 32, 1);
  if (n >= 5) for (int i = 0; i < 16; ++i) H(i, 31 - i, 0);
  return prog;
}

const std::vector<Op>& idct_ops(int n) {
  static const std::vector<Op> progs[4] = {idct_program(2), idct_program(3), idct_program(4),
                                           idct_program(5)};
  return progs[n - 2];
}

void idct(const long long* x, long long* out, int size) {
  int n = size == 4 ? 2 : size == 8 ? 3 : size == 16 ? 4 : 5;
  long long t[32];
  for (int i = 0; i < size; ++i) t[i] = x[brev(n, i)];
  for (const Op& op : idct_ops(n)) {
    long long ta = t[op.a], tb = t[op.b];
    if (op.rot) {
      long long c = cos128(op.angle), s = cos128(op.angle - 64);
      long long na = rs(ta * c - tb * s), nb = rs(ta * s + tb * c);
      if (op.flip) std::swap(na, nb);
      t[op.a] = na, t[op.b] = nb;
    } else {
      t[op.a] = ta + tb, t[op.b] = ta - tb;
    }
  }
  for (int i = 0; i < size; ++i) out[i] = t[i];
}

void iadst4(const long long* x, long long* o) {
  long long s0 = SINPI[1] * x[0] + SINPI[4] * x[2] + SINPI[2] * x[3];
  long long s1 = SINPI[2] * x[0] - SINPI[1] * x[2] - SINPI[4] * x[3];
  long long s3 = SINPI[3] * x[1];
  long long s2 = SINPI[3] * (x[0] - x[2] + x[3]);
  o[0] = rs(s0 + s3), o[1] = rs(s1 + s3), o[2] = rs(s2), o[3] = rs(s0 + s1 - s3);
}

void iadst8(const long long* in, long long* o) {
  const int* c = COSPI;
  long long x0 = in[7], x1 = in[0], x2 = in[5], x3 = in[2], x4 = in[3], x5 = in[4], x6 = in[1], x7 = in[6];
  long long s0 = c[2] * x0 + c[30] * x1, s1 = c[30] * x0 - c[2] * x1;
  long long s2 = c[10] * x2 + c[22] * x3, s3 = c[22] * x2 - c[10] * x3;
  long long s4 = c[18] * x4 + c[14] * x5, s5 = c[14] * x4 - c[18] * x5;
  long long s6 = c[26] * x6 + c[6] * x7, s7 = c[6] * x6 - c[26] * x7;
  x0 = rs(s0 + s4), x1 = rs(s1 + s5), x2 = rs(s2 + s6), x3 = rs(s3 + s7);
  x4 = rs(s0 - s4), x5 = rs(s1 - s5), x6 = rs(s2 - s6), x7 = rs(s3 - s7);
  s4 = c[8] * x4 + c[24] * x5, s5 = c[24] * x4 - c[8] * x5;
  s6 = -c[24] * x6 + c[8] * x7, s7 = c[8] * x6 + c[24] * x7;
  long long a0 = x0 + x2, a1 = x1 + x3, a2 = x0 - x2, a3 = x1 - x3;
  x4 = rs(s4 + s6), x5 = rs(s5 + s7), x6 = rs(s4 - s6), x7 = rs(s5 - s7);
  x2 = rs(c[16] * (a2 + a3)), x3 = rs(c[16] * (a2 - a3));
  long long y6 = rs(c[16] * (x6 + x7)), y7 = rs(c[16] * (x6 - x7));
  o[0] = a0, o[1] = -x4, o[2] = y6, o[3] = -x2, o[4] = x3, o[5] = -y7, o[6] = x5, o[7] = -a1;
}

void iadst16(const long long* in, long long* o) {
  const int* c = COSPI;
  long long x0 = in[15], x1 = in[0], x2 = in[13], x3 = in[2], x4 = in[11], x5 = in[4], x6 = in[9], x7 = in[6];
  long long x8 = in[7], x9 = in[8], x10 = in[5], x11 = in[10], x12 = in[3], x13 = in[12], x14 = in[1], x15 = in[14];
  long long s0 = x0 * c[1] + x1 * c[31], s1 = x0 * c[31] - x1 * c[1];
  long long s2 = x2 * c[5] + x3 * c[27], s3 = x2 * c[27] - x3 * c[5];
  long long s4 = x4 * c[9] + x5 * c[23], s5 = x4 * c[23] - x5 * c[9];
  long long s6 = x6 * c[13] + x7 * c[19], s7 = x6 * c[19] - x7 * c[13];
  long long s8 = x8 * c[17] + x9 * c[15], s9 = x8 * c[15] - x9 * c[17];
  long long s10 = x10 * c[21] + x11 * c[11], s11 = x10 * c[11] - x11 * c[21];
  long long s12 = x12 * c[25] + x13 * c[7], s13 = x12 * c[7] - x13 * c[25];
  long long s14 = x14 * c[29] + x15 * c[3], s15 = x14 * c[3] - x15 * c[29];
  x0 = rs(s0 + s8), x1 = rs(s1 + s9), x2 = rs(s2 + s10), x3 = rs(s3 + s11);
  x4 = rs(s4 + s12), x5 = rs(s5 + s13), x6 = rs(s6 + s14), x7 = rs(s7 + s15);
  x8 = rs(s0 - s8), x9 = rs(s1 - s9), x10 = rs(s2 - s10), x11 = rs(s3 - s11);
  x12 = rs(s4 - s12), x13 = rs(s5 - s13), x14 = rs(s6 - s14), x15 = rs(s7 - s15);
  s8 = x8 * c[4] + x9 * c[28], s9 = x8 * c[28] - x9 * c[4];
  s10 = x10 * c[20] + x11 * c[12], s11 = x10 * c[12] - x11 * c[20];
  s12 = -x12 * c[28] + x13 * c[4], s13 = x12 * c[4] + x13 * c[28];
  s14 = -x14 * c[12] + x15 * c[20], s15 = x14 * c[20] + x15 * c[12];
  long long a0 = x0 + x4, a1 = x1 + x5, a2 = x2 + x6, a3 = x3 + x7;
  long long a4 = x0 - x4, a5 = x1 - x5, a6 = x2 - x6, a7 = x3 - x7;
  x8 = rs(s8 + s12), x9 = rs(s9 + s13), x10 = rs(s10 + s14), x11 = rs(s11 + s15);
  x12 = rs(s8 - s12), x13 = rs(s9 - s13), x14 = rs(s10 - s14), x15 = rs(s11 - s15);
  s4 = a4 * c[8] + a5 * c[24], s5 = a4 * c[24] - a5 * c[8];
  s6 = -a6 * c[24] + a7 * c[8], s7 = a6 * c[8] + a7 * c[24];
  s12 = x12 * c[8] + x13 * c[24], s13 = x12 * c[24] - x13 * c[8];
  s14 = -x14 * c[24] + x15 * c[8], s15 = x14 * c[8] + x15 * c[24];
  x0 = a0 + a2, x1 = a1 + a3, x2 = a0 - a2, x3 = a1 - a3;
  x4 = rs(s4 + s6), x5 = rs(s5 + s7), x6 = rs(s4 - s6), x7 = rs(s5 - s7);
  long long b8 = x8 + x10, b9 = x9 + x11, b10 = x8 - x10, b11 = x9 - x11;
  x12 = rs(s12 + s14), x13 = rs(s13 + s15), x14 = rs(s12 - s14), x15 = rs(s13 - s15);
  long long y2 = rs(-c[16] * (x2 + x3)), y3 = rs(c[16] * (x2 - x3));
  long long y6 = rs(c[16] * (x6 + x7)), y7 = rs(c[16] * (-x6 + x7));
  long long y10 = rs(c[16] * (b10 + b11)), y11 = rs(c[16] * (-b10 + b11));
  long long y14 = rs(-c[16] * (x14 + x15)), y15 = rs(c[16] * (x14 - x15));
  long long r[16] = {x0, -b8, x12, -x4, y6, y14, y10, y2, y3, y11, y15, y7, x5, -x13, b9, -x1};
  for (int i = 0; i < 16; ++i) o[i] = r[i];
}

void transform_1d(bool adst, const long long* x, long long* o, int n) {
  if (!adst) return idct(x, o, n);
  if (n == 4) return iadst4(x, o);
  if (n == 8) return iadst8(x, o);
  iadst16(x, o);
}

// vp9.inverse_transform: res[r * n + c] from the raster coefficients
void inverse_transform(const long long* coef, int n, int tx_type, bool lossless, long long* res) {
  long long mid[1024], in[32], out[32];
  if (lossless) {
    auto one = [](long long a1, long long c1, long long d1, long long b1, long long* o) {
      a1 += c1;
      d1 -= b1;
      long long e1 = (a1 - d1) >> 1;
      b1 = e1 - b1;
      c1 = e1 - c1;
      a1 -= b1;
      d1 += c1;
      o[0] = a1, o[1] = b1, o[2] = c1, o[3] = d1;
    };
    for (int r = 0; r < 4; ++r)
      one(coef[r * 4] >> 2, coef[r * 4 + 1] >> 2, coef[r * 4 + 2] >> 2, coef[r * 4 + 3] >> 2, mid + r * 4);
    for (int c = 0; c < 4; ++c) {
      long long o[4];
      one(mid[c], mid[4 + c], mid[8 + c], mid[12 + c], o);
      for (int r = 0; r < 4; ++r) res[r * 4 + c] = o[r];
    }
    return;
  }
  bool row_adst = tx_type == 2 || tx_type == 3, col_adst = tx_type == 1 || tx_type == 3;
  for (int r = 0; r < n; ++r) {
    for (int i = 0; i < n; ++i) in[i] = coef[r * n + i];
    transform_1d(row_adst, in, mid + r * n, n);
  }
  int shift = n == 4 ? 4 : n == 8 ? 5 : 6;
  for (int c = 0; c < n; ++c) {
    for (int i = 0; i < n; ++i) in[i] = mid[i * n + c];
    transform_1d(col_adst, in, out, n);
    for (int r = 0; r < n; ++r) res[r * n + c] = (out[r] + (1LL << (shift - 1))) >> shift;
  }
}

// -- intra prediction (vp9.intra_pred) ----------------------------------------------

// mode 10: DC from the left alone, 11: from the top, 12: 128
void intra_pred(int mode, int bs, const int* a, int al, const int* l, int* out) {
  auto at = [&](int r, int c) -> int& { return out[r * bs + c]; };
  if (mode == V_PRED) {
    for (int r = 0; r < bs; ++r)
      for (int c = 0; c < bs; ++c) at(r, c) = a[c];
  } else if (mode == H_PRED) {
    for (int r = 0; r < bs; ++r)
      for (int c = 0; c < bs; ++c) at(r, c) = l[r];
  } else if (mode == DC_PRED || mode == 10 || mode == 11 || mode == 12) {
    int v = 128, sa = 0, sl = 0;
    for (int i = 0; i < bs; ++i) sa += a[i], sl += l[i];
    if (mode == DC_PRED) v = (sa + sl + bs) / (2 * bs);
    if (mode == 10) v = (sl + (bs >> 1)) / bs;
    if (mode == 11) v = (sa + (bs >> 1)) / bs;
    for (int i = 0; i < bs * bs; ++i) out[i] = v;
  } else if (mode == TM_PRED) {
    for (int r = 0; r < bs; ++r)
      for (int c = 0; c < bs; ++c) at(r, c) = clampi(l[r] + a[c] - al, 0, 255);
  } else if (mode == D45_PRED) {
    for (int r = 0; r < bs; ++r)
      for (int c = 0; c < bs; ++c) {
        int i = r + c;
        at(r, c) = i == 2 * bs - 2 ? a[2 * bs - 1] : (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2;
      }
  } else if (mode == D63_PRED) {
    for (int r = 0; r < bs; ++r)
      for (int c = 0; c < bs; ++c) {
        int i = (r >> 1) + c;
        at(r, c) = !(r & 1) ? (a[i] + a[i + 1] + 1) >> 1 : (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2;
      }
  } else if (mode == D207_PRED) {
    int ll[80];
    for (int i = 0; i < bs; ++i) ll[i] = l[i];
    for (int i = bs; i < 2 * bs + 2; ++i) ll[i] = l[bs - 1];
    for (int r = 0; r < bs; ++r)
      for (int c = 0; c < bs; ++c) {
        int k = 2 * r + c, i = k >> 1;
        at(r, c) = !(k & 1) ? (ll[i] + ll[i + 1] + 1) >> 1 : (ll[i] + 2 * ll[i + 1] + ll[i + 2] + 2) >> 2;
      }
  } else if (mode == D135_PRED) {
    int e[70], f[70];
    for (int i = 0; i < bs; ++i) e[i] = l[bs - 1 - i];
    e[bs] = al;
    for (int i = 0; i < bs; ++i) e[bs + 1 + i] = a[i];
    for (int k = 1; k < 2 * bs; ++k) f[k] = (e[k - 1] + 2 * e[k] + e[k + 1] + 2) >> 2;
    for (int r = 0; r < bs; ++r)
      for (int c = 0; c < bs; ++c) at(r, c) = f[bs - r + c];
  } else if (mode == D117_PRED) {
    for (int c = 0; c < bs; ++c) at(0, c) = ((c ? a[c - 1] : al) + a[c] + 1) >> 1;
    at(1, 0) = (l[0] + 2 * al + a[0] + 2) >> 2;
    for (int c = 1; c < bs; ++c) at(1, c) = ((c >= 2 ? a[c - 2] : al) + 2 * a[c - 1] + a[c] + 2) >> 2;
    at(2, 0) = (al + 2 * l[0] + l[1] + 2) >> 2;
    for (int r = 3; r < bs; ++r) at(r, 0) = (l[r - 3] + 2 * l[r - 2] + l[r - 1] + 2) >> 2;
    for (int r = 2; r < bs; ++r)
      for (int c = 1; c < bs; ++c) at(r, c) = at(r - 2, c - 1);
  } else {  // D153_PRED
    at(0, 0) = (al + l[0] + 1) >> 1;
    for (int r = 1; r < bs; ++r) at(r, 0) = (l[r - 1] + l[r] + 1) >> 1;
    at(0, 1) = (l[0] + 2 * al + a[0] + 2) >> 2;
    at(1, 1) = (al + 2 * l[0] + l[1] + 2) >> 2;
    for (int r = 2; r < bs; ++r) at(r, 1) = (l[r - 2] + 2 * l[r - 1] + l[r] + 2) >> 2;
    for (int c = 0; c < bs - 2; ++c) at(0, c + 2) = ((c ? a[c - 1] : al) + 2 * a[c] + a[c + 1] + 2) >> 2;
    for (int r = 1; r < bs; ++r)
      for (int c = 2; c < bs; ++c) at(r, c) = at(r - 1, c - 2);
  }
}

// -- inter prediction (vp9.predict_block) -----------------------------------------

const int16_t (*const KERNELS[4])[8] = {SUB_PEL_FILTERS_8, SUB_PEL_FILTERS_8LP, SUB_PEL_FILTERS_8S,
                                         BILINEAR_FILTERS};

void predict_block(const uint8_t* plane, int stride, int width, int height, int x, int y, int bw,
                   int bh, int mvx, int mvy, bool luma, int filt, int* out) {
  int fx, fy;
  if (luma) {
    fx = (mvx & 7) << 1, fy = (mvy & 7) << 1, x += mvx >> 3, y += mvy >> 3;
  } else {
    fx = mvx & 15, fy = mvy & 15, x += mvx >> 4, y += mvy >> 4;
  }
  const int16_t* kx = KERNELS[filt][fx];
  const int16_t* ky = KERNELS[filt][fy];
  static thread_local std::vector<int> tmp;
  tmp.resize(static_cast<size_t>(bh + 7) * bw);
  int cols[72];
  for (int i = 0; i < bw + 7; ++i) cols[i] = clampi(x - 3 + i, 0, width - 1);
  for (int r = 0; r < bh + 7; ++r) {
    const uint8_t* row = plane + static_cast<size_t>(clampi(y - 3 + r, 0, height - 1)) * stride;
    for (int c = 0; c < bw; ++c) {
      int acc = 0;
      for (int k = 0; k < 8; ++k) acc += row[cols[c + k]] * kx[k];
      tmp[static_cast<size_t>(r) * bw + c] = clampi((acc + 64) >> 7, 0, 255);
    }
  }
  for (int r = 0; r < bh; ++r)
    for (int c = 0; c < bw; ++c) {
      int acc = 0;
      for (int k = 0; k < 8; ++k) acc += tmp[static_cast<size_t>(r + k) * bw + c] * ky[k];
      out[r * bw + c] = clampi((acc + 64) >> 7, 0, 255);
    }
}

// -- the loop filter (vp9.filter_edge) ----------------------------------------------

inline int sc(int v) { return clampi(v, -128, 127); }

// one line across an edge: px[0..15] = p7 .. p0, q0 .. q7 (stride apart)
void filter_line(uint8_t* s, int step, int lim, int mblim, int hev_t, int wide) {
  int p[8] = {0}, q[8] = {0};
  int n = wide == 16 ? 8 : 4;  // the 4- and 8-wide filters read p3 .. q3 alone
  for (int i = 0; i < n; ++i) p[i] = s[-(i + 1) * step], q[i] = s[i * step];
  bool mask = std::abs(p[3] - p[2]) <= lim && std::abs(p[2] - p[1]) <= lim && std::abs(p[1] - p[0]) <= lim &&
              std::abs(q[1] - q[0]) <= lim && std::abs(q[2] - q[1]) <= lim && std::abs(q[3] - q[2]) <= lim &&
              std::abs(p[0] - q[0]) * 2 + std::abs(p[1] - q[1]) / 2 <= mblim;
  if (!mask) return;
  bool hev = std::abs(p[1] - p[0]) > hev_t || std::abs(q[1] - q[0]) > hev_t;
  bool flat = false, flat2 = false;
  if (wide >= 8)
    flat = std::abs(p[1] - p[0]) <= 1 && std::abs(q[1] - q[0]) <= 1 && std::abs(p[2] - p[0]) <= 1 &&
           std::abs(q[2] - q[0]) <= 1 && std::abs(p[3] - p[0]) <= 1 && std::abs(q[3] - q[0]) <= 1;
  if (wide == 16) {
    flat2 = flat;
    for (int i = 4; i < 8; ++i) flat2 = flat2 && std::abs(p[i] - p[0]) <= 1 && std::abs(q[i] - q[0]) <= 1;
  }
  if (flat2) {
    int x[16];
    for (int i = 0; i < 8; ++i) x[i] = p[7 - i], x[8 + i] = q[i];
    for (int k = 1; k < 15; ++k) {
      int sum = x[k];
      for (int j = k - 7; j <= k + 7; ++j) sum += x[clampi(j, 0, 15)];
      s[(k - 8) * step] = static_cast<uint8_t>((sum + 8) >> 4);
    }
    return;
  }
  if (flat) {
    int x[8];
    for (int i = 0; i < 4; ++i) x[i] = p[3 - i], x[4 + i] = q[i];
    for (int k = 1; k < 7; ++k) {
      int sum = x[k];
      for (int j = k - 3; j <= k + 3; ++j) sum += x[clampi(j, 0, 7)];
      s[(k - 4) * step] = static_cast<uint8_t>((sum + 4) >> 3);
    }
    return;
  }
  int ps1 = p[1] - 128, ps0 = p[0] - 128, qs0 = q[0] - 128, qs1 = q[1] - 128;
  int f = hev ? sc(ps1 - qs1) : 0;
  f = sc(f + 3 * (qs0 - ps0));
  int f1 = sc(f + 4) >> 3, f2 = sc(f + 3) >> 3;
  s[0] = static_cast<uint8_t>(sc(qs0 - f1) + 128);
  s[-step] = static_cast<uint8_t>(sc(ps0 + f2) + 128);
  f = hev ? 0 : (f1 + 1) >> 1;
  s[step] = static_cast<uint8_t>(sc(qs1 - f) + 128);
  s[-2 * step] = static_cast<uint8_t>(sc(ps1 + f) + 128);
}

// -- the decoder (vp9.Vp9Decoder) ---------------------------------------------------

struct Mv {
  int r = 0, c = 0;
  bool operator==(const Mv& o) const { return r == o.r && c == o.c; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
};

struct Block {
  int size = 0, skip = 0, tx = 0, inter = 0, ref[2] = {0, -1}, mode = DC_PRED;
  int sub_modes[4] = {0, 0, 0, 0}, uv_mode = DC_PRED, filt = 3, seg = 0;
  Mv mv[2][4];
};

struct Frame {
  std::vector<uint8_t> plane[3];
  int stride[3] = {0, 0, 0}, rows[3] = {0, 0, 0};
  int width = 0, height = 0, full_range = 0;
};

struct MvPair {
  int ref0 = -1, ref1 = -1;
  Mv mv0, mv1;
};

struct Header {
  int key = 0, show = 0, error_res = 0, intra_only = 0, reset = 0, intra = 0;
  int sign_bias[4] = {0, 0, 0, 0}, ref_idx[3] = {0, 0, 0}, hp = 0, filter = 0, last_key = 0;
  int refresh = 0, refresh_ctx = 0, parallel = 0, c = 0, ctx_idx = 0;
  int level = 0, sharpness = 0, lf_delta = 0, base_q = 0, dq[3] = {0, 0, 0}, lossless = 0;
  int log2_cols = 0, log2_rows = 0, w = 0, h = 0, use_prev = 0;
  int tx_mode = 0, ref_mode = 0, fix_ref = 0, var_ref[2] = {0, 0};
};

struct Seg {
  int enabled = 0, update_map = 0, temporal = 0, abs = 0;
  uint8_t tree[7] = {255, 255, 255, 255, 255, 255, 255}, pred[3] = {255, 255, 255};
  bool on[8][4] = {};
  int val[8][4] = {};
};

struct SbEntry {
  int r, c, b;
};

struct Decoder {
  std::shared_ptr<Frame> refs[8];
  Probs ctx[4];
  int width = 0, height = 0, full_range = 0, cur_range = 0;
  bool has_last = false;
  int last_w = 0, last_h = 0;
  bool last_shown = true, last_key = false, prev_update_map = false;
  std::vector<MvPair> last_mvs;
  std::shared_ptr<std::vector<uint8_t>> last_segmap, segref;
  int lf_ref[4] = {1, 0, -1, -1}, lf_mode[2] = {0, 0};
  Seg seg;
  std::string error;
  int cbs_refs[8][2] = {};  // cbs_vp9's reference sizes
  // the packet from the frame's start on: the readers read on past the frame
  const uint8_t* tail = nullptr;
  long long tail_n = 0;
  // the frame being decoded
  Probs fc;
  Counts counts;
  Header h;
  int mi_cols = 0, mi_rows = 0, sb_cols = 0;
  std::shared_ptr<Frame> cur;
  std::shared_ptr<std::vector<uint8_t>> segmap;
  bool write_segmap = false;
  int qmul[8][2][2], lvl[8][4][2];
  std::vector<Block> blocks;
  std::vector<int> grid;
  std::vector<int> above_nz[3], above_part, above_segpred;
  int left_nz[3][16], left_part[8], left_segpred[8];
  std::vector<std::vector<SbEntry>> sb_blocks;
  int tile_c0 = 0, tile_c1 = 0;
  const Frame* ref_frames[4] = {nullptr, nullptr, nullptr, nullptr};
  // the last shown frame
  std::shared_ptr<Frame> shown;
  int out_w = 0, out_h = 0;

  Decoder() {
    for (auto& c : ctx) c = default_probs();
  }

  // vp9.split_superframe
  static std::vector<std::pair<long long, long long>> split_superframe(const uint8_t* data, long long n) {
    std::vector<std::pair<long long, long long>> out;
    if (n) {
      int marker = data[n - 1];
      if ((marker & 0xE0) == 0xC0) {
        int mag = ((marker >> 3) & 3) + 1, count = (marker & 7) + 1;
        long long idx = 2 + static_cast<long long>(mag) * count;
        if (n >= idx && data[n - idx] == marker) {
          long long total = 0, at = n - idx + 1, pos = 0;
          std::vector<long long> sizes;
          for (int i = 0; i < count; ++i) {
            long long s = 0;
            for (int j = 0; j < mag; ++j) s |= static_cast<long long>(data[at + j]) << (8 * j);
            at += mag;
            total += s;
            if (s <= 0 || total > n - idx)
              fail("invalid frame size " + std::to_string(s) + " in a superframe");
            sizes.push_back(s);
          }
          for (long long s : sizes) out.push_back({pos, s}), pos += s;
          return out;
        }
      }
    }
    out.push_back({0, n});
    return out;
  }

  // 1 when a frame is shown (in `shown`), 0 when none
  int decode(const uint8_t* data, long long n) {
    int result = 0;
    for (auto& part : split_superframe(data, n)) {
      const uint8_t* frame = data + part.first;
      auto units = cbs_units(frame, part.second);
      for (auto& unit : units) cbs_header(frame + unit.first, unit.second, cbs_refs);
      for (auto& unit : units) {
        tail = frame + unit.first, tail_n = n - part.first - unit.first;
        std::vector<uint8_t> bytes(frame + unit.first, frame + unit.first + unit.second);
        if (decode_frame(bytes)) result = 1;
      }
    }
    return result;
  }

  void show(const std::shared_ptr<Frame>& f) {
    shown = f;
    out_w = f->width, out_h = f->height;
    full_range = f->full_range;
  }

  void color_config(Bits& r) {
    int cs = r.f(3);
    if (cs == 7) fail("RGB not supported in profile 0");
    if (OTHER_MATRIX(cs))
      fail(std::string("the colour space ") + OTHER_MATRIX(cs) +
               ": cv2 converts it with its own matrix; the port converts BT.601 alone", -2);
    cur_range = r.f(1);
  }

  bool decode_frame(const std::vector<uint8_t>& data) {
    Bits r{data.data(), static_cast<long long>(data.size())};
    if (r.f(2) != 2) fail("invalid frame marker");
    int profile = r.f(1) | r.f(1) << 1;
    if (profile == 3) profile += r.f(1);
    if (profile > 3) fail("profile " + std::to_string(profile) + " is not supported");
    if (profile)
      fail("VP9 profile " + std::to_string(profile) +
               " (4:4:4, 4:2:2, 4:4:0 or 10/12-bit): the port decodes profile 0 (8-bit 4:2:0) alone", -2);
    if (r.f(1)) {
      int idx = r.f(3);
      r.end();
      if (!refs[idx]) fail("requested reference " + std::to_string(idx) + " not available");
      show(refs[idx]);
      return true;
    }
    Header hd;
    hd.last_key = last_key;
    hd.key = !r.f(1);
    hd.show = r.f(1);
    hd.error_res = r.f(1);
    bool use_prev = !hd.error_res && last_shown;
    int w = 0, hh = 0;
    if (hd.key) {
      if (r.f(24) != SYNC_CODE) fail("invalid sync code");
      color_config(r);
      hd.refresh = 0xFF;
      w = r.f(16) + 1, hh = r.f(16) + 1;
      if (r.f(1)) r.f(32);
    } else {
      hd.intra_only = !hd.show ? r.f(1) : 0;
      hd.reset = hd.error_res ? 0 : r.f(2);
      if (hd.intra_only) {
        if (r.f(24) != SYNC_CODE) fail("invalid sync code");
        cur_range = 0;
        hd.refresh = r.f(8);
        w = r.f(16) + 1, hh = r.f(16) + 1;
        if (r.f(1)) r.f(32);
      } else {
        hd.refresh = r.f(8);
        for (int i = 0; i < 3; ++i) {
          hd.ref_idx[i] = r.f(3);
          hd.sign_bias[1 + i] = r.f(1) && !hd.error_res;
        }
        for (int i = 0; i < 3; ++i)
          if (!refs[hd.ref_idx[i]]) fail("not all references are available");
        bool found = false;
        for (int i = 0; i < 3; ++i)
          if (r.f(1)) {
            w = refs[hd.ref_idx[i]]->width, hh = refs[hd.ref_idx[i]]->height;
            found = true;
            break;
          }
        if (!found) w = r.f(16) + 1, hh = r.f(16) + 1;
        use_prev = use_prev && has_last && last_w == w && last_h == hh;
        if (r.f(1)) r.f(32);
        hd.hp = r.f(1);
        hd.filter = r.f(1) ? SWITCHABLE : LITERAL_TO_FILTER[r.f(2)];
        for (int i = 0; i < 3; ++i) {
          const Frame& ref = *refs[hd.ref_idx[i]];
          if (ref.width != w || ref.height != hh) {
            std::string rs_ = std::to_string(ref.width) + "x" + std::to_string(ref.height);
            std::string fs_ = std::to_string(w) + "x" + std::to_string(hh);
            if (w * 2 < ref.width || hh * 2 < ref.height || w > 16 * ref.width || hh > 16 * ref.height)
              fail("invalid reference dimensions " + rs_ + " for a frame of " + fs_);
            fail("a reference of " + rs_ + " for a frame of " + fs_ +
                     ": scaled motion compensation is not ported", -2);
          }
        }
      }
    }
    if (width && (w != width || hh != height))
      fail("a frame of " + std::to_string(w) + "x" + std::to_string(hh) + " after frames of " +
               std::to_string(width) + "x" + std::to_string(height) +
               ": the port refuses a change of the frame size", -2);
    hd.intra = hd.key || hd.intra_only;
    hd.refresh_ctx = hd.error_res ? 0 : r.f(1);
    hd.parallel = hd.error_res ? 1 : r.f(1);
    hd.c = r.f(2);
    hd.ctx_idx = hd.intra ? 0 : hd.c;
    if (hd.key || hd.error_res || hd.intra_only) {
      int d[4] = {1, 0, -1, -1};
      std::memcpy(lf_ref, d, sizeof(d));
      lf_mode[0] = lf_mode[1] = 0;
      std::memset(seg.on, 0, sizeof(seg.on));
    }
    hd.level = r.f(6);
    hd.sharpness = r.f(3);
    hd.lf_delta = r.f(1);
    if (hd.lf_delta && r.f(1)) {
      for (int i = 0; i < 4; ++i)
        if (r.f(1)) lf_ref[i] = r.su(6);
      for (int i = 0; i < 2; ++i)
        if (r.f(1)) lf_mode[i] = r.su(6);
    }
    hd.base_q = r.f(8);
    for (int i = 0; i < 3; ++i) hd.dq[i] = r.f(1) ? r.su(4) : 0;
    hd.lossless = hd.base_q == 0 && !hd.dq[0] && !hd.dq[1] && !hd.dq[2];
    seg.enabled = r.f(1);
    if (seg.enabled) {
      seg.update_map = r.f(1);
      if (seg.update_map) {
        for (int i = 0; i < 7; ++i) seg.tree[i] = static_cast<uint8_t>(r.f(1) ? r.f(8) : 255);
        seg.temporal = r.f(1);
        if (seg.temporal)
          for (int i = 0; i < 3; ++i) seg.pred[i] = static_cast<uint8_t>(r.f(1) ? r.f(8) : 255);
      }
      if (r.f(1)) {
        seg.abs = r.f(1);
        for (int i = 0; i < 8; ++i)
          for (int j = 0; j < 4; ++j) {
            seg.on[i][j] = r.f(1);
            seg.val[i][j] = 0;
            if (seg.on[i][j]) {
              int v = r.f(SEG_FEATURE_BITS[j]);
              if (j < 2 && r.f(1)) v = -v;
              seg.val[i][j] = v;
            }
          }
      }
    } else {
      seg.update_map = seg.temporal = 0;
    }
    int sbc = (((w + 7) >> 3) + 7) >> 3;
    int log2_cols = 0;
    while (sbc > (64 << log2_cols)) ++log2_cols;
    int max_log2 = 0;
    while ((sbc >> max_log2) >= 4) ++max_log2;
    max_log2 = std::max(0, max_log2 - 1);
    while (max_log2 > log2_cols && r.f(1)) ++log2_cols;
    int log2_rows = r.f(1);
    if (log2_rows) log2_rows += r.f(1);
    int header_size = r.f(16);
    r.end();
    long long pos = r.byte_pos();
    if (header_size > static_cast<long long>(data.size()) - pos)
      fail("invalid compressed header size " + std::to_string(header_size));
    width = w, height = hh;
    hd.w = w, hd.h = hh, hd.log2_cols = log2_cols, hd.log2_rows = log2_rows, hd.use_prev = use_prev;
    return decode_body(data, pos, header_size, hd);
  }

  void compressed_header(Reader& br) {
    if (br.bit(128)) fail("the compressed header's marker bit is set");
    int tx_mode;
    if (h.lossless) {
      tx_mode = ONLY_4X4;
    } else {
      tx_mode = br.value_bits(2);
      if (tx_mode == ALLOW_32X32) tx_mode += br.value_bits(1);
      if (tx_mode == TX_MODE_SELECT) {
        for (int i = 0; i < 2; ++i) diff_update(br, fc.tx8[i][0]);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j) diff_update(br, fc.tx16[i][j]);
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 3; ++j) diff_update(br, fc.tx32[i][j]);
      }
    }
    h.tx_mode = tx_mode;
    for (int t = 0; t <= TX_MODE_TO_BIGGEST[tx_mode]; ++t)
      if (br.value_bits(1))
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j)
            for (int k = 0; k < 6; ++k)
              for (int m = 0; m < (k == 0 ? 3 : 6); ++m)
                for (int n = 0; n < 3; ++n) diff_update(br, fc.coef[t][i][j][k][m][n]);
    for (int i = 0; i < 3; ++i) diff_update(br, fc.skip[i]);
    h.ref_mode = SINGLE_REFERENCE;
    if (h.intra) return;
    for (int i = 0; i < 7; ++i)
      for (int j = 0; j < 3; ++j) diff_update(br, fc.inter_mode[i][j]);
    if (h.filter == SWITCHABLE)
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 2; ++j) diff_update(br, fc.interp[i][j]);
    for (int i = 0; i < 4; ++i) diff_update(br, fc.intra_inter[i]);
    const int* sb = h.sign_bias;
    if (sb[2] != sb[1] || sb[3] != sb[1]) {
      int mode = br.value_bits(1);
      if (mode) mode += br.value_bits(1);
      h.ref_mode = mode;
      if (sb[1] == sb[2]) {
        h.fix_ref = 3, h.var_ref[0] = 1, h.var_ref[1] = 2;
      } else if (sb[1] == sb[3]) {
        h.fix_ref = 2, h.var_ref[0] = 1, h.var_ref[1] = 3;
      } else {
        h.fix_ref = 1, h.var_ref[0] = 2, h.var_ref[1] = 3;
      }
      if (mode == REFERENCE_MODE_SELECT)
        for (int i = 0; i < 5; ++i) diff_update(br, fc.comp_inter[i]);
    }
    if (h.ref_mode != COMPOUND_REFERENCE)
      for (int i = 0; i < 5; ++i) diff_update(br, fc.single_ref[i][0]), diff_update(br, fc.single_ref[i][1]);
    if (h.ref_mode != SINGLE_REFERENCE)
      for (int i = 0; i < 5; ++i) diff_update(br, fc.comp_ref[i]);
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 9; ++j) diff_update(br, fc.y_mode[i][j]);
    for (int i = 0; i < 16; ++i)
      for (int j = 0; j < 3; ++j) diff_update(br, fc.partition[i][j]);
    for (int j = 0; j < 3; ++j) mv_update(br, fc.mv_joint[j]);
    for (auto& comp : fc.mv_comp) {
      mv_update(br, comp.sign);
      for (int j = 0; j < 10; ++j) mv_update(br, comp.classes[j]);
      mv_update(br, comp.class0[0]);
      for (int j = 0; j < 10; ++j) mv_update(br, comp.bits[j]);
    }
    for (auto& comp : fc.mv_comp) {
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 3; ++k) mv_update(br, comp.class0_fp[j][k]);
      for (int k = 0; k < 3; ++k) mv_update(br, comp.fp[k]);
    }
    if (h.hp)
      for (auto& comp : fc.mv_comp) {
        mv_update(br, comp.class0_hp);
        mv_update(br, comp.hp);
      }
  }

  std::vector<Reader> tile_readers(const std::vector<uint8_t>& data, long long pos, int rows, int cols) {
    std::vector<Reader> out;
    long long n = static_cast<long long>(data.size());
    long long size = n - pos;
    for (int r = 0; r < rows; ++r)
      for (int c = 0; c < cols; ++c) {
        long long k;
        if (r == rows - 1 && c == cols - 1) {
          k = size;
        } else {
          k = 0;
          for (int i = 0; i < 4; ++i) k = (k << 8) | (pos + i < tail_n ? tail[pos + i] : 0);
          pos += 4, size -= 4;
        }
        if (k > size)
          fail("a tile of " + std::to_string(k) + " bytes with " + std::to_string(size) + " left in the frame");
        Reader br = range_decoder(tail, tail_n, pos, k);
        if (br.bit(128)) fail("a tile's marker bit is set");
        out.push_back(br);
        pos += k, size -= k;
      }
    return out;
  }

  static int tile_offset(int i, int mis, int log2) {
    int sbs = (mis + 7) >> 3;
    return std::min(((i * sbs) >> log2) << 3, mis);
  }

  bool decode_body(const std::vector<uint8_t>& data, long long pos, int header_size, const Header& hd) {
    h = hd;
    int c = h.c;
    if (h.key || h.error_res || (h.intra_only && h.reset == 3)) {
      for (auto& p : ctx) p = default_probs();
    } else if (h.intra_only && h.reset == 2) {
      ctx[c] = default_probs();
    }
    fc = ctx[c];
    Reader br = range_decoder(tail, tail_n, pos, header_size);
    compressed_header(br);
    int w = h.w, hh = h.h;
    mi_cols = (w + 7) >> 3, mi_rows = (hh + 7) >> 3;
    sb_cols = (mi_cols + 7) >> 3;
    int sb_rows = (mi_rows + 7) >> 3;
    bool intra = h.intra;
    bool retain = segref && !prev_update_map;
    if (!retain || intra || h.error_res) segref = (!intra && !h.error_res) ? last_segmap : nullptr;
    segmap = std::make_shared<std::vector<uint8_t>>(static_cast<size_t>(mi_rows) * mi_cols, 0);
    if (seg.enabled && !seg.update_map && !intra && !h.error_res && segref) *segmap = *segref;
    write_segmap = seg.enabled && (seg.update_map || intra);
    int nseg = seg.enabled ? 8 : 1;
    for (int s = 0; s < nseg; ++s) {
      bool qon = seg.enabled && seg.on[s][SEG_LVL_ALT_Q], lon = seg.enabled && seg.on[s][SEG_LVL_ALT_LF];
      int q = h.base_q;
      if (qon) q = clampi(seg.abs ? seg.val[s][0] : q + seg.val[s][0], 0, 255);
      qmul[s][0][0] = DC_QLOOKUP[clampi(q + h.dq[0], 0, 255)];
      qmul[s][0][1] = AC_QLOOKUP[q];
      qmul[s][1][0] = DC_QLOOKUP[clampi(q + h.dq[1], 0, 255)];
      qmul[s][1][1] = AC_QLOOKUP[clampi(q + h.dq[2], 0, 255)];
      int l = h.level;
      if (lon) l = clampi(seg.abs ? seg.val[s][1] : l + seg.val[s][1], 0, 63);
      int scale = 1 << (h.level >> 5);
      if (!h.lf_delta) {
        for (int ref = 0; ref < 4; ++ref) lvl[s][ref][0] = lvl[s][ref][1] = l;
      } else {
        lvl[s][0][0] = lvl[s][0][1] = clampi(l + lf_ref[0] * scale, 0, 63);
        for (int ref = 1; ref < 4; ++ref)
          for (int m = 0; m < 2; ++m) lvl[s][ref][m] = clampi(l + (lf_ref[ref] + lf_mode[m]) * scale, 0, 63);
      }
    }
    cur = std::make_shared<Frame>();
    int H = sb_rows * 64, W = sb_cols * 64;
    for (int p = 0; p < 3; ++p) {
      cur->stride[p] = p ? W / 2 : W;
      cur->rows[p] = p ? H / 2 : H;
      cur->plane[p].assign(static_cast<size_t>(cur->stride[p]) * cur->rows[p], 0);
    }
    cur->width = w, cur->height = hh, cur->full_range = cur_range;
    blocks.clear();
    blocks.reserve(static_cast<size_t>(mi_rows) * mi_cols);
    grid.assign(static_cast<size_t>(mi_rows) * mi_cols, -1);
    std::memset(&counts, 0, sizeof(counts));
    above_nz[0].assign(sb_cols * 16, 0);
    above_nz[1].assign(sb_cols * 8, 0);
    above_nz[2].assign(sb_cols * 8, 0);
    above_part.assign(sb_cols * 8, 0);
    above_segpred.assign(sb_cols * 8, 0);
    sb_blocks.assign(static_cast<size_t>(sb_rows) * sb_cols, {});
    for (int i = 0; i < 4; ++i) ref_frames[i] = nullptr;
    if (!intra)
      for (int i = 0; i < 3; ++i) ref_frames[1 + i] = refs[h.ref_idx[i]].get();
    int tile_cols = 1 << h.log2_cols, tile_rows = 1 << h.log2_rows;
    std::vector<Reader> readers = tile_readers(data, pos + header_size, tile_rows, tile_cols);
    for (int tr = 0; tr < tile_rows; ++tr) {
      int r0 = tile_offset(tr, mi_rows, h.log2_rows), r1 = tile_offset(tr + 1, mi_rows, h.log2_rows);
      for (int tc = 0; tc < tile_cols; ++tc) {
        tile_c0 = tile_offset(tc, mi_cols, h.log2_cols), tile_c1 = tile_offset(tc + 1, mi_cols, h.log2_cols);
        Reader& tbr = readers[tr * tile_cols + tc];
        for (int mi_row = r0; mi_row < r1; mi_row += 8) {
          std::memset(left_nz, 0, sizeof(left_nz));
          std::memset(left_part, 0, sizeof(left_part));
          std::memset(left_segpred, 0, sizeof(left_segpred));
          for (int mi_col = tile_c0; mi_col < tile_c1; mi_col += 8) {
            if (rac_is_end(tbr)) fail("a tile's data ends before its last superblock");
            partition(tbr, mi_row, mi_col, BLOCK_64X64);
          }
        }
      }
    }
    if (h.level) loop_filter();
    int fid = h.ctx_idx;
    if (h.refresh_ctx && h.parallel) {
      Probs& saved = ctx[fid];
      uint8_t keep[4][2][2][6][6][3];
      std::memcpy(keep, saved.coef, sizeof(keep));
      saved = fc;
      for (int t = TX_MODE_TO_BIGGEST[h.tx_mode] + 1; t < 4; ++t)
        std::memcpy(saved.coef[t], keep[t], sizeof(keep[t]));
    } else if (h.refresh_ctx) {
      adapt();
    }
    for (int i = 0; i < 8; ++i)
      if (h.refresh & (1 << i)) refs[i] = cur;
    has_last = true, last_w = w, last_h = hh;
    last_shown = h.show;
    last_key = h.key;
    last_mvs.assign(grid.size(), MvPair());
    for (size_t i = 0; i < grid.size(); ++i) {
      const Block& b = blocks[grid[i]];
      if (b.inter) last_mvs[i] = MvPair{b.ref[0], b.ref[1], b.mv[0][3], b.mv[1][3]};
    }
    last_segmap = segmap;
    prev_update_map = seg.enabled && seg.update_map;
    if (!h.show) return false;
    show(cur);
    return true;
  }

  // -- partitions and blocks --------------------------------------------------------

  void partition(Reader& br, int r, int c, int bsize) {
    if (r >= mi_rows || c >= mi_cols) return;
    int n8 = bw8(bsize), hbs = n8 >> 1, bsl = MI_WIDTH_LOG2[bsize];
    int ctxv = ((above_part[c] >> bsl) & 1) + 2 * ((left_part[r & 7] >> bsl) & 1) + bsl * 4;
    const uint8_t* probs = h.intra ? KF_PARTITION_PROBS[ctxv] : fc.partition[ctxv];
    bool has_rows = r + hbs < mi_rows, has_cols = c + hbs < mi_cols;
    int p;
    if (has_rows && has_cols)
      p = read_tree(br, PARTITION_TREE, probs);
    else if (has_cols)
      p = br.bit(probs[1]) ? PARTITION_SPLIT : PARTITION_HORZ;
    else if (has_rows)
      p = br.bit(probs[2]) ? PARTITION_SPLIT : PARTITION_VERT;
    else
      p = PARTITION_SPLIT;
    counts.partition[ctxv][p] += 1;
    int sub = SUBSIZE[p][bsize];
    if (sub < BLOCK_8X8 || p == PARTITION_NONE) {
      block(br, r, c, sub);
    } else if (p == PARTITION_HORZ) {
      block(br, r, c, sub);
      if (has_rows) block(br, r + hbs, c, sub);
    } else if (p == PARTITION_VERT) {
      block(br, r, c, sub);
      if (has_cols) block(br, r, c + hbs, sub);
    } else {
      partition(br, r, c, sub);
      partition(br, r, c + hbs, sub);
      partition(br, r + hbs, c, sub);
      partition(br, r + hbs, c + hbs, sub);
    }
    if (bsize == BLOCK_8X8 || p != PARTITION_SPLIT) {
      for (int i = 0; i < n8; ++i) {
        above_part[c + i] = PARTITION_CONTEXT[sub][0];
        left_part[(r & 7) + i] = PARTITION_CONTEXT[sub][1];
      }
    }
  }

  const Block* at(int r, int c) const { return &blocks[grid[static_cast<size_t>(r) * mi_cols + c]]; }

  void block(Reader& br, int r, int c, int bsize) {
    blocks.emplace_back();
    int bi = static_cast<int>(blocks.size()) - 1;
    Block& b = blocks[bi];
    b.size = bsize;
    const Block* above = r > 0 ? at(r - 1, c) : nullptr;
    const Block* left = c > tile_c0 ? at(r, c - 1) : nullptr;
    int x_mis = std::min(bw8(bsize), mi_cols - c), y_mis = std::min(BH8[bsize], mi_rows - r);
    if (h.intra)
      intra_frame_mode_info(br, b, above, left);
    else
      inter_frame_mode_info(br, b, r, c, above, left, x_mis, y_mis);
    for (int y = 0; y < y_mis; ++y)
      for (int x = 0; x < x_mis; ++x) grid[static_cast<size_t>(r + y) * mi_cols + c + x] = bi;
    if (write_segmap)
      for (int y = 0; y < y_mis; ++y)
        for (int x = 0; x < x_mis; ++x) (*segmap)[static_cast<size_t>(r + y) * mi_cols + c + x] = b.seg;
    int eobs = reconstruct(br, b, r, c);
    if (b.inter && bsize >= BLOCK_8X8 && eobs == 0) b.skip = 1;
    sb_blocks[(r >> 3) * sb_cols + (c >> 3)].push_back({r, c, bi});
  }

  // -- mode info ----------------------------------------------------------------------

  bool feature(int s, int j) const { return seg.enabled && seg.on[s][j]; }

  void read_skip(Reader& br, Block& b, const Block* above, const Block* left) {
    if (feature(b.seg, SEG_LVL_SKIP)) {
      b.skip = 1;
      return;
    }
    int ctxv = (above ? above->skip : 0) + (left ? left->skip : 0);
    b.skip = br.bit(fc.skip[ctxv]);
    counts.skip[ctxv][b.skip] += 1;
  }

  void read_tx(Reader& br, Block& b, const Block* above, const Block* left, bool allow_select) {
    int max_tx = MAX_TXSIZE[b.size];
    if (allow_select && h.tx_mode == TX_MODE_SELECT && b.size >= BLOCK_8X8) {
      int a_ctx = above && !above->skip ? above->tx : max_tx;
      int l_ctx = left && !left->skip ? left->tx : max_tx;
      if (!left) l_ctx = a_ctx;
      if (!above) a_ctx = l_ctx;
      int ctxv = a_ctx + l_ctx > max_tx;
      const uint8_t* probs = max_tx == 1 ? fc.tx8[ctxv] : max_tx == 2 ? fc.tx16[ctxv] : fc.tx32[ctxv];
      int tx = br.bit(probs[0]);
      if (tx && max_tx >= TX_16X16) {
        tx += br.bit(probs[1]);
        if (tx != TX_8X8 && max_tx >= TX_32X32) tx += br.bit(probs[2]);
      }
      if (max_tx == 1) counts.tx8[ctxv][tx] += 1;
      if (max_tx == 2) counts.tx16[ctxv][tx] += 1;
      if (max_tx == 3) counts.tx32[ctxv][tx] += 1;
      b.tx = tx;
    } else {
      b.tx = std::min(max_tx, TX_MODE_TO_BIGGEST[h.tx_mode]);
    }
  }

  void intra_frame_mode_info(Reader& br, Block& b, const Block* above, const Block* left) {
    if (seg.enabled && seg.update_map) b.seg = read_tree(br, SEGMENT_TREE, seg.tree);
    read_skip(br, b, above, left);
    read_tx(br, b, above, left, true);
    b.ref[0] = 0, b.ref[1] = -1;
    auto above_mode = [&](int i) {
      if (i >= 2) return b.sub_modes[i - 2];
      if (!above || above->inter) return static_cast<int>(DC_PRED);
      return above->size < BLOCK_8X8 ? above->sub_modes[i + 2] : above->mode;
    };
    auto left_mode = [&](int i) {
      if (i & 1) return b.sub_modes[i - 1];
      if (!left || left->inter) return static_cast<int>(DC_PRED);
      return left->size < BLOCK_8X8 ? left->sub_modes[i + 1] : left->mode;
    };
    auto read = [&](int i) { return read_tree(br, INTRA_MODE_TREE, KF_Y_MODE_PROB[above_mode(i)][left_mode(i)]); };
    int bs = b.size;
    if (bs == BLOCK_4X4) {
      for (int i = 0; i < 4; ++i) b.sub_modes[i] = read(i);
      b.mode = b.sub_modes[3];
    } else if (bs == BLOCK_4X8) {
      b.sub_modes[0] = b.sub_modes[2] = read(0);
      b.sub_modes[1] = b.sub_modes[3] = b.mode = read(1);
    } else if (bs == BLOCK_8X4) {
      b.sub_modes[0] = b.sub_modes[1] = read(0);
      b.sub_modes[2] = b.sub_modes[3] = b.mode = read(2);
    } else {
      b.mode = read(0);
      for (int i = 0; i < 4; ++i) b.sub_modes[i] = b.mode;
    }
    b.uv_mode = read_tree(br, INTRA_MODE_TREE, KF_UV_MODE_PROB[b.mode]);
  }

  void inter_segment_id(Reader& br, Block& b, int r, int c, int x_mis, int y_mis) {
    if (!seg.enabled) return;
    int pred = 0;
    if (segref && !h.error_res) {
      pred = 8;
      for (int y = 0; y < y_mis; ++y)
        for (int x = 0; x < x_mis; ++x) pred = std::min<int>(pred, (*segref)[static_cast<size_t>(r + y) * mi_cols + c + x]);
    }
    if (!seg.update_map) {
      b.seg = pred;
      return;
    }
    if (seg.temporal) {
      int ctxv = above_segpred[c] + left_segpred[r & 7];
      int flag = br.bit(seg.pred[ctxv]);
      b.seg = flag ? pred : read_tree(br, SEGMENT_TREE, seg.tree);
      for (int x = 0; x < bw8(b.size); ++x) above_segpred[c + x] = flag;
      for (int y = 0; y < BH8[b.size]; ++y) left_segpred[(r & 7) + y] = flag;
    } else {
      b.seg = read_tree(br, SEGMENT_TREE, seg.tree);
    }
  }

  void inter_frame_mode_info(Reader& br, Block& b, int r, int c, const Block* above, const Block* left,
                             int x_mis, int y_mis) {
    inter_segment_id(br, b, r, c, x_mis, y_mis);
    read_skip(br, b, above, left);
    bool ref_feat = feature(b.seg, SEG_LVL_REF_FRAME);
    int inter;
    if (ref_feat) {
      inter = seg.val[b.seg][SEG_LVL_REF_FRAME] != 0;
    } else {
      int ctxv;
      if (above && left) {
        bool ai = !above->inter, li = !left->inter;
        ctxv = ai && li ? 3 : (ai || li);
      } else if (above || left) {
        ctxv = 2 * !(above ? above : left)->inter;
      } else {
        ctxv = 0;
      }
      inter = br.bit(fc.intra_inter[ctxv]);
      counts.intra_inter[ctxv][inter] += 1;
    }
    b.inter = inter;
    read_tx(br, b, above, left, !b.skip || !inter);
    if (!inter) {
      intra_block_modes(br, b);
      return;
    }
    read_refs(br, b, above, left, ref_feat);
    inter_block_modes(br, b, r, c, above, left);
  }

  void intra_block_modes(Reader& br, Block& b) {
    auto read = [&](int group) {
      int m = read_tree(br, INTRA_MODE_TREE, fc.y_mode[group]);
      counts.y_mode[group][m] += 1;
      return m;
    };
    int bs = b.size;
    if (bs == BLOCK_4X4) {
      for (int i = 0; i < 4; ++i) b.sub_modes[i] = read(0);
      b.mode = b.sub_modes[3];
    } else if (bs == BLOCK_4X8) {
      b.sub_modes[0] = b.sub_modes[2] = read(0);
      b.sub_modes[1] = b.sub_modes[3] = b.mode = read(0);
    } else if (bs == BLOCK_8X4) {
      b.sub_modes[0] = b.sub_modes[1] = read(0);
      b.sub_modes[2] = b.sub_modes[3] = b.mode = read(0);
    } else {
      b.mode = read(SIZE_GROUP[bs]);
      for (int i = 0; i < 4; ++i) b.sub_modes[i] = b.mode;
    }
    b.uv_mode = read_tree(br, INTRA_MODE_TREE, fc.uv_mode[b.mode]);
    counts.uv_mode[b.mode][b.uv_mode] += 1;
    b.filt = 3;
    b.ref[0] = 0, b.ref[1] = -1;
  }

  void read_refs(Reader& br, Block& b, const Block* above, const Block* left, bool ref_feat) {
    if (ref_feat) {
      b.ref[0] = seg.val[b.seg][SEG_LVL_REF_FRAME], b.ref[1] = -1;
      return;
    }
    int mode = h.ref_mode;
    if (mode == REFERENCE_MODE_SELECT) {
      int ctxv = comp_inter_ctx(above, left);
      mode = br.bit(fc.comp_inter[ctxv]);
      counts.comp_inter[ctxv][mode] += 1;
    }
    if (mode == COMPOUND_REFERENCE) {
      int idx = h.sign_bias[h.fix_ref];
      int ctxv = comp_ref_ctx(above, left);
      int bit = br.bit(fc.comp_ref[ctxv]);
      counts.comp_ref[ctxv][bit] += 1;
      b.ref[idx] = h.fix_ref;
      b.ref[1 - idx] = h.var_ref[bit];
    } else {
      int ctxv = single_ref_p1(above, left);
      int bit = br.bit(fc.single_ref[ctxv][0]);
      counts.single_ref[ctxv][0][bit] += 1;
      if (bit) {
        ctxv = single_ref_p2(above, left);
        bit = br.bit(fc.single_ref[ctxv][1]);
        counts.single_ref[ctxv][1][bit] += 1;
        b.ref[0] = bit ? 3 : 2;
      } else {
        b.ref[0] = 1;
      }
      b.ref[1] = -1;
    }
  }

  int comp_inter_ctx(const Block* above, const Block* left) const {
    int fix = h.fix_ref;
    if (above && left) {
      bool a2 = above->ref[1] > 0, l2 = left->ref[1] > 0;
      if (!a2 && !l2) return (above->ref[0] == fix) ^ (left->ref[0] == fix);
      if (!a2) return 2 + (above->ref[0] == fix || !above->inter);
      if (!l2) return 2 + (left->ref[0] == fix || !left->inter);
      return 4;
    }
    if (above || left) {
      const Block* e = above ? above : left;
      return e->ref[1] <= 0 ? (e->ref[0] == fix) : 3;
    }
    return 1;
  }

  int comp_ref_ctx(const Block* above, const Block* left) const {
    int fix_idx = h.sign_bias[h.fix_ref], var_idx = 1 - fix_idx;
    int var0 = h.var_ref[0], var1 = h.var_ref[1];
    if (above && left) {
      bool ai = !above->inter, li = !left->inter;
      if (ai && li) return 2;
      if (ai || li) {
        const Block* e = ai ? left : above;
        if (e->ref[1] <= 0) return 1 + 2 * (e->ref[0] != var1);
        return 1 + 2 * (e->ref[var_idx] != var1);
      }
      bool l_sg = left->ref[1] <= 0, a_sg = above->ref[1] <= 0;
      int vrfa = a_sg ? above->ref[0] : above->ref[var_idx];
      int vrfl = l_sg ? left->ref[0] : left->ref[var_idx];
      if (vrfa == vrfl && var1 == vrfa) return 0;
      if (l_sg && a_sg) {
        if ((vrfa == h.fix_ref && vrfl == var0) || (vrfl == h.fix_ref && vrfa == var0)) return 4;
        return vrfa == vrfl ? 3 : 1;
      }
      if (l_sg || a_sg) {
        int vrfc = l_sg ? vrfa : vrfl, rfs = a_sg ? vrfa : vrfl;
        if (vrfc == var1 && rfs != var1) return 1;
        if (rfs == var1 && vrfc != var1) return 2;
        return 4;
      }
      return vrfa == vrfl ? 4 : 2;
    }
    if (above || left) {
      const Block* e = above ? above : left;
      if (!e->inter) return 2;
      if (e->ref[1] > 0) return 4 * (e->ref[var_idx] != var1);
      return 3 * (e->ref[0] != var1);
    }
    return 2;
  }

  static int single_ref_p1(const Block* above, const Block* left) {
    const int L = 1;
    if (above && left) {
      bool ai = !above->inter, li = !left->inter;
      if (ai && li) return 2;
      if (ai || li) {
        const Block* e = ai ? left : above;
        if (e->ref[1] <= 0) return 4 * (e->ref[0] == L);
        return 1 + (e->ref[0] == L || e->ref[1] == L);
      }
      bool a2 = above->ref[1] > 0, l2 = left->ref[1] > 0;
      int a0 = above->ref[0], a1 = above->ref[1], l0 = left->ref[0], l1 = left->ref[1];
      if (a2 && l2) return 1 + (a0 == L || a1 == L || l0 == L || l1 == L);
      if (a2 || l2) {
        int rfs = !a2 ? a0 : l0, crf1 = a2 ? a0 : l0, crf2 = a2 ? a1 : l1;
        if (rfs == L) return 3 + (crf1 == L || crf2 == L);
        return crf1 == L || crf2 == L;
      }
      return 2 * (a0 == L) + 2 * (l0 == L);
    }
    if (above || left) {
      const Block* e = above ? above : left;
      if (!e->inter) return 2;
      if (e->ref[1] <= 0) return 4 * (e->ref[0] == L);
      return 1 + (e->ref[0] == L || e->ref[1] == L);
    }
    return 2;
  }

  static int single_ref_p2(const Block* above, const Block* left) {
    const int L = 1, G = 2, A = 3;
    if (above && left) {
      bool ai = !above->inter, li = !left->inter;
      if (ai && li) return 2;
      if (ai || li) {
        const Block* e = ai ? left : above;
        if (e->ref[1] <= 0) {
          if (e->ref[0] == L) return 3;
          return 4 * (e->ref[0] == G);
        }
        return 1 + 2 * (e->ref[0] == G || e->ref[1] == G);
      }
      bool a2 = above->ref[1] > 0, l2 = left->ref[1] > 0;
      int a0 = above->ref[0], a1 = above->ref[1], l0 = left->ref[0], l1 = left->ref[1];
      if (a2 && l2) {
        if (a0 == l0 && a1 == l1) return 3 * (a0 == G || a1 == G || l0 == G || l1 == G);
        return 2;
      }
      if (a2 || l2) {
        int rfs = !a2 ? a0 : l0, crf1 = a2 ? a0 : l0, crf2 = a2 ? a1 : l1;
        if (rfs == G) return 3 + (crf1 == G || crf2 == G);
        if (rfs == A) return crf1 == G || crf2 == G;
        return 1 + 2 * (crf1 == G || crf2 == G);
      }
      if (a0 == L && l0 == L) return 3;
      if (a0 == L || l0 == L) {
        int edge0 = a0 == L ? l0 : a0;
        return 4 * (edge0 == G);
      }
      return 2 * (a0 == G) + 2 * (l0 == G);
    }
    if (above || left) {
      const Block* e = above ? above : left;
      if (!e->inter || (e->ref[0] == L && e->ref[1] <= 0)) return 2;
      if (e->ref[1] <= 0) return 4 * (e->ref[0] == G);
      return 3 * (e->ref[0] == G || e->ref[1] == G);
    }
    return 2;
  }

  // -- motion vectors -------------------------------------------------------------------

  bool inside(int r, int c) const { return r >= 0 && r < mi_rows && c >= tile_c0 && c < tile_c1; }

  int mode_context(const Block& b, int r, int c) const {
    int counter = 0;
    for (int i = 0; i < 2; ++i) {
      int dr = MV_REF_BLOCKS[b.size][i][0], dc = MV_REF_BLOCKS[b.size][i][1];
      if (inside(r + dr, c + dc)) counter += MODE_2_COUNTER[at(r + dr, c + dc)->mode];
    }
    return COUNTER_TO_CONTEXT[counter];
  }

  // vp9.Vp9Decoder._find_mv_refs
  void find_mv_refs(const Block& b, int r, int c, int ref, int blk, Mv out[2]) const {
    Mv found[2];
    int nfound = 0;
    auto add = [&](Mv mv) {
      if (!nfound) {
        found[nfound++] = mv;
        return false;
      }
      if (mv != found[0]) {
        found[nfound++] = mv;
        return true;
      }
      return false;
    };
    auto scaled = [&](int cand_ref, Mv mv) {
      if (h.sign_bias[cand_ref] != h.sign_bias[ref]) mv.r = -mv.r, mv.c = -mv.c;
      return mv;
    };
    const int32_t(*search)[2] = MV_REF_BLOCKS[b.size];
    const MvPair* prev = h.use_prev ? &last_mvs[static_cast<size_t>(r) * mi_cols + c] : nullptr;
    bool different = false, done = false;
    for (int i = 0; i < 8 && !done; ++i) {
      int dr = search[i][0], dc = search[i][1];
      if (!inside(r + dr, c + dc)) continue;
      const Block* cand = at(r + dr, c + dc);
      different = true;
      for (int j = 0; j < 2; ++j)
        if (cand->ref[j] == ref) {
          Mv mv = (i < 2 && blk >= 0 && cand->size < BLOCK_8X8)
                      ? cand->mv[j][IDX_N_COLUMN_TO_SUBBLOCK[blk][dc == 0]]
                      : cand->mv[j][3];
          done = add(mv);
          break;
        }
    }
    if (!done && prev) {
      if (prev->ref0 == ref)
        done = add(prev->mv0);
      else if (prev->ref1 == ref)
        done = add(prev->mv1);
    }
    if (!done && different) {
      for (int i = 0; i < 8 && !done; ++i) {
        int dr = search[i][0], dc = search[i][1];
        if (!inside(r + dr, c + dc)) continue;
        const Block* cand = at(r + dr, c + dc);
        if (!cand->inter) continue;
        if (cand->ref[0] != ref) {
          done = add(scaled(cand->ref[0], cand->mv[0][3]));
          if (done) break;
        }
        if (cand->ref[1] > 0 && cand->ref[1] != ref && cand->mv[1][3] != cand->mv[0][3])
          done = add(scaled(cand->ref[1], cand->mv[1][3]));
      }
    }
    if (!done && prev) {
      if (prev->ref0 != ref && prev->ref0 > 0) done = add(scaled(prev->ref0, prev->mv0));
      if (!done && prev->ref1 > 0 && prev->ref1 != ref && prev->mv1 != prev->mv0)
        done = add(scaled(prev->ref1, prev->mv1));
    }
    int bw = bw8(b.size), bh = BH8[b.size];
    int lo_c = -(c * 64) - MV_BORDER, hi_c = (mi_cols - bw - c) * 64 + MV_BORDER;
    int lo_r = -(r * 64) - MV_BORDER, hi_r = (mi_rows - bh - r) * 64 + MV_BORDER;
    for (int i = 0; i < 2; ++i) {
      Mv mv = i < nfound ? found[i] : Mv();
      out[i] = Mv{clampi(mv.r, lo_r, hi_r), clampi(mv.c, lo_c, hi_c)};
    }
  }

  Mv lower(Mv mv) const {
    if (h.hp && (std::abs(mv.r) >> 3) < 8 && (std::abs(mv.c) >> 3) < 8) return mv;
    if (mv.r & 1) mv.r += mv.r > 0 ? -1 : 1;
    if (mv.c & 1) mv.c += mv.c > 0 ? -1 : 1;
    return mv;
  }

  int read_mv_component(Reader& br, int comp, bool usehp) {
    const MvComp& p = fc.mv_comp[comp];
    MvCounts& cnt = counts.mv_comp[comp];
    int sign = br.bit(p.sign);
    cnt.sign[sign] += 1;
    int cls = read_tree(br, MV_CLASS_TREE, p.classes);
    cnt.classes[cls] += 1;
    int d = 0, fr, hp, mag;
    if (cls == 0) {
      d = br.bit(p.class0[0]);
      cnt.class0[d] += 1;
      fr = read_tree(br, MV_FP_TREE, p.class0_fp[d]);
      cnt.class0_fp[d][fr] += 1;
      if (usehp) {
        hp = br.bit(p.class0_hp);
        cnt.class0_hp[hp] += 1;
      } else {
        hp = 1;
        cnt.class0_hp[1] += 1;
      }
      mag = 0;
    } else {
      for (int i = 0; i < cls; ++i) {
        int bit = br.bit(p.bits[i]);
        cnt.bits[i][bit] += 1;
        d |= bit << i;
      }
      fr = read_tree(br, MV_FP_TREE, p.fp);
      cnt.fp[fr] += 1;
      if (usehp) {
        hp = br.bit(p.hp);
        cnt.hp[hp] += 1;
      } else {
        hp = 1;
        cnt.hp[1] += 1;
      }
      mag = 2 << (cls + 2);
    }
    mag += ((d << 3) | (fr << 1) | hp) + 1;
    return sign ? -mag : mag;
  }

  Mv read_mv(Reader& br, Mv best) {
    bool usehp = h.hp && (std::abs(best.r) >> 3) < 8 && (std::abs(best.c) >> 3) < 8;
    int j = read_tree(br, MV_JOINT_TREE, fc.mv_joint);
    counts.mv_joint[j] += 1;
    int dr = (j == 2 || j == 3) ? read_mv_component(br, 0, usehp) : 0;
    int dc = (j == 1 || j == 3) ? read_mv_component(br, 1, usehp) : 0;
    return Mv{best.r + dr, best.c + dc};
  }

  int read_inter_mode(Reader& br, int ctxv) {
    int m = read_tree(br, INTER_MODE_TREE, fc.inter_mode[ctxv]);
    counts.inter_mode[ctxv][m] += 1;
    return NEARESTMV + m;
  }

  void inter_block_modes(Reader& br, Block& b, int r, int c, const Block* above, const Block* left) {
    int nrefs = b.ref[1] > 0 ? 2 : 1;
    int ctxv = mode_context(b, r, c);
    if (b.size >= BLOCK_8X8) b.mode = feature(b.seg, SEG_LVL_SKIP) ? ZEROMV : read_inter_mode(br, ctxv);
    if (h.filter == SWITCHABLE) {
      int lt = left ? left->filt : 3, at_ = above ? above->filt : 3;
      int fctx = lt == at_ ? lt : lt == 3 ? at_ : at_ == 3 ? lt : 3;
      b.filt = read_tree(br, SWITCHABLE_INTERP_TREE, fc.interp[fctx]);
      counts.interp[fctx][b.filt] += 1;
    } else {
      b.filt = h.filter;
    }
    if (b.size >= BLOCK_8X8) {
      for (int i = 0; i < nrefs; ++i) {
        Mv mv;
        if (b.mode != ZEROMV) {
          Mv cands[2];
          find_mv_refs(b, r, c, b.ref[i], -1, cands);
          cands[0] = lower(cands[0]), cands[1] = lower(cands[1]);
          mv = b.mode == NEWMV ? read_mv(br, cands[0]) : b.mode == NEARESTMV ? cands[0] : cands[1];
        }
        for (int k = 0; k < 4; ++k) b.mv[i][k] = mv;
      }
      return;
    }
    int nw = (b.size == BLOCK_4X4 || b.size == BLOCK_4X8) ? 1 : 2;
    int nh = (b.size == BLOCK_4X4 || b.size == BLOCK_8X4) ? 1 : 2;
    bool have_new = false;
    Mv best_new[2];
    Mv sub[2][4];
    for (int idy = 0; idy < 2; idy += nh)
      for (int idx = 0; idx < 2; idx += nw) {
        int k = idy * 2 + idx;
        int bmode = read_inter_mode(br, ctxv);
        for (int i = 0; i < nrefs; ++i) {
          Mv mv;
          if (bmode == NEARESTMV || bmode == NEARMV) {
            Mv list[2], nearest, nearv;
            find_mv_refs(b, r, c, b.ref[i], k, list);
            sub8x8_mvs(sub[i], list, k, nearest, nearv);
            mv = bmode == NEARESTMV ? nearest : nearv;
          } else if (bmode == NEWMV) {
            if (!have_new) {
              for (int j = 0; j < nrefs; ++j) {
                Mv cands[2];
                find_mv_refs(b, r, c, b.ref[j], -1, cands);
                best_new[j] = lower(cands[0]);
              }
              have_new = true;
            }
            mv = read_mv(br, best_new[i]);
          }
          sub[i][k] = mv;
          if (nh == 2) sub[i][k + 2] = mv;
          if (nw == 2) sub[i][k + 1] = mv;
        }
        b.mode = bmode;
      }
    for (int i = 0; i < 2; ++i)
      for (int k = 0; k < 4; ++k) b.mv[i][k] = sub[i][k];
  }

  static void sub8x8_mvs(const Mv* bmi, const Mv* list, int k, Mv& nearest, Mv& nearv) {
    if (k == 0) {
      nearest = list[0], nearv = list[1];
      return;
    }
    Mv cands[4];
    int n;
    if (k == 1 || k == 2) {
      nearest = bmi[0];
      cands[0] = list[0], cands[1] = list[1], n = 2;
    } else {
      nearest = bmi[2];
      cands[0] = bmi[1], cands[1] = bmi[0], cands[2] = list[0], cands[3] = list[1], n = 4;
    }
    nearv = Mv();
    for (int i = 0; i < n; ++i)
      if (cands[i] != nearest) {
        nearv = cands[i];
        return;
      }
  }

  // -- tokens and reconstruction ----------------------------------------------------

  int tokens(Reader& br, int tx, int ptype, int ref, int ctxv, const int16_t* scan, const int16_t* nb,
             const int dq[2], long long* out) {
    uint8_t(*probs)[6][3] = fc.coef[tx][ptype][ref];
    unsigned(*cnt)[6][4] = counts.coef[tx][ptype][ref];
    unsigned(*eobc)[6] = counts.eob[tx][ptype][ref];
    const uint8_t* band = tx == TX_4X4 ? COEFBAND_TRANS_4X4 : COEFBAND_TRANS_8X8PLUS;
    int max_eob = 16 << (tx << 1);
    static thread_local std::vector<uint8_t> cache;
    cache.assign(1024, 0);
    int shift = tx == TX_32X32 ? 1 : 0;
    int dqv = dq[0];
    int i = 0;
    while (i < max_eob) {
      int bd = band[i];
      const uint8_t* p = probs[bd][ctxv];
      eobc[bd][ctxv] += 1;
      if (!br.bit(p[0])) {
        cnt[bd][ctxv][3] += 1;
        break;
      }
      while (!br.bit(p[1])) {
        cnt[bd][ctxv][0] += 1;
        dqv = dq[1];
        cache[scan[i]] = 0;
        ++i;
        if (i >= max_eob) return i;
        ctxv = (1 + cache[nb[2 * i]] + cache[nb[2 * i + 1]]) >> 1;
        bd = band[i];
        p = probs[bd][ctxv];
      }
      int token, val;
      if (!br.bit(p[2])) {
        cnt[bd][ctxv][1] += 1;
        token = 1, val = 1;
      } else {
        cnt[bd][ctxv][2] += 1;
        token = read_tree(br, COEF_CON_TREE, PARETO8_FULL[p[2] - 1]);
        if (token <= 4) {
          val = token;
        } else {
          val = 0;
          for (int q = 0; q < CAT_BITS[token - 5]; ++q) val = (val << 1) | br.bit(CAT_PROBS[token - 5][q]);
          val += CAT_BASE[token - 5];
        }
      }
      long long v = (static_cast<long long>(val) * dqv) >> shift;
      if (br.bit(128)) v = -v;
      out[scan[i]] = ((v + 32768) & 0xFFFF) - 32768;
      cache[scan[i]] = static_cast<uint8_t>(ENERGY[token]);
      ++i;
      if (i < max_eob) ctxv = (1 + cache[nb[2 * i]] + cache[nb[2 * i + 1]]) >> 1;
      dqv = dq[1];
    }
    return i;
  }

  static void scan_for(int tx, int tx_type, const int16_t*& scan, const int16_t*& nb) {
    if (tx == TX_32X32) {
      scan = DEFAULT_SCAN_32X32, nb = &DEFAULT_SCAN_32X32_NEIGHBORS[0][0];
      return;
    }
    static const int16_t* scans[3][3] = {{DEFAULT_SCAN_4X4, ROW_SCAN_4X4, COL_SCAN_4X4},
                                         {DEFAULT_SCAN_8X8, ROW_SCAN_8X8, COL_SCAN_8X8},
                                         {DEFAULT_SCAN_16X16, ROW_SCAN_16X16, COL_SCAN_16X16}};
    static const int16_t* nbs[3][3] = {
        {&DEFAULT_SCAN_4X4_NEIGHBORS[0][0], &ROW_SCAN_4X4_NEIGHBORS[0][0], &COL_SCAN_4X4_NEIGHBORS[0][0]},
        {&DEFAULT_SCAN_8X8_NEIGHBORS[0][0], &ROW_SCAN_8X8_NEIGHBORS[0][0], &COL_SCAN_8X8_NEIGHBORS[0][0]},
        {&DEFAULT_SCAN_16X16_NEIGHBORS[0][0], &ROW_SCAN_16X16_NEIGHBORS[0][0], &COL_SCAN_16X16_NEIGHBORS[0][0]}};
    int k = tx_type == 1 ? 1 : tx_type == 2 ? 2 : 0;
    scan = scans[tx][k], nb = nbs[tx][k];
  }

  // vp9.Vp9Decoder._intra_edges: returns the mode to run
  int intra_edges(int p, int px, int py, int tx, int x4, int y4, int w4, int r, int c, int mode, int* a,
                  int& al, int* lft) const {
    const uint8_t* buf = cur->plane[p].data();
    int stride = cur->stride[p], ss = p ? 1 : 0;
    bool have_top = r > 0 || y4 > 0, have_left = c > tile_c0 || x4 > 0, have_right = x4 < w4 - 1;
    int n = 4 << tx;
    if (mode == DC_PRED) mode = have_left ? (have_top ? DC_PRED : 10) : (have_top ? 11 : 12);
    bool needs_tr = mode == D45_PRED || mode == D63_PRED;
    for (int i = 0; i < 2 * n; ++i) a[i] = 127;
    if (have_top) {
      int have = ((mi_cols - c) << (1 - ss)) * 4 - x4 * 4;
      const uint8_t* row = buf + static_cast<size_t>(py - 1) * stride;
      int k = std::min(n, have);
      for (int i = 0; i < k; ++i) a[i] = row[px + i];
      for (int i = k; i < n; ++i) a[i] = a[k - 1];
      if (tx == TX_4X4 && needs_tr && have_right && n + 4 <= have) {
        for (int i = 4; i < 8; ++i) a[i] = row[px + i];
      } else {
        for (int i = n; i < 2 * n; ++i) a[i] = a[n - 1];
      }
    }
    if (have_top && have_left)
      al = buf[static_cast<size_t>(py - 1) * stride + px - 1];
    else
      al = have_top ? 129 : 127;
    if (have_left) {
      int have = ((mi_rows - r) << (1 - ss)) * 4 - y4 * 4;
      int k = std::min(n, have);
      for (int i = 0; i < k; ++i) lft[i] = buf[static_cast<size_t>(py + i) * stride + px - 1];
      for (int i = k; i < n; ++i) lft[i] = lft[k - 1];
    } else {
      for (int i = 0; i < n; ++i) lft[i] = 129;
    }
    return mode;
  }

  int reconstruct(Reader& br, Block& b, int r, int c) {
    int bsize = b.size;
    const int(*seg_q)[2] = qmul[seg.enabled ? b.seg : 0];
    int pbs = std::max(bsize, static_cast<int>(BLOCK_8X8));
    if (b.skip) {
      for (int p = 0; p < 3; ++p) {
        int ss = p ? 1 : 0, pb = SS_SIZE[pbs][ss][ss];
        int ax = (c * 2) >> ss, ay = ((r & 7) * 2) >> ss;
        for (int i = 0; i < bw4(pb); ++i) above_nz[p][ax + i] = 0;
        for (int i = 0; i < BH4[pb]; ++i) left_nz[p][ay + i] = 0;
      }
    }
    if (b.inter) inter_predict(b, r, c);
    int total = 0;
    int bw = bw8(bsize), bh = BH8[bsize];
    static thread_local std::vector<long long> coef(1024), res(1024);
    static thread_local std::vector<int> pred(1024);
    for (int p = 0; p < 3; ++p) {
      int ss = p ? 1 : 0;
      int tx = p == 0 ? b.tx : UV_TXSIZE[bsize][b.tx][1][1];
      int step = 1 << tx;
      int pb = SS_SIZE[pbs][ss][ss];
      int w4 = bw4(pb), h4 = BH4[pb];
      int right = (mi_cols - bw - c) * 64, bottom = (mi_rows - bh - r) * 64;
      int max_w = w4 + (right < 0 ? right >> (5 + ss) : 0);
      int max_h = h4 + (bottom < 0 ? bottom >> (5 + ss) : 0);
      int ax = (c * 2) >> ss, ay = ((r & 7) * 2) >> ss;
      int x0 = (c * 8) >> ss, y0 = (r * 8) >> ss;
      uint8_t* buf = cur->plane[p].data();
      int stride = cur->stride[p];
      std::vector<int>& anz = above_nz[p];
      int* lnz = left_nz[p];
      const int* dq = seg_q[p ? 1 : 0];
      int n = 4 << tx;
      for (int y4 = 0; y4 < max_h; y4 += step)
        for (int x4 = 0; x4 < max_w; x4 += step) {
          int px = x0 + 4 * x4, py = y0 + 4 * y4;
          int tx_type = 0;
          if (!b.inter) {
            int mode = p ? b.uv_mode : (bsize < BLOCK_8X8 ? b.sub_modes[y4 * 2 + x4] : b.mode);
            tx_type = (p || h.lossless || tx == TX_32X32) ? 0 : INTRA_MODE_TO_TX_TYPE[mode];
            int a[64], al, lft[32];
            int run = intra_edges(p, px, py, tx, x4, y4, w4, r, c, mode, a, al, lft);
            intra_pred(run, n, a, al, lft, pred.data());
            for (int yy = 0; yy < n; ++yy)
              for (int xx = 0; xx < n; ++xx)
                buf[static_cast<size_t>(py + yy) * stride + px + xx] = static_cast<uint8_t>(pred[yy * n + xx]);
          }
          if (b.skip) continue;
          int ctxv;
          if (tx == TX_4X4) {
            ctxv = (anz[ax + x4] != 0) + (lnz[ay + y4] != 0);
          } else {
            int ea = 0, el = 0;
            for (int i = 0; i < step; ++i) ea |= anz[ax + x4 + i], el |= lnz[ay + y4 + i];
            ctxv = (ea != 0) + (el != 0);
          }
          const int16_t *scan, *nb;
          scan_for(tx, tx_type, scan, nb);
          std::fill(coef.begin(), coef.begin() + n * n, 0);
          int eob = tokens(br, tx, p ? 1 : 0, b.inter, ctxv, scan, nb, dq, coef.data());
          total += eob;
          int nz = eob > 0;
          int ka = std::min(step, max_w - x4), kl = std::min(step, max_h - y4);
          for (int i = 0; i < step; ++i) anz[ax + x4 + i] = i < ka ? nz : 0;
          for (int i = 0; i < step; ++i) lnz[ay + y4 + i] = i < kl ? nz : 0;
          if (eob) {
            inverse_transform(coef.data(), n, tx_type, h.lossless, res.data());
            for (int yy = 0; yy < n; ++yy)
              for (int xx = 0; xx < n; ++xx) {
                uint8_t& px_ = buf[static_cast<size_t>(py + yy) * stride + px + xx];
                px_ = static_cast<uint8_t>(clampi(static_cast<int>(px_ + res[yy * n + xx]), 0, 255));
              }
          }
        }
    }
    return total;
  }

  void inter_predict(const Block& b, int r, int c) {
    int bsize = b.size;
    int nref = b.ref[1] > 0 ? 2 : 1;
    static thread_local std::vector<int> py[2], pu[2], pv[2];
    int bw = bsize >= BLOCK_8X8 ? bw8(bsize) * 8 : 8, bh = bsize >= BLOCK_8X8 ? BH8[bsize] * 8 : 8;
    int cbw = bsize >= BLOCK_8X8 ? bw >> 1 : 4, cbh = bsize >= BLOCK_8X8 ? bh >> 1 : 4;
    for (int i = 0; i < nref; ++i) {
      const Frame& ref = *ref_frames[b.ref[i]];
      const Mv* mvs = b.mv[i];
      int w = ref.width, hh = ref.height, cw = (w + 1) >> 1, ch = (hh + 1) >> 1;
      py[i].resize(bw * bh), pu[i].resize(cbw * cbh), pv[i].resize(cbw * cbh);
      Mv cmv;
      if (bsize >= BLOCK_8X8) {
        Mv mv = mvs[3];
        predict_block(ref.plane[0].data(), ref.stride[0], w, hh, c * 8, r * 8, bw, bh, mv.c, mv.r, true, b.filt,
                      py[i].data());
        cmv = mv;
      } else {
        int tmp[16];
        for (int k = 0; k < 4; ++k) {
          Mv mv = mvs[k];
          int bx = (k & 1) * 4, by = (k >> 1) * 4;
          predict_block(ref.plane[0].data(), ref.stride[0], w, hh, c * 8 + bx, r * 8 + by, 4, 4, mv.c, mv.r,
                        true, b.filt, tmp);
          for (int yy = 0; yy < 4; ++yy)
            for (int xx = 0; xx < 4; ++xx) py[i][(by + yy) * 8 + bx + xx] = tmp[yy * 4 + xx];
        }
        int s[2] = {0, 0};
        for (int k = 0; k < 4; ++k) s[0] += mvs[k].r, s[1] += mvs[k].c;
        int q[2];
        for (int j = 0; j < 2; ++j) q[j] = s[j] >= 0 ? (s[j] + 2) / 4 : -((-s[j] + 2) / 4);
        cmv = Mv{q[0], q[1]};
      }
      predict_block(ref.plane[1].data(), ref.stride[1], cw, ch, c * 4, r * 4, cbw, cbh, cmv.c, cmv.r, false,
                    b.filt, pu[i].data());
      predict_block(ref.plane[2].data(), ref.stride[2], cw, ch, c * 4, r * 4, cbw, cbh, cmv.c, cmv.r, false,
                    b.filt, pv[i].data());
    }
    auto store = [&](int p, std::vector<int>* src, int x0, int y0, int ww, int hh2) {
      uint8_t* buf = cur->plane[p].data();
      int stride = cur->stride[p];
      for (int yy = 0; yy < hh2; ++yy)
        for (int xx = 0; xx < ww; ++xx) {
          int v = src[0][yy * ww + xx];
          if (nref == 2) v = (v + src[1][yy * ww + xx] + 1) >> 1;
          buf[static_cast<size_t>(y0 + yy) * stride + x0 + xx] = static_cast<uint8_t>(v);
        }
    };
    store(0, py, c * 8, r * 8, bw, bh);
    store(1, pu, c * 4, r * 4, cbw, cbh);
    store(2, pv, c * 4, r * 4, cbw, cbh);
  }

  // -- the loop filter (vp9.Vp9Decoder._setup_mask, _filter_sb) ---------------------------

  struct Lfm {
    uint64_t left_y[4] = {0, 0, 0, 0}, above_y[4] = {0, 0, 0, 0}, int_y = 0;
    uint64_t left_uv[4] = {0, 0, 0, 0}, above_uv[4] = {0, 0, 0, 0}, int_uv = 0;
    int lfl[64] = {};
  };

  Lfm setup_mask(int mi_row, int mi_col) const {
    static const uint64_t ALL = ~0ULL;
    static const uint64_t ABOVE_Y[4] = {ALL, ALL, 0x00FF00FF00FF00FFULL, 0x000000FF000000FFULL};
    static const uint64_t LEFT_Y[4] = {ALL, ALL, 0x5555555555555555ULL, 0x1111111111111111ULL};
    static const uint64_t ABOVE_UV[4] = {0xFFFF, 0xFFFF, 0x0F0F, 0x000F};
    static const uint64_t LEFT_UV[4] = {0xFFFF, 0xFFFF, 0x5555, 0x1111};
    Lfm m;
    for (const SbEntry& e : sb_blocks[(mi_row >> 3) * sb_cols + (mi_col >> 3)]) {
      const Block& b = blocks[e.b];
      int s = seg.enabled ? b.seg : 0;
      int level = b.inter ? lvl[s][b.ref[0]][b.mode != ZEROMV] : lvl[s][0][0];
      if (!level) continue;
      int bw = bw8(b.size), bh = BH8[b.size];
      int shift_y = (e.r - mi_row) * 8 + (e.c - mi_col);
      for (int i = 0; i < bh; ++i)
        for (int j = 0; j < bw; ++j) m.lfl[shift_y + i * 8 + j] = level;
      int txy = b.tx, txuv = UV_TXSIZE[b.size][b.tx][1][1];
      uint64_t row_bits = (1ULL << bw) - 1, size_mask = 0, left_bits = 0;
      for (int i = 0; i < bh; ++i) size_mask |= row_bits << (8 * i), left_bits |= 1ULL << (8 * i);
      m.above_y[txy] |= row_bits << shift_y;
      m.left_y[txy] |= left_bits << shift_y;
      bool uv = !(e.r & 1) && !(e.c & 1);
      int shift_uv = 0;
      uint64_t size_uv = 0;
      if (uv) {
        shift_uv = ((e.r - mi_row) >> 1) * 4 + ((e.c - mi_col) >> 1);
        int w2 = std::max(1, bw >> 1), h2 = std::max(1, bh >> 1);
        uint64_t urow = (1ULL << w2) - 1, uleft = 0;
        for (int i = 0; i < h2; ++i) size_uv |= urow << (4 * i), uleft |= 1ULL << (4 * i);
        m.above_uv[txuv] |= urow << shift_uv;
        m.left_uv[txuv] |= uleft << shift_uv;
      }
      if (b.skip && b.inter) continue;
      m.above_y[txy] |= (size_mask & ABOVE_Y[txy]) << shift_y;
      m.left_y[txy] |= (size_mask & LEFT_Y[txy]) << shift_y;
      if (uv) {
        m.above_uv[txuv] |= (size_uv & ABOVE_UV[txuv]) << shift_uv;
        m.left_uv[txuv] |= (size_uv & LEFT_UV[txuv]) << shift_uv;
      }
      if (txy == TX_4X4) m.int_y |= size_mask << shift_y;
      if (uv && txuv == TX_4X4) m.int_uv |= size_uv << shift_uv;
    }
    for (uint64_t* a : {m.left_y, m.above_y, m.left_uv, m.above_uv}) a[TX_16X16] |= a[TX_32X32];
    m.left_y[TX_8X8] |= m.left_y[TX_4X4] & 0x1111111111111111ULL;
    m.left_y[TX_4X4] &= ~0x1111111111111111ULL;
    m.above_y[TX_8X8] |= m.above_y[TX_4X4] & 0x000000FF000000FFULL;
    m.above_y[TX_4X4] &= ~0x000000FF000000FFULL;
    m.left_uv[TX_8X8] |= m.left_uv[TX_4X4] & 0x1111;
    m.left_uv[TX_4X4] &= ~0x1111ULL & 0xFFFF;
    m.above_uv[TX_8X8] |= m.above_uv[TX_4X4] & 0x000F;
    m.above_uv[TX_4X4] &= ~0x000FULL & 0xFFFF;
    if (mi_row + 8 > mi_rows) {
      int rows = mi_rows - mi_row;
      uint64_t mask_y = rows >= 8 ? ~0ULL : (1ULL << (rows << 3)) - 1;
      uint64_t mask_uv = (1ULL << (((rows + 1) >> 1) << 2)) - 1;
      for (int i = 0; i < 3; ++i) {
        m.left_y[i] &= mask_y, m.above_y[i] &= mask_y;
        m.left_uv[i] &= mask_uv, m.above_uv[i] &= mask_uv;
      }
      m.int_y &= mask_y, m.int_uv &= mask_uv;
      if (rows == 1) {
        m.above_uv[TX_8X8] |= m.above_uv[TX_16X16];
        m.above_uv[TX_16X16] = 0;
      }
      if (rows == 5) {
        m.above_uv[TX_8X8] |= m.above_uv[TX_16X16] & 0xFF00;
        m.above_uv[TX_16X16] &= ~0xFF00ULL & 0xFFFF;
      }
    }
    if (mi_col + 8 > mi_cols) {
      int cols = mi_cols - mi_col;
      uint64_t mask_y = ((1ULL << cols) - 1) * 0x0101010101010101ULL;
      uint64_t mask_uv = ((1ULL << ((cols + 1) >> 1)) - 1) * 0x1111;
      uint64_t mask_uv_int = ((1ULL << (cols >> 1)) - 1) * 0x1111;
      for (int i = 0; i < 3; ++i) {
        m.left_y[i] &= mask_y, m.above_y[i] &= mask_y;
        m.left_uv[i] &= mask_uv, m.above_uv[i] &= mask_uv;
      }
      m.int_y &= mask_y, m.int_uv &= mask_uv_int;
      if (cols == 1) {
        m.left_uv[TX_8X8] |= m.left_uv[TX_16X16];
        m.left_uv[TX_16X16] = 0;
      }
      if (cols == 5) {
        m.left_uv[TX_8X8] |= m.left_uv[TX_16X16] & 0xCCCC;
        m.left_uv[TX_16X16] &= ~0xCCCCULL & 0xFFFF;
      }
    }
    if (mi_col == 0)
      for (int i = 0; i < 3; ++i) m.left_y[i] &= 0xFEFEFEFEFEFEFEFEULL, m.left_uv[i] &= 0xEEEE;
    return m;
  }

  void loop_filter() {
    int sharp = h.sharpness;
    int lims[64][3];
    for (int l = 0; l < 64; ++l) {
      int lim = l >> ((sharp > 0) + (sharp > 4));
      if (sharp > 0) lim = std::min(lim, 9 - sharp);
      lim = std::max(lim, 1);
      lims[l][0] = lim, lims[l][1] = 2 * (l + 2) + lim, lims[l][2] = l >> 4;
    }
    int sb_rows = (mi_rows + 7) >> 3;
    for (int sr = 0; sr < sb_rows; ++sr)
      for (int scol = 0; scol < sb_cols; ++scol) {
        int mi_row = sr * 8, mi_col = scol * 8;
        Lfm m = setup_mask(mi_row, mi_col);
        int rows = std::min(8, mi_rows - mi_row);
        for (int p = 0; p < 3; ++p) {
          int ss = p ? 1 : 0;
          uint8_t* buf = cur->plane[p].data();
          int stride = cur->stride[p];
          int x0 = (mi_col * 8) >> ss, y0 = (mi_row * 8) >> ss;
          int n = p ? 4 : 8, nrows = p ? (rows + 1) >> 1 : rows;
          const uint64_t* lm = p ? m.left_uv : m.left_y;
          const uint64_t* am = p ? m.above_uv : m.above_y;
          uint64_t im = p ? m.int_uv : m.int_y;
          auto level = [&](int R, int C) { return p ? m.lfl[(R * 2) * 8 + C * 2] : m.lfl[R * 8 + C]; };
          auto edge = [&](int x, int y, bool vertical, const int* lim, int wide) {
            for (int i = 0; i < 8; ++i) {
              uint8_t* s = vertical ? buf + static_cast<size_t>(y + i) * stride + x
                                    : buf + static_cast<size_t>(y) * stride + x + i;
              filter_line(s, vertical ? 1 : stride, lim[0], lim[1], lim[2], wide);
            }
          };
          for (int R = 0; R < nrows; ++R)
            for (int C = 0; C < n; ++C) {
              uint64_t bit = 1ULL << (R * n + C);
              int x = x0 + C * 8, y = y0 + R * 8;
              const int* lim = lims[level(R, C)];
              int wide = (lm[TX_16X16] & bit) ? 16 : (lm[TX_8X8] & bit) ? 8 : (lm[TX_4X4] & bit) ? 4 : 0;
              if (wide) edge(x, y, true, lim, wide);
              if (im & bit) edge(x + 4, y, true, lim, 4);
            }
          for (int R = 0; R < nrows; ++R) {
            int mrow = mi_row + (R << ss);
            bool skip_int = ss && mrow == mi_rows - 1;
            for (int C = 0; C < n; ++C) {
              uint64_t bit = 1ULL << (R * n + C);
              int x = x0 + C * 8, y = y0 + R * 8;
              const int* lim = lims[level(R, C)];
              int wide = 0;
              if (mrow) wide = (am[TX_16X16] & bit) ? 16 : (am[TX_8X8] & bit) ? 8 : (am[TX_4X4] & bit) ? 4 : 0;
              if (wide) edge(x, y, false, lim, wide);
              if ((im & bit) && !skip_int) edge(x, y + 4, false, lim, 4);
            }
          }
        }
      }
  }

  // -- backward adaptation (vp9.Vp9Decoder._adapt) ------------------------------------------

  void adapt() {
    Probs& pre = ctx[h.ctx_idx];
    unsigned uf = (h.intra || !h.last_key) ? 112 : 128;
    for (int t = 0; t < 4; ++t)
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          for (int k = 0; k < 6; ++k)
            for (int l = 0; l < (k == 0 ? 3 : 6); ++l) {
              uint8_t* pp = pre.coef[t][i][j][k][l];
              unsigned e = counts.eob[t][i][j][k][l];
              const unsigned* cc = counts.coef[t][i][j][k][l];
              unsigned neob = cc[3];
              pp[0] = merge_prob(pp[0], neob, e - neob, 24, uf);
              pp[1] = merge_prob(pp[1], cc[0], cc[1] + cc[2], 24, uf);
              pp[2] = merge_prob(pp[2], cc[1], cc[2], 24, uf);
            }
    if (h.intra) {
      std::memcpy(pre.skip, fc.skip, sizeof(pre.skip));
      std::memcpy(pre.tx8, fc.tx8, sizeof(pre.tx8));
      std::memcpy(pre.tx16, fc.tx16, sizeof(pre.tx16));
      std::memcpy(pre.tx32, fc.tx32, sizeof(pre.tx32));
      return;
    }
    for (int i = 0; i < 4; ++i) pre.intra_inter[i] = mode_merge(pre.intra_inter[i], counts.intra_inter[i]);
    for (int i = 0; i < 5; ++i) {
      pre.comp_inter[i] = mode_merge(pre.comp_inter[i], counts.comp_inter[i]);
      pre.comp_ref[i] = mode_merge(pre.comp_ref[i], counts.comp_ref[i]);
      for (int j = 0; j < 2; ++j) pre.single_ref[i][j] = mode_merge(pre.single_ref[i][j], counts.single_ref[i][j]);
    }
    for (int i = 0; i < 7; ++i) tree_merge(INTER_MODE_TREE, pre.inter_mode[i], 3, counts.inter_mode[i]);
    for (int i = 0; i < 4; ++i) tree_merge(INTRA_MODE_TREE, pre.y_mode[i], 9, counts.y_mode[i]);
    for (int i = 0; i < 10; ++i) tree_merge(INTRA_MODE_TREE, pre.uv_mode[i], 9, counts.uv_mode[i]);
    for (int i = 0; i < 16; ++i) tree_merge(PARTITION_TREE, pre.partition[i], 3, counts.partition[i]);
    if (h.filter == SWITCHABLE)
      for (int i = 0; i < 4; ++i) tree_merge(SWITCHABLE_INTERP_TREE, pre.interp[i], 2, counts.interp[i]);
    if (h.tx_mode == TX_MODE_SELECT)
      for (int i = 0; i < 2; ++i) {
        const unsigned *c8 = counts.tx8[i], *c16 = counts.tx16[i], *c32 = counts.tx32[i];
        unsigned a[2];
        a[0] = c8[0], a[1] = c8[1];
        pre.tx8[i][0] = mode_merge(pre.tx8[i][0], a);
        a[0] = c16[0], a[1] = c16[1] + c16[2];
        pre.tx16[i][0] = mode_merge(pre.tx16[i][0], a);
        a[0] = c16[1], a[1] = c16[2];
        pre.tx16[i][1] = mode_merge(pre.tx16[i][1], a);
        a[0] = c32[0], a[1] = c32[1] + c32[2] + c32[3];
        pre.tx32[i][0] = mode_merge(pre.tx32[i][0], a);
        a[0] = c32[1], a[1] = c32[2] + c32[3];
        pre.tx32[i][1] = mode_merge(pre.tx32[i][1], a);
        a[0] = c32[2], a[1] = c32[3];
        pre.tx32[i][2] = mode_merge(pre.tx32[i][2], a);
      }
    for (int i = 0; i < 3; ++i) pre.skip[i] = mode_merge(pre.skip[i], counts.skip[i]);
    tree_merge(MV_JOINT_TREE, pre.mv_joint, 3, counts.mv_joint);
    for (int k = 0; k < 2; ++k) {
      MvComp& comp = pre.mv_comp[k];
      const MvCounts& cc = counts.mv_comp[k];
      comp.sign = mode_merge(comp.sign, cc.sign);
      tree_merge(MV_CLASS_TREE, comp.classes, 10, cc.classes);
      comp.class0[0] = mode_merge(comp.class0[0], cc.class0);
      for (int j = 0; j < 10; ++j) comp.bits[j] = mode_merge(comp.bits[j], cc.bits[j]);
      for (int j = 0; j < 2; ++j) tree_merge(MV_FP_TREE, comp.class0_fp[j], 3, cc.class0_fp[j]);
      tree_merge(MV_FP_TREE, comp.fp, 3, cc.fp);
      if (h.hp) {
        comp.class0_hp = mode_merge(comp.class0_hp, cc.class0_hp);
        comp.hp = mode_merge(comp.hp, cc.hp);
      }
    }
  }
};

}  // namespace

extern "C" {

void* vk_vp9_create() { return new Decoder(); }

void vk_vp9_destroy(void* h) { delete static_cast<Decoder*>(h); }

// Decode one packet (a frame or a superframe): 1 when it shows a frame (its
// size in *w, *h; its planes by vk_vp9_planes), 0 when it shows none, -1
// where libavcodec refuses a frame and -2 where the port does (the message
// by vk_vp9_error).
int vk_vp9_decode(void* h, const unsigned char* data, size_t n, int* w, int* hh) {
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
void vk_vp9_planes(void* h, unsigned char* y, unsigned char* u, unsigned char* v) {
  Decoder* d = static_cast<Decoder*>(h);
  const Frame& f = *d->shown;
  int w = d->out_w, hh = d->out_h, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  for (int r = 0; r < hh; ++r)
    std::memcpy(y + static_cast<size_t>(r) * w, f.plane[0].data() + static_cast<size_t>(r) * f.stride[0], w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + static_cast<size_t>(r) * cw, f.plane[1].data() + static_cast<size_t>(r) * f.stride[1], cw);
    std::memcpy(v + static_cast<size_t>(r) * cw, f.plane[2].data() + static_cast<size_t>(r) * f.stride[2], cw);
  }
}

const char* vk_vp9_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

// The last shown frame's colour range (1: full, AVCOL_RANGE_JPEG).
int vk_vp9_full_range(void* h) { return static_cast<Decoder*>(h)->full_range; }

long long vk_vp9_calls() { return g_calls.load(); }

}  // extern "C"
