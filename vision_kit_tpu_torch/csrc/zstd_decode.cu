// Zstandard decompression (RFC 8878) as host C++.
//
// Host code only (nvcc hands it to the host compiler); plain C interface,
// loaded with ctypes by utils/zstd.py:decompress_c. It is the counterpart
// of utils/zstd.py, the plain decoder, and gives the same bytes and the
// same refusals: orbax checkpoints (tensorstore's zstd compressor, and the
// OCDBT B-tree nodes) are read with it on the card's path, where a
// full-width TrainState is tens to hundreds of MB of zstd and the plain
// decoder's Python loops would take minutes.
//
// What it decodes, in the plain decoder's order:
// - frames with or without Frame_Content_Size, single-segment frames and
//   the window descriptor, the content checksum (XXH64's low 32 bits,
//   verified), concatenated and skippable frames; a nonzero Dictionary_ID
//   is refused (status -2);
// - raw, RLE and compressed blocks;
// - literals raw, RLE, Huffman-coded in 1 or 4 streams or treeless, the
//   weights direct or FSE-compressed (two interleaved states), decoded one
//   lookup of max_bits bits a symbol;
// - sequences with each symbol type predefined, RLE, FSE-compressed or
//   repeated, the repeat offsets, matches back across the frame's blocks.
// Decompression is serial within a frame; this is host code by nature.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <new>
#include <vector>

namespace {

enum : long long {
  kTruncated = -1,
  kDictionary = -2,
  kCorrupt = -3,
  kChecksum = -4,
  kSize = -5,
  kCapacity = -6,
};

struct Failure {
  long long code;
};

[[noreturn]] void fail(long long code) { throw Failure{code}; }

std::atomic<long long> g_calls{0};

const uint32_t kMagic = 0xFD2FB528u;
const uint32_t kSkippable = 0x184D2A50u;
const size_t kMaxBlock = 128 * 1024;

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// -- XXH64 -------------------------------------------------------------------

const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
               P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
               P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xround(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  return rotl(acc, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= xround(0, le64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(le32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// -- bit streams -------------------------------------------------------------

// A backward bit stream: the bits of [s, s + len) below the last byte's
// end marker, read from the top; bits below 0 read as zeros.
struct Back {
  const uint8_t* s;
  size_t len;
  int64_t pos;  // bits not yet read

  Back(const uint8_t* src, size_t n) : s(src), len(n) {
    if (n == 0) fail(kCorrupt);
    const uint8_t last = src[n - 1];
    if (last == 0) fail(kCorrupt);
    int top = 7;
    while (!(last >> top)) --top;
    pos = static_cast<int64_t>(n - 1) * 8 + top;
  }

  // bits [lo, lo + n) as a number, zeros below bit 0 (n <= 32)
  inline uint64_t at(int64_t lo, int n) const {
    if (n == 0) return 0;
    const int64_t hi = lo + n;
    if (hi <= 0) return 0;
    int pad = 0;
    if (lo < 0) {
      pad = static_cast<int>(-lo);
      n = static_cast<int>(hi);
      lo = 0;
    }
    const size_t b = static_cast<size_t>(lo >> 3);
    uint64_t w = 0;
    std::memcpy(&w, s + b, len - b < 8 ? len - b : 8);
    return ((w >> (lo & 7)) & ((1ull << n) - 1)) << pad;
  }

  inline uint64_t read(int n) {
    pos -= n;
    return at(pos, n);
  }
};

// -- FSE -----------------------------------------------------------------------

struct Fse {
  int log = 0;
  uint8_t sym[512];
  uint8_t nb[512];
  uint16_t base[512];
};

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,   5,   6,   7,   8,    9,    10,   11,
                              12, 13, 14, 15, 16,  18,  20,  22,  24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,  16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,  30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,  83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

void build_fse(const int16_t* norm, int n_sym, int log, Fse* t) {
  const int size = 1 << log;
  int high = size;
  uint32_t next[256];
  t->log = log;
  for (int s = 0; s < n_sym; ++s) {
    if (norm[s] == -1) {
      t->sym[--high] = static_cast<uint8_t>(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n_sym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = norm[s];
    for (int i = 0; i < norm[s]; ++i) {
      t->sym[pos] = static_cast<uint8_t>(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail(kCorrupt);
  for (int i = 0; i < size; ++i) {
    const uint32_t d = next[t->sym[i]]++;
    int hb = 31;
    while (!(d >> hb)) --hb;
    const int nb = log - hb;
    t->nb[i] = static_cast<uint8_t>(nb);
    t->base[i] = static_cast<uint16_t>((d << nb) - size);
  }
}

// An FSE table description at [pos, end): returns the position after it.
size_t read_fse(const uint8_t* d, size_t pos, size_t end, int max_symbol, int max_log,
                Fse* t) {
  if (pos >= end) fail(kTruncated);
  uint64_t bitpos = pos * 8;
  auto bits = [&](int n) -> uint32_t {
    const size_t b = bitpos >> 3;
    uint64_t w = 0;
    if (b < end) std::memcpy(&w, d + b, end - b < 8 ? end - b : 8);
    return static_cast<uint32_t>((w >> (bitpos & 7)) & ((1ull << n) - 1));
  };
  const int log = static_cast<int>(bits(4)) + 5;
  bitpos += 4;
  if (log > max_log) fail(kCorrupt);
  int remaining = 1 << log;
  int16_t norm[256];
  int n = 0;
  while (remaining > 0) {
    if (n > max_symbol) fail(kCorrupt);
    int nb = 0;
    while ((remaining + 1) >> nb) ++nb;
    uint32_t val = bits(nb);
    const uint32_t lower = (1u << (nb - 1)) - 1;
    const uint32_t threshold = (1u << nb) - 1 - (remaining + 1);
    if ((val & lower) < threshold) {
      val &= lower;
      bitpos += nb - 1;
    } else {
      if (val > lower) val -= threshold;
      bitpos += nb;
    }
    const int count = static_cast<int>(val) - 1;
    remaining -= count < 0 ? -count : count;
    norm[n++] = static_cast<int16_t>(count);
    if (count == 0) {
      while (true) {
        const uint32_t rep = bits(2);
        bitpos += 2;
        for (uint32_t i = 0; i < rep; ++i) {
          if (n > max_symbol) fail(kCorrupt);
          norm[n++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0 || n > max_symbol + 1) fail(kCorrupt);
  if (bitpos > end * 8) fail(kTruncated);
  build_fse(norm, n, log, t);
  return (bitpos + 7) >> 3;
}

// -- Huffman -----------------------------------------------------------------

struct Huffman {
  bool defined = false;
  int max_bits = 0;
  uint8_t sym[1 << 11];
  uint8_t len[1 << 11];
};

void build_huffman(const uint8_t* weights, int n, Huffman* h) {
  if (n > 255) fail(kCorrupt);
  uint32_t total = 0;
  for (int i = 0; i < n; ++i)
    if (weights[i]) total += 1u << (weights[i] - 1);
  if (total == 0) fail(kCorrupt);
  int max_bits = 0;
  while (total >> max_bits) ++max_bits;
  const uint32_t rest = (1u << max_bits) - total;
  if ((rest & (rest - 1)) || max_bits > 11) fail(kCorrupt);
  uint8_t w[256];
  std::memcpy(w, weights, n);
  int last = 0;
  while (rest >> last) ++last;
  w[n] = static_cast<uint8_t>(last);
  uint32_t counts[13] = {0}, rank[13] = {0};
  for (int i = 0; i <= n; ++i) {
    if (w[i] > max_bits) fail(kCorrupt);
    counts[w[i]]++;
  }
  uint32_t start = 0;
  for (int k = 1; k <= max_bits; ++k) {
    rank[k] = start;
    start += counts[k] << (k - 1);
  }
  for (int s = 0; s <= n; ++s) {
    if (!w[s]) continue;
    const uint32_t cnt = 1u << (w[s] - 1);
    std::memset(h->sym + rank[w[s]], s, cnt);
    std::memset(h->len + rank[w[s]], max_bits + 1 - w[s], cnt);
    rank[w[s]] += cnt;
  }
  h->max_bits = max_bits;
  h->defined = true;
}

size_t read_huffman(const uint8_t* d, size_t pos, size_t end, Huffman* h) {
  if (pos >= end) fail(kTruncated);
  const uint8_t header = d[pos++];
  uint8_t weights[512];
  int n = 0;
  if (header >= 128) {
    n = header - 127;
    const size_t nbytes = (n + 1) / 2;
    if (pos + nbytes > end) fail(kTruncated);
    for (size_t i = 0; i < nbytes; ++i) {
      weights[2 * i] = d[pos + i] >> 4;
      weights[2 * i + 1] = d[pos + i] & 15;
    }
    build_huffman(weights, n, h);
    return pos + nbytes;
  }
  if (pos + header > end) fail(kTruncated);
  Fse t;
  const size_t start = read_fse(d, pos, pos + header, 255, 6, &t);
  Back bs(d + start, pos + header - start);
  uint32_t s1 = static_cast<uint32_t>(bs.read(t.log));
  uint32_t s2 = static_cast<uint32_t>(bs.read(t.log));
  if (bs.pos < -64) fail(kCorrupt);
  while (true) {
    weights[n++] = t.sym[s1];
    s1 = t.base[s1] + static_cast<uint32_t>(bs.read(t.nb[s1]));
    if (bs.pos < 0) {
      weights[n++] = t.sym[s2];
      break;
    }
    weights[n++] = t.sym[s2];
    s2 = t.base[s2] + static_cast<uint32_t>(bs.read(t.nb[s2]));
    if (bs.pos < 0) {
      weights[n++] = t.sym[s1];
      break;
    }
    if (n > 255) fail(kCorrupt);
  }
  build_huffman(weights, n, h);
  return pos + header;
}

// One backward Huffman stream: the stream is copied behind 8 zero bytes
// (bit 64 is its bit 0), and each 64-bit load serves every symbol whose
// max_bits lie inside it.
void huffman_stream(const uint8_t* d, size_t start, size_t end, size_t n_out,
                    const Huffman& h, uint8_t* out, std::vector<uint8_t>* scratch) {
  Back bs(d + start, end - start);
  const size_t len = end - start;
  scratch->assign(len + 16, 0);
  std::memcpy(scratch->data() + 8, d + start, len);
  const uint8_t* s = scratch->data();
  const int mb = h.max_bits;
  const uint64_t mask = (1ull << mb) - 1;
  int64_t lo = bs.pos + 64 - mb;
  size_t i = 0;
  while (i < n_out) {
    if (lo < 64 - mb) fail(kCorrupt);
    const int64_t top = lo + mb;
    const int64_t wb = top > 64 ? (top - 64 + 7) >> 3 : 0;
    const uint64_t w = le64(s + wb);
    const int64_t floor = wb * 8;
    do {
      const uint32_t v = static_cast<uint32_t>((w >> (lo - floor)) & mask);
      out[i++] = h.sym[v];
      lo -= h.len[v];
    } while (lo >= floor && i < n_out);
  }
  if (lo != 64 - mb) fail(kCorrupt);
}

// -- frames ------------------------------------------------------------------

struct FrameState {
  Huffman huffman;
  Fse ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> scratch;  // a Huffman stream behind its zero padding
};

struct Header {
  uint64_t window;
  bool has_size;
  uint64_t size;
  bool checksum;
  size_t end;
};

Header frame_header(const uint8_t* d, size_t n, size_t pos) {
  if (pos + 5 > n) fail(kTruncated);
  if (le32(d + pos) != kMagic) fail(kCorrupt);
  const uint8_t fhd = d[pos + 4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail(kCorrupt);
  Header h{};
  h.checksum = (fhd >> 2) & 1;
  size_t p = pos + 5;
  if (!single) {
    if (p >= n) fail(kTruncated);
    const uint8_t wd = d[p++];
    const int log = 10 + (wd >> 3);
    h.window = (1ull << log) + ((1ull << log) >> 3) * (wd & 7);
  }
  static const size_t kDictBytes[4] = {0, 1, 2, 4}, kSizeBytes[4] = {0, 2, 4, 8};
  const size_t nd = kDictBytes[dict_flag];
  const size_t nf = fcs_flag == 0 ? (single ? 1 : 0) : kSizeBytes[fcs_flag];
  if (p + nd + nf > n) fail(kTruncated);
  uint64_t dict_id = 0;
  for (size_t i = 0; i < nd; ++i) dict_id |= static_cast<uint64_t>(d[p + i]) << (8 * i);
  p += nd;
  if (dict_id) fail(kDictionary);
  h.has_size = nf != 0;
  h.size = 0;
  for (size_t i = 0; i < nf; ++i) h.size |= static_cast<uint64_t>(d[p + i]) << (8 * i);
  if (nf == 2) h.size += 256;
  p += nf;
  if (single) h.window = h.size;
  h.end = p;
  return h;
}

struct Out {
  uint8_t* buf;
  size_t cap;
  size_t n = 0;

  inline void need(size_t k) {
    if (k > cap - n) fail(kCapacity);
  }
};

size_t literals(const uint8_t* d, size_t pos, size_t end, FrameState* st,
                std::vector<uint8_t>* lits) {
  if (pos >= end) fail(kTruncated);
  const uint8_t b0 = d[pos];
  const int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind < 2) {
    size_t size;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      pos += 1;
    } else if (fmt == 1) {
      if (pos + 2 > end) fail(kTruncated);
      size = (b0 >> 4) + (d[pos + 1] << 4);
      pos += 2;
    } else {
      if (pos + 3 > end) fail(kTruncated);
      size = (b0 >> 4) + (d[pos + 1] << 4) + (d[pos + 2] << 12);
      pos += 3;
    }
    if (size > kMaxBlock) fail(kCorrupt);
    if (kind == 0) {
      if (pos + size > end) fail(kTruncated);
      lits->assign(d + pos, d + pos + size);
      return pos + size;
    }
    if (pos >= end) fail(kTruncated);
    lits->assign(size, d[pos]);
    return pos + 1;
  }
  static const int kHeaderBytes[4] = {3, 3, 4, 5}, kSizeBits[4] = {10, 10, 14, 18};
  const int nh = kHeaderBytes[fmt];
  if (pos + nh > end) fail(kTruncated);
  uint64_t h = 0;
  for (int i = 0; i < nh; ++i) h |= static_cast<uint64_t>(d[pos + i]) << (8 * i);
  const int bits = kSizeBits[fmt];
  const size_t regen = (h >> 4) & ((1ull << bits) - 1);
  const size_t comp = h >> (4 + bits);
  pos += nh;
  const size_t lit_end = pos + comp;
  if (lit_end > end || regen > kMaxBlock) fail(kTruncated);
  if (kind == 2) {
    pos = read_huffman(d, pos, lit_end, &st->huffman);
  } else if (!st->huffman.defined) {
    fail(kCorrupt);
  }
  lits->resize(regen);
  std::vector<uint8_t>& scratch = st->scratch;
  if (fmt == 0) {
    huffman_stream(d, pos, lit_end, regen, st->huffman, lits->data(), &scratch);
    return lit_end;
  }
  if (pos + 6 > lit_end) fail(kTruncated);
  const size_t s1 = d[pos] | (d[pos + 1] << 8), s2 = d[pos + 2] | (d[pos + 3] << 8),
               s3 = d[pos + 4] | (d[pos + 5] << 8);
  pos += 6;
  const size_t b[5] = {pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, lit_end};
  if (b[3] > lit_end) fail(kCorrupt);
  const size_t each = (regen + 3) / 4;
  if (3 * each > regen) fail(kCorrupt);
  const size_t sizes[4] = {each, each, each, regen - 3 * each};
  for (int i = 0; i < 4; ++i)
    huffman_stream(d, b[i], b[i + 1], sizes[i], st->huffman, lits->data() + i * each,
                   &scratch);
  return lit_end;
}

size_t seq_table(int mode, const uint8_t* d, size_t pos, size_t end, Fse* t, bool* have,
                 const int16_t* def, int n_def, int def_log, int max_symbol, int max_log) {
  if (mode == 0) {
    build_fse(def, n_def, def_log, t);
  } else if (mode == 1) {
    if (pos >= end) fail(kTruncated);
    if (d[pos] > max_symbol) fail(kCorrupt);
    t->log = 0;
    t->sym[0] = d[pos];
    t->nb[0] = 0;
    t->base[0] = 0;
    ++pos;
  } else if (mode == 2) {
    pos = read_fse(d, pos, end, max_symbol, max_log, t);
  } else if (!*have) {
    fail(kCorrupt);
  }
  *have = true;
  return pos;
}

void sequences(const uint8_t* d, size_t pos, size_t end, FrameState* st,
               const std::vector<uint8_t>& lits, Out* out, size_t frame_start) {
  if (pos >= end) fail(kTruncated);
  const uint8_t b0 = d[pos];
  size_t n;
  if (b0 == 0) {
    if (pos + 1 != end) fail(kCorrupt);
    out->need(lits.size());
    std::memcpy(out->buf + out->n, lits.data(), lits.size());
    out->n += lits.size();
    return;
  }
  if (b0 < 128) {
    n = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > end) fail(kTruncated);
    n = ((b0 - 128) << 8) + d[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > end) fail(kTruncated);
    n = d[pos + 1] + (d[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  if (pos >= end) fail(kTruncated);
  const uint8_t modes = d[pos++];
  if (modes & 3) fail(kCorrupt);
  pos = seq_table(modes >> 6, d, pos, end, &st->ll, &st->have_ll, kLLDefault, 36, 6, 35, 9);
  pos = seq_table((modes >> 4) & 3, d, pos, end, &st->of, &st->have_of, kOFDefault, 29, 5,
                  31, 8);
  pos = seq_table((modes >> 2) & 3, d, pos, end, &st->ml, &st->have_ml, kMLDefault, 53, 6,
                  52, 9);
  Back bs(d + pos, end - pos);
  const Fse &ll_t = st->ll, &of_t = st->of, &ml_t = st->ml;
  uint32_t ll_s = static_cast<uint32_t>(bs.read(ll_t.log));
  uint32_t of_s = static_cast<uint32_t>(bs.read(of_t.log));
  uint32_t ml_s = static_cast<uint32_t>(bs.read(ml_t.log));
  if (bs.pos < 0) fail(kCorrupt);
  uint64_t* rep = st->rep;
  size_t lit_pos = 0;
  for (size_t i = 0; i < n; ++i) {
    const int of_code = of_t.sym[of_s], ll_code = ll_t.sym[ll_s], ml_code = ml_t.sym[ml_s];
    if (of_code > 31 || ll_code > 35 || ml_code > 52) fail(kCorrupt);
    const uint64_t of_val = (1ull << of_code) + bs.read(of_code);
    const size_t ml = kMLBase[ml_code] + bs.read(kMLBits[ml_code]);
    const size_t ll = kLLBase[ll_code] + bs.read(kLLBits[ll_code]);
    if (i + 1 < n) {
      ll_s = ll_t.base[ll_s] + static_cast<uint32_t>(bs.read(ll_t.nb[ll_s]));
      ml_s = ml_t.base[ml_s] + static_cast<uint32_t>(bs.read(ml_t.nb[ml_s]));
      of_s = of_t.base[of_s] + static_cast<uint32_t>(bs.read(of_t.nb[of_s]));
    }
    if (bs.pos < 0) fail(kCorrupt);
    uint64_t offset;
    if (of_val > 3) {
      offset = of_val - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const uint64_t idx = of_val - 1 + (ll == 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx < 3 ? rep[idx] : rep[0] - 1;
        if (idx > 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (lit_pos + ll > lits.size()) fail(kCorrupt);
    out->need(ll);
    std::memcpy(out->buf + out->n, lits.data() + lit_pos, ll);
    out->n += ll;
    lit_pos += ll;
    if (offset == 0 || offset > out->n - frame_start) fail(kCorrupt);
    out->need(ml);
    uint8_t* dst = out->buf + out->n;
    const uint8_t* src = dst - offset;
    if (offset >= ml) {
      std::memcpy(dst, src, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) dst[k] = src[k];
    }
    out->n += ml;
  }
  if (bs.pos != 0) fail(kCorrupt);
  const size_t rest = lits.size() - lit_pos;
  out->need(rest);
  std::memcpy(out->buf + out->n, lits.data() + lit_pos, rest);
  out->n += rest;
}

size_t frame(const uint8_t* d, size_t n, size_t pos, Out* out) {
  const Header h = frame_header(d, n, pos);
  size_t p = h.end;
  const size_t start = out->n;
  FrameState* st = new FrameState();
  std::vector<uint8_t> lits;
  const uint64_t block_max = h.window < kMaxBlock ? h.window : kMaxBlock;
  try {
    while (true) {
      if (p + 3 > n) fail(kTruncated);
      const uint32_t bh = d[p] | (d[p + 1] << 8) | (d[p + 2] << 16);
      p += 3;
      const int last = bh & 1, type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 1) {
        if (p + 1 > n) fail(kTruncated);
        if (size > block_max) fail(kCorrupt);
        out->need(size);
        std::memset(out->buf + out->n, d[p], size);
        out->n += size;
        p += 1;
      } else {
        if (p + size > n) fail(kTruncated);
        if (type == 0) {
          if (size > block_max) fail(kCorrupt);
          out->need(size);
          std::memcpy(out->buf + out->n, d + p, size);
          out->n += size;
        } else if (type == 2) {
          if (size > block_max) fail(kCorrupt);
          const size_t before = out->n;
          const size_t q = literals(d, p, p + size, st, &lits);
          sequences(d, q, p + size, st, lits, out, start);
          if (out->n - before > block_max) fail(kCorrupt);
        } else {
          fail(kCorrupt);
        }
        p += size;
      }
      if (h.has_size && out->n - start > h.size) fail(kSize);
      if (last) break;
    }
  } catch (...) {
    delete st;
    throw;
  }
  delete st;
  if (h.has_size && out->n - start != h.size) fail(kSize);
  if (h.checksum) {
    if (p + 4 > n) fail(kTruncated);
    const uint32_t want = le32(d + p);
    if ((xxh64(out->buf + start, out->n - start) & 0xFFFFFFFFu) != want) fail(kChecksum);
    p += 4;
  }
  return p;
}

// An upper bound of the decoded size of [d, d + n): each frame's content
// size where its header has one, and never more than its blocks can hold.
uint64_t bound(const uint8_t* d, size_t n) {
  if (n == 0) fail(kTruncated);
  uint64_t total = 0;
  size_t pos = 0;
  while (pos < n) {
    if (pos + 4 > n) fail(kTruncated);
    const uint32_t magic = le32(d + pos);
    if ((magic & 0xFFFFFFF0u) == kSkippable) {
      if (pos + 8 > n) fail(kTruncated);
      const uint64_t len = le32(d + pos + 4);
      if (pos + 8 + len > n) fail(kTruncated);
      pos += 8 + len;
      continue;
    }
    const Header h = frame_header(d, n, pos);
    const uint64_t block_max = h.window < kMaxBlock ? h.window : kMaxBlock;
    uint64_t blocks = 0;
    size_t p = h.end;
    while (true) {
      if (p + 3 > n) fail(kTruncated);
      const uint32_t bh = d[p] | (d[p + 1] << 8) | (d[p + 2] << 16);
      p += 3;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) fail(kCorrupt);
      blocks += type == 2 ? block_max : size;
      p += type == 1 ? 1 : size;
      if (p > n) fail(kTruncated);
      if (bh & 1) break;
    }
    if (h.checksum) p += 4;
    if (p > n) fail(kTruncated);
    total += h.has_size && h.size < blocks ? h.size : blocks;
    pos = p;
  }
  return total;
}

}  // namespace

extern "C" {

// An upper bound of the decoded size of src[0, n), or a negative status.
long long vk_zstd_decompressed_size(const unsigned char* src, size_t n) {
  try {
    return static_cast<long long>(bound(src, n));
  } catch (const Failure& f) {
    return f.code;
  }
}

// Decode every frame of src[0, n) into dst[0, cap); returns the decoded
// size or a negative status (vk_zstd_error names it).
long long vk_zstd_decompress(const unsigned char* src, size_t n, unsigned char* dst,
                             size_t cap) {
  g_calls.fetch_add(1);
  Out out{dst, cap};
  try {
    if (n == 0) fail(kTruncated);
    size_t pos = 0;
    while (pos < n) {
      if (pos + 4 > n) fail(kTruncated);
      const uint32_t magic = le32(src + pos);
      if ((magic & 0xFFFFFFF0u) == kSkippable) {
        if (pos + 8 > n) fail(kTruncated);
        const uint64_t len = le32(src + pos + 4);
        if (pos + 8 + len > n) fail(kTruncated);
        pos += 8 + len;
      } else {
        pos = frame(src, n, pos, &out);
      }
    }
  } catch (const Failure& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kCapacity;
  }
  return static_cast<long long>(out.n);
}

// Number of vk_zstd_decompress calls since the library was loaded.
long long vk_zstd_calls() { return g_calls.load(); }

const char* vk_zstd_error(long long status) {
  switch (status) {
    case kTruncated: return "zstd: input truncated";
    case kDictionary: return "zstd: frame needs a dictionary; no dictionary is known";
    case kCorrupt: return "zstd: corrupt input";
    case kChecksum: return "zstd: content checksum mismatch";
    case kSize: return "zstd: frame decodes to other than its content size";
    case kCapacity: return "zstd: output larger than its bound";
    default: return "zstd: unknown status";
  }
}

}  // extern "C"
