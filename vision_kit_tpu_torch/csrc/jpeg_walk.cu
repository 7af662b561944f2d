// Host-side Huffman walk of a JPEG's scans: for each scan, how many of its
// MCUs need entropy-coded bits past the data of their restart interval.
//
// Host code only (nvcc hands it to the host compiler); plain C interface,
// loaded with ctypes by data/decode.py:walk_scans_short. It is the
// counterpart of decode.scans_short, the plain decoder's own walks
// (_decode_blocks, _dc_first, _ac_first, _ac_refine and _run_intervals),
// and returns the same counts: the route to nvJPEG sends a file to the
// host decoder instead when any count is nonzero, since libjpeg reads the
// missing bits as zeros and nvJPEG does not.
//
// What the walk reproduces, from the plain decoder:
// - each restart interval's bytes unstuffed (stuffed zeros and fill bytes
//   dropped, split at RST markers) and read MSB first, zero past their end;
// - Huffman codes through a 16-bit lookahead table, a code that matches
//   nothing taking 17 bits and giving symbol 0 (as libjpeg does);
// - sequential scans (DC, then AC runs to the end of block);
// - progressive DC first and DC refinement (one bit a block), AC first with
//   EOBRUN, AC refinement with jdphuff.c's walk over the coefficients that
//   are nonzero before the scan, kept as libjpeg's 16-bit values from the
//   component's earlier scans;
// - jdhuff.c's standard tables (jstdhuff.c) in sequential slots 0 and 1
//   that no DHT before the first scan defines (Motion-JPEG frames carry
//   none); a progressive file takes none, as jdphuff.c;
// - an interval whose bits run out: the MCU where they do is read on
//   through zero bits and the rest of the interval is left; intervals
//   missing before the marker count whole, and the first of them is read
//   from zero bits when the interval before it did not run out.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { kOk = 0, kMalformed = -1, kUnsupported = -2 };

struct Table {
  bool defined = false;
  std::vector<uint16_t> look;  // code length | symbol << 5, by next 16 bits
};

struct Comp {
  int id, h, v;
  int bcols, brows, bcols_real, brows_real;
  size_t offset;  // first block in the coefficient store
};

// Bits of one unstuffed interval, MSB first, zero past its end: a 64-bit
// buffer holding `nbits` unread bits, refilled a byte at a time.
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;    // the next byte to load
  uint64_t acc = 0;  // the low `nbits` bits are unread
  int nbits = 0;

  inline void fill() {
    while (nbits <= 56) {
      acc = (acc << 8) | (pos < n ? d[pos] : 0u);
      ++pos;
      nbits += 8;
    }
  }
  inline uint32_t peek16() {
    if (nbits < 16) fill();
    return static_cast<uint32_t>(acc >> (nbits - 16)) & 0xFFFFu;
  }
  inline void skip(unsigned k) {  // k <= 32
    if (nbits < static_cast<int>(k)) fill();
    nbits -= static_cast<int>(k);
  }
  inline uint32_t get(unsigned s) {  // s <= 32
    if (s == 0) return 0;
    skip(s);
    return static_cast<uint32_t>(acc >> nbits) & static_cast<uint32_t>((uint64_t{1} << s) - 1);
  }
  // whether the bits read so far run past the data
  inline bool past() const {
    return 8 * static_cast<uint64_t>(pos) - nbits > 8 * static_cast<uint64_t>(n);
  }
};

inline int extend(uint32_t v, unsigned s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - static_cast<int>((1u << s) - 1)
                             : static_cast<int>(v);
}

inline int16_t wrap16(int64_t x) {
  return static_cast<int16_t>(static_cast<uint16_t>(static_cast<uint64_t>(x)));
}

bool build_table(const uint8_t* counts, const uint8_t* symbols, size_t nsym,
                 Table* t) {
  t->look.assign(65536, static_cast<uint16_t>(17));  // a bad code: 17 bits, 0
  uint32_t code = 0;
  size_t k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i) {
      if (k >= nsym) return false;
      const uint32_t lo = code << (16 - len), hi = (code + 1) << (16 - len);
      if (hi > 65536) return false;
      const uint16_t e = static_cast<uint16_t>(len | (symbols[k] << 5));
      for (uint32_t j = lo; j < hi; ++j) t->look[j] = e;
      ++k;
      ++code;
    }
    code <<= 1;
  }
  t->defined = true;
  return true;
}

// jstdhuff.c's bits[1..16] and symbols: DC luma, AC luma, DC chroma, AC
// chroma (class, slot (0, 0), (1, 0), (0, 1), (1, 1))
const uint8_t kStdDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                   {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
                                   {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

inline unsigned huff(Bits* b, const Table& t) {
  const uint16_t e = t.look[b->peek16()];
  b->skip(e & 31);
  return e >> 5;
}

struct Walker {
  std::vector<Comp> comps;
  int mcu_cols = 0, mcu_rows = 0;
  bool progressive = false;
  std::vector<int16_t> coefs;  // 64 per block, natural order
  Table tables[2][4];
  int restart = 0;

  // one scan's blocks, MCU by MCU
  std::vector<size_t> blocks;  // block index in the store
  std::vector<int> slots;      // each block's component slot in the scan
  int per_mcu = 0;
  size_t total = 0;  // MCUs

  void block_order(const std::vector<int>& scan) {
    blocks.clear();
    slots.clear();
    if (scan.size() == 1) {
      const Comp& c = comps[scan[0]];
      for (int r = 0; r < c.brows_real; ++r)
        for (int q = 0; q < c.bcols_real; ++q) {
          blocks.push_back(c.offset + static_cast<size_t>(r) * c.bcols + q);
          slots.push_back(0);
        }
      per_mcu = 1;
    } else {
      per_mcu = 0;
      for (size_t s = 0; s < scan.size(); ++s)
        per_mcu += comps[scan[s]].h * comps[scan[s]].v;
      for (int my = 0; my < mcu_rows; ++my)
        for (int mx = 0; mx < mcu_cols; ++mx)
          for (size_t s = 0; s < scan.size(); ++s) {
            const Comp& c = comps[scan[s]];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx) {
                blocks.push_back(c.offset +
                                 static_cast<size_t>(my * c.v + by) * c.bcols +
                                 mx * c.h + bx);
                slots.push_back(static_cast<int>(s));
              }
          }
    }
    total = blocks.size() / per_mcu;
  }

  // Walks MCUs [first, first + n) over `b`; returns the index in the
  // interval of the MCU after which the bits ran past the data, or -1.
  int walk(int kind, size_t first, size_t n, Bits* b, const Table* dc[4],
           const Table* ac[4], int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    uint32_t eobrun = 0;
    for (size_t m = 0; m < n; ++m) {
      const size_t* blk = &blocks[(first + m) * per_mcu];
      const int* slot = &slots[(first + m) * per_mcu];
      for (int i = 0; i < per_mcu; ++i) {
        int16_t* coef = progressive ? &coefs[blk[i] * 64] : nullptr;
        if (kind == 0) {  // sequential: DC, then AC to the end of block
          unsigned s = huff(b, *dc[slot[i]]);
          b->skip(s > 16 ? 16 : s);
          const Table& t = *ac[slot[i]];
          for (int k = 1; k < 64;) {
            const unsigned rs = huff(b, t), r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r + 1;
              b->skip(s);
            } else if (r == 15) {
              k += 16;
            } else {
              break;
            }
          }
        } else if (kind == 1) {  // DC first (values do not matter here)
          const unsigned s = huff(b, *dc[slot[i]]);
          b->skip(s > 16 ? 16 : s);
        } else if (kind == 2) {  // DC refinement
          b->skip(1);
        } else if (kind == 3) {  // AC first
          if (eobrun) {
            --eobrun;
            continue;
          }
          const Table& t = *ac[0];
          for (int k = ss; k <= se;) {
            const unsigned rs = huff(b, t), r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              const int v = extend(b->get(s), s);
              coef[kNatural[k]] = wrap16(static_cast<int64_t>(v) * (int64_t{1} << al));
              ++k;
            } else if (r == 15) {
              k += 16;
            } else {
              eobrun = (1u << r) - 1;
              if (r) eobrun += b->get(r);
              break;
            }
          }
        } else {  // AC refinement (jdphuff.c decode_mcu_AC_refine)
          const Table& t = *ac[0];
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; ++k) {
              const unsigned rs = huff(b, t);
              int r = rs >> 4;
              const unsigned s0 = rs & 15;
              int s = 0;
              if (s0) {
                s = b->get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1u << r;
                if (r) eobrun += b->get(r);
                break;
              }
              do {
                int16_t* c = &coef[kNatural[k]];
                if (*c != 0) {
                  if (b->get(1) && (*c & p1) == 0)
                    *c = wrap16(*c >= 0 ? *c + p1 : *c + m1);
                } else {
                  if (--r < 0) break;
                }
                ++k;
              } while (k <= se);
              if (s) coef[kNatural[k]] = static_cast<int16_t>(s);
            }
          }
          if (eobrun > 0) {
            for (; k <= se; ++k) {
              int16_t* c = &coef[kNatural[k]];
              if (*c != 0 && b->get(1) && (*c & p1) == 0)
                *c = wrap16(*c >= 0 ? *c + p1 : *c + m1);
            }
            --eobrun;
          }
        }
      }
      if (b->past()) return static_cast<int>(m);
    }
    return -1;
  }
};

// Where the marker after entropy-coded data from `pos` starts, or 0 when
// the bytes end first.
size_t scan_end(const uint8_t* d, size_t n, size_t pos) {
  for (size_t i = pos; i + 1 < n; ++i) {
    if (d[i] != 0xFF) continue;
    const uint8_t x = d[i + 1];
    if (x != 0 && x != 0xFF && !(x >= 0xD0 && x <= 0xD7)) return i;
  }
  return 0;
}

// The unstuffed bytes of each restart interval of data[pos, end).
void unstuff(const uint8_t* d, size_t pos, size_t end,
             std::vector<std::vector<uint8_t>>* segs) {
  segs->assign(1, {});
  for (size_t i = pos; i < end; ++i) {
    const uint8_t x = d[i];
    if (x != 0xFF) {
      segs->back().push_back(x);
      continue;
    }
    const uint8_t nxt = i + 1 < end ? d[i + 1] : 0xFF;
    if (nxt == 0xFF) continue;  // a fill byte
    if (nxt == 0) {             // a stuffed zero
      segs->back().push_back(0xFF);
      ++i;
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {
      segs->emplace_back();
      ++i;
    } else {
      segs->back().push_back(0xFF);
    }
  }
}

int walk_file(const uint8_t* d, size_t n, std::vector<int>* out) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kMalformed;
  Walker w;
  bool have_frame = false, started = false;
  std::vector<std::vector<uint8_t>> segs;
  size_t pos = 2;
  while (pos < n) {
    if (d[pos] != 0xFF) return kMalformed;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) break;
    const uint8_t m = d[pos++];
    if (m == 0xD9) break;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (pos + 2 > n) return kMalformed;
    const size_t len = (static_cast<size_t>(d[pos]) << 8) | d[pos + 1];
    const size_t a = pos + 2, b = pos + len;
    if (len < 2 || b > n) return kMalformed;
    const uint8_t* seg = d + a;
    const size_t sn = b - a;
    pos = b;
    const bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
    if (sof && !have_frame) {
      if (m != 0xC0 && m != 0xC1 && m != 0xC2) return kUnsupported;
      if (sn < 6) return kMalformed;
      const int height = (seg[1] << 8) | seg[2], width = (seg[3] << 8) | seg[4];
      const int nc = seg[5];
      if (sn < static_cast<size_t>(6 + 3 * nc) || nc == 0 || nc > 4 || !width ||
          !height)
        return kMalformed;
      w.progressive = m == 0xC2;
      int max_h = 1, max_v = 1;
      for (int i = 0; i < nc; ++i) {
        Comp c{};
        c.id = seg[6 + 3 * i];
        c.h = seg[7 + 3 * i] >> 4;
        c.v = seg[7 + 3 * i] & 15;
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kUnsupported;
        w.comps.push_back(c);
      }
      std::vector<int> sof_h, sof_v;
      for (auto& c : w.comps) {
        sof_h.push_back(c.h);
        sof_v.push_back(c.v);
      }
      if (nc == 1) w.comps[0].h = w.comps[0].v = 1;
      for (auto& c : w.comps) {
        max_h = c.h > max_h ? c.h : max_h;
        max_v = c.v > max_v ? c.v : max_v;
      }
      w.mcu_cols = (width + 8 * max_h - 1) / (8 * max_h);
      w.mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
      size_t total = 0;
      for (auto& c : w.comps) {
        c.bcols = w.mcu_cols * c.h;
        c.brows = w.mcu_rows * c.v;
        const int cw = (width * c.h + max_h - 1) / max_h;
        const int ch = (height * c.v + max_v - 1) / max_v;
        c.bcols_real = (cw + 7) / 8;
        c.brows_real = (ch + 7) / 8;
        c.offset = total;
        total += static_cast<size_t>(c.bcols) * c.brows;
      }
      if (w.progressive) w.coefs.assign(total * 64, 0);  // AC values, for refinement
      have_frame = true;
    } else if (m == 0xC4) {  // DHT
      size_t i = 0;
      while (i < sn) {
        const int tc = seg[i] >> 4, th = seg[i] & 15;
        if (i + 17 > sn || tc > 1 || th > 3) return kMalformed;
        size_t nsym = 0;
        for (int k = 0; k < 16; ++k) nsym += seg[i + 1 + k];
        const size_t avail = sn - (i + 17);
        if (!build_table(seg + i + 1, seg + i + 17, nsym < avail ? nsym : avail,
                         &w.tables[tc][th]))
          return kMalformed;
        i += 17 + nsym;
      }
    } else if (m == 0xDD) {  // DRI
      if (sn < 2) return kMalformed;
      w.restart = (seg[0] << 8) | seg[1];
    } else if (m == 0xDA) {  // SOS
      const size_t end = scan_end(d, n, b);
      if (end == 0) return kMalformed;
      pos = end;
      if (!have_frame || sn < 1) return kMalformed;
      if (!started && !w.progressive) {  // jinit_huff_decoder's std_huff_tables
        for (int th = 0; th < 2; ++th) {
          if (!w.tables[0][th].defined)
            build_table(kStdDcBits[th], kStdDcVals, 12, &w.tables[0][th]);
          if (!w.tables[1][th].defined)
            build_table(kStdAcBits[th], kStdAcVals[th], 162, &w.tables[1][th]);
        }
      }
      started = true;
      const int ns = seg[0];
      if (sn < static_cast<size_t>(4 + 2 * ns)) return kMalformed;
      const int ss = seg[1 + 2 * ns], se = seg[2 + 2 * ns];
      const int ah = seg[3 + 2 * ns] >> 4, al = seg[3 + 2 * ns] & 15;
      int kind = 0;
      if (w.progressive)
        kind = ss == 0 ? (ah == 0 ? 1 : 2) : (ah == 0 ? 3 : 4);
      std::vector<int> scan;
      const Table* dc[4] = {nullptr, nullptr, nullptr, nullptr};
      const Table* ac[4] = {nullptr, nullptr, nullptr, nullptr};
      if (ns < 1 || ns > 4) return kMalformed;
      for (int k = 0; k < ns; ++k) {
        const int cid = seg[1 + 2 * k], td = seg[2 + 2 * k] >> 4, ta = seg[2 + 2 * k] & 15;
        int ci = -1;
        for (size_t j = 0; j < w.comps.size(); ++j)
          if (w.comps[j].id == cid) {
            ci = static_cast<int>(j);
            break;
          }
        if (ci < 0 || td > 3 || ta > 3) return kMalformed;
        scan.push_back(ci);
        const bool need_dc = kind == 0 || kind == 1, need_ac = kind == 0 || kind >= 3;
        if ((need_dc && !w.tables[0][td].defined) || (need_ac && !w.tables[1][ta].defined))
          return kMalformed;
        dc[k] = &w.tables[0][td];
        ac[k] = &w.tables[1][ta];
      }
      if (kind >= 3 && (ns != 1 || ss > se || se > 63)) return kMalformed;
      w.block_order(scan);
      const size_t total = w.total;
      const size_t interval = w.restart ? static_cast<size_t>(w.restart) : total;
      const size_t n_intervals = total ? (total + interval - 1) / interval : 0;
      unstuff(d, b, end, &segs);
      const size_t present = segs.size() < n_intervals ? segs.size() : n_intervals;
      long long n_short = 0;
      int ran = -1;
      for (size_t iv = 0; iv < present; ++iv) {
        const size_t first = iv * interval;
        const size_t cnt = total - first < interval ? total - first : interval;
        Bits bits{segs[iv].data(), segs[iv].size()};
        ran = w.walk(kind, first, cnt, &bits, dc, ac, ss, se, al);
        if (ran >= 0) n_short += static_cast<long long>(cnt) - ran;
      }
      if (present < n_intervals) {
        const size_t first = present * interval;
        n_short += static_cast<long long>(total - first);
        if (ran < 0) {  // the first missing interval, read from zero bits
          const size_t cnt = total - first < interval ? total - first : interval;
          Bits bits{nullptr, 0};
          w.walk(kind, first, cnt, &bits, dc, ac, ss, se, al);
        }
      }
      out->push_back(static_cast<int>(n_short));
    }
  }
  return out->empty() ? kMalformed : kOk;
}

}  // namespace

extern "C" {

// Per-scan counts of MCUs short of bits into out[0, cap); returns the
// number of scans (which may exceed cap), or a negative code: -1 for bytes
// the walk cannot read as a Huffman JPEG, -2 for a frame it does not take.
int vk_jpeg_scans_short(const unsigned char* data, size_t n, int* out, int cap) {
  std::vector<int> counts;
  const int status = walk_file(data, n, &counts);
  if (status != kOk) return status;
  for (size_t i = 0; i < counts.size() && static_cast<int>(i) < cap; ++i)
    out[i] = counts[i];
  return static_cast<int>(counts.size());
}

}  // extern "C"
