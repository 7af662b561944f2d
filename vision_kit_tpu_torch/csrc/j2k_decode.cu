// JPEG 2000 Part 1 decoding (JP2 files and raw J2K codestreams) as host C++.
//
// Host code only (nvcc hands it to the host compiler, with -ffp-contract=off
// so that no multiply and add fuse); plain C interface, loaded with ctypes by
// data/jp2.py (decode_jp2_c). It is the counterpart of data/jp2.py's
// decode_jp2, the plain decoder, and gives the same pixels and the same
// refusals (the same messages): the server on the card decodes each JPEG
// 2000 body here, where the plain decoder's Python loops would take tens of
// seconds a 720p frame.
//
// The same stages in the same order, after OpenJPEG 2.5.3's files and
// OpenCV 5's grfmt_jpeg2000_openjpeg.cpp (jp2.py's docstring has the
// rules): the JP2 boxes (jp2.c); the main header and the tile-parts
// (j2k.c); tiles, resolutions, bands, precincts and code-blocks (tcd.c);
// the five progression orders (pi.c); packet headers with their tag trees
// (t2.c, tgt.c); the MQ decoder and the three coding passes with every
// code-block style (mqc.c, t1.c); dequantisation; the inverse 5/3 in int32
// and 9/7 in float32 (dwt.c); the RCT and ICT (mct.c); the DC level shift;
// then the JP2 palette and channel definitions and OpenCV's conversion to
// 8-bit RGB. Every read is bound-checked: a request body is untrusted.

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <new>
#include <stdexcept>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct Failure {
  std::string msg;
};

struct Unsupported {  // jp2.py's Jp2Unsupported: a video frame the mode does not convert
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{msg}; }

std::string S(long long v) { return std::to_string(v); }

std::atomic<long long> g_calls{0};

typedef std::vector<uint8_t> Bytes;

uint64_t be(const uint8_t* d, size_t n, size_t pos, int k) {
  if (pos + k > n) fail("the bytes end inside a field");
  uint64_t v = 0;
  for (int i = 0; i < k; ++i) v = (v << 8) | d[pos + i];
  return v;
}

int64_t cdiv(int64_t a, int64_t b) {  // Python's -(-a // b)
  int64_t q = (-a) / b, r = (-a) % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return -q;
}
int64_t cdivpow2(int64_t a, int b) { return -((-a) >> b); }

// -- jp2.c: the boxes -----------------------------------------------------

const int kSignature = 1, kFileType = 2, kHeader = 4;

struct Pclr {
  int nr_entries = 0, nr_channels = 0;
  std::vector<int64_t> entries;  // nr_entries x nr_channels
  std::vector<int> sizes;
  bool has_cmap = false;
  std::vector<std::array<int, 3>> cmap;  // cmp, mtyp, pcol
};

struct Jp2 {
  bool ihdr = false;
  int numcomps = 0;
  uint32_t ihdr_w = 0, ihdr_h = 0;
  bool has_colr = false;
  uint32_t enumcs = 0;
  bool has_pclr = false;
  Pclr pclr;
  bool has_cdef = false;
  std::vector<std::array<int, 3>> cdef;  // cn, typ, asoc
  size_t codestream = 0;
};

bool is_img_box(uint32_t k) {
  return k == 0x69686472 || k == 0x636f6c72 || k == 0x62706363 || k == 0x70636c72 ||
         k == 0x636d6170 || k == 0x63646566;  // ihdr colr bpcc pclr cmap cdef
}

const uint32_t kIhdr = 0x69686472, kColr = 0x636f6c72, kBpcc = 0x62706363,
               kPclrBox = 0x70636c72, kCmapBox = 0x636d6170, kCdefBox = 0x63646566,
               kJp = 0x6a502020, kFtyp = 0x66747970, kJp2h = 0x6a703268, kJp2c = 0x6a703263;

void img_box(Jp2& jp2, uint32_t kind, const uint8_t* b, size_t n) {
  if (kind == kIhdr) {
    if (jp2.ihdr) return;
    if (n != 14) fail("Bad image header box (bad size)");
    uint64_t hh = be(b, n, 0, 4), ww = be(b, n, 4, 4);
    int nc = (int)be(b, n, 8, 2);
    if (ww < 1 || hh < 1 || nc < 1)
      fail("Wrong values for: w(" + S((long long)ww) + ") h(" + S((long long)hh) +
           ") numcomps(" + S(nc) + ") (ihdr)");
    if (nc > 16384) fail("Invalid number of components (ihdr)");
    jp2.ihdr = true;
    jp2.numcomps = nc;
    jp2.ihdr_h = (uint32_t)be(b, n, 0, 4);
    jp2.ihdr_w = (uint32_t)be(b, n, 4, 4);
  } else if (kind == kColr) {
    if (n < 3) fail("Bad COLR header box (bad size)");
    if (jp2.has_colr) return;
    int meth = b[0];
    if (meth == 1) {
      if (n < 7) fail("Bad COLR header box (bad size)");
      jp2.enumcs = (uint32_t)be(b, n, 3, 4);
      jp2.has_colr = true;
    } else if (meth == 2) {
      jp2.has_colr = true;
    }
  } else if (kind == kBpcc) {
    if ((int)n != jp2.numcomps) fail("Bad BPCC header box (bad size)");
  } else if (kind == kPclrBox) {
    if (jp2.has_pclr || n < 3) fail("Invalid PCLR box");
    int nr_entries = (int)be(b, n, 0, 2), nr_channels = b[2];
    if (nr_entries == 0 || nr_entries > 1024)
      fail("Invalid PCLR box. Reports " + S(nr_entries) + " entries");
    if (nr_channels == 0) fail("Invalid PCLR box. Reports 0 palette columns");
    if (n < (size_t)(3 + nr_channels)) fail("Invalid PCLR box");
    Pclr& p = jp2.pclr;
    p.nr_entries = nr_entries, p.nr_channels = nr_channels;
    for (int i = 0; i < nr_channels; ++i) {
      p.sizes.push_back((b[3 + i] & 0x7F) + 1);
    }
    size_t pos = 3 + nr_channels;
    p.entries.assign((size_t)nr_entries * nr_channels, 0);
    for (int j = 0; j < nr_entries; ++j)
      for (int i = 0; i < nr_channels; ++i) {
        int k = std::min((p.sizes[i] + 7) >> 3, 4);
        if (pos + k > n) fail("Invalid PCLR box");
        p.entries[(size_t)j * nr_channels + i] = (int64_t)be(b, n, pos, k);
        pos += k;
      }
    jp2.has_pclr = true;
  } else if (kind == kCmapBox) {
    if (!jp2.has_pclr) fail("Need to read a PCLR box before the CMAP box.");
    if (jp2.pclr.has_cmap) fail("Only one CMAP box is allowed.");
    int nc = jp2.pclr.nr_channels;
    if (n < (size_t)4 * nc) fail("Insufficient data for CMAP box.");
    for (int i = 0; i < nc; ++i)
      jp2.pclr.cmap.push_back({(int)be(b, n, 4 * i, 2), b[4 * i + 2], b[4 * i + 3]});
    jp2.pclr.has_cmap = true;
  } else if (kind == kCdefBox) {
    if (jp2.has_cdef) fail("Only one CDEF box is allowed.");
    if (n < 2) fail("Insufficient data for CDEF box.");
    int cnt = (int)be(b, n, 0, 2);
    if (cnt == 0) fail("Number of channel description is equal to zero in CDEF box.");
    if (n < (size_t)(2 + 6 * cnt)) fail("Insufficient data for CDEF box.");
    for (int i = 0; i < cnt; ++i)
      jp2.cdef.push_back({(int)be(b, n, 2 + 6 * i, 2), (int)be(b, n, 4 + 6 * i, 2),
                          (int)be(b, n, 6 + 6 * i, 2)});
    jp2.has_cdef = true;
  }
}

// (length, type, header bytes) of the box at pos; false when fewer bytes
// than its header are left
bool box_header(const uint8_t* d, size_t end, size_t pos, uint64_t& length, uint32_t& kind,
                int& hdr) {
  if (pos + 8 > end) return false;
  length = be(d, end, pos, 4);
  kind = (uint32_t)be(d, end, pos + 4, 4);
  hdr = 8;
  if (length == 0) {
    length = end - pos;
  } else if (length == 1) {
    if (pos + 16 > end) return false;
    if (be(d, end, pos + 8, 4)) fail("Cannot handle box sizes higher than 2^32");
    length = be(d, end, pos + 12, 4);
    hdr = 16;
  }
  return true;
}

Jp2 read_jp2(const uint8_t* d, size_t end) {
  Jp2 jp2;
  size_t pos = 0;
  int state = 0, hdr = 8;
  uint64_t length;
  uint32_t kind;
  while (true) {
    if (!box_header(d, end, pos, length, kind, hdr)) fail("no codestream box");
    if (kind == kJp2c) {
      if (!(state & kHeader)) fail("bad placed jpeg codestream");
      break;
    }
    if (length < (uint64_t)hdr) fail("invalid box size " + S((long long)length));
    uint64_t size = length - hdr;
    size_t body_at = pos + hdr;
    uint64_t next = body_at + size;
    bool top = kind == kJp || kind == kFtyp || kind == kJp2h;
    if (!top && is_img_box(kind) && !(state & kHeader)) {
      if (next > end) fail("Problem with skipping JPEG2000 box, stream error");
      pos = (size_t)next;
      continue;
    }
    if (!top && !is_img_box(kind)) {
      if (!(state & kSignature))
        fail("Malformed JP2 file format: first box must be JPEG 2000 signature box");
      if (!(state & kFileType))
        fail("Malformed JP2 file format: second box must be file type box");
      if (next > end) fail("Problem with skipping JPEG2000 box, stream error");
      pos = (size_t)next;
      continue;
    }
    if (next > end) fail("Invalid box size " + S((long long)size) + " for a box");
    const uint8_t* body = d + body_at;
    size_t n = (size_t)size;
    pos = (size_t)next;
    if (kind == kJp) {
      if (state != 0) fail("The signature box must be the first box in the file.");
      if (n != 4) fail("Error with JP signature Box size");
      if (std::memcmp(body, "\r\n\x87\n", 4) != 0)
        fail("Error with JP Signature : bad magic number");
      state |= kSignature;
    } else if (kind == kFtyp) {
      if (state != kSignature) fail("The ftyp box must be the second box in the file.");
      if (n < 8 || ((n - 8) & 3)) fail("Error with FTYP signature Box size");
      state |= kFileType;
    } else if (kind == kJp2h) {
      if (!(state & kFileType)) fail("The  box must be the first box in the file.");
      bool has_ihdr = false;
      size_t at = 0;
      while (at < n) {
        if (n - at < 8) fail("Cannot handle box of less than 8 bytes");
        uint64_t sub_len = be(body, n, at, 4);
        uint32_t sub_kind = (uint32_t)be(body, n, at + 4, 4);
        uint64_t sub_hdr = 8;
        if (sub_len == 1) {
          if (n - at < 16) fail("Cannot handle XL box of less than 16 bytes");
          if (be(body, n, at + 8, 4)) fail("Cannot handle box sizes higher than 2^32");
          sub_len = be(body, n, at + 12, 4);
          sub_hdr = 16;
        } else if (sub_len == 0) {
          fail("Cannot handle box of undefined sizes");
        }
        if (sub_len < sub_hdr) fail("Box length is inconsistent.");
        if (sub_len > n - at)
          fail("Stream error while reading JP2 Header box: box length is inconsistent.");
        if (is_img_box(sub_kind))
          img_box(jp2, sub_kind, body + at + sub_hdr, (size_t)(sub_len - sub_hdr));
        has_ihdr |= sub_kind == kIhdr;
        at += (size_t)sub_len;
      }
      if (!has_ihdr) fail("Stream error while reading JP2 Header box: no 'ihdr' box.");
      state |= kHeader;
    } else {
      img_box(jp2, kind, body, n);
    }
  }
  if (!jp2.ihdr) fail("IHDR box missing. Required.");
  jp2.codestream = pos + hdr;
  return jp2;
}

// -- j2k.c: the codestream ---------------------------------------------------

const int SOC = 0xFF4F, SOT = 0xFF90, SOD = 0xFF93, EOC = 0xFFD9, SIZ = 0xFF51;
const int COD = 0xFF52, COC = 0xFF53, RGN = 0xFF5E, QCD = 0xFF5C, QCC = 0xFF5D, POC = 0xFF5F;
const int TLM = 0xFF55, PLM = 0xFF57, PLT = 0xFF58, PPM = 0xFF60, PPT = 0xFF61, CRG = 0xFF63,
          COM = 0xFF64;
const int CAP = 0xFF50, CPF = 0xFF59, MCT = 0xFF74, MCC = 0xFF75, MCO = 0xFF77, CBD = 0xFF78;
const int SOP = 0xFF91;
const int kMHSIZ = 2, kMH = 4, kTPHSOT = 8, kTPH = 16, kNEOC = 64, kEOC = 256;
const int LRCP = 0, RLCP = 1, RPCL = 2, PCRL = 3, CPRL = 4;
const int CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8, CBLK_SEGSYM = 32,
          CBLK_HT = 0x40, CBLK_HTMIXED = 0x80;
const int MAX_RLVLS = 33, MAX_BANDS = 3 * 33 - 2;

bool known(int m) {
  switch (m) {
    case SOT: case COD: case COC: case RGN: case QCD: case QCC: case POC: case SIZ:
    case TLM: case PLM: case PLT: case PPM: case PPT: case SOP: case CRG: case COM:
    case MCT: case CBD: case CAP: case CPF: case MCC: case MCO:
      return true;
  }
  return false;
}

int states(int m) {
  switch (m) {
    case SOT: return kMH | kTPHSOT;
    case COD: case COC: case RGN: case QCD: case QCC: case POC: case COM: case MCT:
    case MCC: case MCO:
      return kMH | kTPH;
    case SIZ: return kMHSIZ;
    case TLM: case PLM: case PPM: case CRG: case CBD: case CAP: case CPF: return kMH;
    case PLT: case PPT: return kTPH;
    case SOP: return 0;
  }
  return kMH | kTPH;
}

const char* refused(int m) {
  switch (m) {
    case CAP: return "High Throughput JPEG 2000 (Part 15, CAP marker)";
    case CPF: return "Part 15 CPF marker";
    case MCC: return "Part 2 multiple component transforms (MCC)";
    case MCO: return "Part 2 multiple component transforms (MCO)";
    case CBD: return "Part 2 component bit depth (CBD)";
  }
  return nullptr;
}

struct Tccp {
  int csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  int prcw[33], prch[33];
  int qntsty = 0, numgbits = 0, roishift = 0;
  int expn[MAX_BANDS], mant[MAX_BANDS];
  Tccp() {
    for (int i = 0; i < 33; ++i) prcw[i] = prch[i] = 15;
    for (int i = 0; i < MAX_BANDS; ++i) expn[i] = mant[i] = 0;
  }
};

struct Poc {
  int prg, resno0, compno0, layno1, resno1, compno1;
};

struct Tcp {
  int csty = 0, prg = 0, numlayers = 0, mct = 0;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::map<int, Bytes> ppt;  // Zppt -> the PPT marker's packet headers
  bool has_data = false;
  Bytes data;
  int part_number = -1, nb_parts = 0;
};

struct Comp {
  int prec, sgnd, dx, dy;
};

struct Cs {
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, tdx = 0, tdy = 0, tx0 = 0, ty0 = 0;
  int64_t tw = 0, th = 0;
  std::vector<Comp> comps;
  Tcp def;
  bool has_siz = false;
  int64_t ihdr_w = 0, ihdr_h = 0;
  std::map<int, Bytes> ppm;        // Zppm -> the PPM marker's body
  bool has_ppm_data = false;
  Bytes ppm_data;                  // merged; read on from tile to tile
  size_t ppm_pos = 0;
};

std::string size_refusal(int64_t w, int64_t h) {
  const int64_t kSide = 1 << 20, kPixels = (int64_t)1 << 30;
  if (w > kSide || h > kSide || w * h > kPixels)
    return S(w) + "x" + S(h) + ", over OpenCV's size limits";
  return "";
}

std::string opencv_refusal(const std::vector<Comp>& comps, int64_t x0, int64_t y0) {
  int n = (int)comps.size(), maxp = 0;
  for (int i = 0; i < n; ++i)
    if (comps[i].sgnd) return "OpenJPEG2000: Component " + S(i) + "/" + S(n) + " is signed";
  for (auto& c : comps) maxp = std::max(maxp, c.prec);
  if (maxp < 8) return "OpenJPEG2000: Precision < 8 not supported";
  for (auto& c : comps)
    if (c.dx != 1 || c.dy != 1 || x0 || y0)
      return "OpenJPEG2000: tiles are not supported (sub-sampled or offset components)";
  return "";
}

void read_siz(Cs& cs, const uint8_t* b, size_t n) {
  if (n < 36) fail("Error with SIZ marker size");
  if ((n - 36) % 3) fail("Error with SIZ marker size");
  int64_t x1 = be(b, n, 2, 4), y1 = be(b, n, 6, 4), x0 = be(b, n, 10, 4), y0 = be(b, n, 14, 4);
  int64_t tdx = be(b, n, 18, 4), tdy = be(b, n, 22, 4), tx0 = be(b, n, 26, 4),
          ty0 = be(b, n, 30, 4);
  int csiz = (int)be(b, n, 34, 2);
  if (csiz >= 16385 || csiz == 0)
    fail("Error with SIZ marker: number of component is illegal -> " + S(csiz));
  if ((size_t)csiz != (n - 36) / 3)
    fail("Error with SIZ marker: number of component is not compatible with the remaining "
         "number of parameters");
  if (x0 >= x1 || y0 >= y1) fail("Error with SIZ marker: negative or zero image size");
  if (cs.ihdr_w > 0 && cs.ihdr_h > 0 && (cs.ihdr_w != x1 - x0 || cs.ihdr_h != y1 - y0))
    fail("Error with SIZ marker: IHDR w(" + S(cs.ihdr_w) + ") h(" + S(cs.ihdr_h) +
         ") vs. SIZ w(" + S(x1 - x0) + ") h(" + S(y1 - y0) + ")");
  if (tdx == 0 || tdy == 0) fail("Error with SIZ marker: invalid tile size");
  if (tx0 > x0 || ty0 > y0 || tx0 + tdx <= x0 || ty0 + tdy <= y0)
    fail("Error with SIZ marker: illegal tile offset");
  std::vector<Comp> comps;
  for (int i = 0; i < csiz; ++i) {
    int ssiz = b[36 + 3 * i], dx = b[37 + 3 * i], dy = b[38 + 3 * i];
    int prec = (ssiz & 0x7F) + 1, sgnd = ssiz >> 7;
    if (!(1 <= dx && dx <= 255 && 1 <= dy && dy <= 255))
      fail("Invalid values for comp = " + S(i) + " : dx=" + S(dx) + " dy=" + S(dy) +
           " (should be between 1 and 255 according to the JPEG2000 norm)");
    if (prec > 31)
      fail("Invalid values for comp = " + S(i) + " : prec=" + S(prec) +
           " (should be between 1 and 38 according to the JPEG2000 norm. OpenJpeg only "
           "supports up to 31)");
    comps.push_back({prec, sgnd, dx, dy});
  }
  int64_t tw = cdiv(x1 - tx0, tdx), th = cdiv(y1 - ty0, tdy);
  if (tw == 0 || th == 0 || tw > 65535 / th)
    fail("Invalid number of tiles : " + S(tw) + " x " + S(th) +
         " (maximum fixed by jpeg2000 norm is 65535 tiles)");
  cs.x0 = x0, cs.y0 = y0, cs.x1 = x1, cs.y1 = y1, cs.tdx = tdx, cs.tdy = tdy;
  cs.tx0 = tx0, cs.ty0 = ty0, cs.tw = tw, cs.th = th;
  cs.comps = comps;
  cs.def = Tcp();
  cs.def.tccps.assign(csiz, Tccp());
  cs.has_siz = true;
}

size_t read_spcod(Tccp& t, const uint8_t* b, size_t n, size_t at) {
  if (n - at < 5 || at > n) fail("Error reading SPCod SPCoc element");
  t.numres = b[at] + 1;
  if (t.numres > MAX_RLVLS)
    fail("Invalid value for numresolutions : " + S(t.numres) +
         ", max value is set in openjpeg.h at " + S(MAX_RLVLS));
  t.cblkw = b[at + 1] + 2, t.cblkh = b[at + 2] + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
  t.cblksty = b[at + 3];
  if (t.cblksty & CBLK_HTMIXED)
    fail("Error reading SPCod SPCoc element. Unsupported Mixed HT code-block style found");
  t.qmfbid = b[at + 4];
  if (t.qmfbid > 1) fail("Error reading SPCod SPCoc element, Invalid transformation found");
  at += 5;
  if (t.csty & 1) {
    if (n - at < (size_t)t.numres) fail("Error reading SPCod SPCoc element");
    for (int i = 0; i < t.numres; ++i) {
      int v = b[at + i];
      if (i && ((v & 0xF) == 0 || (v >> 4) == 0)) fail("Invalid precinct size");
      t.prcw[i] = v & 0xF, t.prch[i] = v >> 4;
    }
    at += t.numres;
  } else {
    for (int i = 0; i < 33; ++i) t.prcw[i] = t.prch[i] = 15;
  }
  return at;
}

size_t read_sqcd(Tccp& t, const uint8_t* b, size_t n, size_t at) {
  if (at >= n) fail("Error reading SQcd or SQcc element");
  t.qntsty = b[at] & 0x1F, t.numgbits = b[at] >> 5;
  at += 1;
  size_t left = n - at;
  if (t.qntsty == 0) {
    for (size_t k = 0; k < left; ++k)
      if (k < (size_t)MAX_BANDS) t.expn[k] = b[at + k] >> 3, t.mant[k] = 0;
    at += left;
  } else {
    size_t nb = t.qntsty == 1 ? 1 : left / 2;
    if (left < 2 * nb) fail("Error reading SQcd or SQcc element");
    for (size_t k = 0; k < nb; ++k) {
      int v = (int)be(b, n, at + 2 * k, 2);
      if (k < (size_t)MAX_BANDS) t.expn[k] = v >> 11, t.mant[k] = v & 0x7FF;
    }
    at += 2 * nb;
  }
  if (t.qntsty == 1)
    for (int k = 1; k < MAX_BANDS; ++k)
      t.expn[k] = std::max(t.expn[0] - (k - 1) / 3, 0), t.mant[k] = t.mant[0];
  return at;
}

void read_marker(Cs& cs, int marker, const uint8_t* b, size_t n, Tcp* tcp) {
  int ncomp = (int)cs.comps.size();
  int room = ncomp <= 256 ? 1 : 2;
  const char* why = refused(marker);
  if (why) fail(std::string(why) + " is not decoded");
  if (marker == SIZ) {
    read_siz(cs, b, n);
  } else if (marker == COD) {
    if (n < 5) fail("Error reading COD marker");
    if (b[0] & ~7) fail("Unknown Scod value in COD marker");
    tcp->csty = b[0];
    tcp->prg = b[1] <= CPRL ? b[1] : -1;
    tcp->numlayers = (int)be(b, n, 2, 2);
    if (tcp->numlayers < 1)
      fail("Invalid number of layers in COD marker : " + S(tcp->numlayers) +
           " not in range [1-65535]");
    tcp->mct = b[4];
    if (tcp->mct > 1) fail("Invalid multiple component transformation");
    Tccp& t0 = tcp->tccps[0];
    t0.csty = tcp->csty & 1;
    if (read_spcod(t0, b, n, 5) != n) fail("Error reading COD marker");
    for (size_t i = 1; i < tcp->tccps.size(); ++i) {
      Tccp& t = tcp->tccps[i];
      t.csty = t0.csty, t.numres = t0.numres, t.cblkw = t0.cblkw, t.cblkh = t0.cblkh;
      t.cblksty = t0.cblksty, t.qmfbid = t0.qmfbid;
      std::memcpy(t.prcw, t0.prcw, sizeof t.prcw);
      std::memcpy(t.prch, t0.prch, sizeof t.prch);
    }
  } else if (marker == COC) {
    if (n < (size_t)room + 1) fail("Error reading COC marker");
    int c = (int)be(b, n, 0, room);
    if (c >= ncomp) fail("Error reading COC marker (bad number of components)");
    Tccp& t = tcp->tccps[c];
    t.csty = b[room];
    if (read_spcod(t, b, n, room + 1) != n) fail("Error reading COC marker");
  } else if (marker == QCD) {
    Tccp& t0 = tcp->tccps[0];
    if (read_sqcd(t0, b, n, 0) != n) fail("Error reading QCD marker");
    for (size_t i = 1; i < tcp->tccps.size(); ++i) {
      Tccp& t = tcp->tccps[i];
      t.qntsty = t0.qntsty, t.numgbits = t0.numgbits;
      std::memcpy(t.expn, t0.expn, sizeof t.expn);
      std::memcpy(t.mant, t0.mant, sizeof t.mant);
    }
  } else if (marker == QCC) {
    if (n < (size_t)room) fail("Error reading QCC marker");
    int c = (int)be(b, n, 0, room);
    if (c >= ncomp)
      fail("Invalid component number: " + S(c) + ", regarding the number of components " +
           S(ncomp));
    if (read_sqcd(tcp->tccps[c], b, n, room) != n) fail("Error reading QCC marker");
  } else if (marker == POC) {
    size_t size = 5 + 2 * room, cnt = n / size;
    if (cnt == 0 || n % size) fail("Error reading POC marker");
    long long total = (long long)(tcp->pocs.size() + cnt);
    if (total >= 32) fail("Too many POCs " + S(total));
    for (size_t i = 0; i < cnt; ++i) {
      size_t at = i * size;
      Poc p;
      p.resno0 = b[at], p.compno0 = (int)be(b, n, at + 1, room);
      p.layno1 = (int)be(b, n, at + 1 + room, 2), p.resno1 = b[at + 3 + room];
      p.compno1 = std::min((int)be(b, n, at + 4 + room, room), ncomp);
      p.prg = b[at + 4 + 2 * room];
      tcp->pocs.push_back(p);
    }
  } else if (marker == PPM) {
    if (n < 2) fail("Error reading PPM marker");
    if (cs.ppm.count(b[0])) fail("Zppm " + S(b[0]) + " already read");
    cs.ppm[b[0]] = Bytes(b + 1, b + n);
  } else if (marker == PPT) {
    if (n < 2) fail("Error reading PPT marker");
    if (!cs.ppm.empty())
      fail("Error reading PPT marker: packet header have been previously found in the main "
           "header (PPM marker).");
    if (tcp->ppt.count(b[0])) fail("Zppt " + S(b[0]) + " already read");
    tcp->ppt[b[0]] = Bytes(b + 1, b + n);
  } else if (marker == RGN) {
    if (n != (size_t)(2 + room)) fail("Error reading RGN marker");
    int c = (int)be(b, n, 0, room);
    if (c >= ncomp)
      fail("bad component number in RGN (" + S(c) + " when there are only " + S(ncomp) + ")");
    tcp->tccps[c].roishift = b[room + 1];
  } else if (marker == TLM) {
    if (n < 2) fail("Error reading TLM marker");
    int st = (b[1] >> 4) & 3, sp = (b[1] >> 6) & 1;
    if (st != 3 && (n - 2) % ((sp + 1) * 2 + st)) fail("Error reading TLM marker");  // ST 3: let go
  } else if (marker == PLM) {
    if (n < 1) fail("Error reading PLM marker");
  } else if (marker == PLT) {
    if (n < 1) fail("Error reading PLT marker");
    uint64_t packet_len = 0;
    for (size_t i = 1; i < n; ++i) {
      packet_len |= b[i] & 0x7F;
      packet_len = (b[i] & 0x80) ? packet_len << 7 : 0;
    }
    if (packet_len) fail("Error reading PLT marker");
  } else if (marker == CRG) {
    if (n != (size_t)4 * ncomp) fail("Error reading CRG marker");
  } else if (marker == MCT) {  // read, and of no effect: a COD's MCT field above 1 is refused
    if (n < 2) fail("Error reading MCT marker");
    if (be(b, n, 0, 2) == 0 && n <= 6) fail("Error reading MCT marker");
  }
}

// -- tcd.c: the tile's structure -----------------------------------------------

struct Bio;

struct TagTree {
  std::vector<int> parent, value, low;
  void build(int w, int h) {
    std::vector<std::pair<int, int>> sizes{{w, h}};
    while ((int64_t)w * h > 1) {
      w = (w + 1) >> 1, h = (h + 1) >> 1;
      sizes.push_back({w, h});
    }
    std::vector<int> base{0};
    for (auto& s : sizes) base.push_back(base.back() + s.first * s.second);
    parent.clear();
    for (size_t lv = 0; lv < sizes.size(); ++lv)
      for (int j = 0; j < sizes[lv].second; ++j)
        for (int i = 0; i < sizes[lv].first; ++i)
          parent.push_back(lv + 1 < sizes.size()
                               ? base[lv + 1] + (j >> 1) * sizes[lv + 1].first + (i >> 1)
                               : -1);
    reset();
  }
  void reset() {
    value.assign(parent.size(), 999);
    low.assign(parent.size(), 0);
  }
  int decode(Bio& bio, int leaf, int threshold);
};

struct Seg {
  int maxpasses = 0, numpasses = 0;
  int64_t len = 0;
  uint32_t newlen = 0;
  int numnewpasses = 0;
};

struct Cblk {
  int64_t x0, y0, x1, y1;
  uint32_t numbps = 0;
  int numlenbits = 0, numsegs = 0, numnewpasses = 0;
  std::vector<Seg> segs;
  Bytes data;  // the chunks, joined
};

struct Precinct {
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int orient;
  int64_t x0, y0, x1, y1;
  int numbps;
  float stepsize;
  int expn, mant;
  bool empty;
  std::vector<Precinct> precincts;
};

struct Res {
  int64_t x0, y0, x1, y1, pw, ph;
  int pdx, pdy;
  std::vector<Band> bands;
};

struct TComp {
  int64_t x0, y0, x1, y1;
  int numres, dx, dy;
  std::vector<Res> res;
};

struct Tile {
  int64_t x0, y0, x1, y1;
  std::vector<TComp> comps;
};

Tile tile_structure(const Cs& cs, const Tcp& tcp, int64_t tileno) {
  Tile tile;
  int64_t p = tileno % cs.tw, q = tileno / cs.tw;
  tile.x0 = std::max(cs.tx0 + p * cs.tdx, cs.x0);
  tile.y0 = std::max(cs.ty0 + q * cs.tdy, cs.y0);
  tile.x1 = std::min(cs.tx0 + (p + 1) * cs.tdx, cs.x1);
  tile.y1 = std::min(cs.ty0 + (q + 1) * cs.tdy, cs.y1);
  for (size_t c = 0; c < cs.comps.size(); ++c) {
    const Comp& comp = cs.comps[c];
    const Tccp& t = tcp.tccps[c];
    TComp tc;
    tc.x0 = cdiv(tile.x0, comp.dx), tc.y0 = cdiv(tile.y0, comp.dy);
    tc.x1 = cdiv(tile.x1, comp.dx), tc.y1 = cdiv(tile.y1, comp.dy);
    tc.numres = t.numres, tc.dx = comp.dx, tc.dy = comp.dy;
    for (int r = 0; r < t.numres; ++r) {
      int level = t.numres - 1 - r;
      Res res;
      res.x0 = cdivpow2(tc.x0, level), res.y0 = cdivpow2(tc.y0, level);
      res.x1 = cdivpow2(tc.x1, level), res.y1 = cdivpow2(tc.y1, level);
      res.pdx = t.prcw[r], res.pdy = t.prch[r];
      int pdx = res.pdx, pdy = res.pdy;
      int64_t px0 = (res.x0 >> pdx) << pdx, py0 = (res.y0 >> pdy) << pdy;
      int64_t px1 = cdivpow2(res.x1, pdx) << pdx, py1 = cdivpow2(res.y1, pdy) << pdy;
      res.pw = res.x0 == res.x1 ? 0 : (px1 - px0) >> pdx;
      res.ph = res.y0 == res.y1 ? 0 : (py1 - py0) >> pdy;
      if (res.pw && 0xFFFFFFFFLL / res.pw < res.ph) fail("Size of tile data exceeds system limits");
      int64_t cbgx, cbgy;
      int cbgw, cbgh, orients[3], norients;
      if (r == 0) {
        cbgx = px0, cbgy = py0, cbgw = pdx, cbgh = pdy;
        orients[0] = 0, norients = 1;
      } else {
        cbgx = cdivpow2(px0, 1), cbgy = cdivpow2(py0, 1), cbgw = pdx - 1, cbgh = pdy - 1;
        orients[0] = 1, orients[1] = 2, orients[2] = 3, norients = 3;
      }
      int cbw = std::min(t.cblkw, cbgw), cbh = std::min(t.cblkh, cbgh);
      for (int oi = 0; oi < norients; ++oi) {
        int orient = orients[oi];
        Band band;
        band.orient = orient;
        if (r == 0) {
          band.x0 = res.x0, band.y0 = res.y0, band.x1 = res.x1, band.y1 = res.y1;
        } else {
          int64_t xb = orient & 1, yb = orient >> 1;
          band.x0 = cdivpow2(tc.x0 - (xb << level), level + 1);
          band.y0 = cdivpow2(tc.y0 - (yb << level), level + 1);
          band.x1 = cdivpow2(tc.x1 - (xb << level), level + 1);
          band.y1 = cdivpow2(tc.y1 - (yb << level), level + 1);
        }
        int si = r == 0 ? 0 : 3 * (r - 1) + orient;
        int expn = t.expn[si], mant = t.mant[si];
        int gain = t.qmfbid == 0 ? 0 : (orient == 0 ? 0 : orient == 3 ? 2 : 1);
        band.stepsize = (float)((1.0 + mant / 2048.0) * std::ldexp(1.0, comp.prec + gain - expn));
        band.expn = expn, band.mant = mant;
        band.numbps = expn + t.numgbits - 1;
        band.empty = band.x0 == band.x1 || band.y0 == band.y1;
        int64_t nprec = res.pw * res.ph;
        band.precincts.resize((size_t)nprec);
        for (int64_t k = 0; k < nprec; ++k) {
          Precinct& prc = band.precincts[(size_t)k];
          int64_t gx0 = cbgx + (k % res.pw) * ((int64_t)1 << cbgw);
          int64_t gy0 = cbgy + (k / res.pw) * ((int64_t)1 << cbgh);
          int64_t x0 = std::max(gx0, band.x0), y0 = std::max(gy0, band.y0);
          int64_t x1 = std::min(gx0 + ((int64_t)1 << cbgw), band.x1);
          int64_t y1 = std::min(gy0 + ((int64_t)1 << cbgh), band.y1);
          int64_t cxs = (x0 >> cbw) << cbw, cys = (y0 >> cbh) << cbh;
          prc.x0 = x0, prc.y0 = y0, prc.x1 = x1, prc.y1 = y1;
          prc.cw = std::max((cdivpow2(x1, cbw) << cbw) - cxs, (int64_t)0) >> cbw;
          prc.ch = std::max((cdivpow2(y1, cbh) << cbh) - cys, (int64_t)0) >> cbh;
          for (int64_t i = 0; i < prc.cw * prc.ch; ++i) {
            int64_t kx0 = cxs + (i % prc.cw) * ((int64_t)1 << cbw);
            int64_t ky0 = cys + (i / prc.cw) * ((int64_t)1 << cbh);
            Cblk cb;
            cb.x0 = std::max(kx0, x0), cb.y0 = std::max(ky0, y0);
            cb.x1 = std::min(kx0 + ((int64_t)1 << cbw), x1);
            cb.y1 = std::min(ky0 + ((int64_t)1 << cbh), y1);
            prc.cblks.push_back(std::move(cb));
          }
          if (prc.cw && prc.ch) {
            prc.incl.build((int)prc.cw, (int)prc.ch);
            prc.imsb.build((int)prc.cw, (int)prc.ch);
          }
        }
        res.bands.push_back(std::move(band));
      }
      tc.res.push_back(std::move(res));
    }
    tile.comps.push_back(std::move(tc));
  }
  return tile;
}

// -- pi.c: the packet order ------------------------------------------------------

// (iterator: the POC record's index, layno, resno, compno, precno)
typedef std::function<void(int, int, int, int, int64_t)> PacketFn;

void packets(const Tile& tile, const Tcp& tcp, const PacketFn& fn) {
  const auto& comps = tile.comps;
  int ncomp = (int)comps.size(), nlayers = tcp.numlayers;
  int maxres = 0;
  for (auto& c : comps) maxres = std::max(maxres, c.numres);
  int64_t tx0 = tile.x0, ty0 = tile.y0, tx1 = tile.x1, ty1 = tile.y1;
  std::unordered_set<uint64_t> seen;
  auto once = [&](int l, int r, int c, int64_t k) {
    uint64_t key = (((uint64_t)l * 64 + r) * 16384 + c) * ((uint64_t)1 << 32) + (uint64_t)k;
    return seen.insert(key).second;
  };
  auto steps = [&](int c0, int c1, int64_t& dx, int64_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c) {
      const TComp& comp = comps[c];
      int nr = comp.numres;
      for (int r = 0; r < nr; ++r) {
        const Res& res = comp.res[r];
        int ex = res.pdx + nr - 1 - r, ey = res.pdy + nr - 1 - r;
        if (ex < 32) {
          int64_t v = (int64_t)comp.dx << ex;
          dx = !dx ? v : std::min(dx, v);
        }
        if (ey < 32) {
          int64_t v = (int64_t)comp.dy << ey;
          dy = !dy ? v : std::min(dy, v);
        }
      }
    }
  };
  auto precinct_at = [&](const TComp& comp, int r, int64_t x, int64_t y) -> int64_t {
    const Res& res = comp.res[r];
    int level = comp.numres - 1 - r;
    int64_t dxl = (int64_t)comp.dx << level, dyl = (int64_t)comp.dy << level;
    int64_t trx0 = cdiv(tx0, dxl), try0 = cdiv(ty0, dyl);
    int64_t trx1 = cdiv(tx1, dxl), try1 = cdiv(ty1, dyl);
    int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!(y % ((int64_t)comp.dy << rpy) == 0 ||
          (y == ty0 && (try0 << level) % ((int64_t)1 << rpy))))
      return -1;
    if (!(x % ((int64_t)comp.dx << rpx) == 0 ||
          (x == tx0 && (trx0 << level) % ((int64_t)1 << rpx))))
      return -1;
    if (res.pw == 0 || res.ph == 0 || trx0 == trx1 || try0 == try1) return -1;
    int64_t prci = (cdiv(x, dxl) >> res.pdx) - (trx0 >> res.pdx);
    int64_t prcj = (cdiv(y, dyl) >> res.pdy) - (try0 >> res.pdy);
    return prci + prcj * res.pw;
  };
  auto positions = [&](int64_t dx, int64_t dy, const std::function<void(int64_t, int64_t)>& f) {
    for (int64_t y = ty0; y < ty1; y += dy - y % dy)
      for (int64_t x = tx0; x < tx1; x += dx - x % dx) f(x, y);
  };
  // one progression's packets within its bounds (one opj_pi_next_* iterator)
  int pino = 0;
  auto progression = [&](const Poc& q) {
    int prg = q.prg, r0 = q.resno0, c0 = q.compno0, r1 = q.resno1, c1 = q.compno1;
    int nl = std::min(q.layno1, nlayers);
    if (c0 >= ncomp || c1 >= ncomp + 1) return;  // invalid compno0/compno1
    if (prg == LRCP || prg == RLCP) {
      std::vector<std::pair<int, int>> order;
      if (prg == LRCP) {
        for (int l = 0; l < nl; ++l)
          for (int r = r0; r < r1; ++r) order.push_back({l, r});
      } else {
        for (int r = r0; r < r1; ++r)
          for (int l = 0; l < nl; ++l) order.push_back({l, r});
      }
      for (auto& lr : order) {
        int l = lr.first, r = lr.second;
        for (int c = c0; c < c1; ++c) {
          if (r >= comps[c].numres) continue;
          const Res& res = comps[c].res[r];
          for (int64_t k = 0; k < res.pw * res.ph; ++k)
            if (once(l, r, c, k)) fn(pino, l, r, c, k);
        }
      }
    } else if (prg == RPCL || prg == PCRL) {
      int64_t dx, dy;
      steps(0, ncomp, dx, dy);
      if (!dx || !dy) return;
      if (prg == RPCL) {
        for (int r = r0; r < r1; ++r)
          positions(dx, dy, [&](int64_t x, int64_t y) {
            for (int c = c0; c < c1; ++c) {
              if (r >= comps[c].numres) continue;
              int64_t k = precinct_at(comps[c], r, x, y);
              if (k < 0) continue;
              for (int l = 0; l < nl; ++l)
                if (once(l, r, c, k)) fn(pino, l, r, c, k);
            }
          });
      } else {
        positions(dx, dy, [&](int64_t x, int64_t y) {
          for (int c = c0; c < c1; ++c)
            for (int r = r0; r < std::min(r1, comps[c].numres); ++r) {
              int64_t k = precinct_at(comps[c], r, x, y);
              if (k < 0) continue;
              for (int l = 0; l < nl; ++l)
                if (once(l, r, c, k)) fn(pino, l, r, c, k);
            }
        });
      }
    } else if (prg == CPRL) {
      for (int c = c0; c < c1; ++c) {
        int64_t dx, dy;
        steps(c, c + 1, dx, dy);
        if (!dx || !dy) return;
        positions(dx, dy, [&](int64_t x, int64_t y) {
          for (int r = r0; r < std::min(r1, comps[c].numres); ++r) {
            int64_t k = precinct_at(comps[c], r, x, y);
            if (k < 0) continue;
            for (int l = 0; l < nl; ++l)
              if (once(l, r, c, k)) fn(pino, l, r, c, k);
          }
        });
      }
    }
  };
  // one iterator per POC record, else the COD's progression over everything
  if (tcp.pocs.empty()) progression(Poc{tcp.prg, 0, 0, nlayers, maxres, ncomp});
  for (const Poc& q : tcp.pocs) {
    progression(q);
    ++pino;
  }
}

// whether OpenJPEG skips a packet rather than decoding it: no band of its
// resolution has that precinct in the area of interest, the whole tile with
// a margin of 2 (5/3) or 3 (9/7) (opj_tcd_is_subband_area_of_interest)
bool skipped(const TComp& comp, int resno, int64_t precno, int qmfbid) {
  int64_t margin = qmfbid == 1 ? 2 : 3;
  int nb = resno == 0 ? comp.numres - 1 : comp.numres - resno;
  for (const Band& band : comp.res[resno].bands) {
    int64_t xb = band.orient & 1, yb = band.orient >> 1;
    auto map = [&](int64_t t, int64_t b) -> int64_t {
      if (nb == 0) return t;
      int64_t off = ((int64_t)1 << (nb - 1)) * b;
      return t <= off ? 0 : cdivpow2(t - off, nb);
    };
    int64_t bx0 = std::max(map(comp.x0, xb) - margin, (int64_t)0);
    int64_t by0 = std::max(map(comp.y0, yb) - margin, (int64_t)0);
    int64_t bx1 = map(comp.x1, xb) + margin, by1 = map(comp.y1, yb) + margin;
    const Precinct& prc = band.precincts[(size_t)precno];
    if (prc.x0 < bx1 && prc.y0 < by1 && prc.x1 > bx0 && prc.y1 > by0) return false;
  }
  return true;
}

// -- t2.c: packets -------------------------------------------------------------------

struct Bio {
  const uint8_t* data;
  size_t bp, end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* d, size_t start, size_t e) : data(d), bp(start), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= data[bp++];
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      if (ct == 0) bytein();
      --ct;
      v = (v << 1) | ((buf >> ct) & 1);
    }
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

int TagTree::decode(Bio& bio, int leaf, int threshold) {
  int stack[64], sp = 0, node = leaf;
  while (parent[node] >= 0) {
    stack[sp++] = node;
    node = parent[node];
  }
  int lw = 0;
  while (true) {
    if (lw > low[node]) low[node] = lw;
    else lw = low[node];
    while (lw < threshold && lw < value[node]) {
      if (bio.read(1)) value[node] = lw;
      else ++lw;
    }
    low[node] = lw;
    if (!sp) break;
    node = stack[--sp];
  }
  return value[node] < threshold ? 1 : 0;
}

int numpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  int n = (int)bio.read(2);
  if (n != 3) return 3 + n;
  n = (int)bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + (int)bio.read(7);
}

void init_seg(Cblk& cb, int index, int cblksty, bool first) {
  if ((int)cb.segs.size() <= index) cb.segs.resize(index + 1);
  int maxpasses;
  if (cblksty & CBLK_TERMALL) maxpasses = 1;
  else if (cblksty & CBLK_LAZY) {
    if (first) maxpasses = 10;
    else maxpasses = (cb.segs[index - 1].maxpasses == 1 || cb.segs[index - 1].maxpasses == 10)
                         ? 2 : 1;
  } else {
    maxpasses = 109;
  }
  cb.segs[index] = Seg();
  cb.segs[index].maxpasses = maxpasses;
}

size_t eph_after(const uint8_t* src, size_t pos, size_t end, int eph) {
  if (eph) {
    if (end - pos < 2) fail("Not enough space for required EPH marker");
    if (src[pos] != 0xFF || src[pos + 1] != 0x92) fail("Expected EPH marker");
    pos += 2;
  }
  return pos;
}

// raises each component's resno_decoded in `decoded` to its decoded
// packets' resolutions; where an iterator's packets of a component are all
// skipped so far and resno_decoded is 0, it becomes the component's top
// resolution (OpenJPEG's first_pass_failed). `hdr` (with its read position
// `hpos_io`, advanced) holds the packet headers where PPM or PPT markers
// packed them; null for none
void decode_packets(Tile& tile, const Tcp& tcp, const Bytes& data, std::vector<int>& decoded,
                    const Bytes* hdr, size_t* hpos_io) {
  const uint8_t* src = data.data();
  size_t pos = 0, end = data.size();
  int sop = tcp.csty & 2, eph = tcp.csty & 4;
  int iterator = -1;
  std::vector<bool> first_pass_failed;
  packets(tile, tcp, [&](int pino, int layno, int resno, int compno, int64_t precno) {
    const TComp& comp = tile.comps[compno];
    if (pino != iterator) {
      iterator = pino;
      first_pass_failed.assign(tile.comps.size(), true);
    }
    if (skipped(comp, resno, precno, tcp.tccps[compno].qmfbid)) {
      if (decoded[compno] == 0 && first_pass_failed[compno]) decoded[compno] = comp.numres - 1;
    } else {
      first_pass_failed[compno] = false;
      decoded[compno] = std::max(decoded[compno], resno);
    }
    Res& res = tile.comps[compno].res[resno];
    int cblksty = tcp.tccps[compno].cblksty;
    if (layno == 0) {
      for (Band& band : res.bands) {
        if (band.empty) continue;
        if (precno >= (int64_t)band.precincts.size()) fail("Invalid precinct");
        Precinct& prc = band.precincts[(size_t)precno];
        if (prc.cw && prc.ch) {
          prc.incl.reset();
          prc.imsb.reset();
        }
        for (Cblk& cb : prc.cblks) cb.numsegs = 0;
      }
    }
    if (sop && end - pos >= 6 && src[pos] == 0xFF && src[pos + 1] == 0x91) pos += 6;
    const uint8_t* hsrc = hdr ? hdr->data() : src;
    size_t hpos = hdr ? *hpos_io : pos, hend = hdr ? hdr->size() : end;
    Bio bio(hsrc, hpos, hend);
    if (!bio.read(1)) {
      bio.inalign();
      hpos = eph_after(hsrc, bio.bp, hend, eph);
      if (hdr) *hpos_io = hpos;
      else pos = hpos;
      return;
    }
    for (Band& band : res.bands) {
      if (band.empty) continue;
      Precinct& prc = band.precincts[(size_t)precno];
      for (size_t k = 0; k < prc.cblks.size(); ++k) {
        Cblk& cb = prc.cblks[k];
        int included = cb.numsegs ? (int)bio.read(1) : prc.incl.decode(bio, (int)k, layno + 1);
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          int i = 0;
          while (!prc.imsb.decode(bio, (int)k, i)) ++i;
          cb.numbps = (uint32_t)(band.numbps + 1 - i);
          cb.numlenbits = 3;
        }
        cb.numnewpasses = numpasses(bio);
        int increment = 0;
        while (bio.read(1)) ++increment;
        cb.numlenbits += increment;
        int segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        }
        int n = cb.numnewpasses;
        while (true) {
          Seg& seg = cb.segs[segno];
          seg.numnewpasses = std::min(seg.maxpasses - seg.numpasses, n);
          int floorlog2 = 0;
          for (int v = seg.numnewpasses; v > 1; v >>= 1) ++floorlog2;
          int bits = cb.numlenbits + floorlog2;
          if (bits > 32)
            fail("Invalid bit number " + S(bits) + " in opj_t2_read_packet_header()");
          seg.newlen = bio.read(bits);
          n -= seg.numnewpasses;
          if (n <= 0) break;
          ++segno;
          init_seg(cb, segno, cblksty, false);
        }
      }
    }
    bio.inalign();
    hpos = eph_after(hsrc, bio.bp, hend, eph);
    if (hdr) *hpos_io = hpos;
    else pos = hpos;
    for (Band& band : res.bands) {
      if (band.empty) continue;
      Precinct& prc = band.precincts[(size_t)precno];
      for (Cblk& cb : prc.cblks) {
        if (!cb.numnewpasses) continue;
        int segno;
        if (!cb.numsegs) {
          segno = 0;
          cb.numsegs = 1;
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            ++cb.numsegs;
          }
        }
        while (true) {
          Seg& seg = cb.segs[segno];
          if (pos + seg.newlen > end)
            fail("read: segment too long (" + S(seg.newlen) + ") with max (" + S(end - pos) +
                 ") for codeblock");
          cb.data.insert(cb.data.end(), src + pos, src + pos + seg.newlen);
          pos += seg.newlen;
          seg.len += seg.newlen;
          seg.numpasses += seg.numnewpasses;
          cb.numnewpasses -= seg.numnewpasses;
          if (cb.numnewpasses <= 0) break;
          ++segno;
          ++cb.numsegs;
        }
      }
    }
  });
}

// -- mqc.c and t1.c: code-blocks -------------------------------------------------

const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1};
const int CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18;
// neighbour bits: NW N NE W E SW S SE, then the signs of N, W, E, S
const int NW = 1, N_ = 2, NE = 4, W_ = 8, E_ = 16, SW = 32, S_ = 64, SE = 128;
const int SGN_N = 256, SGN_W = 512, SGN_E = 1024, SGN_S = 2048;

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc_ctx[4096], sc_xor[4096];
  Luts() {
    for (int orient = 0; orient < 4; ++orient)
      for (int f = 0; f < 256; ++f) {
        int h = !!(f & W_) + !!(f & E_), v = !!(f & N_) + !!(f & S_);
        int d = !!(f & NW) + !!(f & NE) + !!(f & SW) + !!(f & SE), n;
        if (orient == 1) std::swap(h, v);
        if (orient == 3) {
          int hv = h + v;
          if (!d) n = !hv ? 0 : hv == 1 ? 1 : 2;
          else if (d == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
          else if (d == 2) n = !hv ? 6 : 7;
          else n = 8;
        } else if (!h) {
          n = !v ? (!d ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
        } else if (h == 1) {
          n = !v ? (!d ? 5 : 6) : 7;
        } else {
          n = 8;
        }
        zc[orient][f] = (uint8_t)(CTX_ZC + n);
      }
    for (int f = 0; f < 4096; ++f) {
      auto contrib = [&](int sig, int neg) { return !(f & sig) ? 0 : (f & neg) ? -1 : 1; };
      int h = std::max(-1, std::min(1, contrib(W_, SGN_W) + contrib(E_, SGN_E)));
      int v = std::max(-1, std::min(1, contrib(N_, SGN_N) + contrib(S_, SGN_S)));
      int x = 0;
      if (h < 0) h = -h, v = -v, x = 1;
      else if (h == 0 && v < 0) v = -v, x = 1;
      int ctx = h == 0 ? (v == 0 ? 0 : 1) : (v == -1 ? 2 : v == 0 ? 3 : 4);
      sc_ctx[f] = (uint8_t)(CTX_SC + ctx), sc_xor[f] = (uint8_t)x;
    }
  }
};

const Luts& luts() {
  static const Luts l;
  return l;
}

struct Mqc {
  Bytes buf;
  size_t bp = 0;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t st[19];  // 2 * state + mps
  void reset_states() {
    std::memset(st, 0, sizeof st);
    st[CTX_UNI] = 2 * 46, st[CTX_AGG] = 2 * 3, st[CTX_ZC] = 2 * 4;
  }
  void load(const uint8_t* seg, size_t n) {
    buf.assign(seg, seg + n);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    bp = 0;
  }
  void init(const uint8_t* seg, size_t n) {
    load(seg, n);
    c = (uint32_t)buf[0] << 16;
    ct = 0;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const uint8_t* seg, size_t n) {
    load(seg, n);
    c = 0, ct = 0;
  }
  void bytein() {
    uint32_t nxt = buf[bp + 1];
    if (buf[bp] == 0xFF) {
      if (nxt > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += nxt << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += nxt << 8;
      ct = 8;
    }
  }
  int decode(int cx) {
    int s = st[cx], d;
    uint32_t qe = kQe[s >> 1];
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = s & 1;
        st[cx] = (uint8_t)(2 * kNmps[s >> 1] + (s & 1));
      } else {
        d = (s & 1) ^ 1;
        st[cx] = (uint8_t)(2 * kNlps[s >> 1] + ((s & 1) ^ kSwitch[s >> 1]));
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return s & 1;
      if (a < qe) {
        d = (s & 1) ^ 1;
        st[cx] = (uint8_t)(2 * kNlps[s >> 1] + ((s & 1) ^ kSwitch[s >> 1]));
      } else {
        d = s & 1;
        st[cx] = (uint8_t)(2 * kNmps[s >> 1] + (s & 1));
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
    return d;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (buf[bp] > 0x8F) {
          c = 0xFF, ct = 8;
        } else {
          c = buf[bp++];
          ct = 7;
        }
      } else {
        c = buf[bp++];
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// (h, w) coefficients of one code-block with OpenJPEG's extra low bit
void t1_decode(const Cblk& cb, int orient, int cblksty, int roishift, std::vector<int32_t>& out,
               int& w, int& h) {
  w = (int)(cb.x1 - cb.x0), h = (int)(cb.y1 - cb.y0);
  int32_t bpno_plus_one = (int32_t)((uint32_t)roishift + cb.numbps);
  if (bpno_plus_one >= 31)
    fail("opj_t1_decode_cblk(): unsupported bpno_plus_one = " + S(bpno_plus_one) + " >= 31");
  int W = w + 2;
  size_t size = (size_t)W * (h + 2);
  std::vector<int32_t> data(size, 0);
  std::vector<uint16_t> nb(size, 0);
  std::vector<uint8_t> flag(size, 0);
  Mqc mqc;
  mqc.reset_states();
  const Luts& L = luts();
  const uint8_t* zc = L.zc[orient];
  bool vsc = cblksty & CBLK_VSC;
  int32_t numbps = (int32_t)cb.numbps;
  size_t index = 0;
  int passtype = 2;
  auto significant = [&](size_t p, int y, int neg) {
    flag[p] |= 1;
    nb[p - 1] |= E_ | (neg ? SGN_E : 0);
    nb[p + 1] |= W_ | (neg ? SGN_W : 0);
    if (!(vsc && (y & 3) == 0)) {
      size_t q = p - W;
      nb[q] |= S_ | (neg ? SGN_S : 0);
      nb[q - 1] |= SE;
      nb[q + 1] |= SW;
    }
    size_t q = p + W;
    nb[q] |= N_ | (neg ? SGN_N : 0);
    nb[q - 1] |= NE;
    nb[q + 1] |= NW;
  };
  for (int segno = 0; segno < cb.numsegs; ++segno) {
    const Seg& seg = cb.segs[segno];
    bool raw = bpno_plus_one <= numbps - 4 && passtype < 2 && (cblksty & CBLK_LAZY);
    size_t len = (size_t)std::min<int64_t>(seg.len, (int64_t)cb.data.size() - (int64_t)index);
    const uint8_t* segdata = cb.data.data() + index;
    index += len;
    if (raw) mqc.raw_init(segdata, len);
    else mqc.init(segdata, len);
    for (int pass = 0; pass < seg.numpasses; ++pass) {
      if (bpno_plus_one < 1) break;
      int32_t one = (int32_t)1 << bpno_plus_one, half = one >> 1, oph = one | half;
      if (passtype == 0) {
        for (int y0 = 0; y0 < h; y0 += 4)
          for (int x = 0; x < w; ++x) {
            size_t p = (size_t)(y0 + 1) * W + x + 1;
            for (int y = y0; y < std::min(y0 + 4, h); ++y, p += W) {
              if (!flag[p] && (nb[p] & 0xFF)) {
                int v = raw ? mqc.raw() : mqc.decode(zc[nb[p] & 0xFF]);
                if (v) {
                  int neg = raw ? mqc.raw()
                                : (mqc.decode(L.sc_ctx[nb[p] & 0xFFF]) ^ L.sc_xor[nb[p] & 0xFFF]);
                  data[p] = neg ? -oph : oph;
                  significant(p, y, neg);
                }
                flag[p] |= 2;
              }
            }
          }
      } else if (passtype == 1) {
        for (int y0 = 0; y0 < h; y0 += 4)
          for (int x = 0; x < w; ++x) {
            size_t p = (size_t)(y0 + 1) * W + x + 1;
            for (int y = y0; y < std::min(y0 + 4, h); ++y, p += W) {
              int f = flag[p];
              if ((f & 3) == 1) {
                int v = raw ? mqc.raw()
                            : mqc.decode((f & 4) ? CTX_MAG + 2
                                         : (nb[p] & 0xFF) ? CTX_MAG + 1 : CTX_MAG);
                int32_t val = data[p];
                data[p] = val + ((v ^ (val < 0)) ? half : -half);
                flag[p] = (uint8_t)(f | 4);
              }
            }
          }
      } else {
        for (int y0 = 0; y0 < h; y0 += 4) {
          bool full = y0 + 4 <= h;
          for (int x = 0; x < w; ++x) {
            size_t p = (size_t)(y0 + 1) * W + x + 1;
            int y = y0;
            if (full && !(flag[p] || nb[p] || flag[p + W] || nb[p + W] || flag[p + 2 * W] ||
                          nb[p + 2 * W] || flag[p + 3 * W] || nb[p + 3 * W])) {
              if (!mqc.decode(CTX_AGG)) continue;
              int run = mqc.decode(CTX_UNI) << 1;
              run |= mqc.decode(CTX_UNI);
              p += (size_t)run * W;
              y += run;
              int neg = mqc.decode(L.sc_ctx[nb[p] & 0xFFF]) ^ L.sc_xor[nb[p] & 0xFFF];
              data[p] = neg ? -oph : oph;
              significant(p, y, neg);
              p += W;
              ++y;
            }
            for (; y < std::min(y0 + 4, h); ++y, p += W) {
              if (!(flag[p] & 3)) {
                if (mqc.decode(zc[nb[p] & 0xFF])) {
                  int neg = mqc.decode(L.sc_ctx[nb[p] & 0xFFF]) ^ L.sc_xor[nb[p] & 0xFFF];
                  data[p] = neg ? -oph : oph;
                  significant(p, y, neg);
                }
              }
            }
            p = (size_t)(y0 + 1) * W + x + 1;
            for (int yy = y0; yy < std::min(y0 + 4, h); ++yy, p += W) flag[p] &= ~2;
          }
        }
        if (cblksty & CBLK_SEGSYM)
          for (int k = 0; k < 4; ++k) mqc.decode(CTX_UNI);
      }
      if ((cblksty & CBLK_RESET) && !raw) mqc.reset_states();
      if (++passtype == 3) {
        passtype = 0;
        --bpno_plus_one;
      }
    }
  }
  out.resize((size_t)w * h);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) out[(size_t)y * w + x] = data[(size_t)(y + 1) * W + x + 1];
  if (roishift) {
    if (roishift >= 31) {
      std::fill(out.begin(), out.end(), 0);
    } else {
      int32_t thresh = (int32_t)1 << roishift;
      for (auto& v : out) {
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
}

// -- dwt.c: the inverse transforms ------------------------------------------------

const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
// libavcodec's jpeg2000dwt.h: the same K, and its inverse (not 2 / K)
const float kLibavK = 1.230174104914001f, kLibavX = 0.812893066115961f;

// jp2.py's libav_stepsize: libavcodec's init_band_stepsize for its float 9/7.
float libav_stepsize(int prec, int expn, int mant, int orient, int r, int numres) {
  float f = (float)std::ldexp(1.0, prec - expn);
  f = (float)((double)f * (mant / 2048.0 + 1.0));
  int lband = orient == 1 || orient == 2;
  if (lband) f = f * (kLibavX * 2.0f);
  else if (orient == 3) f = f * (kLibavX * kLibavX * 4.0f);
  f = (float)((double)f * std::pow((double)kLibavK, 2 * (numres - r) + lband - 2));
  return f * 0.5f;
}
const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
            kDelta = 0.443506852f;

inline int32_t wadd(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t wsub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }

// the inverse 5/3 of n samples in[0..n) (low first, then high), written
// interleaved to out
void idwt53_1d(const int32_t* in, int32_t* out, int n, int sn, int cas) {
  int dn = n - sn;
  if (n == 1) {
    out[0] = cas ? in[0] / 2 : in[0];
    return;
  }
  const int32_t* low = in;
  const int32_t* high = in + sn;
  std::vector<int32_t> even(sn);
  if (cas == 0) {
    for (int i = 0; i < sn; ++i) {
      int32_t hl = high[i == 0 ? 0 : i - 1], hr = high[i < dn ? i : dn - 1];
      even[i] = wsub(low[i], wadd(wadd(hl, hr), 2) >> 2);
    }
    for (int i = 0; i < dn; ++i) {
      int32_t er = even[i + 1 < sn ? i + 1 : sn - 1];
      out[2 * i + 1] = wadd(high[i], wadd(even[i], er) >> 1);
    }
    for (int i = 0; i < sn; ++i) out[2 * i] = even[i];
  } else {
    for (int i = 0; i < sn; ++i) {
      int32_t hr = high[i + 1 < dn ? i + 1 : dn - 1];
      even[i] = wsub(low[i], wadd(wadd(high[i], hr), 2) >> 2);
    }
    for (int i = 0; i < dn; ++i) {
      int32_t el = even[i == 0 ? 0 : i - 1], er = even[i < sn ? i : sn - 1];
      out[2 * i] = wadd(high[i], wadd(el, er) >> 1);
    }
    for (int i = 0; i < sn; ++i) out[2 * i + 1] = even[i];
  }
}

// `libav`: libavcodec's sr_1d97_float (no band scaling; a lone sample times
// X, or K / 2 at an odd start).
void idwt97_1d(const float* in, float* x, int n, int sn, int cas, bool libav) {
  int dn = n - sn, la, lb;
  if (cas == 0) {
    for (int i = 0; i < sn; ++i) x[2 * i] = in[i];
    for (int i = 0; i < dn; ++i) x[2 * i + 1] = in[sn + i];
    la = 0, lb = 1;
  } else {
    for (int i = 0; i < sn; ++i) x[2 * i + 1] = in[i];
    for (int i = 0; i < dn; ++i) x[2 * i] = in[sn + i];
    la = 1, lb = 0;
  }
  if (n <= 1) {
    if (libav && n) x[0] = x[0] * (cas == 0 ? kLibavX : kLibavK / 2.0f);
    return;
  }
  if (!libav) {
    for (int i = la; i < n; i += 2) x[i] = x[i] * kK;
    for (int i = lb; i < n; i += 2) x[i] = x[i] * kTwoInvK;
  }
  auto step2 = [&](int tgt, int count, int m, float c) {
    int full = std::min(count, m);
    for (int i = 0; i < full; ++i) {
      int idx = tgt + 2 * i;
      int left = idx - 1 < 0 ? idx + 1 : idx - 1;
      float s = x[left] + x[idx + 1];
      float p = s * c;
      x[idx] = x[idx] + p;
    }
    if (m < count) {
      int i = tgt + 2 * m;
      float c2 = c + c;
      float p = x[i - 1] * c2;
      x[i] = x[i] + p;
    }
  };
  step2(la, sn, std::min(sn, dn - la), -kDelta);
  step2(lb, dn, std::min(dn, sn - lb), -kGamma);
  step2(la, sn, std::min(sn, dn - la), -kBeta);
  step2(lb, dn, std::min(dn, sn - lb), -kAlpha);
}

// up to resolution `top`
template <typename T, typename F>
void idwt(std::vector<T>& tc, int64_t stride, const TComp& comp, int top, F one) {
  const auto& res = comp.res;
  int64_t rw = res[0].x1 - res[0].x0, rh = res[0].y1 - res[0].y0;
  std::vector<T> in, out;
  for (int r = 1; r <= top; ++r) {
    int64_t snh = rw, snv = rh;
    rw = res[r].x1 - res[r].x0, rh = res[r].y1 - res[r].y0;
    if (!rw || !rh) continue;
    in.resize(std::max(rw, rh)), out.resize(std::max(rw, rh));
    for (int64_t j = 0; j < rh; ++j) {
      T* row = tc.data() + j * stride;
      std::copy(row, row + rw, in.begin());
      one(in.data(), out.data(), (int)rw, (int)snh, (int)(res[r].x0 & 1));
      std::copy(out.begin(), out.begin() + rw, row);
    }
    for (int64_t i = 0; i < rw; ++i) {
      for (int64_t j = 0; j < rh; ++j) in[j] = tc[j * stride + i];
      one(in.data(), out.data(), (int)rh, (int)snv, (int)(res[r].y0 & 1));
      for (int64_t j = 0; j < rh; ++j) tc[j * stride + i] = out[j];
    }
  }
}

// -- tcd.c: one tile ----------------------------------------------------------------

struct Plane {
  bool reversible;
  int64_t w = 0, h = 0;
  std::vector<int32_t> i;
  std::vector<float> f;
};

void decode_tile(Cs& cs, Tcp& tcp, int64_t tileno, std::vector<std::vector<int32_t>>& image,
                 bool video) {
  if (tcp.prg < 0 && tcp.pocs.empty()) fail("Unknown progression order in COD marker");
  Tile tile = tile_structure(cs, tcp, tileno);
  for (const Tccp& t : tcp.tccps)
    if (t.cblksty & CBLK_HT)
      fail("High Throughput JPEG 2000 (Part 15) code-blocks are not decoded");
  std::vector<int> decoded(tile.comps.size(), 0);  // resno_decoded, per tile
  // PPM's headers run on from tile to tile; PPT's are the tile's own
  Bytes ppt;
  size_t ppt_pos = 0;
  const Bytes* hdr = nullptr;
  size_t* hpos = nullptr;
  if (cs.has_ppm_data) {
    hdr = &cs.ppm_data, hpos = &cs.ppm_pos;
  } else if (!tcp.ppt.empty()) {
    for (const auto& kv : tcp.ppt) ppt.insert(ppt.end(), kv.second.begin(), kv.second.end());
    hdr = &ppt, hpos = &ppt_pos;
  }
  decode_packets(tile, tcp, tcp.data, decoded, hdr, hpos);
  std::vector<int> tops;
  for (size_t c = 0; c < tile.comps.size(); ++c)
    tops.push_back(std::min(decoded[c], tile.comps[c].numres - 1));
  std::vector<Plane> planes;
  std::vector<int32_t> vals;
  for (size_t c = 0; c < tile.comps.size(); ++c) {
    const Tccp& t = tcp.tccps[c];
    const TComp& comp = tile.comps[c];
    Plane pl;
    pl.reversible = t.qmfbid == 1;
    const Res& top = comp.res.back();
    pl.w = top.x1 - top.x0, pl.h = top.y1 - top.y0;
    if (pl.reversible) pl.i.assign((size_t)(pl.w * pl.h), 0);
    else pl.f.assign((size_t)(pl.w * pl.h), 0.0f);
    for (int r = 0; r < comp.numres; ++r) {
      const Res& res = comp.res[r];
      for (const Band& band : res.bands) {
        if (band.empty) continue;
        int64_t ox = band.x0, oy = band.y0;
        if (band.orient & 1) ox -= comp.res[r - 1].x1 - comp.res[r - 1].x0;
        if (band.orient & 2) oy -= comp.res[r - 1].y1 - comp.res[r - 1].y0;
        float step = video && !pl.reversible
                         ? libav_stepsize(cs.comps[c].prec, band.expn, band.mant, band.orient, r,
                                          comp.numres)
                         : 0.5f * band.stepsize;
        for (const Precinct& prc : band.precincts)
          for (const Cblk& cb : prc.cblks) {
            int w, h;
            t1_decode(cb, band.orient, t.cblksty, t.roishift, vals, w, h);
            int64_t ys = cb.y0 - oy, xs = cb.x0 - ox;
            for (int y = 0; y < h; ++y)
              for (int x = 0; x < w; ++x) {
                int32_t v = vals[(size_t)y * w + x];
                size_t at = (size_t)((ys + y) * pl.w + xs + x);
                if (pl.reversible) pl.i[at] = v / 2;
                else pl.f[at] = (float)v * step;
              }
          }
      }
    }
    if (pl.reversible) idwt(pl.i, pl.w, comp, tops[c], idwt53_1d);
    else
      idwt(pl.f, pl.w, comp, tops[c], [video](const float* in, float* x, int n, int sn, int cas) {
        idwt97_1d(in, x, n, sn, cas, video);
      });
    planes.push_back(std::move(pl));
  }
  if (tcp.mct && planes.size() >= 3) {
    const auto& tc = tile.comps;
    if (tc[0].numres != tc[1].numres || tc[0].numres != tc[2].numres ||
        decoded[0] != decoded[1] || decoded[0] != decoded[2] ||
        !(planes[0].w == planes[1].w && planes[0].h == planes[1].h && planes[0].w == planes[2].w &&
          planes[0].h == planes[2].h))
      fail("Tiles don't all have the same dimension. Skip the MCT step.");
    size_t n = (size_t)(planes[0].w * planes[0].h);
    if (tcp.tccps[0].qmfbid == 1) {
      if (!planes[1].reversible || !planes[2].reversible)
        fail("an MCT over components of both transforms is not decoded");
      int32_t *y = planes[0].i.data(), *u = planes[1].i.data(), *v = planes[2].i.data();
      for (size_t k = 0; k < n; ++k) {
        int32_t g = wsub(y[k], wadd(u[k], v[k]) >> 2);
        int32_t r = wadd(v[k], g), b = wadd(u[k], g);
        y[k] = r, u[k] = g, v[k] = b;
      }
    } else {
      if (planes[1].reversible || planes[2].reversible)
        fail("an MCT over components of both transforms is not decoded");
      float *y = planes[0].f.data(), *u = planes[1].f.data(), *v = planes[2].f.data();
      for (size_t k = 0; k < n; ++k) {
        float yy = y[k], uu = u[k], vv = v[k];
        float r = yy + vv * 1.402f;
        float g1 = yy - uu * 0.34413f;
        float g = g1 - vv * 0.71414f;
        float b = yy + uu * 1.772f;
        y[k] = r, u[k] = g, v[k] = b;
      }
    }
  }
  for (size_t c = 0; c < tile.comps.size(); ++c) {
    const Comp& info = cs.comps[c];
    const TComp& comp = tile.comps[c];
    int prec = info.prec;
    int64_t lo = info.sgnd ? -((int64_t)1 << (prec - 1)) : 0;
    int64_t hi = info.sgnd ? ((int64_t)1 << (prec - 1)) - 1 : ((int64_t)1 << prec) - 1;
    int32_t shift = info.sgnd ? 0 : (int32_t)((int64_t)1 << (prec - 1));
    const Plane& pl = planes[c];
    const Res& top_res = comp.res[tops[c]];
    int64_t ys = top_res.y0 - cdiv(cs.y0, info.dy), xs = top_res.x0 - cdiv(cs.x0, info.dx);
    int64_t iw = cdiv(cs.x1, info.dx) - cdiv(cs.x0, info.dx);
    int64_t ih = cdiv(cs.y1, info.dy) - cdiv(cs.y0, info.dy);
    int64_t rh = std::min(top_res.y1 - top_res.y0, ih - ys);
    int64_t rw = std::min(top_res.x1 - top_res.x0, iw - xs);
    std::vector<int32_t>& dst = image[c];
    for (int64_t y = 0; y < rh; ++y)
      for (int64_t x = 0; x < rw; ++x) {
        size_t k = (size_t)(y * pl.w + x);
        int64_t out;
        if (pl.reversible) {
          out = std::min(std::max((int64_t)wadd(pl.i[k], shift), lo), hi);
        } else {
          float v = pl.f[k];
          if (v > 2147483647.0f) out = hi;
          else if (v < -2147483648.0f) out = lo;
          else out = std::min(std::max((int64_t)std::nearbyint(v) + shift, lo), hi);
        }
        dst[(size_t)((ys + y) * iw + xs + x)] = (int32_t)out;
      }
  }
}

// the PPM markers' packet headers, joined in Zppm order without their Nppm
// fields (opj_j2k_merge_ppm)
Bytes merge_ppm(const std::map<int, Bytes>& markers) {
  Bytes out;
  uint64_t remaining = 0;
  for (const auto& kv : markers) {
    const Bytes& data = kv.second;
    size_t n = data.size();
    if (remaining >= n) {
      remaining -= n;
      out.insert(out.end(), data.begin(), data.end());
      continue;
    }
    out.insert(out.end(), data.begin(), data.begin() + remaining);
    size_t at = (size_t)remaining;
    remaining = 0;
    while (at < n) {
      if (n - at < 4) fail("Not enough bytes to read Nppm");
      uint64_t k = be(data.data(), n, at, 4);
      at += 4;
      size_t take = (size_t)std::min<uint64_t>(k, n - at);
      out.insert(out.end(), data.begin() + at, data.begin() + at + take);
      if (n - at >= k) {
        at += (size_t)k;
      } else {
        remaining = k - (n - at);
        at = n;
      }
    }
  }
  if (remaining) fail("Corrupted PPM markers");
  return out;
}

// opj_j2k_need_nb_tile_parts_correction: whether the next SOT of tileno,
// reached through other tiles' tile-parts by their Psot, has TPsot == TNsot
bool next_sot_same_tile(const uint8_t* d, size_t pos, size_t end, int64_t tileno) {
  while (true) {
    if (pos + 2 > end || be(d, end, pos, 2) != (uint64_t)SOT) return false;
    if (pos + 4 > end) fail("Stream too short");
    if (be(d, end, pos + 2, 2) != 10) fail("Inconsistent marker size");
    if (pos + 12 > end) fail("Stream too short");
    int64_t isot = be(d, end, pos + 4, 2), psot = be(d, end, pos + 6, 4);
    if (isot == tileno) return d[pos + 10] == d[pos + 11];
    if (psot < 14) return false;
    pos += psot;
    if (pos > end) return false;
  }
}

typedef std::function<void(Cs&, Tcp&, int64_t)> TileFn;

Cs read_codestream(const uint8_t* d, size_t end, size_t start, const TileFn& on_tile,
                   int64_t ihdr_h, int64_t ihdr_w, bool video) {
  Cs cs;
  cs.ihdr_h = ihdr_h, cs.ihdr_w = ihdr_w;
  if (start + 2 > end || be(d, end, start, 2) != (uint64_t)SOC) fail("Expected a SOC marker");
  size_t pos = start + 2;
  if (pos + 2 > end) fail("Stream too short");
  int marker = (int)be(d, end, pos, 2);
  pos += 2;
  int state = kMHSIZ;
  bool seen_siz = false, seen_cod = false, seen_qcd = false;
  while (marker != SOT) {
    if (marker < 0xFF00) {
      char buf[64];
      std::snprintf(buf, sizeof buf, "0x%x", marker);
      fail(std::string("A marker ID was expected (0xff--) instead of ") + buf);
    }
    if (!known(marker)) {
      while (true) {
        if (pos + 2 > end) fail("Stream too short");
        marker = (int)be(d, end, pos, 2);
        pos += 2;
        if (marker >= 0xFF00) {
          if (!(state & states(marker))) fail("Marker is not compliant with its position");
          if (known(marker)) break;
        }
      }
      if (marker == SOT) break;
    }
    seen_siz |= marker == SIZ, seen_cod |= marker == COD, seen_qcd |= marker == QCD;
    if (!(state & states(marker))) fail("Marker is not compliant with its position");
    if (pos + 2 > end) fail("Stream too short");
    size_t size = (size_t)be(d, end, pos, 2);
    if (size < 2) fail("Invalid marker size");
    if (pos + size > end) fail("Stream too short");
    read_marker(cs, marker, d + pos + 2, size - 2, cs.has_siz ? &cs.def : nullptr);
    pos += size;
    if (marker == SIZ) {
      state = kMH;
      std::string why = size_refusal(cs.x1 - cs.x0, cs.y1 - cs.y0);
      if (why.empty() && !video) why = opencv_refusal(cs.comps, cs.x0, cs.y0);
      if (!why.empty()) fail(why);
    }
    if (pos + 2 > end) fail("Stream too short");
    marker = (int)be(d, end, pos, 2);
    pos += 2;
  }
  if (!seen_siz) fail("required SIZ marker not found in main header");
  if (!seen_cod) fail("required COD marker not found in main header");
  if (!seen_qcd) fail("required QCD marker not found in main header");
  if (!cs.ppm.empty()) {
    cs.ppm_data = merge_ppm(cs.ppm);
    cs.has_ppm_data = true;
  }
  int64_t ntiles = cs.tw * cs.th;
  std::vector<Tcp> tcps((size_t)ntiles, cs.def);
  bool single = cs.tw == 1 && cs.th == 1 && cs.tx0 == 0 && cs.ty0 == 0 && cs.x0 == 0 &&
                cs.y0 == 0 && cs.x1 == cs.tdx && cs.y1 == cs.tdy;
  int st_state = kTPHSOT;
  int64_t current = 0, sot_length = 0;
  bool can_decode = false, last_part = false, checked = false;
  int correction = 0;
  int64_t last_tpsot = 0;
  auto read_sot = [&](const uint8_t* b, size_t n) {
    if (n != 8) fail("Error reading SOT marker");
    int64_t isot = be(b, n, 0, 2), psot = be(b, n, 2, 4), tpsot = b[6], tnsot = b[7];
    if (isot >= ntiles) fail("Invalid tile number " + S(isot));
    current = isot;
    Tcp& tcp = tcps[(size_t)isot];
    if (tcp.part_number + 1 != tpsot)
      fail("Invalid tile part index for tile number " + S(isot) + ". Got " + S(tpsot) +
           ", expected " + S(tcp.part_number + 1));
    tcp.part_number += 1;
    if (psot && psot < 14 && psot != 12)
      fail("Psot value is not correct regards to the JPEG2000 norm: " + S(psot) + ".");
    if (!psot) last_part = true;
    if (tcp.nb_parts && tpsot >= tcp.nb_parts) {
      last_part = true;
      fail("In SOT marker, TPSot (" + S(tpsot) +
           ") is not valid regards to the previous number of tile-part (" + S(tcp.nb_parts) +
           "), giving up");
    }
    last_tpsot = tpsot;
    if (tnsot) {
      tnsot += correction;
      if (tpsot >= tnsot) {
        last_part = true;
        fail("In SOT marker, TPSot (" + S(tpsot) +
             ") is not valid regards to the current number of tile-part (header) (" + S(tnsot) +
             "), giving up");
      }
      tcp.nb_parts = (int)tnsot;
    }
    if (tcp.nb_parts && tcp.nb_parts == tpsot + 1) can_decode = true;
    sot_length = last_part ? 0 : psot - 12;
    st_state = kTPH;
  };
  auto read_sod = [&]() {
    Tcp& tcp = tcps[(size_t)current];
    if (last_part) {
      if (end - pos < 2) fail("Tile part length size inconsistent with stream length");
      sot_length = (int64_t)(end - pos) - 2;
    } else if (sot_length >= 2) {
      sot_length -= 2;
    }
    int64_t n = sot_length;
    if (n) {
      if (n > (int64_t)(end - pos)) fail("Tile part length size inconsistent with stream length");
      tcp.data.insert(tcp.data.end(), d + pos, d + pos + n);
      tcp.has_data = true;
      pos += (size_t)n;
    }
    st_state = kTPHSOT;
  };
  // returns the tile to decode, or -1 when there is none
  auto tile_header = [&]() -> int64_t {
    int m = SOT;
    if (st_state == kEOC) m = EOC;
    else if (st_state != kTPHSOT) fail("the codestream goes on where no tile-part may start");
    while (!can_decode && m != EOC) {
      while (m != SOD) {
        if (pos >= end) {
          st_state = kNEOC;
          break;
        }
        if (pos + 2 > end) fail("Stream too short");
        int64_t size = be(d, end, pos, 2);
        pos += 2;
        if (size < 2) fail("Inconsistent marker size");
        if (m == 0x8080 && pos >= end) {
          st_state = kNEOC;
          break;
        }
        if ((st_state & kTPH) && sot_length) {
          if (sot_length < size + 2) fail("Sot length is less than marker size + marker ID");
          sot_length -= size + 2;
        }
        size -= 2;
        if (!(st_state & states(m))) fail("Marker is not compliant with its position");
        if (pos + size > end) fail("Stream too short");
        const uint8_t* body = d + pos;
        pos += (size_t)size;
        if (!known(m)) fail("Not sure how that happened.");
        if (m == SOT) read_sot(body, (size_t)size);
        else read_marker(cs, m, body, (size_t)size, &tcps[(size_t)current]);
        if (pos + 2 > end) fail("Stream too short");
        m = (int)be(d, end, pos, 2);
        pos += 2;
      }
      if (pos >= end && st_state == kNEOC) break;
      read_sod();
      // OpenJPEG's repair of a TNsot one short, looked for once, when a
      // tile's tile-parts after its first complete it
      if (can_decode && !checked && last_tpsot > 0) {
        checked = true;
        if (next_sot_same_tile(d, pos, end, current)) {
          can_decode = false;
          correction = 1;
          for (Tcp& t : tcps)
            if (t.nb_parts) t.nb_parts += 1;
        }
      }
      if (!can_decode) {
        if (pos + 2 > end) fail("Stream too short");
        m = (int)be(d, end, pos, 2);
        pos += 2;
      }
    }
    if (m == EOC && st_state != kEOC) {
      current = 0;
      st_state = kEOC;
    }
    if (!can_decode) {
      while (current < ntiles && !tcps[(size_t)current].has_data) ++current;
      if (current == ntiles) return -1;
    }
    return current;
  };
  int64_t decoded = 0;
  while (true) {
    int64_t tileno = tile_header();
    if (tileno < 0) {
      if (single) fail("Failed to decode tile 1/1");
      break;
    }
    Tcp& tcp = tcps[(size_t)tileno];
    if (!tcp.has_data) fail("Failed to decode tile " + S(tileno + 1) + "/" + S(ntiles));
    on_tile(cs, tcp, tileno);
    tcp.data.clear();
    tcp.data.shrink_to_fit();
    tcp.has_data = false;
    can_decode = false;
    if (pos >= end && st_state == kNEOC) break;  // the bytes ended without an EOC
    if (st_state != kEOC) {
      if (pos + 2 > end) fail("Stream too short");
      int m = (int)be(d, end, pos, 2);
      pos += 2;
      if (m == EOC) {
        current = 0;
        st_state = kEOC;
      } else if (m != SOT) {
        if (pos >= end) st_state = kNEOC;
        else fail("Stream too short, expected SOT");
      }
    }
    if (single || (pos >= end && st_state == kNEOC)) break;
    if (++decoded == ntiles) break;
  }
  return cs;
}

// -- OpenJPEG's JP2 colour boxes, then OpenCV's conversion ----------------------------

void convert(std::vector<std::vector<int32_t>>& planes, const std::vector<Comp>& comps, Jp2* jp2,
             int64_t w, int64_t h, std::vector<uint8_t>& rgb) {
  int max_prec = 0;
  for (auto& c : comps) max_prec = std::max(max_prec, c.prec);
  uint32_t space = 0;
  if (jp2) {
    space = jp2->enumcs;
    bool pc = jp2->has_pclr && jp2->pclr.has_cmap;
    if (jp2->has_cdef) {
      int64_t nr_channels = pc ? jp2->pclr.nr_channels : (int64_t)planes.size();
      for (auto& e : jp2->cdef) {
        int cn = e[0], asoc = e[2];
        if (cn >= nr_channels)
          fail("Invalid component index " + S(cn) + " (>= " + S(nr_channels) + ").");
        if (asoc != 65535 && asoc > 0 && asoc - 1 >= nr_channels)
          fail("Invalid component index " + S(asoc - 1) + " (>= " + S(nr_channels) + ").");
      }
      for (int64_t k = nr_channels - 1; k >= 0; --k) {
        bool found = false;
        for (auto& e : jp2->cdef) found |= e[0] == k;
        if (!found) fail("Incomplete channel definitions.");
      }
    }
    if (pc) {
      auto& cmap = jp2->pclr.cmap;
      int n = (int)cmap.size();
      bool sane = true;
      std::vector<bool> usage(n, false);
      for (auto& m : cmap)
        if (m[0] >= (int)planes.size()) sane = false;
      for (int i = 0; i < n; ++i) {
        int mtyp = cmap[i][1], pcol = cmap[i][2];
        if ((mtyp != 0 && mtyp != 1) || pcol >= n) sane = false;
        else if (usage[pcol] && mtyp == 1) sane = false;
        else if (mtyp == 0 && pcol != 0) sane = false;
        else if (mtyp == 1 && pcol != i) sane = false;
        else usage[pcol] = true;
      }
      for (int i = 0; i < n; ++i)
        if (!usage[i] && cmap[i][1] != 0) sane = false;
      bool all_used = true;
      for (int i = 0; i < n; ++i) all_used = all_used && usage[i];
      if (sane && planes.size() == 1 && !all_used)
        for (int i = 0; i < n; ++i) cmap[i][1] = 1, cmap[i][2] = i;
      if (!sane) fail("the JP2 component mapping (cmap) is inconsistent");
      std::vector<std::vector<int32_t>> fresh;
      int64_t top = jp2->pclr.nr_entries - 1;
      for (int i = 0; i < n; ++i) {
        const auto& src = planes[cmap[i][0]];
        if (cmap[i][1] == 0) {
          fresh.push_back(src);
        } else {
          std::vector<int32_t> out(src.size());  // int32 as OpenJPEG stores it
          for (size_t k = 0; k < src.size(); ++k) {
            int64_t idx = std::min(std::max((int64_t)src[k], (int64_t)0), top);
            out[k] = (int32_t)(uint32_t)jp2->pclr.entries[(size_t)(idx * n + cmap[i][2])];
          }
          fresh.push_back(std::move(out));
        }
      }
      planes = std::move(fresh);
    }
    if (jp2->has_cdef) {
      auto info = jp2->cdef;
      int np = (int)planes.size();
      for (size_t i = 0; i < info.size(); ++i) {
        int cn = info[i][0], typ = info[i][1], asoc = info[i][2];
        if (cn >= np || asoc == 0 || asoc == 65535) continue;
        int acn = asoc - 1;
        if (acn >= np) continue;
        if (cn != acn && typ == 0) {
          std::swap(planes[cn], planes[acn]);
          for (size_t j = i + 1; j < info.size(); ++j) {
            if (info[j][0] == cn) info[j][0] = acn;
            else if (info[j][0] == acn) info[j][0] = cn;
          }
        }
      }
    }
  }
  int shift = max_prec - 8;
  size_t n = (size_t)(w * h);
  auto chan = [&](int c, size_t k) { return (uint8_t)(planes[c][k] >> shift); };
  rgb.resize(n * 3);
  if (space == 12 || space == 24)
    fail("OpenJPEG2000: Unsupported color space conversion: CMYK or e-YCC -> BGR");
  if (space == 17) {
    for (size_t k = 0; k < n; ++k) rgb[3 * k] = rgb[3 * k + 1] = rgb[3 * k + 2] = chan(0, k);
    return;
  }
  if (planes.size() < 3)
    fail("OpenJPEG2000: unsupported conversion from " + S((long long)planes.size()) +
         " components to 3 for " + (space == 18 ? "SYCC" : "SRGB") + " image decoding");
  if (space == 18) {
    for (size_t k = 0; k < n; ++k) {
      int y = chan(0, k), u = chan(1, k) - 128, v = chan(2, k) - 128;
      const int half = 1 << 13;
      int b = y + ((u * 33292 + half) >> 14);
      int g = y + ((v * -9519 + u * -6472 + half) >> 14);
      int r = y + ((v * 18678 + half) >> 14);
      rgb[3 * k] = (uint8_t)std::min(std::max(r, 0), 255);
      rgb[3 * k + 1] = (uint8_t)std::min(std::max(g, 0), 255);
      rgb[3 * k + 2] = (uint8_t)std::min(std::max(b, 0), 255);
    }
    return;
  }
  for (size_t k = 0; k < n; ++k)
    for (int c = 0; c < 3; ++c) rgb[3 * k + c] = chan(c, k);
}

std::string video_refusal(const std::vector<Comp>& comps, int64_t x0, int64_t y0, int64_t x1,
                          int64_t y1, const Jp2* jp2) {
  std::string layout;
  for (size_t i = 0; i < comps.size(); ++i)
    layout += (i ? ", " : "") + S(comps[i].dx) + "x" + S(comps[i].dy);
  uint32_t space = jp2 ? jp2->enumcs : 0;
  for (size_t i = 0; i < comps.size(); ++i)
    if (comps[i].sgnd || comps[i].prec != 8)
      return "JPEG 2000 video whose component " + S((long long)i) + " is " +
             S(comps[i].prec) + "-bit" + (comps[i].sgnd ? " signed" : "") +
             ": the port converts 8-bit unsigned frames only";
  if (x0 || y0) return "JPEG 2000 video with an image offset (" + S(x0) + ", " + S(y0) + ")";
  if (jp2 && (jp2->has_pclr || jp2->has_cdef))
    return "JPEG 2000 video with a palette or channel definitions (pclr, cdef)";
  for (auto& c : comps)
    if (cdiv(x1, c.dx) - cdiv(x0, c.dx) == 1 && cdiv(y1, c.dy) - cdiv(y0, c.dy) == 1)
      return "JPEG 2000 video with a component of a single sample";
  bool grey = comps.size() == 1 && layout == "1x1" && (space == 0 || space == 17);
  bool yuv420 = comps.size() == 3 && layout == "1x1, 2x2, 2x2" && (space == 0 || space == 18);
  if (!(grey || yuv420))
    return "JPEG 2000 video of " + S((long long)comps.size()) + " components sampled " +
           layout + ", colour space " + S(space) +
           ": the port converts 4:2:0 (sYCC) and grey frames only";
  return "";
}

struct Decoder {
  std::string error;
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  std::vector<std::vector<int32_t>> planes;  // the video mode's components
  std::vector<int> pw, ph;
};

// jp2.py's _decode: the components, the codestream header and the JP2 boxes.
Cs decode_components(const uint8_t* d, size_t n, bool video, Jp2& jp2, bool& is_jp2,
                     std::vector<std::vector<int32_t>>& image) {
  is_jp2 = n >= 12 && std::memcmp(d, "\x00\x00\x00\x0cjP  \r\n\x87\n", 12) == 0;
  size_t start = 0;
  if (is_jp2) {
    jp2 = read_jp2(d, n);
    start = jp2.codestream;
  } else if (!(n >= 4 && std::memcmp(d, "\xff\x4f\xff\x51", 4) == 0)) {
    fail("not JPEG 2000");
  }
  Cs cs = read_codestream(
      d, n, start,
      [&](Cs& c, Tcp& tcp, int64_t tileno) {
        if (image.empty()) {
          if (video) {
            std::string why =
                video_refusal(c.comps, c.x0, c.y0, c.x1, c.y1, is_jp2 ? &jp2 : nullptr);
            if (!why.empty()) throw Unsupported{why};
          }
          for (auto& comp : c.comps) {
            int64_t cw = cdiv(c.x1, comp.dx) - cdiv(c.x0, comp.dx);
            int64_t ch = cdiv(c.y1, comp.dy) - cdiv(c.y0, comp.dy);
            image.emplace_back((size_t)(cw * ch), 0);
          }
        }
        decode_tile(c, tcp, tileno, image, video);
      },
      is_jp2 ? jp2.ihdr_h : 0, is_jp2 ? jp2.ihdr_w : 0, video);
  if (image.empty()) fail("Failed to decode all used components");
  return cs;
}

void decode(Decoder& dec, const uint8_t* d, size_t n) {
  Jp2 jp2;
  bool is_jp2 = false;
  std::vector<std::vector<int32_t>> image;
  Cs cs = decode_components(d, n, false, jp2, is_jp2, image);
  int64_t iw = cs.x1 - cs.x0, ih = cs.y1 - cs.y0;
  convert(image, cs.comps, is_jp2 ? &jp2 : nullptr, iw, ih, dec.rgb);
  dec.w = (int)iw, dec.h = (int)ih;
}

void decode_planes(Decoder& dec, const uint8_t* d, size_t n) {
  Jp2 jp2;
  bool is_jp2 = false;
  dec.planes.clear(), dec.pw.clear(), dec.ph.clear();
  Cs cs = decode_components(d, n, true, jp2, is_jp2, dec.planes);
  for (auto& comp : cs.comps) {
    dec.pw.push_back((int)(cdiv(cs.x1, comp.dx) - cdiv(cs.x0, comp.dx)));
    dec.ph.push_back((int)(cdiv(cs.y1, comp.dy) - cdiv(cs.y0, comp.dy)));
  }
}

}  // namespace

extern "C" {

void* vk_j2k_create() { return new Decoder(); }

void vk_j2k_destroy(void* h) { delete static_cast<Decoder*>(h); }

// Decode JP2 or J2K bytes: 0 with the image's size in *w, *hh (its pixels
// by vk_j2k_pixels), -1 on a refusal (the message by vk_j2k_error).
int vk_j2k_decode(void* h, const unsigned char* data, size_t n, int* w, int* hh) {
  Decoder* d = static_cast<Decoder*>(h);
  g_calls.fetch_add(1);
  try {
    decode(*d, data, n);
    *w = d->w, *hh = d->h;
    return 0;
  } catch (const Failure& f) {
    d->error = f.msg;
  } catch (const std::bad_alloc&) {
    d->error = "Not enough memory to decode the image";
  } catch (const std::length_error&) {
    d->error = "Not enough memory to decode the image";
  }
  d->rgb.clear();
  return -1;
}

// The last image as (h, w, 3) uint8 RGB.
void vk_j2k_pixels(void* h, unsigned char* out) {
  Decoder* d = static_cast<Decoder*>(h);
  std::memcpy(out, d->rgb.data(), d->rgb.size());
}

// The video mode (jp2.py's decode_jp2_planes): 0 with the number of
// components in *ncomp and each one's (h, w) in dims (by vk_j2k_plane), -1 on
// a refusal, -2 on a layout the mode does not convert (the message by
// vk_j2k_error).
int vk_j2k_decode_planes(void* h, const unsigned char* data, size_t n, int* ncomp, int* dims) {
  Decoder* d = static_cast<Decoder*>(h);
  g_calls.fetch_add(1);
  try {
    decode_planes(*d, data, n);
    *ncomp = (int)d->planes.size();
    for (size_t k = 0; k < d->planes.size() && k < 4; ++k)
      dims[2 * k] = d->ph[k], dims[2 * k + 1] = d->pw[k];
    return 0;
  } catch (const Unsupported& u) {
    d->error = u.msg;
    d->planes.clear();
    return -2;
  } catch (const Failure& f) {
    d->error = f.msg;
  } catch (const std::bad_alloc&) {
    d->error = "Not enough memory to decode the image";
  } catch (const std::length_error&) {
    d->error = "Not enough memory to decode the image";
  }
  d->planes.clear();
  return -1;
}

// Component k of the last video-mode decode as (h, w) uint8 samples.
void vk_j2k_plane(void* h, int k, unsigned char* out) {
  Decoder* d = static_cast<Decoder*>(h);
  const std::vector<int32_t>& p = d->planes[(size_t)k];
  for (size_t i = 0; i < p.size(); ++i) out[i] = (uint8_t)p[i];
}

const char* vk_j2k_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

long long vk_j2k_calls() { return g_calls.load(); }

}  // extern "C"
