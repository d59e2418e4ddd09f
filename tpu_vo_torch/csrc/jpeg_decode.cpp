// jpeg_decode.cpp — decode_jpeg (codecs.h): baseline JPEG to 8-bit gray,
// the port of io/jpeg.py's decoder (decode and its helpers, named below)
// with libjpeg-turbo's integer arithmetic, block by block where the
// Python one runs over all blocks at once.
//
// Markers as _decode reads them; each scan's entropy-coded segments as
// _scan_segments cuts them (split at RSTn, fill bytes before a marker
// dropped, stuffed zeros removed); Huffman symbols as _decode_scan reads
// them (a 9-bit lookahead table, libjpeg's maxcode search above it, data
// that runs out read as zeros, the DC predictors reset at each restart);
// jidctint's islow IDCT in 64-bit integers, saturated as libjpeg-turbo's
// SIMD IDCT does (idct_islow); fancy upsampling of each component cropped
// to its own size (_upsample); jdcolor.c's tables (_ycc_to_rgb); then
// rgb_to_gray.

#include <algorithm>
#include <cstring>
#include <map>

#include "codecs.h"

namespace vo {
namespace {

constexpr int kLookahead = 9;
constexpr uint32_t kMaxDimension = 65500;  // libjpeg's JPEG_MAX_DIMENSION
// natural (row-major) index of each zigzag position, then 16 guard entries
// of 63 for a run that overshoots the block (jpeg_natural_order's)
constexpr uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jidctint.c's constants (CONST_BITS 13)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
// jdcolor.c's (SCALEBITS 16): FIX(1.40200), FIX(1.77200), FIX(0.71414), FIX(0.34414)
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t{1} << (kScaleBits - 1);
constexpr int64_t FIX_1_40200 = 91881, FIX_1_77200 = 116130, FIX_0_71414 = 46802,
                  FIX_0_34414 = 22554;

uint32_t be16(const uint8_t *p) { return (uint32_t{p[0]} << 8) | p[1]; }

// What _Huffman holds: `look` maps the next kLookahead bits to
// (symbol << 8) | length for codes that short (0 where longer), and
// maxcode, valoffset and vals drive libjpeg's search for longer codes.
struct Huffman {
  uint16_t look[1 << kLookahead] = {0};
  int32_t maxcode[18];
  int32_t valoffset[17] = {0};
  uint8_t vals[256] = {0};
  int nvals = 0;
};

// A table from its DHT counts by length and symbols; false where libjpeg's
// jpeg_make_d_derived_tbl refuses it (over 256 symbols, or a code that
// does not fit its length: all-ones codes are reserved).
bool build_huffman(const uint8_t *bits, const uint8_t *vals, int nvals, Huffman &h) {
  if (nvals > 256) return false;
  std::memcpy(h.vals, vals, nvals);
  h.nvals = nvals;
  for (int &m : h.maxcode) m = -1;
  int code = 0, k = 0;
  for (int length = 1; length <= 16; ++length) {
    const int n = bits[length - 1];
    if (n) {
      if (code + n >= (1 << length)) return false;
      h.valoffset[length] = k - code;
      for (int i = 0; i < n; ++i, ++code, ++k) {
        if (length <= kLookahead) {
          const int lo = code << (kLookahead - length);
          for (int j = 0; j < (1 << (kLookahead - length)); ++j)
            h.look[lo + j] = static_cast<uint16_t>((h.vals[k] << 8) | length);
        }
      }
      h.maxcode[length] = code - 1;
    }
    code <<= 1;
  }
  h.maxcode[17] = 1 << 20;  // ends the search: a bad code decodes as 0
  return true;
}

// A segment's bits, first bit highest, then zeros without end.
struct BitReader {
  const uint8_t *p;
  size_t n;
  size_t pos = 0;
  uint64_t buf = 0;  // the low nb bits are unread
  int nb = 0;

  void refill() {  // to at least 57 bits
    while (nb <= 56) {
      buf = (buf << 8) | (pos < n ? p[pos] : 0);
      ++pos;
      nb += 8;
    }
  }
  uint32_t peek(int k) const { return static_cast<uint32_t>((buf >> (nb - k)) & ((1u << k) - 1)); }
};

// The value of s extra bits, sign-extended as JPEG codes it (HUFF_EXTEND).
inline int32_t extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int32_t>(v) - ((1 << s) - 1)
                             : static_cast<int32_t>(v);
}

// The next symbol of t; false for a code past the table's symbols.
inline bool next_symbol(BitReader &r, const Huffman &t, int &s) {
  const uint16_t e = t.look[r.peek(kLookahead)];
  if (e) {
    r.nb -= e & 255;
    s = e >> 8;
    return true;
  }
  int length = kLookahead + 1;
  int32_t code = static_cast<int32_t>(r.peek(length));
  while (code > t.maxcode[length]) {
    ++length;
    code = static_cast<int32_t>(r.peek(length));
  }
  r.nb -= length;
  if (length > 16) {
    s = 0;
    return true;
  }
  const int32_t i = code + t.valoffset[length];
  if (i < 0 || i >= t.nvals) return false;
  s = t.vals[i];
  return true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;  // its own size, ceil(image * factor / max factor)
  int bw = 0, bh = 0;         // its blocks across and down, MCU padding included
  std::vector<int32_t> coefs;  // 64 a block, natural order, blocks row-major
  int32_t table[64];          // the quantisation table latched at its first scan
};

struct ScanPart {
  Component *c;
  const Huffman *dc, *ac;
  int offs[4];  // block offsets (in coefficients) of its blocks in an MCU
  int n_offs;
};

// One block's coefficients at coefs[base...]; false for a bad code.
inline bool decode_block(BitReader &r, const ScanPart &sp, size_t base, int64_t &pred) {
  int32_t *coefs = sp.c->coefs.data();
  int s;
  if (r.nb < 32) r.refill();  // a code (up to 17 bits) and its extra bits (up to 15)
  if (!next_symbol(r, *sp.dc, s)) return false;
  if (s) {
    r.nb -= s;
    pred += extend(static_cast<uint32_t>((r.buf >> r.nb) & ((1u << s) - 1)), s);
  }
  coefs[base] = static_cast<int32_t>(pred);
  for (int k = 1; k < 64;) {
    if (r.nb < 32) r.refill();
    if (!next_symbol(r, *sp.ac, s)) return false;
    const int run = s >> 4;
    s &= 15;
    if (s) {
      k += run;
      r.nb -= s;
      coefs[base + kNatural[k]] =
          extend(static_cast<uint32_t>((r.buf >> r.nb) & ((1u << s) - 1)), s);
      ++k;
    } else if (run == 15) {
      k += 16;
    } else {
      break;
    }
  }
  return true;
}

// _decode_scan: one baseline scan's MCUs, segment by segment.
bool decode_scan(const std::vector<std::vector<uint8_t>> &segs, std::vector<ScanPart> &parts,
                 int mx, int my, int restart, bool interleaved) {
  const int64_t total = static_cast<int64_t>(mx) * my;
  const int64_t per_seg = restart ? restart : total;
  int64_t n_mcu = 0;
  std::vector<int64_t> preds(parts.size());
  for (size_t seg = 0; n_mcu < total; ++seg) {
    BitReader r{seg < segs.size() ? segs[seg].data() : nullptr,
                seg < segs.size() ? segs[seg].size() : 0};
    std::fill(preds.begin(), preds.end(), 0);
    const int64_t end = std::min(total, n_mcu + per_seg);
    for (; n_mcu < end; ++n_mcu) {
      const int64_t my_i = n_mcu / mx, mx_i = n_mcu % mx;
      for (size_t ci = 0; ci < parts.size(); ++ci) {
        const ScanPart &sp = parts[ci];
        const Component &c = *sp.c;
        const size_t origin =
            interleaved ? static_cast<size_t>((my_i * c.v * c.bw + mx_i * c.h) * 64)
                        : static_cast<size_t>((my_i * c.bw + mx_i) * 64);
        for (int o = 0; o < sp.n_offs; ++o)
          if (!decode_block(r, sp, origin + sp.offs[o], preds[ci])) return false;
      }
    }
  }
  return true;
}

// _scan_segments: the scan's entropy-coded segments from `start`, split at
// RSTn; `end` gets the offset of the marker that ends the scan.
bool scan_segments(const uint8_t *data, size_t n, size_t start,
                   std::vector<std::vector<uint8_t>> &segs, size_t &end) {
  size_t a = start;
  for (size_t m = start; m + 1 < n; ++m) {
    if (data[m] != 0xFF || data[m + 1] == 0 || data[m + 1] == 0xFF) continue;
    size_t e = m;
    while (e > a && data[e - 1] == 0xFF) --e;  // fill bytes before the marker
    std::vector<uint8_t> seg;
    seg.reserve(e - a);
    for (size_t i = a; i < e; ++i) {
      seg.push_back(data[i]);
      if (data[i] == 0xFF && i + 1 < e && data[i + 1] == 0x00) ++i;  // stuffed zero
    }
    segs.push_back(std::move(seg));
    const uint8_t code = data[m + 1];
    if (code < 0xD0 || code > 0xD7) {
      end = m;
      return true;
    }
    a = m + 2;
    ++m;
  }
  return false;  // a scan without an end marker
}

// jidctint's 1-D pass over x[0], x[step], ..., x[7 step], descaled by shift.
inline void idct_1d(const int64_t *x, int step, int shift, int64_t *out, int out_step) {
  const int64_t z2 = x[2 * step], z3 = x[6 * step];
  const int64_t z1 = (z2 + z3) * FIX_0_541196100;
  const int64_t t2 = z1 + z3 * -FIX_1_847759065;
  const int64_t t3 = z1 + z2 * FIX_0_765366865;
  const int64_t t0 = (x[0] + x[4 * step]) * (int64_t{1} << kConstBits);
  const int64_t t1 = (x[0] - x[4 * step]) * (int64_t{1} << kConstBits);
  const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  // the odd part (LL&M figure 8) of x[7], x[5], x[3], x[1]
  int64_t o0 = x[7 * step], o1 = x[5 * step], o2 = x[3 * step], o3 = x[step];
  int64_t q1 = o0 + o3, q2 = o1 + o2, q3 = o0 + o2, q4 = o1 + o3;
  const int64_t z5 = (q3 + q4) * FIX_1_175875602;
  o0 *= FIX_0_298631336;
  o1 *= FIX_2_053119869;
  o2 *= FIX_3_072711026;
  o3 *= FIX_1_501321110;
  q1 *= -FIX_0_899976223;
  q2 *= -FIX_2_562915447;
  q3 = q3 * -FIX_1_961570560 + z5;
  q4 = q4 * -FIX_0_390180644 + z5;
  o0 += q1 + q3;
  o1 += q2 + q4;
  o2 += q2 + q3;
  o3 += q1 + q4;
  const int64_t v[8] = {t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                        t13 - o0, t12 - o1, t11 - o2, t10 - o3};
  const int64_t round = int64_t{1} << (shift - 1);
  for (int i = 0; i < 8; ++i) out[i * out_step] = (v[i] + round) >> shift;
}

// idct_islow of one block (natural order) times its table, into 8 rows of
// out, clip(x + 128, 0, 255).
void idct_block(const int32_t *coef, const int32_t *table, uint8_t *out, size_t stride) {
  int64_t c[64], ws[64], row[8];
  for (int i = 0; i < 64; ++i) c[i] = static_cast<int64_t>(coef[i]) * table[i];
  for (int col = 0; col < 8; ++col) idct_1d(c + col, 8, kConstBits - kPass1Bits, ws + col, 8);
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + 8 * r, 1, kConstBits + kPass1Bits + 3, row, 1);
    for (int i = 0; i < 8; ++i) {
      const int64_t x = row[i] + 128;
      out[r * stride + i] = static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
    }
  }
}

struct Plane {
  std::vector<uint8_t> v;
  size_t stride = 0;
  const uint8_t *at(size_t y) const { return v.data() + y * stride; }
};

// _upsample of the h x w samples at p (rows `stride` apart) by (fy, fx).
Plane upsample(const uint8_t *p, size_t stride, int h, int w, int fy, int fx) {
  Plane o;
  o.stride = static_cast<size_t>(w) * fx;
  o.v.resize(o.stride * h * fy);
  auto in = [&](int y, int x) { return static_cast<int>(p[y * stride + x]); };
  if (fx == 2 && w <= 2) {  // h2v1_upsample / h2v2_upsample: replication
    for (int y = 0; y < h * fy; ++y)
      for (int x = 0; x < w * fx; ++x) o.v[y * o.stride + x] = p[(y / fy) * stride + x / fx];
    return o;
  }
  if (fy == 1) {  // h2v1 fancy
    for (int y = 0; y < h; ++y) {
      uint8_t *d = o.v.data() + y * o.stride;
      for (int x = 0; x < w; ++x) {
        const int c3 = 3 * in(y, x);
        d[2 * x] = static_cast<uint8_t>((c3 + in(y, x > 0 ? x - 1 : 0) + 1) >> 2);
        d[2 * x + 1] = static_cast<uint8_t>((c3 + in(y, x + 1 < w ? x + 1 : w - 1) + 2) >> 2);
      }
    }
    return o;
  }
  std::vector<int> col(w);
  for (int y = 0; y < h; ++y) {
    for (int half = 0; half < 2; ++half) {  // the output row above, then below
      const int near = half == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < h ? y + 1 : h - 1);
      uint8_t *d = o.v.data() + (2 * y + half) * o.stride;
      for (int x = 0; x < w; ++x) col[x] = 3 * in(y, x) + in(near, x);
      if (fx == 1) {  // h1v2 fancy
        for (int x = 0; x < w; ++x) d[x] = static_cast<uint8_t>((col[x] + 1 + half) >> 2);
        continue;
      }
      for (int x = 0; x < w; ++x) {  // h2v2 fancy
        d[2 * x] = static_cast<uint8_t>((3 * col[x] + col[x > 0 ? x - 1 : 0] + 8) >> 4);
        d[2 * x + 1] = static_cast<uint8_t>((3 * col[x] + col[x + 1 < w ? x + 1 : w - 1] + 7) >> 4);
      }
    }
  }
  return o;
}

}  // namespace

bool decode_jpeg(const uint8_t *data, size_t n, GrayImage &out) {
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return false;
  int32_t qt[16][64];
  bool have_qt[16] = {false};
  std::map<int, Huffman> huff;  // by DHT's class/id byte
  std::vector<Component> comps;
  bool have_frame = false, jfif = false;
  int adobe = -1;
  int fh = 0, fw = 0, hmax = 1, vmax = 1, mx = 0, my = 0;
  int restart = 0;
  size_t pos = 2;
  for (;;) {
    while (pos + 1 < n && data[pos] == 0xFF && data[pos + 1] == 0xFF) ++pos;  // fill bytes
    if (pos + 2 > n || data[pos] != 0xFF) return false;
    const uint8_t marker = data[pos + 1];
    if (marker == 0xD9) break;  // EOI
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) {
      pos += 2;
      continue;
    }
    if (pos + 4 > n) return false;
    const size_t len = be16(data + pos + 2);
    if (len < 2 || pos + 2 + len > n) return false;
    const uint8_t *body = data + pos + 4;
    const size_t blen = len - 2;
    pos += 2 + len;
    if (marker == 0xDB) {  // DQT
      for (size_t i = 0; i < blen;) {
        const int pq = body[i] >> 4, tq = body[i] & 15;
        const size_t size = pq ? 128 : 64;
        if (i + 1 + size > blen) return false;
        for (int k = 0; k < 64; ++k)
          qt[tq][kNatural[k]] = static_cast<int32_t>(pq ? be16(body + i + 1 + 2 * k)
                                                        : body[i + 1 + k]);
        have_qt[tq] = true;
        i += 1 + size;
      }
    } else if (marker == 0xC4) {  // DHT
      for (size_t i = 0; i < blen;) {
        if (i + 17 > blen) return false;
        int count = 0;
        for (int k = 0; k < 16; ++k) count += body[i + 1 + k];
        if (i + 17 + count > blen) return false;
        Huffman t;
        if (!build_huffman(body + i + 1, body + i + 17, count, t)) return false;
        huff[body[i]] = t;
        i += 17 + count;
      }
    } else if (marker == 0xDD) {  // DRI
      if (blen < 2) return false;
      restart = static_cast<int>(be16(body));
    } else if (marker == 0xE0 && blen >= 5 && std::memcmp(body, "JFIF\0", 5) == 0) {
      jfif = true;
    } else if (marker == 0xEE && blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
      adobe = body[11];
    } else if (marker == 0xC2 || marker == 0xC3 || (marker >= 0xC5 && marker <= 0xC7) ||
               (marker >= 0xC9 && marker <= 0xCF)) {
      return false;  // progressive, lossless, hierarchical, arithmetic-coded (or DAC)
    } else if (marker == 0xC0 || marker == 0xC1) {  // SOF0, SOF1
      if (blen < 6) return false;
      const int precision = body[0], nc = body[5];
      fh = static_cast<int>(be16(body + 1));
      fw = static_cast<int>(be16(body + 3));
      if (precision != 8 || (nc != 1 && nc != 3) || fh == 0 || fw == 0) return false;
      if (static_cast<uint32_t>(fh) > kMaxDimension || static_cast<uint32_t>(fw) > kMaxDimension)
        return false;
      if (blen < 6 + 3 * static_cast<size_t>(nc)) return false;
      comps.assign(nc, Component());
      hmax = vmax = 1;
      for (int k = 0; k < nc; ++k) {
        Component &c = comps[k];
        c.id = body[6 + 3 * k];
        c.h = body[7 + 3 * k] >> 4;
        c.v = body[7 + 3 * k] & 15;
        c.tq = body[8 + 3 * k];
        if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2) return false;
        hmax = std::max(hmax, c.h);
        vmax = std::max(vmax, c.v);
      }
      mx = (fw + 8 * hmax - 1) / (8 * hmax);
      my = (fh + 8 * vmax - 1) / (8 * vmax);
      for (Component &c : comps) {
        c.width = (fw * c.h + hmax - 1) / hmax;
        c.height = (fh * c.v + vmax - 1) / vmax;
        c.bw = mx * c.h;
        c.bh = my * c.v;
      }
      have_frame = true;
    } else if (marker == 0xDA) {  // SOS
      if (!have_frame || blen < 1) return false;
      const int ns = body[0];
      if (blen < 1 + 2 * static_cast<size_t>(ns)) return false;
      std::vector<ScanPart> parts;
      for (int k = 0; k < ns; ++k) {
        const int cid = body[1 + 2 * k], td_ta = body[2 + 2 * k];
        Component *c = nullptr;  // the last of the frame's components with this id
        for (Component &cc : comps)
          if (cc.id == cid) c = &cc;
        if (!c || c->tq > 15 || !have_qt[c->tq]) return false;
        const auto dc = huff.find(td_ta >> 4), ac = huff.find(0x10 | (td_ta & 15));
        if (dc == huff.end() || ac == huff.end()) return false;
        for (int i = 0; i < dc->second.nvals; ++i)
          if (dc->second.vals[i] > 15) return false;  // libjpeg refuses such a DC table
        if (c->coefs.empty()) {
          c->coefs.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
          std::memcpy(c->table, qt[c->tq], sizeof(c->table));
        }
        ScanPart sp{c, &dc->second, &ac->second, {0}, 0};
        if (ns > 1) {
          for (int y = 0; y < c->v; ++y)
            for (int x = 0; x < c->h; ++x) sp.offs[sp.n_offs++] = (y * c->bw + x) * 64;
        } else {
          sp.n_offs = 1;
        }
        parts.push_back(sp);
      }
      int smx = mx, smy = my;
      if (ns == 1) {  // one block an MCU, over the component's own blocks
        smx = (parts[0].c->width + 7) / 8;
        smy = (parts[0].c->height + 7) / 8;
      }
      std::vector<std::vector<uint8_t>> segs;
      if (!scan_segments(data, n, pos, segs, pos)) return false;
      if (!decode_scan(segs, parts, smx, smy, restart, ns > 1)) return false;
    }
  }
  if (!have_frame) return false;

  std::vector<Plane> planes;
  for (Component &c : comps) {
    if (c.coefs.empty()) return false;  // a component with no scan
    Plane full;
    full.stride = static_cast<size_t>(c.bw) * 8;
    full.v.resize(full.stride * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_block(c.coefs.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.table,
                   full.v.data() + static_cast<size_t>(by) * 8 * full.stride + bx * 8,
                   full.stride);
    const int fy = vmax / c.v, fx = hmax / c.h;
    if (fy == 1 && fx == 1) {
      planes.push_back(std::move(full));
    } else {
      planes.push_back(upsample(full.v.data(), full.stride, c.height, c.width, fy, fx));
    }
  }
  out.width = fw;
  out.height = fh;
  out.pixels.resize(static_cast<size_t>(fw) * fh);
  uint8_t *dst = out.pixels.data();
  if (planes.size() == 1) {
    for (int y = 0; y < fh; ++y) std::memcpy(dst + static_cast<size_t>(y) * fw, planes[0].at(y), fw);
    return true;
  }
  // jdapimin.c's guess of the color space: JFIF means YCbCr, else the
  // Adobe transform, else the component ids ('R', 'G', 'B' means RGB)
  const bool rgb = !jfif && (adobe == 0 || (adobe < 0 && comps[0].id == 'R' &&
                                            comps[1].id == 'G' && comps[2].id == 'B'));
  for (int y = 0; y < fh; ++y) {
    const uint8_t *p0 = planes[0].at(y), *p1 = planes[1].at(y), *p2 = planes[2].at(y);
    uint8_t *d = dst + static_cast<size_t>(y) * fw;
    if (rgb) {
      for (int x = 0; x < fw; ++x) d[x] = rgb_to_gray(p0[x], p1[x], p2[x]);
      continue;
    }
    for (int x = 0; x < fw; ++x) {  // jdcolor.c's ycc_rgb_convert
      const int64_t Y = p0[x], cb = p1[x] - 128, cr = p2[x] - 128;
      const int64_t r = Y + ((FIX_1_40200 * cr + kOneHalf) >> kScaleBits);
      const int64_t g = Y + ((-FIX_0_34414 * cb + kOneHalf - FIX_0_71414 * cr) >> kScaleBits);
      const int64_t b = Y + ((FIX_1_77200 * cb + kOneHalf) >> kScaleBits);
      auto clip = [](int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
      d[x] = rgb_to_gray(clip(r), clip(g), clip(b));
    }
  }
  return true;
}

}  // namespace vo
