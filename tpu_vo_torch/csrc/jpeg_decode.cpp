// jpeg_decode.cpp — decode_jpeg (codecs.h): JPEG to 8-bit gray, the port
// of io/jpeg.py's decoder (decode and its helpers, named below) with
// libjpeg-turbo's integer arithmetic, block by block where the Python one
// runs over all blocks at once.
//
// Markers as _decode reads them (SOF0-3, SOF9, SOF10, DAC); each
// scan's entropy-coded segments as _scan_segments cuts them (split at RSTn,
// fill bytes before a marker dropped, stuffed zeros removed). Baseline
// Huffman symbols as _decode_scan reads them (a 9-bit lookahead table,
// libjpeg's maxcode search above it, data that runs out read as zeros,
// the DC predictors reset at each restart); progressive Huffman scans as
// _decode_progressive_scan (jdphuff.c's DC first and refinement, AC first
// and refinement, EOBRUN); arithmetic-coded scans as _decode_arith_scan
// (jdarith.c's QM decoder on T.81 Table D.2, statistics by table, DAC's
// conditioning, sequential and the four progressive kinds, a fresh start
// at each restart). Then, in a progressive frame whose coefficients stop
// short of their last bit, jdcoefct.c's block smoothing (_smooth);
// jidctint's islow IDCT in 64-bit integers, saturated as libjpeg-turbo's
// SIMD IDCT does (idct_islow). A lossless scan (SOF3) as
// _decode_lossless_scan: jdlhuff.c's difference categories 0-16,
// jddiffct.c's iMCU rows and restarts, jdlossls.c's predictors 1-7 and
// point transform. Then each component cropped to its own size and
// upsampled (_upsample: fancy h2v1, h1v2, h2v2 in a DCT frame, else box
// replication), jdapimin.c's guess of the color space (_color_space),
// jdcolor.c's tables (_ycc_to_rgb), PIL's CMYK to RGB (cmyk_to_rgb), then
// rgb_to_gray.

#include <algorithm>
#include <cstring>
#include <map>

#include "codecs.h"

namespace vo {
namespace {

constexpr int kLookahead = 9;
constexpr uint32_t kMaxDimension = 65500;  // libjpeg's JPEG_MAX_DIMENSION
constexpr int kMaxBlocksInMcu = 10;        // libjpeg's D_MAX_BLOCKS_IN_MCU
// natural (row-major) index of each zigzag position, then 16 guard entries
// of 63 for a run that overshoots the block (jpeg_natural_order's)
constexpr uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Table D.2 as jaricom.c packs it, by state: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; state 113 is the fixed
// probability 0.5 (io/jpeg.ARITAB)
constexpr uint32_t kAritab[114] = {
    0x5A1D0181, 0x2586020E, 0x11140310, 0x080B0412, 0x03D80514, 0x01DA0617,
    0x00E50719, 0x006F081C, 0x0036091E, 0x001A0A21, 0x000D0B23, 0x00060C09,
    0x00030D0A, 0x00010D0C, 0x5A7F0F8F, 0x3F251024, 0x2CF21126, 0x207C1227,
    0x17B91328, 0x1182142A, 0x0CEF152B, 0x09A1162D, 0x072F172E, 0x055C1830,
    0x04061931, 0x03031A33, 0x02401B34, 0x01B11C36, 0x01441D38, 0x00F51E39,
    0x00B71F3B, 0x008A203C, 0x0068213E, 0x004E223F, 0x003B2320, 0x002C0921,
    0x5AE125A5, 0x484C2640, 0x3A0D2741, 0x2EF12843, 0x261F2944, 0x1F332A45,
    0x19A82B46, 0x15182C48, 0x11772D49, 0x0E742E4A, 0x0BFB2F4B, 0x09F8304D,
    0x0861314E, 0x0706324F, 0x05CD3330, 0x04DE3432, 0x040F3532, 0x03633633,
    0x02D43734, 0x025C3835, 0x01F83936, 0x01A43A37, 0x01603B38, 0x01253C39,
    0x00F63D3A, 0x00CB3E3B, 0x00AB3F3D, 0x008F203D, 0x5B1241C1, 0x4D044250,
    0x412C4351, 0x37D84452, 0x2FE84553, 0x293C4654, 0x23794756, 0x1EDF4857,
    0x1AA94957, 0x174E4A48, 0x14244B48, 0x119C4C4A, 0x0F6B4D4A, 0x0D514E4B,
    0x0BB64F4D, 0x0A40304D, 0x583251D0, 0x4D1C5258, 0x438E5359, 0x3BDD545A,
    0x34EE555B, 0x2EAE565C, 0x299A575D, 0x25164756, 0x557059D8, 0x4CA95A5F,
    0x44D95B60, 0x3E225C61, 0x38245D63, 0x32B45E63, 0x2E17565D, 0x56A860DF,
    0x4F466165, 0x47E56266, 0x41CF6367, 0x3C3D6468, 0x375E5D63, 0x52316669,
    0x4C0F676A, 0x4639686B, 0x415E6367, 0x56276AE9, 0x50E76B6C, 0x4B85676D,
    0x55976D6E, 0x504F6B6F, 0x5A106FEE, 0x55226D70, 0x59EB6FF0, 0x5A1D7171};

// Block smoothing (io/jpeg._SMOOTH_KERNELS): the natural index of the
// coefficients it estimates, zigzag 1..9, then the DC; the weights of the
// 5x5 DC values around a block (rows, then columns, -2..+2) without DC
// interpolation (the first five) and with it (all ten)
constexpr int kSmoothPos[10] = {1, 8, 16, 9, 2, 3, 10, 17, 24, 0};
constexpr int8_t kSmoothPlain[5][25] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
constexpr int16_t kSmoothInterp[10][25] = {
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0},
    {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
     -6, 6, 42, 6, -6, -2, -6, -8, -6, -2}};

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
  uint32_t get(int k) {  // the next k (<= 16) bits
    if (nb < k) refill();
    nb -= k;
    return static_cast<uint32_t>((buf >> nb) & ((1u << k) - 1));
  }
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
  std::vector<uint8_t> samples;  // a lossless frame's: height rows of width
  int32_t table[64];          // the quantisation table latched at its first scan
  int bits[64];               // coef_bits: each zigzag coefficient's last Al, -1 before
};

struct ScanPart {
  Component *c;
  const Huffman *dc, *ac;  // Huffman scans: the tables it reads (null where it reads none)
  int dc_tbl, ac_tbl;      // arithmetic scans: its statistics' and conditioning's tables
  int offs[kMaxBlocksInMcu];  // block offsets (in coefficients) of its blocks in an MCU
  int n_offs;
};

// A scan's spectral selection and successive approximation.
struct Band {
  int ss, se, ah, al;
};

// The coefficient as libjpeg stores it (JCOEF: 16 bits, two's complement).
inline int32_t wrap16(int64_t x) {
  return static_cast<int32_t>(static_cast<int16_t>(static_cast<uint16_t>(x & 0xFFFF)));
}

// The block of a single-component scan's MCU n_mcu (of mx across).
inline int32_t *lone_block(const ScanPart &sp, int64_t n_mcu, int64_t mx) {
  return sp.c->coefs.data() + static_cast<size_t>((n_mcu / mx * sp.c->bw + n_mcu % mx) * 64);
}

// The first coefficient of each block of MCU n_mcu (of mx across) of a scan,
// in order: fn(index of its part, block).
template <typename Fn>
inline bool for_each_block(std::vector<ScanPart> &parts, int64_t n_mcu, int64_t mx,
                           bool interleaved, Fn fn) {
  const int64_t my_i = n_mcu / mx, mx_i = n_mcu % mx;
  for (size_t ci = 0; ci < parts.size(); ++ci) {
    Component &c = *parts[ci].c;
    const size_t origin = interleaved ? static_cast<size_t>((my_i * c.v * c.bw + mx_i * c.h) * 64)
                                      : static_cast<size_t>((my_i * c.bw + mx_i) * 64);
    for (int o = 0; o < parts[ci].n_offs; ++o)
      if (!fn(ci, c.coefs.data() + origin + parts[ci].offs[o])) return false;
  }
  return true;
}

// One block's coefficients into blk; false for a bad code.
inline bool decode_block(BitReader &r, const ScanPart &sp, int32_t *blk, int64_t &pred) {
  int s;
  if (r.nb < 32) r.refill();  // a code (up to 17 bits) and its extra bits (up to 15)
  if (!next_symbol(r, *sp.dc, s)) return false;
  if (s) {
    r.nb -= s;
    pred += extend(static_cast<uint32_t>((r.buf >> r.nb) & ((1u << s) - 1)), s);
  }
  blk[0] = static_cast<int32_t>(pred);
  for (int k = 1; k < 64;) {
    if (r.nb < 32) r.refill();
    if (!next_symbol(r, *sp.ac, s)) return false;
    const int run = s >> 4;
    s &= 15;
    if (s) {
      k += run;
      r.nb -= s;
      blk[kNatural[k]] = extend(static_cast<uint32_t>((r.buf >> r.nb) & ((1u << s) - 1)), s);
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
    for (; n_mcu < end; ++n_mcu)
      if (!for_each_block(parts, n_mcu, mx, interleaved, [&](size_t ci, int32_t *blk) {
            return decode_block(r, parts[ci], blk, preds[ci]);
          }))
        return false;
  }
  return true;
}

// _decode_progressive_scan: one progressive Huffman scan (jdphuff.c), the
// DC predictors and EOBRUN reset at each restart.
bool decode_progressive_scan(const std::vector<std::vector<uint8_t>> &segs,
                             std::vector<ScanPart> &parts, int mx, int my, int restart,
                             bool interleaved, const Band &b) {
  const int64_t total = static_cast<int64_t>(mx) * my;
  const int64_t per_seg = restart ? restart : total;
  const int32_t p1 = int32_t{1} << b.al, m1 = -p1;
  int64_t n_mcu = 0;
  std::vector<int64_t> preds(parts.size());
  for (size_t seg = 0; n_mcu < total; ++seg) {
    BitReader r{seg < segs.size() ? segs[seg].data() : nullptr,
                seg < segs.size() ? segs[seg].size() : 0};
    std::fill(preds.begin(), preds.end(), 0);
    uint32_t eobrun = 0;
    const int64_t end = std::min(total, n_mcu + per_seg);
    for (; n_mcu < end; ++n_mcu) {
      if (b.ss == 0) {  // DC first, or refinement: one bit a block
        const bool ok = for_each_block(parts, n_mcu, mx, interleaved, [&](size_t ci, int32_t *blk) {
          if (b.ah) {
            if (r.get(1)) blk[0] |= p1;
            return true;
          }
          int s;
          if (r.nb < 32) r.refill();
          if (!next_symbol(r, *parts[ci].dc, s)) return false;
          if (s) preds[ci] += extend(r.get(s), s);
          blk[0] = static_cast<int32_t>(preds[ci] * (int64_t{1} << b.al));
          return true;
        });
        if (!ok) return false;
        continue;
      }
      int32_t *blk = lone_block(parts[0], n_mcu, mx);
      const Huffman &tab = *parts[0].ac;
      int s;
      if (!b.ah) {  // AC first: the band, values << Al, EOB runs across blocks
        if (eobrun) {
          --eobrun;
          continue;
        }
        for (int k = b.ss; k <= b.se; ++k) {
          if (r.nb < 32) r.refill();
          if (!next_symbol(r, tab, s)) return false;
          const int run = s >> 4;
          s &= 15;
          if (s) {
            k += run;
            blk[kNatural[k]] = extend(r.get(s), s) * (int32_t{1} << b.al);
          } else if (run == 15) {
            k += 15;
          } else {
            eobrun = (1u << run) + (run ? r.get(run) : 0) - 1;
            break;
          }
        }
        continue;
      }
      int k = b.ss;  // AC refinement
      if (!eobrun) {
        for (; k <= b.se; ++k) {
          if (r.nb < 32) r.refill();
          if (!next_symbol(r, tab, s)) return false;
          int run = s >> 4;
          int32_t val = 0;
          if (s & 15) {  // a new coefficient (its size should be 1), then its sign
            val = r.get(1) ? p1 : m1;
          } else if (run != 15) {
            eobrun = (1u << run) + (run ? r.get(run) : 0);
            break;
          }
          // pass run zero coefficients, a correction bit to each nonzero one
          for (; k <= b.se; ++k) {
            int32_t &c = blk[kNatural[k]];
            if (c) {
              if (r.get(1) && !(c & p1)) c += c >= 0 ? p1 : m1;
            } else if (--run < 0) {
              break;
            }
          }
          if (val) blk[kNatural[k]] = val;
        }
      }
      if (eobrun) {  // the rest of the band: correction bits only
        for (; k <= b.se; ++k) {
          int32_t &c = blk[kNatural[k]];
          if (c && r.get(1) && !(c & p1)) c += c >= 0 ? p1 : m1;
        }
        --eobrun;
      }
    }
  }
  return true;
}

// _Arith: jdarith.c's decoder over one segment, its bytes then zeros.
struct Arith {
  const uint8_t *p;
  size_t n;
  size_t pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16 before the two initial bytes, -1 after an error

  int decode(uint8_t *st) {  // arith_decode: one decision on bin *st
    while (a < 0x8000) {  // renormalisation and data input, T.81 D.2.6
      if (--ct < 0) {
        c = (c << 8) | (pos < n ? p[pos] : 0);
        ++pos;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    const uint32_t e = kAritab[sv & 0x7F];
    const int64_t qe = e >> 16;
    const uint8_t nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    a -= qe;
    const int64_t temp = a << ct;
    if (c >= temp) {  // LPS sub-interval, with the conditional exchange
      c -= temp;
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {  // MPS, renormalising: the conditional exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// DAC's conditioning by table number: L, U (DC) and Kx (AC).
struct Conditioning {
  uint8_t lo[16], hi[16], kx[16];
};

// _arith_dc: one DC difference with bins st and context *ctx; false on a
// magnitude overflow.
bool arith_dc(Arith &ad, uint8_t *st, int &ctx, int lo, int hi, int64_t &diff) {
  if (!ad.decode(st + ctx)) {
    ctx = 0;
    diff = 0;
    return true;
  }
  const int sign = ad.decode(st + ctx + 1);
  int s = ctx + 2 + sign;
  int m = ad.decode(st + s);
  if (m) {
    s = 20;  // X1
    while (ad.decode(st + s)) {
      if ((m <<= 1) == 0x8000) return false;
      ++s;
    }
  }
  ctx = m < (1 << lo) >> 1 ? 0 : m > (1 << hi) >> 1 ? 12 + 4 * sign : 4 + 4 * sign;
  int v = m;
  s += 14;
  while (m >>= 1)
    if (ad.decode(st + s)) v |= m;
  ++v;
  diff = sign ? -v : v;
  return true;
}

// _arith_band: the coefficients ss..se of one block, values << al; false on
// a spectral or magnitude overflow.
bool arith_band(Arith &ad, uint8_t *st, uint8_t *fixed, int32_t *blk, int ss, int se, int al,
                int kx) {
  for (int k = ss; k <= se; ++k) {
    int s = 3 * (k - 1);
    if (ad.decode(st + s)) return true;  // EOB
    while (!ad.decode(st + s + 1)) {
      s += 3;
      if (++k > se) return false;
    }
    const int sign = ad.decode(fixed);
    s += 2;
    int m = ad.decode(st + s);
    if (m && ad.decode(st + s)) {
      m <<= 1;
      s = k <= kx ? 189 : 217;  // X2
      while (ad.decode(st + s)) {
        if ((m <<= 1) == 0x8000) return false;
        ++s;
      }
    }
    int v = m;
    s += 14;
    while (m >>= 1)
      if (ad.decode(st + s)) v |= m;
    ++v;
    blk[kNatural[k]] = wrap16(static_cast<int64_t>(sign ? -v : v) * (int64_t{1} << al));
  }
  return true;
}

// _arith_refine: decode_mcu_AC_refine for one block; false on a spectral
// overflow.
bool arith_refine(Arith &ad, uint8_t *st, uint8_t *fixed, int32_t *blk, int ss, int se, int al) {
  const int32_t p1 = int32_t{1} << al, m1 = -p1;
  int kex = se;  // the previous stage's end of block
  while (kex > 0 && !blk[kNatural[kex]]) --kex;
  for (int k = ss; k <= se; ++k) {
    int s = 3 * (k - 1);
    if (k > kex && ad.decode(st + s)) return true;  // EOB
    for (;;) {
      int32_t &c = blk[kNatural[k]];
      if (c) {  // previously nonzero: its correction bit
        if (ad.decode(st + s + 2)) c += c < 0 ? m1 : p1;
        break;
      }
      if (ad.decode(st + s + 1)) {  // newly nonzero
        c = ad.decode(fixed) ? m1 : p1;
        break;
      }
      s += 3;
      if (++k > se) return false;
    }
  }
  return true;
}

// _decode_arith_scan: one arithmetic-coded scan (jdarith.c), sequential or
// progressive; statistics, predictors and contexts start at zero in each
// restart interval, and after an overflow the rest of it is left as is.
bool decode_arith_scan(const std::vector<std::vector<uint8_t>> &segs,
                       std::vector<ScanPart> &parts, int mx, int my, int restart,
                       bool interleaved, bool progressive, const Band &b,
                       const Conditioning &cond) {
  const int64_t total = static_cast<int64_t>(mx) * my;
  const int64_t per_seg = restart ? restart : total;
  const bool dc_first = !progressive || (b.ss == 0 && b.ah == 0);
  uint8_t dc_st[16][64], ac_st[16][256], fixed = 113;
  int64_t preds[4];
  int ctx[4];
  int64_t n_mcu = 0;
  for (size_t seg = 0; n_mcu < total; ++seg) {
    Arith ad{seg < segs.size() ? segs[seg].data() : nullptr,
             seg < segs.size() ? segs[seg].size() : 0};
    for (const ScanPart &sp : parts) {
      std::memset(dc_st[sp.dc_tbl], 0, sizeof(dc_st[0]));
      std::memset(ac_st[sp.ac_tbl], 0, sizeof(ac_st[0]));
    }
    std::fill(preds, preds + 4, 0);
    std::fill(ctx, ctx + 4, 0);
    const int64_t end = std::min(total, n_mcu + per_seg);
    for (; n_mcu < end && ad.ct != -1; ++n_mcu) {
      if (progressive && b.ss == 0 && b.ah) {  // DC refinement: the next bit of each
        for_each_block(parts, n_mcu, mx, interleaved, [&](size_t, int32_t *blk) {
          if (ad.decode(&fixed)) blk[0] |= int32_t{1} << b.al;
          return true;
        });
      } else if (dc_first) {
        for_each_block(parts, n_mcu, mx, interleaved, [&](size_t ci, int32_t *blk) {
          const ScanPart &sp = parts[ci];
          int64_t diff;
          if (!arith_dc(ad, dc_st[sp.dc_tbl], ctx[ci], cond.lo[sp.dc_tbl], cond.hi[sp.dc_tbl],
                        diff)) {
            ad.ct = -1;
            return false;
          }
          preds[ci] = wrap16(preds[ci] + diff);
          blk[0] = wrap16(preds[ci] * (int64_t{1} << b.al));
          if (!progressive &&
              !arith_band(ad, ac_st[sp.ac_tbl], &fixed, blk, 1, 63, 0, cond.kx[sp.ac_tbl])) {
            ad.ct = -1;
            return false;
          }
          return true;
        });
      } else {
        const ScanPart &sp = parts[0];
        int32_t *blk = lone_block(sp, n_mcu, mx);
        const bool ok =
            b.ah ? arith_refine(ad, ac_st[sp.ac_tbl], &fixed, blk, b.ss, b.se, b.al)
                 : arith_band(ad, ac_st[sp.ac_tbl], &fixed, blk, b.ss, b.se, b.al,
                              cond.kx[sp.ac_tbl]);
        if (!ok) ad.ct = -1;
      }
    }
    n_mcu = end;
  }
  return true;
}

// One row of a lossless component (jdlossls.c): x[c] = (d[c] + prediction)
// mod 2^16 from the row above (up) and the sample to the left; a first row
// (of the scan or after a restart) from init and the left, any other row's
// first sample from above.
void undifference_row(const int32_t *d, const int32_t *up, int32_t *x, int w, int psv,
                      bool first, int init) {
  if (first) {
    int32_t ra = (d[0] + init) & 0xFFFF;
    x[0] = ra;
    for (int c = 1; c < w; ++c) x[c] = ra = (d[c] + ra) & 0xFFFF;
    return;
  }
  x[0] = (d[0] + up[0]) & 0xFFFF;
  for (int c = 1; c < w; ++c) {
    const int32_t ra = x[c - 1], rb = up[c], rc = up[c - 1];
    int32_t pred;
    switch (psv) {
      case 1: pred = ra; break;
      case 2: pred = rb; break;
      case 3: pred = rc; break;
      case 4: pred = ra + rb - rc; break;
      case 5: pred = ra + ((rb - rc) >> 1); break;
      case 6: pred = rb + ((ra - rc) >> 1); break;
      default: pred = (ra + rb) >> 1; break;
    }
    x[c] = (d[c] + pred) & 0xFFFF;
  }
}

// _decode_lossless_scan: one lossless scan (jddiffct.c, jdlhuff.c) into its
// components' samples. An interleaved scan's MCU holds v rows of h samples
// of each component, a single component's scan one sample; the restart
// interval must be whole MCU rows. Rows are undifferenced an iMCU row (v
// sample rows of a component) at a time, after its MCU rows are decoded,
// so a restart inside one makes its first row a first row. The samples
// are the reconstructions << Al cut to 8 bits.
bool decode_lossless_scan(const std::vector<std::vector<uint8_t>> &segs,
                          std::vector<ScanPart> &parts, int mx, int my, int restart, int psv,
                          int al) {
  const bool interleaved = parts.size() > 1;
  const int per_row = interleaved ? mx : parts[0].c->width;
  if (restart % per_row) return false;
  const int64_t rows_per = restart / per_row;
  const int init = 1 << (8 - al - 1);
  struct Rows {
    std::vector<int32_t> diff, prev, cur;  // an iMCU row's differences; the last row; this row
    int pw = 0;                            // the differences' row length, MCU padding included
    bool first = true;
  };
  std::vector<Rows> st(parts.size());
  for (size_t k = 0; k < parts.size(); ++k) {
    Component &c = *parts[k].c;
    st[k].pw = interleaved ? mx * c.h : c.width;
    st[k].diff.assign(static_cast<size_t>(st[k].pw) * c.v, 0);
    st[k].prev.assign(c.width, 0);
    st[k].cur.assign(c.width, 0);
    c.samples.assign(static_cast<size_t>(c.width) * c.height, 0);
  }
  size_t seg = 0;
  BitReader r{segs.empty() ? nullptr : segs[0].data(), segs.empty() ? 0 : segs[0].size()};
  int64_t rows_to_go = rows_per;
  auto diff = [&](const Huffman &t, int32_t &d) {
    int s;
    if (r.nb < 32) r.refill();  // a code (up to 17 bits) and its extra bits (up to 15)
    if (!next_symbol(r, t, s)) return false;
    d = 0;
    if (s == 16) {
      d = 32768;
    } else if (s) {
      r.nb -= s;
      d = extend(static_cast<uint32_t>((r.buf >> r.nb) & ((1u << s) - 1)), s);
    }
    return true;
  };
  for (int imcu = 0; imcu < my; ++imcu) {
    Component &c0 = *parts[0].c;
    const int mcu_rows = interleaved ? 1 : std::min(c0.v, c0.height - imcu * c0.v);
    for (int y = 0; y < mcu_rows; ++y) {
      if (restart && rows_to_go == 0) {
        ++seg;
        r = BitReader{seg < segs.size() ? segs[seg].data() : nullptr,
                      seg < segs.size() ? segs[seg].size() : 0};
        for (Rows &s : st) s.first = true;
        rows_to_go = rows_per;
      }
      for (int col = 0; col < per_row; ++col) {
        for (size_t k = 0; k < parts.size(); ++k) {
          const Component &c = *parts[k].c;
          if (!interleaved) {
            if (!diff(*parts[k].dc, st[k].diff[static_cast<size_t>(y) * st[k].pw + col]))
              return false;
            continue;
          }
          for (int dy = 0; dy < c.v; ++dy)
            for (int dx = 0; dx < c.h; ++dx)
              if (!diff(*parts[k].dc,
                        st[k].diff[static_cast<size_t>(dy) * st[k].pw + col * c.h + dx]))
                return false;
        }
      }
      if (restart) --rows_to_go;
    }
    for (size_t k = 0; k < parts.size(); ++k) {
      Component &c = *parts[k].c;
      const int row0 = imcu * c.v;
      const int n_rows = std::min(c.v, c.height - row0);
      for (int y = 0; y < n_rows; ++y) {
        Rows &s = st[k];
        undifference_row(s.diff.data() + static_cast<size_t>(y) * s.pw, s.prev.data(),
                         s.cur.data(), c.width, psv, s.first, init);
        s.first = false;
        uint8_t *out = c.samples.data() + static_cast<size_t>(row0 + y) * c.width;
        for (int x = 0; x < c.width; ++x) out[x] = static_cast<uint8_t>(s.cur[x] << al);
        s.prev.swap(s.cur);
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

// _smoothing_ok: every component's DC seen and its table nonzero where
// smoothing divides, and some coefficient of zigzag 1..9 short of its last
// bit.
bool smoothing_ok(const std::vector<Component> &comps) {
  bool useful = false;
  for (const Component &c : comps) {
    if (c.bits[0] < 0) return false;
    for (int pos : kSmoothPos)
      if (!c.table[pos]) return false;
    for (int k = 1; k < 10; ++k) useful |= c.bits[k] != 0;
  }
  return useful;
}

// The 5 block rows around block row r of c, -2..+2, as decompress_smooth_data
// picks them from its iMCU row (n_rows of them in the frame): they may reach
// the MCU padding below, and on the last iMCU row of a 2-row component
// repeat the row above (_smooth).
void smooth_rows(const Component &c, int r, int n_rows, int rows[5]) {
  const int hb = (c.height + 7) / 8, last = n_rows - 1, tail = hb % c.v ? hb % c.v : c.v;
  const bool on_last = r / c.v == last;
  const int row = on_last ? last * tail + r % c.v : r;
  const int rows_n = on_last ? tail * n_rows : c.v * n_rows;
  const int up = row > 0 ? r - 1 : r, down = row < rows_n - 1 ? r + 1 : r;
  rows[0] = row > 1 ? r - 2 : up;
  rows[1] = up;
  rows[2] = r;
  rows[3] = down;
  rows[4] = row < rows_n - 2 ? r + 2 : down;
}

// _smooth for the block at (rows[2], bx) of c, whose coefficients ws holds:
// each coefficient of zigzag 1..9 that is zero and short of its last bit
// gets the estimate from the 5x5 DC values around it (columns clamped to
// the component's wb blocks), below 1 << Al; where no AC coefficient of
// 1..9 was sent, the DC too.
void smooth_block(const Component &c, const int rows[5], int bx, int wb, int32_t *ws) {
  int64_t dc[25];
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j) {
      const int col = std::min(std::max(bx + j - 2, 0), wb - 1);
      dc[5 * i + j] = c.coefs[(static_cast<size_t>(rows[i]) * c.bw + col) * 64];
    }
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc &= c.bits[k] == -1;
  for (int k = 0; k < (change_dc ? 10 : 5); ++k) {
    const int pos = kSmoothPos[k], al = pos ? c.bits[k + 1] : 0;
    if (pos && (al == 0 || ws[pos] != 0)) continue;
    int64_t sum = 0;
    for (int i = 0; i < 25; ++i)
      sum += dc[i] * (change_dc ? kSmoothInterp[k][i] : kSmoothPlain[k][i]);
    const int64_t num = c.table[0] * sum, q = c.table[pos];
    int64_t pred = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
    if (al > 0 && pred >= (int64_t{1} << al)) pred = (int64_t{1} << al) - 1;
    ws[pos] = wrap16(num < 0 ? -pred : pred);
  }
}

struct Plane {
  std::vector<uint8_t> v;
  size_t stride = 0;
  const uint8_t *at(size_t y) const { return v.data() + y * stride; }
};

// _upsample of the h x w samples at p (rows `stride` apart) by the integral
// ratio (fy, fx): fancy h2v1, h1v2 and h2v2 where `fancy` (a DCT frame) and
// a row holds more than 2 samples (h1v2 whatever it holds), else box
// replication (int_upsample, h2v1_upsample, h2v2_upsample).
Plane upsample(const uint8_t *p, size_t stride, int h, int w, int fy, int fx, bool fancy) {
  Plane o;
  o.stride = static_cast<size_t>(w) * fx;
  o.v.resize(o.stride * h * fy);
  auto in = [&](int y, int x) { return static_cast<int>(p[y * stride + x]); };
  if (!fancy || fx > 2 || fy > 2 || (fx == 2 && w <= 2)) {
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

inline uint8_t clip8(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// jdcolor.c's ycc_rgb_convert of one sample.
inline void ycc_to_rgb(int64_t y, int64_t cb, int64_t cr, uint8_t rgb[3]) {
  cb -= 128;
  cr -= 128;
  rgb[0] = clip8(y + ((FIX_1_40200 * cr + kOneHalf) >> kScaleBits));
  rgb[1] = clip8(y + ((-FIX_0_34414 * cb + kOneHalf - FIX_0_71414 * cr) >> kScaleBits));
  rgb[2] = clip8(y + ((FIX_1_77200 * cb + kOneHalf) >> kScaleBits));
}

// cmyk_to_rgb: PIL's "CMYK;I" inversion of libjpeg's CMYK, then cmyk2rgb.
inline void cmyk_to_rgb(const uint8_t cmyk[4], uint8_t rgb[3]) {
  const int nk = cmyk[3];  // 255 - (255 - k)
  for (int i = 0; i < 3; ++i) {
    const int t = (255 - cmyk[i]) * nk + 128;
    rgb[i] = clip8(nk - (((t >> 8) + t) >> 8));
  }
}

}  // namespace

bool decode_jpeg(const uint8_t *data, size_t n, GrayImage &out) {
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return false;
  int32_t qt[16][64];
  bool have_qt[16] = {false};
  std::map<int, Huffman> huff;  // by DHT's class/id byte
  Conditioning cond;            // DAC's, from jdmarker.c's defaults
  std::fill(cond.lo, cond.lo + 16, 0);
  std::fill(cond.hi, cond.hi + 16, 1);
  std::fill(cond.kx, cond.kx + 16, 5);
  std::vector<Component> comps;
  bool have_frame = false, jfif = false, progressive = false, arithmetic = false, lossless = false;
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
    } else if (marker == 0xCC) {  // DAC
      if (blen % 2) return false;
      for (size_t i = 0; i < blen; i += 2) {
        const int index = body[i], val = body[i + 1];
        if (index >= 32) return false;
        if (index >= 16) {
          cond.kx[index - 16] = static_cast<uint8_t>(val);
        } else {
          if ((val & 15) > (val >> 4)) return false;
          cond.lo[index] = static_cast<uint8_t>(val & 15);
          cond.hi[index] = static_cast<uint8_t>(val >> 4);
        }
      }
    } else if (marker == 0xDD) {  // DRI
      if (blen < 2) return false;
      restart = static_cast<int>(be16(body));
    } else if (marker == 0xE0 && blen >= 5 && std::memcmp(body, "JFIF\0", 5) == 0) {
      jfif = true;
    } else if (marker == 0xEE && blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
      adobe = body[11];
    } else if ((marker >= 0xC5 && marker <= 0xC7) || marker == 0xCB ||
               (marker >= 0xCD && marker <= 0xCF)) {
      return false;  // hierarchical, or lossless arithmetic-coded
    } else if ((marker >= 0xC0 && marker <= 0xC3) || marker == 0xC9 || marker == 0xCA) {
      // SOF0-3, SOF9, SOF10
      progressive = marker == 0xC2 || marker == 0xCA;
      arithmetic = marker >= 0xC9;
      lossless = marker == 0xC3;
      if (blen < 6) return false;
      const int precision = body[0], nc = body[5];
      fh = static_cast<int>(be16(body + 1));
      fw = static_cast<int>(be16(body + 3));
      if (precision != 8 || (nc != 1 && nc != 3 && nc != 4) || fh == 0 || fw == 0) return false;
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
        std::fill(c.bits, c.bits + 64, -1);
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return false;
        hmax = std::max(hmax, c.h);
        vmax = std::max(vmax, c.v);
      }
      for (const Component &c : comps)
        if (hmax % c.h || vmax % c.v) return false;  // a fractional ratio
      const int unit = lossless ? 1 : 8;  // a lossless data unit is one sample
      mx = (fw + unit * hmax - 1) / (unit * hmax);
      my = (fh + unit * vmax - 1) / (unit * vmax);
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
      if (ns < 1 || ns > 4 || blen < 4 + 2 * static_cast<size_t>(ns)) return false;
      const Band b{body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4,
                   body[3 + 2 * ns] & 15};
      if (progressive && ((b.ss == 0 ? b.se != 0 : b.ss > b.se || b.se > 63 || ns != 1) ||
                          (b.ah != 0 && b.al != b.ah - 1) || b.al > 13))
        return false;  // a bad progression (jdphuff.c's and jdarith.c's start_pass)
      if (lossless && (b.ss < 1 || b.ss > 7 || b.se != 0 || b.ah != 0 || b.al >= 8))
        return false;  // a bad lossless scan (jdlossls.c's start_input_pass)
      std::vector<ScanPart> parts;
      int mcu_blocks = 0;
      for (int k = 0; k < ns; ++k) {
        const int cid = body[1 + 2 * k], td_ta = body[2 + 2 * k];
        Component *c = nullptr;  // the last of the frame's components with this id
        for (Component &cc : comps)
          if (cc.id == cid) c = &cc;
        if (!c) return false;
        mcu_blocks += c->h * c->v;
        if (ns > 1 && mcu_blocks > kMaxBlocksInMcu) return false;  // JERR_BAD_MCU_SIZE
        ScanPart sp{c, nullptr, nullptr, td_ta >> 4, td_ta & 15, {0}, 0};
        if (lossless) {  // a DC-class table of categories 0 to 16
          const auto dc = huff.find(td_ta >> 4);
          if (dc == huff.end()) return false;
          for (int i = 0; i < dc->second.nvals; ++i)
            if (dc->second.vals[i] > 16) return false;
          sp.dc = &dc->second;
          parts.push_back(sp);
          continue;
        }
        if (c->tq > 15 || !have_qt[c->tq]) return false;
        if (!arithmetic) {  // the Huffman tables this scan reads, as they stand now
          if (!progressive || (b.ss == 0 && b.ah == 0)) {
            const auto dc = huff.find(td_ta >> 4);
            if (dc == huff.end()) return false;
            for (int i = 0; i < dc->second.nvals; ++i)
              if (dc->second.vals[i] > 15) return false;  // libjpeg refuses such a DC table
            sp.dc = &dc->second;
          }
          if (!progressive || b.ss) {
            const auto ac = huff.find(0x10 | (td_ta & 15));
            if (ac == huff.end()) return false;
            sp.ac = &ac->second;
          }
        }
        if (c->coefs.empty()) {
          c->coefs.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
          std::memcpy(c->table, qt[c->tq], sizeof(c->table));
        }
        if (progressive) std::fill(c->bits + b.ss, c->bits + b.se + 1, b.al);
        if (ns > 1) {
          for (int y = 0; y < c->v; ++y)
            for (int x = 0; x < c->h; ++x) sp.offs[sp.n_offs++] = (y * c->bw + x) * 64;
        } else {
          sp.n_offs = 1;
        }
        parts.push_back(sp);
      }
      if (lossless) {
        std::vector<std::vector<uint8_t>> segs;
        if (!scan_segments(data, n, pos, segs, pos)) return false;
        if (!decode_lossless_scan(segs, parts, mx, my, restart, b.ss, b.al)) return false;
        continue;
      }
      int smx = mx, smy = my;
      if (ns == 1) {  // one block an MCU, over the component's own blocks
        smx = (parts[0].c->width + 7) / 8;
        smy = (parts[0].c->height + 7) / 8;
      }
      std::vector<std::vector<uint8_t>> segs;
      if (!scan_segments(data, n, pos, segs, pos)) return false;
      const bool ok =
          arithmetic ? decode_arith_scan(segs, parts, smx, smy, restart, ns > 1, progressive, b,
                                         cond)
          : progressive ? decode_progressive_scan(segs, parts, smx, smy, restart, ns > 1, b)
                        : decode_scan(segs, parts, smx, smy, restart, ns > 1);
      if (!ok) return false;
    }
  }
  if (!have_frame) return false;

  for (const Component &c : comps)
    if (lossless ? c.samples.empty() : c.coefs.empty()) return false;  // a component with no scan
  // jdapimin.c's guess of the color space (_color_space): for three
  // components JFIF means YCbCr, else the Adobe transform (0 RGB), else
  // the ids ('R', 'G', 'B', or any in a lossless frame, mean RGB); for
  // four, Adobe transform 0 or no Adobe marker means CMYK, else YCCK
  const size_t nc = comps.size();
  const bool rgb = nc == 3 && !jfif &&
                   (adobe >= 0 ? adobe == 0
                               : lossless || (comps[0].id == 'R' && comps[1].id == 'G' &&
                                              comps[2].id == 'B'));
  const bool ycck = nc == 4 && adobe > 0;
  if (lossless && ((nc == 3 && !rgb) || ycck)) return false;  // no color conversion in lossless
  const bool smooth = progressive && smoothing_ok(comps);
  std::vector<Plane> planes;
  for (Component &c : comps) {
    const int fy = vmax / c.v, fx = hmax / c.h;
    if (lossless) {
      planes.push_back(upsample(c.samples.data(), c.width, c.height, c.width, fy, fx, false));
      continue;
    }
    Plane full;
    full.stride = static_cast<size_t>(c.bw) * 8;
    full.v.resize(full.stride * c.bh * 8);
    const int hb = (c.height + 7) / 8, wb = (c.width + 7) / 8;
    for (int by = 0; by < c.bh; ++by) {
      int rows[5];
      if (smooth && by < hb) smooth_rows(c, by, my, rows);
      for (int bx = 0; bx < c.bw; ++bx) {
        const int32_t *coef = c.coefs.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
        int32_t ws[64];
        if (smooth && by < hb && bx < wb) {
          std::memcpy(ws, coef, sizeof(ws));
          smooth_block(c, rows, bx, wb, ws);
          coef = ws;
        }
        idct_block(coef, c.table,
                   full.v.data() + static_cast<size_t>(by) * 8 * full.stride + bx * 8, full.stride);
      }
    }
    if (fy == 1 && fx == 1) {
      planes.push_back(std::move(full));
    } else {
      planes.push_back(upsample(full.v.data(), full.stride, c.height, c.width, fy, fx, true));
    }
  }
  out.width = fw;
  out.height = fh;
  out.pixels.resize(static_cast<size_t>(fw) * fh);
  uint8_t *dst = out.pixels.data();
  if (nc == 1) {
    for (int y = 0; y < fh; ++y) std::memcpy(dst + static_cast<size_t>(y) * fw, planes[0].at(y), fw);
    return true;
  }
  for (int y = 0; y < fh; ++y) {
    const uint8_t *p[4];
    for (size_t k = 0; k < nc; ++k) p[k] = planes[k].at(y);
    uint8_t *d = dst + static_cast<size_t>(y) * fw;
    uint8_t rgb3[3], cmyk[4];
    for (int x = 0; x < fw; ++x) {
      if (nc == 3) {
        if (rgb) {
          d[x] = rgb_to_gray(p[0][x], p[1][x], p[2][x]);
          continue;
        }
        ycc_to_rgb(p[0][x], p[1][x], p[2][x], rgb3);
      } else {
        if (ycck) {  // jdcolor.c's ycck_cmyk_convert
          ycc_to_rgb(p[0][x], p[1][x], p[2][x], rgb3);
          for (int i = 0; i < 3; ++i) cmyk[i] = static_cast<uint8_t>(255 - rgb3[i]);
        } else {
          for (int i = 0; i < 3; ++i) cmyk[i] = p[i][x];
        }
        cmyk[3] = p[3][x];
        cmyk_to_rgb(cmyk, rgb3);
      }
      d[x] = rgb_to_gray(rgb3[0], rgb3[1], rgb3[2]);
    }
  }
  return true;
}

}  // namespace vo
