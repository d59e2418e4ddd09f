// inflate.cpp — zlib_inflate (codecs.h): RFC 1950's zlib wrapper around
// RFC 1951's deflate, decoded into one growing buffer, which also serves as
// the 32 KiB window across blocks.
//
// Huffman codes decode through a 10-bit table indexed by the next input
// bits (deflate packs a code's first bit lowest), and codes longer than
// that through the canonical count/symbol search of zlib's contrib/puff.
// The code sets are checked as zlib's inflate_table checks them.

#include <algorithm>
#include <cstring>

#include "codecs.h"

namespace vo {
namespace {

constexpr int kFastBits = 10;
constexpr int kMaxBits = 15;
constexpr int kMaxLitLen = 286;  // HLIT's largest count
constexpr int kMaxDist = 30;     // HDIST's largest count

// base and extra bits of length symbols 257..285, distance symbols 0..29
constexpr uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                                   15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                                   67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                   2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kDistBase[30] = {
    1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
    193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
// the order in which the code-length code's lengths are sent
constexpr uint8_t kCodeLengthOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                          11, 4,  12, 3, 13, 2, 14, 1, 15};

// Input bits, first bit lowest. `buf` holds `nbits` unread bits; the bits
// above them, where a refill left any, are the bytes that follow.
struct Bits {
  const uint8_t *src;
  size_t n;
  size_t pos = 0;  // next byte to load (past n: zeros were loaded)
  uint64_t buf = 0;
  int nbits = 0;

  // At least 56 bits in buf; false once the bits read would pass the end
  // of the input by more than the buffer holds.
  bool refill() {
    if (pos + 8 <= n) {  // one little-endian load of the next 8 bytes
      uint64_t w;
      std::memcpy(&w, src + pos, 8);
      if (__BYTE_ORDER__ == __ORDER_BIG_ENDIAN__) w = __builtin_bswap64(w);
      buf |= w << nbits;
      pos += (63 - nbits) >> 3;
      nbits |= 56;
      return true;
    }
    while (nbits <= 56) {
      if (pos >= n + 8) return false;
      buf |= static_cast<uint64_t>(pos < n ? src[pos] : 0) << nbits;
      ++pos;
      nbits += 8;
    }
    return true;
  }
  void drop(int k) {
    buf >>= k;
    nbits -= k;
  }
  uint32_t get(int k) {
    const uint32_t v = static_cast<uint32_t>(buf & ((uint64_t{1} << k) - 1));
    drop(k);
    return v;
  }
  // bits taken so far, and whether all of them came from the input
  bool within_input() const { return pos * 8 - nbits <= n * 8; }
};

struct Huffman {
  uint16_t fast[1 << kFastBits];  // (length << 9) | symbol; 0: longer or unused
  uint16_t count[kMaxBits + 1];   // codes of each length
  uint16_t symbol[288];           // symbols by code, shortest first
};

enum class CodeKind { kCodeLengths, kLiteralLengths, kDistances };

// h from n code lengths. False for an over-subscribed set and for an
// incomplete one, except where zlib accepts it: a literal/length or
// distance set of a single one-bit code, or a distance set with no codes.
bool build(Huffman &h, const uint8_t *lengths, int n, CodeKind kind) {
  std::memset(h.count, 0, sizeof(h.count));
  for (int i = 0; i < n; ++i) ++h.count[lengths[i]];
  h.count[0] = 0;
  int max = kMaxBits;
  while (max > 0 && h.count[max] == 0) --max;
  std::memset(h.fast, 0, sizeof(h.fast));
  if (max == 0) return kind == CodeKind::kDistances;
  int left = 1;
  for (int len = 1; len <= kMaxBits; ++len) {
    left = 2 * left - h.count[len];
    if (left < 0) return false;
  }
  if (left > 0 && (kind == CodeKind::kCodeLengths || max != 1)) return false;
  uint16_t offs[kMaxBits + 2] = {0};
  for (int len = 1; len <= kMaxBits; ++len) offs[len + 1] = offs[len] + h.count[len];
  for (int s = 0; s < n; ++s)
    if (lengths[s]) h.symbol[offs[lengths[s]]++] = static_cast<uint16_t>(s);
  // canonical codes, consecutive within a length, shorter ones first
  int code = 0, k = 0;
  for (int len = 1; len <= kFastBits; ++len, code <<= 1) {
    for (int c = 0; c < h.count[len]; ++c, ++code, ++k) {
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      const uint16_t e = static_cast<uint16_t>((len << 9) | h.symbol[k]);
      for (int i = rev; i < (1 << kFastBits); i += 1 << len) h.fast[i] = e;
    }
  }
  return true;
}

// The next symbol of h (needs 15 bits in b), or -1 for a code of no symbol.
int decode(Bits &b, const Huffman &h) {
  const uint16_t e = h.fast[b.buf & ((1u << kFastBits) - 1)];
  if (e) {
    b.drop(e >> 9);
    return e & 511;
  }
  int code = 0, first = 0, index = 0;
  uint64_t bits = b.buf;
  for (int len = 1; len <= kMaxBits; ++len) {
    code |= static_cast<int>(bits & 1);
    bits >>= 1;
    const int count = h.count[len];
    if (code - count < first) {
      b.drop(len);
      return h.symbol[index + (code - first)];
    }
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return -1;
}

uint32_t adler32(const uint8_t *p, size_t n) {
  uint32_t a = 1, s = 0;
  while (n > 0) {
    const size_t k = n < 5552 ? n : 5552;  // the most bytes before s can overflow
    for (size_t i = 0; i < k; ++i) {
      a += p[i];
      s += a;
    }
    a %= 65521;
    s %= 65521;
    p += k;
    n -= k;
  }
  return (s << 16) | a;
}

// Output with room for one more length/distance copy.
struct Output {
  std::vector<uint8_t> &v;
  size_t used = 0;
  void room(size_t k) {
    if (v.size() - used < k) v.resize(std::max(2 * v.size(), used + k));
  }
};

bool dynamic_tables(Bits &b, Huffman &lit, Huffman &dist) {
  if (!b.refill()) return false;
  const int hlit = static_cast<int>(b.get(5)) + 257;
  const int hdist = static_cast<int>(b.get(5)) + 1;
  const int hclen = static_cast<int>(b.get(4)) + 4;
  if (hlit > kMaxLitLen || hdist > kMaxDist) return false;
  uint8_t cl[19] = {0};
  for (int i = 0; i < hclen; ++i) {
    if (b.nbits < 3 && !b.refill()) return false;
    cl[kCodeLengthOrder[i]] = static_cast<uint8_t>(b.get(3));
  }
  Huffman codes;
  if (!build(codes, cl, 19, CodeKind::kCodeLengths)) return false;
  uint8_t lengths[kMaxLitLen + kMaxDist] = {0};
  const int total = hlit + hdist;
  for (int i = 0; i < total;) {
    if (!b.refill()) return false;
    const int sym = decode(b, codes);
    if (sym < 0) return false;
    if (sym < 16) {
      lengths[i++] = static_cast<uint8_t>(sym);
      continue;
    }
    uint8_t value = 0;
    int repeat;
    if (sym == 16) {
      if (i == 0) return false;  // nothing to repeat
      value = lengths[i - 1];
      repeat = 3 + static_cast<int>(b.get(2));
    } else if (sym == 17) {
      repeat = 3 + static_cast<int>(b.get(3));
    } else {
      repeat = 11 + static_cast<int>(b.get(7));
    }
    if (i + repeat > total) return false;
    std::memset(lengths + i, value, repeat);
    i += repeat;
  }
  if (lengths[256] == 0) return false;  // no end-of-block code
  return build(lit, lengths, hlit, CodeKind::kLiteralLengths) &&
         build(dist, lengths + hlit, hdist, CodeKind::kDistances);
}

void fixed_tables(Huffman &lit, Huffman &dist) {
  uint8_t lengths[288];
  std::memset(lengths, 8, 144);
  std::memset(lengths + 144, 9, 112);
  std::memset(lengths + 256, 7, 24);
  std::memset(lengths + 280, 8, 8);
  build(lit, lengths, 288, CodeKind::kLiteralLengths);
  std::memset(lengths, 5, 32);  // 30 and 31 complete the set and are refused
  build(dist, lengths, 32, CodeKind::kDistances);
}

// One Huffman-coded block's symbols up to its end-of-block code.
bool huffman_block(Bits &b, Output &o, const Huffman &lit, const Huffman &dist) {
  for (;;) {
    if (!b.refill()) return false;  // 48 bits: a length, a distance, their extra bits
    o.room(258);
    int sym = decode(b, lit);
    if (sym < 256) {
      if (sym < 0) return false;
      o.v[o.used++] = static_cast<uint8_t>(sym);
      continue;
    }
    if (sym == 256) return true;
    sym -= 257;
    if (sym >= 29) return false;  // 286, 287
    const size_t len = kLenBase[sym] + b.get(kLenExtra[sym]);
    const int ds = decode(b, dist);
    if (ds < 0 || ds >= 30) return false;  // 30, 31
    const size_t d = kDistBase[ds] + b.get(kDistExtra[ds]);
    if (d > o.used) return false;
    uint8_t *to = o.v.data() + o.used;
    const uint8_t *from = to - d;
    if (d >= len) {
      std::memcpy(to, from, len);
    } else {
      for (size_t i = 0; i < len; ++i) to[i] = from[i];
    }
    o.used += len;
  }
}

bool stored(Bits &b, Output &o) {
  b.drop(b.nbits & 7);  // to the byte boundary
  if (!b.refill()) return false;
  const uint32_t len = b.get(16);
  if (b.get(16) != (~len & 0xffffu)) return false;
  o.room(len);
  uint32_t k = 0;
  for (; k < len && b.nbits >= 8; ++k) o.v[o.used++] = static_cast<uint8_t>(b.get(8));
  if (k < len) {  // the buffer is empty and pos is the next byte
    const size_t rest = len - k;
    if (b.pos + rest > b.n) return false;
    std::memcpy(o.v.data() + o.used, b.src + b.pos, rest);
    o.used += rest;
    b.pos += rest;
    b.buf = 0;
  }
  return true;
}

}  // namespace

bool zlib_inflate(const uint8_t *src, size_t n, size_t expected, std::vector<uint8_t> &out) {
  if (n < 2) return false;
  const unsigned cmf = src[0], flg = src[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || (cmf * 256 + flg) % 31 != 0 || (flg & 0x20))
    return false;
  Bits b{src + 2, n - 2};
  // deflate expands a byte to at most 1032, so a short corrupt stream
  // never sizes a large buffer
  out.assign(std::max<size_t>(std::min(expected, n * 1032), 1024), 0);
  Output o{out};
  Huffman lit, dist;
  bool last = false;
  while (!last) {
    if (!b.refill()) return false;
    last = b.get(1) != 0;
    const uint32_t type = b.get(2);
    bool ok;
    if (type == 0) {
      ok = stored(b, o);
    } else if (type == 1) {
      fixed_tables(lit, dist);
      ok = huffman_block(b, o, lit, dist);
    } else if (type == 2) {
      ok = dynamic_tables(b, lit, dist) && huffman_block(b, o, lit, dist);
    } else {
      ok = false;
    }
    if (!ok) return false;
  }
  b.drop(b.nbits & 7);
  if (!b.refill()) return false;
  uint32_t check = 0;
  for (int i = 0; i < 4; ++i) check = (check << 8) | b.get(8);
  if (!b.within_input() || check != adler32(out.data(), o.used)) return false;
  out.resize(o.used);
  return true;
}

}  // namespace vo
