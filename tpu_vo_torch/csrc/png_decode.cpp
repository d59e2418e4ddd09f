// png_decode.cpp — decode_png (codecs.h): a PNG in memory to 8-bit gray,
// as libpng gives it to the loader with png_set_strip_16,
// png_set_palette_to_rgb, png_set_expand_gray_1_2_4_to_8,
// png_set_tRNS_to_alpha, png_set_strip_alpha and png_set_interlace_handling,
// then rgb_to_gray. The chunk rules are libpng's defaults: a bad CRC fails
// a critical chunk and drops an ancillary one; IHDR comes first, PLTE
// before the first IDAT; the IDAT chunks of the image are the first
// consecutive run; an IEND ends the file.
//
// Each Adam7 pass (or the whole image) is unfiltered row by row and each
// row converted to gray straight into its pixels of the output.

#include <algorithm>
#include <cstring>

#include "codecs.h"

namespace vo {
namespace {

constexpr uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
constexpr uint32_t kMaxSide = 1000000;  // libpng's PNG_USER_WIDTH_MAX/HEIGHT_MAX
// Adam7's passes: first column, first row, column step, row step
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                              {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

uint32_t be32(const uint8_t *p) {
  return (uint32_t{p[0]} << 24) | (uint32_t{p[1]} << 16) | (uint32_t{p[2]} << 8) | p[3];
}

uint32_t crc32(const uint8_t *p, size_t n) {
  static const auto table = [] {
    struct T {
      uint32_t v[256];
    } t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      t.v[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) c = table.v[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

struct Header {
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, interlace = 0;
  int channels = 0;  // samples a pixel
};

bool legal(const Header &h) {
  switch (h.color) {
    case 0: return h.depth == 1 || h.depth == 2 || h.depth == 4 || h.depth == 8 || h.depth == 16;
    case 3: return h.depth == 1 || h.depth == 2 || h.depth == 4 || h.depth == 8;
    case 2: case 4: case 6: return h.depth == 8 || h.depth == 16;
    default: return false;
  }
}

// bytes of a row of w pixels, filter byte excluded
size_t row_bytes(const Header &h, uint32_t w) {
  return (static_cast<size_t>(w) * h.channels * h.depth + 7) / 8;
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undo a row's filter in place; prior is the previous row of the same
// image or pass, reconstructed (zeros for the first).
bool unfilter(int type, uint8_t *row, const uint8_t *prior, size_t n, size_t bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + prior[i]);
      return true;
    case 3:
      for (size_t i = 0; i < bpp && i < n; ++i)
        row[i] = static_cast<uint8_t>(row[i] + (prior[i] >> 1));
      for (size_t i = bpp; i < n; ++i)
        row[i] = static_cast<uint8_t>(row[i] + ((row[i - bpp] + prior[i]) >> 1));
      return true;
    case 4:
      for (size_t i = 0; i < bpp && i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + prior[i]);
      for (size_t i = bpp; i < n; ++i)
        row[i] = static_cast<uint8_t>(row[i] + paeth(row[i - bpp], prior[i], prior[i - bpp]));
      return true;
    default:
      return false;  // libpng: "bad adaptive filter value"
  }
}

constexpr int kWhole[4] = {0, 0, 1, 1};

// An Adam7 pass (or the whole image): its grid, its size in pixels and
// the filtered bytes it takes, filter bytes included (none if empty).
struct Pass {
  size_t x0 = 0, y0 = 0, dx = 1, dy = 1;
  uint32_t w = 0, h = 0;
  size_t row = 0, bytes = 0;
  Pass() = default;
  Pass(const Header &hd, const int (&a)[4])
      : x0(a[0]), y0(a[1]), dx(a[2]), dy(a[3]),
        w(hd.width > x0 ? static_cast<uint32_t>((hd.width - x0 + dx - 1) / dx) : 0),
        h(hd.height > y0 ? static_cast<uint32_t>((hd.height - y0 + dy - 1) / dy) : 0),
        row(row_bytes(hd, w)),
        bytes(w && h ? static_cast<size_t>(h) * (row + 1) : 0) {}
};

// One reconstructed row of w pixels to gray, pixel c written to dst[c * step].
void row_to_gray(const Header &h, const uint8_t *palette, const uint8_t *row, uint32_t w,
                 uint8_t *dst, size_t step) {
  const int d = h.depth;
  if (d < 8) {  // one sample a pixel, packed from the high bits of each byte
    const int mask = (1 << d) - 1;
    const int scale = h.color == 0 ? 255 / mask : 1;
    for (uint32_t c = 0; c < w; ++c) {
      const size_t bit = static_cast<size_t>(c) * d;
      const int v = (row[bit >> 3] >> (8 - d - (bit & 7))) & mask;
      dst[c * step] = h.color == 3 ? palette[v] : static_cast<uint8_t>(v * scale);
    }
    return;
  }
  const size_t bytes = d / 8;               // a sample's bytes; the first is the high one
  const size_t stride = bytes * h.channels;  // a pixel's bytes
  for (uint32_t c = 0; c < w; ++c) {
    const uint8_t *px = row + c * stride;
    uint8_t g;
    if (h.color == 3) {
      g = palette[px[0]];
    } else if (h.color == 0 || h.color == 4) {
      g = px[0];
    } else {
      g = rgb_to_gray(px[0], px[bytes], px[2 * bytes]);
    }
    dst[c * step] = g;
  }
}

}  // namespace

bool decode_png(const uint8_t *data, size_t n, GrayImage &out) {
  if (n < 8 || std::memcmp(data, kSignature, 8) != 0) return false;
  Header h;
  // each palette entry's gray; the entries past PLTE's read black, as
  // libpng's zeroed palette of 256 entries gives them
  uint8_t palette[256] = {0};
  bool have_header = false, have_palette = false, seen_idat = false, idat_done = false;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  for (;;) {
    if (n - pos < 12) return false;  // no IEND
    const uint32_t len = be32(data + pos);
    if (len > 0x7fffffffu || n - pos - 12 < len) return false;
    const uint8_t *type = data + pos + 4;
    const uint8_t *body = type + 4;
    const bool critical = (type[0] & 0x20) == 0;
    const bool crc_ok = crc32(type, len + 4) == be32(body + len);
    pos += 12 + len;
    auto is = [&](const char *t) { return std::memcmp(type, t, 4) == 0; };
    if (seen_idat && !is("IDAT")) idat_done = true;
    if (!crc_ok) {
      if (critical) return false;
      continue;  // an ancillary chunk with a bad CRC is dropped
    }
    if (!have_header && !is("IHDR")) return false;
    if (is("IHDR")) {
      if (have_header || len != 13) return false;
      h.width = be32(body);
      h.height = be32(body + 4);
      h.depth = body[8];
      h.color = body[9];
      h.interlace = body[12];
      if (h.width == 0 || h.height == 0 || h.width > kMaxSide || h.height > kMaxSide ||
          !legal(h) || body[10] != 0 || body[11] != 0 || h.interlace > 1)
        return false;
      h.channels = h.color == 2 ? 3 : h.color == 4 ? 2 : h.color == 6 ? 4 : 1;
      have_header = true;
    } else if (is("PLTE")) {
      if (have_palette) return false;              // duplicate
      if (seen_idat || h.color == 0 || h.color == 4) continue;  // out of place, or gray
      have_palette = true;
      if (len % 3 != 0 || len > 3 * 256) {
        if (h.color == 3) return false;
        continue;
      }
      int entries = static_cast<int>(len / 3);
      if (h.color == 3 && entries > (1 << h.depth)) entries = 1 << h.depth;
      for (int i = 0; i < entries; ++i)
        palette[i] = rgb_to_gray(body[3 * i], body[3 * i + 1], body[3 * i + 2]);
    } else if (is("IDAT")) {
      if (h.color == 3 && !have_palette) return false;
      seen_idat = true;
      if (!idat_done) idat.insert(idat.end(), body, body + len);
    } else if (is("IEND")) {
      break;
    } else if (critical) {
      return false;  // an unknown critical chunk
    }
  }
  if (!seen_idat) return false;

  // the passes: Adam7's seven, or the whole image as one
  Pass passes[7];
  const int n_passes = h.interlace ? 7 : 1;
  size_t need = 0;
  for (int p = 0; p < n_passes; ++p) {
    passes[p] = h.interlace ? Pass(h, kAdam7[p]) : Pass(h, kWhole);
    need += passes[p].bytes;
  }
  std::vector<uint8_t> raw;
  if (!zlib_inflate(idat.data(), idat.size(), need, raw) || raw.size() < need) return false;

  out.width = static_cast<int>(h.width);
  out.height = static_cast<int>(h.height);
  out.pixels.assign(static_cast<size_t>(h.width) * h.height, 0);
  const size_t bpp = std::max<size_t>(1, static_cast<size_t>(h.channels) * h.depth / 8);
  const std::vector<uint8_t> zeros(row_bytes(h, h.width), 0);
  uint8_t *src = raw.data();
  for (int p = 0; p < n_passes; ++p) {
    const Pass &q = passes[p];
    if (q.bytes == 0) continue;  // a pass with no pixels sends no rows
    const uint8_t *prior = zeros.data();
    for (uint32_t r = 0; r < q.h; ++r, src += q.row + 1) {
      uint8_t *row = src + 1;
      if (!unfilter(src[0], row, prior, q.row, bpp)) return false;
      row_to_gray(h, palette, row, q.w,
                  out.pixels.data() + (q.y0 + static_cast<size_t>(r) * q.dy) * h.width + q.x0,
                  q.dx);
      prior = row;
    }
  }
  return true;
}

}  // namespace vo
