// codecs.h — the image codecs of the native loader (vo_loader.cpp), with
// no library beyond the C++ standard library:
//
//   zlib_inflate  RFC 1950/1951 (inflate.cpp);
//   decode_png    PNG to 8-bit gray as libpng gives it with the
//                 transforms the loader sets (png_decode.cpp);
//   decode_jpeg   JPEG (sequential, progressive and lossless, Huffman
//                 and arithmetic) to 8-bit gray as PIL reads it through
//                 libjpeg-turbo with its defaults (jpeg_decode.cpp), the
//                 port of io/jpeg.py's decoder.
//
// Each function is pure: it keeps no state between calls, so the loader's
// worker threads call them at once. Any error makes it return false.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace vo {

// BT.601 grayscale in 15-bit fixed point; matches tpu_vo_torch.image.color
// and cv2 5.0 exactly: y = (B*3735 + G*19235 + R*9798 + 16384) >> 15.
inline uint8_t rgb_to_gray(uint8_t r, uint8_t g, uint8_t b) {
  return static_cast<uint8_t>(
      (static_cast<uint32_t>(b) * 3735u + static_cast<uint32_t>(g) * 19235u +
       static_cast<uint32_t>(r) * 9798u + 16384u) >>
      15);
}

// A decoded frame: height rows of width 8-bit gray samples.
struct GrayImage {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> pixels;
};

// Inflates the zlib stream src[0, n) into out (replacing its contents):
// the 2-byte header (deflate, window up to 32 KiB, no preset
// dictionary), stored, fixed- and dynamic-Huffman blocks up to the final
// one, then the Adler-32 of the output. `expected` sizes the first
// allocation only. False on any error: a bad header or trailer, an
// over-subscribed or incomplete code set (zlib's exceptions kept: an
// empty distance code, or a single code of one bit), a code-length repeat
// with nothing to repeat or past the table, a stored block whose LEN and
// NLEN disagree, a length or distance symbol that is never valid (286,
// 287, 30, 31), a distance past the start of the output, or a stream that
// ends before its final block and trailer. Bytes after the trailer are
// ignored.
bool zlib_inflate(const uint8_t *src, size_t n, size_t expected,
                  std::vector<uint8_t> &out);

// A PNG file in memory to gray: 16-bit samples cut to their high byte,
// 1-, 2- and 4-bit gray scaled to 0..255, palette indices through PLTE (an
// index past its entries reads black), tRNS and alpha dropped, Adam7
// filled whole, color through rgb_to_gray. False where libpng stops: bad
// signature, IHDR or chunk layout, a bad CRC on a critical chunk (IHDR,
// PLTE, IDAT, IEND; an ancillary chunk with a bad CRC is skipped), an
// unknown critical chunk, a palette image without PLTE before IDAT, image
// data that does not inflate or is short, an unknown row filter, no IEND.
bool decode_png(const uint8_t *data, size_t n, GrayImage &out);

// A JPEG file in memory to gray: 8-bit SOF0/SOF1 (sequential Huffman),
// SOF2 (progressive Huffman), SOF3 (lossless Huffman: predictors 1-7,
// point transform, no color conversion), SOF9 and SOF10 (sequential and
// progressive arithmetic, with DAC), 1, 3 or 4 components with sampling
// factors 1 to 4 in integral ratios (at most 10 blocks in an interleaved
// MCU), DQT of 8 or 16 bits, DRI/RSTn; libjpeg-turbo 3's block smoothing
// where a progressive frame stops short of a coefficient's last bit;
// jidctint (JDCT_ISLOW) with the SIMD IDCT's saturation, libjpeg-turbo's
// fancy h2v1, h1v2 and h2v2 upsampling (box replication for other ratios
// and lossless frames), jdcolor.c's YCbCr -> RGB, CMYK or YCCK through
// PIL's cmyk2rgb, then rgb_to_gray; one component is Y as it is. False on
// anything else (12-bit, hierarchical, SOF11, SOF13-15, 2 components, a
// fractional ratio, a larger MCU, a bad lossless scan, a lossless frame
// in YCbCr or YCCK), on a bad progression and on a corrupt file, as
// io/jpeg.decode raises.
bool decode_jpeg(const uint8_t *data, size_t n, GrayImage &out);

}  // namespace vo
