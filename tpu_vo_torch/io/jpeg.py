"""JPEG in numpy, with libjpeg-turbo's integer arithmetic: the decoder
that PIL and cv2 run with their defaults, and the gray encoder that
cv2.imencode runs.

- decode(data, path): 8-bit SOF0 and SOF1 (sequential Huffman), SOF2
  (progressive Huffman), SOF9 (sequential arithmetic) and SOF10
  (progressive arithmetic); DHT (redefined between scans as progressive
  files do), DAC, DQT (8- and 16-bit tables), DRI with RSTn markers,
  interleaved and single-component scans, 1 or 3 components with
  sampling factors up to 2x2, any size (the MCU padding is cropped).
  Entropy decoding is serial in Python: Huffman symbols through a 9-bit
  lookahead table and libjpeg's maxcode search above it; jdphuff.c's four
  progressive scan kinds (DC first and refinement, AC first with EOB
  runs, AC refinement with its correction bits); jdarith.c's QM decoder
  (T.81 Table D.2, statistics by table, DAC's L, U and Kx). A bad
  progression (jdphuff.c's fatal checks) raises; where libjpeg only
  warns, decoding goes on. All that follows runs over every block at
  once: in a progressive frame that stops short of a coefficient's last
  bit, jdcoefct.c's block smoothing (libjpeg-turbo 3's 5x5 window, DC
  interpolation where no low AC was sent); dequantisation, jidctint
  (JDCT_ISLOW), libjpeg-turbo's fancy h2v1, h1v2 and h2v2 upsampling
  (alternating biases, edges replicated) and jdcolor.c's table-driven
  YCbCr -> RGB. What it does not decode (12-bit, lossless, hierarchical,
  SOF11, SOF13-15, 2 or 4 components such as Adobe CMYK and YCCK) raises
  a ValueError naming the file and the reason.
- quant_table(quality): jpeg_set_quality's scaled luminance table
  (force_baseline).
- fdct_islow, quantize (jcdctmgr.c's reciprocal multiply), idct_islow:
  vectorised over (N, 8, 8) blocks in int64.
- encode_gray(u8, quality): a baseline file with the Annex K Huffman
  tables, as cv2.imencode(".jpg") writes one.
- encode_rgb(rgb_u8, quality): a baseline JFIF file of an RGB image,
  YCbCr 4:2:0 (jccolor.c's fixed-point rgb_ycc_convert, jcsample.c's
  h2v2_downsample with its alternating bias, jccoefct.c's dummy blocks
  at the right and bottom of the 16x16 MCU grid), the luminance and
  chrominance tables of jpeg_set_quality and Annex K, one interleaved
  scan: PIL's Image.save(format="JPEG", quality=q) byte for byte.
- roundtrip_gray(u8, quality): FDCT, quantise, dequantise, IDCT: the
  pixels of decode(encode_gray(u8, quality)) without the lossless
  entropy stage.
"""

from __future__ import annotations

import struct

import numpy as np

# natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# jcparam.c's std_luminance_quant_tbl, natural order
STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
# jcparam.c's std_chrominance_quant_tbl, natural order
STD_CHROMINANCE = np.full((8, 8), 99, np.int64)
STD_CHROMINANCE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
# Annex K.3's luminance tables: code counts by length 1..16, then symbols
DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_VALS = tuple(range(12))
AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
AC_VALS = (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA)

# Annex K.3's chrominance tables
DC_BITS_C = (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)
AC_BITS_C = (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77)
AC_VALS_C = (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA)
# (DC, AC) Huffman tables by table class: 0 luminance, 1 chrominance
HUFFMAN_TABLES = (((DC_BITS, DC_VALS), (AC_BITS, AC_VALS)),
                  ((DC_BITS_C, DC_VALS), (AC_BITS_C, AC_VALS_C)))

# jfdctint.c / jidctint.c
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
# jdcolor.c: SCALEBITS 16, ONE_HALF
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


LOOKAHEAD = 9  # bits of the Huffman lookahead table
# the frames a decode reads, by SOF marker: (progressive, arithmetic-coded)
_SOF_DECODED = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False),
                0xC9: (False, True), 0xCA: (True, True)}
# what a decode refuses, by SOF marker
_SOF_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
                0xC7: "hierarchical", 0xCB: "lossless arithmetic-coded",
                0xCD: "hierarchical", 0xCE: "hierarchical", 0xCF: "hierarchical"}
# ITU-T T.81 Table D.2 (jaricom.c), by state: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS); state 113 is T.851's fixed probability 0.5
QE_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))
# the same packed as jaricom.c packs it: Qe << 16 | NMPS << 8 | switch << 7 | NLPS
ARITAB = tuple((q << 16) | (nm << 8) | (sw << 7) | nl for q, nl, nm, sw in QE_TABLE)
# natural index of zigzag positions 1..9, the coefficients block smoothing
# estimates (jdcoefct.c's Q01, Q10, Q20, Q11, Q02, Q03, Q12, Q21, Q30)
_SMOOTHED = (1, 8, 16, 9, 2, 3, 10, 17, 24)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# the transforms and the tables


def quant_table(quality: int, base: np.ndarray = STD_LUMINANCE) -> np.ndarray:
    """(8, 8) int64 table of jpeg_set_quality(quality, force_baseline=TRUE)
    scaled from `base` (the luminance table by default), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _odd_part(t0, t1, t2, t3):
    """The shared odd part of jfdctint and jidctint (LL&M figure 8):
    inputs (tmp4..tmp7 of the forward, tmp0..tmp3 of the inverse)."""
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _fdct_1d(d, final: bool):
    """jfdctint's pass over the last axis of d (..., 8): rows (final
    False) or columns (final True)."""
    x = [d[..., i] for i in range(8)]
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [None] * 8
    if final:
        out[0] = _descale(t10 + t11, PASS1_BITS)
        out[4] = _descale(t10 - t11, PASS1_BITS)
        n = CONST_BITS + PASS1_BITS
    else:
        out[0] = (t10 + t11) << PASS1_BITS
        out[4] = (t10 - t11) << PASS1_BITS
        n = CONST_BITS - PASS1_BITS
    z1 = (t12 + t13) * FIX_0_541196100
    out[2] = _descale(z1 + t13 * FIX_0_765366865, n)
    out[6] = _descale(z1 + t12 * -FIX_1_847759065, n)
    o7, o5, o3, o1 = _odd_part(t4, t5, t6, t7)
    out[7], out[5], out[3], out[1] = (_descale(v, n) for v in (o7, o5, o3, o1))
    return np.stack(out, -1)


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jpeg_fdct_islow of (N, 8, 8) level-shifted samples (sample - 128):
    (N, 8, 8) int64 coefficients, scaled up by 8."""
    d = _fdct_1d(np.asarray(blocks, np.int64), final=False)        # rows
    return np.swapaxes(_fdct_1d(np.swapaxes(d, -1, -2), final=True), -1, -2)  # columns


def _idct_1d(x, shift: int):
    """jidctint's pass over the last axis of x (..., 8), descaled by `shift`."""
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * FIX_0_541196100
    t2 = z1 + z3 * -FIX_1_847759065
    t3 = z1 + z2 * FIX_0_765366865
    t0 = (x[..., 0] + x[..., 4]) << CONST_BITS
    t1 = (x[..., 0] - x[..., 4]) << CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = _odd_part(x[..., 7], x[..., 5], x[..., 3], x[..., 1])
    out = (t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3)
    return np.stack([_descale(v, shift) for v in out], -1)


def idct_islow(coefs: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow of (N, 8, 8) dequantised coefficients (natural
    order): (N, 8, 8) uint8 samples, range-limited as libjpeg-turbo's SIMD
    IDCT saturates them, clip(x + 128, 0, 255)."""
    c = np.asarray(coefs, np.int64)
    ws = np.swapaxes(_idct_1d(np.swapaxes(c, -1, -2), CONST_BITS - PASS1_BITS), -1, -2)
    out = _idct_1d(ws, CONST_BITS + PASS1_BITS + 3)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _reciprocal(divisor: np.ndarray):
    """jcdctmgr.c's compute_reciprocal for 16-bit DCTELEMs: (reciprocal,
    correction, shift r) with q = ((x + correction) * reciprocal) >> r."""
    d = np.asarray(divisor, np.int64)
    b = np.floor(np.log2(d)).astype(np.int64)  # flss(divisor) - 1
    r = 16 + b
    fq, fr = (np.int64(1) << r) // d, (np.int64(1) << r) % d
    c = d // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > d // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    return fq, c, r


def quantize(coefs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantize() (jcdctmgr.c) of FDCT output (N, 8, 8)
    by an (8, 8) table (divisor 8 q): the reciprocal multiply on |coef|,
    the sign restored. It equals rounding |coef| / (8 q) half up."""
    fq, c, r = _reciprocal(np.asarray(table, np.int64) * 8)
    a = np.abs(coefs)
    q = ((a + c) * fq) >> r
    return np.where(coefs < 0, -q, q)


def _pad_blocks(u8: np.ndarray):
    """(N, 8, 8) int64 blocks of a 2-D uint8 image, its right and bottom
    edges padded by replicating the last column and row (libjpeg's prep
    controller), and the block grid (by, bx)."""
    img = np.asarray(u8)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"a gray JPEG takes a 2-D uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    by, bx = -(-h // 8), -(-w // 8)
    p = np.pad(img, ((0, by * 8 - h), (0, bx * 8 - w)), mode="edge").astype(np.int64)
    return p.reshape(by, 8, bx, 8).swapaxes(1, 2).reshape(-1, 8, 8), (by, bx)


def _quantized_gray(u8: np.ndarray, quality: int):
    """(quantised coefficients (N, 8, 8), table, block grid, image shape)."""
    blocks, grid = _pad_blocks(u8)
    table = quant_table(quality)
    return quantize(fdct_islow(blocks - 128), table), table, grid, np.shape(u8)


def _assemble(blocks: np.ndarray, grid, shape) -> np.ndarray:
    by, bx = grid
    img = blocks.reshape(by, bx, 8, 8).swapaxes(1, 2).reshape(by * 8, bx * 8)
    return np.ascontiguousarray(img[:shape[0], :shape[1]])


def roundtrip_gray(u8: np.ndarray, quality: int) -> np.ndarray:
    """The uint8 pixels of a baseline gray JPEG round trip at `quality`
    (cv2.imdecode(cv2.imencode(".jpg", u8, [IMWRITE_JPEG_QUALITY, q]),
    IMREAD_GRAYSCALE)): FDCT, quantise, dequantise, IDCT."""
    q, table, grid, shape = _quantized_gray(u8, quality)
    return _assemble(idct_islow(q * table), grid, shape)


# ---------------------------------------------------------------------------
# the encoder


def _huffman_codes(bits, vals):
    """{symbol: (code, length)} of a table given as counts per length."""
    codes, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _code_arrays(bits, vals):
    """(code, length) int64 arrays indexed by symbol (0..255)."""
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for s, (c, n) in _huffman_codes(bits, vals).items():
        code[s], length[s] = c, n
    return code, length


def _magnitude(v: np.ndarray):
    """(size category, its low bits) of nonzero or zero values: JPEG's
    SSSS and the bits that follow it (v - 1 in two's complement for v < 0)."""
    a = np.abs(v)
    size = np.zeros_like(a)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size, np.where(v < 0, v - 1, v) & ((np.int64(1) << size) - 1)


def _entropy_code(zz: np.ndarray, comp=None) -> bytes:
    """The byte-stuffed scan data of (N, 64) zigzag-ordered coefficients
    in scan order. comp (N,) names each block's component (0 by
    default): DC is predicted from the previous block of the same
    component, and component 0 codes with the Annex K luminance tables,
    any other with the chrominance ones. Every symbol is made at once,
    then its bits are laid end to end and packed."""
    n = zz.shape[0]
    comp = np.zeros(n, np.int64) if comp is None else np.asarray(comp, np.int64)
    cls = np.minimum(comp, 1)
    dc_code, dc_len = (np.stack(a) for a in zip(*(_code_arrays(*t[0]) for t in HUFFMAN_TABLES)))
    ac_code, ac_len = (np.stack(a) for a in zip(*(_code_arrays(*t[1]) for t in HUFFMAN_TABLES)))
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx] = dc[idx] - np.concatenate([[0], dc[idx[:-1]]])
    s, extra = _magnitude(diff)
    items = [(np.arange(n), np.zeros(n, np.int64), (dc_code[cls, s] << s) | extra,
              dc_len[cls, s] + s)]
    blk, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    if blk.size:
        first = np.concatenate([[True], blk[1:] != blk[:-1]])
        prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
        run = pos - prev - 1
        v = zz[blk, pos]
        s, extra = _magnitude(v)
        sym = ((run % 16) << 4) | s
        bc = cls[blk]
        items.append((blk, 2 * pos, (ac_code[bc, sym] << s) | extra, ac_len[bc, sym] + s))
        zrl = run // 16  # 16 zeros a ZRL (0xF0) symbol before the coefficient
        k = np.repeat(np.arange(blk.size), zrl)
        items.append((blk[k], 2 * pos[k] - 1, ac_code[bc[k], 0xF0], ac_len[bc[k], 0xF0]))
    last = np.zeros(n, np.int64)
    if blk.size:
        last[blk] = pos  # nonzero order is ascending: the last write is the block's last
    eob = np.flatnonzero(last < 63)
    items.append((eob, np.full(eob.size, 200), ac_code[cls[eob], 0x00],
                  ac_len[cls[eob], 0x00]))
    b, key, val, ln = (np.concatenate(x) for x in zip(*items))
    order = np.lexsort((key, b))
    val, ln = val[order], ln[order]
    total = int(ln.sum())
    start = np.cumsum(ln) - ln
    owner = np.repeat(np.arange(ln.size), ln)
    shift = np.repeat(ln, ln) - 1 - (np.arange(total) - start[owner])
    bits = ((val[owner] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])  # pad with 1-bits
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dht(classes: int) -> bytes:
    """DHT segments of the first `classes` table classes, DC then AC each,
    in the order libjpeg emits them."""
    return b"".join(_segment(0xC4, bytes([tc | k]) + bytes(bits) + bytes(vals))
                    for k, pair in enumerate(HUFFMAN_TABLES[:classes])
                    for tc, (bits, vals) in zip((0x00, 0x10), pair))


def encode_gray(u8: np.ndarray, quality: int) -> bytes:
    """A baseline JPEG file of a 2-D uint8 image, byte for byte as
    cv2.imencode(".jpg", u8, [IMWRITE_JPEG_QUALITY, quality]) writes it:
    JFIF, one 8-bit quantisation table, SOF0 with one 1x1 component, the
    Annex K luminance Huffman tables, one scan."""
    q, table, _, (h, w) = _quantized_gray(u8, quality)
    zz = q.reshape(-1, 64)[:, ZIGZAG]
    return (b"\xff\xd8"
            + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xDB, b"\x00" + table.reshape(-1)[ZIGZAG].astype(np.uint8).tobytes())
            + _segment(0xC0, struct.pack(">BHHBBBB", 8, h, w, 1, 1, 0x11, 0))
            + _dht(1)
            + _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
            + _entropy_code(zz) + b"\xff\xd9")


# jccolor.c: rgb_ycc_convert's fixed-point coefficients (SCALEBITS 16)
_CBCR_OFFSET = 128 << _SCALEBITS


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert: (Y, Cb, Cr) int64 planes; Cb and Cr
    round with ONE_HALF - 1 so that they never reach 256."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + _ONE_HALF) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    return y, cb, cr


def _h2v2_downsample(plane: np.ndarray, mcu_rows: int, mcu_cols: int) -> np.ndarray:
    """A chroma plane (H, W) as libjpeg's prep controller and h2v2
    downsampler make it: rows padded to an even count and columns to
    16 * mcu_cols by replication, 2x2 sums with a bias of 1, 2, 1, 2, ...
    across output columns, >> 2, then the last output row replicated to
    8 * mcu_rows rows."""
    h, w = plane.shape
    p = np.pad(plane, ((0, h % 2), (0, 16 * mcu_cols - w)), mode="edge")
    bias = np.tile(np.array([1, 2], np.int64), 4 * mcu_cols)
    out = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
    return np.pad(out, ((0, 8 * mcu_rows - out.shape[0]), (0, 0)), mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(by, bx, 8, 8) blocks of a plane whose sides are multiples of 8."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def encode_rgb(rgb_u8: np.ndarray, quality: int) -> bytes:
    """A baseline JFIF file of an (H, W, 3) uint8 RGB image, byte for byte
    as PIL's Image.save(format="JPEG", quality=quality) writes it with
    libjpeg-turbo: YCbCr with Y at 2x2 and Cb, Cr at 1x1 (4:2:0), the
    scaled luminance and chrominance quantisation tables, the Annex K
    Huffman tables, one interleaved scan of MCUs Y0 Y1 Y2 Y3 Cb Cr.
    Y blocks past the image's ceil(H/8) x ceil(W/8) are jccoefct.c's
    dummy blocks: zero AC, the DC of the block before them in the MCU."""
    img = np.asarray(rgb_u8)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"an RGB JPEG takes an (H, W, 3) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    mr, mc = -(-h // 16), -(-w // 16)
    yb, xb = -(-h // 8), -(-w // 8)  # Y blocks that hold image rows and columns
    y, cb, cr = _rgb_to_ycc(img)
    tables = (quant_table(quality), quant_table(quality, STD_CHROMINANCE))

    def coded(blocks, table):
        n = blocks.shape[:-2]
        q = quantize(fdct_islow(blocks.reshape(-1, 8, 8) - 128), table)
        return q.reshape(*n, 64)[..., ZIGZAG]

    ypad = np.pad(y, ((0, 8 * yb - h), (0, 8 * xb - w)), mode="edge")
    yz = np.zeros((2 * mr, 2 * mc, 64), np.int64)
    yz[:yb, :xb] = coded(_blocks(ypad), tables[0])
    if xb % 2:  # right-hand dummies: the DC of the block to their left
        yz[:yb, xb, 0] = yz[:yb, xb - 1, 0]
    if yb % 2:  # bottom dummies: the DC of the MCU's last block above them
        yz[yb, :, 0] = np.repeat(yz[yb - 1, 1::2, 0], 2)
    cz = [coded(_blocks(_h2v2_downsample(p, mr, mc)), tables[1]) for p in (cb, cr)]
    mcus = np.concatenate([yz.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4)
                           .reshape(mr, mc, 4, 64), cz[0][:, :, None], cz[1][:, :, None]], 2)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mr * mc)
    dqt = b"".join(_segment(0xDB, bytes([k]) + t.reshape(-1)[ZIGZAG].astype(np.uint8).tobytes())
                   for k, t in enumerate(tables))
    return (b"\xff\xd8"
            + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + dqt
            + _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
            + _dht(2)
            + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
            + _entropy_code(mcus.reshape(-1, 64), comp) + b"\xff\xd9")


# ---------------------------------------------------------------------------
# the decoder


class _Huffman:
    """A decoding table: `look` maps the next LOOKAHEAD bits to
    (symbol << 8) | code length for codes that short (0 where longer), and
    maxcode, valoffset and vals drive libjpeg's search for longer codes."""

    def __init__(self, bits, vals):
        self.vals = list(vals)
        self.look = [0] * (1 << LOOKAHEAD)
        self.maxcode = [-1] * 18
        self.valoffset = [0] * 17
        code = k = 0
        for length in range(1, 17):
            n = bits[length - 1]
            if n:
                self.valoffset[length] = k - code
                for _ in range(n):
                    if length <= LOOKAHEAD:
                        lo = code << (LOOKAHEAD - length)
                        for j in range(1 << (LOOKAHEAD - length)):
                            self.look[lo + j] = (self.vals[k] << 8) | length
                    code += 1
                    k += 1
                self.maxcode[length] = code - 1
            code <<= 1
        self.maxcode[17] = 1 << 20  # ends the search: a bad code decodes as 0


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "width", "height", "bw", "bh", "coefs", "table", "bits")
    # bits: jdphuff.c's coef_bits, the Al of each zigzag coefficient's last
    # scan (-1 before its first)


def _scan_segments(data: bytes, start: int, path: str):
    """(the entropy-coded segments of the scan that starts at `start`,
    unstuffed, split at its RSTn markers; the offset of the marker that
    ends the scan)."""
    arr = np.frombuffer(data, np.uint8, offset=start)
    nxt = arr[1:]
    marks = np.flatnonzero((arr[:-1] == 0xFF) & (nxt != 0) & (nxt != 0xFF)) + start
    segs, a = [], start
    for m in marks.tolist():
        code = data[m + 1]
        segs.append(data[a:m].rstrip(b"\xff").replace(b"\xff\x00", b"\xff"))
        if not 0xD0 <= code <= 0xD7:
            return segs, m
        a = m + 2
    raise ValueError(f"{path}: truncated JPEG (a scan without an end marker)")


_MASK = [(1 << n) - 1 for n in range(65)]
_NATURAL = ZIGZAG.tolist() + [63] * 16  # jpeg_natural_order's guard entries


def _wrap16(x: int) -> int:
    """x as libjpeg stores a coefficient (JCOEF, 16 bits, two's complement)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _mcu_blocks(comps, mcus, interleaved: bool):
    """Each MCU of a scan, in scan order, as a list of (index of its
    component in the scan, offset of the block's first coefficient)."""
    mx, my = mcus
    out = []
    for my_i in range(my):
        for mx_i in range(mx):
            if not interleaved:
                out.append([(0, (my_i * comps[0].bw + mx_i) * 64)])
                continue
            mcu = []
            for ci, c in enumerate(comps):
                origin = (my_i * c.v * c.bw + mx_i * c.h) * 64
                mcu.extend((ci, origin + (y * c.bw + x) * 64)
                           for y in range(c.v) for x in range(c.h))
            out.append(mcu)
    return out


def _restart_intervals(segs, blocks, restart: int):
    """(entropy-coded segment, its MCUs) for each restart interval of a scan;
    a missing segment reads as empty."""
    per = restart or len(blocks)
    for j, i in enumerate(range(0, len(blocks), per)):
        yield (segs[j] if j < len(segs) else b""), blocks[i:i + per]


def _decode_scan(segs, comps, mcus, restart: int, interleaved: bool, tables):
    """Huffman-decode one baseline scan into each component's `coefs`
    (a flat list, 64 natural-order entries a block)."""
    zz, mask = _NATURAL, _MASK
    for raw, blocks in _restart_intervals(segs, _mcu_blocks(comps, mcus, interleaved), restart):
        # data that runs out reads as zeros, as libjpeg fills it
        words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 8), ">u4").tolist()
        nw = len(words)
        wp, buf, nb = 0, 0, 0
        preds = [0] * len(comps)
        for mcu in blocks:
            for ci, base in mcu:
                coefs = comps[ci].coefs
                dct, act = tables[ci]
                # DC, then AC, each symbol through `look` or libjpeg's search
                tab, k = dct, 0
                while True:
                    if nb < 32:  # a code (up to 17 bits) and its extra bits (up to 15)
                        buf = ((buf & mask[nb]) << 32) | (words[wp] if wp < nw else 0)
                        wp += 1
                        nb += 32
                    e = tab.look[(buf >> (nb - LOOKAHEAD)) & 511]
                    if e:
                        nb -= e & 255
                        s = e >> 8
                    else:
                        length = LOOKAHEAD + 1
                        code = (buf >> (nb - length)) & mask[length]
                        while code > tab.maxcode[length]:
                            length += 1
                            code = (buf >> (nb - length)) & mask[length]
                        nb -= length
                        s = tab.vals[code + tab.valoffset[length]] if length <= 16 else 0
                    if k == 0:
                        if s:
                            nb -= s
                            v = (buf >> nb) & mask[s]
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            preds[ci] += v
                        coefs[base] = preds[ci]
                        tab, k = act, 1
                        continue
                    r, s = s >> 4, s & 15
                    if s:
                        k += r
                        nb -= s
                        v = (buf >> nb) & mask[s]
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        coefs[base + zz[k]] = v
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
                    if k >= 64:
                        break


class _Bits:
    """A segment's bits as _decode_scan reads them: first bit highest, then
    zeros without end."""
    __slots__ = ("words", "nw", "wp", "buf", "nb")

    def __init__(self, raw: bytes):
        self.words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4 + 8), ">u4").tolist()
        self.nw = len(self.words)
        self.wp = self.buf = self.nb = 0

    def _fill(self):
        self.buf = ((self.buf & _MASK[self.nb]) << 32) | (self.words[self.wp]
                                                          if self.wp < self.nw else 0)
        self.wp += 1
        self.nb += 32

    def get(self, n: int) -> int:
        """The next n bits (n <= 32) as an unsigned number."""
        if self.nb < n:
            self._fill()
        self.nb -= n
        return (self.buf >> self.nb) & _MASK[n]

    def value(self, s: int) -> int:
        """The next s bits, sign-extended as JPEG codes them (HUFF_EXTEND)."""
        v = self.get(s)
        return v - _MASK[s] if v < (1 << (s - 1)) else v

    def symbol(self, tab: _Huffman) -> int:
        """The next Huffman symbol of tab, as _decode_scan reads it."""
        if self.nb < 32:
            self._fill()
        buf, nb = self.buf, self.nb
        e = tab.look[(buf >> (nb - LOOKAHEAD)) & 511]
        if e:
            self.nb = nb - (e & 255)
            return e >> 8
        length = LOOKAHEAD + 1
        code = (buf >> (nb - length)) & _MASK[length]
        while code > tab.maxcode[length]:
            length += 1
            code = (buf >> (nb - length)) & _MASK[length]
        self.nb = nb - length
        return tab.vals[code + tab.valoffset[length]] if length <= 16 else 0


def _decode_progressive_scan(segs, comps, mcus, restart: int, interleaved: bool, tables,
                             ss: int, se: int, ah: int, al: int):
    """jdphuff.c: one progressive Huffman scan into each component's
    `coefs`: DC first (the predicted value << Al), DC refinement (one bit a
    block), AC first (the band Ss..Se, values << Al, EOB runs across
    blocks) or AC refinement (a correction bit for each coefficient
    already nonzero that has not got the bit, new coefficients of
    +-1 << Al, EOB runs refining the rest of each band). EOBRUN and the DC
    predictors start at 0 in each restart interval."""
    zz = _NATURAL
    p1, m1 = 1 << al, -1 << al
    for raw, blocks in _restart_intervals(segs, _mcu_blocks(comps, mcus, interleaved), restart):
        bits = _Bits(raw)
        preds = [0] * len(comps)
        eobrun = 0
        for mcu in blocks:
            if ss == 0:
                for ci, base in mcu:
                    coefs = comps[ci].coefs
                    if ah:
                        if bits.get(1):
                            coefs[base] |= p1
                        continue
                    s = bits.symbol(tables[ci][0])
                    if s:
                        preds[ci] += bits.value(s)
                    coefs[base] = preds[ci] << al
                continue
            base = mcu[0][1]
            coefs = comps[0].coefs
            tab = tables[0][1]
            if not ah:  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    s = bits.symbol(tab)
                    r, s = s >> 4, s & 15
                    if s:
                        k += r
                        coefs[base + zz[k]] = bits.value(s) << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits.get(r) if r else 0) - 1
                        break
                    k += 1
                continue
            k = ss  # AC refinement
            if not eobrun:
                while k <= se:
                    s = bits.symbol(tab)
                    r, s = s >> 4, s & 15
                    if s:  # a new coefficient (its size should be 1), then its sign
                        s = p1 if bits.get(1) else m1
                    elif r != 15:
                        eobrun = (1 << r) + (bits.get(r) if r else 0)
                        break
                    # pass r zero coefficients, appending a correction bit to
                    # each nonzero one on the way
                    while k <= se:
                        pos = base + zz[k]
                        c = coefs[pos]
                        if c:
                            if bits.get(1) and not c & p1:
                                coefs[pos] = c + (p1 if c >= 0 else m1)
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        coefs[base + zz[k]] = s
                    k += 1
            if eobrun:  # the rest of the band: correction bits only
                while k <= se:
                    pos = base + zz[k]
                    c = coefs[pos]
                    if c and bits.get(1) and not c & p1:
                        coefs[pos] = c + (p1 if c >= 0 else m1)
                    k += 1
                eobrun -= 1


class _Arith:
    """jdarith.c's decoder over one entropy-coded segment: the registers C
    and A and the shift counter CT (-16 before the first two bytes, -1
    after an error), the segment's bytes, then zeros, which is what
    libjpeg reads at and past the marker that ends it."""
    __slots__ = ("data", "n", "pos", "c", "a", "ct")

    def __init__(self, raw: bytes):
        self.data, self.n, self.pos = raw, len(raw), 0
        self.c = self.a = 0
        self.ct = -16

    def decode(self, st, i: int) -> int:
        """arith_decode: one binary decision on the statistics bin st[i]
        (state index, MPS in bit 7), which it updates."""
        a, ct = self.a, self.ct
        while a < 0x8000:  # renormalisation and data input, T.81 D.2.6
            ct -= 1
            if ct < 0:
                self.c = (self.c << 8) | (self.data[self.pos] if self.pos < self.n else 0)
                self.pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:  # the two initial bytes are in
                        a = 0x8000
            a <<= 1
        self.ct = ct
        sv = st[i]
        e = ARITAB[sv & 0x7F]
        qe = e >> 16
        a -= qe
        temp = a << ct
        if self.c >= temp:  # LPS sub-interval, with the conditional exchange
            self.c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
            else:
                st[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            a = qe
        elif a < 0x8000:  # MPS, renormalising: the conditional exchange
            if a < qe:
                st[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
        self.a = a
        return sv >> 7


def _arith_dc(ad: _Arith, st, ctx: int, lo: int, hi: int):
    """Figures F.19-F.24 for one DC difference with the statistics st (64
    bins) and the block's conditioning context: (difference, next
    context), or (None, ctx) where the magnitude overflows. lo and hi are
    DAC's L and U."""
    if not ad.decode(st, ctx):
        return 0, 0
    sign = ad.decode(st, ctx + 1)
    s = ctx + 2 + sign
    m = ad.decode(st, s)
    if m:
        s = 20  # X1
        while ad.decode(st, s):
            m <<= 1
            if m == 0x8000:
                return None, ctx
            s += 1
    if m < (1 << lo) >> 1:
        nctx = 0
    elif m > (1 << hi) >> 1:
        nctx = 12 + 4 * sign
    else:
        nctx = 4 + 4 * sign
    v = m
    s += 14
    m >>= 1
    while m:
        if ad.decode(st, s):
            v |= m
        m >>= 1
    v += 1
    return (-v if sign else v), nctx


def _arith_ac(ad: _Arith, st, fixed, s: int, k: int, kx: int):
    """Figures F.21-F.24 for the nonzero AC coefficient at zigzag k, whose
    SE bin is st[s]: its value, or None where the magnitude overflows. kx
    is DAC's Kx; the sign has the fixed bin."""
    sign = ad.decode(fixed, 0)
    s += 2
    m = ad.decode(st, s)
    if m and ad.decode(st, s):
        m <<= 1
        s = 189 if k <= kx else 217  # X2
        while ad.decode(st, s):
            m <<= 1
            if m == 0x8000:
                return None
            s += 1
    v = m
    s += 14
    m >>= 1
    while m:
        if ad.decode(st, s):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_band(ad: _Arith, st, fixed, coefs, base: int, ss: int, se: int, al: int,
                kx: int) -> bool:
    """Figure F.20: the coefficients ss..se of one block (values << al);
    False on a spectral or magnitude overflow."""
    k = ss
    while k <= se:
        s = 3 * (k - 1)
        if ad.decode(st, s):  # EOB
            return True
        while not ad.decode(st, s + 1):
            s += 3
            k += 1
            if k > se:
                return False
        v = _arith_ac(ad, st, fixed, s, k, kx)
        if v is None:
            return False
        coefs[base + _NATURAL[k]] = _wrap16(v << al)
        k += 1
    return True


def _arith_refine(ad: _Arith, st, fixed, coefs, base: int, ss: int, se: int,
                  al: int) -> bool:
    """decode_mcu_AC_refine of jdarith.c for one block; False on a spectral
    overflow."""
    zz = _NATURAL
    p1, m1 = 1 << al, -1 << al
    kex = se  # the previous stage's end of block
    while kex > 0 and not coefs[base + zz[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        s = 3 * (k - 1)
        if k > kex and ad.decode(st, s):  # EOB
            return True
        while True:
            pos = base + zz[k]
            c = coefs[pos]
            if c:  # previously nonzero: its correction bit
                if ad.decode(st, s + 2):
                    coefs[pos] = c + (m1 if c < 0 else p1)
                break
            if ad.decode(st, s + 1):  # newly nonzero
                coefs[pos] = m1 if ad.decode(fixed, 0) else p1
                break
            s += 3
            k += 1
            if k > se:
                return False
        k += 1
    return True


def _decode_arith_scan(segs, comps, mcus, restart: int, interleaved: bool, tables,
                       dac, progressive: bool, ss: int, se: int, ah: int, al: int):
    """jdarith.c: one arithmetic-coded scan into each component's `coefs`,
    sequential (each block's DC and AC) or one of the four progressive
    kinds. tables: each scan component's (DC, AC) table numbers, which
    name its statistics (shared by the components that share a table) and
    its DAC conditioning; dac: (L, U, Kx) lists by table number. Each
    restart interval starts with zeroed statistics, predictors and
    contexts and a new decoder; after a spectral or magnitude overflow the
    rest of the interval is left as it is (CT = -1)."""
    lo, hi, kx = dac
    fixed = [113]  # the fixed probability 0.5
    dc_first = not progressive or (ss == 0 and ah == 0)
    for raw, blocks in _restart_intervals(segs, _mcu_blocks(comps, mcus, interleaved), restart):
        ad = _Arith(raw)
        dc_st = {t[0]: [0] * 64 for t in tables}
        ac_st = {t[1]: [0] * 256 for t in tables}
        preds, ctx = [0] * len(comps), [0] * len(comps)
        for mcu in blocks:
            if ad.ct == -1:
                break
            if progressive and ss == 0 and ah:  # DC refinement: the next bit of each
                for ci, base in mcu:
                    if ad.decode(fixed, 0):
                        comps[ci].coefs[base] |= 1 << al
                continue
            if dc_first:
                for ci, base in mcu:
                    td, ta = tables[ci]
                    diff, ctx[ci] = _arith_dc(ad, dc_st[td], ctx[ci], lo[td], hi[td])
                    if diff is None:
                        ad.ct = -1
                        break
                    preds[ci] = _wrap16(preds[ci] + diff)
                    coefs = comps[ci].coefs
                    coefs[base] = _wrap16(preds[ci] << al)
                    if not progressive and not _arith_band(ad, ac_st[ta], fixed, coefs, base, 1,
                                                           63, 0, kx[ta]):
                        ad.ct = -1
                        break
                continue
            base = mcu[0][1]
            ta = tables[0][1]
            if ah:
                ok = _arith_refine(ad, ac_st[ta], fixed, comps[0].coefs, base, ss, se, al)
            else:
                ok = _arith_band(ad, ac_st[ta], fixed, comps[0].coefs, base, ss, se, al, kx[ta])
            if not ok:
                ad.ct = -1


# jdcoefct.c's decompress_smooth_data (libjpeg-turbo's 5x5 window): for
# each estimated coefficient, by zigzag position 1..9, its natural index and
# the weights of the 25 DC values around the block (rows, then columns, -2
# to +2) without and with DC interpolation; the last five have weights only
# with it, the DC's own last
_SMOOTH_KERNELS = (
    (1, [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
     [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
      [-1, -1, 0, 1, 1]]),
    (8, [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0, 0, 0, 0, 0], [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
     [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0], [1, -13, -38, -13, 1],
      [1, 3, 3, 3, 1]]),
    (16, [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0],
          [0, 0, -1, 0, 0]],
     [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]]),
    (9, [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0], [1, -10, 0, 10, -1],
         [0, 1, 0, -1, 0]],
     [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0], [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]),
    (2, [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-1, 13, -24, 13, -1], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
     [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]]),
    (3, None, [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0],
               [0, 0, 0, 0, 0]]),
    (10, None, [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0], [0, -1, 3, -1, 0],
                [0, 0, 0, 0, 0]]),
    (17, None, [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0],
                [0, 0, 0, 0, 0]]),
    (24, None, [[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0], [0, -1, -2, -1, 0],
                [0, 0, 0, 0, 0]]),
    (0, None, [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
               [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]]))


def _smoothing_ok(comps) -> bool:
    """jdcoefct.c's smoothing_ok for a progressive frame: every component's
    DC seen and its table's entries at DC and _SMOOTHED nonzero, and some
    component with a coefficient of zigzag 1..9 not known to its last bit."""
    for c in comps:
        t = c.table.reshape(-1)
        if c.bits[0] < 0 or not all(t[i] for i in (0,) + _SMOOTHED):
            return False
    return any(b != 0 for c in comps for b in c.bits[1:10])


def _smooth(c, blocks: np.ndarray, n_rows: int) -> np.ndarray:
    """decompress_smooth_data's coefficients of component c: blocks (bh, bw,
    64) as decoded, n_rows the frame's iMCU rows. In each block of the
    component's own width and height, a coefficient of zigzag 1..9 that
    is zero and not known to its last bit gets an estimate from the 5x5 DC
    values around it (columns clamped to the image's blocks; rows as
    libjpeg-turbo picks them, which may reach the padding row of an MCU
    below or, on the last iMCU row of a 2-row component, repeat the row
    above), clamped below 1 << Al; where no AC coefficient of 1..9 was ever
    sent, the DC is interpolated too."""
    bits = c.bits
    hb, wb, v = -(-c.height // 8), -(-c.width // 8), c.v
    r = np.arange(hb)
    last = n_rows - 1
    tail = hb % v or v  # block rows of the last iMCU row
    on_last = r // v == last
    row = np.where(on_last, last * tail + r % v, r)  # image_block_row
    rows_n = np.where(on_last, tail * n_rows, v * n_rows)  # image_block_rows
    up = np.where(row > 0, r - 1, r)
    down = np.where(row < rows_n - 1, r + 1, r)
    rows = np.stack([np.where(row > 1, r - 2, up), up, r, down,
                     np.where(row < rows_n - 2, r + 2, down)], 1)
    cols = np.clip(np.arange(wb)[:, None] + np.arange(-2, 3), 0, wb - 1)
    dc = blocks[rows[:, None, :, None], cols[None, :, None, :], 0]  # (hb, wb, 5, 5)
    q = c.table.reshape(-1)
    change_dc = all(b == -1 for b in bits[1:10])
    out = blocks.copy()
    ws = out[:hb, :wb]
    for k, (pos, plain, interp) in enumerate(_SMOOTH_KERNELS, 1):
        kern = interp if change_dc else plain
        if kern is None:
            break
        al = bits[k] if pos else 0
        if pos and al == 0:
            continue
        num = q[0] * (dc * np.asarray(kern, np.int64)).sum((-2, -1))
        pred = ((q[pos] << 7) + np.abs(num)) // (q[pos] << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = (np.where(num >= 0, pred, -pred) + 0x8000) % 0x10000 - 0x8000
        ws[..., pos] = pred if pos == 0 else np.where(ws[..., pos] == 0, pred, ws[..., pos])
    return out


def _upsample(plane: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (h, w) component plane (the
    component's own size, its MCU padding cropped) by (fy, fx) in {1, 2}: fancy
    h2v1, h1v2 and h2v2 (triangle filters with alternating biases, edges
    replicated), or plain replication where a row is 2 samples or less."""
    p = plane.astype(np.int64)
    h, w = p.shape
    if (fy, fx) == (1, 1):
        return plane
    if fx == 2 and w <= 2:  # h2v1_upsample / h2v2_upsample
        return np.repeat(np.repeat(plane, fx, 1), fy, 0)
    if fy == 1:  # h2v1 fancy
        left = np.concatenate([p[:, :1], p[:, :-1]], 1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
        out = np.empty((h, 2 * w), np.int64)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        return out.astype(np.uint8)
    up = np.concatenate([p[:1], p[:-1]], 0)
    down = np.concatenate([p[1:], p[-1:]], 0)
    if fx == 1:  # h1v2 fancy
        out = np.empty((2 * h, w), np.int64)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out.astype(np.uint8)
    out = np.empty((2 * h, 2 * w), np.int64)  # h2v2 fancy
    for rows, near in ((slice(0, None, 2), up), (slice(1, None, 2), down)):
        col = 3 * p + near
        left = np.concatenate([col[:, :1], col[:, :-1]], 1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        out[rows, 0::2] = (3 * col + left + 8) >> 4
        out[rows, 1::2] = (3 * col + right + 7) >> 4
    return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: its tables, ONE_HALF rounding and
    range limit."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + _ONE_HALF) >> _SCALEBITS
    cb_b = (_fix(1.77200) * x + _ONE_HALF) >> _SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + _ONE_HALF
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> _SCALEBITS)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """(H, W) gray or (H, W, 3) RGB uint8 pixels of a JPEG (baseline,
    extended, progressive, arithmetic-coded sequential or progressive), as
    libjpeg-turbo decodes them with its defaults; `path` names the file in
    the errors, all ValueErrors."""
    try:
        return _decode(data, path)
    except (struct.error, IndexError, KeyError) as exc:  # a segment cut short or malformed
        raise ValueError(f"{path}: corrupt JPEG ({type(exc).__name__}: {exc})") from None


def _decode(data: bytes, path: str) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qt = {}
    huff = {}
    # DAC's conditioning by table number (jdmarker.c's defaults): L, U, Kx
    dac = ([0] * 16, [1] * 16, [5] * 16)
    comps, frame, restart, adobe, jfif = None, None, 0, None, False
    progressive = arithmetic = False
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt or truncated JPEG (no marker at {pos})")
        marker = data[pos + 1]
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        if len(body) != n - 2:
            raise ValueError(f"{path}: truncated JPEG segment 0x{marker:02X}")
        pos += 2 + n
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table.reshape(8, 8)
                i += 1 + size
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc_th = body[i]
                bits = tuple(body[i + 1:i + 17])
                vals = tuple(body[i + 17:i + 17 + sum(bits)])
                huff[tc_th] = _Huffman(bits, vals)
                i += 17 + sum(bits)
        elif marker == 0xCC:  # DAC
            if len(body) % 2:
                raise ValueError(f"{path}: corrupt JPEG (DAC of odd length)")
            for index, val in zip(body[0::2], body[1::2]):
                if index >= 32:
                    raise ValueError(f"{path}: corrupt JPEG (DAC table {index})")
                if index >= 16:
                    dac[2][index - 16] = val
                elif val & 15 > val >> 4:
                    raise ValueError(f"{path}: corrupt JPEG (DAC L > U: 0x{val:02X})")
                else:
                    dac[0][index], dac[1][index] = val & 15, val >> 4
        elif marker == 0xDD:  # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:  # APP14
            adobe = body[11]
        elif marker in _SOF_REFUSED:
            raise ValueError(f"{path}: {_SOF_REFUSED[marker]} JPEG is not decoded "
                             "(SOF0-2, SOF9 and SOF10 only)")
        elif marker in _SOF_DECODED:
            progressive, arithmetic = _SOF_DECODED[marker]
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG is not decoded (8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"{path}: {nc}-component JPEG (CMYK, YCCK or other) is not "
                                 "decoded (1 or 3 components only)")
            if h == 0 or w == 0:
                raise ValueError(f"{path}: JPEG of size {w}x{h}")
            comps = []
            for k in range(nc):
                c = _Component()
                c.cid, hv, c.tq = body[6 + 3 * k], body[7 + 3 * k], body[8 + 3 * k]
                c.h, c.v = hv >> 4, hv & 15
                if c.h not in (1, 2) or c.v not in (1, 2):
                    raise ValueError(f"{path}: JPEG sampling factors {c.h}x{c.v} are not "
                                     "decoded (up to 2x2)")
                comps.append(c)
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c.width, c.height = -(-w * c.h // hmax), -(-h * c.v // vmax)
                c.bw, c.bh = mx * c.h, my * c.v
                c.coefs = []
                c.table = None
                c.bits = [-1] * 64
            frame = (h, w, hmax, vmax, mx, my)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            ns = body[0]
            if not 1 <= ns <= 4:
                raise ValueError(f"{path}: corrupt JPEG (a scan of {ns} components)")
            ss, se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if progressive and ((se != 0 if ss == 0 else ss > se or se > 63 or ns != 1)
                                or (ah != 0 and al != ah - 1) or al > 13):
                raise ValueError(f"{path}: bad JPEG progression (Ss {ss}, Se {se}, Ah {ah}, "
                                 f"Al {al})")
            by_id = {c.cid: c for c in comps}
            scomps, tables = [], []
            for k in range(ns):
                cid, td_ta = body[1 + 2 * k], body[2 + 2 * k]
                if cid not in by_id:
                    raise ValueError(f"{path}: JPEG scan names an unknown component {cid}")
                c = by_id[cid]
                if c.tq not in qt:
                    raise ValueError(f"{path}: JPEG without quantisation table {c.tq}")
                if arithmetic:
                    tables.append((td_ta >> 4, td_ta & 15))
                else:  # the Huffman tables this scan reads, as they stand now
                    dct = act = None
                    if not progressive or (ss == 0 and ah == 0):
                        dct = huff.get(td_ta >> 4)
                        if dct is None or any(s > 15 for s in dct.vals):
                            raise ValueError(f"{path}: JPEG scan without a valid DC table")
                    if not progressive or ss:
                        act = huff.get(0x10 | (td_ta & 15))
                        if act is None:
                            raise ValueError(f"{path}: JPEG scan without its AC table")
                    tables.append((dct, act))
                if not c.coefs:
                    c.coefs = [0] * (c.bw * c.bh * 64)
                    c.table = qt[c.tq]  # latched at the component's first scan
                if progressive:  # where libjpeg only warns (bogus progression), decode on
                    c.bits[ss:se + 1] = [al] * (se + 1 - ss)
                scomps.append(c)
            if ns == 1:  # single-component scan: one block an MCU, over the component's blocks
                mcus = (-(-scomps[0].width // 8), -(-scomps[0].height // 8))
            else:
                mcus = frame[4:]
            segs, pos = _scan_segments(data, pos, path)
            if arithmetic:
                _decode_arith_scan(segs, scomps, mcus, restart, ns > 1, tables, dac,
                                   progressive, ss, se, ah, al)
            elif progressive:
                _decode_progressive_scan(segs, scomps, mcus, restart, ns > 1, tables,
                                         ss, se, ah, al)
            else:
                _decode_scan(segs, scomps, mcus, restart, ns > 1, tables)
    if frame is None or comps is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    h, w, hmax, vmax, _, my = frame
    for c in comps:
        if not c.coefs:
            raise ValueError(f"{path}: JPEG component {c.cid} has no scan")
    smooth = progressive and _smoothing_ok(comps)
    planes = []
    for c in comps:
        blocks = np.asarray(c.coefs, np.int64).reshape(c.bh, c.bw, 64)
        if smooth:
            blocks = _smooth(c, blocks, my)
        plane = idct_islow(blocks.reshape(-1, 8, 8) * c.table)
        plane = plane.reshape(c.bh, c.bw, 8, 8).swapaxes(1, 2)
        plane = plane.reshape(c.bh * 8, c.bw * 8)[:c.height, :c.width]
        planes.append(_upsample(plane, vmax // c.v, hmax // c.h)[:h, :w])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    # jdapimin.c's guess of the color space: JFIF means YCbCr, else the
    # Adobe transform, else the component ids ('R', 'G', 'B' means RGB)
    if not jfif and (adobe == 0 or (adobe is None and [c.cid for c in comps] == [82, 71, 66])):
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)
