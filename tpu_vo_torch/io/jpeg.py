"""Baseline JPEG in numpy, with libjpeg-turbo's integer arithmetic: the
decoder that PIL and cv2 run with their defaults, and the gray encoder
that cv2.imencode runs.

- decode(data, path): SOF0 and SOF1 (8-bit, Huffman), DHT, DQT (8- and
  16-bit tables), DRI with RSTn markers, interleaved and single-component
  scans, 1 or 3 components with sampling factors up to 2x2, any size
  (the MCU padding is cropped). Huffman decoding is bit-serial in Python
  (a 9-bit lookahead table, libjpeg's maxcode search above it); all that
  follows runs over every block at once: dequantisation, jidctint
  (JDCT_ISLOW), libjpeg-turbo's fancy h2v1, h1v2 and h2v2 upsampling
  (alternating biases, edges replicated) and jdcolor.c's table-driven
  YCbCr -> RGB. What it does not decode (progressive, arithmetic coding,
  12-bit, lossless, hierarchical, 2 or 4 components such as Adobe CMYK
  and YCCK) raises a ValueError naming the file and the reason.
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
# what a decode refuses, by SOF marker
_SOF_REFUSED = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
                0xC6: "hierarchical", 0xC7: "hierarchical", 0xC9: "arithmetic-coded",
                0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded",
                0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}


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
    __slots__ = ("cid", "h", "v", "tq", "width", "height", "bw", "bh", "coefs", "table")


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


def _decode_scan(segs, comps, mcus, restart: int, interleaved: bool, tables):
    """Huffman-decode one baseline scan into each component's `coefs`
    (a flat list, 64 natural-order entries a block)."""
    zz = ZIGZAG.tolist() + [63] * 16  # jpeg_natural_order's guard entries
    mask = [(1 << n) - 1 for n in range(65)]
    # per component of the scan: (coefs, dc table, ac table, block offsets of an MCU)
    plan = []
    for c, (dct, act) in zip(comps, tables):
        if interleaved:
            offs = [(y * c.bw + x) * 64 for y in range(c.v) for x in range(c.h)]
        else:
            offs = [0]
        plan.append((c, dct, act, offs))
    mx, my = mcus
    per_seg = restart or mx * my
    n_mcu = 0
    for seg_i in range((mx * my + per_seg - 1) // per_seg):
        raw = segs[seg_i] if seg_i < len(segs) else b""
        pad = (-len(raw)) % 4 + 8  # data that runs out reads as zeros, as libjpeg fills it
        words = np.frombuffer(raw + b"\x00" * pad, ">u4").tolist()
        nw = len(words)
        wp, buf, nb = 0, 0, 0
        preds = [0] * len(plan)
        for _ in range(min(per_seg, mx * my - n_mcu)):
            my_i, mx_i = divmod(n_mcu, mx)
            n_mcu += 1
            for ci, (c, dct, act, offs) in enumerate(plan):
                coefs = c.coefs
                if interleaved:
                    origin = (my_i * c.v * c.bw + mx_i * c.h) * 64
                else:
                    origin = (my_i * c.bw + mx_i) * 64
                for off in offs:
                    base = origin + off
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
    """(H, W) gray or (H, W, 3) RGB uint8 pixels of a baseline JPEG, as
    libjpeg-turbo decodes them with its defaults; `path` names the file
    in the errors, all ValueErrors."""
    try:
        return _decode(data, path)
    except (struct.error, IndexError, KeyError) as exc:  # a segment cut short or malformed
        raise ValueError(f"{path}: corrupt JPEG ({type(exc).__name__}: {exc})") from None


def _decode(data: bytes, path: str) -> np.ndarray:
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qt = {}
    huff = {}
    comps, frame, restart, adobe, jfif = None, None, 0, None, False
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
        elif marker == 0xDD:  # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:  # APP14
            adobe = body[11]
        elif marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG is not decoded (baseline only)")
        elif marker in _SOF_REFUSED:
            raise ValueError(f"{path}: {_SOF_REFUSED[marker]} JPEG is not decoded "
                             "(baseline only)")
        elif marker in (0xC0, 0xC1):  # SOF0, SOF1
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
            frame = (h, w, hmax, vmax, mx, my)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            ns = body[0]
            by_id = {c.cid: c for c in comps}
            scomps, tables = [], []
            for k in range(ns):
                cid, td_ta = body[1 + 2 * k], body[2 + 2 * k]
                if cid not in by_id:
                    raise ValueError(f"{path}: JPEG scan names an unknown component {cid}")
                c = by_id[cid]
                if c.tq not in qt:
                    raise ValueError(f"{path}: JPEG without quantisation table {c.tq}")
                dct, act = huff.get(td_ta >> 4), huff.get(0x10 | (td_ta & 15))
                if dct is None or act is None:
                    raise ValueError(f"{path}: JPEG scan without its Huffman tables")
                if not c.coefs:
                    c.coefs = [0] * (c.bw * c.bh * 64)
                    c.table = qt[c.tq]  # latched at the component's first scan
                scomps.append(c)
                tables.append((dct, act))
            if ns == 1:  # single-component scan: one block an MCU, over the component's blocks
                mcus = (-(-scomps[0].width // 8), -(-scomps[0].height // 8))
            else:
                mcus = frame[4:]
            segs, pos = _scan_segments(data, pos, path)
            _decode_scan(segs, scomps, mcus, restart, ns > 1, tables)
    if frame is None or comps is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    h, w, hmax, vmax, _, _ = frame
    planes = []
    for c in comps:
        if not c.coefs:
            raise ValueError(f"{path}: JPEG component {c.cid} has no scan")
        coefs = np.asarray(c.coefs, np.int64).reshape(-1, 8, 8) * c.table
        plane = idct_islow(coefs).reshape(c.bh, c.bw, 8, 8).swapaxes(1, 2)
        plane = plane.reshape(c.bh * 8, c.bw * 8)[:c.height, :c.width]
        planes.append(_upsample(plane, vmax // c.v, hmax // c.h)[:h, :w])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    # jdapimin.c's guess of the color space: JFIF means YCbCr, else the
    # Adobe transform, else the component ids ('R', 'G', 'B' means RGB)
    if not jfif and (adobe == 0 or (adobe is None and [c.cid for c in comps] == [82, 71, 66])):
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)
