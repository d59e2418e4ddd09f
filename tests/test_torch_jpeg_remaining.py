"""The JPEG kinds tpu_vo's reader reads beyond the port's earlier ones,
through the port's two readers, io/dataset.load_frame (io/jpeg.decode)
and the native loader (csrc/jpeg_decode.cpp), against tpu_vo's two,
load_frame (PIL) and its libjpeg build of native/vo_loader.cpp, on a
corpus made here from a numpy seed:

  - sampling factors past 2x2 (libjpeg's 1 to 4): 4:1:1, 4:1:0, h1v4,
    3:1 and chroma above luma, sequential, progressive and arithmetic,
    at odd sizes (the system libjpeg through the writer of
    tests/test_torch_jpeg_progressive.py, extended here with each
    component's factors);
  - 4-component files: PIL's CMYK (Adobe APP14, transform 0) at several
    qualities, and the writer's CMYK with and without the Adobe marker
    and YCCK (transform 2), sequential, progressive and arithmetic;
  - lossless SOF3 from lossless_jpeg below: every predictor, point
    transforms 0, 1 and 3, restart intervals, 1, 3 and 4 components with
    sampling factors, interleaved and one scan a component, a Huffman
    table that reaches category 16 (and differences of 32768), 1-sample
    wide and 1-row frames;
  - what PIL refuses: fractional sampling ratios, a factor of 5, more
    than 10 blocks in an interleaved MCU, 2 components, lossless scans
    with Ss 0 or 8, Se or Ah nonzero or Al 8, a lossless restart interval
    that is not whole MCU rows, a lossless frame in YCbCr or YCCK (libjpeg
    converts no color in lossless mode), a lossless file labelled SOF11: the
    Python reader raises naming the file and the reason, the native
    loader skips the file between two good ones;
  - PIL's cmyk2rgb (cmyk_to_rgb) on all 65,536 (c, k) pairs.

Every file equals tpu_vo's load_frame, gray and gray=False. tpu_vo's
native build (libjpeg-turbo 2.1 here) reads a 4-component file's first
three CMYK output channels as RGB, and has no lossless decoder (its
libjpeg error handler exits the process): on 4-component files the test
holds it to rgb_to_gray of those three channels and the port to PIL, and
checks that it refuses lossless files in a child process.
The committed files in tpu_vo_torch/data/jpeg/kinds/ (frames 0-4 of the
main path, one of each kind at 1241x376) are checked against their
manifest; `python -m tests.test_torch_jpeg_remaining` (from the
repository's root) rewrites them (needs jpeglib.h, PIL and tpu_vo).
`python -m pytest tests/test_torch_jpeg_remaining.py -p no:cacheprovider`.
"""

import heapq
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_jpeg_progressive import SCRIPTS, script_text, sof
from tests.test_torch_native_codecs import (_jax_read, _pil_rgb,  # noqa: F401
                                            _port_read, jax_native)
from tpu_vo.io import dataset as jdataset
from tpu_vo_torch.io import dataset, jpeg, native_loader
from _torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- a lossless (SOF3) encoder ----------------------------------------------

def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def huffman_table(freq):
    """(counts by length 1..16, symbols) of an optimal table for the
    frequencies of categories 0..16, lengths limited to 16 as jchuff.c's
    jpeg_gen_optimal_table limits them (a reserved symbol keeps the
    all-ones code out)."""
    f = [max(int(x), 0) for x in freq] + [1]  # the reserved symbol, last
    heap = [(x, i, [i]) for i, x in enumerate(f) if x > 0]
    size = [0] * len(f)
    heapq.heapify(heap)
    n = len(f)
    while len(heap) > 1:
        a, b = heapq.heappop(heap), heapq.heappop(heap)
        for i in a[2] + b[2]:
            size[i] += 1
        heapq.heappush(heap, (a[0] + b[0], n, a[2] + b[2]))
        n += 1
    bits = [0] * 33
    for i, s in enumerate(size):
        if f[i] > 0:
            bits[max(s, 1)] += 1
    for i in range(32, 16, -1):  # Annex K.3's length limiting
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code goes
    order = sorted((s, i) for i, s in enumerate(size[:-1]) if f[i] > 0)
    return bits[1:17], [i for _, i in order]


def _categories(d: np.ndarray):
    """(category, extra bits) of differences in (-32768, 32768]."""
    a = np.abs(d)
    s = np.zeros_like(a)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    s[d == 32768] = 16
    extra = np.where(d < 0, d - 1, d) & ((np.int64(1) << np.minimum(s, 15)) - 1)
    return s, np.where(s == 16, 0, extra)


def _pack(code: np.ndarray, length: np.ndarray, sym: np.ndarray, extra: np.ndarray) -> bytes:
    """The byte-stuffed bits of each difference's code (code, length) then
    its extra bits, padded with 1-bits."""
    nx = np.where(sym == 16, 0, sym)
    val = (code << nx) | extra
    ln = length + nx
    total = int(ln.sum())
    start = np.cumsum(ln) - ln
    owner = np.repeat(np.arange(ln.size), ln)
    shift = np.repeat(ln, ln) - 1 - (np.arange(total) - start[owner])
    bits = ((val[owner] >> shift) & 1).astype(np.uint8)
    data = np.packbits(np.concatenate([bits, np.ones((-total) % 8, np.uint8)]))
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _canonical(bits, vals):
    code, length = np.zeros(17, np.int64), np.zeros(17, np.int64)
    c = k = 0
    for n, cnt in enumerate(bits, 1):
        for _ in range(cnt):
            code[vals[k]], length[vals[k]] = c, n
            c += 1
            k += 1
        c <<= 1
    return code, length


def _predict(x: np.ndarray, psv: int, first_rows, init: int) -> np.ndarray:
    """The differences (x - prediction) mod 2^16, in (-32768, 32768], of
    a component's samples x (rows, width), the rows in first_rows
    predicted as T.81 H.1.2.1's first line."""
    x = x.astype(np.int64)
    pred = np.zeros_like(x)
    left = np.concatenate([np.zeros((x.shape[0], 1), np.int64), x[:, :-1]], 1)
    up = np.concatenate([np.zeros((1, x.shape[1]), np.int64), x[:-1]], 0)
    ul = np.concatenate([np.zeros((1, x.shape[1]), np.int64), left[:-1]], 0)
    ra, rb, rc = left, up, ul
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = up[:, 0]
    for r in first_rows:
        pred[r] = left[r]
        pred[r, 0] = init
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def lossless_jpeg(channels, sampling=None, psv=1, pt=0, restart_rows=0, ids=None, jfif=False,
                  adobe=None, interleave=True, two_tables=False, diffs=None) -> bytes:
    """A lossless (SOF3, 8-bit) JPEG of (H, W) gray or (H, W, nc) uint8
    channels: component k is channel k at its sampling factors (h, v)
    (1x1 each by default; a component below the largest factors takes
    every (hmax / h)-th column and (vmax / v)-th row), the samples >> pt,
    predictor psv, a restart every `restart_rows` MCU rows, component
    ids `ids` (1, 2, ... by default), a JFIF APP0 and an Adobe APP14 of
    transform `adobe` where asked, one interleaved scan or a scan a
    component, one optimal Huffman table (two, the first component's and
    the others', with two_tables) holding all 17 categories. `diffs`, a
    function of (component index, shape) returning differences, replaces
    the predicted ones (every category, 32768 too, then decodes)."""
    img = np.asarray(channels, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    hgt, wid, nc = img.shape
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mx, my = -(-wid // hmax), -(-hgt // vmax)
    init = 1 << (8 - pt - 1)
    comp_d = []
    for k, (h, v) in enumerate(sampling):
        plane = img[::vmax // v, ::hmax // h, k] >> pt
        rows = plane.shape[0]
        step = (restart_rows * v if interleave else restart_rows) or rows
        d = _predict(plane, psv, range(0, rows, step), init)
        if diffs is not None:
            d = diffs(k, d.shape)
        comp_d.append(d)
    table_of = [min(k, 1) if two_tables else 0 for k in range(nc)]

    def scan_symbols(ks):
        """Each restart interval's differences in scan order, by table."""
        if len(ks) > 1:
            grid = []
            for k in ks:
                h, v = sampling[k]
                g = np.zeros((my * v, mx * h), np.int64)
                g[:comp_d[k].shape[0], :comp_d[k].shape[1]] = comp_d[k]
                grid.append(g.reshape(my, v, mx, h).transpose(0, 2, 1, 3).reshape(my, mx, -1))
            mcus = np.concatenate(grid, 2)
            tabs = np.concatenate([[table_of[k]] * (sampling[k][0] * sampling[k][1])
                                   for k in ks])
            per = restart_rows or my
            return [(mcus[r:r + per].reshape(-1), np.tile(tabs, mcus[r:r + per].shape[0] * mx))
                    for r in range(0, my, per)]
        d = comp_d[ks[0]]
        per = restart_rows or d.shape[0]
        return [(d[r:r + per].reshape(-1), np.full(d[r:r + per].size, table_of[ks[0]]))
                for r in range(0, d.shape[0], per)]

    scan_sets = [list(range(nc))] if interleave else [[k] for k in range(nc)]
    intervals = [scan_symbols(ks) for ks in scan_sets]
    freq = np.ones((2, 17), np.int64)
    for iv in intervals:
        for d, t in iv:
            s, _ = _categories(d)
            np.add.at(freq, (t, s), 1)
    tables = [huffman_table(freq[t]) for t in range(2 if two_tables else 1)]
    codes = [_canonical(*t) for t in tables]
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    out += _segment(0xC3, struct.pack(">BHHB", 8, hgt, wid, nc) + b"".join(
        bytes([ids[k], (h << 4) | v, 0]) for k, (h, v) in enumerate(sampling)))
    out += b"".join(_segment(0xC4, bytes([t]) + bytes(bits) + bytes(vals))
                    for t, (bits, vals) in enumerate(tables))
    if restart_rows:
        per_row = mx if interleave else None
        n = restart_rows * (per_row if per_row else comp_d[0].shape[1])
        out += _segment(0xDD, struct.pack(">H", n))
    for ks, iv in zip(scan_sets, intervals):
        if restart_rows and not interleave:  # a row of this component's samples an MCU row
            out += _segment(0xDD, struct.pack(">H", restart_rows * comp_d[ks[0]].shape[1]))
        out += _segment(0xDA, bytes([len(ks)]) + b"".join(
            bytes([ids[k], table_of[k] << 4]) for k in ks) + bytes([psv, 0, pt]))
        for j, (d, t) in enumerate(iv):
            s, extra = _categories(d)
            code, length = (np.stack([c[i] for c in codes])[t, s] for i in (0, 1))
            out += _pack(code, length, s, extra)
            if j + 1 < len(iv):
                out += bytes([0xFF, 0xD0 + j % 8])
    return out + b"\xff\xd9"


# --- the system libjpeg's files -------------------------------------------

# jpeg_writer4 IN OUT WIDTH HEIGHT SPACE QUALITY FACTORS ARITH RESTART ADOBE SCRIPT:
# IN holds HEIGHT x WIDTH x 3 (RGB, for SPACE ycc) or x 4 (CMYK, for SPACE
# cmyk or ycck) bytes; SPACE is the file's color space; FACTORS is "-"
# (libjpeg's defaults) or each component's "h,v" joined by ";"; ARITH 1
# codes arithmetically; RESTART is the interval in MCUs; ADOBE 0 leaves out
# the Adobe marker libjpeg writes for CMYK and YCCK; SCRIPT is "-"
# (sequential), "simple" (jpeg_simple_progression) or scans
# "c,c,...:Ss-Se:Ah:Al" joined by ";"
WRITER_SOURCE = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc != 12) return 2;
  const int w = atoi(argv[3]), h = atoi(argv[4]);
  const char *space = argv[5];
  const int nc = strcmp(space, "ycc") == 0 ? 3 : 4;
  const size_t n = (size_t)w * h * nc;
  unsigned char *px = (unsigned char *)malloc(n);
  FILE *in = fopen(argv[1], "rb");
  if (!in || fread(px, 1, n, in) != n) return 3;
  fclose(in);
  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = fopen(argv[2], "wb");
  if (!out) return 4;
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = nc;
  cinfo.in_color_space = nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  jpeg_set_colorspace(&cinfo, nc == 3 ? JCS_YCbCr
                              : strcmp(space, "ycck") == 0 ? JCS_YCCK : JCS_CMYK);
  jpeg_set_quality(&cinfo, atoi(argv[6]), TRUE);
  if (strcmp(argv[7], "-") != 0) {
    char *q = argv[7];
    for (int k = 0; k < nc && *q; k++) {
      cinfo.comp_info[k].h_samp_factor = (int)strtol(q, &q, 10);
      cinfo.comp_info[k].v_samp_factor = (int)strtol(q + 1, &q, 10);
      if (*q == ';') ++q;
    }
  }
  cinfo.arith_code = atoi(argv[8]);
  cinfo.restart_interval = atoi(argv[9]);
  if (nc == 4) cinfo.write_Adobe_marker = atoi(argv[10]);
  const char *p = argv[11];
  if (strcmp(p, "simple") == 0) {
    jpeg_simple_progression(&cinfo);
  } else if (strcmp(p, "-") != 0) {
    jpeg_scan_info *scans = (jpeg_scan_info *)calloc(64, sizeof(jpeg_scan_info));
    int ns = 0;
    char *q = (char *)p;
    while (*q && ns < 64) {
      jpeg_scan_info *s = &scans[ns++];
      for (;;) {
        s->component_index[s->comps_in_scan++] = (int)strtol(q, &q, 10);
        if (*q != ',') break;
        ++q;
      }
      s->Ss = (int)strtol(q + 1, &q, 10);
      s->Se = (int)strtol(q + 1, &q, 10);
      s->Ah = (int)strtol(q + 1, &q, 10);
      s->Al = (int)strtol(q + 1, &q, 10);
      if (*q == ';') ++q;
    }
    cinfo.scan_info = scans;
    cinfo.num_scans = ns;
  }
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = px + (size_t)cinfo.next_scanline * w * nc;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  return 0;
}
"""


def build_writer(directory: str) -> str:
    """WRITER_SOURCE built with the system libjpeg into directory."""
    src = os.path.join(directory, "jpeg_writer4.c")
    exe = os.path.join(directory, "jpeg_writer4")
    with open(src, "w") as f:
        f.write(WRITER_SOURCE)
    subprocess.run(["g++", "-x", "c++", "-O1", src, "-o", exe, "-ljpeg"], check=True,
                   capture_output=True)
    return exe


def write_jpeg(exe: str, path: str, pixels: np.ndarray, space: str, quality: int,
               factors=None, arith=False, restart=0, adobe=True, script="-") -> bytes:
    """A JPEG of (H, W, 3) RGB (space "ycc") or (H, W, 4) CMYK (space
    "cmyk" or "ycck") uint8 pixels through the writer; factors is a list of
    (h, v) or None; script is "-", "simple" or a name in SCRIPTS."""
    px = np.ascontiguousarray(pixels, np.uint8)
    raw = path + ".raw"
    px.tofile(raw)
    text = script if script in ("-", "simple") else script_text(script, px.shape[2])
    fac = "-" if factors is None else ";".join(f"{h},{v}" for h, v in factors)
    subprocess.run([exe, raw, path, str(px.shape[1]), str(px.shape[0]), space, str(quality),
                    fac, str(int(arith)), str(restart), str(int(adobe)), text], check=True,
                   capture_output=True)
    os.remove(raw)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    check = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                           input="#include <stdio.h>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    if check.returncode != 0:
        pytest.skip(f"jpeglib.h missing: {check.stderr.strip()}")
    return build_writer(str(tmp_path_factory.mktemp("jpeg_writer4")))


def _cmyk(seed: int, h: int, w: int) -> np.ndarray:
    """Smooth CMYK with noise: K from the mean of an RGB image's channels."""
    rgb = _pil_rgb(seed, h, w).astype(np.int64)
    k = np.clip(200 - rgb.mean(-1), 0, 255)
    return np.concatenate([255 - rgb, k[..., None]], -1).astype(np.uint8)


def _frame_of_pil_cmyk(path: str) -> np.ndarray:
    """What tpu_vo's native build makes of a 4-component file: libjpeg's C,
    M and Y output (the bytes PIL inverts back) through rgb_to_gray."""
    with Image.open(path) as im:
        assert im.mode == "CMYK"
        cmy = 255 - np.asarray(im, np.int64)[..., :3]
    return ((cmy[..., 2] * 3735 + cmy[..., 1] * 19235 + cmy[..., 0] * 9798 + (1 << 14))
            >> 15).astype(np.uint8)


# Files on which tpu_vo's native build (libjpeg-turbo 2.1) and PIL (3.1)
# disagree in block smoothing, as in test_torch_jpeg_progressive's
# LIBJPEG_21_SMOOTHING_DIFFERS: 2.1 picks other neighbour rows where a
# component's iMCU row holds 2 or 4 block rows. The port follows PIL.
LIBJPEG_21_SMOOTHING_DIFFERS = {"410_dc_only", "h1v4_partial", "h1v4_dc_only", "h1v4_al1_dc",
                                "h2v4_partial", "h2v4_dc_only", "h2v4_al1_dc"}


def _every_reader(jax_native, d, name: str, kind: str):
    """The file d/name (alone in d) through the port's Python and native
    readers against tpu_vo's load_frame, gray and in color, and through
    tpu_vo's native build: its own frame where kind is "dct", rgb_to_gray
    of libjpeg's C, M and Y where "cmyk" (4 components); not at all where
    "lossless" (its libjpeg exits on SOF3; test_tpu_vo_native_refuses_lossless)."""
    path = str(d / name)
    want = jdataset.load_frame(path)
    np.testing.assert_array_equal(dataset.load_frame(path), want)
    np.testing.assert_array_equal(_port_read(d), want)
    np.testing.assert_array_equal(dataset.load_frame(path, gray=False),
                                  jdataset.load_frame(path, gray=False))
    if kind == "cmyk":
        np.testing.assert_array_equal(_jax_read(jax_native, d), _frame_of_pil_cmyk(path))
    elif kind == "dct" and not np.array_equal(_jax_read(jax_native, d), want):
        assert os.path.splitext(name)[0] in LIBJPEG_21_SMOOTHING_DIFFERS, name


# sampling layouts past 2x2: each component's (h, v), luma first
LAYOUTS = {"411": [(4, 1), (1, 1), (1, 1)], "410": [(4, 2), (1, 1), (1, 1)],
           "h1v4": [(1, 4), (1, 1), (1, 1)], "31": [(3, 1), (1, 1), (1, 1)],
           "h2v4": [(2, 4), (1, 1), (1, 1)], "chroma_up": [(1, 1), (2, 2), (2, 2)],
           "mixed": [(4, 1), (2, 1), (1, 1)]}
# (name, arith, restart, script)
PROCESSES = {"seq": (False, 0, "-"), "seq_rst": (False, 2, "-"), "prog": (False, 0, "simple"),
             "arith": (True, 3, "-"), "arith_prog": (True, 0, "simple")}
SIZES = ((21, 35), (37, 53), (9, 13))
SAMPLING_CASES = []
for _i, (_lay, _f) in enumerate(LAYOUTS.items()):
    for _j, (_proc, (_arith, _rst, _script)) in enumerate(PROCESSES.items()):
        SAMPLING_CASES.append((f"{_lay}_{_proc}", _f, dict(arith=_arith, restart=_rst,
                                                          script=_script),
                               SIZES[(_i + _j) % len(SIZES)]))
for _lay in ("410", "h1v4", "h2v4"):  # block smoothing over iMCU rows of 2 and 4 block rows
    for _script in ("partial", "dc_only", "al1_dc"):
        SAMPLING_CASES.append((f"{_lay}_{_script}", LAYOUTS[_lay], dict(script=_script),
                               (45, 29)))
# three 2x2 components in a scan each: 12 blocks an MCU, but never in one scan
SAMPLING_CASES.append(("s222_each", [(2, 2)] * 3, dict(script="each_seq"), (21, 35)))
SCRIPTS["each_seq"] = [("each", 0, 63, 0, 0)]


@pytest.mark.parametrize("name,factors,kw,size", SAMPLING_CASES,
                         ids=[c[0] for c in SAMPLING_CASES])
def test_sampling_factors_equal_every_reader(writer, jax_native, tmp_path, name, factors, kw,
                                            size):
    data = write_jpeg(writer, str(tmp_path / f"{name}.jpg"),
                      _pil_rgb(len(name) + size[0], *size), "ycc", 85, factors=factors, **kw)
    frame_factors = [data[data.index(b"\xff" + bytes([sof(data)])) + 11 + 3 * k] for k in range(3)]
    assert frame_factors == [(h << 4) | v for h, v in factors]
    _every_reader(jax_native, tmp_path, f"{name}.jpg", "dct")


# 4-component files: (name, space, kwargs of write_jpeg, size); PIL's below
CMYK_CASES = [
    ("cmyk_seq", "cmyk", dict(), (21, 35)),
    ("cmyk_prog_rst", "cmyk", dict(script="simple", restart=2), (37, 53)),
    ("cmyk_arith", "cmyk", dict(arith=True, restart=1), (21, 35)),
    ("cmyk_no_adobe", "cmyk", dict(adobe=False), (21, 35)),
    ("cmyk_sub", "cmyk", dict(factors=[(2, 2), (1, 1), (1, 2), (2, 1)]), (9, 13)),
    ("ycck_seq", "ycck", dict(), (21, 35)),
    ("ycck_prog", "ycck", dict(script="simple"), (37, 53)),
    ("ycck_arith", "ycck", dict(arith=True, restart=3), (21, 35)),
    ("ycck_arith_prog", "ycck", dict(arith=True, script="simple"), (9, 13)),
    ("ycck_411", "ycck", dict(factors=[(4, 1), (1, 1), (1, 1), (4, 1)], script="partial"),
     (45, 29)),
    ("ycck_no_adobe", "ycck", dict(adobe=False), (21, 35)),
]


@pytest.mark.parametrize("name,space,kw,size", CMYK_CASES, ids=[c[0] for c in CMYK_CASES])
def test_cmyk_and_ycck_equal_every_reader(writer, jax_native, tmp_path, name, space, kw, size):
    data = write_jpeg(writer, str(tmp_path / f"{name}.jpg"), _cmyk(len(name), *size), space, 80,
                      **kw)
    adobe = data.find(b"\xff\xee\x00\x0eAdobe")
    assert (adobe >= 0) == kw.get("adobe", True)
    if adobe >= 0:
        assert data[adobe + 15] == (2 if space == "ycck" else 0)  # the transform
    _every_reader(jax_native, tmp_path, f"{name}.jpg", "cmyk")


@pytest.mark.parametrize("quality,size", [(10, (21, 35)), (50, (16, 16)), (95, (37, 53))])
def test_pil_cmyk_equals_every_reader(jax_native, tmp_path, quality, size):
    """PIL's CMYK files: Adobe APP14 of transform 0, the inks inverted."""
    Image.fromarray(_cmyk(quality, *size), "CMYK").save(tmp_path / "cmyk.jpg", quality=quality)
    _every_reader(jax_native, tmp_path, "cmyk.jpg", "cmyk")


def test_cmyk_to_rgb_is_pils_on_every_pair():
    """cmyk_to_rgb against PIL's CMYK -> RGB on all 65,536 (c, k) pairs
    (m and y run the same formula: they take the pair mirrored)."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    pil_cmyk = np.stack([c, 255 - c, (c + k) % 256, k], -1).astype(np.uint8)
    want = np.asarray(Image.fromarray(pil_cmyk, "CMYK").convert("RGB"))
    # libjpeg's output is what PIL's "CMYK;I" raw mode inverts
    np.testing.assert_array_equal(jpeg.cmyk_to_rgb(255 - pil_cmyk), want)


def _image(seed: int, h: int, w: int, nc: int) -> np.ndarray:
    """Smooth channels with noise, a flat run and the extremes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    ch = np.stack([128 + 100 * np.sin(x / 4.0 + k) * np.cos(y / 6.0 - k) for k in range(nc)], -1)
    img = np.clip(ch + rng.normal(0, 10, (h, w, nc)), 0, 255).astype(np.uint8)
    img[:2, :3] = 0
    img[-1, -2:] = 255
    return img


def _with_32768(k, shape):
    """Differences of every category, a tenth of them 32768."""
    rng = np.random.default_rng(100 + k)
    d = rng.integers(-300, 301, shape)
    return np.where(rng.random(shape) < 0.1, 32768, d)


# lossless files: (name, image (h, w, nc), kwargs of lossless_jpeg)
LOSSLESS_CASES = []
for _psv in range(1, 8):
    for _pt, _rst in ((0, 0), (1, 2), (3, 1)):
        LOSSLESS_CASES.append((f"gray_p{_psv}_pt{_pt}_rst{_rst}", (21, 35, 1),
                               dict(psv=_psv, pt=_pt, restart_rows=_rst)))
    LOSSLESS_CASES.append((f"rgb_p{_psv}", (17, 23, 3), dict(psv=_psv, pt=_psv % 3,
                                                            restart_rows=_psv % 3)))
LOSSLESS_CASES += [
    ("rgb_sub22_two_tables", (21, 35, 3), dict(sampling=[(2, 2), (1, 1), (1, 1)], psv=7,
                                               two_tables=True, restart_rows=2)),
    ("rgb_411_each", (21, 35, 3), dict(sampling=[(4, 1), (1, 1), (1, 1)], psv=4,
                                       interleave=False, restart_rows=1)),
    ("rgb_chroma_up", (13, 9, 3), dict(sampling=[(1, 1), (2, 2), (1, 2)], psv=6)),
    ("rgb_adobe0", (13, 9, 3), dict(adobe=0, psv=2)),
    ("rgb_ids", (13, 9, 3), dict(ids=[82, 71, 66], psv=3)),
    ("cmyk", (21, 35, 4), dict(psv=5, restart_rows=2)),
    ("cmyk_adobe0_sub", (21, 35, 4), dict(adobe=0, sampling=[(2, 2), (1, 1), (1, 1), (2, 2)],
                                          psv=1)),
    ("gray_v2_each_rst3", (21, 35, 1), dict(sampling=[(1, 2)], restart_rows=3, psv=4)),
    ("gray_h1v2_s22_each", (21, 35, 3), dict(sampling=[(1, 2), (2, 2), (2, 1)],
                                             interleave=False, restart_rows=3, psv=7)),
    ("gray_32768", (21, 35, 1), dict(diffs=_with_32768, psv=6, pt=2)),
    ("rgb_32768", (13, 9, 3), dict(diffs=_with_32768, psv=4, restart_rows=2,
                                   sampling=[(2, 1), (1, 1), (1, 1)])),
    ("one_wide", (21, 1, 1), dict(psv=7, restart_rows=2)),
    ("one_row", (1, 35, 1), dict(psv=5)),
    ("one_by_one_rgb", (1, 1, 3), dict(psv=6)),
]


@pytest.mark.parametrize("name,shape,kw", LOSSLESS_CASES, ids=[c[0] for c in LOSSLESS_CASES])
def test_lossless_equals_every_reader(jax_native, tmp_path, name, shape, kw):
    img = _image(len(name), *shape)
    data = lossless_jpeg(img[..., 0] if shape[2] == 1 else img, **kw)
    (tmp_path / f"{name}.jpg").write_bytes(data)
    assert sof(data) == 0xC3
    _every_reader(jax_native, tmp_path, f"{name}.jpg", "lossless")
    if shape[2] < 4 and kw.get("diffs") is None and kw.get("sampling") is None:
        sent = (img >> kw.get("pt", 0)) << kw.get("pt", 0)  # each sample as it was sent
        np.testing.assert_array_equal(dataset.load_frame(str(tmp_path / f"{name}.jpg"),
                                                         gray=shape[2] == 1),
                                      sent[..., 0] if shape[2] == 1 else sent)


def test_corpus_covers_the_kinds():
    """Every sampling layout in each process; CMYK and YCCK sequential,
    progressive and arithmetic; every predictor and the point transforms
    0, 1 and 3 in the lossless files, with and without restarts, with 1, 3
    and 4 components, interleaved and not."""
    assert {n for n, *_ in SAMPLING_CASES} >= {f"{lay}_{proc}" for lay in LAYOUTS
                                               for proc in PROCESSES}
    for space in ("cmyk", "ycck"):
        kinds = {(kw.get("arith", False), kw.get("script", "-") != "-")
                 for _, sp, kw, _ in CMYK_CASES if sp == space}
        assert kinds >= {(False, False), (False, True), (True, False)}
    kw_all = [kw for _, _, kw in LOSSLESS_CASES]
    assert {kw["psv"] for kw in kw_all} == set(range(1, 8))
    assert {kw.get("pt", 0) for kw in kw_all} >= {0, 1, 3}
    assert {shape[2] for _, shape, _ in LOSSLESS_CASES} == {1, 3, 4}
    assert {kw.get("interleave", True) for kw in kw_all} == {True, False}
    assert any(kw.get("restart_rows") for kw in kw_all)


def _sof_factors(data: bytes, factors) -> bytes:
    """A file's frame header with each component's (h, v) replaced."""
    i = data.index(b"\xff" + bytes([sof(data)])) + 11
    b = bytearray(data)
    for k, (h, v) in enumerate(factors):
        b[i + 3 * k] = (h << 4) | v
    return bytes(b)


def _sos_fields(data: bytes, ss=None, se=None, ahal=None) -> bytes:
    """A file whose first scan header has Ss, Se or Ah/Al replaced."""
    i = data.index(b"\xff\xda")
    j = i + 5 + 2 * data[i + 4]
    b = bytearray(data)
    for k, v in enumerate((ss, se, ahal)):
        if v is not None:
            b[j + k] = v
    return bytes(b)


def _dri(data: bytes, n: int) -> bytes:
    i = data.index(b"\xff\xdd")
    return data[:i + 4] + struct.pack(">H", n) + data[i + 6:]


H, W = 21, 35
# what PIL refuses and both of the port's readers refuse: (the reason, the
# file from the writer's exe)
REFUSED = {
    "fractional": ("fractional", lambda exe, p: _sof_factors(write_jpeg(
        exe, p, _pil_rgb(1, H, W), "ycc", 80, factors=LAYOUTS["31"]), [(3, 1), (2, 1), (1, 1)])),
    "factor_5": ("sampling factors 5x1", lambda exe, p: _sof_factors(write_jpeg(
        exe, p, _pil_rgb(2, H, W), "ycc", 80, factors=LAYOUTS["411"]), [(5, 1)])),
    "mcu_12_blocks": ("MCU of 12 blocks", lambda exe, p: _sof_factors(write_jpeg(
        exe, p, _pil_rgb(3, H, W), "ycc", 80, factors=[(1, 1)] * 3), [(2, 2)] * 3)),
    "mcu_16_blocks_cmyk": ("MCU of 16 blocks", lambda exe, p: _sof_factors(write_jpeg(
        exe, p, _cmyk(4, H, W), "cmyk", 80, script="simple"), [(2, 2)] * 4)),
    "two_components": ("2-component", lambda exe, p: (lambda d: d[:d.index(b"\xff\xc0") + 9]
                                                     + b"\x02" + d[d.index(b"\xff\xc0") + 10:])(
        write_jpeg(exe, p, _pil_rgb(5, H, W), "ycc", 80))),
    "lossless_ss0": ("lossless.*Ss 0", lambda exe, p: _sos_fields(lossless_jpeg(
        _image(6, H, W, 1)[..., 0]), ss=0)),
    "lossless_ss8": ("lossless.*Ss 8", lambda exe, p: _sos_fields(lossless_jpeg(
        _image(7, H, W, 1)[..., 0]), ss=8)),
    "lossless_se1": ("lossless.*Se 1", lambda exe, p: _sos_fields(lossless_jpeg(
        _image(8, H, W, 1)[..., 0]), se=1)),
    "lossless_ah1": ("lossless.*Ah 1", lambda exe, p: _sos_fields(lossless_jpeg(
        _image(9, H, W, 1)[..., 0]), ahal=0x10)),
    "lossless_al8": ("lossless.*Al 8", lambda exe, p: _sos_fields(lossless_jpeg(
        _image(10, H, W, 1)[..., 0]), ahal=8)),
    "lossless_restart": ("lossless JPEG restart interval 20", lambda exe, p: _dri(lossless_jpeg(
        _image(11, H, W, 1)[..., 0], restart_rows=1), 20)),
    "lossless_sof11": ("lossless arithmetic", lambda exe, p: (lambda d: d[:d.index(b"\xff\xc3")]
                                                              + b"\xff\xcb"
                                                              + d[d.index(b"\xff\xc3") + 2:])(
        lossless_jpeg(_image(16, H, W, 1)[..., 0]))),
    "lossless_ycc": ("lossless JPEG in YCbCr", lambda exe, p: lossless_jpeg(
        _image(12, H, W, 3), jfif=True)),
    "lossless_ycck": ("lossless JPEG in YCCK", lambda exe, p: lossless_jpeg(
        _image(13, H, W, 4), adobe=2)),
}


@pytest.mark.parametrize("kind", REFUSED)
def test_refused_kinds_raise_and_are_skipped(writer, tmp_path, kind):
    """What libjpeg refuses (a fractional sampling ratio, a factor past 4,
    an interleaved MCU of more than 10 blocks, 2 components, a bad lossless
    scan or restart interval, a lossless frame that would need a color
    conversion, a lossless file labelled SOF11, whose scan the QM decoder
    reads without error, so PIL's libjpeg refuses the process): PIL
    raises, the Python reader raises naming the file and the reason, the
    native loader skips the file between two good ones."""
    why, make = REFUSED[kind]
    bad = make(writer, str(tmp_path / "made.jpg"))
    buf = io.BytesIO()
    Image.fromarray(_pil_rgb(14, H, W)).save(buf, format="JPEG", quality=80)
    d = tmp_path / "seq"
    d.mkdir()
    for n, b in (("000000.jpg", buf.getvalue()), ("000001.jpg", bad),
                 ("000002.jpg", buf.getvalue())):
        (d / n).write_bytes(b)
    with pytest.raises((OSError, SyntaxError)):
        jdataset.load_frame(str(d / "000001.jpg"))
    with pytest.raises(ValueError, match=f"000001.jpg.*{why}"):
        dataset.load_frame(str(d / "000001.jpg"))
    with native_loader.NativeDataset(str(d)) as ds:
        assert ds.read(1) is None
        assert [i for i, _ in ds] == [0, 2]


def test_tpu_vo_native_refuses_lossless(jax_native, tmp_path):
    """tpu_vo's libjpeg (2.1) build has no lossless decoder: opening a
    directory of one SOF3 file ends its process (libjpeg's error_exit),
    which the port's readers both read."""
    (tmp_path / "000000.jpg").write_bytes(lossless_jpeg(_image(15, H, W, 1)[..., 0]))
    code = ("import ctypes, sys\n"
            f"lib = ctypes.CDLL({jax_native._name!r})\n"
            "lib.vl_open_dataset.argtypes, lib.vl_open_dataset.restype = [ctypes.c_char_p], "
            "ctypes.c_int64\n"
            f"print('opened', lib.vl_open_dataset({str(tmp_path)!r}.encode()))\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert run.returncode != 0 and "opened" not in run.stdout, (run.stdout, run.stderr)
    assert "SOF type 0xc3" in run.stderr, run.stderr
    want = jdataset.load_frame(str(tmp_path / "000000.jpg"))
    np.testing.assert_array_equal(_port_read(tmp_path), want)


KINDS_DIR = os.path.join(REPO, "tpu_vo_torch", "data", "jpeg", "kinds")
KINDS_BYTES_MAX = 1_500_000
# the committed files, frames 0-4 of the main path: (kind, reader of tpu_vo's native build)
KINDS = (("Adobe CMYK, PIL q90", "cmyk"), ("YCCK, libjpeg's default sampling, q90", "cmyk"),
         ("4:1:1 RGB, q90", "dct"), ("lossless gray, predictor 1, restart every 16 rows",
                                     "lossless"),
         ("lossless RGB, G 2x2, R and B 1x1, predictor 7", "lossless"))


def _kinds_manifest():
    import json

    with open(os.path.join(KINDS_DIR, "manifest.json")) as f:
        return json.load(f)["files"]


def _sha(b) -> str:
    import hashlib

    return hashlib.sha256(b).hexdigest()


def test_committed_kinds_match_their_manifest(jax_native, tmp_path):
    """tpu_vo_torch/data/jpeg/kinds: each file's bytes, SOF, size and frame
    as the manifest says (the frame tpu_vo's load_frame gives), the same
    frame through the port's Python reader, the native loader over the
    directory yielding all five, and tpu_vo's native build where it reads
    the kind; at most KINDS_BYTES_MAX bytes in all."""
    entries = _kinds_manifest()
    assert [e["file"] for e in entries] == [f"{i:06d}.jpg" for i in range(len(KINDS))]
    total = 0
    for e, (kind, native) in zip(entries, KINDS):
        path = os.path.join(KINDS_DIR, e["file"])
        with open(path, "rb") as f:
            data = f.read()
        total += len(data)
        assert e["kind"] == kind and _sha(data) == e["sha256"], e["file"]
        want = jdataset.load_frame(path)
        assert sof(data) == int(e["sof"], 16) and [e["height"], e["width"]] == list(want.shape)
        assert _sha(want.tobytes()) == e["frame_sha256"], e["file"]
        assert _sha(dataset.load_frame(path).tobytes()) == e["frame_sha256"], e["file"]
        if native != "lossless":
            d = tmp_path / e["file"]
            d.mkdir()
            (d / e["file"]).write_bytes(data)
            np.testing.assert_array_equal(_jax_read(jax_native, d), _frame_of_pil_cmyk(path)
                                          if native == "cmyk" else want)
    assert total <= KINDS_BYTES_MAX
    with native_loader.NativeDataset(KINDS_DIR) as ds:
        got = list(ds)
    assert [i for i, _ in got] == list(range(len(KINDS)))
    for (_, f), e in zip(got, entries):
        assert _sha(f.tobytes()) == e["frame_sha256"], e["file"]


def _write_committed(out_dir: str) -> None:
    """The committed files: frames 0-4 of the main path, the colour ones
    under the committed arithmetic files' slow tints (R + 24 sin(x / 160),
    B + 24 cos(y / 90)), the YCCK one's K a slow wave: Adobe CMYK (PIL,
    q90), YCCK at libjpeg's
    default sampling (q90), 4:1:1 RGB (q90), lossless gray (predictor 1,
    a restart every 16 rows) and lossless RGB (ids 'R', 'G', 'B', G at
    2x2, predictor 7); and manifest.json with tpu_vo's frame of each."""
    import json
    import tempfile

    from tpu_vo_torch.utils.synthetic import make_sequence

    frames = make_sequence(32, 1241, 376, seed=0)[0][:len(KINDS)]
    y, x = np.mgrid[0:frames[0].shape[0], 0:frames[0].shape[1]]

    def tint(f):
        f = f.astype(np.int64)
        return np.clip(np.stack([f + (24 * np.sin(x / 160.0)).astype(np.int64), f,
                                 f + (24 * np.cos(y / 90.0)).astype(np.int64)], -1),
                       0, 255).astype(np.uint8)

    os.makedirs(out_dir, exist_ok=True)
    buf = io.BytesIO()
    Image.fromarray(tint(frames[0])).convert("CMYK").save(buf, format="JPEG", quality=90)
    files = [buf.getvalue()]
    k = np.clip(16 + 16 * np.sin((x + y) / 200.0), 0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        exe = build_writer(tmp)
        files.append(write_jpeg(exe, os.path.join(tmp, "ycck.jpg"),
                                np.concatenate([255 - tint(frames[1]), k[..., None]], -1),
                                "ycck", 90))
        files.append(write_jpeg(exe, os.path.join(tmp, "411.jpg"), tint(frames[2]), "ycc", 90,
                                factors=LAYOUTS["411"]))
    files.append(lossless_jpeg(frames[3], psv=1, restart_rows=16))
    files.append(lossless_jpeg(tint(frames[4]), sampling=[(1, 1), (2, 2), (1, 1)], psv=7,
                               ids=[82, 71, 66]))
    entries = []
    for i, (data, (kind, _)) in enumerate(zip(files, KINDS)):
        name = f"{i:06d}.jpg"
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        frame = jdataset.load_frame(path)
        entries.append({"file": name, "kind": kind, "sha256": _sha(data),
                        "sof": f"0x{sof(data):02X}", "width": int(frame.shape[1]),
                        "height": int(frame.shape[0]), "frame_sha256": _sha(frame.tobytes())})
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"files": entries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    _write_committed(KINDS_DIR)
