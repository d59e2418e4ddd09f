"""Progressive and arithmetic-coded JPEG (SOF2, SOF9, SOF10 with DAC)
through the port's two readers, io/dataset.load_frame (io/jpeg.decode)
and the native loader (csrc/jpeg_decode.cpp), against tpu_vo's two,
load_frame (PIL) and its libjpeg build of native/vo_loader.cpp, bit for
bit, on a corpus made here from a numpy seed:

  - PIL's progressive files (jpeg_simple_progression: DC first and
    refinement, AC first and refinement at Ah 2 -> 1 -> 0): gray and
    YCbCr at 4:4:4, 4:2:2 and 4:2:0, qualities 10, 50 and 95, with and
    without a restart interval, 21x35 and 16x16;
  - files from the system libjpeg through a small writer built here
    (WRITER_SOURCE): SOF9 and SOF10 in gray, 4:4:4 and 4:2:0 with
    restart intervals and non-default DAC conditioning (L, U, Kx), and
    Huffman and arithmetic scan scripts (spectral selection only, two
    successive-approximation levels, DC scans one component each, an AC
    band left at Al 1, DC alone, a partial band): the last three leave
    coefficients short of their last bit, so libjpeg-turbo's block
    smoothing runs, on sizes whose 4:2:0 luma has an odd number of block
    rows;
  - a scan whose Al is not Ah - 1: the Python reader raises naming the
    file, the native loader skips it, PIL refuses it; so do 12-bit,
    lossless, hierarchical, SOF11, SOF13-15 and CMYK files (PIL aside);
  - an arithmetic-coded file longer than PIL hands libjpeg at once, which
    PIL refuses: both of the port's readers give libjpeg's frame;
  - the committed full-size files in tpu_vo_torch/data/jpeg/ against
    their manifest, tpu_vo's load_frame and its native build.

Color files also equal tpu_vo's load_frame(..., gray=False). The writer
and tpu_vo's native build need jpeglib.h: their tests skip only where it
is missing. `python -m tests.test_torch_jpeg_progressive` (from the
repository's root) rewrites the committed files and their manifest
(needs jpeglib.h, PIL and tpu_vo).
"""

import ctypes
import ctypes.util
import hashlib
import io
import json
import os
import subprocess
import tempfile

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_io import _with_sof
from tests.test_torch_native_codecs import (H, W, _jax_read, _one_thread, _pil_rgb,  # noqa: F401
                                            _port_read, jax_native)
from tpu_vo.io import dataset as jdataset
from tpu_vo_torch.io import dataset, jpeg, native_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tpu_vo_torch", "data", "jpeg")
# PIL hands libjpeg a file 64 KiB at a time, and libjpeg's arithmetic
# decoder cannot wait for more data (JERR_CANT_SUSPEND): PIL refuses an
# arithmetic-coded file longer than this, which libjpeg reads whole
PIL_ARITH_LIMIT = 65536

# jpeg_writer IN OUT WIDTH HEIGHT COMPONENTS QUALITY H V ARITH RESTART L U KX SCRIPT:
# IN holds HEIGHT x WIDTH x COMPONENTS (1 gray, 3 RGB) bytes; H x V is the
# luma's sampling (chroma 1x1); ARITH 1 codes arithmetically; RESTART is
# the interval in MCUs; L, U and KX are every table's DAC conditioning;
# SCRIPT is "-" (sequential), "simple" (jpeg_simple_progression) or scans
# "c,c,...:Ss-Se:Ah:Al" joined by ";"
WRITER_SOURCE = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc != 15) return 2;
  const int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
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
  cinfo.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, atoi(argv[6]), TRUE);
  if (nc == 3) {
    cinfo.comp_info[0].h_samp_factor = atoi(argv[7]);
    cinfo.comp_info[0].v_samp_factor = atoi(argv[8]);
  }
  cinfo.arith_code = atoi(argv[9]);
  cinfo.restart_interval = atoi(argv[10]);
  for (int i = 0; i < NUM_ARITH_TBLS; i++) {
    cinfo.arith_dc_L[i] = atoi(argv[11]);
    cinfo.arith_dc_U[i] = atoi(argv[12]);
    cinfo.arith_ac_K[i] = atoi(argv[13]);
  }
  const char *p = argv[14];
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

# scan scripts by name: (components, Ss, Se, Ah, Al), components "all" (one
# interleaved scan), "each" (a scan per component) or a component index
SCRIPTS = {
    "spectral": [("all", 0, 0, 0, 0), (0, 1, 5, 0, 0), (0, 6, 63, 0, 0), (1, 1, 63, 0, 0),
                 (2, 1, 63, 0, 0)],
    "two_levels": [("all", 0, 0, 0, 2), ("each", 1, 63, 0, 2), ("all", 0, 0, 2, 1),
                   ("each", 1, 63, 2, 1), ("all", 0, 0, 1, 0), ("each", 1, 63, 1, 0)],
    "dc_each": [("each", 0, 0, 0, 0), (0, 1, 9, 0, 0), (0, 10, 63, 0, 0), (1, 1, 63, 0, 0),
                (2, 1, 63, 0, 0)],
    "al1_left": [("all", 0, 0, 0, 0), (0, 1, 9, 0, 0), (0, 10, 63, 0, 1), (1, 1, 63, 0, 1),
                 (2, 1, 63, 0, 0)],
    "al1_dc": [("all", 0, 0, 0, 1), ("each", 1, 63, 0, 1)],
    "dc_only": [("all", 0, 0, 0, 0)],
    "partial": [("all", 0, 0, 0, 0), (0, 1, 2, 0, 0), (0, 3, 9, 0, 2)],
}
# (script, Huffman or arithmetic) -> the 1241x376 4:2:2 file's script
COMMITTED_SCRIPT = "dc_each_al1"
SCRIPTS[COMMITTED_SCRIPT] = [("each", 0, 0, 0, 1), (0, 1, 5, 0, 2), (1, 1, 63, 0, 1),
                             (2, 1, 63, 0, 0), (0, 6, 63, 0, 2), ("all", 0, 0, 1, 0),
                             (0, 1, 63, 2, 1), (0, 1, 63, 1, 0)]


def script_text(name: str, nc: int) -> str:
    """The writer's SCRIPT argument for a script of SCRIPTS over nc components."""
    scans = []
    for comps, ss, se, ah, al in SCRIPTS[name]:
        if comps == "all":
            groups = [list(range(nc))]
        elif comps == "each":
            groups = [[c] for c in range(nc)]
        else:
            groups = [[comps]] if comps < nc else []
        scans += [f"{','.join(map(str, g))}:{ss}-{se}:{ah}:{al}" for g in groups]
    return ";".join(scans)


def build_writer(directory: str) -> str:
    """WRITER_SOURCE built with the system libjpeg into directory."""
    src = os.path.join(directory, "jpeg_writer.c")
    exe = os.path.join(directory, "jpeg_writer")
    with open(src, "w") as f:
        f.write(WRITER_SOURCE)
    subprocess.run(["g++", "-x", "c++", "-O1", src, "-o", exe, "-ljpeg"], check=True,
                   capture_output=True)
    return exe


def write_jpeg(exe: str, path: str, pixels: np.ndarray, quality: int, sampling=(2, 2),
               arith=False, restart=0, dac=(0, 1, 5), script="-") -> bytes:
    """A JPEG of (H, W) gray or (H, W, 3) RGB uint8 pixels through the
    writer; `script` is "-", "simple" or a name in SCRIPTS."""
    px = np.ascontiguousarray(pixels, np.uint8)
    nc = 1 if px.ndim == 2 else 3
    raw = path + ".raw"
    px.tofile(raw)
    text = script if script in ("-", "simple") else script_text(script, nc)
    subprocess.run([exe, raw, path, str(px.shape[1]), str(px.shape[0]), str(nc), str(quality),
                    str(sampling[0]), str(sampling[1]), str(int(arith)), str(restart),
                    *map(str, dac), text], check=True, capture_output=True)
    os.remove(raw)
    with open(path, "rb") as f:
        return f.read()


def sof(data: bytes) -> int:
    """The file's SOF marker (0xC0-0xCF but DHT, JPG and DAC)."""
    i = 2
    while True:
        marker, n = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return marker
        i += 2 + n


def scans(data: bytes):
    """(Ss, Se, Ah, Al, restart interval in force) of each scan of a file."""
    out, i, restart = [], 2, 0
    while i + 4 <= len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF) or 0xD0 <= data[i + 1] <= 0xD7:
            i += 1
            continue
        marker, n = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        if marker == 0xD9:
            break
        body = data[i + 4:i + 2 + n]
        if marker == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        if marker == 0xDA:
            ns = body[0]
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            out.append((ss, se, ahal >> 4, ahal & 15, restart))
        i += 2 + n
    return out


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    check = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                           input="#include <stdio.h>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    if check.returncode != 0:
        pytest.skip(f"jpeglib.h missing: {check.stderr.strip()}")
    return build_writer(str(tmp_path_factory.mktemp("jpeg_writer")))


def _image(seed: int, h: int, w: int, gray: bool) -> np.ndarray:
    rgb = _pil_rgb(seed, h, w)
    return np.asarray(Image.fromarray(rgb).convert("L")) if gray else rgb


# Files on which tpu_vo's two readers disagree: libjpeg-turbo 2.1's block
# smoothing (tpu_vo's native build here) picks other neighbours than 3.x's
# (PIL's) for a component two blocks wide and for 4:2:0 luma, whose iMCU
# row holds two block rows. The port follows PIL (ROADMAP Queue C).
LIBJPEG_21_SMOOTHING_DIFFERS = {
    "sof2_dc_only_422_16", "sof2_dc_only_420_21", "sof2_dc_only_420_40",
    "sof2_partial_420_21", "sof2_partial_420_40", "sof10_dc_only_422_16",
    "sof10_dc_only_420_21", "sof10_dc_only_420_40", "sof10_partial_420_21",
    "sof10_partial_420_40", "sof10_al1_dc_420_40"}


def _same_through_every_reader(jax_native, d, name: str, color: bool):
    """The file d/name equal through the port's Python and native readers,
    tpu_vo's load_frame and tpu_vo's libjpeg build; a color file also in
    color against tpu_vo's load_frame. Where tpu_vo's build and PIL
    disagree, the case must be one of LIBJPEG_21_SMOOTHING_DIFFERS, and the
    port's readers are held to PIL."""
    path = str(d / name)
    want = jdataset.load_frame(path)
    np.testing.assert_array_equal(dataset.load_frame(path), want)
    np.testing.assert_array_equal(_port_read(d), want)
    if not np.array_equal(_jax_read(jax_native, d), want):
        assert os.path.splitext(name)[0] in LIBJPEG_21_SMOOTHING_DIFFERS, name
    if color:
        np.testing.assert_array_equal(dataset.load_frame(path, gray=False),
                                      jdataset.load_frame(path, gray=False))


# PIL's progressive files: (name, kind, quality, restart, (h, w))
KINDS = {"gray": ("L", 0), "444": ("RGB", 0), "422": ("RGB", 1), "420": ("RGB", 2)}
PIL_CASES = [(f"{k}_q{q}{'_rst' if rst else ''}_{h}x{w}", k, q, rst, (h, w))
             for k in KINDS for q in (10, 50, 95) for rst in (False, True)
             for h, w in ((H, W), (16, 16))]


@pytest.mark.parametrize("name,kind,quality,restart,size", PIL_CASES,
                         ids=[c[0] for c in PIL_CASES])
def test_pil_progressive_equals_every_reader(jax_native, tmp_path, name, kind, quality,
                                             restart, size):
    mode, sub = KINDS[kind]
    h, w = size
    opts = dict(quality=quality, progressive=True)
    if mode == "RGB":
        opts["subsampling"] = sub
    if restart:
        opts["restart_marker_blocks"] = 2
    buf = io.BytesIO()
    Image.fromarray(_pil_rgb(quality + h + w, h, w)).convert(mode).save(buf, format="JPEG",
                                                                       **opts)
    data = buf.getvalue()
    assert sof(data) == 0xC2
    kinds = {(ss == 0, ah != 0) for ss, _, ah, _, _ in scans(data)}
    assert kinds == {(True, False), (True, True), (False, False), (False, True)}
    assert all((r != 0) == restart for *_, r in scans(data))
    (tmp_path / f"{name}.jpg").write_bytes(data)
    _same_through_every_reader(jax_native, tmp_path, f"{name}.jpg", mode == "RGB")


# the writer's files: (name, kwargs of write_jpeg, gray, (h, w))
SAMPLING = {"gray": (1, 1), "444": (1, 1), "422": (2, 1), "420": (2, 2)}
WRITER_CASES = []
for _arith, _proc in ((True, "-"), (True, "simple")):
    for _k in ("gray", "444", "420"):
        for _v, (_rst, _dac, _size) in enumerate((
                (0, (0, 1, 5), (H, W)), (2, (2, 4, 2), (H, W)), (1, (1, 1, 63), (16, 16)),
                (3, (0, 0, 1), (40, 67)))):
            WRITER_CASES.append((f"sof{10 if _proc == 'simple' else 9}_{_k}_{_v}", dict(
                quality=(30, 75, 90, 95)[_v], sampling=SAMPLING[_k], arith=True, restart=_rst,
                dac=_dac, script=_proc), _k == "gray", _size))
for _arith in (False, True):
    for _s in SCRIPTS:
        if _s == COMMITTED_SCRIPT:
            continue
        for _k, _size in (("gray", (H, W)), ("422", (16, 16)), ("420", (H, W)),
                          ("420", (40, 67))):
            WRITER_CASES.append((f"{'sof10' if _arith else 'sof2'}_{_s}_{_k}_{_size[0]}", dict(
                quality=80, sampling=SAMPLING[_k], arith=_arith, restart=3 if _arith else 0,
                dac=(1, 3, 4), script=_s), _k == "gray", _size))


@pytest.mark.parametrize("name,kw,gray,size", WRITER_CASES, ids=[c[0] for c in WRITER_CASES])
def test_libjpeg_files_equal_every_reader(writer, jax_native, tmp_path, name, kw, gray, size):
    data = write_jpeg(writer, str(tmp_path / f"{name}.jpg"),
                      _image(len(name) + size[1], *size, gray), **kw)
    assert sof(data) == (0xC9 if kw["script"] == "-" else 0xCA if kw["arith"] else 0xC2)
    assert (b"\xff\xcc" in data) == kw["arith"]
    assert all((r != 0) == (kw["restart"] != 0) for *_, r in scans(data))
    _same_through_every_reader(jax_native, tmp_path, f"{name}.jpg", not gray)


def test_corpus_covers_each_process_with_restarts_and_subsampling():
    """SOF2, SOF9 and SOF10 each appear with a restart interval and with
    chroma subsampled."""
    seen = set()
    for _, kw, gray, _ in WRITER_CASES:
        marker = 0xC9 if kw["script"] == "-" else 0xCA if kw["arith"] else 0xC2
        seen.add((marker, kw["restart"] != 0, not gray and kw["sampling"] != (1, 1)))
    seen |= {(0xC2, rst, KINDS[k][1] != 0) for _, k, _, rst, _ in PIL_CASES}
    for marker in (0xC2, 0xC9, 0xCA):
        assert (marker, True, True) in seen


def test_bad_progression_raises_and_is_skipped(writer, tmp_path):
    """A refinement scan whose Al is not Ah - 1 (libjpeg's
    JERR_BAD_PROGRESSION): the Python reader raises naming the file, PIL
    refuses it, the native loader skips it between two good frames."""
    img = _image(7, H, W, gray=True)
    data = write_jpeg(writer, str(tmp_path / "good.jpg"), img, 75, script="two_levels")
    i = data.index(b"\xff\xda")
    while data[i + 9] != 0x21:  # the first scan at Ah 2, Al 1 (one component: Ah/Al at +9)
        i = data.index(b"\xff\xda", i + 2)
    bad = data[:i + 9] + b"\x20" + data[i + 10:]  # Ah 2, Al 0
    d = tmp_path / "seq"
    d.mkdir()
    for n, b in (("000000.jpg", data), ("000001.jpg", bad), ("000002.jpg", data)):
        (d / n).write_bytes(b)
    with pytest.raises(ValueError, match="000001.jpg.*bad JPEG progression"):
        dataset.load_frame(str(d / "000001.jpg"))
    with pytest.raises(OSError):
        jdataset.load_frame(str(d / "000001.jpg"))
    with native_loader.NativeDataset(str(d)) as ds:
        assert ds.read(1) is None
        got = list(ds)
    assert [i for i, _ in got] == [0, 2]
    for _, f in got:
        np.testing.assert_array_equal(f, jdataset.load_frame(str(d / "000000.jpg")))


def test_arithmetic_past_pils_read_follows_libjpeg(writer, jax_native, tmp_path):
    """An arithmetic-coded file longer than PIL_ARITH_LIMIT: PIL refuses it
    (tpu_vo's load_frame raises), tpu_vo's libjpeg build reads it, and both
    of the port's readers give that build's frame."""
    img = np.clip(np.random.default_rng(11).normal(128, 40, (200, 320, 3)), 0, 255)
    data = write_jpeg(writer, str(tmp_path / "big.jpg"), img, 90, sampling=(1, 1), arith=True,
                      restart=7, script="simple")
    assert len(data) > PIL_ARITH_LIMIT and sof(data) == 0xCA
    with pytest.raises(OSError):
        jdataset.load_frame(str(tmp_path / "big.jpg"))
    want = _jax_read(jax_native, tmp_path)
    np.testing.assert_array_equal(_port_read(tmp_path), want)
    np.testing.assert_array_equal(dataset.load_frame(str(tmp_path / "big.jpg")), want)


# what both of the port's readers refuse: (why, the file from a baseline one)
REFUSED = {
    "12bit": ("12-bit", lambda b: _with_sof(b, 0xC1, 12)),
    "sof3": ("lossless", lambda b: _with_sof(b, 0xC3)),
    "sof5": ("hierarchical", lambda b: _with_sof(b, 0xC5)),
    "sof6": ("hierarchical", lambda b: _with_sof(b, 0xC6)),
    "sof7": ("hierarchical", lambda b: _with_sof(b, 0xC7)),
    "sof11": ("lossless arithmetic", lambda b: _with_sof(b, 0xCB)),
    "sof13": ("hierarchical", lambda b: _with_sof(b, 0xCD)),
    "sof14": ("hierarchical", lambda b: _with_sof(b, 0xCE)),
    "sof15": ("hierarchical", lambda b: _with_sof(b, 0xCF)),
    "cmyk": ("CMYK", None),
}


@pytest.mark.parametrize("kind", REFUSED)
def test_refused_kinds_raise_and_are_skipped(tmp_path, kind):
    """12-bit, lossless, hierarchical, SOF11, SOF13-15 and 4-component
    (CMYK) JPEG: the Python reader raises naming the file and the reason,
    the native loader skips the file between two good frames."""
    buf = io.BytesIO()
    Image.fromarray(_pil_rgb(3, H, W)).save(buf, format="JPEG", quality=80)
    good = buf.getvalue()
    why, make = REFUSED[kind]
    if make is None:
        buf = io.BytesIO()
        Image.fromarray(_pil_rgb(4, H, W)).convert("CMYK").save(buf, format="JPEG")
        bad = buf.getvalue()
    else:
        bad = make(good)
    for n, b in (("000000.jpg", good), ("000001.jpg", bad), ("000002.jpg", good)):
        (tmp_path / n).write_bytes(b)
    with pytest.raises(ValueError, match=f"000001.jpg.*{why}"):
        dataset.load_frame(str(tmp_path / "000001.jpg"))
    with native_loader.NativeDataset(str(tmp_path)) as ds:
        assert ds.read(1) is None
        assert [i for i, _ in ds] == [0, 2]


def test_qe_table_is_libjpegs():
    """io/jpeg's Qe table (T.81 Table D.2, packed as jaricom.c packs it)
    equals the jpeg_aritab of the system libjpeg, where it exports one."""
    name = ctypes.util.find_library("jpeg")
    if name is None:
        pytest.skip("no libjpeg")
    try:
        table = (ctypes.c_long * len(jpeg.ARITAB)).in_dll(ctypes.CDLL(name), "jpeg_aritab")
    except ValueError:
        pytest.skip(f"{name} does not export jpeg_aritab")
    assert list(table) == list(jpeg.ARITAB)


def _manifest():
    with open(os.path.join(DATA, "manifest.json")) as f:
        return json.load(f)


def _frame_sha(frame: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(frame, np.uint8).tobytes()).hexdigest()


def test_committed_files_match_their_manifest(jax_native, tmp_path):
    """Every committed file: its bytes, SOF and size as the manifest says,
    and the manifest's frame hash is tpu_vo's load_frame's and its native
    build's; the port's native loader gives that frame for every file,
    and its Python reader for the first progressive frame."""
    entries = _manifest()["files"]
    total = 0
    for e in entries:
        path = os.path.join(DATA, e["file"])
        with open(path, "rb") as f:
            data = f.read()
        total += len(data)
        assert hashlib.sha256(data).hexdigest() == e["sha256"], e["file"]
        assert sof(data) == int(e["sof"], 16) and [e["height"], e["width"]] == \
            list(jdataset.load_frame(path).shape)
        assert _frame_sha(jdataset.load_frame(path)) == e["frame_sha256"], e["file"]
        d = tmp_path / e["file"].replace("/", "_")
        d.mkdir()
        (d / "000000.jpg").write_bytes(data)
        assert _frame_sha(_jax_read(jax_native, d)) == e["frame_sha256"], e["file"]
    assert total <= 1 << 20
    prog = sorted((e for e in entries if e["file"].startswith("progressive/")),
                  key=lambda e: e["file"])
    assert [e["file"] for e in prog] == [f"progressive/{i:06d}.jpg" for i in range(8)]
    with native_loader.NativeDataset(os.path.join(DATA, "progressive")) as ds:
        got = list(ds)
    assert [i for i, _ in got] == list(range(8))
    for (_, f), e in zip(got, prog):
        assert _frame_sha(f) == e["frame_sha256"], e["file"]
    for e in entries:
        if "/" not in e["file"]:
            d = tmp_path / ("native_" + e["file"])
            d.mkdir()
            (d / e["file"]).write_bytes(open(os.path.join(DATA, e["file"]), "rb").read())
            assert _frame_sha(_port_read(d)) == e["frame_sha256"], e["file"]
    assert _frame_sha(dataset.load_frame(os.path.join(DATA, prog[0]["file"]))) == \
        prog[0]["frame_sha256"]


def _write_committed(out_dir: str) -> None:
    """The committed files: the main path's first 8 frames as PIL's gray
    q90 progressive files; a 1241x376 RGB image made from frame 0 as
    4:2:0 q90 SOF9 and SOF10 files with restart intervals (the writer);
    the same image as a Huffman 4:2:2 file with COMMITTED_SCRIPT; and
    manifest.json with tpu_vo's frame of each."""
    from tpu_vo_torch.utils.synthetic import make_sequence

    frames = make_sequence(32, 1241, 376, seed=0)[0][:8]
    os.makedirs(os.path.join(out_dir, "progressive"), exist_ok=True)
    names = []
    for i, f in enumerate(frames):
        names.append(f"progressive/{i:06d}.jpg")
        Image.fromarray(f).save(os.path.join(out_dir, names[-1]), format="JPEG", quality=90,
                                progressive=True)
    # frame 0 under slow tints: smooth chroma keeps both arithmetic files
    # under the 64 KiB that PIL hands libjpeg at once (PIL_ARITH_LIMIT)
    f0 = frames[0].astype(np.int64)
    y, x = np.mgrid[0:f0.shape[0], 0:f0.shape[1]]
    rgb = np.clip(np.stack([f0 + (24 * np.sin(x / 160.0)).astype(np.int64), f0,
                            f0 + (24 * np.cos(y / 90.0)).astype(np.int64)], -1), 0, 255)
    with tempfile.TemporaryDirectory() as tmp:
        exe = build_writer(tmp)
        for name, kw in (("arith_seq_420.jpg", dict(arith=True, restart=16)),
                         ("arith_prog_420.jpg", dict(arith=True, restart=16, script="simple")),
                         ("prog_script_422.jpg", dict(sampling=(2, 1),
                                                      script=COMMITTED_SCRIPT))):
            data = write_jpeg(exe, os.path.join(out_dir, name), rgb, 90, **kw)
            assert len(data) <= PIL_ARITH_LIMIT, (name, len(data))
            names.append(name)
    files = []
    for name in names:
        path = os.path.join(out_dir, name)
        with open(path, "rb") as f:
            data = f.read()
        frame = jdataset.load_frame(path)
        files.append({"file": name, "sha256": hashlib.sha256(data).hexdigest(),
                      "sof": f"0x{sof(data):02X}", "width": int(frame.shape[1]),
                      "height": int(frame.shape[0]), "frame_sha256": _frame_sha(frame)})
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"files": files}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    _write_committed(DATA)
