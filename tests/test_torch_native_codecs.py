"""The port's native loader, whose codecs are its own (csrc/inflate.cpp,
png_decode.cpp, jpeg_decode.cpp), against the JAX package's native route
(native/vo_loader.cpp on libpng, libjpeg and zlib), frame by frame, bit for
bit, on a corpus made here from a numpy seed:

  - PNG: the five color types at every legal bit depth, every row
    filter in each file, tRNS on gray, RGB and palette (held to the same
    file without tRNS, which the JAX build misreads), a PLTE shorter
    than the indices reach, the image data split over several IDAT
    chunks, zlib levels 0, 1 and 9 (stored, fixed- and dynamic-Huffman
    blocks all appear); an Adam7-interlaced file, which the JAX build
    cannot read, equals the same samples written without interlace;
  - JPEG: PIL files at qualities 10, 50 and 95, gray and YCbCr at 4:4:4,
    4:2:2 and 4:2:0, optimised Huffman tables, a restart interval, sizes
    that leave MCU padding;
  - unreadable files (a truncated IDAT, a flipped Adler-32 byte, a bad
    IDAT CRC, a lossless JPEG: a baseline file whose frame header says
    SOF3): skipped by NativeDataset's iteration, None from its read,
    refused by io/dataset.load_frame; first in a directory, NativeDataset
    raises FileNotFoundError and PrefetchLoader falls back to the Python
    reader. (Progressive and arithmetic-coded JPEG, which both readers
    decode, are in tests/test_torch_jpeg_progressive.py.)

The JAX half is built with g++ into a temporary directory once per module
(never through tpu_vo.io.native_loader, which builds into the package
without a lock) and skips only where png.h or jpeglib.h is missing.
"""

import ctypes
import io
import os
import struct
import subprocess
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_vo_torch.io import dataset, loader, native_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(REPO, "native", "vo_loader.cpp")
SIG = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
H, W = 21, 35  # not multiples of 8 or 16: MCU padding, partial bytes, short Adam7 passes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: under xdist every worker
    would otherwise start a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """native/vo_loader.cpp built with libpng, libjpeg and zlib, bound by ctypes."""
    check = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                           input="#include <png.h>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    if check.returncode != 0:
        pytest.skip(f"png.h or jpeglib.h missing: {check.stderr.strip()}")
    so = str(tmp_path_factory.mktemp("jax_native") / "libvo_loader.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", JAX_SRC, "-o", so,
                    "-lpng", "-ljpeg", "-lz", "-lpthread"], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.vl_open_dataset.argtypes, lib.vl_open_dataset.restype = [ctypes.c_char_p], ctypes.c_int64
    for name in ("vl_width", "vl_height"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = [ctypes.c_int64], ctypes.c_int
    lib.vl_read_frame.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.vl_read_frame.restype = ctypes.c_int
    lib.vl_close.argtypes, lib.vl_close.restype = [ctypes.c_int64], None
    return lib


def _jax_read(lib, d):
    """Frame 0 of directory d through the JAX package's native build."""
    h = lib.vl_open_dataset(str(d).encode())
    assert h, f"the JAX native build does not read {os.listdir(d)}"
    try:
        out = np.empty((lib.vl_height(h), lib.vl_width(h)), np.uint8)
        r = lib.vl_read_frame(h, 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    finally:
        lib.vl_close(h)
    assert r == 1
    return out


def _port_read(d):
    with native_loader.NativeDataset(str(d)) as ds:
        got = ds.read(0)
    assert got is not None, f"the port's native loader does not read {os.listdir(d)}"
    return got


# --- a PNG writer of every kind -------------------------------------------

def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _packed(samples, depth):
    """(h, w * channels) samples as PNG row bytes."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, (-n) % per), samples.dtype)], 1)
    s = s.reshape(h, -1, per).astype(np.uint8)
    out = np.zeros(s.shape[:2], np.uint8)
    for k in range(per):
        out |= s[..., k] << (8 - depth * (k + 1))
    return out


def _filtered(rows, bpp, first_filter):
    """Each row through filter (first_filter + row) % 5, its byte in front."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    preds = [np.zeros_like(x), a, b, (a + b) >> 1,
             np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))]
    ftype = (first_filter + np.arange(len(x))) % 5
    pred = np.stack(preds)[ftype, np.arange(len(x))]
    return np.concatenate([ftype[:, None].astype(np.uint8),
                           ((x - pred) & 0xFF).astype(np.uint8)], 1).tobytes()


def _png(samples, ctype, depth, *, palette=None, trns=None, interlace=False, level=6,
         idat_parts=1, first_filter=0):
    """PNG bytes of (h, w[, channels]) samples at any color type and depth."""
    h, w = samples.shape[:2]
    ch = CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)

    def raw(img):
        hh, ww = img.shape[:2]
        if hh == 0 or ww == 0:
            return b""
        return _filtered(_packed(img.reshape(hh, ww * ch), depth), bpp, first_filter)

    data = (b"".join(raw(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7) if interlace
            else raw(samples))
    z = zlib.compress(data, level)
    cuts = np.linspace(0, len(z), idat_parts + 1).astype(int)
    out = SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += b"".join(_chunk(b"IDAT", z[a:b]) for a, b in zip(cuts[:-1], cuts[1:]))
    return out + _chunk(b"IEND", b"")


def _samples(ctype, depth, seed):
    """Random samples with a flat run, a ramp and the extremes."""
    rng = np.random.default_rng(seed)
    ch = CHANNELS[ctype]
    s = rng.integers(0, 1 << depth, (H, W, ch))
    s[2:7, 3:15] = s[2, 3]
    s[10] = (np.arange(W)[:, None] * ((1 << depth) - 1) // (W - 1))
    s[12, :2] = [[0], [(1 << depth) - 1]]
    return s[..., 0] if ch == 1 else s


def _trns(ctype, depth, n_pal):
    if ctype == 3:
        return bytes(range(0, 256, 256 // n_pal))[:n_pal]
    if ctype == 0:
        return struct.pack(">H", 1)
    if ctype == 2:
        return struct.pack(">HHH", 1, 2, 3)
    return None


def _png_corpus():
    """(name, kwargs of _png) of every kind in the corpus."""
    cases = []
    for ctype, depths in DEPTHS.items():
        for depth in depths:
            seed = 10 * ctype + depth
            n_pal = 1 << depth if ctype == 3 else 0
            palette = (np.random.default_rng(seed).integers(0, 256, (n_pal, 3))
                       if ctype == 3 else None)
            for level, parts in ((0, 1), (1, 3), (9, 2)):
                cases.append((f"c{ctype}d{depth}z{level}", dict(
                    samples=_samples(ctype, depth, seed + level), ctype=ctype, depth=depth,
                    palette=palette, level=level, idat_parts=parts, first_filter=level)))
            trns = _trns(ctype, depth, n_pal)
            if trns is not None:
                cases.append((f"c{ctype}d{depth}trns", dict(
                    samples=_samples(ctype, depth, seed + 1), ctype=ctype, depth=depth,
                    palette=palette, trns=trns, first_filter=2)))
    # a PLTE of 5 entries under 4-bit indices that reach 15
    short = np.random.default_rng(3).integers(0, 256, (5, 3))
    cases.append(("c3d4short_plte", dict(samples=_samples(3, 4, 77), ctype=3, depth=4,
                                         palette=short, first_filter=4)))
    return cases


PNG_CASES = _png_corpus()


def test_png_corpus_has_stored_fixed_and_dynamic_blocks():
    """BTYPE of each file's first deflate block, the third byte of its
    first IDAT's zlib stream."""
    types = set()
    for _, kw in PNG_CASES:
        png = _png(**kw)
        i = png.index(b"IDAT") + 4
        types.add((png[i + 2] >> 1) & 3)
    assert types == {0, 1, 2}


@pytest.mark.parametrize("name,kw", PNG_CASES, ids=[n for n, _ in PNG_CASES])
def test_png_equals_the_jax_native_build(jax_native, tmp_path, name, kw):
    """Each PNG as the JAX package's libpng build reads it; its Adam7 twin
    (same samples, interlaced) reads the same through the port. A file
    with tRNS is held to the JAX build's frame of the same file without
    the chunk: that build turns tRNS into an alpha channel it does not
    strip (png_set_strip_alpha is asked only for the file's own alpha
    types) and then reads gray-alpha or RGBA rows as RGB, past the row's
    end for gray, so its frame is not the image."""
    flat, adam7, ref = tmp_path / "flat", tmp_path / "adam7", tmp_path / "ref"
    for d in (flat, adam7, ref):
        d.mkdir()
    (flat / f"{name}.png").write_bytes(_png(**kw))
    (adam7 / f"{name}.png").write_bytes(_png(**kw, interlace=True))
    (ref / f"{name}.png").write_bytes(_png(**{**kw, "trns": None}))
    want = _jax_read(jax_native, ref)
    assert want.shape == (H, W)
    np.testing.assert_array_equal(_port_read(flat), want)
    np.testing.assert_array_equal(_port_read(adam7), want)


def _pil_rgb(seed, h, w):
    """Smooth color with some noise: every quality leaves AC terms."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k) for k in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


# (mode, PIL subsampling) -> name; subsampling 0 4:4:4, 1 4:2:2, 2 4:2:0
JPEG_KINDS = {("L", 0): "gray", ("RGB", 0): "444", ("RGB", 1): "422", ("RGB", 2): "420"}
JPEG_CASES = [(f"{JPEG_KINDS[k]}_q{q}{'_opt' if opt else ''}{'_rst' if rst else ''}_{h}x{w}",
               k, q, opt, rst, h, w)
              for k in JPEG_KINDS for q in (10, 50, 95)
              for opt, rst, (h, w) in ((False, False, (H, W)), (True, True, (40, 67)))]
JPEG_CASES += [(f"{JPEG_KINDS[k]}_q75_tiny_{h}x{w}", k, 75, False, False, h, w)
               for k in ((("RGB", 2)), ("RGB", 1)) for h, w in ((3, 2), (5, 4), (9, 17))]


@pytest.mark.parametrize("name,kind,quality,optimize,restart,h,w", JPEG_CASES,
                         ids=[c[0] for c in JPEG_CASES])
def test_jpeg_equals_the_jax_native_build(jax_native, tmp_path, name, kind, quality, optimize,
                                          restart, h, w):
    mode, sub = kind
    img = Image.fromarray(_pil_rgb(quality + h, h, w)).convert(mode)
    opts = dict(quality=quality, optimize=optimize)
    if mode == "RGB":
        opts["subsampling"] = sub
    if restart:
        opts["restart_marker_blocks"] = 3
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **opts)
    data = buf.getvalue()
    assert (b"\xff\xdd" in data) == restart
    (tmp_path / f"{name}.jpg").write_bytes(data)
    want = _jax_read(jax_native, tmp_path)
    assert want.shape == (h, w)
    np.testing.assert_array_equal(_port_read(tmp_path), want)


def _unreadable(kind, good_png):
    """A file of `kind` made from a good PNG's bytes (or a lossless JPEG:
    a baseline file's SOF0 marker made SOF3)."""
    if kind == "lossless_jpeg":
        buf = io.BytesIO()
        Image.fromarray(_pil_rgb(5, H, W)).save(buf, format="JPEG", quality=80)
        data = buf.getvalue()
        i = data.index(b"\xff\xc0")
        return data[:i + 1] + b"\xc3" + data[i + 2:], ".jpg"
    i = good_png.index(b"IDAT") - 4
    n = struct.unpack(">I", good_png[i:i + 4])[0]
    z = good_png[i + 8:i + 8 + n]
    rest = good_png[i + 12 + n:]
    if kind == "bad_idat_crc":
        chunk = good_png[i:i + 8 + n] + struct.pack(">I", zlib.crc32(b"IDAT" + z) ^ 1)
    else:
        z = z[:len(z) // 2] if kind == "truncated_idat" else z[:-1] + bytes([z[-1] ^ 0x40])
        chunk = _chunk(b"IDAT", z)
    return good_png[:i] + chunk + rest, ".png"


UNREADABLE = ("truncated_idat", "flipped_adler32", "bad_idat_crc", "lossless_jpeg")


def _good(seed):
    return _png(_samples(0, 8, seed), 0, 8, first_filter=seed)


def test_unreadable_files_are_skipped(tmp_path):
    names = ["000000.png"]
    (tmp_path / names[0]).write_bytes(_good(0))
    for k, kind in enumerate(UNREADABLE, 1):
        data, ext = _unreadable(kind, _good(k))
        names.append(f"{k:06d}{ext}")
        (tmp_path / names[-1]).write_bytes(data)
    names.append("000009.png")
    (tmp_path / names[-1]).write_bytes(_good(9))
    paths = [str(tmp_path / n) for n in names]
    with native_loader.NativeDataset(str(tmp_path)) as ds:
        assert ds.num_frames == len(names)
        assert [ds.read(i) is None for i in range(len(names))] == [False, True, True, True, True,
                                                                    False]
        got = list(ds)
    assert [i for i, _ in got] == [0, 5]
    for (i, frame) in got:
        np.testing.assert_array_equal(frame, dataset.load_frame(paths[i]))
    for p in paths[1:5]:
        with pytest.raises(ValueError):
            dataset.load_frame(p)


@pytest.mark.parametrize("kind", UNREADABLE)
def test_a_directory_whose_first_file_is_unreadable(tmp_path, kind):
    """vl_open_dataset decodes the first file to size the sequence: where it
    is refused, NativeDataset raises and PrefetchLoader reads the rest
    with the Python decoder."""
    data, ext = _unreadable(kind, _good(1))
    (tmp_path / f"000000{ext}").write_bytes(data)
    (tmp_path / "000001.png").write_bytes(_good(2))
    with pytest.raises(FileNotFoundError):
        native_loader.NativeDataset(str(tmp_path))
    paths = dataset.list_image_paths(str(tmp_path))
    pl = loader.PrefetchLoader(paths, device="cpu")
    got = [(i, t.numpy()) for i, _, t in pl]
    assert pl.decoder == "python"
    assert [i for i, _ in got] == [1]
    np.testing.assert_array_equal(got[0][1], dataset.load_frame(paths[1]))
