"""The port's PNG reader (io/dataset.decode_png, load_frame) against
tpu_vo's PIL-based load_frame, bit for bit, on files of every kind PIL
reads: color types 0, 2, 3, 4 and 6 at every legal bit depth, with and
without tRNS, with and without Adam7 interlace, every row filter; a
short palette; files PIL writes itself (palette, gray with alpha,
16-bit, 1-bit); and both packages' PrefetchLoader(use_native=False)
over one directory that mixes them with JPEGs.

The files are made by a small writer here, since PIL writes only a few
of these kinds.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from tpu_vo.io import dataset as jdataset, loader as jloader
from tpu_vo_torch.io import dataset, jpeg, loader

SIG = b"\x89PNG\r\n\x1a\n"
# (first column, first row, column step, row step) of Adam7's passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
CASES = [(c, d) for c, ds in DEPTHS.items() for d in ds]


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered(rows, ftype, bpp):
    """PNG filter `ftype` applied to (h, stride) uint8 rows."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = [np.zeros_like(x), a, b, (a + b) >> 1,
            np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


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


def write_png_any(path, samples, ctype, depth, palette=None, trns=None, interlace=False,
                  ftype=0):
    """A PNG of (h, w[, channels]) samples at any color type and depth."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    ch = CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)

    def raw(img):
        hh, ww = img.shape[:2]
        if hh == 0 or ww == 0:
            return b""
        rows = _filtered(_packed(img.reshape(hh, ww * ch), depth), ftype, bpp)
        return np.concatenate([np.full((hh, 1), ftype, np.uint8), rows], 1).tobytes()

    data = (b"".join(raw(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7) if interlace
            else raw(samples))
    out = SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _samples(ctype, depth, seed, h=13, w=11):
    rng = np.random.default_rng(seed)
    shape = (h, w) if CHANNELS[ctype] == 1 else (h, w, CHANNELS[ctype])
    s = rng.integers(0, 1 << depth, shape)
    if h > 5 and w > 4:
        s[3:6, 1:5] = s[3, 1]  # a flat run for the filters
    if depth == 16 and s.ndim == 2 and w >= 4:
        s[0, :4] = [0, 255, 256, 65535]  # both sides of PIL's clip
    return s


def _trns(ctype, depth, n_pal):
    if ctype == 3:
        return bytes(range(0, 256, 256 // n_pal))[:n_pal]
    if ctype == 0:
        return struct.pack(">H", 1)
    if ctype == 2:
        return struct.pack(">HHH", 1, 2, 3)
    return None  # types 4 and 6 carry alpha and no tRNS


def _assert_like_tpu_vo(path):
    for gray in (True, False):
        np.testing.assert_array_equal(dataset.load_frame(path, gray),
                                      jdataset.load_frame(path, gray))


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", CASES)
def test_every_color_type_and_depth_matches_tpu_vo(tmp_path, ctype, depth, interlace):
    """Each legal (color type, depth), filters in turn, with tRNS where the
    type allows it, plain and Adam7-interlaced (an odd size leaves some
    passes empty)."""
    n_pal = 1 << depth if ctype == 3 else 0
    palette = (np.random.default_rng(depth).integers(0, 256, (n_pal, 3)) if ctype == 3
               else None)
    for ftype in range(5):
        for trns in (None, _trns(ctype, depth, n_pal)):
            path = str(tmp_path / f"t{ctype}_{depth}_{ftype}_{trns is not None}.png")
            write_png_any(path, _samples(ctype, depth, ftype, h=13, w=11 if interlace else 9),
                          ctype, depth, palette, trns, interlace, ftype)
            _assert_like_tpu_vo(path)


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (9, 1), (17, 33)])
def test_interlaced_small_and_odd_sizes(tmp_path, size):
    """Adam7 on sizes where whole passes are empty."""
    for ctype, depth in ((0, 8), (2, 16), (3, 4), (0, 1)):
        n_pal = 16 if ctype == 3 else 0
        palette = np.random.default_rng(1).integers(0, 256, (n_pal, 3)) if n_pal else None
        path = str(tmp_path / f"i{ctype}_{depth}.png")
        write_png_any(path, _samples(ctype, depth, 3, *size), ctype, depth, palette,
                      interlace=True, ftype=4)
        _assert_like_tpu_vo(path)


def test_short_palette_reads_black_past_its_entries(tmp_path):
    path = str(tmp_path / "short.png")
    idx = np.random.default_rng(2).integers(0, 9, (7, 6))
    palette = np.random.default_rng(3).integers(0, 256, (5, 3))
    write_png_any(path, idx, 3, 8, palette)
    _assert_like_tpu_vo(path)
    assert not dataset.load_frame(path, gray=False)[idx >= 5].any()


def test_files_pil_writes(tmp_path):
    """Palette (with and without transparency), gray with alpha, 16-bit
    gray, 1-bit and gray with tRNS files as PIL itself writes them (PIL
    writes no interlaced PNG; the writer here makes those)."""
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
    writes = {
        "p.png": lambda p: Image.fromarray(rgb).convert("P").save(p),
        "p_trns.png": lambda p: Image.fromarray(rgb).convert("P").save(p, transparency=3),
        "la.png": lambda p: Image.fromarray(rgb[..., :2].copy(), "LA").save(p),
        "i16.png": lambda p: Image.fromarray(
            rng.integers(0, 600, (23, 31)).astype(np.uint16)).save(p),
        "bw.png": lambda p: Image.fromarray(rgb[..., 0] > 127).save(p),
        "gray_trns.png": lambda p: Image.fromarray(rgb[..., 0]).save(p, transparency=7)}
    for name, write in writes.items():
        path = str(tmp_path / name)
        write(path)
        _assert_like_tpu_vo(path)


def test_sixteen_bit_gray_clips_as_pil_does(tmp_path):
    """PIL's RGB conversion of 16-bit gray clips at 255 (tpu_vo's native
    loader strips to the high byte instead)."""
    path = str(tmp_path / "g16.png")
    ramp = np.array([[0, 1, 254, 255, 256, 4095, 65535]])
    write_png_any(path, ramp, 0, 16)
    np.testing.assert_array_equal(dataset.load_frame(path), np.minimum(ramp, 255))
    _assert_like_tpu_vo(path)


def test_prefetch_loaders_agree_over_a_mixed_directory(tmp_path):
    """Both packages' PrefetchLoader(use_native=False) over PNGs of every
    kind beside JPEGs: the same frames, in order, none skipped."""
    from tpu_vo_torch.utils.synthetic import make_sequence

    frames = make_sequence(n_frames=8, width=40, height=24, seed=5)[0]
    kinds = ["palette", "adam7", "gray_alpha", "g16", "jpeg_gray", "jpeg_420", "rgb16",
             "sub8"]
    for i, (f, kind) in enumerate(zip(frames, kinds)):
        stem = str(tmp_path / f"{i:06d}")
        if kind == "palette":
            write_png_any(stem + ".png", f, 3, 8, np.repeat(np.arange(256)[:, None], 3, 1))
        elif kind == "adam7":
            write_png_any(stem + ".png", f, 0, 8, interlace=True, ftype=4)
        elif kind == "gray_alpha":
            write_png_any(stem + ".png", np.stack([f, 255 - f], -1), 4, 8, ftype=3)
        elif kind == "g16":
            write_png_any(stem + ".png", f.astype(np.int64) * 257, 0, 16, ftype=1)
        elif kind == "jpeg_gray":
            with open(stem + ".jpg", "wb") as fh:
                fh.write(jpeg.encode_gray(f, 90))
        elif kind == "jpeg_420":
            Image.fromarray(np.stack([f, f // 2, 255 - f], -1)).save(stem + ".jpeg", quality=80)
        elif kind == "rgb16":
            write_png_any(stem + ".png", np.stack([f, f, 255 - f], -1).astype(np.int64) * 257,
                          2, 16, ftype=2)
        else:
            write_png_any(stem + ".png", f >> 4, 0, 4)
    paths = dataset.list_image_paths(str(tmp_path))
    ref = [(i, p, np.asarray(t)) for i, p, t in jloader.PrefetchLoader(paths, use_native=False)]
    got = [(i, p, t.numpy()) for i, p, t in
           loader.PrefetchLoader(paths, device="cpu", use_native=False)]
    assert [(i, p) for i, p, _ in got] == [(i, p) for i, p, _ in ref] == list(
        zip(range(len(paths)), paths))
    for (_, p, a), (_, _, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b, err_msg=p)
    np.testing.assert_array_equal(got[1][2], frames[1])  # Adam7 gray is the frame itself
    np.testing.assert_array_equal(got[4][2], jpeg.roundtrip_gray(frames[4], 90))
