"""Dataset enumeration and frame decode, matching main.cpp semantics (port
of tpu_vo/io/dataset.py).

- list_image_paths: regular files with extension .png/.jpg/.jpeg
  (case-insensitive), lexicographically sorted (main.cpp:26-49).
- parse_timestamp: std::stod on the filename stem, falling back to the
  frame index (main.cpp:146-151). stod parses a leading numeric prefix.
- load_frame: decode to grayscale uint8 as tpu_vo's does through PIL
  (Image.open(...).convert("RGB"), then the integer BT.601 weights, or
  mode L as it is), with no imaging library: decode_png reads every PNG
  (color types 0, 2, 3, 4 and 6 at every legal bit depth, PLTE with tRNS
  read and dropped, Adam7 interlace, all five row filters; zlib + numpy)
  and hands a JPEG to io/jpeg.decode (sequential, progressive and
  lossless, Huffman- and arithmetic-coded, gray, RGB, CMYK and YCCK). It
  gives PIL's values: 1-, 2- and 4-bit gray scaled to 0..255, 16-bit gray
  clipped to 255, 16-bit color and gray with alpha cut to their high byte,
  the alpha dropped, CMYK through PIL's cmyk2rgb. A file it does not
  decode (12-bit, hierarchical, 2-component or lossless arithmetic JPEG,
  a corrupt file) raises a ValueError that names the file and the reason.
- write_png: an 8-bit gray/RGB/RGBA encoder, one filter for all rows.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List, Optional

import numpy as np

from tpu_vo_torch.io import jpeg

_EXTS = {".png", ".jpg", ".jpeg"}
_STOD = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> (samples a pixel, legal bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def list_image_paths(dataset_path: str) -> List[str]:
    """Enumerate + sort image files exactly like load_image_paths."""
    paths = []
    for entry in os.scandir(dataset_path):
        if not entry.is_file():
            continue
        ext = os.path.splitext(entry.name)[1].lower()
        if ext in _EXTS:
            paths.append(entry.path)
    paths.sort()
    return paths


def autodetect_dataset(cli_arg: Optional[str] = None) -> Optional[str]:
    """CLI arg, else data/Dataset_VO, else Dataset_VO (main.cpp:59-73)."""
    if cli_arg:
        return cli_arg
    for cand in ("data/Dataset_VO", "Dataset_VO"):
        if os.path.isdir(cand):
            return cand
    return None


def parse_timestamp(path: str, index: int) -> float:
    """std::stod(stem) with fallback to the frame index."""
    stem = os.path.splitext(os.path.basename(path))[0]
    m = _STOD.match(stem.strip())
    if m:
        try:
            return float(m.group(0))
        except ValueError:
            pass
    return float(index)


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk after the signature, CRC-checked."""
    pos = len(_PNG_SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            break
        body = data[pos + 8:end - 4]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end - 4:end])[0]:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r} (CRC mismatch)")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter_row(ftype: int, line: np.ndarray, prior: np.ndarray, bpp: int,
                  path: str) -> np.ndarray:
    """Undo one row's PNG filter (None, Sub, Up, Average, Paeth); uint8
    arithmetic wraps modulo 256 as the format requires."""
    if ftype == 0:
        return line.copy()
    if ftype == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:
        return line + prior
    if ftype not in (3, 4):
        raise ValueError(f"{path}: unknown PNG row filter {ftype}")
    # Average and Paeth depend on the reconstructed left neighbour: in order.
    raw, up = line.tolist(), prior.tolist()
    cur = [0] * len(raw)
    for x in range(len(raw)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - bpp] if x >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (raw[x] + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def _unfilter(raw: memoryview, h: int, w: int, channels: int, depth: int, path: str):
    """(h, w, channels) samples of one image (or Adam7 pass) whose filtered
    rows start `raw`; returns (samples as uint8 or uint16, bytes used)."""
    stride = -(-w * channels * depth // 8)
    if h == 0 or w == 0:
        return np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8), 0
    size = h * (stride + 1)
    if len(raw) < size:
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, expected {size}")
    rows = np.frombuffer(raw[:size], np.uint8).reshape(h, stride + 1)
    bpp = max(1, channels * depth // 8)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp, path)
    if depth == 16:
        samples = out.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = out
    else:  # samples packed from the high bits of each byte
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((out[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, stride * per)
    return samples[:, :w * channels].reshape(h, w, channels), size


def _pil_values(samples: np.ndarray, ctype: int, depth: int, palette: np.ndarray):
    """What PIL's decode followed by convert("RGB") (or mode L) makes of
    the samples: (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8."""
    if ctype == 3:
        return palette[samples[..., 0]]
    if ctype in (0, 4):
        g = samples[..., 0]
        if depth == 16:  # I;16 clips to 255; LA;16 reads the high byte
            return (np.minimum(g, 255) if ctype == 0 else g >> 8).astype(np.uint8)
        return (g * (255 // ((1 << depth) - 1))).astype(np.uint8)  # 1, 2, 4 bits scaled
    return (samples >> 8).astype(np.uint8) if depth == 16 else samples


def decode_png(path: str) -> np.ndarray:
    """(H, W) gray or (H, W, 3|4) RGB(A) uint8 pixels of a PNG or JPEG
    file, with the values PIL gives them: PNG gray types (gray, gray with
    alpha, any depth) come out 2-D, palette and RGB as RGB, RGBA as RGBA;
    a JPEG is decoded by io/jpeg.decode."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return jpeg.decode(data, path)
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG or JPEG file")
    header, idat, palette = None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)  # indices past the entries read black
            entries = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
            palette[:min(len(entries), 256)] = entries[:256]
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise ValueError(f"{path}: invalid PNG color type {ctype} at bit depth {depth}")
    if compression or filtering or interlace > 1:
        raise ValueError(f"{path}: invalid PNG compression, filter or interlace method")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _COLOR_TYPES[ctype][0]
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as exc:
        raise ValueError(f"{path}: corrupt PNG image data ({exc})") from None
    if interlace:
        samples = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        for x0, y0, dx, dy in ADAM7:
            ph, pw = max(0, -(-(h - y0) // dy)), max(0, -(-(w - x0) // dx))
            part, used = _unfilter(raw, ph, pw, channels, depth, path)
            samples[y0::dy, x0::dx] = part
            raw = raw[used:]
    else:
        samples, _ = _unfilter(raw, h, w, channels, depth, path)
    return np.ascontiguousarray(_pil_values(samples, ctype, depth, palette))


def load_frame(path: str, gray: bool = True) -> np.ndarray:
    """Decode an image file to uint8 (H, W) gray or (H, W, 3) RGB."""
    img = decode_png(path)
    if img.ndim == 2:
        return img if gray else np.repeat(img[..., None], 3, axis=-1)
    rgb = img[..., :3]
    if not gray:
        return np.ascontiguousarray(rgb)
    # BT.601 integer weights matching tpu_vo_torch.image.color
    rgb = rgb.astype(np.int64)
    y = (rgb[..., 2] * 3735 + rgb[..., 1] * 19235
         + rgb[..., 0] * 9798 + (1 << 14)) >> 15
    return y.astype(np.uint8)


def _filter_rows(img: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """(H, stride) rows filtered with one PNG filter type."""
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"unknown PNG row filter {ftype}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """Write (H, W) gray or (H, W, 3|4) RGB(A) uint8 pixels as an 8-bit
    PNG, every row filtered with `filter_type` (0-4)."""
    img = np.asarray(img)
    bpp = 1 if img.ndim == 2 else img.shape[-1]
    ctype = {1: 0, 3: 2, 4: 6}.get(bpp)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or ctype is None:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3|4) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = _filter_rows(img.reshape(h, w * bpp), filter_type, bpp)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))
