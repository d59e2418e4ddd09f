"""Dataset enumeration and frame decode, matching main.cpp semantics (port
of tpu_vo/io/dataset.py).

- list_image_paths: regular files with extension .png/.jpg/.jpeg
  (case-insensitive), lexicographically sorted (main.cpp:26-49).
- parse_timestamp: std::stod on the filename stem, falling back to the
  frame index (main.cpp:146-151). stod parses a leading numeric prefix.
- load_frame: decode to grayscale uint8. The port decodes PNG itself
  with zlib and numpy (8-bit gray, RGB and RGBA, not interlaced, all five
  row filters), so it needs no imaging library; color goes to gray with
  tpu_vo's integer BT.601 weights. A JPEG, or a PNG outside that set
  (16-bit, palette, interlaced, gray with alpha), raises a ValueError that
  names the file and the reason.
- write_png: the matching 8-bit gray/RGB/RGBA encoder, one filter for all
  rows.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List, Optional

import numpy as np

_EXTS = {".png", ".jpg", ".jpeg"}
_STOD = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels, for the 8-bit types the decoder reads
_CHANNELS = {0: 1, 2: 3, 6: 4}
_UNSUPPORTED = {3: "palette", 4: "gray with alpha"}


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


def decode_png(path: str) -> np.ndarray:
    """(H, W) gray or (H, W, 3|4) RGB(A) uint8 pixels of an 8-bit,
    non-interlaced gray, RGB or RGBA PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        raise ValueError(f"{path}: JPEG is not decoded by the port (it reads PNG only)")
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype in _UNSUPPORTED:
        raise ValueError(f"{path}: {_UNSUPPORTED[ctype]} PNG is not supported "
                         "(8-bit gray, RGB and RGBA only)")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: invalid PNG color type {ctype}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if compression or filtering:
        raise ValueError(f"{path}: invalid PNG compression or filter method")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{path}: corrupt PNG image data ({exc})") from None
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp, path)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


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
