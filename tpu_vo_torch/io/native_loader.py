"""ctypes binding of the native C++ image loader (port of
tpu_vo/io/native_loader.py).

csrc/vo_loader.cpp decodes PNG and JPEG on a pool of threads into an
ordered ring, converts color to gray with the exact BT.601 fixed-point
arithmetic of image/color, and reads and writes packed .vobin sequences
(decode once, then mmap). It is the port's counterpart of the JAX
package's native/vo_loader.cpp with the codecs in csrc/ itself
(inflate.cpp, png_decode.cpp, jpeg_decode.cpp; codecs.h), so that it
builds with g++ and nothing but the C++ standard library and pthreads.
A PNG decodes to libpng's pixels under the original's transforms, and an
Adam7-interlaced one is read whole (tpu_vo's native route fails on it:
"IDAT: Too much image data"); a JPEG decodes as io/jpeg.decode does
(sequential and progressive, Huffman- and arithmetic-coded; 12-bit,
lossless, hierarchical and CMYK files are skipped, as the Python route
refuses them). The library is built on first use, never
at import, with g++ into tpu_vo_torch/_build/, named by a hash of every
source and the flags, through ops/_build.build_once: concurrent first
uses in several processes build it once and never load a half-written
file.

  available()            True once the library is loaded; False only
                         after a failed build, whose output
                         unavailable_reason() then returns;
  build_command(out)     the g++ command that builds the library into out;
  NativeDataset(path, n_threads=4, depth=8)
                         a directory's sorted .png/.jpg/.jpeg frames:
                         read(i), ordered iteration of (i, frame) that
                         skips unreadable frames, close();
  pack_dataset(dir, out) decode a directory once into a .vobin file;
  PackedSequence(path)   read(start, count) of a .vobin file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpu_vo_torch.ops._build import build_once

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SRC = os.path.join(CSRC, "vo_loader.cpp")
CODEC_SOURCES = ("inflate.cpp", "png_decode.cpp", "jpeg_decode.cpp")
CODEC_HEADERS = ("codecs.h",)
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lpthread",)

_LIBS: Dict[str, ctypes.CDLL] = {}    # loaded libraries by path
_ERRORS: Dict[str, str] = {}          # failed builds' output by path
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I = ctypes.c_int
_I64 = ctypes.c_int64


def sources() -> Tuple[str, ...]:
    """Every file the build reads: the loader, then the codecs' sources
    and header."""
    return (SRC, *(os.path.join(CSRC, name) for name in CODEC_SOURCES + CODEC_HEADERS))


def build_command(out: str) -> List[str]:
    """g++ with the flags, the loader's and the codecs' sources, and LIBS."""
    return [CXX, *CXX_FLAGS, SRC, *(os.path.join(CSRC, name) for name in CODEC_SOURCES),
            "-o", out, *LIBS]


def library_path() -> str:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvo_loader_{h.hexdigest()[:16]}.so")


def _compile(tmp: str) -> None:
    out = subprocess.run(build_command(tmp), capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"building {SRC} failed:\n{out.stdout}{out.stderr}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the 13 vl_* entry points' argument and result types."""
    sig = {
        "vl_open_dataset": ([ctypes.c_char_p], _I64),
        "vl_num_frames": ([_I64], _I),
        "vl_width": ([_I64], _I),
        "vl_height": ([_I64], _I),
        "vl_start_prefetch": ([_I64, _I, _I], None),
        "vl_next": ([_I64, _U8P], _I),
        "vl_read_frame": ([_I64, _I, _U8P], _I),
        "vl_close": ([_I64], None),
        "vl_pack_dataset": ([ctypes.c_char_p, ctypes.c_char_p, _I], _I),
        "vl_open_pack": ([ctypes.c_char_p], _I64),
        "vl_pack_info": ([_I64, ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_I)],
                         _I),
        "vl_pack_read": ([_I64, _I, _I, _U8P], _I),
        "vl_close_pack": ([_I64], None),
    }
    for name, (args, res) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises RuntimeError with
    the compiler's output if the build failed (then and on every later
    call in this process)."""
    path = library_path()
    if path not in _LIBS:
        if path in _ERRORS:
            raise RuntimeError(_ERRORS[path])
        try:
            build_once(path, _compile)
            _LIBS[path] = _bind(ctypes.CDLL(path))
        except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
            _ERRORS[path] = str(exc)
            raise RuntimeError(_ERRORS[path]) from exc
    return _LIBS[path]


def available() -> bool:
    """Whether the library loads (building it on first use)."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def unavailable_reason() -> Optional[str]:
    """The failed build's output, or None if it did not fail."""
    return _ERRORS.get(library_path())


def _ptr(buf: np.ndarray):
    return buf.ctypes.data_as(_U8P)


class NativeDataset:
    """A directory's frames, decoded by the library's threads and
    delivered in order. Close it (or use it in a `with`) in the thread
    that iterates it, once iteration has stopped."""

    def __init__(self, path: str, n_threads: int = 4, depth: int = 8):
        self._lib = get_lib()
        self._h = self._lib.vl_open_dataset(path.encode())
        if not self._h:
            raise FileNotFoundError(f"no decodable images in {path!r}")
        self.num_frames = self._lib.vl_num_frames(self._h)
        self.width = self._lib.vl_width(self._h)
        self.height = self._lib.vl_height(self._h)
        self._n_threads = n_threads
        self._depth = depth
        self._started = False

    def read(self, idx: int) -> Optional[np.ndarray]:
        """Frame idx (H, W) uint8, or None if it does not decode to the
        first frame's size."""
        buf = np.empty((self.height, self.width), dtype=np.uint8)
        return buf if self._lib.vl_read_frame(self._h, idx, _ptr(buf)) == 1 else None

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        """(i, frame) in order, from the prefetch threads; a frame that
        does not decode is skipped (main.cpp:137). Iterate once."""
        if not self._started:
            self._lib.vl_start_prefetch(self._h, self._n_threads, self._depth)
            self._started = True
        i = 0
        while True:
            buf = np.empty((self.height, self.width), dtype=np.uint8)
            r = self._lib.vl_next(self._h, _ptr(buf))
            if r < 0:
                return
            if r == 1:
                yield i, buf
            i += 1

    def close(self) -> None:
        """Stop the prefetch threads and free the handle."""
        if getattr(self, "_h", 0):
            self._lib.vl_close(self._h)
            self._h = 0

    def __enter__(self) -> "NativeDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


def pack_dataset(dataset_dir: str, out_path: str, n_threads: int = 4) -> int:
    """Decode a directory once into a packed .vobin file (an unreadable
    frame as zeros); returns the frame count."""
    n = get_lib().vl_pack_dataset(dataset_dir.encode(), out_path.encode(), n_threads)
    if n < 0:
        raise RuntimeError(f"packing {dataset_dir!r} into {out_path!r} failed ({n})")
    return n


class PackedSequence:
    """A .vobin file, mmapped: read(start, count) copies frames out with
    no decode."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.vl_open_pack(path.encode())
        if not self._h:
            raise FileNotFoundError(f"bad pack file {path!r}")
        t, h, w = _I(), _I(), _I()
        self._lib.vl_pack_info(self._h, ctypes.byref(t), ctypes.byref(h), ctypes.byref(w))
        self.num_frames, self.height, self.width = t.value, h.value, w.value

    def read(self, start: int = 0, count: Optional[int] = None) -> np.ndarray:
        """Frames [start, start + count) as (count, H, W) uint8."""
        count = self.num_frames - start if count is None else count
        out = np.empty((count, self.height, self.width), dtype=np.uint8)
        r = self._lib.vl_pack_read(self._h, start, count, _ptr(out))
        if r != count:
            raise RuntimeError(f"pack read of frames [{start}, {start + count}) failed ({r})")
        return out

    def close(self) -> None:
        if getattr(self, "_h", 0):
            self._lib.vl_close_pack(self._h)
            self._h = 0

    def __enter__(self) -> "PackedSequence":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
