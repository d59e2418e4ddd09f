"""Build and load the CUDA kernels of csrc/ as one shared library.

nvcc compiles csrc/*.cu for sm_90a into a library with a plain C
interface, loaded with ctypes. The build runs on first use (never at
import) into tpu_vo_torch/_build/, named by a hash of the sources and
flags so that an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("select.cu", "patch.cu")
# -fmad=false: the select kernel's Harris arithmetic must round every
# product and sum on its own, as the eager plain version does.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


class BuildInfo:
    """What the last build did: the library path, the seconds it took
    (0 when a built library was reused) and nvcc's output."""

    path = ""
    seconds = 0.0
    log = ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libtpu_vo_kernels_{_digest()}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(os.path.join(CSRC, s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BuildInfo.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{BuildInfo.log}")
        os.replace(tmp, path)
        BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.path = path
    lib = ctypes.CDLL(path)
    lib.tvo_select_maps.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                    _I, _F, _F, _P]
    lib.tvo_select_maps.restype = _I
    lib.tvo_extract_patches.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.tvo_extract_patches.restype = _I
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if the C launcher's cudaGetLastError() was not cudaSuccess."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
