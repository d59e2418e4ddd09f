"""Build and load the CUDA kernels of csrc/ as one shared library.

nvcc compiles each of csrc/*.cu for sm_90a, all at once in parallel
processes, and links the objects into a library with a plain C
interface, loaded with ctypes. The build runs on first use (never at
import) into tpu_vo_torch/_build/, named by a hash of the sources and
flags so that an edited source is rebuilt.

`build_once` makes such a file race-free; the native image loader
(io/native_loader) builds through it too.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable

import torch

from tpu_vo_torch.ops._describe_abi import DescribeConsts
from tpu_vo_torch.ops.levels import LevelTable
from tpu_vo_torch.utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("select.cu", "patch.cu", "fast.cu", "patch_probe.cu", "describe.cu")
HEADERS = ("levels.cuh",)
# -fmad=false: the select kernel's Harris arithmetic and the describe
# kernel's blur, angle and offsets must round every product and sum on
# its own, as the eager plain versions do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


class BuildInfo:
    """What the last build did: the library path, the seconds it took
    (0 when a built library was reused) and nvcc's output."""

    path = ""
    seconds = 0.0
    log = ""


def build_once(path: str, build: Callable[[str], None]) -> bool:
    """Make `path` with build(tmp) unless it exists; True if this call
    built it. Under an exclusive flock on `path + ".lock"`, build(tmp)
    writes a file of this process's own (`<path>.<pid>.tmp`), which
    os.replace then moves into place: processes that need `path` at the
    same moment build it once, and none loads a half-written file. An
    exception of build(tmp) propagates, and the next caller tries again."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return False
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            build(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return True


def _nvcc_build(tmp: str) -> None:
    """Compile each of SOURCES in parallel and link them into tmp."""
    nvcc = _nvcc()
    objs = [f"{tmp}.{s}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    BuildInfo.log = "".join(logs)
    try:
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{BuildInfo.log}")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed (in
    the span kernels.load)."""
    with span("kernels.load"):
        path = os.path.join(BUILD_DIR, f"libtpu_vo_kernels_{_digest()}.so")
        t0 = time.perf_counter()
        if build_once(path, _nvcc_build):
            BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.path = path
        lib = ctypes.CDLL(path)
        lib.tvo_select_maps_levels.argtypes = [LevelTable, _I, _F, _I, _F, _F, _I, _P]
        lib.tvo_select_maps_levels.restype = _I
        lib.tvo_select_maps_occupancy.argtypes = [_I, ctypes.POINTER(_I)]
        lib.tvo_select_maps_occupancy.restype = _I
        lib.tvo_extract_patches_levels.argtypes = [LevelTable, _P, _P, _P, _I, _P]
        lib.tvo_extract_patches_levels.restype = _I
        lib.tvo_fast_margin_levels.argtypes = [LevelTable, _I, _F, _P]
        lib.tvo_fast_margin_levels.restype = _I
        lib.tvo_fast_margin_occupancy.argtypes = [ctypes.POINTER(_I)]
        lib.tvo_fast_margin_occupancy.restype = _I
        lib.tvo_band_windows.argtypes = [_P, _P, _P, _P, *[_I] * 9, _P]
        lib.tvo_band_windows.restype = _I
        lib.tvo_phase_windows.argtypes = [_P, _P, _P, _P, *[_I] * 8, _P]
        lib.tvo_phase_windows.restype = _I
        lib.tvo_windows_blocks_per_sm.argtypes = [_I, _I, _I]
        lib.tvo_windows_blocks_per_sm.restype = _I
        lib.tvo_describe_windows.argtypes = [_P, _P, _P, _I, DescribeConsts, _P, _P, _P]
        lib.tvo_describe_windows.restype = _I
        return lib


@contextlib.contextmanager
def on_device(t: torch.Tensor):
    """Make t's device the current one for a launch, and yield the handle
    of its current stream: a kernel launches, and the launchers' caches
    per device look up, on the device of the tensors it is given."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, name: str) -> None:
    """Raise if the C launcher's cudaGetLastError() was not cudaSuccess."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
