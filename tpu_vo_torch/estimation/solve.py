"""Stage 2's small linear algebra without a wait for the card: `svd(A)`
and `eigh(A)` return what torch.linalg.svd(A) and torch.linalg.eigh(A)
return, bit for bit, in the same shapes, dtypes and strides.

On a CUDA tensor of a shape where torch calls one of cuSOLVER's batched
routines, the call is made here, through ctypes, into the libcusolver
that torch has loaded:
  svd   gesvdjBatched (batched Jacobi): float32 or float64, both
        dimensions at most 32;
  eigh  XsyevBatched (batched syevd): float32 or float64, more than one
        matrix, n at most 32 (stage 2's 9x9 normal matrices).
It passes what torch passes: a column-major copy of the input, vector
mode; for svd torch's Jacobi parameters (the dtype's epsilon as the
tolerance, GESVDJ_MAX_SWEEPS sweeps, sorted singular values); for eigh
the lower triangle (UPLO='L') and default parameters; workspaces and an
info array from torch's allocators, on the current stream. U comes back
column-major and Vh row-major (the transpose of a column-major V),
eigenvectors column-major, as torch lays them out, so that the ops that
follow launch the same kernels. Each such call is the span `solve.jacobi`.

Convergence. Torch reads the info array on the host: its SVD reruns a
matrix that did not converge with gesvd and then raises, its eigh
raises. That read is the wait for the card this module removes, so it
neither reruns nor raises. It adds the number of matrices whose info is
not 0 to a counter on the card, which `nonconverged(device)` reads (and
waits for). The counter reads 0 wherever the outputs equal torch's.

Everywhere else (CPU tensors, eigh of a single matrix, where torch takes
the unbatched syevd, other shapes and dtypes, inputs that require grad)
the functions return torch.linalg's result unchanged. Nothing is loaded
until the first call on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import math
import os
import threading

import torch

from tpu_vo_torch.utils.profiling import span

MAX_N = 32                      # gesvdjBatched takes m, n <= 32; eigh's route too
GESVDJ_MAX_SWEEPS = 400         # torch's cusolver_gesvdj_max_sweeps
_PREFIX = {torch.float32: "S", torch.float64: "D"}
_DATA_TYPE = {torch.float32: 0, torch.float64: 1}   # cudaDataType CUDA_R_32F, CUDA_R_64F
_EIG_MODE_VECTOR = 1            # cusolverEigMode_t CUSOLVER_EIG_MODE_VECTOR
_FILL_MODE_LOWER = 0            # cublasFillMode_t CUBLAS_FILL_MODE_LOWER

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIZE = ctypes.c_size_t


def _routed(A, max_dim: int, min_batch: int) -> bool:
    """A CUDA float32/float64 tensor of matrices no larger than max_dim,
    at least min_batch of them, that requires no grad."""
    shape = tuple(A.shape)
    return (A.device.type == "cuda" and A.dtype in _PREFIX and len(shape) >= 2
            and 0 < shape[-2] <= max_dim and 0 < shape[-1] <= max_dim
            and math.prod(shape[:-2]) >= min_batch and not A.requires_grad)


def svd_routed(A) -> bool:
    """Where torch.linalg.svd(A) runs gesvdjBatched, and svd() makes that
    call itself."""
    return _routed(A, MAX_N, 1)


def eigh_routed(A) -> bool:
    """Where torch.linalg.eigh(A) runs XsyevBatched (a batch of more than
    one matrix) and eigh() makes that call itself, at n <= 32."""
    return _routed(A, MAX_N, 2) and A.shape[-2] == A.shape[-1]


def svd(A: torch.Tensor):
    """torch.linalg.svd(A) (full_matrices=True): (U, S, Vh)."""
    if not svd_routed(A):
        return torch.linalg.svd(A)
    with span("solve.jacobi"):
        return _gesvdj_batched(A)


def eigh(A: torch.Tensor):
    """torch.linalg.eigh(A) (UPLO='L'): (eigenvalues, eigenvectors)."""
    if not eigh_routed(A):
        return torch.linalg.eigh(A)
    with span("solve.jacobi"):
        return _xsyev_batched(A)


def nonconverged(device=None) -> int:
    """Matrices of this module's calls on the CUDA `device` (the current
    one when None) whose info was not 0, that is which did not converge,
    since the process started; waits for the card."""
    d = torch.device("cuda" if device is None else device)
    if d.type != "cuda" or not _counters:
        return 0
    c = _counters.get(torch.cuda.current_device() if d.index is None else d.index)
    return 0 if c is None else int(c.item())


# ---------------------------------------------------------------------------
# cuSOLVER
# ---------------------------------------------------------------------------

_counters: dict = {}            # device index -> int64 count on that device
_lock = threading.Lock()        # one handle a device: set its stream and call under it


def _library_path() -> str:
    """The libcusolver this process has mapped (the one torch calls), else
    the CUDA toolkit's (where torch carries cuSOLVER statically)."""
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split(None, 5)[-1].strip()
            if os.path.basename(path).startswith("libcusolver.so"):
                return path
    from torch.utils.cpp_extension import CUDA_HOME

    found = sorted(glob.glob(os.path.join(CUDA_HOME or "/usr/local/cuda", "lib64",
                                          "libcusolver.so*")))
    if not found:
        raise RuntimeError("libcusolver not found: neither mapped by torch nor in the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found[0]


_GESVDJ_BATCHED = [_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I]   # handle ... V, ldv
_XSYEV_BATCHED = [_P, _P, _I, _I, _I64, _I, _P, _I64, _I, _P, _I]  # handle ... W, computeType
# argtypes of each function called; each returns a cusolverStatus_t (int)
_SIGNATURES = {
    "cusolverDnCreate": [_P],
    "cusolverDnSetStream": [_P, _P],
    "cusolverDnCreateGesvdjInfo": [_P],
    "cusolverDnXgesvdjSetTolerance": [_P, ctypes.c_double],
    "cusolverDnXgesvdjSetMaxSweeps": [_P, _I],
    "cusolverDnXgesvdjSetSortEig": [_P, _I],
    "cusolverDnCreateParams": [_P],
    **{f"cusolverDn{p}gesvdjBatched_bufferSize": _GESVDJ_BATCHED + [_P, _P, _I] for p in "SD"},
    **{f"cusolverDn{p}gesvdjBatched": _GESVDJ_BATCHED + [_P, _I, _P, _P, _I] for p in "SD"},
    "cusolverDnXsyevBatched_bufferSize": _XSYEV_BATCHED + [_P, _P, _I64],
    "cusolverDnXsyevBatched": _XSYEV_BATCHED + [_P, _SIZE, _P, _SIZE, _P, _I64],
}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(_library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} failed with cusolverStatus_t {status}")


@functools.lru_cache(maxsize=None)
def _handle(device: torch.device) -> int:
    """One cuSOLVER handle a device, created on it."""
    h = _P()
    with torch.cuda.device(device):
        _check(_library().cusolverDnCreate(ctypes.byref(h)), "cusolverDnCreate")
    return h.value


@functools.lru_cache(maxsize=None)
def _gesvdj_params(dtype: torch.dtype) -> int:
    """gesvdjBatched's parameters as torch sets them: the dtype's machine
    epsilon as the tolerance, GESVDJ_MAX_SWEEPS sweeps, sorted singular
    values. Read-only in the batched routine."""
    p, lib = _P(), _library()
    _check(lib.cusolverDnCreateGesvdjInfo(ctypes.byref(p)), "cusolverDnCreateGesvdjInfo")
    _check(lib.cusolverDnXgesvdjSetTolerance(p, torch.finfo(dtype).eps),
           "cusolverDnXgesvdjSetTolerance")
    _check(lib.cusolverDnXgesvdjSetMaxSweeps(p, GESVDJ_MAX_SWEEPS), "cusolverDnXgesvdjSetMaxSweeps")
    _check(lib.cusolverDnXgesvdjSetSortEig(p, 1), "cusolverDnXgesvdjSetSortEig")
    return p.value


@functools.lru_cache(maxsize=None)
def _dn_params() -> int:
    """The 64-bit API's parameters at their defaults, as torch passes them."""
    p = _P()
    _check(_library().cusolverDnCreateParams(ctypes.byref(p)), "cusolverDnCreateParams")
    return p.value


@contextlib.contextmanager
def _on_stream(device: torch.device):
    """(library, the device's handle) on the device's current stream,
    under the lock."""
    lib, handle = _library(), _handle(device)
    with torch.cuda.device(device), _lock:
        _check(lib.cusolverDnSetStream(handle, torch.cuda.current_stream(device).cuda_stream),
               "cusolverDnSetStream")
        yield lib, handle


def _count(info: torch.Tensor) -> None:
    """Add the matrices whose info is not 0 to the device's counter."""
    c = _counters.get(info.device.index)
    if c is None:
        c = _counters[info.device.index] = torch.zeros((), dtype=torch.int64,
                                                       device=info.device)
    c.add_(info.ne(0).sum())


def _gesvdj_batched(A: torch.Tensor):
    m, n = A.shape[-2:]
    lead = A.shape[:-2]
    batch = math.prod(lead)
    a = A.mT.clone(memory_format=torch.contiguous_format)          # column-major A
    U = torch.empty(*lead, m, m, dtype=A.dtype, device=A.device).mT  # column-major
    S = torch.empty(*lead, min(m, n), dtype=A.dtype, device=A.device)
    Vh = torch.empty(*lead, n, n, dtype=A.dtype, device=A.device)    # column-major V
    head = (_EIG_MODE_VECTOR, m, n, a.data_ptr(), m, S.data_ptr(), U.data_ptr(), m,
            Vh.data_ptr(), n)
    name = f"cusolverDn{_PREFIX[A.dtype]}gesvdjBatched"
    params, lwork = _gesvdj_params(A.dtype), ctypes.c_int()
    with _on_stream(A.device) as (lib, handle):
        _check(getattr(lib, name + "_bufferSize")(handle, *head, ctypes.byref(lwork), params,
                                                   batch), name + "_bufferSize")
        work = torch.empty(max(lwork.value, 1), dtype=A.dtype, device=A.device)
        info = torch.empty(batch, dtype=torch.int32, device=A.device)
        _check(getattr(lib, name)(handle, *head, work.data_ptr(), lwork.value, info.data_ptr(),
                                  params, batch), name)
    _count(info)
    return torch.return_types.linalg_svd((U, S, Vh))


def _xsyev_batched(A: torch.Tensor):
    n = A.shape[-1]
    lead = A.shape[:-2]
    batch = math.prod(lead)
    V = torch.empty(*lead, n, n, dtype=A.dtype, device=A.device).mT  # column-major
    V.copy_(A)
    L = torch.empty(*lead, n, dtype=A.dtype, device=A.device)
    t = _DATA_TYPE[A.dtype]
    head = (_dn_params(), _EIG_MODE_VECTOR, _FILL_MODE_LOWER, n, t, V.data_ptr(), n, t,
            L.data_ptr(), t)
    on_device, on_host = ctypes.c_size_t(), ctypes.c_size_t()
    with _on_stream(A.device) as (lib, handle):
        _check(lib.cusolverDnXsyevBatched_bufferSize(handle, *head, ctypes.byref(on_device),
                                                     ctypes.byref(on_host), batch),
               "cusolverDnXsyevBatched_bufferSize")
        work = torch.empty(max(on_device.value, 1), dtype=torch.uint8, device=A.device)
        host_work = ctypes.create_string_buffer(max(on_host.value, 1))
        info = torch.empty(batch, dtype=torch.int32, device=A.device)
        _check(lib.cusolverDnXsyevBatched(handle, *head, work.data_ptr(), on_device.value,
                                          host_work, on_host.value, info.data_ptr(), batch),
               "cusolverDnXsyevBatched")
    _count(info)
    return torch.return_types.linalg_eigh((L, V))
