"""Angles and rBRIEF bits of 43x43 windows: the describe kernel.

`describe_windows` launches csrc/describe.cu once for all windows of a
CUDA tensor: each window's intensity-centroid angle, its 7x7 Gaussian
blur and its 256 steered rBRIEF bits, with no intermediate in device
memory. `describe_windows_reference` is its plain version, the eager
functions of features/patches (`angles_from_patches`,
`descriptor_bits_from_patches`), which `describe_windows` runs on the
CPU and which the kernel is held to bit for bit on
windows of integer pixels, as the pyramid makes them (the moments' sums
are then exact in any order).

The kernel's constants are the eager code's own, passed at launch: the
float32 taps of patches.blur_taps, fast_atan2_deg's polynomial and eps,
brief's deg-to-rad factor and 512 pattern points, and the umax table of
the moment circle.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_vo_torch.features import brief, orientation, patches
from tpu_vo_torch.ops._describe_abi import UMAX_ROWS, DescribeConsts

RAW_SIZE = patches.RAW_SIZE  # 43
N_BITS = 256


@functools.lru_cache(maxsize=None)
def consts() -> DescribeConsts:
    """The constants of the eager code, each the float32 rounding of the
    Python scalar it uses."""
    o = orientation
    return DescribeConsts((ctypes.c_float * 7)(*patches.blur_taps()), o._P1, o._P3, o._P5,
                          o._P7, o._EPS, brief._DEG2RAD,
                          (ctypes.c_int * UMAX_ROWS)(*map(int, o.build_umax())))


def _check(raw: torch.Tensor) -> None:
    if raw.dtype != torch.float32:
        raise ValueError(f"windows must be float32, got {raw.dtype}")
    if raw.dim() < 2 or tuple(raw.shape[-2:]) != (RAW_SIZE, RAW_SIZE):
        raise ValueError(f"windows must be (..., {RAW_SIZE}, {RAW_SIZE}), got "
                         f"{tuple(raw.shape)}")
    if not raw.is_contiguous():
        raise ValueError("windows must be contiguous")


def describe_windows_reference(raw: torch.Tensor):
    """Plain PyTorch version of the describe kernel: (angles (...,) f32
    degrees, bits (..., 256) bool) of (..., 43, 43) windows."""
    ang = patches.angles_from_patches(raw)
    return ang, patches.descriptor_bits_from_patches(raw, ang)


def _describe_cuda(raw: torch.Tensor):
    from tpu_vo_torch.ops import _build

    lead = tuple(raw.shape[:-2])
    ang = torch.empty(lead, dtype=torch.float32, device=raw.device)
    bits = torch.empty(lead + (N_BITS,), dtype=torch.bool, device=raw.device)
    if ang.numel() == 0:
        return ang, bits
    px, py = brief._pattern(raw.device)
    with _build.on_device(raw) as stream:
        err = _build.library().tvo_describe_windows(
            raw.data_ptr(), ang.data_ptr(), bits.data_ptr(), ang.numel(), consts(),
            px.data_ptr(), py.data_ptr(), stream)
    _build.check_launch(err, "describe_windows")
    describe_windows.launches += 1
    return ang, bits


def describe_windows(raw: torch.Tensor):
    """(angles (...,) f32 degrees, bits (..., 256) bool) of contiguous
    (..., 43, 43) float32 windows: on a CUDA device the describe kernel,
    one launch, equal bit for bit to describe_windows_reference, which
    runs on the CPU."""
    _check(raw)
    if raw.device.type == "cuda":
        return _describe_cuda(raw)
    if raw.device.type == "cpu":
        return describe_windows_reference(raw)
    raise ValueError(f"describe_windows: unsupported device {raw.device}")


describe_windows.launches = 0  # describe kernel launches
