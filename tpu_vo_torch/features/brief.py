"""Steered rBRIEF-256 sampling offsets and bit packing (port of
tpu_vo/features/brief.py).

The pattern is rotated by the keypoint angle in float32 and the offsets
are rounded half to even like cvRound. Bit k of byte k//8 is
[I_blur(p_2k) < I_blur(p_2k+1)].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_vo_torch.features._orb_pattern import PATTERN_X, PATTERN_Y

_PX = np.asarray(PATTERN_X, dtype=np.float32)  # (512,)
_PY = np.asarray(PATTERN_Y, dtype=np.float32)
_DEG2RAD = float(np.float32(np.pi / 180.0))


@functools.lru_cache(maxsize=None)
def _pattern(device: torch.device):
    """(x, y) of the 512 pattern points on `device`, copied once (a copy
    from pageable host memory waits for the stream to drain)."""
    return torch.as_tensor(_PX, device=device), torch.as_tensor(_PY, device=device)


def steered_offsets(angles_deg: torch.Tensor):
    """Rotated integer sample offsets (dy, dx), each (..., 512) int64.

    a = cos(angle*pi/180), b = sin(...), column offset round(x*a - y*b),
    row offset round(x*b + y*a), all in float32. sin/cos may differ from
    libm/XLA by an ulp, which can flip an offset sitting on a .5 boundary.
    """
    ang = angles_deg.to(torch.float32) * _DEG2RAD
    a = torch.cos(ang)[..., None]
    b = torch.sin(ang)[..., None]
    px, py = _pattern(ang.device)
    dx = torch.round(px * a - py * b).to(torch.int64)
    dy = torch.round(px * b + py * a).to(torch.int64)
    return dy, dx


def pack_bits_u8(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 32) uint8, little bit order (cv2 layout)."""
    b = bits.reshape(*bits.shape[:-1], 32, 8).to(torch.int32)
    w = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * w).sum(-1).to(torch.uint8)


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) uint32 lanes, stored as int32 with the
    same bit pattern (torch has no uint32 arithmetic on the CPU)."""
    b = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    w = 1 << torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (b * w).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
