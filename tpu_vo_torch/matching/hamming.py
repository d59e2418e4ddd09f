"""Brute-force Hamming matching of 256-bit descriptors with a
cross-check (port of tpu_vo/matching/hamming.py).

Descriptors unpack to +-1 float32 vectors; popcount(a XOR b) =
(256 - <a, b>) / 2, so the distance matrix is one 256-deep f32 matmul
with integer results below 2^24 (exact; TF32 is off package-wide).
Cross-check: query i matches train j iff j = argmin_j d(i, j) and
i = argmin_i d(i, j), lowest index first on ties like OpenCV's sequential
scans. Ratio test: the nearest j when its distance is below `ratio` times
the second nearest. Invalid slots get MAX_DIST and never match. All
functions take leading batch dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_DIST = 512.0  # > 256, sentinel for invalid pairs


class Matches(NamedTuple):
    """Fixed-capacity match set: one slot per query descriptor."""

    train_idx: torch.Tensor  # (..., N) int64 best train index per query
    distance: torch.Tensor   # (..., N) float32 Hamming distance
    valid: torch.Tensor      # (..., N) bool — survived cross-check and masks


def _unpack_pm1(desc32: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) int32 lanes -> (..., N, 256) +-1 float32."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc32.device)
    bits = (desc32[..., :, None] >> shifts) & 1
    bits = bits.reshape(*desc32.shape[:-1], 256)
    return bits.to(torch.float32) * 2.0 - 1.0


def hamming_distance_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(..., N, M) float32 exact Hamming distances of (..., N|M, 8) lanes."""
    dot = _unpack_pm1(d1) @ _unpack_pm1(d2).transpose(-1, -2)
    return (256.0 - dot) * 0.5


def masked_distances(d1, d2, valid1, valid2) -> torch.Tensor:
    dist = hamming_distance_matrix(d1, d2)
    mask = valid1[..., :, None] & valid2[..., None, :]
    return torch.where(mask, dist, torch.full_like(dist, MAX_DIST))


def mutual_nearest_match(d1: torch.Tensor, d2: torch.Tensor,
                         valid1: torch.Tensor, valid2: torch.Tensor) -> Matches:
    """BFMatcher(crossCheck=true) semantics on fixed-capacity inputs."""
    dist = masked_distances(d1, d2, valid1, valid2)
    best_j = torch.argmin(dist, dim=-1)                     # (..., N)
    best_i = torch.argmin(dist, dim=-2)                     # (..., M)
    d_best = torch.gather(dist, -1, best_j[..., None])[..., 0]
    i_idx = torch.arange(dist.shape[-2], device=dist.device)
    mutual = torch.gather(best_i, -1, best_j) == i_idx
    ok = mutual & valid1 & (d_best < MAX_DIST)
    return Matches(
        train_idx=best_j,
        distance=torch.where(ok, d_best, torch.full_like(d_best, MAX_DIST)),
        valid=ok,
    )


def ratio_test_match(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor,
                     valid2: torch.Tensor, ratio: float = 0.75) -> Matches:
    """Lowe ratio-test matching: query i keeps its nearest train j when
    d1st < ratio * d2nd, the second distance taken with MAX_DIST written
    over the (first-minimum) best column, so a tie at the first distance
    fails the test."""
    dist = masked_distances(d1, d2, valid1, valid2)
    best_j = torch.argmin(dist, dim=-1)
    d1st = torch.gather(dist, -1, best_j[..., None])[..., 0]
    d2nd = dist.scatter(-1, best_j[..., None], MAX_DIST).amin(-1)
    ok = valid1 & (d1st < MAX_DIST) & (d1st < ratio * d2nd)
    return Matches(
        train_idx=best_j,
        distance=torch.where(ok, d1st, torch.full_like(d1st, MAX_DIST)),
        valid=ok,
    )
