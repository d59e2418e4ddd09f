# Frozen copy of tpu_vo_torch/estimation/recover_pose.py (whole): the benchmark's reference.
"""Pose recovery from an essential matrix with cheirality
disambiguation (port of tpu_vo/estimation/recover_pose.py).

The four (R, t) decompositions are evaluated as one stacked batch; the
winner maximizes the bounded cheirality count, ties broken by the
unbounded positive-depth count (cv::recoverPose whenever the bounded
counts differ).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from vobench.reference.triangulation import cheirality_mask


class RecoveredPose(NamedTuple):
    R: torch.Tensor           # (..., 3, 3) rotation, x_c2 = R x_c1 + t
    t: torch.Tensor           # (..., 3) unit translation
    mask: torch.Tensor        # (..., N) bool: input inliers passing cheirality
    num_valid: torch.Tensor   # (...,) int32 count of mask


@functools.lru_cache(maxsize=None)
def _w(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Hartley-Zisserman's W on `device`, copied once (a copy from
    pageable host memory waits for the stream to drain)."""
    return torch.tensor(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
                        dtype=dtype, device=device)


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t): proper rotations and a unit t via SVD; the four
    candidate motions are (R1, +-t), (R2, +-t)."""
    U, _, Vt = torch.linalg.svd(E)
    sU = torch.sign(torch.linalg.det(U))
    sV = torch.sign(torch.linalg.det(Vt))
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * sU[..., None, None]], dim=-1)
    Vt = torch.cat([Vt[..., :2, :], Vt[..., 2:, :] * sV[..., None, None]], dim=-2)
    W = _w(E.dtype, E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def recover_pose_from_essential(E: torch.Tensor, x1: torch.Tensor,
                                x2: torch.Tensor, mask: torch.Tensor,
                                distance_thresh: float = 50.0) -> RecoveredPose:
    """Select the cheirality-consistent (R, t) among the 4 decompositions.

    E: (..., 3, 3); x1/x2: (..., N, 2) normalized; mask: (..., N) bool.
    """
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2], dim=0)            # (4, ..., 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=0)              # (4, ..., 3)
    che = cheirality_mask(Rs, ts, x1, x2, distance_thresh) & mask
    counts = che.sum(-1)                                 # (4, ...)
    che_unb = cheirality_mask(Rs, ts, x1, x2, float("inf")) & mask
    key_lex = counts * (x1.shape[-2] + 1) + che_unb.sum(-1)
    best = torch.argmax(key_lex, dim=0)                  # (...,)

    def take(stacked):
        idx = best.reshape(1, *best.shape, *([1] * (stacked.dim() - 1 - best.dim())))
        idx = idx.expand(1, *stacked.shape[1:])
        return torch.gather(stacked, 0, idx)[0]

    return RecoveredPose(take(Rs), take(ts), take(che),
                         take(counts).to(torch.int32))
