"""Adaptive match filtering (port of tpu_vo/matching/filter.py).

Keeps matches with d < min(max(3 * min_dist, 0.7 * median_dist), 35),
where the median is the upper median sorted[n // 2], as masked
reductions over the fixed-capacity slots, batched over leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_vo_torch.configs import MatchConfig
from tpu_vo_torch.matching.hamming import MAX_DIST, Matches


class MatchStats(NamedTuple):
    """The reference's [MatchDebug] record (units: Hamming bits)."""

    num_matches: torch.Tensor  # int32
    min: torch.Tensor
    max: torch.Tensor
    mean: torch.Tensor
    median: torch.Tensor
    threshold: torch.Tensor


def match_statistics(m: Matches, cfg: MatchConfig = MatchConfig()) -> MatchStats:
    inf = torch.full_like(m.distance, float("inf"))
    zero = torch.zeros_like(m.distance[..., 0])
    d = torch.where(m.valid, m.distance, inf)
    n = m.valid.sum(-1).to(torch.int32)
    has = n > 0
    dmin = torch.where(has, d.amin(-1), zero)
    dmax = torch.where(has, torch.where(m.valid, m.distance, -inf).amax(-1), zero)
    dsum = torch.where(m.valid, m.distance, torch.zeros_like(m.distance)).sum(-1)
    dmean = torch.where(has, dsum / torch.clamp(n, min=1), zero)
    dsort = torch.sort(d, dim=-1).values
    dmed = torch.where(has, torch.gather(dsort, -1, (n // 2).to(torch.int64)[..., None])[..., 0], zero)
    thr = torch.clamp(torch.maximum(cfg.min_scale * dmin, cfg.median_scale * dmed),
                      max=cfg.max_hamming)
    return MatchStats(n, dmin, dmax, dmean, dmed, thr)


def adaptive_threshold_filter(m: Matches, cfg: MatchConfig = MatchConfig()):
    """Apply the reference threshold; returns (filtered Matches, MatchStats)."""
    stats = match_statistics(m, cfg)
    keep = m.valid & (m.distance < stats.threshold[..., None])
    return Matches(
        train_idx=m.train_idx,
        distance=torch.where(keep, m.distance, torch.full_like(m.distance, MAX_DIST)),
        valid=keep,
    ), stats
