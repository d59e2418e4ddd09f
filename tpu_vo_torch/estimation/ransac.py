"""Fixed-budget essential-matrix RANSAC, batched over pairs (port of
tpu_vo/estimation/ransac.py `find_essential_ransac`): SoA 5-point or
8-point hypotheses, two-phase MSAC or inlier-count scoring, adaptive
sigma (MSAC), the finalist cheirality gate and the linear LO refit.

Every (pair, hypothesis) is solved and scored in parallel: 256 minimal
samples -> up to 2560 5-point candidates (256 8-point models) per pair,
ranked on a fixed valid-first subset of `prescreen` correspondences, then
the top `finalists` scored on the full set. Where the set is no larger
than the subset (N <= prescreen) or either count is 0, every candidate is
scored on the full set, with no finalist cut and no cheirality gate, and
adaptive sigma adapts on the full set. Ties break by lowest index (stable
sorts, first-minimum argmin for the MSAC loss after `_quantize_ranking`,
first-maximum argmax for inlier counts), as in the JAX package.

Its phases are functions of their own: draw_samples, hypotheses,
prescreen_finalists (two-phase scoring only), score_finalists and
lo_refit. `Phases` holds one call's arguments and the policy they set,
and chains the phases in order; find_essential_ransac returns its run,
and tools/profile_ransac times its methods one by one.

Sampling: `idx` takes explicit (P, max_iters, S) sample indices (the seam
the tests feed with the JAX package's draws; S = 5, or 8 for 8-point);
otherwise one CPU torch.Generator per pair draws them, so a pair's
samples depend neither on how the pairs are batched nor on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from tpu_vo_torch.estimation.eight_point import estimate_essential_8pt
from tpu_vo_torch.estimation.five_point import five_point_candidates_batched
from tpu_vo_torch.estimation.recover_pose import decompose_essential
from tpu_vo_torch.geometry.epipolar import sampson_error
from tpu_vo_torch.geometry.triangulation import cheirality_mask
from tpu_vo_torch.utils.profiling import span


# Two-phase scoring: every hypothesis ranked on a subset of PRESCREEN
# correspondences, the best FINALISTS then scored on the full set
PRESCREEN = 128
FINALISTS = 16


class EssentialRansacResult(NamedTuple):
    E: torch.Tensor              # (P, 3, 3) best essential matrix
    inliers: torch.Tensor        # (P, N) bool inlier mask (includes validity)
    num_inliers: torch.Tensor    # (P,) int32
    success: torch.Tensor        # (P,) bool — a usable model was found
    num_hypotheses: torch.Tensor  # (P,) int32 — valid candidate models scored


def _valid_first(mask: torch.Tensor) -> torch.Tensor:
    """(P, N) slot order with the valid slots first, each part ascending
    (jnp.argsort(~mask), which is stable)."""
    return torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)


def draw_samples(generators: Sequence[torch.Generator], mask: torch.Tensor,
                 n_iters: int, sample_size: int) -> torch.Tensor:
    """(P, n_iters, sample_size) indices drawn uniformly (with replacement)
    from each pair's valid slots, one CPU generator per pair (the uniform
    draws are moved to the mask's device, so a CPU and a CUDA run draw the
    same samples). The draws go to a CUDA device from pinned memory, so
    the copy does not wait for the stream to drain."""
    u = torch.stack([torch.rand((n_iters, sample_size), generator=g)
                     for g in generators])
    if mask.is_cuda:
        u = u.pin_memory().to(mask.device, non_blocking=True)
    n_valid = torch.clamp(mask.sum(-1), min=1)[:, None, None]
    r = torch.minimum((u * n_valid).to(torch.int64), n_valid - 1)
    return torch.gather(_valid_first(mask), 1, r.flatten(1)).view(r.shape)


def _quantize_ranking(loss: torch.Tensor, bits: int = 12) -> torch.Tensor:
    """Truncate a non-negative f32 score to `bits` mantissa bits, so that
    near-ties become exact ties independent of reduction order."""
    keep = ~((1 << (23 - bits)) - 1)
    return (loss.to(torch.float32).view(torch.int32) & keep).view(torch.float32)


def _errors(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(P, H, N) Sampson errors of (P, H, 3, 3) hypotheses, inf if not finite."""
    err = sampson_error(E, x1[:, None], x2[:, None])
    return torch.where(torch.isfinite(err), err, torch.full_like(err, float("inf")))


def _score(E, x1, x2, mask, thr_sq) -> torch.Tensor:
    """(P, H, N) inlier masks of (P, H, 3, 3) hypotheses."""
    return (_errors(E, x1, x2) < thr_sq) & mask[:, None]


def _score_msac(E, x1, x2, mask, thr_sq, score_sq):
    """(inlier masks at thr_sq, MSAC loss at score_sq per inlier) of
    (P, H, 3, 3) hypotheses; thr_sq/score_sq are (P, 1, 1)."""
    err = _errors(E, x1, x2)
    inl = (err < thr_sq) & mask[:, None]
    loss = torch.where(mask[:, None], torch.minimum(err, score_sq),
                       torch.zeros_like(err)).sum(-1)
    return inl, loss / torch.clamp(inl.sum(-1).to(loss.dtype), min=1.0)


def _finalist_cheirality_frac(Es, x1s, x2s, inl_sub, distance_thresh):
    """(P, F) fraction of each finalist's subset inliers passing
    cheirality under its best of four decompositions."""
    R1, R2, t = decompose_essential(Es)
    Rs = torch.stack([R1, R1, R2, R2], dim=2)               # (P, F, 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=2)                 # (P, F, 4, 3)
    che = cheirality_mask(Rs, ts, x1s[:, None, None], x2s[:, None, None],
                          distance_thresh)                  # (P, F, 4, S)
    counts = (che & inl_sub[:, :, None]).sum(-1).amax(-1)
    denom = torch.clamp(inl_sub.sum(-1), min=1)
    return counts.to(torch.float32) / denom.to(torch.float32)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[p, i[p, ...]] along axis 1 for every pair p."""
    p = torch.arange(x.shape[0], device=x.device)
    return x[p.view(-1, *([1] * (i.dim() - 1))), i]


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis, on every device
    (lax.argmax's tie rule), built from a max and a min rather than
    relying on how a backend's argmax breaks ties."""
    i = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    at_max = x == x.amax(-1, keepdim=True)
    return torch.where(at_max, i, torch.full_like(i, x.shape[-1])).amin(-1)


def _adapted_score_sq(Es, x1s, x2s, sub_inl0, sub_loss, valid_models,
                      score_sq, thr_sq):
    """clip(9 * median inlier Sampson residual of the provisional winner
    on (x1s, x2s), base, thr^2) per pair, shaped (P, 1, 1): the prescreen
    subset with two-phase scoring, else the full set."""
    inf = torch.full_like(sub_loss, float("inf"))
    prov = torch.argmin(torch.where(valid_models, _quantize_ranking(sub_loss), inf), -1)
    err_p = _errors(_take(Es, prov[:, None]), x1s, x2s)[:, 0]   # (P, S)
    inl_p = _take(sub_inl0, prov[:, None])[:, 0]
    srt = torch.sort(torch.where(inl_p, err_p, torch.full_like(err_p, float("inf"))), dim=-1).values
    kk = torch.clamp(inl_p.sum(-1), min=1)
    med = torch.gather(srt, 1, ((kk - 1) // 2)[:, None])[:, 0]
    base = score_sq.view(-1)
    med = torch.where(torch.isfinite(med), med, base)
    return torch.minimum(torch.maximum(9.0 * med, base), thr_sq.view(-1)).view(-1, 1, 1)


class Winner(NamedTuple):
    """The best hypothesis of each pair after full-set scoring."""
    E: torch.Tensor              # (P, 3, 3)
    inliers: torch.Tensor        # (P, N) bool
    count: torch.Tensor          # (P,) inlier count, -1 where no valid model won
    loss: Optional[torch.Tensor]  # (P,) quantized MSAC loss (None: count scoring)


def thresholds(threshold, p_: int, score_sigma_scale: float, dtype, device):
    """(thr_sq, score_sq), each (P, 1, 1): the squared inlier threshold of
    each pair and the MSAC truncation before adaptive sigma."""
    thr = torch.as_tensor(threshold, dtype=dtype, device=device).expand(p_)
    thr_sq = (thr ** 2).view(-1, 1, 1)
    return thr_sq, thr_sq * (score_sigma_scale ** 2)


def uses_prescreen(n: int, prescreen: int, finalists: int) -> bool:
    """Two-phase scoring (prescreen subset, then finalists on the full
    set) at N = n correspondences; else every hypothesis on the full set."""
    two_phase = bool(prescreen) and bool(finalists) and prescreen < n
    if two_phase and (prescreen < 1 or finalists < 1):
        raise ValueError(f"two-phase scoring needs prescreen {prescreen} and finalists "
                         f"{finalists} of at least 1")
    return two_phase


def hypotheses(x1: torch.Tensor, x2: torch.Tensor, idx: torch.Tensor,
               use_five_point: bool = True):
    """(Es (P, H, 3, 3), valid (P, H)) of the (P, iters, S) samples idx:
    up to 10 five-point candidates a sample (H = iters * 10), or one
    8-point model a sample."""
    p_ = x1.shape[0]
    s1, s2 = _take(x1, idx), _take(x2, idx)                 # (P, iters, S, 2)
    if use_five_point:
        Es, valid_models = five_point_candidates_batched(s1, s2)
        return Es.reshape(p_, -1, 3, 3), valid_models.reshape(p_, -1)
    Es = estimate_essential_8pt(s1, s2, torch.ones(s1.shape[:-1], dtype=torch.bool,
                                                   device=x1.device))
    return Es, torch.ones(Es.shape[:2], dtype=torch.bool, device=x1.device)


def prescreen_finalists(Es, valid_models, x1, x2, mask, thr_sq, score_sq,
                        prescreen: int = PRESCREEN, finalists: int = FINALISTS,
                        msac: bool = True, adaptive_sigma: bool = True,
                        cheirality_gate: bool = True, cheirality_min_frac: float = 0.25,
                        distance_thresh: float = 50.0):
    """Phase 1: rank every hypothesis on a fixed valid-first subset of
    `prescreen` correspondences (adaptive sigma on the subset with MSAC)
    and keep the top `finalists`, with their cheirality gate. Returns
    (Es, valid_models, gate_ok or None, score_sq) of the finalists."""
    sub = _valid_first(mask)[:, :prescreen]
    x1s, x2s, ms = _take(x1, sub), _take(x2, sub), _take(mask, sub)
    if msac:
        sub_inl0, sub_loss = _score_msac(Es, x1s, x2s, ms, thr_sq, score_sq)
        if adaptive_sigma:
            score_sq = _adapted_score_sq(Es, x1s, x2s, sub_inl0, sub_loss,
                                         valid_models, score_sq, thr_sq)
            _, sub_loss = _score_msac(Es, x1s, x2s, ms, thr_sq, score_sq)
        sub_rank = torch.where(valid_models, -_quantize_ranking(sub_loss),
                               torch.full_like(sub_loss, -float("inf")))
    else:
        counts = _score(Es, x1s, x2s, ms, thr_sq).sum(-1)
        sub_rank = torch.where(valid_models, counts, torch.full_like(counts, -1))
    top = torch.sort(sub_rank, dim=-1, descending=True, stable=True).indices
    top = top[:, :min(finalists, Es.shape[1])]
    Es = _take(Es, top)
    valid_models = _take(valid_models, top)
    gate_ok = None
    if cheirality_gate:
        inl_sub = _score(Es, x1s, x2s, ms, thr_sq)
        frac = _finalist_cheirality_frac(Es, x1s, x2s, inl_sub, distance_thresh)
        gate_ok = valid_models & (frac >= cheirality_min_frac)
    return Es, valid_models, gate_ok, score_sq


def score_finalists(Es, valid_models, gate_ok, x1, x2, mask, thr_sq, score_sq,
                    msac: bool = True, adapt: bool = False):
    """Phase 2: score the finalists (every hypothesis without phase 1) on
    the full set and pick each pair's best, the cheirality gate applied
    where any finalist passes it; `adapt` runs adaptive sigma here (MSAC
    without phase 1). Returns (Winner, score_sq)."""
    if msac:
        inlier_masks, losses = _score_msac(Es, x1, x2, mask, thr_sq, score_sq)
        if adapt:
            score_sq = _adapted_score_sq(Es, x1, x2, inlier_masks, losses, valid_models,
                                         score_sq, thr_sq)
            inlier_masks, losses = _score_msac(Es, x1, x2, mask, thr_sq, score_sq)
        inf = torch.full_like(losses, float("inf"))
        losses = torch.where(valid_models, _quantize_ranking(losses), inf)
        if gate_ok is not None:
            gated = torch.where(gate_ok, losses, inf)
            losses = torch.where(torch.isfinite(gated).any(-1, keepdim=True), gated, losses)
        best = torch.argmin(losses, -1)[:, None]
        loss_best = _take(losses, best)[:, 0]
        counts = inlier_masks.sum(-1)
        count_best = torch.where(_take(valid_models, best)[:, 0], _take(counts, best)[:, 0],
                                 torch.full_like(counts[:, 0], -1))
    else:
        inlier_masks = _score(Es, x1, x2, mask, thr_sq)
        counts = inlier_masks.sum(-1)
        none = torch.full_like(counts, -1)
        counts = torch.where(valid_models, counts, none)
        if gate_ok is not None:
            gated = torch.where(gate_ok, counts, none)
            counts = torch.where((gated >= 0).any(-1, keepdim=True), gated, counts)
        best = first_argmax(counts)[:, None]
        count_best = _take(counts, best)[:, 0]
        loss_best = None
    winner = Winner(_take(Es, best)[:, 0], _take(inlier_masks, best)[:, 0], count_best,
                    loss_best)
    return winner, score_sq


def lo_refit(winner: Winner, x1, x2, mask, thr_sq, score_sq, num_hypotheses,
             sample_size: int = 5) -> EssentialRansacResult:
    """The LO refit: a linear 8-point fit on the winner's inliers, kept
    where its score is no worse (MSAC loss, or inlier count); a pair
    succeeds where the winner has at least `sample_size` inliers."""
    E_best, inl_best = winner.E, winner.inliers
    n_best = torch.clamp(winner.count, min=0).to(torch.int32)
    success = winner.count >= sample_size
    E_ref = estimate_essential_8pt(x1, x2, inl_best)
    if winner.loss is not None:
        inl_ref, loss_ref = _score_msac(E_ref[:, None], x1, x2, mask, thr_sq, score_sq)
        inl_ref, loss_ref = inl_ref[:, 0], loss_ref[:, 0]
        loss_ref = torch.where(torch.isfinite(loss_ref), _quantize_ranking(loss_ref),
                               torch.full_like(loss_ref, float("inf")))
        better = (loss_ref <= winner.loss) & success
    else:
        inl_ref = _score(E_ref[:, None], x1, x2, mask, thr_sq)[:, 0]
        better = (inl_ref.sum(-1) >= n_best) & success
    E_best = torch.where(better[:, None, None], E_ref, E_best)
    inl_best = torch.where(better[:, None], inl_ref, inl_best)
    n_best = torch.where(better, inl_ref.sum(-1).to(torch.int32), n_best)
    return EssentialRansacResult(
        E=E_best,
        inliers=inl_best & success[:, None],
        num_inliers=torch.where(success, n_best, torch.zeros_like(n_best)),
        success=success,
        num_hypotheses=num_hypotheses,
    )


class Phases:
    """find_essential_ransac on one batch of P pairs, phase by phase: its
    arguments, the policy they set (two-phase scoring or not; adaptive
    sigma on the prescreen subset or on the full set) and one method a
    phase. run(idx) chains them and is find_essential_ransac's result;
    tools/profile_ransac calls the methods one by one."""

    def __init__(self, x1, x2, mask, threshold, max_iters: int = 256,
                 use_five_point: bool = True, prescreen: int = PRESCREEN,
                 finalists: int = FINALISTS, score: str = "msac",
                 score_sigma_scale: float = 0.5, adaptive_sigma: bool = True,
                 cheirality_gate: bool = True, cheirality_min_frac: float = 0.25,
                 distance_thresh: float = 50.0):
        if score not in ("msac", "count"):
            raise ValueError(f"unknown score method {score!r}")
        self.x1, self.x2, self.mask = x1, x2, mask
        self.max_iters, self.use_five_point = max_iters, use_five_point
        self.prescreen_n, self.finalists = prescreen, finalists
        self.msac = score == "msac"
        self.adaptive_sigma = adaptive_sigma
        self.gate = (cheirality_gate, cheirality_min_frac, distance_thresh)
        self.two_phase = uses_prescreen(mask.shape[1], prescreen, finalists)
        self.sample_size = 5 if use_five_point else 8
        self.thr_sq, self.score_sq = thresholds(threshold, mask.shape[0], score_sigma_scale,
                                                x1.dtype, x1.device)

    def draw(self, generators: Sequence[torch.Generator]) -> torch.Tensor:
        """draw_samples: (P, max_iters, S) sample indices."""
        with span("ransac.draw"):
            return draw_samples(generators, self.mask, self.max_iters, self.sample_size)

    def hypotheses(self, idx: torch.Tensor):
        """(Es, valid_models, num_hypotheses) of the samples idx."""
        Es, valid_models = hypotheses(self.x1, self.x2, idx, self.use_five_point)
        return Es, valid_models, valid_models.sum(-1).to(torch.int32)

    def prescreen(self, Es, valid_models):
        """Phase 1 (prescreen_finalists) with two-phase scoring; else every
        hypothesis as it is. Returns (Es, valid_models, gate_ok or None,
        score_sq)."""
        if not self.two_phase:
            return Es, valid_models, None, self.score_sq
        return prescreen_finalists(Es, valid_models, self.x1, self.x2, self.mask, self.thr_sq,
                                   self.score_sq, self.prescreen_n, self.finalists, self.msac,
                                   self.adaptive_sigma, *self.gate)

    def fullscore(self, Es, valid_models, gate_ok, score_sq):
        """Phase 2 (score_finalists), adaptive sigma here with MSAC where
        there was no phase 1. Returns (Winner, score_sq)."""
        adapt = self.msac and self.adaptive_sigma and not self.two_phase
        return score_finalists(Es, valid_models, gate_ok, self.x1, self.x2, self.mask,
                               self.thr_sq, score_sq, self.msac, adapt)

    def refit(self, winner: Winner, score_sq, num_hypotheses) -> EssentialRansacResult:
        """lo_refit."""
        return lo_refit(winner, self.x1, self.x2, self.mask, self.thr_sq, score_sq,
                        num_hypotheses, self.sample_size)

    def search(self, idx: torch.Tensor):
        """The phases before the refit chained on samples idx, each in its
        span (ransac.hypotheses, .prescreen, .fullscore): (Winner,
        score_sq, num_hypotheses), refit's arguments."""
        with span("ransac.hypotheses"):
            Es, valid_models, num_hypotheses = self.hypotheses(idx)
        with span("ransac.prescreen"):
            Es, valid_models, gate_ok, score_sq = self.prescreen(Es, valid_models)
        with span("ransac.fullscore"):
            winner, score_sq = self.fullscore(Es, valid_models, gate_ok, score_sq)
        return winner, score_sq, num_hypotheses

    def run(self, idx: torch.Tensor) -> EssentialRansacResult:
        """search, then refit in its span (ransac.refit)."""
        winner, score_sq, num_hypotheses = self.search(idx)
        with span("ransac.refit"):
            return self.refit(winner, score_sq, num_hypotheses)


def find_essential_ransac(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    threshold,
    generators: Optional[Sequence[torch.Generator]] = None,
    idx: Optional[torch.Tensor] = None,
    max_iters: int = 256,
    use_five_point: bool = True,
    prescreen: int = PRESCREEN,
    finalists: int = FINALISTS,
    score: str = "msac",
    score_sigma_scale: float = 0.5,
    adaptive_sigma: bool = True,
    cheirality_gate: bool = True,
    cheirality_min_frac: float = 0.25,
    distance_thresh: float = 50.0,
) -> EssentialRansacResult:
    """RANSAC essential matrices of P pairs of (P, N, 2) normalized
    correspondences with (P, N) validity masks: Phases' draw, hypotheses,
    prescreen (two-phase scoring only), fullscore and refit, in that order.

    threshold: inlier threshold in normalized coordinates, a float or a
      (P,) tensor. Give either `generators` (one per pair) or `idx`
      (P, max_iters, S) sample indices, S = 5 with `use_five_point`, else 8.
    score: "msac" (truncated-residual loss, the default) or "count"
      (inlier counting; adaptive sigma does not apply).
    """
    phases = Phases(x1, x2, mask, threshold, max_iters, use_five_point, prescreen, finalists,
                    score, score_sigma_scale, adaptive_sigma, cheirality_gate,
                    cheirality_min_frac, distance_thresh)
    return phases.run(phases.draw(generators) if idx is None else idx)


def pixel_threshold_to_normalized(threshold_px: float, K: torch.Tensor):
    """cv::findEssentialMat's threshold mapping: thr / (0.5*(fx+fy))."""
    return threshold_px / (0.5 * (K[..., 0, 0] + K[..., 1, 1]))
