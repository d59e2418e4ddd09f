"""find_essential_ransac split by phase (port of tools/profile_ransac.py).

On bench.py's configuration (T=64 frames of make_sequence(64, 1241, 376,
seed=0), 1200 keypoints, features at frame_chunk 8, matches normalized
as estimate_pair does) at the runner's pair tiling (pc pairs a call over
the 63 pairs), `hyps` hypotheses a pair (the JAX tool's ITERS), it times:

  poly(no-DK)  the sample draw and the AoS 5-point helpers up to the
               degree-10 polynomial (estimation/five_point `_nullspace_basis`
               ... `_det_poly`), as the JAX tool isolates them
  dk_roots     the AoS Durand-Kerner roots (`dk` iterations) and Newton
  draw+5pt     ransac.Phases.draw and .hypotheses (draw_samples and the
               SoA solver the main path runs)
  prescreen    ransac.Phases.prescreen (prescreen_finalists): subset
               scoring, adaptive sigma, the top-k finalists and their
               cheirality gate
  fullscore    ransac.Phases.fullscore (score_finalists): the finalists
               on the full set
  refit        ransac.Phases.refit (lo_refit): the 8-point refit and its
               rescore
  full ransac  find_essential_ransac

Rows as tools/profile_rows says (torch.profiler's figures on every row).
The row "composed_equal" says whether the phases called one by one as
the rows time them (`stepwise`) give find_essential_ransac(idx=idx)'s
result bit for bit on this device: it guards the tool's wiring; the
order of the phases and the scoring policy live in ransac.Phases alone.
On the card, the row "syncs" lists each runtime call that made the host
wait in one run of the phases and recover_pose (estimate_pair's RANSAC
and pose recovery), with the phase and the aten op it sat in and its
host wait in ms, from torch.profiler; a row "sync <phase> <op> <k>" a
site (the k-th such call of each chunk) sums its host waits.

    python -m tpu_vo_torch.tools.profile_ransac [--pc 9 --hyps 256 --dk 100 --reps 16]
"""

from __future__ import annotations

import sys

import torch

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.estimation import five_point as F5
from tpu_vo_torch.estimation import ransac as R
from tpu_vo_torch.estimation.recover_pose import recover_pose_from_essential
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import _intrinsics, pair_generators
from tpu_vo_torch.tools import profile_rows
from tpu_vo_torch.tools.profile_pairs import match_stage, prep_stage, ransac_options
from tpu_vo_torch.utils.profiling import SYNC_CALLS

DEFAULTS = dict(T=64, width=1241, height=376, features=1200, fc=8, pc=9, hyps=256, dk=100,
                reps=16, iters=5)
PHASES = ("draw", "hypotheses", "prescreen", "fullscore", "refit", "recover_pose")


def phases_of(x1n, x2n, mask, thr, rcfg: RansacConfig) -> R.Phases:
    """find_essential_ransac's phases for one chunk of pairs, with the
    arguments estimate_pair passes from `rcfg`."""
    return R.Phases(x1n, x2n, mask, thr, **ransac_options(rcfg))


def stepwise(c: R.Phases, idx: torch.Tensor) -> R.EssentialRansacResult:
    """The phases called one by one on samples idx, as the rows time
    them."""
    Es, vm, n_hyp = c.hypotheses(idx)
    Es, vm, gate, sq = c.prescreen(Es, vm)
    winner, sq = c.fullscore(Es, vm, gate, sq)
    return c.refit(winner, sq, n_hyp)


def aos_poly(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """The AoS helpers from (..., 5, 2) samples to (..., 11) polynomials."""
    A = F5._constraint_matrix(F5._nullspace_basis(s1, s2))
    A = A / torch.clamp(torch.abs(A).amax(-1, keepdim=True), min=1e-30)
    return F5._det_poly(F5._action_polynomials(F5._gauss_jordan(A)[..., 10:]))


def aos_roots(polys: torch.Tensor, dk: int):
    roots, ok = F5._poly_roots(polys, iters=dk)
    return F5._newton_real(polys, roots.real), ok


def sync_waits(chunks, gens, distance_thresh: float) -> list:
    """Each runtime call that waits for the card in one run of the phases
    and recover_pose over the chunks: [{"phase", "op", "call",
    "host_wait_ms"}] in order, from torch.profiler's host events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c, g in zip(chunks, gens):
            with record_function("draw"):
                idx = c.draw(g)
            res = c.run(idx)  # its phases open the spans ransac.<phase>
            with record_function("recover_pose"):
                recover_pose_from_essential(res.E, c.x1, c.x2, res.inliers, distance_thresh)
    torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cpu]
    phase_of = {**{p: p for p in PHASES}, **{f"ransac.{p}": p for p in PHASES}}
    marks = [(phase_of[e[0]], *e[1:]) for e in host if e[0] in phase_of]
    ops = [e for e in host if e[0].startswith("aten::")]

    def within(outer, e):
        return outer[3] == e[3] and outer[1] <= e[1] and e[2] <= outer[2]

    out = []
    for e in sorted((e for e in host if e[0] in SYNC_CALLS), key=lambda e: e[1]):
        phase = next((m[0] for m in marks if within(m, e)), "outside the phases")
        outer = [o for o in ops if within(o, e)]
        op = min(outer, key=lambda o: o[1])[0] if outer else "none"
        out.append({"phase": phase, "op": op, "call": e[0], "host_wait_ms": (e[2] - e[1]) / 1e6})
    return out


def sync_sites(waits: list, n_chunks: int) -> dict:
    """{row name: figures} a sync site: sync_waits' calls grouped by
    phase and op, the k-th of a site's calls in each chunk being site k
    (each chunk makes the same syncs in the same order)."""
    groups = {}
    for w in waits:
        groups.setdefault((w["phase"], w["op"].replace("aten::", "")), []).append(
            w["host_wait_ms"])
    out = {}
    for (phase, op), ms in groups.items():
        per = max(1, len(ms) // n_chunks)
        for k in range(per):
            site = ms[k::per]
            out[f"sync {phase} {op} {k + 1}"] = {"calls": len(site), "host_wait_ms": sum(site),
                                                 "max_ms": max(site)}
    return out


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_ransac", o)
    T = o.T
    cfg = VOConfig(image_width=o.width, image_height=o.height,
                   orb=ORBConfig(n_features=o.features), ransac=RansacConfig(max_iters=o.hyps))
    frames = torch.from_numpy(profile_rows.sequence(T, o.width, o.height).copy()).to(o.device)
    n1 = profile_rows.frame_launches(T, o.fc)
    feats = rows.run(lambda: runner.detect_frames(frames, cfg, o.fc), (n1, n1))
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    K = _intrinsics(cfg.intrinsics, prev.xy.device, prev.xy.dtype)
    thr = R.pixel_threshold_to_normalized(cfg.ransac.threshold_px, K)
    spans = runner._spans(T - 1, o.pc)
    chunks = []
    for a, e in spans:
        p, c = ORBFeatures(*(f[a:e] for f in prev)), ORBFeatures(*(f[a:e] for f in cur))
        _, _, x1n, x2n, mask = prep_stage(p, c, match_stage(p, c, cfg)[0], K)
        chunks.append(phases_of(x1n, x2n, mask, thr, cfg.ransac))

    def gens():
        g = pair_generators(0, range(1, T))
        return [g[a:e] for a, e in spans]

    def poly_fn():
        out = []
        for c, g in zip(chunks, gens()):
            idx = c.draw(g)
            out.append(aos_poly(R._take(c.x1, idx), R._take(c.x2, idx)))
        return out

    polys = rows.run(poly_fn)

    def dk_fn():
        return [aos_roots(p, o.dk) for p in polys]

    def draw5pt_fn():
        return [c.hypotheses(c.draw(g)) for c, g in zip(chunks, gens())]

    hyps = rows.run(draw5pt_fn)

    def prescreen_fn():
        return [c.prescreen(Es, vm) for c, (Es, vm, _) in zip(chunks, hyps)]

    fin = rows.run(prescreen_fn)

    def fullscore_fn():
        return [c.fullscore(Es, vm, gate, sq) for c, (Es, vm, gate, sq) in zip(chunks, fin)]

    won = rows.run(fullscore_fn)

    def refit_fn():
        return [c.refit(w, sq, n_hyp) for c, (w, sq), (_, _, n_hyp) in zip(chunks, won, hyps)]

    def full_fn():
        return [R.find_essential_ransac(c.x1, c.x2, c.mask, thr, generators=g,
                                        **ransac_options(cfg.ransac))
                for c, g in zip(chunks, gens())]

    t = dict(reps=o.reps, iters=o.iters, profile=True, per=("pair", T - 1))
    rows.add("tiling", {"pairs": T - 1, "pc": o.pc, "calls": len(spans), "hyps": o.hyps,
                        "dk_iters": o.dk, "correspondences": chunks[0].mask.shape[1],
                        "two_phase": chunks[0].two_phase})
    rows.time("poly(no-DK)", poly_fn, **t)
    rows.time("dk_roots", dk_fn, **t)
    rows.time("draw+5pt", draw5pt_fn, **t)
    if chunks[0].two_phase:
        rows.time("prescreen", prescreen_fn, **t)
    else:
        rows.add("prescreen", "not run: the correspondences are no more than the prescreen "
                              "subset, so every hypothesis is scored on the full set")
    rows.time("fullscore", fullscore_fn, **t)
    rows.time("refit", refit_fn, **t)
    rows.time("full ransac", full_fn, **t)
    idxs = [c.draw(g) for c, g in zip(chunks, gens())]
    rows.add("composed_equal", all(
        all(torch.equal(x, y) for x, y in zip(stepwise(c, i), R.find_essential_ransac(
            c.x1, c.x2, c.mask, thr, idx=i, **ransac_options(cfg.ransac))))
        for c, i in zip(chunks, idxs)))
    if rows.on_card:
        waits = sync_waits(chunks, gens(), cfg.ransac.distance_thresh)
        rows.add("syncs", {"count": len(waits), "calls": waits,
                           "host_wait_ms": sum(w["host_wait_ms"] for w in waits)})
        for name, value in sync_sites(waits, len(chunks)).items():
            rows.add(name, value)
    else:
        rows.add("syncs", profile_rows.NOT_ON_CARD)
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
