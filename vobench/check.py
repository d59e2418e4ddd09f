"""What decides `correct`: the program's output of a call, each layer's,
against the reference's on the same frames and seeds, as numbers that
each have a limit of their own (vobench/limits/<workload>.json).

  features_diff  keypoint slots (over all frames) whose validity,
                 position, level or Harris response differ
  desc_diff      valid slots, equal in the above, whose descriptor or
                 angle differ
  match_diff     query slots whose matched train index, or pairs whose
                 count of good matches, differ
  inlier_diff    query slots whose RANSAC inlier flag differs
  flags_diff     pairs whose have_rt or pose_ok differ
  rot_gap_deg    widest angle between the two relative rotations of a
                 pair, over pairs that both give one
  dir_gap_deg    widest angle between the two translation directions
  traj_gap       widest distance between the two trajectories' positions,
                 over the reference's path length

A cell whose traffic taps a stage with the role `refine` (a stage after
stage 2 that refines every pair's relative motion; its output has the
refined R (P, 3, 3), t (P, 3) and the bool `improved` (P,), read by name,
R_rel and t_rel also taken) is judged on three numbers more:

  refine_rot_gap_deg  widest angle between the two refined relative
                      rotations, over pairs that both give one (have_rt)
  refine_dir_gap_deg  widest angle between the refined translation
                      directions, over the same pairs
  refine_flags_diff   pairs whose `improved` differs
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

NAMES = ("features_diff", "desc_diff", "match_diff", "inlier_diff", "flags_diff",
         "rot_gap_deg", "dir_gap_deg", "traj_gap")
REFINE_NAMES = ("refine_rot_gap_deg", "refine_dir_gap_deg", "refine_flags_diff")


def names(stages) -> tuple:
    """The numbers that judge a cell whose traffic taps `stages` (role to
    the entry's function)."""
    return NAMES + (REFINE_NAMES if "refine" in stages else ())


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def _angle_deg(a: torch.Tensor, b: torch.Tensor, dims) -> torch.Tensor:
    """Angle between rotations (dims (-2, -1)) or unit vectors (dims -1),
    from the chord: |a - b| = 2 sqrt(2) sin(theta / 2) for rotations,
    2 sin(theta / 2) for unit vectors; exact near 0, where acos is not."""
    chord = torch.linalg.vector_norm(a - b, dim=dims)
    scale = 2.0 * math.sqrt(2.0) if isinstance(dims, tuple) else 2.0
    return torch.rad2deg(2.0 * torch.asin(torch.clamp(chord / scale, max=1.0)))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-300)


def _gaps(Rp, Rr, tp, tr, both) -> Tuple[float, float]:
    """The widest rotation angle and translation-direction angle between
    two sets of relative motions, over the pairs `both`, in degrees."""
    f64 = torch.float64
    rot = _angle_deg(Rp.to(f64), Rr.to(f64), (-2, -1))
    dirs = _angle_deg(_unit(tp.to(f64)), _unit(tr.to(f64)), -1)
    zero = torch.zeros((), dtype=f64, device=rot.device)
    return (float(torch.where(both, rot, zero).amax()),
            float(torch.where(both, dirs, zero).amax()))


def _field(out, *names):
    """The first of `names` in a stage's output (a NamedTuple or a dict)."""
    got = out if isinstance(out, dict) else out._asdict()
    for n in names:
        if n in got:
            return got[n]
    raise KeyError(f"the refine stage's output has none of {names}")


def _refine(prog, ref, both) -> Dict[str, float]:
    """REFINE_NAMES of one call; NaN each where the reference gave no
    refinement."""
    if ref is None:
        return {k: float("nan") for k in REFINE_NAMES}
    rot, dirs = _gaps(_field(prog, "R", "R_rel"), _field(ref, "R", "R_rel"),
                      _field(prog, "t", "t_rel"), _field(ref, "t", "t_rel"), both)
    return {"refine_rot_gap_deg": rot, "refine_dir_gap_deg": dirs,
            "refine_flags_diff": _count(_field(prog, "improved") != _field(ref, "improved"))}


def compare(prog, ref) -> Dict[str, float]:
    """The numbers of one call: prog and ref are (features, estimates,
    poses), as the program's stages returned them and as the reference
    run returns them, each optionally with a fourth item, a dict of
    further stage outputs by role. NAMES always; REFINE_NAMES where the
    program's call tapped `refine`."""
    pf, pe, pp, *p_more = prog
    rf, re, rp, *r_more = ref
    kp = ((pf.valid != rf.valid)
          | (rf.valid & ((pf.xy != rf.xy).any(-1) | (pf.octave != rf.octave)
                         | (pf.response != rf.response))))
    desc = rf.valid & ~kp & ((pf.desc32 != rf.desc32).any(-1) | (pf.angle != rf.angle))
    match = (_count(pe["match_train_idx"] != re["match_train_idx"])
             + _count(pe["n_good"] != re["n_good"]))
    both = pe["have_rt"] & re["have_rt"]
    rot, dirs = _gaps(pe["R"], re["R"], pe["t"], re["t"], both)
    f64 = torch.float64
    pos_p = pp.t.to(f64).reshape(-1, pp.t.shape[-2], 3)
    pos_r = rp.t.to(f64).reshape(-1, rp.t.shape[-2], 3)
    path = torch.linalg.vector_norm(pos_r[:, 1:] - pos_r[:, :-1], dim=-1).sum(-1)
    gap = torch.linalg.vector_norm(pos_p - pos_r, dim=-1).amax(-1)
    out = {
        "features_diff": _count(kp),
        "desc_diff": _count(desc),
        "match_diff": match,
        "inlier_diff": _count(pe["match_mask"] != re["match_mask"]),
        "flags_diff": _count(pe["have_rt"] != re["have_rt"]) + _count(pe["pose_ok"] != re["pose_ok"]),
        "rot_gap_deg": rot,
        "dir_gap_deg": dirs,
        "traj_gap": float((gap / torch.clamp(path, min=1e-12)).amax()),
    }
    p_stages = p_more[0] if p_more else {}
    if "refine" in p_stages:
        out.update(_refine(p_stages["refine"], (r_more[0] if r_more else {}).get("refine"), both))
    return out


def worst(readings, names=NAMES) -> Dict[str, float]:
    """The largest of each number over several calls' readings; NaN where
    a reading lacks it or any reading is NaN."""
    out = {}
    for k in names:
        got = [r.get(k, float("nan")) for r in readings]
        out[k] = float("nan") if any(math.isnan(x) for x in got) else max(got)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float], names=NAMES) -> bool:
    """Every number of `names` at or under its limit. A number without a
    limit, or a NaN, fails."""
    return all(k in limits and numbers[k] <= limits[k] for k in names)
