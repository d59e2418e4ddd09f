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
"""

from __future__ import annotations

import math
from typing import Dict

import torch

NAMES = ("features_diff", "desc_diff", "match_diff", "inlier_diff", "flags_diff",
         "rot_gap_deg", "dir_gap_deg", "traj_gap")


def _count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def _angle_deg(a: torch.Tensor, b: torch.Tensor, dims) -> torch.Tensor:
    """Angle between rotations (dims (-2, -1)) or unit vectors (dims -1),
    from the chord: |a - b| = 2 sqrt(2) sin(theta / 2) for rotations,
    2 sin(theta / 2) for unit vectors; exact near 0, where acos is not."""
    chord = torch.linalg.vector_norm(a - b, dim=dims)
    scale = 2.0 * math.sqrt(2.0) if isinstance(dims, tuple) else 2.0
    return torch.rad2deg(2.0 * torch.asin(torch.clamp(chord / scale, max=1.0)))


def compare(prog, ref) -> Dict[str, float]:
    """The numbers of NAMES for one call: prog and ref are (features,
    estimates, poses) as the program's stages returned them and as
    vobench.reference.pipeline.run returns them."""
    pf, pe, pp = prog
    rf, re, rp = ref
    kp = ((pf.valid != rf.valid)
          | (rf.valid & ((pf.xy != rf.xy).any(-1) | (pf.octave != rf.octave)
                         | (pf.response != rf.response))))
    desc = rf.valid & ~kp & ((pf.desc32 != rf.desc32).any(-1) | (pf.angle != rf.angle))
    match = (_count(pe["match_train_idx"] != re["match_train_idx"])
             + _count(pe["n_good"] != re["n_good"]))
    both = pe["have_rt"] & re["have_rt"]
    f64 = torch.float64
    rot = _angle_deg(pe["R"].to(f64), re["R"].to(f64), (-2, -1))
    tp, tr = pe["t"].to(f64), re["t"].to(f64)
    unit = lambda v: v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                                     min=1e-300)
    dirs = _angle_deg(unit(tp), unit(tr), -1)
    zero = torch.zeros((), dtype=f64, device=rot.device)
    pos_p = pp.t.to(f64).reshape(-1, pp.t.shape[-2], 3)
    pos_r = rp.t.to(f64).reshape(-1, rp.t.shape[-2], 3)
    path = torch.linalg.vector_norm(pos_r[:, 1:] - pos_r[:, :-1], dim=-1).sum(-1)
    gap = torch.linalg.vector_norm(pos_p - pos_r, dim=-1).amax(-1)
    return {
        "features_diff": _count(kp),
        "desc_diff": _count(desc),
        "match_diff": match,
        "inlier_diff": _count(pe["match_mask"] != re["match_mask"]),
        "flags_diff": _count(pe["have_rt"] != re["have_rt"]) + _count(pe["pose_ok"] != re["pose_ok"]),
        "rot_gap_deg": float(torch.where(both, rot, zero).amax()),
        "dir_gap_deg": float(torch.where(both, dirs, zero).amax()),
        "traj_gap": float((gap / torch.clamp(path, min=1e-12)).amax()),
    }


def worst(readings) -> Dict[str, float]:
    """The largest of each number over several calls' readings."""
    return {k: max(r[k] for r in readings) for k in NAMES}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit. A number without a limit, or a
    NaN, fails."""
    return all(k in limits and numbers[k] <= limits[k] for k in NAMES)
