"""The accuracy diagnostics' shared parts (tools harris_candidate_probe ...
extract_orb_pattern; their harness is tools/profile_rows).

- Scenes are rendered once per process (`scene`, `degraded`); a caller
  that rendered them elsewhere (chip_smoke.py's process pool) hands them
  over with `prefill`.
- A committed leg of data/reference_trajectories.json is used only on the
  frames it was made from: `leg_frames` renders the leg's scene, degrades
  it as the leg says, and raises unless the frames' sha256 is the leg's.
- `reference` gives the OpenCV reference's trajectory of a scene: from
  its committed leg (`reference="committed"`, the default: the card's
  host has no cv2), or recomputed by utils/cv_reference.ReferenceVO
  (`reference="cv2"`, where cv2 imports).
- Errors against ground truth: `ate_vs_gt_rel` (a trajectory's), and per
  pair `gt_relative`, `rot_err_deg`, `dir_err_deg`, `pair_motion`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_vo_torch.tools import reference_band
from tpu_vo_torch.utils import synthetic
from tpu_vo_torch.utils.metrics import ate_rmse, extent, scale_matched_gt

REFERENCES = ("committed", "cv2")
NEEDS_CV2 = "needs cv2: run with --device cpu where cv2 is installed"

# (scene, T, W, H, seed) -> synthetic.render's tuple; leg name -> frames
RENDERED: Dict[tuple, tuple] = {}
DEGRADED: Dict[str, list] = {}
CHECKED: List[str] = []  # the legs whose frames leg_frames hashed, in order


def prefill(renders: Optional[dict] = None, degraded: Optional[dict] = None) -> None:
    """Hand over scenes rendered elsewhere: {spec: render's tuple} and
    {leg name: degraded frames}."""
    RENDERED.update(renders or {})
    DEGRADED.update(degraded or {})


def scene(kind: str, T: int, W: int, H: int, seed: int = 0) -> tuple:
    """synthetic.render(kind, T, W, H, seed), rendered once per process."""
    key = (kind, T, W, H, seed)
    if key not in RENDERED:
        RENDERED[key] = synthetic.render(*key)
    return RENDERED[key]


def degraded(name: str) -> list:
    """The frames of leg `name` (its scene, degraded as the leg is), made
    once per process; not checked against the leg (see leg_frames)."""
    if name not in DEGRADED:
        DEGRADED[name] = reference_band.leg_frames(name, scene(*reference_band.LEGS[name])[0])
    return DEGRADED[name]


def leg_for(spec: tuple, label: Optional[str] = None) -> Optional[str]:
    """The name of the committed leg of scene spec (scene, T, W, H, seed),
    clean (label None) or degraded as `label` names (a config 6 level or
    only_<nuisance>), else None."""
    want = (None, "clean") if label is None else (label,)
    for name, s in reference_band.LEGS.items():
        if s == tuple(spec) and reference_band.degradation(name)[0] in want:
            return name
    return None


def leg_frames(name: str) -> Tuple[list, dict]:
    """(frames, record) of committed leg `name`: the frames rendered here,
    whose sha256 must be the record's (else AssertionError: no
    approximate reference is used)."""
    rec = reference_band.load()[name]
    frames = degraded(name)
    sha = synthetic.frames_sha256(frames)
    if sha != rec["frames_sha256"]:
        raise AssertionError(f"leg {name}: the frames rendered here hash to {sha}, the "
                             f"committed reference's to {rec['frames_sha256']}")
    CHECKED.append(name)
    return frames, rec


def check_reference(how: str) -> str:
    if how not in REFERENCES:
        raise ValueError(f"reference must be one of {REFERENCES}, got {how!r}")
    return how


def reference(how: str, name: Optional[str], frames, W: int, H: int, band_seeds: int = 0):
    """(t (T, 3), R (T, 3, 3), band or None) of the reference on `frames`:
    committed leg `name` (its frames checked by leg_frames; its band of
    reference_band.SEEDS seeds) or ReferenceVO(W, H) run here (with
    band_seeds, reference_band.ref_with_band's band of that many seeds)."""
    check_reference(how)
    if how == "committed":
        if name is None:
            raise ValueError(f"no committed leg holds this scene ({W}x{H}, {len(frames)} frames); "
                             f"use reference='cv2' where cv2 is installed")
        _, rec = leg_frames(name)
        t, R = reference_band.leg_arrays(rec)
        return t, R, rec["band"]
    if band_seeds:
        t, R, b, _, _ = reference_band.ref_with_band(W, H, frames, k=band_seeds)
        return t, R, b
    from tpu_vo_torch.utils.cv_reference import ReferenceVO

    ref = ReferenceVO(W, H)
    t = ref.run(frames)
    return t, ref.rotations(), None


def cv2_available() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def ate_vs_gt_rel(t: np.ndarray, ts) -> float:
    """ATE of camera centres t against the ground truth's centres ts
    (scale-matched, utils/metrics.scale_matched_gt) over the truth's
    extent: utils/metrics.trajectory_report's ate_vs_gt_rel, unrounded."""
    gts = scale_matched_gt(np.stack(ts))
    return ate_rmse(np.asarray(t, np.float64), gts) / extent(gts)


def pair_chunk(T: int) -> int:
    """The JAX tools' pair chunk: the first of 9, 7, 11, 13 that divides
    the T - 1 pairs, else all of them."""
    return next(c for c in (9, 7, 11, 13, T - 1) if (T - 1) % c == 0 or c == T - 1)


def gt_relative(Rs, ts, i: int):
    """(R, t) of the ground-truth motion c_i <- c_{i-1}."""
    return Rs[i].T @ Rs[i - 1], Rs[i].T @ (ts[i - 1] - ts[i])


def rot_err_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Geodesic angle (deg) between two rotations."""
    c = (np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def dir_err_deg(ta: np.ndarray, tb: np.ndarray) -> float:
    """Angle (deg) between two translation directions, sign-agnostic."""
    ta = np.asarray(ta, np.float64).ravel()
    tb = np.asarray(tb, np.float64).ravel()
    ta = ta / (np.linalg.norm(ta) + 1e-12)
    tb = tb / (np.linalg.norm(tb) + 1e-12)
    return float(np.degrees(np.arccos(np.clip(abs(float(ta @ tb)), -1, 1))))


def pair_motion(t: np.ndarray, R: np.ndarray, i: int):
    """(R, t or None) of the motion c_i <- c_{i-1} that a trajectory of
    camera centres t and world-from-camera rotations R holds (as
    ReferenceVO composes it); t is None where the centre did not move
    (the reference held its position: no pose)."""
    R_rel = R[i].T @ R[i - 1]
    d = t[i] - t[i - 1]
    if not np.linalg.norm(d) > 0:
        return R_rel, None
    return R_rel, -R[i].T @ d
