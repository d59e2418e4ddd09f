"""Trajectory accuracy metrics shared by benchmarks and e2e tests (a copy
of tpu_vo/utils/metrics.py, which needs numpy only).

The reference publishes no metrics (SURVEY.md §6); these implement the
BASELINE.md accuracy targets: RMS ATE against the OpenCV reference
trajectory and against ground truth (with the monocular fixed-scale-0.3
convention of visual_odometry.cpp:352 matched to GT by mean step length).
"""

from __future__ import annotations

import numpy as np


def ate_rmse(traj_a: np.ndarray, traj_b: np.ndarray) -> float:
    """RMS absolute trajectory error between (T, 3) center trajectories."""
    traj_a = np.asarray(traj_a, np.float64)
    traj_b = np.asarray(traj_b, np.float64)
    assert traj_a.shape == traj_b.shape
    return float(np.sqrt(np.mean(np.sum((traj_a - traj_b) ** 2, axis=1))))


def extent(traj: np.ndarray) -> float:
    """Diagonal of the trajectory's axis-aligned bounding box."""
    traj = np.asarray(traj, np.float64)
    return float(np.linalg.norm(traj.max(axis=0) - traj.min(axis=0))) or 1.0


def scale_matched_gt(gt_t: np.ndarray, per_step: float = 0.3) -> np.ndarray:
    """Rescale a ground-truth (T, 3) center trajectory to the pipeline's
    fixed per-step displacement convention (scale 0.3 per accepted frame,
    visual_odometry.cpp:352-353) so ATE against estimated trajectories is
    meaningful despite the unobservable monocular scale."""
    gt_t = np.asarray(gt_t, np.float64)
    steps = np.linalg.norm(np.diff(gt_t, axis=0), axis=1)
    mean_step = float(steps.mean()) or 1.0
    return gt_t * (per_step / mean_step)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Similarity transform (s, R, t) minimizing ||dst - (s R src + t)||²."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse_aligned(traj_a: np.ndarray, traj_b: np.ndarray,
                     with_scale: bool = True) -> float:
    """RMS ATE after Umeyama similarity alignment of a onto b — the
    standard monocular-VO evaluation protocol (scale is unobservable)."""
    s, R, t = umeyama_alignment(traj_a, traj_b, with_scale)
    aligned = (s * (R @ np.asarray(traj_a, np.float64).T)).T + t
    return ate_rmse(aligned, traj_b)


def rpe(est_t: np.ndarray, ref_t: np.ndarray,
        est_R: np.ndarray | None = None,
        ref_R: np.ndarray | None = None) -> dict:
    """Relative pose error over consecutive frames (KITTI-style, delta=1).

    Translation: RMS of ||Δt_est − Δt_ref|| per step, also normalized by
    the ref trajectory's mean step length ("drift fraction per frame").
    Rotation (when both rotation stacks are given): geodesic angle of
    (ΔR_est)ᵀ(ΔR_ref) per step, mean and RMS in degrees. Per-step deltas
    are expressed in each trajectory's own previous-frame body frame, so
    a shared global rotation offset does not count as error.
    """
    est_t = np.asarray(est_t, np.float64)
    ref_t = np.asarray(ref_t, np.float64)
    n = min(len(est_t), len(ref_t))
    out: dict = {}
    if n < 2:
        return out
    if est_R is not None and ref_R is not None:
        eR = np.asarray(est_R, np.float64)[:n]
        rR = np.asarray(ref_R, np.float64)[:n]
        d_est = eR[:-1].transpose(0, 2, 1) @ (est_t[1:n] - est_t[:n - 1])[..., None]
        d_ref = rR[:-1].transpose(0, 2, 1) @ (ref_t[1:n] - ref_t[:n - 1])[..., None]
        d_est, d_ref = d_est[..., 0], d_ref[..., 0]
        dR = (eR[:-1].transpose(0, 2, 1) @ eR[1:]).transpose(0, 2, 1) @ (
            rR[:-1].transpose(0, 2, 1) @ rR[1:])
        cos = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0, -1, 1)
        ang = np.degrees(np.arccos(cos))
        out["rpe_rot_mean_deg"] = round(float(ang.mean()), 4)
        out["rpe_rot_rmse_deg"] = round(float(np.sqrt((ang ** 2).mean())), 4)
    else:
        d_est = est_t[1:n] - est_t[:n - 1]
        d_ref = ref_t[1:n] - ref_t[:n - 1]
    err = np.linalg.norm(d_est - d_ref, axis=1)
    step = float(np.linalg.norm(d_ref, axis=1).mean()) or 1.0
    out["rpe_trans_rmse"] = round(float(np.sqrt((err ** 2).mean())), 4)
    out["rpe_trans_rel_step"] = round(
        float(np.sqrt((err ** 2).mean())) / step, 4)
    return out


def trajectory_report(our_traj: np.ndarray,
                      ref_traj: np.ndarray | None = None,
                      gt_t: np.ndarray | None = None,
                      our_R: np.ndarray | None = None,
                      ref_R: np.ndarray | None = None,
                      gt_R: np.ndarray | None = None) -> dict:
    """Round-tripped accuracy dict for benchmark results.

    Reports raw (both-start-at-identity, shared fixed scale) and
    Umeyama-aligned ATE vs the OpenCV reference trajectory and vs ground
    truth, each also relative to trajectory extent; plus per-frame RPE
    (translation drift and rotation degrees, utils/metrics.rpe) vs each
    comparator when rotations are supplied (BASELINE.json names "ATE/RPE
    parity" as the metric — both halves are reported here).
    """
    out: dict = {}
    if ref_traj is not None:
        ext = extent(ref_traj)
        ate = ate_rmse(our_traj, ref_traj)
        out["ate_vs_reference"] = round(ate, 4)
        out["ate_rel_extent"] = round(ate / ext, 4)
        out["ate_vs_reference_aligned_rel"] = round(
            ate_rmse_aligned(our_traj, ref_traj) / ext, 4)
        for k, v in rpe(our_traj, ref_traj, our_R, ref_R).items():
            out[k + "_vs_reference"] = v
    if gt_t is not None:
        gts = scale_matched_gt(gt_t)
        ext = extent(gts)
        out["ate_vs_gt"] = round(ate_rmse(our_traj, gts), 4)
        out["ate_vs_gt_rel"] = round(ate_rmse(our_traj, gts) / ext, 4)
        for k, v in rpe(our_traj, gts, our_R, gt_R).items():
            out[k + "_vs_gt"] = v
        if ref_traj is not None:
            out["ref_ate_vs_gt_rel"] = round(
                ate_rmse(ref_traj, gts) / ext, 4)
            for k, v in rpe(ref_traj, gts, ref_R, gt_R).items():
                out["ref_" + k + "_vs_gt"] = v
    return out


def load_trajectory_any(path: str):
    """Load a trajectory file in KITTI (12-column T_wc[:3,:4]) or TUM
    (8-column timestamp+translation+quaternion) format, auto-detected by
    column count. Returns (R (N,3,3) or None, t (N,3))."""
    ncols = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                ncols = len(line.split())
                break
    if ncols == 12:
        from tpu_vo_torch.io.kitti import load_kitti_poses

        return load_kitti_poses(path)
    if ncols == 8:
        from tpu_vo_torch.io.trajectory_io import load_trajectory_tum

        _, pose = load_trajectory_tum(path)
        return np.asarray(pose.R, np.float64), np.asarray(pose.t, np.float64)
    raise ValueError(
        f"{path}: unrecognized trajectory format ({ncols} columns; "
        "expected 12 = KITTI or 8 = TUM)")


def evaluate_against_file(traj, gt_path: str, align: str = "scale") -> dict:
    """ATE + RPE of an estimated Pose trajectory against a GT file
    (KITTI or TUM).

    Umeyama-aligns the estimate onto GT (align='scale' fits similarity,
    'rigid' fits SE3, 'none' compares raw) and reports RMS ATE absolute,
    relative to the GT extent, and the frame count compared; plus
    per-frame RPE (translation drift, scale-matched to the estimate's
    fixed-0.3-step convention, and rotation degrees when the GT format
    carries rotations — utils/metrics.rpe).
    """
    gt_R, gt_t = load_trajectory_any(gt_path)
    est_t = np.asarray(traj.t, np.float64)
    est_R = (np.asarray(traj.R, np.float64)
             if getattr(traj, "R", None) is not None else None)
    n = min(len(est_t), len(gt_t))
    est_t_al, gt_t = est_t[:n], gt_t[:n]
    if align in ("scale", "rigid") and n >= 3:
        s, R, t = umeyama_alignment(est_t_al, gt_t, align == "scale")
        est_t_al = (s * (R @ est_t_al.T)).T + t
    ate = ate_rmse(est_t_al, gt_t)
    out = {
        "ate_rmse": round(ate, 6),
        "ate_rel_extent": round(ate / extent(gt_t), 6),
        "frames": n,
        "align": align,
    }
    # RPE compares per-step motions in matching units: rescale GT to the
    # estimator's fixed per-step displacement (monocular scale-free).
    gts = scale_matched_gt(gt_t)
    out.update(rpe(est_t[:n], gts,
                   None if est_R is None else est_R[:n],
                   None if gt_R is None else np.asarray(gt_R)[:n]))
    return out
