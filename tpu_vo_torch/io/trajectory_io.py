"""Trajectory persistence and checkpoint/resume (port of
tpu_vo/io/trajectory_io.py):
  - TUM-format text (timestamp tx ty tz qx qy qz qw) for evaluation tools,
  - KITTI-format text (12 numbers a row, T_wc[:3, :4]),
  - npz with full (R, t) arrays + per-frame diagnostics,
  - a checkpoint of the VO state (pose, previous-frame features, frame
    index and RANSAC seed) from which a run resumes exactly: the resumed
    frames draw the samples an uninterrupted run draws.
Readers return a Pose of float32 CPU tensors.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry import se3
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.io.kitti import load_kitti_poses
from tpu_vo_torch.pipeline.step import VOState


def _numpy(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def save_trajectory_tum(path: str, poses: Pose,
                        timestamps: Optional[np.ndarray] = None) -> None:
    R = _numpy(poses.R, np.float64)
    t = _numpy(poses.t, np.float64)
    n = len(t)
    ts = np.arange(n, dtype=np.float64) if timestamps is None else timestamps
    q = se3.rotation_to_quaternion(torch.from_numpy(R)).numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(n):
            f.write(
                f"{ts[i]:.6f} {t[i,0]:.9f} {t[i,1]:.9f} {t[i,2]:.9f} "
                f"{q[i,0]:.9f} {q[i,1]:.9f} {q[i,2]:.9f} {q[i,3]:.9f}\n"
            )


def load_trajectory_tum(path: str) -> Tuple[np.ndarray, Pose]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split()])
    arr = np.asarray(rows)
    R = se3.quaternion_to_rotation(torch.from_numpy(arr[:, 4:8]))
    return arr[:, 0], Pose(R.to(torch.float32), torch.from_numpy(arr[:, 1:4]).to(torch.float32))


def save_trajectory_kitti(path: str, poses: Pose) -> None:
    """KITTI odometry pose format: 12 numbers/row = T_wc[:3, :4] row-major,
    the convention of the ground-truth files (io/kitti.load_kitti_poses)."""
    R = _numpy(poses.R, np.float64)
    t = _numpy(poses.t, np.float64)
    T = np.concatenate([R, t[..., None]], axis=-1).reshape(len(t), 12)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for row in T:
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_trajectory_kitti(path: str) -> Pose:
    """Inverse of save_trajectory_kitti (also reads ground-truth files)."""
    R, t = load_kitti_poses(path)
    return Pose(torch.from_numpy(R).to(torch.float32), torch.from_numpy(t).to(torch.float32))


def save_trajectory_npz(path: str, poses: Pose, diagnostics=None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = {"R": _numpy(poses.R), "t": _numpy(poses.t)}
    if diagnostics:
        for k, v in diagnostics.items():
            data[f"diag_{k}"] = _numpy(v)
    np.savez_compressed(path, **data)


def save_checkpoint(path: str, state) -> None:
    """Persist a pipeline VOState (pose, previous features, counters, seed)."""
    if not isinstance(state, VOState):
        raise TypeError(f"save_checkpoint takes a VOState, got {type(state).__name__}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    feats = {k: _numpy(v) for k, v in state.prev._asdict().items()}
    np.savez_compressed(
        path, R=_numpy(state.pose.R), t=_numpy(state.pose.t),
        initialized=np.asarray(state.initialized), frame_idx=np.asarray(state.frame_idx),
        seed=np.asarray(state.seed), **feats)


def load_checkpoint(path: str, device=None):
    """The VOState of a checkpoint, its tensors on `device` (CPU if None)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        prev = ORBFeatures(*(torch.from_numpy(z[k]).to(device) for k in ORBFeatures._fields))
        return VOState(
            pose=Pose(torch.from_numpy(z["R"]).to(device), torch.from_numpy(z["t"]).to(device)),
            prev=prev,
            initialized=bool(z["initialized"]),
            frame_idx=int(z["frame_idx"]),
            seed=int(z["seed"]),
        )
