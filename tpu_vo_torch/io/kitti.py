"""KITTI odometry dataset ingestion (a copy of tpu_vo/io/kitti.py, which
needs numpy only).

The reference consumes a flat directory of images and *guesses* intrinsics
from the image size (reference src/main.cpp:26-49,98-106;
visual_odometry.cpp:90-98). The north-star benchmark, however, is phrased
against a "1241x376 KITTI-style sequence" (BASELINE.json), and any real
deployment runs on the actual KITTI odometry layout:

    sequences/<NN>/
        image_0/ image_1/   rectified grayscale left/right, 000000.png ...
        image_2/ image_3/   rectified color left/right
        calib.txt           P0..P3 3x4 projection matrices (+ optional Tr)
        times.txt           one float timestamp (seconds) per frame
    poses/<NN>.txt          ground truth: 12 numbers/row = T_wc[:3, :4]

This module understands that layout natively: detection, calibration
parsing (true fx/fy/cx/cy from the chosen camera's projection matrix),
timestamps, and ground-truth pose loading for ATE evaluation. Monocular VO
uses one camera stream; the default is image_0 (grayscale left), matching
the gray pipeline input.

Everything here is host-side plain NumPy — calibration flows into the
pipeline only as the `VOConfig.intrinsics_override` tuple.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_vo_torch.io.dataset import list_image_paths

#: preference order for the monocular stream when --kitti-cam is not given
_CAM_PREFERENCE = (0, 2, 1, 3)


@dataclasses.dataclass(frozen=True)
class KittiSequence:
    """A resolved KITTI odometry sequence."""

    root: str                       # sequence directory
    camera: int                     # chosen camera index (0..3)
    image_dir: str                  # <root>/image_<camera>
    image_paths: Tuple[str, ...]    # sorted frame files
    intrinsics: Tuple[float, float, float, float]   # fx, fy, cx, cy
    times: Optional[np.ndarray]     # (N,) seconds, or None if absent
    gt_poses_path: Optional[str]    # poses/<NN>.txt if discoverable


def parse_calib(path: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI calib.txt into {name: (3, 4) float64} matrices.

    Lines look like ``P0: v00 v01 ... v23`` (12 floats). Unparseable or
    non-12-element lines (e.g. the raw-dataset's R/T entries) are kept as
    flat arrays so callers can inspect them; P0..P3 and Tr are reshaped.
    """
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            name, _, rest = line.partition(":")
            try:
                vals = np.array([float(v) for v in rest.split()],
                                dtype=np.float64)
            except ValueError:
                continue
            if vals.size == 12:
                vals = vals.reshape(3, 4)
            out[name.strip()] = vals
    return out


def intrinsics_from_projection(P: np.ndarray) -> Tuple[float, float, float,
                                                       float]:
    """(fx, fy, cx, cy) of a rectified KITTI projection matrix.

    KITTI's P_i = K_i [I | t_i] with a shared rectified K per camera pair;
    the left 3x3 block is upper-triangular so the intrinsics read off the
    diagonal and third column directly.
    """
    P = np.asarray(P, dtype=np.float64)
    if P.shape != (3, 4):
        raise ValueError(f"projection matrix must be (3, 4), got {P.shape}")
    return (float(P[0, 0]), float(P[1, 1]), float(P[0, 2]), float(P[1, 2]))


def load_times(path: str) -> np.ndarray:
    """times.txt: one float (seconds since sequence start) per line."""
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def load_kitti_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load KITTI ground-truth poses: (R (N,3,3), t (N,3)) camera->world.

    Each row is the first 3 rows of a 4x4 T_wc, row-major (12 floats) —
    the same camera->world convention the pipeline's Pose uses
    (geometry/se3.py; reference pose.h:26-78).
    """
    flat = np.loadtxt(path, dtype=np.float64)
    if flat.ndim == 1:
        flat = flat[None]
    if flat.shape[1] != 12:
        raise ValueError(
            f"KITTI pose file must have 12 columns, got {flat.shape[1]}")
    T = flat.reshape(-1, 3, 4)
    return np.ascontiguousarray(T[:, :, :3]), np.ascontiguousarray(T[:, :, 3])


def _find_gt_poses(seq_root: str) -> Optional[str]:
    """Locate poses/<NN>.txt for sequences/<NN> when the standard tree is
    present (dataset_root/sequences/NN + dataset_root/poses/NN.txt)."""
    seq_root = os.path.abspath(seq_root)
    seq_name = os.path.basename(seq_root)
    parent = os.path.dirname(seq_root)
    if os.path.basename(parent) != "sequences":
        return None
    cand = os.path.join(os.path.dirname(parent), "poses", seq_name + ".txt")
    return cand if os.path.isfile(cand) else None


def is_kitti_sequence(path: str) -> bool:
    """A directory is a KITTI sequence iff it has calib.txt and at least
    one image_<i> subdirectory."""
    if not os.path.isdir(path) or not os.path.isfile(
            os.path.join(path, "calib.txt")):
        return False
    return any(
        os.path.isdir(os.path.join(path, f"image_{i}")) for i in range(4))


def open_kitti_sequence(path: str,
                        camera: Optional[int] = None) -> KittiSequence:
    """Resolve a KITTI sequence directory into paths + calibration.

    camera=None picks the first available stream in preference order
    grayscale-left, color-left, grayscale-right, color-right.
    """
    calib = parse_calib(os.path.join(path, "calib.txt"))
    cams: List[int] = [camera] if camera is not None else list(_CAM_PREFERENCE)
    for cam in cams:
        image_dir = os.path.join(path, f"image_{cam}")
        if not os.path.isdir(image_dir):
            continue
        key = f"P{cam}"
        if key not in calib:
            raise ValueError(f"calib.txt has no {key} entry for {image_dir}")
        paths = tuple(list_image_paths(image_dir))
        times = None
        times_path = os.path.join(path, "times.txt")
        if os.path.isfile(times_path):
            times = load_times(times_path)
        return KittiSequence(
            root=os.path.abspath(path),
            camera=cam,
            image_dir=image_dir,
            image_paths=paths,
            intrinsics=intrinsics_from_projection(calib[key]),
            times=times,
            gt_poses_path=_find_gt_poses(path),
        )
    raise ValueError(
        f"{path}: no image_<camera> directory found "
        f"(looked for {['image_%d' % c for c in cams]})")
