"""OpenCV-Python re-implementation of the reference VO pipeline (the
port's own copy of tpu_vo/utils/cv_reference.py).

A behavioral port of the reference's VisualOdometry::process_frame
(visual_odometry.cpp:64-378): the golden trajectory that
`tools/reference_band` records in data/reference_trajectories.json and
the CPU tests hold the port against. cv2 is imported inside the
functions that need it, never at module import: the card's host has no
cv2, and nothing that runs there calls this module.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ReferenceVO:
    """Mirrors the reference class: same ORB/matcher config, gates, scale.

    `ransac_state`: OpenCV 5's classic findEssentialMat(RANSAC) path is
    fully deterministic (its USAC core uses a fixed internal RNG state;
    cv2.setRNGSeed has no effect — measured). To quantify the reference
    estimator's own sampling scatter (the "self-ATE band",
    tools/reference_band.ref_with_band), pass an int here: the
    essential matrix is then estimated through the UsacParams overload
    with the same confidence/threshold but a caller-chosen
    randomGeneratorState. None (default) = the exact reference call
    (visual_odometry.cpp:213-216).
    """

    def __init__(self, image_width: int, image_height: int,
                 ransac_state: Optional[int] = None):
        import cv2

        self.ransac_state = ransac_state
        # cv::ORB::create args, visual_odometry.cpp:65-85
        self.orb = cv2.ORB_create(
            nfeatures=1200, scaleFactor=1.2, nlevels=8, edgeThreshold=31,
            firstLevel=0, WTA_K=2, scoreType=cv2.ORB_HARRIS_SCORE,
            patchSize=31, fastThreshold=10,
        )
        self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        fx = float(image_width)
        self.K = np.array([[fx, 0, image_width / 2.0],
                           [0, fx, image_height / 2.0],
                           [0, 0, 1.0]])
        self.R_wc = np.eye(3)
        self.t_wc = np.zeros(3)
        self.prev: Optional[Tuple[list, np.ndarray]] = None
        self.trajectory: List[Tuple[np.ndarray, np.ndarray]] = []
        self.last_F: Optional[np.ndarray] = None

    def _good_matches(self, desc1, desc2):
        # visual_odometry.cpp:145-180
        if desc1 is None or desc2 is None or len(desc1) == 0 or len(desc2) == 0:
            return []
        matches = self.matcher.match(desc1, desc2)
        if not matches:
            return []
        dists = sorted(m.distance for m in matches)
        min_d = dists[0]
        med = dists[len(dists) // 2]
        thr = min(max(3.0 * min_d, 0.7 * med), 35.0)
        return [m for m in matches if m.distance < thr]

    def _estimate_relative_pose(self, kps1, kps2, matches):
        # visual_odometry.cpp:182-281
        import cv2

        if len(matches) < 8:
            return False, None, None
        p1 = np.float32([kps1[m.queryIdx].pt for m in matches])
        p2 = np.float32([kps2[m.trainIdx].pt for m in matches])
        if self.ransac_state is None:
            E, mask = cv2.findEssentialMat(p1, p2, self.K,
                                           cv2.RANSAC, 0.999, 2.0)
        else:
            up = cv2.UsacParams()
            up.confidence = 0.999
            up.threshold = 2.0
            up.maxIterations = 1000
            up.randomGeneratorState = int(self.ransac_state)
            dc = np.zeros((1, 5))
            E, mask = cv2.findEssentialMat(p1, p2, self.K, self.K,
                                           dc, dc, up)
        if E is None or E.shape != (3, 3):
            return False, None, None
        Kinv = np.linalg.inv(self.K)
        self.last_F = Kinv.T @ E @ Kinv
        inlier_count = int(mask.sum()) if mask is not None else 0
        n_valid, R, t, _ = cv2.recoverPose(E, p1, p2, self.K, mask=mask)
        if n_valid < 10 or inlier_count < 12:
            return False, R, t
        return True, R, t

    def process_frame(self, image: np.ndarray):
        # visual_odometry.cpp:323-378
        import cv2

        if image.ndim == 3:
            gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        else:
            gray = image
        kps, desc = self.orb.detectAndCompute(gray, None)

        if self.prev is None:
            self.trajectory.append((self.R_wc.copy(), self.t_wc.copy()))
            self.prev = (kps, desc)
            return

        prev_kps, prev_desc = self.prev
        matches = self._good_matches(prev_desc, desc)
        if len(matches) >= 10:
            pose_ok, R, t = self._estimate_relative_pose(prev_kps, kps, matches)
            if R is not None and t is not None:
                scale = 0.3 if pose_ok else 0.0
                t = t.ravel()
                # invert_relative_camera_to_camera_transform (:292-301)
                R_inv = R.T
                t_inv = -R.T @ t
                # compose (:303-314)
                self.t_wc = self.t_wc + scale * (self.R_wc @ t_inv)
                self.R_wc = self.R_wc @ R_inv
        self.trajectory.append((self.R_wc.copy(), self.t_wc.copy()))
        self.prev = (kps, desc)

    def run(self, frames) -> np.ndarray:
        """Process a list of frames; returns (T, 3) camera centers."""
        for f in frames:
            self.process_frame(f)
        return np.array([t for _, t in self.trajectory])

    def rotations(self) -> np.ndarray:
        """(T, 3, 3) world-from-camera rotations of the processed
        trajectory (for RPE evaluation alongside the centers)."""
        return np.array([R for R, _ in self.trajectory])


def absolute_trajectory_error(traj_a: np.ndarray, traj_b: np.ndarray) -> float:
    """RMS ATE between two (T, 3) center trajectories (no alignment —
    both start at identity with the same fixed scale convention)."""
    assert traj_a.shape == traj_b.shape
    return float(np.sqrt(np.mean(np.sum((traj_a - traj_b) ** 2, axis=1))))


def relative_pose_error(rots_a, rots_b) -> float:
    """Mean geodesic rotation error (degrees) between pose lists."""
    errs = []
    for Ra, Rb in zip(rots_a, rots_b):
        cosang = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
        errs.append(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
    return float(np.mean(errs))
