"""Object-style API mirroring the reference's public surface (port of
tpu_vo/api.py):

    Frame(id, image) with .keypoints/.descriptors/.pose/.timestamp
    VisualOdometry(width, height).process_frame(frame)
    .get_trajectory() / .get_trajectory_poses() / .has_last_F() / .last_F()

State lives in the wrapper, compute in the functional `vo_step`, on the
card unless the caller passes device="cpu". The keypoint overlay
(`render_overlay=True`) and `TrajectoryViewer` need `viz/`, which is not
ported yet: the overlay raises NotImplementedError.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.image.color import bgr_to_gray
from tpu_vo_torch.io.trajectory_io import load_checkpoint, save_checkpoint
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.pipeline.step import VOState, initial_state, vo_step
from tpu_vo_torch.utils.records import step_record


@dataclass
class Frame:
    """One time-step: image + features + pose estimate (frame.h:19-58)."""

    id: int = -1
    image: Optional[np.ndarray] = None
    timestamp: float = 0.0
    processed: bool = False
    keypoints: Optional[np.ndarray] = None    # (N, 2) xy, valid rows only
    descriptors: Optional[np.ndarray] = None  # (N, 32) uint8
    pose: Pose = field(default_factory=lambda: Pose.identity())

    @classmethod
    def from_image(cls, frame_id: int, image: np.ndarray,
                   timestamp: float = 0.0) -> "Frame":
        return cls(id=frame_id, image=np.asarray(image), timestamp=timestamp)


class VisualOdometry:
    """Stateful facade over vo_step (visual_odometry.h:31-66)."""

    def __init__(self, image_width: int, image_height: int,
                 config: Optional[VOConfig] = None, seed: int = 0, device=None):
        self.config = config or VOConfig(image_width=image_width,
                                         image_height=image_height)
        if (self.config.image_width, self.config.image_height) != (image_width, image_height):
            raise ValueError(f"config is for {self.config.image_width}x"
                             f"{self.config.image_height}, not {image_width}x{image_height}")
        self.device = entry_device(device)
        self._state: VOState = initial_state(self.config, seed, self.device)
        self._lock = threading.Lock()
        self._trajectory: List[Pose] = []
        self._records: List[dict] = []
        self._last_F: Optional[np.ndarray] = None

    @property
    def camera_matrix(self) -> np.ndarray:
        fx, fy, cx, cy = self.config.intrinsics
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])

    def process_frame(self, frame: Frame, render_overlay: bool = False) -> None:
        """Run one frame; updates frame.pose and the trajectory, with the
        reference's failure ladder (visual_odometry.cpp:323-378). The
        reference also returned a keypoint overlay (and tpu_vo fills
        frame.keypoints and .descriptors with it): render_overlay=True
        raises NotImplementedError, the overlay (viz/overlay.py) is not
        ported."""
        if render_overlay:
            raise NotImplementedError("the keypoint overlay (viz/overlay.py) is not ported yet")
        if frame.image is None:
            raise ValueError("frame has no image")
        img = torch.as_tensor(np.asarray(frame.image)).to(self.device)
        if img.dim() == 3:
            img = bgr_to_gray(img)
        self._state, out = vo_step(self._state, img, self.config)

        pose = Pose(out.pose.R.cpu(), out.pose.t.cpu())
        frame.pose = pose
        frame.processed = True
        rec = step_record(frame.id, out)
        with self._lock:
            self._trajectory.append(pose)
            self._records.append(rec)
            if bool(out.has_F):
                self._last_F = out.F.cpu().numpy()

    # --- reference getters -------------------------------------------------
    def get_trajectory(self) -> List[np.ndarray]:
        """Camera centers, like get_trajectory (visual_odometry.cpp:380)."""
        with self._lock:
            return [p.t.numpy() for p in self._trajectory]

    def get_trajectory_poses(self) -> List[Pose]:
        with self._lock:
            return list(self._trajectory)

    def get_records(self) -> List[dict]:
        """Structured per-frame diagnostics (replaces stdout scraping)."""
        with self._lock:
            return list(self._records)

    def has_last_F(self) -> bool:
        return self._last_F is not None

    def last_F(self) -> np.ndarray:
        if self._last_F is None:
            raise RuntimeError("no fundamental matrix computed yet")
        return self._last_F

    # --- checkpoint/resume --------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        save_checkpoint(path, self._state)

    def restore_checkpoint(self, path: str) -> None:
        self._state = load_checkpoint(path, self.device)
