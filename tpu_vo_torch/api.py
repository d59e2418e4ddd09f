"""Object-style API mirroring the reference's public surface (port of
tpu_vo/api.py):

    Frame(id, image) with .keypoints/.descriptors/.pose/.timestamp
    VisualOdometry(width, height).process_frame(frame) -> overlay image
    .get_trajectory() / .get_trajectory_poses() / .has_last_F() / .last_F()
    TrajectoryViewer().init()/render_step(poses)/save_trajectory_screenshots()

State lives in the wrapper, compute in the functional `vo_step`, on the
card unless the caller passes device="cpu". Drawing (the keypoint
overlay, the trajectory viewer) is host code in viz/.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from tpu_vo_torch.configs import VOConfig, ViewerConfig
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.image.color import bgr_to_gray
from tpu_vo_torch.io.trajectory_io import load_checkpoint, save_checkpoint
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.pipeline.step import VOState, initial_state, vo_step
from tpu_vo_torch.utils.profiling import CALL_SPAN, span
from tpu_vo_torch.utils.records import step_record
from tpu_vo_torch.viz.overlay import draw_keypoints_overlay, host_features
from tpu_vo_torch.viz.trajectory import TrajectoryRenderer, save_trajectory_screenshots


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

    def process_frame(self, frame: Frame,
                      render_overlay: bool = False) -> Optional[np.ndarray]:
        """Run one frame; updates frame.pose and the trajectory, with the
        reference's failure ladder (visual_odometry.cpp:323-378). With
        render_overlay=True it also fills frame.keypoints and
        .descriptors from this frame's valid features (state.prev after
        the step, copied to the host once) and returns their keypoint
        overlay (H, W, 3) on the gray frame (the reference always
        rendered it)."""
        if frame.image is None:
            raise ValueError("frame has no image")
        with span(CALL_SPAN):
            with span("vo.upload"):
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

            if not render_overlay:
                return None
            feats = host_features(self._state.prev)
            frame.keypoints = feats.xy[feats.valid]
            frame.descriptors = feats.desc[feats.valid]
            gray = np.asarray(frame.image) if np.ndim(frame.image) == 2 else img.cpu().numpy()
            return draw_keypoints_overlay(gray, feats)

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


class TrajectoryViewer:
    """Facade matching trajectory_viewer.h:10-34 over the software renderer.

    render_step() draws the scene; with show=True and a GUI-capable cv2 it
    displays a live window (the reference's Pangolin window), otherwise it
    just keeps the last rendered frame available as .last_frame.
    """

    def __init__(self, show: bool = False):
        self.cfg = ViewerConfig()
        self._renderer = TrajectoryRenderer(self.cfg)
        self._initialized = False
        self._show = show
        self._quit = False
        self.last_frame: Optional[np.ndarray] = None

    def init(self) -> None:
        self._initialized = True

    def should_quit(self) -> bool:
        return self._quit

    @staticmethod
    def _stack(poses: List[Pose]) -> Pose:
        """One Pose of (n, 3, 3) and (n, 3) host arrays, in the poses' dtype."""
        return Pose(np.stack([np.asarray(p.R) for p in poses]),
                    np.stack([np.asarray(p.t) for p in poses]))

    def render_step(self, trajectory: List[Pose]) -> Optional[np.ndarray]:
        self.init()
        if not trajectory:
            return None
        poses = self._stack(trajectory)
        self._renderer.build_scene(poses)
        center = poses.t.mean(axis=0)
        k = 0.1
        eye = center + np.array([2 * k, -5 * k, -10 * k]) * 10
        self.last_frame = self._renderer.render(eye, center,
                                                np.array([0.0, -1.0, 0.0]))
        if self._show:
            try:
                import cv2

                cv2.imshow("Visual Odometry: Trajectory",
                           self.last_frame[..., ::-1])
                if cv2.waitKey(1) in (27, ord("q")):
                    self._quit = True
            except Exception:  # the window system failed after the preflight
                pass
        return self.last_frame

    def save_trajectory_screenshots(self, trajectory: List[Pose],
                                    out_dir: str) -> bool:
        if not trajectory:
            return False
        return save_trajectory_screenshots(self._stack(trajectory), out_dir,
                                           self.cfg)
