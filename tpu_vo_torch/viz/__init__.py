"""Host-side drawing (port of tpu_vo/viz): the keypoint overlay, the 3D
trajectory renderer and its 7 screenshots, the epipolar tool, all drawn
by viz/raster on numpy arrays (no PIL, no cv2; cv2 only for windows,
behind viz/gui.gui_available)."""

from tpu_vo_torch.viz.overlay import draw_keypoints_overlay
from tpu_vo_torch.viz.trajectory import TrajectoryRenderer, save_trajectory_screenshots
from tpu_vo_torch.viz.epipolar import render_epipolar_pair, clip_line_to_image

__all__ = [
    "draw_keypoints_overlay",
    "TrajectoryRenderer",
    "save_trajectory_screenshots",
    "render_epipolar_pair",
    "clip_line_to_image",
]
