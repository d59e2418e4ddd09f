"""Host-side keypoint overlay (port of tpu_vo/viz/overlay.py, drawn by
viz/raster in place of PIL).

Equivalent of render_current_frame_with_keypoints_overlay
(visual_odometry.cpp:283-290): cv::drawKeypoints with
DRAW_RICH_KEYPOINTS draws, per keypoint, a circle of radius size/2 and a
radius line at the keypoint angle, in green. Drawing stays outside the
step; each field of the features comes to the host in one copy.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from tpu_vo_torch.viz import raster

FIELDS = ("xy", "size", "angle", "valid", "desc")


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_features(features) -> SimpleNamespace:
    """The fields the overlay and Frame need (xy, size, angle, valid and,
    where present, desc) as numpy arrays, each copied from the device once."""
    return SimpleNamespace(**{k: to_host(getattr(features, k)) for k in FIELDS
                              if hasattr(features, k)})


def draw_keypoints_overlay(image: np.ndarray, features,
                           color=(0, 255, 0)) -> np.ndarray:
    """Render rich keypoints. image: (H, W) gray or (H, W, 3) RGB uint8.

    features: ORBFeatures (or any object with .xy, .size, .angle, .valid
    numpy-convertible fields). Returns (H, W, 3) RGB uint8. Each valid
    keypoint draws its circle, then its radius line, in slot order, as
    tpu_vo's PIL loop does.
    """
    image = to_host(image)
    rgb = np.stack([image] * 3, axis=-1) if image.ndim == 2 else image
    out = np.array(rgb, dtype=np.uint8)
    h, w = out.shape[:2]
    idx = np.flatnonzero(to_host(features.valid))
    xy = to_host(features.xy)[idx].astype(np.float64)
    r = to_host(features.size)[idx].astype(np.float64) / 2.0
    a = np.deg2rad(to_host(features.angle)[idx].astype(np.float64))
    x, y = xy[:, 0], xy[:, 1]
    ep, er, ec = raster.ellipse_pixels(np.stack([x - r, y - r, x + r, y + r], 1), False, h, w)
    lp, lr, lc = raster.line_pixels(
        np.stack([x, y, x + r * np.cos(a), y + r * np.sin(a)], 1), 1, h, w)
    rows, cols = np.concatenate([er, lr]), np.concatenate([ec, lc])
    order = np.concatenate([2 * ep, 2 * lp + 1])
    return raster.paint(out, order, rows, cols, np.broadcast_to(np.asarray(color, np.uint8),
                                                                (rows.size, 3)))
