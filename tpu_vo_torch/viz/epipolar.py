"""Epipolar-geometry inspection tool — headless port of epipolar_viewer.h
(port of tpu_vo/viz/epipolar.py, drawn by viz/raster in place of PIL).

The reference ships an interactive two-image GUI (epipolar_viewer.h,
compiled but never wired into main): clicking a point in one image draws
its epipolar line (l2 = F x1 on the left image, l1 = F^T x2 on the right)
clipped exactly to the other image, with 0-based <-> 1-based (MATLAB)
F-convention conversion and Frobenius normalization.

This module reproduces the math (conversions: epipolar_viewer.h:36-62,
line computation: :152-156, exact line-rectangle clipping with
deduplication: :158-189) and renders overlays headlessly. An interactive
loop runs where viz/gui.gui_available() finds cv2 and a display.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_vo_torch.geometry.epipolar import (
    convert_F_0based_to_1based,
    normalize_frobenius,
)
from tpu_vo_torch.viz import raster
from tpu_vo_torch.viz.gui import gui_available


# Copied from tpu_vo/viz/epipolar.py.
def clip_line_to_image(line: Sequence[float], w: int, h: int,
                       eps: float = 1e-12,
                       one_based: bool = True) -> Optional[Tuple]:
    """Clip homogeneous line a*x + b*y + c = 0 to the image rectangle.

    With one_based=True the valid range is [1, w] x [1, h] (matching
    clipLineToImage1Based); duplicated intersection points are removed
    with the reference's 1e-7 tolerance. Returns ((x0,y0),(x1,y1)) or None.
    """
    a, b, c = float(line[0]), float(line[1]), float(line[2])
    lo = 1.0 if one_based else 0.0
    xhi = float(w) if one_based else w - 1.0
    yhi = float(h) if one_based else h - 1.0

    pts: List[Tuple[float, float]] = []

    def add_if_inside(x, y):
        if lo <= x <= xhi and lo <= y <= yhi:
            pts.append((x, y))

    if abs(b) > eps:
        add_if_inside(lo, -(a * lo + c) / b)
        add_if_inside(xhi, -(a * xhi + c) / b)
    if abs(a) > eps:
        add_if_inside(-(b * lo + c) / a, lo)
        add_if_inside(-(b * yhi + c) / a, yhi)

    uniq: List[Tuple[float, float]] = []
    for p in pts:
        if not any(abs(p[0] - q[0]) < 1e-7 and abs(p[1] - q[1]) < 1e-7
                   for q in uniq):
            uniq.append(p)
    if len(uniq) < 2:
        return None
    return uniq[0], uniq[1]


def epipolar_line_for_click(F1: np.ndarray, side: str,
                            x: float, y: float) -> np.ndarray:
    """Line in the *other* image for a 0-based click at (x, y).

    side='left' -> l2 = F x1; side='right' -> l1 = F^T x2, with the
    1-based homogeneous lift of the reference (:148-150).
    """
    p = np.array([x + 1.0, y + 1.0, 1.0])
    if side == "left":
        return F1 @ p
    return F1.T @ p


def render_epipolar_pair(left: np.ndarray, right: np.ndarray,
                         F: np.ndarray,
                         clicks: Sequence[Tuple[str, float, float]],
                         convention: str = "opencv_0based",
                         normalize_F: bool = True,
                         color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    """Render the side-by-side canvas with point markers + epipolar lines.

    clicks: sequence of (side, x, y) with 0-based local pixel coords.
    Returns an RGB uint8 canvas of size (max(h), wL+wR, 3) — the same
    layout as EpipolarViewer::buildCanvasBase. Each click draws its
    cross marker (cv::MARKER_CROSS size 14), then its clipped line.
    """
    F1 = torch.tensor(np.asarray(F, dtype=np.float64))
    if convention == "opencv_0based":
        F1 = convert_F_0based_to_1based(F1)
    elif convention != "matlab_1based":
        raise ValueError(f"unknown convention {convention!r}")
    if normalize_F:
        F1 = normalize_frobenius(F1)
    F1 = F1.numpy()

    def to_rgb(img):
        img = np.asarray(img)
        return np.stack([img] * 3, -1) if img.ndim == 2 else img

    L, R = to_rgb(left), to_rgb(right)
    hL, wL = L.shape[:2]
    hR, wR = R.shape[:2]
    canvas = np.zeros((max(hL, hR), wL + wR, 3), dtype=np.uint8)
    canvas[:hL, :wL] = L
    canvas[:hR, wL:wL + wR] = R

    lines = []
    for side, x, y in clicks:
        shift = 0 if side == "left" else wL
        cx, cy = x + shift, y
        lines += [(cx - 7, cy, cx + 7, cy), (cx, cy - 7, cx, cy + 7)]
        line = epipolar_line_for_click(F1, side, x, y)
        other_w, other_h = (wR, hR) if side == "left" else (wL, hL)
        other_shift = wL if side == "left" else 0
        seg = clip_line_to_image(line, other_w, other_h)
        if seg is not None:
            (x0, y0), (x1, y1) = seg
            # 1-based -> canvas 0-based (matlab1BasedToCanvas0Based)
            lines.append((x0 - 1.0 + other_shift, y0 - 1.0, x1 - 1.0 + other_shift, y1 - 1.0))
    if not lines:
        return canvas
    p, r, c = raster.line_pixels(np.asarray(lines, np.float64), thickness, *canvas.shape[:2])
    return raster.paint(canvas, p, r, c, np.broadcast_to(np.asarray(color, np.uint8),
                                                         (r.size, 3)))


def run_epipolar_viewer(left, right, F, convention="opencv_0based",
                        normalize_F: bool = True,
                        window_name: str = "Epipolar GUI") -> int:
    """Interactive viewer when a GUI backend (cv2 + display) exists.

    Mirrors run_epipolar_viewer (epipolar_viewer.h:279-307) and the mouse
    protocol of handleMouse (:233-255): LBUTTONDOWN inside either image
    selects that side as active (left image -> l2 = F x1 in the right,
    right image -> l1 = F^T x2 in the left); dragging updates only while
    the cursor stays inside the active side; LBUTTONUP clears the active
    side. Keys r/g/b/k set color, +/- thickness, ESC exits. Returns 0 on
    success, 1 (printing why) where gui_available() finds no cv2 or no
    display, or on an error.
    """
    ok, why = gui_available()
    if not ok:
        print(f"run_epipolar_viewer: no GUI: {why}")
        return 1
    try:
        import cv2

        state = {"color": (255, 0, 0), "thick": 2, "clicks": [],
                 "active": None}
        L = np.asarray(left)
        R = np.asarray(right)
        hL, wL = L.shape[:2]
        hR, wR = R.shape[:2]

        def redraw():
            canvas = render_epipolar_pair(
                left, right, F, state["clicks"][-1:], convention,
                normalize_F, state["color"], state["thick"])
            cv2.imshow(window_name, canvas[..., ::-1])

        def side_of(x, y):
            if 0 <= x < wL and 0 <= y < hL:
                return "left"
            if wL <= x < wL + wR and 0 <= y < hR:
                return "right"
            return None

        def on_mouse(event, x, y, flags, _):
            if event == cv2.EVENT_LBUTTONDOWN:
                state["active"] = side_of(x, y)
            elif event == cv2.EVENT_LBUTTONUP:
                state["active"] = None
                return
            elif not (event == cv2.EVENT_MOUSEMOVE
                      and flags & cv2.EVENT_FLAG_LBUTTON):
                return
            side = state["active"]
            if side is not None and side_of(x, y) == side:
                state["clicks"].append(
                    (side, x if side == "left" else x - wL, y))
                redraw()

        cv2.namedWindow(window_name)
        cv2.setMouseCallback(window_name, on_mouse)
        redraw()
        colors = {ord("r"): (255, 0, 0), ord("g"): (0, 255, 0),
                  ord("b"): (0, 0, 255), ord("k"): (0, 0, 0)}
        while True:
            k = cv2.waitKey(20)
            if k == 27:
                break
            if k in colors:
                state["color"] = colors[k]
                redraw()
            if k in (ord("+"), ord("=")):
                state["thick"] += 1
                redraw()
            if k in (ord("-"), ord("_")):
                state["thick"] = max(1, state["thick"] - 1)
                redraw()
        cv2.destroyWindow(window_name)
        return 0
    except Exception as e:  # a window system that fails after the preflight
        print(f"run_epipolar_viewer error: {e}")
        return 1
