"""Offline 3D trajectory renderer — GL-free port of trajectory_viewer.cpp
(port of tpu_vo/viz/trajectory.py, drawn by viz/raster in place of PIL
and written by io/jpeg.encode_rgb).

Reproduces the Pangolin/OpenGL viewer's scene and its 7-view screenshot
writer (trajectory_viewer.cpp:66-233) as a small software renderer:

  scene (render_step, :94-153): world axes (len 0.5), 21x21 ground grid,
  green trajectory polyline, points (start red / end blue / middle green),
  current camera axes (0.3) + yellow frustum (0.25), historical axes and
  frusta every 10th pose (0.1 / 0.08) — frusta drawn looking along -Zc
  (:313-358, :265-300);

  camera model: ProjectionMatrix(1024, 768, 500, 500, 512, 389, 0.1, 1000)
  (:79) with ModelViewLookAt; screenshots frame the trajectory AABB with
  eye = center + max(2.5*extent, 1.0) * dir for the six axis views + iso
  (:170-226), written as JPEG quality 95 (:56).

The scene is float64 numpy arrays, built for all poses at once in
tpu_vo's order; segments are projected, clipped at the near plane and
drawn with painter's ordering, then the points.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from tpu_vo_torch.configs import ViewerConfig
from tpu_vo_torch.io.jpeg import encode_rgb
from tpu_vo_torch.viz import raster
from tpu_vo_torch.viz.overlay import to_host

Vec3 = np.ndarray

AXIS_COLORS = np.array([(255, 0, 0), (0, 255, 0), (0, 0, 255)], np.uint8)
GRID = (77, 77, 77)
GREEN, RED, BLUE, YELLOW = (0, 255, 0), (255, 0, 0), (0, 0, 255), (255, 255, 0)
CLEAR = (26, 26, 26)  # glClearColor 0.1


def look_at(eye: Vec3, center: Vec3, up: Vec3) -> Tuple[np.ndarray, Vec3]:
    """OpenGL-style view: returns (R_view (3,3), eye). Camera looks -z."""
    f = center - eye
    f = f / max(np.linalg.norm(f), 1e-12)
    upn = up / max(np.linalg.norm(up), 1e-12)
    s = np.cross(f, upn)
    s = s / max(np.linalg.norm(s), 1e-12)
    u = np.cross(s, f)
    R = np.stack([s, u, -f])  # rows: right, up, -forward
    return R, eye


def _axes(origins, Rs, length, width):
    """(K, 3, ...) axis segments of K frames: x, y and -z (visual forward
    is -Zc, trajectory_viewer.cpp:275), each o -> o + length * d."""
    d = np.swapaxes(np.asarray(Rs, float), -1, -2).copy()  # rows: the columns of R
    d[:, 2] = -d[:, 2]
    o = np.repeat(np.asarray(origins, float)[:, None], 3, 1)
    colors = np.broadcast_to(AXIS_COLORS, (len(o), 3, 3))
    return o, o + length * d, colors, np.full((len(o), 3), float(width))


def _frusta(Rs, ts, scale, width=1.5):
    """(K, 8, ...) frustum segments: for each corner, apex -> corner then
    corner -> next corner."""
    d, hw, hh = 1.0 * scale, 0.6 * scale, 0.4 * scale
    corners_c = np.array([[-hw, -hh, -d], [hw, -hh, -d], [hw, hh, -d], [-hw, hh, -d]])
    ts = np.asarray(ts, float)
    P = np.einsum("kij,cj->kci", np.asarray(Rs, float), corners_c) + ts[:, None]
    O = np.repeat(ts[:, None], 4, 1)
    a = np.stack([O, P], 2).reshape(len(ts), 8, 3)
    b = np.stack([P, np.roll(P, -1, 1)], 2).reshape(len(ts), 8, 3)
    colors = np.broadcast_to(np.asarray(YELLOW, np.uint8), (len(ts), 8, 3))
    return a, b, colors, np.full((len(ts), 8), float(width))


class TrajectoryRenderer:
    """Draws the viewer scene into an RGB image for a given view."""

    def __init__(self, cfg: ViewerConfig = ViewerConfig()):
        self.cfg = cfg
        z3, z = np.zeros((0, 3)), np.zeros(0)
        # segments: a (S, 3), b (S, 3), color (S, 3) uint8, width (S,)
        self.segments = (z3, z3, np.zeros((0, 3), np.uint8), z)
        # points: p (P, 3), color (P, 3) uint8, size (P,)
        self.points = (z3, np.zeros((0, 3), np.uint8), z)

    # -- scene assembly ----------------------------------------------------
    def build_scene(self, poses) -> None:
        """Assemble segments/points from trajectory (render_step geometry),
        in the order tpu_vo appends them. poses: a Pose of (n, 3, 3) and
        (n, 3) tensors or arrays."""
        cfg = self.cfg
        parts = [_axes(np.zeros((1, 3)), np.eye(3)[None], cfg.axis_len, 2.0)]
        g, s = cfg.grid_size, cfg.grid_step
        i = np.arange(-g, g + s / 2, s)
        ones, zeros = np.ones_like(i), np.zeros_like(i)
        a = np.stack([np.stack([-g * ones, zeros, i], 1), np.stack([i, zeros, -g * ones], 1)], 1)
        b = np.stack([np.stack([g * ones, zeros, i], 1), np.stack([i, zeros, g * ones], 1)], 1)
        parts.append((a, b, np.broadcast_to(np.asarray(GRID, np.uint8), (len(i), 2, 3)),
                      np.ones((len(i), 2))))

        R = to_host(poses.R).astype(float).reshape(-1, 3, 3)
        t = to_host(poses.t).astype(float).reshape(-1, 3)
        n = len(t)
        if n == 0:
            self._set(parts, (np.zeros((0, 3)), np.zeros((0, 3), np.uint8), np.zeros(0)))
            return
        parts.append((t[:-1], t[1:], np.broadcast_to(np.asarray(GREEN, np.uint8), (n - 1, 3)),
                      np.full(n - 1, 2.0)))
        pcol = np.broadcast_to(np.asarray(GREEN, np.uint8), (n, 3)).copy()
        pcol[0] = RED
        if n > 1:
            pcol[-1] = BLUE
        points = (t.copy(), pcol, np.full(n, 5.0))
        parts.append(_axes(t[-1:], R[-1:], cfg.cam_axis_len, 3.0))
        parts.append(_frusta(R[-1:], t[-1:], cfg.cam_frustum_scale))
        h = np.arange(0, n, cfg.history_every_n)
        ax = _axes(t[h], R[h], cfg.history_axis_len, 3.0)
        fr = _frusta(R[h], t[h], cfg.history_frustum_scale)
        parts.append(tuple(np.concatenate([x, y], 1) for x, y in zip(ax, fr)))
        self._set(parts, points)

    def _set(self, parts, points) -> None:
        """Flatten (a, b, color, width) parts of (K, m) or (S,) segments in
        row-major order."""
        self.segments = tuple(
            np.concatenate([np.reshape(p[k], (-1, 3) if k < 3 else -1) for p in parts])
            for k in range(4))
        self.points = points

    # -- projection + raster ------------------------------------------------
    def render(self, eye: Vec3, center: Vec3, up: Vec3) -> np.ndarray:
        cfg = self.cfg
        Rv, eye = look_at(np.asarray(eye, float), np.asarray(center, float),
                          np.asarray(up, float))
        W, H = cfg.width, cfg.height
        img = np.empty((H, W, 3), np.uint8)
        img[:] = CLEAR

        def to_cam(p):
            return (p - eye) @ Rv.T

        def project(pc):
            z = -pc[:, 2]
            u = cfg.cx + cfg.focal * pc[:, 0] / z
            v_gl = cfg.cy + cfg.focal * pc[:, 1] / z
            return u, (H - 1) - v_gl

        near = cfg.z_near
        a, b, colors, widths = self.segments
        pa, pb = to_cam(a), to_cam(b)
        za, zb = -pa[:, 2], -pb[:, 2]
        keep = ~((za < near) & (zb < near))
        pa, pb, za, zb = pa[keep], pb[keep], za[keep], zb[keep]
        with np.errstate(divide="ignore", invalid="ignore"):
            ca = za < near
            cb = ~ca & (zb < near)
            alpha = np.where(ca, (near - za) / (zb - za), (near - zb) / (za - zb))[:, None]
            pa, pb = (np.where(ca[:, None], pa + alpha * (pb - pa), pa),
                      np.where(cb[:, None], pb + alpha * (pa - pb), pb))
        ua, va = project(pa)
        ub, vb = project(pb)
        lw = np.maximum(1, np.round(widths[keep]).astype(np.int64))
        sp, sr, sc = raster.line_pixels(np.stack([ua, va, ub, vb], 1), lw, H, W)
        scol = colors[keep][sp]

        p, pcolor, size = self.points
        pc = to_cam(p)
        vis = ~(-pc[:, 2] < near)
        u, v = project(pc[vis])
        r = size[vis] / 2.0
        pp, pr, pcc = raster.ellipse_pixels(np.stack([u - r, v - r, u + r, v + r], 1), True, H, W)
        order = np.concatenate([sp, len(ua) + pp])
        return raster.paint(img, order, np.concatenate([sr, pr]), np.concatenate([sc, pcc]),
                            np.concatenate([scol, pcolor[vis][pp]]))


# Screenshot views: (tag, direction, up) — trajectory_viewer.cpp:194-202.
# AxisNegY -> up (0,-1,0); AxisZ -> up (0,0,1).
VIEWS = (
    ("posX", (+1, 0, 0), (0, -1, 0)),
    ("negX", (-1, 0, 0), (0, -1, 0)),
    ("posY", (0, +1, 0), (0, 0, 1)),
    ("negY", (0, -1, 0), (0, 0, 1)),
    ("posZ", (0, 0, +1), (0, -1, 0)),
    ("negZ", (0, 0, -1), (0, -1, 0)),
    ("iso", (+1, -1, -1), (0, -1, 0)),
)


def view_eyes(t: np.ndarray, cfg: ViewerConfig = ViewerConfig()):
    """(tag, eye, center, up) of each screenshot view of camera centers t
    (n, 3), n >= 1: the trajectory's box framed from max(2.5 * extent,
    1.0) along each direction."""
    t = np.asarray(t, float)
    mn, mx = t.min(axis=0), t.max(axis=0)
    center = 0.5 * (mn + mx)
    extent = float((mx - mn).max())
    dist = max(cfg.framing_factor * extent, cfg.framing_min_dist)
    out = []
    for tag, dirn, up in VIEWS:
        d = np.asarray(dirn, float)
        nd = np.linalg.norm(d)
        d = d / nd if nd > 1e-12 else np.array([0.0, 0.0, -1.0])
        out.append((tag, center + dist * d, center, np.asarray(up, float)))
    return out


def save_trajectory_screenshots(poses, out_dir: str,
                                cfg: ViewerConfig = ViewerConfig()) -> bool:
    """The 7-view export (save_trajectory_screenshots, :155-233): files
    trajectory_view_from_<tag>.jpg, baseline JPEG at cfg.jpeg_quality.
    False on an empty trajectory or when a file cannot be written."""
    t = to_host(poses.t).astype(float).reshape(-1, 3)
    if len(t) == 0:
        return False
    os.makedirs(out_dir, exist_ok=True)
    renderer = TrajectoryRenderer(cfg)
    renderer.build_scene(poses)
    ok = True
    for tag, eye, center, up in view_eyes(t, cfg):
        img = renderer.render(eye, center, up)
        path = os.path.join(out_dir, f"trajectory_view_from_{tag}.jpg")
        try:
            with open(path, "wb") as f:
                f.write(encode_rgb(img, cfg.jpeg_quality))
        except OSError:
            ok = False
    return ok
