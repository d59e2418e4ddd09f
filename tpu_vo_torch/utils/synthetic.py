"""Synthetic VO sequences with known ground-truth motion, numpy and
scipy only (port of tpu_vo/utils/synthetic.py): `make_sequence` (two
textured depth planes), `make_corridor_sequence` and `make_pan_sequence`
(forward motion, or a pan while dollying, down a textured corridor),
`make_dynamic_corridor_sequence` (the corridor with a moving object,
occluding pillars or a low-texture stretch, and the object's masks), and
`compass_pattern`, frames that hold kernel B1's FAST compass test at its
edge. `render(scene, ...)` draws a scene of `SCENES` by name (config 7's
as `dynamic_<name>`), `render_range` only a range of its frames (bit for
bit the same), and `submit_render` spreads a large scene over a process
pool by ranges.

The JAX package renders with cv2. Here `make_sequence` blurs with
scipy.ndimage.gaussian_filter and warps with map_coordinates. The
corridor renderer follows cv2 5's arithmetic step by step in float64:
Gaussian octaves by scipy.ndimage.correlate1d (mirror border, cv2's
reflect-101) with weights from math.exp, min-max normalization truncated
to uint8, warpPerspective as float coordinates through the inverse
homography with bilinear taps (constant 0 border) or the nearest texel
(depth, border inf), and the 2x INTER_AREA reduction as (sum + 2) >> 2.
The textures, draws and poses are tpu_vo's; frames are alike but not
equal pixel for pixel (tests/test_torch_synthetic.py states the bound).
Every step is elementwise IEEE arithmetic or a fixed-order scipy loop in
float64 (no BLAS, no FFT), so the frames hash the same on any host that
agrees on numpy's sin and cos.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
from scipy import ndimage


def _texture(rng: np.random.Generator, size: int, blob_sigma: float) -> np.ndarray:
    img = rng.uniform(0, 255, (size, size)).astype(np.float32)
    img = ndimage.gaussian_filter(img, blob_sigma, mode="mirror", truncate=4.0)
    lo, hi = float(img.min()), float(img.max())
    return ((img - lo) * (255.0 / max(hi - lo, 1e-9))).astype(np.uint8)


def _disks(rng: np.random.Generator, size: int, count: int) -> np.ndarray:
    """Union of `count` filled disks (the foreground plane's footprint)."""
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((size, size), dtype=np.uint8)
    for _ in range(count):
        cx, cy = rng.integers(0, size, 2)
        r = int(rng.integers(30, 90))
        mask[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = 255
    return mask


def _plane_homography(K: np.ndarray, R_cw: np.ndarray, t_cw: np.ndarray,
                      z_plane: float, tex_size: int,
                      world_extent: float) -> np.ndarray:
    """Homography mapping texture pixels -> image pixels for plane z=z_plane."""
    s = world_extent / tex_size
    A = np.array([[s, 0, -world_extent / 2],
                  [0, s, -world_extent / 2],
                  [0, 0, 1]], dtype=np.float64)
    M = np.column_stack([R_cw[:, 0], R_cw[:, 1], R_cw[:, 2] * z_plane + t_cw])
    return K @ M @ A


def _warp(src: np.ndarray, H: np.ndarray, width: int, height: int,
          order: int, mode: str) -> np.ndarray:
    """cv2.warpPerspective(src, H, (width, height)) equivalent."""
    yy, xx = np.mgrid[:height, :width].astype(np.float64)
    pts = np.linalg.inv(H) @ np.stack([xx.ravel(), yy.ravel(), np.ones(xx.size)])
    coords = np.stack([pts[1] / pts[2], pts[0] / pts[2]])
    out = ndimage.map_coordinates(src.astype(np.float32), coords, order=order,
                                  mode=mode, cval=0.0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(height, width)


def make_sequence(
    n_frames: int = 30,
    width: int = 640,
    height: int = 480,
    seed: int = 0,
    step_t: Tuple[float, float, float] = (0.22, 0.0, 0.06),
    yaw_per_frame_deg: float = 0.5,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], np.ndarray]:
    """Returns (frames, R_wc_list, t_wc_list, K): uint8 (height, width)
    frames, camera->world poses and K with fx = fy = width."""
    rng = np.random.default_rng(seed)
    K = np.array([[width, 0, width / 2.0],
                  [0, width, height / 2.0],
                  [0, 0, 1.0]], dtype=np.float64)

    tex_far = _texture(rng, 1536, 2.2)
    tex_near = _texture(rng, 1024, 1.8)
    mask = _disks(rng, 1024, 60)

    z_far, z_near = 10.0, 6.0
    extent_far, extent_near = 28.0, 18.0

    frames, Rs, ts = [], [], []
    yaw_step = np.deg2rad(yaw_per_frame_deg)
    for i in range(n_frames):
        yaw = yaw_step * i
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        t_wc = np.asarray(step_t, dtype=np.float64) * i
        Rs.append(R_wc)
        ts.append(t_wc)

        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc
        H_far = _plane_homography(K, R_cw, t_cw, z_far, 1536, extent_far)
        H_near = _plane_homography(K, R_cw, t_cw, z_near, 1024, extent_near)
        far = _warp(tex_far, H_far, width, height, 1, "mirror")
        near = _warp(tex_near, H_near, width, height, 1, "mirror")
        near_mask = _warp(mask, H_near, width, height, 0, "constant")
        frames.append(np.where(near_mask > 0, near, far))

    return frames, Rs, ts, K


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) in float64: 2 * round(4 sigma)
    + 1 taps, reflect-101 border."""
    radius = int(4.0 * sigma + 0.5)
    w = [math.exp(-0.5 * (k / sigma) ** 2) for k in range(-radius, radius + 1)]
    total = math.fsum(w)
    w = np.array([v / total for v in w])
    out = ndimage.correlate1d(img, w, axis=1, mode="mirror")
    return ndimage.correlate1d(out, w, axis=0, mode="mirror")


def _fractal_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Multi-octave noise (sigma 2..32, weights 1.4^k), min-max normalized
    to uint8 by truncation: corner structure at every viewing scale. Draws
    one (h, w) float32 uniform field per octave, as tpu_vo does."""
    acc = np.zeros((h, w), np.float64)
    for k, sigma in enumerate([2.0, 4.0, 8.0, 16.0, 32.0]):
        n = _blur(rng.uniform(-1, 1, (h, w)).astype(np.float32).astype(np.float64), sigma)
        n /= max(float(np.abs(n).max()), 1e-9)
        acc += n * (1.4 ** k)
    lo, hi = float(acc.min()), float(acc.max())
    return np.clip((acc - lo) * (255.0 / max(hi - lo, 1e-300)), 0.0, 255.0).astype(np.uint8)


def _mat3(A, B):
    """A @ B for 3x3 nested lists of Python floats (no BLAS: the same bits
    on every host)."""
    return [[A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j] for j in range(3)]
            for i in range(3)]


def _vec3(A, v):
    return [A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2] for i in range(3)]


def _inv3(H):
    """Inverse of a 3x3 nested list by its adjugate."""
    (a, b, c), (d, e, f), (g, h, i) = H
    A, B, C = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * A + b * B + c * C
    adj = [[A, c * h - b * i, b * f - c * e],
           [B, a * i - c * g, c * d - a * f],
           [C, b * g - a * h, a * e - b * d]]
    return [[v / det for v in row] for row in adj]


def _plane_homography_general(K, R_cw, t_cw, origin, u_axis, v_axis,
                              tex_w: int, tex_h: int, u_extent: float, v_extent: float):
    """Homography texture px -> image px for an arbitrary world plane, as
    nested lists: texture pixel (u, v) is world X = origin + (u / tex_w)
    u_extent U + (v / tex_h) v_extent V. Returns (H, (a, b, c)) with the
    camera depth z(u, v) = a u + b v + c, affine in texture coordinates."""
    K, R = np.asarray(K, np.float64).tolist(), np.asarray(R_cw, np.float64).tolist()
    su, sv = u_extent / tex_w, v_extent / tex_h
    U3 = _vec3(R, [su * float(x) for x in u_axis])
    V3 = _vec3(R, [sv * float(x) for x in v_axis])
    O3 = [o + t for o, t in zip(_vec3(R, [float(x) for x in origin]),
                                np.asarray(t_cw, np.float64).tolist())]
    H = _mat3(K, [[U3[r], V3[r], O3[r]] for r in range(3)])
    return H, (U3[2], V3[2], O3[2])


def _source_coords(H, wss: int, hss: int):
    """Source coordinates (X, Y), float64 (hss, wss), of every destination
    pixel through the inverse of H, as cv2.warpPerspective takes them."""
    M = _inv3(H)
    return _through(M, np.arange(wss, dtype=np.float64)[None, :],
                    np.arange(hss, dtype=np.float64)[:, None])


def _through(M, x: np.ndarray, y: np.ndarray):
    """(X, Y) = the dehomogenized M (x, y, 1); inf or nan where the
    denominator is 0, as the bounds tests then reject."""
    den = M[2][0] * x + (M[2][1] * y + M[2][2])
    with np.errstate(divide="ignore", invalid="ignore"):
        return ((M[0][0] * x + (M[0][1] * y + M[0][2])) / den,
                (M[1][0] * x + (M[1][1] * y + M[1][2])) / den)


def _bilinear(tex: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """uint8 bilinear samples of tex at (X, Y), taps outside tex reading 0
    (INTER_LINEAR, BORDER_CONSTANT 0), rounded to nearest."""
    h, w = tex.shape
    x0f, y0f = np.floor(X), np.floor(Y)
    fx, fy = X - x0f, Y - y0f
    x0 = np.clip(x0f, -2, w + 1).astype(np.int64)
    y0 = np.clip(y0f, -2, h + 1).astype(np.int64)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = tex[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float64)
        return np.where(ok, v, 0.0)

    top = tap(y0, x0) * (1.0 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1.0 - fx) + tap(y0 + 1, x0 + 1) * fx
    return np.clip(np.rint(top * (1.0 - fy) + bot * fy), 0, 255).astype(np.uint8)


STRIP_ROWS = 256  # canvas rows composited at a time: bounds a 4K frame's temporaries


def _composite_planes(Kss, R_cw, t_cw, planes, textures, wss: int, hss: int,
                      tagged_idx=None):
    """Z-buffer composite of textured world planes into one uint8 view at
    (hss, wss). Each plane's depth is its float32 z-map (a u + b v + c on
    the texture grid) at the nearest texel, inf outside the texture or at
    depth <= 0.05; a pixel shows the bilinear warp of the plane of least
    depth (the first of equal ones), 0 where none. The warp is computed
    at the pixels each plane wins only. Returns (view, tag): with
    tagged_idx, tag marks the pixels whose winner is planes[tagged_idx]
    (-1: no plane), as tpu_vo's `winner == tagged_idx`; else None.

    Rows are composited STRIP_ROWS at a time; every step is per pixel, so
    the strips change no bit of the result."""
    views = []
    for (orig, ua, va, tw, th, ue, ve) in planes:
        H, abc = _plane_homography_general(Kss, R_cw, t_cw, orig, ua, va, tw, th, ue, ve)
        views.append((_inv3(H), abc, tw, th))
    best = np.zeros((hss, wss), np.uint8)
    tag = None if tagged_idx is None else np.zeros((hss, wss), bool)
    xs = np.arange(wss, dtype=np.float64)[None, :]
    for r0 in range(0, hss, STRIP_ROWS):
        rows = np.arange(r0, min(r0 + STRIP_ROWS, hss), dtype=np.float64)[:, None]
        zs = []
        for M, (a, b, c), tw, th in views:
            X, Y = _through(M, xs, rows)
            u = np.rint(X)
            v = np.rint(Y)
            with np.errstate(invalid="ignore"):
                inside = (u >= 0) & (u < tw) & (v >= 0) & (v < th)
            u = np.where(inside, u, 0).astype(np.float32)
            v = np.where(inside, v, 0).astype(np.float32)
            z = (np.float32(a) * u + np.float32(b) * v) + np.float32(c)
            zs.append(np.where(inside & (z > 0.05), z, np.float32(np.inf)))
        zs = np.stack(zs)
        win = np.argmin(zs, axis=0)
        win = np.where(np.isfinite(np.min(zs, axis=0)), win, -1)
        if tag is not None:
            tag[r0:r0 + len(rows)] = win == tagged_idx
        strip = best[r0:r0 + len(rows)]
        for idx, ((M, _, _, _), tex) in enumerate(zip(views, textures)):
            sel = np.nonzero(win == idx)
            if sel[0].size == 0:
                continue
            X, Y = _through(M, sel[1].astype(np.float64), (sel[0] + r0).astype(np.float64))
            strip[sel] = _bilinear(tex, X, Y)
    return best, tag


def _area_half(img: np.ndarray) -> np.ndarray:
    """cv2.resize(img, (w // 2, h // 2), INTER_AREA) of uint8: the rounded
    mean (sum + 2) >> 2 of each 2x2 block."""
    h, w = img.shape
    s = img.reshape(h // 2, 2, w // 2, 2).astype(np.int32).sum(axis=(1, 3))
    return ((s + 2) >> 2).astype(np.uint8)


def _area_half_mask(tag: np.ndarray) -> np.ndarray:
    """cv2.resize(tag as float32, (w // 2, h // 2), INTER_AREA) > 0.5: at
    least 3 of each 2x2 block tagged."""
    h, w = tag.shape
    return tag.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3)) >= 3


def _corridor_planes(rng: np.random.Generator, corridor_len: float, half_w: float,
                     half_h: float):
    """The 4-wall + end-cap plane specs and their textures: 4 wall
    textures (rows 768, columns along z at ~100 px per world unit, 2048 to
    16384), then the 768x1024 end cap, drawn in that order as tpu_vo does
    so the same rng state gives the same walls."""
    zres = int(np.clip(corridor_len * 100, 2048, 16384))
    vres = 768
    L, hw, hh = corridor_len, half_w, half_h
    planes = [
        (np.array([-hw, -hh, 0.0]), np.array([0, 0, 1.0]),
         np.array([0, 1.0, 0]), zres, vres, L, 2 * hh),   # left wall
        (np.array([hw, -hh, 0.0]), np.array([0, 0, 1.0]),
         np.array([0, 1.0, 0]), zres, vres, L, 2 * hh),   # right wall
        (np.array([-hw, hh, 0.0]), np.array([0, 0, 1.0]),
         np.array([1.0, 0, 0]), zres, vres, L, 2 * hw),   # floor (y=+hh)
        (np.array([-hw, -hh, 0.0]), np.array([0, 0, 1.0]),
         np.array([1.0, 0, 0]), zres, vres, L, 2 * hw),   # ceiling (y=-hh)
        (np.array([-hw, -hh, L]), np.array([1.0, 0, 0]),
         np.array([0, 1.0, 0]), 1024, 768, 2 * hw, 2 * hh),  # end cap
    ]
    textures = [_fractal_texture(rng, vres, zres) for _ in range(4)]
    textures.append(_fractal_texture(rng, 768, 1024))
    return planes, textures, zres


@functools.lru_cache(maxsize=2)
def _corridor_textures(seed: int, corridor_len: float, half_w: float, half_h: float):
    """(planes, textures, zres, rng state after them) of the corridor of a
    seed: the scene's first draws, so every frame range, and every scene
    of config 7 (one seed, one length), builds them once per process. The
    textures are read-only; a scene that edits one copies it."""
    rng = np.random.default_rng(seed)
    planes, textures, zres = _corridor_planes(rng, corridor_len, half_w, half_h)
    for tex in textures:
        tex.setflags(write=False)
    return tuple(planes), tuple(textures), zres, rng.bit_generator.state


def _intrinsics(width: int, height: int) -> np.ndarray:
    return np.array([[width, 0, width / 2.0],
                     [0, width, height / 2.0],
                     [0, 0, 1.0]], dtype=np.float64)


def _sway_pose(i: int, step_z: float, sway_x: float, yaw_amp_deg: float):
    """The corridor's own camera path: advance step_z per frame, sway by
    sway_x and yaw by yaw_amp_deg."""
    yaw = np.deg2rad(yaw_amp_deg) * np.sin(i / 6.0)
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    t_wc = np.array([sway_x * np.sin(i / 4.0), 0.0, step_z * i])
    return R_wc, t_wc


def _view(K, width: int, height: int, R_wc, t_wc, planes, textures, tagged_idx=None):
    """(frame, mask): the planes seen from camera->world pose (R_wc, t_wc),
    rendered at 2x and reduced by INTER_AREA, and with tagged_idx the mask
    of planes[tagged_idx] (else None)."""
    ss = 2
    Kss = K.copy()
    Kss[:2] *= ss
    wss, hss = width * ss, height * ss
    R_cw = R_wc.T.tolist()
    t_cw = [-v for v in _vec3(R_cw, t_wc.tolist())]
    best, tag = _composite_planes(Kss, R_cw, t_cw, planes, textures, wss, hss, tagged_idx)
    return _area_half(best), None if tag is None else _area_half_mask(tag)


class _Scene(NamedTuple):
    """A sequence before it is drawn: every frame's pose, K, and draw(i)
    -> (frame i, its object mask or None)."""

    Rs: List[np.ndarray]
    ts: List[np.ndarray]
    K: np.ndarray
    draw: Callable
    masks: bool  # the scene's sequence ends with its object masks


def _corridor_scene(n_frames=40, width=640, height=480, seed=0, step_z=0.8, sway_x=0.15,
                    yaw_amp_deg=1.5, corridor_len=None, half_w=2.5, half_h=2.0,
                    pose_fn=None) -> _Scene:
    if corridor_len is None:
        corridor_len = step_z * n_frames + 25.0
    K = _intrinsics(width, height)
    planes, textures, _, _ = _corridor_textures(seed, corridor_len, half_w, half_h)
    Rs, ts = [], []
    for i in range(n_frames):
        if pose_fn is not None:
            R_wc, t_wc = pose_fn(i)
            R_wc = np.asarray(R_wc, np.float64)
            t_wc = np.asarray(t_wc, np.float64)
        else:
            R_wc, t_wc = _sway_pose(i, step_z, sway_x, yaw_amp_deg)
        Rs.append(R_wc)
        ts.append(t_wc)
    return _Scene(Rs, ts, K, lambda i: _view(K, width, height, Rs[i], ts[i], planes, textures), False)


def _sequence(scene: _Scene, start: int = 0, stop=None):
    """(frames, Rs, ts, K[, masks]) of a scene, the frames (and masks)
    those of [start, stop) only; the poses are every frame's."""
    drawn = [scene.draw(i) for i in range(start, len(scene.Rs) if stop is None else stop)]
    out = ([f for f, _ in drawn], scene.Rs, scene.ts, scene.K)
    return out + ([m for _, m in drawn],) if scene.masks else out


def make_corridor_sequence(
    n_frames: int = 40,
    width: int = 640,
    height: int = 480,
    seed: int = 0,
    step_z: float = 0.8,
    sway_x: float = 0.15,
    yaw_amp_deg: float = 1.5,
    corridor_len: float | None = None,
    half_w: float = 2.5,
    half_h: float = 2.0,
    pose_fn=None,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], np.ndarray]:
    """Forward motion down a textured 4-wall corridor with an end cap.

    Returns (frames, R_wc_list, t_wc_list, K): uint8 (height, width)
    frames rendered at 2x and reduced by INTER_AREA, camera->world poses
    and K with fx = fy = width, the poses and K equal to tpu_vo's. The
    camera sways by sway_x and yaws by yaw_amp_deg as it advances step_z
    per frame, unless pose_fn(i) -> (R_wc, t_wc) gives the poses.
    """
    return _sequence(_corridor_scene(n_frames, width, height, seed, step_z, sway_x, yaw_amp_deg,
                                     corridor_len, half_w, half_h, pose_fn))


def _pan_scene(n_frames=32, width=640, height=480, seed=0, step_z=0.5, yaw_amp_deg=35.0,
               yaw_period=10.0) -> _Scene:
    def pose(i):
        yaw = np.deg2rad(yaw_amp_deg) * np.sin(i / yaw_period)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        t_wc = np.array([0.0, 0.0, step_z * i])
        return R_wc, t_wc

    return _corridor_scene(n_frames=n_frames, width=width, height=height, seed=seed,
                           step_z=step_z, pose_fn=pose)


def make_pan_sequence(
    n_frames: int = 32,
    width: int = 640,
    height: int = 480,
    seed: int = 0,
    step_z: float = 0.5,
    yaw_amp_deg: float = 35.0,
    yaw_period: float = 10.0,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], np.ndarray]:
    """The corridor while panning: the camera advances step_z per frame
    and yaws through +-yaw_amp_deg (up to ~4 deg per frame at the default
    period). Same conventions and renderer as make_corridor_sequence."""
    return _sequence(_pan_scene(n_frames, width, height, seed, step_z, yaw_amp_deg, yaw_period))


def _dynamic_scene(n_frames=48, width=640, height=480, seed=0, step_z=0.8, sway_x=0.15,
                   yaw_amp_deg=1.5, obj_size=0.0, obj_ahead=6.0, obj_x_amp=1.4,
                   obj_period=9.0, obj_y=0.0, n_occluders=0, occluder_w=0.5,
                   low_texture_span=None) -> _Scene:
    corridor_len = step_z * n_frames + 25.0
    K = _intrinsics(width, height)
    hw, hh = 2.5, 2.0
    planes, textures, zres, state = _corridor_textures(seed, corridor_len, hw, hh)
    planes, textures = list(planes), list(textures)
    rng = np.random.default_rng(seed)
    rng.bit_generator.state = state
    if low_texture_span is not None:
        z0, z1 = low_texture_span
        u0 = int(np.clip(z0 / corridor_len, 0, 1) * zres)
        u1 = int(np.clip(z1 / corridor_len, 0, 1) * zres)
        for k in range(4):  # walls + floor + ceiling
            textures[k] = textures[k].copy()
            textures[k][:, u0:u1] = 128
    for j in range(n_occluders):
        x0 = (-1.0) ** j * (hw - 1.2)
        z0 = 6.0 + j * (step_z * n_frames + 6.0) / max(n_occluders, 1)
        planes.append((np.array([x0 - occluder_w / 2, -hh, z0]),
                       np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                       256, 1024, occluder_w, 2 * hh))
        textures.append(_fractal_texture(rng, 1024, 256))
    obj_tex = _fractal_texture(rng, 512, 512) if obj_size > 0 else None
    poses = [_sway_pose(i, step_z, sway_x, yaw_amp_deg) for i in range(n_frames)]

    def draw(i):
        frame_planes, frame_tex = list(planes), list(textures)
        if obj_size > 0:
            ox = obj_x_amp * np.sin(2 * np.pi * i / obj_period)
            oz = step_z * i + obj_ahead
            frame_planes.append((
                np.array([ox - obj_size / 2, obj_y - obj_size / 2, oz]),
                np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                512, 512, obj_size, obj_size))
            frame_tex.append(obj_tex)
        tagged = len(frame_planes) - 1 if obj_size > 0 else -1
        return _view(K, width, height, *poses[i], frame_planes, frame_tex, tagged)

    return _Scene([R for R, _ in poses], [t for _, t in poses], K, draw, True)


def make_dynamic_corridor_sequence(
    n_frames: int = 48,
    width: int = 640,
    height: int = 480,
    seed: int = 0,
    step_z: float = 0.8,
    sway_x: float = 0.15,
    yaw_amp_deg: float = 1.5,
    obj_size: float = 0.0,
    obj_ahead: float = 6.0,
    obj_x_amp: float = 1.4,
    obj_period: float = 9.0,
    obj_y: float = 0.0,
    n_occluders: int = 0,
    occluder_w: float = 0.5,
    low_texture_span: Tuple[float, float] | None = None,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], np.ndarray,
           List[np.ndarray]]:
    """The corridor with structured, non-static geometry (tpu_vo's
    arguments, draws from the rng and returns), any of:

      moving object (obj_size > 0): a textured square quad obj_ahead
        units ahead of the camera, swinging sideways by obj_x_amp with
        period obj_period frames: an independently moving rigid body
        whose matches are structured outliers to the camera's motion;
      occluders (n_occluders > 0): static full-height pillars, on
        alternate sides, spaced down the corridor;
      low texture (low_texture_span = (z0, z1)): walls, floor and
        ceiling blanked to grey 128 over that z-range.

    Returns (frames, R_wc_list, t_wc_list, K, obj_masks): obj_masks[i] is
    the (height, width) bool map of the object's pixels (at least 3 of
    the 4 supersampled pixels), all False without an object.
    Conventions as make_corridor_sequence.
    """
    return _sequence(_dynamic_scene(
        n_frames, width, height, seed, step_z, sway_x, yaw_amp_deg, obj_size, obj_ahead,
        obj_x_amp, obj_period, obj_y, n_occluders, occluder_w, low_texture_span))


# Config 7's scenes (benchmarks/run_benchmarks.py, run_config_7): an object
# at three sizes, four occluders and a low-texture stretch
DYNAMIC_SCENES = {
    "obj_light": dict(obj_size=1.2),
    "obj_mid": dict(obj_size=2.0),
    "obj_heavy": dict(obj_size=3.2),
    "occluders": dict(n_occluders=4),
    "low_texture": dict(low_texture_span=(10.0, 22.0)),
}
SCENES = {"corridor": _corridor_scene, "pan": _pan_scene,
          **{f"dynamic_{k}": functools.partial(_dynamic_scene, **kw)
             for k, kw in DYNAMIC_SCENES.items()}}


def render(scene: str, n_frames: int, width: int, height: int, seed: int):
    """The sequence of SCENES[scene] (make_*_sequence's tuple): a
    module-level callable that a process pool can run."""
    return render_range(scene, n_frames, width, height, seed, 0, n_frames)


def render_range(scene: str, n_frames: int, width: int, height: int, seed: int,
                 start: int, stop: int):
    """render(...) with the frames (and masks) of [start, stop) only, bit
    for bit those of the whole sequence: the textures come from the seed
    (built once per process), then only those frames are drawn. The poses
    and K are the whole sequence's. Workers render a large scene by ranges."""
    return _sequence(SCENES[scene](n_frames=n_frames, width=width, height=height, seed=seed),
                     start, stop)


RANGE_PIXELS = 2 * 3840 * 2160  # frame pixels a render_range task draws at most


def submit_render(pool, scene: str, n_frames: int, width: int, height: int, seed: int):
    """Futures of render_range on `pool` over consecutive frame ranges of
    at most RANGE_PIXELS pixels each (one range for a small scene);
    join_ranges of their results, in order, is render(...)'s."""
    per = max(1, RANGE_PIXELS // (width * height))
    return [pool.submit(render_range, scene, n_frames, width, height, seed, a,
                        min(a + per, n_frames)) for a in range(0, n_frames, per)]


def join_ranges(parts):
    """The sequence of render_range's parts of one scene, in order."""
    out = list(parts[0])
    for k in [0] + ([4] if len(out) == 5 else []):
        out[k] = [x for p in parts for x in p[k]]
    return tuple(out)


def frames_sha256(frames) -> str:
    """sha256 of the frames' uint8 bytes in order (the reference file's
    check that a host renders the scene the file was made from)."""
    import hashlib

    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f, dtype=np.uint8).tobytes())
    return h.hexdigest()


def compass_pattern(b: int, h: int, w: int, threshold: int, seed: int = 0) -> np.ndarray:
    """(b, h, w) float32 frames on the integer grid in which FAST's compass
    test sits at its edge. Centres on a 7-pixel grid have exactly 1 or 2
    compass points (circle points 0, 4, 8, 12) past the threshold on the
    dark side (d = centre - point = threshold + 1) and 1 or 2 on the
    bright side (d = -(threshold + 1)), the others at |d| = threshold; the
    other circle points pass on one side with probability 0.85. Every
    other pixel is within the threshold of 128."""
    from tpu_vo_torch.features.fast import CIRCLE_OFFSETS

    rng = np.random.default_rng(seed)
    v, t = 128, int(threshold)
    img = rng.integers(v - t, v + t + 1, (b, h, w))
    cy, cx = np.meshgrid(np.arange(3, h - 3, 7), np.arange(3, w - 3, 7), indexing="ij")
    k = cy.size
    bi = np.repeat(np.arange(b), k)
    cy, cx = np.tile(cy.ravel(), b), np.tile(cx.ravel(), b)
    n = bi.size
    img[bi, cy, cx] = v
    side = rng.integers(0, 2, (n, 1)) * 2 - 1
    d = np.where(rng.random((n, 16)) < 0.85, side * (t + 1), rng.choice([-t, t], (n, 16)))
    compass = rng.permuted(np.tile([0, 4, 8, 12], (n, 1)), axis=1)
    nd, nb = rng.integers(1, 3, (n, 1)), rng.integers(1, 3, (n, 1))
    rank = np.arange(4)
    d[np.arange(n)[:, None], compass] = np.where(
        rank < nd, t + 1, np.where(rank < nd + nb, -(t + 1), rng.choice([-t, t], (n, 4))))
    for j, (dx, dy) in enumerate(CIRCLE_OFFSETS):
        img[bi, cy + dy, cx + dx] = v - d[:, j]
    return img.astype(np.float32)
