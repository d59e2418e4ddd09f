"""Synthetic VO sequences with known ground-truth motion, numpy and
scipy only (port of tpu_vo/utils/synthetic.py): `make_sequence` (two
textured depth planes), `make_corridor_sequence` and `make_pan_sequence`
(forward motion, or a pan while dollying, down a textured corridor), and
`compass_pattern`, frames that hold kernel B1's FAST compass test at its
edge.

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

import math
from typing import List, Tuple

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


def _composite_planes(Kss, R_cw, t_cw, planes, textures, wss: int, hss: int) -> np.ndarray:
    """Z-buffer composite of textured world planes into one uint8 view at
    (hss, wss). Each plane's depth is its float32 z-map (a u + b v + c on
    the texture grid) at the nearest texel, inf outside the texture or at
    depth <= 0.05; a pixel shows the bilinear warp of the plane of least
    depth (the first of equal ones), 0 where none. The warp is computed
    at the pixels each plane wins only."""
    Hs, zs = [], []
    for (orig, ua, va, tw, th, ue, ve) in planes:
        H, (a, b, c) = _plane_homography_general(Kss, R_cw, t_cw, orig, ua, va, tw, th, ue, ve)
        X, Y = _source_coords(H, wss, hss)
        u = np.rint(X)
        v = np.rint(Y)
        with np.errstate(invalid="ignore"):
            inside = (u >= 0) & (u < tw) & (v >= 0) & (v < th)
        u = np.where(inside, u, 0).astype(np.float32)
        v = np.where(inside, v, 0).astype(np.float32)
        z = (np.float32(a) * u + np.float32(b) * v) + np.float32(c)
        zs.append(np.where(inside & (z > 0.05), z, np.float32(np.inf)))
        Hs.append(H)
    zs = np.stack(zs)
    win = np.argmin(zs, axis=0)
    win = np.where(np.isfinite(np.min(zs, axis=0)), win, -1)
    best = np.zeros((hss, wss), np.uint8)
    for idx, (H, tex) in enumerate(zip(Hs, textures)):
        sel = np.nonzero(win == idx)
        if sel[0].size == 0:
            continue
        X, Y = _through(_inv3(H), sel[1].astype(np.float64), sel[0].astype(np.float64))
        best[sel] = _bilinear(tex, X, Y)
    return best


def _area_half(img: np.ndarray) -> np.ndarray:
    """cv2.resize(img, (w // 2, h // 2), INTER_AREA) of uint8: the rounded
    mean (sum + 2) >> 2 of each 2x2 block."""
    h, w = img.shape
    s = img.reshape(h // 2, 2, w // 2, 2).astype(np.int32).sum(axis=(1, 3))
    return ((s + 2) >> 2).astype(np.uint8)


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
    if corridor_len is None:
        corridor_len = step_z * n_frames + 25.0
    rng = np.random.default_rng(seed)
    K = np.array([[width, 0, width / 2.0],
                  [0, width, height / 2.0],
                  [0, 0, 1.0]], dtype=np.float64)
    ss = 2
    Kss = K.copy()
    Kss[:2] *= ss
    wss, hss = width * ss, height * ss

    planes, textures, _ = _corridor_planes(rng, corridor_len, half_w, half_h)

    frames, Rs, ts = [], [], []
    for i in range(n_frames):
        if pose_fn is not None:
            R_wc, t_wc = pose_fn(i)
            R_wc = np.asarray(R_wc, np.float64)
            t_wc = np.asarray(t_wc, np.float64)
        else:
            yaw = np.deg2rad(yaw_amp_deg) * np.sin(i / 6.0)
            cy_, sy_ = np.cos(yaw), np.sin(yaw)
            R_wc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
            t_wc = np.array([sway_x * np.sin(i / 4.0), 0.0, step_z * i])
        Rs.append(R_wc)
        ts.append(t_wc)

        R_cw = R_wc.T.tolist()
        t_cw = [-v for v in _vec3(R_cw, t_wc.tolist())]
        best = _composite_planes(Kss, R_cw, t_cw, planes, textures, wss, hss)
        frames.append(_area_half(best))

    return frames, Rs, ts, K


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

    def pose(i):
        yaw = np.deg2rad(yaw_amp_deg) * np.sin(i / yaw_period)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        t_wc = np.array([0.0, 0.0, step_z * i])
        return R_wc, t_wc

    return make_corridor_sequence(
        n_frames=n_frames, width=width, height=height, seed=seed,
        step_z=step_z, pose_fn=pose)


SCENES = {"corridor": make_corridor_sequence, "pan": make_pan_sequence}


def render(scene: str, n_frames: int, width: int, height: int, seed: int):
    """SCENES[scene](n_frames, width, height, seed): a module-level callable
    that a process pool can run."""
    return SCENES[scene](n_frames=n_frames, width=width, height=height, seed=seed)


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
