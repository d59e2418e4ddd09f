"""Synthetic VO sequences with known ground-truth motion, numpy-only
(port of tpu_vo/utils/synthetic.py `make_sequence`), and
`compass_pattern`, frames that hold kernel B1's FAST compass test at its
edge.

A camera moves over two textured depth planes (real parallax, so the
essential matrix is well defined); each frame is rendered through the
plane-induced homographies. The JAX package renders with cv2; here the
blur is scipy.ndimage.gaussian_filter and the warps are
scipy.ndimage.map_coordinates, so scenes are alike but not equal pixel
for pixel.
"""

from __future__ import annotations

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
