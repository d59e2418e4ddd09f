"""Textured planes seen through a pinhole camera, drawn on the device.

A plane is (origin, u axis, v axis, texels per world unit, texture,
alpha): every pixel's ray is cut with every plane, the nearest cut in
front of the camera wins, and the plane's texture is sampled there
bilinearly, mirrored past its edges. A plane with an alpha map (sampled
at the nearest texel, zero past its edges) is seen only where it is
nonzero. The camera has fx = fy = W and its principal point at the
centre, as the program assumes when it is given no calibration.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class Plane(NamedTuple):
    origin: tuple        # a point of the plane, world units
    u: tuple             # unit axis of the texture's columns
    v: tuple             # unit axis of the texture's rows
    texels: float        # texels per world unit
    texture: torch.Tensor            # (h, w) float32, 0..255
    alpha: Optional[torch.Tensor] = None  # (h, w) float32 or None


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed` (any int below 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (h, w), reflected at the edges."""
    r = max(1, int(math.ceil(4 * sigma)))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-x * x / (2 * sigma * sigma))
    k = k / k.sum()
    out = F.pad(img[None, None], (r, r, 0, 0), mode="reflect")
    out = F.conv2d(out, k.view(1, 1, 1, -1))
    out = F.pad(out, (0, 0, r, r), mode="reflect")
    return F.conv2d(out, k.view(1, 1, -1, 1))[0, 0]


def noise_texture(gen: torch.Generator, h: int, w: int, sigmas, device) -> torch.Tensor:
    """(h, w) float32 texture in 0..255: uniform noise blurred at each of
    `sigmas` texels and summed, then stretched to the full range."""
    acc = torch.zeros((h, w), dtype=torch.float32, device=device)
    for s in sigmas:
        acc += _blur(torch.rand((h, w), generator=gen, device=device), float(s))
    lo, hi = acc.min(), acc.max()
    return (acc - lo) * (255.0 / torch.clamp(hi - lo, min=1e-6))


def disks(gen: torch.Generator, size: int, count: int, r_lo: int, r_hi: int,
          device) -> torch.Tensor:
    """(size, size) float32: 1 inside the union of `count` random disks."""
    c = torch.randint(0, size, (count, 2), generator=gen, device=device).to(torch.float32)
    r = torch.randint(r_lo, r_hi, (count,), generator=gen, device=device).to(torch.float32)
    yy = torch.arange(size, dtype=torch.float32, device=device)
    inside = ((yy[None, :, None] - c[:, 1, None, None]) ** 2
              + (yy[None, None, :] - c[:, 0, None, None]) ** 2) <= (r * r)[:, None, None]
    return inside.any(0).to(torch.float32)


def yaw(angle_rad: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations about the camera's y axis."""
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _sample(tex: torch.Tensor, col: torch.Tensor, row: torch.Tensor, mode: str,
            padding: str) -> torch.Tensor:
    h, w = tex.shape
    grid = torch.stack([col * (2.0 / max(w - 1, 1)) - 1.0,
                        row * (2.0 / max(h - 1, 1)) - 1.0], -1)
    return F.grid_sample(tex[None, None], grid[None], mode=mode, padding_mode=padding,
                         align_corners=True)[0, 0]


def draw(planes, R_wc: torch.Tensor, t_wc: torch.Tensor, width: int,
         height: int) -> torch.Tensor:
    """(H, W) uint8: the planes seen from camera->world pose (R_wc, t_wc)."""
    dev = R_wc.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    f = float(width)
    ray_c = torch.stack([(xs - width / 2.0) / f, (ys - height / 2.0) / f,
                         torch.ones_like(xs)], -1)
    ray = ray_c @ R_wc.T                              # (H, W, 3) world directions
    best = torch.full((height, width), float("inf"), device=dev)
    out = torch.zeros((height, width), dtype=torch.float32, device=dev)
    for p in planes:
        o = torch.tensor(p.origin, dtype=torch.float32, device=dev)
        u = torch.tensor(p.u, dtype=torch.float32, device=dev)
        v = torch.tensor(p.v, dtype=torch.float32, device=dev)
        n = torch.linalg.cross(u, v)
        denom = ray @ n
        lam = ((o - t_wc) @ n) / torch.where(denom.abs() > 1e-9, denom,
                                             torch.full_like(denom, 1e-9))
        hit = t_wc + lam[..., None] * ray - o
        col, row = (hit @ u) * p.texels, (hit @ v) * p.texels
        seen = (lam > 1e-3) & (lam < best)
        if p.alpha is not None:
            seen &= _sample(p.alpha, col, row, "nearest", "zeros") > 0.5
        val = _sample(p.texture, col, row, "bilinear", "reflection")
        out = torch.where(seen, val, out)
        best = torch.where(seen, lam, best)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
