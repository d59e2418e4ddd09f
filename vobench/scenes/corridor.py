"""A textured corridor (tpu_vo_torch/utils/synthetic.py
`make_corridor_sequence`, the scene of the high-density configuration),
redrawn in torch: two walls, floor and ceiling (half width 2.5, half
height 2.0) and an end cap at z = `length`, each with its own texture of
blurred noise at several scales, `texels` texels per unit. The camera
advances `step_z` a frame, sways by sway_x * sin(i / 4) and yaws by
yaw_deg * sin(i / 6), as the corridor's own path does."""

from __future__ import annotations

import math

import torch

from vobench.scenes import render

HALF_W, HALF_H = 2.5, 2.0


def poses(n_frames: int, device, step_z: float = 0.4, sway_x: float = 0.15,
          yaw_deg: float = 1.5):
    i = torch.arange(n_frames, dtype=torch.float32, device=device)
    R_wc = render.yaw(math.radians(yaw_deg) * torch.sin(i / 6.0))
    t_wc = torch.stack([sway_x * torch.sin(i / 4.0), torch.zeros_like(i), step_z * i], -1)
    return R_wc, t_wc


def make(seed: int, n_frames: int, width: int, height: int, device, length: float = 30.0,
         texels: float = 128.0, **params):
    gen = render.generator(seed, device)
    sig = (1.5, 4.0, 12.0)
    zres, wres, hres = int(length * texels), int(2 * HALF_W * texels), int(2 * HALF_H * texels)
    wall = [render.noise_texture(gen, hres, zres, sig, device) for _ in range(2)]
    flat = [render.noise_texture(gen, wres, zres, sig, device) for _ in range(2)]
    cap = render.noise_texture(gen, hres, wres, sig, device)
    z, x, y = (0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)
    planes = [render.Plane((-HALF_W, -HALF_H, 0.0), z, y, texels, wall[0]),
              render.Plane((HALF_W, -HALF_H, 0.0), z, y, texels, wall[1]),
              render.Plane((-HALF_W, HALF_H, 0.0), z, x, texels, flat[0]),
              render.Plane((-HALF_W, -HALF_H, 0.0), z, x, texels, flat[1]),
              render.Plane((-HALF_W, -HALF_H, length), x, y, texels, cap)]
    R_wc, t_wc = poses(n_frames, device, **params)
    frames = torch.stack([render.draw(planes, R_wc[i], t_wc[i], width, height)
                          for i in range(n_frames)])
    return frames, R_wc, t_wc
