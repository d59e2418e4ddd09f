"""Two textured depth planes, the scene of bench.py's main path
(tpu_vo_torch/utils/synthetic.py `make_sequence`), redrawn in torch: a
far plane at z = 10 (1536 texels over 28 units) and a near plane at
z = 6 (1024 texels over 18 units) seen through the union of 60 disks.
The camera moves by `step` a frame and yaws as yaw_deg * sin(i / period)
so that a long sequence keeps both planes in view."""

from __future__ import annotations

import math

import torch

from vobench.scenes import render


def poses(n_frames: int, device, step=(0.22, 0.0, 0.06), yaw_deg: float = 8.0,
          period: float = 20.0):
    i = torch.arange(n_frames, dtype=torch.float32, device=device)
    R_wc = render.yaw(math.radians(yaw_deg) * torch.sin(i / period))
    t_wc = i[:, None] * torch.tensor(step, dtype=torch.float32, device=device)
    return R_wc, t_wc


def make(seed: int, n_frames: int, width: int, height: int, device, **params):
    gen = render.generator(seed, device)
    far = render.noise_texture(gen, 1536, 1536, (2.2,), device)
    near = render.noise_texture(gen, 1024, 1024, (1.8,), device)
    mask = render.disks(gen, 1024, 60, 30, 90, device)
    planes = [render.Plane((-14.0, -14.0, 10.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                           1536 / 28.0, far),
              render.Plane((-9.0, -9.0, 6.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                           1024 / 18.0, near, mask)]
    R_wc, t_wc = poses(n_frames, device, **params)
    frames = torch.stack([render.draw(planes, R_wc[i], t_wc[i], width, height)
                          for i in range(n_frames)])
    return frames, R_wc, t_wc
