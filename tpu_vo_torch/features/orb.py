"""ORB detect-and-compute, batched over frames (port of
tpu_vo/features/orb.py, accelerator route).

Per pyramid level, over all B frames at once:
  select_maps (kernel B1): FAST-9/16 + strict NMS + border + dense
      Harris + packed keys + vertical 2-row pool
  _rank_from_maps: exact stage-1 cut of the 2n best FAST keys, then the
      n best by Harris response (retainBest twice)
  extract_patches (kernel B2): one 43x43 window per keypoint
  angles, blur and steered rBRIEF bits from the windows (features/patches)
Slots are ordered by level, then by descending Harris response; every
stage runs at fixed capacity with a validity mask.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import brief, patches
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops.patch import extract_patches
from tpu_vo_torch.ops.select import _bit_reverse, select_maps


class ORBFeatures(NamedTuple):
    """Fixed-capacity feature sets, (..., N) with N = config.n_features."""

    xy: torch.Tensor        # (..., N, 2) float32 level-0 pixel coords (x, y)
    response: torch.Tensor  # (..., N) float32 Harris response
    angle: torch.Tensor     # (..., N) float32 orientation, degrees [0, 360)
    octave: torch.Tensor    # (..., N) int32 pyramid level
    size: torch.Tensor      # (..., N) float32 patchSize * level scale
    desc: torch.Tensor      # (..., N, 32) uint8 rBRIEF descriptor (cv2 layout)
    desc32: torch.Tensor    # (..., N, 8) int32 lanes (the uint32 bit pattern)
    valid: torch.Tensor     # (..., N) bool slot validity


# Copied from tpu_vo/features/orb.py.
def features_per_level(n_features: int, n_levels: int,
                       scale_factor: float) -> List[int]:
    """OpenCV's geometric per-level feature budget (orb.cpp)."""
    factor = 1.0 / scale_factor
    nd = n_features * (1 - factor) / (1 - factor ** n_levels)
    out = []
    total = 0
    for _ in range(n_levels - 1):
        n = int(np.round(nd))
        out.append(n)
        total += n
        nd *= factor
    out.append(max(n_features - total, 0))
    return out


def _stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties broken by lowest index, like
    lax.top_k (torch.topk does not promise an order among ties)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _rank_from_maps(packed, harris_map, idx_bits, w, n_level, cfg, area):
    """Stage-1 FAST cut + stage-2 Harris ranking from select_maps' outputs
    for (B, ...) levels. Returns (ys, xs, response, valid), each (B, k1)."""
    k2 = min((4 if cfg.retain_best_keep_ties else 2) * n_level, area)
    b, hp2, wp = packed.shape
    pooled = packed.view(b, hp2, wp // 2, 2).amax(-1).view(b, -1)
    k_red = min(k2, pooled.shape[1])
    # Exact cut. Only the values are used and nonzero keys are unique
    # (they hold the index), so the order among tied zeros is immaterial.
    v = torch.topk(pooled, k_red, dim=-1).values
    if k_red < k2:
        v = torch.nn.functional.pad(v, (0, k2 - k_red))

    v2 = (v >> idx_bits).to(torch.float32)
    mask = (1 << idx_bits) - 1
    idx2 = torch.where(v > 0, _bit_reverse(mask - (v & mask), idx_bits),
                       torch.zeros_like(v))
    ys2 = idx2 // w
    xs2 = idx2 % w
    cand_ok = v2 > 0.0
    resp = torch.gather(harris_map.reshape(b, -1), 1, idx2.to(torch.int64))

    if cfg.retain_best_keep_ties:
        n2 = min(2 * n_level, area)
        cand_ok = cand_ok & (v2 >= v2[:, n2 - 1:n2])
    resp = torch.where(cand_ok, resp, torch.full_like(resp, -float("inf")))
    v1, sel = _stable_topk(resp, min(n_level, k2))
    ys = torch.gather(ys2, 1, sel)
    xs = torch.gather(xs2, 1, sel)
    valid = torch.isfinite(v1)
    return ys, xs, torch.where(valid, v1, torch.zeros_like(v1)), valid


def detect_and_compute(img: torch.Tensor,
                       cfg: ORBConfig = ORBConfig()) -> ORBFeatures:
    """ORB features of (B, H, W) or (H, W) grayscale frames (uint8 or
    float32 0..255); the kernels launch once per level for the batch."""
    single = img.dim() == 2
    frames = img[None] if single else img
    b = frames.shape[0]
    dev = frames.device
    levels = build_pyramid(frames, cfg.n_levels, cfg.scale_factor)
    budgets = features_per_level(cfg.n_features, cfg.n_levels,
                                 cfg.scale_factor)

    xs_all, ys_all, resp_all, ang_all, valid_all = [], [], [], [], []
    oct_all, size_all, scale_all, bits_all = [], [], [], []
    for level, (lvl, n_level) in enumerate(zip(levels, budgets)):
        if n_level <= 0:
            continue
        h, w = lvl.shape[-2:]
        lvl = lvl.contiguous()
        packed, hmap, idx_bits = select_maps(lvl, cfg.fast_threshold,
                                             cfg.edge_threshold)
        ys, xs, resp, valid = _rank_from_maps(packed, hmap, idx_bits, w,
                                              n_level, cfg, h * w)
        raw = extract_patches(lvl, ys.contiguous(), xs.contiguous())
        ang = patches.angles_from_patches(raw)
        bits_all.append(patches.descriptor_bits_from_patches(raw, ang))
        scale = float(cfg.scale_factor ** level)
        k = xs.shape[1]
        xs_all.append(xs)
        ys_all.append(ys)
        resp_all.append(resp)
        ang_all.append(ang)
        valid_all.append(valid)
        oct_all.append(torch.full((b, k), level, dtype=torch.int32, device=dev))
        size_all.append(torch.full((b, k), cfg.patch_size * scale,
                                   dtype=torch.float32, device=dev))
        scale_all.append(torch.full((b, k), scale, dtype=torch.float32,
                                    device=dev))

    bits = torch.cat(bits_all, dim=1)
    scale = torch.cat(scale_all, dim=1)
    xy = (torch.stack([torch.cat(xs_all, 1), torch.cat(ys_all, 1)], dim=-1)
          .to(torch.float32) * scale[..., None])
    valid = torch.cat(valid_all, dim=1)
    v1 = valid[..., None]
    feats = ORBFeatures(
        xy=torch.where(v1, xy, torch.zeros_like(xy)),
        response=torch.cat(resp_all, 1),
        angle=torch.where(valid, torch.cat(ang_all, 1),
                          torch.zeros((), device=dev)),
        octave=torch.cat(oct_all, 1),
        size=torch.cat(size_all, 1),
        desc=torch.where(v1, brief.pack_bits_u8(bits),
                         torch.zeros((), dtype=torch.uint8, device=dev)),
        desc32=torch.where(v1, brief.pack_bits_u32(bits),
                           torch.zeros((), dtype=torch.int32, device=dev)),
        valid=valid,
    )
    if single:
        feats = ORBFeatures(*(f[0] for f in feats))
    return feats
