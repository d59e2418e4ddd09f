"""ORB detect-and-compute, batched over frames (port of
tpu_vo/features/orb.py, accelerator route).

Over all B frames and pyramid levels at once:
  select_maps_levels (kernel B1, one launch for all levels): FAST-9/16 +
      strict NMS + border + dense Harris + packed keys + vertical 2-row
      pool
  _rank_from_maps, per level: exact stage-1 cut of the 2n best FAST keys
      (_stage1_cut), then the n best by Harris response (_rank_keys;
      retainBest twice)
  extract_patches_levels (kernel B2, one launch for all levels' slots):
      one 43x43 window per keypoint
  describe (one launch of the describe kernel for all windows): angles,
      blur and steered rBRIEF bits (ops/describe; its plain version is
      features/patches' per-window functions)
Slots are ordered by level, then by descending Harris response; every
stage runs at fixed capacity with a validity mask.

`_select_level_keypoints` is the JAX package's other selection route,
the one it takes where the fused kernel does not run: fast.detect
(kernel B3 + NMS; or its maps from fast.detect_levels, one launch for a
pyramid), border, top-2n by FAST score, harris_at, top-n by Harris.
detect_and_compute does not use it; tools/stage_bench.py does.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import brief, fast, harris
from tpu_vo_torch.features.fast import _border_mask
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops.describe import describe_windows
from tpu_vo_torch.ops.patch import extract_patches_levels
from tpu_vo_torch.ops.select import _bit_reverse, select_maps_levels
from tpu_vo_torch.utils.profiling import span


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


def _harris_cut(v2, ys2, xs2, resp, n_level, k2, cfg, area):
    """Stage 2 from the stage-1 candidates (B, k2): FAST scores v2 (0 for
    an empty slot), positions and Harris responses. Keeps the ties at the
    2n-th score if cfg.retain_best_keep_ties (OpenCV's retainBest(2n)),
    then the n best by Harris, ties to the lowest slot. Returns (ys, xs,
    response, valid), each (B, k1)."""
    cand_ok = v2 > 0.0
    if cfg.retain_best_keep_ties:
        n2 = min(2 * n_level, area)
        cand_ok = cand_ok & (v2 >= v2[:, n2 - 1:n2])
    resp = torch.where(cand_ok, resp, torch.full_like(resp, -float("inf")))
    v1, sel = _stable_topk(resp, min(n_level, k2))
    ys = torch.gather(ys2, 1, sel)
    xs = torch.gather(xs2, 1, sel)
    valid = torch.isfinite(v1)
    return ys, xs, torch.where(valid, v1, torch.zeros_like(v1)), valid


def _stage1_size(n_level, cfg, area):
    """The stage-1 cut's capacity: 2n keys, or 4n to hold the ties at the
    2n-th score (cfg.retain_best_keep_ties), at most the level's area."""
    return min((4 if cfg.retain_best_keep_ties else 2) * n_level, area)


def _stage1_cut(packed, k2):
    """Stage 1: the (B, k2) largest packed keys of select_maps' (B, H/2,
    W_pad) map after its 1x2 pool, zero-padded where the map holds fewer.
    The cut is exact. Only the values are used and nonzero keys are
    unique (they hold the index), so the order among tied zeros is
    immaterial."""
    b, hp2, wp = packed.shape
    pooled = packed.view(b, hp2, wp // 2, 2).amax(-1).view(b, -1)
    k_red = min(k2, pooled.shape[1])
    v = torch.topk(pooled, k_red, dim=-1).values
    if k_red < k2:
        v = torch.nn.functional.pad(v, (0, k2 - k_red))
    return v


def _rank_keys(v, harris_map, idx_bits, w, n_level, cfg, area):
    """Stage 2 from stage 1's (B, k2) keys v: each key's position decoded,
    the Harris response gathered there, then _harris_cut. Returns (ys,
    xs, response, valid), each (B, k1)."""
    b, k2 = v.shape
    v2 = (v >> idx_bits).to(torch.float32)
    mask = (1 << idx_bits) - 1
    idx2 = torch.where(v > 0, _bit_reverse(mask - (v & mask), idx_bits),
                       torch.zeros_like(v))
    resp = torch.gather(harris_map.reshape(b, -1), 1, idx2.to(torch.int64))
    return _harris_cut(v2, idx2 // w, idx2 % w, resp, n_level, k2, cfg, area)


def _rank_from_maps(packed, harris_map, idx_bits, w, n_level, cfg, area):
    """Stage-1 FAST cut + stage-2 Harris ranking from select_maps' outputs
    for (B, ...) levels. Returns (ys, xs, response, valid), each (B, k1)."""
    v = _stage1_cut(packed, _stage1_size(n_level, cfg, area))
    return _rank_keys(v, harris_map, idx_bits, w, n_level, cfg, area)


def _select_level_keypoints(lvl: torch.Tensor, n_level: int, cfg: ORBConfig,
                            detected=None):
    """FAST -> border -> top-2n by FAST -> Harris -> top-n for (B, H, W)
    float32 levels (tpu_vo/features/orb.py `_select_level_keypoints`, its
    fast.detect branch). `detected` is the level's (score, keep) from
    fast.detect_levels, or None to run fast.detect here. Returns (ys, xs,
    response, valid), each (B, k1).

    Both cuts break ties by lowest flat index, like lax.top_k: FAST
    scores tie often. With cfg.retain_best_keep_ties the stage-1 cut has
    a capacity of 4n for the ties at the 2n-th score.
    """
    b, h, w = lvl.shape
    k2 = min((4 if cfg.retain_best_keep_ties else 2) * n_level, h * w)
    score, keep = fast.detect(lvl, cfg.fast_threshold) if detected is None else detected
    keep = keep & _border_mask(h, w, cfg.edge_threshold, lvl.device)
    masked = torch.where(keep, score, torch.zeros((), device=lvl.device))
    v2, idx2 = _stable_topk(masked.view(b, -1), k2)
    ys2 = (idx2 // w).to(torch.int32)
    xs2 = (idx2 % w).to(torch.int32)
    return _harris_cut(v2, ys2, xs2, harris.harris_at(lvl, ys2, xs2), n_level, k2, cfg,
                       h * w)


def pyramid_levels(frames: torch.Tensor, cfg: ORBConfig):
    """[(level, (B, H, W) float32 level, budget)] of the pyramid levels of
    (B, H, W) frames that keep at least one keypoint."""
    budgets = features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    return [(level, lvl.contiguous(), n_level) for level, (lvl, n_level) in enumerate(
        zip(build_pyramid(frames, cfg.n_levels, cfg.scale_factor), budgets)) if n_level > 0]


def select_keypoints(used, cfg: ORBConfig):
    """Kernel B1 on all of pyramid_levels' levels (one launch), then each
    level's two-stage cut, all levels in one span (orb.rank): ([(ys, xs,
    response, valid)] per level, each (B, k), and each level's first
    slot)."""
    maps = select_maps_levels([lvl for _, lvl, _ in used], cfg.fast_threshold,
                              cfg.edge_threshold)
    kps, starts, slots = [], [], 0
    with span("orb.rank"):
        for (_, lvl, n_level), (packed, hmap, idx_bits) in zip(used, maps):
            h, w = lvl.shape[-2:]
            kps.append(_rank_from_maps(packed, hmap, idx_bits, w, n_level, cfg, h * w))
            starts.append(slots)
            slots += kps[-1][0].shape[1]
    return kps, starts


def keypoint_coords(kps):
    """(ys, xs), each (B, N): every level's keypoint rows and columns, in
    slot order."""
    return torch.cat([k[0] for k in kps], 1), torch.cat([k[1] for k in kps], 1)


def keypoint_windows(used, ys, xs, starts) -> torch.Tensor:
    """Kernel B2: the (B, N, 43, 43) windows at keypoint_coords' (ys, xs),
    each level's from its first slot in `starts`, one launch."""
    return extract_patches_levels([lvl for _, lvl, _ in used], ys, xs, starts)


def describe(raw: torch.Tensor):
    """(angles, rBRIEF bits) of (B, N, 43, 43) windows: one launch of the
    describe kernel on a CUDA tensor, its plain version on the CPU
    (ops/describe.py)."""
    return describe_windows(raw)


def pack_features(used, kps, ys, xs, ang, bits, cfg: ORBConfig) -> ORBFeatures:
    """ORBFeatures of (B, ...) frames from the levels, keypoints (per level
    and keypoint_coords' (ys, xs)), angles and bits: level-0 coordinates,
    octave, size, packed descriptors, every invalid slot zeroed."""
    b = kps[0][0].shape[0]
    dev = bits.device
    oct_all, size_all, scale_all = [], [], []
    for (level, _, _), kp in zip(used, kps):
        scale = float(cfg.scale_factor ** level)
        k = kp[0].shape[1]
        oct_all.append(torch.full((b, k), level, dtype=torch.int32, device=dev))
        size_all.append(torch.full((b, k), cfg.patch_size * scale,
                                   dtype=torch.float32, device=dev))
        scale_all.append(torch.full((b, k), scale, dtype=torch.float32, device=dev))
    scale = torch.cat(scale_all, dim=1)
    xy = torch.stack([xs, ys], dim=-1).to(torch.float32) * scale[..., None]
    valid = torch.cat([k[3] for k in kps], dim=1)
    v1 = valid[..., None]
    return ORBFeatures(
        xy=torch.where(v1, xy, torch.zeros_like(xy)),
        response=torch.cat([k[2] for k in kps], 1),
        angle=torch.where(valid, ang, torch.zeros((), device=dev)),
        octave=torch.cat(oct_all, 1),
        size=torch.cat(size_all, 1),
        desc=torch.where(v1, brief.pack_bits_u8(bits),
                         torch.zeros((), dtype=torch.uint8, device=dev)),
        desc32=torch.where(v1, brief.pack_bits_u32(bits),
                           torch.zeros((), dtype=torch.int32, device=dev)),
        valid=valid,
    )


def detect_and_compute(img: torch.Tensor,
                       cfg: ORBConfig = ORBConfig()) -> ORBFeatures:
    """ORB features of (B, H, W) or (H, W) grayscale frames (uint8 or
    float32 0..255); each kernel launches once for all levels and frames:
    pyramid_levels, select_keypoints (B1), keypoint_coords,
    keypoint_windows (B2), describe and pack_features, in that order,
    each in its span (orb.pyramid, .select, .windows, .describe, .pack)."""
    single = img.dim() == 2
    frames = img[None] if single else img
    with span("orb.pyramid"):
        used = pyramid_levels(frames, cfg)
    with span("orb.select"):
        kps, starts = select_keypoints(used, cfg)
        ys, xs = keypoint_coords(kps)
    with span("orb.windows"):
        raw = keypoint_windows(used, ys, xs, starts)
    with span("orb.describe"):
        ang, bits = describe(raw)
    with span("orb.pack"):
        feats = pack_features(used, kps, ys, xs, ang, bits, cfg)
    if single:
        feats = ORBFeatures(*(f[0] for f in feats))
    return feats
