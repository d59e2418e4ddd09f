"""Config 3's stage profile at 4K beside the tuned shape (port of
tools/profile_4k.py).

profile(W, H, n_feat, ratio, B) at (1241x376, 1200 keypoints, no ratio
test, B 8) and (3840x2160, 8000 keypoints, the ratio test, B 2), on
numpy.random.default_rng(0) uint8 frames, times per frame (per pair for
the pair rows):

  pyramid_ms           the 8-level pyramid
  select_maps_ms       the pyramid and kernel B1 over all levels (one launch)
  select_plus_topk_ms  the pyramid, B1 and each level's two-stage top-k
  patches_blur_ms      kernel B2 (one launch) and features/patches.
                       blur_patches on the keypoints' windows
  frontend_ms          detect_and_compute
  hamming_ms           the Hamming step over the B-1 pairs: the ratio test
                       where the configuration has it, else the cross-check
  pair_ms              estimate_pair over the B-1 pairs

then the table of measured 4K / 1241x376 ratios against the scaling
model: pixels (17.8x) for the pyramid and the selection maps, keypoints
(6.7x) for the windows, their square for the Hamming step. Rows as
tools/profile_rows says.

    python -m tpu_vo_torch.tools.profile_4k [--reps 16 --iters 3]  (reps: 128 and 16 by default)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import MatchConfig, ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.features import orb, patches
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.matching.hamming import mutual_nearest_match, ratio_test_match
from tpu_vo_torch.ops.select import select_maps_levels
from tpu_vo_torch.pipeline.step import estimate_pair, pair_generators
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(base_width=1241, base_height=376, base_features=1200, base_batch=8,
                hi_width=3840, hi_height=2160, hi_features=8000, hi_batch=2, hyps=256,
                reps=None, iters=3)
BASE_REPS, HI_REPS = 128, 16  # the JAX tool's calls a measurement, where reps is None
STAGES = ("pyramid_ms", "select_maps_ms", "select_plus_topk_ms", "patches_blur_ms",
          "frontend_ms", "hamming_ms", "pair_ms")


def profile(rows, label: str, W: int, H: int, n_feat: int, ratio: bool, B: int, max_iters: int,
            reps: int, iters: int) -> dict:
    """Rows `label`.<stage> on B frames; returns {stage: ms a frame or pair}."""
    cfg = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=n_feat),
                   match=MatchConfig(use_ratio_test=ratio), ransac=RansacConfig(max_iters=max_iters))
    ocfg = cfg.orb
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 255, (B, H, W), dtype=np.uint8)).to(rows.dev)
    t = dict(reps=reps, iters=iters)
    res = {}

    def put(stage, row, n):
        res[stage] = row["ms"] / n if rows.on_card else row["host_ms"] / n

    def pyramid():
        return build_pyramid(imgs.to(torch.float32), ocfg.n_levels, ocfg.scale_factor)

    def sel_maps():
        return select_maps_levels([lv.contiguous() for lv in pyramid()], ocfg.fast_threshold,
                                  ocfg.edge_threshold)

    def sel_full():
        return orb.select_keypoints(orb.pyramid_levels(imgs, ocfg), ocfg)

    used = orb.pyramid_levels(imgs, ocfg)
    kps, starts = rows.run(lambda: orb.select_keypoints(used, ocfg), (1, 0))
    ys, xs = orb.keypoint_coords(kps)

    def patches_blur():
        return patches.blur_patches(orb.keypoint_windows(used, ys, xs, starts))

    def frontend():
        return orb.detect_and_compute(imgs, ocfg)

    feats = rows.run(frontend, (1, 1))
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))

    def hamming():
        if ratio:
            return ratio_test_match(prev.desc32, cur.desc32, prev.valid, cur.valid,
                                    cfg.match.ratio)
        return mutual_nearest_match(prev.desc32, cur.desc32, prev.valid, cur.valid)

    def pairs():
        return estimate_pair(prev, cur, cfg, generators=pair_generators(0, range(1, B)))

    for stage, fn, launches, n, extra in (
            ("pyramid_ms", pyramid, (0, 0), B, {}), ("select_maps_ms", sel_maps, (1, 0), B, {}),
            ("select_plus_topk_ms", sel_full, (1, 0), B, {}),
            ("patches_blur_ms", patches_blur, (0, 1), B, {}),
            ("frontend_ms", frontend, (1, 1), B, {}),
            ("hamming_ms", hamming, (0, 0), B - 1,
             {"hamming": "ratio test" if ratio else "cross-check"}),
            ("pair_ms", pairs, (0, 0), B - 1, {"profile": True})):
        unit = "frame" if n == B else "pair"
        put(stage, rows.time(f"{label}.{stage}", fn, launches=launches, per=(unit, n),
                             **t, **extra), n)
    return res


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_4k", o)
    base = profile(rows, f"base_{o.base_width}x{o.base_height}", o.base_width, o.base_height,
                   o.base_features, False, o.base_batch, o.hyps, o.reps or BASE_REPS, o.iters)
    hi = profile(rows, f"hi_{o.hi_width}x{o.hi_height}", o.hi_width, o.hi_height, o.hi_features,
                 True, o.hi_batch, o.hyps, o.reps or HI_REPS, o.iters)
    px = (o.hi_width * o.hi_height) / (o.base_width * o.base_height)
    kp = o.hi_features / o.base_features
    model = {"pyramid_ms": px, "select_maps_ms": px, "select_plus_topk_ms": px,
             "patches_blur_ms": kp, "hamming_ms": kp * kp}
    rows.add("ratios", {"clock": "CUDA events" if rows.on_card else "host",
                        "pixels_x": px, "keypoints_x": kp, "stages": [
                            {"stage": k, "base": base[k], "hi": hi[k],
                             "x_measured": hi[k] / max(base[k], 1e-9), "x_model": model.get(k)}
                            for k in STAGES]})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
