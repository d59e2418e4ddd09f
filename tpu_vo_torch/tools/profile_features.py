"""The ORB frontend split by substage (port of tools/profile_features.py).

detect_and_compute at the bench tiling (T=64 frames of
make_sequence(64, 1241, 376, seed=0), 1200 keypoints, fc frames a call),
each substage chunk-mapped at fc as the runner maps it:

  pyramid     orb.pyramid_levels: the 8-level resize
  select      orb.select_keypoints: kernel B1 (one launch for all
              levels) and each level's two-stage top-k (_rank_from_maps)
  patches     orb.keypoint_windows: kernel B2, one 43x43 window a slot
              (at orb.keypoint_coords' positions, gathered untimed)
  angle+desc  orb.describe: intensity-centroid angles, the window blur
              and the steered rBRIEF bits
  pack        orb.pack_features: bits packed, slots assembled
  full        detect_and_compute

The JAX tool branches on fast._use_pallas() for its patches row; the
port always runs B2 on the card (ops/patch.extract_patches_levels). The
row "composed_equal" says whether the substages chained give
detect_and_compute's features bit for bit, on this device.

    python -m tpu_vo_torch.tools.profile_features [--fc 8 --reps 32]
"""

from __future__ import annotations

import sys

import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.features import orb
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(T=64, width=1241, height=376, features=1200, fc=8, reps=32, iters=5)


def chunks(frames: torch.Tensor, fc):
    """The frame chunks of the runner's stage 1."""
    return [frames[a:e] for a, e in runner._spans(frames.shape[0], fc)]


def composed(frames: torch.Tensor, cfg: ORBConfig, fc) -> orb.ORBFeatures:
    """The substages chained, chunk by chunk: detect_and_compute's
    features of every frame."""
    out = []
    for x in chunks(frames, fc):
        used = orb.pyramid_levels(x, cfg)
        kps, starts = orb.select_keypoints(used, cfg)
        ys, xs = orb.keypoint_coords(kps)
        ang, bits = orb.describe(orb.keypoint_windows(used, ys, xs, starts))
        out.append(orb.pack_features(used, kps, ys, xs, ang, bits, cfg))
    return runner._cat(out)


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("profile_features", o)
    T = o.T
    cfg = ORBConfig(n_features=o.features)
    vcfg = VOConfig(image_width=o.width, image_height=o.height, orb=cfg)
    frames = torch.from_numpy(profile_rows.sequence(T, o.width, o.height).copy()).to(o.device)
    xs = chunks(frames.to(torch.float32), o.fc)
    n = len(xs)

    def pyramid_fn():
        return [orb.pyramid_levels(x, cfg) for x in xs]

    used = rows.run(pyramid_fn)

    def select_fn():
        return [orb.select_keypoints(u, cfg) for u in used]

    sel = rows.run(select_fn, (n, 0))
    coords = [orb.keypoint_coords(k) for k, _ in sel]

    def patches_fn():
        return [orb.keypoint_windows(u, ys, xs, s)
                for u, (ys, xs), (_, s) in zip(used, coords, sel)]

    raws = rows.run(patches_fn, (0, n))

    def angdesc_fn():
        return [orb.describe(r) for r in raws]

    ad = rows.run(angdesc_fn)

    def pack_fn():
        return [orb.pack_features(u, k, ys, xs, a, b, cfg)
                for u, (k, _), (ys, xs), (a, b) in zip(used, sel, coords, ad)]

    def full_fn():
        return runner.detect_frames(frames, vcfg, o.fc)

    t = dict(reps=o.reps, iters=o.iters, per=("frame", T))
    rows.time("pyramid", pyramid_fn, **t)
    rows.time("select", select_fn, launches=(n, 0), **t)
    rows.time("patches", patches_fn, launches=(0, n), **t)
    rows.time("angle+desc", angdesc_fn, **t)
    rows.time("pack", pack_fn, **t)
    rows.time("full", full_fn, launches=(n, n), **t)
    a = rows.run(lambda: composed(frames, cfg, o.fc), (n, n))
    b = rows.run(full_fn, (n, n))
    rows.add("composed_equal", all(torch.equal(x, y) for x, y in zip(a, b)))
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
