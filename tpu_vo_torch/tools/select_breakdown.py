"""The production selection stage split per pyramid level (port of
tools/select_breakdown.py).

One 1241x376 frame of uniform noise (numpy's default_rng(0)), its 8
pyramid levels, ORBConfig(n_features=2000); for each level:

  kernel       kernel B1 on the level alone (ops/select.select_maps,
               one launch a call): FAST, NMS, Harris, packed keys, the
               2-row pool
  pool_topk    stage 1, features/orb._stage1_cut: the 1x2 pool of the
               packed map, flatten and the exact top-k (the pipeline's
               capacity, orb._stage1_size: 4n with keep-ties)
  gather_rank  stage 2, features/orb._rank_keys on pool_topk's keys: the
               positions decoded, the Harris gather, the keep-ties cut
               and the second top-k
  whole        kernel, then features/orb._rank_from_maps (pool_topk and
               gather_rank)
  band         no counterpart: the JAX tool times the HBM band stack that
               feeds its Pallas kernel; B1 stages its tiles inside the
               kernel, so no band stack exists on the card

with their totals, and "select_maps_levels": B1 over all 8 levels in one
launch, the production form. Each row times the pipeline's own function;
the JAX tool's gather_rank is the difference of two timings, the port's
is timed alone. Rows as tools/profile_rows says.

    python -m tpu_vo_torch.tools.select_breakdown [--reps 1024 --iters 3]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import orb
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops.select import select_maps, select_maps_levels
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(width=1241, height=376, features=2000, reps=1024, iters=3)
BAND = ("not ported: B1 stages its tiles in shared memory inside the kernel; the card has no "
        "HBM band stack to time")
# the rows' functions: the pipeline's own stages
pool_topk = orb._stage1_cut
gather_rank = orb._rank_keys


def levels_of(o, device):
    """(levels (1, h, w) float32, budgets) of the tool's noise frame."""
    cfg = ORBConfig(n_features=o.features)
    img = np.random.default_rng(0).integers(0, 255, (o.height, o.width)).astype(np.float32)
    levels = [lv.contiguous() for lv in build_pyramid(
        torch.from_numpy(img)[None].to(device), cfg.n_levels, cfg.scale_factor)]
    return cfg, levels, orb.features_per_level(cfg.n_features, cfg.n_levels,
                                              cfg.scale_factor)


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("select_breakdown", o)
    cfg, levels, budgets = levels_of(o, o.device)
    thr, border = cfg.fast_threshold, cfg.edge_threshold
    t = dict(reps=o.reps, iters=o.iters)
    tot = dict.fromkeys(("kernel", "pool_topk", "gather_rank", "whole"), 0.0)
    key = "ms" if rows.on_card else "host_ms"
    for i, (lvl, n_level) in enumerate(zip(levels, budgets)):
        h, w = lvl.shape[-2:]
        k2 = orb._stage1_size(n_level, cfg, h * w)

        def kernel(lvl=lvl):
            return select_maps(lvl, thr, border)

        packed, hmap, bits = rows.run(kernel, (1, 0))
        v = pool_topk(packed, k2)

        def pool(packed=packed, k2=k2):
            return pool_topk(packed, k2)

        def rank(v=v, hmap=hmap, bits=bits, w=w, n_level=n_level, area=h * w):
            return gather_rank(v, hmap, bits, w, n_level, cfg, area)

        def whole(kernel=kernel, w=w, n_level=n_level, area=h * w):
            p, hm, b = kernel()
            return orb._rank_from_maps(p, hm, b, w, n_level, cfg, area)

        r = {"kernel": rows.time(f"level{i}.kernel", kernel, launches=(1, 0), **t),
             "pool_topk": rows.time(f"level{i}.pool_topk", pool, **t),
             "gather_rank": rows.time(f"level{i}.gather_rank", rank, **t),
             "whole": rows.time(f"level{i}.whole", whole, launches=(1, 0), **t)}
        rows.add(f"level{i}", {"shape": [h, w], "n_level": n_level, "k2": k2, "band": BAND})
        for name in tot:
            tot[name] += r[name][key]
    rows.add("totals", {f"{k}_{key}": v for k, v in tot.items()} | {"band": BAND})
    rows.time("select_maps_levels", lambda: select_maps_levels(levels, thr, border),
              launches=(1, 0), **t, levels=len(levels))
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
