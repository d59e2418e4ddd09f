"""Where the stage-1 pool and top-k time goes, and what exact alternatives
cost (port of tools/topk_micro.py).

On the JAX tool's synthetic level-0 packed map (188 x 1280 int32, about 3%
survivors, numpy's default_rng(0); made on the host, so no kernel runs),
K2 = 706 (2 x level 0's budget of 1200 keypoints), in torch:

  pool_flat      view (h, w/2, 2), amax(-1), flatten: the 1x2 pool
  flat_only      flatten of the pooled map (a view: it launches nothing)
  topk_1d        torch.topk over the flat map (the production cut)
  topk_2d        exact two-stage: top-min(K2, w) per row, then of the union
  topk_rowband   exact two-stage over 4 row bands
  approx_f32     no counterpart (below)
  sort_1d        torch.sort of the whole map (the upper bound)

and whether topk_2d and topk_rowband give topk_1d's values (the keys
are unique nonzero ints, so values decide). Rows as tools/profile_rows
says.

    python -m tpu_vo_torch.tools.topk_micro [--reps 1024 --iters 5]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(height=188, width=1280, k=706, reps=1024, iters=5)
APPROX = ("not ported: ApproxTopK is a TPU device (lax.approx_max_k); the port always takes "
          "the exact stage-1 cut (stage1_exact_topk=False is not ported)")


def packed_map(h: int, wp: int, seed: int = 0):
    """(packed (h, wp) int32 with ~3% nonzero keys, pooled (h, wp/2))."""
    rng = np.random.default_rng(seed)
    dense = rng.integers(1, 2**28, (h, wp), dtype=np.int32)
    mask = rng.random((h, wp)) < 0.03
    packed = np.where(mask, dense, 0).astype(np.int32)
    pairs = packed.reshape(h, wp // 2, 2)
    return packed, np.maximum(pairs[:, :, 0], pairs[:, :, 1])


def pool_flat(p):
    h, wp = p.shape
    return p.view(h, wp // 2, 2).amax(-1).reshape(-1)


def flat_only(p2):
    return p2.reshape(-1)


def topk_1d(p2, k):
    return torch.topk(p2.reshape(-1), k).values


def topk_2d(p2, k):
    vr = torch.topk(p2, min(k, p2.shape[1]), dim=-1).values
    return torch.topk(vr.reshape(-1), k).values


def topk_rowband(p2, k, bands: int = 4):
    hpad = -(-p2.shape[0] // bands) * bands
    q = torch.nn.functional.pad(p2, (0, 0, 0, hpad - p2.shape[0])).reshape(bands, -1)
    vr = torch.topk(q, k, dim=-1).values
    return torch.topk(vr.reshape(-1), k).values


def sort_1d(p2):
    return torch.sort(p2.reshape(-1)).values


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("topk_micro", o)
    packed_np, pooled_np = packed_map(o.height, o.width)
    packed = torch.from_numpy(packed_np).to(o.device)
    pooled = torch.from_numpy(np.ascontiguousarray(pooled_np)).to(o.device)
    k = o.k
    t = dict(reps=o.reps, iters=o.iters)
    rows.add("shape", {"packed": [o.height, o.width], "k": k,
                       "survivors": int((packed_np != 0).sum())})
    rows.time("pool_flat", lambda: pool_flat(packed), **t)
    rows.time("flat_only", lambda: flat_only(pooled), **t)
    rows.time("topk_1d", lambda: topk_1d(pooled, k), **t)
    rows.time("topk_2d", lambda: topk_2d(pooled, k), **t)
    rows.time("topk_rowband", lambda: topk_rowband(pooled, k), **t)
    rows.add("approx_f32", APPROX)
    rows.time("sort_1d", lambda: sort_1d(pooled), **t)
    t1 = topk_1d(pooled, k)
    rows.add("topk_2d_exact", bool(torch.equal(topk_2d(pooled, k), t1)))
    rows.add("topk_rowband_exact", bool(torch.equal(topk_rowband(pooled, k), t1)))
    rows.add("pool_flat_exact", bool(torch.equal(pool_flat(packed), flat_only(pooled))))
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
