"""A/B of dense in-kernel Harris against Harris per candidate from the
window kernel (port of tools/harris_candidate_probe.py).

Kernel B1 computes Harris densely, although stage 2 ranks only the <= 2n
stage-1 survivors a level. The proposal: drop dense Harris from B1 and
compute it per candidate from B2's windows. With the candidates' windows
reused for the winners, the net gain is

    net = S + P1 - (P2 + Hc)
      S   select_maps with Harris - without it (B1's two instances): the
          dense-Harris share
      P1  B2 at n_level winners a level (saved by the reuse)
      P2  B2 at 2 n_level candidates a level (the new cost)
      Hc  Harris at the window centre from the candidates' windows
          (center_harris_from_patches, plain torch)

and the verdict is KEEP when net > 0.15 of select_maps with Harris.

Rows (the JAX tool's): select_with_harris_ms, select_no_harris_ms,
dense_harris_share_ms, patches_winners_ms, patches_candidates_ms,
center_harris_ms, net_win_ms, verdict, each over 8 calls a level of
select_maps and extract_patches on one 1241x376 pyramid of uniform noise
(numpy's default_rng(0)), 1200 keypoints; and the same rows in the
pipeline's form, marked _levels: one select_maps_levels launch and one
extract_patches_levels launch for all 8 levels. Timed rows as
tools/profile_rows says (CUDA-event ms, reps x iters calls); the derived
rows are their differences; on the CPU every device figure reads "not
measured" and so do the verdicts. At one frame a call is mostly the
wrapper's host work, so the rows `<name>_levels_kernel_ms` add the
kernels' own device time (torch.profiler's median over reps launches)
of B1's two instances and of B2 at 1x and 2x, and
dense_harris_share_levels_kernel_ms their difference for B1.

    python -m tpu_vo_torch.tools.harris_candidate_probe [--reps 256 --iters 3]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.features.orb import features_per_level
from tpu_vo_torch.ops.patch import extract_patches, extract_patches_levels
from tpu_vo_torch.ops.select import select_maps, select_maps_levels
from tpu_vo_torch.tools import profile_rows
from tpu_vo_torch.tools.profile_rows import NOT_ON_CARD
from tpu_vo_torch.utils.profiling import kernel_alone_ms

DEFAULTS = dict(width=1241, height=376, features=1200, reps=256, iters=3)
KERNELS = ("select_maps", "extract_patches", "select_maps_no_harris")
THRESHOLD, BORDER = 10, 31
KEEP = "KEEP: candidate Harris wins"
NEGATIVE = "NEGATIVE: dense in-kernel Harris stays"
# B1's two instances as the profiler names them (demangled or not)
SELECT_KERNEL = {True: ("select_kernel<true>", "select_kernelILb1E"),
                 False: ("select_kernel<false>", "select_kernelILb0E")}


def _pyramid_shapes(W, H, n_levels=8, sf=1.2):
    shapes = []
    for lv in range(n_levels):
        s = 1.0 / (sf ** lv)
        shapes.append((int(round(H * s)), int(round(W * s))))
    return shapes


def center_harris_from_patches(raw: torch.Tensor) -> torch.Tensor:
    """Harris response at the window centre, (k, 43, 43) windows -> (k,).

    features/harris.harris_at's arithmetic on the 11x11 neighbourhood of
    the 43x43 window's centre (21, 21) that the Sobel and the 7x7 box
    need."""
    win = raw[:, 16:27, 16:27].to(torch.float32)   # (k, 11, 11)

    def at(dy, dx):
        return win[:, 1 + dy:10 + dy, 1 + dx:10 + dx]  # (k, 9, 9)

    Ix = ((at(0, 1) - at(0, -1)) * 2.0
          + (at(-1, 1) - at(-1, -1)) + (at(1, 1) - at(1, -1)))
    Iy = ((at(1, 0) - at(-1, 0)) * 2.0
          + (at(1, -1) - at(-1, -1)) + (at(1, 1) - at(-1, 1)))
    a = torch.sum((Ix * Ix)[:, 1:8, 1:8], dim=(1, 2))
    b = torch.sum((Iy * Iy)[:, 1:8, 1:8], dim=(1, 2))
    c = torch.sum((Ix * Iy)[:, 1:8, 1:8], dim=(1, 2))
    scale4 = float(np.float32((1.0 / ((1 << 2) * 7 * 255.0)) ** 4))
    return (a * b - c * c - 0.04 * (a + b) * (a + b)) * scale4


def _derived(rows, name, value):
    """A row computed from timed rows: ms on the card, host_ms on the CPU."""
    key = "ms" if rows.on_card else "host_ms"
    return rows.add(name, {key: value} if rows.on_card else {"ms": NOT_ON_CARD, key: value})


def _verdict(rows, suffix, t):
    """The derived rows and the verdict from timed rows t (S, P1, P2, Hc
    and select_with_harris)."""
    S = t["with"] - t["without"]
    Hc = max(t["hc"] - t["P2"], 0.0)
    net = S + t["P1"] - (t["P2"] + Hc)
    _derived(rows, f"dense_harris_share{suffix}_ms", S)
    _derived(rows, f"center_harris{suffix}_ms", Hc)
    _derived(rows, f"net_win{suffix}_ms", net)
    verdict = (KEEP if net > 0.15 * t["with"] else NEGATIVE) if rows.on_card else NOT_ON_CARD
    rows.add(f"verdict{suffix}", verdict)
    return net


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    rows = profile_rows.Rows("harris_candidate_probe", o, kernels=KERNELS)
    dev = o.device
    key = "ms" if rows.on_card else "host_ms"
    shapes = _pyramid_shapes(o.width, o.height)
    budgets = features_per_level(o.features, 8, 1.2)
    rng = np.random.default_rng(0)
    levels = [torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32))[None].to(dev)
              for h, w in shapes]
    n = len(levels)
    t = dict(reps=o.reps, iters=o.iters)

    def slots(mult):
        out = []
        for (h, w), n_level in zip(shapes, budgets):
            k = min(mult * n_level, h * w)
            ys = torch.from_numpy(rng.integers(31, h - 31, k).astype(np.int32))[None].to(dev)
            xs = torch.from_numpy(rng.integers(31, w - 31, k).astype(np.int32))[None].to(dev)
            out.append((ys, xs))
        return out

    def cat(sl):
        offs = np.cumsum([0] + [ys.shape[1] for ys, _ in sl])[:-1].tolist()
        return (torch.cat([ys for ys, _ in sl], 1).contiguous(),
                torch.cat([xs for _, xs in sl], 1).contiguous(), offs)

    def select_all(with_harris):
        return lambda: [select_maps(lvl, THRESHOLD, BORDER, with_harris=with_harris)
                        for lvl in levels]

    def patches(sl):
        return lambda: [extract_patches(lvl, ys, xs) for lvl, (ys, xs) in zip(levels, sl)]

    def patches_hc(sl):
        return lambda: [center_harris_from_patches(extract_patches(lvl, ys, xs)[0])
                        for lvl, (ys, xs) in zip(levels, sl)]

    per = {"with": rows.time("select_with_harris_ms", select_all(True), launches=(n, 0, 0), **t),
           "without": rows.time("select_no_harris_ms", select_all(False), launches=(n, 0, n),
                                **t)}
    slots1, slots2 = slots(1), slots(2)
    per["P1"] = rows.time("patches_winners_ms", patches(slots1), launches=(0, n, 0), **t)
    per["P2"] = rows.time("patches_candidates_ms", patches(slots2), launches=(0, n, 0), **t)
    per["hc"] = rows.time("patches_candidates_center_harris_ms", patches_hc(slots2),
                          launches=(0, n, 0), **t)
    _verdict(rows, "", {k: v[key] for k, v in per.items()})

    ys1, xs1, off1 = cat(slots1)
    ys2, xs2, off2 = cat(slots2)

    def levels_hc():
        raw = extract_patches_levels(levels, ys2, xs2, off2)
        return center_harris_from_patches(raw[0])

    lv = {"with": rows.time("select_with_harris_levels_ms",
                            lambda: select_maps_levels(levels, THRESHOLD, BORDER),
                            launches=(1, 0, 0), **t),
          "without": rows.time("select_no_harris_levels_ms",
                               lambda: select_maps_levels(levels, THRESHOLD, BORDER,
                                                          with_harris=False),
                               launches=(1, 0, 1), **t),
          "P1": rows.time("patches_winners_levels_ms",
                          lambda: extract_patches_levels(levels, ys1, xs1, off1),
                          launches=(0, 1, 0), **t),
          "P2": rows.time("patches_candidates_levels_ms",
                          lambda: extract_patches_levels(levels, ys2, xs2, off2),
                          launches=(0, 1, 0), **t),
          "hc": rows.time("patches_candidates_center_harris_levels_ms", levels_hc,
                          launches=(0, 1, 0), **t)}
    _verdict(rows, "_levels", {k: v[key] for k, v in lv.items()})

    # the two instances of B1 and B2's launches alone on the device (no
    # host work): what the card spends on dense Harris at these shapes
    alone = {}
    for name, fn, kernel, launches in (
            ("select_with_harris_levels", lambda: select_maps_levels(levels, THRESHOLD, BORDER),
             SELECT_KERNEL[True], (1, 0, 0)),
            ("select_no_harris_levels", lambda: select_maps_levels(
                levels, THRESHOLD, BORDER, with_harris=False), SELECT_KERNEL[False], (1, 0, 1)),
            ("patches_winners_levels", lambda: extract_patches_levels(levels, ys1, xs1, off1),
             "extract_kernel", (0, 1, 0)),
            ("patches_candidates_levels", lambda: extract_patches_levels(levels, ys2, xs2, off2),
             "extract_kernel", (0, 1, 0))):
        if rows.on_card:
            ms = kernel_alone_ms(rows.counted(fn, launches), kernel, o.reps)
            alone[name] = ms
            rows.add(f"{name}_kernel_ms", {"ms": NOT_ON_CARD if ms is None else ms})
        else:
            rows.add(f"{name}_kernel_ms", {"ms": NOT_ON_CARD})
    if rows.on_card and None not in alone.values():
        rows.add("dense_harris_share_levels_kernel_ms",
                 {"ms": alone["select_with_harris_levels"] - alone["select_no_harris_levels"]})
    else:
        rows.add("dense_harris_share_levels_kernel_ms", {"ms": NOT_ON_CARD})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
