"""Micro-benchmarks of the ORB frontend's stages (port of
tools/stage_bench.py).

Times current and candidate implementations of the hot ORB stages, and
the cumulative ablation of detect_and_compute (pyramid -> +fast -> +topk
-> +harris -> +orientation -> full), on B = 8 KITTI-style 1241x376
frames, 8 levels, 1200 keypoints. Times are CUDA-event means in ms per
frame, each line tagged with the card's name and power limit. The
ablation runs kernel B3 through features/fast.detect_levels, one launch
per pyramid, in its +fast ... +orientation stages (4 launches a pass),
and kernels B1 and B2 in its full stage.

    python -m tpu_vo_torch.tools.stage_bench [blur|orientation|topk|ablate ...]

It runs on the card and raises without one (main(device="cpu") runs on
the CPU, timed by the host clock).
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import fast, orb, orientation
from tpu_vo_torch.features.fast import _border_mask
from tpu_vo_torch.features.orb import _stable_topk, features_per_level
from tpu_vo_torch.image.filters import gaussian_blur, gaussian_kernel_1d
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.utils import profiling

H, W = 376, 1241
B = 8  # frames per call, as the pipeline batches them
CFG = ORBConfig()
WARMUP, ITERS = 3, 20  # calls of a stage before and while it is timed


def make_frames(b: int, h: int, w: int, device) -> torch.Tensor:
    """(b, h, w) uint8 uniform noise from numpy's seed 0, on `device`."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 255, size=(b, h, w), dtype=np.uint8)).to(device)


def make_levels(frames: torch.Tensor, cfg: ORBConfig = CFG):
    return [lv.contiguous() for lv in build_pyramid(frames.to(torch.float32), cfg.n_levels,
                                                    cfg.scale_factor)]


def _budgets(cfg: ORBConfig):
    return features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)


def _ms_per_frame(fn, b: int, device: torch.device, iters: int = ITERS,
                  warmup: int = WARMUP) -> float:
    """Mean ms per frame of fn() over `iters` calls after `warmup`: CUDA
    events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        return profiling.cuda_times(fn, warmup=warmup, reps=1, iters=iters)[0] / b
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters / b


# ---------------------------------------------------------------- blur

def _reflect101_matrix(n: int, k: np.ndarray) -> np.ndarray:
    ks = len(k)
    pad = ks // 2
    M = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for t in range(ks):
            j = i + t - pad
            if j < 0:
                j = -j
            elif j >= n:
                j = 2 * (n - 1) - j
            M[i, j] += k[t]
    return M


@functools.lru_cache(maxsize=None)
def _blur_mats(h: int, w: int, ksize: int, sigma: float, device: torch.device):
    k = gaussian_kernel_1d(ksize, sigma)
    return (torch.as_tensor(_reflect101_matrix(h, k), device=device),
            torch.as_tensor(_reflect101_matrix(w, k), device=device))


def gaussian_blur_matmul(img, ksize=7, sigma=2.0, quantize=True):
    """Candidate: the blur as two banded products, rows then columns, in
    full float32 (the package turns TF32 off)."""
    h, w = img.shape[-2], img.shape[-1]
    Bh, Bw = _blur_mats(h, w, ksize, sigma, img.device)
    x = img.to(torch.float32)
    x = torch.einsum("ij,...jw->...iw", Bh, x)
    x = torch.einsum("...hj,wj->...hw", x, Bw)
    if quantize:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x


def bench_blur(frames, levels, tag):
    def cur():
        return [gaussian_blur(lv) for lv in levels]

    def mm():
        return [gaussian_blur_matmul(lv) for lv in levels]

    b, dev = frames.shape[0], frames.device
    t_cur = _ms_per_frame(cur, b, dev)
    t_mm = _ms_per_frame(mm, b, dev)
    dmax = max(float((x - y).abs().max()) for x, y in zip(cur(), mm()))
    print(f"blur: shift-add {t_cur:.3f} ms  matmul {t_mm:.3f} ms  max|diff| {dmax} [{tag}]")


# ---------------------------------------------------------- orientation

def select_keypoints(levels, cfg: ORBConfig = CFG):
    """FAST + Harris selection per level (the part before orientation):
    (ys, xs, valid) of the dense route, (B, n_level) each."""
    out = []
    for lv, n, det in zip(levels, _budgets(cfg), fast.detect_levels(levels, cfg.fast_threshold)):
        ys, xs, _, valid = orb._select_level_keypoints(lv, n, cfg, det)
        out.append((ys, xs, valid))
    return out


def orientation_flat(levels, kps):
    """Candidate: one flat gather per frame across levels for the
    prefix-sum ends; (B, sum of N) angles."""
    _, _, _, v, d = orientation._circle_tables(levels[0].device)
    pad = torch.nn.functional.pad
    flats, idx0, idx1, xs_all = [], [], [], []
    base = 0
    for lvl, (ys, xs, _) in zip(levels, kps):
        b, h, w = lvl.shape
        ii = torch.round(lvl).to(torch.int32)
        x_idx = torch.arange(w, dtype=torch.int32, device=lvl.device)
        p0 = pad(torch.cumsum(ii, -1, dtype=torch.int32), (1, 0))
        p1 = pad(torch.cumsum(ii * x_idx, -1, dtype=torch.int32), (1, 0))
        flats.append(torch.stack([p0, p1], 1).view(b, -1))       # (B, 2*h*(w+1))
        ys = ys.to(torch.int64)[..., None]
        xs = xs.to(torch.int64)[..., None]
        r = torch.clamp(ys + v, 0, h - 1) * (w + 1)
        hi = torch.clamp(xs + d + 1, 0, w)
        lo = torch.clamp(xs - d, 0, w)
        stride = h * (w + 1)
        idx0.append(torch.cat([base + r + hi, base + r + lo], -1))           # (B, N, 62)
        idx1.append(torch.cat([base + stride + r + hi, base + stride + r + lo], -1))
        xs_all.append(xs[..., 0])
        base += 2 * stride
    flat = torch.cat(flats, 1)
    idx = torch.cat([torch.cat(idx0, 1), torch.cat(idx1, 1)], -1)            # (B, Ntot, 124)
    g = torch.gather(flat, 1, idx.view(idx.shape[0], -1)).view(idx.shape)
    n31 = 2 * orientation.HALF_PATCH + 1
    s0 = g[..., :n31] - g[..., n31:2 * n31]
    s1 = g[..., 2 * n31:3 * n31] - g[..., 3 * n31:]
    xs_cat = torch.cat(xs_all, 1).to(torch.int32)
    m10 = (s1 - xs_cat[..., None] * s0).sum(-1)
    m01 = (v.to(torch.int32) * s0).sum(-1)
    return orientation.fast_atan2_deg(m01.to(torch.float32), m10.to(torch.float32))


def orientation_per_level(levels, kps):
    """Current: ic_angles_prefix per level, concatenated."""
    return torch.cat([orientation.ic_angles_prefix(lv, ys, xs)
                      for lv, (ys, xs, _) in zip(levels, kps)], 1)


def bench_orientation(frames, levels, tag):
    kps = select_keypoints(levels)
    b, dev = frames.shape[0], frames.device
    t_cur = _ms_per_frame(lambda: orientation_per_level(levels, kps), b, dev)
    t_flat = _ms_per_frame(lambda: orientation_flat(levels, kps), b, dev)
    dmax = float((orientation_per_level(levels, kps) - orientation_flat(levels, kps)).abs().max())
    print(f"orientation: per-level {t_cur:.3f} ms  flat {t_flat:.3f} ms  max|diff| {dmax} "
          f"[{tag}]")


# ---------------------------------------------------------------- topk

def scores_per_level(levels, cfg: ORBConfig = CFG):
    """FAST scores at NMS survivors inside the border, 0 elsewhere."""
    outs = []
    for lvl, (score, keep) in zip(levels, fast.detect_levels(levels, cfg.fast_threshold)):
        h, w = lvl.shape[-2:]
        keep = keep & _border_mask(h, w, cfg.edge_threshold, lvl.device)
        outs.append(torch.where(keep, score, torch.zeros((), device=lvl.device)))
    return outs


def topk_current(scores, budgets):
    """The route's own cut: a stable descending sort (lax.top_k's order)."""
    outs = []
    for s, n in zip(scores, budgets):
        b, h, w = s.shape
        outs.append(_stable_topk(s.view(b, -1), min(2 * n, h * w)))
    return outs


def topk_chunked(scores, budgets, n_chunks=16):
    """Exact hierarchical top-k: per-chunk top-k, then top-k of the
    candidates."""
    outs = []
    for s, n in zip(scores, budgets):
        b, h, w = s.shape
        k2 = min(2 * n, h * w)
        flat = s.view(b, -1)
        m = flat.shape[1]
        chunks = torch.nn.functional.pad(flat, (0, (-m) % n_chunks)).view(b, n_chunks, -1)
        v_c, i_c = _stable_topk(chunks, min(k2, chunks.shape[2]))          # (B, c, kk)
        gi = i_c + (torch.arange(n_chunks, device=s.device) * chunks.shape[2])[:, None]
        v, j = _stable_topk(v_c.reshape(b, -1), k2)
        outs.append((v, torch.gather(gi.reshape(b, -1), 1, j)))
    return outs


def topk_packed(scores, budgets):
    """(score << 21) | (m - 1 - idx) as int32 keys, so top-k sorts 32-bit
    keys once: FAST scores are integers <= 254 and an index fits in 21
    bits for <= 2M pixels; ties go to the lowest index first."""
    outs = []
    for s, n in zip(scores, budgets):
        b, h, w = s.shape
        m = h * w
        idx = torch.arange(m, dtype=torch.int32, device=s.device)
        packed = (s.view(b, -1).to(torch.int32) << 21) | (m - 1 - idx)
        v = torch.topk(packed, min(2 * n, m), dim=-1).values
        outs.append(((v >> 21).to(torch.float32), (m - 1) - (v & ((1 << 21) - 1))))
    return outs


def topk_variants(budgets):
    return {
        "current": lambda s: topk_current(s, budgets),
        "chunk8": lambda s: topk_chunked(s, budgets, 8),
        "chunk32": lambda s: topk_chunked(s, budgets, 32),
        "chunk128": lambda s: topk_chunked(s, budgets, 128),
        "packed": lambda s: topk_packed(s, budgets),
    }


def bench_topk(frames, levels, tag):
    scores = scores_per_level(levels)
    b, dev = frames.shape[0], frames.device
    ref = None
    for name, fn in topk_variants(_budgets(CFG)).items():
        t = _ms_per_frame(lambda fn=fn: fn(scores), b, dev)
        vs = torch.cat([v for v, _ in fn(scores)], -1)
        ref = vs if ref is None else ref
        print(f"topk[{name}]: {t:.3f} ms  values-match={bool(torch.equal(vs, ref))} [{tag}]")


# ------------------------------------------------------------- ablation

def ablation_stages(cfg: ORBConfig = CFG):
    """The cumulative sub-pipelines of detect_and_compute on (B, H, W)
    uint8 frames, as (name, fn(frames)) pairs."""
    budgets = _budgets(cfg)

    def pyramid(img):
        return make_levels(img, cfg)

    def thru_fast(img):
        return [score for score, _ in fast.detect_levels(pyramid(img), cfg.fast_threshold)]

    def thru_topk(img):
        return topk_current(scores_per_level(pyramid(img), cfg), budgets)

    def thru_harris(img):
        return select_keypoints(pyramid(img), cfg)

    def thru_orientation(img):
        ls = pyramid(img)
        return orientation_per_level(ls, select_keypoints(ls, cfg))

    def full(img):
        return orb.detect_and_compute(img, cfg)

    return [("pyramid", pyramid), ("+fast", thru_fast), ("+topk", thru_topk),
            ("+harris", thru_harris), ("+orientation", thru_orientation), ("full", full)]


def bench_ablate(frames, levels, tag):
    """Print and return [(stage, ms per frame)] of the ablation."""
    out = []
    prev = 0.0
    for name, f in ablation_stages():
        t = _ms_per_frame(lambda f=f: f(frames), frames.shape[0], frames.device)
        print(f"ablate[{name}]: {t:.3f} ms (delta {t - prev:+.3f}) [{tag}]", flush=True)
        out.append((name, t))
        prev = t
    return out


STAGES = {"blur": bench_blur, "orientation": bench_orientation, "topk": bench_topk,
          "ablate": bench_ablate}


def main(argv=None, device=None) -> None:
    which = list(sys.argv[1:] if argv is None else argv) or list(STAGES)
    unknown = [s for s in which if s not in STAGES]
    if unknown:
        raise SystemExit(f"unknown stage(s) {unknown}; choose from {list(STAGES)}")
    dev = entry_device(device)
    tag = profiling.card() if dev.type == "cuda" else "cpu, host clock"
    frames = make_frames(B, H, W, dev)
    levels = make_levels(frames)
    print(f"device={dev.type} levels={[tuple(lv.shape) for lv in levels]} [{tag}]", flush=True)
    for name in which:
        STAGES[name](frames, levels, tag)


if __name__ == "__main__":
    main()
