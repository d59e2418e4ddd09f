"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from tpu_vo_torch/csrc (nvcc, sm_90a);
  3. compare each kernel with its plain PyTorch version on the card:
     select_maps (B1) at the 8 pyramid-level shapes of 1241x376 frames,
     extract_patches (B2) on one frame's 1200 keypoints and on a level
     smaller than the 43x43 window; both must agree bit for bit;
  4. drive the main path, run_sequence_batched on a (32, 376, 1241) uint8
     synthetic sequence with 1200 keypoints and 256-hypothesis 5-point
     RANSAC, with the kernels' launch counters reset just before; check
     that both kernels launched, the poses are finite and the trajectory
     is accurate, and that a small sequence gives the same answer on the
     card as on the CPU;
  5. time the main path, its three stages and each kernel beside its
     plain version with CUDA events (medians after warm-up);
  6. profile each stage and the main path with torch.profiler: device
     busy time, kernel launches, host-device copies and stream
     synchronizations per run, and the top device time.

The line before the last is a JSON object with the kernels' names,
sources, launch counts, errors and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpu_vo_torch.configs import ORBConfig, RansacConfig, VOConfig  # noqa: E402
from tpu_vo_torch.features import orb  # noqa: E402
from tpu_vo_torch.image.pyramid import build_pyramid  # noqa: E402
from tpu_vo_torch.ops import _build  # noqa: E402
from tpu_vo_torch.ops.patch import extract_patches, extract_patches_reference  # noqa: E402
from tpu_vo_torch.ops.select import select_maps, select_maps_reference  # noqa: E402
from tpu_vo_torch.pipeline import runner, step  # noqa: E402
from tpu_vo_torch.utils.synthetic import make_sequence  # noqa: E402

W, H, T = 1241, 376, 32
SMALL_W, SMALL_H, SMALL_T = 480, 360, 8
# Accuracy bars of the main path on make_sequence(32, 1241, 376, seed=0),
# measured on the CPU on these frames: the port had pose_ok on 31/31 pairs
# and a mean per-pair rotation error of 0.833 deg (max 2.26), the JAX
# runner 31/31 and 0.812 deg (max 2.07). The bound leaves room for the
# card's other rounding.
MIN_POSE_OK = 0.7
MAX_MEAN_PAIR_ROT_ERR_DEG = 1.5
WARMUP, REPS, MAIN_REPS, PROFILE_RUNS = 2, 5, 20, 3
# CUDA runtime calls that make the host wait for the card
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
               "cudaMemcpy")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _cuda_times(fn, warmup=WARMUP, reps=REPS) -> list:
    """Milliseconds of each of `reps` calls of fn() by CUDA events, after
    warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _cuda_ms(fn) -> float:
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    return statistics.median(_cuda_times(fn))


def _pair_rot_err_deg(R_wc: np.ndarray, Rs_gt) -> np.ndarray:
    """Geodesic error (deg) of each consecutive relative rotation."""
    errs = []
    for i in range(len(Rs_gt) - 1):
        est = R_wc[i].T @ R_wc[i + 1]
        gt = Rs_gt[i].T @ Rs_gt[i + 1]
        c = (np.trace(est.T @ gt) - 1.0) / 2.0
        errs.append(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    return np.asarray(errs)


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in the same unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _profile(name, fn, card, rows=0):
    """Profile PROFILE_RUNS calls of fn() after warm-up; print per run the
    host time, the device busy time (union of device intervals), device
    operations, host-to-device and device-to-host copies and the runtime
    calls that wait for the card; with rows, the top device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_RUNS):
            with record_function(name):
                fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev_ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != name and not getattr(e, "is_user_annotation", False)]
    busy = _busy_ms([(k.time_range.start, k.time_range.end) for k in dev_ops]) / 1e3

    def per_run(pred, evs):
        return sum(1 for e in evs if pred(e.name)) / PROFILE_RUNS

    h2d = per_run(lambda n: "HtoD" in n, dev_ops)
    d2h = per_run(lambda n: "DtoH" in n, dev_ops)
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    waits = {c: per_run(lambda n, c=c: n == c, host) for c in _SYNC_CALLS}
    print(f"profile {name}: {wall_ms / PROFILE_RUNS:.3f} ms per run (host clock, profiler "
          f"on), device busy {busy / PROFILE_RUNS:.3f} ms = {100.0 * busy / wall_ms:.1f}%, "
          f"{len(dev_ops) / PROFILE_RUNS:.0f} device ops, {h2d:.0f} HtoD and {d2h:.0f} DtoH "
          f"copies, waits {waits} per run [{card}]", flush=True)
    if rows:
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=rows,
                                        max_name_column_width=60), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.BuildInfo.seconds:.2f} s) "
          f"-> {_build.BuildInfo.path}", flush=True)
    print(_build.BuildInfo.log.strip(), flush=True)

    cfg = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=1200),
                   ransac=RansacConfig(max_iters=256))
    ocfg = cfg.orb
    frames_np, Rs_gt, _, _ = make_sequence(n_frames=T, width=W, height=H, seed=0)
    frames = torch.from_numpy(np.stack(frames_np)).to(dev)

    # 3. kernels against their plain versions, on the card
    levels = [lv.contiguous() for lv in build_pyramid(frames, ocfg.n_levels, ocfg.scale_factor)]
    budgets = orb.features_per_level(ocfg.n_features, ocfg.n_levels, ocfg.scale_factor)
    sel_err = 0.0
    kps = []
    for lvl, n_level in zip(levels, budgets):
        pk, hk, bk = select_maps(lvl, ocfg.fast_threshold, ocfg.edge_threshold)
        pr, hr, br = select_maps_reference(lvl, ocfg.fast_threshold, ocfg.edge_threshold)
        torch.cuda.synchronize()
        if bk != br or not torch.equal(pk, pr) or not torch.equal(hk, hr):
            raise AssertionError(f"select_maps differs from its plain version at "
                                 f"{tuple(lvl.shape)}: packed {int((pk != pr).sum())} "
                                 f"cells, harris max {float((hk - hr).abs().max())}")
        sel_err = max(sel_err, float((hk - hr).abs().max()), float((pk - pr).abs().max()))
        kps.append(orb._rank_from_maps(pk, hk, bk, lvl.shape[-1], n_level, ocfg,
                                       lvl.shape[-2] * lvl.shape[-1]))
    print(f"select_maps == plain at {[tuple(lv.shape) for lv in levels]}", flush=True)

    patch_err = 0.0
    n_kp = 0
    for lvl, (ys, xs, _, _) in zip(levels, kps):
        ys0, xs0 = ys[:1].contiguous(), xs[:1].contiguous()
        n_kp += ys0.shape[1]
        a = extract_patches(lvl[:1], ys0, xs0)
        b = extract_patches_reference(lvl[:1], ys0, xs0)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"extract_patches differs at {tuple(lvl.shape)}")
        patch_err = max(patch_err, float((a - b).abs().max()))
    g = torch.Generator().manual_seed(0)
    tiny = torch.randint(0, 256, (2, 30, 60), generator=g).float().to(dev)
    tys = torch.randint(-5, 35, (2, 17), generator=g, dtype=torch.int32).to(dev)
    txs = torch.randint(-5, 65, (2, 17), generator=g, dtype=torch.int32).to(dev)
    if not torch.equal(extract_patches(tiny, tys, txs), extract_patches_reference(tiny, tys, txs)):
        raise AssertionError("extract_patches differs on a level smaller than the window")
    print(f"extract_patches == plain on {n_kp} keypoints of one frame and a 30x60 level",
          flush=True)

    # 4. the main path, counted
    select_maps.launches = 0
    extract_patches.launches = 0
    poses, diags = runner.run_sequence_batched(frames, cfg, seed=0)
    torch.cuda.synchronize()
    launches = {"select_maps": select_maps.launches,
                "extract_patches": extract_patches.launches}
    print(f"main path launches: {launches}", flush=True)
    if launches["select_maps"] < ocfg.n_levels or launches["extract_patches"] < 1:
        raise AssertionError(f"main path did not go through the kernels: {launches}")
    if not (torch.isfinite(poses.R).all() and torch.isfinite(poses.t).all()):
        raise AssertionError("non-finite poses")
    pose_ok = float(diags["pose_ok"].float().mean())
    rot = _pair_rot_err_deg(poses.R.double().cpu().numpy(), Rs_gt)
    print(f"pose_ok {pose_ok:.3f}, mean per-pair rotation error {rot.mean():.4f} deg "
          f"(max {rot.max():.4f}), keypoints/frame "
          f"{diags['num_keypoints'].float().mean().item():.1f}", flush=True)
    if pose_ok < MIN_POSE_OK or not rot.mean() < MAX_MEAN_PAIR_ROT_ERR_DEG:
        raise AssertionError("main path accuracy below its bar")

    small_np, small_gt, _, _ = make_sequence(n_frames=SMALL_T, width=SMALL_W,
                                             height=SMALL_H, seed=3)
    small = torch.from_numpy(np.stack(small_np))
    scfg = VOConfig(image_width=SMALL_W, image_height=SMALL_H)
    pc, dc = runner.run_sequence_batched(small, scfg, seed=0)
    pg, dg = runner.run_sequence_batched(small.to(dev), scfg, seed=0)
    rc = _pair_rot_err_deg(pc.R.double().numpy(), small_gt)
    rg = _pair_rot_err_deg(pg.R.double().cpu().numpy(), small_gt)
    dev_rot = _pair_rot_err_deg(pg.R.double().cpu().numpy(), list(pc.R.double().numpy()))
    kp_agree = float((dg["num_keypoints"].cpu() == dc["num_keypoints"]).float().mean())
    print(f"small sequence, card vs CPU: pose_ok {float(dg['pose_ok'].float().mean()):.3f} vs "
          f"{float(dc['pose_ok'].float().mean()):.3f}, rotation error vs truth "
          f"{rg.mean():.4f} vs {rc.mean():.4f} deg, per-pair rotation difference "
          f"max {dev_rot.max():.4f} deg, keypoint counts equal on {kp_agree:.3f} of frames",
          flush=True)
    if not (float(dg["pose_ok"].float().mean()) >= MIN_POSE_OK and rg.mean() < rc.mean() + 0.5):
        raise AssertionError("the card and the CPU disagree on the small sequence")

    # 5. times
    def main_path():
        return runner.run_sequence_batched(frames, cfg, seed=0)

    def stage1():
        return orb.detect_and_compute(frames, ocfg)

    feats = stage1()
    prev = orb.ORBFeatures(*(f[:-1] for f in feats))
    cur = orb.ORBFeatures(*(f[1:] for f in feats))

    def stage2():
        return step.estimate_pair(prev, cur, cfg,
                                  generators=runner.pair_generators(0, range(1, T)))

    est = stage2()

    def stage3():
        return runner.chain_relative_poses(est["R"], est["t"], est["have_rt"],
                                           est["pose_ok"], cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    main_path()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    main_times = _cuda_times(main_path, reps=MAIN_REPS)
    ms_main = statistics.median(main_times)
    q1, _, q3 = statistics.quantiles(main_times, n=4)
    ms_s1, ms_s2, ms_s3 = (_cuda_ms(f) for f in (stage1, stage2, stage3))
    thr, border = ocfg.fast_threshold, ocfg.edge_threshold
    sel_ms = sum(_cuda_ms(lambda lv=lv: select_maps(lv, thr, border)) for lv in levels)
    sel_plain = sum(_cuda_ms(lambda lv=lv: select_maps_reference(lv, thr, border))
                    for lv in levels)
    kp = [(ys.contiguous(), xs.contiguous()) for ys, xs, _, _ in kps]
    pat_ms = sum(_cuda_ms(lambda lv=lv, k=k: extract_patches(lv, *k)) for lv, k in zip(levels, kp))
    pat_plain = sum(_cuda_ms(lambda lv=lv, k=k: extract_patches_reference(lv, *k))
                    for lv, k in zip(levels, kp))
    tag = f"[{card}]"
    print(f"main path: {T} frames in {ms_main:.3f} ms (median of {MAIN_REPS}, quartiles "
          f"{q1:.3f}-{q3:.3f} ms) = {T * 1000.0 / ms_main:.2f} frames/s, peak device memory "
          f"{peak_gib:.3f} GiB {tag}")
    print(f"stage 1 features {ms_s1:.3f} ms, stage 2 pairs {ms_s2:.3f} ms, "
          f"stage 3 chain {ms_s3:.3f} ms {tag}")
    print(f"select_maps 8 levels x {T} frames: kernel {sel_ms:.3f} ms, plain {sel_plain:.3f} ms {tag}")
    print(f"extract_patches 1200 kps x {T} frames: kernel {pat_ms:.3f} ms, plain {pat_plain:.3f} ms {tag}")

    # 6. profile
    for name, fn in (("stage1_features", stage1), ("stage2_pairs", stage2),
                     ("stage3_chain", stage3)):
        _profile(name, fn, card)
    _profile("main_path", main_path, card, rows=25)

    report = {"kernels": [
        {"name": "select_maps", "route": "cuda", "source": "tpu_vo_torch/csrc/select.cu",
         "replaces": "tpu_vo/ops/select_pallas.py:359", "launches": launches["select_maps"],
         "max_abs_err": sel_err, "ms": sel_ms, "plain_ms": sel_plain},
        {"name": "extract_patches", "route": "cuda", "source": "tpu_vo_torch/csrc/patch.cu",
         "replaces": "tpu_vo/ops/patch_pallas.py:181",
         "launches": launches["extract_patches"], "max_abs_err": patch_err,
         "ms": pat_ms, "plain_ms": pat_plain},
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
