"""The benchmark's configurations 1, 2, 4 and 5 on the port (port of
benchmarks/run_benchmarks.py, those configs), on the card:

  1. corridor 640x480, 1000 keypoints, 96 frames (frame_chunk 8, pair_chunk T - 1);
  2. corridor 1241x376, 2000 keypoints, 64 frames (frame_chunk 8, pair_chunk 9);
  4. 8 corridor sequences (seeds 0-7) of 64 frames at 640x480, 1000
     keypoints, through parallel/sharding.run_batch_of_sequences on one
     card (frame_chunk 8, pair_chunk 56: the first of the JAX harness's
     ladders (8, 4, 2, 1) and (56, 9, 7, 3, 1) that divides B*T and B*(T-1));
  5. corridor 640x480, 1000 keypoints, 32 frames: features, pairs, then
     models/refinement.refine_window (6 LM iterations) over every pair's
     RANSAC inliers before the chain.

    python -m tpu_vo_torch.tools.run_benchmarks [--configs 1,2,4,5] [--frames T]
        [--out PATH] [--device cpu] [--workers N]

Each config prints one JSON line: frames/s (median of the timed runs by
CUDA events; the host clock with --device cpu), the card's name and power
limit, then utils/metrics.trajectory_report against the OpenCV reference
committed in data/reference_trajectories.json (tools/reference_band) and
ground truth, and the parity verdict: the aligned relative ATE within the
reference's own RANSAC scatter band (or 1%). With --frames T the
frames differ from the committed leg's, and no reference is compared.
Config 4's accuracy is its sequence 0's. The lines also go to --out
(default bench_out/run_benchmarks.jsonl in the repo, which git ignores).
The frames are rendered on the host in --workers processes first.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import statistics
import sys
import time

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.camera import intrinsics_from_image_size, normalize_points
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.models.refinement import refine_window
from tpu_vo_torch.parallel.sharding import run_batch_of_sequences
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.tools import reference_band
from tpu_vo_torch.utils import profiling, synthetic
from tpu_vo_torch.utils.metrics import trajectory_report

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   "bench_out", "run_benchmarks.jsonl")
# config -> (T, W, H, keypoints, sequences, reference leg)
CONFIGS = {
    1: (96, 640, 480, 1000, 1, "config1"),
    2: (64, 1241, 376, 2000, 1, "config2"),
    4: (64, 640, 480, 1000, 8, "config4_seq0"),
    5: (32, 640, 480, 1000, 1, "config5"),
}
NAMES = {1: "1_short_mono_640x480_1k", 2: "2_kitti_1241x376_2k",
         4: "4_batched_8seq_one_card", 5: "5_window_triangulation_lm"}
LM_ITERS = 6      # config 5's refine_window iterations
FRAME_CHUNK = 8   # frames per stage-1 launch in every config
WARMUP, REPS = 1, 3


def chunks(frames: int, pairs: int):
    """Config 4's (frame_chunk, pair_chunk): the first of each ladder that
    divides the totals."""
    return (next(c for c in (FRAME_CHUNK, 4, 2, 1) if frames % c == 0),
            next(c for c in (56, 9, 7, 3, 1) if pairs % c == 0))


def window_refined(frames: torch.Tensor, cfg: VOConfig, seed: int = 0, iters: int = LM_ITERS,
                   frame_chunk=FRAME_CHUNK, with_parts: bool = False):
    """Config 5's pipeline on (T, H, W) frames on their device: features
    (frame_chunk frames a launch), every pair's RANSAC pose, then
    refine_window over its inliers before the chain. Returns poses, or
    with with_parts (poses, diagnostics, the refine_window inputs)."""
    T = frames.shape[0]
    feats = runner.detect_frames(frames, cfg, frame_chunk)
    prev = ORBFeatures(*(f[:-1] for f in feats))
    cur = ORBFeatures(*(f[1:] for f in feats))
    est = runner.estimate_pairs(prev, cur, cfg, pair_generators(seed, range(1, T)))
    K = intrinsics_from_image_size(cfg.image_width, cfg.image_height, device=frames.device)
    x1 = normalize_points(prev.xy, K)
    x2 = torch.gather(normalize_points(cur.xy, K), 1,
                      est["match_train_idx"][..., None].expand(-1, -1, 2))
    args = (x1, x2, est["match_mask"], est["R"], est["t"])
    ref = refine_window(*args, iters=iters)
    poses = runner.chain_relative_poses(ref.R_rel, ref.t_rel, est["have_rt"], est["pose_ok"],
                                        cfg)
    return (poses, runner.diagnostics(est), args) if with_parts else poses


def _timed(fn, dev: torch.device):
    """(median ms, the last output) of fn() after WARMUP calls: CUDA events
    on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        out = fn()
        return statistics.median(profiling.cuda_times(fn, warmup=WARMUP, reps=REPS)), out
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def parity_verdict(res: dict, band: float) -> dict:
    """Within 1% of the reference, or inside its own scatter band."""
    rel = res.get("ate_vs_reference_aligned_rel")
    if rel is not None:
        res["ref_self_ate_band"] = band
        res["parity_within_ref_band"] = bool(rel <= max(band, 0.01))
    return res


def run_config(n: int, seqs, dev: torch.device, legs: dict, tag: str) -> dict:
    """Config n on `seqs`, a list of (frames, Rs, ts, K) per sequence."""
    T, W, H, kps, B, leg = CONFIGS[n]
    T = len(seqs[0][0])
    cfg = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=kps))
    res = {"config": NAMES[n], "frames": B * T}
    if n == 4:
        frames = torch.from_numpy(np.stack([np.stack(s[0]) for s in seqs])).to(dev)
        fc, pc = chunks(B * T, B * (T - 1))
        ms, (poses, _) = _timed(lambda: run_batch_of_sequences(
            frames, cfg, frame_chunk=fc, pair_chunk=pc, device=dev), dev)
        poses = Pose(poses.R[0], poses.t[0])
        res.update(sequences=B, frame_chunk=fc, pair_chunk=pc)
    else:
        frames = torch.from_numpy(np.stack(seqs[0][0])).to(dev)
        if n == 5:
            ms, poses = _timed(lambda: window_refined(frames, cfg), dev)
            _, _, args = window_refined(frames, cfg, with_parts=True)
            refine_ms, _ = _timed(lambda: refine_window(*args, iters=LM_ITERS), dev)
            res.update(lm_iters=LM_ITERS, refine_ms=refine_ms, refine_share=refine_ms / ms)
        else:
            fc, pc = FRAME_CHUNK, (T - 1 if n == 1 else 9)
            if (T - 1) % pc:
                pc = None
            ms, (poses, _) = _timed(lambda: runner.run_sequence_batched(
                frames, cfg, frame_chunk=fc, pair_chunk=pc, device=dev), dev)
            res.update(frame_chunk=fc, pair_chunk=pc)
    res.update(ms=ms, frames_per_sec=B * T / ms * 1e3, device=tag)
    traj = poses.t.double().cpu().numpy()
    our_R = poses.R.double().cpu().numpy()
    frames0, Rs, ts, _ = seqs[0]
    rec = legs.get(leg)
    if rec is not None and rec["frames_sha256"] == synthetic.frames_sha256(frames0):
        ref_t, ref_R = reference_band.leg_arrays(rec)
        res.update(trajectory_report(traj, ref_t, np.stack(ts), our_R=our_R, ref_R=ref_R,
                                     gt_R=np.stack(Rs)))
        parity_verdict(res, rec["band"])
    else:
        res.update(trajectory_report(traj, None, np.stack(ts), our_R=our_R, gt_R=np.stack(Rs)))
        res["reference"] = "none: the frames are not the committed leg's"
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="1,2,4,5")
    ap.add_argument("--frames", type=int, default=None, help="T in place of each config's own")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None, help="cpu to run on the host")
    ap.add_argument("--workers", type=int, default=4, help="rendering processes")
    args = ap.parse_args(argv)
    configs = [int(c) for c in args.configs.split(",")]
    dev = runner.entry_device(args.device)
    tag = profiling.card() if dev.type == "cuda" else "cpu"
    legs = reference_band.load()
    specs = {(n, b): ("corridor", args.frames or CONFIGS[n][0], CONFIGS[n][1], CONFIGS[n][2], b)
             for n in configs for b in range(CONFIGS[n][4])}
    with concurrent.futures.ProcessPoolExecutor(
            args.workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: pool.submit(synthetic.render, *spec) for k, spec in specs.items()}
        scenes = {k: f.result() for k, f in futures.items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for n in configs:
            res = run_config(n, [scenes[(n, b)] for b in range(CONFIGS[n][4])], dev, legs, tag)
            line = json.dumps(res)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
