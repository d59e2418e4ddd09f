"""The benchmark's configurations 1-5 and 7 on the port (port of
benchmarks/run_benchmarks.py, those configs), on the card:

  1. corridor 640x480, 1000 keypoints, 96 frames (frame_chunk 8, pair_chunk T - 1);
  2. corridor 1241x376, 2000 keypoints, 64 frames (frame_chunk 8, pair_chunk 9);
  3. corridor 3840x2160, 8000 keypoints, the ratio test, 8 frames
     (frame_chunk 2, pair_chunk T - 1), with the peak device memory;
  4. 8 corridor sequences (seeds 0-7) of 64 frames at 640x480, 1000
     keypoints, through parallel/sharding.run_batch_of_sequences on one
     card (frame_chunk 8, pair_chunk 56: the first of the JAX harness's
     ladders (8, 4, 2, 1) and (56, 9, 7, 3, 1) that divides B*T and B*(T-1));
  5. corridor 640x480, 1000 keypoints, 32 frames: features, pairs, then
     models/refinement.refine_window (6 LM iterations) over every pair's
     RANSAC inliers before the chain;
  7. the five dynamic corridors of utils/synthetic.DYNAMIC_SCENES at
     640x480, 1200 keypoints, 48 frames (frame_chunk 8, pair_chunk the
     first of (9, 7, 11, 13, T - 1) that divides T - 1): the port's and
     the reference's ATE and RPE against ground truth, and on the object
     scenes the median share of keypoints on the object and of RANSAC
     inliers on it (`object_attribution`).

    python -m tpu_vo_torch.tools.run_benchmarks [--configs 1,2,3,4,5,7] [--frames T]
        [--out PATH] [--device cpu] [--workers N]

Each config prints one JSON line: frames/s (median of the timed runs by
CUDA events; the host clock with --device cpu), the card's name and power
limit, then utils/metrics.trajectory_report against the OpenCV reference
committed in data/reference_trajectories.json (tools/reference_band) and
ground truth, and the parity verdict: the aligned relative ATE within the
reference's own RANSAC scatter band (or 1%). With --frames T the
frames differ from the committed leg's, and no reference is compared.
Config 4's accuracy is its sequence 0's. Configs 3 and 7 carry the JAX
harness's field names beside the port's own; config 7 prints a line per
scene, then its config line. The lines also go to --out (default
bench_out/run_benchmarks.jsonl in the repo, which git ignores). The
frames are rendered on the host in --workers processes first, large
scenes by frame ranges (utils/synthetic.submit_render).
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

from tpu_vo_torch.configs import MatchConfig, ORBConfig, VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.camera import intrinsics_from_image_size, normalize_points
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.models.refinement import refine_window
from tpu_vo_torch.parallel.sharding import run_batch_of_sequences
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.tools import reference_band
from tpu_vo_torch.utils import profiling, synthetic
from tpu_vo_torch.utils.metrics import ate_rmse, extent, rpe, scale_matched_gt, trajectory_report

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   "bench_out", "run_benchmarks.jsonl")
# config -> (T, W, H, keypoints, sequences, reference leg); config 7's
# sequences are its scenes, each with the leg config7_<scene>
CONFIGS = {
    1: (96, 640, 480, 1000, 1, "config1"),
    2: (64, 1241, 376, 2000, 1, "config2"),
    3: (8, 3840, 2160, 8000, 1, "config3"),
    4: (64, 640, 480, 1000, 8, "config4_seq0"),
    5: (32, 640, 480, 1000, 1, "config5"),
    7: (48, 640, 480, 1200, len(synthetic.DYNAMIC_SCENES), "config7"),
}
NAMES = {1: "1_short_mono_640x480_1k", 2: "2_kitti_1241x376_2k",
         3: "3_highdensity_4k_8k_ratio", 4: "4_batched_8seq_one_card",
         5: "5_window_triangulation_lm", 7: "7_dynamic_scene_robustness"}
LM_ITERS = 6      # config 5's refine_window iterations
FRAME_CHUNK = 8   # frames per stage-1 launch in every config but 3
C3_FRAME_CHUNK = 2  # config 3's: two 4K frames a launch
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


def config_cfg(n: int) -> VOConfig:
    """Config n's VOConfig (config 3 with the ratio test)."""
    _, W, H, kps, _, _ = CONFIGS[n]
    match = MatchConfig(use_ratio_test=True) if n == 3 else MatchConfig()
    return VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=kps), match=match)


def config_chunks(n: int, T: int):
    """(frame_chunk, pair_chunk) of config n at T frames: config 3's (2,
    T - 1); config 7's (8, the first of (9, 7, 11, 13, T - 1) that
    divides T - 1), as the JAX harness picks them."""
    if n == 3:
        return C3_FRAME_CHUNK, T - 1
    return FRAME_CHUNK, next(c for c in (9, 7, 11, 13, T - 1) if (T - 1) % c == 0)


def object_attribution(feats: ORBFeatures, est: dict, masks, W: int, H: int):
    """(median over pairs of the share of valid keypoints on the moving
    object, median of the share of RANSAC inliers on it): a match is on
    the object where its keypoint in frame i or its match_train_idx
    keypoint in frame i + 1 (the unfiltered match slot, as tpu_vo reads
    it) falls on that frame's mask, at the rounded pixel."""
    xy = feats.xy.double().cpu().numpy()
    valid = feats.valid.cpu().numpy()
    train = est["match_train_idx"].cpu().numpy()
    inl = est["match_mask"].cpu().numpy()

    def on_obj(p, m):
        x = np.clip(np.round(p[:, 0]).astype(int), 0, W - 1)
        y = np.clip(np.round(p[:, 1]).astype(int), 0, H - 1)
        return m[y, x]

    shares, fracs = [], []
    for i in range(len(train)):
        obj = on_obj(xy[i], masks[i]) | on_obj(xy[i + 1][train[i]], masks[i + 1])
        shares.append((obj & valid[i]).sum() / max(valid[i].sum(), 1))
        fracs.append((inl[i] & obj).sum() / max(inl[i].sum(), 1))
    return float(np.median(shares)), float(np.median(fracs))


def parity_verdict(res: dict, band: float) -> dict:
    """Within 1% of the reference, or inside its own scatter band."""
    rel = res.get("ate_vs_reference_aligned_rel")
    if rel is not None:
        res["ref_self_ate_band"] = band
        res["parity_within_ref_band"] = bool(rel <= max(band, 0.01))
    return res


def _gt_report(traj, R, Rs, ts) -> dict:
    """Config 7's accuracy fields against ground truth: ATE over the
    extent and RPE, after the scale match."""
    gt_t = scale_matched_gt(np.stack(ts))
    return {"ate_vs_gt_rel": ate_rmse(traj, gt_t) / extent(gt_t),
            **rpe(traj, gt_t, R, np.stack(Rs))}


def run_scene_7(name: str, seq, dev: torch.device, legs: dict) -> dict:
    """Config 7 on one scene, seq = (frames, Rs, ts, K, masks): the port's
    run timed, its and the reference's accuracy against ground truth, and
    on an object scene the attribution of keypoints and inliers."""
    frames_np, Rs, ts, _, masks = seq
    T, W, H = len(frames_np), CONFIGS[7][1], CONFIGS[7][2]
    cfg = config_cfg(7)
    fc, pc = config_chunks(7, T)
    frames = torch.from_numpy(np.stack(frames_np)).to(dev)
    ms, (poses, diags) = _timed(lambda: runner.run_sequence_batched(
        frames, cfg, frame_chunk=fc, pair_chunk=pc, device=dev), dev)
    traj, our_R = poses.t.double().cpu().numpy(), poses.R.double().cpu().numpy()
    entry = {"ms": ms, "frames_per_sec": T / ms * 1e3, "frame_chunk": fc, "pair_chunk": pc,
             "pose_ok_frac": float(diags["pose_ok"].double().mean()),
             "poses_finite": bool(torch.isfinite(poses.t).all() and torch.isfinite(poses.R).all())}
    ours = _gt_report(traj, our_R, Rs, ts)
    entry["tpu_vo_ate_vs_gt_rel"] = ours.pop("ate_vs_gt_rel")
    entry.update({"tpu_vo_" + k: v for k, v in ours.items()})
    rec = legs.get(f"config7_{name}")
    if rec is not None and rec["frames_sha256"] == synthetic.frames_sha256(frames_np):
        ref_t, ref_R = reference_band.leg_arrays(rec)
        ref = _gt_report(ref_t, ref_R, Rs, ts)
        entry["ref_ate_vs_gt_rel"] = ref.pop("ate_vs_gt_rel")
        entry.update({"ref_" + k: v for k, v in ref.items()})
    else:
        entry["reference"] = "none: the frames are not the committed leg's"
    if name.startswith("obj"):
        feats = runner.detect_frames(frames, cfg, fc)
        est = runner.estimate_pairs(ORBFeatures(*(f[:-1] for f in feats)),
                                    ORBFeatures(*(f[1:] for f in feats)), cfg,
                                    pair_generators(0, range(1, T)), pc)
        entry["obj_kp_share_median"], entry["obj_inlier_frac_median"] = object_attribution(
            feats, est, masks, W, H)
    return entry


def run_config(n: int, seqs, dev: torch.device, legs: dict, tag: str) -> dict:
    """Config n on `seqs`, a list of (frames, Rs, ts, K) per sequence
    (config 7: of (frames, Rs, ts, K, masks) per scene, in the order of
    synthetic.DYNAMIC_SCENES)."""
    T, W, H, kps, B, leg = CONFIGS[n]
    T = len(seqs[0][0])
    cfg = config_cfg(n)
    res = {"config": NAMES[n], "frames": B * T}
    if n == 7:
        res.update(scenes={}, device=tag)
        for name, seq in zip(synthetic.DYNAMIC_SCENES, seqs):
            res["scenes"][name] = run_scene_7(name, seq, dev, legs)
            print(json.dumps({"scene": name, **res["scenes"][name]}), flush=True)
        return res
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
            fc, pc = config_chunks(3, T) if n == 3 else (FRAME_CHUNK, T - 1 if n == 1 else 9)
            if (T - 1) % pc:
                pc = None
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)

            def run():
                return runner.run_sequence_batched(frames, cfg, frame_chunk=fc, pair_chunk=pc,
                                                   device=dev)

            ms, (poses, _) = _timed(run, dev)
            res.update(frame_chunk=fc, pair_chunk=pc)
            if n == 3:
                # the JAX harness's fields; its one-shot wall time is one
                # warm call by the host clock, to the outputs' readiness
                t0 = time.perf_counter()
                profiling.fence(run())
                wall_s = time.perf_counter() - t0
                res.update(frames_per_sec_chip=T / ms * 1e3, one_shot_wall_fps=T / wall_s,
                           ref_seconds_per_frame=None,
                           short_sequence_caveat=f"T={T}: ATE over a short 4K clip",
                           peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                                         if dev.type == "cuda" else None))
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


def scene_spec(n: int, b: int, frames: int = None):
    """render's (scene, T, W, H, seed) of config n's sequence b (config
    7: its scene b, seed 0); `frames` in place of the config's T."""
    T, W, H = CONFIGS[n][:3]
    if n == 7:
        return (f"dynamic_{list(synthetic.DYNAMIC_SCENES)[b]}", frames or T, W, H, 0)
    return ("corridor", frames or T, W, H, b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="1,2,3,4,5,7")
    ap.add_argument("--frames", type=int, default=None, help="T in place of each config's own")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None, help="cpu to run on the host")
    ap.add_argument("--workers", type=int, default=4, help="rendering processes")
    args = ap.parse_args(argv)
    configs = [int(c) for c in args.configs.split(",")]
    dev = runner.entry_device(args.device)
    tag = profiling.card() if dev.type == "cuda" else "cpu"
    legs = reference_band.load()
    specs = {(n, b): scene_spec(n, b, args.frames) for n in configs for b in range(CONFIGS[n][4])}
    with concurrent.futures.ProcessPoolExecutor(
            args.workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {k: synthetic.submit_render(pool, *spec) for k, spec in specs.items()}
        scenes = {k: synthetic.join_ranges([f.result() for f in fs]) for k, fs in futures.items()}
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
