"""Command-line entry point mirroring the reference's main.cpp (port of
tpu_vo/cli.py, headless).

Usage: python -m tpu_vo_torch.cli [dataset_dir] --no-viewer [options]

  - dataset path from argv or autodetect data/Dataset_VO / Dataset_VO
    (:59-73), enumerate + lexicographically sort .png/.jpg/.jpeg (:26-49);
    a KITTI odometry sequence directory gives calibrated K, times.txt
    stamps and, in a sequences/<NN> tree, the ground truth poses/<NN>.txt;
  - first image probes W x H, intrinsics derived fx=fy=W (:98-106)
    unless calibrated;
  - per-frame: banner + "Frame i: Detected N keypoints", [MatchDebug],
    [PoseUpdate], "Position: [...]";
  - after the loop, TUM, KITTI and npz trajectories, and the ATE report
    against ground truth (--gt, or the KITTI tree's).

It runs on the card unless given --device cpu. Frames come through
io/loader.PrefetchLoader, decoded and uploaded ahead of use: on the native
loader's threads (libpng, libjpeg; PNG and JPEG) when the paths are a
whole directory, else (--max-frames, --resume, or a native build that
failed) by the port's PNG reader (io/dataset.load_frame); it prints which,
and the compiler's error where the native build failed. The 3D trajectory viewer,
--show and the trajectory screenshots need viz/, which is not ported
yet: the CLI refuses to run without --no-viewer, or with --show.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

import numpy as np
import torch

from tpu_vo_torch.configs import MatchConfig, ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.io import native_loader
from tpu_vo_torch.io.dataset import autodetect_dataset, list_image_paths, parse_timestamp
from tpu_vo_torch.io.kitti import is_kitti_sequence, open_kitti_sequence
from tpu_vo_torch.io.loader import PrefetchLoader
from tpu_vo_torch.io.trajectory_io import (
    load_checkpoint,
    save_checkpoint,
    save_trajectory_kitti,
    save_trajectory_npz,
    save_trajectory_tum,
)
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.pipeline.step import initial_state, vo_step
from tpu_vo_torch.utils.metrics import evaluate_against_file


def build_config(args, width: int, height: int,
                 intrinsics=None) -> VOConfig:
    return VOConfig(
        image_width=width,
        image_height=height,
        orb=ORBConfig(n_features=args.features, n_levels=args.levels),
        match=MatchConfig(use_ratio_test=args.ratio_test),
        ransac=RansacConfig(max_iters=args.ransac_iters),
        trajectory_scale=args.scale,
        intrinsics_override=tuple(intrinsics) if intrinsics else None,
    )


def _parse_calib_arg(spec: str):
    """--calib 'fx,fy,cx,cy' -> intrinsics tuple."""
    vals = [float(v) for v in spec.replace(",", " ").split()]
    if len(vals) != 4:
        raise argparse.ArgumentTypeError(
            "--calib expects 4 values: fx,fy,cx,cy")
    return tuple(vals)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu_vo_torch", description="Monocular visual odometry on one CUDA card")
    p.add_argument("dataset", nargs="?", default=None,
                   help="image directory (default: data/Dataset_VO)")
    p.add_argument("--features", type=int, default=1200)
    p.add_argument("--levels", type=int, default=8,
                   help="ORB pyramid levels (reference: 8)")
    p.add_argument("--ransac-iters", type=int, default=256)
    p.add_argument("--scale", type=float, default=0.3)
    p.add_argument("--ratio-test", action="store_true",
                   help="Lowe ratio matching instead of cross-check")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--out-dir", default=None,
                   help="output dir (default: <dataset>)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None, help="checkpoint to resume from")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--show", action="store_true",
                   help="interactive windows (not ported yet: refused)")
    p.add_argument("--no-viewer", action="store_true",
                   help="skip the per-frame 3D trajectory render (required: "
                        "the viewer is not ported yet)")
    p.add_argument("--calib", type=_parse_calib_arg, default=None,
                   metavar="fx,fy,cx,cy",
                   help="calibrated intrinsics; overrides the reference's "
                        "fx=fy=W guess (and any KITTI calib.txt)")
    p.add_argument("--kitti-cam", type=int, default=None, choices=range(4),
                   help="camera stream for a KITTI sequence dir "
                        "(default: first of image_0/2/1/3)")
    p.add_argument("--gt", default=None,
                   help="ground-truth trajectory (KITTI 12-column or TUM "
                        "format) to evaluate ATE against; auto-discovered "
                        "for KITTI sequences/<NN> trees")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    if args.show or not args.no_viewer:
        print("The trajectory viewer and --show (viz/) are not ported yet: "
              "run with --no-viewer and without --show.", file=sys.stderr)
        return 2

    print("=" * 40)
    print("  Visual Odometry (tpu_vo_torch)")
    print("=" * 40)

    dataset = autodetect_dataset(args.dataset)
    if not dataset or not os.path.isdir(dataset):
        print("Dataset directory not found.\n"
              "Expected one of:\n  - data/Dataset_VO (recommended)\n"
              "  - Dataset_VO\n\nRun with an explicit path, e.g.:\n"
              "  python -m tpu_vo_torch.cli data/Dataset_VO --no-viewer",
              file=sys.stderr)
        return -1
    print(f"Dataset path: {dataset}")
    try:
        device = entry_device(args.device)
    except RuntimeError as exc:
        print(f"{exc} (--device cpu)", file=sys.stderr)
        return -1

    kitti_times = None
    calib = args.calib
    gt_path = args.gt
    if is_kitti_sequence(dataset):
        seq = open_kitti_sequence(dataset, camera=args.kitti_cam)
        print(f"KITTI odometry sequence detected (camera {seq.camera}, "
              f"calib.txt P{seq.camera})")
        paths = list(seq.image_paths)
        kitti_times = seq.times
        if calib is None:
            calib = seq.intrinsics
        if gt_path is None and seq.gt_poses_path:
            gt_path = seq.gt_poses_path
            print(f"Ground truth: {gt_path}")
    else:
        paths = list_image_paths(dataset)
    print(f"Found {len(paths)} images in dataset")
    if not paths:
        print("No images found in dataset directory!", file=sys.stderr)
        return -1
    if args.max_frames:
        paths = paths[: args.max_frames]

    start = 0
    state = None
    if args.resume:
        state = load_checkpoint(args.resume, device)
        # Frames [0, frame_idx) were already consumed by the checkpointed
        # run; re-running them would compose their motions twice.
        start = min(state.frame_idx, len(paths))
        print(f"Resumed from {args.resume} at frame {start} "
              f"(skipping {start} processed frames)")

    loader = PrefetchLoader(paths[start:], device=device)
    failed = native_loader.unavailable_reason()
    if failed:
        error = next((ln for ln in failed.splitlines() if "error" in ln), failed.strip())
        print(f"Decoder: {loader.decoder} (native loader unavailable: {error.strip()})")
    else:
        print(f"Decoder: {loader.decoder}")
    frames = iter(loader)
    first = next(frames, None)
    if first is None:
        print("No frames processed; nothing to save.")
        return 0
    height, width = first[2].shape
    print(f"Image dimensions: {width} x {height}")

    cfg = build_config(args, width, height, intrinsics=calib)
    print("Camera matrix initialized"
          + (" (calibrated):" if calib else " (fx=fy=W guess):"))
    fx, fy, cx, cy = cfg.intrinsics
    print(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]))
    if state is None:
        state = initial_state(cfg, device=device)

    out_dir = args.out_dir or dataset
    poses_R, poses_t, stamps = [], [], []

    n_total = len(paths)
    print(f"\nProcessing {n_total - start} frames...")
    print("=" * 40)
    t_start = time.time()
    for j, path, frame in itertools.chain([first], frames):
        i = start + j
        ts = (float(kitti_times[i]) if kitti_times is not None
              and i < len(kitti_times) else parse_timestamp(path, i))
        print(f"\n--- Frame {i + 1}/{n_total} ---")
        state, out = vo_step(state, frame, cfg)
        poses_R.append(out.pose.R.cpu().numpy())
        poses_t.append(out.pose.t.cpu().numpy())
        stamps.append(ts)

        if not args.quiet:
            print(f"Frame {i}: Detected {int(out.num_keypoints)} keypoints")
            print(f"[MatchDebug] #matches={int(out.num_matches)}"
                  f"  inliers={int(out.num_inliers)}"
                  f"  valid={int(out.num_valid_points)}"
                  f"  residual={float(out.epipolar_residual):.4f}"
                  f"  (units: Hamming-matched px)")
            print(f"[PoseUpdate] matches={int(out.num_matches)}"
                  f" pose_ok={int(out.pose_ok)}"
                  f" scale={float(out.scale):.1f}")
            pos = poses_t[-1]
            print(f"Position: [{pos[0]:.6g}, {pos[1]:.6g}, {pos[2]:.6g}]")

        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(os.path.join(out_dir, "vo_checkpoint.npz"), state)

    elapsed = time.time() - t_start
    n = len(poses_t)
    print("\n" + "=" * 40)
    print("Processing complete!")
    print(f"Total frames processed: {n}")
    print(f"Throughput: {n / max(elapsed, 1e-9):.1f} frames/sec "
          f"(incl. the kernels' first build)")

    if not poses_t:
        print("No frames processed; nothing to save.")
        return 0
    traj = Pose(torch.from_numpy(np.stack(poses_R)), torch.from_numpy(np.stack(poses_t)))
    save_trajectory_tum(os.path.join(out_dir, "trajectory_tum.txt"), traj,
                        np.asarray(stamps))
    save_trajectory_kitti(os.path.join(out_dir, "trajectory_kitti.txt"), traj)
    save_trajectory_npz(os.path.join(out_dir, "trajectory.npz"), traj)

    if gt_path:
        try:
            report = evaluate_against_file(traj, gt_path, align="scale")
            print("Ground-truth evaluation (Umeyama scale-aligned — "
                  "monocular scale is unobservable):")
            print("  " + " ".join(f"{k}={v}" for k, v in report.items()))
        except (OSError, ValueError) as exc:  # a bad GT file must not lose the run
            print(f"Ground-truth evaluation failed: {exc}", file=sys.stderr)
    print("Trajectory screenshots not saved: viz/ is not ported yet")
    return 0


if __name__ == "__main__":
    sys.exit(main())
