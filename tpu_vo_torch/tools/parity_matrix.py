"""The parity preset and the production defaults across scenes and seeds,
against the OpenCV reference's own scatter (port of tools/parity_matrix.py).

Scenes (the JAX tool's SCENES): the corridor at 640x480 (96 frames, config
1's), at 1241x376 (64, config 2's), the pan at 320x240 (48) and the
corridor at 320x240 (48), all seed 0 with 1200 keypoints. On each, the
batched runner (frame_chunk 8, pair_chunk the first of 9, 7, 11, 13 that
divides the pairs, else all) with VOConfig.reference_parity() (`faithful`)
and with the defaults (`production`), under RANSAC seeds 0 .. seeds-1.
The reference's trajectory and its 5-seed band come from the committed
legs config1, config2, diag_pan_320x240 and diag_corridor_320x240
(reference="committed"; each scene's frames' sha256 checked against its
leg), or from utils/cv_reference here (reference="cv2", a band of as
many seeds as --seeds).

Rows, one a scene and variant (`<scene>.<variant>`): per seed the
Umeyama-aligned ATE against the reference over its extent, its max,
within_band_all (max <= max(band, 0.01)), ATE against ground truth over
its extent and the mean RPE rotation (deg); and the timing: `compile_s`
is a string (eager PyTorch compiles nothing), `first_call_s` the first
call's wall seconds, run_s_per_seed the steady calls' (seed 0 again,
then the others), one_shot_fps = T / the steady seed-0 call; with
--device-fps, device_fps from CUDA events (tools/device_time, 4 calls x
3) on the two corridor scenes of config 1 and 2. One row a scene
(`<scene>`) holds the reference's band and ATE against ground truth.

    python -m tpu_vo_torch.tools.parity_matrix [--seeds 5] [--device-fps]
        [--scenes corridor_640x480,...] [--frames-scale 1.0]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.tools import diag_common, profile_rows
from tpu_vo_torch.tools.device_time import device_time_ms
from tpu_vo_torch.tools.profile_rows import NOT_ON_CARD
from tpu_vo_torch.utils.metrics import ate_rmse_aligned, extent, rpe, scale_matched_gt

DEFAULTS = dict(seeds=5, frames_scale=1.0, scenes="", device_fps=False, reference="committed")
SCENES = [
    # (name, maker, W, H, T, n_features)
    ("corridor_640x480", "corridor", 640, 480, 96, 1200),
    ("corridor_1241x376", "corridor", 1241, 376, 64, 1200),
    ("pan_320x240", "pan", 320, 240, 48, 1200),
    ("corridor_320x240", "corridor", 320, 240, 48, 1200),
]
FPS_SCENES = {"corridor_640x480", "corridor_1241x376"}
COMPILE = ("no counterpart: eager PyTorch compiles nothing ahead of a call; first_call_s is "
           "the first call's wall time")


def make_scene(kind, T, W, H, seed=0):
    """(frames, Rs, ts, K) of the maker `kind` (corridor or pan)."""
    return diag_common.scene(kind, T, W, H, seed)


def variant_cfg(variant, W, H, n_features):
    if variant == "faithful":
        return VOConfig.reference_parity(image_width=W, image_height=H, n_features=n_features)
    return VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=n_features))


def run_variant(rows, frames, cfg, seeds, pc, T, device_fps=False):
    """(per-seed (R, t) float64 numpy, timing) of the runner over seeds."""
    calls = profile_rows.frame_launches(T, 8)

    def call(s):
        poses, _ = rows.run(lambda: runner.run_sequence_batched(
            frames, cfg, seed=s, device=frames.device, frame_chunk=8, pair_chunk=pc),
            (calls, calls))
        return poses.R.double().cpu().numpy(), poses.t.double().cpu().numpy()

    t0 = time.perf_counter()
    first = call(0)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    call(0)
    steady_s = time.perf_counter() - t0
    outs, run_s = [first], [steady_s]
    for s in range(1, seeds):
        t0 = time.perf_counter()
        outs.append(call(s))
        run_s.append(time.perf_counter() - t0)
    timing = {"compile_s": COMPILE, "first_call_s": first_s, "run_s_per_seed": run_s,
              "one_shot_fps": T / steady_s}
    if device_fps:
        if rows.on_card:
            ms = device_time_ms(rows.counted(lambda: runner.run_sequence_batched(
                frames, cfg, seed=0, device=frames.device, frame_chunk=8, pair_chunk=pc),
                (calls, calls)), reps=4, iters=3)
            timing["device_fps"] = T / ms * 1e3
        else:
            timing["device_fps"] = NOT_ON_CARD
    return outs, timing


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    how = diag_common.check_reference(o.reference)
    rows = profile_rows.Rows("parity_matrix", o)
    chosen = [s for s in (o.scenes or "").split(",") if s]
    for name, kind, W, H, T, nf in SCENES:
        if chosen and name not in chosen:
            continue
        T = max(8, int(T * o.frames_scale))
        spec = (kind, T, W, H, 0)
        frames_np, Rs, ts, _ = make_scene(*spec)
        gt_R, gt_t = np.stack(Rs), scale_matched_gt(np.stack(ts))
        leg = diag_common.leg_for(spec)
        if how == "committed" and leg is not None:
            frames_np = diag_common.leg_frames(leg)[0]
        traj_ref, _, band = diag_common.reference(how, leg, frames_np, W, H,
                                                  band_seeds=o.seeds)
        ext = extent(traj_ref)
        rows.add(name, {"frames": T, "resolution": f"{W}x{H}", "ref_self_ate_band": band,
                        "ref_ate_vs_gt_rel": diag_common.ate_vs_gt_rel(traj_ref, ts),
                        "reference": how if how == "cv2" else f"committed leg {leg}"})
        frames = torch.from_numpy(np.stack(frames_np)).to(o.device)
        pc = diag_common.pair_chunk(T)
        for variant in ("faithful", "production"):
            cfg = variant_cfg(variant, W, H, nf)
            outs, timing = run_variant(rows, frames, cfg, o.seeds, pc, T,
                                       device_fps=o.device_fps and name in FPS_SCENES)
            rels, gts, rpes = [], [], []
            for R_est, t_est in outs:
                rels.append(ate_rmse_aligned(t_est, traj_ref) / ext)
                gts.append(diag_common.ate_vs_gt_rel(t_est, ts))
                rpes.append(rpe(t_est, gt_t, R_est, gt_R).get("rpe_rot_mean_deg"))
            rows.add(f"{name}.{variant}", {
                "ate_vs_ref_aligned_rel_per_seed": rels, "ate_vs_ref_max": max(rels),
                "within_band_all": bool(max(rels) <= max(band, 0.01)),
                "ate_vs_gt_rel_per_seed": gts, "rpe_rot_mean_deg_per_seed": rpes, **timing})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
