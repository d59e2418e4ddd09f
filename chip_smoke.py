"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profiling-out PATH] [--diagnostics-out PATH]

Phases, in order; any failure raises and the exit code is non-zero:

  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from tpu_vo_torch/csrc (nvcc, sm_90a) and,
     beside them, the native image loader (g++, io/native_loader; its
     inflate, PNG and JPEG codecs are csrc's own, it links pthread and no
     image or compression library): a failed build fails the run, and it
     prints the build's seconds and the library's path; count the tensor-core
     instructions (HMMA) of P2's phase_mxu_kernel in the library's SASS
     (cuobjdump); none fails the run;
  3. compare each kernel with its plain PyTorch version on the card:
     select_maps_levels (B1, one launch for all levels) on the 8 pyramid
     levels of the main path's 32 1241x376 frames, of 8 frames of
     uniform noise and of the near-threshold compass pattern at the 8
     level shapes, and on odd shapes (37x101, 9x11, 105x347, 77x129) at
     borders 31 and 4; fast_margin_levels (B3, one launch for all
     levels) on the main path's 8 levels, the noise and the compass
     pattern at the 8 level shapes, and 37x101 and 9x11 (fast_margin, one
     level); extract_patches_levels (B2, one launch for all levels' slots)
     on all 1200 slots of the main path's 32 frames, with slots clamped
     at every edge, and on a table with a 30x60 level whose slot count
     leaves a tail of fewer than 4 windows; B1 and B2 also on one frame
     (B = 1, as the streaming path calls them) at all 8 levels; all must
     agree bit for bit;
  4. drive the main path, run_sequence_batched on a (32, 376, 1241) uint8
     synthetic sequence with 1200 keypoints and 256-hypothesis 5-point
     RANSAC, with the kernels' launch counters reset just before; check
     that B1 and B2 each launched exactly once, the poses are finite and
     the trajectory is accurate, and that a small sequence gives the same
     answer on the card as on the CPU;
  4a. bench.py's harness: tpu_vo_torch.tools.bench at bench.py's
     configuration (make_sequence(64, 1241, 376, seed=0), rendered in the
     worker pool with the other scenes, 1200 keypoints, 256 hypotheses,
     frame_chunk 8, pair_chunk 9; 2 warm-up and 3 timed windows of 8
     calls; --reference committed), after the renders are joined and
     beside no other host work, counters reset just before: its stdout is
     one line with bench.py's keys, value > 0 and vs_baseline the rounded
     ratio of the unrounded value and baseline; B1 and B2 launch once per
     8-frame chunk of every call and B3 never; the last call's pose_ok >=
     0.7 and mean rotation error < 1.5 deg over the 63 pairs against
     ground truth; the line holds e2e_decode_fps (the native loader's
     leg), whose launches count with the rest; then B1
     and B2 against their plain versions bit for bit at one 8-frame
     chunk's shapes; it prints the line, the card's name and power limit
     and the launches;
  4b. drive the streaming path: api.VisualOdometry over the same 32
     frames, counters reset just before; check that B1 and B2 each
     launched once per frame, pose_ok and the rotation error meet the
     main path's bars, and run_sequence_scan gives finite poses and F
     (the first frame's F, estimated against no features, included) and
     run_sequence_batched's pose_ok per pair and world positions within
     1e-4; print the per-frame ms (CUDA events; median and quartiles
     after 2 warm-up frames); check that RANSAC's first-maximum (count
     scoring) and torch.argmin (MSAC) take the first of tied values on
     the card;
  4c. run_sequence_batched with each VOConfig option (the ratio test,
     count scoring, 8-point samples, min_valid_fraction 0.5) on the small
     sequence, card against CPU as in phase 4;
  4d. the CLI: 24 frames of the main path written as 8-bit gray PNGs
     (all five row filters) in a KITTI tree with calib.txt, times.txt
     and poses/00.txt, run by tpu_vo_torch.cli.main on the card, counters
     reset just before; check that B1 and B2 launched once per frame, the
     three trajectory files hold 24 poses, an ATE figure was printed and
     the CLI read through the native loader (Decoder: native); it prints
     its ms a frame (host clock between frames, median);
  4d2. the CLI's default run (the 3D trajectory viewer rendering the
     whole trajectory every frame, the 7 screenshots at the end) over the
     same tree, counters reset just before: B1 and B2 launch once a
     frame, render_step runs once a frame, the positions equal the
     --no-viewer run's (max diff 0), the 7 files exist, each decodes
     through io/jpeg.decode to (768, 1024, 3) and equals encode_rgb of
     the port's own render of its view byte for byte;
     process_frame(render_overlay=True) on the card gives the overlay that
     draw_keypoints_overlay draws from a CPU copy of the same features;
     Adam7 PNGs (gray, palette) decode through the native loader to the
     Python reader's pixels; it
     prints the CLI's ms a frame with and without the viewer, render_step's
     ms at 24 and at 1000 poses and the screenshots' seconds (host clock);
  4e. the ingest path: make_sequence(64, 1241, 376, seed=0) written as
     Paeth PNG files; NativeDataset's frames equal them bit for bit and
     in order, and a packed .vobin reads them back; PrefetchLoader(device=
     "cuda") yields them on the card, equal and in order, through the
     native decoder; run_sequence_streamed over the native loader's
     64-frame chunks and over 16-frame host chunks, counters reset just
     before each, launches
     B1 and B2 8 times per 64 frames and matches run_sequence_batched
     (frame_chunk 8, pair_chunk 9) on the card: pose_ok equal, world
     positions within 1e-4; B1 and B2 against their plain versions bit
     for bit on each 8-frame chunk's (8, 376, 1241) pyramid and 1200
     keypoints; then tools/io_bench's rows, every native one measured;
  4f. frames from files of other formats: the main path's first 24 frames
     written as baseline JPEG at quality 90 (io/jpeg.encode_gray, the card
     host having no other encoder) into one directory, and as 8-bit PNGs
     alternating palette (a PLTE of the 256 grays) and Adam7-interlaced
     gray (a small writer here) into another; over each, load_frame (ms
     per decoded frame, host clock), PrefetchLoader onto the card with
     use_native=False and with the native loader (which it must choose),
     and the CLI (counters reset just before; it must report Decoder:
     native); all 24 frames decode and none is skipped, the JPEG frames
     equal roundtrip_gray(frame, 90) of the originals and the PNG frames
     the originals, each native frame the Python reader's frame of the
     same file, the CLI launches B1 and B2 once a frame, and its
     positions lie within 1e-4 of run_sequence_scan's on those frames in
     memory with the CLI's configuration; the same over a third
     directory, the 8 committed progressive JPEG frames of the main path
     (tpu_vo_torch/data/jpeg/progressive, PIL's gray q90 files), each
     file's bytes and each decoded frame held to the sha256 in the
     manifest (tpu_vo's decode); then each committed JPEG alone
     (progressive frame 0, SOF9 and SOF10 4:2:0 RGB with restarts, a
     Huffman 4:2:2 scan script with smoothing) through both readers,
     held to the manifest, with the ms a frame of each route and kind
     printed beside this call's baseline q90 file;
  5. drive the FAST-detect path at full width: the stage benchmark's
     ablation (tpu_vo_torch.tools.stage_bench) on 8 frames of 1241x376,
     counters reset just before; check that B3 launched exactly 4 times
     per pass of the ablation (once per pyramid in each of its 4 FAST
     stages) and once per fast.detect_levels call, and that the dense
     route's descriptors (fast.detect_levels selection, ic_angles_prefix,
     gaussian_blur, descriptor_bits) equal the patch route's for the same
     keypoints; it prints each stage's ms per frame;
  5b. drive the patch-slots probe path at its full shapes: the probe
     tool (tpu_vo_torch.tools.patch_slots_probe) on 8 frames of
     1241x376 with 512 keypoints each, counters reset just before; check
     that P1, P2 and P3 each launched, then hold every variant of its
     sweep that fits in shared memory, and P1 at 128 and 512 lanes with
     fewer slots, against its plain version bit for bit, on the probe's
     keypoints and on 5 at the right edge and 5 at the bottom edge, and
     P2 and P3 also on levels whose pixels span 41 binades
     (patch_slots_probe.binade_levels); the probe prints its timing floor
     and each variant's ms;
  5c. parity with the OpenCV reference (the accuracy path): render the
     card's two legs of tpu_vo_torch/data/reference_trajectories.json
     (the corridor at 640x480 and 1241x376, T 24, seed 3; rendered on
     the host in worker processes started after the build, with the
     scenes of 5d-5g, and waited for before phase 4b, so that no timed
     phase runs beside them; it prints each scene's render seconds),
     require their sha256 to equal the file's, then run_sequence_batched
     with VOConfig.reference_parity() on 5 RANSAC seeds each, counters
     reset just before; every seed's aligned ATE over the extent must
     lie within max(1.15 band, 0.01), and B1 and B2 launch once a run;
     then B1 and B2 against their plain versions bit for bit at each
     leg's own shapes (the 24 frames' pyramid, the keypoints ranked
     from B1's maps under the keep-ties budget of 4n);
  5d. config 5: the corridor at 640x480, 1000 keypoints, 32 frames
     through tools/run_benchmarks.window_refined (features 8 frames a
     launch, pairs, models/refinement.refine_window with 6 LM iterations,
     the chain), counters reset just before (4 launches each of B1 and
     B2); frames/s and the refine's share by CUDA events; the refined and
     unrefined aligned ATE against the committed reference and ground
     truth; refine_window on the card against the CPU on the same inputs
     in float32 and float64; B1 and B2 against their plain versions bit
     for bit on each 8-frame chunk's pyramid and keypoints;
  5e. config 4, cut to B = 4 sequences of 16 frames at 640x480 (the
     benchmark has 8 of 64): parallel/sharding.run_batch_of_sequences,
     counters reset just before (8 launches each of B1 and B2 at
     frame_chunk 8; pair_chunk 15, one sequence's pairs); frames/s by
     CUDA events; each sequence's pose_ok equal to, and its positions
     within 1e-4 of, run_sequence_batched on the card with the same
     chunks; B1 and B2 against their plain versions bit for bit on each
     8-frame chunk's pyramid and keypoints;
  5f. config 3: the corridor at 3840x2160, 8000 keypoints, the ratio
     test, 8 frames (rendered by frame ranges in the workers), its sha256
     equal to the committed `config3` leg's; run_sequence_batched with
     frame_chunk 2 and pair_chunk 7, counters reset just before (4
     launches each of B1 and B2); finite poses, pose_ok >= 0.7, the
     aligned ATE over the extent within max(band, 0.01) of the leg; B1
     and B2 against their plain versions bit for bit on the first
     chunk's 8 levels from (2, 2160, 3840) (23-bit keys) with the 8000
     keypoints ranked from B1's maps; then tools/run_benchmarks' config
     3 line (ms a run, frames/s, peak device memory), stage 1, stage 2
     and its ratio-test Hamming step's share by CUDA events, and B1's
     and B2's times and bounds at these shapes, with B2's library call
     (one aten::index gather of the same windows, checked equal);
  5g. config 7: the five dynamic corridors of utils/synthetic
     (640x480, T 48, 1200 keypoints), each sha256 equal to its leg's;
     run_sequence_batched with frame_chunk 8 and pair_chunk 47 on each,
     counters reset just before (6 launches each of B1 and B2 a run); B1
     and B2 bit for bit on the first scene's first chunk; then
     tools/run_benchmarks' config 7 lines: each scene's ATE and RPE
     against ground truth beside the reference's (from the committed
     leg); the median on-object inlier share must be at most 0.15 on
     obj_light and obj_mid, the occluders' ATE over the extent below
     0.05 with every pair pose_ok, and every scene's poses finite
     (obj_heavy and low_texture are reported, not gated);
  5h. config 6: the corridor (640x480, T 48, rendered in ranges of 12
     frames) and the pan (320x240, T 32), seed 0, each degraded in the
     worker pool to utils/synthetic's four nuisance levels (seed 17)
     before phase 4b; each of the 8 scenes' sha256 equal to its
     config6_<scene>_<level> leg's; B1 and B2 bit for bit on the harsh
     level's first chunk of each scene (320x240 and 640x480); one pass
     over the 8 runs (frame_chunk 8, pair_chunk T - 1), counters reset
     just before (6 launches each of B1 and B2 a corridor run, 4 a pan
     run); then tools/run_benchmarks' line per scene and level (frames/s
     by CUDA events, ATE and RPE against ground truth beside the
     reference's from the leg, pose_ok, parity with the leg's band,
     reported); gates: finite poses, pose_ok >= 0.7 on the corridor at
     every level and on the pan's clean level, the corridor's ATE over
     the extent below 0.01 at every level; a level where the port is
     worse than the reference against ground truth by more than the
     leg's band is named in its line; io/jpeg.decode's ms a frame at
     640x480 (8 clean corridor frames at quality 90, equal to
     roundtrip_gray);
  5i. the parallel runners (parallel/sharding) over the main path's 32
     frames and config 4's cut of 5e, as host arrays: in a world of 1 on
     NCCL in this process (a local TCP store, destroyed after),
     run_sequence_time_sharded on a (1,) mesh and run_batch_time_sharded
     on a (1, 1) mesh, counters reset just before each (4 and 8 launches
     each of B1 and B2, one per 8-frame chunk), nothing moved; then
     worlds of 2 and 4 gloo ranks, all on cuda:0 (NCCL refuses two ranks
     on one card), each rank a tools/parallel_run process that loads the
     kernels built here (a rank that builds them again fails), gets the
     frames by .npy and returns its results by .npz: SP over 2 ranks (16
     frames a rank) and DP over 2 (2 sequences a rank), then DP x SP on
     a (2, 2) mesh (2 sequences x 8 frames a rank); each rank asserts B1
     and B2 launched once per frame chunk; every result's pose_ok equal
     to, and its positions within 1e-4 of, phase 4's or 5e's; it prints
     each rank's CUDA-event ms per runner, the halo and gathered bytes
     from the runners' record of transfers and each world's wall time;
  5j. the profiling tools (tpu_vo_torch/tools: profile_headline,
     profile_features, select_breakdown, topk_micro, profile_4k,
     probe_4k_gap, profile_pairs, profile_ransac, profile_5pt_micro,
     profile_chain, streamed_probe, profile_batch8 (four of its seven
     variants), profile_batch8_flat (three of its seven points)), each
     through its main at its full shapes with reps and iters cut (at
     least 3 timed calls a row),
     counters reset just before each: every output line parses, B1's and
     B2's launches equal what the tool's calls imply (one B1 launch and
     no B2 a select_maps call in select_breakdown; none in topk_micro,
     profile_5pt_micro and profile_chain), and profile_features',
     profile_pairs' and profile_ransac's composed stages equal the
     function they split bit for bit; it prints each tool's seconds and
     CUDA-event ms by row, and with --profiling-out PATH writes every
     tool's result there;
  5k. the accuracy diagnostics and A/B probes (tpu_vo_torch/tools:
     harris_candidate_probe, dk_iters_diag, score_variants_diag,
     pan_blur_pair_probe, keepties_seed_sweep, keepties_diag,
     pan_harsh_ablation, parity_matrix, diagnose_ate; DIAGNOSTIC_TOOLS),
     each through its main at the JAX tool's shapes (dk_iters_diag with
     fewer timed calls), on scenes rendered and degraded in the pool
     with the others (diag_common.prefill), counters reset just before
     each: every output line parses and the last is its result on the
     card; B1's launches, those of its Harris-off instance among them,
     B2's and B3's equal what its calls imply; each tool checks the
     sha256 of every committed leg it reads (the phase requires the
     legs it names in DIAGNOSTIC_LEGS); then B1's Harris-off instance
     against select_maps_reference(..., with_harris=False) bit for bit at
     the probe's 8 level shapes (one frame of noise, per level and in one
     launch) and at the main path's 8 levels x 32 frames (one launch):
     its packed keys equal the Harris instance's and its Harris map is
     all zero; it prints each tool's seconds and rows, and with
     --diagnostics-out PATH writes every tool's result there;
  6. time the main path, its three stages and each kernel beside its
     plain version with CUDA events (medians after warm-up), and each
     kernel's bound: the larger of its bytes over 3.35 TB/s and its f32
     operations over 67 TFLOP/s (B1 and B3: their lane-instructions,
     counted from this run's compass candidates, over 33.5 T per second),
     from this run's shapes; B3's kernel alone, its registers and blocks
     per SM; P1 (8, 2,
     compact, 256 lanes), P2 (16, 8) and P3 (16, 8) and B2 at the probe's
     keypoints as the probe timed them, beside their plain versions and
     bounds, and the bf16 operations of P2's one-hot products; P1-P3's
     own device time (torch.profiler's kernel durations, no host work)
     and their blocks per SM; the library call of B2, P1, P2
     and P3: their plain versions' final gather as one aten::index call
     on prebuilt indices, checked equal to the kernel's output;
     B1 and B2 at B = 1 (one frame's 8 levels); B1's Harris-off instance
     beside its plain version and its bound (B1's bytes: the zero map is
     still written; fewer lane-instructions), and both instances'
     registers and blocks per SM (the Harris instance must keep
     B1_REGISTERS and MIN_BLOCKS) and each instance's own device time
     (torch.profiler's kernel durations);
  7. profile each stage, the main path and the streaming path (8 frames
     of run_sequence_scan) with torch.profiler: device busy time, kernel
     launches, host-device copies and stream synchronizations per run,
     and the top device time.

The line before the last is a JSON object with the kernels' names,
sources, launch counts, errors, times and bounds (B1 twice: its Harris
instance, select_maps, and its Harris-off instance,
select_maps_no_harris, whose launches are phase 5k's; B1's and B2's also
with their launches on each path, `launches_by_path`, and their times
and bounds at config 3's shapes, `at_config3`); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import multiprocessing
import os
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from tpu_vo_torch import api, cli  # noqa: E402
from tpu_vo_torch.configs import (MatchConfig, ORBConfig, RansacConfig, VOConfig,  # noqa: E402
                                  ViewerConfig)
from tpu_vo_torch.estimation.ransac import first_argmax  # noqa: E402
from tpu_vo_torch.features import brief, fast, orb, orientation, patches  # noqa: E402
from tpu_vo_torch.features.fast import _border_mask as fast_border  # noqa: E402
from tpu_vo_torch.image.filters import gaussian_blur  # noqa: E402
from tpu_vo_torch.image.pyramid import build_pyramid  # noqa: E402
from tpu_vo_torch.io import native_loader  # noqa: E402
from tpu_vo_torch.io.dataset import list_image_paths, load_frame, write_png  # noqa: E402
from tpu_vo_torch.io.jpeg import (decode as jpeg_decode, encode_gray, encode_rgb,  # noqa: E402
                                  roundtrip_gray)
from tpu_vo_torch.io.loader import PrefetchLoader  # noqa: E402
from tpu_vo_torch.io.kitti import load_kitti_poses  # noqa: E402
from tpu_vo_torch.io.trajectory_io import load_trajectory_tum  # noqa: E402
from tpu_vo_torch.matching.hamming import ratio_test_match  # noqa: E402
from tpu_vo_torch.ops import _build  # noqa: E402
from tpu_vo_torch.ops import fast as fast_ops, patch_probe  # noqa: E402
from tpu_vo_torch.ops.fast import (fast_margin, fast_margin_levels,  # noqa: E402
                                   fast_margin_reference)
from tpu_vo_torch.ops.patch import (RAW_RADIUS, RAW_SIZE, extract_patches,  # noqa: E402
                                    extract_patches_levels, extract_patches_reference)
from tpu_vo_torch.ops.patch import _starts as patch_starts  # noqa: E402
from tpu_vo_torch.ops.select import (compass_candidates, select_maps,  # noqa: E402
                                     select_maps_levels, select_maps_reference)
from tpu_vo_torch.ops.select import occupancy as select_occupancy  # noqa: E402
from tpu_vo_torch.models.refinement import refine_window  # noqa: E402
from tpu_vo_torch.parallel import distributed, sharding  # noqa: E402
from tpu_vo_torch.parallel.mesh import make_mesh  # noqa: E402
from tpu_vo_torch.parallel.sharding import (run_batch_of_sequences,  # noqa: E402
                                            run_batch_time_sharded, run_sequence_time_sharded)
from tpu_vo_torch.pipeline import runner, step  # noqa: E402
from tpu_vo_torch.tools import (bench, diag_common, io_bench, patch_slots_probe,  # noqa: E402
                                profile_rows, reference_band, run_benchmarks, stage_bench)
from tpu_vo_torch.tools.harris_candidate_probe import SELECT_KERNEL, _pyramid_shapes  # noqa: E402
from tpu_vo_torch.tools.device_time import device_time_ms  # noqa: E402
from tpu_vo_torch.utils.profiling import (busy_profile, card as _card, cuda_times,  # noqa: E402
                                          kernel_alone_ms)
from tpu_vo_torch.utils import synthetic  # noqa: E402
from tpu_vo_torch.utils.metrics import ate_rmse_aligned, trajectory_report  # noqa: E402
from tpu_vo_torch.utils.synthetic import compass_pattern, make_sequence  # noqa: E402
from tpu_vo_torch.geometry.se3 import Pose  # noqa: E402
from tpu_vo_torch.viz.overlay import draw_keypoints_overlay  # noqa: E402
from tpu_vo_torch.viz.trajectory import TrajectoryRenderer, view_eyes  # noqa: E402

W, H, T = 1241, 376, 32
# P1's 128- and 512-lane bands, which the probe's sweep runs only at 16
# slots, too many to fit: checked at slot counts that fit
PROBE_EXTRA = ((8, 4, False, 128), (8, 4, True, 128), (8, 2, True, 512))
# The probe's variants timed in phase 6, by wrapper: the fastest P1 that
# fits and P2, P3 at the tool's default slots
PROBE_TIMED = {"band_windows": ("P1", dict(kp_chunk=8, nslots=2, compact=True, lanes=256)),
               "phase_windows_mxu": ("P2", dict(kp_chunk=16, nslots=8)),
               "phase_windows_roll": ("P3", dict(kp_chunk=16, nslots=8))}
# their CUDA kernels' names, as the profiler reports them
PROBE_KERNEL_FN = {"band_windows": "band_kernel", "phase_windows_mxu": "phase_mxu_kernel",
                   "phase_windows_roll": "phase_roll_kernel"}
# B3's launches per pass of the stage benchmark's ablation: one per pyramid
# in each of +fast, +topk, +harris and +orientation
B3_PER_PASS = 4
# bf16 tensor-core operations per window of P2's two one-hot products as
# mma.sync tiles them, (48, 128) x (128, 48) and (48, 48) x (48, 48), for
# each of three bf16 parts, a multiply and an add per term: how P2
# computes, not what its function needs, so printed beside its bound
P2_OPS = 3 * 2 * (48 * 128 * 48 + 48 * 48 * 48)
BF16_OPS_PER_S = 989e12  # the tensor cores' dense bf16 peak at 700 W
SMALL_W, SMALL_H, SMALL_T = 480, 360, 8
# The VOConfig options that the default path does not take, each run once
# on the small sequence (phase 4c)
OPTIONS = {"ratio test": {"match": MatchConfig(use_ratio_test=True)},
           "count scoring": {"ransac": RansacConfig(score_method="count")},
           "8-point samples": {"ransac": RansacConfig(use_five_point=False)},
           "min_valid_fraction 0.5": {"ransac": RansacConfig(min_valid_fraction=0.5)}}
CLI_T = 24            # frames of the CLI phase
VIEWER_POSES = 1000   # synthetic poses of the larger render_step timing
VIEWER_REPS = 5       # timed render_step calls at each size
# The ingest phase (4e): bench.py's 64 frames, written as Paeth PNG files;
# the streamed runner over the native loader's chunks of 64 (bench.py's
# e2e leg) and over io_bench's host chunks of 16, against the batched
# runner at bench.py's frame_chunk 8 and pair_chunk 9
INGEST_T, INGEST_HOST_CHUNK = 64, 16
# Phase 4a: tools/bench at bench.py's configuration (:41-69), its baseline
# the committed one (the card's host has no cv2)
BENCH_SIZES = dict(T=64, width=W, height=H, features=1200, hyps=256, repeats=8, fc=8, pc=9,
                   reference="committed")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "cpu_baseline_fps"}
INGEST_FRAME_CHUNK, INGEST_PAIR_CHUNK = 8, 9
PAETH = 4
STREAM_PROFILE_T = 8  # streamed frames per profiled run
# The streaming path against the batched one on the same 32 frames: each
# pair draws the same samples; the world positions differ by the order of
# composition (frame after frame, against prefix doubling)
MAX_STREAM_POS_DIFF = 1e-4
# Accuracy bars of the main path on make_sequence(32, 1241, 376, seed=0),
# measured on the CPU on these frames: the port had pose_ok on 31/31 pairs
# and a mean per-pair rotation error of 0.833 deg (max 2.26), the JAX
# runner 31/31 and 0.812 deg (max 2.07). The bound leaves room for the
# card's other rounding.
MIN_POSE_OK = 0.7
MAX_MEAN_PAIR_ROT_ERR_DEG = 1.5
WARMUP, REPS, MAIN_REPS, PROFILE_RUNS = 2, 5, 20, 3
# The accuracy path (phases 5c-5e): the card's parity legs of the
# committed reference, config 5 and config 4 cut to B sequences of T4
# frames; every scene is rendered on the host by RENDER_WORKERS processes,
# all done before the first timed phase
PARITY_LEGS = ("card_corridor_640x480", "card_corridor_1241x376")
PARITY_SEEDS = 5
C5_T, C5_W, C5_H, C5_KPS = run_benchmarks.CONFIGS[5][:4]
_, C4_W, C4_H, C4_KPS = run_benchmarks.CONFIGS[4][:4]
C4_B, C4_T = 4, 16    # the cut: the benchmark has 8 sequences of 64 frames
# each frame chunk and each pair chunk within one sequence, so that a
# sequence's own run makes the same launches on the same inputs
C4_FRAME_CHUNK = run_benchmarks.FRAME_CHUNK
RENDER_WORKERS = 6
# config 7's object scenes whose median on-object inlier share must be at
# most 0.15 (tests/test_dynamic_scenes.py's bar); obj_heavy crosses the
# consensus majority by design and is reported, not gated
C7_EXCLUDED = ("obj_light", "obj_mid")
# Config 6 (phase 5h): the corridor rendered in ranges of C6_RANGE frames,
# then every level degraded in the pool; its bars: pose_ok on the corridor
# at every level and on the pan's clean level, the corridor's ATE over the
# extent against ground truth (the JAX record: 0.0017-0.0036 for tpu_vo,
# 0.0032-0.0361 for the reference); the pan's degraded levels are reported
C6_RANGE = 12
C6_DECODE_T = 8  # corridor frames encoded and decoded to time the JPEG reader at 640x480
C6_MAX_CORRIDOR_ATE = 0.01
# The file-format phase (4f): the main path's first VARIANT_T frames as
# baseline JPEG at VARIANT_QUALITY and as PNGs alternating 8-bit palette
# and Adam7-interlaced gray; the committed progressive and arithmetic-coded
# JPEG files, each native decode timed as the median of JPEG_NATIVE_REPS
VARIANT_T, VARIANT_QUALITY = 24, 90
JPEG_DATA = os.path.join(HERE, "tpu_vo_torch", "data", "jpeg")
JPEG_NATIVE_REPS = 5
# Phase 5i: the parallel runners. A world of 1 on NCCL in this process,
# then worlds of 2 and 4 gloo ranks sharing the card (NCCL refuses two
# ranks on one card), each rank a tools/parallel_run process; PAR_REPS
# timed calls of each runner after its counted one
PAR_REPS = 3
PAR_TIMEOUT = 60         # seconds a rank waits for the others and for a collective
PAR_WORLD_TIMEOUT = 240  # seconds a spawned world may take, start-up included
PAR_DEVICE = "cuda:0"    # every rank of a gloo world on this card
# Phase 5j: the profiling tools (tpu_vo_torch/tools), each through its main
# at its full shapes, reps and iters cut so that every row keeps at least 3
# timed calls. The config-4 tools run the rows that bound their answers:
# profile_batch8 its four variants of at most 2.8 s a run (the fc1_pc1
# variants, one frame and one pair a call, take 6.8-8.1 s a run of 8 x 16
# frames; vmap8_T64_fc8_pc9 is the same call as profile_batch8_flat's
# fc8_pc9 row), profile_batch8_flat pc 9 and 252 at fc 8 and fc 32 at pc
# 84; the other rows are run by hand (python -m tpu_vo_torch.tools.<name>)
PROFILING_TOOLS = {
    "profile_headline": dict(reps=1, iters=3),
    "profile_features": dict(reps=1, iters=3),
    "select_breakdown": dict(reps=3, iters=1),
    "topk_micro": dict(reps=16, iters=3),
    "profile_4k": dict(reps=1, iters=3),
    "probe_4k_gap": dict(reps=1, chain_reps=3, iters=3),
    "profile_pairs": dict(reps=1, iters=3),
    "profile_ransac": dict(reps=1, iters=3),
    "profile_5pt_micro": dict(reps=1, iters=3),
    "profile_chain": dict(reps=3, iters=1),
    "streamed_probe": dict(reps=3, iters=3),
    "profile_batch8": dict(reps=1, iters=3, variants=(
        "single_T96_fc8_pc95", "single_T96_fc8_pc5", "vmap8_T16_fc8_pc15", "vmap8_T16_fc2_pc3")),
    "profile_batch8_flat": dict(reps=1, iters=3, pcs=(9, 252), fcs=(32,)),
}
# the tools that launch no kernel of the port, and those whose composed
# stages the phase holds bit for bit against the function they split
PROFILING_NO_KERNELS = ("topk_micro", "profile_5pt_micro", "profile_chain")
PROFILING_COMPOSED = ("profile_features", "profile_pairs", "profile_ransac")
# Phase 5k: the accuracy diagnostics and A/B probes, each through its main
# at the JAX tool's shapes; dk_iters_diag with 2 x 3 timed calls a row (the
# JAX tool's 16 x 5 take about 30 s more)
DIAGNOSTIC_TOOLS = {
    "harris_candidate_probe": dict(),
    "dk_iters_diag": dict(reps=2, iters=3),
    "score_variants_diag": dict(),
    "pan_blur_pair_probe": dict(),
    "keepties_seed_sweep": dict(),
    "keepties_diag": dict(),
    "pan_harsh_ablation": dict(),
    "parity_matrix": dict(),
    "diagnose_ate": dict(),
}
DIAGNOSTIC_CUTS = {"dk_iters_diag": "timed calls cut to reps 2 x iters 3 (the JAX tool's 16 x 5)"}
# the committed legs whose frames the tools must hash to the legs' sha256
DIAGNOSTIC_LEGS = ("config1", "config2", "diag_pan_320x240", "diag_corridor_320x240",
                   "config6_pan_clean", "config6_pan_harsh", "diag_pan_only_noise",
                   "diag_pan_only_exposure", "diag_pan_only_blur", "diag_pan_only_jpeg",
                   "diag_planes_640x480")
# their scenes, rendered in the pool in ranges of DIAG_RANGE frames (the
# pan of 32 frames at 320x240 is config 6's clean pan, rendered already)
DIAGNOSTIC_SCENES = (("planes", 16, 1241, 376, 0), ("corridor", 16, 1241, 376, 0),
                     ("corridor", 64, 1241, 376, 0), ("corridor", 96, 640, 480, 0),
                     ("pan", 48, 320, 240, 0), ("corridor", 48, 320, 240, 0),
                     ("planes", 30, 640, 480, 0))
DIAG_RANGE = 16
# B1's Harris instance as ptxas builds it before and beside its Harris-off
# instance (csrc/select.cu's header): 47 registers, MIN_BLOCKS 5 blocks per SM
B1_REGISTERS, B1_BLOCKS = 47, 5
# refine_window on the card against the CPU on the same inputs, in float32
# (the pipeline's) and in float64 (where the LM's accept decisions do not
# turn on the last bits)
MAX_REFINE_DIFF = 1e-3
MAX_REFINE_DIFF_F64 = 1e-8

# The card's peaks for the bounds (H100 SXM data sheet, at 700 W): HBM
# bytes per second and f32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Kernels B1 and B3 are counted in issued lane-instructions, one per lane
# per clock for f32 min/max and adds alike: 132 SMs x 128 lanes x 1.98 GHz.
LANE_INSTR_PER_S = 33.5e12
# B3, per pixel inside its 3-pixel border: the compass test (4
# differences, 8 compares, 4 to combine); per compass candidate among
# them, the other 12 differences, the exact arc scan (47 min/max per
# polarity) and 2 to join the polarities.
FAST_COMPASS_OPS = 16
FAST_ARC_OPS = 12 + 2 * 47 + 2
# Per pixel inside the edge-threshold border: the compass test (4
# differences, 8 compares, 4 to combine), strict NMS (8 maxes, 1 compare,
# 1 and), Harris (two Sobel stencils of 6, 3 products, 3 separable 7x7 box
# sums of 12 adds, 8 for the response, 1 border select), the packed key
# (bit reverse, shift, or, subtract, select) and half a compare for the
# 2-row pool.
SELECT_HARRIS_OPS = 12 + 3 + 36 + 8 + 1
SELECT_OPS = 16 + 10 + SELECT_HARRIS_OPS + 5 + 1
# Per compass candidate: the other 12 differences, the exact arc scan (47
# min/max per polarity) and 2 to join the polarities.
SELECT_ARC_OPS = 12 + 2 * 47 + 2


def _cuda_ms(fn, warmup=WARMUP, reps=REPS) -> float:
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    return statistics.median(cuda_times(fn, warmup=warmup, reps=reps))


def _bound(nbytes: float, ops: float):
    """(ms, what bounds it): the larger of bytes over the HBM rate and
    f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _union_pixels(shape, rows, cols, keep=None) -> int:
    """Pixels of (B, H, W) levels that windows of rows (B, N, R) x cols
    (B, N, C) cover, each counted once (rows where keep (B, N, R) is
    False read nothing): what a window kernel must read."""
    b, h, w = shape
    cover = torch.zeros((b, max(h, int(rows.max()) + 1), max(w, int(cols.max()) + 1)),
                        dtype=torch.int32, device=rows.device)
    bi = torch.arange(b, device=rows.device)[:, None, None, None]
    hit = torch.ones((), dtype=torch.int32, device=rows.device)
    if keep is not None:
        hit = keep[..., None].to(torch.int32)
    cover.index_put_((bi, rows[..., :, None], cols[..., None, :]),
                     hit.expand(*rows.shape, cols.shape[-1]), accumulate=True)
    return int((cover[:, :h, :w] > 0).sum())


def _window_pixels(levels, kps) -> int:
    """Pixels of the levels that the keypoints' 43x43 windows cover (the
    union, each counted once): what extract_patches must read."""
    total = 0
    r = torch.arange(RAW_SIZE, device=levels[0].device)
    for lvl, (ys, xs) in zip(levels, kps):
        b, h, w = lvl.shape
        y0 = torch.clamp(ys.long() - RAW_RADIUS, 0, max(h, RAW_SIZE) - RAW_SIZE)
        x0 = torch.clamp(xs.long() - RAW_RADIUS, 0, max(w, RAW_SIZE) - RAW_SIZE)
        total += _union_pixels(lvl.shape, y0[..., None] + r, x0[..., None] + r)
    return total


def _select_bound(levels, thr: int, border: int, with_harris: bool = True):
    """B1's bound on these levels: ((ms, what bounds it), bytes,
    lane-instructions, pixels inside the border, compass candidates among
    them). Bytes: each level read once, its Harris map (zero or not) and
    packed keys written once; lane-instructions: SELECT_OPS per pixel
    inside the border (less SELECT_HARRIS_OPS without Harris) and
    SELECT_ARC_OPS per compass candidate, from these levels."""
    dev = levels[0].device
    inner = [fast_border(lv.shape[-2], lv.shape[-1], border, dev) for lv in levels]
    n_inner = sum(lv.shape[0] * int(m.sum()) for lv, m in zip(levels, inner))
    n_cand = sum(int((compass_candidates(lv, thr) & m).sum()) for lv, m in zip(levels, inner))
    nbytes = sum(b * (8 * h * w + 4 * ((h + 1) // 2) * (w + w % 2))
                 for b, h, w in (lv.shape for lv in levels))
    ops = SELECT_OPS if with_harris else SELECT_OPS - SELECT_HARRIS_OPS
    instr = ops * n_inner + SELECT_ARC_OPS * n_cand
    bound = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                (instr / LANE_INSTR_PER_S * 1e3, "operations"))
    return bound, nbytes, instr, n_inner, n_cand


def _patch_bound(levels, kp):
    """B2's bound: the pixels its windows cover, read once, and per slot
    its keypoint in and its 43x43 f32 window out, over the HBM rate."""
    return _bound(4 * _window_pixels(levels, kp)
                  + sum(ys.shape[0] * ys.shape[1] * (8 + 4 * RAW_SIZE * RAW_SIZE)
                        for ys, _ in kp), 0)


def _library_gather(levels, windows):
    """(flat, idx) such that flat[idx], one aten::index call, is the
    windows: the levels' pixels flattened, with a 0 after them; windows,
    per level, (rows (B, n, R), cols (B, n, C)[, keep (B, n, R)]), a pixel
    past the level or in a row where keep is False reading the 0."""
    flat = torch.cat([lv.flatten() for lv in levels] + [levels[0].new_zeros(1)])
    parts, off = [], 0
    for lv, (rows, cols, *keep) in zip(levels, windows):
        b, h, w = lv.shape
        r, c = rows[..., :, None], cols[..., None, :]
        bi = torch.arange(b, device=lv.device)[:, None, None, None]
        ok = (r < h) & (c < w)
        if keep:
            ok = ok & keep[0][..., None]
        parts.append(torch.where(ok, off + (bi * h + r) * w + c, flat.numel() - 1))
        off += lv.numel()
    return flat, torch.cat(parts, 1)


def _sass_count(lib_path: str, function: str, opcode: str) -> int:
    """Instructions starting with `opcode` in the SASS of the kernels
    whose name holds `function`, from cuobjdump."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside and f" {opcode}" in line:
            count += 1
    return count


def _pair_rot_err_deg(R_wc: np.ndarray, Rs_gt) -> np.ndarray:
    """Geodesic error (deg) of each consecutive relative rotation."""
    errs = []
    for i in range(len(Rs_gt) - 1):
        est = R_wc[i].T @ R_wc[i + 1]
        gt = Rs_gt[i].T @ Rs_gt[i + 1]
        c = (np.trace(est.T @ gt) - 1.0) / 2.0
        errs.append(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    return np.asarray(errs)


def _reset(kernels):
    """Set the launch counters of {name: wrapper} to 0 (B1's count of its
    Harris-off launches too)."""
    for k in kernels.values():
        k.launches = 0
    select_maps.launches_no_harris = 0


def _hold_b1_b2(label, frames, ocfg, card):
    """B1 and B2 against their plain versions bit for bit at a path's own
    shapes: the pyramid of `frames` (one stage-1 launch's) and the
    keypoints that detect_and_compute ranks from B1's maps under `ocfg`.
    Counted launches go to the counters: call it outside a counted run.
    Returns (levels, ys, xs, slot offsets with the total last)."""
    budgets = orb.features_per_level(ocfg.n_features, ocfg.n_levels, ocfg.scale_factor)
    used = [(lv.contiguous(), n) for lv, n in zip(
        build_pyramid(frames, ocfg.n_levels, ocfg.scale_factor), budgets) if n > 0]
    levels = [lv for lv, _ in used]
    thr, brd = ocfg.fast_threshold, ocfg.edge_threshold
    maps = select_maps_levels(levels, thr, brd)
    ys_all, xs_all, starts = [], [], [0]
    for (lvl, n), (pk, hk, bk) in zip(used, maps):
        pr, hr, br = select_maps_reference(lvl, thr, brd)
        torch.cuda.synchronize()
        if bk != br or not torch.equal(pk, pr) or not torch.equal(hk, hr):
            raise AssertionError(f"{label}: select_maps_levels differs from its plain version at "
                                 f"{tuple(lvl.shape)}: packed {int((pk != pr).sum())} cells, "
                                 f"harris max {float((hk - hr).abs().max())}")
        h, w = lvl.shape[-2:]
        ys, xs, _, _ = orb._rank_from_maps(pk, hk, bk, w, n, ocfg, h * w)
        ys_all.append(ys)
        xs_all.append(xs)
        starts.append(starts[-1] + ys.shape[1])
    ys, xs = torch.cat(ys_all, 1).contiguous(), torch.cat(xs_all, 1).contiguous()
    a = extract_patches_levels(levels, ys, xs, starts[:-1])
    b = torch.cat([extract_patches_reference(lv, ys[:, o:e], xs[:, o:e])
                   for lv, o, e in zip(levels, starts, starts[1:])], 1)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{label}: extract_patches_levels differs from its plain version "
                             f"on {int((a != b).flatten(2).any(-1).sum())} windows")
    print(f"{label}: select_maps_levels == plain at {[tuple(lv.shape) for lv in levels]}, "
          f"border {brd}; extract_patches_levels == plain on {ys.numel()} slots "
          f"({starts[-1]} a frame) [{card}]", flush=True)
    return levels, ys, xs, starts


def _card_vs_cpu(label, frames, Rs_gt, cfg):
    """Run run_sequence_batched on the CPU and on the card over the same
    frames; print how they agree; fail where the card's pose_ok falls
    below the bar or its rotation error exceeds the CPU's by 0.5 deg."""
    pc, dc = runner.run_sequence_batched(frames, cfg, seed=0, device="cpu")
    pg, dg = runner.run_sequence_batched(frames, cfg, seed=0)
    rc = _pair_rot_err_deg(pc.R.double().numpy(), Rs_gt)
    rg = _pair_rot_err_deg(pg.R.double().cpu().numpy(), Rs_gt)
    dev_rot = _pair_rot_err_deg(pg.R.double().cpu().numpy(), list(pc.R.double().numpy()))
    kp_agree = float((dg["num_keypoints"].cpu() == dc["num_keypoints"]).float().mean())
    ok_agree = float((dg["pose_ok"].cpu() == dc["pose_ok"]).float().mean())
    print(f"{label}, card vs CPU: pose_ok {float(dg['pose_ok'].float().mean()):.3f} vs "
          f"{float(dc['pose_ok'].float().mean()):.3f} (equal on {ok_agree:.3f} of pairs), "
          f"rotation error vs truth {rg.mean():.4f} vs {rc.mean():.4f} deg, per-pair rotation "
          f"difference max {dev_rot.max():.4f} deg, keypoint counts equal on {kp_agree:.3f} of "
          f"frames", flush=True)
    if not (float(dg["pose_ok"].float().mean()) >= MIN_POSE_OK and rg.mean() < rc.mean() + 0.5):
        raise AssertionError(f"the card and the CPU disagree on the {label}")


def _bench_phase(kernels, card):
    """Phase 4a: tools/bench at bench.py's configuration, counted; its line,
    ratio, launches, accuracy and IO leg checked; then B1 and B2 bit for
    bit at one 8-frame chunk's shapes. Returns the B1 and B2 launches."""
    o = dict(BENCH_SIZES)
    frames_np, Rs_gt = bench.scene(o["T"], W, H)
    buf = io.StringIO()
    _reset(kernels)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench.main([], **o)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    lines = buf.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    print(f"bench: {secs:.1f} s for one call (T {o['T']}, {o['repeats']} repeats x "
          f"{bench.WARMUP_WINDOWS + bench.WINDOWS} windows, fc {o['fc']}, pc {o['pc']}); "
          f"launches {launches} [{card}]", flush=True)
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} lines on stdout, not 1")
    line = json.loads(lines[0])
    rec = bench.last_run()
    if (set(line) != BENCH_KEYS | {"e2e_decode_fps"} or line["metric"] != bench.METRIC
            or line["unit"] != bench.UNIT or not line["e2e_decode_fps"] > 0):
        raise AssertionError(f"the bench's line is not bench.py's with e2e_decode_fps: {line}")
    # bench.py rounds value, the baseline and their ratio each on its own;
    # the ratio of the two printed numbers is within 0.01 of vs_baseline
    if not (line["value"] > 0 and line["value"] == round(rec["fps"], 2)
            and line["vs_baseline"] == round(rec["fps"] / rec["cpu_baseline_fps"], 2)
            and abs(line["vs_baseline"] - line["value"] / line["cpu_baseline_fps"]) <= 0.01):
        raise AssertionError(f"the bench's value and ratio disagree: {line}")
    n = (bench.WARMUP_WINDOWS + bench.WINDOWS) * o["repeats"] * profile_rows.frame_launches(
        o["T"], o["fc"]) + io_bench.e2e_decode_launches(o["T"])
    want = {"select_maps": n, "extract_patches": n, "fast_margin": 0}
    if launches != want or rec["expected_launches"] != {k: n for k in profile_rows.KERNELS}:
        raise AssertionError(f"the bench's launches {launches} are not {want}")
    poses, diags = rec["poses"], rec["diagnostics"]
    pose_ok = float(diags["pose_ok"].float().mean())
    rot = _pair_rot_err_deg(poses.R.double().cpu().numpy(), Rs_gt)
    print(f"bench's last run: pose_ok {pose_ok:.3f}, mean per-pair rotation error "
          f"{rot.mean():.4f} deg (max {rot.max():.4f}) over {len(rot)} pairs", flush=True)
    if len(rot) != o["T"] - 1 or pose_ok < MIN_POSE_OK or not rot.mean() < MAX_MEAN_PAIR_ROT_ERR_DEG:
        raise AssertionError("the bench's run is below the main path's accuracy bar")
    chunk = torch.from_numpy(frames_np[:o["fc"]].copy()).cuda()
    ocfg = ORBConfig(n_features=o["features"])
    _hold_b1_b2(f"bench (one {o['fc']}-frame chunk)", chunk, ocfg, card)
    return launches


def _write_kitti_tree(root, frames, Rs, ts, K) -> str:
    """root/sequences/00 (image_0/*.png, the row filters in turn; calib.txt
    with P0 = K [I | 0]; times.txt) and root/poses/00.txt from the
    ground truth; returns the sequence directory."""
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "image_0"))
    for i, f in enumerate(frames):
        write_png(os.path.join(seq, "image_0", f"{i:06d}.png"), f, filter_type=i % 5)
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        P = np.hstack([K, np.zeros((3, 1))])
        f.write("P0: " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n")
    np.savetxt(os.path.join(seq, "times.txt"), 0.1 * np.arange(len(frames)), fmt="%.6f")
    os.makedirs(os.path.join(root, "poses"))
    T_wc = np.concatenate([np.asarray(Rs), np.asarray(ts)[..., None]], -1)
    np.savetxt(os.path.join(root, "poses", "00.txt"), T_wc.reshape(len(frames), 12), fmt="%.9e")
    return seq


def _streaming_phase(frames_np, frames, Rs_gt, cfg, kernels, poses, diags, card):
    """VisualOdometry over the frames, counted and timed per frame; its
    accuracy; run_sequence_scan against the batched run (poses, diags)
    of the same frames; the tie rules of RANSAC's winners on the card."""
    T = len(frames_np)
    _reset(kernels)
    vo = api.VisualOdometry(cfg.image_width, cfg.image_height, config=cfg)
    frame_ms = []
    for i, img in enumerate(frames_np):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        vo.process_frame(api.Frame.from_image(i, img))
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
    stream_launches = {name: k.launches for name, k in kernels.items()}
    print(f"streaming path launches: {stream_launches} for {T} frames", flush=True)
    if stream_launches["select_maps"] != T or stream_launches["extract_patches"] != T:
        raise AssertionError(f"the streaming path did not launch B1 and B2 once per frame: "
                             f"{stream_launches}")
    stream_ms = statistics.median(frame_ms[2:])
    sq1, _, sq3 = statistics.quantiles(frame_ms[2:], n=4)
    s_ok = float(np.mean([r["pose_ok"] for r in vo.get_records()[1:]]))
    s_R = np.stack([p.R.double().numpy() for p in vo.get_trajectory_poses()])
    s_rot = _pair_rot_err_deg(s_R, Rs_gt)
    print(f"streaming path (VisualOdometry.process_frame): {stream_ms:.3f} ms per frame (median "
          f"of {T - 2} after 2 warm-up frames, quartiles {sq1:.3f}-{sq3:.3f} ms) = "
          f"{1000.0 / stream_ms:.2f} frames/s; pose_ok {s_ok:.3f}, mean per-pair rotation error "
          f"{s_rot.mean():.4f} deg (max {s_rot.max():.4f}) [{card}]", flush=True)
    if s_ok < MIN_POSE_OK or not s_rot.mean() < MAX_MEAN_PAIR_ROT_ERR_DEG:
        raise AssertionError("streaming path accuracy below its bar")
    scan = runner.run_sequence_scan(frames, cfg, seed=0)
    if not (scan.pose.R.shape == (T, 3, 3) and scan.F.shape == (T, 3, 3)
            and all(bool(torch.isfinite(x).all()) for x in (scan.pose.R, scan.pose.t, scan.F))):
        raise AssertionError("run_sequence_scan gave non-finite or misshapen outputs")
    same_ok = float((scan.pose_ok[1:] == diags["pose_ok"]).float().mean())
    pos_diff = float((scan.pose.t - poses.t).abs().max())
    vo_t = torch.stack([p.t for p in vo.get_trajectory_poses()])
    facade_diff = float((vo_t - scan.pose.t.cpu()).abs().max())
    print(f"run_sequence_scan vs run_sequence_batched, seed 0: pose_ok equal on {same_ok:.3f} of "
          f"pairs, world positions differ by at most {pos_diff:.3e} (bar {MAX_STREAM_POS_DIFF}); "
          f"VisualOdometry vs run_sequence_scan {facade_diff:.3e}", flush=True)
    if same_ok < 1.0 or not pos_diff <= MAX_STREAM_POS_DIFF:
        raise AssertionError("the streaming and batched runners disagree")
    ties = torch.randint(0, 3, (64, 300), generator=torch.Generator().manual_seed(1))
    first_max = first_argmax(ties.to(frames.device)).cpu()
    first_min = torch.argmin(ties.to(frames.device).float(), -1).cpu()
    want_max = torch.from_numpy(np.argmax(ties.numpy(), -1))  # numpy: the first of ties
    want_min = torch.from_numpy(np.argmin(ties.numpy(), -1))
    print(f"ties on the card: first_argmax takes the first maximum on "
          f"{float((first_max == want_max).float().mean()):.3f} of 64 rows, torch.argmin the "
          f"first minimum on {float((first_min == want_min).float().mean()):.3f}", flush=True)
    if not (torch.equal(first_max, want_max) and torch.equal(first_min, want_min)):
        raise AssertionError("RANSAC's tie rule (first maximum, first minimum) fails on the card")
    return stream_launches


@contextlib.contextmanager
def _frame_clock():
    """cli.vo_step wrapped to note the host clock as each frame's step
    starts; yields the list of those times."""
    stamps, step = [], cli.vo_step

    def timed(*args, **kwargs):
        stamps.append(time.perf_counter())
        return step(*args, **kwargs)

    cli.vo_step = timed
    try:
        yield stamps
    finally:
        cli.vo_step = step


def _ms_per_frame(stamps) -> float:
    """Median ms between successive frames' steps, the first interval
    (the loop's warm-up) left out."""
    return float(np.median(np.diff(stamps)[1:])) * 1e3


def _cli_phase(seq_dir, n, K, kernels, card):
    """tpu_vo_torch.cli.main --no-viewer over the KITTI tree of n PNG
    frames, counted; its three trajectory files and its ATE line. Returns
    (launches, the npz's positions, ms a frame)."""
    png = os.path.join(seq_dir, "image_0")
    decode_ms = {}
    for i, name in ((0, "no filter"), (4, "Paeth")):
        t0 = time.perf_counter()
        load_frame(os.path.join(png, f"{i:06d}.png"))
        decode_ms[name] = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as out_dir:
        _reset(kernels)
        text = io.StringIO()
        t0 = time.perf_counter()
        with _frame_clock() as stamps, contextlib.redirect_stdout(text):
            rc = cli.main([seq_dir, "--no-viewer", "--quiet", "--out-dir", out_dir])
        cli_s = time.perf_counter() - t0
        cli_launches = {name: k.launches for name, k in kernels.items()}
        text = text.getvalue()
        stamps_tum, _ = load_trajectory_tum(os.path.join(out_dir, "trajectory_tum.txt"))
        kitti_R, _ = load_kitti_poses(os.path.join(out_dir, "trajectory_kitti.txt"))
        with np.load(os.path.join(out_dir, "trajectory.npz")) as z:
            cli_t = z["t"]
    ms = _ms_per_frame(stamps)
    lines = [ln.strip() for ln in text.splitlines()
             if "ate_rmse=" in ln or "Throughput" in ln or ln.startswith("Decoder:")]
    print(f"CLI --no-viewer over a KITTI tree of {n} PNG frames: exit {rc}, {cli_s:.3f} s in all, "
          f"{ms:.3f} ms a frame (host clock between frames, median), launches {cli_launches}, "
          f"poses in the TUM/KITTI/npz files {len(stamps_tum)}/{len(kitti_R)}/{len(cli_t)}; "
          f"{' | '.join(lines)}; PNG decode of one {K[0, 2] * 2:.0f}x{K[1, 2] * 2:.0f} "
          f"frame (host): {decode_ms['no filter']:.1f} ms unfiltered, {decode_ms['Paeth']:.1f} ms "
          f"Paeth [{card}]", flush=True)
    if (rc != 0 or (len(stamps_tum), len(kitti_R), len(cli_t)) != (n,) * 3
            or not any("ate_rmse=" in ln for ln in lines)
            or "Decoder: native" not in lines
            or cli_launches["select_maps"] != n or cli_launches["extract_patches"] != n):
        raise AssertionError("the CLI run failed its checks")
    return cli_launches, cli_t, ms


def _median_ms(fn, reps=VIEWER_REPS) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _viewer_phase(seq_dir, frames_np, cfg, cli_t, cli_ms, kernels, card):
    """Phase 4d2: the CLI's default run over the same tree, counted, with
    render_step counted and each screenshot checked against the port's own
    render; the overlay on the card against a CPU copy of its features;
    the native loader on Adam7 PNGs. Returns the run's launches."""
    n = len(frames_np)
    renders, shot_s = [], []
    render_step, save_shots = api.TrajectoryViewer.render_step, cli.save_trajectory_screenshots

    def counted_render(self, poses):
        renders.append(len(poses))
        return render_step(self, poses)

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        ok = save_shots(*args, **kwargs)
        shot_s.append(time.perf_counter() - t0)
        return ok

    with tempfile.TemporaryDirectory() as out_dir:
        api.TrajectoryViewer.render_step, cli.save_trajectory_screenshots = counted_render, timed_save
        try:
            _reset(kernels)
            text = io.StringIO()
            with _frame_clock() as stamps, contextlib.redirect_stdout(text):
                rc = cli.main([seq_dir, "--quiet", "--out-dir", out_dir])
            launches = {name: k.launches for name, k in kernels.items()}
        finally:
            api.TrajectoryViewer.render_step, cli.save_trajectory_screenshots = render_step, save_shots
        ms = _ms_per_frame(stamps)
        with np.load(os.path.join(out_dir, "trajectory.npz")) as z:
            R, t = z["R"], z["t"]
        pos_diff = float(np.abs(t - cli_t).max()) if t.shape == cli_t.shape else float("inf")
        shots = os.path.join(out_dir, "trajectory_screenshots")
        names = sorted(os.listdir(shots)) if os.path.isdir(shots) else []
        renderer = TrajectoryRenderer(ViewerConfig())
        renderer.build_scene(Pose(torch.from_numpy(R), torch.from_numpy(t)))
        segments = len(renderer.segments[0])
        bad = []
        for tag, eye, center, up in view_eyes(t.astype(np.float64)):
            path = os.path.join(shots, f"trajectory_view_from_{tag}.jpg")
            data = b""
            if os.path.exists(path):
                with open(path, "rb") as f:
                    data = f.read()
            own = encode_rgb(renderer.render(eye, center, up), ViewerConfig().jpeg_quality)
            if data != own or jpeg_decode(data, path).shape != (768, 1024, 3):
                bad.append(tag)
        saved = f"Saved trajectory screenshots to: {shots}" in text.getvalue()
    print(f"CLI default run (viewer every frame, 7 screenshots) over the same {n} frames: exit "
          f"{rc}, {ms:.3f} ms a frame against {cli_ms:.3f} with --no-viewer (host clock between "
          f"frames, median), launches {launches}, render_step called {len(renders)} times, "
          f"positions against the --no-viewer run: max diff {pos_diff:.3e}; screenshots "
          f"{len(names)} files in {shot_s[0] if shot_s else float('nan'):.3f} s, each equal to "
          f"encode_rgb of its own render and (768, 1024, 3) through io/jpeg.decode: "
          f"{not bad and len(names) == 7} [{card}]", flush=True)
    if (rc != 0 or renders != list(range(1, n + 1)) or pos_diff != 0.0 or bad or len(names) != 7
            or not saved or launches["select_maps"] != n or launches["extract_patches"] != n):
        raise AssertionError(f"the CLI's default run failed its checks (views off: {bad})")

    viewer = api.TrajectoryViewer()
    traj = [Pose(torch.from_numpy(r), torch.from_numpy(c)) for r, c in zip(R, t)]
    ms24 = _median_ms(lambda: viewer.render_step(traj))
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.normal(0.0, 0.05, (VIEWER_POSES, 3)) + [0.0, 0.0, 0.3], 0)
    big = [Pose(torch.eye(3), torch.from_numpy(c.astype(np.float32))) for c in walk]
    ms_big = _median_ms(lambda: viewer.render_step(big))
    renderer.build_scene(Pose(torch.eye(3).expand(VIEWER_POSES, 3, 3), torch.from_numpy(walk)))
    print(f"render_step (build_scene + render, 1024x768): {ms24:.3f} ms at {n} poses "
          f"({segments} segments), {ms_big:.3f} ms at {VIEWER_POSES} poses "
          f"({len(renderer.segments[0])} segments); median of {VIEWER_REPS}, host clock [{card}]",
          flush=True)

    vo = api.VisualOdometry(cfg.image_width, cfg.image_height, config=cfg)
    vo.process_frame(api.Frame.from_image(0, frames_np[0]))
    frame = api.Frame.from_image(1, frames_np[1])
    t0 = time.perf_counter()
    overlay = vo.process_frame(frame, render_overlay=True)
    overlay_ms = (time.perf_counter() - t0) * 1e3
    prev = vo._state.prev
    if prev.xy.device.type != "cuda":
        raise AssertionError("the facade's features are not on the card")
    cpu = type(prev)(*(x.cpu() for x in prev))
    want = draw_keypoints_overlay(frames_np[1], cpu)
    valid = cpu.valid.numpy()
    same = (overlay.shape == want.shape and np.array_equal(overlay, want)
            and np.array_equal(frame.keypoints, cpu.xy.numpy()[valid])
            and np.array_equal(frame.descriptors, cpu.desc.numpy()[valid]))
    print(f"process_frame(render_overlay=True) on the card: {int(valid.sum())} keypoints, "
          f"overlay {overlay.shape} equal to draw_keypoints_overlay of a CPU copy of the "
          f"features: {same}; {overlay_ms:.3f} ms for the frame with its overlay [{card}]",
          flush=True)
    if not same:
        raise AssertionError("the overlay on the card differs from the CPU copy's")

    with tempfile.TemporaryDirectory() as d:
        for i, f in enumerate(frames_np[:4]):
            _png_variant(os.path.join(d, f"{i:06d}.png"), f, palette=i % 2 == 0)
        with native_loader.NativeDataset(d) as ds:
            got = list(ds)
        paths = list_image_paths(d)
        if [i for i, _ in got] != [0, 1, 2, 3] or any(
                not np.array_equal(f, load_frame(p)) for (_, f), p in zip(got, paths)):
            raise AssertionError("the native loader does not read Adam7 PNGs as the Python "
                                 "reader does")
    print("native loader on Adam7 PNGs: 4 frames (Adam7 gray, palette) equal the Python "
          "reader's", flush=True)
    return launches


def _png_variant(path, img, palette: bool) -> None:
    """An 8-bit PNG of a 2-D uint8 image (no row filter): palette (the
    pixels as indices into a PLTE of the 256 grays) or Adam7-interlaced
    gray. io/dataset has no writer of these kinds, as tpu_vo has none."""
    h, w = img.shape

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    def rows(a):
        if a.size == 0:
            return b""
        return np.concatenate([np.zeros((a.shape[0], 1), np.uint8), a], 1).tobytes()

    if palette:
        head = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)
        extra = chunk(b"PLTE", np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes())
        data = rows(img)
    else:
        head = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 1)
        extra = b""
        data = b"".join(rows(img[y0::dy, x0::dx]) for x0, y0, dx, dy in (
            (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
            (0, 1, 1, 2)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head) + extra
                + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _frame_sha(frame) -> str:
    return hashlib.sha256(np.ascontiguousarray(frame, np.uint8).tobytes()).hexdigest()


def _committed_jpegs():
    """tpu_vo_torch/data/jpeg's manifest entries, each file's bytes checked
    against its sha256 (a mismatch raises), with the bytes under "data"."""
    with open(os.path.join(JPEG_DATA, "manifest.json")) as f:
        entries = json.load(f)["files"]
    for e in entries:
        with open(os.path.join(JPEG_DATA, e["file"]), "rb") as f:
            e["data"] = f.read()
        if hashlib.sha256(e["data"]).hexdigest() != e["sha256"]:
            raise AssertionError(f"{e['file']}: its bytes are not the manifest's")
    return entries


def _variants_phase(frames_np, kernels, card):
    """Phase 4f: the frames as baseline JPEG (encode_gray), as palette and
    Adam7 PNGs, and the committed progressive JPEG of the first 8; each
    directory through load_frame (timed), PrefetchLoader onto the card (the
    Python reader, then the native loader) and the CLI (counted, through
    the native loader), against the frames they hold (by sha256) and the
    CLI's runner on those frames in memory; then each committed JPEG alone
    through both readers, timed against the baseline file. Returns {path:
    launches}."""
    committed = _committed_jpegs()
    progressive = [e for e in committed if e["file"].startswith("progressive/")]
    # (its frames' sha256, a writer of frame i into directory d)
    formats = {
        "JPEG": ([_frame_sha(roundtrip_gray(f, VARIANT_QUALITY)) for f in frames_np],
                 lambda d, i: open(os.path.join(d, f"{i:06d}.jpg"), "wb").write(
                     encode_gray(frames_np[i], VARIANT_QUALITY))),
        "palette/Adam7 PNG": ([_frame_sha(f) for f in frames_np],
                              lambda d, i: _png_variant(os.path.join(d, f"{i:06d}.png"),
                                                        frames_np[i], palette=i % 2 == 0)),
        "progressive JPEG": ([e["frame_sha256"] for e in progressive],
                             lambda d, i: open(os.path.join(d, f"{i:06d}.jpg"), "wb").write(
                                 progressive[i]["data"])),
    }
    H_, W_ = frames_np[0].shape
    cli_cfg = cli.build_config(argparse.Namespace(features=1200, levels=8, ratio_test=False,
                                                  ransac_iters=256, scale=0.3), W_, H_)
    counts, python_ms, dirs = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        for fmt, (want, write) in formats.items():
            if fmt == "progressive JPEG":
                t_new = time.perf_counter()  # the committed JPEGs' share of the phase
            n = len(want)
            d = dirs[fmt] = os.path.join(root, fmt.split("/")[0].replace(" ", "_").lower())
            os.makedirs(d)
            for i in range(n):
                write(d, i)
            paths = list_image_paths(d)
            t0 = time.perf_counter()
            decoded = [load_frame(p) for p in paths]
            python_ms[fmt] = ms = (time.perf_counter() - t0) * 1e3 / len(paths)
            if [_frame_sha(f) for f in decoded] != want:
                raise AssertionError(f"{fmt}: load_frame does not give the frames written")
            for use_native in (False, True):
                loader = PrefetchLoader(paths, device="cuda", use_native=use_native)
                got = [(i, t) for i, _, t in loader]
                if (loader.decoder != ("native" if use_native else "python")
                        or [i for i, _ in got] != list(range(n)) or any(
                        t.device.type != "cuda" or _frame_sha(t.cpu().numpy()) != h
                        for (_, t), h in zip(got, want))):
                    raise AssertionError(f"{fmt}: PrefetchLoader(use_native={use_native}) "
                                         f"({loader.decoder}) skipped or changed frames: "
                                         f"{[i for i, _ in got]}")
            out_dir = os.path.join(root, "out_" + os.path.basename(d))
            _reset(kernels)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main([d, "--no-viewer", "--quiet", "--out-dir", out_dir])
            counts[f"CLI over {fmt} ({n} frames)"] = c = {k: v.launches for k, v in kernels.items()}
            decoder = next((ln.strip() for ln in text.getvalue().splitlines()
                            if ln.startswith("Decoder:")), "")
            with np.load(os.path.join(out_dir, "trajectory.npz")) as z:
                cli_t = z["t"]
            scan = runner.run_sequence_scan(torch.from_numpy(np.stack(decoded)), cli_cfg, seed=0)
            diff = float(np.abs(cli_t - scan.pose.t.double().cpu().numpy()).max())
            held = {"JPEG": "roundtrip_gray of the originals", "palette/Adam7 PNG": "the originals",
                    "progressive JPEG": "the manifest's frames (tpu_vo's decode)"}[fmt]
            print(f"{fmt} frames from files ({n} of {W_}x{H_}"
                  f"{f', quality {VARIANT_QUALITY}' if fmt == 'JPEG' else ''}): load_frame "
                  f"{ms:.1f} ms per decoded frame (host); all {n} equal to {held} by sha256; "
                  f"PrefetchLoader yields all {n} on the card through the Python reader and "
                  f"through the native loader, each frame the same; the CLI exit "
                  f"{rc} ({decoder}), launches {c}, its {len(cli_t)} positions against "
                  f"run_sequence_scan on the decoded frames in memory: max diff {diff:.3e} (bar "
                  f"{MAX_STREAM_POS_DIFF}) [{card}]", flush=True)
            if (rc != 0 or len(cli_t) != n or not diff <= MAX_STREAM_POS_DIFF
                    or decoder != "Decoder: native"
                    or c["select_maps"] != n or c["extract_patches"] != n):
                raise AssertionError(f"{fmt}: the CLI run failed its checks")
        # each committed JPEG alone through both readers (the full-size
        # Python decodes once each), beside this call's baseline q90 file
        rows = {"baseline q90 (encode_gray)": (dirs["JPEG"], None, python_ms["JPEG"]),
                "progressive, 8 frames": (dirs["progressive JPEG"], None,
                                          python_ms["progressive JPEG"])}
        for e in (e for e in committed if "/" not in e["file"]):
            d = os.path.join(root, "alone_" + e["file"].replace(".jpg", ""))
            os.makedirs(d)
            path = os.path.join(d, e["file"])
            with open(path, "wb") as f:
                f.write(e["data"])
            t0 = time.perf_counter()
            frame = load_frame(path)
            rows[f"{e['file']} ({e['sof']})"] = (d, e["frame_sha256"],
                                                 (time.perf_counter() - t0) * 1e3)
            if _frame_sha(frame) != e["frame_sha256"]:
                raise AssertionError(f"{e['file']}: load_frame's frame is not the manifest's")
        for name, (d, sha, _) in rows.items():
            if sha is not None:
                with native_loader.NativeDataset(d) as ds:
                    if _frame_sha(ds.read(0)) != sha:
                        raise AssertionError(f"{name}: the native frame is not the manifest's")
        times = {name: (io_bench._frame_ms(d, JPEG_NATIVE_REPS), py)
                 for name, (d, _, py) in rows.items()}
    print(f"JPEG kinds, ms a {W_}x{H_} frame, native (NativeDataset.read of the first file alone, "
          f"median of {JPEG_NATIVE_REPS}) / Python (load_frame, host clock): "
          + "; ".join(f"{k} {nat:.2f} / {py:.1f}" for k, (nat, py) in times.items())
          + f"; every committed file's bytes and both readers' frames equal the manifest's; the "
          f"committed JPEGs took {time.perf_counter() - t_new:.1f} s of the phase [{card}]",
          flush=True)
    return counts


def _native_build():
    """Phase 2's half for the native loader: build it with g++ from csrc's
    sources, linking pthread alone (a failed build raises with g++'s
    output), and print the seconds, the libraries and the path."""
    libs = [a for a in native_loader.build_command("") if a.startswith("-l")]
    if libs != ["-lpthread"]:
        raise AssertionError(f"the native loader's build links {libs}, not pthread alone")
    t0 = time.perf_counter()
    native_loader.get_lib()
    print(f"native loader: built in {time.perf_counter() - t0:.2f} s (g++ {' '.join(libs)}, no "
          f"libpng, libjpeg or zlib; beside nvcc) -> {native_loader.library_path()}", flush=True)


def _ingest_phase(cfg, kernels, card):
    """The ingest path on bench.py's 64 frames as Paeth PNG files: the
    native loader's decode and pack, PrefetchLoader
    onto the card, the streamed runner (counted) against the batched one,
    B1 and B2 at the streamed chunks' shapes, then io_bench. Returns
    {path: launches}."""
    arr = bench.scene(INGEST_T, W, H)[0]  # make_sequence(64, seed=0), rendered in the pool
    frames = torch.from_numpy(arr.copy()).cuda()
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        for i, f in enumerate(arr):
            write_png(os.path.join(d, f"{i:06d}.png"), f, filter_type=PAETH)
        paths = list_image_paths(d)
        with native_loader.NativeDataset(d, n_threads=4, depth=8) as ds:
            got = list(ds)
        if [i for i, _ in got] != list(range(INGEST_T)) or not np.array_equal(
                np.stack([f for _, f in got]), arr):
            raise AssertionError("NativeDataset's frames differ from the written ones")
        pack = os.path.join(d, "seq.vobin")
        n = native_loader.pack_dataset(d, pack)
        with native_loader.PackedSequence(pack) as ps:
            if n != INGEST_T or not np.array_equal(ps.read(), arr):
                raise AssertionError("the packed sequence does not read back its frames")
        print(f"ingest: NativeDataset == the {INGEST_T} written Paeth frames, in order; "
              f"the .vobin pack reads them back", flush=True)
        loader = PrefetchLoader(paths, device="cuda")
        got = [(i, t) for i, _, t in loader]
        if (loader.decoder != "native" or [i for i, _ in got] != list(range(INGEST_T))
                or any(t.device != frames.device for _, t in got)
                or not torch.equal(torch.stack([t for _, t in got]), frames)):
            raise AssertionError(f"PrefetchLoader ({loader.decoder} decoder) did not yield the "
                                 f"frames on the card, equal and in order")
        print(f"ingest: PrefetchLoader(device='cuda') yields the {INGEST_T} frames on the card, "
              f"equal and in order; decoder {loader.decoder}", flush=True)
        del got
        poses, diags = runner.run_sequence_batched(frames, cfg, seed=0,
                                                   frame_chunk=INGEST_FRAME_CHUNK,
                                                   pair_chunk=INGEST_PAIR_CHUNK)

        def native_chunks():
            with native_loader.NativeDataset(d, n_threads=io_bench.E2E_THREADS,
                                             depth=io_bench.DECODE_DEPTH) as ds:
                yield from io_bench.chunks_of(ds, INGEST_T)

        chunked = {f"native decoder's {INGEST_T}-frame chunks": native_chunks,
                   f"{INGEST_HOST_CHUNK}-frame host chunks": lambda: (
                       arr[i:i + INGEST_HOST_CHUNK] for i in range(0, INGEST_T, INGEST_HOST_CHUNK))}
        for name, chunks in chunked.items():
            _reset(kernels)
            t0 = time.perf_counter()
            sp, sd = runner.run_sequence_streamed(chunks(), cfg, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[name] = {n: k.launches for n, k in kernels.items()}
            same_ok = bool(torch.equal(sd["pose_ok"], diags["pose_ok"]))
            pos_diff = float((sp.t - poses.t).abs().max())
            print(f"ingest: run_sequence_streamed over the {name}: {wall:.3f} s host wall for "
                  f"{INGEST_T} frames (first run of this path), launches {runs[name]}; against "
                  f"run_sequence_batched (frame_chunk {INGEST_FRAME_CHUNK}, pair_chunk "
                  f"{INGEST_PAIR_CHUNK}): pose_ok equal {same_ok} (mean "
                  f"{float(sd['pose_ok'].float().mean()):.3f}), positions differ by at most "
                  f"{pos_diff:.3e} (bar {MAX_STREAM_POS_DIFF}) [{card}]", flush=True)
            want_n = INGEST_T // runner.STREAM_FRAME_CHUNK
            if runs[name]["select_maps"] != want_n or runs[name]["extract_patches"] != want_n:
                raise AssertionError(f"the streamed path over the {name} did not launch B1 and "
                                     f"B2 {want_n} times: {runs[name]}")
            if not same_ok or not pos_diff <= MAX_STREAM_POS_DIFF:
                raise AssertionError(f"the streamed path over the {name} disagrees with the "
                                     f"batched runner")
    for a in range(0, INGEST_T, runner.STREAM_FRAME_CHUNK):
        _hold_b1_b2(f"streamed path, frames {a}-{a + runner.STREAM_FRAME_CHUNK - 1}",
                    frames[a:a + runner.STREAM_FRAME_CHUNK], cfg.orb, card)
    del frames
    t0 = time.perf_counter()
    rows = io_bench.main([])  # prints its rows, tagged with the card
    print(f"io_bench: {time.perf_counter() - t0:.1f} s", flush=True)
    native_rows = ("decode_only_fps", "e2e_png_fps", "e2e_packed_fps", "e2e_decode_fps")
    if rows["native"] != "built" or not all(rows[k] is not None and rows[k] > 0
                                            for k in native_rows):
        raise AssertionError(f"io_bench's native rows are not all measured: "
                             f"{ {k: rows[k] for k in ('native', *native_rows)} }")
    return runs


def _profile(name, fn, card, rows=0):
    """Profile PROFILE_RUNS calls of fn() after warm-up (utils/profiling.
    busy_profile); print per run the host time, the device busy time
    (union of device intervals), device operations, host-to-device and
    device-to-host copies and the runtime calls that wait for the card;
    with rows, the top device time."""
    p = busy_profile(fn, PROFILE_RUNS, WARMUP, rows=rows, name=name)
    print(f"profile {name}: {p['host_ms']:.3f} ms per run (host clock, profiler "
          f"on), device busy {p['busy_ms']:.3f} ms = {100.0 * p['busy_share']:.1f}%, "
          f"{p['device_ops']:.0f} device ops, {p['htod']:.0f} HtoD and {p['dtoh']:.0f} DtoH "
          f"copies, waits {p['waits']} per run [{card}]", flush=True)
    if rows:
        print(p["table"], flush=True)


def _profiling_tools_phase(kernels, card, out=None):
    """Phase 5j: each of PROFILING_TOOLS through its main on the card,
    counters reset just before each; its output lines parse, its B1 and
    B2 launches equal what its calls imply (its expected_launches; one B1
    launch and no B2 per select_maps call in select_breakdown, none in
    PROFILING_NO_KERNELS), and the composed stages of PROFILING_COMPOSED
    equal the function they split bit for bit. Prints one line a tool
    (its seconds and CUDA-event ms by row); `out` gets every tool's last
    line. Returns the B1 and B2 launches of all the tools."""
    import importlib

    total = dict.fromkeys(("select_maps", "extract_patches"), 0)
    objs = {}
    for name, kw in PROFILING_TOOLS.items():
        mod = importlib.import_module(f"tpu_vo_torch.tools.{name}")
        _reset(kernels)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            obj = mod.main(**kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lines = [json.loads(line) for line in buf.getvalue().strip().splitlines()]
        if lines[-1] != json.loads(json.dumps(obj)) or lines[-1]["card"] != card:
            raise AssertionError(f"{name}: its last line is not its result on {card}")
        got = {k: kernels[k].launches for k in total}
        want = obj["expected_launches"]
        if name == "select_breakdown":
            # per level one untimed select_maps call and two timed rows of it
            # (a warm-up and reps x iters calls each), then select_maps_levels'
            # row: one launch a call
            row_calls = 1 + kw["reps"] * kw["iters"]
            want = {"select_maps": 8 * (1 + 2 * row_calls) + row_calls, "extract_patches": 0}
        if name in PROFILING_NO_KERNELS:
            want = dict.fromkeys(total, 0)
        if got != want or got != obj["expected_launches"]:
            raise AssertionError(f"{name}: launches {got}, its calls imply {want}")
        if name in PROFILING_COMPOSED and obj["rows"]["composed_equal"] is not True:
            raise AssertionError(f"{name}: its composed stages differ from the function they "
                                 f"split on the card")
        for k in total:
            total[k] += got[k]
        objs[name] = obj
        timed = ", ".join(f"{r} {v['ms']:.3f}" for r, v in obj["rows"].items()
                          if isinstance(v, dict) and isinstance(v.get("ms"), float))
        print(f"{name}: {secs:.1f} s, launches {got}, composed "
              f"{obj['rows'].get('composed_equal', '-')}; ms a call: {timed} [{card}]",
              flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(objs, f)
    return total


def _diagnostics_phase(kernels, card, out=None):
    """Phase 5k: each of DIAGNOSTIC_TOOLS through its main on the card,
    counters reset just before each; its output lines parse and the last
    is its result; B1's launches (its Harris-off ones counted apart), B2's
    and B3's equal what its calls imply; the legs of DIAGNOSTIC_LEGS were
    each hashed against the committed sha256 (diag_common.leg_frames
    raises on a difference). Prints one line a tool (its seconds and its
    rows); `out` gets every tool's last line. Returns the launches of all
    the tools, {kernel: count}."""
    import importlib

    counters = {"select_maps": lambda: select_maps.launches,
                "select_maps_no_harris": lambda: select_maps.launches_no_harris,
                "extract_patches": lambda: extract_patches.launches,
                "fast_margin": lambda: fast_margin.launches}
    total = dict.fromkeys(counters, 0)
    objs = {}
    diag_common.CHECKED.clear()
    for name, kw in DIAGNOSTIC_TOOLS.items():
        mod = importlib.import_module(f"tpu_vo_torch.tools.{name}")
        _reset(kernels)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            obj = mod.main(**kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lines = [json.loads(line) for line in buf.getvalue().strip().splitlines()]
        if lines[-1] != json.loads(json.dumps(obj)) or lines[-1]["card"] != card:
            raise AssertionError(f"{name}: its last line is not its result on {card}")
        got = {k: c() for k, c in counters.items()}
        want = {k: obj["expected_launches"].get(k, 0) for k in counters}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, its calls imply {want}")
        for k in total:
            total[k] += got[k]
        objs[name] = obj
        rows = json.dumps(obj["rows"])
        cut = DIAGNOSTIC_CUTS.get(name, "the JAX tool's shapes and depth")
        print(f"{name}: {secs:.1f} s ({cut}), launches {got}; rows "
              f"{rows if len(rows) < 3000 else rows[:3000] + ' ...'} [{card}]", flush=True)
    missing = set(DIAGNOSTIC_LEGS) - set(diag_common.CHECKED)
    if missing:
        raise AssertionError(f"phase 5k read no frames of the legs {sorted(missing)}")
    print(f"phase 5k: the frames of {len(set(diag_common.CHECKED))} committed legs hash to their "
          f"sha256: {sorted(set(diag_common.CHECKED))}", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(objs, f)
    return total


def _hold_harris_off(label, levels, thr, border, per_level=False):
    """B1's Harris-off instance on `levels` in one launch (and, with
    per_level, one select_maps launch a level) against its plain version
    bit for bit, its packed keys equal to the Harris instance's, its map
    all zero. Returns the largest difference from the plain version (0)."""
    err = 0.0
    on = select_maps_levels(levels, thr, border)
    runs = [select_maps_levels(levels, thr, border, with_harris=False)]
    if per_level:
        runs.append([select_maps(lv, thr, border, with_harris=False) for lv in levels])
    for lvl, (pk, hk, bk), (pt, _, bt) in ((lv, k, t) for off in runs
                                           for lv, k, t in zip(levels, off, on)):
        pr, hr, br = select_maps_reference(lvl, thr, border, with_harris=False)
        torch.cuda.synchronize()
        if bk != br or not torch.equal(pk, pr) or not torch.equal(hk, hr):
            raise AssertionError(f"B1 without Harris differs from its plain version on the "
                                 f"{label} at {tuple(lvl.shape)}: packed {int((pk != pr).sum())} "
                                 f"cells, harris max {float(hk.abs().max())}")
        if bk != bt or not torch.equal(pk, pt) or bool(hk.any()):
            raise AssertionError(f"B1 without Harris: packed keys differ from the Harris "
                                 f"instance's, or its map is not zero, at {tuple(lvl.shape)}")
        err = max(err, float((pk - pr).abs().max()), float((hk - hr).abs().max()))
    print(f"select_maps_levels(with_harris=False) == plain and == the Harris instance's packed "
          f"keys, zero map, on the {label} at {[tuple(lv.shape) for lv in levels]}, 1 launch"
          f"{' (and select_maps, 1 launch a level)' if per_level else ''}", flush=True)
    return err


def _start_renders(pool):
    """Submit the accuracy path's scenes to `pool`: {key: futures of
    render_range by frame ranges}, the parity legs, "config5", "config3"
    and config 7's "config7_<scene>" by their names in the reference file,
    ("c4", b) config 4's sequences, "bench" the bench's and the ingest
    path's frames, ("c6", scene) config 6's clean scenes; the largest
    first. Each future's
    `done_s` is set to the seconds from the submission to its end."""
    names = ("config3",) + tuple(f"config7_{k}" for k in synthetic.DYNAMIC_SCENES)
    specs = {name: reference_band.LEGS[name] for name in names + PARITY_LEGS + ("config5",)}
    specs.update({("c4", b): ("corridor", C4_T, C4_W, C4_H, b) for b in range(C4_B)})
    specs["bench"] = reference_band.BENCH  # make_sequence(64, 1241, 376, seed=0)
    t0 = time.perf_counter()
    futures = {k: synthetic.submit_render(pool, *spec) for k, spec in specs.items()}
    # config 6's clean scenes (the corridor by ranges of C6_RANGE frames);
    # _degrade makes their levels
    for scene in run_benchmarks.C6_SCENES:
        spec = reference_band.LEGS[f"config6_{scene}_clean"]
        futures[("c6", scene)] = [pool.submit(synthetic.render_range, *spec, a,
                                              min(a + C6_RANGE, spec[1]))
                                  for a in range(0, spec[1], C6_RANGE)]
    # phase 5k's scenes
    for spec in DIAGNOSTIC_SCENES:
        futures[("diag", spec)] = [pool.submit(synthetic.render_range, *spec, a,
                                               min(a + DIAG_RANGE, spec[1]))
                                   for a in range(0, spec[1], DIAG_RANGE)]
    for fs in futures.values():
        for f in fs:
            f.add_done_callback(lambda f: setattr(f, "done_s", time.perf_counter() - t0))
    return futures


def _diag_prefill(pool, renders, degraded):
    """Hand phase 5k's scenes to the tools (diag_common.prefill): the
    rendered ones, config 6's clean and harsh pan, and the pan ablation's
    four single nuisances, degraded in `pool`."""
    pan = reference_band.LEGS["config6_pan_clean"]
    scenes = {spec: _rendered(renders, ("diag", spec)) for spec in DIAGNOSTIC_SCENES}
    scenes[pan] = _rendered(renders, ("c6", "pan"))
    only = [n for n in DIAGNOSTIC_LEGS if n.startswith("diag_pan_only_")]
    futures = {n: pool.submit(reference_band.leg_frames, n, scenes[pan][0]) for n in only}
    made = {n: f.result() for n, f in futures.items()}
    made.update(config6_pan_clean=degraded[("pan", "clean")],
                config6_pan_harsh=degraded[("pan", "harsh")])
    diag_common.prefill(scenes, made)


def _rendered(renders, key):
    """The sequence of `key` from its rendered frame ranges."""
    return synthetic.join_ranges([f.result() for f in renders[key]])


def _parity_phase(renders, kernels, card):
    """5 seeds of VOConfig.reference_parity() on each card leg against the
    committed reference's band; returns the B1 and B2 launches."""
    legs = reference_band.load()
    launches = {"select_maps": 0, "extract_patches": 0}
    for name in PARITY_LEGS:
        rec = legs[name]
        t0 = time.perf_counter()
        frames_np = _rendered(renders, name)[0]
        wait_s = time.perf_counter() - t0
        sha = synthetic.frames_sha256(frames_np)
        if sha != rec["frames_sha256"]:
            raise AssertionError(f"{name}: the frames rendered here hash to {sha}, the committed "
                                 f"reference's to {rec['frames_sha256']}")
        W_, H_ = rec["W"], rec["H"]
        frames = torch.from_numpy(np.stack(frames_np)).cuda()
        cfg = VOConfig.reference_parity(image_width=W_, image_height=H_)
        traj_ref, _ = reference_band.leg_arrays(rec)
        tol = reference_band.parity_tolerance(rec["band"])
        _reset(kernels)
        rels, oks = [], []
        for s in range(PARITY_SEEDS):
            poses, diags = runner.run_sequence_batched(frames, cfg, seed=s)
            if not bool(torch.isfinite(poses.t).all()):
                raise AssertionError(f"{name}: non-finite poses at seed {s}")
            rels.append(ate_rmse_aligned(poses.t.double().cpu().numpy(), traj_ref)
                        / rec["extent"])
            oks.append(float(diags["pose_ok"].float().mean()))
        got = {n: kernels[n].launches for n in launches}
        for n in launches:
            launches[n] += got[n]
        print(f"parity {name} ({rec['T']} frames, hash equal to the file's; waited "
              f"{wait_s:.1f} s for the render): aligned ATE / extent per seed "
              f"{[round(r, 5) for r in rels]}, band {rec['band']:.5f}, bar {tol:.5f}, pose_ok "
              f"{[round(o, 3) for o in oks]}, launches {got} [{card}]", flush=True)
        if max(rels) > tol:
            raise AssertionError(f"{name}: {sum(r > tol for r in rels)}/{PARITY_SEEDS} seeds "
                                 f"outside the reference's band")
        if got["select_maps"] != PARITY_SEEDS or got["extract_patches"] != PARITY_SEEDS:
            raise AssertionError(f"{name}: B1 and B2 did not launch once a run: {got}")
        _hold_b1_b2(f"parity {name}, {rec['T']} frames", frames, cfg.orb, card)
    return launches


def _config5_phase(renders, kernels, card):
    """Config 5 (window refinement) on the card; returns B1's and B2's
    launches in one run."""
    legs = reference_band.load()
    frames_np, Rs, ts, _ = _rendered(renders, "config5")
    rec = legs["config5"]
    if synthetic.frames_sha256(frames_np) != rec["frames_sha256"]:
        raise AssertionError("config 5: the frames are not the committed reference's")
    frames = torch.from_numpy(np.stack(frames_np)).cuda()
    cfg = VOConfig(image_width=C5_W, image_height=C5_H, orb=ORBConfig(n_features=C5_KPS))
    _reset(kernels)
    poses = run_benchmarks.window_refined(frames, cfg)
    torch.cuda.synchronize()
    launches = {n: kernels[n].launches for n in ("select_maps", "extract_patches")}
    if any(v != C5_T // run_benchmarks.FRAME_CHUNK for v in launches.values()):
        raise AssertionError(f"config 5 did not launch B1 and B2 once a frame chunk: {launches}")
    for a in range(0, C5_T, run_benchmarks.FRAME_CHUNK):
        _hold_b1_b2(f"config 5, frames {a}-{a + run_benchmarks.FRAME_CHUNK - 1}",
                    frames[a:a + run_benchmarks.FRAME_CHUNK], cfg.orb, card)
    plain = run_benchmarks.window_refined(frames, cfg, iters=0)
    ms = _cuda_ms(lambda: run_benchmarks.window_refined(frames, cfg))
    _, _, args = run_benchmarks.window_refined(frames, cfg, with_parts=True)
    refine_ms = _cuda_ms(lambda: refine_window(*args, iters=run_benchmarks.LM_ITERS))
    ref_t, ref_R = reference_band.leg_arrays(rec)
    reports = {}
    for label, p in (("refined", poses), ("unrefined", plain)):
        if not bool(torch.isfinite(p.t).all() and torch.isfinite(p.R).all()):
            raise AssertionError(f"config 5: non-finite {label} poses")
        traj = p.t.double().cpu().numpy()
        reports[label] = trajectory_report(traj, ref_t, np.stack(ts),
                                           our_R=p.R.double().cpu().numpy(), ref_R=ref_R,
                                           gt_R=np.stack(Rs))
        reports[label]["rel"] = ate_rmse_aligned(traj, ref_t) / rec["extent"]
    diffs = {}
    for dtype in (torch.float32, torch.float64):
        a = [x.to(dtype) if x.is_floating_point() else x for x in args]
        gpu = refine_window(*a, iters=run_benchmarks.LM_ITERS)
        cpu = refine_window(*(x.cpu() for x in a), iters=run_benchmarks.LM_ITERS)
        diffs[dtype] = (float((gpu.R_rel.cpu() - cpu.R_rel).abs().max()),
                        float((gpu.t_rel.cpu() - cpu.t_rel).abs().max()),
                        float(((gpu.cost.cpu() - cpu.cost).abs()
                               / cpu.cost.clamp(min=1e-30)).max()),
                        float((gpu.improved.cpu() == cpu.improved).float().mean()))
    print(f"config 5 ({C5_T} frames {C5_W}x{C5_H}, {C5_KPS} keypoints, refine_window "
          f"{run_benchmarks.LM_ITERS} LM iterations): {ms:.3f} ms = {C5_T * 1000.0 / ms:.2f} "
          f"frames/s, refine_window {refine_ms:.3f} ms = {100.0 * refine_ms / ms:.1f}% of it "
          f"(median of {REPS}), launches {launches} [{card}]", flush=True)
    for label, rep in reports.items():
        print(f"config 5 {label}: aligned ATE / extent vs reference {rep['rel']:.6f} (band "
              f"{rec['band']:.5f}), ATE vs scale-matched ground truth {rep['ate_vs_gt']} "
              f"({rep['ate_vs_gt_rel']} of extent; the reference's {rep['ref_ate_vs_gt_rel']}), "
              f"RPE rotation vs ground truth {rep['rpe_rot_mean_deg_vs_gt']} deg mean", flush=True)
    for dtype, bar in ((torch.float32, MAX_REFINE_DIFF), (torch.float64, MAX_REFINE_DIFF_F64)):
        d_R, d_t, d_c, same = diffs[dtype]
        print(f"config 5 refine_window card vs CPU on the same inputs in {dtype}: R max "
              f"{d_R:.3e}, t max {d_t:.3e}, cost max relative {d_c:.3e}, improved equal on "
              f"{same:.3f} of pairs (bar {bar})", flush=True)
        if not (d_R <= bar and d_t <= bar and d_c <= bar):
            raise AssertionError(f"config 5: refine_window differs between the card and the "
                                 f"CPU in {dtype}")
    return launches


def _config4_phase(renders, kernels, card):
    """Config 4 cut to C4_B x C4_T: the batch against each sequence alone
    on the card; returns B1's and B2's launches in one run and (the host
    frames, the config, the poses, the diagnostics) for phase 5i."""
    seqs = [_rendered(renders, ("c4", b)) for b in range(C4_B)]
    frames_np = np.stack([np.stack(s[0]) for s in seqs])
    frames = torch.from_numpy(frames_np).cuda()
    cfg = VOConfig(image_width=C4_W, image_height=C4_H, orb=ORBConfig(n_features=C4_KPS))
    fc, pc = C4_FRAME_CHUNK, C4_T - 1
    _reset(kernels)
    poses, diags = run_batch_of_sequences(frames, cfg, frame_chunk=fc, pair_chunk=pc)
    torch.cuda.synchronize()
    launches = {n: kernels[n].launches for n in ("select_maps", "extract_patches")}
    if any(v != C4_B * C4_T // fc for v in launches.values()):
        raise AssertionError(f"config 4 did not launch B1 and B2 once a frame chunk: {launches}")
    flat = frames.reshape(C4_B * C4_T, C4_H, C4_W)
    for a in range(0, C4_B * C4_T, fc):
        _hold_b1_b2(f"config 4, frames {a}-{a + fc - 1} of the flattened batch",
                    flat[a:a + fc], cfg.orb, card)
    ms = _cuda_ms(lambda: run_batch_of_sequences(frames, cfg, frame_chunk=fc, pair_chunk=pc))
    diffs, oks = [], []
    for b in range(C4_B):
        p, d = runner.run_sequence_batched(frames[b], cfg, seed=b, frame_chunk=fc,
                                           pair_chunk=pc)
        if not torch.equal(d["pose_ok"], diags["pose_ok"][b]):
            raise AssertionError(f"config 4: sequence {b}'s pose_ok differs from its own run")
        diffs.append(float((p.t - poses.t[b]).abs().max()))
        oks.append(float(d["pose_ok"].float().mean()))
    print(f"config 4 (cut to {C4_B} sequences x {C4_T} frames at {C4_W}x{C4_H}, {C4_KPS} "
          f"keypoints, frame_chunk {fc}, pair_chunk {pc}): {ms:.3f} ms = "
          f"{C4_B * C4_T * 1000.0 / ms:.2f} frames/s (median of {REPS}), launches {launches}; "
          f"each sequence against run_sequence_batched: pose_ok equal, positions differ by at "
          f"most {max(diffs):.3e} (bar {MAX_STREAM_POS_DIFF}), pose_ok {oks} [{card}]", flush=True)
    if max(diffs) > MAX_STREAM_POS_DIFF:
        raise AssertionError("config 4: a sequence's positions differ from its own run")
    return launches, (frames_np, cfg, poses, diags)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _hold_parallel(label, t, pose_ok, ref_poses, ref_diags, rows=None):
    """A parallel runner's positions (numpy (..., T, 3)) and pose_ok against
    a one-process run on the card (rows of it where given) at phase 5e's
    bar; returns the largest position difference."""
    ref_t, ref_ok = ref_poses.t.cpu().numpy(), ref_diags["pose_ok"].cpu().numpy()
    if rows is not None:
        ref_t, ref_ok = ref_t[rows], ref_ok[rows]
    if not np.array_equal(np.asarray(pose_ok), ref_ok):
        raise AssertionError(f"{label}: pose_ok differs from the one-process run")
    diff = float(np.abs(np.asarray(t) - ref_t).max())
    if diff > MAX_STREAM_POS_DIFF:
        raise AssertionError(f"{label}: positions differ from the one-process run by {diff:.3e}")
    return diff


def _moved(transfers) -> str:
    """What a record of transfers [(op, axis, nbytes)] moved, by op."""
    ops = {}
    for op, axis, n in transfers:
        ops.setdefault((str(op), str(axis)), []).append(int(n))
    return ", ".join(f"{op} on {axis}: {ns} B" for (op, axis), ns in ops.items()) or "nothing"


def _spawn_world(name, n, jobs, d):
    """Run tools/parallel_run's `jobs` in a world of n gloo ranks, all on
    cuda:0; returns ({job's out: [each rank's npz]}, wall seconds with
    start-up). A rank that fails or a world that outlives
    PAR_WORLD_TIMEOUT fails the run; no rank outlives this call."""
    spec = os.path.join(d, f"{name}.json")
    with open(spec, "w") as f:
        json.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=HERE,
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // n)))
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "tpu_vo_torch.tools.parallel_run", spec,
                               "--address", f"localhost:{port}", "--world", str(n), "--rank",
                               str(r), "--backend", "gloo", "--device", PAR_DEVICE,
                               "--timeout", str(PAR_TIMEOUT)],
                              env=env, cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        deadline = t0 + PAR_WORLD_TIMEOUT
        outs = [p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0]
                for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{name}: rank {r} exited with {p.returncode}:\n{out[-3000:]}")
    results = {job["out"]: [dict(np.load(f"{job['out']}.rank{r}.npz")) for r in range(n)]
               for job in jobs}
    for out, ranks in results.items():
        if any(float(o["build_s"]) != 0.0 for o in ranks):
            raise AssertionError(f"{name}: a rank built the kernels again")
    return results, wall


def _parallel_phase(main_np, cfg, poses, diags, c4_run, kernels, card):
    """Phase 5i: run_sequence_time_sharded and run_batch_time_sharded in a
    world of 1 on NCCL in this process, then SP and DP in a world of 2
    and DP x SP in a world of 4 gloo ranks on this card; each held against
    phase 4's (the main path) or phase 5e's (config 4's cut) results at
    phase 5e's bar, B1 and B2 launched once per frame chunk in each rank.
    Returns {path: B1 and B2 launches}."""
    c4_np, c4_cfg, c4_poses, c4_diags = c4_run
    chunk = runner.STREAM_FRAME_CHUNK
    names = ("select_maps", "extract_patches")
    launches = {}
    tag = f"[{card}]"

    # 1. a world of 1 on NCCL, this process its rank
    t0 = time.perf_counter()
    distributed.initialize(f"localhost:{_free_port()}", 1, 0, backend="nccl",
                           timeout=PAR_TIMEOUT)
    try:
        for label, mesh_shape, fn, ref, want in (
                (f"SP over {T} frames", ((1,), ("seq",)),
                 lambda m: run_sequence_time_sharded(main_np, cfg, m), (poses, diags),
                 T // chunk),
                (f"DP x SP over config 4's {C4_B} x {C4_T}", ((1, 1), ("data", "seq")),
                 lambda m: run_batch_time_sharded(c4_np, c4_cfg, m), (c4_poses, c4_diags),
                 C4_B * C4_T // chunk)):
            mesh = make_mesh(*mesh_shape)
            _reset(kernels)
            del sharding.transfers[:]
            p, d = fn(mesh)
            torch.cuda.synchronize()
            got = {n: kernels[n].launches for n in names}
            if any(v != want for v in got.values()) or sharding.transfers:
                raise AssertionError(f"NCCL world of 1, {label}: launches {got} (want {want} "
                                     f"each), transfers {sharding.transfers} (want none)")
            diff = _hold_parallel(f"NCCL world of 1, {label}", p.t.cpu().numpy(),
                                  d["pose_ok"].cpu().numpy(), *ref)
            ms = _cuda_ms(lambda: fn(mesh), warmup=0, reps=PAR_REPS)
            launches[f"parallel {label}, NCCL world of 1"] = got
            print(f"parallel, NCCL world of 1, {label} on a {mesh_shape[0]} mesh: {ms:.3f} ms a "
                  f"call (CUDA events, median of {PAR_REPS}), launches {got}, moved nothing, "
                  f"positions within {diff:.3e} of the one-process run, pose_ok equal {tag}",
                  flush=True)
    finally:
        dist_wall = time.perf_counter() - t0
        torch.distributed.destroy_process_group()
    print(f"parallel, NCCL world of 1: {dist_wall:.1f} s with its set-up {tag}", flush=True)

    # 2. and 3. worlds of gloo ranks sharing this card, each a process
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "main.npy"), main_np)
        np.save(os.path.join(d, "c4.npy"), c4_np)
        main_cfg, c4_fields = dataclasses.asdict(cfg), dataclasses.asdict(c4_cfg)

        def job(out, runner_, mesh_, frames, fields, want, **extra):
            return dict(runner=runner_, mesh=list(mesh_), axes=["data", "seq"],
                        frames=os.path.join(d, frames), cfg=fields, seed=0, reps=PAR_REPS,
                        launches=want, out=os.path.join(d, out), **extra)

        worlds = (
            ("gloo world of 2", 2, [
                job("sp", "sp", (1, 2), "main.npy", main_cfg, T // 2 // chunk),
                job("dp", "dp", (2, 1), "c4.npy", c4_fields,
                    C4_B // 2 * C4_T // C4_FRAME_CHUNK, frame_chunk=C4_FRAME_CHUNK,
                    pair_chunk=C4_T - 1)]),
            ("gloo world of 4", 4, [
                job("dp_sp", "dp_sp", (2, 2), "c4.npy", c4_fields,
                    C4_B // 2 * C4_T // 2 // chunk)]))
        for world, n, jobs in worlds:
            results, wall = _spawn_world(world.replace(" ", "_"), n, jobs, d)
            for j in jobs:
                label = {"sp": f"SP over {T} frames", "dp": f"DP over config 4's {C4_B} x {C4_T}",
                         "dp_sp": f"DP x SP over config 4's {C4_B} x {C4_T}"}[j["runner"]]
                ref = (poses, diags) if j["runner"] == "sp" else (c4_poses, c4_diags)
                diffs = []
                for r, o in enumerate(results[j["out"]]):
                    moved = _moved(zip(o["transfers_op"], o["transfers_axis"],
                                       o["transfers_nbytes"]))
                    rows = None if j["runner"] == "sp" else o["rows"]
                    diffs.append(_hold_parallel(f"{world}, {label}, rank {r}", o["t"],
                                                o["diag_pose_ok"], *ref, rows=rows))
                    launches[f"parallel {label}, {world}, rank {r}"] = dict(
                        zip(names, (int(v) for v in o["launches"])))
                    print(f"parallel, {world}, {label} on a {tuple(j['mesh'])} mesh, rank {r}: "
                          f"{statistics.median(o['ms'].tolist()):.3f} ms a call (CUDA events, "
                          f"median of {PAR_REPS}), launches {o['launches'].tolist()}, moved "
                          f"{moved} {tag}", flush=True)
                print(f"parallel, {world}, {label}: every rank within {max(diffs):.3e} of the "
                      f"one-process run, pose_ok equal {tag}", flush=True)
            print(f"parallel, {world}: {wall:.1f} s wall, start-up included {tag}", flush=True)
    return launches


def _config3_phase(renders, kernels, card):
    """Config 3 (3840x2160, 8000 keypoints, the ratio test, T 8) on the
    card; returns (B1's and B2's launches in one run, B1's and B2's times
    and bounds at its shapes)."""
    rec = reference_band.load()["config3"]
    frames_np, Rs, ts, K = _rendered(renders, "config3")
    if synthetic.frames_sha256(frames_np) != rec["frames_sha256"]:
        raise AssertionError("config 3: the frames are not the committed reference's")
    T = len(frames_np)
    frames = torch.from_numpy(np.stack(frames_np)).cuda()
    cfg = run_benchmarks.config_cfg(3)
    fc, pc = run_benchmarks.config_chunks(3, T)
    _reset(kernels)
    poses, diags = runner.run_sequence_batched(frames, cfg, frame_chunk=fc, pair_chunk=pc)
    torch.cuda.synchronize()
    launches = {n: kernels[n].launches for n in ("select_maps", "extract_patches")}
    if any(v != T // fc for v in launches.values()):
        raise AssertionError(f"config 3 did not launch B1 and B2 once a frame chunk: {launches}")
    if not bool(torch.isfinite(poses.t).all() and torch.isfinite(poses.R).all()):
        raise AssertionError("config 3: non-finite poses")
    pose_ok = float(diags["pose_ok"].float().mean())
    ref_t, _ = reference_band.leg_arrays(rec)
    rel = ate_rmse_aligned(poses.t.double().cpu().numpy(), ref_t) / rec["extent"]
    bar = max(rec["band"], 0.01)
    print(f"config 3 ({T} frames {frames.shape[2]}x{frames.shape[1]}, {cfg.orb.n_features} "
          f"keypoints, ratio test, frame_chunk {fc}, pair_chunk {pc}; hash equal to the file's): "
          f"launches {launches}, pose_ok {pose_ok:.3f} (bar {MIN_POSE_OK}), aligned ATE / extent "
          f"vs reference {rel:.6f} (band {rec['band']:.6f}, bar {bar:.4f}), keypoints/frame "
          f"{diags['num_keypoints'].float().mean().item():.1f}, matches/pair "
          f"{diags['num_matches'].float().mean().item():.1f}, inliers/pair "
          f"{diags['num_inliers'].float().mean().item():.1f} [{card}]", flush=True)
    if pose_ok < MIN_POSE_OK or not rel <= bar:
        raise AssertionError("config 3: accuracy below its bar")
    levels, ys, xs, starts = _hold_b1_b2(f"config 3, frames 0-{fc - 1}", frames[:fc], cfg.orb, card)
    del poses, diags

    # times: the run (run_benchmarks.run_config, CUDA events), stage 1,
    # stage 2 and its Hamming step, and the two kernels at these shapes
    base_gib = torch.cuda.memory_allocated() / 2**30
    res = run_benchmarks.run_config(3, [(frames_np, Rs, ts, K)], frames.device,
                                    reference_band.load(), card)
    feats = runner.detect_frames(frames, cfg, fc)
    prev = orb.ORBFeatures(*(f[:-1] for f in feats))
    cur = orb.ORBFeatures(*(f[1:] for f in feats))
    gens = runner.pair_generators(0, range(1, T))
    s1 = _cuda_ms(lambda: runner.detect_frames(frames, cfg, fc), warmup=1, reps=3)
    s2 = _cuda_ms(lambda: runner.estimate_pairs(prev, cur, cfg, gens, pc), warmup=1, reps=3)
    ham = _cuda_ms(lambda: ratio_test_match(prev.desc32, cur.desc32, prev.valid, cur.valid,
                                            cfg.match.ratio), warmup=1, reps=3)
    thr, brd = cfg.orb.fast_threshold, cfg.orb.edge_threshold
    kp = [(ys[:, o:e], xs[:, o:e]) for o, e in zip(starts, starts[1:])]
    sel_bound, sel_bytes, sel_instr, n_inner, n_cand = _select_bound(levels, thr, brd)
    sel = (_cuda_ms(lambda: select_maps_levels(levels, thr, brd)),
           sum(_cuda_ms(lambda lv=lv: select_maps_reference(lv, thr, brd), warmup=1, reps=3)
               for lv in levels), sel_bound)
    pat = (_cuda_ms(lambda: extract_patches_levels(levels, ys, xs, starts[:-1])),
           _cuda_ms(lambda: [extract_patches_reference(lv, y, x) for lv, (y, x) in zip(levels, kp)],
                    warmup=1, reps=3), _patch_bound(levels, kp))
    # B2's library call at these shapes: one aten::index gather of the same
    # windows on prebuilt indices, as phase 6 times it on the main path
    r = torch.arange(RAW_SIZE, device=frames.device)
    b2_flat, b2_idx = _library_gather(
        levels, [(patch_starts(y, lv.shape[-2])[..., None] + r,
                  patch_starts(x, lv.shape[-1])[..., None] + r) for lv, (y, x) in zip(levels, kp)])
    if not torch.equal(b2_flat[b2_idx], extract_patches_levels(levels, ys, xs, starts[:-1])):
        raise AssertionError("config 3: B2's library gather differs from the kernel")
    pat_lib = _cuda_ms(lambda: b2_flat[b2_idx])
    del b2_flat, b2_idx
    tag = f"[{card}]"
    print(f"config 3: {res['ms']:.3f} ms a run (median of {run_benchmarks.REPS}, CUDA events) = "
          f"{res['frames_per_sec']:.2f} frames/s, one warm call by the host clock "
          f"{res['one_shot_wall_fps']:.2f} frames/s; peak device memory {res['peak_mem_gib']:.3f} "
          f"GiB ({base_gib:.3f} GiB held by the script before the run); stage 1 {s1:.3f} ms "
          f"({fc} frames a launch), stage 2 {s2:.3f} ms, its ratio-test Hamming step {ham:.3f} "
          f"ms = {100.0 * ham / s2:.1f}% of stage 2; aligned ATE / extent vs reference "
          f"{res.get('ate_vs_reference_aligned_rel')}, vs ground truth {res.get('ate_vs_gt_rel')} "
          f"(the reference's {res.get('ref_ate_vs_gt_rel')}), parity "
          f"{res.get('parity_within_ref_band')} {tag}", flush=True)
    for name, (k_ms, p_ms, (b_ms, by)), lib in (("select_maps_levels", sel, None),
                                                 ("extract_patches_levels", pat, pat_lib)):
        lib = "none" if lib is None else f"{lib:.4f} ms"
        print(f"{name} at config 3's shapes ({[tuple(lv.shape) for lv in levels]}, "
              f"{ys.shape[1]} slots a frame), 1 launch: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({by}), library call {lib} {tag}", flush=True)
    print(f"select_maps bound at config 3's shapes: {sel_bytes} B, {sel_instr} lane-instructions "
          f"({n_inner} pixels inside the border, {n_cand} compass candidates) {tag}", flush=True)
    times = {name: {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                    "library_ms": lib}
             for name, (k_ms, p_ms, (b_ms, by)), lib in (("select_maps", sel, None),
                                                          ("extract_patches", pat, pat_lib))}
    return launches, times


def _config7_phase(renders, kernels, card):
    """Config 7's five dynamic scenes (640x480, 1200 keypoints, T 48) on
    the card; returns B1's and B2's launches in one run of a scene."""
    legs = reference_band.load()
    seqs = []
    for name in synthetic.DYNAMIC_SCENES:
        seq = _rendered(renders, f"config7_{name}")
        if synthetic.frames_sha256(seq[0]) != legs[f"config7_{name}"]["frames_sha256"]:
            raise AssertionError(f"config 7 {name}: the frames are not the committed reference's")
        seqs.append(seq)
    T = len(seqs[0][0])
    cfg = run_benchmarks.config_cfg(7)
    fc, pc = run_benchmarks.config_chunks(7, T)
    launches = None
    for name, seq in zip(synthetic.DYNAMIC_SCENES, seqs):
        frames = torch.from_numpy(np.stack(seq[0])).cuda()
        if launches is None:
            _hold_b1_b2(f"config 7 {name}, frames 0-{fc - 1}", frames[:fc], cfg.orb, card)
        _reset(kernels)
        runner.run_sequence_batched(frames, cfg, frame_chunk=fc, pair_chunk=pc)
        torch.cuda.synchronize()
        got = {n: kernels[n].launches for n in ("select_maps", "extract_patches")}
        if any(v != T // fc for v in got.values()):
            raise AssertionError(f"config 7 {name} did not launch B1 and B2 once a frame chunk: "
                                 f"{got}")
        launches = launches or got
    res = run_benchmarks.run_config(7, seqs, torch.device("cuda"), legs, card)
    for name, e in res["scenes"].items():
        obj = (f", object keypoint share {e['obj_kp_share_median']:.4f}, object inlier share "
               f"{e['obj_inlier_frac_median']:.4f} (medians over pairs)" if "obj_kp_share_median" in e
               else "")
        print(f"config 7 {name} (hash equal to the file's; frame_chunk {fc}, pair_chunk {pc}): "
              f"{e['ms']:.3f} ms = {e['frames_per_sec']:.2f} frames/s; ATE / extent vs ground truth "
              f"port {e['tpu_vo_ate_vs_gt_rel']:.5f}, reference {e['ref_ate_vs_gt_rel']:.5f}; RPE "
              f"rotation mean port {e['tpu_vo_rpe_rot_mean_deg']} deg, reference "
              f"{e['ref_rpe_rot_mean_deg']} deg; pose_ok {e['pose_ok_frac']:.3f}{obj} [{card}]",
              flush=True)
    bad = [n for n, e in res["scenes"].items() if not e["poses_finite"]]
    bad += [n for n in C7_EXCLUDED if not res["scenes"][n]["obj_inlier_frac_median"] <= 0.15]
    occ = res["scenes"]["occluders"]
    if not (occ["tpu_vo_ate_vs_gt_rel"] < 0.05 and occ["pose_ok_frac"] == 1.0):
        bad.append("occluders")
    if bad:
        raise AssertionError(f"config 7: {bad} fail their bars")
    return launches


def _degrade(pool, renders):
    """Config 6's scenes at every nuisance level, degraded in `pool` from
    the rendered clean scenes: {(scene, level): frames}."""
    clean = {scene: _rendered(renders, ("c6", scene))[0] for scene in run_benchmarks.C6_SCENES}
    futures = {(scene, level): pool.submit(synthetic.nuisance_level, frames, level)
               for scene, frames in clean.items() for level in synthetic.NUISANCE_LEVELS
               if level != "clean"}
    return {(scene, level): clean[scene] if level == "clean" else futures[(scene, level)].result()
            for scene in clean for level in synthetic.NUISANCE_LEVELS}


def _config6_phase(renders, degraded, kernels, card):
    """Config 6 (the corridor and the pan at four nuisance levels) on the
    card; returns B1's and B2's launches in one pass over its 8 runs."""
    legs = reference_band.load()
    runs = {}
    for (scene, level), frames_np in degraded.items():
        name = f"config6_{scene}_{level}"
        if synthetic.frames_sha256(frames_np) != legs[name]["frames_sha256"]:
            raise AssertionError(f"config 6 {scene} {level}: the degraded frames are not the "
                                 f"committed leg's")
        runs[(scene, level)] = torch.from_numpy(np.stack(frames_np)).cuda()
    print(f"config 6: the {len(runs)} degraded scenes hash to their legs' sha256", flush=True)
    for scene in run_benchmarks.C6_SCENES:
        frames = runs[(scene, "harsh")]
        cfg = run_benchmarks.config_cfg(6, frames.shape[2], frames.shape[1])
        _hold_b1_b2(f"config 6 {scene} harsh, frames 0-{run_benchmarks.FRAME_CHUNK - 1}",
                    frames[:run_benchmarks.FRAME_CHUNK], cfg.orb, card)
    _reset(kernels)
    want = 0
    for frames in runs.values():
        T = frames.shape[0]
        cfg = run_benchmarks.config_cfg(6, frames.shape[2], frames.shape[1])
        fc, pc = run_benchmarks.config_chunks(6, T)
        runner.run_sequence_batched(frames, cfg, frame_chunk=fc, pair_chunk=pc)
        want += T // fc
    torch.cuda.synchronize()
    launches = {n: kernels[n].launches for n in ("select_maps", "extract_patches")}
    print(f"config 6: one pass over its {len(runs)} runs launched {launches} (want {want} "
          f"each: one a frame chunk)", flush=True)
    if any(v != want for v in launches.values()):
        raise AssertionError(f"config 6 did not launch B1 and B2 once a frame chunk: {launches}")
    del runs
    clean = degraded[("corridor", "clean")][:C6_DECODE_T]
    files = [encode_gray(f, VARIANT_QUALITY) for f in clean]
    t0 = time.perf_counter()
    decoded = [jpeg_decode(b) for b in files]
    ms = (time.perf_counter() - t0) * 1e3 / len(files)
    if any(not np.array_equal(d, roundtrip_gray(f, VARIANT_QUALITY))
           for d, f in zip(decoded, clean)):
        raise AssertionError("io/jpeg.decode differs from roundtrip_gray on the corridor's frames")
    print(f"JPEG decode (io/jpeg.decode, host clock) of the corridor's first {len(files)} frames "
          f"at {clean[0].shape[1]}x{clean[0].shape[0]}, quality {VARIANT_QUALITY}: {ms:.1f} ms a "
          f"frame, {sum(map(len, files)) / len(files) / 1024:.1f} KiB a file; equal to "
          f"roundtrip_gray [{card}]", flush=True)
    bad = []
    for (scene, level), frames_np in degraded.items():
        seq = _rendered(renders, ("c6", scene))
        e = run_benchmarks.run_scene_6(scene, level, frames_np, seq[1], seq[2],
                                       torch.device("cuda"), legs)
        print(json.dumps({**e, "device": card}), flush=True)
        band = legs[f"config6_{scene}_{level}"]["band"]
        worse = e["tpu_vo_ate_vs_gt_rel"] - e["ref_ate_vs_gt_rel"] > band
        note = "; the port is worse than the reference by more than the band" if worse else ""
        print(f"config 6 {scene} {level} ({len(frames_np)} frames {frames_np[0].shape[1]}x"
              f"{frames_np[0].shape[0]}, frame_chunk {e['frame_chunk']}, pair_chunk "
              f"{e['pair_chunk']}): {e['ms']:.3f} ms = {e['frames_per_sec']:.2f} frames/s; ATE / "
              f"extent vs ground truth port {e['tpu_vo_ate_vs_gt_rel']:.5f}, reference "
              f"{e['ref_ate_vs_gt_rel']:.5f}; RPE rotation mean port "
              f"{e['tpu_vo_rpe_rot_mean_deg']} deg, reference {e['ref_rpe_rot_mean_deg']} deg; "
              f"pose_ok {e['pose_ok_frac']:.3f}; aligned ATE / extent vs the reference "
              f"{e['ate_vs_reference_aligned_rel']:.5f} (band {band:.5f}, within "
              f"{e['parity_within_ref_band']})"
              f"{note} [{card}]", flush=True)
        gated = scene == "corridor" or level == "clean"
        if not e["poses_finite"] or (gated and e["pose_ok_frac"] < MIN_POSE_OK) or (
                scene == "corridor" and not e["tpu_vo_ate_vs_gt_rel"] < C6_MAX_CORRIDOR_ATE):
            bad.append(f"{scene} {level}")
    if bad:
        raise AssertionError(f"config 6: {bad} fail their bars")
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    p.add_argument("--profiling-out", default=None,
                   help="write the profiling tools' results (phase 5j) to this JSON file")
    p.add_argument("--diagnostics-out", default=None,
                   help="write the diagnostics' results (phase 5k) to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    pool = concurrent.futures.ProcessPoolExecutor(
        RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        return _run(card, dev, pool, args.profiling_out, args.diagnostics_out)
    finally:
        pool.shutdown(cancel_futures=True)


def _run(card, dev, pool, profiling_out=None, diagnostics_out=None) -> int:
    t_start = time.perf_counter()

    # 2. build: the kernels (nvcc) and, beside them, the native loader (g++)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        native = ex.submit(_native_build)
        _build.library()
        native.result()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.BuildInfo.seconds:.2f} s) "
          f"-> {_build.BuildInfo.path}", flush=True)
    print(_build.BuildInfo.log.strip(), flush=True)
    n_hmma = _sass_count(_build.BuildInfo.path, "phase_mxu_kernel", "HMMA")
    print(f"phase_mxu_kernel (P2): {n_hmma} HMMA instructions in its SASS", flush=True)
    if n_hmma == 0:
        raise AssertionError("P2's products do not run on the tensor cores")
    # the accuracy path's scenes, rendered on the host beside phases 3-4,
    # which time nothing
    renders = _start_renders(pool)

    cfg = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=1200),
                   ransac=RansacConfig(max_iters=256))
    ocfg = cfg.orb
    frames_np, Rs_gt, ts_gt, K_gt = make_sequence(n_frames=T, width=W, height=H, seed=0)
    frames = torch.from_numpy(np.stack(frames_np)).to(dev)

    # 3. kernels against their plain versions, on the card
    levels = [lv.contiguous() for lv in build_pyramid(frames, ocfg.n_levels, ocfg.scale_factor)]
    levels1 = [lv[:1].contiguous() for lv in levels]  # one frame, as the streaming path has
    budgets = orb.features_per_level(ocfg.n_features, ocfg.n_levels, ocfg.scale_factor)
    thr, border = ocfg.fast_threshold, ocfg.edge_threshold
    shapes = [tuple(lv.shape) for lv in levels]
    noise = stage_bench.make_levels(stage_bench.make_frames(stage_bench.B, H, W, dev))
    pattern = [torch.from_numpy(compass_pattern(8, h, w, thr, seed=i)).to(dev)
               for i, (_, h, w) in enumerate(shapes)]
    g = torch.Generator().manual_seed(0)
    odd = [torch.randint(0, 256, (3, h, w), generator=g).float().to(dev)
           for h, w in ((37, 101), (9, 11), (105, 347), (77, 129))]
    sel_err = 0.0
    maps = None
    for name, lvls, brd in (("main path", levels, border), ("main path at B = 1", levels1, border),
                            ("noise", noise, border),
                            ("compass pattern", pattern, border), ("odd shapes", odd, border),
                            ("odd shapes", odd, 4)):
        lvls = [lv.contiguous() for lv in lvls]
        got = select_maps_levels(lvls, thr, brd)
        for lvl, (pk, hk, bk) in zip(lvls, got):
            pr, hr, br = select_maps_reference(lvl, thr, brd)
            torch.cuda.synchronize()
            if bk != br or not torch.equal(pk, pr) or not torch.equal(hk, hr):
                raise AssertionError(
                    f"select_maps_levels differs from its plain version on the {name} at "
                    f"{tuple(lvl.shape)}, border {brd}: packed {int((pk != pr).sum())} cells, "
                    f"harris max {float((hk - hr).abs().max())}")
            sel_err = max(sel_err, float((hk - hr).abs().max()), float((pk - pr).abs().max()))
        maps = maps or got
        print(f"select_maps_levels == plain on the {name} at {[tuple(lv.shape) for lv in lvls]}, "
              f"border {brd}", flush=True)
    kps = [orb._rank_from_maps(pk, hk, bk, lvl.shape[-1], n_level, ocfg,
                               lvl.shape[-2] * lvl.shape[-1])
           for lvl, n_level, (pk, hk, bk) in zip(levels, budgets, maps)]

    # B2 on all 1200 slots of the main path; the first 8 slots of each
    # level moved to every edge and corner (clamped windows)
    starts = np.cumsum([0] + [ys.shape[1] for ys, _, _, _ in kps])[:-1].tolist()
    main_ys = torch.cat([ys for ys, _, _, _ in kps], 1).contiguous()
    main_xs = torch.cat([xs for _, xs, _, _ in kps], 1).contiguous()
    kys, kxs = main_ys.clone(), main_xs.clone()
    for lvl, a in zip(levels, starts):
        h, w = lvl.shape[-2:]
        edge = torch.tensor([[-5, h + 5, 10, 10, -5, h + 5, 0, h - 1],
                             [10, 10, -5, w + 5, -5, w + 5, 0, w - 1]], dtype=torch.int32)
        kys[:, a:a + 8], kxs[:, a:a + 8] = edge[0].to(dev), edge[1].to(dev)
    tiny = torch.randint(0, 256, (2, 30, 60), generator=g).float().to(dev)
    small_levels = [tiny, levels[0][:2].contiguous(), levels[7][:2].contiguous()]
    tys = torch.cat([torch.randint(-5, lv.shape[1] + 5, (2, n), generator=g, dtype=torch.int32)
                     for lv, n in zip(small_levels, (17, 12, 8))], 1).to(dev)
    txs = torch.cat([torch.randint(-5, lv.shape[2] + 5, (2, n), generator=g, dtype=torch.int32)
                     for lv, n in zip(small_levels, (17, 12, 8))], 1).to(dev)
    patch_err = 0.0
    for name, lvls, ys, xs, offs in (
            (f"all {kys.shape[1]} slots of the main path", levels, kys, kxs, starts),
            (f"all {kys.shape[1]} slots of one frame of the main path (B = 1)", levels1,
             kys[:1].contiguous(), kxs[:1].contiguous(), starts),
            ("a 30x60 level and a tail of 2 windows", small_levels, tys, txs, [0, 17, 29])):
        a = extract_patches_levels(lvls, ys, xs, offs)
        b = torch.cat([extract_patches_reference(lv, ys[:, o:e], xs[:, o:e])
                       for lv, o, e in zip(lvls, offs, offs[1:] + [ys.shape[1]])], 1)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"extract_patches_levels differs on {name}: "
                                 f"{int((a != b).flatten(2).any(-1).sum())} windows")
        patch_err = max(patch_err, float((a - b).abs().max()))
        print(f"extract_patches_levels == plain on {name} ({ys.numel()} windows)", flush=True)

    fast_err = 0.0
    odd = [torch.randint(0, 256, shape, generator=g).float().to(dev)
           for shape in ((3, 37, 101), (2, 9, 11))]
    for name, lvls in (("main path", levels), ("noise", noise), ("compass pattern", pattern),
                       ("odd shape 37x101", odd[:1]), ("odd shape 9x11", odd[1:])):
        before = fast_margin.launches
        got = fast_margin_levels(lvls, thr) if len(lvls) > 1 else [fast_margin(lvls[0], thr)]
        torch.cuda.synchronize()
        if fast_margin.launches != before + 1:
            raise AssertionError(f"B3 launched {fast_margin.launches - before} times for "
                                 f"{len(lvls)} levels of the {name}")
        for lvl, (ks, kc) in zip(lvls, got):
            rs, rc = fast_margin_reference(lvl, thr)
            torch.cuda.synchronize()
            if not (torch.equal(ks, rs) and torch.equal(kc, rc)):
                raise AssertionError(f"fast_margin_levels differs from its plain version on the "
                                     f"{name} at {tuple(lvl.shape)}: {int((kc != rc).sum())} "
                                     f"corners, score max {float((ks - rs).abs().max())}")
            fast_err = max(fast_err, float((ks - rs).abs().max()))
        print(f"fast_margin_levels == plain on the {name} at "
              f"{[tuple(lv.shape) for lv in lvls]}, 1 launch", flush=True)

    # 4. the main path, counted
    kernels = {"select_maps": select_maps, "extract_patches": extract_patches,
               "fast_margin": fast_margin}
    _reset(kernels)
    poses, diags = runner.run_sequence_batched(frames, cfg, seed=0)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"main path launches: {launches}", flush=True)
    if launches["select_maps"] != 1 or launches["extract_patches"] != 1:
        raise AssertionError(f"the main path did not launch B1 and B2 once each: {launches}")
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
    _card_vs_cpu("small sequence", small, small_gt,
                 VOConfig(image_width=SMALL_W, image_height=SMALL_H))

    # the renders end before the first timed phase
    t0 = time.perf_counter()
    concurrent.futures.wait([f for fs in renders.values() for f in fs])
    done = sorted(f.done_s for fs in renders.values() for f in fs)
    print(f"host renders: {len(renders)} scenes in {len(done)} frame ranges on {RENDER_WORKERS} "
          f"processes, started after the build, done {done[0]:.1f}-{done[-1]:.1f} s after their "
          f"start; waited {time.perf_counter() - t0:.1f} s for them before phase 4b; per scene, "
          f"the seconds to its last range: "
          f"{ {str(k): round(max(f.done_s for f in fs), 1) for k, fs in renders.items()} }",
          flush=True)
    t0 = time.perf_counter()
    degraded = _degrade(pool, renders)
    print(f"config 6: {len(degraded) - len(run_benchmarks.C6_SCENES)} degraded scenes made in "
          f"the pool in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    _diag_prefill(pool, renders, degraded)
    print(f"phase 5k's scenes handed over, its single-nuisance pans made in the pool in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bench.prefill(_rendered(renders, "bench"))

    # 4a. bench.py's harness (tools/bench), counted, beside no host work
    t0 = time.perf_counter()
    bench_counts = _bench_phase(kernels, card)
    print(f"phase bench: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # 4b. the streaming path, counted: VisualOdometry frame by frame
    stream_counts = _streaming_phase(frames_np, frames, Rs_gt, cfg, kernels, poses, diags, card)

    # 4c. every VOConfig option on the small sequence, card against CPU
    for name, option in OPTIONS.items():
        _card_vs_cpu(f"small sequence, {name}", small, small_gt,
                     VOConfig(image_width=SMALL_W, image_height=SMALL_H, **option))

    # 4d. the CLI over a KITTI tree of PNG frames, counted; 4d2. its
    # default run, viewer and screenshots, over the same tree, counted
    with tempfile.TemporaryDirectory() as root:
        seq_dir = _write_kitti_tree(root, frames_np[:CLI_T], Rs_gt[:CLI_T], ts_gt[:CLI_T], K_gt)
        cli_counts, cli_t, cli_ms = _cli_phase(seq_dir, CLI_T, K_gt, kernels, card)
        t0 = time.perf_counter()
        viewer_counts = _viewer_phase(seq_dir, frames_np[:CLI_T], cfg, cli_t, cli_ms, kernels,
                                      card)
        print(f"phase CLI default run: {time.perf_counter() - t0:.1f} s", flush=True)

    # 4e. the ingest path: native decode, PrefetchLoader, the streamed
    # runner (counted), io_bench
    t0 = time.perf_counter()
    ingest_counts = _ingest_phase(cfg, kernels, card)
    print(f"phase ingest: {time.perf_counter() - t0:.1f} s", flush=True)

    # 4f. JPEG and PNG variants from files: the Python reader, PrefetchLoader
    # and the CLI (counted)
    t0 = time.perf_counter()
    variant_counts = _variants_phase(frames_np[:VARIANT_T], kernels, card)
    print(f"phase file formats: {time.perf_counter() - t0:.1f} s", flush=True)

    # 5. the FAST-detect path at full width, counted: the stage
    # benchmark's ablation on 8 frames (B3 in +fast ... +orientation, B1
    # and B2 in full), then dense against patch descriptors
    _reset(kernels)
    stage_bench.main(["ablate"])
    torch.cuda.synchronize()
    b3_launches = {name: k.launches for name, k in kernels.items()}
    passes = stage_bench.WARMUP + stage_bench.ITERS
    print(f"FAST-detect path launches: {b3_launches} in {passes} passes", flush=True)
    if (b3_launches["fast_margin"] != B3_PER_PASS * passes or b3_launches["select_maps"] < 1
            or b3_launches["extract_patches"] < 1):
        raise AssertionError(f"the ablation did not go through the kernels as expected "
                             f"({B3_PER_PASS} B3 launches a pass): {b3_launches}")
    ab_frames = stage_bench.make_frames(stage_bench.B, H, W, dev)
    ab_levels = stage_bench.make_levels(ab_frames)
    before = fast_margin.launches
    fast.detect_levels(ab_levels, thr)
    if fast_margin.launches != before + 1:
        raise AssertionError(f"detect_levels launched B3 {fast_margin.launches - before} times")
    n_desc = 0
    for lvl, (ys, xs, valid) in zip(ab_levels, stage_bench.select_keypoints(ab_levels)):
        ang = orientation.ic_angles_prefix(lvl, ys, xs)
        dense = brief.descriptor_bits(gaussian_blur(lvl), ys, xs, ang)
        raw = extract_patches(lvl, ys.contiguous(), xs.contiguous())
        pang = patches.angles_from_patches(raw)
        patch = patches.descriptor_bits_from_patches(raw, pang)
        if not (torch.equal(ang[valid], pang[valid]) and torch.equal(dense[valid], patch[valid])):
            raise AssertionError(f"dense and patch descriptors differ at {tuple(lvl.shape)}: "
                                 f"{int((dense != patch)[valid].any(-1).sum())} descriptors")
        n_desc += int(valid.sum())
    print(f"dense == patch angles and descriptors on {n_desc} keypoints of "
          f"{stage_bench.B} frames", flush=True)

    # 5b. the patch-slots probe path at its full shapes, counted; then
    # each variant that fits against its plain version
    probe_kernels = {"band_windows": patch_probe.band_windows,
                     "phase_windows_mxu": patch_probe.phase_windows_mxu,
                     "phase_windows_roll": patch_probe.phase_windows_roll}
    _reset({**kernels, **probe_kernels})
    probe_rows = patch_slots_probe.main()
    torch.cuda.synchronize()
    p_launches = {name: k.launches for name, k in probe_kernels.items()}
    print(f"probe path launches: {p_launches}, refused: "
          f"{sum(1 for r in probe_rows if r['refused'])} of {len(probe_rows) - 1} variants",
          flush=True)
    if min(p_launches.values()) < 1 or extract_patches.launches < 1:
        raise AssertionError(f"the probe did not go through the kernels: {p_launches}")
    pimgs, pys, pxs = patch_slots_probe.make_inputs(*patch_slots_probe.SHAPE, dev)
    b_p, h_p = pimgs.shape[:2]
    eys = torch.randint(-5, h_p + 5, (b_p, 5), generator=g, dtype=torch.int32).to(dev)
    exs = torch.tensor([1170, 1180, 1200, 1240, 1245], dtype=torch.int32,
                       device=dev).repeat(b_p, 1)
    bys = torch.tensor([h_p - 27, h_p - 22, h_p - 5, h_p - 1, h_p + 4], dtype=torch.int32,
                       device=dev).repeat(b_p, 1)
    bxs = torch.randint(-5, W + 5, (b_p, 5), generator=g, dtype=torch.int32).to(dev)
    bimgs = torch.from_numpy(patch_slots_probe.binade_levels(*pimgs.shape)).to(dev)
    probe_err = {"P1": 0.0, "P2": 0.0, "P3": 0.0}
    checked = []
    for name, run in ([(f"{k} {label}", run) for k, label, run, _ in patch_slots_probe.variants()]
                      + [(f"P1 {v}", patch_slots_probe.build(*v)) for v in PROBE_EXTRA]):
        kw = run.keywords
        try:
            patch_probe.check_fits(name[:2], kw["nslots"],
                                   kw.get("lanes", patch_probe.PHASE_LANES))
        except ValueError:
            continue
        plain = patch_probe.phase_windows_reference
        if run.func is patch_probe.band_windows:
            plain = functools.partial(patch_probe.band_windows_reference,
                                      compact=kw["compact"], lanes=kw["lanes"])
        inputs = [(pimgs, pys, pxs), (pimgs, eys, exs), (pimgs, bys, bxs)]
        if name[:2] in ("P2", "P3"):
            inputs += [(bimgs, pys, pxs), (bimgs, eys, exs)]
        for im, y, x in inputs:
            a, b = run(im, y, x), plain(im, y, x)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"{name} differs from its plain version at {tuple(y.shape)} "
                                     f"keypoints: max {float((a - b).abs().max())}")
            probe_err[name[:2]] = max(probe_err[name[:2]], float((a - b).abs().max()))
        checked.append(name)
    if {n[:2] for n in checked} != set(probe_err):
        raise AssertionError(f"a probe kernel was not checked: {checked}")
    del bimgs  # out of phase 6's peak memory
    print(f"probe kernels == plain on {pys.numel()}, {eys.numel()} right-edge and "
          f"{bys.numel()} bottom-edge keypoints, P2 and P3 also on levels across 41 binades: "
          f"{checked}", flush=True)

    # 5c-5e. the accuracy path, counted: parity with the reference, config
    # 5's window refinement, config 4's batch of sequences
    path_launches = {"main": launches,
                     f"bench (T {BENCH_SIZES['T']}, {BENCH_SIZES['repeats']} repeats x "
                     f"{bench.WARMUP_WINDOWS + bench.WINDOWS} windows)": bench_counts,
                     "streaming (32 frames)": stream_counts,
                     "CLI (24 frames)": cli_counts, "CLI default run (24 frames)": viewer_counts,
                     **{f"streamed, {k} ({INGEST_T} frames)": c
                        for k, c in ingest_counts.items()}, **variant_counts}
    for name, phase in (("parity (2 legs x 5 seeds)", _parity_phase),
                        ("config 5", _config5_phase), ("config 4", _config4_phase)):
        t0 = time.perf_counter()
        path_launches[name] = phase(renders, kernels, card)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    path_launches["config 4"], c4_run = path_launches["config 4"]

    # 5f-5g. config 3 (4K, 8000 keypoints, ratio test) and config 7's
    # dynamic scenes, counted
    t0 = time.perf_counter()
    path_launches["config 3"], c3_times = _config3_phase(renders, kernels, card)
    print(f"phase config 3: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    path_launches["config 7 (one scene)"] = _config7_phase(renders, kernels, card)
    print(f"phase config 7: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    path_launches["config 6"] = _config6_phase(renders, degraded, kernels, card)
    del degraded
    print(f"phase config 6: {time.perf_counter() - t0:.1f} s", flush=True)

    # 5i. the parallel runners, counted in each rank: a world of 1 on NCCL
    # here, worlds of 2 and 4 gloo ranks on this card
    t0 = time.perf_counter()
    path_launches.update(_parallel_phase(np.stack(frames_np), cfg, poses, diags, c4_run,
                                         kernels, card))
    del c4_run
    print(f"phase parallel runners: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # 5j. the profiling tools at their full shapes, counted per tool
    t0 = time.perf_counter()
    path_launches["profiling tools"] = _profiling_tools_phase(kernels, card, profiling_out)
    print(f"phase profiling tools: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # 5k. the accuracy diagnostics and A/B probes at the JAX tools' shapes,
    # counted per tool; then B1's Harris-off instance against its plain
    # version at the probe's shapes and the main path's
    t0 = time.perf_counter()
    path_launches["diagnostics"] = _diagnostics_phase(kernels, card, diagnostics_out)
    rng = np.random.default_rng(0)
    probe_levels = [torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32))[None].to(dev)
                    for h, w in _pyramid_shapes(W, H)]
    off_err = max(_hold_harris_off("probe's levels (one frame of noise)", probe_levels, thr,
                                   border, per_level=True),
                  _hold_harris_off("main path", levels, thr, border))
    del probe_levels
    print(f"phase diagnostics: {time.perf_counter() - t0:.1f} s, launches "
          f"{path_launches['diagnostics']} [{card}]", flush=True)

    # 6. times
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
    main_times = cuda_times(main_path, warmup=WARMUP, reps=MAIN_REPS)
    ms_main = statistics.median(main_times)
    q1, _, q3 = statistics.quantiles(main_times, n=4)
    ms_s1, ms_s2, ms_s3 = (_cuda_ms(f) for f in (stage1, stage2, stage3))
    # B1's two instances in turns (with, without, without, with)
    sel_turns = [_cuda_ms(lambda wh=wh: select_maps_levels(levels, thr, border, with_harris=wh))
                 for wh in (True, False, False, True)]
    sel_ms, sel_off_ms = sel_turns[0], sel_turns[1]
    sel_plain = sum(_cuda_ms(lambda lv=lv: select_maps_reference(lv, thr, border))
                    for lv in levels)
    sel_off_plain = sum(_cuda_ms(lambda lv=lv: select_maps_reference(lv, thr, border,
                                                                     with_harris=False))
                        for lv in levels)
    sel_regs = {wh: select_occupancy(wh) for wh in (True, False)}
    # each instance's own device time (no host work between the events)
    sel_alone = {wh: kernel_alone_ms(lambda wh=wh: select_maps_levels(levels, thr, border,
                                                                      with_harris=wh),
                                     SELECT_KERNEL[wh], MAIN_REPS) for wh in (True, False)}
    if sel_regs[True] != (B1_REGISTERS, B1_BLOCKS):
        raise AssertionError(f"B1's Harris instance: {sel_regs[True]} (registers, blocks per SM), "
                             f"not {(B1_REGISTERS, B1_BLOCKS)} as before its Harris-off instance")
    ends = starts[1:] + [main_ys.shape[1]]
    pat_ms = _cuda_ms(lambda: extract_patches_levels(levels, main_ys, main_xs, starts))
    pat_plain = _cuda_ms(lambda: [extract_patches_reference(lv, main_ys[:, o:e], main_xs[:, o:e])
                                  for lv, o, e in zip(levels, starts, ends)])
    kp = [(main_ys[:, o:e], main_xs[:, o:e]) for o, e in zip(starts, ends)]
    fast_ms = _cuda_ms(lambda: fast_margin_levels(levels, thr))
    fast_alone = kernel_alone_ms(lambda: fast_margin_levels(levels, thr), "fast_margin_kernel",
                                  MAIN_REPS)
    fast_regs, fast_per_sm = fast_ops.occupancy()
    fast_plain = sum(_cuda_ms(lambda lv=lv: fast_margin_reference(lv, thr), warmup=1, reps=2)
                     for lv in levels)
    inner3 = [fast_border(lv.shape[-2], lv.shape[-1], 3, dev) for lv in levels]
    n_inner3 = sum(lv.shape[0] * int(m.sum()) for lv, m in zip(levels, inner3))
    n_cand3 = sum(int((compass_candidates(lv, thr) & m).sum()) for lv, m in zip(levels, inner3))
    fast_bytes = sum(9 * b * h * w for b, h, w in shapes)
    fast_instr = FAST_COMPASS_OPS * n_inner3 + FAST_ARC_OPS * n_cand3
    fast_bound = max((fast_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                     (fast_instr / LANE_INSTR_PER_S * 1e3, "operations"))
    sel_bound, sel_bytes, sel_instr, n_inner, n_cand = _select_bound(levels, thr, border)
    sel_off_bound, _, sel_off_instr, _, _ = _select_bound(levels, thr, border, with_harris=False)
    pat_bound = _patch_bound(levels, kp)
    probe_n = pys.numel()
    probe_out = probe_n * (8 + 4 * patch_probe.ROWS * RAW_SIZE)  # keypoints in, windows out
    p1_rows, p1_cols = patch_probe.band_index(h_p, W, pys, pxs, True, 256)
    ph_rows, ph_cols, ph_keep = patch_probe.phase_index(h_p, W, pys, pxs)
    ph_bytes = 4 * _union_pixels(pimgs.shape, ph_rows, ph_cols, ph_keep) + probe_out
    # the kernels' times are the probe's (phase 5b); their plain versions
    # and library calls are timed here with the same tool, and the
    # kernels alone by the profiler
    probe_windows = {"band_windows": (p1_rows, p1_cols),
                     "phase_windows_mxu": (ph_rows, ph_cols, ph_keep),
                     "phase_windows_roll": (ph_rows, ph_cols, ph_keep)}
    probe_lib, probe_alone = {}, {}
    for name, (kernel, args) in PROBE_TIMED.items():
        run = functools.partial(probe_kernels[name], **args)
        flat, idx = _library_gather([pimgs], [probe_windows[name]])
        if not torch.equal(flat[idx], run(pimgs, pys, pxs)):
            raise AssertionError(f"{name}'s library gather differs from the kernel")
        probe_lib[name] = device_time_ms(lambda f=flat, i=idx: f[i],
                                         reps=patch_slots_probe.REPS)
        probe_alone[name] = kernel_alone_ms(lambda r=run: r(pimgs, pys, pxs),
                                             PROBE_KERNEL_FN[name], patch_slots_probe.REPS)
        del flat, idx
    per_sm = {k: patch_probe.blocks_per_sm(k, PROBE_TIMED[name][1]["nslots"])
              for k, name in (("P1", "band_windows"), ("P2", "phase_windows_mxu"),
                              ("P3", "phase_windows_roll"))}
    b2_flat, b2_idx = _library_gather(
        levels, [(patch_starts(ys, lv.shape[-2])[..., None] + torch.arange(RAW_SIZE, device=dev),
                  patch_starts(xs, lv.shape[-1])[..., None] + torch.arange(RAW_SIZE, device=dev))
                 for lv, (ys, xs) in zip(levels, kp)])
    if not torch.equal(b2_flat[b2_idx], extract_patches_levels(levels, main_ys, main_xs, starts)):
        raise AssertionError("B2's library gather differs from the kernel")
    pat_lib = _cuda_ms(lambda: b2_flat[b2_idx])
    del b2_flat, b2_idx
    probe_times = {}
    for name, plain, bound in (
            ("band_windows", lambda: patch_probe.band_windows_reference(pimgs, pys, pxs, True, 256),
             _bound(4 * _union_pixels(pimgs.shape, p1_rows, p1_cols) + probe_out, 0)),
            ("phase_windows_mxu", lambda: patch_probe.phase_windows_reference(pimgs, pys, pxs),
             _bound(ph_bytes, 0)),
            ("phase_windows_roll", lambda: patch_probe.phase_windows_reference(pimgs, pys, pxs),
             _bound(ph_bytes, 0))):
        kernel, args = PROBE_TIMED[name]
        k_ms = next(r["ms"] for r in probe_rows if r["kernel"] == kernel and r["args"] == args)
        probe_times[name] = (k_ms, device_time_ms(plain, reps=patch_slots_probe.REPS), bound)
    b2_probe = probe_rows[0]["ms"]
    b2_probe_bound = _bound(4 * _window_pixels([pimgs], [(pys, pxs)])
                            + probe_n * (8 + 4 * RAW_SIZE * RAW_SIZE), 0)
    ys1, xs1 = main_ys[:1].contiguous(), main_xs[:1].contiguous()
    sel1 = (_cuda_ms(lambda: select_maps_levels(levels1, thr, border)),
            kernel_alone_ms(lambda: select_maps_levels(levels1, thr, border), "select_kernel",
                             MAIN_REPS),
            sum(_cuda_ms(lambda lv=lv: select_maps_reference(lv, thr, border)) for lv in levels1))
    pat1 = (_cuda_ms(lambda: extract_patches_levels(levels1, ys1, xs1, starts)),
            kernel_alone_ms(lambda: extract_patches_levels(levels1, ys1, xs1, starts),
                             "extract_kernel", MAIN_REPS),
            _cuda_ms(lambda: [extract_patches_reference(lv, ys1[:, o:e], xs1[:, o:e])
                              for lv, o, e in zip(levels1, starts, ends)]))
    stream8_ms = _cuda_ms(lambda: runner.run_sequence_scan(frames[:STREAM_PROFILE_T], cfg,
                                                           seed=0), warmup=1)
    tag = f"[{card}]"
    print(f"main path: {T} frames in {ms_main:.3f} ms (median of {MAIN_REPS}, quartiles "
          f"{q1:.3f}-{q3:.3f} ms) = {T * 1000.0 / ms_main:.2f} frames/s, peak device memory "
          f"{peak_gib:.3f} GiB {tag}")
    print(f"stage 1 features {ms_s1:.3f} ms, stage 2 pairs {ms_s2:.3f} ms, "
          f"stage 3 chain {ms_s3:.3f} ms {tag}")
    print(f"select_maps bound: {sel_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes "
          f"({sel_bytes} B), {sel_instr / LANE_INSTR_PER_S * 1e3:.4f} ms by lane-instructions "
          f"({sel_instr}: {n_inner} pixels inside the border, {n_cand} compass candidates "
          f"among them) {tag}")
    print(f"fast_margin bound: {fast_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes "
          f"({fast_bytes} B), {fast_instr / LANE_INSTR_PER_S * 1e3:.4f} ms by "
          f"lane-instructions ({fast_instr}: {n_inner3} pixels inside the 3-pixel border, "
          f"{n_cand3} compass candidates among them) {tag}")
    print(f"select_maps without Harris bound: {sel_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes "
          f"({sel_bytes} B: the zero map is written), "
          f"{sel_off_instr / LANE_INSTR_PER_S * 1e3:.4f} ms by lane-instructions ({sel_off_instr}) "
          f"{tag}")
    alone = {wh: "not measured" if v is None else f"{v:.4f} ms" for wh, v in sel_alone.items()}
    print(f"select_kernel registers and blocks per SM: Harris instance {sel_regs[True]}, "
          f"Harris-off instance {sel_regs[False]}; in turns (with, without, without, with) "
          f"{[round(x, 4) for x in sel_turns]} ms: dense Harris "
          f"{(sel_turns[0] + sel_turns[3] - sel_turns[1] - sel_turns[2]) / 2:.4f} ms of "
          f"{(sel_turns[0] + sel_turns[3]) / 2:.4f}; each kernel alone (median of {MAIN_REPS} "
          f"launches) {alone[True]} with Harris, {alone[False]} without {tag}")
    for name, k_ms, p_ms, (b_ms, by), lib in (
            (f"select_maps_levels 8 levels x {T} frames, 1 launch", sel_ms, sel_plain, sel_bound,
             None),
            (f"select_maps_levels without Harris 8 levels x {T} frames, 1 launch", sel_off_ms,
             sel_off_plain, sel_off_bound, None),
            (f"extract_patches_levels 1200 kps x {T} frames, 1 launch", pat_ms, pat_plain,
             pat_bound, pat_lib),
            (f"fast_margin_levels 8 levels x {T} frames, 1 launch", fast_ms, fast_plain,
             fast_bound, None)):
        lib = "none" if lib is None else f"{lib:.4f} ms"
        print(f"{name}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({by}), library call {lib} {tag}")
    for name, (k_ms, alone, p_ms) in (("select_maps_levels", sel1), ("extract_patches_levels", pat1)):
        alone = "not measured" if alone is None else f"{alone:.4f} ms"
        print(f"{name} at B = 1 (one frame's 8 levels, as the streaming path calls it), 1 launch: "
              f"kernel {k_ms:.4f} ms (alone {alone}), plain {p_ms:.3f} ms {tag}")
    print(f"run_sequence_scan over {STREAM_PROFILE_T} frames: {stream8_ms:.3f} ms "
          f"({stream8_ms / STREAM_PROFILE_T:.3f} ms per frame; median of {REPS}) {tag}")
    alone = "not measured" if fast_alone is None else f"{fast_alone:.4f} ms"
    print(f"fast_margin_kernel alone {alone} (median of {MAIN_REPS} launches), {fast_regs} "
          f"registers, {fast_per_sm} blocks of 256 threads per SM {tag}")
    for name, (k_ms, p_ms, (b_ms, by)) in probe_times.items():
        alone = probe_alone[name]
        alone = "not measured" if alone is None else f"{alone:.4f} ms"
        print(f"{name} {PROBE_TIMED[name][1]} at the probe's {probe_n} keypoints: kernel "
              f"{k_ms:.4f} ms (kernel alone {alone}), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({by}), library call (aten::index) {probe_lib[name]:.4f} ms {tag}")
    print(f"blocks per SM: P1 (8, 2) {per_sm['P1']}, P2 (16, 8) {per_sm['P2']}, P3 (16, 8) "
          f"{per_sm['P3']} {tag}")
    print(f"phase_windows_mxu's one-hot products: {P2_OPS} bf16 operations per window, "
          f"{P2_OPS * probe_n / BF16_OPS_PER_S * 1e3:.4f} ms at the bf16 peak {tag}")
    print(f"extract_patches (B2) at the probe's {probe_n} keypoints: {b2_probe:.4f} ms, bound "
          f"{b2_probe_bound[0]:.4f} ms ({b2_probe_bound[1]}) {tag}")

    # 7. profile
    for name, fn in (("stage1_features", stage1), ("stage2_pairs", stage2),
                     ("stage3_chain", stage3)):
        _profile(name, fn, card)
    _profile("main_path", main_path, card, rows=25)
    _profile(f"streaming_{STREAM_PROFILE_T}_frames",
             lambda: runner.run_sequence_scan(frames[:STREAM_PROFILE_T], cfg, seed=0), card,
             rows=15)

    # library_ms: for B2 and P1-P3, one aten::index call on prebuilt
    # indices (their plain versions' final gather, checked equal to the
    # kernel's output); no single PyTorch call computes B1's fused maps or
    # B3's FAST scores, so theirs is null. B3's launches are those of its
    # own path (phase 5, 4 a pass), P1-P3's those of the probe's (phase 5b).
    report = {"kernels": [
        {"name": "select_maps", "route": "cuda", "source": "tpu_vo_torch/csrc/select.cu",
         "replaces": "tpu_vo/ops/select_pallas.py:359", "launches": launches["select_maps"],
         "launches_by_path": {p: c["select_maps"] for p, c in path_launches.items()},
         "max_abs_err": sel_err, "ms": sel_ms, "alone_ms": sel_alone[True], "plain_ms": sel_plain,
         "bound_ms": sel_bound[0], "bound_by": sel_bound[1], "library_ms": None,
         "at_config3": c3_times["select_maps"]},
        {"name": "select_maps_no_harris", "route": "cuda", "source": "tpu_vo_torch/csrc/select.cu",
         "replaces": "tpu_vo/ops/select_pallas.py:359",
         "launches": path_launches["diagnostics"]["select_maps_no_harris"],
         "max_abs_err": off_err, "ms": sel_off_ms, "alone_ms": sel_alone[False],
         "plain_ms": sel_off_plain,
         "bound_ms": sel_off_bound[0], "bound_by": sel_off_bound[1], "library_ms": None},
        {"name": "extract_patches", "route": "cuda", "source": "tpu_vo_torch/csrc/patch.cu",
         "replaces": "tpu_vo/ops/patch_pallas.py:181",
         "launches": launches["extract_patches"], "max_abs_err": patch_err,
         "launches_by_path": {p: c["extract_patches"] for p, c in path_launches.items()},
         "ms": pat_ms, "plain_ms": pat_plain,
         "bound_ms": pat_bound[0], "bound_by": pat_bound[1], "library_ms": pat_lib,
         "at_config3": c3_times["extract_patches"]},
        {"name": "fast_margin", "route": "cuda", "source": "tpu_vo_torch/csrc/fast.cu",
         "replaces": "tpu_vo/ops/fast_pallas.py:153",
         "launches": b3_launches["fast_margin"], "max_abs_err": fast_err,
         "ms": fast_ms, "plain_ms": fast_plain,
         "bound_ms": fast_bound[0], "bound_by": fast_bound[1], "library_ms": None},
    ] + [
        {"name": name, "route": "cuda", "source": "tpu_vo_torch/csrc/patch_probe.cu",
         "replaces": f"tools/patch_slots_probe.py:{line}", "launches": p_launches[name],
         "max_abs_err": probe_err[p], "ms": probe_times[name][0], "plain_ms": probe_times[name][1],
         "bound_ms": probe_times[name][2][0], "bound_by": probe_times[name][2][1],
         "library_ms": probe_lib[name]}
        for name, p, line in (("band_windows", "P1", 90), ("phase_windows_mxu", "P2", 226),
                              ("phase_windows_roll", "P3", 322))
    ]}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build to here", flush=True)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
