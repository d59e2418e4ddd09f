"""Frozen configuration dataclasses with the reference pipeline's exact constants.

Copied whole from tpu_vo/configs.py (pure dataclasses, no jax), so the
port can be configured without importing the JAX package; the field names
and defaults are pinned equal by tests/test_torch_configs.py.

Every default below is pinned to the reference implementation:
  - ORB params:      reference src/visual_odometry.cpp:65-73
  - match filter:    reference src/visual_odometry.cpp:147,166
  - RANSAC + gates:  reference src/visual_odometry.cpp:213-216,270-271,344,189
  - trajectory scale:reference src/visual_odometry.cpp:352
  - intrinsics rule: reference src/visual_odometry.cpp:90-98 (fx=fy=W, cx=W/2, cy=H/2)
  - viewer layout:   reference src/trajectory_viewer.cpp:66-88,194-202
All configs are hashable frozen dataclasses so they can be closed over by
jit-compiled functions as static arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB detector/descriptor configuration (cv::ORB::create arg-for-arg)."""

    n_features: int = 1200          # kOrbMaxFeatures
    scale_factor: float = 1.2       # kOrbPyramidScale
    n_levels: int = 8               # kOrbPyramidLevels
    edge_threshold: int = 31        # kOrbBorderMarginPx
    first_level: int = 0            # kOrbFirstLevel
    wta_k: int = 2                  # kOrbWtaK (2 -> 256 binary comparisons)
    score_harris: bool = True       # kOrbScoreType == HARRIS_SCORE
    patch_size: int = 31            # kOrbPatchSizePx
    fast_threshold: int = 10        # kOrbFastThreshold
    # TPU-specific: fixed keypoint capacity per pyramid level before the
    # global top-N cut. Data-dependent keypoint counts do not jit; we keep
    # fixed-size slots with validity masks instead.
    per_level_capacity: int = 4096
    # OpenCV's KeyPointsFilter::retainBest keeps score TIES at the cutoff
    # (so its stage-1 FAST cut can pass more than 2n candidates to Harris
    # ranking; integer FAST scores tie often). True emulates the keep-ties
    # cut within a 4n fixed candidate capacity — the strict-parity mode
    # (keypoint-set overlap vs cv2.ORB_create is equal or higher than
    # False at both benchmark resolutions; benchmarks/keepties_diag.json).
    # Default is False for ROBUSTNESS, not parity: the root cause of the
    # once-mysterious "0.2% -> 3.2% ATE at 1241x376" is a bimodal RANSAC
    # failure mode, not a systematic accuracy loss — over 5 RANSAC seeds
    # keep-ties ATE is {0.20, 0.22, 0.33, 3.17, 3.18}% while False is a
    # tight 0.15-0.21% (benchmarks/keepties_seed_sweep.json; full root
    # cause in docs/DESIGN.md "Keep-ties"). False truncates to exactly 2n
    # with ties chosen by bit-reversed index (deterministic, spatially
    # uniform — see ops/select_pallas._bit_reverse).
    retain_best_keep_ties: bool = False
    # Stage-1 candidate cut over the pooled packed map. lax.top_k lowers
    # to a FULL SORT on TPU (0.144 ms at the 1241x376 level-0 shape ==
    # jnp.sort's 0.147; benchmarks/topk_micro.json). With False the cut
    # instead uses lax.approx_max_k (TPU ApproxTopK, 0.039 ms) as a SET
    # prefilter and re-reads the exact int32 packed keys at the returned
    # positions — candidate order within the cut never matters because
    # stage 2 re-ranks by Harris response. The only semantic change is
    # membership at the 2n-th-score boundary: ApproxTopK's bin-max can
    # drop a true boundary candidate (recall_target=0.95) and float32
    # rounding of the packed key collapses tie-break bits below 2^-24 —
    # both touch only equal-or-near-tied FAST scores at the cutoff, the
    # same boundary already documented as tie-order-unspecified vs
    # OpenCV (docs/ROADMAP.md "Known wobbles"). Forced True when
    # retain_best_keep_ties is set: the keep-ties threshold needs the
    # exact 2n-th value, which only a sorted exact cut provides.
    stage1_exact_topk: bool = False

    @property
    def harris_block_size(self) -> int:
        # OpenCV ORB ranks FAST corners by a Harris response computed over a
        # fixed 7x7 block regardless of patch size.
        return 7

    @property
    def harris_k(self) -> float:
        return 0.04

    @property
    def half_patch(self) -> int:
        # Intensity-centroid orientation radius (OpenCV: patchSize/2 = 15).
        return self.patch_size // 2


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching configuration.

    The reference uses BFMatcher(NORM_HAMMING, crossCheck=true) followed by an
    adaptive absolute threshold min(max(3*min_dist, 0.7*median_dist), 35.0)
    (visual_odometry.cpp:87,153,166). A Lowe ratio test is also provided
    (used by the high-density benchmark config) but defaults off for parity.
    """

    cross_check: bool = True
    max_hamming: float = 35.0       # kMaxHammingThreshold
    min_scale: float = 3.0          # 3.0 * min_dist
    median_scale: float = 0.7       # 0.7 * median_dist
    use_ratio_test: bool = False
    ratio: float = 0.75


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC and pose-recovery gates."""

    confidence: float = 0.999       # cv::findEssentialMat prob
    threshold_px: float = 2.0       # cv::findEssentialMat threshold (pixels)
    # TPU-side RANSAC runs a fixed hypothesis budget; adaptive-iteration
    # stopping is applied as a mask, not a dynamic loop bound.
    max_iters: int = 256
    sample_size: int = 5            # Nister 5-point minimal sample
    use_five_point: bool = True     # False -> normalized 8-point samples of 8
    # Hypothesis ranking: "msac" (truncated-residual score, the ranking
    # OpenCV's USAC core behind cv::findEssentialMat actually uses) or
    # "count" (classic inlier counting). Counting saturates on
    # rotation-dominant pairs — every hypothesis explains all matches at
    # 2 px and the argmax tie-break picks arbitrarily bad rotations
    # (estimation/ransac.py module docstring) — so msac is the default.
    score_method: str = "msac"
    # MSAC scores residuals truncated at (scale * threshold_px); inlier
    # masks and gates keep threshold_px. A sub-threshold scoring sigma is
    # what disambiguates near-homographic (rotation-dominant) pairs — the
    # batched equivalent of USAC's shrinking-threshold inner LO. 0.5 is
    # the measured sweet spot (tools/score_variants_diag.py): 0.25
    # overfits multi-pixel upper-pyramid keypoint noise at KITTI
    # resolution (29.8 deg worst-pair translation direction vs 8.5 at
    # 0.5), while 1.0 under-discriminates pan pairs (p90 rotation error
    # 8.1 deg vs 1.4 at 0.5).
    score_sigma_scale: float = 0.5
    # Data-adaptive scoring sigma (round 5): re-rank the finalists at
    # clip(9 * median inlier Sampson residual of the provisional winner,
    # base, threshold^2). On clean data the clamp keeps ranking
    # bit-identical to the fixed base sigma; under heavy motion blur —
    # the one regime where round 4 degraded worse than the reference
    # (pan+harsh, benchmarks/pan_harsh_ablation.json) — the sigma
    # loosens per pair and the pan winner's rotation error drops from
    # mean 2.27/max 13.1 deg to 0.45/1.5 deg
    # (tools/score_variants_diag.py --nuisance blur).
    adaptive_sigma: bool = True
    # Finalist cheirality gate: Sampson/MSAC scores are cheirality-blind
    # (a twisted-pair E has identical epipolar residuals), so RANSAC can
    # crown a hypothesis recoverPose then rejects (<10 valid points),
    # needlessly dropping the frame to the rotation-only fallback. The
    # gate triangulates each finalist's prescreen-subset inliers under
    # its four decompositions and skips finalists with under
    # cheirality_min_frac of them in front of both cameras
    # (estimation/ransac._finalist_cheirality_frac). cv::findEssentialMat
    # has the same blind spot; this is a strict robustness improvement,
    # not a parity deviation (the reference's gates discard such frames
    # anyway, visual_odometry.cpp:270-277).
    cheirality_gate: bool = True
    cheirality_min_frac: float = 0.25
    min_matches_attempt: int = 8    # visual_odometry.cpp:189
    min_matches_for_pose: int = 10  # kMinMatchesForPose, visual_odometry.cpp:344
    min_inliers: int = 12           # kMinInliers, visual_odometry.cpp:271
    min_valid_points: int = 10      # kMinValidPoints, visual_odometry.cpp:270
    distance_thresh: float = 50.0   # cv::recoverPose cheirality depth cutoff
    # Additional (non-reference) gate: require the winning decomposition to
    # hold at least this fraction of the RANSAC inliers. recoverPose's
    # absolute >=10 gate lets a twisted-pair twin win a near-split
    # cheirality vote when true depths flirt with distance_thresh; 0.0
    # reproduces the reference exactly, ~0.5 rejects those flips into the
    # rotation-only fallback.
    min_valid_fraction: float = 0.0


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Top-level pipeline configuration."""

    image_width: int = 1241
    image_height: int = 376
    orb: ORBConfig = ORBConfig()
    match: MatchConfig = MatchConfig()
    ransac: RansacConfig = RansacConfig()
    trajectory_scale: float = 0.3   # kScaleGood, visual_odometry.cpp:352
    # Calibrated intrinsics (fx, fy, cx, cy). The reference has no
    # calibration input at all — it GUESSES fx=fy=W, cx=W/2, cy=H/2
    # (visual_odometry.cpp:90-93). When a dataset ships real calibration
    # (e.g. a KITTI odometry sequence's calib.txt projection matrices,
    # io/kitti.py) set this and the whole pipeline — normalization, RANSAC
    # thresholds, F/E conversions, cheirality — uses the true K instead.
    intrinsics_override: Tuple[float, float, float, float] = None

    @classmethod
    def reference_parity(cls, image_width: int = 1241,
                         image_height: int = 376,
                         n_features: int = 1200,
                         **overrides) -> "VOConfig":
        """The single strict cv2-parity preset: every knob whose default
        deliberately diverges from the reference (for measured accuracy/
        robustness wins) set jointly to its cv2-faithful value.

          - retain_best_keep_ties=True: OpenCV KeyPointsFilter::retainBest
            keeps score ties at the stage-1 FAST cut.
          - stage1_exact_topk=True: exact sorted cut (required by
            keep-ties; ApproxTopK's boundary drop is a deviation).
          - score_sigma_scale=1.0 and adaptive_sigma=False: MSAC
            truncation fixed at the RANSAC threshold itself — what
            OpenCV 5's USAC core behind
            cv::findEssentialMat(RANSAC, 0.999, 2.0) scores with
            (visual_odometry.cpp:213-216). The production defaults
            (0.5 base + per-pair adaptive loosening) are measured
            accuracy/robustness wins, not parity.
          - cheirality_gate=False: cv::findEssentialMat is
            cheirality-blind; the finalist gate is a robustness addition.
          - min_valid_fraction=0.0 and the lexicographic recoverPose
            tie-break are already reference-faithful (the tie-break
            equals cv::recoverPose whenever its bounded cheirality
            counts differ; at exact ties cv2's pick is arbitrary, so
            there is no deterministic reference behavior to match —
            estimation/recover_pose.py:66-85).

        Jointly verified against ReferenceVO across seeds/scenes in
        tests/test_reference_parity.py; faithful-vs-production numbers:
        benchmarks/parity_matrix.json (docs/DESIGN.md "Parity matrix").
        """
        orb = overrides.pop("orb", None) or ORBConfig(
            n_features=n_features,
            retain_best_keep_ties=True,
            stage1_exact_topk=True,
        )
        ransac = overrides.pop("ransac", None) or RansacConfig(
            score_sigma_scale=1.0,
            adaptive_sigma=False,
            cheirality_gate=False,
        )
        return cls(image_width=image_width, image_height=image_height,
                   orb=orb, ransac=ransac, **overrides)

    @property
    def intrinsics(self) -> Tuple[float, float, float, float]:
        """(fx, fy, cx, cy): the calibrated override when provided, else
        derived from image size like the reference.

        fx = fy = image_width (square pixels assumed), principal point at the
        image center (visual_odometry.cpp:90-93).
        """
        if self.intrinsics_override is not None:
            return tuple(float(v) for v in self.intrinsics_override)
        w = float(self.image_width)
        h = float(self.image_height)
        return (w, w, w / 2.0, h / 2.0)


@dataclasses.dataclass(frozen=True)
class ViewerConfig:
    """Offline trajectory renderer configuration (trajectory_viewer.cpp)."""

    width: int = 1024
    height: int = 768
    # ProjectionMatrix(1024,768,500,500,512,389,0.1,1000)
    focal: float = 500.0
    cx: float = 512.0
    cy: float = 389.0
    z_near: float = 0.1
    z_far: float = 1000.0
    grid_size: float = 10.0
    grid_step: float = 1.0
    axis_len: float = 0.5
    cam_axis_len: float = 0.3
    cam_frustum_scale: float = 0.25
    history_axis_len: float = 0.1
    history_frustum_scale: float = 0.08
    history_every_n: int = 10
    # save_trajectory_screenshots framing: dist = max(2.5*extent, 1.0)
    framing_factor: float = 2.5
    framing_min_dist: float = 1.0
    jpeg_quality: int = 95
