"""tpu_vo_torch — the PyTorch + CUDA port of tpu_vo for one NVIDIA H100.

Same module layout and public names as `tpu_vo` (the JAX reference, which
stays beside it unchanged). Plain code is eager PyTorch on whatever device
the input tensors live on; the entry points (run_sequence_batched, the
stage benchmark) run on the card unless given device="cpu". The kernels
are written by hand in CUDA C++ (`csrc/`) and launched only for CUDA
tensors:

  geometry/    SE3 poses, intrinsics, epipolar algebra, cheirality
  image/       Gaussian kernel and full-frame blur, cascaded pyramid
  features/    FAST / Harris / NMS / orientation / rBRIEF / ORB
  ops/         select_maps (B1), extract_patches (B2), fast_margin (B3)
  matching/    Hamming distances, mutual-NN cross-check, adaptive filter
  estimation/  8-point, SoA Nister 5-point, batched RANSAC, recover_pose
  pipeline/    estimate_pair, chain_relative_poses, run_sequence_batched
  utils/       numpy-only synthetic sequences, fences and CUDA-event timers
  tools/       stage_bench, the frontend stage benchmark

This package imports neither jax nor tpu_vo.
"""

import torch

# Full-f32 matmuls and convolutions everywhere: the JAX package pins
# "highest" precision for the pyramid resize, the pair estimation and
# the pose chain, and TF32 keeps only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from tpu_vo_torch.configs import (  # noqa: E402
    MatchConfig,
    ORBConfig,
    RansacConfig,
    VOConfig,
    ViewerConfig,
)
from tpu_vo_torch.geometry.se3 import Pose  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Pose",
    "ORBConfig",
    "MatchConfig",
    "RansacConfig",
    "VOConfig",
    "ViewerConfig",
    "__version__",
]
