"""tpu_vo_torch — the PyTorch + CUDA port of tpu_vo for one NVIDIA H100.

Same module layout and public names as `tpu_vo` (the JAX reference, which
stays beside it unchanged). Plain code is eager PyTorch on whatever device
the input tensors live on; the two kernels of the main path are written
by hand in CUDA C++ (`csrc/`) and launched only for CUDA tensors:

  geometry/    SE3 poses, intrinsics, epipolar algebra, cheirality
  image/       Gaussian kernel, cascaded pyramid
  features/    FAST / Harris / NMS / orientation / rBRIEF / ORB
  ops/         select_maps (kernel B1) and extract_patches (kernel B2)
  matching/    Hamming distances, mutual-NN cross-check, adaptive filter
  estimation/  8-point, SoA Nister 5-point, batched RANSAC, recover_pose
  pipeline/    estimate_pair, chain_relative_poses, run_sequence_batched
  utils/       numpy-only synthetic sequences

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
