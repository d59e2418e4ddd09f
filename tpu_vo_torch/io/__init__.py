"""Image listing and decoding, decode-ahead loading, KITTI sequences and
trajectory files (port of tpu_vo/io; the same exports)."""

from tpu_vo_torch.io.dataset import list_image_paths, load_frame, parse_timestamp
from tpu_vo_torch.io.loader import PrefetchLoader, load_sequence_array
from tpu_vo_torch.io.trajectory_io import (
    load_checkpoint,
    load_trajectory_tum,
    save_checkpoint,
    save_trajectory_npz,
    save_trajectory_tum,
)

__all__ = [
    "list_image_paths",
    "load_frame",
    "parse_timestamp",
    "PrefetchLoader",
    "load_sequence_array",
    "save_trajectory_tum",
    "load_trajectory_tum",
    "save_trajectory_npz",
    "save_checkpoint",
    "load_checkpoint",
]
