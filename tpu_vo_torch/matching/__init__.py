from tpu_vo_torch.matching.hamming import (
    hamming_distance_matrix,
    mutual_nearest_match,
    ratio_test_match,
)
from tpu_vo_torch.matching.filter import adaptive_threshold_filter, match_statistics

__all__ = [
    "hamming_distance_matrix",
    "mutual_nearest_match",
    "ratio_test_match",
    "adaptive_threshold_filter",
    "match_statistics",
]
