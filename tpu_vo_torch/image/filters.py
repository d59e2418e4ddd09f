"""Gaussian kernel of cv::GaussianBlur(ksize=7, sigma=2).

`gaussian_kernel_1d` is copied from tpu_vo/image/filters.py (pure numpy).
The blur itself runs per keypoint window in features/patches.py.
"""

from __future__ import annotations

import numpy as np


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel: exp(-x^2/(2 sigma^2)) normalized to sum 1."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)
