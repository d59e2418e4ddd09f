"""The card's published peaks and the work of kernels B1 and B2, counted
from the shapes of a stage's inputs and outputs (never from how a kernel
does it, so a later kernel that fuses or splits them reads the same
work). Each input byte is counted read once and each output byte written
once."""

from __future__ import annotations

from typing import List, Tuple

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM bytes per second,
# and issued lane-instructions per second (132 SMs x 128 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
LANE_INSTR_PER_S = 33.5e12

# Kernel B1's lane-instructions per pixel inside the edge-threshold
# border, whatever the image: the FAST compass test (4 differences, 8
# compares, 4 to combine), strict NMS (8 maxes, 1 compare, 1 and), Harris
# (two Sobel stencils of 6, 3 products, three separable 7x7 box sums of 12
# adds, 8 for the response, 1 border select), the packed key (bit reverse,
# shift, or, subtract, select) and half a compare for the 2-row pool. The
# arc scan of a compass candidate depends on the pixels and is left out:
# the count is the least the kernel must issue.
SELECT_OPS_PER_PIXEL = 16 + 10 + (12 + 3 + 36 + 8 + 1) + 5 + 1

WINDOW = 43  # B2's window side, pixels


def level_sizes(height: int, width: int, n_levels: int, scale: float) -> List[Tuple[int, int]]:
    """Each pyramid level's (H, W): round(size / scale^level)."""
    return [(int(round(height / scale ** lv)), int(round(width / scale ** lv)))
            for lv in range(n_levels)]


def level_budgets(n_features: int, n_levels: int, scale: float) -> List[int]:
    """OpenCV's geometric per-level keypoint budget."""
    factor = 1.0 / scale
    nd = n_features * (1 - factor) / (1 - factor ** n_levels)
    out, total = [], 0
    for _ in range(n_levels - 1):
        n = int(round(nd))
        out.append(n)
        total += n
        nd *= factor
    out.append(max(n_features - total, 0))
    return out


def used_levels(height: int, width: int, orb: dict):
    """[(H, W, budget)] of the levels that keep a keypoint."""
    sizes = level_sizes(height, width, orb["n_levels"], orb["scale_factor"])
    budgets = level_budgets(orb["n_features"], orb["n_levels"], orb["scale_factor"])
    return [(h, w, n) for (h, w), n in zip(sizes, budgets) if n > 0]


def b1_work(frames: int, height: int, width: int, orb: dict) -> Tuple[int, int]:
    """(bytes, lane-instructions) of kernel B1 over `frames` frames: each
    level read once as float32, its Harris map (float32) and its 2-row
    pooled packed keys (int32) written once; SELECT_OPS_PER_PIXEL per pixel
    inside the border."""
    nbytes = instr = 0
    border = orb["edge_threshold"]
    for h, w, _ in used_levels(height, width, orb):
        nbytes += frames * (8 * h * w + 4 * ((h + 1) // 2) * (w + w % 2))
        instr += frames * SELECT_OPS_PER_PIXEL * max(h - 2 * border, 0) * max(w - 2 * border, 0)
    return nbytes, instr


def b2_work(frames: int, height: int, width: int, orb: dict) -> int:
    """Bytes of kernel B2 over `frames` frames: per keypoint slot its
    (y, x) int32 pair in and its 43x43 float32 window out. The pixels the
    windows read depend on where the keypoints fall and are left out."""
    slots = sum(min(n, h * w) for h, w, n in used_levels(height, width, orb))
    return frames * slots * (8 + 4 * WINDOW * WINDOW)


def least_seconds(nbytes: float, instr: float = 0.0) -> float:
    """The least time the card needs for this work: the larger of its
    bytes over the HBM rate and its lane-instructions over the issue rate."""
    return max(nbytes / HBM_BYTES_PER_S, instr / LANE_INSTR_PER_S)
