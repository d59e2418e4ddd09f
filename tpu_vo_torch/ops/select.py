"""Fused keypoint selection: FAST + strict NMS + border + Harris + packed
(score, index) keys + vertical 2-row max-pool of pyramid levels.

`select_maps` replaces tpu_vo/ops/select_pallas.py `fused_select_maps`,
and `select_maps_levels` does the same for a list of levels. For CUDA
tensors they launch kernel B1 (csrc/select.cu) once, for all levels; for
CPU tensors they run `select_maps_reference`, the plain version built
from features/fast.py and features/harris.py, level by level. Both
return, for levels (B, H, W) float32 on the integer grid 0..255:

  packed   (B, ceil(H/2), W + W % 2) int32: the 2-row max of
           (score << idx_bits) | (mask - bitrev(flat_idx)) at NMS
           survivors inside the border, 0 elsewhere;
  harris   (B, H, W) float32: the dense Harris response inside the
           border, 0 outside it;
  idx_bits bit_length(H*W - 1): score = v >> idx_bits, flat_idx =
           bitrev(mask - (v & mask)) with mask = (1 << idx_bits) - 1.

Descending packed order is descending FAST score with ties broken by
ascending bit-reversed index, which spreads kept ties uniformly over the
image (see _bit_reverse).

with_harris=False (every entry point) is the Pallas kernel's A/B variant:
the same packed keys bit for bit, and a zero Harris map, the Harris work
skipped (kernel B1's second instance on the card). Only the Harris probe
(tools/harris_candidate_probe) asks for it. `select_maps.launches` counts
every launch of B1, `select_maps.launches_no_harris` those of the second
instance among them.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_vo_torch.features import fast, harris
from tpu_vo_torch.ops import levels as lvl_table

HALO = 4  # FAST circle (3) + NMS (1); Sobel (1) + box (3)


def _bit_reverse(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Reverse the low `bits` bits of non-negative x (< 2^32), in int64
    (torch has no uint32 shifts on the CPU); returns int32.

    Used as the tie-break among equal FAST scores: a plain
    ascending-index tie-break biases kept ties toward the top rows.
    """
    x = x.to(torch.int64)
    for shift, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                     (8, 0x00FF00FF), (16, 0x0000FFFF)):
        x = ((x & m) << shift) | ((x >> shift) & m)
    return (x >> (32 - bits)).to(torch.int32)


def idx_bits_for(h: int, w: int) -> int:
    bits = max(1, (h * w - 1).bit_length())
    if bits + 9 > 32:
        raise ValueError(f"level {h}x{w} too large for packed selection")
    return bits


def _check(levels: torch.Tensor, border: int) -> None:
    if levels.dim() != 3 or levels.dtype != torch.float32:
        raise ValueError(f"levels must be (B, H, W) float32, got "
                         f"{tuple(levels.shape)} {levels.dtype}")
    if border < HALO:
        raise ValueError(f"border must be >= {HALO}, got {border}")


def select_maps_reference(levels: torch.Tensor, threshold: int, border: int,
                          with_harris: bool = True):
    """Plain PyTorch version of kernel B1 (same outputs, bit for bit)."""
    _check(levels, border)
    b, h, w = levels.shape
    bits = idx_bits_for(h, w)
    inb = fast._border_mask(h, w, border, levels.device)
    score, corner = fast.fast_score_map(levels, threshold)
    keep = fast.nonmax_suppress(score, corner) & inb
    if with_harris:
        hmap = torch.where(inb, harris.harris_response_map(levels),
                           torch.zeros((), device=levels.device))
    else:
        hmap = torch.zeros((b, h, w), dtype=torch.float32, device=levels.device)

    flat = torch.arange(h * w, device=levels.device).view(h, w)
    key = ((1 << bits) - 1) - _bit_reverse(flat, bits)
    packed = torch.where(keep, (score.to(torch.int32) << bits) | key,
                         torch.zeros((), dtype=torch.int32,
                                     device=levels.device))
    packed = torch.nn.functional.pad(packed, (0, w % 2, 0, h % 2))
    pooled = packed.view(b, (h + 1) // 2, 2, w + w % 2).amax(dim=2)
    return pooled, hmap, bits


def compass_candidates(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """(..., H, W) bool: pixels with at least two of the FAST circle's
    compass points (0, 4, 8, 12) past the threshold on one side, d > thr
    or -d > thr with d = center - point. A nine-long arc of the circle
    holds at least two compass points, so every pixel this rejects has a
    FAST margin <= threshold: kernel B1 skips its arc scan."""
    thr = float(threshold)
    d = [img - fast._shift(img, dy, dx)
         for dx, dy in (fast.CIRCLE_OFFSETS[j] for j in (0, 4, 8, 12))]
    dark = sum((x > thr).to(torch.int32) for x in d)
    bright = sum((-x > thr).to(torch.int32) for x in d)
    return (dark >= 2) | (bright >= 2)


def _select_maps_cuda(levels, threshold: int, border: int, with_harris: bool = True):
    from tpu_vo_torch.ops import _build

    lvl_table.check_levels(levels)
    b = levels[0].shape[0]
    out = []
    for lvl in levels:
        _check(lvl, border)
        h, w = lvl.shape[-2:]
        bits = idx_bits_for(h, w)
        packed = torch.empty((b, (h + 1) // 2, w + w % 2), dtype=torch.int32,
                             device=lvl.device)
        hmap = torch.empty((b, h, w), dtype=torch.float32, device=lvl.device)
        out.append((packed, hmap, bits))
    if b == 0:
        return out
    table = lvl_table.level_table(levels, (), 0, *zip(*out))
    with _build.on_device(levels[0]) as stream:
        err = _build.library().tvo_select_maps_levels(
            table, b, float(threshold), int(border), harris.HARRIS_K,
            harris.harris_scale4(), int(bool(with_harris)), stream)
    _build.check_launch(err, "select_maps" if with_harris else "select_maps (no Harris)")
    select_maps.launches += 1
    if not with_harris:
        select_maps.launches_no_harris += 1
    return out


def select_maps_levels(levels, threshold: int, border: int, with_harris: bool = True):
    """[(packed, harris, idx_bits)] of a list of (B, H, W) float32 pyramid
    levels: kernel B1 launched once for up to MAX_LEVELS levels of CUDA
    tensors, the plain version level by level on CPU tensors."""
    levels = list(levels)
    if levels and levels[0].device.type == "cpu":
        return [select_maps_reference(lvl, threshold, border, with_harris) for lvl in levels]
    if levels and levels[0].device.type == "cuda":
        return [m for i in range(0, len(levels), lvl_table.MAX_LEVELS)
                for m in _select_maps_cuda(levels[i:i + lvl_table.MAX_LEVELS],
                                           threshold, border, with_harris)]
    raise ValueError(f"select_maps_levels: unsupported levels "
                     f"{[lvl.device for lvl in levels]}")


def select_maps(levels: torch.Tensor, threshold: int, border: int, with_harris: bool = True):
    """(packed, harris, idx_bits) of (B, H, W) float32 pyramid levels:
    kernel B1 (a one-level table) on a CUDA tensor, the plain version on a
    CPU tensor."""
    if levels.device.type == "cuda":
        return _select_maps_cuda([levels], threshold, border, with_harris)[0]
    if levels.device.type == "cpu":
        return select_maps_reference(levels, threshold, border, with_harris)
    raise ValueError(f"select_maps: unsupported device {levels.device}")


def occupancy(with_harris: bool = True):
    """(registers per thread, blocks per SM) of one instance of kernel B1
    on the current card."""
    from tpu_vo_torch.ops import _build

    regs = ctypes.c_int(0)
    blocks = _build.library().tvo_select_maps_occupancy(int(bool(with_harris)),
                                                        ctypes.byref(regs))
    if blocks < 0:
        raise RuntimeError("select_maps: occupancy query failed")
    return regs.value, blocks


select_maps.launches = 0            # kernel B1 launches, by either entry point
select_maps.launches_no_harris = 0  # those of the instance without Harris
