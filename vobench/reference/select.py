# Frozen copy of tpu_vo_torch/ops/select.py (plain parts only): the benchmark's reference.
"""Kernel B1's plain version: FAST + strict NMS + border + Harris +
packed (score, index) keys + vertical 2-row max-pool of a (B, H, W)
float32 level on the integer grid 0..255. Returns

  packed   (B, ceil(H/2), W + W % 2) int32: the 2-row max of
           (score << idx_bits) | (mask - bitrev(flat_idx)) at NMS
           survivors inside the border, 0 elsewhere;
  harris   (B, H, W) float32: the dense Harris response inside the
           border, 0 outside it;
  idx_bits bit_length(H*W - 1).

Descending packed order is descending FAST score with ties broken by
ascending bit-reversed index.
"""

from __future__ import annotations

import torch

from vobench.reference import fast, harris

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
    """Kernel B1's outputs for one level, in plain PyTorch."""
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
