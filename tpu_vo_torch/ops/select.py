"""Fused keypoint selection: FAST + strict NMS + border + Harris + packed
(score, index) keys + vertical 2-row max-pool, one pass per pyramid level.

`select_maps` replaces tpu_vo/ops/select_pallas.py `fused_select_maps`.
For a CUDA tensor it launches kernel B1 (csrc/select.cu); for a CPU
tensor it runs `select_maps_reference`, the plain version built from
features/fast.py and features/harris.py. Both return, for levels
(B, H, W) float32 on the integer grid 0..255:

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
"""

from __future__ import annotations

import torch

from tpu_vo_torch.features import fast, harris

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


def _border_mask(h: int, w: int, border: int, device) -> torch.Tensor:
    row = torch.arange(h, device=device)
    col = torch.arange(w, device=device)
    return (((row >= border) & (row < h - border))[:, None]
            & ((col >= border) & (col < w - border))[None, :])


def _check(levels: torch.Tensor, border: int) -> None:
    if levels.dim() != 3 or levels.dtype != torch.float32:
        raise ValueError(f"levels must be (B, H, W) float32, got "
                         f"{tuple(levels.shape)} {levels.dtype}")
    if border < HALO:
        raise ValueError(f"border must be >= {HALO}, got {border}")


def select_maps_reference(levels: torch.Tensor, threshold: int, border: int):
    """Plain PyTorch version of kernel B1 (same outputs, bit for bit)."""
    _check(levels, border)
    b, h, w = levels.shape
    bits = idx_bits_for(h, w)
    inb = _border_mask(h, w, border, levels.device)
    score, corner = fast.fast_score_map(levels, threshold)
    keep = fast.nonmax_suppress(score, corner) & inb
    hmap = torch.where(inb, harris.harris_response_map(levels),
                       torch.zeros((), device=levels.device))

    flat = torch.arange(h * w, device=levels.device).view(h, w)
    key = ((1 << bits) - 1) - _bit_reverse(flat, bits)
    packed = torch.where(keep, (score.to(torch.int32) << bits) | key,
                         torch.zeros((), dtype=torch.int32,
                                     device=levels.device))
    packed = torch.nn.functional.pad(packed, (0, w % 2, 0, h % 2))
    pooled = packed.view(b, (h + 1) // 2, 2, w + w % 2).amax(dim=2)
    return pooled, hmap, bits


def _select_maps_cuda(levels: torch.Tensor, threshold: int, border: int):
    from tpu_vo_torch.ops import _build

    _check(levels, border)
    if not levels.is_contiguous():
        raise ValueError("levels must be contiguous")
    b, h, w = levels.shape
    bits = idx_bits_for(h, w)
    packed = torch.empty((b, (h + 1) // 2, w + w % 2), dtype=torch.int32,
                         device=levels.device)
    hmap = torch.empty((b, h, w), dtype=torch.float32, device=levels.device)
    if b == 0:
        return packed, hmap, bits
    lib = _build.library()
    stream = torch.cuda.current_stream(levels.device).cuda_stream
    err = lib.tvo_select_maps(
        levels.data_ptr(), packed.data_ptr(), hmap.data_ptr(), b, h, w,
        packed.shape[1], packed.shape[2], float(threshold), int(border),
        bits, harris.HARRIS_K, harris.harris_scale4(), stream)
    _build.check_launch(err, "select_maps")
    select_maps.launches += 1
    return packed, hmap, bits


def select_maps(levels: torch.Tensor, threshold: int, border: int):
    """(packed, harris, idx_bits) of (B, H, W) float32 pyramid levels:
    kernel B1 on a CUDA tensor, the plain version on a CPU tensor."""
    if levels.device.type == "cuda":
        return _select_maps_cuda(levels, threshold, border)
    if levels.device.type == "cpu":
        return select_maps_reference(levels, threshold, border)
    raise ValueError(f"select_maps: unsupported device {levels.device}")


select_maps.launches = 0  # kernel launches, counted by _select_maps_cuda
