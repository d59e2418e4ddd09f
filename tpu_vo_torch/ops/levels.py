"""The pyramid-level table that kernels B1, B2 and B3 take by value
(csrc/levels.cuh, same fields in the same order), so that one launch
covers up to MAX_LEVELS levels."""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

MAX_LEVELS = 8

_Ptrs = ctypes.c_void_p * MAX_LEVELS
_Ints = ctypes.c_int * MAX_LEVELS


class LevelTable(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("total", ctypes.c_int),
                ("img", _Ptrs), ("packed", _Ptrs), ("harris", _Ptrs),
                ("H", _Ints), ("W", _Ints), ("Hp2", _Ints), ("Wout", _Ints),
                ("idx_bits", _Ints), ("first", _Ints), ("score", _Ptrs), ("corner", _Ptrs)]


def check_levels(levels: Sequence[torch.Tensor]) -> None:
    """1..MAX_LEVELS contiguous (B, H, W) float32 levels on one device
    with one B."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"a level table holds 1 to {MAX_LEVELS} levels, got {len(levels)}")
    for lvl in levels:
        if lvl.dim() != 3 or lvl.dtype != torch.float32 or not lvl.is_contiguous():
            raise ValueError(f"levels must be contiguous (B, H, W) float32, got "
                             f"{tuple(lvl.shape)} {lvl.dtype}")
        if lvl.device != levels[0].device or lvl.shape[0] != levels[0].shape[0]:
            raise ValueError("levels must share their device and batch size")


def level_table(levels: Sequence[torch.Tensor], first: Sequence[int] = (), total: int = 0,
                packed: Sequence[torch.Tensor] = (), harris: Sequence[torch.Tensor] = (),
                idx_bits: Sequence[int] = (), score: Sequence[torch.Tensor] = (),
                corner: Sequence[torch.Tensor] = ()) -> LevelTable:
    """The table of `levels`: B2's first slot of each level and slots per
    frame, B1's outputs or B3's (the launchers of B1 and B3 fill in their
    block offsets)."""
    t = LevelTable(n=len(levels), total=total)
    for i, lvl in enumerate(levels):
        h, w = lvl.shape[-2:]
        t.img[i] = lvl.data_ptr()
        t.H[i], t.W[i] = h, w
        t.Hp2[i], t.Wout[i] = (h + 1) // 2, w + w % 2
    for i, start in enumerate(first):
        t.first[i] = start
    for i, (p, hm, bits) in enumerate(zip(packed, harris, idx_bits)):
        t.packed[i], t.harris[i], t.idx_bits[i] = p.data_ptr(), hm.data_ptr(), bits
    for i, (s, c) in enumerate(zip(score, corner)):
        t.score[i], t.corner[i] = s.data_ptr(), c.data_ptr()
    return t
