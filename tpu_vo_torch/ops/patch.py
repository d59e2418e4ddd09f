"""Per-keypoint 43x43 window extraction.

`extract_patches` replaces tpu_vo/ops/patch_pallas.py
`extract_patches_pallas` (and equals tpu_vo/features/patches.py
`extract_patches`). For a CUDA tensor it launches kernel B2
(csrc/patch.cu); for a CPU tensor it runs `extract_patches_reference`.

The window of keypoint (y, x) starts at clip(y - 21, 0, H' - 43),
clip(x - 21, 0, W' - 43) of the level zero-padded to H' = max(H, 43),
W' = max(W, 43), like jax.lax.dynamic_slice, so every slot (valid or
not) and every level size gives the same window on both paths.
"""

from __future__ import annotations

import torch

RAW_RADIUS = 21
RAW_SIZE = 2 * RAW_RADIUS + 1  # 43


def _check(levels: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> None:
    if levels.dim() != 3 or levels.dtype != torch.float32:
        raise ValueError(f"levels must be (B, H, W) float32, got "
                         f"{tuple(levels.shape)} {levels.dtype}")
    want = (levels.shape[0], ys.shape[-1])
    for name, t in (("ys", ys), ("xs", xs)):
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be int32 of shape {want}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != levels.device:
            raise ValueError(f"{name} is on {t.device}, levels on "
                             f"{levels.device}")


def _starts(c: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.clamp(c.to(torch.int64) - RAW_RADIUS, 0,
                       max(dim, RAW_SIZE) - RAW_SIZE)


def extract_patches_reference(levels: torch.Tensor, ys: torch.Tensor,
                              xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B2: (B, N, 43, 43) float32."""
    _check(levels, ys, xs)
    b, h, w = levels.shape
    lvl = torch.nn.functional.pad(
        levels, (0, max(0, RAW_SIZE - w), 0, max(0, RAW_SIZE - h)))
    r = torch.arange(RAW_SIZE, device=levels.device)
    rows = (_starts(ys, h)[..., None] + r)[..., :, None]    # (B, N, 43, 1)
    cols = (_starts(xs, w)[..., None] + r)[..., None, :]    # (B, N, 1, 43)
    bi = torch.arange(b, device=levels.device)[:, None, None, None]
    return lvl[bi, rows, cols]


def _extract_patches_cuda(levels: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    from tpu_vo_torch.ops import _build

    _check(levels, ys, xs)
    if not (levels.is_contiguous() and ys.is_contiguous()
            and xs.is_contiguous()):
        raise ValueError("levels, ys and xs must be contiguous")
    b, h, w = levels.shape
    n = ys.shape[-1]
    out = torch.empty((b, n, RAW_SIZE, RAW_SIZE), dtype=torch.float32,
                      device=levels.device)
    if b * n == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(levels.device).cuda_stream
    err = lib.tvo_extract_patches(levels.data_ptr(), ys.data_ptr(),
                                  xs.data_ptr(), out.data_ptr(), b, h, w, n,
                                  stream)
    _build.check_launch(err, "extract_patches")
    extract_patches.launches += 1
    return out


def extract_patches(levels: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """(B, N, 43, 43) windows of (B, H, W) levels at int32 (B, N)
    keypoints: kernel B2 on a CUDA tensor, the plain version on a CPU
    tensor."""
    if levels.device.type == "cuda":
        return _extract_patches_cuda(levels, ys, xs)
    if levels.device.type == "cpu":
        return extract_patches_reference(levels, ys, xs)
    raise ValueError(f"extract_patches: unsupported device {levels.device}")


extract_patches.launches = 0  # kernel launches, counted by _extract_patches_cuda
