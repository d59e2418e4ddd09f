"""Kernels P1, P2 and P3: keypoint windows staged through shared memory.

The three functions of tools/patch_slots_probe.py that reach
pl.pallas_call (the probe that chose kernel B2's design) as CUDA kernels
(csrc/patch_probe.cu):

  band_windows        P1, replaces `build` (Pallas body `_kernel`);
  phase_windows_mxu   P2, replaces `build_v2` (body `_v2_kernel`);
  phase_windows_roll  P3, replaces `build_v3` (body `_v3_kernel`).

Each takes (B, H, W) float32 levels and int32 (B, N) keypoints and
returns (B, N, 48, 43) float32 windows: for a CUDA tensor through its
kernel, for a CPU tensor through its plain version. A kernel takes
`kp_chunk` keypoints at a time in each block and keeps `nslots` windows
in flight there, one warp per window (at most 8 warps a block), as a grid
step of the TPU kernel does.

With r0 = clip(y - 21, 0, H - 48) and c0 = clip(x - 21, 0, W - 43):

- P1's TPU kernel pads the level with zeros to hp = max(ceil8(H), 56)
  rows and wp = (ceil(W / 128) + 1) * 128 columns and copies one (56,
  lanes) band per keypoint, from row r8 = clip(floor8(r0), 0, hp - 56)
  and column cc = min(floor128(c0), (floor(W / 128) + 1) * 128 - lanes).
  With `compact`, out[r, j] = pad[r0 + r, cc + (c0 - floor128(c0) + j)
  mod lanes]; without, out[r, j] = pad[r8 + r, cc + j], the band's
  top-left corner. The clamp of cc does not move the column offset, so
  near the right edge the window comes out shifted left; that is the TPU
  kernel's function, and the port computes it. The CUDA kernel copies
  only the window's own elements from the caller's level, each from the
  pixel that `band_index` names (zero-filled past its edge, which no
  element reaches): no padded copy, and a slot of 8,256 B.
- P2 and P3 compute one function, `phase_windows_reference`:
  out[r, j] = level[r0 + r, c0 + j] for r < 48 - (r0 mod 4), and 0 in
  the last r0 mod 4 rows. Both copy a (48, 128) band from (r0 & ~3,
  c0 & ~63) of the caller's level (`phase_band`; no padded copy, the
  columns past W zero-filled by the copy) with one warp per window. P2
  compacts it by two one-hot products on the tensor cores, each band
  value split into three bf16 parts (`bf16_split`) so that they stay
  exact; P3 by a lane roll and a row offset.

H < 48 or W < 43 is refused (the TPU kernels clip with a negative upper
bound), and so is P1 with (floor(W / 128) + 1) * 128 < lanes (the TPU
kernel's copy would start at a negative column). Only the kernels are
bound by shared memory: a variant whose slots do not fit in one block
raises ValueError on a CUDA tensor; the plain versions compute every
variant. A kernel launches on the device of the tensors it is given.
"""

from __future__ import annotations

import torch

from tpu_vo_torch.ops.patch import RAW_RADIUS, RAW_SIZE, _check

ROWS = 48          # window rows, as the TPU kernels return them
BAND_ROWS = 56     # P1's band rows
PHASE_LANES = 128  # P2's and P3's band columns
SMEM_LIMIT = 232_448  # shared memory one block may use on an H100
_MAX_WARPS = 8        # the kernels' largest block, 256 threads
_MAX_WINDOWS = 2**30  # the kernels' window numbers are int32
_KERNEL_ID = {"P2": 0, "P3": 1, "P1": 2}  # the C entry's kernel numbers


def _check_defined(levels, ys, xs) -> None:
    _check(levels, ys, xs)
    h, w = levels.shape[-2:]
    if h < ROWS or w < RAW_SIZE:
        raise ValueError(f"levels of {h}x{w} are smaller than the "
                         f"{ROWS}x{RAW_SIZE} window")


def _check_slots(kp_chunk: int, nslots: int) -> None:
    if kp_chunk < 1 or nslots < 1:
        raise ValueError(f"kp_chunk {kp_chunk} and nslots {nslots} must be "
                         f"positive")


def _check_lanes(w: int, lanes: int) -> None:
    if lanes < 128 or lanes % 128:
        raise ValueError(f"lanes {lanes} must be a positive multiple of 128")
    if (w // 128 + 1) * 128 < lanes:
        raise ValueError(f"a {lanes}-lane band is wider than a level of "
                         f"width {w} allows ({(w // 128 + 1) * 128} lanes)")


def slot_warps(nslots: int) -> int:
    """Warps per block of P1, P2 and P3: one per slot, at most 8."""
    return min(nslots, _MAX_WARPS)


def smem_bytes(kernel: str, nslots: int, lanes: int = PHASE_LANES):
    """(bytes of one slot, bytes of shared memory a block of `kernel`
    ("P1", "P2" or "P3") uses with `nslots` slots). A P1 slot holds the
    (48, 43) window, whatever its band's lanes; a P2 or P3 slot its (48,
    128) band (P2 stages its window in the band's slot)."""
    slot = 4 * ROWS * (RAW_SIZE if kernel == "P1" else PHASE_LANES)
    return slot, nslots * slot


def check_fits(kernel: str, nslots: int, lanes: int = PHASE_LANES) -> None:
    """Raise ValueError where `nslots` slots of `kernel` do not fit in the
    shared memory of one block."""
    slot, total = smem_bytes(kernel, nslots, lanes)
    if total > SMEM_LIMIT:
        raise ValueError(f"does not fit ({nslots} x {slot:,} B = {total:,} B of slots "
                         f"> {SMEM_LIMIT:,} B of shared memory per block)")


def _starts(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int):
    r0 = torch.clamp(ys.to(torch.int64) - RAW_RADIUS, 0, h - ROWS)
    c0 = torch.clamp(xs.to(torch.int64) - RAW_RADIUS, 0, w - RAW_SIZE)
    return r0, c0


def _band_padded_shape(h: int, w: int):
    """(hp, wp): the zero-padded level P1 copies its bands from."""
    return max(-(-h // 8) * 8, BAND_ROWS), (-(-w // 128) + 1) * 128


def band_index(h: int, w: int, ys: torch.Tensor, xs: torch.Tensor,
               compact: bool = True, lanes: int = 256):
    """(rows (B, N, 48), cols (B, N, 43)) int64: the pixels of P1's padded
    level that each window element holds."""
    hp, _ = _band_padded_shape(h, w)
    r0, c0 = _starts(ys, xs, h, w)
    c128 = c0 // 128 * 128
    cc = torch.clamp(c128, max=(w // 128 + 1) * 128 - lanes)
    r = torch.arange(ROWS, device=ys.device)
    j = torch.arange(RAW_SIZE, device=ys.device)
    if compact:
        return r0[..., None] + r, cc[..., None] + ((c0 - c128)[..., None] + j) % lanes
    r8 = torch.clamp(r0 // 8 * 8, 0, max(hp - BAND_ROWS, 0))
    return r8[..., None] + r, cc[..., None] + j


def phase_band(h: int, w: int, ys: torch.Tensor, xs: torch.Tensor):
    """(row, col, roff, coff, ncols), each (B, N) int64: the (48, 128)
    band that P2 and P3 copy for each window, as `PhaseBand` in
    csrc/patch_probe.cu computes it from the caller's (h, w) level: from
    (row, col) = (r0 & ~3, c0 & ~63), the window at (roff, coff) = (r0 & 3,
    c0 & 63) in it. Its rows lie inside the level (row + 48 <= h); its
    first `ncols` columns come from the level, the rest are zero."""
    r0, c0 = _starts(ys, xs, h, w)
    col = c0 & ~63
    return r0 & ~3, col, r0 & 3, c0 & 63, torch.clamp(w - col, max=PHASE_LANES)


def phase_index(h: int, w: int, ys: torch.Tensor, xs: torch.Tensor):
    """(rows (B, N, 48), cols (B, N, 43), keep (B, N, 48)): the level
    pixels of P2's and P3's windows, and the rows that are not zero."""
    row, col, roff, coff, _ = phase_band(h, w, ys, xs)
    r = torch.arange(ROWS, device=ys.device)
    keep = r < ROWS - roff[..., None]
    return ((row + roff)[..., None] + r,
            (col + coff)[..., None] + torch.arange(RAW_SIZE, device=ys.device), keep)


def bf16_split(x: torch.Tensor):
    """(hi, mid, lo): P2's three-way split of float32 x, with the
    kernel's bit operations: hi = x with its low 16 bits cleared, r = x -
    hi, mid = r with its low 16 bits cleared, lo = r - mid. Each part is
    exact in bfloat16 and (hi + mid) + lo == x bit for bit for finite x
    whose lo part is not subnormal (every |x| >= 2**-100, and 0; -0
    gives +0)."""
    mask = torch.tensor(-65536, dtype=torch.int32)  # 0xFFFF0000

    def top(v):
        return (v.view(torch.int32) & mask).view(torch.float32)

    hi = top(x)
    r = x - hi
    mid = top(r)
    return hi, mid, r - mid


def _gather(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    bi = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[bi, rows[..., :, None], cols[..., None, :]]


def band_windows_reference(levels: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                           compact: bool = True, lanes: int = 256) -> torch.Tensor:
    """Plain PyTorch version of kernel P1: (B, N, 48, 43) float32."""
    _check_defined(levels, ys, xs)
    b, h, w = levels.shape
    _check_lanes(w, lanes)
    hp, wp = _band_padded_shape(h, w)
    pad = torch.nn.functional.pad(levels, (0, wp - w, 0, hp - h))
    return _gather(pad, *band_index(h, w, ys, xs, compact, lanes))


def phase_windows_reference(levels: torch.Tensor, ys: torch.Tensor,
                            xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernels P2 and P3: (B, N, 48, 43) float32."""
    _check_defined(levels, ys, xs)
    rows, cols, keep = phase_index(*levels.shape[-2:], ys, xs)
    return torch.where(keep[..., None], _gather(levels, rows, cols), 0.0)


def _check_windows(wrapper, n: int) -> None:
    if n > _MAX_WINDOWS:
        raise ValueError(f"{wrapper.__name__}: {n} windows above {_MAX_WINDOWS}")


def _launch(wrapper, fn_name: str, img: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor, *args: int) -> torch.Tensor:
    """Launch the C function `fn_name`(img, ys, xs, out, *args, stream)
    into a new (B, N, 48, 43) `out` and count the launch on `wrapper`."""
    from tpu_vo_torch.ops import _build

    if not (img.is_contiguous() and ys.is_contiguous() and xs.is_contiguous()):
        raise ValueError("levels, ys and xs must be contiguous")
    out = torch.empty((*ys.shape, ROWS, RAW_SIZE), dtype=torch.float32, device=img.device)
    if ys.numel() == 0:
        return out
    with _build.on_device(img) as stream:
        err = getattr(_build.library(), fn_name)(img.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                                                 out.data_ptr(), *args, stream)
    _build.check_launch(err, wrapper.__name__)
    wrapper.launches += 1
    return out


def band_windows(levels: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                 kp_chunk: int, nslots: int, compact: bool = True,
                 lanes: int = 256) -> torch.Tensor:
    """(B, N, 48, 43) windows of (B, H, W) levels through (56, lanes)
    bands: kernel P1 on a CUDA tensor, the plain version on a CPU tensor."""
    _check_defined(levels, ys, xs)
    _check_slots(kp_chunk, nslots)
    b, h, w = levels.shape
    _check_lanes(w, lanes)
    if levels.device.type == "cuda":
        check_fits("P1", nslots, lanes)
        _check_windows(band_windows, b * ys.shape[-1])
        return _launch(band_windows, "tvo_band_windows", levels.contiguous(), ys, xs, b, h, w,
                       ys.shape[-1], kp_chunk, nslots, slot_warps(nslots), int(compact), lanes)
    if levels.device.type == "cpu":
        return band_windows_reference(levels, ys, xs, compact, lanes)
    raise ValueError(f"band_windows: unsupported device {levels.device}")


def _phase_windows(wrapper, kernel: str, levels, ys, xs, kp_chunk, nslots,
                   roll: bool) -> torch.Tensor:
    _check_defined(levels, ys, xs)
    _check_slots(kp_chunk, nslots)
    if levels.device.type == "cuda":
        check_fits(kernel, nslots)
        b, h, w = levels.shape
        _check_windows(wrapper, b * ys.shape[-1])
        return _launch(wrapper, "tvo_phase_windows", levels.contiguous(), ys, xs, b, h, w,
                       ys.shape[-1], kp_chunk, nslots, slot_warps(nslots), int(roll))
    if levels.device.type == "cpu":
        return phase_windows_reference(levels, ys, xs)
    raise ValueError(f"{wrapper.__name__}: unsupported device {levels.device}")


def phase_windows_mxu(levels: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                      kp_chunk: int = 16, nslots: int = 8) -> torch.Tensor:
    """(B, N, 48, 43) windows through (48, 128) bands compacted by two
    one-hot products on the tensor cores, exact through a three-way bf16
    split: kernel P2 on a CUDA tensor, the plain version on a CPU tensor."""
    return _phase_windows(phase_windows_mxu, "P2", levels, ys, xs, kp_chunk, nslots, False)


def phase_windows_roll(levels: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                       kp_chunk: int = 16, nslots: int = 8) -> torch.Tensor:
    """(B, N, 48, 43) windows through (48, 128) bands compacted by a lane
    roll and a row offset: kernel P3 on a CUDA tensor, the plain version
    on a CPU tensor."""
    return _phase_windows(phase_windows_roll, "P3", levels, ys, xs, kp_chunk, nslots, True)


def blocks_per_sm(kernel: str, nslots: int) -> int:
    """Blocks of P1, P2 or P3 ("P1", "P2", "P3") with `nslots` slots that
    fit on one SM of the current card (0 where none fits)."""
    from tpu_vo_torch.ops import _build

    n = _build.library().tvo_windows_blocks_per_sm(_KERNEL_ID[kernel], nslots,
                                                   slot_warps(nslots))
    if n < 0:
        raise RuntimeError(f"{kernel}: occupancy query failed")
    return n


band_windows.launches = 0        # kernel launches, counted by _launch
phase_windows_mxu.launches = 0
phase_windows_roll.launches = 0
