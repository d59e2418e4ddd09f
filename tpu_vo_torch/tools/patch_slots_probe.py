"""Probe: keypoint windows through bands staged in shared memory, by
slots in flight and keypoints per block (port of
tools/patch_slots_probe.py).

Times kernel P1 (`build`: one (56, lanes) band per keypoint, then a lane
roll and a row offset), P2 (`build_v2`: a (48, 128) band compacted by two
one-hot f32 products) and P3 (`build_v3`: the same band, roll and row
offset) over the JAX tool's (kp_chunk, nslots) sweep, and P3 at (16, 8)
and (32, 16), beside kernel B2 (ops/patch.extract_patches) on the same
keypoints. Data as the JAX tool makes it: 8 frames of 376x1241 uniform
[0, 255) f32 from numpy seed 0, then 512 keypoints per frame with y in
[31, 345) and x in [31, 1210). The first line is the timing floor, the
time per call of a call that launches nothing. Each other line gives ms
per call (tools/device_time, CUDA events), GB/s of band traffic and whether rows
[:43] equal B2's windows, tagged with the card's name and power limit. A
variant that the kernels cannot run is printed as refused with the
reason: its bands do not fit in one block's shared memory, or the TPU
kernel does not define it at this width.

    python -m tpu_vo_torch.tools.patch_slots_probe [p1|p2|p3 ...]

It runs on the card and raises without one; main(device="cpu") runs the
plain versions on the CPU, untimed.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from tpu_vo_torch.ops import patch_probe
from tpu_vo_torch.ops.patch import RAW_SIZE, extract_patches
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.tools.device_time import device_time_ms, overhead_ms
from tpu_vo_torch.utils import profiling

BAND_ROWS, BAND_LANES = patch_probe.BAND_ROWS, 256  # P1's band, lanes swept
V2_ROWS, V2_LANES = patch_probe.ROWS, patch_probe.PHASE_LANES

# (kp_chunk, nslots, compact, lanes) of P1, as the JAX tool sweeps them
P1_SWEEP = (
    (8, 2, True, 256), (8, 4, True, 256), (8, 8, True, 256),
    (16, 4, True, 256), (16, 8, True, 256), (16, 16, True, 256),
    (32, 8, True, 256), (32, 16, True, 256), (32, 32, True, 256),
    (32, 16, False, 256),   # copy and fixed write only (no compaction)
    (32, 16, False, 128),   # half-lane band: traffic-scaling probe
    (32, 16, True, 512),    # double-lane band: inverse probe
)
P2_SWEEP = ((16, 8), (32, 8), (32, 16))
P3_SWEEP = ((16, 8), (32, 16))
SHAPE = (8, 376, 1241, 512)  # frames, height, width, keypoints per frame
REPS = 64                    # calls per timing, the JAX tool's REPS default


def build(kp_chunk, nslots, compact=True, lanes=BAND_LANES):
    """P1, the JAX tool's `build`: run(imgs, ys, xs) -> (B, N, 48, 43)."""
    return functools.partial(patch_probe.band_windows, kp_chunk=kp_chunk, nslots=nslots,
                             compact=compact, lanes=lanes)


def build_v2(kp_chunk=16, nslots=8):
    """P2, the JAX tool's `build_v2`: run(imgs, ys, xs) -> (B, N, 48, 43)."""
    return functools.partial(patch_probe.phase_windows_mxu, kp_chunk=kp_chunk, nslots=nslots)


def build_v3(kp_chunk=16, nslots=8):
    """P3, the JAX tool's `build_v3`: run(imgs, ys, xs) -> (B, N, 48, 43)."""
    return functools.partial(patch_probe.phase_windows_roll, kp_chunk=kp_chunk, nslots=nslots)


def make_inputs(b: int, h: int, w: int, n: int, device):
    """(imgs (b, h, w) f32, ys, xs (b, n) int32) as the JAX tool draws them."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, size=(b, h, w)).astype(np.float32)
    ys = rng.integers(31, h - 31, size=(b, n)).astype(np.int32)
    xs = rng.integers(31, w - 31, size=(b, n)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (imgs, ys, xs))


def binade_levels(b: int, h: int, w: int, seed: int = 1) -> np.ndarray:
    """(b, h, w) f32 pixels uniform in [0, 256) times 2**k, k uniform in
    -20..20 per pixel, from numpy `seed`: values across 41 binades, on
    which P2's bf16 split is exercised in full."""
    rng = np.random.default_rng(seed)
    scale = 2.0 ** rng.integers(-20, 21, size=(b, h, w))
    return (rng.uniform(0, 256, size=(b, h, w)) * scale).astype(np.float32)


def variants(which=("p1", "p2", "p3")):
    """(kernel, label, run, band bytes per window) of the sweep; run is a
    partial of the kernel's wrapper, its settings in run.keywords."""
    if "p1" in which:
        for kp_chunk, nslots, compact, lanes in P1_SWEEP:
            yield ("P1", f"chunk={kp_chunk:2d} slots={nslots:2d} compact={int(compact)} "
                   f"lanes={lanes}", build(kp_chunk, nslots, compact, lanes),
                   BAND_ROWS * lanes * 4)
    for kernel, v, build_fn, sweep in (("P2", "v2", build_v2, P2_SWEEP),
                                      ("P3", "v3", build_v3, P3_SWEEP)):
        if kernel.lower() in which:
            for kp_chunk, nslots in sweep:
                yield (kernel, f"{v} chunk={kp_chunk:2d} slots={nslots:2d}",
                       build_fn(kp_chunk, nslots), V2_ROWS * V2_LANES * 4)


def _rate(ms, nbytes: int) -> str:
    if ms is None:
        return "not measured"
    return f"{ms:7.3f} ms ({nbytes / ms / 1e6:4.0f} GB/s)"


def main(argv=None, device=None, shape=SHAPE, reps=REPS):
    """Run the sweep of the kernels named in `argv` (all when None) at
    `shape` = (frames, height, width, keypoints per frame), `reps` calls
    per timing; print the timing floor, then one line per variant, and
    return [{"kernel", "label", "args", "ms", "match", "refused"}] with
    B2's line first ("args": the variant's wrapper settings)."""
    which = list(argv or ("p1", "p2", "p3"))
    unknown = [k for k in which if k not in ("p1", "p2", "p3")]
    if unknown:
        raise SystemExit(f"unknown kernel(s) {unknown}; choose from p1, p2, p3")
    dev = entry_device(device)
    cuda = dev.type == "cuda"
    tag = profiling.card() if cuda else "cpu, plain versions, not timed"
    b, h, w, n = shape
    imgs, ys, xs = make_inputs(b, h, w, n, dev)

    def timed(fn):
        return device_time_ms(fn, imgs, ys, xs, reps=reps) if cuda else None

    if cuda:
        print(f"timing floor (a call that launches nothing): "
              f"{overhead_ms(imgs, reps=reps):.5f} ms [{tag}]", flush=True)
    ref = extract_patches(imgs, ys, xs)
    t0 = timed(extract_patches)
    print(f"production (B2 extract_patches): {_rate(t0, b * n * RAW_SIZE * RAW_SIZE * 4)}, "
          f"{b * n} windows [{tag}]", flush=True)
    rows = [{"kernel": "B2", "label": "production", "args": {}, "ms": t0, "match": True,
             "refused": None}]
    for kernel, label, run, band_bytes in variants(which):
        row = {"kernel": kernel, "label": label, "args": run.keywords, "ms": None,
               "match": None, "refused": None}
        rows.append(row)
        try:
            out = run(imgs, ys, xs)
        except ValueError as e:
            print(f"{label}: refused, {e} [{tag}]", flush=True)
            row["refused"] = str(e)
            continue
        row["match"] = bool(torch.equal(out[:, :, :RAW_SIZE], ref))
        row["ms"] = timed(run)
        print(f"{label}: {_rate(row['ms'], b * n * band_bytes)}  match43={row['match']} "
              f"[{tag}]", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
