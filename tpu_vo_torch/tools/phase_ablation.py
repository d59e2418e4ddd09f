"""Where kernels P2's and P3's time goes: each built as it is and with a
part of its work cut, timed alone at the patch-slots probe's shapes.

    python -m tpu_vo_torch.tools.phase_ablation

Variants, each at the probe's (kp_chunk, nslots) = (16, 8): the kernel
as built (one slot per warp, 8 warps); the same with two slots per warp
(4 warps, through the C entry's `warps` argument); P3 without its window
stores (the band copies alone); P2 without its band copies (the products
and stores alone, on whatever the slots hold). The cut variants are
csrc/patch_probe.cu with a loop bound set to 0 or an early return,
compiled by nvcc with the package's flags into tpu_vo_torch/_build/
phase_ablation/. Only the first two compute the kernels' function, and
are checked against the plain version; the others are timed for their
difference alone. Prints per variant the median ms per launch of
CUDA-event runs of 64 launches, in rounds that alternate the variants,
with the card's name and power limit. Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import torch

from tpu_vo_torch.ops import _build, patch_probe
from tpu_vo_torch.ops.patch import RAW_SIZE
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.tools import patch_slots_probe
from tpu_vo_torch.utils.profiling import card, cuda_times

CUT = {
    "stores": ("for (int f = lane; f < WIN4; f += 32) {\n               float v[4];",
               "for (int f = lane; f < 0; f += 32) {\n               float v[4];"),
    "copies": ("  const PhaseBand p(ys[win], xs[win], H, W);\n  const float* src",
               "  return;\n  const PhaseBand p(ys[win], xs[win], H, W);\n  const float* src"),
}
KP_CHUNK, NSLOTS = 16, 8
# (kernel, label, cut, warps)
VARIANTS = (("P3", "as built", None, NSLOTS), ("P3", "two slots per warp", None, NSLOTS // 2),
            ("P3", "copies alone (no stores)", "stores", NSLOTS),
            ("P2", "as built", None, NSLOTS), ("P2", "two slots per warp", None, NSLOTS // 2),
            ("P2", "products and stores alone (no copies)", "copies", NSLOTS))


def _source(cut: str) -> str:
    """csrc/patch_probe.cu with `cut` applied."""
    with open(os.path.join(_build.CSRC, "patch_probe.cu")) as f:
        src = f.read()
    old, new = CUT[cut]
    if src.count(old) != 1:
        raise RuntimeError(f"patch_probe.cu no longer has one '{old}' ({cut})")
    return src.replace(old, new)


def build_cuts():
    """{cut: loaded library} of each cut source, compiled in parallel, and
    {None: the package's library}."""
    out_dir = os.path.join(_build.BUILD_DIR, "phase_ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for cut in CUT:
        cu, so = os.path.join(out_dir, f"{cut}.cu"), os.path.join(out_dir, f"{cut}.so")
        with open(cu, "w") as f:
            f.write(_source(cut))
        procs[cut] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {None: _build.library()}
    for cut, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for '{cut}':\n{log}")
        libs[cut] = ctypes.CDLL(so)
        libs[cut].tvo_phase_windows.argtypes = libs[None].tvo_phase_windows.argtypes
    return libs


def main(rounds: int = 3) -> dict:
    dev = entry_device()
    imgs, ys, xs = patch_slots_probe.make_inputs(*patch_slots_probe.SHAPE, dev)
    b, h, w = imgs.shape
    n = ys.shape[1]
    out = torch.empty((b, n, patch_probe.ROWS, RAW_SIZE), device=dev)
    ref = patch_probe.phase_windows_reference(imgs, ys, xs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    libs = build_cuts()

    def launcher(kernel, cut, warps):
        lib = libs[cut]

        def launch():
            err = lib.tvo_phase_windows(imgs.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                                        out.data_ptr(), b, h, w, n, KP_CHUNK, NSLOTS, warps,
                                        int(kernel == "P3"), stream)
            _build.check_launch(err, f"phase ablation {kernel}")
        return launch

    runs = {(k, label): launcher(k, cut, warps) for k, label, cut, warps in VARIANTS}
    for (k, label), (_, _, cut, _) in zip(runs, VARIANTS):
        if cut is None:
            runs[k, label]()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{k} {label} differs from the plain version")
    times = {key: [] for key in runs}
    for _ in range(rounds):
        for key, run in runs.items():
            times[key] += cuda_times(run, warmup=2, reps=5, iters=patch_slots_probe.REPS)
    tag = card()
    result = {key: statistics.median(t) for key, t in times.items()}
    for (k, label), ms in result.items():
        print(f"{k} (16, 8) {label}: {ms:.4f} ms (median of {len(times[k, label])} runs of "
              f"{patch_slots_probe.REPS} launches) [{tag}]", flush=True)
    return result


if __name__ == "__main__":
    main()
