"""Where kernel B3's time goes: csrc/fast.cu built as it is and with parts
of its work cut or done another way, each timed alone on the main path's
levels.

    python -m tpu_vo_torch.tools.fast_ablation

Levels: the 8-level pyramid of make_sequence(32, 1241, 376, seed=0), the
main path's frames, at FAST threshold 10. Variants: the kernel as built;
without its arc scan; without its compass test (so without the arc scan
too: what is left is the tile load, the zeroing of the staged outputs and
the stores); that skeleton without its stores (the loads alone) and
without its loads (the stores alone); the outputs by 16-B stores of each
tile row (elements one by one before its first 16-B boundary and after
its last); 32 x 64 tiles instead of 64 x 64. Each is csrc/fast.cu with
one text replaced, compiled by nvcc with the package's flags into
tpu_vo_torch/_build/fast_ablation/. The variants that compute B3's
function are checked against its plain version; the cut ones are timed
for their difference alone. Prints per variant the median ms per launch
of CUDA-event runs of 20 launches, in rounds that alternate the variants,
with ptxas's registers and the card's name and power limit. Needs a card
and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import numpy as np
import torch

from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops import _build, levels as lvl_table
from tpu_vo_torch.ops.fast import fast_margin_reference
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.utils.profiling import card, cuda_times
from tpu_vo_torch.utils.synthetic import make_sequence

THRESHOLD = 10
_STORES = """    for (int c = lane; c < n; c += 32) {
      score[c] = s_score[r * TW + c];
      corner[c] = s_corner[r * TW + c];
    }"""
# 16-B stores of a tile row: VEC elements a lane from the row's first 16-B
# boundary on, the elements before it and after the last one one by one
_ROW_STORES = """    auto run = [&](auto* dst, const auto* src, auto vec) {
      constexpr int VEC = decltype(vec)::value;
      using T = std::remove_pointer_t<decltype(dst)>;
      const int head = min(n, (int)(((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) /
                                    sizeof(T)));
      const int nvec = (n - head) / VEC, tail0 = head + nvec * VEC;
      if (lane < head) dst[lane] = src[lane];
      for (int k = lane; k < nvec; k += 32) {
        union {
          uint4 v;
          T e[VEC];
        } u;
        for (int e = 0; e < VEC; ++e) u.e[e] = src[head + k * VEC + e];
        reinterpret_cast<uint4*>(dst + head)[k] = u.v;
      }
      if (lane < n - tail0) dst[tail0 + lane] = src[tail0 + lane];
    };
    run(score, &s_score[r * TW], std::integral_constant<int, 4>{});
    run(corner, &s_corner[r * TW], std::integral_constant<int, 16>{});"""
# name: [(old, new), ...] replacements of csrc/fast.cu
CUT = {
    "arc": [("for (int j = tid; j < ncand; j += NT)", "for (int j = tid; j < 0; j += NT)")],
    "compass": [("cand = dark >= 2 || bright >= 2;", "cand = false;")],
    "stores": [("for (int r = warp; r < TH && r0 + r < H; r += NWARPS)",
                "for (int r = warp; r < 0; r += NWARPS)")],
    "loads": [("for (int r = warp; r < IH; r += NWARPS) {",
               "for (int r = warp; r < 0; r += NWARPS) {")],
    "row stores": [(_STORES, _ROW_STORES),
                   ("#include <stdint.h>\n", "#include <stdint.h>\n\n#include <type_traits>\n")],
    "32 x 64 tiles": [("constexpr int TH = 64; ", "constexpr int TH = 32; ")],
}
# (label, cuts, computes B3's function)
VARIANTS = (("as built", (), True),
            ("without the arc scan", ("arc",), False),
            ("without the compass test and the arc scan", ("compass",), False),
            ("the loads alone (no compass, arc scan or stores)", ("compass", "stores"), False),
            ("the stores alone (no loads, compass or arc scan)", ("compass", "loads"), False),
            ("16-B stores of each tile row", ("row stores",), True),
            ("32 x 64 tiles", ("32 x 64 tiles",), True))


def _source(cuts) -> str:
    """csrc/fast.cu with each of `cuts` applied."""
    with open(os.path.join(_build.CSRC, "fast.cu")) as f:
        src = f.read()
    for cut in cuts:
        for old, new in CUT[cut]:
            if src.count(old) != 1:
                raise RuntimeError(f"fast.cu no longer has one '{old}' ({cut})")
            src = src.replace(old, new)
    return src


def build_variants():
    """{label: (loaded library, ptxas's register line)}, compiled in parallel."""
    out_dir = os.path.join(_build.BUILD_DIR, "fast_ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (label, cuts, _) in enumerate(VARIANTS):
        cu, so = os.path.join(out_dir, f"v{i}.cu"), os.path.join(out_dir, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(_source(cuts))
        procs[label] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for '{label}':\n{log}")
        lib = ctypes.CDLL(so)
        lib.tvo_fast_margin_levels.argtypes = [lvl_table.LevelTable, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_void_p]
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "Used" in line and "registers" in line]
        libs[label] = (lib, regs[-1] if regs else "")
    return libs


def main(rounds: int = 3) -> dict:
    dev = entry_device()
    frames = torch.from_numpy(np.stack(make_sequence(n_frames=32, width=1241, height=376,
                                                     seed=0)[0])).to(dev)
    levels = [lv.contiguous() for lv in build_pyramid(frames, 8, 1.2)]
    ref = [fast_margin_reference(lv, THRESHOLD) for lv in levels]
    out = [(torch.empty_like(lv), torch.empty(lv.shape, dtype=torch.bool, device=dev))
           for lv in levels]
    table = lvl_table.level_table(levels, score=[s for s, _ in out], corner=[c for _, c in out])
    stream = torch.cuda.current_stream(dev).cuda_stream
    libs = build_variants()

    def launcher(lib, label):
        def launch():
            _build.check_launch(lib.tvo_fast_margin_levels(table, frames.shape[0],
                                                           float(THRESHOLD), stream),
                                f"fast ablation {label}")
        return launch

    runs = {label: launcher(lib, label) for label, (lib, _) in libs.items()}
    for label, _, exact in VARIANTS:
        if exact:
            for s, c in out:
                s.fill_(-1.0)
                c.fill_(True)
            runs[label]()
            torch.cuda.synchronize()
            if not all(torch.equal(s, rs) and torch.equal(c, rc)
                       for (s, c), (rs, rc) in zip(out, ref)):
                raise AssertionError(f"B3 {label} differs from the plain version")
    times = {label: [] for label in runs}
    for _ in range(rounds):
        for label, run in runs.items():
            times[label] += cuda_times(run, warmup=2, reps=5, iters=20)
    tag = card()
    result = {label: statistics.median(t) for label, t in times.items()}
    for label, ms in result.items():
        print(f"B3 {label}: {ms:.4f} ms per launch (8 levels x 32 frames; median of "
              f"{len(times[label])} runs of 20 launches; {libs[label][1]}) [{tag}]", flush=True)
    return result


if __name__ == "__main__":
    main()
