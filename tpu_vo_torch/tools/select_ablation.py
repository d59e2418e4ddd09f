"""Where kernel B1's time goes: the select kernel built with parts of its
work switched off, timed on the main path's 8 levels x 32 frames.

    python -m tpu_vo_torch.tools.select_ablation

Each variant is csrc/select.cu with a phase's loop bound set to 0 (no
arc scan; no Sobel and horizontal box sums; no compass test; no tile
load), compiled by nvcc with the package's flags into
tpu_vo_torch/_build/ablation/ and launched through the same C entry
point. Only the full kernel computes B1's function; the others differ
from it by design and are timed for their difference alone. Prints per
variant the median ms of CUDA-event runs, in rounds that alternate the
variants, with the card's name and power limit. Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import numpy as np
import torch

from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.features import harris
from tpu_vo_torch.image.pyramid import build_pyramid
from tpu_vo_torch.ops import _build, levels as lvl_table, select
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.utils.profiling import card, cuda_times
from tpu_vo_torch.utils.synthetic import make_sequence

OFF = {
    "arc scan": ("j < s_ncand; j += NT)", "j < 0; j += NT)"),
    "Sobel and box sums": ("i < GR * SOBEL_STRIPS; i += NT)", "i < 0; i += NT)",
                           "i < GR * (TILE / HSEG); i += NT)", "i < 0; i += NT)"),
    "compass test": ("base < SC * SC; base += NT)", "base < 0; base += NT)"),
    "tile load": ("i < IMG * IMG; i += NT)", "i < 0; i += NT)"),
}
VARIANTS = (("full", ()), ("no arc scan", ("arc scan",)),
            ("no Sobel and box sums", ("Sobel and box sums",)),
            ("no arc scan, Sobel, box sums", ("arc scan", "Sobel and box sums")),
            ("no compass, arc scan, Sobel, box sums",
             ("compass test", "arc scan", "Sobel and box sums")),
            ("no tile load either", ("tile load", "compass test", "arc scan",
                                     "Sobel and box sums")))


def _source(parts) -> str:
    with open(os.path.join(_build.CSRC, "select.cu")) as f:
        src = f.read()
    for part in parts:
        pairs = OFF[part]
        for old, new in zip(pairs[::2], pairs[1::2]):
            if src.count(old) != 1:
                raise RuntimeError(f"select.cu no longer has one '{old}' ({part})")
            src = src.replace(old, new)
    return src


def build_variants():
    """{name: loaded library} of every variant, compiled in parallel."""
    out_dir = os.path.join(_build.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, parts) in enumerate(VARIANTS):
        cu, so = os.path.join(out_dir, f"v{i}.cu"), os.path.join(out_dir, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(_source(parts))
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for '{name}':\n{log}")
        lib = ctypes.CDLL(so)
        lib.tvo_select_maps_levels.argtypes = _build.library().tvo_select_maps_levels.argtypes
        libs[name] = lib
    return libs


def main(rounds: int = 3) -> dict:
    dev = entry_device()
    cfg = ORBConfig(n_features=1200)
    frames = np.stack(make_sequence(n_frames=32, width=1241, height=376, seed=0)[0])
    levels = [lv.contiguous() for lv in build_pyramid(torch.from_numpy(frames).to(dev),
                                                      cfg.n_levels, cfg.scale_factor)]
    b = levels[0].shape[0]
    maps = select.select_maps_levels(levels, cfg.fast_threshold, cfg.edge_threshold)
    table = lvl_table.level_table(levels, (), 0, *zip(*maps))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        err = lib.tvo_select_maps_levels(table, b, float(cfg.fast_threshold),
                                         cfg.edge_threshold, harris.HARRIS_K,
                                         harris.harris_scale4(), 1, stream)
        _build.check_launch(err, "select ablation")

    libs = build_variants()
    times = {name: [] for name in libs}
    for _ in range(rounds):
        for name, lib in libs.items():
            times[name] += cuda_times(lambda lib=lib: launch(lib), warmup=2, reps=10)
    tag = card()
    result = {name: statistics.median(t) for name, t in times.items()}
    for name, ms in result.items():
        print(f"select kernel, {name}: {ms:.4f} ms (median of {len(times[name])}) [{tag}]",
              flush=True)
    return result


if __name__ == "__main__":
    main()
