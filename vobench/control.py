"""The readings that the limits of vobench/limits/<workload>.json are set
from, on the card at the cell's own size:

  program  the program's first call of each seed, through the cell's
           entry as a run drives it, against the reference: the lower
           readings;
  control  the reference computed with TF32 on, in the program's place,
           against the reference in full float32 (the configuration's
           precision): the upper readings. Every control has to fail.

    python -m vobench.control --workload <name> --seeds 1,2,3 [--mode program|control|both]

One JSON line per seed and mode; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys


def readings(workload: str, seeds, modes, device=None, overrides=None):
    """[(mode, seed, numbers)] for each seed and mode."""
    import torch

    from vobench import check, harness
    from vobench.reference import configs as ref_configs

    cell = harness.load_cell(workload, overrides)
    ref_run = harness.reference_run(cell.config)
    dev = torch.device(device or "cuda")
    import tpu_vo_torch.configs as prog_configs

    entry_mod = importlib.import_module(cell.traffic["entry"]["module"])
    entry = getattr(entry_mod, cell.traffic["entry"]["function"])
    cfg = harness.vo_config(cell.config, prog_configs)
    ref_cfg = harness.vo_config(cell.config, ref_configs)
    kwargs, settings = harness.entry_kwargs(cell, dev)
    block = cell.traffic["ref_block"]
    out = []
    tap = harness.Tap(entry_mod, cell.traffic["stages"], False)
    try:
        for seed in seeds:
            frames = harness.make_pool(cell, seed, dev)[0]
            cs = harness.call_seed(seed, 0)
            precise = harness.reference(frames, ref_cfg, cs, block, ref_run, tf32=False,
                                        settings=settings)
            if "program" in modes:
                poses, _ = entry(frames, cfg, cs, **kwargs)
                prog = (tap.out["stage1"], tap.out["stage2"], poses, dict(tap.out))
                out.append(("program", seed, check.compare(prog, precise)))
                del prog, poses
                tap.out.clear()
            if "control" in modes:
                low = harness.reference(frames, ref_cfg, cs, block, ref_run, tf32=True,
                                        settings=settings)
                out.append(("control", seed, check.compare(low, precise)))
                del low
            del precise, frames
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        tap.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--mode", choices=("program", "control", "both"), default="both")
    args = ap.parse_args(argv)
    modes = ("program", "control") if args.mode == "both" else (args.mode,)
    seeds = [int(s) for s in args.seeds.split(",")]
    for mode, seed, numbers in readings(args.workload, seeds, modes):
        print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed, **numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
