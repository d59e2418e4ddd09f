"""Run one cell of BENCHMARK.json once and print its result line.

    python -m vobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, with --trace 1 the breakdown,
and last the numbers that decided `correct`, each beside its limit,
which also end standard error. It exits non-zero, printing no line,
without a card, or where a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """When this process started, by the host's clock: from its start
    time in clock ticks since boot (10 ms steps), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every compile cache at a fixed path inside the checkout (the program's
# own kernels build into tpu_vo_torch/_build/, also inside it).
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, ".vobench_cache", _sub)

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from vobench.harness import run_cell

    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
