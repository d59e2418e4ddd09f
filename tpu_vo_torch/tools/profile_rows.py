"""The profiling tools' shared harness: options, timed rows, JSON lines.

Each profiling tool (profile_headline, profile_features, select_breakdown,
topk_micro, profile_4k, probe_4k_gap, profile_pairs, profile_ransac,
profile_5pt_micro, profile_chain, streamed_probe, profile_batch8,
profile_batch8_flat) has main(argv=None, device=None, **sizes). Its
sizes are its DEFAULTS (the JAX tool's shapes and its FC, PC, REPS,
ITERS, DK and N knobs), then argv (--name value; "none" for None, commas
for a tuple), then the keyword arguments. device None is the card
(pipeline/runner.entry_device), which raises without one; nothing falls
back to the CPU.

A row timed on the card holds "ms", the CUDA-event ms a call
(tools/device_time: the median of `iters` runs of `reps` calls, after
`warmup` calls), and, where the tool profiles it (stage 2, the chain, a
whole runner), torch.profiler's figures over `reps` more calls
(utils/profiling.busy_profile): "host_ms" a call (the profiler on),
"busy_ms" (the union of the device intervals), "busy_share",
"device_ops", "htod", "dtoh" and "waits" (runtime calls that wait for
the card). On the CPU a row holds the host clock's "host_ms" a call, and
each device figure reads NOT_ON_CARD. A row with no counterpart on the
card holds a string that says why.

Every row is printed as a JSON line tagged with the card's name and
power limit (utils/profiling.card); the last line is one JSON object of
all rows, with `expected_launches`, the launches of kernels B1
(select_maps) and B2 (extract_patches) that the tool's calls imply (and
of any other kernel the tool names: B1's instance without Harris,
select_maps_no_harris, among B1's; B3, fast_margin), and
`--out PATH` writes that object too. Nothing else is written.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from tpu_vo_torch.pipeline.runner import _spans, entry_device
from tpu_vo_torch.tools.device_time import device_time_ms
from tpu_vo_torch.utils.profiling import busy_profile, card
from tpu_vo_torch.utils.synthetic import make_sequence

NOT_ON_CARD = "not measured: CPU run"
KERNELS = ("select_maps", "extract_patches")  # B1, B2


def _value(text: str, like):
    """Parse a command-line value like the default `like`."""
    if isinstance(like, tuple):
        kind = type(like[0]) if like else int
        return tuple(_value(t, kind()) for t in text.split(",") if t)
    if text.lower() == "none":
        return None
    if isinstance(like, bool):
        return text.lower() in ("1", "true", "yes")
    if isinstance(like, float):
        return float(text)
    if isinstance(like, str):
        return text
    return int(text)


def options(argv, defaults: Dict[str, Any], device, sizes: Dict[str, Any],
            description: str) -> argparse.Namespace:
    """The tool's sizes (defaults, then argv, then `sizes`), its device
    (`device`, else --device, else the card) and --out."""
    unknown = sorted(set(sizes) - set(defaults) - {"out"})
    if unknown:
        raise TypeError(f"unknown sizes {unknown}; the tool takes {sorted(defaults)}")
    p = argparse.ArgumentParser(description=description)
    for k, v in defaults.items():
        p.add_argument("--" + k.replace("_", "-"), dest=k, default=v,
                       type=functools.partial(_value, like=v))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    p.add_argument("--out", default=None, help="also write the last line's object here")
    args = p.parse_args([] if argv is None else list(argv))
    for k, v in sizes.items():
        setattr(args, k, v)
    args.device = entry_device(device if device is not None else args.device)
    return args


def frame_launches(n: int, chunk: Optional[int]) -> int:
    """B1's (and B2's) launches of stage 1 over n frames, `chunk` a call."""
    return len(_spans(n, chunk))


@functools.lru_cache(maxsize=4)
def sequence(T: int, W: int, H: int, seed: int = 0) -> np.ndarray:
    """make_sequence(T, W, H, seed)'s frames, (T, H, W) uint8, read-only
    (rendered once per process: several tools share them)."""
    arr = np.stack(make_sequence(n_frames=T, width=W, height=H, seed=seed)[0])
    arr.setflags(write=False)
    return arr


def host_ms(fn: Callable[[], Any], reps: int, iters: int, warmup: int) -> float:
    """Median over `iters` runs of `reps` calls of fn() of the host clock's
    ms a call, after `warmup` calls (the CPU's rows)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


class Rows:
    """A tool's rows, printed as they come and gathered for its last line."""

    def __init__(self, tool: str, opts: argparse.Namespace, kernels: Tuple[str, ...] = KERNELS):
        self.tool = tool
        self.kernels = kernels
        self.dev = opts.device
        self.on_card = self.dev.type == "cuda"
        self.card = card() if self.on_card else "cpu"
        self.out = getattr(opts, "out", None)
        self.sizes = {k: v for k, v in vars(opts).items() if k not in ("device", "out")}
        self.rows: Dict[str, Any] = {}
        self.expected = dict.fromkeys(kernels, 0)

    def counted(self, fn: Callable[[], Any], launches: Tuple[int, ...] = (0, 0)):
        """fn, each call adding `launches` (B1, B2, then the tool's other
        kernels, in the order of `kernels`) to expected_launches on the card
        (on the CPU the kernels' plain versions run, uncounted)."""
        def call(*args):
            if self.on_card:
                for k, n in zip(self.kernels, launches):
                    self.expected[k] += n
            return fn(*args)
        return call

    def run(self, fn: Callable[[], Any], launches: Tuple[int, ...] = (0, 0)):
        """One untimed call of fn (a setup step), counted."""
        return self.counted(fn, launches)()

    def time(self, name: str, fn: Callable[[], Any], reps: int, iters: int, warmup: int = 1,
             launches: Tuple[int, ...] = (0, 0), profile: bool = False,
             per: Optional[Tuple[str, int]] = None, **extra) -> Dict[str, Any]:
        """Time fn() as row `name` (see the module docstring); `per`
        (unit, n) adds ms_per_<unit>; `extra` goes into the row as it is."""
        fn = self.counted(fn, launches)
        if self.on_card:
            row = {"ms": device_time_ms(fn, reps=reps, iters=iters, warmup=warmup)}
            if profile:
                p = busy_profile(fn, reps, 0, name=name)
                row.update(host_ms=p["host_ms"], busy_ms=p["busy_ms"],
                           busy_share=p["busy_share"], device_ops=p["device_ops"],
                           htod=p["htod"], dtoh=p["dtoh"], waits=p["waits_total"])
        else:
            row = {"ms": NOT_ON_CARD, "host_ms": host_ms(fn, reps, iters, warmup)}
            if profile:
                row.update(dict.fromkeys(("busy_ms", "busy_share", "device_ops", "waits"),
                                         NOT_ON_CARD))
        if per is not None:
            row[f"ms_per_{per[0]}"] = row["ms"] / per[1] if self.on_card else NOT_ON_CARD
        row.update(extra)
        return self.add(name, row)

    def add(self, name: str, value):
        """Row `name` with a value (a dict of figures, a number, a flag or a
        string giving why the card has no counterpart); printed at once."""
        self.rows[name] = value
        line = {"tool": self.tool, "row": name}
        line.update(value if isinstance(value, dict) else {"value": value})
        line["card"] = self.card
        print(json.dumps(line), flush=True)
        return value

    def finish(self) -> Dict[str, Any]:
        """Print (and write to --out) the object of all rows; return it."""
        obj = {"tool": self.tool, "card": self.card, "device": str(self.dev),
               "clock": "CUDA events; torch.profiler" if self.on_card else "host",
               "sizes": self.sizes, "rows": self.rows,
               "expected_launches": self.expected if self.on_card else NOT_ON_CARD}
        text = json.dumps(obj)
        print(text, flush=True)
        if self.out:
            with open(self.out, "w") as f:
                f.write(text + "\n")
        return obj
