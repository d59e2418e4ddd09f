"""One run of one cell: the frames drawn on the card from the seed, one
warm-up call, a closed loop of calls for the window (traced or not),
then the reference's check of a sample of the window's calls and the
cell's metrics, each read by its own file.

Everything a cell is made of is found by name: its configuration
(configs/<config>.json), its traffic (traffic/<traffic>.json), its scene
(scenes/<kind>.py), its limits (limits/<workload>.json) and each metric's
reader (end_to_end/<name>.py with --trace 0, metrics/<name>.py with
--trace 1), as BENCHMARK.json names them. The configuration names its
reference run (`reference`) and may carry settings for the entry that
are not VOConfig fields (`entry_kwargs`), which the reference run takes
too."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import random
import re
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_vo")
DEFAULT_REFERENCE = "vobench/reference"
REFERENCE_RUN = re.compile(r"^vobench(\.[A-Za-z_]\w*)+:[A-Za-z_]\w*$")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole (tpu_vo_torch is not tpu_vo)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def derive(seed: int, *path) -> int:
    """A 63-bit seed drawn from --seed and a path of small ints."""
    s = np.random.SeedSequence([int(seed) % (1 << 64)] + [int(p) for p in path]).generate_state(2)
    return (int(s[0]) << 32 | int(s[1])) >> 1


def call_seed(seed: int, i: int) -> int:
    """The RANSAC seed of call i, below 2**31 so that seed + row stays small."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), 1, i % (1 << 32)])
               .generate_state(1)[0]) >> 1


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, overrides: Optional[dict] = None) -> Cell:
    """The cell `workload` of BENCHMARK.json with its files; `overrides`
    (tests only) replaces port, traffic and entry settings to cut it down."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    config = load_json(os.path.join(HERE, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
    for k, v in (overrides or {}).items():
        if k in traffic:
            traffic[k] = v
        elif k in config["port"]["orb"] or k in config["port"]["ransac"]:
            config["port"]["orb" if k in config["port"]["orb"] else "ransac"][k] = v
        elif k in config["port"]:
            config["port"][k] = v
        elif k in config.get("entry_kwargs", {}):
            config["entry_kwargs"][k] = v
        else:
            raise KeyError(f"no setting {k!r} to override")
    return Cell(workload, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)], limits)


def vo_config(config: dict, configs_module):
    """The configuration's VOConfig in `configs_module` (the program's or
    the reference's copy)."""
    port = config["port"]
    return configs_module.VOConfig(
        image_width=port["image_width"], image_height=port["image_height"],
        orb=configs_module.ORBConfig(**port["orb"]),
        match=configs_module.MatchConfig(**port["match"]),
        ransac=configs_module.RansacConfig(**port["ransac"]))


def reference_run(config: dict):
    """The configuration's reference run, called as run(frames, ref_cfg,
    seed, block, **entry_kwargs): for `reference` "vobench/reference",
    vobench.reference.pipeline.run; for "vobench.<module>:<function>",
    that function of the benchmark's own module. Anything else raises."""
    name = config.get("reference")
    if name == DEFAULT_REFERENCE:
        from vobench.reference import pipeline
        return pipeline.run
    if not isinstance(name, str) or not REFERENCE_RUN.match(name):
        raise ValueError(f"configuration {config.get('name')!r}: unknown reference {name!r}; "
                         f"give {DEFAULT_REFERENCE!r} or 'vobench.<module>:<function>'")
    module, function = name.split(":")
    run = getattr(importlib.import_module(module), function, None)
    if not callable(run):
        raise ValueError(f"configuration {config.get('name')!r}: {name!r} is not a function")
    return run


def entry_kwargs(cell: Cell, dev) -> tuple:
    """(the entry's keyword arguments, the configuration's entry_kwargs):
    the traffic's kwargs and the configuration's entry_kwargs, which the
    reference run also takes, and the device where it is not the card.
    A key set by both raises."""
    settings = dict(cell.config.get("entry_kwargs", {}))
    kwargs = dict(cell.traffic.get("kwargs", {}))
    clash = sorted(set(settings) & set(kwargs))
    if clash:
        raise ValueError(f"{cell.name}: {clash} set both by the configuration's entry_kwargs "
                         "and by the traffic's kwargs")
    kwargs.update(settings)
    if dev.type != "cuda":
        kwargs["device"] = str(dev)
    return kwargs, settings


def make_pool(cell: Cell, seed: int, device):
    """The traffic's pool of distinct calls' frames, drawn on `device`:
    each item (*call_shape, H, W) uint8, each row of it a sequence of its
    own scene seed."""
    import torch

    scene = importlib.import_module(f"vobench.scenes.{cell.config['scene']['kind']}")
    shape = list(cell.traffic["call_shape"])
    rows, T = math.prod(shape[:-1]), shape[-1]
    W, H = cell.config["port"]["image_width"], cell.config["port"]["image_height"]
    pool = []
    for k in range(cell.traffic["pool"]):
        seqs = [scene.make(derive(seed, 0, k, r), T, W, H, device,
                           **cell.config["scene"]["params"])[0] for r in range(rows)]
        pool.append(torch.stack(seqs).reshape(*shape, H, W))
    return pool


class Tap:
    """Wraps the stage functions that the entry calls through on its own
    module: each call's stage outputs are kept in `out`, and, when traced,
    each stage runs inside a torch.profiler span named <module>.<function>."""

    def __init__(self, module, stages: dict, traced: bool):
        from torch.profiler import record_function

        self.module, self.out, self.saved, self.span_role = module, {}, {}, {}
        short = module.__name__.rsplit(".", 1)[-1]
        for role, fname in stages.items():
            fn = getattr(module, fname)
            span = f"{short}.{fname}"
            self.saved[fname] = fn
            self.span_role[span] = role
            setattr(module, fname, self._wrap(fn, role, span, traced, record_function))

    def _wrap(self, fn, role, span, traced, record_function):
        def tapped(*args, **kwargs):
            if traced:
                with record_function(span):
                    result = fn(*args, **kwargs)
            else:
                result = fn(*args, **kwargs)
            self.out[role] = result
            return result
        return tapped

    def close(self):
        for fname, fn in self.saved.items():
            setattr(self.module, fname, fn)


def _reader(kind: str, name: str):
    """The read(ctx) function of metric `name`: file <kind>/<name>.py."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"vobench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: Optional[str] = None, overrides: Optional[dict] = None) -> dict:
    """One run; returns the result line's object. `device` and `overrides`
    (tests) run it elsewhere than the card, cut down."""
    import torch

    from vobench import check, trace as trace_mod

    cell = load_cell(workload, overrides)
    ref_run = reference_run(cell.config)
    chips = 1
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"{workload} needs {chips} CUDA device(s); "
                             f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        device = "cuda"
    dev = torch.device(device)
    entry_mod = importlib.import_module(cell.traffic["entry"]["module"])
    entry = getattr(entry_mod, cell.traffic["entry"]["function"])
    import tpu_vo_torch.configs as prog_configs

    cfg = vo_config(cell.config, prog_configs)
    kwargs, settings = entry_kwargs(cell, dev)
    pool = make_pool(cell, seed, dev)
    tap = Tap(entry_mod, cell.traffic["stages"], trace)
    shape = cell.traffic["call_shape"]
    rows, T = math.prod(shape[:-1]), shape[-1]

    def one_call(i: int):
        poses, _ = entry(pool[i % len(pool)], cfg, call_seed(seed, i), **kwargs)
        poses.t.cpu()
        return poses

    one_call(-1)                                       # warm-up: the cell's own shapes
    setup_peak = window_peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    keep_n, rng = cell.traffic["check_calls"], random.Random(derive(seed, 2))
    kept = []                                          # reservoir sample of the window's calls
    calls = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    limit_calls = cell.traffic["trace_calls"] if trace else None
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    i = 0
    while time.perf_counter() - t0 < seconds and (limit_calls is None or i < limit_calls):
        a = time.perf_counter()
        if trace:
            with record_function(trace_mod.CALL_SPAN):
                poses = one_call(i)
        else:
            poses = one_call(i)
        b = time.perf_counter()
        calls.append((a - t0, b - t0))
        record = (i, dict(tap.out), poses)
        if len(kept) < keep_n:
            kept.append(record)
        else:
            j = rng.randrange(i + 1)
            if j < keep_n:
                kept[j] = record
        tap.out.clear()
        i += 1
    summary = None
    if trace:
        prof.stop()
        summary = trace_mod.summarize(prof.profiler.kineto_results.events(),
                                      tap.span_role)
        del prof
    if dev.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules the benchmark may not load are loaded: {bad}")
    tap.close()
    if dev.type == "cuda":
        setup_peak = max(setup_peak, window_peak)
        torch.cuda.empty_cache()
    ctx = SimpleNamespace(cell=cell, calls=calls, setup_s=setup_s,
                          frames_per_call=rows * T, pairs_per_call=rows * (T - 1),
                          trace=summary, window_peak_bytes=window_peak,
                          span_role=tap.span_role)
    names = check.names(cell.traffic["stages"])
    readings = _check(cell, kept, pool, seed, dev, ref_run, settings, names)
    numbers = check.worst(readings, names)
    correct = check.judge(numbers, cell.limits, names)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = _reader("metrics" if trace else "end_to_end", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": chips, "memory_peak_bytes": int(setup_peak)}
    line = {"correct": bool(correct), "attempted": len(calls), "failed": 0,
            "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in summary.top_ops],
                             "idle_gaps": [list(x) for x in summary.gaps]}
    line["checks"] = {k: {"value": numbers[k], "limit": cell.limits.get(k)} for k in names}
    line["checks"]["calls_checked"] = {"value": len(readings), "limit": keep_n}
    return line


def _check(cell, kept, pool, seed, dev, ref_run, settings, names):
    """Each kept call's numbers: its program outputs (its stages' taps
    beside them) against the reference run on the same frames and RANSAC
    seed, computed once the window has closed, in full float32 with TF32
    off."""
    import torch

    from vobench import check
    from vobench.reference import configs as ref_configs

    ref_cfg = vo_config(cell.config, ref_configs)
    readings = []
    while kept:
        i, out, poses = kept.pop()
        ref = reference(pool[i % len(pool)], ref_cfg, call_seed(seed, i),
                        cell.traffic["ref_block"], ref_run, tf32=False, settings=settings)
        readings.append(check.compare((out["stage1"], out["stage2"], poses, out), ref))
        del ref, out, poses
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if len(readings) < cell.traffic["check_calls"]:
        readings.append({k: float("nan") for k in names})
    return readings


def reference(frames, ref_cfg, seed: int, block: int, ref_run, tf32: bool, settings=None):
    """The reference run (reference_run) with the configuration's
    entry_kwargs `settings`, its matmuls and convolutions in TF32 or in
    full float32, the flags restored after."""
    import torch

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return ref_run(frames, ref_cfg, seed, block, **(settings or {}))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
