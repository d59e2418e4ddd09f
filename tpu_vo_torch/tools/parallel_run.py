"""One rank of a world that runs the parallel runners of
tpu_vo_torch/parallel/sharding over frames from .npy files, writing what
the rank gets back to .npz files.

Under torchrun (env:// rendezvous; gloo on the CPU):

    torchrun --nproc-per-node 2 -m tpu_vo_torch.tools.parallel_run JOBS.json \\
        --backend gloo --device cpu

or one process per rank, started by hand or by a parent:

    python -m tpu_vo_torch.tools.parallel_run JOBS.json --address localhost:PORT \\
        --world N --rank R [--backend gloo|nccl] [--device cuda:0]

The backend is NCCL unless named (one card per rank); several ranks on
one card need gloo. JOBS.json is a list of jobs, run in order by every
rank:

    {"runner": "dp" | "sp" | "dp_sp",
     "mesh": [sizes], "axes": [names],    # make_mesh(sizes, names)
     "frames": "x.npy",                   # (B, T, H, W) for dp and dp_sp, (T, H, W) for sp
     "cfg": {...},                        # VOConfig's fields (dataclasses.asdict)
     "seed": 0, "frame_chunk": null, "pair_chunk": null,   # the last two for dp
     "reps": 0,                           # timed calls after the counted one (the card)
     "launches": n,                       # optional: B1 and B2 launches of the counted call
     "out": "prefix"}

Each job builds its mesh, reads the frames memory-mapped (a rank uploads
only its part), and runs the runner once with the kernels' launch
counters reset just before; where "launches" is given, B1 and B2 must
each have launched that often. Then it times `reps` more calls by CUDA
events (on the card only). It writes
<out>.rank<R>.npz: R and t (the poses the rank returns), diag_<name> for
each diagnostic, rows (the global rows they belong to), launches (B1,
B2), the counted call's transfers (op, axis, nbytes), ms (each timed
call) and build_s (seconds the kernel library took to build in this
process: 0 when it was loaded as built).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from tpu_vo_torch.interop import config_from_fields
from tpu_vo_torch.ops import _build
from tpu_vo_torch.ops.patch import extract_patches
from tpu_vo_torch.ops.select import select_maps
from tpu_vo_torch.parallel import sharding
from tpu_vo_torch.parallel.distributed import initialize
from tpu_vo_torch.parallel.mesh import make_mesh
from tpu_vo_torch.pipeline.runner import entry_device
from tpu_vo_torch.utils.profiling import cuda_times


def _call(job: dict, frames, cfg, mesh, device):
    """The job's runner as a function of nothing."""
    seed = job.get("seed", 0)
    if job["runner"] == "dp":
        return lambda: sharding.run_batch_of_sequences(
            frames, cfg, seed, job.get("frame_chunk"), job.get("pair_chunk"), device, mesh)
    if job["runner"] == "sp":
        return lambda: sharding.run_sequence_time_sharded(frames, cfg, mesh, seed,
                                                          device=device)
    if job["runner"] == "dp_sp":
        return lambda: sharding.run_batch_time_sharded(frames, cfg, mesh, seed, device=device)
    raise ValueError(f"unknown runner {job['runner']!r}")


def run_job(job: dict, rank: int, device=None) -> dict:
    """Run one job on this rank (see the module's docstring); returns what
    it writes."""
    dev = entry_device(device)
    mesh = make_mesh(tuple(job["mesh"]), tuple(job["axes"]), device_type=dev.type)
    frames = np.load(job["frames"], mmap_mode="r")
    call = _call(job, frames, config_from_fields(job["cfg"]), mesh, dev)
    select_maps.launches = extract_patches.launches = 0
    del sharding.transfers[:]
    poses, diags = call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = (select_maps.launches, extract_patches.launches)
    moved = list(sharding.transfers)
    want = job.get("launches")
    if want is not None and launches != (want, want):
        raise AssertionError(f"rank {rank}, {job['runner']}: B1 and B2 launched {launches} "
                             f"times, not {want} each")
    reps = job.get("reps", 0)
    ms = cuda_times(call, warmup=0, reps=reps) if reps else []
    if job["runner"] == "sp":
        rows = [0]
    else:
        n = poses.R.shape[0]
        rows = list(range(mesh.get_local_rank("data") * n, (mesh.get_local_rank("data") + 1) * n))
    out = {"R": poses.R.cpu().numpy(), "t": poses.t.cpu().numpy(),
           **{f"diag_{k}": v.cpu().numpy() for k, v in diags.items()},
           "rows": np.asarray(rows), "launches": np.asarray(launches),
           "transfers_op": np.asarray([m.op for m in moved], dtype=str),
           "transfers_axis": np.asarray([m.axis for m in moved], dtype=str),
           "transfers_nbytes": np.asarray([m.nbytes for m in moved], dtype=np.int64),
           "ms": np.asarray(ms), "build_s": np.asarray(_build.BuildInfo.seconds)}
    np.savez(f"{job['out']}.rank{rank}.npz", **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("jobs", help="JSON list of jobs")
    ap.add_argument("--address", help="host:port of rank 0's store (default: env://)")
    ap.add_argument("--world", type=int, help="number of ranks (with --address)")
    ap.add_argument("--rank", type=int, help="this process's rank (with --address)")
    ap.add_argument("--backend", help="nccl (default) or gloo")
    ap.add_argument("--device", help="the device of this rank (default: the card)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds to wait for the other ranks and for each collective")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    with open(args.jobs) as f:
        jobs = json.load(f)
    initialize(args.address, args.world, args.rank, args.backend, args.timeout)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    try:
        for job in jobs:
            run_job(job, dist.get_rank(), dev)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
