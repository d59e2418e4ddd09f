"""Joining a torch.distributed world (port of tpu_vo/parallel/distributed.py).

Every process of a world calls initialize(); the meshes built afterwards
(mesh.make_mesh, global_mesh) span all of its ranks, and the runners of
parallel/sharding take them. A rank is one process on one device.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from tpu_vo_torch.parallel.mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: Union[None, float, datetime.timedelta] = None) -> None:
    """Join the world: dist.init_process_group over
    tcp://`coordinator_address` ("host:port", rank `process_id` of
    `num_processes`) when an address is given, else over env:// (the
    variables torchrun sets: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).

    The backend is "nccl" unless the caller names another; without a card
    it raises rather than choose one. "gloo" is taken only when named
    (several ranks that share one card, or the CPU). With NCCL the
    process's card is cuda:LOCAL_RANK (0 when unset). `timeout` (seconds
    or a timedelta) bounds the wait for the other ranks and each
    collective.

    A no-op when this process has already joined a world; every other
    failure raises: a coordinator that cannot be reached must not turn
    into a world of one."""
    if dist.is_initialized():
        return
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the nccl backend: name another "
                               "(backend='gloo') to run without a card")
        backend = "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                             else datetime.timedelta(seconds=timeout))
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=-1 if num_processes is None else num_processes,
                                rank=-1 if process_id is None else process_id, **kwargs)


def global_mesh(axis_names: Sequence[str] = ("data", "seq"), axis_sizes=None,
                device_type: Optional[str] = None):
    """make_mesh over every rank of the world."""
    return make_mesh(axis_sizes, axis_names, device_type)


def is_multi_host() -> bool:
    """Whether this process is one of several ranks (JAX's
    process_count() > 1)."""
    return dist.is_initialized() and dist.get_world_size() > 1
