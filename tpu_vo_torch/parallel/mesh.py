"""Device meshes over the ranks of a torch.distributed world (port of
tpu_vo/parallel/mesh.py).

A "data" axis splits independent sequences over ranks (DP) and a "seq"
axis splits the frames of a sequence (the VO form of sequence
parallelism: features are per frame, and the pose chain needs only the
per-pair motions). One rank holds one position of the mesh.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpu_vo_torch.pipeline.runner import entry_device


def make_mesh(axis_sizes: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "seq"),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh over the whole world, ranks laid out row-major over
    `axis_sizes`, its dims named by `axis_names` (cut to the number of
    sizes). By default every rank is on "data": (world, 1), or (world,)
    for one name. The product of the sizes must be the world size.

    `device_type` is "cuda" unless the caller names another ("cpu"); with
    no card and none named it raises. The world must be initialized
    (distributed.initialize). Building a mesh is collective: it makes one
    process group per line of ranks along each axis, so every rank builds
    the same meshes in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call distributed.initialize first")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (n, 1) if len(axis_names) == 2 else (n,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if math.prod(axis_sizes) != n:
        raise ValueError(f"mesh {axis_sizes} != {n} ranks")
    if len(axis_names) < len(axis_sizes):
        raise ValueError(f"mesh {axis_sizes} needs {len(axis_sizes)} axis names, "
                         f"got {tuple(axis_names)}")
    device_type = entry_device(device_type).type
    return init_device_mesh(device_type, axis_sizes,
                            mesh_dim_names=tuple(axis_names)[:len(axis_sizes)])
