"""VO over several ranks of a torch.distributed world (port of
tpu_vo/parallel/sharding.py), and batches of sequences on one card.

  - DP (`run_batch_of_sequences`, "data" axis): independent sequences
    split over ranks. Each rank runs the batched pipeline on its own
    rows and issues no collective. Without a mesh it is the one-card
    batch: the B sequences are flattened before the stages, so
    `frame_chunk` and `pair_chunk` are the sizes of each launch whatever
    B is; pairs are formed within each sequence (never across two),
    sequence b drawing from pair_generators(seed + b, range(1, T)), and
    each sequence's result equals run_sequence_batched(frames[b], cfg,
    seed + b).
  - SP (`run_sequence_time_sharded`, "seq" axis): one sequence split
    along time. Each rank computes the features of its frames, sends its
    last frame's features to the next rank on the axis (one packed
    buffer per boundary, the only transfer at feature scale; the first
    rank takes the all-invalid empty features, so its first pair is the
    dummy that is dropped), estimates its pairs, each drawing from its
    global generator, and all-gathers the per-pair estimates (about 100
    B a pair). Every rank chains all T-1 pairs as run_sequence_batched
    does and returns the whole trajectory.
  - DP x SP (`run_batch_time_sharded`): rows split on the data axis,
    time on the seq axis; one halo per local sequence, all of a rank's
    packed into one send per boundary; nothing moves along the data
    axis. Returns the data rank's rows with their whole T.

Each runner takes the global host array (numpy, or a CPU tensor), and a
rank uploads only its own part to its device. With gloo the transfers
stage through host memory; with NCCL they send the device tensors. The
transport follows the group's backend, and nothing falls back to
another. Every collective a runner issues is appended to `transfers`
(op, mesh axis, bytes), the port's record of the communication contract
that the JAX package checks on its compiled HLO.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_vo_torch.configs import VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.pipeline.runner import (
    STREAM_FRAME_CHUNK,
    _check_chunks,
    _empty_features,
    _spans,
    _stream_chunk,
    _streamed_pairs,
    chain_relative_poses,
    detect_frames,
    diagnostics,
    entry_device,
    estimate_pairs,
)
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.utils.profiling import CALL_SPAN, span

# The per-pair estimates that the seq axis gathers: the pose chain's
# inputs and the diagnostics (106 B a pair)
GATHERED = ("R", "t", "have_rt", "pose_ok", "n_keypoints", "n_good", "n_inliers",
            "n_valid_points", "mean_residual", "F")


class Transfer(NamedTuple):
    """One collective as a rank issued it."""

    op: str      # "send", "recv" or "all_gather"
    axis: str    # the mesh axis it runs along
    nbytes: int  # the buffer this rank sends, receives, or adds to the gather


# Every collective the runners issued in this process, in order; the
# tests clear and read it
transfers: List[Transfer] = []


def _axis(mesh, name: str):
    """(process group, this rank's index, size) of mesh axis `name`."""
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no {name!r}")
    return mesh.get_group(name), mesh.get_local_rank(name), mesh.size(
        mesh.mesh_dim_names.index(name))


def _block(total: int, rank: int, n: int, what: str, axis: str) -> range:
    """This rank's indices of `total` split in n equal blocks."""
    if total % n:
        raise ValueError(f"{what} = {total} does not divide over the {n} ranks of axis {axis!r}")
    size = total // n
    return range(rank * size, (rank + 1) * size)


def _upload(frames, rows: range, times: range, device: torch.device) -> torch.Tensor:
    """frames[rows, times] of the global host array, on `device`."""
    with span("vo.upload"):
        part = frames[rows.start:rows.stop, times.start:times.stop]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.array(part))  # a copy: the array may be a read-only memmap
        return part.to(device)


def _wire(group) -> Optional[torch.device]:
    """Where a buffer must lie to cross `group`: host memory for gloo,
    the tensors' own device (None) for NCCL."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        return None
    raise ValueError(f"no transport for the {backend!r} backend")


def _pack(tensors) -> torch.Tensor:
    """(L, bytes) uint8: each row the bytes of row i of every tensor."""
    return torch.cat([t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)
                      for t in tensors], 1)


def _unpack(buf: torch.Tensor, like) -> list:
    """The tensors of `like` (dtypes, trailing shapes) from (L, bytes)
    rows of _pack."""
    out, a = [], 0
    for t in like:
        n = t[0].numel() * t.element_size()
        part = buf[:, a:a + n].clone(memory_format=torch.contiguous_format)  # offset 0
        out.append(part.view(t.dtype).reshape(-1, *t.shape[1:]))
        a += n
    return out


def _halo(last: ORBFeatures, empty: ORBFeatures, group, rank: int, n: int,
          axis: str) -> ORBFeatures:
    """Rank r's `last` features (R, ...) to rank r + 1 of the axis, in one
    buffer; returns those of rank r - 1, or `empty` on rank 0."""
    if n == 1:
        return empty
    send = _pack(last)
    wire = _wire(group)
    if wire is not None:
        send = send.to(wire)
    recv = torch.empty_like(send)
    ops = []
    if rank + 1 < n:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, rank + 1), group))
        transfers.append(Transfer("send", axis, send.numel()))
    if rank > 0:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, rank - 1), group))
        transfers.append(Transfer("recv", axis, recv.numel()))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if rank == 0:
        return empty
    return ORBFeatures(*_unpack(recv.to(last.xy.device), last))


def _gather(fields: list, R: int, group, n: int, axis: str) -> list:
    """all_gather over the axis of per-pair tensors (R*t, ...), row-major
    in (row, pair); returns them as (R, n*t, ...) in the axis's order."""
    part = _pack(fields)
    dev = part.device
    wire = _wire(group)
    if wire is not None:
        part = part.to(wire)
    parts = [torch.empty_like(part) for _ in range(n)]
    dist.all_gather(parts, part, group=group)
    transfers.append(Transfer("all_gather", axis, part.numel()))
    rows = torch.stack(parts).to(dev)               # (n, R*t, bytes)
    rows = rows.reshape(n, R, -1, rows.shape[-1]).transpose(0, 1).reshape(-1, rows.shape[-1])
    return [f.reshape(R, -1, *f.shape[1:]) for f in _unpack(rows, fields)]


def _chain_rows(est: dict, cfg: VOConfig):
    """Each row's pose chain from (R, P) estimates: (Pose (R, P+1), diagnostics (R, P))."""
    with span("vo.stage3"):
        poses = [chain_relative_poses(est["R"][b], est["t"][b], est["have_rt"][b],
                                      est["pose_ok"][b], cfg) for b in range(est["R"].shape[0])]
        return (Pose(torch.stack([p.R for p in poses]), torch.stack([p.t for p in poses])),
                diagnostics(est))


def run_batch_of_sequences(frames, cfg: VOConfig, seed: int = 0,
                           frame_chunk: Optional[int] = None,
                           pair_chunk: Optional[int] = None, device=None,
                           mesh=None, data_axis: str = "data"):
    """VO over a (B, T, H, W) uint8 batch of sequences (numpy, or a
    tensor) on `device` (the card when None).

    Without a mesh, all B rows run here. With one, data rank r takes rows
    [r*B/n, (r+1)*B/n) (B must divide by the axis's n ranks), uploads only
    those, and issues no collective; row b still draws from seed + b. A
    chunk must divide the rank's rows' frames (pairs) unless it is at
    least that long. Every check raises ValueError before stage 1.
    Returns (poses: Pose with leading dims (rows, T), diagnostics dict of
    (rows, T-1) tensors) of this rank's rows."""
    _check_chunks(frame_chunk, pair_chunk)
    B, T = frames.shape[:2]
    rows = range(B) if mesh is None else _block(B, *_axis(mesh, data_axis)[1:], "B", data_axis)
    R = len(rows)
    _spans(R * T, frame_chunk)
    _spans(R * (T - 1), pair_chunk)
    with span(CALL_SPAN):
        local = _upload(frames, rows, range(T), entry_device(device))
        feats = detect_frames(local.reshape(R * T, *local.shape[2:]), cfg, frame_chunk)
        feats = [f.reshape(R, T, *f.shape[1:]) for f in feats]
        prev = ORBFeatures(*(f[:, :-1].reshape(R * (T - 1), *f.shape[2:]) for f in feats))
        cur = ORBFeatures(*(f[:, 1:].reshape(R * (T - 1), *f.shape[2:]) for f in feats))
        with span("vo.seeds"):
            gens = [g for b in rows for g in pair_generators(seed + b, range(1, T))]
        est = estimate_pairs(prev, cur, cfg, gens, pair_chunk)
        return _chain_rows({k: est[k].reshape(R, T - 1, *est[k].shape[1:]) for k in GATHERED},
                           cfg)


def _time_sharded(frames, rows: range, seed: int, cfg: VOConfig, mesh, axis: str, device):
    """Rows `rows` of (B, T, H, W) frames with T split on mesh axis `axis`:
    (poses (R, T), diagnostics (R, T-1)) on every rank of the axis."""
    group, r, n = _axis(mesh, axis)
    times = _block(frames.shape[1], r, n, "T", axis)
    dev = entry_device(device)
    with span(CALL_SPAN):
        local = _upload(frames, rows, times, dev)
        R, t = local.shape[:2]
        feats = detect_frames(local.reshape(R * t, *local.shape[2:]), cfg,
                              _stream_chunk(R * t, STREAM_FRAME_CHUNK))
        feats = ORBFeatures(*(f.reshape(R, t, *f.shape[1:]) for f in feats))
        empty = ORBFeatures(*(f.expand(R, *f.shape[1:]) for f in _empty_features(cfg, dev)))
        carry = _halo(ORBFeatures(*(f[:, -1] for f in feats)), empty, group, r, n, axis)
        est = _streamed_pairs(carry, feats, cfg, [seed + b for b in rows], times.start)
        fields = [est[k] for k in GATHERED]
        if n > 1:
            fields = _gather(fields, R, group, n, axis)
        else:
            fields = [f.reshape(R, t, *f.shape[1:]) for f in fields]
        # drop each row's first pair: frame 0 against the empty features
        return _chain_rows({k: f[:, 1:] for k, f in zip(GATHERED, fields)}, cfg)


def run_sequence_time_sharded(frames, cfg: VOConfig, mesh, seed: int = 0, axis: str = "seq",
                              device=None):
    """One (T, H, W) uint8 sequence (numpy, or a tensor) with its frames
    split over mesh axis `axis` (T must divide by its n ranks), on
    `device` (the card when None). Seq rank r uploads and runs frames
    [r*T/n, (r+1)*T/n); pair i draws from pair_generators(seed, [i]) as
    in run_sequence_batched. Ranks of other axes run the same. Returns
    (poses: Pose with leading dim T, diagnostics dict of (T-1,)
    tensors), the whole sequence's, on every rank."""
    poses, diags = _time_sharded(frames[None], range(1), seed, cfg, mesh, axis, device)
    return Pose(poses.R[0], poses.t[0]), {k: v[0] for k, v in diags.items()}


def run_batch_time_sharded(frames, cfg: VOConfig, mesh, seed: int = 0,
                           data_axis: str = "data", seq_axis: str = "seq", device=None):
    """VO over a (B, T, H, W) uint8 batch (numpy, or a tensor) with the
    rows split on `data_axis` and the frames on `seq_axis` (each must
    divide by its axis's ranks), on `device` (the card when None). Row b
    draws from seed + b, pair i of it from pair_generators(seed + b, [i]).
    Returns (poses: Pose with leading dims (rows, T), diagnostics dict of
    (rows, T-1) tensors) of this data rank's rows, on every rank of its
    seq axis."""
    rows = _block(frames.shape[0], *_axis(mesh, data_axis)[1:], "B", data_axis)
    return _time_sharded(frames, rows, seed, cfg, mesh, seq_axis, device)
