"""The port's parallel runners (tpu_vo_torch/parallel) on the CPU, over
one torch.distributed world of 4 gloo ranks in child processes.

The world runs tools/parallel_run's jobs on a (4, 1), a (1, 4) and two
(2, 2) meshes: DP over 4 sequences, SP over 4 ranks and (on the (2, 2)
mesh's seq axis) over 2, and DP x SP; then the same runners with a stub
stage 2 (search_pair, with finish_pair passing its result through) that
echoes each pair's generator. Held here:

  - DP rows, SP's whole sequence (which holds a blank frame, so that
    some pairs are not pose_ok and a halo carries no valid feature) and
    DP x SP rows bit for bit equal to the one-process runners
    (run_batch_of_sequences without a mesh, run_sequence_batched);
  - the record of what moved (sharding.transfers): DP nothing; SP and DP
    x SP one send of one frame's features per seq boundary and local
    sequence, gathers of at most 256 B a pair, nothing along "data",
    nothing of H*W bytes or more for each frame a transfer carries;
  - each pair's generator: row b of the batch draws from seed + b, pair
    j of seq rank r is global pair r*t + j;
  - make_mesh, initialize and is_multi_host, and the ValueError of an
    indivisible B or T before stage 1;
  - against JAX once: tpu_vo's run_batch_time_sharded on a (2, 2) mesh of
    virtual CPU devices over the same frames, at the bar of
    tests/test_torch_pipeline.py.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_vo.configs import ORBConfig as JORBConfig, VOConfig as JVOConfig
from tpu_vo.parallel.mesh import make_mesh as jax_make_mesh
from tpu_vo.parallel.sharding import run_batch_time_sharded as jax_run_batch_time_sharded
from tpu_vo.utils.cv_reference import absolute_trajectory_error, relative_pose_error
from tpu_vo_torch.configs import ORBConfig, VOConfig
from tpu_vo_torch.parallel import distributed, mesh as mesh_mod, sharding
from tpu_vo_torch.parallel.sharding import (run_batch_of_sequences, run_batch_time_sharded,
                                            run_sequence_time_sharded)
from tpu_vo_torch.pipeline.runner import _empty_features, run_sequence_batched
from tpu_vo_torch.pipeline.step import pair_generators
from tpu_vo_torch.utils.synthetic import make_sequence
from _torch_threads import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, T, B, SEED, KPS, LEVELS = 160, 120, 8, 4, 7, 150, 3
WORLD = 4
BLANK = 3  # the SP sequence's blank frame: the last of seq rank 1 of 4, sent as its halo
CFG = VOConfig(image_width=W, image_height=H, orb=ORBConfig(n_features=KPS, n_levels=LEVELS))
AXES = ["data", "seq"]
# job name: (runner, mesh, frames); each runs once in the world, and with
# the echoing stub as "echo_<name>"
JOBS = {"dp": ("dp", [4, 1], "batch"), "sp4": ("sp", [1, 4], "seq"),
        "sp2": ("sp", [2, 2], "seq"), "dp_sp": ("dp_sp", [2, 2], "batch")}
ECHOED = ("dp", "sp4", "dp_sp")
# One rank of the world: the checks of initialize and make_mesh, the jobs,
# then the jobs again with search_pair echoing each pair's first draw
# through its epipolar residual
_CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
from tpu_vo_torch.parallel import distributed, mesh
from tpu_vo_torch.pipeline import runner
from tpu_vo_torch.tools import parallel_run

rank, port = int(sys.argv[1]), int(sys.argv[2])
with open(sys.argv[3]) as f:
    spec = json.load(f)
address = f"localhost:{port}"
distributed.initialize(address, spec["world"], rank, backend="gloo", timeout=60)
checks = {"initialized": torch.distributed.is_initialized()}
distributed.initialize(address, spec["world"], rank, backend="gloo", timeout=60)
checks["second_initialize_noop"] = torch.distributed.get_world_size() == spec["world"]
checks["is_multi_host"] = distributed.is_multi_host()
m = mesh.make_mesh(device_type="cpu")
checks["default_mesh"] = [list(m.shape), list(m.mesh_dim_names)]
m = distributed.global_mesh(axis_names=("data",), device_type="cpu")
checks["one_name_mesh"] = [list(m.shape), list(m.mesh_dim_names)]
try:
    mesh.make_mesh((3, 1), device_type="cpu")
    checks["wrong_size"] = "built"
except ValueError as e:
    checks["wrong_size"] = str(e)
if not torch.cuda.is_available():
    try:
        mesh.make_mesh((spec["world"], 1))
        checks["no_card"] = "built"
    except RuntimeError as e:
        checks["no_card"] = str(e)
for job in spec["jobs"]:
    parallel_run.run_job(job, rank, "cpu")


def echo(prev, cur, cfg, generators=None, idx=None):
    n = prev.xy.shape[0]
    zeros = torch.zeros(n, dtype=torch.int32)
    return dict(R=torch.eye(3).expand(n, 3, 3).contiguous(), t=torch.zeros(n, 3),
                have_rt=torch.ones(n, dtype=torch.bool), pose_ok=torch.ones(n, dtype=torch.bool),
                n_keypoints=zeros, n_good=zeros, n_inliers=zeros, n_valid_points=zeros,
                F=torch.zeros(n, 3, 3),
                mean_residual=torch.stack([torch.rand((), generator=g) for g in generators]))


runner.search_pair = echo
runner.finish_pair = lambda est, cfg: est
for job in spec["echo_jobs"]:
    parallel_run.run_job(job, rank, "cpu")
with open(f"{spec['dir']}/checks.rank{rank}.json", "w") as f:
    json.dump(checks, f)
torch.distributed.destroy_process_group()
"""


@functools.lru_cache(maxsize=None)
def _scenes():
    """B make_sequence scenes (frames, Rs, ts, K)."""
    return [make_sequence(n_frames=T, width=W, height=H, seed=b) for b in range(B)]


def _batch() -> np.ndarray:
    return np.stack([np.stack(s[0]) for s in _scenes()])


def _sequence() -> np.ndarray:
    seq = _batch()[0].copy()
    seq[BLANK] = 128
    return seq


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _load(d, name):
    return [dict(np.load(os.path.join(d, f"{name}.rank{r}.npz"))) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world; returns ({job: [rank's npz]}, [rank's checks])."""
    d = str(tmp_path_factory.mktemp("parallel"))
    np.save(os.path.join(d, "batch.npy"), _batch())
    np.save(os.path.join(d, "seq.npy"), _sequence())
    cfg = dataclasses.asdict(CFG)

    def job(name, runner, mesh, frames):
        return dict(runner=runner, mesh=mesh, axes=AXES, frames=os.path.join(d, f"{frames}.npy"),
                    cfg=cfg, seed=SEED, out=os.path.join(d, name))

    spec = {"world": WORLD, "dir": d,
            "jobs": [job(name, *v) for name, v in JOBS.items()],
            "echo_jobs": [job(f"echo_{name}", *JOBS[name]) for name in ECHOED]}
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r), str(port),
                               os.path.join(d, "spec.json")], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        # the one-process references and tpu_vo's run while the ranks work
        _one_card(), _whole_sequence(), _tpu_vo_dp_sp()
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = {name: _load(d, name) for name in
               list(JOBS) + [f"echo_{name}" for name in ECHOED]}
    checks = []
    for r in range(WORLD):
        with open(os.path.join(d, f"checks.rank{r}.json")) as f:
            checks.append(json.load(f))
    return results, checks


@functools.lru_cache(maxsize=None)
def _one_card():
    """run_batch_of_sequences without a mesh over the batch."""
    return run_batch_of_sequences(_batch(), CFG, seed=SEED, device="cpu")


@functools.lru_cache(maxsize=None)
def _whole_sequence():
    return run_sequence_batched(torch.from_numpy(_sequence()), CFG, seed=SEED, device="cpu")


@functools.lru_cache(maxsize=None)
def _tpu_vo_dp_sp():
    """tpu_vo's run_batch_time_sharded over the batch on a (2, 2) mesh of 4
    virtual CPU devices, in float32: (R, t, num_keypoints) as numpy."""
    with jax.enable_x64(False):
        jmesh = jax_make_mesh((2, 2), ("data", "seq"), devices=jax.devices()[:4])
        jcfg = JVOConfig(image_width=W, image_height=H,
                         orb=JORBConfig(n_features=KPS, n_levels=LEVELS))
        poses, diags = jax_run_batch_time_sharded(jnp.asarray(_batch()), jcfg, jmesh, seed=SEED)
        return (np.asarray(poses.R, np.float64), np.asarray(poses.t, np.float64),
                np.asarray(diags["num_keypoints"]))


def _assert_rows_equal(out, poses, diags, rows):
    assert np.array_equal(out["R"], poses.R[rows].numpy())
    assert np.array_equal(out["t"], poses.t[rows].numpy())
    for k, v in diags.items():
        assert np.array_equal(out[f"diag_{k}"], v[rows].numpy()), k


def _frame_bytes() -> int:
    """One frame's ORBFeatures in bytes (89 a slot)."""
    return sum(f[0].numel() * f.element_size() for f in _empty_features(CFG, torch.device("cpu")))


def test_dp_rows_equal_one_card_runner(world):
    results, _ = world
    poses, diags = _one_card()
    rows = []
    for out in results["dp"]:
        assert out["R"].shape == (B // WORLD, T, 3, 3)
        _assert_rows_equal(out, poses, diags, out["rows"])
        rows += out["rows"].tolist()
    assert rows == list(range(B))
    # and so each row to its own sequence's run (tests/test_torch_sharding.py)
    p, d = run_sequence_batched(torch.from_numpy(_batch()[B - 1]), CFG, seed=SEED + B - 1,
                                device="cpu")
    assert torch.equal(poses.t[B - 1], p.t) and torch.equal(diags["pose_ok"][B - 1], d["pose_ok"])


@pytest.mark.parametrize("name", ["sp4", "sp2"])
def test_sp_equals_whole_sequence(world, name):
    results, _ = world
    poses, diags = _whole_sequence()
    assert not bool(diags["pose_ok"].all())
    assert int(diags["num_keypoints"][BLANK - 1]) == 0  # pair BLANK's current frame
    for out in results[name]:
        assert out["t"].shape == (T, 3)
        assert np.array_equal(out["R"], poses.R.numpy())
        assert np.array_equal(out["t"], poses.t.numpy())
        for k, v in diags.items():
            assert np.array_equal(out[f"diag_{k}"], v.numpy()), k


def test_dp_sp_equals_each_sequence(world):
    results, _ = world
    poses, diags = _one_card()
    rows = set()
    for out in results["dp_sp"]:
        assert out["R"].shape == (B // 2, T, 3, 3)
        _assert_rows_equal(out, poses, diags, out["rows"])
        rows |= set(out["rows"].tolist())
    assert rows == set(range(B))
    assert bool(diags["pose_ok"].any()) and not bool(diags["pose_ok"].all())


def _moved(outs):
    """[(rank, op, axis, nbytes)] of every rank's record."""
    return [(r, str(op), str(ax), int(n)) for r, out in enumerate(outs)
            for op, ax, n in zip(out["transfers_op"], out["transfers_axis"],
                                 out["transfers_nbytes"])]


@pytest.mark.parametrize("name, n_seq, local_rows", [("sp4", 4, 1), ("sp2", 2, 1),
                                                     ("dp_sp", 2, B // 2)])
def test_time_sharded_moves_one_halo_and_small_gathers(world, name, n_seq, local_rows):
    results, _ = world
    moved = _moved(results[name])
    groups = WORLD // n_seq  # seq lines of the mesh
    t = T // n_seq
    assert all(ax == "seq" for _, _, ax, _ in moved)
    sends = [(r, n) for r, op, _, n in moved if op == "send"]
    recvs = [(r, n) for r, op, _, n in moved if op == "recv"]
    gathers = [(r, n) for r, op, _, n in moved if op == "all_gather"]
    assert len(sends) == len(recvs) == groups * (n_seq - 1)
    assert all(n == local_rows * _frame_bytes() for _, n in sends + recvs)
    assert sorted(r for r, _ in gathers) == list(range(WORLD))
    assert all(n <= 256 * local_rows * t for _, n in gathers)
    # no image-scale transfer: each send is below H*W bytes for each frame
    # it carries (one per local sequence), each gather below it whole
    assert all(n < H * W * (local_rows if op != "all_gather" else 1) for _, op, _, n in moved)
    # the last rank of each seq line sends nothing, the first receives nothing
    assert {r % n_seq for r, _ in sends} == set(range(n_seq - 1))
    assert {r % n_seq for r, _ in recvs} == set(range(1, n_seq))


def test_dp_moves_nothing(world):
    results, _ = world
    assert _moved(results["dp"]) == []
    assert _moved(results["echo_dp"]) == []


def _draw(seed, i) -> float:
    return float(torch.rand((), generator=pair_generators(seed, [i])[0]))


@pytest.mark.parametrize("name", ECHOED)
def test_pairs_draw_from_their_global_generators(world, name):
    results, _ = world
    for out in results[f"echo_{name}"]:
        echoed = out["diag_epipolar_residual"]
        rows = out["rows"] if name != "sp4" else [0]
        echoed = echoed.reshape(len(rows), T - 1)
        want = np.asarray([[_draw(SEED + b, i) for i in range(1, T)] for b in rows], np.float32)
        assert np.array_equal(echoed, want)


def test_initialize_is_a_no_op_once_joined_and_multi_host(world):
    _, checks = world
    for c in checks:
        assert c["initialized"] and c["second_initialize_noop"] and c["is_multi_host"]


def test_make_mesh_shapes_and_checks(world):
    _, checks = world
    for c in checks:
        assert c["default_mesh"] == [[WORLD, 1], ["data", "seq"]]
        assert c["one_name_mesh"] == [[WORLD], ["data"]]
        assert "(3, 1) != 4 ranks" in c["wrong_size"]
        if "no_card" in c:
            assert "no CUDA device" in c["no_card"]


def test_initialize_raises_on_an_unreachable_coordinator():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        distributed.initialize(f"localhost:{_free_port()}", 2, 1, backend="gloo", timeout=1)
    assert not dist.is_initialized() and not distributed.is_multi_host()


def test_initialize_without_a_card_names_no_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("localhost:1", 1, 0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_mesh(device_type="cpu")


class _Mesh:
    """Enough of a DeviceMesh for the runners' checks: names, sizes and
    this rank's index on each axis."""

    def __init__(self, sizes, ranks):
        self.mesh_dim_names, self._sizes, self._ranks = tuple(AXES), sizes, ranks

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self._ranks[AXES.index(name)]

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize("runner, frames, sizes", [
    ("dp", (3, T), (2, 1)), ("dp", (B, T), (3, 1)), ("dp_sp", (3, T), (2, 2)),
    ("dp_sp", (B, 6), (2, 4)), ("sp", (1, 6), (1, 4))])
def test_indivisible_shapes_raise_before_stage1(runner, frames, sizes, monkeypatch):
    def stage1(*args, **kwargs):
        raise AssertionError("stage 1 ran before the shapes were checked")

    monkeypatch.setattr(sharding, "detect_frames", stage1)
    mesh = _Mesh(sizes, (sizes[0] - 1, sizes[1] - 1))
    x = np.zeros(frames + (H, W), np.uint8)
    call = {"dp": lambda: run_batch_of_sequences(x, CFG, device="cpu", mesh=mesh),
            "dp_sp": lambda: run_batch_time_sharded(x, CFG, mesh, device="cpu"),
            "sp": lambda: run_sequence_time_sharded(x[0], CFG, mesh, device="cpu")}[runner]
    with pytest.raises(ValueError, match="does not divide"):
        call()


def test_dp_sp_tracks_like_tpu_vo(world):
    """The port's DP x SP rows against tpu_vo's run_batch_time_sharded on a
    (2, 2) mesh of 4 virtual CPU devices, same frames and seed: pose_ok on
    >= 70% of pairs, each row's aligned ATE against tpu_vo's trajectory
    under 0.3 of its extent, rotation error against ground truth at most
    tpu_vo's + 1 deg, keypoint counts within 2%."""
    results, _ = world
    jR, jt, jkps = _tpu_vo_dp_sp()
    rows = {}
    for out in results["dp_sp"]:
        for i, b in enumerate(out["rows"]):
            rows[int(b)] = (out["R"][i].astype(np.float64), out["t"][i].astype(np.float64),
                            out["diag_pose_ok"][i], out["diag_num_keypoints"][i])
    assert np.mean([rows[b][2] for b in range(B)]) >= 0.7
    for b in range(B):
        Rt, tt, _, kps = rows[b]
        assert np.isfinite(Rt).all() and np.isfinite(tt).all()
        extent = max(np.linalg.norm(jt[b, -1]), 1e-9)
        assert absolute_trajectory_error(tt, jt[b]) / extent < 0.3, b
        Rs_gt = _scenes()[b][1]
        assert relative_pose_error(Rt, Rs_gt) <= relative_pose_error(jR[b], Rs_gt) + 1.0, b
        np.testing.assert_allclose(kps, jkps[b], rtol=0.02)
