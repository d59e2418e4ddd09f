"""The benchmark's cv2-parity cell (kitti_orb1200_parity,
VOConfig.reference_parity) and the seq128 cell in bench.py's chunks, on
the CPU and cut down.

The parity cell builds VOConfig.reference_parity in the program's and the
reference's configs; its program call reads 0 on every number of
vobench.check against the plain reference, its features bit for bit,
while stage 1's keep-ties cut admits candidates beyond 2n and RANSAC never
runs the finalists' cheirality gate (the default cell, beside it, admits
none and runs the gate). A chunked call runs a stage-1 pass a chunk of
frames and a stage-2 pass a chunk of pairs; it equals the unchunked call,
which is the reference's bit for bit, in every feature, match, inlier
flag and count, and in its motions to float32's rounding; it runs one
LO refit over all its pairs. On the card (skipped without one) a 64-frame
call in bench.py's chunks is the unchunked call bit for bit."""

import functools
import importlib

import pytest
import torch

import tpu_vo_torch.configs as prog_configs
from tpu_vo_torch.estimation import ransac
from tpu_vo_torch.features import orb
from tpu_vo_torch.pipeline import runner, step
from vobench import check, harness
from vobench.reference import configs as ref_configs
from _torch_threads import _one_thread  # noqa: F401

SEED = 2 ** 31 + 11
PARITY = "kitti_orb1200_parity.seq128"
SEQ = "kitti_orb1200.seq128"
# tpu_vo's bench.py chunks: 64 frames, 8 a stage-1 pass and 9 pairs a
# stage-2 pass (no cell runs them: their frames/s spread too widely)
BENCH = dict(call_shape=[64], pool=1, kwargs={"frame_chunk": 8, "pair_chunk": 9})
# 320x240, where every pyramid level holds ties at its 2n-th FAST score;
# the default cell cut the same way beside the parity cell
CUT = dict(image_width=320, image_height=240, n_features=300, n_levels=4, max_iters=64,
           call_shape=[4])
# The seq128 cell cut to 16 frames and 15 pairs in bench.py's chunks:
# runner._spans needs chunks that divide both, so pair_chunk 9 becomes 3
# (5 stage-2 passes) and frame_chunk stays 8 (2 stage-1 passes)
CHUNKED = dict(image_width=160, image_height=120, n_features=100, n_levels=3, max_iters=16,
               call_shape=[16], kwargs={"frame_chunk": 8, "pair_chunk": 3})
# float32 rounding of one pair's motion, in degrees and over the path
# length: a few ulps of R (~1e-6 deg) and of t, with two orders of room;
# the cell's limits are 0.01 deg, 0.5 deg and 0.001
ROUNDING_DEG, ROUNDING_TRAJ = 1e-4, 1e-6


@functools.lru_cache(maxsize=None)
def _cell(workload, chunked=False):
    """(cell, frames) of `workload` cut by CUT, or by CHUNKED."""
    cell = harness.load_cell(workload, CHUNKED if chunked else CUT)
    return cell, harness.make_pool(cell, SEED, torch.device("cpu"))[0]


def _program(cell, frames, **kwargs):
    """(features, stage-2 outputs, poses, diagnostics) of one call through
    the cell's entry, its stages tapped as a run taps them."""
    tap = harness.Tap(importlib.import_module(cell.traffic["entry"]["module"]),
                      cell.traffic["stages"], False)
    try:
        entry = getattr(tap.module, cell.traffic["entry"]["function"])
        poses, diags = entry(frames, harness.vo_config(cell.config, prog_configs), 77,
                             device="cpu", **kwargs)
        return tap.out["stage1"], tap.out["stage2"], poses, diags
    finally:
        tap.close()


def _reference(cell, frames):
    return harness.reference(frames, harness.vo_config(cell.config, ref_configs), 77,
                             cell.traffic["ref_block"], harness.reference_run(cell.config),
                             tf32=False)


def _leaves(x):
    """The tensors of nested dicts, tuples and NamedTuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    return [t for v in x for t in _leaves(v)]


def _reads_0(prog, ref):
    numbers = check.compare(prog[:3], ref)
    assert all(v == 0 for v in numbers.values()), numbers
    for p, r in zip(prog[0], ref[0]):
        assert torch.equal(p, r)
    assert torch.equal(prog[2].t.reshape(ref[2].t.shape), ref[2].t)


@pytest.mark.parametrize("module", [prog_configs, ref_configs], ids=["program", "reference"])
def test_the_parity_configuration_is_reference_parity(module):
    cell = harness.load_cell(PARITY)
    assert harness.vo_config(cell.config, module) == module.VOConfig.reference_parity()
    assert cell.config["reduced"] == [] and cell.config["reference"] == harness.DEFAULT_REFERENCE


@pytest.mark.parametrize("workload,parity", [(PARITY, True), (SEQ, False)])
def test_the_parity_cell_reads_0_keeps_ties_and_skips_the_gate(monkeypatch, workload, parity):
    beyond, gate = [], []
    cut, frac = orb._harris_cut, ransac._finalist_cheirality_frac

    def counting_cut(v2, ys2, xs2, resp, n_level, k2, cfg, area):
        n2 = min(2 * n_level, area)
        kept = (v2 > 0) & (v2 >= v2[:, min(n2, k2) - 1:min(n2, k2)])
        beyond.append(int((kept.sum(1) - n2).clamp(min=0).sum()))
        return cut(v2, ys2, xs2, resp, n_level, k2, cfg, area)

    monkeypatch.setattr(orb, "_harris_cut", counting_cut)
    monkeypatch.setattr(ransac, "_finalist_cheirality_frac",
                        lambda *a: gate.append(1) or frac(*a))
    cell, frames = _cell(workload)
    prog = _program(cell, frames)
    _reads_0(prog, _reference(cell, frames))
    assert int(prog[0].valid.sum()) > 0.5 * prog[0].valid.numel()
    if parity:
        assert max(beyond) > 0 and not gate
    else:
        assert max(beyond) == 0 and gate


def test_a_chunked_call_runs_its_passes_and_keeps_to_the_reference(monkeypatch):
    cell, frames = _cell(SEQ, chunked=True)
    kwargs = cell.traffic["kwargs"]
    assert kwargs == {"frame_chunk": 8, "pair_chunk": 3}
    passes = {"stage1": 0, "search": 0, "refit": []}
    detect, search, refit = runner.detect_and_compute, runner.search_pair, step.lo_refit

    def counted(stage, fn):
        def run(*a, **k):
            passes[stage] += 1
            return fn(*a, **k)
        return run

    def refit_rows(winner, *a):
        passes["refit"].append(winner.E.shape[0])
        return refit(winner, *a)

    monkeypatch.setattr(runner, "detect_and_compute", counted("stage1", detect))
    monkeypatch.setattr(runner, "search_pair", counted("search", search))
    monkeypatch.setattr(step, "lo_refit", refit_rows)
    chunked = _program(cell, frames, **kwargs)
    assert passes == {"stage1": 2, "search": 5, "refit": [15]}
    monkeypatch.undo()
    whole = _program(cell, frames)
    ref = _reference(cell, frames)
    _reads_0(whole, ref)
    # Every feature, match, inlier flag, count and flag bit for bit; the
    # motions to float32's rounding: on the CPU the 5-point solver's
    # vectorized loops round the last pair of a batch otherwise than the
    # same pair inside a larger batch, so its candidates, and the E, R, t
    # and F that follow, can move by a few ulps (~4e-7 in an entry of R)
    # with the chunk it is solved in. On the card the solver does not,
    # and a chunked call equals the unchunked call bit for bit (below).
    assert chunked[1].keys() == whole[1].keys() and chunked[3].keys() == whole[3].keys()
    pairs = list(zip(_leaves(chunked), _leaves(whole)))
    assert len(pairs) == len(_leaves(whole)) > 20
    assert all(torch.equal(a, b) for a, b in pairs if not a.is_floating_point())
    for a, b in zip(chunked[0], whole[0]):
        assert torch.equal(a, b)
    for numbers in (check.compare(chunked[:3], whole[:3]), check.compare(chunked[:3], ref)):
        assert all(numbers[k] == 0 for k in check.NAMES if k.endswith("_diff")), numbers
        assert max(numbers["rot_gap_deg"], numbers["dir_gap_deg"]) < ROUNDING_DEG, numbers
        assert numbers["traj_gap"] < ROUNDING_TRAJ, numbers
        assert check.judge(numbers, cell.limits)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's kernels at its own size")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_a_chunked_call_is_the_unchunked_call_bit_for_bit(cuda):
    """A 64-frame call of the seq128 cell in bench.py's chunks: 8 stage-1
    and 7 stage-2 passes of 9 pairs give the unchunked call's every
    output bit for bit. The LO refit's batched A^T A rounds otherwise at
    9 pairs than at 63 on the card, so it runs once over all pairs
    (finish_pair)."""
    cell = harness.load_cell(SEQ, BENCH)
    frames = harness.make_pool(cell, 3, cuda)[0]
    cfg = harness.vo_config(cell.config, prog_configs)
    seed = harness.call_seed(3, 0)
    out = [runner.run_sequence_batched(frames, cfg, seed, **kw)
           for kw in (cell.traffic["kwargs"], {})]
    pairs = list(zip(_leaves(out[0]), _leaves(out[1])))
    assert len(pairs) == len(_leaves(out[1])) == 9
    assert all(torch.equal(a, b) for a, b in pairs)
