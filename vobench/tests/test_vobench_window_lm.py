"""The refinement cell, vga_orb1000_lm.seq32, run whole by the harness on
the CPU at its own frame size and keypoints, cut to 3-frame calls: a
sound run is correct; a program that runs one LM iteration fewer fails
on the refine_* numbers; a Jacobian whose rotation block is 1% off moves
them, but within the limits; and the reference run imports nothing of
the program, of tpu_vo or of JAX."""

import ast
import os
import subprocess
import sys
import time

import pytest

from tpu_vo_torch.models import refinement
from tpu_vo_torch.pipeline import runner
from vobench import check, harness
from vobench.reference import window_lm

WORKLOAD = "vga_orb1000_lm.seq32"
SEED = 2 ** 31 + 11
CUT = dict(pool=1, check_calls=1, trace_calls=1, ref_block=3, call_shape=[3])


def _run(**settings):
    return harness.run_cell(WORKLOAD, SEED, 0.1, False, time.time(), device="cpu",
                            overrides=dict(CUT, **settings))


def _numbers(line):
    return {k: c["value"] for k, c in line["checks"].items() if k != "calls_checked"}


def _failing(line):
    return {k for k, c in line["checks"].items()
            if k != "calls_checked" and not c["value"] <= c["limit"]}


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_a_sound_run_is_correct(sound):
    assert sound["correct"] is True, sound["checks"]
    assert list(sound["checks"]) == list(check.NAMES + check.REFINE_NAMES) + ["calls_checked"]
    numbers = _numbers(sound)
    # stages 1 and 2 are the reference's bit for bit; the refinement is
    # another order of the same sums, so its gaps are rounding's
    assert all(numbers[k] == 0 for k in check.NAMES if k != "traj_gap")
    assert numbers["refine_flags_diff"] == 0 and 0 < numbers["refine_rot_gap_deg"] < 1e-4


def test_one_lm_iteration_fewer_fails_on_the_refine_numbers(monkeypatch):
    """At the cell's 6 iterations the LM has converged by the 5th on these
    pairs (the 6th takes no step), so a lost last iteration changes no
    output; at one iteration, losing it leaves every pair unrefined."""
    real = runner.refine_pairs
    monkeypatch.setattr(runner, "refine_pairs",
                        lambda prev, cur, est, cfg, iters: real(prev, cur, est, cfg, iters - 1))
    line = _run(refine_iters=1)
    assert line["correct"] is False
    failing = _failing(line)
    assert "refine_flags_diff" in failing and failing <= set(check.REFINE_NAMES) | {"traj_gap"}


def test_a_jacobian_one_percent_off_moves_the_refine_numbers_within_the_limits(sound,
                                                                              monkeypatch):
    """The LM takes a step only where the cost falls, so a Jacobian 1% off
    in its rotation block slows the descent but ends at the same minimum:
    the refined rotations move some 1e-5 degrees, tens of times the sound
    run's rounding and under the program's own spread on the card (up to
    7.1e-4 degrees). `correct` cannot see it; the Jacobian tests do
    (tests/test_torch_refinement.py, tests/test_torch_refine_pairs.py)."""
    real = refinement._residuals_and_jacobian

    def off(*args):
        r, J = real(*args)
        J = J.clone()
        J[..., :3] *= 1.01
        return r, J

    monkeypatch.setattr(refinement, "_residuals_and_jacobian", off)
    line = _run()
    moved, base = _numbers(line), _numbers(sound)
    assert moved["refine_rot_gap_deg"] > 10 * base["refine_rot_gap_deg"]
    assert line["correct"] is True


def test_the_reference_imports_nothing_of_the_program_or_jax():
    path = window_lm.__file__
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in harness.FORBIDDEN + ("tpu_vo_torch",), name
    code = ("import sys\nimport vobench.reference.window_lm\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & (set(harness.FORBIDDEN) | {"tpu_vo_torch"})
    assert harness.reference_run(harness.load_cell(WORKLOAD).config) is window_lm.run
