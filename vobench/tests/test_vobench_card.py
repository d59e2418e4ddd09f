"""On the card only: the control (the reference in TF32, the precision
below the configuration's float32) has to come out not correct, at a
size a test run holds. `python -m vobench.control` reads it at the
cells' own sizes."""

import pytest
import torch

from vobench import check, control, harness

SMALL = dict(call_shape=[6], pool=1, ref_block=6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti_orb1200.seq128", "uhd_orb8000.seq16"])
def test_the_control_is_not_correct_and_the_program_is(cuda, workload):
    got = control.readings(workload, [11, 12, 13], ("program", "control"), device=cuda,
                           overrides=SMALL)
    limits = harness.load_cell(workload).limits
    for mode, seed, numbers in got:
        assert check.judge(numbers, limits) == (mode == "program"), (mode, seed, numbers)
