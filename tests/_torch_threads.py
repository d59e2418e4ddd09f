"""The port's CPU tests run torch on one intra-op thread.

A test file takes the policy with one line,

    from _torch_threads import _one_thread  # noqa: F401

which pytest's default import mode resolves, since it puts `tests/` on
sys.path (also under `--noconftest`). The file is not named test_*, so
pytest does not collect it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while the importing file runs: the suite runs
    in six xdist workers that share the host's cores, and a worker's torch
    would otherwise start a thread per core, so that the pools of
    concurrent files turn each parallel op into a wait (tenfold and more
    in the slowest files). Checks compare within one thread setting or
    within tolerances; the previous count is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
