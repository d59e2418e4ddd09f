import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """One process among the test workers: few intra-op threads."""
    torch.set_num_threads(2)
