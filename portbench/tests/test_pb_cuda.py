"""On a card: one tiny run of each cell through the CUDA kernels, correct
under the cell's limits."""
import pytest
import torch

from portbench.tests.tiny import WORKLOADS, run_tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_card(card, workload):
    line, nums = run_tiny(workload, seed=2**31 + 1, device=card)
    assert line["failed"] == 0 and nums["keys"] == 0
    assert line["correct"], line["checks"]
