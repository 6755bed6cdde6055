"""On the card: a short run of each cell, as the command drives it."""
import pytest

from benchmark import run
from benchmark.tests.conftest import WORKLOADS


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_the_card(cuda_card, workload):
    res = run.run_cell(run.load_cell(workload), 2**31 + 21, 2.0, False,
                       cuda_card)
    assert res["correct"] is True, (res["checks"], res["notes"])
    assert res["memory_peak_bytes"] > 0
