"""The benchmark's own tests: on the CPU at small shapes, and, marked
`cuda`, on the card.  Run from the repo root:

    python -m pytest benchmark/tests -q
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_card():
    """Skips the test where there is no CUDA card; decided here, when the
    test runs, never when the module is imported."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def tiny_cell(workload, rows=96, columns=80, frames=4, batches=2):
    """The cell of BENCHMARK.json at a shape a CPU test can hold."""
    from benchmark import run
    cell = run.load_cell(workload)
    cell["config"] = dict(cell["config"], rows=rows, columns=columns)
    cell["mix"] = dict(cell["mix"], frames_per_call=frames,
                       pool_batches=batches)
    return cell


# the cells of BENCHMARK.json, and one set aside (benchmark/aside/)
WORKLOADS = ("ct512-ht-enc", "ct512-ht-dec", "wsi512-ht-enc")
