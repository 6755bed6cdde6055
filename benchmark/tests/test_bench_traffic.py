import numpy as np
import pytest

from benchmark.tests.conftest import WORKLOADS, tiny_cell
from benchmark.traffic import generate


@pytest.mark.parametrize("workload", WORKLOADS)
def test_one_seed_one_pool_and_seeds_differ(workload):
    cell = tiny_cell(workload)
    cfg, mix = cell["config"], cell["mix"]
    a = generate.frames(mix, cfg, 2**31 + 7, "cpu")
    b = generate.frames(mix, cfg, 2**31 + 7, "cpu")
    c = generate.frames(mix, cfg, 2**31 + 8, "cpu")
    n = mix["frames_per_call"] * mix["pool_batches"]
    shape = (n, cfg["rows"], cfg["columns"]) + (
        (3,) if cfg["samples_per_pixel"] == 3 else ())
    assert a.shape == shape and a.dtype == np.dtype(cfg["dtype"])
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_ct_phantom_holds_hu_values():
    cell = tiny_cell("ct512-ht-enc", rows=128, columns=128)
    a = generate.frames(cell["mix"], cell["config"], 3, "cpu")
    # padding outside the field of view, air, and tissue inside the body
    assert (a == -2000).any()
    assert ((a > -1100) & (a < -900)).mean() > 0.02
    assert ((a > -50) & (a < 150)).mean() > 0.2
    assert a.max() < 2048
