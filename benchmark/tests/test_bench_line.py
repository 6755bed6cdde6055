import json

import pytest

from benchmark import run
from benchmark.tests.conftest import WORKLOADS, tiny_cell


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(workload, trace):
    cell = tiny_cell(workload)
    res = run.run_cell(cell, 2**31 + 3, 0.3, trace, "cpu")
    line = json.loads(json.dumps(run.result_line(res, "cpu", 1, trace)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True, (line["checks"], res["notes"])
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU no device metric is read
        assert not {"device_idle_pct.enc", "device_idle_pct.dec",
                    "dwt_fwd_roofline", "dwt_inv_roofline"} & set(
                        line["metrics"])
        assert set(line["metrics"]) <= {m["name"] for m in cell["per_layer"]}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_benchmark_json_names_files_for_every_entry():
    from pathlib import Path
    root = Path(run.ROOT)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for aside in (root / "benchmark" / "aside").glob("*.json"):
        extra = json.loads(aside.read_text())
        for k in ("workloads", "end_to_end", "per_layer"):
            bench[k] = bench[k] + extra[k]
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert (root / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        mix = root / "benchmark" / "traffic" / f"{w['traffic']}.json"
        assert mix.exists()
        mix = json.loads(mix.read_text())
        assert (root / "benchmark" / "operations"
                / f"{mix['operation']}.py").exists()
        assert (root / "benchmark" / "traffic" / "scenes"
                / f"{mix['scene']}.py").exists()
    for c in bench["configs"]:
        assert (root / c["file"]).exists()
