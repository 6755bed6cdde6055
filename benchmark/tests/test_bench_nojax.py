import subprocess
import sys

from benchmark import run

CODE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.run as r
from benchmark.tests.conftest import tiny_cell
res = r.run_cell(tiny_cell("ct512-ht-enc"), 1, 0.2, False, "cpu")
print(res["correct"], r.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CODE.format(root=str(run.ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(run.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_top_level_names_compare_whole(monkeypatch):
    fake = object()
    monkeypatch.setitem(sys.modules, "go_jpeg2000_tpu_torch_extra", fake)
    monkeypatch.setitem(sys.modules, "jaxtyping", fake)
    assert run.forbidden_modules() == [] or all(
        m.split(".")[0] in run.FORBIDDEN for m in run.forbidden_modules())
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "go_jpeg2000_tpu.ops", fake)
    monkeypatch.setitem(sys.modules, "jaxlib", fake)
    assert set(run.forbidden_modules()) - before == {"go_jpeg2000_tpu.ops",
                                                     "jaxlib"}


def test_no_card_no_result(capsys):
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: test_bench_chip runs the cells")
    assert run.main(["--workload", "ct512-ht-enc", "--seed", "1",
                     "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_no_program_no_result(tmp_path):
    import shutil
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "ct512-ht-enc", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
    assert "not in" in out.stderr
