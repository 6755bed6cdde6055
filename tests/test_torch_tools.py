"""The port's tools (go_jpeg2000_tpu_torch/tools) on the CPU at tiny sizes:
each tool's main runs with --device cpu and its stage rows plus the
unattributed remainder equal its wall; the default device "cuda" raises
here; the tools import no jax; the stage clock counts a nested stage once
and refuses a wrap its caller bypasses; and the codestreams of
profile_stages' ht53 and ebcot paths equal the JAX package's encode_batch
(the slice as a whole against the reference), multihost_scaling's equal
encode's."""
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

from go_jpeg2000_tpu.models.encoder import encode_batch as jax_encode_batch
from go_jpeg2000_tpu.options import Format, Options

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu_torch.tools import (_clock, bench_config4_scale,
                                         benchmark_compare,
                                         multihost_scaling,
                                         profile_kernel_stages,
                                         profile_stages)

TOOLS = ("profile_stages", "profile_kernel_stages", "bench_config4_scale",
         "multihost_scaling", "benchmark_compare")


def _toy_module():
    """outer() calls inner() twice; each sleeps."""
    mod = types.ModuleType("toy")

    def inner():
        time.sleep(0.01)

    def outer():
        time.sleep(0.01)
        mod.inner()
        mod.inner()

    def never():
        pass

    mod.inner, mod.outer, mod.never = inner, outer, never
    return mod


def _sums_to_wall(rep):
    rows = sum(s["host_ms"] for s in rep["stages"].values())
    assert rows + rep["unattributed_ms"] == pytest.approx(rep["wall_ms"],
                                                          rel=1e-9)
    assert rep["unattributed_ms"] >= 0


def test_clock_counts_a_nested_stage_once():
    mod = _toy_module()
    stages = [_clock.Stage(mod, "outer", "outer"),
              _clock.Stage(mod, "inner", "inner")]
    with _clock.StageClock(stages) as clock:
        mod.outer()
        mod.inner()
    rep = clock.report()
    assert rep["stages"]["outer"]["calls"] == 1
    assert rep["stages"]["inner"]["calls"] == 3
    # outer holds its own sleep only; inner its three
    assert 8 <= rep["stages"]["outer"]["host_ms"] < 25
    assert rep["stages"]["inner"]["host_ms"] >= 29
    _sums_to_wall(rep)
    assert clock.attributed_s * 1e3 == pytest.approx(
        sum(s["host_ms"] for s in rep["stages"].values()))
    # the wraps are gone
    assert mod.outer.__name__ == "outer"
    assert rep["idle_lower"] is None and rep["stages"]["inner"][
        "device_ms"] is None


def test_clock_refuses_a_stage_never_called():
    mod = _toy_module()
    bypass = mod.inner           # a caller that took the function before
    with pytest.raises(RuntimeError, match="never called"):
        with _clock.StageClock([_clock.Stage(mod, "inner", "inner"),
                                _clock.Stage(mod, "never", "never")]):
            mod.inner()
    with pytest.raises(RuntimeError, match="inner"):
        with _clock.StageClock([_clock.Stage(mod, "inner", "inner")]):
            bypass()
    with _clock.StageClock([_clock.Stage(mod, "never", "never")],
                           strict=False) as clock:
        pass
    assert clock.seconds == {}


def test_clock_outer_only_stage_and_class_methods():
    # Tensor.to at top level is timed, inside another stage it is not
    mod = _toy_module()
    x = torch.zeros(4)

    def copy_in_stage():
        x.to(torch.float64)
    mod.copy = copy_in_stage
    with _clock.StageClock([_clock.Stage(mod, "copy", "stage"),
                            _clock.COPIES[0]]) as clock:
        x.to(torch.int32)
        mod.copy()
    assert clock.report()["stages"]["other copies (Tensor.to)"]["calls"] == 1
    assert "to" not in vars(torch.Tensor)


@pytest.mark.parametrize("tool", TOOLS)
def test_default_device_raises_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = sys.modules[f"go_jpeg2000_tpu_torch.tools.{tool}"]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_tools_import_no_jax():
    code = ("import sys\n"
            + "".join(f"import go_jpeg2000_tpu_torch.tools.{t}\n"
                      for t in TOOLS + ("_clock",))
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'go_jpeg2000_tpu', 'bench')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=root)
    assert out.stdout.strip() == "[]"


def _json_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


@pytest.mark.parametrize("path,argv", [
    ("ht53", ["--frames", "2", "--size", "32"]),
    ("ht97", ["--frames", "1", "--size", "32"]),
    ("ebcot", ["--frames", "1", "--size", "16"]),
    ("single", ["--size", "64"]),
    ("config2", ["--size", "64"]),
    ("config4", ["--size", "32", "--tile", "16"])])
def test_profile_stages_rows_sum_to_wall(path, argv, capsys):
    assert profile_stages.main(["--path", path, "--reps", "1", "--device",
                                "cpu"] + argv) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert lines and all(l["path"] == path for l in lines)
    for line in lines:
        for what in ("encode", "decode"):
            if line[what] is not None:
                _sums_to_wall(line[what])
    if path == "config4":
        # the breakdown leaves the remainder small: every stage is named
        rep = lines[0]["encode"]
        assert rep["stages"]["tile batch on the host"]["calls"] == 1
        assert rep["stages"]["HT kernels"]["calls"] >= 1


def test_profile_stages_threads_give_the_same_bytes():
    res = profile_stages.run(["--path", "single", "--size", "64", "--reps",
                              "1", "--threads", "1,2", "--device", "cpu"])
    assert [r["threads"] for r in res] == [1, 2]
    assert res[0]["data"] == res[1]["data"]


def test_profile_stages_encodes_equal_jax():
    # the slice as a whole: the tool's cases through the port give the
    # JAX package's codestreams, HT lossless and Part-1 paths A, B, C
    args = profile_stages.parse(["--frames", "2", "--size", "64"])
    frames = [_clock.natural_image(64, 64, seed=i) for i in range(2)]
    for path, ht in (("ht53", True), ("ebcot", False)):
        ref = jax_encode_batch(frames, Options(
            format=Format.J2K, lossless=True, num_resolutions=6,
            high_throughput=ht))
        for case in profile_stages.cases(path, args, "cpu"):
            assert case.encode() == ref, case.label


def test_profile_kernel_stages_rows_and_glue(capsys):
    assert profile_kernel_stages.main(["32", "2", "1", "--reps", "1",
                                       "--device", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [l["what"] for l in lines] == ["encode", "decode"]
    for line in lines:
        _sums_to_wall(line)
        assert line["stages"]["program"]["calls"] == 2
    assert lines[0]["stages"]["DWT levels"]["calls"] == 10
    assert lines[1]["stages"]["MagSgn"]["calls"] == 2


def test_bench_config4_scale_round_trips():
    rows = bench_config4_scale.run(["64", "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["tile"] == 16
    sec = rows[0]["seconds"]
    assert all(sec[k] > 0 for k in bench_config4_scale.LEGS)
    assert sec["lossy97 psnr"] > 25


def test_multihost_scaling_gives_encodes_bytes():
    rows = multihost_scaling.run(["--size", "128", "--hosts", "1,2",
                                  "--device", "cpu"])
    assert [r["hosts"] for r in rows] == [1, 2]
    img, opts, _label = multihost_scaling.image_and_options(
        multihost_scaling.parse(["--size", "128"]))
    ref = tp.encode(img, opts, device="cpu")
    for r in rows:
        assert r["data"] == ref
        assert r["native_threads"] == r["hosts"] * os.cpu_count()
    assert rows[0]["efficiency"] == 1.0


def test_benchmark_compare_round_trips(capsys):
    rows = benchmark_compare.run(["--sizes", "64", "--iters", "1",
                                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert rows[0]["size"] == 64 and rows[0]["part1 bytes"] > 0
    if benchmark_compare.openjpeg() is None:
        assert "OpenJPEG: not run" in out
    else:
        assert "OpenJPEG decodes the port's stream exactly" in out
