"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell names a configuration
(benchmark/configs/), a traffic mix (benchmark/traffic/<name>.json) and the
cards it needs; the mix names the operation
(benchmark/operations/<name>.py) and the scene the generator makes frames
of (benchmark/traffic/scenes/<name>.py).  Set-up makes the pool of
frames from the seed, runs the operation's own set-up and warms up every
shape the window uses.  The window is a closed loop of one client: the
next call goes out when the previous returns, cycling through the pool,
until `--seconds` have passed; the rates are all the calls' pixels over
the window's wall.  Once the window has closed the run reads the peak
device memory, frees the program's state and judges a seeded sample of
the answers against the plain reference.  The last line of standard
output is one JSON object; the last lines of standard error are the
numbers compared, each beside its limit.

Every metric, end-to-end or per-layer, is read by its own file
benchmark/metrics/<metric name>.py.  `--trace 0` reports the cell's
end-to-end metrics, read from the window (`Window`); `--trace 1` runs the
same window under torch.profiler and the stage clock (benchmark/clock.py)
and reports the cell's per-layer metrics, read from the trace.

The run needs the cards: without CUDA, or with fewer cards than the cell
asks for, it exits 1 and prints no result.  It exits 3 and prints no
result if JAX or the JAX package was loaded.  The port's kernel builds
and every compile cache stay in go_jpeg2000_tpu_torch/_build/ inside the
checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "go_jpeg2000_tpu_torch" / "_build"
FORBIDDEN = ("jax", "jaxlib", "flax", "go_jpeg2000_tpu")


def _process_age() -> float:
    """Seconds from the process's start to T_START (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        now = time.perf_counter()
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK")
                   - (now - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def setup_seconds() -> float:
    return _AGE + time.perf_counter() - T_START


_AGE = _process_age()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (go_jpeg2000_tpu_torch is not go_jpeg2000_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_cell(workload: str, root: Path = ROOT) -> Dict:
    """The cell's workload entry, configuration, mix and metric entries:
    from BENCHMARK.json, or, for a cell set aside, with its own entries
    from benchmark/aside/<workload>.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    aside = root / "benchmark" / "aside" / f"{workload}.json"
    if workload not in {w["name"] for w in bench["workloads"]} and \
            aside.exists():
        extra = json.loads(aside.read_text())
        bench = dict(bench, **{k: bench[k] + extra.get(k, []) for k in
                               ("workloads", "end_to_end", "per_layer")})
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    centry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = json.loads((root / centry["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic"
                      / f"{wl['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"workload": wl, "config": cfg, "mix": mix, "end_to_end": e2e,
            "per_layer": layer}


@dataclasses.dataclass
class Window:
    """What the end-to-end metrics read: every call's wall (s), the
    window's wall (s), the set-up (s) and the pixels of every call."""
    walls: List[float]
    window_s: float
    setup_s: float
    pixels: int


def metric_module(name: str, root: Path = ROOT):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_problems(mix: Dict, before: Dict[str, int], after: Dict[str, int]
                  ) -> List[str]:
    """The mix's path counters over the window: each must read as the mix
    states, or the run took another path than its cell names."""
    out = []
    for name, (op, want) in mix["path_counters"].items():
        got = after.get(name, 0) - before.get(name, 0)
        ok = {"==": got == want, ">": got > want}[op]
        if not ok:
            out.append(f"{name} read {got} over the window, not {op} {want}")
    return out


def counter_readings() -> Dict[str, int]:
    from go_jpeg2000_tpu_torch.ops import dwt_cuda
    from go_jpeg2000_tpu_torch.utils.metrics import counters
    snap = counters.snapshot()
    snap["dwt_cuda.PLAIN_LEVELS"] = dwt_cuda.PLAIN_LEVELS
    return snap


def window(op, seconds: float, keep: int, rng: random.Random):
    """The closed loop: (per-call walls, kept (call, batch, answer), calls
    whose answer lacks frames, window seconds).  `keep` answers are kept
    by reservoir sampling over all calls, the rest dropped at once."""
    walls, kept = [], []
    short = n = 0
    n_batches = len(op.inputs)
    t0 = time.perf_counter()
    while True:
        b = n % n_batches
        ta = time.perf_counter()
        out = op.call(b)
        tb = time.perf_counter()
        walls.append(tb - ta)
        short += op.short(out)
        if len(kept) < keep:
            kept.append((n, b, out))
        else:
            j = rng.randrange(n + 1)
            if j < keep:
                kept[j] = (n, b, out)
        del out
        n += 1
        if tb - t0 >= seconds:
            return walls, kept, short, tb - t0


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool,
             device) -> Dict:
    """One run of the cell on `device` (a CUDA card in every run the
    command makes; the CPU in the benchmark's own tests): the result's
    fields, and "checks" {name: (reading, limit)} and "notes"."""
    import torch

    from . import operation
    from .traffic import generate

    cfg, mix = cell["config"], cell["mix"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rng = random.Random(seed)
    pool = generate.frames(mix, cfg, seed, dev)
    op = operation.load(mix["operation"])(cfg, mix, pool, dev)
    op.setup()
    for b in range(min(2, len(op.inputs))):
        op.call(b)
    if cuda:
        torch.cuda.synchronize()
    setup_s = setup_seconds()

    stages, metrics = {}, {}
    if trace:
        for m in cell["per_layer"]:
            metrics[m["name"]] = metric_module(m["name"])
            for st in getattr(metrics[m["name"]], "STAGES", ()):
                if stages.setdefault(st[:2], st) != st:
                    raise ValueError(f"two metrics wrap {st[:2]} unlike: "
                                     f"{stages[st[:2]]}, {st}")
    before = counter_readings()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from .clock import Stage, StageClock
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with StageClock([Stage(*s) for s in stages.values()], cuda,
                            profile=True) as clock:
                walls, kept, short, window_s = window(
                    op, seconds, mix["kept_calls"], rng)
    else:
        walls, kept, short, window_s = window(op, seconds, mix["kept_calls"],
                                              rng)
    after = counter_readings()
    problems = path_problems(mix, before, after)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    result = {"attempted": len(walls), "failed": short}
    if trace:
        from .tracing import Trace
        t = Trace(prof, clock.report(), walls, cell, cuda)
        values = {name: mod.read(t) for name, mod in metrics.items()}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell["per_layer"]
                             if values[m["name"]] is not None}
        result["busy_s"], result["breakdown"] = t.busy_s, t.breakdown()
        del prof, clock, t
    else:
        w = Window(walls, window_s, setup_s, len(walls) * op.pixels_per_call)
        result["metrics"] = {m["name"]: {
            "value": metric_module(m["name"]).read(w), "unit": m["unit"]}
            for m in cell["end_to_end"]}
    result["window_s"] = window_s
    result["memory_peak_bytes"] = peak
    result["spread_note"] = spread_note(walls, window_s)

    # the program's state goes before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = op.check(kept, rng)
    checks["calls_short_of_frames"] = (short, 0)
    checks["path_counters_off"] = (len(problems), 0)
    result["checks"] = checks
    result["notes"] = problems + op.notes + [
        f"the check took {time.perf_counter() - t_check:.1f} s"]
    result["correct"] = all(v <= lim for v, lim in checks.values())
    return result


def spread_note(walls: List[float], window_s: float) -> str:
    """The calls' walls (min, median, max, ms) and how many calls finished
    in each quarter of the window: where a run's rate moved during it."""
    ms = sorted(1e3 * w for w in walls)
    t, quarters = 0.0, [0, 0, 0, 0]
    for w in walls:
        t += w
        quarters[min(3, int(4 * t / window_s))] += 1
    return (f"{len(ms)} calls: min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} "
            f"max {ms[-1]:.1f} ms; calls a quarter of the window {quarters}")


class ForbiddenModules(RuntimeError):
    pass


def result_line(res: Dict, dev_kind: str, count: int, trace: bool) -> Dict:
    device = {"platform": "gpu", "kind": dev_kind, "count": count,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res["checks"].items()}
    return line


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    if not (ROOT / "go_jpeg2000_tpu_torch" / "__init__.py").exists():
        print(f"benchmark: the program (go_jpeg2000_tpu_torch) is not in "
              f"{ROOT}, so no result", file=sys.stderr)
        return 1
    # the program's caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
    cell = load_cell(args.workload)
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ", so no result", file=sys.stderr)
        return 1
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda:0")
        if forbidden_modules():
            raise ForbiddenModules(forbidden_modules())
    except ForbiddenModules as exc:
        print(f"benchmark: JAX or the JAX package was loaded: {exc}",
              file=sys.stderr)
        return 3
    for note in res["notes"] + [res["spread_note"]]:
        print(f"note: {note}", file=sys.stderr)
    line = result_line(res, torch.cuda.get_device_name(0), chips,
                       bool(args.trace))
    print(json.dumps(line), flush=True)
    for name, (value, limit) in res["checks"].items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
