"""One stage clock for the tools, and what they share.

A `Stage` names a function by where it lives (a module, a class, or a
module path under the package such as "models.encoder") and its name,
and gives it a label.  While a `StageClock` is installed, each stage's
function is replaced by a wrapper that records, per label:

- calls, and host milliseconds by `time.perf_counter`, exclusive: a
  stage called inside another counts once, in the inner stage, and is
  taken out of the outer one, so the rows and the remainder sum to the
  wall;
- for a device stage, the device milliseconds between a CUDA event pair
  recorded on the current stream around each call.  The events are read
  after the one synchronize that ends the run, so the clock adds no
  synchronization to the path;
- bytes, where the stage copies between host and device (`nbytes`).

The clock reports the wall (the host clock from installing the wraps to
the end of that synchronize), the unattributed remainder (wall less the
top-level stages) and the device idle share's lower bound: 1 - the sum of
the outermost device stages' event spans over the wall.  Those spans hold
the gaps inside a program, where the card waits for the host, so they
over-count busy time and the share they give is a lower bound.
`idle_bracket` measures one run both ways: the events' lower bound, and
the upper bound from the kernel and copy events torch.profiler kept,
which under-count busy time where it loses events.

The port imports modules as module attributes (`transforms.upload`), so a
wrap on the module's attribute reaches every caller, and a caller in the
same module too, which looks the name up in the module's globals.  A stage
that a run never calls is an error (with strict=True), because a wrap that
its caller bypasses (a `from x import f` taken before the wrap) must not
look like zero time.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

PACKAGE = "go_jpeg2000_tpu_torch"


@dataclasses.dataclass(frozen=True)
class Stage:
    # a module or class, or a path under PACKAGE: "models.encoder", or
    # "codestream.parser:Parser" for a class of that module
    where: object
    name: str
    label: str
    device: bool = False    # timed on the card too, between CUDA events
    # (args, kwargs, result) -> bytes the call copies between host and card
    nbytes: Optional[Callable] = None
    # timed only where no other stage is running (Tensor.to, Tensor.cpu:
    # the copies a caller makes in its own body)
    outer_only: bool = False


def owner(where):
    """The object that holds a stage's function."""
    if isinstance(where, str):
        path, _, attr = where.partition(":")
        mod = importlib.import_module(f"{PACKAGE}.{path}")
        return getattr(mod, attr) if attr else mod
    return where


def arg_bytes(*positions):
    """nbytes of the arrays or tensors at these argument positions."""
    return lambda a, kw, out: sum(_size(a[i]) for i in positions)


def out_bytes(a, kw, out) -> int:
    """nbytes of a stage's result (an array, a tensor, or a tuple)."""
    if isinstance(out, (tuple, list)):
        return sum(_size(x) for x in out)
    return _size(out)


def moved_bytes(a, kw, out) -> int:
    """Tensor.to: the bytes of the result where it changed device."""
    if isinstance(out, torch.Tensor) and out.device != a[0].device:
        return _size(out)
    return 0


def _size(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    return 0


# the copies a caller makes in its own body, outside every named stage
COPIES = (Stage(torch.Tensor, "to", "other copies (Tensor.to)", device=True,
                nbytes=moved_bytes, outer_only=True),
          Stage(torch.Tensor, "cpu", "download (Tensor.cpu)", device=True,
                nbytes=out_bytes, outer_only=True))

# every function of the port that runs device work or waits for it: the
# device programs with their uploads, the fetches and downloads; all
# device stages, for the idle share's lower bound and the host/device
# split of a run (with strict=False: a run calls some of them)
DEVICE_STAGES = tuple(
    Stage(mod, name, f"{mod}.{name}", device=True) for mod, name in (
        ("models.transforms", "run_forward"),
        ("models.transforms", "dispatch_forward_batch"),
        ("models.transforms", "fetch_forward_batch"),
        ("models.transforms", "upload"),
        ("models.fused_encode", "fused_encode_chunk"),
        ("models.fused_encode", "encode_pyramid"),
        ("models.fused_encode", "fetch_pool"),
        ("models.ebcot_fused", "ebcot_encode_chunk"),
        ("models.ebcot_fused", "ebcot_decisions_chunk"),
        ("models.ebcot_fused", "fetch"),
        ("parallel.sharded", "tile_transform_step"),
        ("parallel.sharded", "gather_tiles"),
        ("parallel.sharded", "empty_leaves"),
        ("parallel.sharded", "place_tiles"),
        ("parallel.sharded", "tile_inverse_step"),
        ("models.decoder", "upload_parsed"),
        ("ops.ht_dec", "fused_decode"),
        ("ops.ht_dec_cuda", "blocks_to_pyramid"),
        ("models.transforms", "inverse_pyramid"),
        ("models.transforms", "dispatch_inverse_stacked"),
        ("models.decoder", "download"),
        ("models.transforms", "run_inverse"))) + COPIES


@dataclasses.dataclass
class Row:
    calls: int = 0
    host_s: float = 0.0
    spans: List = dataclasses.field(default_factory=list)
    bytes: int = 0
    device: bool = False


class StageClock:
    """Install wraps on `stages` for the body of a `with` block; `device`
    is the device the run's work goes to (events only on a CUDA one)."""

    def __init__(self, stages: Sequence[Stage], device="cpu",
                 strict: bool = True):
        self.stages = list(stages)
        self.cuda = torch.device(device).type == "cuda"
        self.strict = strict
        self.rows: Dict[str, Row] = {}
        for st in self.stages:
            row = self.rows.setdefault(st.label, Row())
            row.device = row.device or st.device
        self.calls = [0] * len(self.stages)
        self.stack: List[List[float]] = []
        self.device_depth = 0
        self.top_s = 0.0
        self.outer_spans: List = []
        self.saved = []
        self.wall_s = None

    def __enter__(self):
        for i, st in enumerate(self.stages):
            obj = owner(st.where)
            had = st.name in vars(obj)
            fn = getattr(obj, st.name)
            self.saved.append((obj, st.name, had, vars(obj).get(st.name)))
            setattr(obj, st.name, self._wrap(i, st, fn))
        self.t0 = time.perf_counter()
        return self

    def _wrap(self, i: int, st: Stage, fn):
        clock = self
        row = self.rows[st.label]

        def timed(*a, **kw):
            if st.outer_only and clock.stack:
                return fn(*a, **kw)
            frame = [0.0]
            events = None
            if st.device and clock.cuda:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            outer = clock.device_depth == 0
            if st.device:
                clock.device_depth += 1
            clock.stack.append(frame)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                clock.stack.pop()
                if st.device:
                    clock.device_depth -= 1
                if clock.stack:
                    clock.stack[-1][0] += dt
                else:
                    clock.top_s += dt
                clock.calls[i] += 1
                row.calls += 1
                row.host_s += dt - frame[0]
                if events is not None:
                    events[1].record()
                    row.spans.append(events)
                    if outer:
                        clock.outer_spans.append(events)
            if st.nbytes is not None:
                row.bytes += st.nbytes(a, kw, out)
            return out
        return timed

    def __exit__(self, exc_type, *exc):
        try:
            if self.cuda:
                torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self.t0
        finally:
            for obj, name, had, fn in reversed(self.saved):
                if had:
                    setattr(obj, name, fn)
                else:
                    delattr(obj, name)
            self.saved = []
        if exc_type is None and self.strict:
            missing = [f"{st.label} ({getattr(owner(st.where), '__name__', st.where)}"
                       f".{st.name})" for st, n in zip(self.stages, self.calls)
                       if n == 0]
            if missing:
                raise RuntimeError("stages never called, so their callers "
                                   "bypass the wraps: " + ", ".join(missing))
        return False

    @property
    def seconds(self) -> Dict[str, float]:
        """Each called label's host seconds, exclusive."""
        return {label: row.host_s for label, row in self.rows.items()
                if row.calls}

    @property
    def attributed_s(self) -> float:
        """Host seconds inside the stages (the top-level calls' sum)."""
        return self.top_s

    def report(self) -> Dict:
        """{"wall_ms", "stages": {label: {"calls", "host_ms", "device_ms",
        "bytes"}}, "unattributed_ms", "busy_ms", "idle_lower"}: device_ms
        and the idle share's lower bound are None off the card."""
        wall_ms = self.wall_s * 1e3
        stages = {}
        for label, row in self.rows.items():
            dev_ms = None
            if row.device and self.cuda:
                dev_ms = sum(s.elapsed_time(e) for s, e in row.spans)
            stages[label] = {"calls": row.calls, "host_ms": row.host_s * 1e3,
                             "device_ms": dev_ms, "bytes": row.bytes}
        busy = idle = None
        if self.cuda:
            busy = sum(s.elapsed_time(e) for s, e in self.outer_spans)
            idle = 1 - busy / wall_ms
        return {"wall_ms": wall_ms, "stages": stages,
                "unattributed_ms": wall_ms - self.top_s * 1e3,
                "busy_ms": busy, "idle_lower": idle}


def timed_run(fn, stages: Sequence[Stage], device, strict: bool = True):
    """fn() under a StageClock: (its result, the clock's report)."""
    with StageClock(stages, device, strict) as clock:
        out = fn()
    return out, clock.report()


def idle_bracket(fn, device) -> Optional[Dict]:
    """The device idle share of one run of fn() as a bracket, from two
    measures of the run's device busy time over its wall: fn() runs under
    torch.profiler and, inside it, a StageClock over DEVICE_STAGES.
    `lower` = 1 - the outermost device stages' CUDA-event spans / wall:
    the spans hold every kernel and copy of the run and the card's waits
    inside a program, so they over-count busy time.  `upper` = 1 - the
    device time of the kernel and copy events the profiler kept / wall:
    it may lose events (kernel_times.py --profiler-probe), so it
    under-counts busy time; `kept` and `calls` compare its device events
    with the launch and copy calls it saw.  The profiler's own host work
    is in the wall.  `upper` is None where the profiler kept no device
    event.  None off the card."""
    if torch.device(device).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with StageClock(DEVICE_STAGES, device, strict=False) as clock:
            fn()
    rep = clock.report()
    events = prof.events()
    kept = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = sum(1 for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                       "cudaMemcpy", "cudaMemset")))
    busy_ms = sum(e.time_range.elapsed_us() for e in kept) * 1e-3
    return {"lower": rep["idle_lower"], "spans_ms": rep["busy_ms"],
            "wall_ms": rep["wall_ms"], "profiler_ms": busy_ms,
            "upper": 1 - busy_ms / rep["wall_ms"] if kept else None,
            "kept": len(kept), "calls": calls}


def bracket_text(b: Dict) -> str:
    """One line's worth of an idle_bracket."""
    text = (f"at least {b['lower']:.3f} (device stages' CUDA-event spans "
            f"{b['spans_ms']:.2f} ms of {b['wall_ms']:.2f} ms wall under "
            f"torch.profiler)")
    if b["upper"] is None:
        return text + ", at most: not measured (the profiler kept no " \
            "device event)"
    return (text + f", at most {b['upper']:.3f} (the profiler's device "
            f"time {b['profiler_ms']:.2f} ms, {b['kept']} device events "
            f"kept of {b['calls']} launch and copy calls)")


@functools.lru_cache(maxsize=1)
def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, or "no
    nvidia-smi" where there is none (the CPU)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def tag() -> str:
    """What every result line ends with: the card and the host's cores."""
    return f"[{card_line()}; cpu_count {os.cpu_count()}]"


def resolve_device(device) -> torch.device:
    """The port's own check: "cuda" without a card raises RuntimeError."""
    from go_jpeg2000_tpu_torch.models import transforms
    return transforms.resolve_device(device)


def natural_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth 8-bit noise (bench.py's natural_image)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=(h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def rgb_image(h: int, w: int, seed: int) -> np.ndarray:
    """Three natural_image planes, seeds seed .. seed + 2."""
    return np.stack([natural_image(h, w, seed + c) for c in range(3)],
                    axis=-1)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def same(a, b) -> bool:
    """Equal results: bytes, arrays (dtype too), or lists and tuples of
    them."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def median_report(reports: List[Dict]) -> Dict:
    """The run of median wall (the lower middle of an even count), with
    the spread of every run's wall."""
    order = sorted(range(len(reports)), key=lambda i: reports[i]["wall_ms"])
    rep = dict(reports[order[(len(order) - 1) // 2]])
    rep["walls_ms"] = [reports[i]["wall_ms"] for i in order]
    return rep


def print_report(title: str, rep: Dict) -> None:
    """A report's lines: the wall with its spread, a row per stage and
    the remainder, each with tag()."""
    walls = rep.get("walls_ms", [rep["wall_ms"]])
    t = tag()
    print(f"{title}: wall {rep['wall_ms']:.2f} ms (median of {len(walls)}, "
          f"spread {walls[0]:.2f}-{walls[-1]:.2f} ms) {t}", flush=True)
    for label, s in rep["stages"].items():
        dev = ("" if s["device_ms"] is None
               else f", device {s['device_ms']:.3f} ms")
        moved = f", {s['bytes']} bytes" if s["bytes"] else ""
        print(f"  {label}: {s['calls']} calls, host {s['host_ms']:.2f} ms"
              f"{dev}{moved} {t}", flush=True)
    share = 100 * rep["unattributed_ms"] / rep["wall_ms"]
    print(f"  unattributed: {rep['unattributed_ms']:.2f} ms ({share:.1f}% of "
          f"wall) {t}", flush=True)
