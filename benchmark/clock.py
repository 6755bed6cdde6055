"""The benchmark's stage clock: spans around the port's functions.

A frozen copy of go_jpeg2000_tpu_torch/tools/_clock.py `StageClock`, kept
here so that a later change to the program's tools cannot move the
yardstick.  Two additions: each label also keeps its inclusive host time,
so a metric can subtract the stages it names from an entry point's wall
whatever other stages a later metric wraps; and with `profile=True` each
call is also a torch.profiler range named by its label, so the trace's
idle gaps can be put down to what the host was doing.

While a `StageClock` is installed, each stage's function is replaced by a
wrapper that records, per label:
- calls, and host seconds by `time.perf_counter`, both exclusive (a stage
  called inside another counts once, in the inner stage, and is taken out
  of the outer one) and inclusive;
- for a device stage, a CUDA event pair on the current stream around each
  call, read after the one synchronize that ends the clock; the spans of
  the outermost device stages give the idle share's lower bound,
  1 - their sum over the wall: they hold the gaps inside a program where
  the card waits for the host, so they over-count busy time.

The port calls its layers as module attributes (`fused_encode.t2_bodies`,
or a global of the same module), so a wrap on the attribute reaches every
caller.  A stage that a run never calls is an error, because a wrap that
its caller bypasses must not read as zero time.
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Dict, List, Sequence

import torch

PACKAGE = "go_jpeg2000_tpu_torch"


@dataclasses.dataclass(frozen=True)
class Stage:
    where: str          # a module path under PACKAGE, such as "models.encoder"
    name: str
    label: str
    device: bool = False    # timed on the card too, between CUDA events


@dataclasses.dataclass
class Row:
    calls: int = 0
    host_s: float = 0.0     # exclusive
    incl_s: float = 0.0     # inclusive
    spans: List = dataclasses.field(default_factory=list)
    device: bool = False


class StageClock:
    def __init__(self, stages: Sequence[Stage], cuda: bool,
                 profile: bool = False):
        self.stages = list(stages)
        self.cuda = cuda
        self.profile = profile
        self.rows: Dict[str, Row] = {}
        for st in self.stages:
            row = self.rows.setdefault(st.label, Row())
            row.device = row.device or st.device
        self.stack: List[List[float]] = []
        self.device_depth = 0
        self.outer_spans: List = []
        self.saved = []
        self.wall_s = None

    def __enter__(self):
        for st in self.stages:
            mod = importlib.import_module(f"{PACKAGE}.{st.where}")
            fn = getattr(mod, st.name)
            self.saved.append((mod, st.name, fn))
            setattr(mod, st.name, self._wrap(st, fn))
        self.t0 = time.perf_counter()
        return self

    def _wrap(self, st: Stage, fn):
        clock = self
        row = self.rows[st.label]

        def timed(*a, **kw):
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
            rf = (torch.profiler.record_function(st.label) if clock.profile
                  else None)
            t0 = time.perf_counter()
            try:
                if rf is None:
                    return fn(*a, **kw)
                with rf:
                    return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                clock.stack.pop()
                if st.device:
                    clock.device_depth -= 1
                if clock.stack:
                    clock.stack[-1][0] += dt
                row.calls += 1
                row.host_s += dt - frame[0]
                row.incl_s += dt
                if events is not None:
                    events[1].record()
                    row.spans.append(events)
                    if outer:
                        clock.outer_spans.append(events)
        return timed

    def __exit__(self, exc_type, *exc):
        try:
            if self.cuda:
                torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self.t0
        finally:
            for mod, name, fn in reversed(self.saved):
                setattr(mod, name, fn)
            self.saved = []
        if exc_type is None:
            missing = [f"{st.where}.{st.name}" for st in self.stages
                       if self.rows[st.label].calls == 0]
            if missing:
                raise RuntimeError("stages never called, so their callers "
                                   "bypass the wraps: " + ", ".join(missing))
        return False

    def report(self) -> Dict:
        """{label: {"calls", "host_ms", "incl_ms", "device_ms"}}, with
        "busy_ms" (the outermost device stages' event spans) and "wall_ms";
        device readings are None off the card."""
        stages = {}
        for label, row in self.rows.items():
            dev = None
            if row.device and self.cuda:
                dev = sum(s.elapsed_time(e) for s, e in row.spans)
            stages[label] = {"calls": row.calls, "host_ms": row.host_s * 1e3,
                             "incl_ms": row.incl_s * 1e3, "device_ms": dev}
        busy = (sum(s.elapsed_time(e) for s, e in self.outer_spans)
                if self.cuda else None)
        return {"stages": stages, "busy_ms": busy,
                "wall_ms": self.wall_s * 1e3}
