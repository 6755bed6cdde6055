"""What a traced run hands the per-layer metrics' readers.

`Trace` holds the window's torch.profiler record, the stage clock's
report (benchmark/clock.py), every call's wall and the cell.  A reader
(benchmark/metrics/<name>.py) takes what it needs and returns a number,
or None where the run gave it nothing to read; the run then leaves that
metric out of its line.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch



def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    def __init__(self, prof, report: Dict, walls: List[float], cell: Dict,
                 cuda: bool):
        self.report = report
        self.walls = walls
        self.cell = cell
        self.cuda = cuda
        events = prof.events()
        labels = set(report["stages"])
        # the stage labels' ranges show on the device's timeline too, as
        # annotations: they are not operations
        self.device_events = [
            (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in labels
            and not getattr(e, "is_user_annotation", False)]
        self.label_events = [
            (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name in labels]
        self.busy = _merge([(a, b) for _n, a, b in self.device_events])

    @property
    def calls(self) -> int:
        return len(self.walls)

    def stage(self, label: str) -> Dict:
        return self.report["stages"][label]

    def incl_ms(self, label: str) -> float:
        return self.stage(label)["incl_ms"]

    @property
    def busy_s(self) -> Optional[float]:
        """Seconds in which some operation ran on the card."""
        if not self.cuda:
            return None
        return sum(b - a for a, b in self.busy)

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose name holds one of `names`."""
        return sum(b - a for n, a, b in self.device_events
                   if any(k in n for k in names))

    def shape(self) -> Dict:
        cfg = self.cell["config"]
        return {"frames": self.cell["mix"]["frames_per_call"],
                "rows": cfg["rows"], "columns": cfg["columns"],
                "components": cfg["samples_per_pixel"],
                "levels": cfg["codec"]["num_resolutions"] - 1}

    def breakdown(self) -> Dict:
        """The ten device operations that took most time, and the ten
        host stages in which the card sat idle longest: each idle stretch
        of the window goes, instant by instant, to the innermost stage the
        host was in ("harness" between calls)."""
        ops: Dict[str, float] = {}
        for n, a, b in self.device_events:
            ops[n[:120]] = ops.get(n[:120], 0.0) + (b - a)
        idle: Dict[str, float] = {}
        segs = innermost(self.label_events)
        if segs:
            for a, b, name in overlap(segs, idle_spans(self.busy, segs[0][0],
                                                       segs[-1][1])):
                idle[name] = idle.get(name, 0.0) + (b - a)
        top = lambda d: [[k, v] for k, v in  # noqa: E731
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def innermost(events: List[Tuple[str, float, float]]
              ) -> List[Tuple[float, float, str]]:
    """Nested (label, start, end) ranges of one thread -> consecutive
    (start, end, innermost label) segments, "harness" between ranges."""
    segs: List[Tuple[float, float, str]] = []
    stack: List[Tuple[str, float, float]] = []
    cursor = None

    def emit(a, b, name):
        if cursor is not None and b > a:
            segs.append((a, b, name))
    for ev in sorted(events, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= ev[1]:
            top = stack.pop()
            emit(cursor, top[2], top[0])
            cursor = top[2]
        emit(cursor, ev[1], stack[-1][0] if stack else "harness")
        stack.append(ev)
        cursor = ev[1]
    while stack:
        top = stack.pop()
        emit(cursor, top[2], top[0])
        cursor = top[2]
    return segs


def idle_spans(busy: List[Tuple[float, float]], lo: float, hi: float
               ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] outside the merged busy spans."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def overlap(segs, spans):
    """(start, end, label) of each segment's part inside the spans; both
    sorted and each free of overlaps."""
    out, i = [], 0
    for a, b in spans:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s, e, name = segs[j]
            lo, hi = max(a, s), min(b, e)
            if hi > lo:
                out.append((lo, hi, name))
            j += 1
    return out
