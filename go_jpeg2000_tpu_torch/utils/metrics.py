"""In-pipeline observability counters (SURVEY §5.5).

The reference has zero observability (no log statements, no counters —
SURVEY §5: "errors are returned, not logged"); the blueprint requires
pipeline counters surfaced to callers.  A single process-wide registry
keeps the hot paths branch-light: `counters.add` is one dict update under
a lock only when contended (CPython dict ops are atomic enough for
monotonic counters; the lock guards snapshot/reset consistency).

Usage:
    from go_jpeg2000_tpu_torch.utils.metrics import counters
    counters.add("dec.packets_parsed")
    counters.snapshot()  # {"dec.packets_parsed": 1, ...}

Counter namespace (maintained by encoder.py / decoder.py / rate.py and the
batch and sharded paths):
    enc.pixels_in        pixels submitted to encode
    enc.bytes_out        codestream bytes produced
    enc.blocks_coded     code-blocks entropy-coded
    enc.passes_coded     coding passes emitted
    enc.truncation_points  pass boundaries available to PCRD
    enc.budget_overshoot   budgets the PCRD could not meet
    enc.budget_overshoot_bytes  bytes past those budgets
    enc.fused_chunks     chunks through the fused device HT encode
    enc.ebcot_device_chunks  chunks through the device EBCOT encode (path A)
    enc.ebcot_hybrid_chunks  chunks through the device decisions and the
                         native MQ coder (path B)
    enc.host_entropy_frames  batch frames coded on the host (path C and
                         what the fused plans refuse)
    enc.sharded_device_ht_tiles  sharded tiles through the device HT encode
    enc.sharded_host_entropy_tiles  sharded tiles coded on the host
    dec.bytes_in         codestream bytes consumed
    dec.pixels_out       pixels reconstructed
    dec.packets_parsed   packet headers parsed
    dec.packets_skipped  packets skipped whole via PLT seek (region decode)
    dec.packet_bytes_skipped  bytes skipped via PLT seek
    dec.blocks_decoded   code-blocks entropy-decoded
    dec.blocks_skipped   blocks outside the decode area (region decode)
    dec.tiles_decoded    tiles decoded
    dec.tiles_skipped    tiles outside the decode area
    dec.device_ht_chunks  batch chunks through the device HT decode
    dec.host_ht_frames   batch frames through the host HT decode
    dec.ebcot_frames     batch frames through the EBCOT decode
    dec.sharded_device_ht_tiles  sharded tiles through the device HT decode
    dec.sharded_host_tiles  sharded tiles through the host tile decode

Spans.  `with counters.span(name, args):` around a step records it, but
only while a torch profiler records (`torch.profiler.profile`, or
`torch.autograd.profiler.profile`): nothing else turns spans on.  Off,
`span` returns one shared no-op context.  On, each span is a
`record_function` range, on the profiler's timeline beside the device's
kernels and copies, and adds under its name its calls and host ns by
`time.perf_counter_ns`, inclusive and self (less the spans directly
inside it, on the same thread; a span's own cost of entering and leaving
the range stays in its inclusive time, not in its parent's self).
`counters.spans()` reads them, `counters.reset()` clears them with the
counts; `snapshot()` holds counts only.  The spans of
`models/encoder.py::encode_batch` (the fused HT path; its EBCOT and host
branches have enc.batch, enc.header and enc.stack only):
    enc.batch            the call, after the fallback to `encode`; its
                         `args` is the call's sequence number
    enc.header           header_and_main, build_tile, _leaf_deltas,
                         byte_budget; a second block, the plans
    enc.stack            the frames stacked into one host batch
    enc.launch           fused_encode_chunk: the device program's host
                         enqueue, with enc.upload in it
    enc.upload           the frames' host-to-device copy in
                         fused_encode_chunk
    enc.fetch.wait       fetch_pool: the word totals, the host waiting on
                         the device program
    enc.fetch.copy       fetch_pool: the used pool into pinned memory
    enc.t2               t2_bodies: geometry, zero bit-planes, the native
                         call's buffers and the frames' bytes
    enc.t2.native        the native ht_t2_encode_frames call alone
    enc.finalize         SOT, SOD and body joins and _finalize_codestream,
                         once a chunk
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

# one span's readings: calls, then inclusive and self host ns
SPAN_FIELDS = ("calls", "incl_ns", "self_ns")


class _NoSpan:
    """What `span` returns while no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_owner", "_name", "_range", "_t0", "_child_ns")

    def __init__(self, owner: "Counters", name: str, args: Optional[str]):
        self._owner = owner
        self._name = name
        self._range = record_function(name, args)
        self._child_ns = 0

    def __enter__(self):
        # the clock brackets the range, so what entering and leaving it
        # costs is this span's, not its parent's self time
        self._t0 = time.perf_counter_ns()
        self._range.__enter__()
        self._owner._stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = self._owner._stack()
        stack.pop()
        self._range.__exit__(*exc)
        ns = time.perf_counter_ns() - self._t0
        if stack:
            stack[-1]._child_ns += ns
        self._owner._record(self._name, ns, ns - self._child_ns)
        return False


class Counters:
    def __init__(self) -> None:
        self._c: Dict[str, int] = {}
        self._spans: Dict[str, List[int]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def get(self, name: str) -> int:
        return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def reset(self) -> None:
        with self._lock:
            self._c.clear()
            self._spans.clear()

    def span(self, name: str, args: Optional[str] = None):
        """A context that records the step it holds under `name` while a
        torch profiler records, and else does nothing (module docstring).
        `args` goes to the profiler's range."""
        if not _profiler_enabled():
            return _NO_SPAN
        return _Span(self, name, args)

    def spans(self) -> Dict[str, Dict[str, int]]:
        """{name: {"calls", "incl_ns", "self_ns"}} of every span recorded
        since the last reset."""
        with self._lock:
            return {name: dict(zip(SPAN_FIELDS, row))
                    for name, row in self._spans.items()}

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name: str, *readings: int) -> None:
        with self._lock:
            row = self._spans.setdefault(name, [0] * len(SPAN_FIELDS))
            row[0] += 1
            for i, v in enumerate(readings, 1):
                row[i] += v


counters = Counters()
