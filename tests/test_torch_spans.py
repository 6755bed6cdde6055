"""The spans of go_jpeg2000_tpu_torch.utils.metrics (`counters.span`) and
where `models/encoder.py::encode_batch` puts them: they record only while a
torch profiler records, nest as the steps do, and change no byte."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu_torch.utils import metrics
from go_jpeg2000_tpu_torch.utils.metrics import counters

# the spans of the fused HT path, each under the one it sits in
PARENT = {"enc.header": "enc.batch", "enc.stack": "enc.batch",
          "enc.launch": "enc.batch", "enc.upload": "enc.launch",
          "enc.fetch.wait": "enc.batch", "enc.fetch.copy": "enc.batch",
          "enc.t2": "enc.batch", "enc.t2.native": "enc.t2",
          "enc.finalize": "enc.batch"}
NAMES = ["enc.batch"] + list(PARENT)
# blocks a call (the header's second block holds the plans); the others
# run once a chunk
PER_CALL = {"enc.batch": 1, "enc.header": 2, "enc.stack": 1}


def _frames(kind):
    rng = np.random.default_rng(25)
    if kind == "gray53":
        return ([rng.integers(0, 4096, (64, 64)).astype(np.uint16)
                 for _ in range(4)],
                tp.Options(lossless=True, high_throughput=True))
    return ([rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
             for _ in range(4)],
            tp.Options(lossless=False, high_throughput=True, quality=85))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for e in prof.events():
        if e.name in NAMES:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out, ranges


def test_off_span_is_the_shared_no_op(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(metrics, "record_function", refuse)
    counters.reset()
    assert not torch._C._autograd._profiler_enabled()
    a, b = counters.span("enc.batch", "1"), counters.span("enc.header")
    assert a is b is metrics._NO_SPAN
    with a:
        with b:
            pass
    assert counters.spans() == {}


def test_off_encode_batch_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(metrics, "record_function", refuse)
    counters.reset()
    frames, opts = _frames("gray53")
    assert len(tp.encode_batch(frames, opts, device="cpu")) == 4
    assert counters.spans() == {}
    assert counters.snapshot()["enc.fused_chunks"] >= 1


@pytest.mark.parametrize("kind", ["gray53", "rgb97"])
def test_spans_nest_in_the_call(kind):
    frames, opts = _frames(kind)
    counters.reset()
    _out, ranges = _profiled(lambda: tp.encode_batch(frames, opts,
                                                     device="cpu"))
    spans = counters.spans()
    chunks = counters.snapshot()["enc.fused_chunks"]
    assert set(spans) == set(NAMES) == set(ranges)
    (root,) = ranges["enc.batch"]
    for name in NAMES:
        want = PER_CALL.get(name, chunks)
        assert spans[name]["calls"] == want == len(ranges[name]), name
        for a, b in ranges[name]:
            assert root[0] <= a <= b <= root[1], name
        if name in PARENT:
            outer = ranges[PARENT[name]]
            assert all(any(p <= a and b <= q for p, q in outer)
                       for a, b in ranges[name]), name
        s = spans[name]
        assert 0 <= s["self_ns"] <= s["incl_ns"]
    for parent in set(PARENT.values()):
        kids = [n for n, p in PARENT.items() if p == parent]
        assert (spans[parent]["self_ns"]
                + sum(spans[k]["incl_ns"] for k in kids)
                == spans[parent]["incl_ns"]), parent


@pytest.mark.parametrize("kind", ["gray53", "rgb97"])
def test_codestreams_equal_with_the_profiler_on_and_off(kind):
    frames, opts = _frames(kind)
    off = tp.encode_batch(frames, opts, device="cpu")
    on, ranges = _profiled(lambda: tp.encode_batch(frames, opts,
                                                   device="cpu"))
    assert ranges["enc.batch"]
    assert on == off


def test_root_args_hold_the_call_number(monkeypatch):
    seen = []
    real = metrics.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)
    monkeypatch.setattr(metrics, "record_function", spy)
    frames, opts = _frames("gray53")
    _profiled(lambda: [tp.encode_batch(frames, opts, device="cpu")
                       for _ in range(2)])
    roots = [int(args) for name, args in seen if name == "enc.batch"]
    assert len(roots) == 2 and roots[1] == roots[0] + 1 >= 2
    assert all(args is None for name, args in seen if name != "enc.batch")


def test_reset_clears_spans_and_snapshot_holds_none():
    frames, opts = _frames("gray53")
    counters.reset()
    _profiled(lambda: tp.encode_batch(frames, opts, device="cpu"))
    assert set(counters.spans()) == set(NAMES)
    assert not set(counters.snapshot()) & set(NAMES)
    counters.reset()
    assert counters.spans() == {} and counters.snapshot() == {}
