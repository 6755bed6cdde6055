"""The readers of the program's spans (benchmark/spans.py and the
metrics that use it), against a registry filled by hand."""
import pytest

from benchmark import run
from go_jpeg2000_tpu_torch.utils import metrics


class Registry:
    """A counters registry whose spans() is what the test gives it."""

    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return self._spans


def _span(calls, incl_ns, self_ns):
    return {"calls": calls, "incl_ns": incl_ns, "self_ns": self_ns}


# two encode_batch calls; the chunk spans ran four times
WINDOW = {
    "enc.batch": _span(2, 200_000_000, 3_000_000),
    "enc.header": _span(2, 9_000_000, 8_000_000),
    "enc.stack": _span(2, 20_000_000, 20_000_000),
    "enc.finalize": _span(4, 30_000_000, 30_000_000),
    "enc.t2": _span(4, 50_000_000, 10_000_000),
    "enc.t2.native": _span(4, 40_000_000, 40_000_000),
    "enc.fetch.wait": _span(4, 12_000_000, 12_000_000),
}

WANT = {"entry_self_ms.enc": 1.5, "header_ms.enc": 4.0,
        "stack_ms.enc": 10.0, "finalize_ms.enc": 15.0,
        "t2_native_ms.enc": 20.0, "fetch_wait_ms.enc": 6.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_divides_the_window_by_the_calls(name, monkeypatch):
    monkeypatch.setattr(metrics, "counters", Registry(WINDOW))
    assert run.metric_module(name).read(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_none_without_calls(name, monkeypatch):
    # no span recorded (an untraced window), a root never called, a
    # program whose registry has no spans at all
    for registry in (Registry({}),
                     Registry(dict(WINDOW, **{"enc.batch": _span(0, 0, 0)})),
                     object()):
        monkeypatch.setattr(metrics, "counters", registry)
        assert run.metric_module(name).read(None) is None


def test_a_span_the_path_lacks_reads_none(monkeypatch):
    monkeypatch.setattr(metrics, "counters", Registry(
        {"enc.batch": WINDOW["enc.batch"]}))
    assert run.metric_module("t2_native_ms.enc").read(None) is None
    assert run.metric_module("entry_self_ms.enc").read(None) == 1.5
