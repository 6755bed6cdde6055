import math
import random
import time

import pytest

from benchmark import run
from benchmark.roofline import dwt_bytes
from benchmark.tests.conftest import tiny_cell


class FakeTrace:
    def __init__(self, walls):
        self.walls = walls


@pytest.mark.parametrize("name", ["batch_p95_ms.enc", "batch_p95_ms.dec"])
def test_p95_is_over_all_calls(name):
    read = run.metric_module(name).read
    # 100 calls of 1..100 ms: the 95th by nearest rank is 95 ms
    walls = [i / 1e3 for i in range(1, 101)]
    random.Random(0).shuffle(walls)
    assert read(FakeTrace(walls)) == pytest.approx(95.0)
    # ten chunks whose medians are all 10 ms: a median of chunks would say
    # 10, the calls' own 95th percentile is the slow tail
    walls = ([0.010] * 9 + [0.500]) * 10
    assert read(FakeTrace(walls)) == pytest.approx(500.0)


def test_dwt_bytes_by_hand():
    # level 1 reads 2 planes of 8 x 6 and writes as many: 2 * 4 * 96;
    # level 2 takes the 4 x 3 LL: 2 * 4 * 24
    assert dwt_bytes(2, 8, 6, 2) == 768 + 192
    # odd sizes keep ceil(n / 2) low samples
    assert dwt_bytes(1, 5, 3, 2) == 2 * 4 * 15 + 2 * 4 * 6


class SleepOp:
    frames = 2
    inputs = [0, 1, 2]

    def __init__(self):
        self.calls = []

    def call(self, b):
        self.calls.append(b)
        time.sleep(0.01)
        return [b] * (1 if len(self.calls) == 3 else 2)

    def short(self, answer):
        return len(answer) != self.frames


def test_window_counts_every_call_over_its_whole_time():
    op = SleepOp()
    walls, kept, short, window_s = run.window(op, 0.2, 2, random.Random(1))
    assert len(walls) == len(op.calls) >= 10
    assert op.calls[:4] == [0, 1, 2, 0]          # the pool is cycled
    assert short == 1                            # the third call lacked a frame
    assert len(kept) == 2
    assert sum(walls) <= window_s < sum(walls) + 0.05
    assert window_s >= 0.2


def test_rate_is_all_the_work_over_the_window():
    cell = tiny_cell("ct512-ht-enc")
    res = run.run_cell(cell, 5, 0.5, False, "cpu")
    f = cell["mix"]["frames_per_call"]
    pixels = res["attempted"] * f * cell["config"]["rows"] * cell["config"]["columns"]
    assert res["metrics"]["encode_mpix_s"]["value"] == pytest.approx(
        pixels / 1e6 / res["window_s"])
    assert res["metrics"]["setup_s"]["value"] > 0
    assert not math.isnan(res["metrics"]["encode_mpix_s"]["value"])


@pytest.mark.parametrize("name", ["encode_mpix_s", "decode_mpix_s"])
def test_rate_readers_take_every_pixel_over_the_whole_window(name):
    w = run.Window(walls=[0.1] * 30, window_s=4.0, setup_s=7.5,
                   pixels=30 * 64 * 512 * 512)
    assert run.metric_module(name).read(w) == pytest.approx(
        30 * 64 * 512 * 512 / 1e6 / 4.0)
    assert run.metric_module("setup_s").read(w) == 7.5


def test_idle_time_goes_to_the_innermost_stage():
    from benchmark.tracing import idle_spans, innermost, overlap
    # a call [0, 10] with a parse [1, 5] and a device stage [6, 9] in it,
    # a second call [11, 12]
    events = [("call", 0, 10), ("parse", 1, 5), ("device", 6, 9),
              ("call", 11, 12)]
    segs = innermost(events)
    assert segs == [(0, 1, "call"), (1, 5, "parse"), (5, 6, "call"),
                    (6, 9, "device"), (9, 10, "call"), (10, 11, "harness"),
                    (11, 12, "call")]
    # the card busy over [2, 3] and [6.5, 8]
    spans = idle_spans([(2, 3), (6.5, 8)], 0, 12)
    assert spans == [(0, 2), (3, 6.5), (8, 12)]
    idle = {}
    for a, b, name in overlap(segs, spans):
        idle[name] = idle.get(name, 0) + b - a
    assert idle == {"call": 4, "parse": 3, "device": 1.5, "harness": 1}
