"""A run with the timed path broken underneath must come out not correct:
each fault the cells can have, planted in the port at a small shape on
the CPU, with the rest of the run as the command drives it.  (A step that
returns its state unchanged and the exchange between chips are faults of
cells that keep state or span cards; these cells have neither.)"""
import numpy as np
import pytest

from benchmark import control, run
from benchmark.tests.conftest import WORKLOADS, tiny_cell


def half_the_batch(monkeypatch, workload):
    from go_jpeg2000_tpu_torch.models import decoder, encoder
    mod, name = ((decoder, "decode_batch") if "dec" in workload
                 else (encoder, "encode_batch"))
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda frames, *a: fn(frames[:len(frames) // 2], *a))


def altered_answer(monkeypatch, workload):
    """One byte or one sample changed where the answer is produced: the
    native Tier-2's tile bodies, or the decode's download."""
    from go_jpeg2000_tpu_torch.models import decoder, fused_encode
    if "dec" in workload:
        fn = decoder.download

        def download(out, dt):
            arr = fn(out, dt).copy()
            arr[len(arr) // 3] += 1
            return arr
        monkeypatch.setattr(decoder, "download", download)
    else:
        fn = fused_encode.t2_bodies

        def t2_bodies(*a):
            bodies = fn(*a)
            return [b[:len(b) // 2] + bytes([b[len(b) // 2] ^ 0x10])
                    + b[len(b) // 2 + 1:] for b in bodies]
        monkeypatch.setattr(fused_encode, "t2_bodies", t2_bodies)


def another_path(monkeypatch, workload):
    """The device branch refuses the frames, so the port codes them
    another way (the host HT coder, or `decode` frame by frame): the path
    counters must say so."""
    from go_jpeg2000_tpu_torch.models import decoder, fused_encode
    if "dec" in workload:
        monkeypatch.setattr(decoder, "parse_chunk", lambda *a: None)
    else:
        monkeypatch.setattr(fused_encode, "plan_for", lambda *a, **k: None)


def one_frame_from_its_neighbour(monkeypatch, workload):
    """One slot of every batch answered from its neighbour: the encode
    codes frame 0's samples in slot 1, the decode returns frame 0 there."""
    from go_jpeg2000_tpu_torch.models import decoder, encoder
    if "dec" in workload:
        fn = decoder.decode_batch

        def decode_batch(streams, *a):
            out = list(fn(streams, *a))
            out[1] = out[0]
            return out
        monkeypatch.setattr(decoder, "decode_batch", decode_batch)
    else:
        fn = encoder.encode_batch
        monkeypatch.setattr(encoder, "encode_batch", lambda frames, *a: fn(
            [frames[0], frames[0]] + list(frames[2:]), *a))


def one_frame_altered(monkeypatch, workload):
    """One frame of every batch altered where it is produced: a byte of
    the last frame's tile body, or a sample of the last decoded frame."""
    from go_jpeg2000_tpu_torch.models import decoder, fused_encode
    if "dec" in workload:
        fn = decoder.download

        def download(out, dt):
            arr = fn(out, dt).copy()      # flat: the chunk's last frame ends it
            arr[len(arr) - 5] ^= 4
            return arr
        monkeypatch.setattr(decoder, "download", download)
    else:
        fn = fused_encode.t2_bodies

        def t2_bodies(*a):
            bodies = list(fn(*a))
            b = bodies[-1]
            bodies[-1] = (b[:len(b) // 2] + bytes([b[len(b) // 2] ^ 0x10])
                          + b[len(b) // 2 + 1:])
            return bodies
        monkeypatch.setattr(fused_encode, "t2_bodies", t2_bodies)


FAULTS = {"half_the_batch": half_the_batch, "altered_answer": altered_answer,
          "another_path": another_path,
          "one_frame_from_its_neighbour": one_frame_from_its_neighbour,
          "one_frame_altered": one_frame_altered}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_not_correct(monkeypatch, workload, fault):
    cell = tiny_cell(workload)
    FAULTS[fault](monkeypatch, workload)
    res = run.run_cell(cell, 2**31 + 11, 0.3, False, "cpu")
    assert res["correct"] is False, res["checks"]
    if fault in WHICH:
        assert res["checks"][WHICH[fault]][0] > 0, res["checks"]


# the number each fault must move (the others may move too)
WHICH = {"half_the_batch": "calls_short_of_frames",
         "another_path": "path_counters_off"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_reads_not_correct(workload):
    """The reference one precision down in the program's place, judged by
    the run's own check (on the card, at the cell's size, by
    `python3 -m benchmark.control`)."""
    cell = tiny_cell(workload, rows=128, columns=96)
    res = control.control(cell, 2**31 + 12, "cpu")
    assert res["correct"] is False, res
    over = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    # the values, not the parse or the header, tell the control apart
    assert over and over <= {"coefficient_mismatch", "index_mismatch_ppm",
                             "max_index_gap", "segment_mismatch",
                             "sample_mismatch"}, res


def test_sound_run_reads_correct():
    res = run.run_cell(tiny_cell("ct512-ht-dec"), 2**31 + 13, 0.3, False,
                       "cpu")
    assert res["correct"] is True and np.isfinite(
        res["metrics"]["decode_mpix_s"]["value"])
