import random

import numpy as np
import pytest
import torch

from benchmark import judge, operation
from benchmark.reference import codestream, decode, transform, write
from benchmark.tests.conftest import tiny_cell
from benchmark.traffic import generate

ENCODE = ("ct512-ht-enc", "wsi512-ht-enc")


@pytest.mark.parametrize("workload", ENCODE)
def test_port_codestreams_match_the_reference(workload):
    """The port's codestreams of a tiny frame of each configuration parse
    with the stated header, and every block's values and bytes equal the
    reference's (the CPU path of the port)."""
    cell = tiny_cell(workload, rows=72, columns=100, frames=2, batches=1)
    cfg, mix = cell["config"], dict(cell["mix"], segment_frames=2)
    pool = generate.frames(mix, cfg, 11, "cpu")
    op = operation.load("encode_batch")(cfg, mix, pool, "cpu")
    checks = op.check([(0, 0, op.call(0))], random.Random(0))
    assert all(v == 0 for v, _lim in checks.values()), (checks, op.notes)


def test_reference_round_trip_of_the_lossless_configuration():
    cell = tiny_cell("ct512-ht-dec", rows=40, columns=56, frames=1,
                     batches=1)
    cfg = cell["config"]
    frame = generate.frames(cell["mix"], cfg, 12, "cpu")
    pyr = transform.forward(frame, cfg)
    assert np.array_equal(transform.inverse(pyr, cfg)[0], frame[0])
    data = operation.load("encode_batch")(cfg, cell["mix"], frame,
                                          "cpu").call(0)[0]
    assert np.array_equal(decode.decode(data, cfg), frame[0])


def test_rct_round_trip_and_odd_sizes():
    cfg = {"rows": 9, "columns": 7, "samples_per_pixel": 3,
           "bits_stored": 16, "signed": False, "dtype": "uint16",
           "codec": {"lossless": True, "num_resolutions": 4}}
    x = np.random.default_rng(0).integers(0, 1 << 16, (2, 9, 7, 3)).astype(
        np.uint16)
    assert np.array_equal(transform.inverse(transform.forward(x, cfg), cfg),
                          x)


def test_band_sizes_tile_the_frame():
    sizes = codestream.band_sizes(100, 72, 5)
    assert sum(w * h for w, h in sizes.values()) == 100 * 72
    assert sizes[(5, "HL")] == (50, 36) and sizes[(0, "LL")] == (4, 3)


def test_lower_precision_changes_the_values():
    cell = tiny_cell("wsi512-ht-enc", rows=64, columns=64, frames=1,
                     batches=1)
    cfg = cell["config"]
    frame = generate.frames(cell["mix"], cfg, 13, "cpu")
    a = transform.forward(frame, cfg)
    b = transform.forward(frame, cfg, torch.bfloat16)
    assert any((a[0][k] != b[0][k]).any() for k in a[0])


@pytest.mark.parametrize("workload", ENCODE)
def test_reference_writer_codes_the_tile_as_the_port(workload):
    """The reference writer's codestream of the reference transform reads
    back with the stated header and carries the port's tile data byte for
    byte (the headers differ only in fields the check does not compare)."""
    cell = tiny_cell(workload, rows=72, columns=100, frames=1, batches=1)
    cfg = cell["config"]
    frame = generate.frames(cell["mix"], cfg, 14, "cpu")
    want = operation.expected_header(cfg)
    pyrs = [{k: v[0].numpy() for k, v in p.items()}
            for p in transform.forward(frame, cfg)]
    mine = write.codestream_of(want, pyrs)
    main, _blocks = codestream.read(mine)
    assert operation.header_gaps(main, want) == []
    port = operation.load("encode_batch")(cfg, cell["mix"], frame,
                                          "cpu").call(0)[0]
    sod = b"\xff\x93"
    assert mine[mine.index(sod):] == port[port.index(sod):]
    if cfg["codec"]["lossless"]:
        assert np.array_equal(decode.decode(mine, cfg), frame[0])


def test_tag_tree_writer_reads_back():
    rng = np.random.default_rng(3)
    values = rng.integers(0, 6, (5, 7))
    tw = write.TagTreeWriter(values)
    bw = write.BitWriter()
    for y in range(5):
        for x in range(7):
            tw.encode(bw, x, y, int(values[y, x]) + 1)
    data = bw.end() + b"\x00" * 4
    tr = codestream.TagTree(7, 5)
    br = codestream.BitReader(data, 0)
    for y in range(5):
        for x in range(7):
            t = 1
            while not tr.decode(br, x, y, t):
                t += 1
            assert tr.leaf(x, y) == values[y, x]


def test_frames_judged_in_worker_processes(monkeypatch):
    """The check's frames go to spawned workers when the job is large; the
    numbers are those the calling process gives."""
    cell = tiny_cell("ct512-ht-enc", rows=64, columns=64, frames=3,
                     batches=1)
    cfg, mix = cell["config"], dict(cell["mix"], segment_frames=1)
    pool = generate.frames(mix, cfg, 15, "cpu")
    op = operation.load("encode_batch")(cfg, mix, pool, "cpu")
    kept = [(0, 0, op.call(0))]
    inline = op.check(kept, random.Random(1))
    monkeypatch.setattr(judge, "INLINE_PIXELS", 0)
    monkeypatch.setattr(judge, "WORKERS", 2)
    assert op.check(kept, random.Random(1)) == inline
