"""Shared helpers of the decode-option tests (test_torch_decode_options.py,
test_torch_decode_samples.py): images made from a seed, and the port's
decode held to the JAX package's on the same bytes, with the work
counters of both."""
import numpy as np

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.options import Config, Format, Options
from go_jpeg2000_tpu.utils.metrics import counters as jax_counters

SKIP_COUNTERS = ("dec.tiles_skipped", "dec.tiles_decoded",
                 "dec.packets_skipped", "dec.packet_bytes_skipped",
                 "dec.packets_parsed", "dec.blocks_skipped",
                 "dec.blocks_decoded")


def make_image(shape, seed=0, dtype=np.uint8, hi=256):
    """Smoothed noise, as tests/test_region_decode.py makes it."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, hi, size=shape).astype(np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    return a.astype(dtype)


def decode_both(data, **kw):
    """(port decode, JAX decode, port counters, JAX counters) of `data`
    with Config(**kw)."""
    tp.counters.reset()
    got = tp.decode(data, tp.Config(**kw), device="cpu")
    ours = tp.counters.snapshot()
    jax_counters.reset()
    want = jp2k.decode(data, Config(**kw))
    theirs = jax_counters.snapshot()
    return got, want, ours, theirs


def decode_exact(data, **kw):
    """Port and JAX decodes equal, dtype and shape included, and so are
    their work counters; returns (image, port counters)."""
    got, want, ours, theirs = decode_both(data, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    for k in SKIP_COUNTERS:
        assert ours.get(k, 0) == theirs.get(k, 0), k
    return got, ours


def ht_opts(**kw):
    return Options(**{"format": Format.J2K, "lossless": True,
                      "num_resolutions": 3, "high_throughput": True, **kw})


def assert_close(got, want, lossless):
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want).max() if got.size else 0
    assert d <= (0 if lossless else 1), d
