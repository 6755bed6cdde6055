"""The port's Part-1 code-block styles and its Python entropy backend
against the JAX package, on images made from a seed at 32-48 px.

Styles: the PTERM sets of tests/test_entropy.py (TestPTerm.STYLES) and all
six flags (0x3f), at two quality layers and with a byte budget, give the
JAX package's encode bytes through `encode`, `encode_batch` and
`encode_sharded`, and decode exactly where nothing truncates.  A styled
Part-1 batch takes the host path (path C, enc.host_entropy_frames) whatever
the backend asks, as the JAX package's does (its device EBCOT codes style
0 only).

backend="python": the port's copies of the JAX package's Python coders
(ops/ht.py, ops/t1.py) give the JAX package's python-backend bytes, HT
refinement passes included (tests/test_ht_refinement.py), and, with one
layer, the native backend's bytes (tests/test_native.py)."""
import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models.encoder import encode_batch as jax_encode_batch
from go_jpeg2000_tpu.options import Format, Options
from go_jpeg2000_tpu.utils import markers as mk
from go_jpeg2000_tpu_torch.parallel import encode_sharded


def _image(shape, seed):
    """Smooth noise, as bench.py's natural_image makes it."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=shape).astype(np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def _opts(**kw):
    base = dict(format=Format.J2K, lossless=True, num_resolutions=3)
    base.update(kw)
    return Options(**base)


STYLES = [mk.CBSTYLE_PTERM,
          mk.CBSTYLE_PTERM | mk.CBSTYLE_TERMALL,
          mk.CBSTYLE_PTERM | mk.CBSTYLE_TERMALL | mk.CBSTYLE_LAZY,
          mk.CBSTYLE_PTERM | mk.CBSTYLE_LAZY | mk.CBSTYLE_RESET,
          0x3f]
RGB = _image((48, 56, 3), 5)


@pytest.mark.parametrize("style", STYLES, ids=hex)
def test_style_two_layers(style):
    opts = _opts(code_block_style=style, num_layers=2)
    ours = tp.encode(RGB, tp.options_from_reference(opts), device="cpu")
    assert ours == jp2k.encode(RGB, opts)
    assert np.array_equal(tp.decode(ours, device="cpu"), RGB)
    assert np.array_equal(tp.decode(ours, tp.Config(quality_layers=1),
                                    device="cpu"),
                          jp2k.decode(ours, jp2k.Config(quality_layers=1)))


@pytest.mark.parametrize("style", STYLES, ids=hex)
def test_style_with_budget(style):
    gray = RGB[..., 1]
    opts = _opts(code_block_style=style, num_layers=2, compression_ratio=4.0,
                 tile_size=(32, 32))
    ours = tp.encode(gray, tp.options_from_reference(opts), device="cpu")
    assert ours == jp2k.encode(gray, opts)
    assert len(ours) <= gray.size / 4.0
    assert np.array_equal(tp.decode(ours, device="cpu"), jp2k.decode(ours))


@pytest.mark.parametrize("style", [mk.CBSTYLE_PTERM | mk.CBSTYLE_TERMALL
                                   | mk.CBSTYLE_LAZY, 0x3f], ids=hex)
def test_style_lossy_within_one_grey_level(style):
    opts = _opts(code_block_style=style, num_layers=2, lossless=False,
                 quality=85)
    ours = tp.encode(RGB, tp.options_from_reference(opts), device="cpu")
    got, want = tp.decode(ours, device="cpu"), jp2k.decode(
        jp2k.encode(RGB, opts))
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("backend", ["auto", "device", "hybrid", "native"])
def test_styled_batch_takes_path_c(backend):
    opts = _opts(code_block_style=0x3f, backend=backend)
    popts = tp.options_from_reference(opts)
    frames = [RGB, _image((48, 56, 3), 6)]
    tp.counters.reset()
    got = tp.encode_batch(frames, popts, device="cpu")
    snap = tp.counters.snapshot()
    assert snap.get("enc.host_entropy_frames", 0) == 2
    assert not snap.get("enc.ebcot_device_chunks", 0)
    assert not snap.get("enc.ebcot_hybrid_chunks", 0)
    assert got == jax_encode_batch(frames, opts)
    assert got == [tp.encode(f, popts, device="cpu") for f in frames]
    for data, f in zip(tp.decode_batch(got, device="cpu"), frames):
        assert np.array_equal(data, f)


def test_styled_sharded():
    opts = _opts(code_block_style=0x3f, tile_size=(32, 32))
    image = _image((64, 64, 3), 7)
    assert encode_sharded(image, tp.options_from_reference(opts),
                          device="cpu") == jp2k.encode(image, opts)


# --- backend "python" -------------------------------------------------------

PYTHON = {
    "part1": dict(),
    "part1_layers": dict(num_layers=2),
    "part1_style": dict(code_block_style=mk.CBSTYLE_PTERM
                        | mk.CBSTYLE_TERMALL),
    "ht": dict(high_throughput=True),
    "ht_refined": dict(high_throughput=True, ht_refinement=True),
    "ht_refined_rgb": dict(high_throughput=True, ht_refinement=True,
                           shape=(32, 32, 3)),
    "ht_lossy_layers": dict(high_throughput=True, lossless=False,
                            num_layers=3, compression_ratio=4.0),
}


@pytest.mark.parametrize("name", sorted(PYTHON))
def test_python_backend_equals_jax(name):
    kw = dict(PYTHON[name])
    image = _image(kw.pop("shape", (32, 40)), 8)
    opts = _opts(backend="python", **kw)
    ours = tp.encode(image, tp.options_from_reference(opts), device="cpu")
    ref = jp2k.encode(image, opts)
    if opts.lossless:
        assert ours == ref
        assert np.array_equal(tp.decode(ours, device="cpu"), image)
    else:
        got, want = tp.decode(ours, device="cpu"), jp2k.decode(ref)
        assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("ht", [False, True])
def test_python_backend_equals_native(ht):
    image = _image((32, 48), 9)
    native = tp.options_from_reference(_opts(high_throughput=ht,
                                             backend="native"))
    python = dataclasses.replace(native, backend="python")
    tp.counters.reset()
    d_python = tp.encode_batch([image], python, device="cpu")[0]
    assert tp.counters.snapshot().get("enc.host_entropy_frames", 0) == 1
    assert d_python == tp.encode(image, native, device="cpu")
    assert d_python == tp.encode(image, python, device="cpu")
    assert encode_sharded(image, dataclasses.replace(
        python, tile_size=(16, 16)), device="cpu") == encode_sharded(
            image, dataclasses.replace(native, tile_size=(16, 16)),
            device="cpu")


def test_python_backend_refined_blocks_have_three_passes():
    from go_jpeg2000_tpu.models.entropy_backend import (
        encode_blocks_batch as jax_blocks)
    from go_jpeg2000_tpu_torch.models.entropy_backend import (
        encode_blocks_batch)
    rng = np.random.RandomState(5)
    c = np.round(rng.laplace(0, 60, size=(32, 32))).astype(np.int32)
    jobs = [(c, "LL", mk.CBSTYLE_HT, 12)]
    kw = dict(backend="python", ht_refinement=True, ht_require_exact=False)
    res, ref = encode_blocks_batch(jobs, **kw)[0], jax_blocks(jobs, **kw)[0]
    assert len(res.passes) == 3
    assert res.data == ref.data and res.segment_lengths == \
        ref.segment_lengths
    assert [(p.rate, p.distortion) for p in res.passes] == \
        [(p.rate, p.distortion) for p in ref.passes]
