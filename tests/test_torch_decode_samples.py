"""The port's decode of colour spaces and sample types
(go_jpeg2000_tpu_torch.decode on the CPU) against the JAX package's
decode, on streams the JAX encoder writes from images made from a seed at
small sizes: the 14 JP2 colour conversions, function by function at 8, 12
and 16 bits and through decode; signed and 4- to 20-bit samples, lossless
and 9/7; streams whose SIZ marker was rewritten (signed, 4- and 20-bit,
2x2 subsampled), through decode and decode_batch; decode_sharded and
decode_multihost with quality_layers and signed samples, and their gates.
Lossless decodes and unconverted colour spaces equal the JAX package's
exactly, dtype included; lossy decodes within one grey level; the CIELab,
CIEJab and ROMM-RGB conversions (an sRGB gamma `pow` each) within one
grey level on at most 0.1% of the samples.  The region, layered and
reduced decodes are in tests/test_torch_decode_options.py."""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.ops import colorspace as jax_cs
from go_jpeg2000_tpu.options import ColorSpace, Config, Format, Options
from go_jpeg2000_tpu_torch.ops import colorspace
from go_jpeg2000_tpu_torch.parallel import decode_multihost, decode_sharded
from tests.decode_parity import (assert_close, decode_both, decode_exact,
                                 ht_opts, make_image)
from tests.siz_relabel import relabel, relabel_cases

# the conversions through an sRGB gamma pow: within one grey level on at
# most this share of the samples
GAMMA_SPACES = ("CIELAB", "CIEJAB", "ROMM_RGB")
GAMMA_SHARE = 1e-3


# -------------------------------------------------- colour conversions

SPACES = sorted(s.name for s in ColorSpace
                if jax_cs.get_color_conversion(s) is not None)


def _converted_close(got, want, space):
    """Equal, or for the gamma spaces within one grey level on at most
    GAMMA_SHARE of the samples."""
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if space in GAMMA_SPACES:
        assert diff.max() <= 1
        assert (diff > 0).mean() <= GAMMA_SHARE
    else:
        assert diff.max() == 0


def test_fourteen_converters():
    assert len(SPACES) == 14
    assert all(colorspace.get_color_conversion(tp.ColorSpace[s])
               is not None for s in SPACES)
    assert colorspace.get_color_conversion(tp.ColorSpace.SRGB) is None


@pytest.mark.parametrize("space", SPACES)
def test_converter_against_jax(space):
    mine = colorspace.get_color_conversion(tp.ColorSpace[space])
    theirs = jax_cs.get_color_conversion(ColorSpace[space])
    rng = np.random.RandomState(len(space))
    for precision in (8, 12, 16):
        comps = [rng.randint(0, 1 << precision, size=(96, 96)).astype(
            np.int32) for _ in range(4)]
        got = mine([torch.from_numpy(c) for c in comps], precision)
        want = theirs(comps, precision)
        assert len(got) == len(want) == 3
        assert all(g.dtype == torch.int32 for g in got)
        _converted_close(np.stack([g.numpy() for g in got]),
                         np.stack([np.asarray(w) for w in want]), space)


@pytest.mark.parametrize("space", SPACES)
def test_jp2_colour_space_decode(space):
    n = 4 if space in ("CMYK", "YCCK") else 3
    img = make_image((40, 48, n), len(space))
    data = jp2k.encode(img, Options(lossless=True, num_resolutions=3,
                                    color_space=ColorSpace[space]))
    got, want, _o, _t = decode_both(data)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (40, 48, 3)
    _converted_close(got, want, space)
    # a region decodes to the converted image's crop
    crop = tp.decode(data, tp.Config(decode_area=(8, 4, 40, 30)),
                     device="cpu")
    assert np.array_equal(crop, got[4:30, 8:40])


# ------------------------------------------------------ sample types

SAMPLES = {
    "int8": (np.int8, None, -128, 128),
    "int16": (np.int16, None, -30000, 30000),
    "u4": (np.uint8, 4, 0, 16),
    "u12": (np.uint16, 12, 0, 4096),
    "s12": (np.int16, 12, -2048, 2048),
    "s20": (np.int32, 20, -(1 << 19), 1 << 19),
    "u20": (np.uint32, 20, 0, 1 << 20),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
@pytest.mark.parametrize("ht", [True, False])
def test_sample_types(name, ht):
    dtype, precision, lo, hi = SAMPLES[name]
    img = (make_image((48, 40), 11, np.float64, 1 << 16) * (hi - lo)
           / (1 << 16) + lo).astype(dtype)
    opts = ht_opts(high_throughput=ht, precision=precision or 0)
    data = jp2k.encode(img, opts)
    got, _ = decode_exact(data)
    assert np.array_equal(got, img)


def test_lossy_signed_and_12bit():
    for dtype, precision, lo, hi in (SAMPLES["int16"], SAMPLES["u12"]):
        img = (make_image((48, 40), 12, np.float64, 1 << 16) * (hi - lo)
               / (1 << 16) + lo).astype(dtype)
        data = jp2k.encode(img, ht_opts(lossless=False, quality=90,
                                    precision=precision or 0))
        got, want, _o, _t = decode_both(data)
        assert_close(got, want, False)


@pytest.mark.parametrize("ht", [True, False])
def test_relabelled_streams(ht):
    x = make_image((56, 72), 13)
    data = jp2k.encode(x, ht_opts(high_throughput=ht, num_resolutions=4))
    for name, (kw, want) in relabel_cases(x).items():
        s = relabel(data, **kw)
        got, _ = decode_exact(s)
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
        # decode_batch hands them to decode one by one
        batch = tp.decode_batch([s, s], device="cpu")
        assert all(np.array_equal(b, got) and b.dtype == got.dtype
                   for b in batch), name
    sub = relabel(data, sub=2)
    crop, _ = decode_exact(sub, decode_area=(10, 6, 90, 70))
    assert np.array_equal(crop, np.repeat(np.repeat(x, 2, 0), 2, 1)[6:70,
                                                                  10:90])
    half, _ = decode_exact(sub, reduce_resolution=1)
    assert half.shape == (56, 72)


# ---------------------------------------- decode_sharded, multihost

def test_sharded_and_multihost_quality_layers():
    img = make_image((64, 64, 3), 14)
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                   high_throughput=True, num_layers=3,
                   compression_ratio=3.0, tile_size=(32, 32))
    data = jp2k.encode(img, opts)
    want = jp2k.decode(data, Config(quality_layers=1))
    assert not np.array_equal(want, img)
    cfg = tp.Config(quality_layers=1)
    assert np.array_equal(tp.decode(data, cfg, device="cpu"), want)
    tp.counters.reset()
    got = decode_sharded(data, cfg, device="cpu")
    assert tp.counters.snapshot().get("dec.sharded_host_tiles", 0) == 4
    assert got.dtype == want.dtype and np.array_equal(got, want)
    got = decode_multihost(data, cfg, n_hosts=2, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # signed samples through the sharded decode and both hosts
    signed = (make_image((64, 64), 15).astype(np.int16) - 128) * 50
    data = jp2k.encode(signed, Options(format=Format.J2K, lossless=True,
                                       num_resolutions=3,
                                       high_throughput=True,
                                       tile_size=(32, 32)))
    for got in (decode_sharded(data, device="cpu"),
                decode_multihost(data, n_hosts=1, device="cpu")):
        assert got.dtype == np.int16 and np.array_equal(got, signed)
    # gates: region and reduced decodes as the JAX package's, subsampling
    for cfg in (tp.Config(reduce_resolution=1),
                tp.Config(decode_area=(0, 0, 16, 16))):
        with pytest.raises(ValueError):
            decode_sharded(data, cfg, device="cpu")
        with pytest.raises(ValueError):
            decode_multihost(data, cfg, n_hosts=2, device="cpu")
    sub = relabel(jp2k.encode(make_image((64, 64), 16), ht_opts(
        tile_size=(64, 64))), sub=2)
    with pytest.raises(ValueError):
        decode_sharded(sub, device="cpu")
    with pytest.raises(ValueError):
        decode_multihost(sub, n_hosts=2, device="cpu")
