"""The port's encoders on the sample types of the JAX package's encode:
int8, int16, uint32 of up to 29 bits lossless (31 lossy), explicit
precisions from 1 bit, and 2 or 4 components, in J2K and JP2, held to
go_jpeg2000_tpu.encode on 40x48 images made from a seed.

Lossless streams equal the JAX package's byte for byte and decode exactly,
through `encode` and `encode_batch` (each of its branches: the fused HT
encode, Part-1 device EBCOT and the host path).  Lossy 9/7 decodes agree
with the JAX package's within one grey level of an 8-bit image, which is
2^(P-8) at P bits (a quantizer index that float32 lifting rounds the
other way moves a sample by the step, which grows with the precision), and
PSNR within 0.05 dB up to 16 bits (0.2 dB up to 24 bits and 0.5 dB above,
where the float32 lifting's rounding, different in XLA's fused programs
and in torch's separate ops, grows to the size of the quantization
error: the port measured 0.26 dB below the JAX package at 29 bits).  Where the JAX package fails on the sample width (30
bits and up lossless, 32 lossy) the port raises ValueError.  Where it is
wrong (the precision it gives a signed integer image without `precision`
drops a bit) the port is exact; a test shows both."""
import numpy as np
import pytest
import struct
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.options import Format, Options


def _image(shape, seed, dtype, lo, hi):
    """Smooth noise in [lo, hi)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(lo, hi, size=shape).astype(np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return np.round(a).astype(dtype)


def _opts(**kw):
    base = dict(format=Format.J2K, lossless=True, num_resolutions=3)
    base.update(kw)
    return Options(**base)


def _psnr(a, b, bits):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(float((1 << bits) - 1) ** 2 / mse)


# name -> (image, options, bits)
SAMPLES = {
    "int8": (_image((40, 48), 1, np.int8, -128, 128), {}, 8),
    "int16": (_image((40, 48), 2, np.int16, -32768, 32768), {}, 16),
    "int16_rgb": (_image((40, 48, 3), 2, np.int16, -32768, 32768), {}, 16),
    "uint32_20": (_image((40, 48), 3, np.uint32, 0, 1 << 20),
                  dict(precision=20), 20),
    "uint32_24": (_image((40, 48), 4, np.uint32, 0, 1 << 24),
                  dict(precision=24), 24),
    "uint32_29": (_image((40, 48), 5, np.uint32, 0, 1 << 29),
                  dict(precision=29), 29),
    "uint32_29_natural": (_image((40, 48), 5, np.uint32, 0, 1 << 29), {}, 29),
    "uint32_28_rgb": (_image((40, 48, 3), 6, np.uint32, 0, 1 << 28),
                      dict(precision=28), 28),
    "precision1": (_image((40, 48), 7, np.uint8, 0, 2), dict(precision=1), 1),
    "precision4": (_image((40, 48), 8, np.uint8, 0, 16), dict(precision=4), 4),
    "precision6": (_image((40, 48), 9, np.uint8, 0, 64), dict(precision=6), 6),
    "precision12": (_image((40, 48), 10, np.uint16, 0, 4096),
                    dict(precision=12), 12),
    "gray_alpha_12": (_image((40, 48, 2), 11, np.uint16, 0, 4096),
                      dict(precision=12), 12),
    "rgbn_16": (_image((40, 48, 4), 12, np.uint16, 0, 65536), {}, 16),
    "rgba_8": (_image((40, 48, 4), 13, np.uint8, 0, 256), {}, 8),
}


@pytest.mark.parametrize("ht", [False, True])
@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_lossless_equals_jax(name, ht):
    image, kw, bits = SAMPLES[name]
    opts = _opts(high_throughput=ht, **kw)
    popts = tp.options_from_reference(opts)
    ours = tp.encode(image, popts, device="cpu")
    assert ours == jp2k.encode(image, opts)
    got = tp.decode(ours, device="cpu")
    assert got.dtype == jp2k.decode(ours).dtype
    assert np.array_equal(got, image)
    # the batch branches give each frame its encode stream
    tp.counters.reset()
    assert tp.encode_batch([image, image], popts, device="cpu") == [ours] * 2
    # Part-1 samples of 27 bits and up have more bitplanes than the device
    # EBCOT's 29 (ebcot_fused.plan_for) and code on the host
    assert tp.counters.snapshot().get("enc.host_entropy_frames", 0) == (
        0 if ht or bits < 27 else 2)


@pytest.mark.parametrize("name", ["int8", "int16", "int16_rgb", "uint32_20",
                                  "uint32_29", "gray_alpha_12", "rgbn_16",
                                  "rgba_8"])
def test_lossy_within_a_step_of_jax(name):
    image, kw, bits = SAMPLES[name]
    opts = _opts(lossless=False, quality=85, high_throughput=True, **kw)
    ours = tp.encode(image, tp.options_from_reference(opts), device="cpu")
    ref = jp2k.encode(image, opts)
    got, want = tp.decode(ours, device="cpu"), jp2k.decode(ref)
    assert got.dtype == want.dtype and got.shape == image.shape
    tol = max(1, 1 << max(0, bits - 8))
    assert np.abs(got.astype(np.int64) - want).max() <= tol
    # float32 lifting noise: a 24-bit significand against P-bit samples
    slack = 0.05 if bits <= 16 else 0.2 if bits <= 24 else 0.5
    assert _psnr(got, image, bits) >= _psnr(want, image, bits) - slack


@pytest.mark.parametrize("fmt", [Format.J2K, Format.JP2])
@pytest.mark.parametrize("name", ["gray_alpha_12", "rgba_8"])
def test_components_in_jp2(name, fmt):
    image, kw, _bits = SAMPLES[name]
    opts = _opts(format=fmt, high_throughput=True, **kw)
    ours = tp.encode(image, tp.options_from_reference(opts), device="cpu")
    assert ours == jp2k.encode(image, opts)
    meta = tp.decode_metadata(ours)
    assert meta.num_components == image.shape[2]
    if fmt == Format.JP2:
        assert int(meta.color_space) == int(jp2k.decode_metadata(
            ours).color_space)
    assert np.array_equal(tp.decode(ours, device="cpu"), image)


def test_batch_decode_takes_signed_and_four_components_on_the_device():
    # the HT batch decode's device branch takes signed and 4-component
    # streams, as the JAX package's
    for name in ("int16", "rgbn_16"):
        image = SAMPLES[name][0]
        streams = tp.encode_batch([image] * 2, tp.options_from_reference(
            _opts(high_throughput=True)), device="cpu")
        tp.counters.reset()
        for got in tp.decode_batch(streams, device="cpu"):
            assert np.array_equal(got, image)
        assert tp.counters.snapshot().get("dec.device_ht_chunks", 0) > 0


@pytest.mark.parametrize("bits,lossless,rgb", [(30, True, False),
                                               (31, True, False),
                                               (29, True, True),
                                               (32, False, False)])
def test_sample_width_limits_raise_in_both(bits, lossless, rgb):
    shape = (16, 16, 3) if rgb else (16, 16)
    image = _image(shape, 14, np.uint32, 0, 1 << (bits - 1))
    opts = _opts(lossless=lossless, precision=bits)
    with pytest.raises(ValueError, match=f"{bits}-bit samples"):
        tp.encode(image, tp.options_from_reference(opts), device="cpu")
    with pytest.raises(ValueError, match=f"{bits}-bit samples"):
        tp.encode_batch([image], tp.options_from_reference(opts),
                        device="cpu")
    # the JAX package fails in the quantization marker or the jitted
    # transform
    with pytest.raises((struct.error, OverflowError)):
        jp2k.encode(image, opts)


def test_31_bit_lossy_encodes_in_both():
    image = _image((16, 16), 15, np.uint32, 0, 1 << 31)
    opts = _opts(lossless=False, quality=85, precision=31)
    ours = tp.encode(image, tp.options_from_reference(opts), device="cpu")
    want = jp2k.decode(jp2k.encode(image, opts))
    got = tp.decode(ours, device="cpu")
    assert np.abs(got.astype(np.int64) - want).max() <= 1 << 23


@pytest.mark.parametrize("ht", [False, True])
def test_signed_int32_precision(ht):
    # samples in [-2^19, 2^19) need 20 signed bits; the JAX package takes
    # bit_length(max |x|) = 19 (go_jpeg2000_tpu/models/encoder.py:53-55), so
    # its lossless round trip loses the samples past 2^18; the port takes
    # the smallest width that holds every sample, and with precision=20
    # both give one stream
    image = _image((40, 48), 16, np.int32, -(1 << 19), 1 << 19)
    image[0, 0], image[0, 1] = 1 - (1 << 19), (1 << 19) - 1
    opts = _opts(high_throughput=ht)
    ref = jp2k.encode(image, opts)
    assert jp2k.decode_metadata(ref).components[0].precision == 19
    assert not np.array_equal(jp2k.decode(ref), image)
    ours = tp.encode(image, tp.options_from_reference(opts), device="cpu")
    meta = tp.decode_metadata(ours)
    assert meta.components[0].precision == 20 and meta.components[0].signed
    assert np.array_equal(tp.decode(ours, device="cpu"), image)
    opts20 = _opts(high_throughput=ht, precision=20)
    assert tp.encode(image, tp.options_from_reference(opts20),
                     device="cpu") == jp2k.encode(image, opts20) == ours


@pytest.mark.parametrize("lo,hi,want", [(-4, 4, (3, True)),
                                        (-5, 3, (4, True)),
                                        (-4, 5, (4, True)),
                                        (0, 1000, (10, False)),
                                        (0, 1, (1, False))])
def test_natural_precision_holds_every_sample(lo, hi, want):
    from go_jpeg2000_tpu.models import encoder as jenc
    from go_jpeg2000_tpu_torch.models import encoder
    image = np.arange(lo, hi, dtype=np.int32).reshape(1, -1)
    got = encoder._natural_precision(image, tp.Options())
    assert got == want
    bits, signed = got
    assert image.min() >= (-(1 << (bits - 1)) if signed else 0)
    assert image.max() < (1 << (bits - 1) if signed else 1 << bits)
    jax_bits, jax_signed = jenc._natural_precision(image, Options())
    if jax_signed == signed and (
            image.min() >= -(1 << (jax_bits - 1)) if signed else True) and (
            image.max() < (1 << (jax_bits - 1) if signed else 1 << jax_bits)):
        # where the JAX rule holds every sample, both give one width
        assert jax_bits == bits
