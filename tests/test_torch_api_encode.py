"""The port's single-image encode (go_jpeg2000_tpu_torch.encode, on the CPU)
against the JAX package's go_jpeg2000_tpu.encode, on images made from a seed
at small sizes (at most 96x80, tiles of 32).

Lossless: codestreams byte-identical to the JAX package's, for one tile and
tile grids, gray and RGB, HTJ2K and Part-1, with tile and image offsets,
quality layers and compression_ratio budgets, J2K and JP2, and the port's
decode equal to the JAX package's, and to the input where no budget
truncates the stream.  Lossy 9/7 at one layer: bytes equal where
the JAX package's float32 lifting rounds as torch's does, else decodes within
one grey level and a PSNR at least the JAX package's minus 0.05 dB.  An odd
image offset gives levels at odd origins and sizes, which the CUDA level
kernels take too (dwt_cuda.usable refuses none; the card would count a
refused level in PLAIN_LEVELS).  encode_batch
hands uneven frames to encode, as the JAX package does; the encode
options (styles, markers, POC, the python backend, other precisions,
signed samples, four components) give the JAX package's bytes."""
import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.options import Format, Options, ProgressionOrder
from go_jpeg2000_tpu_torch.models import transforms
from go_jpeg2000_tpu_torch.ops import dwt_cuda

J2K = dict(format=Format.J2K, num_resolutions=3)


def _image(shape, seed, dtype=np.uint8, bits=None):
    """Smooth noise, as bench.py's natural_image makes it."""
    rng = np.random.RandomState(seed)
    hi = 1 << bits if bits else np.iinfo(dtype).max + 1
    a = rng.randint(0, hi, size=shape).astype(np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(dtype)


def _psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(peak ** 2 / mse)


LOSSLESS = {
    "ht_gray_tiles": ((64, 80), dict(high_throughput=True,
                                     tile_size=(32, 32))),
    "ht_rgb_tiles": ((64, 48, 3), dict(high_throughput=True,
                                       tile_size=(32, 32))),
    "part1_gray_tiles": ((64, 80), dict(tile_size=(32, 32))),
    "part1_rgb_tiles": ((48, 64, 3), dict(tile_size=(32, 32))),
    "ht_offsets": ((60, 50), dict(high_throughput=True, tile_size=(32, 32),
                                  tile_offset=(5, 1), image_offset=(7, 3))),
    "part1_rgb_offsets": ((40, 45, 3), dict(tile_size=(32, 32),
                                            tile_offset=(2, 3),
                                            image_offset=(3, 5))),
    "ht_layers2": ((64, 64), dict(high_throughput=True, num_layers=2,
                                  tile_size=(32, 32))),
    "ht_layers3_rgb": ((48, 48, 3), dict(high_throughput=True,
                                         num_layers=3)),
    "part1_layers3": ((64, 48), dict(num_layers=3, tile_size=(32, 32))),
    "ht_ratio": ((64, 64), dict(high_throughput=True, compression_ratio=3.0,
                                tile_size=(32, 32))),
    "part1_ratio": ((64, 64), dict(compression_ratio=3.0)),
    "part1_layers_ratio": ((64, 64, 3), dict(num_layers=2,
                                             compression_ratio=4.0,
                                             tile_size=(32, 32))),
    "ht_layers_ratio_rpcl": ((64, 64), dict(
        high_throughput=True, num_layers=2, compression_ratio=2.5,
        progression_order=ProgressionOrder.RPCL)),
    "part1_exact_rates": ((48, 48), dict(num_layers=2, exact_rates=True)),
    "jp2_ht_rgb": ((48, 64, 3), dict(high_throughput=True,
                                     tile_size=(32, 32),
                                     format=Format.JP2)),
    "jp2_part1_comment": ((40, 40), dict(format=Format.JP2,
                                         comment="port")),
    "ht_plt_16bit": ((48, 40), dict(high_throughput=True, enable_plt=True,
                                    tile_size=(32, 32))),
    "part1_12bit": ((64, 48), dict(precision=12, tile_size=(32, 32))),
}


@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_lossless_encode_matches_jax(name):
    shape, kw = LOSSLESS[name]
    dtype, bits = np.uint8, None
    if "16bit" in name:
        dtype = np.uint16
    if "12bit" in name:
        dtype, bits = np.uint16, 12
    image = _image(shape, seed=len(name), dtype=dtype, bits=bits)
    opts = Options(**{**J2K, "lossless": True, **kw})
    ours = tp.encode(image, tp.options_from_reference(opts), device="cpu")
    assert ours == jp2k.encode(image, opts)
    got = tp.decode(ours, device="cpu")
    want = jp2k.decode(ours)
    assert got.dtype == image.dtype and np.array_equal(got, want)
    # a byte budget truncates: exact only where the stream holds every pass
    assert np.array_equal(want, image) == (opts.compression_ratio <= 1.0)


LOSSY = {
    "ht_gray": ((64, 80), dict(high_throughput=True)),
    "ht_rgb_tiles": ((64, 64, 3), dict(high_throughput=True,
                                       tile_size=(32, 32))),
    "part1_gray_tiles": ((80, 64), dict(tile_size=(32, 32), quality=60)),
    "part1_rgb": ((48, 64, 3), dict(quality=90)),
    "part1_rgb_offsets": ((45, 40, 3), dict(tile_size=(32, 32),
                                            image_offset=(3, 1))),
}


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_lossy_encode_agrees_with_jax(name):
    shape, kw = LOSSY[name]
    image = _image(shape, seed=len(name) + 40)
    opts = Options(**{**J2K, "lossless": False, **kw})
    ours = tp.encode(image, tp.options_from_reference(opts), device="cpu")
    ref = jp2k.encode(image, opts)
    decodes = [tp.decode(ours, device="cpu"), tp.decode(ref, device="cpu"),
               jp2k.decode(ours), jp2k.decode(ref)]
    for d in decodes:
        assert d.shape == image.shape and d.dtype == image.dtype
        assert np.abs(d.astype(int) - decodes[3]).max() <= 1
    assert _psnr(decodes[0], image) >= _psnr(decodes[3], image) - 0.05
    if ours == ref:
        assert np.array_equal(decodes[0], decodes[3])


def test_default_options_encode_and_decode():
    # Options(): JP2, lossy Part-1 9/7, quality 75, one tile
    image = _image((72, 80, 3), seed=3)
    ours = tp.encode(image, device="cpu")
    assert ours[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    ref = jp2k.encode(image)
    got, want = tp.decode(ours, device="cpu"), jp2k.decode(ref)
    assert got.shape == image.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    assert _psnr(got, image) >= _psnr(want, image) - 0.05
    assert tp.decode_metadata(ours).format == tp.Format.JP2


def test_odd_offsets_take_plain_levels(monkeypatch):
    # the level kernels take every level at any origin and size: at image
    # offset (7, 3) the tiles' levels have odd origins and sizes, and none
    # is refused (none would lift plain, or count in PLAIN_LEVELS, on the
    # card), as at offset (0, 0)
    seen = []
    shapes = []
    fwd, inv = transforms.forward_level, transforms.inverse_level

    def spy_fwd(x, kind, u0, v0, above=None, below=None):
        seen.append(dwt_cuda.usable(*x.shape[-2:], u0, v0, kind))
        shapes.append(tuple(x.shape[-2:]) + (u0, v0))
        return fwd(x, kind, u0, v0, above, below)

    def spy_inv(bands, kind, u0, v0, above=None, below=None):
        h = bands["LL"].shape[-2] + bands["LH"].shape[-2]
        w = bands["LL"].shape[-1] + bands["HL"].shape[-1]
        seen.append(dwt_cuda.usable(h, w, u0, v0, kind, inverse=True))
        return inv(bands, kind, u0, v0, above, below)

    monkeypatch.setattr(transforms, "forward_level", spy_fwd)
    monkeypatch.setattr(transforms, "inverse_level", spy_inv)
    image = _image((64, 64), seed=8)
    for offset, odd in (((0, 0), False), ((7, 3), True)):
        seen.clear()
        shapes.clear()
        opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                       high_throughput=True, tile_size=(32, 32),
                       image_offset=offset)
        data = tp.encode(image, tp.options_from_reference(opts),
                         device="cpu")
        assert data == jp2k.encode(image, opts)
        assert np.array_equal(tp.decode(data, device="cpu"), image)
        assert seen and all(seen)
        assert any(h & 1 or w & 1 or u & 1 or v & 1
                   for h, w, u, v in shapes) == odd


def test_encode_batch_uneven_shapes_go_one_by_one():
    frames = [_image((32, 40), 1), _image((48, 32), 2), _image((32, 40), 3)]
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                   high_throughput=True)
    popts = tp.options_from_reference(opts)
    tp.counters.reset()
    got = tp.encode_batch(frames, popts, device="cpu")
    assert tp.counters.snapshot().get("enc.fused_chunks", 0) == 0
    assert got == [tp.encode(f, popts, device="cpu") for f in frames]
    assert got == [jp2k.encode(f, opts) for f in frames]
    tiled = dataclasses.replace(popts, tile_size=(16, 16))
    assert tp.encode_batch(frames[:1], tiled, device="cpu") == \
        [tp.encode(frames[0], tiled, device="cpu")]


@pytest.mark.parametrize("override,item", [
    # (each case named the ROADMAP item it raised with before it was
    # ported: 7 for lossy layers, budgets and HT refinement, 6b for the
    # rest) every case now matches the JAX package's encode: the bytes for
    # lossless, decodes within one grey level for lossy
    (dict(lossless=False, num_layers=2), None),
    (dict(lossless=False, compression_ratio=8.0), None),
    (dict(lossless=False, high_throughput=True, ht_refinement=True), None),
    (dict(code_block_style=1), "6b"),
    (dict(enable_sop=True), "6b"), (dict(enable_eph=True), "6b"),
    (dict(enable_ppm=True), "6b"), (dict(enable_ppt=True), "6b"),
    (dict(enable_tlm=True), "6b"),
    (dict(progression_changes=[(0, 0, 1, 3, 1, 0)]), "6b"),
    (dict(backend="python"), "6b"), (dict(precision=6), "6b")])
def test_encode_outside_slice_raises(override, item):
    opts = dataclasses.replace(
        tp.Options(format=tp.Format.J2K, lossless=True, num_resolutions=3),
        **override)
    image = _image((32, 32), 0)
    if override.get("precision"):
        image = _image((32, 32), 0, bits=override["precision"])
    ours = tp.encode(image, opts, device="cpu")
    ref = jp2k.encode(image, dataclasses.replace(
        Options(format=Format.J2K, lossless=True, num_resolutions=3),
        **override))
    got, want = tp.decode(ours, device="cpu"), jp2k.decode(ref)
    if opts.lossless:
        assert ours == ref
        assert np.array_equal(got, image)
        return
    budget = image.size / max(opts.compression_ratio, 1.0)
    if len(ref) <= budget:     # 32x32 at 8:1: the headers overshoot
        assert len(ours) <= budget
    assert np.abs(got.astype(int) - want).max() <= 1
    assert _psnr(got, image) >= _psnr(want, image) - 0.05


@pytest.mark.parametrize("image", [
    (_image((16, 16), 4).astype(np.int16) - 128) * 100,
    _image((16, 16, 4), 5)])
def test_encode_refuses_signed_and_four_components(image):
    # (named for the refusal it held before signed samples and any number
    # of components were ported) both give the JAX package's bytes and
    # decode exactly
    opts = tp.Options(format=tp.Format.J2K, lossless=True)
    ours = tp.encode(image, opts, device="cpu")
    assert ours == jp2k.encode(image, Options(format=Format.J2K,
                                              lossless=True))
    got = tp.decode(ours, device="cpu")
    assert got.dtype == image.dtype and np.array_equal(got, image)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    image = _image((16, 16), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.encode(image)
    data = tp.encode(image, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.decode(data)
