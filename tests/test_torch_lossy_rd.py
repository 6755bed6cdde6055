"""Lossy 9/7 with PCRD, quality layers and byte budgets (BASELINE config 2)
through the port's encode, on the CPU: the JAX package's tests/test_lossy_rd.py
and test_lossy_fused.py at 256^2 and smaller.

Against OpenJPEG through Pillow at matched rates, gray at 10, 20 and 40:1
and RGB with the ICT at 20:1: the port's PSNR at least OpenJPEG's minus
0.05 dB for both (the JAX package's own RGB test allows 0.1).  Against the
JAX package's encode at the same options: decodes within one grey level of
the JAX stream's decode, PSNR at least its minus 0.05 dB, and the stream
inside the byte budget.  Also the budget fit (93-100% of the budget),
exact_rates, lossy HT refinement with MSE non-increasing in the layers
(the JAX decoder reads the port's stream at 1, 2 and 3 layers; the port
decodes whole streams only), lossy Part-1 on the tile-sharded path
(PSNR within 0.05 dB of encode, decode_sharded within one grey level of
decode), and CustomMCT against the JAX class."""
import io

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models import encoder as jenc
from go_jpeg2000_tpu.ops import mct as jmct
from go_jpeg2000_tpu.options import Config, Format, Options
from go_jpeg2000_tpu_torch.models.decoder import sniff_format
from go_jpeg2000_tpu_torch.ops import mct
from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded


def _img(shape, seed=0):
    """The JAX R-D tests' image: noise smoothed twice by three taps."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=shape).astype(np.float32)
    for ax in (0, 1):
        for _ in range(2):
            a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def _psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(peak * peak / mse) if mse else float("inf")


def _opj_psnr(img, ratio, nres, mct_on=None):
    """PSNR of OpenJPEG's irreversible encode at `ratio` (through Pillow)."""
    from PIL import Image, features
    if not features.check("jpg_2000"):
        pytest.skip("Pillow has no OpenJPEG")
    b = io.BytesIO()
    kw = {} if mct_on is None else {"mct": mct_on}
    Image.fromarray(img).save(b, format="JPEG2000", irreversible=True,
                              quality_mode="rates", quality_layers=[ratio],
                              num_resolutions=nres, **kw)
    arr = np.asarray(Image.open(io.BytesIO(b.getvalue())))
    return _psnr(arr, img), len(b.getvalue())


def _against_jax(img, opts):
    """The port's stream of `opts`, held to the JAX package's encode: its
    decode within one grey level, PSNR at least the JAX package's minus
    0.05 dB, inside the budget where the JAX stream is.  Returns (stream,
    the port's PSNR)."""
    ours = tp.encode(img, tp.options_from_reference(opts), device="cpu")
    ref = jp2k.encode(img, opts)
    got, want = tp.decode(ours, device="cpu"), jp2k.decode(ref)
    assert np.abs(got.astype(int) - want).max() <= 1
    p_ours = _psnr(got, img)
    assert p_ours >= _psnr(want, img) - 0.05
    if opts.compression_ratio > 1.0 and len(ref) <= img.size / \
            opts.compression_ratio:
        assert len(ours) <= img.size / opts.compression_ratio
    return ours, p_ours


@pytest.mark.parametrize("ratio", [10.0, 20.0, 40.0])
def test_matched_rate_psnr_vs_openjpeg_gray(ratio):
    img = _img((256, 256), 0)
    ours, p_ours = _against_jax(img, Options(
        format=Format.J2K, lossless=False, quality=98, num_resolutions=6,
        num_layers=1, compression_ratio=ratio, backend="native"))
    assert len(ours) <= int(img.size / ratio)
    p_opj, n_opj = _opj_psnr(img, ratio, 6)
    assert len(ours) <= n_opj * 1.05
    assert p_ours >= p_opj - 0.05, (ratio, p_ours, p_opj)


def test_matched_rate_psnr_vs_openjpeg_rgb_ict():
    img = _img((256, 256, 3), 1)
    ratio = 20.0
    ours, p_ours = _against_jax(img, Options(
        format=Format.JP2, lossless=False, quality=98, num_resolutions=5,
        num_layers=3, compression_ratio=ratio, backend="native"))
    # the budget holds the codestream; the JP2 boxes come on top
    assert len(sniff_format(ours)[1]) <= int(img.size / ratio)
    # OpenJPEG through Pillow uses no MCT unless told: match the ICT
    p_opj, _n = _opj_psnr(img, ratio, 5, mct_on=1)
    assert p_ours >= p_opj - 0.05, (p_ours, p_opj)


def test_budget_fit_uses_budget():
    img = _img((256, 256), 3)
    ratio = 16.0
    ours, _p = _against_jax(img, Options(
        format=Format.J2K, lossless=False, quality=98, num_resolutions=6,
        num_layers=1, compression_ratio=ratio, backend="native"))
    budget = int(img.size / ratio)
    assert budget * 0.93 <= len(ours) <= budget


def test_exact_rates_option_still_valid():
    img = _img((128, 128), 5)
    common = dict(format=Format.J2K, lossless=False, quality=98,
                  num_resolutions=5, num_layers=2, compression_ratio=12.0,
                  backend="native")
    fast, p_fast = _against_jax(img, Options(**common))
    exact, p_exact = _against_jax(img, Options(exact_rates=True, **common))
    assert p_exact >= p_fast - 0.1, (p_fast, p_exact)
    assert p_fast >= p_exact - 0.5, (p_fast, p_exact)
    budget = img.size // 12
    assert len(fast) <= budget and len(exact) <= budget


def _nat(h, w, seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, (h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    return a.astype(np.uint8)


HT85 = Options(format=Format.J2K, lossless=False, quality=85,
               num_resolutions=4, high_throughput=True)


def test_lossy_fused_encode_engages_and_matches_host_quality():
    frames = [_nat(128, 128, i) for i in range(2)]
    tp.counters.reset()
    dev = tp.encode_batch(frames, tp.options_from_reference(HT85),
                          device="cpu")
    assert tp.counters.snapshot().get("enc.fused_chunks", 0) > 0
    for d, f in zip(dev, frames):
        host, p_host = _against_jax(f, HT85)
        assert abs(len(d) - len(host)) <= max(64, 0.02 * len(host))
        p_dev = _psnr(tp.decode(d, device="cpu"), f)
        assert abs(p_dev - p_host) < 0.05, (p_dev, p_host)
        assert p_dev > 40


def test_lossy_budgeted_ratio_batch_and_single():
    # layers with a budget turn HT refinement on: the chunked host branch
    # of encode_batch (one PCRD pass), and encode's budget fit
    img = _nat(128, 128, 11)
    opts = Options(format=Format.J2K, lossless=False, quality=95,
                   num_resolutions=5, high_throughput=True,
                   compression_ratio=10.0, num_layers=2)
    tp.counters.reset()
    data = tp.encode_batch([img], tp.options_from_reference(opts),
                           device="cpu")[0]
    assert tp.counters.snapshot().get("enc.host_entropy_frames", 0) == 1
    ref = jenc.encode_batch([img], opts)[0]
    got, want = tp.decode(data, device="cpu"), jp2k.decode(ref)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert _psnr(got, img) >= _psnr(want, img) - 0.05
    assert len(data) <= img.size / 10 * 1.35
    _host, p_host = _against_jax(img, opts)
    assert abs(_psnr(got, img) - p_host) < 0.5


def test_lossy_ht_refined_layers_rd():
    img = _nat(128, 128, 7)
    opts = Options(format=Format.J2K, lossless=False, num_resolutions=4,
                   high_throughput=True, ht_refinement=True,
                   backend="native", num_layers=3, compression_ratio=4.0)
    data, _p = _against_jax(img, opts)
    mses = [float(((jp2k.decode(data, Config(quality_layers=ql))
                    .astype(np.float64) - img) ** 2).mean())
            for ql in (1, 2, 3)]
    assert mses[2] <= mses[1] <= mses[0]
    assert mses[2] < mses[0] or mses[0] == 0.0
    assert np.array_equal(tp.decode(data, device="cpu"), jp2k.decode(data))


@pytest.mark.parametrize("kw", [dict(), dict(num_layers=2,
                                             compression_ratio=8.0)],
                         ids=["one_layer", "layers_budget"])
def test_sharded_lossy97_ebcot(kw):
    img = _nat(128, 128, 32)
    opts = tp.Options(format=tp.Format.J2K, lossless=False, quality=85,
                      num_resolutions=3, tile_size=(64, 64),
                      high_throughput=False, **kw)
    tp.counters.reset()
    data = encode_sharded(img, opts, device="cpu")
    assert tp.counters.snapshot()["enc.sharded_host_entropy_tiles"] == 4
    dec_g = tp.decode(data, device="cpu")
    dec_si = tp.decode(tp.encode(img, opts, device="cpu"), device="cpu")
    assert abs(_psnr(dec_g, img) - _psnr(dec_si, img)) <= 0.05
    out = decode_sharded(data, device="cpu")
    assert np.max(np.abs(out.astype(np.int32) - dec_g.astype(np.int32))) <= 1


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_custom_mct_matches_jax(n):
    rng = np.random.RandomState(n)
    m = rng.uniform(-1, 1, size=(n, n)) + np.eye(n) * 2
    ours, theirs = mct.CustomMCT(m), jmct.CustomMCT(m)
    comps = rng.uniform(-100, 100, size=(n, 8, 8)).astype(np.float32)
    out = ours.forward(torch.from_numpy(comps))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(theirs.forward(comps)),
                               rtol=1e-5, atol=1e-4)
    back = ours.backward(out)
    np.testing.assert_allclose(back.numpy(), comps, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("matrix", [np.zeros((3, 3)), np.zeros((2, 3))],
                         ids=["singular", "non_square"])
def test_custom_mct_rejects(matrix):
    for cls in (mct.CustomMCT, jmct.CustomMCT):
        with pytest.raises(ValueError):
            cls(matrix)
