"""The port's tile-sharded pipeline (go_jpeg2000_tpu_torch.parallel) in one
process, against the JAX package's (go_jpeg2000_tpu.parallel.sharded, on the
8-device CPU mesh) and its single-device encoder.

Lossless codestreams must be byte-identical to the JAX encoder.encode (HT
through the device HT entropy, Part-1 and budgeted layers through the host
branch), and decode_sharded must give the image back.  Lossy 9/7 decodes
must agree within one grey level with the JAX decode_sharded of the same
stream, and the PSNR must be at least the JAX package's minus 0.05 dB (its
jitted float32 lifting may round differently, so a quantizer index can flip
at a step boundary).  The halo lifting of row shards down to 2 rows must
equal the port's unsharded lifting and the JAX dwt_multilevel_sharded
exactly (the JAX package's 9/7 within a relative 1e-5: its jitted
float32 program rounds a few steps otherwise), and the band statistics
the JAX step's (counts exact, sums within a relative 1e-5: float32 sums
in another order).  Shapes follow the JAX
package's dryrun_multichip: 2 decomposition levels, tiles 32 wide."""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import jax
from jax.sharding import PartitionSpec as P

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models import decoder as jdec
from go_jpeg2000_tpu.models import encoder as jenc
from go_jpeg2000_tpu.options import Format, Options
from go_jpeg2000_tpu.parallel import mesh as jmesh
from go_jpeg2000_tpu.parallel import sharded as jsh
from go_jpeg2000_tpu_torch.models import transforms
from go_jpeg2000_tpu_torch.ops import band_stats, dwt
from go_jpeg2000_tpu_torch.parallel import (decode_sharded, encode_sharded,
                                            sharded as psh)

LEVELS = 2
TILE = (32, 16)                  # (width, height): 16 = sp * 2^levels * 2


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8)


def _img(shape, seed, depth=8):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << depth, size=shape).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    return a.astype(np.uint8 if depth <= 8 else np.uint16)


def _opts(**kw):
    return Options(format=Format.J2K, num_resolutions=LEVELS + 1,
                   tile_size=TILE, **kw)


def _psnr(x, ref, peak=255.0):
    mse = np.mean((x.astype(np.float64) - ref) ** 2)
    return 10 * np.log10(peak ** 2 / mse) if mse else 99.0


DEVICE, HOST = "enc.sharded_device_ht_tiles", "enc.sharded_host_entropy_tiles"


@pytest.mark.parametrize("name,shape,depth,kw,branch", [
    ("ht gray", (32, 96), 8, dict(high_throughput=True), DEVICE),
    ("ht rgb16", (48, 64, 3), 16, dict(high_throughput=True), DEVICE),
    ("ht rgb16 layers budget", (32, 64, 3), 16,
     dict(high_throughput=True, num_layers=2, compression_ratio=6.0), HOST),
    ("part1", (32, 64, 3), 8, {}, HOST),
    ("part1 gray", (32, 96), 8, {}, HOST),
    ("part1 rgb16", (32, 64, 3), 16, {}, HOST),
    ("part1 layers budget", (32, 64, 3), 8,
     dict(num_layers=2, compression_ratio=6.0), HOST),
])
def test_lossless_matches_jax_encoder(name, shape, depth, kw, branch):
    img = _img(shape, seed=len(name), depth=depth)
    opts = _opts(lossless=True, **kw)
    tp.counters.reset()
    data = encode_sharded(img, tp.options_from_reference(opts),
                          device="cpu")
    n_tiles = (shape[0] // TILE[1]) * (shape[1] // TILE[0])
    assert tp.counters.snapshot().get(branch) == n_tiles
    assert data == jenc.encode(img, opts), name
    if kw.get("high_throughput") and "num_layers" not in kw:
        out = decode_sharded(data, device="cpu")
        assert out.dtype == img.dtype and np.array_equal(out, img)
        assert tp.counters.snapshot()["dec.sharded_device_ht_tiles"] \
            == n_tiles
    elif "compression_ratio" not in kw:
        assert np.array_equal(jdec.decode(data), img)


def test_lossy_matches_jax_sharded(mesh8):
    img = _img((16, 64, 3), seed=41)         # two tiles, two classes
    opts = _opts(lossless=False, quality=85, high_throughput=True)
    data = encode_sharded(img, tp.options_from_reference(opts),
                          device="cpu")
    ours = decode_sharded(data, device="cpu")
    theirs = jsh.decode_sharded(data, mesh8)
    assert np.max(np.abs(ours.astype(np.int32) - theirs)) <= 1
    jax_data = jsh.encode_sharded(img, mesh8, opts)
    assert _psnr(ours, img) >= _psnr(jdec.decode(jax_data), img) - 0.05


@pytest.mark.parametrize("kw", [dict(num_layers=2),
                                dict(compression_ratio=8.0)])
def test_lossy_layers_and_budget_against_jax_encoder(kw):
    """The combination the JAX package's own tests leave out: sharded lossy
    coding with layers or a byte budget (HT refinement passes, host
    branch), held to the JAX single-device encoder's PSNR."""
    img = _img((32, 96, 3), seed=43)
    opts = _opts(lossless=False, quality=85, high_throughput=True, **kw)
    tp.counters.reset()
    data = encode_sharded(img, tp.options_from_reference(opts),
                          device="cpu")
    assert tp.counters.snapshot()["enc.sharded_host_entropy_tiles"] == 6
    ref = jenc.encode(img, opts)
    if "compression_ratio" in kw:
        assert len(data) <= img.size // 8
    assert _psnr(jdec.decode(data), img) >= _psnr(jdec.decode(ref), img) \
        - 0.05


def _jax_pyramid(x, levels, kind, mesh):
    fn = jax.jit(jax.shard_map(
        lambda a: jsh.dwt_multilevel_sharded(a, levels, "sp", kind),
        mesh=mesh, in_specs=(P(None, "sp", None),),
        out_specs=P(None, "sp", None), check_vma=False))
    return [{k: np.asarray(v) for k, v in e.items()} for e in fn(x)]


def _split_pyramid(x, levels, kind, sp):
    """The port's halo lifting on sp row shards of x, in one process."""
    shards = list(torch.chunk(x, sp, dim=-2))
    out = []
    for lev in range(levels):
        bands = psh.forward_level_split(shards, kind)
        entry = {k: torch.cat([b[k] for b in bands], dim=-2)
                 for k in ("HL", "LH", "HH")}
        shards = [b["LL"].contiguous() for b in bands]
        if lev == levels - 1:
            entry["LL"] = torch.cat(shards, dim=-2)
        out.append(entry)
    return out


def _split_reconstruct(pyr, kind, sp):
    cur = list(torch.chunk(pyr[-1]["LL"], sp, dim=-2))
    for entry in reversed(pyr):
        split = {k: torch.chunk(entry[k], sp, dim=-2)
                 for k in ("HL", "LH", "HH")}
        bands = [dict(LL=cur[r], **{k: split[k][r].contiguous()
                                    for k in split}) for r in range(sp)]
        cur = psh.inverse_level_split(bands, kind)
    return torch.cat(cur, dim=-2)


@pytest.mark.parametrize("kind", [dwt.REV53, dwt.IRR97])
@pytest.mark.parametrize("sp", [2, 4])
def test_halo_lifting_matches_jax_and_unsharded(kind, sp):
    """sp = 4 at 2 levels of 16 rows: the last level's shards have 2 rows,
    fewer than the 9/7 lifting reaches."""
    rng = np.random.RandomState(sp)
    x = rng.randint(-300, 300, size=(3, 16, 36)).astype(np.int32)
    if kind == dwt.IRR97:
        x = x.astype(np.float32)
    xt = torch.from_numpy(x)
    ours = _split_pyramid(xt, LEVELS, kind, sp)
    whole = dwt.decompose(xt, LEVELS, kind)
    mesh = jmesh.make_mesh(8, dp=8 // sp, sp=sp)
    theirs = _jax_pyramid(x, LEVELS, kind, mesh)
    for o, w, t in zip(ours, whole, theirs):
        assert sorted(o) == sorted(w) == sorted(t)
        for k in o:
            assert torch.equal(o[k], w[k]), k
            if kind == dwt.REV53:
                np.testing.assert_array_equal(o[k].numpy(), t[k])
            else:
                # XLA's jitted float32 program rounds some steps otherwise
                # (a few ulps); the port's own lifting is exact above
                np.testing.assert_allclose(o[k].numpy(), t[k], rtol=1e-5,
                                           atol=1e-3)
    assert torch.equal(_split_reconstruct(whole, kind, sp),
                       dwt.reconstruct(whole, kind))


@pytest.mark.parametrize("kind", [dwt.REV53, dwt.IRR97])
def test_transform_step_and_band_stats_match_jax(kind, mesh8):
    rng = np.random.RandomState(7)
    batch = rng.randint(0, 256, size=(4, 3, 16, 32)).astype(np.uint8)
    batch[1, :, :8] = 128               # zeros after the DC shift
    step = jsh.make_tile_transform_step(mesh8, LEVELS, True, 8, False, kind)
    jpyr, jstats = step(batch)
    pyr, stats = psh.tile_transform_step(
        transforms.upload(batch, torch.device("cpu")), LEVELS, True, 8,
        False, kind)
    for e, je in zip(pyr, jpyr):
        for k in e:
            if kind == dwt.REV53:
                np.testing.assert_array_equal(e[k].numpy(), np.asarray(je[k]))
            else:
                np.testing.assert_allclose(e[k].numpy(), np.asarray(je[k]),
                                           rtol=1e-5, atol=1e-3)
    jstats = np.asarray(jstats)
    np.testing.assert_array_equal(stats[:, 1].numpy(), jstats[:, 1])
    np.testing.assert_allclose(stats[:, 0].numpy(), jstats[:, 0], rtol=1e-5)
    sums, counts = band_stats.band_stats(band_stats.leaves_of(pyr))
    assert sums.dtype == torch.float64 and counts.dtype == torch.int64
    assert counts.tolist() == jstats[:, 1].astype(np.int64).tolist()


def test_gates():
    img = _img((64, 64), seed=5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            encode_sharded(img, tp.options_from_reference(
                _opts(lossless=True, high_throughput=True)))
    with pytest.raises(ValueError):
        encode_sharded(img, tp.Options(format=tp.Format.J2K, lossless=True,
                                       num_resolutions=1), device="cpu")
    with pytest.raises(ValueError):
        # tile height 12 not divisible by 2^levels
        encode_sharded(img, tp.Options(format=tp.Format.J2K, lossless=True,
                                       num_resolutions=3, tile_size=(8, 12)),
                       device="cpu")
    with pytest.raises(ValueError):
        # the last column of tiles is narrower
        encode_sharded(_img((32, 48), seed=6), tp.options_from_reference(
            _opts(lossless=True)), device="cpu")
    # JP2 (refused before the encode options were ported) wraps the
    # codestream as the JAX package's encode does
    jp2 = Options(lossless=True, num_resolutions=3)
    assert encode_sharded(img, tp.options_from_reference(jp2),
                          device="cpu") == jenc.encode(img, jp2)
    ok = jenc.encode(img, _opts(lossless=True, high_throughput=True))
    with pytest.raises(ValueError):
        decode_sharded(ok, tp.Config(reduce_resolution=1), device="cpu")
    with pytest.raises(ValueError):
        decode_sharded(ok, tp.Config(decode_area=(0, 0, 16, 16)),
                       device="cpu")
    with pytest.raises(ValueError):
        decode_sharded(jenc.encode(img, Options(
            format=Format.J2K, lossless=True, num_resolutions=1,
            high_throughput=True)), device="cpu")
    # what the device HT decode refuses (Part-1, layers, SOP) takes the
    # host tile decode, as in the JAX package
    for host in (_opts(lossless=True),
                 _opts(lossless=True, high_throughput=True, num_layers=2),
                 _opts(lossless=True, high_throughput=True,
                       enable_sop=True)):
        tp.counters.reset()
        data = jenc.encode(img, host)
        assert np.array_equal(decode_sharded(data, device="cpu"),
                              jdec.decode(data))
        assert tp.counters.snapshot()["dec.sharded_host_tiles"] > 0
