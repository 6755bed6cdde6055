"""The hand-written CUDA kernels (go_jpeg2000_tpu_torch/csrc/dwt53.cu,
dwt97.cu, ht_enc.cu, ht_dec.cu, ebcot_enc.cu, band_stats.cu, mct.cu) against their
plain torch versions, on the card; the DWT level kernels also in their halo
form on row shards down to 2 rows, against the unsharded level.
Needs a CUDA device and nvcc; skips without a card.  Imports neither jax
nor the JAX package, so it runs where only torch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact equality, for 9/7 too (the kernel rounds the plain
version's float32 ops in the same order, without FMA contraction), and for
every output of the HT encode kernels, the distortion's float32 bits too
(both versions sum float32 squares in float64 and round once).  The fused
cleanup-and-pack kernel's words, bits and meta are equal at every legal
code-block shape, on ragged and odd true sizes, all-zero blocks, 30-bit
magnitudes, rows filled exactly at max_mn, rows of a width off 4 words
and more quad pairs than one round, and encode_pyramid's pool of a batch
and of a class read in place; all four DWT level kernels are
exact at any even width, the inverse 5/3 in its halo form too, and at
every origin parity on 1-sample, 3-sample, odd and 1080p shapes (one
launch each, no plain level; an empty level launches nothing); the edge
packing kernel's slots equal the plain version's.  The HT
decode kernels' outputs are equal bit for bit, float32 leaves too.  The
EBCOT kernels' slots, decision pools, MQ segments and lengths are equal
exactly (MQ segments also to the native coder's), on the MQ stress
streams of ops/mq_device.py too; the decision pools also on
ebcot_cuda.compact_stress_slots at two slot alignments; the two pool
compactions (ht_compact_pool, ebcot_pool_rows) also on their stress sets
(ht_enc_cuda.pool_stress_cases, ebcot_cuda.pool_stress_rows) with the
rows off a 16-byte boundary; the decision
slots also on ebcot_device.stress_blocks and the MagSgn blocks on
ht_dec.stress_cases; the block extraction and the assembly also on
block_layout.layout_stress_cases (leaves off 16 bytes), and neither
wrapper makes a synchronizing call after a plan's first.  The band
statistics' counts are equal, their float64 sums within a relative 1e-12 (the order of
the atomics varies).  The colour head and tail (csrc/mct.cu: mct_forward,
mct_inverse) equal transforms.coefficients_plain and samples_plain on the
card bit for bit, float32 too, over every sample dtype, precisions 1-31,
1, 3 and 4 components, with and without RCT/ICT, narrowed and not, on
rows off 16 bytes, single pixels and a row shard's view, and the tail on
floats past int32 and NaN (where the plain version on the card saturates
and gives 0 for NaN, and on the CPU gives INT_MIN: a difference of
torch's, left as it is).  The tile-sharded encode and decode give the
CPU's bytes and pixels."""
import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu_torch.models import (decoder, ebcot_fused, encoder,
                                          fused_encode, transforms)
from go_jpeg2000_tpu_torch.native import loader
from go_jpeg2000_tpu_torch.ops import (block_layout, dwt, dwt_cuda,
                                       ebcot_cuda, ebcot_device, ht_dec,
                                       ht_dec_cuda, ht_enc, ht_enc_cuda,
                                       mct_cuda, mq_device)
from go_jpeg2000_tpu_torch.tcd import geometry as geo

BANDS = ("LL", "HL", "LH", "HH")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 512, 512), (32, 32, 32), (3, 2, 2),
                                   (2, 6, 10), (1, 2048, 2048),
                                   (2, 18, 34)])
def test_kernels_match_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    x = torch.randint(-40000, 40000, shape, generator=g, device=cuda,
                      dtype=torch.int32)
    before = dict(dwt_cuda.LAUNCHES)
    got = dwt_cuda.forward_2d_53(x)
    ref = dwt.forward_2d(x, dwt.REV53)
    for k in BANDS:
        assert torch.equal(got[k], ref[k]), k
    rec = dwt_cuda.inverse_2d_53(got)
    assert torch.equal(rec, dwt.inverse_2d(ref, dwt.REV53))
    assert torch.equal(rec, x)
    torch.cuda.synchronize()
    assert dwt_cuda.LAUNCHES["dwt53_fwd_level"] == \
        before["dwt53_fwd_level"] + 1
    assert dwt_cuda.LAUNCHES["dwt53_inv_level"] == \
        before["dwt53_inv_level"] + 1


@pytest.mark.cuda
def test_codec_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
              for _ in range(2)]
    opts = tp.Options(format=tp.Format.J2K, lossless=True,
                      high_throughput=True, num_resolutions=6)
    dwt_cuda.reset_counts()
    on_card = tp.encode_batch(frames, opts, device=cuda)
    decoded = tp.decode_batch(on_card, device=cuda)
    assert dwt_cuda.LAUNCHES["dwt53_fwd_level"] > 0
    assert dwt_cuda.LAUNCHES["dwt53_inv_level"] > 0
    assert on_card == tp.encode_batch(frames, opts, device="cpu")
    assert all(np.array_equal(d, f) for d, f in zip(decoded, frames))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 512, 512), (3, 2, 2), (2, 4, 8),
                                   (2, 6, 10), (1, 10, 6), (2, 34, 18),
                                   (1, 2048, 2048)])
def test_97_kernels_match_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    x = torch.randn(shape, generator=g, device=cuda) * 200
    before = dict(dwt_cuda.LAUNCHES)
    got = dwt_cuda.forward_2d_97(x)
    ref = dwt.forward_2d(x, dwt.IRR97)
    for k in BANDS:
        assert torch.equal(got[k], ref[k]), k
    rec = dwt_cuda.inverse_2d_97(got)
    assert torch.equal(rec, dwt.inverse_2d(ref, dwt.IRR97))
    assert float((rec - x).abs().max()) < 1e-3 * 200
    torch.cuda.synchronize()
    assert dwt_cuda.LAUNCHES["dwt97_fwd_level"] == \
        before["dwt97_fwd_level"] + 1
    assert dwt_cuda.LAUNCHES["dwt97_inv_level"] == \
        before["dwt97_inv_level"] + 1


@pytest.mark.cuda
def test_lossy_codec_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
              for _ in range(2)]
    opts = tp.Options(format=tp.Format.J2K, lossless=False, quality=85,
                      high_throughput=True, num_resolutions=6)
    dwt_cuda.reset_counts()
    on_card = tp.encode_batch(frames, opts, device=cuda)
    decoded = tp.decode_batch(on_card, device=cuda)
    assert dwt_cuda.LAUNCHES["dwt97_fwd_level"] > 0
    assert dwt_cuda.LAUNCHES["dwt97_inv_level"] > 0
    assert dwt_cuda.PLAIN_LEVELS == 0
    assert on_card == tp.encode_batch(frames, opts, device="cpu")
    on_cpu = tp.decode_batch(on_card, device="cpu")
    assert all(np.array_equal(d, c) for d, c in zip(decoded, on_cpu))


# shapes [N, H, W] of the parity tests: 1-sample axes, 3-sample axes,
# tile- and strip-crossing odd sizes, an odd-sized 1080p frame and the
# 1080p batch's level 4
PARITY_SHAPES = [(3, 1, 1), (2, 1, 9), (2, 9, 1), (2, 3, 3), (2, 35, 63),
                 (1, 1079, 1919), (24, 135, 240)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [dwt.REV53, dwt.IRR97])
@pytest.mark.parametrize("pu,pv", [(0, 0), (1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("shape", PARITY_SHAPES)
def test_level_kernels_every_parity(cuda, shape, pu, pv, kind):
    """All four level kernels at origin (4 + pu, 2 + pv), through
    transforms.forward_level and inverse_level: one launch each, no plain
    level, equal to the plain lifting bit for bit (9/7 too) at the band
    sizes of dwt.subband_shapes."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 2 * pu + pv)
    if kind == dwt.REV53:
        x = torch.randint(-(1 << 20), 1 << 20, shape, generator=g,
                          device=cuda, dtype=torch.int32)
    else:
        x = torch.randn(shape, generator=g, device=cuda) * 200
    lib = "dwt53" if kind == dwt.REV53 else "dwt97"
    u0, v0 = 4 + pu, 2 + pv
    dwt_cuda.reset_counts()
    got = transforms.forward_level(x, kind, u0, v0)
    ref = {k: v.contiguous()
           for k, v in dwt.forward_2d(x, kind, u0=u0, v0=v0).items()}
    shapes = dwt.subband_shapes(shape[1], shape[2], 1, u0, v0)[0]
    for k in BANDS:
        assert tuple(got[k].shape) == (shape[0],) + shapes[k], k
        assert torch.equal(got[k], ref[k]), k
    rec = transforms.inverse_level(ref, kind, u0, v0)
    assert torch.equal(rec, dwt.inverse_2d(ref, kind, u0=u0, v0=v0))
    if kind == dwt.REV53:
        assert torch.equal(rec, x)
    torch.cuda.synchronize()
    assert dwt_cuda.LAUNCHES[f"{lib}_fwd_level"] == 1
    assert dwt_cuda.LAUNCHES[f"{lib}_inv_level"] == 1
    assert dwt_cuda.PLAIN_LEVELS == 0


@pytest.mark.cuda
def test_level_kernels_parity_empty_levels(cuda):
    """A level with an empty axis (a 1-column tile at an odd origin gives
    its next level 0 columns) launches nothing and lifts nothing plain."""
    for kind, dtype in ((dwt.REV53, torch.int32), (dwt.IRR97, torch.float32)):
        x = torch.zeros((2, 5, 0), dtype=dtype, device=cuda)
        dwt_cuda.reset_counts()
        got = transforms.forward_level(x, kind, 1, 1)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            "LL": (2, 2, 0), "HL": (2, 2, 0), "LH": (2, 3, 0),
            "HH": (2, 3, 0)}
        assert tuple(transforms.inverse_level(got, kind, 1, 1).shape) == \
            (2, 5, 0)
        assert sum(dwt_cuda.LAUNCHES.values()) == 0
        assert dwt_cuda.PLAIN_LEVELS == 0


@pytest.mark.cuda
@pytest.mark.parametrize("lossless", [True, False])
def test_reduced_decode_odd_offsets_on_card_matches_cpu(cuda, lossless):
    """A stream at image offset (3, 5) and tile offset (1, 2) (odd level
    origins and sizes on every tile) decoded on the card at
    reduce_resolution 0, 1 and 2: equal to the CPU run, every level
    through the inverse kernels, none plain."""
    rng = np.random.RandomState(11)
    img = rng.randint(0, 256, (75, 61)).astype(np.uint8)
    opts = tp.Options(format=tp.Format.J2K, lossless=lossless, quality=85,
                      high_throughput=True, num_resolutions=4,
                      image_offset=(3, 5), tile_offset=(1, 2),
                      tile_size=(32, 32))
    data = tp.encode(img, opts, device="cpu")
    for r in (0, 1, 2):
        cfg = tp.Config(reduce_resolution=r)
        got, launched, plain = _plain_levels_after(
            lambda: tp.decode(data, cfg, device=cuda))
        assert np.array_equal(got, tp.decode(data, cfg, device="cpu")), r
        assert launched > 0 and plain == 0
    if lossless:
        assert np.array_equal(tp.decode(data, device=cuda), img)


API_CASES = {
    # (image shape, dtype, options, the level kernels that take every
    # level, at odd tile origins and sizes too)
    "ht_tiles_layers": ((96, 128, 3), np.uint8, tp.Options(
        format=tp.Format.J2K, lossless=True, high_throughput=True,
        num_layers=3, tile_size=(64, 64)), "dwt53"),
    "part1_budget": ((128, 96), np.uint16, tp.Options(
        format=tp.Format.J2K, lossless=True, num_layers=2,
        compression_ratio=6.0, precision=12, tile_size=(64, 64)),
        "dwt53"),
    "defaults": ((96, 128, 3), np.uint8, tp.Options(), "dwt97"),
    "odd_offsets": ((100, 75), np.uint8, tp.Options(
        format=tp.Format.J2K, lossless=True, image_offset=(7, 3),
        tile_offset=(5, 1), tile_size=(32, 32)), "dwt53"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(API_CASES))
def test_single_image_api_on_card_matches_cpu(cuda, case):
    shape, dtype, opts, kernel = API_CASES[case]
    rng = np.random.RandomState(3)
    hi = 1 << 12 if dtype == np.uint16 else 256
    image = rng.randint(0, hi, shape).astype(dtype)
    dwt_cuda.reset_counts()
    on_card = tp.encode(image, opts, device=cuda)
    decoded = tp.decode(on_card, device=cuda)
    assert dwt_cuda.LAUNCHES[f"{kernel}_fwd_level"] > 0
    assert dwt_cuda.LAUNCHES[f"{kernel}_inv_level"] > 0
    assert dwt_cuda.PLAIN_LEVELS == 0
    assert on_card == tp.encode(image, opts, device="cpu")
    assert np.array_equal(decoded, tp.decode(on_card, device="cpu"))
    if opts.lossless and opts.compression_ratio <= 1.0:
        assert np.array_equal(decoded, image)


def _block_batch(frames, lossless, dev):
    """The plan and the pyramid of frames on `dev`, as the fused encode
    builds them."""
    opts = tp.Options(format=tp.Format.J2K, lossless=lossless, quality=85,
                      high_throughput=True, num_resolutions=6)
    header = encoder.build_header(frames[0], opts)
    nc = header.num_components
    prec = header.components[0].precision
    encoder._apply_comp_quants(header, opts, nc, prec)
    tile = geo.build_tile(header, 0)
    plan = fused_encode.plan_for(header, tile, lossy=not lossless)
    batch = np.stack([np.stack(encoder._image_components(f))
                      for f in frames])
    pyr = transforms.forward_pyramid(
        transforms.upload(batch, dev), 5,
        dwt.REV53 if lossless else dwt.IRR97, nc >= 3, prec, False, 0, 0)
    return plan, pyr


def _case_frames(case):
    """Three frames of one of the HT kernel cases."""
    rng = np.random.RandomState(len(case))
    shape, dtype = {"gray": ((256, 256), np.uint8),
                    "ragged": ((96, 80), np.uint8),
                    "rgb16": ((128, 96, 3), np.uint16),
                    "noise": ((128, 128), np.uint8),
                    "zeros": ((64, 64), np.uint8)}[case]
    hi = 1 if case == "zeros" else np.iinfo(dtype).max + 1
    return [rng.randint(0, hi, shape).astype(dtype) for _ in range(3)]


HT_CASES = ["gray", "ragged", "rgb16", "noise", "zeros"]


@pytest.mark.cuda
@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("case", HT_CASES)
def test_ht_kernels_match_plain(cuda, case, lossless):
    frames = _case_frames(case)
    plan, pyr = _block_batch(frames, lossless, cuda)
    before = dict(ht_enc_cuda.LAUNCHES)
    blocks = ht_enc_cuda.extract_blocks(pyr, plan, 3, 5)
    assert torch.equal(blocks, fused_encode.extract_blocks(pyr, plan, 3, 5))
    hs, ws = fused_encode._block_dims(plan, 3, cuda)
    got = ht_enc_cuda.cleanup_fields(blocks, hs, ws, plan.max_mn)
    ref = ht_enc.cleanup_fields(blocks, hs, ws, plan.max_mn)
    _outputs_equal(got, ref)
    args = [ref[k] for k in ("ms_words", "ms_bits", "vlc_words", "vlc_bits",
                             "mel_words", "mel_bits", "numbps", "u_max",
                             "dist")]
    out, totals = ht_enc_cuda.assemble_pool(*args)
    rout, rtotals = ht_enc.assemble_pool(*args)
    assert torch.equal(totals, rtotals)
    assert torch.equal(out[:rout.numel()], rout)
    torch.cuda.synchronize()
    for k, n in (("ht_extract_blocks", 1), ("ht_cleanup_pack", 1),
                 ("ht_compact_pool", 1)):
        assert ht_enc_cuda.LAUNCHES[k] == before[k] + n, k


def _outputs_equal(got, ref):
    """Every output of the cleanup pass equal bit for bit, the distortion's
    float32 bits too."""
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert torch.equal(got[k].view(torch.int32),
                           ref[k].view(torch.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("tiles", [None, [2, 0]], ids=["batch", "class"])
def test_encode_pyramid_pool_matches_plain(cuda, tiles, lossless):
    """The whole device pool of encode_pyramid (extraction, the fused
    cleanup and packing, the pool compaction), of the batch and of a
    class of its frames read in place, against ht_enc.cleanup_fields_compact
    of the plain extraction."""
    plan, pyr = _block_batch(_case_frames("gray"), lossless, cuda)
    n = 3 if tiles is None else len(tiles)
    before = dict(ht_enc_cuda.LAUNCHES)
    out, totals = fused_encode.encode_pyramid(pyr, plan, n, 5, tiles=tiles)
    blocks = fused_encode.extract_blocks(pyr, plan, n, 5, tiles)
    hs, ws = fused_encode._block_dims(plan, n, cuda)
    ref, rtotals = ht_enc.cleanup_fields_compact(blocks, hs, ws, plan.max_mn)
    assert torch.equal(totals, rtotals)
    assert torch.equal(out[:ref.numel()], ref)
    torch.cuda.synchronize()
    for k in ("ht_extract_blocks", "ht_cleanup_pack", "ht_compact_pool"):
        assert ht_enc_cuda.LAUNCHES[k] == before[k] + 1, k


@pytest.mark.cuda
@pytest.mark.parametrize("lossless", [True, False])
def test_fused_encode_on_card_matches_cpu(cuda, lossless):
    rng = np.random.RandomState(2)
    frames = [rng.randint(0, 256, (96, 80, 3)).astype(np.uint8)
              for _ in range(2)]
    opts = tp.Options(format=tp.Format.J2K, lossless=lossless, quality=85,
                      high_throughput=True, num_resolutions=6)
    ht_enc_cuda.reset_counts()
    tp.counters.reset()
    on_card = tp.encode_batch(frames, opts, device=cuda)
    snap = tp.counters.snapshot()
    assert snap.get("enc.fused_chunks", 0) > 0
    assert snap.get("enc.host_entropy_frames", 0) == 0
    assert min(ht_enc_cuda.LAUNCHES.values()) > 0
    assert on_card == tp.encode_batch(frames, opts, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("case", HT_CASES)
def test_ht_dec_kernels_match_plain(cuda, case, lossless):
    opts = tp.Options(format=tp.Format.J2K, lossless=lossless, quality=85,
                      high_throughput=True, num_resolutions=6)
    streams = tp.encode_batch(_case_frames(case), opts, device="cpu")
    batch = decoder.prepare_batch(streams)
    assert batch is not None
    plan = batch.plan
    qinfo, pool, woff = decoder.upload_parsed(
        *decoder.parse_chunk(batch, batch.bodies), cuda)
    before = dict(ht_dec_cuda.LAUNCHES)
    blocks = ht_dec_cuda.magsgn_decode_blocks(qinfo, pool, woff, plan.cbh,
                                              plan.cbw)
    assert torch.equal(blocks, ht_dec.magsgn_decode_blocks(
        qinfo, pool, woff, plan.cbh, plan.cbw))
    dequants = (False,) if lossless else (False, True)
    for dequant in dequants:
        got = ht_dec_cuda.blocks_to_pyramid(blocks, plan, 3, batch.n_comps,
                                            batch.nl, dequant)
        ref = ht_dec.blocks_to_pyramid(blocks, plan, 3, batch.n_comps,
                                       batch.nl, dequant)
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r)
            for k in r:
                assert g[k].dtype == r[k].dtype
                assert torch.equal(g[k].view(torch.int32),
                                   r[k].contiguous().view(torch.int32)), k
    torch.cuda.synchronize()
    assert ht_dec_cuda.LAUNCHES["ht_magsgn_decode"] == \
        before["ht_magsgn_decode"] + 1
    assert ht_dec_cuda.LAUNCHES["ht_blocks_to_pyramid"] == \
        before["ht_blocks_to_pyramid"] + len(dequants)


@pytest.mark.cuda
@pytest.mark.parametrize("lossless", [True, False])
def test_decode_on_card_matches_cpu(cuda, lossless):
    rng = np.random.RandomState(3)
    # even sizes at every level: no plain DWT level
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
              for _ in range(2)]
    opts = tp.Options(format=tp.Format.J2K, lossless=lossless, quality=85,
                      high_throughput=True, num_resolutions=6)
    streams = tp.encode_batch(frames, opts, device="cpu")
    ht_dec_cuda.reset_counts()
    dwt_cuda.reset_counts()
    tp.counters.reset()
    on_card = tp.decode_batch(streams, device=cuda)
    snap = tp.counters.snapshot()
    assert snap.get("dec.device_ht_chunks", 0) > 0
    assert snap.get("dec.host_ht_frames", 0) == 0
    assert min(ht_dec_cuda.LAUNCHES.values()) > 0
    assert dwt_cuda.PLAIN_LEVELS == 0
    on_cpu = tp.decode_batch(streams, device="cpu")
    assert all(np.array_equal(d, c) for d, c in zip(on_card, on_cpu))
    if lossless:
        assert all(np.array_equal(d, f) for d, f in zip(on_card, frames))


EBCOT_OPTS = tp.Options(format=tp.Format.J2K, lossless=True,
                        high_throughput=False, num_resolutions=6)


def _ebcot_inputs(frames, dev):
    """The decision kernel's inputs of the frames' Part-1 block batch."""
    header = encoder.build_header(frames[0], EBCOT_OPTS)
    nc = header.num_components
    prec = header.components[0].precision
    encoder._apply_comp_quants(header, EBCOT_OPTS, nc, prec)
    tile = geo.build_tile(header, 0)
    plan = ebcot_fused.plan_for(header, tile)
    batch = np.stack([np.stack(encoder._image_components(f))
                      for f in frames])
    pyr = transforms.forward_pyramid(transforms.upload(batch, dev), 5,
                                     dwt.REV53, nc >= 3, prec, False, 0, 0)
    blocks = fused_encode.extract_blocks(pyr, plan, len(frames), 5)
    return plan, ebcot_fused.block_inputs(blocks, plan, len(frames))


def _split(pool, lens):
    ends = np.cumsum(lens.cpu().numpy().astype(np.int64))
    data = pool.cpu().numpy()
    return [data[e - n:e].tobytes() for e, n in zip(ends, lens.cpu().numpy())]


@pytest.mark.cuda
@pytest.mark.parametrize("case", HT_CASES)
def test_ebcot_kernels_match_plain(cuda, case):
    plan, (mags, signs, classes, valid) = _ebcot_inputs(_case_frames(case),
                                                        cuda)
    planes = ebcot_fused.max_planes(plan)
    before = dict(ebcot_cuda.LAUNCHES)
    slots = ebcot_cuda.decision_slots(mags, signs, classes, valid, planes)
    assert torch.equal(slots, ebcot_device.decision_slots(
        mags, signs, classes, valid, planes))
    pool, ndec, off, largest = ebcot_cuda.compact_rows(slots)
    ref = ebcot_cuda.compact_rows_plain(slots)
    for g, r in zip((pool, ndec, off), ref[:3]):
        assert torch.equal(g, r)
    assert largest == ref[3]
    rows, lens = ebcot_cuda.mq_encode(pool, ndec, off, largest)
    segs, total = ebcot_cuda.pool_rows(rows, off, lens)
    psegs, ptotal = ebcot_cuda.pool_rows_plain(rows, off, lens)
    assert torch.equal(total, ptotal.to(cuda))
    assert torch.equal(segs[:int(total)], psegs[:int(ptotal)])
    mine = _split(segs[:int(total)], lens)
    streams = _split(pool, ndec)
    stripped = [s[:-1] if s.endswith(b"\xff") else s for s in mine]
    assert stripped == loader.mq_encode_streams(streams)
    # the plain lockstep chain on the three largest blocks of at most 3000
    # decisions (it launches tens of ops per decision step)
    counts = ndec.cpu().numpy()
    pick = [int(i) for i in np.argsort(np.where(counts <= 3000, counts, -1)
                                       )[-3:]]
    assert [stripped[i] for i in pick] == mq_device.encode_streams(
        [streams[i] for i in pick])
    torch.cuda.synchronize()
    for k in ebcot_cuda.LAUNCHES:
        assert ebcot_cuda.LAUNCHES[k] == before[k] + 1, k


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ebcot_cuda.compact_stress_slots())
                         + ["empty"])
@pytest.mark.parametrize("base", [0, 5])
def test_compact_kernels_stress_slots(cuda, name, base):
    """The compaction kernels on ebcot_cuda.compact_stress_slots (rows of
    only 0xFF, decisions at the first and last byte of every chunk, runs
    across 16-byte boundaries at both ends of a chunk, T off 16 and off the
    chunk, rows of 13 bytes, 0xFF fill planes), with the slots starting 0
    and 5 bytes past a 16-byte boundary, and on B = 0 and T = 0: pool,
    counts, offsets and largest count equal compact_rows_plain's."""
    if name == "empty":
        for shape in ((0, 300), (3, 0)):
            slots = torch.empty(shape, dtype=torch.uint8, device=cuda)
            got = ebcot_cuda.compact_rows(slots)
            ref = ebcot_cuda.compact_rows_plain(slots)
            for a, b in zip(got[:3], ref[:3]):
                assert torch.equal(a, b.to(a.device))
            assert got[3] == ref[3] == 0
        return
    host = ebcot_cuda.compact_stress_slots()[name]
    buf = torch.empty(host.size + 16, dtype=torch.uint8, device=cuda)
    slots = buf[base:base + host.size].view(host.shape)
    slots.copy_(torch.from_numpy(host))
    assert slots.data_ptr() % 16 == base and slots.is_contiguous()
    before = ebcot_cuda.LAUNCHES["ebcot_compact_rows"]
    pool, ndec, off, largest = ebcot_cuda.compact_rows(slots)
    assert ebcot_cuda.LAUNCHES["ebcot_compact_rows"] == before + 1
    ref = ebcot_cuda.compact_rows_plain(slots)
    for g, r in zip((pool, ndec, off), ref[:3]):
        assert torch.equal(g, r)
    assert largest == ref[3]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ht_enc_cuda.pool_stress_cases()))
@pytest.mark.parametrize("base", [0, 1, 3])
def test_pool_kernels_stress_cases(cuda, name, base):
    """ht_compact_pool on ht_enc_cuda.pool_stress_cases (row widths off 4
    words, rows filled exactly, empty rows and an all-empty batch, MagSgn
    rows of 4.8 KB, one row, two rounds of the scan), the word rows `base`
    words past a 16-byte boundary: the used prefix and the totals equal
    ht_enc.assemble_pool's, in one launch of the wrapper."""
    args = []
    for a in ht_enc_cuda.pool_stress_cases()[name]:
        if a.ndim == 2:
            buf = torch.empty(a.size + 4, dtype=torch.int32, device=cuda)
            t = buf[base:base + a.size].view(a.shape)
            t.copy_(torch.from_numpy(a))
            assert t.data_ptr() % 16 == 4 * base
        else:
            t = torch.from_numpy(a).to(cuda)
        args.append(t)
    before = ht_enc_cuda.LAUNCHES["ht_compact_pool"]
    out, totals = ht_enc_cuda.assemble_pool(*args)
    assert ht_enc_cuda.LAUNCHES["ht_compact_pool"] == before + 1
    want, wtot = ht_enc.assemble_pool(*args)
    assert torch.equal(totals, wtot)
    assert torch.equal(out[:want.numel()], want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ebcot_cuda.pool_stress_rows()))
@pytest.mark.parametrize("base", [0, 5, 11])
def test_segment_pool_kernel_stress_rows(cuda, name, base):
    """ebcot_pool_rows on ebcot_cuda.pool_stress_rows (short rows at every
    phase, empty rows and an all-empty batch, rows of up to 9 KB, one row,
    runs of two rows a warp with a partial last tile), the row buffer
    `base` bytes past a 16-byte boundary: the pool's used prefix and the
    total equal pool_rows_plain's."""
    ndec, lens, rows = ebcot_cuda.pool_stress_rows()[name]
    buf = torch.empty(rows.size + 16, dtype=torch.uint8, device=cuda)
    rows_t = buf[base:base + rows.size]
    rows_t.copy_(torch.from_numpy(rows))
    assert rows_t.data_ptr() % 16 == base
    off = torch.from_numpy(np.cumsum(ndec.astype(np.int64)) - ndec).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    before = ebcot_cuda.LAUNCHES["ebcot_pool_rows"]
    pool, total = ebcot_cuda.pool_rows(rows_t, off, lens_t)
    assert ebcot_cuda.LAUNCHES["ebcot_pool_rows"] == before + 1
    want, wtot = ebcot_cuda.pool_rows_plain(rows_t, off, lens_t)
    assert torch.equal(total, wtot)
    used = int(wtot)
    assert torch.equal(pool[:used], want[:used])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["snake", "comb", "single_live",
                                  "all_planes"])
def test_decision_kernel_stress_blocks(cuda, name):
    arrays = ebcot_device.stress_blocks()[name]
    mags, signs, classes, valid = (torch.from_numpy(a).to(cuda)
                                   for a in arrays[:4])
    planes = arrays[4]
    got = ebcot_cuda.decision_slots(mags, signs, classes, valid, planes)
    assert torch.equal(got, ebcot_device.decision_slots(
        mags, signs, classes, valid, planes))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["m32", "uncoded", "pool_end", "odd",
                                  "odd_small", "gaps", "wide", "wide_62"])
def test_magsgn_kernel_stress_cases(cuda, name):
    case = {c[0]: c[1:] for c in ht_dec.stress_cases(
        ht_dec_cuda.STAGE_WORDS)}[name]
    q, buf, woff, cbh, cbw, off = case
    qinfo = torch.from_numpy(q).to(cuda)
    pool = torch.from_numpy(buf).to(cuda)[off:]
    woff = torch.from_numpy(woff).to(cuda)
    got = ht_dec_cuda.magsgn_decode_blocks(qinfo, pool, woff, cbh, cbw)
    assert torch.equal(got, ht_dec.magsgn_decode_blocks(qinfo, pool, woff,
                                                        cbh, cbw))


LAYOUT_CASES = [c[0] for c in block_layout.layout_stress_cases()]


def _layout_case(name, dev, phase=0):
    """A layout stress plan and its inputs on `dev`: (plan, n, components,
    levels, pyramid placed by block_layout.stress_leaves, slots)."""
    _n, plan, n, nc, levels = {c[0]: c for c in
                               block_layout.layout_stress_cases()}[name]
    pyr, slots = block_layout.stress_inputs(plan, n, nc, levels, seed=5)
    return (plan, n, nc, levels, block_layout.stress_leaves(pyr, dev, phase),
            torch.from_numpy(slots).to(dev))


def _leaves_equal(got, ref):
    """Pyramids equal bit for bit, band for band."""
    assert [sorted(e) for e in got] == [sorted(e) for e in ref]
    for g, r in zip(got, ref):
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape
            assert torch.equal(g[k].contiguous().view(torch.int32),
                               r[k].contiguous().view(torch.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [0, 1, 3, "strided"])
@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_layout_kernels_stress_plans(cuda, name, phase):
    # block_layout.layout_stress_cases: offset grids off multiples of 4,
    # odd band widths, 32x32 and 64x16 blocks, one and three frames; the
    # extraction's leaves `phase` words past a 16-byte boundary, or strided
    plan, n, nc, levels, pyr, slots = _layout_case(name, cuda, phase)
    before = dict(ht_enc_cuda.LAUNCHES)
    got = ht_enc_cuda.extract_blocks(pyr, plan, n, levels)
    assert torch.equal(got, fused_encode.extract_blocks(pyr, plan, n,
                                                        levels))
    dequants = (False, True) if plan.deltas is not None else (False,)
    b2p = dict(ht_dec_cuda.LAUNCHES)
    for dequant in dequants:
        _leaves_equal(
            ht_dec_cuda.blocks_to_pyramid(slots, plan, n, nc, levels,
                                          dequant),
            ht_dec.blocks_to_pyramid(slots, plan, n, nc, levels, dequant))
    assert ht_enc_cuda.LAUNCHES["ht_extract_blocks"] == \
        before["ht_extract_blocks"] + 1
    assert ht_dec_cuda.LAUNCHES["ht_blocks_to_pyramid"] == \
        b2p["ht_blocks_to_pyramid"] + len(dequants)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gray", "tiles_lossy_rgb"])
def test_layout_wrappers_never_wait_for_the_card(cuda, name):
    # after a plan's first call, neither wrapper makes a synchronizing CUDA
    # call (a pageable upload, a read-back)
    plan, n, nc, levels, pyr, slots = _layout_case(name, cuda)
    dequant = plan.deltas is not None
    ht_enc_cuda.extract_blocks(pyr, plan, n, levels)
    ht_dec_cuda.blocks_to_pyramid(slots, plan, n, nc, levels, dequant)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blocks = ht_enc_cuda.extract_blocks(pyr, plan, n, levels)
        leaves = ht_dec_cuda.blocks_to_pyramid(slots, plan, n, nc, levels,
                                               dequant)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(blocks, fused_encode.extract_blocks(pyr, plan, n,
                                                           levels))
    _leaves_equal(leaves, ht_dec.blocks_to_pyramid(slots, plan, n, nc,
                                                   levels, dequant))


@pytest.mark.cuda
def test_extract_wrapper_refuses_tiles_past_the_leaves(cuda):
    """With `tiles`, the card's extraction refuses a position past the
    leaves or below 0, a wrong count and leaves of unequal frames, and
    launches nothing; a class of the frames equals the plain version."""
    plan, n, _nc, levels, pyr, _slots = _layout_case("gray", cuda)
    short = [dict(e) for e in pyr]
    short[0]["HH"] = short[0]["HH"][:n - 1]
    before = ht_enc_cuda.LAUNCHES["ht_extract_blocks"]
    for leaves, tiles in ((pyr, [n, 0]), (pyr, [-1, 0]), (pyr, [0]),
                          (short, [0, 1])):
        with pytest.raises(ValueError):
            ht_enc_cuda.extract_blocks(leaves, plan, 2, levels, tiles)
    assert ht_enc_cuda.LAUNCHES["ht_extract_blocks"] == before
    tiles = [n - 1, 0]
    assert torch.equal(ht_enc_cuda.extract_blocks(pyr, plan, 2, levels, tiles),
                       fused_encode.extract_blocks(pyr, plan, 2, levels,
                                                   tiles))


@pytest.mark.cuda
def test_layout_wrappers_refuse_what_they_cannot_take(cuda):
    plan, n, nc, levels, pyr, slots = _layout_case("gray", cuda)
    bad = [dict(e) for e in pyr]
    bad[0]["HL"] = bad[0]["HL"].float()
    with pytest.raises(ValueError):
        ht_enc_cuda.extract_blocks(bad, plan, n, levels)
    with pytest.raises(ValueError):
        ht_dec_cuda.blocks_to_pyramid(slots[1:], plan, n, nc, levels)
    buf = torch.empty(slots.numel() + 4, dtype=torch.int32, device=cuda)
    off16 = buf[1:1 + slots.numel()].view(slots.shape)
    off16.copy_(slots)
    with pytest.raises(ValueError):
        ht_dec_cuda.blocks_to_pyramid(off16, plan, n, nc, levels)


def _row_segments(rows, off, lens):
    """Each block's segment in the MQ row buffer (row b at 3 off[b] + 3b),
    trailing 0xFF kept."""
    data = rows.cpu().numpy()
    starts = 3 * off.cpu().numpy() + 3 * np.arange(off.numel())
    return [data[s:s + n].tobytes()
            for s, n in zip(starts, lens.cpu().numpy())]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,base", [(0, 0), (1, 5), (2, 11)])
def test_mq_kernel_stress_streams(cuda, seed, base):
    """The MQ kernel on mq_device.stress_streams, the pool's base `base`
    bytes past a 16-byte boundary: every segment equal to the native
    coder's, and to the plain chain's on the streams of at most four
    staging chunks."""
    streams = mq_device.stress_streams(ebcot_cuda.MQ_CHUNK, seed)
    pool, ndec, off, largest = mq_device.pool_of(streams, cuda, base)
    assert pool.data_ptr() % 16 == base
    before = ebcot_cuda.LAUNCHES["ebcot_mq_encode"]
    rows, lens = ebcot_cuda.mq_encode(pool, ndec, off, largest)
    torch.cuda.synchronize()
    assert ebcot_cuda.LAUNCHES["ebcot_mq_encode"] == before + 1
    segs = _row_segments(rows, off, lens)
    assert [s[:-1] if s.endswith(b"\xff") else s for s in segs] == \
        loader.mq_encode_streams(streams)
    short = [i for i, s in enumerate(streams)
             if len(s) <= 4 * ebcot_cuda.MQ_CHUNK]
    sp, sn, so, sl = mq_device.pool_of([streams[i] for i in short], cuda)
    prows, plens = ebcot_cuda.mq_encode_plain(sp, sn, so, sl)
    assert [segs[i] for i in short] == _row_segments(prows, so, plens)


@pytest.mark.cuda
@pytest.mark.parametrize("mag", [3000, (1 << 30) - 1])
@pytest.mark.parametrize("shape", [(32, 32), (64, 32), (32, 128), (128, 32),
                                   (64, 64), (4, 1024), (1024, 4), (2, 2),
                                   (16, 16)])
def test_cleanup_kernel_block_shapes(cuda, shape, mag):
    """The fused cleanup kernel against its plain version on random blocks
    of legal code-block shapes, magnitudes up to `mag` (2^30 - 1 is the
    fields' limit), ragged and odd true sizes, an all-zero block: every
    output bit for bit."""
    h, w = shape
    rng = np.random.RandomState(h * 2048 + w)
    c = rng.randint(-mag, mag + 1, size=(40, h, w)).astype(np.int32)
    c[rng.rand(40, h, w) < 0.4] = 0
    c[0] = 0
    hs = rng.randint(1, h + 1, 40).astype(np.int32)
    ws = rng.randint(1, w + 1, 40).astype(np.int32)
    hs[1], ws[1] = h, w
    hs[2], ws[2] = max(1, h - 1), max(1, w - 1)
    max_mn = 16 if mag < (1 << 14) else 31
    _cleanup_matches_plain(torch.from_numpy(c).to(cuda),
                           torch.from_numpy(hs).to(cuda),
                           torch.from_numpy(ws).to(cuda), max_mn)


@pytest.mark.cuda
def test_cleanup_kernel_refuses_illegal_shapes(cuda):
    for shape in ((2, 2048, 2), (2, 128, 64), (2, 3, 4)):
        with pytest.raises(ValueError):
            ht_enc_cuda.cleanup_fields(
                torch.zeros(shape, dtype=torch.int32, device=cuda),
                [1, 1], [1, 1], 16)
    for max_mn in (0, 33):
        with pytest.raises(ValueError):
            ht_enc_cuda.cleanup_fields(
                torch.zeros((2, 4, 4), dtype=torch.int32, device=cuda),
                [1, 1], [1, 1], max_mn)


def _cleanup_matches_plain(blocks, hs, ws, max_mn):
    """ht_enc_cuda.cleanup_fields (one launch) against ht_enc.cleanup_fields,
    bit for bit."""
    before = ht_enc_cuda.LAUNCHES["ht_cleanup_pack"]
    got = ht_enc_cuda.cleanup_fields(blocks, hs, ws, max_mn)
    torch.cuda.synchronize()
    assert ht_enc_cuda.LAUNCHES["ht_cleanup_pack"] == before + 1
    _outputs_equal(got, ht_enc.cleanup_fields(blocks, hs, ws, max_mn))


def _filled_blocks(h, w, dev, tries=4096, seed=0):
    """Blocks whose MagSgn bits are exactly h * w * mm for one mm, so the
    row of ht_enc.stream_words(h, w, mm) words is filled to its last bit:
    (blocks, mm), found among random blocks by the plain version."""
    rng = np.random.RandomState(seed)
    c = rng.randint(-300, 301, size=(tries, h, w)).astype(np.int32)
    c[rng.rand(tries, h, w) < 0.1] = 0
    c = torch.from_numpy(c).to(dev)
    full = torch.full((tries,), h, dtype=torch.int32, device=dev)
    wide = torch.full((tries,), w, dtype=torch.int32, device=dev)
    bits = ht_enc.cleanup_values(c, full, wide)["ms_lens"].sum(1).cpu()
    hit = bits % (h * w) == 0
    mm = int(torch.bincount(bits[hit] // (h * w)).argmax())
    sel = torch.nonzero(bits == mm * h * w).flatten()[:8].to(dev)
    assert len(sel) and ht_enc.stream_words(h, w, mm)[0] * 32 == mm * h * w
    return c[sel].contiguous(), mm


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zeros", "spill", "fill", "fill32",
                                  "f6", "f6_offset", "f1537",
                                  "f1537_offset", "rounds"])
def test_pack_kernel_edge_rows(cuda, case):
    """The fused kernel's packing at its edges: all-zero blocks (every
    row empty); 30-bit magnitudes (fields spill at every bit offset); a
    MagSgn row filled exactly at max_mn (16x16 and 8x32 blocks); rows of a
    width off 4 words, stored by 4 bytes (6x10 blocks, and 2x2 with rows
    of one word); rows of 1537 words and more (4x1024, 1024x4); more quad
    pairs than one round of the CTA's threads (64x64 and 1024x2)."""
    rng = np.random.RandomState(len(case))
    shapes = {"zeros": [(64, 64)], "spill": [(64, 64), (32, 32)],
              "fill": [(16, 16)], "fill32": [(8, 32)], "f6": [(6, 10)],
              "f6_offset": [(2, 2)], "f1537": [(4, 1024)],
              "f1537_offset": [(1024, 4)], "rounds": [(64, 64), (1024, 2)]}
    for h, w in shapes[case]:
        if case.startswith("fill"):
            c, max_mn = _filled_blocks(h, w, cuda)
        else:
            mag = (1 << 30) - 1 if case == "spill" else 3000
            c = rng.randint(-mag, mag + 1, (9, h, w)).astype(np.int32)
            c[rng.rand(9, h, w) < 0.3] = 0
            if case == "zeros":
                c[:] = 0
            c = torch.from_numpy(c).to(cuda)
            max_mn = 31 if case == "spill" else 16
        nb = c.shape[0]
        hs = torch.from_numpy(rng.randint(1, h + 1, nb).astype(np.int32))
        ws = torch.from_numpy(rng.randint(1, w + 1, nb).astype(np.int32))
        if case.startswith("fill"):
            hs.fill_(h)
            ws.fill_(w)
        _cleanup_matches_plain(c, hs.to(cuda), ws.to(cuda), max_mn)


@pytest.mark.cuda
def test_pack_kernel_block_shapes(cuda):
    """The fused kernel at every legal code-block shape (powers of two
    from 4 to 1024 a side, at most 4096 samples: 4x4 .. 64x64, 32x128,
    4x1024, ..), bit for bit."""
    rng = np.random.RandomState(8)
    for a in range(2, 11):
        for b in range(2, 13 - a):
            h, w = 1 << a, 1 << b
            c = rng.randint(-5000, 5001, (9, h, w)).astype(np.int32)
            c[rng.rand(9, h, w) < 0.5] = 0
            hs = rng.randint(1, h + 1, 9).astype(np.int32)
            ws = rng.randint(1, w + 1, 9).astype(np.int32)
            _cleanup_matches_plain(torch.from_numpy(c).to(cuda),
                                   torch.from_numpy(hs).to(cuda),
                                   torch.from_numpy(ws).to(cuda), 20)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 2, 2), (2, 6, 6), (2, 2, 10),
                                   (1, 6, 4100), (1, 2, 8192),
                                   (1, 6, 8192), (2, 70, 10),
                                   (1, 66, 4100)])
def test_fwd53_kernel_widths(cuda, shape):
    """The forward 5/3 kernel at widths that are not a multiple of its
    column tile or of 4, and at heights of 2 and 6, exactly."""
    g = torch.Generator(device=cuda).manual_seed(shape[2])
    x = torch.randint(-(1 << 17), 1 << 17, shape, generator=g, device=cuda,
                      dtype=torch.int32)
    got = dwt_cuda.forward_2d_53(x)
    ref = dwt.forward_2d(x, dwt.REV53)
    for k in BANDS:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("side", [4096, 8192])
def test_fwd53_kernel_wide_frames(cuda, side):
    """A 4096^2 and an 8192^2 frame's first 5/3 level, forward and inverse,
    take the kernels (one launch each, no plain level) and equal the plain
    lifting."""
    g = torch.Generator(device=cuda).manual_seed(side)
    x = torch.randint(-(1 << 17), 1 << 17, (1, side, side), generator=g,
                      device=cuda, dtype=torch.int32)
    dwt_cuda.reset_counts()
    got = transforms.forward_level(x, dwt.REV53, 0, 0)
    rec = transforms.inverse_level(got, dwt.REV53, 0, 0)
    assert dwt_cuda.PLAIN_LEVELS == 0
    assert dwt_cuda.LAUNCHES["dwt53_fwd_level"] == 1
    assert dwt_cuda.LAUNCHES["dwt53_inv_level"] == 1
    ref = dwt.forward_2d(x, dwt.REV53)
    for k in BANDS:
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(rec, x)
    assert torch.equal(rec, dwt.inverse_2d(ref, dwt.REV53))


# widths whose column pairs leave 1, 5 and 10 pairs in the last tile of 30
# (2 -> 1 pair, 10 -> 5, 4100 -> 2050), heights of one strip and a bit
@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 10, 4100])
@pytest.mark.parametrize("h", [2, 6, 34, 66])
def test_inv53_kernel_widths(cuda, h, w):
    """The inverse 5/3 kernel at widths off its column tile, bit for bit,
    on bands of 17-bit samples (the extremes of a 16-bit level)."""
    g = torch.Generator(device=cuda).manual_seed(h * w + 53)
    bands = {k: torch.randint(-(1 << 17), 1 << 17, (2, h // 2, w // 2),
                              generator=g, device=cuda, dtype=torch.int32)
             for k in BANDS}
    before = dwt_cuda.LAUNCHES["dwt53_inv_level"]
    got = dwt_cuda.inverse_2d_53(bands)
    assert dwt_cuda.LAUNCHES["dwt53_inv_level"] == before + 1
    assert torch.equal(got, dwt.inverse_2d(bands, dwt.REV53))
    x = torch.randint(-40000, 40000, (2, h, w), generator=g, device=cuda,
                      dtype=torch.int32)
    assert torch.equal(dwt_cuda.inverse_2d_53(dwt_cuda.forward_2d_53(x)), x)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 10, 4100])
@pytest.mark.parametrize("sp", [2, 4])
def test_fwd53_kernel_halo_shards_of_two_rows(cuda, w, sp):
    """Row shards of 2 rows at widths off the column tile: the halo form
    equals the unsharded kernel and the plain halo lifting."""
    from go_jpeg2000_tpu_torch.parallel import sharded
    g = torch.Generator(device=cuda).manual_seed(w + sp)
    x = torch.randint(-40000, 40000, (3, 2 * sp, w), generator=g,
                      device=cuda, dtype=torch.int32)
    shards = [s.contiguous() for s in torch.chunk(x, sp, dim=-2)]
    fwd = sharded.forward_level_split(shards, dwt.REV53)
    plain = sharded.forward_level_split([s.cpu() for s in shards],
                                        dwt.REV53)
    ref = dwt_cuda.forward_2d_53(x)
    for k in BANDS:
        got = torch.cat([f[k] for f in fwd], dim=-2)
        assert torch.equal(got, ref[k]), k
        assert torch.equal(got.cpu(), torch.cat([f[k] for f in plain],
                                                dim=-2)), k


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 10, 4100])
@pytest.mark.parametrize("sp", [2, 4])
def test_inv53_kernel_halo_shards_of_two_rows(cuda, w, sp):
    """The inverse 5/3 kernel's halo form on row shards of 2 rows (and of
    34) at widths off the column tile equals the unsharded kernel, the
    plain halo lifting and the input."""
    from go_jpeg2000_tpu_torch.parallel import sharded
    for rows in (2 * sp, 34 * sp):
        g = torch.Generator(device=cuda).manual_seed(w + sp + rows)
        x = torch.randint(-40000, 40000, (3, rows, w), generator=g,
                          device=cuda, dtype=torch.int32)
        _fwd, inv, bands = _halo_split(x, sp, dwt.REV53)
        bands = {k: v.contiguous() for k, v in bands.items()}
        split = [{k: v.cpu().contiguous() for k, v in zip(bands, parts)}
                 for parts in zip(*(torch.chunk(b, sp, dim=-2)
                                    for b in bands.values()))]
        plain = sharded.inverse_level_split(split, dwt.REV53,
                                            level=dwt.inverse_2d_halo)
        rec = torch.cat(inv, dim=-2)
        assert torch.equal(rec, dwt_cuda.inverse_2d_53(bands))
        assert torch.equal(rec.cpu(), torch.cat(plain, dim=-2))
        assert torch.equal(rec, x)


# widths whose column pairs leave 0, 1 or 27 pairs in the last tile of 28
# (2 -> 1 pair, 54 -> 27, 56 -> 28, 58 -> 29, 8174 -> 4087, 8176 -> 4088,
# 8178 -> 4089), and 8192
@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 54, 56, 58, 8174, 8176, 8178, 8192])
@pytest.mark.parametrize("h", [2, 6, 34])
def test_97_kernel_widths(cuda, h, w):
    """Both 9/7 kernels at widths off their column tile and at heights of
    2, 6 and 34 (one strip and a bit), bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(h * w)
    x = torch.randn((2, h, w), generator=g, device=cuda) * 200
    got = dwt_cuda.forward_2d_97(x)
    ref = dwt.forward_2d(x, dwt.IRR97)
    for k in BANDS:
        assert torch.equal(got[k], ref[k]), k
    bands = {k: (torch.randn(v.shape, generator=g, device=cuda) * 200)
             for k, v in ref.items()}
    assert torch.equal(dwt_cuda.inverse_2d_97(bands),
                       dwt.inverse_2d(bands, dwt.IRR97))


@pytest.mark.cuda
@pytest.mark.parametrize("side", [4096, 8192])
def test_97_kernels_wide_frames(cuda, side):
    """A 4096^2 and an 8192^2 frame's first 9/7 level, forward and inverse,
    take the kernels (one launch each, no plain level) and equal the plain
    lifting."""
    g = torch.Generator(device=cuda).manual_seed(side + 97)
    x = torch.rand((1, side, side), generator=g, device=cuda) * 255 - 128
    dwt_cuda.reset_counts()
    got = transforms.forward_level(x, dwt.IRR97, 0, 0)
    rec = transforms.inverse_level(got, dwt.IRR97, 0, 0)
    assert dwt_cuda.PLAIN_LEVELS == 0
    assert dwt_cuda.LAUNCHES["dwt97_fwd_level"] == 1
    assert dwt_cuda.LAUNCHES["dwt97_inv_level"] == 1
    ref = dwt.forward_2d(x, dwt.IRR97)
    for k in BANDS:
        assert torch.equal(got[k], ref[k]), k
    del x
    assert torch.equal(rec, dwt.inverse_2d(ref, dwt.IRR97))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 10, 4100])
@pytest.mark.parametrize("sp", [2, 4])
def test_97_kernels_halo_shards_of_two_rows(cuda, w, sp):
    """Row shards of 2 rows at widths off the column tile: the 9/7 halo
    forms (the lifting reaches 4 rows, past the neighbouring shard) equal
    the unsharded kernels."""
    g = torch.Generator(device=cuda).manual_seed(w + sp + 97)
    x = torch.randn((3, 2 * sp, w), generator=g, device=cuda) * 200
    fwd, inv, _bands = _halo_split(x, sp, dwt.IRR97)
    ref = dwt_cuda.forward_2d_97(x)
    for k in BANDS:
        assert torch.equal(torch.cat([f[k] for f in fwd], dim=-2), ref[k]), k
    assert torch.equal(torch.cat(inv, dim=-2), dwt_cuda.inverse_2d_97(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("backend,counter", [
    ("device", "enc.ebcot_device_chunks"),
    ("hybrid", "enc.ebcot_hybrid_chunks"),
    ("native", "enc.host_entropy_frames")])
def test_ebcot_codec_on_card_matches_cpu(cuda, backend, counter):
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
              for _ in range(2)]
    opts = dataclasses.replace(EBCOT_OPTS, backend=backend)
    ebcot_cuda.reset_counts()
    tp.counters.reset()
    on_card = tp.encode_batch(frames, opts, device=cuda)
    decoded = tp.decode_batch(on_card, device=cuda)
    snap = tp.counters.snapshot()
    assert snap.get(counter, 0) > 0 and snap["dec.ebcot_frames"] == 2
    if backend != "native":
        assert ebcot_cuda.LAUNCHES["ebcot_decision_slots"] > 0
    assert on_card == tp.encode_batch(
        frames, dataclasses.replace(opts, backend="native"), device="cpu")
    assert all(np.array_equal(d, f) for d, f in zip(decoded, frames))


def _halo_split(x, sp, kind):
    """One forward level of x's sp row shards with their halos, and the
    inverse of the unsharded bands the same way, through the kernels."""
    from go_jpeg2000_tpu_torch.parallel import sharded
    shards = [s.contiguous() for s in torch.chunk(x, sp, dim=-2)]
    fwd = sharded.forward_level_split(shards, kind)
    bands = dwt.forward_2d(x, kind)
    split = [{k: v.contiguous() for k, v in zip(bands, parts)}
             for parts in zip(*(torch.chunk(b, sp, dim=-2)
                                for b in bands.values()))]
    return fwd, sharded.inverse_level_split(split, kind), bands


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [dwt.REV53, dwt.IRR97])
@pytest.mark.parametrize("sp,rows", [(2, 512), (4, 512), (4, 8), (2, 4)])
def test_halo_kernels_match_plain_and_unsharded(cuda, kind, sp, rows):
    """Row shards of 2 rows (rows / sp = 2) included: the 9/7 lifting
    reaches 4 rows, past the neighbouring shard."""
    g = torch.Generator(device=cuda).manual_seed(rows + sp)
    x = torch.randint(-40000, 40000, (6, rows, 64), generator=g, device=cuda,
                      dtype=torch.int32)
    if kind == dwt.IRR97:
        x = x.to(torch.float32) / 128
    before = dict(dwt_cuda.LAUNCHES)
    fwd, inv, bands = _halo_split(x, sp, kind)
    plain_fwd, plain_inv, _ = _halo_split(x.cpu(), sp, kind)
    for k in BANDS:
        got = torch.cat([f[k] for f in fwd], dim=-2)
        assert torch.equal(got, bands[k]), k
        assert torch.equal(got.cpu(),
                           torch.cat([f[k] for f in plain_fwd], dim=-2)), k
    rec = torch.cat(inv, dim=-2)
    assert torch.equal(rec, dwt.inverse_2d(bands, kind))
    assert torch.equal(rec.cpu(), torch.cat(plain_inv, dim=-2))
    torch.cuda.synchronize()
    lib = "dwt53" if kind == dwt.REV53 else "dwt97"
    for name in (f"{lib}_fwd_level", f"{lib}_inv_level"):
        assert dwt_cuda.LAUNCHES[name] == before[name] + sp
    # one packing launch a shard and a direction
    assert dwt_cuda.LAUNCHES["dwt_pack_edges"] == \
        before["dwt_pack_edges"] + 2 * sp


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 10, 58, 4100])
@pytest.mark.parametrize("kind", [dwt.REV53, dwt.IRR97])
def test_halo_kernels_whole_strips(cuda, kind, w):
    """Shards of whole strips (32 and 64 rows: the level kernels' even shard
    instance) at widths off the column tile, sp = 2 and 4, both
    directions, equal the unsharded kernels."""
    g = torch.Generator(device=cuda).manual_seed(w + 32)
    for sp, rows in ((4, 128), (2, 128), (4, 256)):
        x = torch.randint(-40000, 40000, (3, rows, w), generator=g,
                          device=cuda, dtype=torch.int32)
        if kind == dwt.IRR97:
            x = x.to(torch.float32) / 64
        fwd, inv, bands = _halo_split(x, sp, kind)
        for k in BANDS:
            assert torch.equal(torch.cat([f[k] for f in fwd], dim=-2),
                               bands[k]), (sp, rows, k)
        assert torch.equal(torch.cat(inv, dim=-2),
                           dwt.inverse_2d(bands, kind)), (sp, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 10, 512, 4100])
@pytest.mark.parametrize("rows", [2, 8, 34])
def test_pack_edges_matches_plain(cuda, rows, w):
    """The edge packing kernel, a forward shard's rows and an inverse
    shard's bands, at widths of 16-byte and of 4-byte copies, into a slot
    of an edges tensor too, equals dwt.pack_edges exactly."""
    g = torch.Generator(device=cuda).manual_seed(rows * w)
    x = torch.randint(-(1 << 30), 1 << 30, (3, rows, w), generator=g,
                      device=cuda, dtype=torch.int32)
    bands = {k: torch.randint(-(1 << 30), 1 << 30, (3, rows // 2, w // 2),
                              generator=g, device=cuda, dtype=torch.int32)
             for k in BANDS}
    for src in (x, x.to(torch.float32), bands):
        before = dwt_cuda.LAUNCHES["dwt_pack_edges"]
        got = dwt_cuda.pack_edges(src)
        slots = torch.zeros((2,) + tuple(got.shape), dtype=got.dtype,
                            device=cuda)
        dwt_cuda.pack_edges(src, out=slots[1])
        assert dwt_cuda.LAUNCHES["dwt_pack_edges"] == before + 2
        host = ({k: v.cpu() for k, v in src.items()}
                if isinstance(src, dict) else src.cpu())
        want = dwt.pack_edges(host)
        assert got.shape[1] == dwt.edge_count(rows)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(slots[1].cpu(), want)
        assert not slots[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 3, 33, 4101])
@pytest.mark.parametrize("kind", [dwt.REV53, dwt.IRR97])
def test_halo_kernels_odd_widths(cuda, kind, w):
    """Row shards at odd widths and one column (a single tile column's
    levels: 3000 -> 1500 -> 750 -> 375), shards of 2, 34 and 64 rows at
    sp = 2 and 4: the packing kernel equals dwt.pack_edges (bands of
    ceil and floor half widths), and the halo form, both directions,
    equals the unsharded kernels and the plain halo form, one packing and
    one level launch a shard and direction."""
    from go_jpeg2000_tpu_torch.parallel import sharded
    g = torch.Generator(device=cuda).manual_seed(w + 33)
    for sp, rows in ((2, 4), (4, 8), (2, 68), (4, 256)):
        x = torch.randint(-40000, 40000, (3, rows, w), generator=g,
                          device=cuda, dtype=torch.int32)
        if kind == dwt.IRR97:
            x = x.to(torch.float32) / 64
        before = dict(dwt_cuda.LAUNCHES)
        fwd, inv, bands = _halo_split(x, sp, kind)
        torch.cuda.synchronize()
        lib = "dwt53" if kind == dwt.REV53 else "dwt97"
        for name in (f"{lib}_fwd_level", f"{lib}_inv_level"):
            assert dwt_cuda.LAUNCHES[name] == before[name] + sp
        assert dwt_cuda.LAUNCHES["dwt_pack_edges"] == \
            before["dwt_pack_edges"] + 2 * sp
        plain_fwd, plain_inv, _ = _halo_split(x.cpu(), sp, kind)
        for k in BANDS:
            got = torch.cat([f[k] for f in fwd], dim=-2)
            assert torch.equal(got, bands[k]), (sp, rows, k)
            assert torch.equal(got.cpu(), torch.cat(
                [f[k] for f in plain_fwd], dim=-2)), (sp, rows, k)
        rec = torch.cat(inv, dim=-2)
        assert torch.equal(rec, dwt.inverse_2d(bands, kind)), (sp, rows)
        assert torch.equal(rec.cpu(), torch.cat(plain_inv, dim=-2))
        top = {k: v[:, :rows // sp // 2].contiguous() for k, v in bands.items()}
        assert torch.equal(dwt_cuda.pack_edges(top).cpu(), dwt.pack_edges(
            {k: v.cpu() for k, v in top.items()})), (sp, rows)


@pytest.mark.cuda
def test_sharded_row_shards_odd_width_on_card(cuda, tmp_path):
    """encode_sharded and decode_sharded on a gloo grid of (dp, sp) =
    (1, 2) ranks sharing the card, on one tile column 33 wide (level
    widths 33, 17, 9) and on a 3000-wide single tile (3000, 1500, 750,
    375, 188):
    every rank's codestream equals the one-process encode's, lossless
    decodes are exact, lossy decodes equal the one-process decode, and
    every level ran through the halo kernels (no plain level)."""
    import json
    import pickle

    import torch.multiprocessing as mp

    from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded
    from tests import torch_dist_worker
    loader.available()                 # build before the ranks start
    dwt_cuda.load()
    rng = np.random.RandomState(12)
    img = rng.randint(0, 1 << 16, (64, 33, 3)).astype(np.uint16)
    wide = rng.randint(0, 256, (64, 3000)).astype(np.uint8)
    cases = [(img, tp.Options(format=tp.Format.J2K, lossless=True,
                              high_throughput=True, num_resolutions=4,
                              tile_size=(33, 16)), True),
             ((img >> 8).astype(np.uint8), tp.Options(
                 format=tp.Format.J2K, lossless=False, quality=85,
                 high_throughput=True, num_resolutions=4,
                 tile_size=(33, 16)), True),
             (wide, tp.Options(format=tp.Format.J2K, lossless=True,
                               high_throughput=True, num_resolutions=6),
              True)]
    single = []
    for image, opts, _decode in cases:
        data = encode_sharded(image, opts, device=cuda)
        assert data == encode_sharded(image, opts, device="cpu")
        single.append((data, decode_sharded(data, device=cuda)))
    mp.spawn(torch_dist_worker.run,
             args=(2, str(tmp_path / "rdv"), str(tmp_path), 1, 2, cases,
                   "gloo", "cuda"), nprocs=2)
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        for (data, pix), (ref, ref_pix), case in zip(got, single, cases):
            assert data == ref, (rank, case[1])
            assert np.array_equal(pix, ref_pix), (rank, case[1])
        with open(tmp_path / f"rank{rank}_launches.json") as f:
            launches = json.load(f)
        assert launches["plain_levels"] == 0, rank
        for name in ("dwt53_fwd_level", "dwt53_inv_level",
                     "dwt97_fwd_level", "dwt97_inv_level", "dwt_pack_edges"):
            assert launches[name] > 0, (rank, name)
    assert np.array_equal(single[0][1], img)
    assert np.array_equal(single[2][1], wide)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_band_stats_matches_plain(cuda, dtype):
    from go_jpeg2000_tpu_torch.ops import band_stats
    g = torch.Generator(device=cuda).manual_seed(3)
    leaves = [torch.randint(-3, 4, shape, generator=g, device=cuda,
                            dtype=torch.int32).to(dtype)
              for shape in [(7, 3, 256, 256), (7, 3, 1, 5), (0, 3, 4, 4),
                            (7, 3, 64, 64), (2, 2)]]
    before = band_stats.LAUNCHES["band_stats"]
    sums, counts = band_stats.band_stats(leaves)
    ref_sums, ref_counts = band_stats.band_stats_plain(leaves)
    torch.cuda.synchronize()
    assert band_stats.LAUNCHES["band_stats"] == before + 1
    assert torch.equal(counts, ref_counts)
    assert torch.allclose(sums, ref_sums, rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("lossless", [True, False])
def test_sharded_codec_on_card_matches_cpu(cuda, lossless):
    from go_jpeg2000_tpu_torch.ops import band_stats
    from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded
    rng = np.random.RandomState(6)
    img = rng.randint(0, 1 << 16, (2048, 2048, 3)).astype(np.uint16)
    if not lossless:
        img = (img >> 8).astype(np.uint8)
    opts = tp.Options(format=tp.Format.J2K, lossless=lossless, quality=85,
                      num_resolutions=5, tile_size=(512, 512),
                      high_throughput=True)
    dwt_cuda.reset_counts()
    band_stats.reset_counts()
    tp.counters.reset()
    data = encode_sharded(img, opts, device=cuda)
    out = decode_sharded(data, device=cuda)
    snap = tp.counters.snapshot()
    assert snap["enc.sharded_device_ht_tiles"] == 16
    assert snap["dec.sharded_device_ht_tiles"] == 16
    assert dwt_cuda.PLAIN_LEVELS == 0 and band_stats.LAUNCHES["band_stats"]
    assert data == encode_sharded(img, opts, device="cpu")
    assert np.array_equal(out, decode_sharded(data, device="cpu"))
    if lossless:
        assert np.array_equal(out, img)


@pytest.mark.cuda
@pytest.mark.parametrize("dp,sp", [(4, 1), (2, 2), (1, 4)])
def test_sharded_nccl_grids_match_one_process(cuda, dp, sp, tmp_path):
    """The tile-sharded pipeline on NCCL groups of four ranks, one card
    each: every rank's codestream equals the one-process encode's and its
    decode the one-process decode, for HT lossless (with row shards of 2
    rows at sp = 4), HT lossy and Part-1 with 2 layers at 6:1 (the PCRD's
    all_reduce).  Needs four cards."""
    import pickle

    import torch.multiprocessing as mp

    from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded
    from tests import torch_dist_worker
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    loader.available()                 # build before the ranks start
    dwt_cuda.load()
    rng = np.random.RandomState(8)
    img = rng.randint(0, 1 << 16, (256, 384, 3)).astype(np.uint16)
    small = dict(format=tp.Format.J2K, num_resolutions=4, tile_size=(64, 32))
    cases = [(img, tp.Options(lossless=True, high_throughput=True, **small),
              True),
             ((img >> 8).astype(np.uint8), tp.Options(
                 lossless=False, quality=85, high_throughput=True, **small),
              True),
             (img, tp.Options(lossless=True, num_layers=2,
                              compression_ratio=6.0, **small), False)]
    single = []
    for image, opts, decode in cases:
        data = encode_sharded(image, opts, device=cuda)
        single.append((data, decode_sharded(data, device=cuda)
                       if decode else None))
    mp.spawn(torch_dist_worker.run,
             args=(4, str(tmp_path / "rdv"), str(tmp_path), dp, sp, cases,
                   "nccl"), nprocs=4)
    for rank in range(4):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        for (data, pix), (ref, ref_pix), case in zip(got, single, cases):
            assert data == ref, (rank, case[1])
            if case[2]:
                assert np.array_equal(pix, ref_pix), (rank, case[1])
    assert np.array_equal(single[0][1], img)


def _config2_image(side, seed=0):
    """bench.py's natural image: three-tap smoothed noise, RGB."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=(side, side, 3)).astype(np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


CONFIG2 = tp.Options(format=tp.Format.JP2, lossless=False, quality=98,
                     num_resolutions=6, num_layers=3, compression_ratio=20.0,
                     backend="native")


@pytest.mark.cuda
def test_config2_on_card_matches_cpu(cuda):
    """BASELINE config 2 (lossy 9/7 + ICT, 3 layers and PCRD at 20:1, JP2)
    at 256^2: the card's bytes and decode equal the CPU's, inside the
    budget."""
    img = _config2_image(256)
    data = tp.encode(img, CONFIG2, device=cuda)
    assert data == tp.encode(img, CONFIG2, device="cpu")
    assert len(decoder.sniff_format(data)[1]) <= img.size // 20
    assert np.array_equal(tp.decode(data, device=cuda),
                          tp.decode(data, device="cpu"))


@pytest.mark.cuda
def test_multihost_on_card_matches_card_encode(cuda):
    """Two host processes, each with the transforms on the card: the bytes
    of the card's single-process encode, lossless and lossy budgeted, with
    the launches of that encode and not of the hosts' warm-up; the decode
    of two hosts equals the card's decode."""
    from go_jpeg2000_tpu_torch.ops import kernel_launches, reset_launches
    from go_jpeg2000_tpu_torch.parallel import (decode_multihost,
                                                encode_multihost)
    img = _config2_image(256, seed=5)
    for opts in (tp.Options(format=tp.Format.J2K, lossless=True,
                            num_resolutions=4, tile_size=(64, 64),
                            high_throughput=True, num_layers=2,
                            compression_ratio=6.0),
                 tp.Options(format=tp.Format.J2K, lossless=False,
                            num_resolutions=4, tile_size=(64, 64),
                            high_throughput=True, num_layers=2,
                            compression_ratio=12.0)):
        reset_launches()
        single = tp.encode(img, opts, device=cuda)
        once = kernel_launches()
        stats = {}
        data = encode_multihost(img, opts, n_hosts=2, device="cuda",
                                warmups=1, _stats=stats)
        assert data == single
        assert stats["host_launches"] == once
        assert np.array_equal(decode_multihost(data, n_hosts=2,
                                               device="cuda"),
                              tp.decode(data, device=cuda))


@pytest.mark.cuda
def test_dryrun_multichip_on_card(cuda):
    from go_jpeg2000_tpu_torch.entry import dryrun_multichip, entry
    dryrun_multichip(1, device="cuda")
    fn, args = entry(device="cuda")
    pool, totals = fn(*args)
    assert pool.is_cuda and int(totals.sum()) > 0


def _plain_levels_after(fn):
    """fn() with dwt_cuda's launch counts and plain levels reset before it:
    (result, inverse level launches, plain levels)."""
    dwt_cuda.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, (dwt_cuda.LAUNCHES["dwt53_inv_level"]
                 + dwt_cuda.LAUNCHES["dwt97_inv_level"]), \
        dwt_cuda.PLAIN_LEVELS


@pytest.mark.cuda
def test_precinct_seek_on_card_matches_cpu(cuda):
    """A region of an HTJ2K lossless image in 32x32 precincts with PLT
    (chip_smoke.py's R3 at 256^2): the card's decode skips the packets of
    the precincts outside it by PLT seek, as the CPU's does, and equals
    the input's crop, every level through the inverse 5/3 kernel."""
    img = _config2_image(256, seed=3)
    data = tp.encode(img, tp.Options(
        format=tp.Format.J2K, lossless=True, high_throughput=True,
        num_resolutions=4, precinct_size=[(5, 5)] * 4, enable_plt=True),
        device="cpu")
    cfg = tp.Config(decode_area=(0, 0, 40, 40))
    snaps = []
    for dev in (cuda, "cpu"):
        tp.counters.reset()
        crop, launched, plain = _plain_levels_after(
            lambda: tp.decode(data, cfg, device=dev))
        assert np.array_equal(crop, img[:40, :40])
        snaps.append(tp.counters.snapshot())
        if dev is cuda:
            assert launched == 3 and plain == 0
    assert snaps[0]["dec.packets_skipped"] > 0
    for k in ("dec.packets_skipped", "dec.packets_parsed",
              "dec.blocks_decoded"):
        assert snaps[0][k] == snaps[1][k], k


@pytest.mark.cuda
def test_relabelled_samples_on_card(cuda):
    """An 8-bit lossless stream with only its SIZ marker rewritten
    (chip_smoke.py's P1 at 96x80): signed 8-bit, 4- and 20-bit, 2x2
    subsampled decode on the card to their exact expected samples, as on
    the CPU."""
    from tests.siz_relabel import relabel, relabel_cases
    x = _config2_image(96, seed=4)[:, :80, 0].copy()
    for ht in (True, False):
        data = tp.encode(x, tp.Options(format=tp.Format.J2K, lossless=True,
                                       high_throughput=ht,
                                       num_resolutions=4), device="cpu")
        for name, (kw, want) in relabel_cases(x).items():
            s = relabel(data, **kw)
            got, launched, plain = _plain_levels_after(
                lambda: tp.decode(s, device=cuda))
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                name
            assert launched == 3 and plain == 0
            assert np.array_equal(tp.decode(s, device="cpu"), got)


@pytest.mark.cuda
def test_colour_converters_on_card_match_cpu(cuda):
    """The 14 JP2 colour converters on the card against the CPU at 8 and
    16 bits: equal (their divisions are IEEE divisions on both devices,
    colorspace._div), CIELab, CIEJab and ROMM-RGB within one grey level
    (a float64 pow on each device, rounded to float32); and a JP2 tagged
    sYCC decodes to the CPU's pixels."""
    from go_jpeg2000_tpu_torch.ops import colorspace
    rng = np.random.RandomState(9)
    spaces = [c for c in tp.ColorSpace
              if colorspace.get_color_conversion(c) is not None]
    assert len(spaces) == 14
    for bits in (8, 16):
        planes = [torch.from_numpy(rng.randint(
            0, 1 << bits, size=(256, 256)).astype(np.int32))
            for _ in range(4)]
        on_card = [p.to(cuda) for p in planes]
        for space in spaces:
            conv = colorspace.get_color_conversion(space)
            got = torch.stack(conv(on_card, bits))
            assert got.is_cuda and got.dtype == torch.int32
            diff = (got.cpu() - torch.stack(conv(planes, bits))).abs()
            assert int(diff.max()) <= 1, space
            if space.name not in ("CIELAB", "CIEJAB", "ROMM_RGB"):
                assert int(diff.max()) == 0, space
    img = _config2_image(128, seed=6)
    data = tp.encode(img, tp.Options(lossless=True, high_throughput=True,
                                     num_resolutions=4,
                                     color_space=tp.ColorSpace.SYCC),
                     device="cpu")
    assert np.array_equal(tp.decode(data, device=cuda),
                          tp.decode(data, device="cpu"))


@pytest.mark.cuda
def test_layered_and_reduced_decode_on_card_matches_cpu(cuda):
    """Config 2's options at 256^2 (chip_smoke.py's L1): the decodes from
    1 and 2 of 3 layers and at reduce_resolution 1 and 2 equal the CPU's,
    every level through the inverse 9/7 kernel."""
    img = _config2_image(256)
    data = tp.encode(img, CONFIG2, device="cpu")
    for kw in (dict(quality_layers=1), dict(quality_layers=2),
               dict(reduce_resolution=1), dict(reduce_resolution=2)):
        cfg = tp.Config(**kw)
        got, launched, plain = _plain_levels_after(
            lambda: tp.decode(data, cfg, device=cuda))
        assert np.array_equal(got, tp.decode(data, cfg, device="cpu")), kw
        assert launched == 5 - kw.get("reduce_resolution", 0)
        assert plain == 0


def _extremes(shape, bits, seed):
    """Each sample 0 or 2^bits - 1 at random: the largest 5/3 details."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2, size=shape) * ((1 << bits) - 1)).astype(
        np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["29-bit gray", "28-bit RGB after RCT",
                                  "signed int16 batch"])
def test_fwd53_kernel_wide_and_signed_samples(cuda, case):
    # every forward 5/3 level of the kernel equals the plain lifting bit
    # for bit where its lifting sums come within a bit of int32's range
    # (the kernel sums in uint32_t, wrapping as torch's int32 does) and on
    # signed samples
    if case == "signed int16 batch":
        rng = np.random.RandomState(3)
        img = rng.randint(-32768, 32768, size=(4, 1, 256, 192)).astype(
            np.int16)
        bits, mct, signed = 16, False, True
    else:
        rgb = case.startswith("28")
        bits = 28 if rgb else 29
        img = np.moveaxis(_extremes((512, 384, 3 if rgb else 1), bits, 4),
                          -1, 0)[None]
        mct, signed = rgb, False
    x = transforms.upload(img, cuda)
    cur = transforms.coefficients(x, dwt.REV53, mct, bits, signed).reshape(
        -1, *img.shape[-2:])
    for _ in range(4):
        dwt_cuda.reset_counts()
        got = transforms.forward_level(cur, dwt.REV53, 0, 0)
        assert dwt_cuda.LAUNCHES["dwt53_fwd_level"] == 1
        want = dwt.forward_2d(cur, dwt.REV53)
        for k in BANDS:
            assert torch.equal(got[k], want[k]), k
        cur = got["LL"].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(high_throughput=True, enable_sop=True,
                                     enable_eph=True),
                                dict(high_throughput=True, enable_ppt=True,
                                     enable_tlm=True),
                                dict(backend="device", enable_sop=True,
                                     enable_eph=True)])
def test_marker_batches_on_card_match_cpu(cuda, kw):
    # the fused HT kernels' and device EBCOT's segments through the Python
    # Tier-2 with markers: the card's bytes equal the CPU run's (path C
    # on the CPU for Part-1, which gives path A's bytes)
    rng = np.random.RandomState(8)
    frames = [rng.randint(-2048, 2048, size=(256, 192)).astype(np.int16)
              for _ in range(3)]
    opts = tp.Options(format=tp.Format.J2K, lossless=True, num_resolutions=5,
                      **kw)
    tp.counters.reset()
    got = tp.encode_batch(frames, opts, device=cuda)
    snap = tp.counters.snapshot()
    assert snap.get("enc.fused_chunks", 0) + snap.get(
        "enc.ebcot_device_chunks", 0) == 1
    ref = opts if opts.high_throughput else dataclasses.replace(
        opts, backend="native")
    assert got == tp.encode_batch(frames, ref, device="cpu")
    for d, f in zip(tp.decode_batch(got, device=cuda), frames):
        assert np.array_equal(d, f)


# ------------------------------------------ colour head and tail (mct.cu)

MCT_DTYPES = (np.uint8, np.int8, np.int16, np.uint16, np.int32)
MCT_PRECISIONS = (1, 8, 12, 16, 29, 30, 31)
# [N, H, W]: rows off 16 bytes, a single pixel, aligned planes, odd planes
MCT_SHAPES = ((2, 3, 5), (1, 1, 1), (2, 64, 64), (3, 17, 33))


def _mct_samples(dtype, shape, seed):
    """Samples over the dtype's whole range, its extremes included."""
    info = np.iinfo(dtype)
    rng = np.random.RandomState(seed)
    a = rng.randint(info.min, int(info.max) + 1, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    flat[:2] = (info.min, info.max)[:flat.size]
    return a.astype(dtype)


def _bits_equal(got, want):
    """Equal dtype, shape and bits (float32 compared as its bit pattern)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def _mct_pair(x, coef, kind, use_mct, precision, signed):
    """Both kernels against their plain versions on the card, each one
    launch."""
    before = dict(mct_cuda.LAUNCHES)
    _bits_equal(mct_cuda.mct_forward(x, kind, use_mct, precision, signed),
                transforms.coefficients_plain(x, kind, use_mct, precision,
                                              signed))
    for narrow in (True, False):
        _bits_equal(mct_cuda.mct_inverse(coef, kind, use_mct, precision,
                                         signed, narrow),
                    transforms.samples_plain(coef, kind, use_mct, precision,
                                             signed, narrow))
    torch.cuda.synchronize()
    assert mct_cuda.LAUNCHES["mct_forward"] == before["mct_forward"] + 1
    assert mct_cuda.LAUNCHES["mct_inverse"] == before["mct_inverse"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("precision", MCT_PRECISIONS)
@pytest.mark.parametrize("dtype", MCT_DTYPES, ids=lambda d: np.dtype(d).name)
def test_mct_kernels_match_plain(cuda, dtype, precision, signed):
    seed = precision * 7 + MCT_DTYPES.index(dtype) * 2 + signed
    for n, h, w in MCT_SHAPES:
        for c in (1, 3, 4):
            batch = _mct_samples(dtype, (n, c, h, w), seed)
            x = transforms.upload(batch, cuda)
            assert x.dtype == torch.from_numpy(batch[:0]).dtype  # narrow
            for kind in (dwt.REV53, dwt.IRR97):
                for use_mct in (False, True):
                    coef = transforms.coefficients_plain(
                        x, kind, use_mct, precision, signed)
                    # moved a little, so the tail also clamps and rounds
                    g = torch.Generator(device=cuda).manual_seed(seed + c)
                    noise = torch.randint(-4, 5, coef.shape, generator=g,
                                          device=cuda)
                    coef = (coef + noise.to(torch.int32) if kind == dwt.REV53
                            else coef + noise.to(torch.float32) / 2)
                    _mct_pair(x, coef, kind, use_mct, precision, signed)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [dwt.REV53, dwt.IRR97])
def test_mct_kernels_read_a_row_shard_view(cuda, kind):
    # rows 2-5 of every frame's planes: frame and component strides of the
    # whole batch, planes contiguous, read in place
    batch = _mct_samples(np.uint16, (3, 4, 8, 24), 5)
    full = transforms.upload(batch, cuda)
    view = full[:, :, 2:6]
    assert not view.is_contiguous()
    coef_full = transforms.coefficients_plain(full, kind, True, 16, False)
    coef = coef_full[:, :, 2:6]
    _mct_pair(view, coef, kind, True, 16, False)
    _bits_equal(mct_cuda.mct_forward(view, kind, True, 16, False),
                mct_cuda.mct_forward(view.contiguous(), kind, True, 16,
                                     False))
    # a plane that is not contiguous (every other column) is copied first
    cols = full[..., ::2]
    _bits_equal(mct_cuda.mct_forward(cols, kind, False, 16, False),
                transforms.coefficients_plain(cols, kind, False, 16, False))


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("precision", [8, 16, 31])
def test_mct_inverse_on_floats_past_int32_and_nan(cuda, precision, signed):
    # the card's plain version saturates and takes NaN to 0; the kernel
    # equals it (the CPU's plain version gives INT_MIN for all three)
    vals = torch.tensor([3e9, -3e9, float("nan"), 2.0 ** 31, -2.0 ** 31,
                         2.5, -2.5, 0.5, float("inf"), -float("inf"),
                         1e38, 2147483520.0], device=cuda)
    x = vals[torch.arange(3 * 4 * 16, device=cuda) % vals.numel()].reshape(
        1, 3, 4, 16)
    for use_mct in (False, True):
        for narrow in (True, False):
            _bits_equal(mct_cuda.mct_inverse(x, dwt.IRR97, use_mct,
                                             precision, signed, narrow),
                        transforms.samples_plain(x, dwt.IRR97, use_mct,
                                                 precision, signed, narrow))


@pytest.mark.cuda
def test_mct_kernels_at_config4_size_and_through_the_routing(cuda):
    # a quarter of config 4's tile batch (64 tiles of 512x512 16-bit RGB):
    # coefficients and samples launch one kernel each on the card, exact,
    # and the round trip gives the samples back
    batch = _mct_samples(np.uint16, (64, 3, 512, 512), 9)
    x = transforms.upload(batch, cuda)
    mct_cuda.reset_counts()
    for kind in (dwt.REV53, dwt.IRR97):
        coef = transforms.coefficients(x, kind, True, 16, False)
        _bits_equal(coef, transforms.coefficients_plain(x, kind, True, 16,
                                                        False))
        out = transforms.samples(coef, kind, True, 16, False)
        _bits_equal(out, transforms.samples_plain(coef, kind, True, 16,
                                                  False))
        if kind == dwt.REV53:
            assert np.array_equal(out.cpu().numpy().view(np.uint16), batch)
    torch.cuda.synchronize()
    assert mct_cuda.LAUNCHES == {"mct_forward": 2, "mct_inverse": 2}
    with pytest.raises(ValueError):
        mct_cuda.mct_inverse(coef.to(torch.int16), dwt.REV53, True, 16,
                             False)
