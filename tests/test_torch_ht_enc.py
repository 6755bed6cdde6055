"""The port's plain HT encode functions (go_jpeg2000_tpu_torch/ops/ht_enc.py,
models/fused_encode.py extract_blocks) against the JAX package's
(ops/ht_tpu.py, models/fused_encode.py), on the same numpy inputs made from
a seed, on the CPU.  Every integer output must be equal; the distortion
(float32 squares, which the port sums in float64 and rounds once, as its
kernel does, and the JAX package sums in float32, ops/ht_tpu.py:489)
within a relative 1e-6 on the small blocks and 1e-5 on 64x64 ones."""
import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models import encoder as jenc
from go_jpeg2000_tpu.models import fused_encode as jfe
from go_jpeg2000_tpu.ops import ht as jht
from go_jpeg2000_tpu.ops import ht_tpu
from go_jpeg2000_tpu.options import Format, Options
from go_jpeg2000_tpu.tcd import geometry as jgeo
from go_jpeg2000_tpu_torch.models import encoder, fused_encode, transforms
from go_jpeg2000_tpu_torch.native import loader
from go_jpeg2000_tpu_torch.ops import dwt, ht_enc, ht_enc_cuda
from go_jpeg2000_tpu_torch.tcd import geometry as geo
from tests import row_copy_model as rc

SHAPES = [(4, 4), (8, 8), (16, 16), (6, 10), (2, 4), (32, 8), (12, 4),
          (2, 2), (10, 6), (64, 48)]


def _blocks(shape, seed):
    """Blocks of one shape over the sparsity and magnitude grid of
    tests/test_ht_tpu.py."""
    rng = np.random.RandomState(seed)
    out = []
    for sparsity in (0.0, 0.7, 0.95, 1.0):
        for mag in (1, 200, 4000):
            c = rng.randint(-mag, mag + 1, size=shape).astype(np.int32)
            c[rng.rand(*shape) < sparsity] = 0
            out.append(c)
    return out


def _batch(cases):
    """Zero-pad blocks to one even shape; (coeffs, hs, ws)."""
    hmax = max(b.shape[0] for b in cases)
    wmax = max(b.shape[1] for b in cases)
    hmax += hmax & 1
    wmax += wmax & 1
    arr = np.zeros((len(cases), hmax, wmax), np.int32)
    hs = np.zeros(len(cases), np.int32)
    ws = np.zeros(len(cases), np.int32)
    for i, b in enumerate(cases):
        arr[i, :b.shape[0], :b.shape[1]] = b
        hs[i], ws[i] = b.shape
    return arr, hs, ws


def _ragged():
    cases = [c for i, s in enumerate(SHAPES) for c in _blocks(s, i)[::3]]
    return cases + [np.zeros((8, 8), np.int32)]


def test_direct_enc_table_matches_jax():
    got = ht_enc.direct_enc_table()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ht_tpu._direct_enc_table())


@pytest.mark.parametrize("case", [f"{h}x{w}" for h, w in SHAPES]
                         + ["ragged"])
def test_cleanup_fields_matches_jax(case):
    if case == "ragged":
        arr, hs, ws = _batch(_ragged())
    else:
        h, w = map(int, case.split("x"))
        arr, hs, ws = _batch(_blocks((h, w), seed=h * 100 + w))
    ref = {k: np.asarray(v) for k, v in ht_tpu._fields_fn(
        arr.shape[1], arr.shape[2], 16)(arr, hs, ws).items()}
    got = {k: v.numpy() for k, v in ht_enc.cleanup_fields(
        torch.from_numpy(arr), hs, ws, 16).items()}
    for k in ("ms", "vlc", "mel"):
        np.testing.assert_array_equal(got[f"{k}_words"].view(np.uint32),
                                      ref[f"{k}_words"])
        np.testing.assert_array_equal(got[f"{k}_bits"], ref[f"{k}_bits"])
    np.testing.assert_array_equal(got["numbps"], ref["numbps"])
    np.testing.assert_array_equal(got["u_max"], ref["u_max"])
    # float64 against float32 sums of the same float32 squares
    np.testing.assert_allclose(got["dist"], ref["dist"], rtol=1e-6)


@pytest.mark.parametrize("mag", [255, 65535, 1 << 20])
def test_distortion_is_the_float64_sum_near_jax_float32(mag):
    """The plain distortion of 64x64 blocks is the float32 rounding of the
    exact sum of the float32 squares (float64 holds it exactly up to 2^20
    magnitudes), and within a relative 1e-5 of the JAX package's float32
    sum (6.3e-6 apart at 8-bit magnitudes, where float32 loses the low
    bits of a sum past 2^24)."""
    rng = np.random.RandomState(mag % 97)
    arr = rng.randint(-mag, mag + 1, size=(4, 64, 64)).astype(np.int32)
    arr[1, :, 40:] = 0
    hs = np.full(4, 64, np.int32)
    ws = np.full(4, 64, np.int32)
    got = ht_enc.cleanup_fields(torch.from_numpy(arr), hs, ws, 31)["dist"]
    exact = (np.abs(arr).astype(np.float32) ** 2).astype(np.float64).sum(
        axis=(1, 2)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), exact)
    ref = np.asarray(ht_tpu._fields_fn(64, 64, 31)(arr, hs, ws)["dist"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def _pack_fields(nb, f, rows):
    """Fields [nb, f] (values masked to their lengths): random lengths
    0..31; "spill", row r an r-bit field then 31-bit fields, so fields
    spill at every bit offset 0..31; "zeros", all lengths 0."""
    rng = np.random.RandomState(f)
    lens = rng.randint(0, 32, (nb, f)).astype(np.int32)
    if rows == "spill":
        lens[:] = 31
        lens[:, 0] = np.arange(nb) % 32
    elif rows == "zeros":
        lens[:] = 0
    vals = (rng.randint(0, 2 ** 31, (nb, f))
            & ((np.int64(1) << lens) - 1)).astype(np.int32)
    return vals, lens


@pytest.mark.parametrize(
    "nb,f,n_words,rows",
    [(5, 40, 40, "random"), (16, 300, 300, "random"), (3, 1, 2, "random"),
     (32, 40, 40, "spill"), (7, 6, 6, "random"), (3, 1537, 1537, "random"),
     (4, 37, 3, "zeros")],
    ids=["5-40-40", "16-300-300", "3-1-2", "spill-every-offset", "f6",
         "f1537", "zero-rows"])
def test_pack_bits_matches_jax(nb, f, n_words, rows):
    vals, lens = _pack_fields(nb, f, rows)
    ref_words, ref_bits = jax.jit(ht_tpu._pack_bits, static_argnums=2)(
        vals.view(np.uint32), lens, n_words)
    words, bits = ht_enc.pack_bits(torch.from_numpy(vals),
                                   torch.from_numpy(lens), n_words)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(ref_words))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_bits))


def test_pack_streams_on_cpu_is_pack_bits_per_stream():
    # the fused cleanup-and-pack wrapper's CPU path: each stream of the
    # plain cleanup_values through the plain pack_bits, in order
    arr, hs, ws = _batch(_ragged())
    blocks = torch.from_numpy(arr)
    got = ht_enc_cuda.cleanup_fields(blocks, hs, ws, 16)
    fields = ht_enc.cleanup_values(blocks, hs, ws)
    for name, n_words in zip(("ms", "vlc", "mel"), ht_enc.stream_words(
            arr.shape[1], arr.shape[2], 16)):
        rw, rb = ht_enc.pack_bits(fields[f"{name}_vals"],
                                  fields[f"{name}_lens"], n_words)
        assert torch.equal(got[f"{name}_words"], rw)
        assert torch.equal(got[f"{name}_bits"], rb)
    for k in ("numbps", "u_max", "dist"):
        assert torch.equal(got[k], fields[k]), k


def test_pack_bits_refuses_too_few_words():
    vals = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.full((2, 4), 31, dtype=torch.int32)
    with pytest.raises(ValueError, match="more than 3 words"):
        ht_enc.pack_bits(vals, lens, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_pool_matches_jax(seed):
    rng = np.random.RandomState(seed)
    nb, w = 9, 24
    bits = rng.randint(0, 32 * w + 1, nb).astype(np.int32)
    bits[rng.rand(nb) < 0.3] = 0
    words = rng.randint(0, 2 ** 32, (nb, w), dtype=np.uint64)
    words[np.arange(w)[None, :] >= ((bits[:, None] + 31) >> 5)] = 0
    words = words.astype(np.uint32)
    cap = nb * w
    ref_pool, ref_off, ref_nw = (np.asarray(a) for a in ht_tpu.compact_pool(
        words, bits, cap))
    pool, off, nw = ht_enc.compact_pool(torch.from_numpy(words.view(
        np.int32)), torch.from_numpy(bits))
    used = int(ref_nw.sum())
    assert pool.numel() == used
    np.testing.assert_array_equal(pool.numpy().view(np.uint32),
                                  ref_pool[:used])
    np.testing.assert_array_equal(off.numpy(), ref_off)
    np.testing.assert_array_equal(nw.numpy(), ref_nw)
    host_off, host_nw = ht_enc.pool_offsets(bits, 5)
    np.testing.assert_array_equal(host_off, ref_off + 5)
    np.testing.assert_array_equal(host_nw, ref_nw)


# ------------------------------------------- the pool kernels' decomposition

SCAN_THREADS = rc.define("ht_enc.cu", "SCAN_THREADS")
COPY_WARPS = rc.define("ht_enc.cu", "COPY_WARPS")
HT_COPY_UNROLL = rc.define("ht_enc.cu", "HT_COPY_UNROLL")


def _row_words(bits):
    return (bits.astype(np.int64) + 31) >> 5


def _pool_scan_model(bits):
    """ht_pool_scan_kernel on one stream's bit counts: a thread a tile of
    COPY_WARPS rows (its word count in an int), SCAN_THREADS tiles a round,
    an inclusive scan of the tile counts over each warp's 32 threads, then
    over the warps, with a carry between rounds.  Returns (each tile's
    offset, the total)."""
    nb = bits.size
    ntiles = -(-nb // COPY_WARPS)
    words = np.zeros(ntiles * COPY_WARPS, np.int64)
    words[:nb] = _row_words(bits)
    own = words.reshape(ntiles, COPY_WARPS).sum(axis=1)
    assert own.max(initial=0) < 2 ** 31
    tiles = np.zeros(ntiles, np.int64)
    carry = 0
    for base in range(0, ntiles, SCAN_THREADS):
        run = np.zeros(SCAN_THREADS, np.int64)
        m = min(SCAN_THREADS, ntiles - base)
        run[:m] = own[base:base + m]
        incl = np.cumsum(run.reshape(-1, 32), axis=1)
        warp_incl = np.cumsum(incl[:, -1])
        warp_before = np.concatenate([[0], warp_incl[:-1]])
        excl = (carry + warp_before[:, None] + incl).reshape(-1) - run
        tiles[base:base + m] = excl[:m]
        carry += int(warp_incl[-1])
    return tiles, carry


def _compact_pool_model(args, word_phase, out_phase):
    """ht_compact_pool in numpy: the scan of the three streams' tiles, then
    a CTA per (tile, stream), a warp a row finding its offset from the
    tile's and a shuffle scan of the tile's word counts, and each CTA
    writing meta rows 2s and 2s + 1 of its tile; the word rows start
    word_phase words and the output out_phase words past a 16-byte
    boundary.  Returns (the used prefix int32, totals, every store
    (address, size), the output's first address)."""
    ms_w, ms_b, vlc_w, vlc_b, mel_w, mel_b, numbps, u_max, dist = args
    nb = ms_b.size
    words, bits = (ms_w, vlc_w, mel_w), (ms_b, vlc_b, mel_b)
    scans = [_pool_scan_model(b) for b in bits]
    totals = [t for _o, t in scans]
    meta = (ms_b, vlc_b, mel_b, numbps, u_max, dist.view(np.int32))
    out = np.full(nb * (6 + sum(w.shape[1] for w in words)), 0x5A5A5A5A,
                  np.int32)
    mem = rc.Mem(out, 4 * out_phase)
    stores = []
    for x in range(-(-nb // COPY_WARPS)):
        first = x * COPY_WARPS
        for s in range(3):
            for t in range(2 * COPY_WARPS):
                m, r = 2 * s + t // COPY_WARPS, first + t % COPY_WARPS
                if r < nb:
                    out[m * nb + r] = meta[m][r]
                    stores.append((mem.addr(4 * (m * nb + r)), 4))
            width = words[s].shape[1]
            src = rc.Mem(words[s], 4 * word_phase)
            cnt = _row_words(bits[s][first:first + COPY_WARPS])
            for w, row in enumerate(range(first, min(first + COPY_WARPS,
                                                     nb))):
                nw = min(width, int(cnt[w]))
                at = (6 * nb + sum(totals[:s]) + int(scans[s][0][x])
                      + int(cnt[:w].sum()))
                rc.warp_copy(mem, 4 * at, src, 4 * row * width, 4 * nw,
                             stores, HT_COPY_UNROLL)
    used = 6 * nb + sum(totals)
    return out[:used], totals, stores, mem.addr(0)


POOL_CASES = ht_enc_cuda.pool_stress_cases()


@pytest.mark.parametrize("word_phase", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(set(POOL_CASES) - {"two_rounds"}))
def test_compact_pool_kernel_model(name, word_phase):
    """The pool kernels' decomposition (ht_compact_pool: a scan of tiles of
    8 rows, a warp per (row, stream), 16-byte windows realigned to the
    pool, narrower stores at each row's ends) equals ht_enc.assemble_pool
    on ht_enc_cuda.pool_stress_cases, with the word rows and the output at
    every phase of 0 to 3 words past a 16-byte boundary; every store is
    aligned, inside its row's range, and the stores cover the used prefix
    exactly once."""
    args = POOL_CASES[name]
    want, wtot = ht_enc.assemble_pool(*(torch.from_numpy(a) for a in args))
    for out_phase in range(4):
        got, totals, stores, lo = _compact_pool_model(args, word_phase,
                                                      out_phase)
        assert totals == wtot.tolist()
        np.testing.assert_array_equal(got, want.numpy())
        rc.check_stores(stores, lo, lo + 4 * got.size)
    if name == "all_empty":
        assert totals == [0, 0, 0]


def test_compact_pool_kernel_model_two_rounds():
    """The same on more rows than the scan stages at a time (two rounds;
    a multiple of neither a round nor a copy CTA's rows)."""
    args = POOL_CASES["two_rounds"]
    nb = args[1].size
    assert nb > SCAN_THREADS * COPY_WARPS and nb % COPY_WARPS
    want, wtot = ht_enc.assemble_pool(*(torch.from_numpy(a) for a in args))
    got, totals, stores, lo = _compact_pool_model(args, 1, 2)
    assert totals == wtot.tolist()
    np.testing.assert_array_equal(got, want.numpy())
    rc.check_stores(stores, lo, lo + 4 * got.size)


def test_cleanup_fields_compact_matches_jax():
    arr, hs, ws = _batch(_ragged())
    nb = len(hs)
    caps = (nb * 2000, nb * 400, nb * 40)
    ref = np.asarray(jax.jit(ht_tpu.cleanup_fields_compact,
                             static_argnums=(3, 4, 5, 6))(arr, hs, ws, 16,
                                                          *caps))
    out, totals = ht_enc.cleanup_fields_compact(torch.from_numpy(arr), hs,
                                                ws, 16)
    out = out.numpy().view(np.uint32)
    totals = totals.numpy()
    assert out.size == 6 * nb + totals.sum()
    np.testing.assert_array_equal(out[:6 * nb], ref[:6 * nb])
    base_ref, base = 6 * nb, 6 * nb
    for cap, tot in zip(caps, totals):
        np.testing.assert_array_equal(out[base:base + tot],
                                      ref[base_ref:base_ref + tot])
        assert not ref[base_ref + tot:base_ref + cap].any()
        base += tot
        base_ref += cap


@pytest.mark.parametrize("serializer", ["native", "python"])
def test_serializers_on_port_pool_give_oracle_segments(serializer):
    cases = _ragged()
    arr, hs, ws = _batch(cases)
    nb = len(cases)
    out, totals = ht_enc.cleanup_fields_compact(torch.from_numpy(arr), hs,
                                                ws, 16)
    out = out.numpy()
    meta = out[:6 * nb].reshape(6, nb)
    pool = out[6 * nb:].view(np.uint32)
    tot = totals.numpy()
    bases = (0, tot[0], tot[0] + tot[1])
    place = [ht_enc.pool_offsets(meta[s], bases[s]) for s in range(3)]
    if serializer == "native":
        segs = loader.ht_serialize_blocks(
            pool, *place[0], meta[0], *place[1], meta[1], *place[2],
            meta[2], meta[3])
    else:
        segs = []
        for i in range(nb):
            streams = []
            for s in range(3):
                off, nw = int(place[s][0][i]), int(place[s][1][i])
                streams += [pool[off:off + nw], int(meta[s][i])]
            segs.append(ht_enc.serialize_block(*streams, int(meta[3][i]))[0])
    for i, c in enumerate(cases):
        assert segs[i] == jht.encode_cleanup(c)[0], (i, c.shape)


def _plan_pair(frames, lossless):
    """The port's and the JAX package's headers, tiles and plans."""
    ropts = Options(format=Format.J2K, lossless=lossless, quality=85,
                    num_resolutions=6, high_throughput=True)
    popts = tp.options_from_reference(ropts)
    out = []
    for enc, geo_mod, fe, opts in ((encoder, geo, fused_encode, popts),
                                   (jenc, jgeo, jfe, ropts)):
        header = enc.build_header(frames[0], opts)
        enc._apply_comp_quants(header, opts, header.num_components,
                               header.components[0].precision)
        tile = geo_mod.build_tile(header, 0)
        out.append(fe.plan_for(header, tile, lossy=not lossless))
    return out


@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("shape", [(128, 128), (96, 80), (64, 64, 3)])
def test_extract_blocks_matches_jax(shape, lossless):
    import jax.numpy as jnp
    rng = np.random.RandomState(sum(shape))
    frames = [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(2)]
    plan, jplan = _plan_pair(frames, lossless)
    assert plan.band_specs == jplan.band_specs
    assert plan.deltas == jplan.deltas
    batch = np.stack([np.stack(encoder._image_components(f))
                      for f in frames])
    kind = dwt.REV53 if lossless else dwt.IRR97
    levels = 5
    pyr = transforms.forward_pyramid(
        transforms.upload(batch, torch.device("cpu")), levels, kind,
        batch.shape[1] >= 3, 8, False, 0, 0)
    got = fused_encode.extract_blocks(pyr, plan, 2, levels)
    jpyr = [{k: jnp.asarray(v.contiguous().numpy()) for k, v in e.items()}
            for e in pyr]
    ref = np.asarray(jfe._extract_blocks(jpyr, jplan, 2, levels))
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.abs(ref).max() > 0


def test_fused_chunk_matches_jax_program():
    # the whole lossless device program: the port's fused_encode_chunk on
    # the CPU against the JAX package's jitted _fused_fn, meta and pools
    frames = [np.random.RandomState(i).randint(0, 256, (64, 96, 3)
                                               ).astype(np.uint8)
              for i in range(2)]
    plan, jplan = _plan_pair(frames, True)
    batch = np.stack([np.stack(encoder._image_components(f))
                      for f in frames])
    out, totals = fused_encode.fused_encode_chunk(
        batch, plan, 5, dwt.REV53, True, 8, False, "cpu")
    out = out.numpy()
    totals = totals.numpy()
    nb = 2 * plan.nb
    assert out.size == 6 * nb + int(totals.sum())
    caps = tuple(nb * n for n in ht_enc.stream_words(      # every bound
        jplan.cbh, jplan.cbw, jplan.max_mn))
    ref = np.asarray(jfe._fused_fn(2, 3, 64, 96, 5, True, 8, False,
                                   jfe._plan_key(jplan), *caps)(
        batch.reshape(-1)))
    np.testing.assert_array_equal(out[:5 * nb], ref[:5 * nb].view(np.int32))
    # the distortion: XLA sums each block's 4096 float32 squares in the
    # fused program's own order, a few ulps from torch's sum
    np.testing.assert_allclose(out[5 * nb:6 * nb].view(np.float32),
                               ref[5 * nb:6 * nb].view(np.float32),
                               rtol=1e-5)
    base, jbase = 6 * nb, 6 * nb
    for tot, cap in zip(totals, caps):
        np.testing.assert_array_equal(out[base:base + tot].view(np.uint32),
                                      ref[jbase:jbase + tot])
        base += tot
        jbase += cap
