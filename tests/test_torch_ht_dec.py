"""The port's plain device HT decode (go_jpeg2000_tpu_torch/ops/ht_dec.py)
against the JAX package's (ops/ht_tpu_decode.py), on the CPU.  Frames come
from a numpy seed, are encoded by the port, and both packages' native
loaders parse them (the two parses must be equal).  Tolerances:
magsgn_decode_blocks exact, against the JAX package and against the
all-host native ht_t2_decode_frames; blocks_to_pyramid exact, float32
leaves too (the same float32 operations in the same order: (|q| + 0.5) *
delta, then the sign); fused_decode exact for lossless, within one grey
level for lossy (the JAX package's jitted float32 lifting may round a
sample the other way).

A CPU model of the ht_magsgn_decode kernel's decomposition (threads of
QUADS_PER_THREAD consecutive quads, a serial prefix inside a thread and a
scan of the thread totals, the block's words staged in a window of
STAGE_WORDS words from the 16-byte boundary below its first word, fields
as funnel shifts of a word pair that slides along, two 32-byte runs per
thread or per-quad stores) equals magsgn_decode_blocks and the JAX
package, exactly, on ht_dec.stress_cases (32-bit fields, uncoded blocks,
a block at the pool's end, odd widths, offsets with gaps, a block past the
window) and on real parses; tests/test_torch_cuda.py and chip_smoke.py put
the kernel to the same cases on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.codestream.parser import Parser as JParser
from go_jpeg2000_tpu.models import fused_encode as jfe
from go_jpeg2000_tpu.native import loader as jloader
from go_jpeg2000_tpu.ops import ht_tpu_decode
from go_jpeg2000_tpu.tcd import geometry as jgeo
from go_jpeg2000_tpu_torch.models import decoder
from go_jpeg2000_tpu_torch.native import loader
from go_jpeg2000_tpu_torch.ops import dwt, ht_dec, ht_dec_cuda


def _nat(h, w, seed, depth=8):
    """tests/test_ht_device_decode.py's frames."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << depth, (h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    return a.astype(np.uint8 if depth <= 8 else np.uint16)


def _rgb(h, w, seeds):
    return [np.stack([_nat(h, w, s + c) for c in (0, 9, 17)], axis=-1)
            for s in seeds]


# the cases of tests/test_ht_device_decode.py, and a lossy RGB one
CASES = {
    "gray": ([_nat(96, 96, i) for i in range(3)], dict(num_resolutions=4)),
    "odd": ([_nat(130, 97, i + 5) for i in range(2)],
            dict(num_resolutions=3)),
    "16bit": ([_nat(64, 64, i + 11, depth=16) for i in range(2)],
              dict(num_resolutions=3)),
    "rgb": (_rgb(96, 96, (0, 1)), dict(num_resolutions=4)),
    "small_blocks": ([_nat(128, 128, i + 23) for i in range(2)],
                     dict(num_resolutions=3, ht_block_width=32,
                          ht_block_height=32)),
    "lossy_rgb": (_rgb(80, 72, (3, 4)),
                  dict(num_resolutions=6, lossless=False, quality=85)),
}


def _case(name):
    """(frames, streams, the port's Batch, the JAX package's plan, the
    parse as numpy arrays)."""
    frames, extra = CASES[name]
    opts = tp.Options(**{**dict(format=tp.Format.J2K, lossless=True,
                                high_throughput=True), **extra})
    streams = tp.encode_batch(frames, opts, device="cpu")
    batch = decoder.prepare_batch(streams)
    assert batch is not None
    args = decoder._native_args(batch, batch.bodies)
    ours = loader.ht_t2_parse_frames(*args)
    hdr = JParser(streams[0]).read_header()
    tile = jgeo.build_tile(hdr, 0)
    jplan = jfe.plan_for(hdr, tile, lossy=batch.kind == dwt.IRR97)
    assert jplan.band_specs == batch.plan.band_specs
    assert jplan.deltas == batch.plan.deltas
    jgeom = jfe.t2_geom(hdr, tile, jplan)
    ref = jloader.ht_t2_parse_frames(args[0], args[1], len(streams), jplan.nb,
                                     jgeom, jgeom["mb"], jplan.ws, jplan.hs,
                                     jplan.cbh, jplan.cbw)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    return frames, streams, batch, jplan, ours


def _blocks(batch, parsed):
    qinfo, pool, woff, *_ = parsed
    return ht_dec.magsgn_decode_blocks(
        torch.from_numpy(qinfo.view(np.int32)),
        torch.from_numpy(pool.view(np.int32)), torch.from_numpy(woff),
        batch.plan.cbh, batch.plan.cbw)


@pytest.mark.parametrize("name", list(CASES))
def test_magsgn_decode_matches_jax_and_native(name):
    """Also the MagSgn kernel's model: on a parse (blocks one after
    another) every word it reads lies in its block's window."""
    _frames, _streams, batch, jplan, parsed = _case(name)
    qinfo, pool, woff, *_ = parsed
    got = _blocks(batch, parsed).numpy()
    model, inside, outside = _magsgn_model(
        qinfo.view(np.int32), pool.view(np.int32), woff, batch.plan.cbh,
        batch.plan.cbw)
    np.testing.assert_array_equal(model, got)
    assert inside > 0 and outside == 0
    ref = np.asarray(jax.jit(ht_tpu_decode.magsgn_decode_blocks,
                             static_argnums=(3, 4))(
        qinfo, pool, woff.astype(np.int32), jplan.cbh, jplan.cbw))
    assert got.dtype == np.int32 and np.abs(got).max() > 0
    np.testing.assert_array_equal(got, ref)
    host = loader.ht_t2_decode_frames(*decoder._native_args(batch,
                                                            batch.bodies))
    np.testing.assert_array_equal(got, host.reshape(got.shape))


@pytest.mark.parametrize("name,dequant", [
    ("gray", False), ("odd", False), ("rgb", False), ("small_blocks", False),
    ("lossy_rgb", False), ("lossy_rgb", True)])
def test_blocks_to_pyramid_matches_jax(name, dequant):
    _frames, streams, batch, jplan, parsed = _case(name)
    blocks = _blocks(batch, parsed)
    n = len(streams)
    got = ht_dec.blocks_to_pyramid(blocks, batch.plan, n, batch.n_comps,
                                   batch.nl, dequant)
    ref = ht_tpu_decode.blocks_to_pyramid_dev(
        jnp.asarray(blocks.numpy()), jplan, n, batch.n_comps, batch.nl,
        dequant)
    assert [sorted(e) for e in got] == [sorted(e) for e in ref]
    for g, r in zip(got, ref):
        for k in r:
            r_k = np.asarray(r[k])
            assert g[k].dtype == (torch.float32 if dequant else torch.int32)
            assert tuple(g[k].shape) == r_k.shape
            # float32 leaves bit for bit, int32 leaves exact
            np.testing.assert_array_equal(g[k].numpy().view(np.int32),
                                          r_k.view(np.int32))


@pytest.mark.parametrize("name", list(CASES))
def test_fused_decode_matches_jax(name):
    frames, streams, batch, jplan, parsed = _case(name)
    qinfo, pool, woff = decoder.upload_parsed(*parsed[:3],
                                              torch.device("cpu"))
    n = len(streams)
    got = ht_dec.fused_decode(qinfo, pool, woff, batch.plan, n,
                              batch.n_comps, batch.nl, batch.kind,
                              batch.use_mct, batch.precision, batch.signed)
    fn = ht_tpu_decode.fused_decode_fn(
        n, batch.n_comps, batch.nl, jfe._plan_key(jplan), batch.precision,
        batch.signed, batch.use_mct, len(parsed[1]), kind=batch.kind)
    ref = np.asarray(fn(parsed[0], parsed[1], parsed[2].astype(np.int32)))
    dt = ref.dtype
    got = got.numpy().view(dt)
    assert got.shape == ref.shape
    want = np.stack([np.moveaxis(f.reshape(f.shape[:2] + (-1,)), -1, 0)
                     for f in frames]).reshape(-1)
    if batch.kind == dwt.REV53:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(np.int64) - ref).max() <= 1


@pytest.mark.parametrize("lossless", [True, False])
def test_blocks_to_pyramid_offset_grid_matches_jax(lossless):
    # a tile origin off (0, 0) offsets the code-block grids (the rolls);
    # the port's encoder refuses such images, so the JAX package encodes
    from go_jpeg2000_tpu.models.encoder import encode_batch as jax_encode
    from go_jpeg2000_tpu.options import Format, Options
    frames = [_nat(72, 88, 40 + i) for i in range(2)]
    streams = jax_encode(frames, Options(
        format=Format.J2K, lossless=lossless, quality=85, num_resolutions=4,
        high_throughput=True, image_offset=(48, 16)))
    batch = decoder.prepare_batch(streams)
    assert batch is not None
    assert not batch.on_device
    assert any(spec[9] or spec[10] for spec in batch.plan.band_specs)
    hdr = JParser(streams[0]).read_header()
    jplan = jfe.plan_for(hdr, jgeo.build_tile(hdr, 0), multi_tile=True,
                         lossy=not lossless)
    assert jplan.band_specs == batch.plan.band_specs
    coeffs = loader.ht_t2_decode_frames(*decoder._native_args(
        batch, batch.bodies))
    blocks = torch.from_numpy(coeffs).reshape(-1, jplan.cbh, jplan.cbw)
    for dequant in (False, True) if not lossless else (False,):
        got = ht_dec.blocks_to_pyramid(blocks, batch.plan, 2, 1, batch.nl,
                                       dequant)
        ref = ht_tpu_decode.blocks_to_pyramid_dev(
            jnp.asarray(coeffs), jplan, 2, 1, batch.nl, dequant)
        host = decoder._blocks_to_pyramid(coeffs, batch.plan, 2, 1, batch.nl)
        for g, r, h in zip(got, ref, host):
            assert sorted(g) == sorted(r)
            for k in r:
                np.testing.assert_array_equal(
                    g[k].numpy().view(np.int32),
                    np.asarray(r[k]).view(np.int32))
                if not dequant:
                    np.testing.assert_array_equal(g[k].numpy(), h[k])


# ------------------------------------------ the MagSgn kernel's decomposition

def _magsgn_model(qinfo, pool, woff, cbh, cbw):
    """ht_magsgn_decode as the kernel computes it, every block's threads at
    once: (int32 [NB, cbh, cbw], words read inside the window, words read
    from the pool outside it)."""
    nb, qh, qw = qinfo.shape
    nq = qh * qw
    per = ht_dec_cuda.QUADS_PER_THREAD
    stage = ht_dec_cuda.STAGE_WORDS
    words = pool.astype(np.uint32).astype(np.int64)
    pw = words.size
    last = pw - 1
    busy = -(-nq // per)                     # threads with quads
    threads = min(max(-(-busy // 32) * 32, 32), ht_dec_cuda.MS_THREADS)
    out = np.full((nb, cbh, cbw), -7, np.int64)
    inside = outside = 0
    for b in range(nb):
        a0 = max(int(woff[b]) & ~3, 0)
        a1 = int(woff[b + 1]) + 1 if b + 1 < nb else pw
        a1 = min(a1, pw, a0 + stage)
        staged = max(a1 - a0, 0)
        win = np.zeros(stage, np.int64)      # cp.async zero-fills the tail
        win[:staged] = words[a0:a0 + staged]
        q = qinfo[b].reshape(-1).astype(np.uint32).astype(np.int64)
        base = int(woff[b]) * 32
        for q0 in range(0, nq, per * threads):
            qs = q0 + per * np.arange(threads)
            info = np.zeros((threads, per), np.int64)
            for k in range(per):
                ok = qs + k < nq
                info[ok, k] = q[(qs + k)[ok]]
            u, rho = info & 0xFF, (info >> 8) & 0xF
            ek, e1 = (info >> 12) & 0xF, (info >> 16) & 0xF
            m = np.stack([np.where((rho >> i) & 1, u - ((ek >> i) & 1), 0)
                          for i in range(4)], axis=-1)        # [T, per, 4]
            tot = m.reshape(threads, -1).sum(axis=1)
            pos = base + np.cumsum(tot) - tot                 # block scan
            base += int(tot.sum())
            c = np.zeros((threads, per, 4), np.int64)
            for t in np.nonzero(qs < nq)[0]:
                p, cw, lo, hi = int(pos[t]), None, 0, 0

                def word(i):
                    nonlocal inside, outside
                    i = max(min(i, last), 0)
                    if 0 <= i - a0 < staged:
                        inside += 1
                        return int(win[i - a0])
                    outside += 1
                    return int(words[i])
                for k in range(per):
                    for i in range(4):
                        if not (rho[t, k] >> i) & 1:
                            continue
                        mi = int(m[t, k, i])
                        wi = p >> 5
                        if wi != cw:
                            lo = hi if cw is not None and wi == cw + 1 \
                                else word(wi)
                            hi = word(wi + 1)
                            cw = wi
                        v = ((hi << 32 | lo) >> (p & 31)) & 0xFFFFFFFF
                        v &= 0xFFFFFFFF if mi >= 32 else (1 << mi) - 1
                        if mi < 32:
                            v |= ((int(e1[t, k]) >> i) & 1) << mi
                        c[t, k, i] = -((v >> 1) + 1) if v & 1 else (v >> 1) + 1
                        p += mi
            # stores: two 32-byte runs for 4 quads of one quad row, else per
            # quad
            for t in np.nonzero(qs < nq)[0]:
                for k in range(per):
                    qq = int(qs[t]) + k
                    if qq >= nq:
                        break
                    y, x = 2 * (qq // qw), 2 * (qq % qw)
                    for r in range(2):
                        for j in range(2):
                            if y + r < cbh and x + j < cbw:
                                out[b, y + r, x + j] = c[t, k, r + 2 * j]
    return out.astype(np.int32), inside, outside


def _stress(name):
    for case in ht_dec.stress_cases(ht_dec_cuda.STAGE_WORDS):
        if case[0] == name:
            return case[1:]
    raise KeyError(name)


STRESS = ["m32", "uncoded", "pool_end", "odd", "odd_small", "gaps", "wide",
          "wide_62"]


@pytest.mark.parametrize("name", STRESS)
def test_magsgn_stress_cases_match_jax(name):
    """ht_dec.stress_cases (what tests/test_torch_cuda.py and chip_smoke.py
    put to the kernel on the card): the kernel's model, the plain version
    and the JAX package agree exactly, and the blocks the cases put past
    their windows do read past them."""
    q, buf, woff, cbh, cbw, off = _stress(name)
    pool = buf[off:]
    got, inside, outside = _magsgn_model(q, pool, woff, cbh, cbw)
    plain = ht_dec.magsgn_decode_blocks(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(woff),
        cbh, cbw).numpy()
    np.testing.assert_array_equal(got, plain)
    ref = np.asarray(jax.jit(ht_tpu_decode.magsgn_decode_blocks,
                             static_argnums=(3, 4))(
        q.view(np.uint32), pool.view(np.uint32), woff.astype(np.int32), cbh,
        cbw))
    np.testing.assert_array_equal(plain, ref)
    assert inside > 0
    if name in ("m32", "gaps"):
        assert outside > 0
    elif name != "pool_end":
        assert outside == 0, outside
