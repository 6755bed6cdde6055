"""CPU models of the two code-block layout kernels: ht_extract_blocks
(csrc/ht_enc.cu extract_kernel: pyramid leaves -> block slots) and
ht_blocks_to_pyramid (csrc/ht_dec.cu to_pyramid_kernel: slots -> leaves),
decomposed as the kernels decompose them (csrc/block_layout.cuh): CTAs,
warps and lanes, the per-frame descriptors of ops/block_layout.py, the
16-byte windows, their realignment in registers, zero fill, several slots
a CTA, and the frame loop over gridDim.y.

Each model runs on block_layout.layout_stress_cases (what chip_smoke.py and
tests/test_torch_cuda.py put to the kernels on the card) and is held to the
plain version (fused_encode.extract_blocks, ht_dec.blocks_to_pyramid) and,
through it, to the JAX package's _extract_blocks and blocks_to_pyramid_dev
on the CPU: lossless equal, float32 leaves bit for bit.  The models also
assert that every slot word and every leaf sample is written exactly once,
that no extraction load leaves its slot row's run of the leaf, and that
the assembly reads only the slots' valid samples.  Also: the per-plan
caches hold their plans, and the layout refuses what the kernels cannot
take."""
import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

from go_jpeg2000_tpu.models import fused_encode as jfe
from go_jpeg2000_tpu.ops import ht_tpu_decode
from go_jpeg2000_tpu_torch.models import fused_encode
from go_jpeg2000_tpu_torch.ops import (block_layout, ht_dec, ht_dec_cuda,
                                       ht_enc_cuda)
from tests import row_copy_model as rc

EX_THREADS = rc.define("ht_enc.cu", "EX_THREADS")
EX_VECS = rc.define("ht_enc.cu", "EX_VECS")
AS_WARPS = rc.define("ht_dec.cu", "AS_WARPS")
AS_WINDOWS = rc.define("ht_dec.cu", "AS_WINDOWS")
GRID_Y = 65535                       # the launches' largest gridDim.y
CASES = {c[0]: c for c in block_layout.layout_stress_cases()}
# cases whose leaf rows are all 16-byte aligned (one load a vector)
ALIGNED = ("gray",)


def _log2(v):
    return int(v).bit_length() - 1


def _realign(x, y, m):
    """realign_words: words m .. m + 3 of x | y, [V, 4] each."""
    h, q = (m & 2) > 0, (m & 1) > 0
    t = [np.where(h, a, b) for a, b in ((x[:, 2], x[:, 0]), (x[:, 3], x[:, 1]),
                                        (y[:, 0], x[:, 2]), (y[:, 1], x[:, 3]),
                                        (y[:, 2], y[:, 0]))]
    return np.stack([np.where(q, t[k + 1], t[k]) for k in range(4)], axis=1)


def _quantize(words, delta):
    """quantize4 on int32 words holding float32 bit patterns."""
    f = words.astype(np.int32).view(np.float32)
    q = np.floor(np.abs(f) / delta.astype(np.float32)[:, None]).astype(
        np.int64)
    return np.where(f < 0, -q, np.where(f > 0, q, 0))


def _extract_model(leaves, phases, desc, n, nb, cbh, cbw, lossy,
                   grid_y=GRID_Y):
    """extract_kernel over its whole grid: leaves [n, C, bh, bw] in launch
    order, each `phases[i]` words past a 16-byte boundary.  Returns (slots
    int32 [n * nb, cbh, cbw], vector loads, word loads)."""
    flat = np.concatenate([a.reshape(-1).view(np.int32) for a in leaves])
    base = np.cumsum([0] + [a.size for a in leaves])[:-1]
    slot_vecs, row_vecs = cbh * cbw // 4, cbw // 4
    frame_vecs = nb * slot_vecs
    per_cta = EX_THREADS * EX_VECS
    grid_x = -(-frame_vecs // per_cta)
    # thread t of CTA bx stores vectors bx * per_cta + u * EX_THREADS + t
    v = (np.arange(grid_x)[:, None, None] * per_cta
         + np.arange(EX_VECS)[None, :, None] * EX_THREADS
         + np.arange(EX_THREADS)[None, None, :]).reshape(-1)
    v = v[v < frame_vecs]
    j = v >> _log2(slot_vecs)
    w = v & (slot_vecs - 1)
    r, c = w >> _log2(row_vecs), (w & (row_vecs - 1)) << 2
    d = desc[j].astype(np.int64)             # each lane's descriptor
    live = (r < d[:, 1]) & (c < d[:, 2])     # padding: zeros, no load
    d, r, c = d[live], r[live], c[live]
    leaf = d[:, 0]
    out = np.zeros((n, frame_vecs, 4), np.int64)
    writes = np.zeros((n, frame_vecs), np.int64)
    vec_loads = word_loads = 0
    for by in range(min(n, grid_y)):
        for f in range(by, n, grid_y):
            lo = f * d[:, 5] + d[:, 4] + r * d[:, 3]    # the row's run
            hi = lo + d[:, 2]
            src = lo + c
            m = (phases[leaf] + src) & 3
            a = src - m

            def window(at, wanted):
                nonlocal vec_loads, word_loads
                idx = at[:, None] + np.arange(4)
                inside = wanted[:, None] & (idx >= lo[:, None]) & (
                    idx < hi[:, None])
                whole = wanted & (at >= lo) & (at + 4 <= hi)
                assert ((phases[leaf] + at)[whole] % 4 == 0).all()
                vec_loads += int(whole.sum())
                word_loads += int(inside[~whole].sum())
                return np.where(inside, flat[np.where(
                    inside, base[leaf][:, None] + idx, 0)], 0)

            x = window(a, np.ones(len(a), bool))
            y = window(a + 4, (m > 0) & (a + 4 < hi))
            words = _realign(x, y, m)
            if lossy:
                words = _quantize(words, d[:, 6].astype(np.int32).view(
                    np.float32))
            vals = np.zeros((len(v), 4), np.int64)
            vals[live] = words
            out[f, v] = vals
            writes[f, v] += 1
    assert (writes == 1).all(), "a slot vector stored twice or never"
    return (out.astype(np.int32).reshape(n * nb, cbh, cbw), vec_loads,
            word_loads)


def _dequant(q, delta):
    """dequant: float32 bits of sign(q) * (|q| + 0.5) * delta."""
    a = ((np.abs(q).astype(np.float32) + np.float32(0.5))
         * delta.astype(np.float32))
    return np.where(q < 0, -a, np.where(q > 0, a, np.float32(0))).astype(
        np.float32).view(np.int32)


def _pyramid_model(slots, rows, leaf_off, total, n, nb, cbh, cbw, dequant,
                   valid, grid_y=GRID_Y):
    """to_pyramid_kernel over its whole grid on slots int32 [n * nb, cbh,
    cbw] (16-byte aligned, as the wrapper requires); valid [nb] the
    (rows, cols) each slot holds.  Returns the buffer int32 [total] (float32
    bit patterns where dequant) and the count of 16-byte loads."""
    flat = slots.reshape(-1).astype(np.int64)
    shift = _log2(cbh * cbw)
    n_rows = rows.shape[0]
    grid_x = -(-n_rows // AS_WARPS)
    i = (np.arange(grid_x)[:, None] * AS_WARPS
         + np.arange(AS_WARPS)[None, :]).reshape(-1)
    i = i[i < n_rows]                        # warps past the rows return
    d = rows[i].astype(np.int64)
    bw, ox, lw = d[:, 1], d[:, 6] & 0xFFFF, d[:, 6] >> 16
    buf = np.full(total, -7, np.int64)
    writes = np.zeros(total, np.int64)
    loads = 0
    for by in range(min(n, grid_y)):
        for f in range(by, n, grid_y):
            e0 = leaf_off[d[:, 0]] + d[:, 2] + f * d[:, 3]
            k0, k1 = e0 >> 2, (e0 + bw - 1) >> 2
            nwin = k1 - k0 + 1
            # lane l, step s, window u of a step: offset l + 32 (U s + u)
            steps = -(-nwin.max() // (32 * AS_WINDOWS))
            offs = (np.arange(32)[:, None, None]
                    + 32 * (AS_WINDOWS * np.arange(steps)[None, :, None]
                            + np.arange(AS_WINDOWS)[None, None, :])
                    ).reshape(-1)
            row, k = np.nonzero(offs[None, :] < nwin[:, None])
            kk = k0[row] + offs[k]
            x0 = 4 * kk - e0[row]
            srow = ((f * nb + d[row, 4]) << shift) + d[row, 5]

            def at(x):
                xs = x + ox[row]
                xx = xs >> lw[row]
                return (srow + (xx << shift) + (xs & ((1 << lw[row]) - 1))
                        - np.where(xx == 0, ox[row], 0))

            ok = (x0[:, None] + np.arange(4) >= 0) & (
                x0[:, None] + np.arange(4) < bw[row][:, None])
            src = np.stack([at(x0 + t) for t in range(4)], axis=1)
            # only valid samples of their slots are used
            sl, pos = src[ok] >> shift, src[ok] & ((1 << shift) - 1)
            vr, vc = valid[sl % nb, 0], valid[sl % nb, 1]
            assert ((pos // cbw < vr) & (pos % cbw < vc)).all()
            full = ok.all(axis=1)
            fast = full & (src[:, 3] == src[:, 0] + 3)
            words = np.where(ok, flat[np.where(ok, src, 0)], 0)
            p = src[fast, 0]
            m = p & 3
            a = p - m
            assert (a >= 0).all() and (a + np.where(m, 8, 4)
                                       <= flat.size).all()
            xw = flat[a[:, None] + np.arange(4)]
            yw = np.where(m[:, None] > 0, flat[np.minimum(
                a[:, None] + 4 + np.arange(4), flat.size - 1)], xw)
            words[fast] = _realign(xw, yw, m)
            loads += int(fast.sum()) + int((m > 0).sum())
            if dequant:
                delta = d[row, 7].astype(np.int32).view(np.float32)
                words = np.stack([_dequant(words[:, t], delta)
                                  for t in range(4)], axis=1)
            at_buf = 4 * kk[:, None] + np.arange(4)
            buf[at_buf[ok]] = words[ok]
            np.add.at(writes, at_buf[ok], 1)
    return buf.astype(np.int32), writes, loads


def _jax_ref(fn, plan, x, *static):
    """fn(x, plan, *static) of the JAX package, jitted (eager jnp compiles
    every op of every band shape), with the plan's quantizer steps traced:
    a step folded in as a constant lets XLA divide by its reciprocal, which
    the JAX package's eager extraction does not."""
    def run(x, deltas):
        view = types.SimpleNamespace(
            band_specs=plan.band_specs, nb=plan.nb, cbh=plan.cbh,
            cbw=plan.cbw, deltas=None if deltas is None else list(deltas))
        return fn(x, view, *static)
    return jax.jit(run)(x, None if plan.deltas is None
                        else jnp.asarray(plan.deltas, jnp.float32))


def _torch_pyr(pyr):
    return [{k: torch.from_numpy(v) for k, v in e.items()} for e in pyr]


@pytest.mark.parametrize("name", sorted(CASES))
def test_extract_model_matches_plain_and_jax(name):
    _n, plan, n, nc, levels = CASES[name]
    lossy = plan.deltas is not None
    pyr, _slots = block_layout.stress_inputs(plan, n, nc, levels, seed=1)
    keys, shapes, desc = block_layout.slot_descriptors(plan, nc, levels,
                                                       lossy)
    leaves = [pyr[lv][band] for lv, band in keys]
    assert [a.shape for a in leaves] == [(n, nc) + s for s in shapes]
    plain = fused_encode.extract_blocks(_torch_pyr(pyr), plan, n,
                                        levels).numpy()
    # leaves on 16-byte boundaries, then at every phase off them with the
    # frame loop taking two frames a CTA row
    for phases, grid_y in ((np.zeros(len(leaves), np.int64), GRID_Y),
                           (np.arange(len(leaves)) % 4, 2)):
        got, vec_loads, word_loads = _extract_model(
            leaves, phases, desc, n, plan.nb, plan.cbh, plan.cbw, lossy,
            grid_y)
        np.testing.assert_array_equal(got, plain)
        assert vec_loads > 0
        if name in ALIGNED and not phases.any():
            assert word_loads == 0
        else:
            assert word_loads > 0
    ref = np.asarray(_jax_ref(
        jfe._extract_blocks, plan,
        [{k: jnp.asarray(v) for k, v in e.items()} for e in pyr], n, levels))
    np.testing.assert_array_equal(plain, ref)


@pytest.mark.parametrize("name,dequant", [
    (k, dq) for k in sorted(CASES)
    for dq in ((False, True) if CASES[k][1].deltas is not None
               else (False,))])
def test_pyramid_model_matches_plain_and_jax(name, dequant):
    _n, plan, n, nc, levels = CASES[name]
    _pyr, slots = block_layout.stress_inputs(plan, n, nc, levels, seed=2)
    keys, shapes, rows = block_layout.row_descriptors(plan, nc, levels,
                                                      dequant)
    off, total = block_layout.leaf_offsets(shapes, n, nc)
    desc = block_layout.slot_descriptors(plan, nc, levels, False)[2]
    plain = ht_dec.blocks_to_pyramid(torch.from_numpy(slots), plan, n, nc,
                                     levels, dequant)
    ref = _jax_ref(ht_tpu_decode.blocks_to_pyramid_dev, plan,
                   jnp.asarray(slots), n, nc, levels, dequant)
    for grid_y in (GRID_Y, 2):
        buf, writes, loads = _pyramid_model(
            slots, rows, off, total, n, plan.nb, plan.cbh, plan.cbw,
            dequant, desc[:, 1:3], grid_y)
        assert loads > 0
        leaf_words = np.zeros(total, bool)
        for (lv, band), (bh, bw), o in zip(keys, shapes, off):
            size = n * nc * bh * bw
            leaf_words[o:o + size] = True
            got = buf[o:o + size].reshape(n, nc, bh, bw)
            want = plain[lv][band].contiguous().numpy()
            assert want.dtype == (np.float32 if dequant else np.int32)
            np.testing.assert_array_equal(got, want.view(np.int32))
            np.testing.assert_array_equal(
                want.view(np.int32), np.asarray(ref[lv][band]).view(np.int32))
        # every leaf sample once, the padding between leaves never
        assert (writes[leaf_words] == 1).all()
        assert (writes[~leaf_words] == 0).all()
    assert [sorted(e) for e in plain] == [sorted(e) for e in ref]


def test_layout_constants_match_the_sources():
    assert rc.define("block_layout.cuh", "MAX_LEAVES") == \
        block_layout.MAX_LEAVES
    assert rc.define("block_layout.cuh", "LAYOUT_FIELDS") == \
        block_layout.LAYOUT_FIELDS


def _plan_of(shape):
    from go_jpeg2000_tpu_torch import options
    from go_jpeg2000_tpu_torch.models import encoder
    from go_jpeg2000_tpu_torch.tcd import geometry as geo
    opts = options.Options(format=options.Format.J2K, lossless=True,
                           num_resolutions=4, high_throughput=True)
    header = encoder.build_header(np.zeros(shape, np.uint8), opts)
    encoder._apply_comp_quants(header, opts, 1, 8)
    return fused_encode.plan_blocks(header, geo.build_tile(header, 0))


def test_plan_caches_hold_their_plans():
    # plans built by plan_blocks are not memoized: a cache keyed on id()
    # alone hands a freed plan's layout to a new plan at its address (it
    # did here for 5 of 30 plans built in turn)
    cpu = torch.device("cpu")
    for k in range(30):
        plan = _plan_of((64 + 8 * k, 40 + 16 * (k % 5)))
        desc = ht_enc_cuda.extract_layout(plan, 2, 1, 3, cpu)[2]
        np.testing.assert_array_equal(desc.numpy(), block_layout.
                                      slot_descriptors(plan, 1, 3, False)[2])
        rows = ht_dec_cuda.pyramid_layout(plan, 2, 1, 3, False, cpu)[0]
        np.testing.assert_array_equal(rows.numpy(), block_layout.
                                      row_descriptors(plan, 1, 3, False)[2])
        hs, ws = fused_encode._block_dims(plan, 2, cpu)
        np.testing.assert_array_equal(hs.numpy(), np.tile(plan.hs, 2))
        np.testing.assert_array_equal(ws.numpy(), np.tile(plan.ws, 2))
        del plan, desc, rows, hs, ws
        gc.collect()


def _fake_plan(levels):
    """A plan of 3 * levels + 1 leaves of 2x2 bands in 4x4 slots."""
    specs = [(0, lev, band, 1, 1, 4, 4, 2, 2, 0, 0)
             for lev in range(levels, 0, -1) for band in ("HL", "LH", "HH")]
    specs.insert(0, (0, 0, "LL", 1, 1, 4, 4, 2, 2, 0, 0))
    return types.SimpleNamespace(band_specs=specs, nb=len(specs), cbh=4,
                                 cbw=4, deltas=None)


def test_layout_refuses_more_leaves_than_a_launch_takes():
    cpu = torch.device("cpu")
    fits = _fake_plan(32)
    assert len(block_layout.leaves(fits, 1, 32)[0]) == \
        block_layout.MAX_LEAVES
    ht_enc_cuda.extract_layout(fits, 1, 1, 32, cpu)
    with pytest.raises(ValueError, match="leaves"):
        ht_enc_cuda.extract_layout(_fake_plan(33), 1, 1, 33, cpu)
    with pytest.raises(ValueError, match="leaves"):
        ht_dec_cuda.pyramid_layout(_fake_plan(33), 1, 1, 33, False, cpu)
    bad = _fake_plan(2)
    bad.band_specs[1] = (0, 2, "HL", 1, 1, 4, 8, 2, 2, 0, 0)   # ew > cbw
    with pytest.raises(ValueError, match="does not fit"):
        block_layout.slot_descriptors(bad, 1, 2, False)
