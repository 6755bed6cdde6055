"""The port's Part-1 (EBCOT) lossless path against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds at small sizes.  Tolerance:
exact everywhere.  Decision slots, MQ byte pools and segment lengths are
integers and must be equal; codestreams byte-identical; decodes equal the
input and the JAX package's decodes.

* ops/ebcot_device.decision_slots (the plain version of the
  ebcot_decision_slots kernel) against the JAX ebcot_device.decision_slots
  on the cases of tests/test_ebcot_device.py, and its compacted streams
  against the traced serial coder (ops/t1.py);
* the plain MQ chain (ops/mq_device.py: mq_encode_scan, compact_rows,
  pool_rows) against the JAX chain, ops/mq.MQEncoder and the native
  mq_encode_streams, on the streams of tests/test_mq_device.py; the
  wrappers of ops/ebcot_cuda.py on CPU tensors (their plain versions);
* encode_batch with backend "device" (path A), "hybrid" (path B) and
  "native" (path C) against the JAX package's encode_batch, and
  decode_batch, on gray, RGB (RCT) and 16-bit frames;
* a CPU model of the ebcot_decision_slots kernel's decomposition (one
  (block, plane) at a time: a 32-bit word of flag nibbles per stripe
  column, the SPP fixpoint by sweeps over runs of RUN_COLS columns
  resolved in visiting order, closed-form slots) against the plain
  version and the JAX package, on random blocks and on
  ebcot_device.stress_blocks (an SPP chain snaking through a 64x64 block,
  stripe-long chains, one live plane, all 29 planes); the kernel's shared
  memory footprint against every code-block shape;
* what stays outside the slice raises.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models.decoder import decode_batch as jax_decode_batch
from go_jpeg2000_tpu.models.encoder import encode_batch as jax_encode_batch
from go_jpeg2000_tpu.ops import ebcot_device as jax_ebcot
from go_jpeg2000_tpu.ops import mq_device as jax_mq
from go_jpeg2000_tpu.options import Format, Options
from go_jpeg2000_tpu_torch.models import ebcot_fused
from go_jpeg2000_tpu_torch.native import loader
from go_jpeg2000_tpu_torch.ops import ebcot_cuda, ebcot_device, mq, mq_device
from go_jpeg2000_tpu_torch.ops import t1

OPTS = Options(format=Format.J2K, lossless=True, num_resolutions=3,
               high_throughput=False, backend="native")


def natural_image(h, w, seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=(h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


# ----------------------------------------------------------- decision slots

def _batch(blocks, bands, h, w):
    """Blocks padded into one [B, h, w] batch: (mags, signs, classes,
    valid) as numpy."""
    b = len(blocks)
    mags = np.zeros((b, h, w), np.int32)
    signs = np.zeros((b, h, w), np.int32)
    valid = np.zeros((b, h, w), bool)
    for i, c in enumerate(blocks):
        bh, bw = c.shape
        mags[i, :bh, :bw] = np.abs(c)
        signs[i, :bh, :bw] = c < 0
        valid[i, :bh, :bw] = True
    classes = np.asarray([t1.BAND_CLASS[x] for x in bands], np.int32)
    return mags, signs, classes, valid


def _check_slots(blocks, bands, h, w, max_planes, model=None):
    """The plain version against the JAX package and the traced serial
    coder; `model`: the planes (indices from the top, or "all") that also
    go through the decision kernel's model (_plane_model)."""
    mags, signs, classes, valid = _batch(blocks, bands, h, w)
    want = np.asarray(jax_ebcot.decision_slots(mags, signs, classes, valid,
                                               max_planes))
    got = ebcot_cuda.decision_slots(
        torch.from_numpy(mags), torch.from_numpy(signs),
        torch.from_numpy(classes), torch.from_numpy(valid),
        max_planes).numpy()
    np.testing.assert_array_equal(got, want)
    if model is not None:
        _model_planes(mags, signs, classes, valid, max_planes, want,
                      None if model == "all" else model)
    assert got.shape[1] == max_planes * ebcot_device.slots_per_plane(h, w)
    for stream, c, band in zip(ebcot_device.compact_host(got), blocks,
                               bands):
        trace = []
        t1.encode_block(c, band, cb_style=0, trace=trace)
        assert stream == trace
    return got


@pytest.mark.parametrize("shape,mag,density", [
    ((8, 8), 200, 0.6), ((16, 16), 2000, 0.4), ((4, 4), 3, 0.9),
    ((12, 16), 50, 0.2), ((32, 32), 500, 0.5), ((8, 3), 9, 0.3),
    ((4, 70), 40, 0.5)])
def test_decision_slots_match_jax(shape, mag, density):
    """The three band classes in one batch, at each shape of the JAX
    package's decision-kernel cases and two more (a block narrower than 4
    columns in a padded batch, runs of the kernel's model cut by the
    width), with one plane above the data's; every (block, plane) also
    through the decision kernel's model."""
    rng = np.random.RandomState(shape[0] * 1000 + mag)
    blocks = []
    for _ in range(3):
        c = rng.randint(-mag, mag + 1, size=shape).astype(np.int32)
        c[rng.rand(*shape) < density] = 0
        blocks.append(c)
    h = -(-shape[0] // 4) * 4
    _check_slots(blocks, ["LL", "HL", "HH"], h, max(shape[1], 4),
                 int(mag).bit_length() + 1, model="all")


def test_decision_slots_ragged_batch():
    """Blocks of different true sizes and bit depths in one padded batch
    (ragged valid masks, a block deeper than 16 bits, an all-zero block)."""
    rng = np.random.RandomState(7)
    specs = [((64, 64), 4000, "LL"), ((64, 64), 10, "HH"),
             ((33, 64), 900, "HL"), ((64, 17), 2, "LL"),
             ((5, 6), 100000, "HH"), ((64, 64), 0, "LL")]
    blocks, bands = [], []
    for (h, w), mag, band in specs:
        c = (rng.randint(-mag, mag + 1, size=(h, w)).astype(np.int32)
             if mag else np.zeros((h, w), np.int32))
        c[rng.rand(h, w) < 0.55] = 0
        blocks.append(c)
        bands.append(band)
    slots = _check_slots(blocks, bands, 64, 64, 18, model=[0, 3, 9, 14, 17])
    assert (slots[-1] == ebcot_device.EMPTY).all()


def test_decision_slots_propagation_chain_and_run_length():
    """A diagonal forces a long SPP propagation chain (the fixpoint's
    depth); a sparse block is run-length heavy."""
    chain = np.zeros((16, 16), np.int32)
    for i in range(16):
        chain[i, i] = 3
    chain[0, 0] = 7
    _check_slots([chain], ["LL"], 16, 16, 8, model="all")
    sparse = np.zeros((16, 16), np.int32)
    sparse[9, 3] = -1
    sparse[2, 12] = 1
    _check_slots([sparse], ["HH"], 16, 16, 4, model="all")


# ------------------------------------- the decision kernel's decomposition

N_BASE, N_SIGN, N_SIN, N_BIT, N_ETA = 0, 4, 8, 12, 16


def _zc_rule(h, v, d, bc):
    """Table D.1 for scalar counts (the plain version's rule)."""
    if bc == 1:
        h, v = v, h
    if bc in (0, 1):
        if h == 2:
            return 8
        if h == 1:
            return 7 if v >= 1 else (6 if d >= 1 else 5)
        if v:
            return 4 if v == 2 else 3
        return 2 if d >= 2 else d
    hv = h + v
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv >= 1 else 6
    if d == 1:
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    return 2 if hv >= 2 else hv


# ZC context of an 8-bit neighbour mask (bit k: NW N NE W E SW S SE)
_ZC = np.asarray([[_zc_rule(bin(m & 0x18).count("1"),
                            bin(m & 0x42).count("1"),
                            bin(m & 0xA5).count("1"), bc)
                   for m in range(256)] for bc in range(3)], np.int64)


def _nib(a, at):
    return (a >> at) & 0xF


def _ext(words, at, g, x):
    """A flag's 6-bit columns (row above the stripe, rows 0-3, row below)
    at padded stripe g + 1 and padded columns x (arrays)."""
    return (((_nib(words[g, x], at) >> 3) & 1)
            | (_nib(words[g + 1, x], at) << 1)
            | ((_nib(words[g + 2, x], at) & 1) << 5))


def _mask8(l, cn, cs, rt, r):
    return (((l >> r) & 1) | (((cn >> r) & 1) << 1) | (((rt >> r) & 1) << 2)
            | (((l >> (r + 1)) & 1) << 3) | (((rt >> (r + 1)) & 1) << 4)
            | (((l >> (r + 2)) & 1) << 5) | (((cs >> (r + 2)) & 1) << 6)
            | (((rt >> (r + 2)) & 1) << 7))


def _any8(l, c, r):
    return (l | (l >> 1) | (l >> 2) | c | (c >> 2) | r | (r >> 1)
            | (r >> 2)) & 0xF


def _sc(m, sl, sc, sr, r, sign):
    def contrib(bit, sg):
        return np.where((m >> bit) & 1, 1 - 2 * sg, 0)
    hc = np.clip(contrib(3, (sl >> (r + 1)) & 1)
                 + contrib(4, (sr >> (r + 1)) & 1), -1, 1)
    vc = np.clip(contrib(1, (sc >> r) & 1) + contrib(6, (sc >> (r + 2)) & 1),
                 -1, 1)
    ctx = np.where(hc == 0, 9 + (vc != 0), 12 + hc * vc)
    xr = ((hc < 0) | ((hc == 0) & (vc < 0))).astype(np.int64)
    return ctx | ((sign ^ xr) << 5)


def _plane_model(mags, signs, valid, bc, p, run_cols=ebcot_cuda.RUN_COLS):
    """One (block, plane) as the kernel computes it: (the plane's slots
    uint8 [G * W * 23], fixpoint sweeps).  Columns are vectors here; the
    sweeps loop over the offset inside a run, every run at once, as the
    kernel's threads run side by side."""
    h, w = mags.shape
    gn = h // 4
    maxmag = int(np.where(valid, mags, 0).max()) if mags.size else 0
    empty = np.full(gn * w * 23, 0xFF, np.uint8)
    if maxmag <= 0 or p >= maxmag.bit_length():
        return empty, 0
    rows = np.nonzero(valid.any(axis=1))[0]
    hval = int(rows[-1]) + 1 if rows.size else 0
    m = mags.astype(np.int64).reshape(gn, 4, w)
    v = valid.reshape(gn, 4, w)
    sin = ((m >> (p + 1)) > 0) & v
    word = np.zeros((gn + 2, w + 2), np.int64)
    for r in range(4):
        word[1:-1, 1:-1] |= (
            ((v[:, r] & ~sin[:, r]) << (N_BASE + r))
            | ((signs.reshape(gn, 4, w)[:, r] != 0) << (N_SIGN + r))
            | (sin[:, r] << (N_SIN + r))
            | ((((m[:, r] >> p) & 1) * v[:, r]) << (N_BIT + r))
            | ((((m[:, r] >> (p + 2)) > 0) & v[:, r]) << (N_ETA + r)))
    gi = np.arange(gn)[:, None]
    e = [_ext(word, N_SIN, gi, np.arange(w)[None] + k) for k in range(3)]
    ns = _any8(*e)                                     # [gn, w]
    base, bit = _nib(word[1:-1, 1:-1], N_BASE), _nib(word[1:-1, 1:-1],
                                                      N_BIT)
    # fixpoint: nw holds mem | new << 4 per padded column
    runs = -(-w // run_cols)
    src = np.zeros((gn + 2, w + 2), np.int64)
    sweeps = 0
    while True:
        sweeps += 1
        dst = np.zeros_like(src)
        left = src[1:-1, [min(j * run_cols, w) for j in range(runs)]] >> 4
        for k in range(run_cols):
            xs = np.arange(runs) * run_cols + k
            ok = xs < w
            xc = np.minimum(xs, w - 1)
            up = (src[:-2, :] >> 7) & 1                # stripe above, row 3
            t = (ns[:, xc] | left | (left >> 1) | ((left << 1) & 0xF)
                 | up[:, xc] | up[:, xc + 1] | up[:, xc + 2])
            mem = np.zeros_like(t)
            nwb = np.zeros_like(t)
            for r in range(4):
                tr = (t >> r) | ((nwb >> (r - 1)) if r else 0)
                mr = (base[:, xc] >> r) & tr & 1
                mem |= mr << r
                nwb |= (mr & (bit[:, xc] >> r)) << r
            dst[1:-1, xc[ok] + 1] = (mem | nwb << 4)[:, ok]
            left = nwb
        if np.array_equal(dst, src):
            break
        src = dst
    mem = src[1:-1, 1:-1] & 0xF
    nw_ = mem & bit
    # the slots, one column at a time (all columns at once)
    pad = lambda a: np.pad(a, 1)                       # noqa: E731
    sinp, memp, bitp = (_nib(word, N_SIN), pad(mem), _nib(word, N_BIT))
    basep, signp = _nib(word, N_BASE), _nib(word, N_SIGN)
    flags = {"si": sinp, "nv": memp & bitp, "sa": sinp | (memp & bitp),
             "bc": basep & ~memp & bitp, "sg": signp}

    def ext(f, k):
        a = flags[f]
        x = np.arange(w)[None] + k
        return (((a[gi, x] >> 3) & 1) | (a[gi + 1, x] << 1)
                | ((a[gi + 2, x] & 1) << 5))
    si, nv, sa, bcl, sg = ([ext(f, k) for k in range(3)]
                           for f in ("si", "nv", "sa", "bc", "sg"))
    own = word[1:-1, 1:-1]
    sin_o, bit_o, eta = _nib(own, N_SIN), bit, _nib(own, N_ETA)
    sign = _nib(own, N_SIGN)
    cand = base & ~mem & 0xF
    any_sa = _any8(*sa)
    nbc = (any_sa | ((bcl[0] | (bcl[0] >> 1)) & 0xF) | ((bcl[0] >> 2) & 0x7)
           | ((bcl[1] | bcl[2]) & 1))
    full = (4 * np.arange(gn)[:, None] + 4) <= hval
    rl = full & ((cand & ~nbc & 0xF) == 0xF)
    fs = np.where(bit_o, 4, 4)
    for r in range(3, -1, -1):
        fs = np.where((bit_o >> r) & 1, r, fs)
    spp = np.full((gn, w, 8), 0xFF, np.int64)
    mrp = np.full((gn, w, 4), 0xFF, np.int64)
    cup = np.full((gn, w, 11), 0xFF, np.int64)
    cup[..., 0] = np.where(rl, 17 | np.where(fs < 4, 32, 0), 0xFF)
    cup[..., 1] = np.where(rl & (fs < 4), 18 | (((fs >> 1) & 1) << 5), 0xFF)
    cup[..., 2] = np.where(rl & (fs < 4), 18 | ((fs & 1) << 5), 0xFF)
    spl, spr, spn = si[0] | (nv[0] & 0x1F), si[2] | (nv[2] & 1), si[1] | nv[1]
    cul, cur, cun = sa[0] | (bcl[0] & 0x1F), sa[2] | (bcl[2] & 1), sa[1] | bcl[1]
    for r in range(4):
        bt, sn = (bit_o >> r) & 1, (sign >> r) & 1
        ms = _mask8(spl, spn, si[1], spr, r)
        mr = (mem >> r) & 1
        spp[..., 2 * r] = np.where(mr, _ZC[bc][ms] | (bt << 5), 0xFF)
        spp[..., 2 * r + 1] = np.where(
            mr & bt, _sc(ms, sg[0], sg[1], sg[2], r, sn), 0xFF)
        mrp[..., r] = np.where(
            (sin_o >> r) & 1,
            np.where((eta >> r) & 1, 16, np.where((any_sa >> r) & 1, 15, 14))
            | (bt << 5), 0xFF)
        mc = _mask8(cul, cun, sa[1], cur, r)
        zc_emit = ((cand >> r) & 1).astype(bool) & (~rl | (r > fs))
        sc_emit = (zc_emit & (bt == 1)) | (rl & (fs == r))
        cup[..., 3 + 2 * r] = np.where(zc_emit, _ZC[bc][mc] | (bt << 5), 0xFF)
        cup[..., 4 + 2 * r] = np.where(
            sc_emit, _sc(mc, sg[0], sg[1], sg[2], r, sn), 0xFF)
    out = np.concatenate([spp.reshape(-1), mrp.reshape(-1), cup.reshape(-1)])
    return out.astype(np.uint8), sweeps


def _plain_sweeps(mags, valid, p):
    """Sweeps the plain version's whole-block Jacobi fixpoint takes at plane
    p (the last one finds no change)."""
    h, w = mags.shape
    r = torch.from_numpy(np.arange(h)[:, None] % 4 * np.ones((1, w), int))
    m, v = torch.from_numpy(mags[None]), torch.from_numpy(valid[None])
    s_in = ((m >> (p + 1)) > 0) & v
    bit = (((m >> p) & 1) > 0) & v
    nb_sin = torch.zeros_like(s_in)
    for (dy, dx) in ebcot_device._OFFS:
        nb_sin |= ebcot_device._shift_to(s_in, dy, dx)
    base = v & ~s_in
    member, sweeps = base & nb_sin, 0
    while True:
        sweeps += 1
        new = member & bit
        trig = torch.zeros_like(member)
        for (dy, dx) in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (1, -1)):
            trig |= (ebcot_device._shift_to(new, dy, dx)
                     & ebcot_device._before_sample(dy, dx, r))
        member2 = base & (nb_sin | trig)
        if torch.equal(member2, member):
            return sweeps
        member = member2


def _model_planes(mags, signs, classes, valid, max_planes, want, picks=None):
    """Every (block, plane) of `picks` (default: all) through _plane_model,
    each against its slice of `want`; returns the largest sweep count."""
    nb, h, w = mags.shape
    per = ebcot_device.slots_per_plane(h, w)
    most = 0
    for b in range(nb):
        for pi in (range(max_planes) if picks is None else picks):
            got, sweeps = _plane_model(mags[b], signs[b], valid[b],
                                       int(classes[b]), max_planes - 1 - pi)
            np.testing.assert_array_equal(
                got, want[b, pi * per:(pi + 1) * per], err_msg=f"{b}, {pi}")
            most = max(most, sweeps)
    return most


@pytest.mark.parametrize("name", ["snake", "comb", "single_live",
                                  "all_planes"])
def test_decision_stress_blocks(name):
    """ebcot_device.stress_blocks (what tests/test_torch_cuda.py and
    chip_smoke.py put to the kernel on the card): the plain version equals
    the JAX package's, and the kernel's decomposition equals both on every
    plane a block codes, one empty plane and, for the snake, the plane of
    the chain, which the plain fixpoint takes over 100 sweeps to settle
    and the runs of RUN_COLS columns under 30."""
    mags, signs, classes, valid, planes = ebcot_device.stress_blocks()[name]
    if name == "all_planes":            # JAX's eager planes: one block
        mags, signs, classes, valid = (a[:1] for a in (mags, signs, classes,
                                                       valid))
    got = ebcot_cuda.decision_slots(*(torch.from_numpy(a) for a in (
        mags, signs, classes, valid)), planes).numpy()
    want = np.asarray(jax_ebcot.decision_slots(mags, signs, classes, valid,
                                               planes))
    np.testing.assert_array_equal(got, want)
    picks = {"all_planes": [0, 1, 14, 28]}.get(name)
    most = _model_planes(mags, signs, classes, valid, planes, want, picks)
    if name == "snake":
        p = 3
        assert _plain_sweeps(mags[0], valid[0], p) > 100
        assert most < 30
        one = np.where(mags[0] == 8)
        assert len(one[0]) > 100
    if name == "single_live":
        assert (got[:, :-ebcot_device.slots_per_plane(64, 64)] == 0xFF).all()


def test_decision_kernel_shared_memory_fits_every_code_block():
    """The kernel's CTA takes every block the wrapper took before it (a
    height that is a multiple of 4; the old footprint, a byte map and two
    membership maps of (h + 2)(w + 2) bytes and a byte per column, within
    the limit), every code-block shape (at most 4096 samples) among them."""
    limit = ebcot_cuda.MAX_SMEM_BYTES
    for h in range(4, 4097, 4):
        for w in range(1, 4096 // h + 1):
            assert ebcot_cuda.decision_smem(h, w) <= limit, (h, w)
    for h in range(4, 300, 4):
        for w in range(1, 300):
            if 3 * (h + 2) * (w + 2) + (h // 4) * w <= limit:
                assert ebcot_cuda.decision_smem(h, w) <= limit, (h, w)
    assert ebcot_cuda.decision_smem(64, 64) < 40 * 1024


# ------------------------------------------------------------- the MQ chain

def _random_streams():
    rng = np.random.RandomState(7)
    return [[(int(rng.randint(0, 19)), int(rng.randint(0, 2)))
             for _ in range(n)]
            for n in (0, 1, 2, 7, 8, 9, 40, 100, 256, 333, 512)]


def _skewed_streams():
    return [[(0, 0)] * 300, [(18, 1)] * 300,
            [(17, i % 2) for i in range(300)],
            [(9, 1)] * 150 + [(9, 0)] * 150,
            [(i % 19, (i // 3) % 2) for i in range(431)]]


def _jax_chain(packed):
    """The JAX package's chain as its fused path runs it: (pool, lens)."""
    import jax.numpy as jnp
    b = len(packed)
    u = jax_mq.UNROLL
    t_cap = -(-max(len(s) for s in packed) // u) * u
    slots = np.full((b, t_cap), 0xFF, np.uint8)
    valid = np.zeros((b, t_cap), bool)
    for i, s in enumerate(packed):
        slots[i, :len(s)] = np.frombuffer(s, np.uint8)
        valid[i, :len(s)] = True
    ndec = np.asarray([len(s) for s in packed], np.int32)
    aligned = jax_mq.compact_rows(jnp.asarray(slots), jnp.asarray(valid),
                                  t_cap)
    sb, sv, lens = jax_mq.mq_encode_scan(aligned.T.reshape(-1, u, b),
                                         jnp.asarray(ndec))
    rows = jax_mq.compact_rows(sb, sv, 2 * t_cap + 8, drop_first=True)
    lens = np.asarray(lens)
    return np.asarray(jax_mq.pool_rows(rows, lens, int(lens.sum()))), lens


@pytest.mark.parametrize("which", ["random", "skewed"])
def test_mq_chain_matches_jax_mqencoder_and_native(which):
    streams = _random_streams() if which == "random" else _skewed_streams()
    packed = [bytes(c | (b << 5) for c, b in s) for s in streams]
    want_pool, want_lens = _jax_chain(packed)
    # the port's plain chain, staged as the JAX package stages it
    b = len(packed)
    u = mq_device.UNROLL
    t_cap = -(-max(map(len, packed)) // u) * u
    aligned = np.full((b, t_cap), 0xFF, np.uint8)
    for i, s in enumerate(packed):
        aligned[i, :len(s)] = np.frombuffer(s, np.uint8)
    ndec = torch.tensor([len(s) for s in packed])
    sb, sv, lens = mq_device.mq_encode_scan(
        torch.from_numpy(aligned.T.copy()).reshape(-1, u, b), ndec)
    rows = mq_device.compact_rows(sb, sv, 2 * t_cap + 8, drop_first=True)
    pool = mq_device.pool_rows(rows, lens, int(lens.sum()))
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    np.testing.assert_array_equal(pool.numpy(), want_pool)
    native = loader.mq_encode_streams(packed)
    for s, seg, nat in zip(streams, mq_device.encode_streams(packed), native):
        if not s:
            assert seg == b""
            continue
        enc = mq.MQEncoder()
        for ctx, bit in s:
            enc.encode(bit, ctx)
        assert seg == enc.flush() == nat


def test_wrappers_on_cpu_chain_to_native_segments():
    """compact_rows, mq_encode and pool_rows of ops/ebcot_cuda on CPU
    tensors (their plain versions) on the decisions of a small block
    batch: the segments equal the native MQ coder's on the same decisions."""
    rng = np.random.RandomState(3)
    blocks = []
    for mag in (700, 30, 3, 0):
        c = rng.randint(-mag, mag + 1, size=(16, 16)).astype(np.int32)
        c[rng.rand(16, 16) < 0.5] = 0
        blocks.append(c)
    mags, signs, classes, valid = (torch.from_numpy(a) for a in _batch(
        blocks, ["HL", "LL", "HH", "LH"], 16, 16))
    slots = ebcot_cuda.decision_slots(mags, signs, classes, valid, 11)
    np.testing.assert_array_equal(
        ebcot_fused.numbps(mags, valid, 11).numpy(),
        ebcot_device.numbps_of(mags.numpy(), valid.numpy()))
    pool, ndec, off, largest = ebcot_cuda.compact_rows(slots)
    assert ndec.tolist() == [int((r != 0xFF).sum()) for r in slots]
    assert largest == max(ndec.tolist()) and ndec[-1] == 0
    rows, lens = ebcot_cuda.mq_encode(pool, ndec, off, largest)
    assert rows.numel() == ebcot_cuda.row_bytes(ndec)
    segs, total = ebcot_cuda.pool_rows(rows, off, lens)
    assert int(total) == int(lens.sum())
    ends = np.cumsum(ndec.numpy())
    streams = [pool.numpy()[e - n:e].tobytes()
               for e, n in zip(ends, ndec.numpy())]
    ends = np.cumsum(lens.numpy())
    for i, nat in enumerate(loader.mq_encode_streams(streams)):
        seg = segs.numpy()[ends[i] - lens[i]:ends[i]].tobytes()
        assert (seg[:-1] if seg.endswith(b"\xff") else seg) == nat


# --------------------------------------------------- the decision compaction

def _compact_model(slots, chunk, slot_base=0, pool_base=0):
    """csrc/ebcot_enc.cu's chunked compaction in numpy, with the slots
    starting `slot_base` and the pool `pool_base` bytes past a 16-byte
    boundary: a count per (row, chunk) from the chunk's 16-byte windows
    (bytes outside the chunk read as 0xFF), each row's sum and the scan of
    the rows, then for each chunk with a decision its place (the row's
    offset and the counts of the row's chunks before it), each window's
    live bytes at the exclusive scan of the window counts, and the pool's
    16-byte windows written whole inside the chunk's range and by bytes at
    its ends.  Returns (pool, ndec, off, largest, the (row, chunk) pairs
    the write pass read)."""
    nb, t = slots.shape
    flat = slots.reshape(-1)
    cpr = -(-t // chunk) if t else 0

    def windows(r, c):
        lo = r * t + c * chunk
        hi = min(lo + chunk, (r + 1) * t)
        a0 = (slot_base + lo) // 16 * 16 - slot_base
        idx = a0 + np.arange(-(-(hi - a0) // 16) * 16)
        inside = (idx >= lo) & (idx < hi)
        win = np.full(idx.size, 0xFF, np.uint8)
        win[inside] = flat[idx[inside]]
        return win.reshape(-1, 16)

    counts = np.array([[int((windows(r, c) != 0xFF).sum())
                        for c in range(cpr)] for r in range(nb)],
                      np.int64).reshape(nb, cpr)
    ndec = counts.sum(axis=1)
    off = np.cumsum(ndec) - ndec
    total = int(ndec.sum())
    pool = np.full(pool_base + total + 16, 0x5A, np.uint8)
    read = []
    for r in range(nb):
        for c in range(cpr):
            if counts[r, c] == 0:
                continue
            read.append((r, c))
            base = pool_base + int(off[r] + counts[r, :c].sum())
            win = windows(r, c)
            live = win != 0xFF
            pos = np.cumsum(live.sum(axis=1)) - live.sum(axis=1)
            stage = np.zeros(base % 16 + int(counts[r, c]) + 32, np.uint8)
            for k in range(win.shape[0]):
                at = base % 16 + pos[k]
                stage[at:at + live[k].sum()] = win[k][live[k]]
            lo, hi = base, base + int(counts[r, c])
            for a in range(lo // 16 * 16, hi, 16):
                s0 = a - lo // 16 * 16
                if a >= lo and a + 16 <= hi:
                    pool[a:a + 16] = stage[s0:s0 + 16]
                else:
                    for j in range(16):
                        if lo <= a + j < hi:
                            pool[a + j] = stage[s0 + j]
    assert (pool[:pool_base] == 0x5A).all()
    assert (pool[pool_base + total:] == 0x5A).all()
    largest = int(ndec.max()) if nb else 0
    return (pool[pool_base:pool_base + total], ndec, off, largest, read)


def _decision_batch_64():
    rng = np.random.RandomState(5)
    blocks = []
    for mag in (3000, 200, 9, 0):
        c = rng.randint(-mag, mag + 1, size=(64, 64)).astype(np.int32)
        c[rng.rand(64, 64) < 0.4] = 0
        blocks.append(c)
    arrays = (torch.from_numpy(a) for a in _batch(
        blocks, ["HL", "LL", "HH", "LH"], 64, 64))
    return ebcot_cuda.decision_slots(*arrays, 11).numpy()


COMPACT_CASES = sorted(ebcot_cuda.compact_stress_slots()) + [
    "empty_batch", "decisions_64"]


@pytest.mark.parametrize("name", COMPACT_CASES)
def test_chunked_compaction_model(name):
    """The compaction kernels' decomposition (chunks of COMPACT_CHUNK bytes,
    or of 48 and 1000 bytes on the short cases) equals compact_rows_plain
    at every alignment of slots and pool; the write pass reads no chunk
    without a decision."""
    if name == "empty_batch":
        slots = np.zeros((0, 300), np.uint8)
    elif name == "decisions_64":
        slots = _decision_batch_64()
    else:
        slots = ebcot_cuda.compact_stress_slots()[name]
    pool, ndec, off, largest = ebcot_cuda.compact_rows_plain(
        torch.from_numpy(slots))
    chunks = [ebcot_cuda.COMPACT_CHUNK]
    if slots.size <= 50000:
        chunks += [48, 1000]
    for chunk in chunks:
        for sb, pb in ((0, 0), (5, 11), (15, 1)):
            got = _compact_model(slots, chunk, sb, pb)
            np.testing.assert_array_equal(got[0], pool.numpy())
            np.testing.assert_array_equal(got[1], ndec.numpy())
            np.testing.assert_array_equal(got[2], off.numpy())
            assert got[3] == largest
            nb, t = slots.shape
            for r, c in got[4]:
                row = slots[r, c * chunk:(c + 1) * chunk]
                assert (row != 0xFF).any()
            assert len(got[4]) == sum(
                (slots[r, c:c + chunk] != 0xFF).any()
                for r in range(nb) for c in range(0, t, chunk))
    if name == "fill_planes":       # the generator's 0xFF fill planes
        plane = ebcot_device.slots_per_plane(64, 64)
        assert (slots[4] == 0xFF).all() and ndec[4] == 0
        assert (slots[3, :10 * plane] == 0xFF).all()
    if name == "decisions_64":
        assert ndec.tolist()[-1] == 0 and min(ndec.tolist()[:3]) > 0


# ------------------------------------------------------- the batch paths

def _frames(kind):
    if kind == "gray":
        return [natural_image(96, 96, i) for i in range(2)]
    if kind == "rgb":
        return [np.stack([natural_image(64, 48, 3 * i + c) for c in range(3)],
                         axis=-1) for i in range(2)]
    rng = np.random.RandomState(1)
    return [(natural_image(48, 40, i).astype(np.uint16) * 257
             + rng.randint(0, 64, (48, 40))).astype(np.uint16)
            for i in range(2)]


_JAX = {}


def _jax_streams(kind):
    if kind not in _JAX:
        _JAX[kind] = jax_encode_batch(_frames(kind), OPTS)
    return _JAX[kind]


@pytest.mark.parametrize("backend,counter", [
    ("device", "enc.ebcot_device_chunks"),
    ("hybrid", "enc.ebcot_hybrid_chunks"),
    ("native", "enc.host_entropy_frames")])
@pytest.mark.parametrize("kind", ["gray", "rgb", "gray16"])
def test_encode_matches_jax(kind, backend, counter):
    opts = dataclasses.replace(tp.options_from_reference(OPTS),
                               backend=backend)
    tp.counters.reset()
    got = tp.encode_batch(_frames(kind), opts, device="cpu")
    assert tp.counters.snapshot().get(counter, 0) > 0
    assert got == _jax_streams(kind)


def test_auto_takes_path_a_and_matches_jax_device_path():
    frames = [natural_image(24, 32, i) for i in range(2)]
    opts = dataclasses.replace(OPTS, backend="device", num_resolutions=2)
    tp.counters.reset()
    got = tp.encode_batch(frames, dataclasses.replace(
        tp.options_from_reference(opts), backend="auto"), device="cpu")
    assert tp.counters.snapshot().get("enc.ebcot_device_chunks", 0) == 1
    assert got == jax_encode_batch(frames, opts)


@pytest.mark.parametrize("kind", ["gray", "rgb", "gray16"])
def test_decode_roundtrips_and_matches_jax(kind):
    frames = _frames(kind)
    streams = _jax_streams(kind)
    tp.counters.reset()
    got = tp.decode_batch(streams, device="cpu")
    assert tp.counters.snapshot()["dec.ebcot_frames"] == len(frames)
    for d, j, f in zip(got, jax_decode_batch(streams), frames):
        assert d.dtype == f.dtype and np.array_equal(d, f)
        assert np.array_equal(d, j)


def test_header_and_guard_bits_match_jax():
    """Part-1 headers carry no CAP marker, no HT code-block style, and two
    guard bits (three for HT)."""
    from go_jpeg2000_tpu_torch.models import encoder
    frame = natural_image(32, 32, 0)
    for ht in (False, True):
        opts = dataclasses.replace(tp.options_from_reference(OPTS),
                                   high_throughput=ht)
        h = encoder.build_header(frame, opts)
        assert (h.capabilities is not None) == ht
        assert bool(h.coding_style.cb_style & 0x40) == ht
        assert h.quantization.guard_bits == (3 if ht else 2)


@pytest.mark.parametrize("override", [
    dict(lossless=False), dict(code_block_style=1), dict(num_layers=2),
    dict(backend="python")])
def test_outside_slice_raises(override):
    # (named for the refusals it held before styles and the python backend
    # were ported) lossy Part-1, quality layers, code-block styles and the
    # Python backend take the batch path's host branch (path C) and give
    # the JAX package's encode_batch (bytes for lossless, decodes within
    # one grey level for 9/7)
    opts = dataclasses.replace(tp.options_from_reference(OPTS), **override)
    frames = [natural_image(32, 32, 0)]
    tp.counters.reset()
    ours = tp.encode_batch(frames, opts, device="cpu")
    assert tp.counters.snapshot().get("enc.host_entropy_frames", 0) == 1
    ref = jax_encode_batch(frames, dataclasses.replace(OPTS, **override))
    if opts.lossless:
        assert ours == ref
    got, want = (tp.decode_batch(ours, device="cpu")[0],
                 jax_decode_batch(ref)[0])
    assert np.abs(got.astype(int) - want).max() <= (0 if opts.lossless
                                                    else 1)


@pytest.mark.parametrize("override", [dict(lossless=False, quality=80),
                                      dict(code_block_style=1)])
def test_decode_outside_slice_raises(override):
    # lossy and styled Part-1 streams decode through decode, one by one
    # (Python Tier-2, the native T1 decoder): the JAX package's pixels,
    # within one grey level for 9/7
    frames = [natural_image(32, 32, 0)]
    stream = jax_encode_batch(frames, dataclasses.replace(OPTS, **override))
    tp.counters.reset()
    got = tp.decode_batch(stream, device="cpu")[0]
    assert tp.counters.snapshot().get("dec.ebcot_frames", 0) == 0
    want = jax_decode_batch(stream)[0]
    lossless = override.get("lossless", True)
    assert np.abs(got.astype(int) - want).max() <= (0 if lossless else 1)
    if lossless:
        assert np.array_equal(got, frames[0])


def test_cuda_without_card_raises_and_modules_import_clean():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.encode_batch([natural_image(32, 32, 0)],
                            tp.options_from_reference(OPTS))
    code = ("import sys\n"
            "import go_jpeg2000_tpu_torch\n"
            "from go_jpeg2000_tpu_torch.models import ebcot_fused\n"
            "from go_jpeg2000_tpu_torch.ops import (ebcot_cuda, "
            "ebcot_device, mq_device)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'go_jpeg2000_tpu' or "
            "m.startswith('go_jpeg2000_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True)
