"""The port's DWT (go_jpeg2000_tpu_torch.ops.dwt, and the CPU side of the
CUDA level wrappers in ops/dwt_cuda.py) against the JAX package: the Pallas
level kernels in interpret mode, and the parity-general jnp lifting at odd
sizes and origins.  Tolerances: 5/3, exact equality (integer lifting); 9/7,
exact equality with the JAX package's eager lifting (the same float32 ops
in the same order), and test_dwt_pallas.py's tolerance against the Pallas
9/7 kernels, whose XLA program may round differently.  Plain-torch models
of the level kernels' decompositions (_tiles_97, _tiles_53: strips, column
tiles and their halos) equal the plain level bit for bit."""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

from go_jpeg2000_tpu.ops import dwt as jdwt
from go_jpeg2000_tpu.ops import dwt_pallas
from go_jpeg2000_tpu_torch.ops import dwt, dwt_cuda

BANDS = ("LL", "HL", "LH", "HH")


def _ints(shape, seed, lo=-2000, hi=2000):
    return np.random.RandomState(seed).randint(lo, hi, size=shape).astype(
        np.int32)


def _eq(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 64, 64), (1, 32, 96),
                                   (3, 8, 8), (2, 6, 10), (1, 4, 4100),
                                   (1, 2, 6), (2, 6, 2), (1, 70, 62)])
def test_forward_level_matches_pallas(shape):
    x = _ints(shape, shape[1])
    ref = dwt_pallas.forward_2d_53(x, interpret=True)
    got = dwt_cuda.forward_2d_53(torch.from_numpy(x))
    for k in BANDS:
        _eq(got[k], ref[k])


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 64, 64), (1, 32, 96),
                                   (3, 8, 8), (2, 6, 10)])
def test_inverse_level_matches_pallas(shape):
    n, h, w = shape
    bands = {k: _ints((n, h // 2, w // 2), 7 + i) for i, k in enumerate(BANDS)}
    ref = dwt_pallas.inverse_2d_53(bands, interpret=True)
    got = dwt_cuda.inverse_2d_53({k: torch.from_numpy(v)
                                  for k, v in bands.items()})
    _eq(got, ref)


# (h, w, u0, v0, levels): odd sizes, odd origins, 1-sample axes
@pytest.mark.parametrize("case", [(33, 47, 1, 0, 3), (17, 9, 1, 1, 4),
                                  (1, 5, 0, 0, 2), (5, 1, 1, 1, 1),
                                  (8, 8, 3, 2, 3), (2, 3, 1, 1, 2)])
def test_decompose_reconstruct_match_jnp(case):
    h, w, u0, v0, levels = case
    x = _ints((2, h, w), h * w)
    kw = dict(levels=levels, kind=jdwt.REV53, u0=u0, v0=v0)
    ref = jax.jit(functools.partial(jdwt.decompose, **kw))(x)
    got = dwt.decompose(torch.from_numpy(x), levels, dwt.REV53, u0=u0, v0=v0)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            _eq(g[k], r[k])
    del kw["levels"]
    rec_ref = jax.jit(functools.partial(jdwt.reconstruct, **kw))(ref)
    rec = dwt.reconstruct(got, dwt.REV53, u0=u0, v0=v0)
    _eq(rec, rec_ref)
    _eq(rec, x)
    assert dwt.subband_shapes(h, w, levels, u0, v0) == \
        jdwt.subband_shapes(h, w, levels, u0, v0)


def test_multilevel_matches_pallas_decompose():
    x = _ints((2, 64, 64), 9, -500, 500)
    ref = dwt_pallas.decompose_53(x, 3, interpret=True)
    got = dwt.decompose(torch.from_numpy(x), 3)
    for lev in range(3):
        for k in ref[lev]:
            _eq(got[lev][k], ref[lev][k])


def test_usable_gating():
    # every level without halo rows takes the kernels: any origin parity,
    # odd sizes, 1-sample axes, and empty ones (which launch nothing)
    for u0, v0 in ((0, 0), (1, 0), (0, 3), (7, 5)):
        for h, w in ((512, 512), (511, 512), (1079, 1919), (1, 1), (1, 9),
                     (9, 1), (2, 3), (0, 5), (135, 240)):
            assert dwt_cuda.usable(h, w, u0, v0)
            assert dwt_cuda.usable(h, w, u0, v0, dwt.REV53, inverse=True)
    # a row shard's level (halo rows) needs an even origin and an even
    # height; any width (a single tile column's levels go odd)
    assert dwt_cuda.usable(512, 512, 0, 0, halo=True)
    assert dwt_cuda.usable(2, 2, 0, 0, halo=True)
    for w in (1, 2, 375, 3058, 3060, 4095, 4096, 8192, 65536):
        assert dwt_cuda.usable(16, w, 0, 0, inverse=True, halo=True)
        assert dwt_cuda.usable(w + (w & 1), w, 0, 0, dwt.REV53,
                               inverse=True, halo=True)
    assert not dwt_cuda.usable(511, 512, 0, 0, halo=True)    # odd height
    assert not dwt_cuda.usable(512, 512, 1, 0, halo=True)    # odd origin
    assert not dwt_cuda.usable(512, 512, 0, 3, halo=True)
    assert not dwt_cuda.usable(1, 4096, 0, 0, inverse=True, halo=True)
    assert not hasattr(dwt_cuda, "MAX_SMEM_BYTES")


def test_wrappers_refuse_other_devices():
    # a tensor off the CPU goes to the kernel or raises; never a fallback
    x = torch.empty((1, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dwt_cuda.forward_2d_53(x)
    bands = {k: torch.empty((1, 2, 2), dtype=torch.int32, device="meta")
             for k in BANDS}
    with pytest.raises(ValueError):
        dwt_cuda.inverse_2d_53(bands)


def _floats(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 100).astype(
        np.float32)


# (n, h, w, u0, v0): even and odd sizes and origins, 1- and 2-sample axes
CASES_97 = [(2, 64, 64, 0, 0), (1, 33, 47, 1, 0), (2, 17, 9, 1, 1),
            (2, 1, 5, 0, 1), (2, 5, 1, 1, 0), (1, 2, 2, 1, 1),
            (1, 2, 3, 0, 1), (3, 6, 10, 0, 0), (1, 1, 1, 0, 0)]


def _jax_eager_all(fn, cases):
    """{case: fn(case)} of JAX eager computations, run on a few threads:
    eager jnp compiles every op anew for each shape (about 55 ms an op on
    the CPU), and XLA compiles in parallel, so the cases of one test share
    the wall time of their compiles.  The results are eager's, bit for
    bit."""
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(cases, pool.map(fn, cases)))


def _jax_97_level(case):
    n, h, w, u0, v0 = case
    x = _floats((n, h, w), h * w + u0)
    ref = jdwt.forward_2d(x, jdwt.IRR97, u0=u0, v0=v0)
    return x, ref, jdwt.inverse_2d(ref, jdwt.IRR97, u0=u0, v0=v0)


@pytest.fixture(scope="module")
def jax_97_levels():
    return _jax_eager_all(_jax_97_level, CASES_97)


@pytest.mark.parametrize("case", CASES_97)
def test_97_level_matches_jax_eager(case, jax_97_levels):
    n, h, w, u0, v0 = case
    x, ref, rec_ref = jax_97_levels[case]
    got = dwt.forward_2d(torch.from_numpy(x), dwt.IRR97, u0=u0, v0=v0)
    for k in BANDS:
        _eq(got[k], ref[k])
    rec = dwt.inverse_2d(got, dwt.IRR97, u0=u0, v0=v0)
    _eq(rec, rec_ref)
    np.testing.assert_allclose(rec.numpy(), x, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 32, 96), (3, 8, 8),
                                   (1, 2, 2)])
def test_97_level_matches_pallas(shape):
    x = _floats(shape, shape[1] + 2)
    ref = dwt_pallas.forward_2d_97(x, interpret=True)
    got = dwt_cuda.forward_2d_97(torch.from_numpy(x))
    for k in BANDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-3)
    ref_inv = dwt_pallas.inverse_2d_97(ref, interpret=True)
    got_inv = dwt_cuda.inverse_2d_97(got)
    np.testing.assert_allclose(got_inv.numpy(), np.asarray(ref_inv),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_inv.numpy(), x, rtol=1e-4, atol=0.02)


CASES_97_MULTI = [(33, 47, 1, 0, 3), (64, 64, 0, 0, 5), (8, 8, 3, 2, 3),
                  (2, 3, 1, 1, 2)]


def _jax_97_multi(case):
    h, w, u0, v0, levels = case
    x = _floats((2, h, w), h + w)
    kw = dict(kind=jdwt.IRR97, u0=u0, v0=v0)
    ref = jdwt.decompose(x, levels, **kw)
    return x, ref, jdwt.reconstruct(ref, **kw)


@pytest.fixture(scope="module")
def jax_97_multi():
    return _jax_eager_all(_jax_97_multi, CASES_97_MULTI)


@pytest.mark.parametrize("case", CASES_97_MULTI)
def test_97_decompose_reconstruct(case, jax_97_multi):
    h, w, u0, v0, levels = case
    x, ref, rec_ref = jax_97_multi[case]
    got = dwt.decompose(torch.from_numpy(x), levels, dwt.IRR97, u0=u0, v0=v0)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            _eq(g[k], r[k])
    rec = dwt.reconstruct(got, dwt.IRR97, u0=u0, v0=v0)
    _eq(rec, rec_ref)
    np.testing.assert_allclose(rec.numpy(), x, rtol=0, atol=2e-3)


def _reflect(i, n):
    if n == 1:
        return 0
    while i < 0 or i >= n:
        i = -i if i < 0 else 2 * n - 2 - i
    return i


def _axis_lift(lift, n, parity):
    """The kernels' lifting of one axis of a window whose first sample has
    `parity`: the plain 1-D lifting, or, on a level axis of one sample,
    Annex F's 1-sample rule at that sample's parity on each of the
    window's copies of it (the kernels do not lift such an axis)."""
    if n > 1:
        return lambda sub, axis: lift(sub, axis, parity)
    return lambda sub, axis: torch.cat(
        [lift(sub.narrow(axis, i, 1), axis, parity)
         for i in range(sub.shape[axis])], dim=axis)


def _tiles(x, lift, inverse, strip, pairs, rows, halo_pairs, pu, pv,
           row_of=None):
    """A level kernel's decomposition in plain torch, on the interleaved
    signal x [n, h, w] at origin parity (pu, pv), in the kernels' pair
    frame: strip s covers local rows 32s - pv .. (the first a low-pass
    row), rounded up to whole row pairs, and tile t column pairs
    pairs * t .., pair q holding local columns 2q - pu and 2q - pu + 1.
    Each (strip, tile) lifts only its window, extended by `rows` = (above,
    below) rows and by `halo_pairs` = (left, right) column pairs, read
    through repeated symmetric reflection (or by `row_of`); the windows'
    centres inside the level are concatenated.  Forward: columns, then
    rows; inverse: rows, then columns."""
    n, h, w = x.shape
    up, down = rows
    left, right = halo_pairs
    row_of = row_of or (lambda g: x[:, _reflect(g, h)])
    # a window starts on a row and a column of the parity of `up` and 0; a
    # 1-sample axis has its level's parity
    vlift = _axis_lift(lift, h, up & 1 if h > 1 else pv)
    hlift = _axis_lift(lift, w, 0 if w > 1 else pu)
    out = torch.empty_like(x)
    for r0 in range(-pv, h, strip):
        rr = min(strip, h - r0)
        band = torch.stack([row_of(g) for g in range(
            r0 - up, r0 + rr + (rr & 1) + down)], dim=1)
        for q0 in range(0, (w + pu + 1) // 2, pairs):
            c_first = 2 * (q0 - left) - pu
            cols = [_reflect(c, w) for c in range(
                c_first, 2 * (q0 + pairs + right) - pu)]
            sub = band[:, :, cols]
            if inverse:                               # rows, then columns
                sub = vlift(hlift(sub, 2), 1)[:, up:up + rr]
            else:                                     # columns, then rows
                sub = hlift(vlift(sub, 1)[:, up:up + rr], 2)
            r_lo, c_lo = max(r0, 0), max(2 * q0 - pu, 0)
            c_hi = min(2 * (q0 + pairs) - pu, w)
            out[:, r_lo:r0 + rr, c_lo:c_hi] = \
                sub[:, r_lo - r0:, c_lo - c_first:c_hi - c_first]
    return out


# output column pairs of one warp's tile in csrc/dwt97.cu (lanes 2 .. 29)
TILE_PAIRS_97 = 28


def _tiles_97(x, inverse, rows=None, halo_pairs=2, pu=0, pv=0):
    """The 9/7 kernels' decomposition in plain torch (_tiles), on the
    interleaved signal x [n, h, w] at origin parity (pu, pv): strips of
    STRIP_ROWS rows, tiles of TILE_PAIRS_97 column pairs, `rows` = (above,
    below) rows (by default the kernels' halo: forward 4 above and 3
    below, inverse 3 and 4) and `halo_pairs` column pairs a side."""
    lift = dwt._inverse_1d_97 if inverse else dwt._forward_1d_97
    return _tiles(x, lift, inverse,
                  dwt_cuda.STRIP_ROWS[(dwt.IRR97, inverse)], TILE_PAIRS_97,
                  rows or dwt.HALO_DEPTH[(dwt.IRR97, inverse)],
                  (halo_pairs, halo_pairs), pu, pv)


@pytest.mark.parametrize("h", [2, 4, 6, 10, 34])
def test_97_strip_halo_depth(h):
    # csrc/dwt97.cu's halo (forward 4 rows above and 3 below, inverse 3 and
    # 4) gives the plain result bit for bit; one row fewer on a side does not
    x = torch.from_numpy(_floats((2, h, 8), h))
    fwd = dwt._forward_1d_97(dwt._forward_1d_97(x, 1, 0), 2, 0)
    inv = dwt._inverse_1d_97(dwt._inverse_1d_97(x, 2, 0), 1, 0)
    assert torch.equal(_tiles_97(x, False, rows=(4, 3)), fwd)
    assert torch.equal(_tiles_97(x, True, rows=(3, 4)), inv)
    assert dwt_cuda.HALO_ROWS[dwt.IRR97] == 4 + 3
    if h > dwt_cuda.STRIP_ROWS[(dwt.IRR97, False)]:
        for rows in ((3, 3), (4, 2)):
            assert not torch.equal(_tiles_97(x, False, rows=rows), fwd)
        for rows in ((2, 4), (3, 3)):
            assert not torch.equal(_tiles_97(x, True, rows=rows), inv)


def _bands_of(y, pu=0, pv=0):
    """The four bands of an interleaved level at origin parity (pu, pv):
    low-pass rows and columns are the globally even ones."""
    return {"LL": y[:, pv::2, pu::2], "HL": y[:, pv::2, 1 - pu::2],
            "LH": y[:, 1 - pv::2, pu::2], "HH": y[:, 1 - pv::2, 1 - pu::2]}


@pytest.mark.parametrize("w", [2, 4, 6, 10, 54, 56, 58, 114, 130])
@pytest.mark.parametrize("h", [2, 6, 34, 70])
def test_97_tile_decomposition(h, w):
    # csrc/dwt97.cu's warps (STRIP_ROWS rows by 28 column pairs, with 2 halo
    # pairs a side and the vertical halo) give the plain 2-D level bit for
    # bit, forward and inverse; with one halo pair a side they do not
    x = torch.from_numpy(_floats((2, h, w), h * w))
    fwd = dwt.forward_2d(x, dwt.IRR97)
    got = _bands_of(_tiles_97(x, False))
    for k in BANDS:
        assert torch.equal(got[k], fwd[k]), k
    inv = dwt.inverse_2d({k: v.contiguous() for k, v in _bands_of(x).items()},
                         dwt.IRR97)
    assert torch.equal(_tiles_97(x, True), inv)
    if w // 2 > TILE_PAIRS_97:                    # tiles meet inside the frame
        one = _bands_of(_tiles_97(x, False, halo_pairs=1))
        assert not all(torch.equal(one[k], fwd[k]) for k in BANDS)
        assert not torch.equal(_tiles_97(x, True, halo_pairs=1), inv)


def test_97_usable_and_refusals():
    # every 9/7 level without halo rows takes the kernels, at any origin
    # and size; halo levels need an even origin and height, any width
    for inverse in (False, True):
        for u0, v0 in ((0, 0), (1, 1), (3, 0), (0, 5)):
            for h, w in ((512, 512), (512, 511), (1, 1), (3, 2), (1079, 1919),
                         (16, 2560), (8192, 8192)):
                assert dwt_cuda.usable(h, w, u0, v0, dwt.IRR97,
                                       inverse=inverse)
        assert dwt_cuda.usable(16, 2560, 0, 0, dwt.IRR97, inverse=inverse,
                               halo=True)
        assert dwt_cuda.usable(512, 511, 0, 0, dwt.IRR97, inverse=inverse,
                               halo=True)
        assert not dwt_cuda.usable(511, 512, 0, 0, dwt.IRR97,
                                   inverse=inverse, halo=True)
        assert not dwt_cuda.usable(512, 512, 0, 1, dwt.IRR97,
                                   inverse=inverse, halo=True)
    # the wrappers refuse a tensor off the CPU and the card, and halo rows
    # at an odd geometry
    x = torch.empty((1, 4, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        dwt_cuda.forward_2d_97(x)
    bands = {k: torch.empty((1, 2, 2), dtype=torch.float32, device="meta")
             for k in BANDS}
    with pytest.raises(ValueError):
        dwt_cuda.inverse_2d_97(bands)
    x5 = torch.empty((1, 5, 4), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="halo rows"):
        dwt_cuda.forward_2d_97(x5, edges=torch.empty(
            (2, 1, 5, 4), dtype=torch.float32, device="meta"))
    # on the CPU too: the plain halo form is not defined there either
    with pytest.raises(ValueError, match="halo rows"):
        dwt_cuda.forward_2d_97(torch.zeros((1, 5, 4)),
                               edges=torch.zeros((2, 1, 5, 4)))


# output column pairs of one warp's tile in csrc/dwt53.cu (lanes 1 .. 30)
TILE_PAIRS_53 = 30


def _unpair(rows):
    """Halo rows in dwt.pair_rows' layout ([LL|HL] or [LH|HH]) as
    interleaved columns."""
    w2 = rows.shape[-1] // 2
    out = torch.empty_like(rows)
    out[..., 0::2] = rows[..., :w2]
    out[..., 1::2] = rows[..., w2:]
    return out


def _tiles_53(x, rows=None, halo_pairs=(1, 1), outside=None, inverse=True,
              pu=0, pv=0):
    """The 5/3 kernels' decomposition in plain torch (_tiles), on the
    interleaved signal x [n, h, w] at origin parity (pu, pv): strips of
    STRIP_ROWS rows, tiles of TILE_PAIRS_53 column pairs, `rows` = (above,
    below) rows (by default the kernel's halo: forward 2 and 1, inverse 1
    and 2) and `halo_pairs` = (left, right) column pairs (the kernels'
    lanes 0 and 31), read through repeated symmetric reflection, or, for a
    row shard, rows g outside it from `outside(g)`."""
    h = x.shape[1]

    def row(g):
        if outside is not None and not 0 <= g < h:
            return outside(g)
        return x[:, _reflect(g, h)]

    lift = dwt._inverse_1d_53 if inverse else dwt._forward_1d_53
    return _tiles(x, lift, inverse,
                  dwt_cuda.STRIP_ROWS[(dwt.REV53, inverse)], TILE_PAIRS_53,
                  rows or dwt.HALO_DEPTH[(dwt.REV53, inverse)], halo_pairs,
                  pu, pv, row_of=row)


# ------------------------------------------- the halo form's edge addressing

def _edge_row_model(edges, own, rank, g):
    """csrc/dwt_edges.cuh edge_row, in numpy: row g (outside the shard) of
    row shard `rank`, whose own rows are `own` [n, h, w], in the globally
    extended signal of sp shards: the global row reflected over the sp * h
    rows, from the shard's own rows or from the edge slot of the shard that
    holds it, edges [sp, n, e, w] (first e/2 rows, then the last e/2)."""
    sp, _n, e, _w = edges.shape
    h = own.shape[1]
    gg = rank * h + g
    while gg < 0 or gg >= sp * h:
        gg = -gg if gg < 0 else 2 * sp * h - 2 - gg
    s, i = divmod(gg, h)
    if s == rank:
        return own[:, i], s
    return edges[s][:, i if i < e // 2 else i - (h - e)], s


def _slot_rows(h):
    """csrc/dwt_edges.cuh edge_source_row: the shard rows an edge slot
    holds, in order."""
    e = min(h, 2 * dwt.EDGE_ROWS)
    return [r if r < e // 2 else r + h - e for r in range(e)]


def _pack_model(rows):
    """csrc/dwt_edges.cu's forward packing in numpy: rows [n, h, w] ->
    the slot."""
    return rows[:, _slot_rows(rows.shape[1])]


def _pair_row(bands, i):
    """Interleaved row i of a level's bands [n, h/2, w/2], in numpy, as
    dwt.pair_rows lays it out: [LL|HL] row i // 2 for an even i, [LH|HH]
    for an odd one."""
    lo, hi = ("LH", "HH") if i & 1 else ("LL", "HL")
    return np.concatenate([bands[lo][:, i // 2], bands[hi][:, i // 2]],
                          axis=-1)


def _pack_pairs_model(bands):
    """csrc/dwt_edges.cu's inverse packing in numpy: the bands -> the
    slot's interleaved rows."""
    h = 2 * bands["LL"].shape[1]
    return np.stack([_pair_row(bands, i) for i in _slot_rows(h)], axis=1)


def _pairs(bands):
    """dwt.pair_rows in numpy: every interleaved row."""
    return np.stack([_pair_row(bands, i)
                     for i in range(2 * bands["LL"].shape[1])], axis=1)


@pytest.mark.parametrize("w", [6, 7])
@pytest.mark.parametrize("rows", [2, 4, 8, 34])
@pytest.mark.parametrize("sp", [2, 4])
def test_edge_addressing_model(sp, rows, w):
    """The kernels' addressing (numpy models of edge_row and the packing
    kernel) against the plain contract (dwt.pack_edges: shard_edges and
    pair_edges; dwt.halos_from_edges) and against the whole signal's own
    reflected rows, forward and inverse, for every row each lifting
    reaches, at an even and an odd width (low bands one column wider);
    on shards of 2 and 4 rows the reflection at the global top and bottom
    reaches into another shard, on longer ones it does not."""
    x = _ints((3, sp * rows, w), 7 * sp + rows, -30000, 30000)
    total = sp * rows
    full = {"fwd": x, "inv": None}
    band = {k: v.numpy() for k, v in dwt.forward_2d(torch.from_numpy(x),
                                                    dwt.REV53).items()}
    full["inv"] = _pairs(band)
    shards = {"fwd": np.split(x, sp, axis=1),
              "inv": [dict(zip(BANDS, parts)) for parts in zip(
                  *(np.split(band[k], sp, axis=1) for k in BANDS))]}
    crossed = 0
    for way, inverse in (("fwd", False), ("inv", True)):
        if inverse:
            model = np.stack([_pack_pairs_model(b) for b in shards[way]])
            own = [_pairs(b) for b in shards[way]]
        else:
            model = np.stack([_pack_model(r) for r in shards[way]])
            own = shards[way]
        src = [{k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.items()} if inverse
               else torch.from_numpy(np.ascontiguousarray(b))
               for b in shards[way]]
        plain = torch.stack([dwt.pack_edges(b) for b in src])
        np.testing.assert_array_equal(plain.numpy(), model)
        assert plain.shape[2] == dwt.edge_count(rows)
        for kind in (dwt.REV53, dwt.IRR97):
            depth = dwt.HALO_DEPTH[(kind, inverse)]
            for rank in range(sp):
                above, below = dwt.halos_from_edges(
                    plain, torch.from_numpy(own[rank]), rank, depth)
                gs = list(range(-depth[0], 0)) + list(
                    range(rows, rows + depth[1]))
                got = torch.cat([above, below], dim=1).numpy()
                for j, g in enumerate(gs):
                    row, s = _edge_row_model(model, own[rank], rank, g)
                    truth = full[way][:, _reflect(rank * rows + g, total)]
                    np.testing.assert_array_equal(row, truth)
                    np.testing.assert_array_equal(got[:, j], truth)
                    crossed += (not 0 <= rank * rows + g < total
                                and s != rank)
    assert (crossed > 0) == (rows <= 4)


def _halo_case(case):
    """The JAX package's unsharded level of a halo case, eager."""
    kind, sp, rows, w = case
    x = (_ints((2, sp * rows, w), sp * rows, -30000, 30000)
         if kind == dwt.REV53 else _floats((2, sp * rows, w), sp * rows))
    ref = jdwt.forward_2d(x, kind)
    return x, ref, jdwt.inverse_2d(ref, kind)


# (kind, sp, rows a shard, width): shards of 2 rows; odd widths and a
# single column, as a single tile column's levels have
HALO_CASES = [(dwt.REV53, 4, 2, 10), (dwt.REV53, 2, 34, 10),
              (dwt.IRR97, 4, 2, 10), (dwt.IRR97, 2, 34, 10),
              (dwt.REV53, 4, 2, 9), (dwt.IRR97, 2, 34, 7),
              (dwt.REV53, 2, 4, 1)]


@pytest.fixture(scope="module")
def jax_halo_levels():
    return _jax_eager_all(_halo_case, HALO_CASES)


@pytest.mark.parametrize("case", HALO_CASES)
def test_plain_halo_form_matches_jax_level(case, jax_halo_levels):
    """The plain halo form (dwt.forward_2d_halo and inverse_2d_halo on the
    edges dwt.pack_edges packs) of sp row shards, shards of 2 rows too,
    equals the JAX package's unsharded level bit for bit, 9/7 included,
    at odd widths too."""
    kind, sp, rows, _w = case
    x, ref, rec_ref = jax_halo_levels[case]
    from go_jpeg2000_tpu_torch.parallel import sharded
    shards = list(torch.chunk(torch.from_numpy(x), sp, dim=-2))
    got = sharded.forward_level_split(shards, kind, dwt.forward_2d_halo,
                                      dwt.pack_edges)
    for k in BANDS:
        _eq(torch.cat([g[k] for g in got], dim=-2), ref[k])
    split = [{k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in zip(BANDS, parts)}
             for parts in zip(*(np.split(np.asarray(ref[k]), sp, axis=1)
                                for k in BANDS))]
    rec = sharded.inverse_level_split(split, kind, dwt.inverse_2d_halo,
                                      dwt.pack_edges)
    _eq(torch.cat(rec, dim=-2), rec_ref)


@pytest.mark.parametrize("w", [2, 4, 6, 10, 58, 62, 64, 130])
@pytest.mark.parametrize("h", [2, 6, 34, 70])
def test_53_inverse_tile_decomposition(h, w):
    # csrc/dwt53.cu's inverse warps (STRIP_ROWS rows by 30 column pairs,
    # one halo pair a side, 1 row above and 2 below) give the plain inverse
    # level bit for bit; without the halo pair on the right they do not
    x = torch.from_numpy(_ints((2, h, w), h * w + 53, -30000, 30000))
    inv = dwt.inverse_2d({k: v.contiguous() for k, v in _bands_of(x).items()},
                         dwt.REV53)
    assert torch.equal(_tiles_53(x), inv)
    if w // 2 > TILE_PAIRS_53:                    # tiles meet inside the frame
        assert not torch.equal(_tiles_53(x, halo_pairs=(1, 0)), inv)
    if h > dwt_cuda.STRIP_ROWS[(dwt.REV53, True)]:  # strips meet too
        for rows in ((0, 2), (1, 1)):
            assert not torch.equal(_tiles_53(x, rows=rows), inv)


@pytest.mark.parametrize("sp,rows,w", [(2, 4, 10), (4, 8, 62), (2, 68, 64),
                                       (4, 16, 2), (2, 132, 130)])
def test_53_inverse_tiles_halo_form(sp, rows, w):
    # the same decomposition on sp row shards, reading the rows beyond each
    # shard as the kernel does (edge_row, on the edges the exchange gives
    # every shard, parallel/sharded.py), equals the plain halo lifting shard
    # by shard and the unsharded inverse level
    from go_jpeg2000_tpu_torch.parallel import sharded
    x = torch.from_numpy(_ints((3, rows, w), rows + w + sp, -30000, 30000))
    bands = dwt.forward_2d(x, dwt.REV53)
    split = [{k: v.contiguous() for k, v in zip(bands, parts)}
             for parts in zip(*(torch.chunk(b, sp, dim=-2)
                                for b in bands.values()))]

    def tiles(b, kind, edges, rank):
        own = dwt.pair_rows(b)
        return _tiles_53(_unpair(own), outside=lambda g: _unpair(
            _edge_row_model(edges, own, rank, g)[0]))

    got = sharded.inverse_level_split(split, dwt.REV53, level=tiles)
    plain = sharded.inverse_level_split(split, dwt.REV53,
                                        level=dwt.inverse_2d_halo)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert torch.equal(torch.cat(got, dim=-2), x)


# (h, w, pu, pv) of the parity tests: odd and 1-sample sizes, strips of
# either parity, widths that cross a tile (30 pairs: 59, 61, 63; 28 pairs:
# 55, 57)
PARITY_SIDES = (1, 2, 3, 5, 33, 35)
PARITIES = [(pu, pv) for pu in (0, 1) for pv in (0, 1)]
PARITY_53 = [(h, w) + p for h in PARITY_SIDES
             for w in PARITY_SIDES + (59, 61, 63) for p in PARITIES]
PARITY_97 = [(h, w) + p for h in PARITY_SIDES
             for w in PARITY_SIDES + (55, 57) for p in PARITIES]
# the cases whose plain level is also held to the JAX package's jnp level,
# at every parity: every height and the tile-crossing widths on one shape
# each (eager jnp compiles its ops anew for every shape, about 1.5 s a
# shape and direction on the CPU, so not all 102 shapes)
JAX_SHAPES = {dwt.REV53: {(1, 3), (2, 1), (3, 2), (5, 35), (33, 61),
                          (35, 5)},
              dwt.IRR97: {(1, 2), (2, 3), (3, 1), (5, 33), (33, 57),
                          (35, 35)}}


def _parity_input(kind, h, w, pu, pv):
    seed = 1000 * h + 10 * w + 2 * pu + pv
    if kind == dwt.REV53:
        return _ints((2, h, w), seed, -30000, 30000)
    return _floats((2, h, w), seed)


def _check_parity_forward(kind, tiles, h, w, pu, pv):
    """The kernels' model at origin parity (pu, pv) equals the plain level
    bit for bit, and on JAX_SHAPES the plain level the JAX package's jnp
    level."""
    x = _parity_input(kind, h, w, pu, pv)
    # an origin of either parity away from 0: (4 + pu, 2 + pv)
    u0, v0 = 4 + pu, 2 + pv
    plain = dwt.forward_2d(torch.from_numpy(x), kind, u0=u0, v0=v0)
    got = _bands_of(tiles(torch.from_numpy(x), False, pu, pv), pu, pv)
    shapes = dwt.subband_shapes(h, w, 1, u0, v0)[0]
    for k in BANDS:
        assert tuple(plain[k].shape[-2:]) == shapes[k], k
        assert torch.equal(got[k], plain[k]), k
    if (h, w) in JAX_SHAPES[kind]:
        ref = jdwt.forward_2d(x, kind, u0=u0, v0=v0)
        for k in BANDS:
            _eq(plain[k], ref[k])


def _check_parity_inverse(kind, tiles, h, w, pu, pv):
    x = _parity_input(kind, h, w, pu, pv)
    u0, v0 = 4 + pu, 2 + pv
    bands = {k: v.contiguous()
             for k, v in _bands_of(torch.from_numpy(x), pu, pv).items()}
    plain = dwt.inverse_2d(bands, kind, u0=u0, v0=v0)
    assert torch.equal(tiles(torch.from_numpy(x), True, pu, pv), plain)
    if (h, w) in JAX_SHAPES[kind]:
        _eq(plain, jdwt.inverse_2d({k: v.numpy() for k, v in bands.items()},
                                   kind, u0=u0, v0=v0))


def _model_53(x, inverse, pu, pv):
    return _tiles_53(x, inverse=inverse, pu=pu, pv=pv)


def _model_97(x, inverse, pu, pv):
    return _tiles_97(x, inverse, pu=pu, pv=pv)


@pytest.mark.parametrize("h,w,pu,pv", PARITY_53)
def test_53_forward_parity_tiles(h, w, pu, pv):
    # csrc/dwt53.cu's forward warps in the pair frame at every origin
    # parity and at odd and 1-sample sizes
    _check_parity_forward(dwt.REV53, _model_53, h, w, pu, pv)


@pytest.mark.parametrize("h,w,pu,pv", PARITY_53)
def test_53_inverse_parity_tiles(h, w, pu, pv):
    _check_parity_inverse(dwt.REV53, _model_53, h, w, pu, pv)


@pytest.mark.parametrize("h,w,pu,pv", PARITY_97)
def test_97_forward_parity_tiles(h, w, pu, pv):
    # csrc/dwt97.cu's warps in the pair frame, bit for bit
    _check_parity_forward(dwt.IRR97, _model_97, h, w, pu, pv)


@pytest.mark.parametrize("h,w,pu,pv", PARITY_97)
def test_97_inverse_parity_tiles(h, w, pu, pv):
    _check_parity_inverse(dwt.IRR97, _model_97, h, w, pu, pv)


@pytest.mark.parametrize("kind", [dwt.REV53, dwt.IRR97])
def test_parity_windows_need_their_halo(kind):
    # at odd parity and size too, one row or one column pair fewer on a
    # side of the kernels' windows gives another result
    h, w, pu, pv = 67, 125, 1, 1
    x = torch.from_numpy(_parity_input(kind, h, w, pu, pv))
    for inverse in (False, True):
        up, down = dwt.HALO_DEPTH[(kind, inverse)]
        if kind == dwt.REV53:
            full = _tiles_53(x, inverse=inverse, pu=pu, pv=pv)
            fewer = [_tiles_53(x, rows=r, inverse=inverse, pu=pu, pv=pv)
                     for r in ((up - 1, down), (up, down - 1))]
            fewer += [_tiles_53(x, halo_pairs=p, inverse=inverse, pu=pu,
                                pv=pv) for p in ((0, 1), (1, 0))]
        else:
            full = _tiles_97(x, inverse, pu=pu, pv=pv)
            fewer = [_tiles_97(x, inverse, rows=r, pu=pu, pv=pv)
                     for r in ((up - 1, down), (up, down - 1))]
            fewer += [_tiles_97(x, inverse, halo_pairs=1, pu=pu, pv=pv)]
        for f in fewer:
            assert not torch.equal(f, full)
