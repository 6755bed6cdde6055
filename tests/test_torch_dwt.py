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
    # a row shard's level (halo rows) keeps the even rule
    assert dwt_cuda.usable(512, 512, 0, 0, halo=True)
    assert dwt_cuda.usable(2, 2, 0, 0, halo=True)
    for w in (2, 3058, 3060, 4096, 8192, 65536):
        assert dwt_cuda.usable(16, w, 0, 0, inverse=True, halo=True)
        assert dwt_cuda.usable(w, w, 0, 0, dwt.REV53, inverse=True,
                               halo=True)
    assert not dwt_cuda.usable(511, 512, 0, 0, halo=True)    # odd size
    assert not dwt_cuda.usable(512, 512, 1, 0, halo=True)    # odd origin
    assert not dwt_cuda.usable(512, 512, 0, 3, halo=True)
    assert not dwt_cuda.usable(16, 4095, 0, 0, inverse=True, halo=True)
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


@pytest.mark.parametrize("case", CASES_97)
def test_97_level_matches_jax_eager(case):
    n, h, w, u0, v0 = case
    x = _floats((n, h, w), h * w + u0)
    ref = jdwt.forward_2d(x, jdwt.IRR97, u0=u0, v0=v0)
    got = dwt.forward_2d(torch.from_numpy(x), dwt.IRR97, u0=u0, v0=v0)
    for k in BANDS:
        _eq(got[k], ref[k])
    rec_ref = jdwt.inverse_2d(ref, jdwt.IRR97, u0=u0, v0=v0)
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


@pytest.mark.parametrize("case", [(33, 47, 1, 0, 3), (64, 64, 0, 0, 5),
                                  (8, 8, 3, 2, 3), (2, 3, 1, 1, 2)])
def test_97_decompose_reconstruct(case):
    h, w, u0, v0, levels = case
    x = _floats((2, h, w), h + w)
    kw = dict(kind=jdwt.IRR97, u0=u0, v0=v0)
    ref = jdwt.decompose(x, levels, **kw)
    got = dwt.decompose(torch.from_numpy(x), levels, dwt.IRR97, u0=u0, v0=v0)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            _eq(g[k], r[k])
    rec = dwt.reconstruct(got, dwt.IRR97, u0=u0, v0=v0)
    _eq(rec, jdwt.reconstruct(ref, **kw))
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
    # and size; halo levels keep the even rule
    for inverse in (False, True):
        for u0, v0 in ((0, 0), (1, 1), (3, 0), (0, 5)):
            for h, w in ((512, 512), (512, 511), (1, 1), (3, 2), (1079, 1919),
                         (16, 2560), (8192, 8192)):
                assert dwt_cuda.usable(h, w, u0, v0, dwt.IRR97,
                                       inverse=inverse)
        assert dwt_cuda.usable(16, 2560, 0, 0, dwt.IRR97, inverse=inverse,
                               halo=True)
        assert not dwt_cuda.usable(512, 511, 0, 0, dwt.IRR97,
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
        dwt_cuda.forward_2d_97(x5, above=torch.empty(
            (1, 4, 4), dtype=torch.float32, device="meta"))


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


def _tiles_53(x, rows=None, halo_pairs=(1, 1), above=None, below=None,
              inverse=True, pu=0, pv=0):
    """The 5/3 kernels' decomposition in plain torch (_tiles), on the
    interleaved signal x [n, h, w] at origin parity (pu, pv) (a row shard
    of the inverse when `above` [n, 1, w] or `below` [n, 2, w], pair_rows'
    layout, are given): strips of STRIP_ROWS rows, tiles of TILE_PAIRS_53
    column pairs, `rows` = (above, below) rows (by default the kernel's
    halo: forward 2 and 1, inverse 1 and 2) and `halo_pairs` = (left,
    right) column pairs (the kernels' lanes 0 and 31), read through
    repeated symmetric reflection or from the halo rows."""
    h = x.shape[1]
    ext_above = None if above is None else _unpair(above)
    ext_below = None if below is None else _unpair(below)

    def row(g):
        if g < 0 and ext_above is not None:
            return ext_above[:, ext_above.shape[1] + g]
        if g >= h and ext_below is not None:
            return ext_below[:, g - h]
        return x[:, _reflect(g, h)]

    lift = dwt._inverse_1d_53 if inverse else dwt._forward_1d_53
    return _tiles(x, lift, inverse,
                  dwt_cuda.STRIP_ROWS[(dwt.REV53, inverse)], TILE_PAIRS_53,
                  rows or dwt.HALO_DEPTH[(dwt.REV53, inverse)], halo_pairs,
                  pu, pv, row_of=row)


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
    # the same decomposition on sp row shards, reading the halo rows the
    # exchange gives each shard (parallel/sharded.py), equals the plain halo
    # lifting shard by shard and the unsharded inverse level
    from go_jpeg2000_tpu_torch.parallel import sharded
    x = torch.from_numpy(_ints((3, rows, w), rows + w + sp, -30000, 30000))
    bands = dwt.forward_2d(x, dwt.REV53)
    split = [{k: v.contiguous() for k, v in zip(bands, parts)}
             for parts in zip(*(torch.chunk(b, sp, dim=-2)
                                for b in bands.values()))]

    def tiles(b, kind, above, below):
        il = dwt.pair_rows(b)
        return _tiles_53(_unpair(il), above=above, below=below)

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
