"""The MQ stress streams (go_jpeg2000_tpu_torch/ops/mq_device.py
stress_streams) through the port's plain MQ chain on the CPU
(ops/ebcot_cuda.mq_encode on CPU tensors), held against three oracles,
exactly: the JAX package's lockstep mq_device chain, the JAX package's
MQEncoder (ops/mq.py) and the port's native mq_encode_streams.  The
streams are built around the CUDA kernel's staging chunk (lengths 0, 1,
C - 1, C, C + 1, 2C + 1, pool offsets off 16-byte boundaries, long MPS
runs, carries into 0xFF and stuffing, one stream far longer than the
rest); tests/test_torch_cuda.py holds the kernel to the same streams on
the card.  The plain lockstep chain takes tens of torch ops a decision, so
it runs on the streams of at most four chunks; the long stream goes to the
native coder and MQEncoder only.

Also a numpy model of the segment-pool kernel (csrc/ebcot_enc.cu
ebcot_pool_rows: tiles of rows that each sum the lengths before them, a
warp a run of rows, 16-byte windows realigned to the pool and narrower
stores at each row's ends) on ebcot_cuda.pool_stress_rows, held to
pool_rows_plain at every phase of rows and pool.

And the cleanup wrapper's shape rule (ops/ht_enc_cuda.py
cleanup_shape_supported, the rule it applies to CUDA tensors): every legal
code-block shape of the padded batch is accepted, and the wrapper takes
such shapes on the CPU through the plain version, whose fields match the
JAX package's at the extreme shapes."""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import jax.numpy as jnp
from go_jpeg2000_tpu.ops import ht_tpu
from go_jpeg2000_tpu.ops import mq as jax_mq
from go_jpeg2000_tpu.ops import mq_device as jax_mq_device
from go_jpeg2000_tpu_torch.native import loader
from go_jpeg2000_tpu_torch.ops import ebcot_cuda, ht_enc, ht_enc_cuda
from go_jpeg2000_tpu_torch.ops import mq_device
from tests import row_copy_model as rc

CHUNK = ebcot_cuda.MQ_CHUNK
SHORT = 4 * CHUNK


@pytest.fixture(scope="module")
def streams():
    return mq_device.stress_streams(CHUNK, seed=0)


def _mqencoder(stream, coder=jax_mq.MQEncoder):
    enc = coder()
    for x in stream:
        enc.encode(x >> 5, x & 0x1F)
    return enc


def _segments(rows, off, lens):
    """Each block's segment from the row buffer (row b at 3 off[b] + 3b),
    trailing 0xFF kept."""
    data = rows.numpy()
    starts = 3 * off.numpy() + 3 * np.arange(off.numel())
    return [data[s:s + n].tobytes() for s, n in zip(starts, lens.numpy())]


def _strip(seg):
    return seg[:-1] if seg.endswith(b"\xff") else seg


class _Events(jax_mq.MQEncoder):
    """MQEncoder that counts what its BYTEOUTs did: carries that turned
    the last byte into 0xFF, stuffed bytes, and the longest run of
    decisions without a BYTEOUT."""

    def __init__(self):
        super().__init__()
        self.carry_ff = self.stuffed = self.run = self.longest_run = 0

    def _byteout(self):
        last = self.buf[-1]
        if last == 0xFE and self.c >= 0x8000000:
            self.carry_ff += 1
        super()._byteout()
        self.stuffed += self.buf[-2] == 0xFF
        self.run = 0

    def encode(self, d, cx):
        super().encode(d, cx)
        self.run += 1
        self.longest_run = max(self.longest_run, self.run)


def test_stress_streams_cover_the_cases(streams):
    lens = [len(s) for s in streams]
    for n in (0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1):
        assert n in lens
    offsets = np.cumsum(lens) - lens
    assert any(o % 16 for o, n in zip(offsets, lens) if n)
    assert lens[-1] >= 20 * max(lens[:-1])
    assert streams == mq_device.stress_streams(CHUNK, seed=0)
    assert streams != mq_device.stress_streams(CHUNK, seed=1)
    carry_ff = stuffed = longest_run = 0
    for s in streams:
        enc = _Events()
        for x in s:
            enc.encode(x >> 5, x & 0x1F)
        carry_ff += enc.carry_ff
        stuffed += enc.stuffed
        longest_run = max(longest_run, enc.longest_run)
    assert carry_ff > 0 and stuffed > 0
    assert longest_run > 2 * CHUNK


@pytest.mark.parametrize("base_offset", [0, 5])
def test_pool_of_lays_out_the_streams(streams, base_offset):
    pool, ndec, off, largest = mq_device.pool_of(streams, "cpu",
                                                 base_offset)
    assert pool.is_contiguous() and pool.numel() == sum(map(len, streams))
    assert ndec.tolist() == [len(s) for s in streams]
    assert largest == max(map(len, streams))
    data = pool.numpy()
    for s, o in zip(streams, off.tolist()):
        assert data[o:o + len(s)].tobytes() == s


def _jax_chain(packed):
    """The JAX package's device chain (compact, lockstep scan, compact,
    pool) on host decision streams: segments with the trailing 0xFF."""
    b, u = len(packed), jax_mq_device.UNROLL
    t_cap = -(-max(map(len, packed)) // u) * u
    slots = np.full((b, t_cap), 0xFF, np.uint8)
    valid = np.zeros((b, t_cap), bool)
    for i, s in enumerate(packed):
        slots[i, :len(s)] = np.frombuffer(s, np.uint8)
        valid[i, :len(s)] = True
    ndec = np.asarray([len(s) for s in packed], np.int32)
    aligned = jax_mq_device.compact_rows(jnp.asarray(slots),
                                         jnp.asarray(valid), t_cap)
    sb, sv, lens = jax_mq_device.mq_encode_scan(
        aligned.T.reshape(-1, u, b), jnp.asarray(ndec))
    rows = jax_mq_device.compact_rows(sb, sv, 3 * t_cap + 3,
                                      drop_first=True)
    lens = np.asarray(lens)
    pool = np.asarray(jax_mq_device.pool_rows(rows, lens, int(lens.sum())))
    ends = np.cumsum(lens)
    return [pool[e - n:e].tobytes() for e, n in zip(ends, lens)]


@pytest.fixture(scope="module")
def plain_short(streams):
    """The port's plain chain (ebcot_cuda.mq_encode on CPU tensors) on the
    streams of at most four chunks: (streams, segments)."""
    short = [s for s in streams if len(s) <= SHORT]
    pool, ndec, off, largest = mq_device.pool_of(short)
    rows, lens = ebcot_cuda.mq_encode(pool, ndec, off, largest)
    assert rows.numel() == ebcot_cuda.row_bytes(ndec)
    return short, _segments(rows, off, lens)


def test_plain_chain_matches_jax_chain(plain_short):
    short, segs = plain_short
    assert segs == _jax_chain(short)


def test_plain_chain_matches_mqencoder_and_native(plain_short):
    short, segs = plain_short
    native = loader.mq_encode_streams(short)
    assert len(short) == len(native)
    for s, seg, nat in zip(short, segs, native):
        want = _mqencoder(s).flush() if s else b""
        assert _strip(seg) == want == nat


def test_long_stream_native_matches_mqencoder(streams):
    longest = max(streams, key=len)
    assert len(longest) > SHORT
    native = loader.mq_encode_streams([longest])[0]
    assert native == _mqencoder(longest).flush()


def _legal_shapes():
    return [(h, w) for h in range(2, 1025, 2) for w in range(2, 1025, 2)
            if h * w <= 4096]


def test_cleanup_shape_rule_accepts_every_legal_shape():
    legal = _legal_shapes()
    assert (4, 1024) in legal and (1024, 4) in legal and (64, 64) in legal
    assert all(ht_enc_cuda.cleanup_shape_supported(h, w) for h, w in legal)
    for h, w in ((3, 4), (4, 3), (0, 4), (4, 0), (2048, 2), (2, 2048),
                 (128, 64), (66, 64), (1026, 2)):
        assert not ht_enc_cuda.cleanup_shape_supported(h, w), (h, w)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1024), (1024, 4), (2, 1024),
                                   (1024, 2), (32, 32), (64, 32), (32, 128),
                                   (128, 32), (64, 64)])
def test_cleanup_wrapper_takes_legal_shapes_on_cpu(shape):
    h, w = shape
    rng = np.random.RandomState(h * 2048 + w)
    c = rng.randint(-3000, 3001, size=(3, h, w)).astype(np.int32)
    c[rng.rand(3, h, w) < 0.5] = 0
    hs = np.asarray([h, max(1, h - 1), max(1, h // 2)], np.int32)
    ws = np.asarray([w, max(1, w // 2 + 1), max(1, w - 1)], np.int32)
    got = ht_enc_cuda.cleanup_fields(torch.from_numpy(c), hs, ws, 16)
    for stream, n in zip(("ms", "vlc", "mel"), ht_enc.stream_words(h, w, 16)):
        assert got[f"{stream}_words"].shape == (3, n)
        assert got[f"{stream}_bits"].shape == (3,)
    if h * w > 64 and min(h, w) > 2 and max(h, w) < 1024:
        return          # the JAX comparison at the extreme shapes only
    words = got
    ref = ht_tpu._fields_fn(h, w, 16)(c, hs, ws)
    for k in ("ms", "vlc", "mel"):
        np.testing.assert_array_equal(words[f"{k}_words"].numpy().view(
            np.uint32), np.asarray(ref[f"{k}_words"]))
        np.testing.assert_array_equal(words[f"{k}_bits"].numpy(),
                                      np.asarray(ref[f"{k}_bits"]))
    np.testing.assert_array_equal(got["numbps"].numpy(),
                                  np.asarray(ref["numbps"]))
    np.testing.assert_array_equal(got["u_max"].numpy(),
                                  np.asarray(ref["u_max"]))


# ------------------------------------------- the segment pool's decomposition

POOL_WARPS = rc.define("ebcot_enc.cu", "POOL_WARPS")
POOL_MAX_CTAS = rc.define("ebcot_enc.cu", "POOL_MAX_CTAS")
POOL_COPY_UNROLL = rc.define("ebcot_enc.cu", "POOL_COPY_UNROLL")
POOL_ROWS = ebcot_cuda.pool_stress_rows()


def _pool_rows_model(ndec, lens, rows, rows_phase, pool_phase):
    """ebcot_pool_rows in numpy: runs of ceil(nb / (POOL_WARPS *
    POOL_MAX_CTAS)) rows a warp, a CTA of POOL_WARPS warps a tile, each
    tile's base the sum of every length before it, a warp's base that plus
    the runs of the warps before it, rows copied in turn by the warp copy;
    the row buffer starts rows_phase bytes and the pool pool_phase bytes
    past a 16-byte boundary.  Returns (pool prefix, total, stores, the
    pool's first address)."""
    nb = lens.size
    off = np.cumsum(ndec.astype(np.int64)) - ndec
    run = -(-nb // (POOL_WARPS * POOL_MAX_CTAS))
    grid = -(-nb // (POOL_WARPS * run))
    src = rc.Mem(rows, rows_phase)
    pool = rc.Mem(np.full(rows.size + 16, 0x5A, np.uint8), pool_phase)
    stores, totals, visited = [], [], []
    for c in range(grid):
        first = c * POOL_WARPS * run
        before = int(lens[:first].sum())
        spans = [(min(first + w * run, nb),
                  min(min(first + w * run, nb) + run, nb))
                 for w in range(POOL_WARPS)]
        mine = [int(lens[r0:r1].sum()) for r0, r1 in spans]
        if c == grid - 1:
            totals.append(before + sum(mine))
        for w, (r0, r1) in enumerate(spans):
            base = before + sum(mine[:w])
            for r in range(r0, r1):
                visited.append(r)
                rc.warp_copy(pool, base, src, 3 * int(off[r]) + 3 * r,
                             int(lens[r]), stores, POOL_COPY_UNROLL)
                base += int(lens[r])
    assert visited == list(range(nb)) and len(totals) == 1
    total = totals[0]
    assert (pool.data[total:] == 0x5A).all()
    return pool.data[:total], total, stores, pool.addr(0)


def _check_pool_model(name, rows_phase, pool_phases):
    ndec, lens, rows = POOL_ROWS[name]
    off = torch.from_numpy(np.cumsum(ndec.astype(np.int64)) - ndec)
    want, wtot = ebcot_cuda.pool_rows_plain(torch.from_numpy(rows), off,
                                            torch.from_numpy(lens))
    for pool_phase in pool_phases:
        got, total, stores, lo = _pool_rows_model(
            ndec, lens, rows, rows_phase, pool_phase)
        assert total == int(wtot)
        np.testing.assert_array_equal(got, want.numpy()[:total])
        rc.check_stores(stores, lo, lo + total)


@pytest.mark.parametrize("rows_phase", range(16))
def test_pool_rows_kernel_model_phases(rows_phase):
    """The segment-pool kernel's decomposition equals pool_rows_plain on
    short rows of every length phase, with the row buffer and the pool at
    every phase of 0 to 15 bytes past a 16-byte boundary; every store is
    aligned, inside its row's range, and the stores cover the pool's used
    prefix exactly once."""
    _check_pool_model("phases", rows_phase, range(16))


@pytest.mark.parametrize("name", sorted(set(POOL_ROWS) - {"phases"}))
def test_pool_rows_kernel_model_cases(name):
    """The same on rows of length 0, a batch of only empty rows, rows far
    longer than a warp's step, a single row, and more rows than
    POOL_MAX_CTAS tiles of a row a warp (runs of two, a partial last
    tile)."""
    ndec, lens, _rows = POOL_ROWS[name]
    if name == "many_rows":
        assert lens.size > POOL_WARPS * POOL_MAX_CTAS
        assert lens.size % (2 * POOL_WARPS)
    if name == "long_rows":
        assert lens.max() > 2 * 32 * POOL_COPY_UNROLL * 16
    if name == "all_empty":
        assert not lens.any()
    for rows_phase, pool_phase in ((0, 0), (5, 11), (15, 1)):
        _check_pool_model(name, rows_phase, [pool_phase])

