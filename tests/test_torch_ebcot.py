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


def _check_slots(blocks, bands, h, w, max_planes):
    mags, signs, classes, valid = _batch(blocks, bands, h, w)
    want = np.asarray(jax_ebcot.decision_slots(mags, signs, classes, valid,
                                               max_planes))
    got = ebcot_cuda.decision_slots(
        torch.from_numpy(mags), torch.from_numpy(signs),
        torch.from_numpy(classes), torch.from_numpy(valid),
        max_planes).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == max_planes * ebcot_device.slots_per_plane(h, w)
    for stream, c, band in zip(ebcot_device.compact_host(got), blocks,
                               bands):
        trace = []
        t1.encode_block(c, band, cb_style=0, trace=trace)
        assert stream == trace
    return got


@pytest.mark.parametrize("shape,mag,density", [
    ((8, 8), 200, 0.6), ((16, 16), 2000, 0.4), ((4, 4), 3, 0.9),
    ((12, 16), 50, 0.2), ((32, 32), 500, 0.5)])
def test_decision_slots_match_jax(shape, mag, density):
    """The three band classes in one batch, at each shape of the JAX
    package's decision-kernel cases, with one plane above the data's."""
    rng = np.random.RandomState(shape[0] * 1000 + mag)
    blocks = []
    for _ in range(3):
        c = rng.randint(-mag, mag + 1, size=shape).astype(np.int32)
        c[rng.rand(*shape) < density] = 0
        blocks.append(c)
    h = -(-shape[0] // 4) * 4
    _check_slots(blocks, ["LL", "HL", "HH"], h, max(shape[1], 4),
                 int(mag).bit_length() + 1)


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
    slots = _check_slots(blocks, bands, 64, 64, 18)
    assert (slots[-1] == ebcot_device.EMPTY).all()


def test_decision_slots_propagation_chain_and_run_length():
    """A diagonal forces a long SPP propagation chain (the fixpoint's
    depth); a sparse block is run-length heavy."""
    chain = np.zeros((16, 16), np.int32)
    for i in range(16):
        chain[i, i] = 3
    chain[0, 0] = 7
    _check_slots([chain], ["LL"], 16, 16, 8)
    sparse = np.zeros((16, 16), np.int32)
    sparse[9, 3] = -1
    sparse[2, 12] = 1
    _check_slots([sparse], ["HH"], 16, 16, 4)


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
    opts = dataclasses.replace(tp.options_from_reference(OPTS), **override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp.encode_batch([natural_image(32, 32, 0)], opts, device="cpu")


@pytest.mark.parametrize("override", [dict(lossless=False, quality=80),
                                      dict(code_block_style=1)])
def test_decode_outside_slice_raises(override):
    stream = jax_encode_batch([natural_image(32, 32, 0)],
                              dataclasses.replace(OPTS, **override))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp.decode_batch(stream, device="cpu")


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
