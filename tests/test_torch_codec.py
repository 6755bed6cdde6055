"""The port's slices as a whole against the JAX package.  Lossless:
go_jpeg2000_tpu_torch encode_batch(device="cpu") must give codestreams
byte-identical to the JAX encode_batch, and each package must decode the
other's streams pixel-exactly.  Lossy 9/7: the float32 lifting may round
differently in the JAX package's jitted programs, so a quantizer index can
flip at a step boundary; every decode of either package's streams by
either decoder must agree within one grey level, and the port's PSNR must
be at least the JAX package's minus 0.05 dB.  Encodes inside the fused
device HT encode's reach must take it (enc.fused_chunks > 0 and no
enc.host_entropy_frames); what fused_encode.plan_for refuses takes the
counted host branch.  What the batch paths do not take goes through the
single-image encode and decode, as in the JAX package; the markers, the
python backend and signed samples match the JAX package too (PPM against
its encode: its encode_batch fails on PPM); decode_batch hands region and
reduced decodes to decode."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models.decoder import decode_batch as jax_decode_batch
from go_jpeg2000_tpu.models.encoder import encode as jp2k_encode
from go_jpeg2000_tpu.models.encoder import encode_batch as jax_encode_batch
from go_jpeg2000_tpu.options import Config, Format, Options

OPTS = Options(format=Format.J2K, lossless=True, high_throughput=True,
               num_resolutions=6)
# the JAX bench's lossy HT leg (bench.py htlossy97_512)
LOSSY = Options(format=Format.J2K, lossless=False, quality=85,
                num_resolutions=6, high_throughput=True)


def _frames(n, shape, seed, dtype=np.uint8):
    """Smooth noise, as bench.py's natural_image makes it."""
    rng = np.random.RandomState(seed)
    hi = np.iinfo(dtype).max + 1
    out = []
    for _ in range(n):
        a = rng.randint(0, hi, size=shape).astype(np.float64)
        for ax in (0, 1):
            a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
        out.append(a.astype(dtype))
    return out


@pytest.mark.parametrize("n,shape", [(3, (128, 128)), (2, (96, 80)),
                                     (2, (64, 64, 3))])
def test_encode_matches_jax_and_decodes_both_ways(n, shape):
    frames = _frames(n, shape, seed=shape[0] + n)
    tp.counters.reset()
    ours = tp.encode_batch(frames, tp.options_from_reference(OPTS),
                           device="cpu")
    _assert_fused()
    ref = jax_encode_batch(frames, OPTS)
    assert len(ours) == len(ref)
    assert all(a == b for a, b in zip(ours, ref))
    for got, f in zip(tp.decode_batch(ref, device="cpu"), frames):
        assert got.dtype == f.dtype and np.array_equal(got, f)
    for got, f in zip(jax_decode_batch(ours), frames):
        assert np.array_equal(got, f)


def _assert_fused():
    """The last encode ran the fused device HT encode and no host entropy."""
    snap = tp.counters.snapshot()
    assert snap.get("enc.fused_chunks", 0) > 0
    assert snap.get("enc.host_entropy_frames", 0) == 0


@pytest.mark.parametrize("case", ["plt", "gray16", "noise"])
def test_fused_encode_cases_match_jax(case):
    opts = OPTS
    if case == "plt":
        opts = dataclasses.replace(OPTS, enable_plt=True)
        frames = _frames(2, (96, 80, 3), seed=11)
    elif case == "gray16":
        frames = _frames(2, (72, 64), seed=12, dtype=np.uint16)
    else:
        rng = np.random.RandomState(13)
        frames = [rng.randint(0, 256, (80, 64)).astype(np.uint8)
                  for _ in range(2)]
    tp.counters.reset()
    ours = tp.encode_batch(frames, tp.options_from_reference(opts),
                           device="cpu")
    _assert_fused()
    assert ours == jax_encode_batch(frames, opts)
    for got, f in zip(tp.decode_batch(ours, device="cpu"), frames):
        assert np.array_equal(got, f)


def test_plan_refused_takes_counted_host_branch():
    # 32x32 precincts at the top resolution give its 64x64 bands two
    # precincts a side: plan_for refuses, the host entropy branch runs
    opts = dataclasses.replace(OPTS, precinct_size=[(5, 5)] * 6)
    frames = _frames(2, (128, 128), seed=14)
    tp.counters.reset()
    ours = tp.encode_batch(frames, tp.options_from_reference(opts),
                           device="cpu")
    snap = tp.counters.snapshot()
    assert snap.get("enc.host_entropy_frames", 0) == 2
    assert snap.get("enc.fused_chunks", 0) == 0
    assert ours == jax_encode_batch(frames, opts)


def _psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(peak ** 2 / mse)


@pytest.mark.parametrize("n,shape", [(2, (128, 128)), (2, (96, 80)),
                                     (2, (64, 64, 3))])
def test_lossy_decodes_agree_across_packages(n, shape):
    frames = _frames(n, shape, seed=shape[1] + 7)
    tp.counters.reset()
    ours = tp.encode_batch(frames, tp.options_from_reference(LOSSY),
                           device="cpu")
    _assert_fused()
    ref = jax_encode_batch(frames, LOSSY)
    decodes = [tp.decode_batch(ours, device="cpu"),
               tp.decode_batch(ref, device="cpu"),
               jax_decode_batch(ours), jax_decode_batch(ref)]
    for i, f in enumerate(frames):
        outs = [d[i] for d in decodes]
        assert all(o.shape == f.shape and o.dtype == f.dtype for o in outs)
        for o in outs[:3]:
            assert np.abs(o.astype(int) - outs[3]).max() <= 1
        assert _psnr(outs[0], f) >= _psnr(outs[3], f) - 0.05


def test_lossy_native_decode_matches_jax_magsgn():
    # the port's host branch (a tile origin off (0, 0)) decodes lossy HT
    # blocks with the native ht_t2_decode_frames, which the JAX package
    # never runs on lossy streams; it must give the indices of the JAX
    # package's device MagSgn decode
    from go_jpeg2000_tpu.codestream.parser import Parser as JParser
    from go_jpeg2000_tpu.models import fused_encode as jfe
    from go_jpeg2000_tpu.native import loader as jloader
    from go_jpeg2000_tpu.ops import ht_tpu_decode
    from go_jpeg2000_tpu.tcd import geometry as jgeo
    from go_jpeg2000_tpu_torch.codestream.parser import Parser
    from go_jpeg2000_tpu_torch.models import fused_encode
    from go_jpeg2000_tpu_torch.native import loader
    from go_jpeg2000_tpu_torch.tcd import geometry as geo

    frames = _frames(2, (80, 72, 3), seed=9)
    streams = tp.encode_batch(frames, tp.options_from_reference(LOSSY),
                              device="cpu")

    def walk(parser_cls, geo_mod, fe_mod):
        datas = []
        for s in streams:
            p = parser_cls(s)
            header = p.read_header()
            datas.append(b"".join(s[t.data_start:t.data_end]
                                  for t in p.read_all_tile_parts(header)))
        tile = geo_mod.build_tile(header, 0)
        plan = fe_mod.plan_for(header, tile, lossy=True)
        off = np.zeros(len(datas) + 1, np.int64)
        np.cumsum([len(d) for d in datas], out=off[1:])
        buf = np.frombuffer(b"".join(datas), np.uint8)
        geom = fe_mod.t2_geom(header, tile, plan)
        return (buf, off, len(datas), plan.nb, geom, geom["mb"], plan.ws,
                plan.hs, plan.cbh, plan.cbw), plan

    args, plan = walk(Parser, geo, fused_encode)
    ours = loader.ht_t2_decode_frames(*args)
    jargs, jplan = walk(JParser, jgeo, jfe)
    qinfo, pool, woff, _nw, _numbps = jloader.ht_t2_parse_frames(*jargs)
    ref = np.asarray(ht_tpu_decode.magsgn_decode_blocks(
        qinfo, pool, woff.astype(np.int32), jplan.cbh, jplan.cbw))
    assert plan.deltas == jplan.deltas
    assert np.abs(ours).max() > 0
    np.testing.assert_array_equal(ours, ref.reshape(ours.shape))


def _assert_device_decode(n_chunks=1):
    """The last decode ran the device HT branch and no host HT decode."""
    snap = tp.counters.snapshot()
    assert snap.get("dec.device_ht_chunks", 0) == n_chunks
    assert snap.get("dec.host_ht_frames", 0) == 0


@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("n,shape,dtype", [(3, (96, 80), np.uint8),
                                           (2, (64, 48, 3), np.uint8),
                                           (2, (40, 56), np.uint16)])
def test_decode_takes_device_branch_and_matches_jax(n, shape, dtype,
                                                    lossless):
    frames = _frames(n, shape, seed=shape[0] + n, dtype=dtype)
    opts = OPTS if lossless else LOSSY
    streams = jax_encode_batch(frames, opts)
    tp.counters.reset()
    ours = tp.decode_batch(streams, device="cpu")
    _assert_device_decode()
    ref = jax_decode_batch(streams)
    peak = float(np.iinfo(dtype).max)
    for o, r, f in zip(ours, ref, frames):
        assert o.shape == f.shape and o.dtype == f.dtype
        if lossless:
            assert np.array_equal(o, f) and np.array_equal(o, r)
        else:
            assert np.abs(o.astype(np.int64) - r).max() <= 1
            assert _psnr(o, f, peak) >= _psnr(r, f, peak) - 0.05


def test_decode_chunks_on_the_device_branch(monkeypatch):
    from go_jpeg2000_tpu_torch.models import decoder
    frames = _frames(5, (48, 40, 3), seed=21)
    streams = tp.encode_batch(frames, tp.options_from_reference(OPTS),
                              device="cpu")
    # room for two frames a chunk: 5 frames in 3 chunks of at most 2
    monkeypatch.setattr(decoder, "DECODE_CHUNK_BYTES",
                        2 * 48 * 40 * 3 * decoder.DECODE_BYTES_PER_SAMPLE)
    tp.counters.reset()
    got = tp.decode_batch(streams, device="cpu")
    _assert_device_decode(n_chunks=3)
    assert all(np.array_equal(g, f) for g, f in zip(got, frames))


@pytest.mark.parametrize("lossless", [True, False])
def test_offset_origin_takes_counted_host_branch(lossless):
    # an image offset puts the tile origin off (0, 0): the device branch
    # refuses it, as the JAX package's does, and the host HT branch runs
    frames = _frames(2, (64, 72), seed=31)
    opts = dataclasses.replace(OPTS if lossless else LOSSY,
                               image_offset=(32, 64))
    streams = jax_encode_batch(frames, opts)
    tp.counters.reset()
    ours = tp.decode_batch(streams, device="cpu")
    snap = tp.counters.snapshot()
    assert snap.get("dec.host_ht_frames", 0) == 2
    assert snap.get("dec.device_ht_chunks", 0) == 0
    for o, r, f in zip(ours, jax_decode_batch(streams), frames):
        assert o.shape == f.shape
        if lossless:
            assert np.array_equal(o, f) and np.array_equal(o, r)
        else:
            assert np.abs(o.astype(np.int64) - r).max() <= 1


def test_native_source_is_the_ports_own_identical_copy():
    from go_jpeg2000_tpu_torch.native import loader
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port_dir = os.path.join(root, "go_jpeg2000_tpu_torch", "native")
    assert os.path.dirname(loader._SRC) == port_dir
    assert os.path.dirname(loader._INC) == port_dir
    for name in ("j2k_native.cpp", "ht_tables.inc"):
        with open(os.path.join(port_dir, name), "rb") as f:
            ours = f.read()
        with open(os.path.join(root, "go_jpeg2000_tpu", "native", name),
                  "rb") as f:
            assert ours == f.read(), name


def test_plan_memo_keys_every_component():
    # two headers that differ only in component 1's QCC get their own plans
    from go_jpeg2000_tpu_torch.models import encoder, fused_encode
    from go_jpeg2000_tpu_torch.ops import quant
    from go_jpeg2000_tpu_torch.tcd import geometry as geo

    frame = _frames(1, (64, 64, 3), seed=4)[0]
    opts = tp.options_from_reference(LOSSY)
    plans = []
    for base_delta in (None, 0.25):
        header = encoder.build_header(frame, opts)
        encoder._apply_comp_quants(header, opts, 3, 8)
        if base_delta is not None:
            header.comp_quant[1] = quant.make_irreversible_quant(
                8, header.coding_style.num_decompositions, base_delta,
                guard_bits=3)
        plans.append(fused_encode.plan_for(header, geo.build_tile(header, 0),
                                           lossy=True))
    assert plans[0] is not plans[1]
    assert plans[0].deltas != plans[1].deltas
    n = len(plans[0].deltas) // 3
    assert plans[0].deltas[:n] == plans[1].deltas[:n]      # component 0
    assert plans[0].deltas[n:2 * n] != plans[1].deltas[n:2 * n]


def test_uint16_roundtrip_and_jax_decodes():
    frames = _frames(2, (48, 40, 3), seed=5, dtype=np.uint16)
    streams = tp.encode_batch(frames, tp.options_from_reference(OPTS),
                              device="cpu")
    for got, f in zip(tp.decode_batch(streams, device="cpu"), frames):
        assert got.dtype == np.uint16 and np.array_equal(got, f)
    for got, f in zip(jax_decode_batch(streams), frames):
        assert np.array_equal(got, f)


def test_options_and_config_from_reference():
    from go_jpeg2000_tpu.options import Config, ProgressionOrder
    o = dataclasses.replace(OPTS, progression_order=ProgressionOrder.RPCL,
                            comment="x")
    po = tp.options_from_reference(o)
    assert isinstance(po, tp.Options) and po.format == tp.Format.J2K
    assert int(po.progression_order) == int(ProgressionOrder.RPCL)
    assert po.comment == "x" and po.lossless and po.high_throughput
    pc = tp.config_from_reference(Config(quality_layers=1))
    assert isinstance(pc, tp.Config) and pc.quality_layers == 1


def _jax_streams(frames, override):
    """The JAX package's streams for frames under OPTS with `override`: its
    encode_batch, or, with PPM, which its encode_batch fails on (it
    concatenates the (PPM chunk, tile-part) pair to bytes), its encode of
    each frame, which the port's batch gives."""
    opts = dataclasses.replace(OPTS, **override)
    if override.get("enable_ppm"):
        with pytest.raises(TypeError):
            jax_encode_batch(frames, opts)
        return [jp2k_encode(f, opts) for f in frames]
    return jax_encode_batch(frames, opts)


@pytest.mark.parametrize("override", [
    dict(lossless=False, num_layers=2),
    dict(lossless=False, compression_ratio=10.0),
    dict(lossless=False, ht_refinement=True),
    dict(high_throughput=False, lossless=False),
    dict(format=tp.Format.JP2), dict(tile_size=(32, 32)),
    dict(num_layers=2), dict(compression_ratio=10.0),
    dict(enable_sop=True), dict(enable_ppm=True), dict(backend="python")])
def test_encode_outside_slice_raises(override):
    # (named for the refusals it held before the encode options were
    # ported) every override matches the JAX package: bytes for lossless,
    # decodes within one grey level (and its PSNR - 0.05 dB) for lossy,
    # its layers and budgets too; SOP, PPM and the python backend included
    opts = dataclasses.replace(tp.options_from_reference(OPTS), **override)
    frames = _frames(2, (32, 32), 0)
    ours = tp.encode_batch(frames, opts, device="cpu")
    ref = _jax_streams(frames, override)
    if opts.lossless:
        assert ours == ref
    for o, r, f in zip(tp.decode_batch(ours, device="cpu"),
                       jax_decode_batch(ref), frames):
        assert o.shape == f.shape and o.dtype == f.dtype
        assert np.abs(o.astype(int) - r).max() <= (0 if opts.lossless else 1)
        if not opts.lossless:
            assert _psnr(o, f) >= _psnr(r, f) - 0.05


def test_encode_rejects_mixed_shapes_and_signed():
    # (named for the refusal of signed samples it held before they were
    # ported) frames of differing shapes go through encode one by one, as
    # in the JAX package; signed int16 frames batch and give its bytes
    opts = tp.options_from_reference(OPTS)
    frames = [_frames(1, (32, 32), 1)[0], _frames(1, (32, 24), 2)[0]]
    got = tp.encode_batch(frames, opts, device="cpu")
    assert got == jax_encode_batch(frames, OPTS)
    assert got == [tp.encode(f, opts, device="cpu") for f in frames]
    signed = [(f.astype(np.int16) - 128) * 200 for f in
              _frames(2, (16, 16), 3)]
    got = tp.encode_batch(signed, opts, device="cpu")
    assert got == jax_encode_batch(signed, OPTS)
    for d, f in zip(tp.decode_batch(got, device="cpu"), signed):
        assert d.dtype == np.int16 and np.array_equal(d, f)


def test_decode_outside_slice_raises():
    # (named for the refusals it held before the decode options were
    # ported) reduced and region decodes go from decode_batch through
    # decode one by one, as the JAX package's decode_batch sends them,
    # and give its pixels and dtype
    stream = tp.encode_batch(_frames(1, (32, 32), 1),
                             tp.options_from_reference(OPTS), device="cpu")
    for kw in (dict(reduce_resolution=1), dict(decode_area=(0, 0, 8, 8))):
        got = tp.decode_batch(stream, tp.Config(**kw), device="cpu")
        want = jax_decode_batch(stream, Config(**kw))
        assert len(got) == len(want) == 1
        assert got[0].dtype == want[0].dtype
        assert got[0].shape == want[0].shape
        assert np.array_equal(got[0], want[0])
    # JP2 files decode (through decode, one by one) as the JAX package does
    frames = _frames(2, (32, 40, 3), 2)
    jp2 = jax_encode_batch(frames, dataclasses.replace(OPTS,
                                                       format=Format.JP2))
    for got, ref, f in zip(tp.decode_batch(jp2, device="cpu"),
                           jax_decode_batch(jp2), frames):
        assert np.array_equal(got, ref) and np.array_equal(got, f)
    with pytest.raises(tp.DecodeError):
        tp.decode_batch([b"not a codestream"], device="cpu")


def test_refined_streams_encode_and_decode_raises():
    # the 3-pass HT sets encode (native refined coder) and decode: the
    # native parse refuses their refinement passes, so decode_batch hands
    # the frames to decode (Python Tier-2, native refined block decoder)
    frames = _frames(2, (64, 64), 3)
    opts = dataclasses.replace(tp.options_from_reference(OPTS),
                               ht_refinement=True)
    streams = tp.encode_batch(frames, opts, device="cpu")
    assert streams != tp.encode_batch(frames, tp.options_from_reference(OPTS),
                                      device="cpu")
    assert streams == jax_encode_batch(
        frames, dataclasses.replace(OPTS, ht_refinement=True))
    tp.counters.reset()
    got = tp.decode_batch(streams, device="cpu")
    assert tp.counters.snapshot().get("dec.device_ht_chunks", 0) == 0
    for g, r, f in zip(got, jax_decode_batch(streams), frames):
        assert np.array_equal(g, f) and np.array_equal(g, r)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames = _frames(1, (16, 16), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.encode_batch(frames, tp.options_from_reference(OPTS))
    stream = tp.encode_batch(frames, tp.options_from_reference(OPTS),
                             device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.decode_batch(stream)


def test_import_leaves_jax_out():
    code = ("import sys, go_jpeg2000_tpu_torch, "
            "go_jpeg2000_tpu_torch.ops.ht_enc_cuda, "
            "go_jpeg2000_tpu_torch.ops.ht_dec_cuda, "
            "go_jpeg2000_tpu_torch.models.fused_encode, "
            "go_jpeg2000_tpu_torch.ops.band_stats, "
            "go_jpeg2000_tpu_torch.utils.boxes, "
            "go_jpeg2000_tpu_torch.models.entropy_backend, "
            "go_jpeg2000_tpu_torch.models.transforms, "
            "go_jpeg2000_tpu_torch.models.encoder, "
            "go_jpeg2000_tpu_torch.models.decoder, "
            "go_jpeg2000_tpu_torch.parallel, "
            "go_jpeg2000_tpu_torch.parallel.multihost, "
            "go_jpeg2000_tpu_torch.entry; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'go_jpeg2000_tpu')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=root)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("override", [
    dict(), dict(lossless=False), dict(high_throughput=False),
    dict(num_resolutions=7)])
def test_decode_batch_levels_past_the_frame(override):
    # 16x16 frames at 5 or 6 levels: the top levels' detail bands are
    # empty and the block plans leave them out of the batch decode's
    # pyramid, whose inverse raised KeyError before it made them zero-size;
    # the JAX package's decode_batch raises KeyError on the HT ones too
    # (its fused branch; go_jpeg2000_tpu/ops/dwt.py:226), its decode does
    # not
    import go_jpeg2000_tpu as jp2k
    frames = _frames(2, (16, 16), 7)
    opts = dataclasses.replace(OPTS, **override)
    streams = jax_encode_batch(frames, opts)
    tp.counters.reset()
    got = tp.decode_batch(streams, device="cpu")
    snap = tp.counters.snapshot()
    assert snap.get("dec.device_ht_chunks", 0) + snap.get(
        "dec.ebcot_frames", 0) > 0
    if opts.high_throughput:
        with pytest.raises(KeyError):
            jax_decode_batch(streams)
    for g, r, f in zip(got, [jp2k.decode(x) for x in streams], frames):
        assert np.abs(g.astype(int) - r).max() <= (0 if opts.lossless
                                                   else 1)
        if opts.lossless:
            assert np.array_equal(g, f)
