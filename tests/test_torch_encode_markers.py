"""The port's encoders with the codestream markers and progression changes
(SOP, EPH, PLT, TLM, PPT, PPM, POC) against the JAX package's encode, on
images made from a seed at 48-64 px.

Lossless streams must equal go_jpeg2000_tpu.encode byte for byte through
every encoder of the port: `encode`, `encode_batch` (the fused HT encode,
Part-1 device EBCOT paths A and B, and the host path C), `encode_sharded`
in one process and `encode_multihost(n_hosts=1)`; the port's decode gives
the image back.  encode_multihost refuses PPM and TLM with ValueError, as
the JAX package does.  Where the JAX package's encode_batch is wrong (it
drops TLM and fails on PPM) the port's batch gives each frame its `encode`
stream; a test records both."""
import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.codestream.parser import Parser
from go_jpeg2000_tpu.models.encoder import encode_batch as jax_encode_batch
from go_jpeg2000_tpu.options import Format, Options, ProgressionOrder
from go_jpeg2000_tpu.parallel import multihost as jax_multihost
from go_jpeg2000_tpu_torch.parallel import encode_multihost, encode_sharded


def _image(shape, seed):
    """Smooth noise, as bench.py's natural_image makes it."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=shape).astype(np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def _opts(**kw):
    base = dict(format=Format.J2K, lossless=True, num_resolutions=3)
    base.update(kw)
    return Options(**base)


def _same_as_jax(image, opts, decode=True):
    """The port's encode of `image` equals the JAX package's, and decodes to
    the image; returns the stream."""
    ours = tp.encode(image, tp.options_from_reference(opts), device="cpu")
    assert ours == jp2k.encode(image, opts)
    if decode:
        assert np.array_equal(tp.decode(ours, device="cpu"), image)
    return ours


RGB = _image((64, 64, 3), 11)


# --- POC (tests/test_codestream.py TestPOC) ---------------------------------

@pytest.mark.parametrize("ht", [False, True])
def test_poc_two_segments(ht):
    opts = _opts(num_resolutions=4, num_layers=2, high_throughput=ht,
                 progression_changes=[(0, 0, 2, 2, 3, 0), (2, 0, 2, 4, 3, 4)])
    data = _same_as_jax(RGB, opts)
    assert b"\xff\x5f" in data
    assert tp.decode_metadata(data).num_layers == 2


@pytest.mark.parametrize("ht", [False, True])
def test_poc_partial_coverage_gets_a_catch_all_segment(ht):
    from go_jpeg2000_tpu_torch.models import encoder
    opts = _opts(high_throughput=ht, progression_changes=[(0, 0, 1, 1, 3, 1)])
    h = encoder.build_header(RGB, tp.options_from_reference(opts))
    assert [tuple(vars(p).values()) for p in h.poc] == \
        [(0, 0, 1, 1, 3, 1), (0, 0, 1, 3, 3, 0)]
    _same_as_jax(RGB, opts)


def test_poc_entry_of_wrong_length_raises_in_both():
    opts = _opts(progression_changes=[(0, 0, 1, 1, 3)])
    with pytest.raises(ValueError, match="progression_changes"):
        tp.encode(RGB, tp.options_from_reference(opts), device="cpu")
    with pytest.raises(ValueError, match="progression_changes"):
        jp2k.encode(RGB, opts)


# --- PLT / TLM (tests/test_codestream.py TestPLTTLM) ------------------------

@pytest.mark.parametrize("kw", [dict(enable_plt=True), dict(enable_tlm=True),
                                dict(enable_plt=True, num_layers=2),
                                dict(enable_tlm=True, tile_size=(32, 32))])
def test_plt_tlm(kw):
    gray = _image((64, 64), 9)
    data = _same_as_jax(gray, _opts(**kw))
    p = Parser(data)
    hdr = p.read_header()
    tps = p.read_all_tile_parts(hdr)
    if kw.get("enable_tlm"):
        assert [ln for _, ln in hdr.tlm] == [tp.tile_part_length
                                             for tp in tps]
    else:
        assert sum(tps[0].packet_lengths) == \
            tps[0].data_end - tps[0].data_start


# --- PPT / PPM (tests/test_codestream.py TestPackedHeaders) -----------------

@pytest.mark.parametrize("kw", [
    {"enable_ppt": True},
    {"enable_ppt": True, "tile_size": (32, 32)},
    {"enable_ppt": True, "enable_sop": True, "enable_eph": True},
    {"enable_ppt": True, "high_throughput": True, "num_layers": 2},
    {"enable_ppm": True},
    {"enable_ppm": True, "tile_size": (32, 32), "num_layers": 2},
    {"enable_ppm": True, "enable_sop": True, "enable_eph": True},
])
def test_packed_headers(kw):
    data = _same_as_jax(RGB, _opts(**kw))
    assert (b"\xff\x61" if kw.get("enable_ppt") else b"\xff\x60") in data


def test_ppm_and_tlm_count_in_the_budget():
    # core_size counts the PPM and TLM segments: the budget holds with them
    opts = _opts(tile_size=(32, 32), num_layers=2, compression_ratio=4.0,
                 enable_ppm=True, enable_tlm=True)
    data = _same_as_jax(RGB, opts, decode=False)
    assert len(data) <= RGB.size / 4.0


# --- SOP / EPH and progression orders (tests/test_e2e.py) -------------------

@pytest.mark.parametrize("ht", [False, True])
def test_sop_eph(ht):
    _same_as_jax(_image((48, 48), 9), _opts(enable_sop=True,
                                            enable_eph=True,
                                            high_throughput=ht))


@pytest.mark.parametrize("po", list(ProgressionOrder))
def test_progression_orders_with_sop(po):
    _same_as_jax(_image((48, 48), 7), _opts(progression_order=po,
                                            num_layers=2, enable_sop=True))


def test_lossy_markers_within_one_grey_level():
    opts = _opts(lossless=False, quality=85, num_layers=2, enable_sop=True,
                 enable_eph=True, enable_plt=True, enable_tlm=True,
                 enable_ppt=True)
    ours = tp.encode(RGB, tp.options_from_reference(opts), device="cpu")
    ref = jp2k.encode(RGB, opts)
    got, want = tp.decode(ours, device="cpu"), jp2k.decode(ref)
    assert np.abs(got.astype(int) - want).max() <= 1
    mse = lambda a: np.mean((a.astype(np.float64) - RGB) ** 2)
    assert 10 * np.log10(mse(want) / mse(got)) >= -0.05


# --- encode_batch: every branch with markers --------------------------------

BATCH_MARKERS = [dict(enable_sop=True, enable_eph=True),
                 dict(enable_ppt=True),
                 dict(enable_plt=True, enable_tlm=True),
                 dict(progression_changes=[(0, 0, 1, 2, 3, 1)]),
                 dict(enable_ppm=True, enable_eph=True)]

# (options, the branch's counter) of each batch branch
BRANCHES = {
    "fused": (dict(high_throughput=True), "enc.fused_chunks"),
    "path_a": (dict(backend="device"), "enc.ebcot_device_chunks"),
    "path_b": (dict(backend="hybrid"), "enc.ebcot_hybrid_chunks"),
    "path_c": (dict(backend="native"), "enc.host_entropy_frames"),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("markers", BATCH_MARKERS,
                         ids=lambda kw: "+".join(sorted(kw)))
def test_encode_batch_branches(branch, markers):
    kw, counter = BRANCHES[branch]
    opts = _opts(**kw, **markers)
    popts = tp.options_from_reference(opts)
    frames = [_image((48, 48, 3), s) for s in (1, 2)]
    tp.counters.reset()
    got = tp.encode_batch(frames, popts, device="cpu")
    snap = tp.counters.snapshot()
    if opts.enable_ppm:
        # PPM takes the host path in the JAX package's branches too
        counter = "enc.host_entropy_frames"
    assert snap.get(counter, 0) > 0
    assert got == [jp2k.encode(f, opts) for f in frames]
    assert got == [tp.encode(f, popts, device="cpu") for f in frames]
    for data, f in zip(tp.decode_batch(got, device="cpu"), frames):
        assert np.array_equal(data, f)


@pytest.mark.parametrize("ht", [False, True])
def test_jax_encode_batch_drops_tlm_and_fails_on_ppm(ht):
    # the JAX package's encode_batch writes main + tile-part + EOC without
    # _finalize_codestream (go_jpeg2000_tpu/models/encoder.py:732-736,
    # :917-919): no TLM, and the (ppm_chunk, tile_part) pair of a PPM
    # assembly fails to concatenate; the port's batch is its encode
    frame = _image((32, 32, 3), 3)
    tlm = _opts(high_throughput=ht, enable_tlm=True)
    ref = jp2k.encode(frame, tlm)
    jax_batch = jax_encode_batch([frame], tlm)[0]
    assert b"\xff\x55" in ref and b"\xff\x55" not in jax_batch
    assert len(ref) - len(jax_batch) == 11
    assert tp.encode_batch([frame], tp.options_from_reference(tlm),
                           device="cpu") == [ref]
    ppm = _opts(high_throughput=ht, enable_ppm=True)
    with pytest.raises(TypeError):
        jax_encode_batch([frame], ppm)
    assert tp.encode_batch([frame], tp.options_from_reference(ppm),
                           device="cpu") == [jp2k.encode(frame, ppm)]


# --- encode_sharded (one process) and encode_multihost (one host) -----------

SHARDED = [dict(high_throughput=True, enable_sop=True, enable_eph=True,
                enable_plt=True, enable_tlm=True),
           dict(high_throughput=True, enable_ppm=True),
           dict(high_throughput=True, enable_ppt=True,
                progression_changes=[(0, 0, 1, 2, 3, 1)]),
           dict(enable_sop=True, enable_ppt=True, num_layers=2),
           dict(enable_ppm=True, enable_tlm=True, num_layers=2,
                compression_ratio=4.0)]


@pytest.mark.parametrize("kw", SHARDED, ids=lambda kw: "+".join(sorted(kw)))
def test_encode_sharded(kw):
    opts = _opts(tile_size=(32, 32), **kw)
    tp.counters.reset()
    got = encode_sharded(RGB, tp.options_from_reference(opts), device="cpu")
    snap = tp.counters.snapshot()
    assert got == jp2k.encode(RGB, opts)
    device_ht = opts.high_throughput and opts.num_layers == 1
    # the device HT encode codes every tile, markers or not
    assert snap.get("enc.sharded_device_ht_tiles", 0) == \
        (4 if device_ht else 0)
    if opts.compression_ratio <= 1.0:
        assert np.array_equal(tp.decode(got, device="cpu"), RGB)


@pytest.mark.parametrize("kw", [dict(enable_sop=True, enable_eph=True),
                                dict(enable_plt=True, enable_ppt=True,
                                     num_layers=2, compression_ratio=4.0),
                                dict(enable_ppm=True), dict(enable_tlm=True)],
                         ids=lambda kw: "+".join(sorted(kw)))
def test_encode_multihost_one_host(kw):
    opts = _opts(tile_size=(32, 32), high_throughput=True, **kw)
    popts = tp.options_from_reference(opts)
    if opts.enable_ppm or opts.enable_tlm:
        with pytest.raises(ValueError, match="PPM/TLM"):
            encode_multihost(RGB, popts, n_hosts=1, device="cpu")
        with pytest.raises(ValueError, match="PPM/TLM"):
            jax_multihost.encode_multihost(RGB, opts, n_hosts=1)
        return
    assert encode_multihost(RGB, popts, n_hosts=1, device="cpu") == \
        jp2k.encode(RGB, opts)


def test_jp2_with_markers():
    opts = dataclasses.replace(_opts(enable_sop=True, enable_tlm=True,
                                     tile_size=(32, 32)), format=Format.JP2)
    data = _same_as_jax(RGB, opts)
    assert encode_sharded(RGB, tp.options_from_reference(opts),
                          device="cpu") == data


def test_encode_multihost_signed_styled_one_host():
    # styles and signed samples flow through the host's encode
    image = (RGB.astype(np.int16) - 128) * 100
    opts = _opts(tile_size=(32, 32), code_block_style=0x3f, enable_sop=True,
                 num_layers=2)
    assert encode_multihost(image, tp.options_from_reference(opts),
                            n_hosts=1, device="cpu") == \
        jp2k.encode(image, opts)
