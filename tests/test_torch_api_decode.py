"""The port's single-image decode (go_jpeg2000_tpu_torch.decode and
decode_metadata, on the CPU) against the JAX package's, on streams the JAX
package writes from images made from a seed at small sizes (at most 96x80,
tiles of 32), and on OpenJPEG's streams through Pillow (skipped where Pillow
lacks OpenJPEG).

Lossless streams (multi-tile, layered, budgeted, HT refinement passes,
SOP/EPH, PPM, PPT, PLT, TLM, JP2, offsets) decode to the JAX package's
pixels exactly; lossy 9/7 streams within one grey level.  decode_metadata
agrees field for field.  decode_batch hands what its batch branches do not
take (multi-tile, refined, JP2) to decode; decode_sharded decodes Part-1,
layered and absent-tile streams through the host tile decode, both equal to
the JAX package's decode.  The decode options (region, reduced and
layered decodes, colour conversions, signed samples) give the JAX
package's pixels and dtype; tests/test_torch_decode_options.py holds them
in full."""
import dataclasses
import io

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.options import ColorSpace, Config, Format, Options
from go_jpeg2000_tpu_torch.codestream.parser import Parser
from go_jpeg2000_tpu_torch.parallel import decode_sharded

try:
    from PIL import Image, features
    HAVE_OPJ = features.check("jpg_2000")
except Exception:
    HAVE_OPJ = False


def _image(shape, seed, dtype=np.uint8):
    """Smooth noise, as bench.py's natural_image makes it."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, np.iinfo(dtype).max + 1, size=shape).astype(np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(dtype)


def _opts(**kw):
    return Options(**{"format": Format.J2K, "lossless": True,
                      "num_resolutions": 3, **kw})


STREAMS = {
    "ht_tiles_rgb": ((64, 48, 3), _opts(high_throughput=True,
                                        tile_size=(32, 32))),
    "part1_tiles": ((64, 80), _opts(tile_size=(32, 32))),
    "ht_refined_layers": ((64, 64), _opts(high_throughput=True,
                                          num_layers=3)),
    "part1_layers_ratio": ((64, 64, 3), _opts(num_layers=2,
                                              compression_ratio=4.0,
                                              tile_size=(32, 32))),
    "ht_ratio_tiles": ((64, 64), _opts(high_throughput=True,
                                       compression_ratio=3.0,
                                       tile_size=(32, 32))),
    "sop_eph": ((48, 48, 3), _opts(enable_sop=True, enable_eph=True,
                                   tile_size=(32, 32))),
    "ht_sop_eph_layers": ((48, 40), _opts(high_throughput=True,
                                          enable_sop=True, enable_eph=True,
                                          num_layers=2)),
    "ppm": ((64, 48), _opts(enable_ppm=True, tile_size=(32, 32))),
    "ppt_eph": ((48, 64), _opts(enable_ppt=True, enable_eph=True,
                                high_throughput=True, tile_size=(32, 32))),
    "plt_tlm": ((48, 48), _opts(enable_plt=True, enable_tlm=True,
                                tile_size=(32, 32))),
    "jp2_offsets": ((50, 45, 3), _opts(format=Format.JP2, tile_size=(32, 32),
                                       tile_offset=(3, 2),
                                       image_offset=(5, 7))),
    "lossy_ht_tiles": ((64, 64, 3), _opts(lossless=False,
                                          high_throughput=True,
                                          tile_size=(32, 32))),
    "lossy_part1": ((80, 64), _opts(lossless=False, quality=70)),
    "lossy_jp2_default": ((48, 64, 3), Options()),
}


def _stream(name):
    shape, opts = STREAMS[name]
    image = _image(shape, seed=len(name))
    return image, opts, jp2k.encode(image, opts)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_matches_jax(name):
    image, opts, data = _stream(name)
    got = tp.decode(data, device="cpu")
    want = jp2k.decode(data)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(int) - want).max() <= (0 if opts.lossless
                                                    else 1)
    if opts.lossless and opts.compression_ratio <= 1.0:
        assert np.array_equal(got, image)


def _fields(meta):
    out = {}
    for f in dataclasses.fields(meta):
        v = getattr(meta, f.name)
        if f.name == "components":
            v = [dataclasses.astuple(c) for c in v]
        elif hasattr(v, "value"):
            v = (type(v).__name__, int(v))
        out[f.name] = v
    return out


@pytest.mark.parametrize("name,kw", [
    ("j2k", _opts(high_throughput=True, tile_size=(32, 32), num_layers=2,
                  comment="tiles")),
    ("jp2_rgb", Options(lossless=True, num_resolutions=4)),
    ("jp2_gray_icc", Options(icc_profile=b"\x00" * 8)),
    ("jp2_sycc", Options(color_space=ColorSpace.SYCC, lossless=True))])
def test_decode_metadata_matches_jax(name, kw):
    image = _image((48, 40, 3) if "gray" not in name else (48, 40), seed=1)
    data = jp2k.encode(image, kw)
    assert _fields(tp.decode_metadata(data)) == \
        _fields(jp2k.decode_metadata(data))


def test_decode_batch_hands_other_streams_to_decode():
    frames = [_image((48, 40, 3), seed=s) for s in range(2)]
    streams = [jp2k.encode(frames[0], _opts(tile_size=(32, 32),
                                            high_throughput=True)),
               jp2k.encode(frames[1], _opts(high_throughput=True,
                                            ht_refinement=True)),
               jp2k.encode(frames[0], Options(lossless=True)),
               jp2k.encode(frames[1], _opts(high_throughput=True))]
    # one by one (tiled, refined, JP2), then mixed in one call
    for batch in ([streams[0]] * 2, [streams[1]] * 2, [streams[2]] * 2,
                  streams):
        tp.counters.reset()
        got = tp.decode_batch(batch, device="cpu")
        assert tp.counters.snapshot().get("dec.device_ht_chunks", 0) == 0
        for g, s in zip(got, batch):
            assert np.array_equal(g, tp.decode(s, device="cpu"))
            assert np.array_equal(g, jp2k.decode(s))


def _drop_tile(data, t_idx):
    """The codestream without tile t_idx's tile-parts."""
    p = Parser(data)
    header = p.read_header()
    out = data
    for tp_info in sorted(p.read_all_tile_parts(header),
                          key=lambda x: -x.data_start):
        if tp_info.tile_index == t_idx:
            sot = out.rfind(b"\xff\x90", 0, tp_info.data_start)
            out = out[:sot] + out[tp_info.data_end:]
    return out


@pytest.mark.parametrize("case", ["part1", "layered", "absent_tile",
                                  "refined"])
def test_decode_sharded_host_branch_matches_jax(case):
    image = _image((64, 64, 3), seed=7)
    opts = _opts(tile_size=(32, 32), high_throughput=case != "part1",
                 num_layers=2 if case == "layered" else 1,
                 ht_refinement=True if case == "refined" else None)
    data = jp2k.encode(image, opts)
    if case == "absent_tile":
        data = _drop_tile(data, 1)
    tp.counters.reset()
    got = decode_sharded(data, device="cpu")
    assert tp.counters.snapshot().get("dec.sharded_host_tiles", 0) == 4
    want = jp2k.decode(data)
    assert np.array_equal(got, want)
    assert np.array_equal(tp.decode(data, device="cpu"), want)
    if case == "absent_tile":
        assert not want[:32, 32:].any()


def test_corrupt_tile_stays_zero_and_max_pixels():
    image = _image((64, 64), seed=4)
    data = bytearray(jp2k.encode(image, _opts(tile_size=(32, 32))))
    p = Parser(bytes(data))
    header = p.read_header()
    t2 = [t for t in p.read_all_tile_parts(header) if t.tile_index == 2][0]
    data[t2.data_start:t2.data_end] = b"\xff" * (t2.data_end - t2.data_start)
    got = tp.decode(bytes(data), device="cpu")
    assert np.array_equal(got, jp2k.decode(bytes(data)))
    with pytest.raises(tp.DecodeError, match="max_pixels"):
        tp.decode(bytes(data), tp.Config(max_pixels=100), device="cpu")


@pytest.mark.parametrize("fault", ["no_native_library", "inverse_fails"])
def test_multi_tile_decode_raises_on_non_data_faults(fault, monkeypatch):
    """Per-tile containment covers corrupt data only: a missing native
    library or a failing device inverse raises on a tiled image instead of
    leaving its tiles zero."""
    from go_jpeg2000_tpu_torch.models import transforms
    from go_jpeg2000_tpu_torch.native import loader
    data = jp2k.encode(_image((64, 64), seed=5), _opts(tile_size=(32, 32)))
    if fault == "no_native_library":
        monkeypatch.setattr(loader, "available", lambda: False)
        want = "native entropy library"
    else:
        def fail(*_a, **_k):
            raise RuntimeError("inverse failed")
        monkeypatch.setattr(transforms, "run_inverse", fail)
        want = "inverse failed"
    with pytest.raises(RuntimeError, match=want):
        tp.decode(data, device="cpu")


@pytest.mark.skipif(not HAVE_OPJ, reason="Pillow lacks OpenJPEG")
@pytest.mark.parametrize("shape,kw", [
    ((64, 48), dict(irreversible=False)),
    ((48, 64, 3), dict(irreversible=False, tile_size=(32, 32))),
    ((64, 64, 3), dict(irreversible=False, quality_mode="rates",
                       quality_layers=[20, 10, 0], progression="RPCL")),
    ((64, 80, 3), dict(irreversible=True, quality_mode="rates",
                       quality_layers=[8])),
    ((48, 48), dict(irreversible=True, no_jp2=True))])
def test_decode_openjpeg_streams(shape, kw):
    image = _image(shape, seed=shape[1])
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG2000", **kw)
    data = buf.getvalue()
    got = tp.decode(data, device="cpu")
    want = jp2k.decode(data)
    lossless = not kw["irreversible"] and "quality_layers" not in kw
    assert got.shape == image.shape
    assert np.abs(got.astype(int) - want).max() <= (0 if lossless else 1)
    if lossless:
        assert np.array_equal(got, image)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# The next two tests keep the names of the refusals they held before the
# decode options were ported; they now hold the options to the JAX
# package's decode.
@pytest.mark.parametrize("kw", [
    dict(reduce_resolution=1), dict(decode_area=(0, 0, 8, 8)),
    dict(quality_layers=1)])
def test_decode_options_still_out_raise(kw):
    data = jp2k.encode(_image((32, 32), 0), _opts(num_layers=2))
    _same(tp.decode(data, tp.Config(**kw), device="cpu"),
          jp2k.decode(data, Config(**kw)))


def test_colour_conversion_and_signed_still_out_raise():
    image = _image((32, 32, 3), 0)
    data = jp2k.encode(image, Options(color_space=ColorSpace.SYCC))
    _same(tp.decode(data, device="cpu"), jp2k.decode(data))
    signed = jp2k.encode(
        (_image((16, 16), 1).astype(np.int16) - 128) * 100, _opts())
    got = tp.decode(signed, device="cpu")
    _same(got, jp2k.decode(signed))
    assert got.dtype == np.int16 and got.min() < 0
    with pytest.raises(ValueError):
        tp.decode(b"\x00\x00\x00\x0cjP  \r\n\x87\n" + b"\x00" * 16,
                  device="cpu")
