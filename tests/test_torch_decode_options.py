"""The port's decode options (go_jpeg2000_tpu_torch.decode on the CPU)
against the JAX package's decode, on streams the JAX encoder writes from
images made from a seed at small sizes (at most 256x256).

Region decodes (Config.decode_area) mirror tests/test_region_decode.py
with its counter assertions, and the counters (dec.tiles_skipped,
dec.packets_skipped, dec.packet_bytes_skipped, dec.blocks_skipped) equal
the JAX package's; layered decodes (quality_layers) at every layer count
and reduced decodes (reduce_resolution) at every level, HT and Part-1,
lossless and 9/7, with the levels the card's level kernels refuse
(dwt_cuda.usable; dwt_cuda.PLAIN_LEVELS counts them on the card) counted
at even and odd image offsets: none, odd origins included.  Lossless
decodes equal the JAX package's exactly, dtype included; lossy 9/7
decodes within one grey level.  Colour spaces and sample types are in
tests/test_torch_decode_samples.py."""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.options import Config, Format, Options
from go_jpeg2000_tpu_torch.models import transforms
from go_jpeg2000_tpu_torch.ops import dwt_cuda
from tests.decode_parity import (assert_close, decode_both, decode_exact,
                                 ht_opts, make_image)

# ---------------------------------------- tests/test_region_decode.py

def test_tiled_region_skips_tiles():
    img = make_image((256, 256), 1)
    data = jp2k.encode(img, ht_opts(tile_size=(64, 64), enable_plt=True))
    crop, snap = decode_exact(data, decode_area=(0, 0, 60, 60))
    assert np.array_equal(crop, img[0:60, 0:60])
    assert snap.get("dec.tiles_skipped", 0) == 15
    assert snap.get("dec.tiles_decoded", 0) == 1


def test_tiled_region_center():
    img = make_image((256, 256), 2)
    data = jp2k.encode(img, ht_opts(tile_size=(64, 64), enable_plt=True))
    crop, snap = decode_exact(data, decode_area=(100, 70, 140, 130))
    assert np.array_equal(crop, img[70:130, 100:140])
    assert snap.get("dec.tiles_decoded", 0) == 4
    assert snap.get("dec.tiles_skipped", 0) == 12


def test_precinct_region_skips_packets_via_plt():
    img = make_image((256, 256), 3)
    data = jp2k.encode(img, ht_opts(enable_plt=True,
                                precinct_size=[(5, 5)] * 3))
    full, snap = decode_exact(data)
    assert np.array_equal(full, img)
    total_packets = snap.get("dec.packets_parsed", 0)
    assert total_packets > 20
    crop, snap = decode_exact(data, decode_area=(0, 0, 40, 40))
    assert np.array_equal(crop, img[0:40, 0:40])
    assert snap.get("dec.packets_skipped", 0) > 0
    assert snap.get("dec.packet_bytes_skipped", 0) > 0
    parsed = snap.get("dec.packets_parsed", 0)
    assert parsed + snap["dec.packets_skipped"] == total_packets
    assert parsed < total_packets // 2


def test_precinct_region_without_plt_skips_blocks():
    img = make_image((256, 256), 4)
    data = jp2k.encode(img, ht_opts(precinct_size=[(5, 5)] * 3))
    _full, snap = decode_exact(data)
    all_blocks = snap.get("dec.blocks_decoded", 0)
    crop, snap = decode_exact(data, decode_area=(200, 200, 256, 256))
    assert np.array_equal(crop, img[200:256, 200:256])
    assert snap.get("dec.packets_skipped", 0) == 0     # no PLT to seek with
    assert snap.get("dec.blocks_skipped", 0) > 0
    assert snap.get("dec.blocks_decoded", 0) < all_blocks


def test_region_with_reduce_resolution():
    img = make_image((256, 256), 5)
    data = jp2k.encode(img, ht_opts(tile_size=(128, 128), enable_plt=True))
    full_r1, _ = decode_exact(data, reduce_resolution=1)
    crop, snap = decode_exact(data, decode_area=(0, 0, 100, 100),
                        reduce_resolution=1)
    assert np.array_equal(crop, full_r1[0:50, 0:50])
    assert snap.get("dec.tiles_skipped", 0) == 3


def test_region_decode_ebcot_multilayer():
    # the JAX test writes this stream with backend "python"; the native
    # coder writes the same bytes faster
    img = make_image((128, 128), 6)
    opts = ht_opts(high_throughput=False, tile_size=(64, 64), num_layers=2,
               enable_plt=True)
    data = jp2k.encode(img, opts)
    crop, snap = decode_exact(data, decode_area=(64, 64, 128, 128))
    assert np.array_equal(crop, img[64:128, 64:128])
    assert snap.get("dec.tiles_skipped", 0) == 3


def test_region_decode_subsampled_components():
    img = make_image((128, 128, 3), 9)
    data = jp2k.encode(img, ht_opts(tile_size=(64, 64), enable_plt=True))
    crop, snap = decode_exact(data, decode_area=(32, 32, 96, 96))
    assert np.array_equal(crop, img[32:96, 32:96])
    assert snap.get("dec.tiles_decoded", 0) == 4


# ---------------------------------------------- layered and reduced

LAYERED = {
    "ht_lossless": dict(high_throughput=True, lossless=True),
    "ht_97": dict(high_throughput=True, lossless=False),
    "part1_lossless": dict(high_throughput=False, lossless=True),
    "part1_97": dict(high_throughput=False, lossless=False),
}


@pytest.fixture(scope="module", params=sorted(LAYERED))
def layered(request):
    kw = LAYERED[request.param]
    img = make_image((64, 80, 3), 7)
    data = jp2k.encode(img, Options(format=Format.J2K, num_resolutions=3,
                                    num_layers=3, compression_ratio=3.0,
                                    tile_size=(64, 48), **kw))
    return img, data, kw["lossless"]


def test_layered_decode_every_layer_count(layered):
    img, data, lossless = layered
    errs = []
    for q in (1, 2, 3):
        got, want, ours, theirs = decode_both(data, quality_layers=q)
        assert_close(got, want, lossless)
        assert ours["dec.blocks_decoded"] == theirs["dec.blocks_decoded"]
        errs.append(np.abs(got.astype(np.int64) - img).mean())
    # every layer adds passes: the error falls, or stays where it is
    assert errs[0] >= errs[1] >= errs[2]


def _levels_seen(monkeypatch):
    """Every inverse level transforms.inverse_level runs, as (h, w, u0, v0)
    of its output."""
    seen = []
    run = transforms.inverse_level

    def spy(bands, kind, u0, v0, above=None, below=None):
        out = run(bands, kind, u0, v0, above, below)
        seen.append(tuple(out.shape[-2:]) + (u0, v0))
        return out

    monkeypatch.setattr(transforms, "inverse_level", spy)
    return seen


def test_reduced_decode_every_level(layered, monkeypatch):
    _img_, data, lossless = layered
    seen = _levels_seen(monkeypatch)
    for r in (0, 1, 2):
        seen.clear()
        got, want, _o, _t = decode_both(data, reduce_resolution=r)
        assert_close(got, want, lossless)
        assert got.shape[:2] == (-(-64 // (1 << r)), -(-80 // (1 << r)))
        # 4 tiles, each (2 - r) levels; none the level kernels refuse
        assert len(seen) == 4 * (2 - r)
        assert not [s for s in seen if not dwt_cuda.usable(*s)]


@pytest.mark.parametrize("offset", [(0, 0), (3, 5)])
def test_reduced_decode_at_image_offsets(offset, monkeypatch):
    """Odd image offsets give odd level origins, and the level kernels take
    them: the plain levels (what dwt_cuda.PLAIN_LEVELS counts on the card,
    the levels dwt_cuda.usable refuses) are none at either offset, and the
    odd offset's decodes do run levels at odd origins."""
    img = make_image((48, 40), 8)
    data = jp2k.encode(img, ht_opts(num_resolutions=4, image_offset=offset))
    seen = _levels_seen(monkeypatch)
    plain = []
    odd = []
    for r in (0, 1, 2, 3, 4):
        seen.clear()
        if r == 4:   # more than the stream's 3 levels: both raise
            with pytest.raises(ValueError):
                tp.decode(data, tp.Config(reduce_resolution=r),
                          device="cpu")
            with pytest.raises(ValueError):
                jp2k.decode(data, Config(reduce_resolution=r))
            continue
        got, _ = decode_exact(data, reduce_resolution=r)
        if r == 0:
            assert np.array_equal(got, img)
        plain.append(len([s for s in seen if not dwt_cuda.usable(*s)]))
        odd.append(len([s for s in seen if any(v & 1 for v in s)]))
    assert plain == [0, 0, 0, 0]
    if offset == (0, 0):
        assert odd == [0, 0, 0, 0]
    else:
        assert odd[0] > 0 and odd[-1] == 0
