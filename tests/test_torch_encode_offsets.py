"""Tile and image offsets at the edges of what a codestream may hold.

1. A tile offset past the image offset breaks Header.validate's rule, which
   every decoder holds a stream to.  The JAX package's `encode` writes such
   a stream anyway and its `decode` refuses it; the port's four encoders
   (encode, encode_batch, encode_sharded, encode_multihost) refuse the
   options with ValueError before they write anything.  This departs from
   the JAX package on purpose.
2. Thin tiles whose levels go empty: a last tile row one sample high at an
   odd origin, a first tile column 15 wide at an odd origin and a last one
   2 wide.  The JAX package's encode raises there and its decode returns
   wrong pixels, so the oracle is OpenJPEG (through Pillow): the port's
   stream decodes to the input under OpenJPEG, and the port decodes
   OpenJPEG's stream of the same geometry to the input.  Only geometries
   whose OpenJPEG round trip is exact are used (with a tile offset of
   (1, 0) OpenJPEG's own round trip fails, so the 36x49x3 cases anchor
   their tiles at (0, 0) under an image offset).

About 10 s serial (7 s of it the JAX package's first encode); part 2
skips where Pillow has no OpenJPEG."""
import io

import numpy as np
import pytest

import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.options import Options as JaxOptions
from go_jpeg2000_tpu_torch.parallel import encode_multihost, encode_sharded

try:
    from PIL import Image, features
    HAVE_OPJ = features.check("jpg_2000")
except Exception:
    HAVE_OPJ = False


def _image(shape, seed):
    """Smooth 8-bit noise, as bench.py's natural_image makes it."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=shape).astype(np.float64)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


PAST = dict(lossless=True, tile_size=(32, 32), tile_offset=(2, 5),
            image_offset=(0, 0))


def test_jax_writes_a_tile_offset_past_the_image_offset_its_decode_refuses():
    img = _image((29, 59, 4), 0)
    data = jp2k.encode(img, JaxOptions(**PAST))
    assert len(data) > 0
    with pytest.raises(ValueError, match="tile offset must not exceed"):
        jp2k.decode(data)


@pytest.mark.parametrize("encoder", ["encode", "encode_batch",
                                     "encode_sharded", "encode_multihost"])
def test_port_encoders_refuse_a_tile_offset_past_the_image_offset(encoder):
    img = _image((29, 59, 4), 0)
    opts = tp.Options(**PAST)
    run = {"encode": lambda: tp.encode(img, opts, device="cpu"),
           "encode_batch": lambda: tp.encode_batch([img, img], opts,
                                                   device="cpu"),
           "encode_sharded": lambda: encode_sharded(img, opts,
                                                    device="cpu"),
           "encode_multihost": lambda: encode_multihost(
               img, opts, n_hosts=2, device="cpu")}[encoder]
    with pytest.raises(ValueError, match="tile offset must not exceed"):
        run()
    # one past on either axis alone is refused too; equal offsets are legal
    for kw in (dict(tile_offset=(1, 0)), dict(tile_offset=(0, 1))):
        with pytest.raises(ValueError, match="tile offset must not exceed"):
            tp.encode(img, tp.Options(tile_size=(32, 32), **kw),
                      device="cpu")
    ok = tp.Options(lossless=True, tile_size=(32, 32), tile_offset=(2, 5),
                    image_offset=(2, 5))
    assert np.array_equal(tp.decode(tp.encode(img, ok, device="cpu"),
                                    device="cpu"), img)


# (shape, image offset (x, y), tile offset, tile side, resolutions, HT)
THIN = {
    "33x35 last tile row 1 high, Part-1":
        ((33, 35), (0, 3), (0, 3), 32, 5, False),
    "33x35 last tile row 1 high, HT": ((33, 35), (0, 3), (0, 3), 32, 5, True),
    "36x49x3 tile columns 15 and 2 wide, HT":
        ((36, 49, 3), (1, 0), (0, 0), 16, 4, True),
    "36x49x3 last tile row 4 high at an odd origin, HT":
        ((36, 49, 3), (0, 1), (0, 1), 16, 4, True),
}


@pytest.mark.skipif(not HAVE_OPJ, reason="Pillow lacks OpenJPEG")
@pytest.mark.parametrize("case", sorted(THIN))
def test_thin_tiles_round_trip_against_openjpeg(case):
    shape, off, toff, side, nres, ht = THIN[case]
    img = _image(shape, len(case))
    opts = tp.Options(format=tp.Format.J2K, lossless=True, image_offset=off,
                      tile_offset=toff, tile_size=(side, side),
                      num_resolutions=nres, high_throughput=ht)
    data = tp.encode(img, opts, device="cpu")
    assert np.array_equal(tp.decode(data, device="cpu"), img)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG2000", offset=off,
                              tile_offset=toff, tile_size=(side, side),
                              num_resolutions=nres, irreversible=False,
                              no_jp2=True)
    theirs = buf.getvalue()
    # OpenJPEG's own round trip is exact here, so its stream is an oracle
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(theirs))), img)
    assert np.array_equal(tp.decode(theirs, device="cpu"), img)
