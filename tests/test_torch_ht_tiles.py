"""Block extraction of a tile-origin class read in place (about 10 s
serial): the port's plain fused_encode.extract_blocks with `tiles`, and
encode_pyramid with `tiles`, against the JAX package's jnp.take of the
class's tiles then _extract_blocks, and against the port's own gathered
batch, on the same numpy frames made from a seed, on the CPU.  Exact.
Positions past the leaves and leaves of unequal frames are refused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models import encoder as jenc
from go_jpeg2000_tpu.models import fused_encode as jfe
from go_jpeg2000_tpu.options import Format, Options
from go_jpeg2000_tpu.tcd import geometry as jgeo
from go_jpeg2000_tpu_torch.models import encoder, fused_encode, transforms
from go_jpeg2000_tpu_torch.ops import dwt, ht_enc_cuda
from go_jpeg2000_tpu_torch.tcd import geometry as geo

LEVELS = 5
CLASS = [1, 3, 6]          # a non-contiguous class of 8 tiles


def _setup(lossless, shape=(64, 64, 3), n=8):
    """(port plan, JAX plan, the pyramid of n frames on the CPU)."""
    rng = np.random.RandomState(7 + lossless)
    frames = [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]
    ropts = Options(format=Format.J2K, lossless=lossless, quality=85,
                    num_resolutions=LEVELS + 1, high_throughput=True)
    popts = tp.options_from_reference(ropts)
    plans = []
    for enc, geo_mod, fe, opts in ((encoder, geo, fused_encode, popts),
                                   (jenc, jgeo, jfe, ropts)):
        header = enc.build_header(frames[0], opts)
        enc._apply_comp_quants(header, opts, header.num_components,
                               header.components[0].precision)
        plans.append(fe.plan_for(header, geo_mod.build_tile(header, 0),
                                 lossy=not lossless))
    batch = np.stack([np.stack(encoder._image_components(f))
                      for f in frames])
    pyr = transforms.forward_pyramid(
        transforms.upload(batch, torch.device("cpu")), LEVELS,
        dwt.REV53 if lossless else dwt.IRR97, batch.shape[1] >= 3, 8, False,
        0, 0)
    return plans[0], plans[1], pyr


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["int32-lossless", "float32-lossy"])
def test_extract_blocks_of_a_class_matches_jax_take(lossless):
    plan, jplan, pyr = _setup(lossless)
    leaf = pyr[0]["HL"]
    assert leaf.dtype == (torch.int32 if lossless else torch.float32)
    got = fused_encode.extract_blocks(pyr, plan, len(CLASS), LEVELS, CLASS)
    idx = jnp.asarray(CLASS)
    jpyr = [{k: jnp.take(jnp.asarray(v.contiguous().numpy()), idx, axis=0)
             for k, v in e.items()} for e in pyr]
    ref = np.asarray(jfe._extract_blocks(jpyr, jplan, len(CLASS), LEVELS))
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.abs(ref).max() > 0
    # the wrapper's CPU branch is the plain version
    assert torch.equal(ht_enc_cuda.extract_blocks(pyr, plan, len(CLASS),
                                                  LEVELS, CLASS), got)


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["int32-lossless", "float32-lossy"])
def test_encode_pyramid_of_a_class_equals_the_gathered_batch(lossless):
    plan, _jplan, pyr = _setup(lossless)
    out, totals = fused_encode.encode_pyramid(pyr, plan, len(CLASS), LEVELS,
                                              tiles=CLASS)
    idx = torch.tensor(CLASS)
    gathered = [{k: v.index_select(0, idx) for k, v in e.items()}
                for e in pyr]
    ref, ref_totals = fused_encode.encode_pyramid(gathered, plan, len(CLASS),
                                                  LEVELS)
    assert torch.equal(totals, ref_totals)
    assert torch.equal(out, ref)
    assert int(totals.sum()) > 0


def test_encode_pyramid_refuses_tiles_past_the_leaves():
    plan, _jplan, pyr = _setup(True, shape=(64, 64), n=2)
    for tiles in ([0, 2], [-1, 0], [0]):
        with pytest.raises(ValueError):
            fused_encode.encode_pyramid(pyr, plan, 2, LEVELS, tiles=tiles)


def test_extract_blocks_refuses_leaves_of_unequal_frames():
    """A leaf with fewer frames than the others is refused with `tiles`,
    even where every position lies below the first leaf's count."""
    plan, _jplan, pyr = _setup(True, shape=(64, 64), n=3)
    short = [dict(e) for e in pyr]
    short[1]["HH"] = short[1]["HH"][:2]
    for extract in (fused_encode.extract_blocks, ht_enc_cuda.extract_blocks):
        assert extract(pyr, plan, 2, LEVELS, [2, 0]).shape[0] == 2 * plan.nb
        with pytest.raises(ValueError, match="frames"):
            extract(short, plan, 2, LEVELS, [2, 0])
