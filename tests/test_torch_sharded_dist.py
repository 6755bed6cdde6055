"""The port's tile-sharded pipeline on gloo groups of ranks spawned on the
CPU, (dp, sp) = (2, 1), (1, 2) and (2, 2): the four checks of the JAX
package's dryrun_multichip.  Every rank must return the same codestream:
for lossless HT (16-bit RGB, signed 16-bit RGB, and with SOP, EPH, PLT,
TLM and PPM) and for Part-1 with two layers and a byte budget (the
distributed PCRD; also with all six code-block styles, PPM and TLM)
byte-identical to the JAX package's
encoder.encode, for lossy 9/7 HT to the port's single-process encode (the
halo lifting is exact whatever the grid).  decode_sharded must give every
rank the lossless image back exactly, and the lossy decode of the
single-process run.

The ranks (tests/torch_dist_worker.py) import the port and torch only; they
meet through a file in the test's temporary directory, so no port is
needed."""
import pickle

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores
import torch.multiprocessing as mp

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models import encoder as jenc
from go_jpeg2000_tpu.options import Format, Options
from go_jpeg2000_tpu_torch.native import loader
from go_jpeg2000_tpu_torch.parallel import decode_sharded, encode_sharded

from . import torch_dist_worker

TILE = (32, 16)                  # 16 = sp * 2^levels * 2 at sp = 2


def _img(shape, seed, depth=8):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 1 << depth, size=shape).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    return a.astype(np.uint8 if depth <= 8 else np.uint16)


def _opts(**kw):
    return Options(format=Format.J2K, num_resolutions=3, tile_size=TILE,
                   **kw)


# 3 x 3 tiles: dp = 2 gives its shards 5 and 4 tiles
IMAGE = _img((48, 96, 3), seed=9)
IMAGE16 = _img((48, 96, 3), seed=10, depth=16)
IMAGE_GRAY = _img((48, 96), seed=11)
CASES = [("ht", IMAGE16, _opts(lossless=True, high_throughput=True), True),
         ("ht gray", IMAGE_GRAY, _opts(lossless=True, high_throughput=True),
          True),
         ("part1 budget", IMAGE, _opts(lossless=True, num_layers=2,
                                       compression_ratio=6.0), False),
         ("lossy ht", IMAGE, _opts(lossless=False, quality=85,
                                   high_throughput=True), True),
         # markers in the tile-parts: the device HT segments through the
         # Python Tier-2; PPM and TLM counted over the ranks in the budget
         ("ht markers", IMAGE, _opts(lossless=True, high_throughput=True,
                                     enable_sop=True, enable_eph=True,
                                     enable_plt=True, enable_tlm=True,
                                     enable_ppm=True), True),
         ("part1 styled ppm budget", IMAGE, _opts(
             lossless=True, num_layers=2, compression_ratio=6.0,
             code_block_style=0x3f, enable_ppm=True, enable_tlm=True),
          False),
         ("ht signed", (IMAGE16.astype(np.int32) - 32768).astype(np.int16),
          _opts(lossless=True, high_throughput=True), True)]


@pytest.fixture(scope="module")
def single():
    """Each case in one process: the JAX encoder's bytes for the lossless
    cases, the port's for all, and the port's decodes."""
    loader.available()         # build the native library before any spawn
    out = {}
    for name, image, opts, decode in CASES:
        data = encode_sharded(image, tp.options_from_reference(opts),
                              device="cpu")
        ref = data if name == "lossy ht" else jenc.encode(image, opts)
        pix = decode_sharded(data, device="cpu") if decode else None
        out[name] = (ref, data, pix)
    return out


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2)])
def test_grid_matches_single_process(dp, sp, single, tmp_path):
    cases = [(im, tp.options_from_reference(o), d) for _n, im, o, d in CASES]
    mp.spawn(torch_dist_worker.run,
             args=(dp * sp, str(tmp_path / "rdv"), str(tmp_path), dp, sp,
                   cases), nprocs=dp * sp)
    for rank in range(dp * sp):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        for (name, image, opts, decode), (data, pix) in zip(CASES, got):
            ref, mine, ref_pix = single[name]
            assert mine == ref, name
            assert data == ref, (rank, name)
            if decode:
                assert np.array_equal(pix, ref_pix), (rank, name)
                if opts.lossless:
                    assert np.array_equal(pix, image), (rank, name)
