"""Quality layers and byte budgets through the fused HT batch encode.

With ht_refinement=False an HTJ2K encode_batch takes the fused device HT
encode even with quality layers or a compression_ratio, as in the JAX
package: native single-layer Tier-2 only at one layer without a budget,
else the natively serialized segments (one truncation point a block) go
through the PCRD of each frame and the Python Tier-2.  Lossless streams
must be byte-identical to the JAX package's encode_batch; lossy ones must
decode within one grey level of the JAX stream's decode, at a PSNR at
least the JAX package's minus 0.05 dB, inside the byte budget."""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.models.decoder import decode as jax_decode
from go_jpeg2000_tpu.models.encoder import encode_batch as jax_encode_batch
from go_jpeg2000_tpu.options import Format, Options


def _img(shape, seed):
    """Smooth noise (two-tap), as the JAX package's multihost tests make
    it."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=shape).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax)) / 2
    return a.astype(np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def _fused(frames, opts):
    tp.counters.reset()
    out = tp.encode_batch(frames, tp.options_from_reference(opts),
                          device="cpu")
    snap = tp.counters.snapshot()
    assert snap.get("enc.fused_chunks", 0) > 0
    assert snap.get("enc.host_entropy_frames", 0) == 0
    return out


@pytest.mark.parametrize("kw", [dict(num_layers=2),
                                dict(num_layers=2, compression_ratio=3.0)],
                         ids=["layers2", "layers2_ratio3"])
def test_fused_batch_layers_and_budget_match_jax(kw):
    # before the repair the fused branch always wrote one layer by native
    # Tier-2: 15,362 bytes for both cases, against the JAX package's
    # 15,366 and 4,283
    frame = _img((128, 128), 0)
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=4,
                   high_throughput=True, ht_refinement=False, **kw)
    ours = _fused([frame], opts)
    ref = jax_encode_batch([frame], opts)
    assert ours == ref
    assert len(ours[0]) == (4283 if "compression_ratio" in kw else 15366)
    if "compression_ratio" not in kw:
        assert np.array_equal(tp.decode(ours[0], device="cpu"), frame)


def test_fused_batch_lossy_layers_and_budget():
    frames = [_img((128, 128), 1), _img((128, 128), 2)]
    opts = Options(format=Format.J2K, lossless=False, quality=95,
                   num_resolutions=4, high_throughput=True,
                   ht_refinement=False, num_layers=2, compression_ratio=5.0)
    ours = _fused(frames, opts)
    ref = jax_encode_batch(frames, opts)
    budget = frames[0].size / opts.compression_ratio
    for o, r, f in zip(ours, ref, frames):
        assert len(o) <= budget
        got, want = tp.decode(o, device="cpu"), jax_decode(r)
        assert np.abs(got.astype(int) - want).max() <= 1
        assert _psnr(got, f) >= _psnr(want, f) - 0.05
