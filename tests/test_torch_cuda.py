"""The hand-written CUDA DWT level kernels (go_jpeg2000_tpu_torch/csrc/
dwt53.cu, dwt97.cu) against their plain torch version, on the card.  Needs
a CUDA device and nvcc; skips without a card.  Imports neither jax nor the
JAX package, so it runs where only torch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact equality, for 9/7 too (the kernel rounds the plain
version's float32 ops in the same order, without FMA contraction)."""
import numpy as np
import pytest
import torch

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu_torch.ops import dwt, dwt_cuda

BANDS = ("LL", "HL", "LH", "HH")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 512, 512), (32, 32, 32), (3, 2, 2),
                                   (2, 6, 10), (1, 2048, 2048),
                                   (2, 18, 34)])
def test_kernels_match_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    x = torch.randint(-40000, 40000, shape, generator=g, device=cuda,
                      dtype=torch.int32)
    before = dict(dwt_cuda.LAUNCHES)
    got = dwt_cuda.forward_2d_53(x)
    ref = dwt.forward_2d(x, dwt.REV53)
    for k in BANDS:
        assert torch.equal(got[k], ref[k]), k
    rec = dwt_cuda.inverse_2d_53(got)
    assert torch.equal(rec, dwt.inverse_2d(ref, dwt.REV53))
    assert torch.equal(rec, x)
    torch.cuda.synchronize()
    assert dwt_cuda.LAUNCHES["dwt53_fwd_level"] == \
        before["dwt53_fwd_level"] + 1
    assert dwt_cuda.LAUNCHES["dwt53_inv_level"] == \
        before["dwt53_inv_level"] + 1


@pytest.mark.cuda
def test_codec_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
              for _ in range(2)]
    opts = tp.Options(format=tp.Format.J2K, lossless=True,
                      high_throughput=True, num_resolutions=6)
    dwt_cuda.reset_counts()
    on_card = tp.encode_batch(frames, opts, device=cuda)
    decoded = tp.decode_batch(on_card, device=cuda)
    assert dwt_cuda.LAUNCHES["dwt53_fwd_level"] > 0
    assert dwt_cuda.LAUNCHES["dwt53_inv_level"] > 0
    assert on_card == tp.encode_batch(frames, opts, device="cpu")
    assert all(np.array_equal(d, f) for d, f in zip(decoded, frames))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 512, 512), (3, 2, 2), (2, 4, 8),
                                   (2, 6, 10), (1, 10, 6), (2, 34, 18),
                                   (1, 2048, 2048)])
def test_97_kernels_match_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    x = torch.randn(shape, generator=g, device=cuda) * 200
    before = dict(dwt_cuda.LAUNCHES)
    got = dwt_cuda.forward_2d_97(x)
    ref = dwt.forward_2d(x, dwt.IRR97)
    for k in BANDS:
        assert torch.equal(got[k], ref[k]), k
    rec = dwt_cuda.inverse_2d_97(got)
    assert torch.equal(rec, dwt.inverse_2d(ref, dwt.IRR97))
    assert float((rec - x).abs().max()) < 1e-3 * 200
    torch.cuda.synchronize()
    assert dwt_cuda.LAUNCHES["dwt97_fwd_level"] == \
        before["dwt97_fwd_level"] + 1
    assert dwt_cuda.LAUNCHES["dwt97_inv_level"] == \
        before["dwt97_inv_level"] + 1


@pytest.mark.cuda
def test_lossy_codec_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
              for _ in range(2)]
    opts = tp.Options(format=tp.Format.J2K, lossless=False, quality=85,
                      high_throughput=True, num_resolutions=6)
    dwt_cuda.reset_counts()
    on_card = tp.encode_batch(frames, opts, device=cuda)
    decoded = tp.decode_batch(on_card, device=cuda)
    assert dwt_cuda.LAUNCHES["dwt97_fwd_level"] > 0
    assert dwt_cuda.LAUNCHES["dwt97_inv_level"] > 0
    assert dwt_cuda.PLAIN_LEVELS == 0
    assert on_card == tp.encode_batch(frames, opts, device="cpu")
    on_cpu = tp.decode_batch(on_card, device="cpu")
    assert all(np.array_equal(d, c) for d, c in zip(decoded, on_cpu))
