"""The port's batched device transforms (go_jpeg2000_tpu_torch.models.
transforms) against the JAX package's: the packed flat forward pyramid
(DC shift, RCT, 5 levels of 5/3, int16 narrowing) and the batched inverse
from one flat upload, exact, dtype included; the ICT, exact; and the lossy
chain (ICT, 9/7, device deadzone quantization; midpoint dequantization,
inverse 9/7, inverse ICT, rounding), where the JAX package's jitted
programs may round the float32 lifting differently: at least 99.9% of the
quantizer indices equal and none off by more than one, decoded samples
within one.  Gray and RGB, 6 resolutions."""
import numpy as np
import pytest

import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

from go_jpeg2000_tpu.models import transforms as jt
from go_jpeg2000_tpu.ops import mct as jmct
from go_jpeg2000_tpu.ops import quant as jquant
from go_jpeg2000_tpu.utils import fetch
from go_jpeg2000_tpu_torch.models import transforms as tt
from go_jpeg2000_tpu_torch.ops import mct, quant

LEVELS = 5


@pytest.mark.parametrize("c,h,w", [(1, 64, 64), (3, 64, 64), (1, 96, 80),
                                   (3, 96, 80)])
def test_forward_and_inverse_batch_match_jax(c, h, w):
    n = 2
    batch = np.random.RandomState(c * h + w).randint(
        0, 256, size=(n, c, h, w)).astype(np.uint8)
    args = (LEVELS, "53", c >= 3, 8, False, 0, 0)

    ref = np.asarray(jt.forward_transform_batch(n, c, h, w, *args)(
        batch.reshape(-1)))
    got = tt.dispatch_forward_batch(batch, *args, "cpu").numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)

    # inverse from the same (unflattened, stacked) pyramid
    pyrs = tt.fetch_forward_batch(tt.dispatch_forward_batch(
        batch, *args, "cpu"), n, c, h, w, LEVELS, 0, 0)
    stacked = [{k: np.stack([p[lev][k] for p in pyrs]) for k in pyrs[0][lev]}
               for lev in range(LEVELS)]
    ref_inv = fetch.gather(jt.dispatch_inverse_stacked(
        stacked, n, c, *args))
    got_inv = tt.dispatch_inverse_stacked(stacked, n, c, *args, "cpu").numpy()
    np.testing.assert_array_equal(got_inv.view(ref_inv.dtype), ref_inv)
    np.testing.assert_array_equal(got_inv.reshape(batch.shape), batch)


def test_rct_and_quant_ops_match_jax():
    rng = np.random.RandomState(4)
    r, g, b = (rng.randint(-300, 300, (8, 12)).astype(np.int32)
               for _ in range(3))
    ours = mct.forward_rct(*(torch.from_numpy(a) for a in (r, g, b)))
    ref = jmct.forward_rct(r, g, b)
    for o, e in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(e))
    back = mct.inverse_rct(*ours)
    for o, e in zip(back, (r, g, b)):
        np.testing.assert_array_equal(o.numpy(), e)
    c = (rng.randn(16, 16) * 50).astype(np.float32)
    q = quant.quantize(torch.from_numpy(c), 0.75)
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jquant.quantize(c, 0.75)))
    np.testing.assert_array_equal(
        quant.dequantize(q, 0.75).numpy(),
        np.asarray(jquant.dequantize(q.numpy(), 0.75)))


def test_ict_matches_jax():
    rng = np.random.RandomState(5)
    rgb = [rng.randint(-128, 128, (16, 24)).astype(np.int32)
           for _ in range(3)]
    ycc = mct.forward_ict(*(torch.from_numpy(a) for a in rgb))
    for o, e in zip(ycc, jmct.forward_ict(*rgb)):
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), np.asarray(e))
    f = [(rng.randn(16, 24) * 80).astype(np.float32) for _ in range(3)]
    back = mct.inverse_ict(*(torch.from_numpy(a) for a in f))
    for o, e in zip(back, jmct.inverse_ict(*f)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(e))


def _leaf_deltas(levels, seed):
    rng = np.random.RandomState(seed)
    return tuple(float(d) for d in rng.uniform(0.4, 3.0, 3 * levels + 1))


@pytest.mark.parametrize("c,h,w", [(1, 64, 64), (3, 64, 64), (1, 96, 80)])
def test_lossy_forward_and_inverse_batch_match_jax(c, h, w):
    n = 2
    batch = np.random.RandomState(c + h + w).randint(
        0, 256, size=(n, c, h, w)).astype(np.uint8)
    args = (LEVELS, "97", c >= 3, 8, False, 0, 0)
    deltas = _leaf_deltas(LEVELS, h + w)

    flat = tt.dispatch_forward_batch(batch, *args, "cpu", deltas)
    assert flat.dtype == torch.int16          # precision <= 10
    ours = tt.fetch_forward_batch(flat, n, c, h, w, LEVELS, 0, 0)
    got, ref = [], []
    for i in range(n):
        pyr = jt.run_forward(list(batch[i].astype(np.int32)), *args,
                             quant_deltas=deltas)
        for lev in range(LEVELS):
            for k in sorted(pyr[lev]):
                got.append(ours[i][lev][k].reshape(-1))
                ref.append(np.asarray(pyr[lev][k]).reshape(-1))
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert np.abs(got - ref).max() <= 1
    assert (got == ref).mean() >= 0.999

    # inverse: our indices, dequantized by both packages at the midpoint
    stacked = [{k: np.stack([p[lev][k] for p in ours]) for k in ours[0][lev]}
               for lev in range(LEVELS)]
    by_leaf = iter(deltas)
    dmap = [{k: (next(by_leaf),) * c for k in sorted(stacked[lev])}
            for lev in range(LEVELS)]
    got_inv = tt.dispatch_inverse_stacked(stacked, n, c, *args, "cpu",
                                          dmap).numpy()
    deq = [{k: np.asarray(jquant.dequantize(v, dmap[lev][k][0]))
            for k, v in stacked[lev].items()} for lev in range(LEVELS)]
    ref_inv = fetch.gather(jt.dispatch_inverse_stacked(deq, n, c, *args))
    assert got_inv.dtype == np.uint8
    assert np.abs(got_inv.astype(int) - ref_inv.astype(int)).max() <= 1


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tt.resolve_device("cuda")
