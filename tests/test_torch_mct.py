"""The head and tail of the port's transform chains (go_jpeg2000_tpu_torch.
models.transforms coefficients and samples, the plain versions of the
kernels of csrc/mct.cu) against the JAX package's lines that its device
programs chain (go_jpeg2000_tpu/models/transforms.py forward_transform_batch
and the batched inverse, over go_jpeg2000_tpu/ops/mct.py), run eagerly, on
the CPU: the samples as transforms.upload ships them (uint8, int8, int16,
uint16, int32), precisions 1, 8, 12, 16 and 29-31, signed and unsigned, 1,
3 and 4 components, with and without the colour transform, 5/3 and 9/7,
the tail narrowed and not.  Tolerance: exact, dtype included, float32 too
(each float32 op rounds once in both packages, in the same order).  The
tail's float inputs stay inside int32 after the inverse ICT: out of range,
torch's CPU conversion gives INT_MIN where XLA and the card saturate.

Also: a CPU tensor never reaches the kernels' wrappers (mct_cuda.LAUNCHES
stays 0, and the wrappers refuse a CPU tensor), and device "cuda" without
a card raises.  About 11 s serial."""
import numpy as np
import pytest

import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import jax.numpy as jnp

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.ops import mct as jmct
from go_jpeg2000_tpu_torch.models import transforms as tt
from go_jpeg2000_tpu_torch.ops import dwt, mct_cuda

DTYPES = (np.uint8, np.int8, np.int16, np.uint16, np.int32)
PRECISIONS = (1, 8, 12, 16, 29, 30, 31)
SHAPE = (2, 4, 3, 5)          # frames, components, rows, columns
CPU = torch.device("cpu")


def _samples(dtype, seed):
    """[2, 4, 3, 5] samples over the dtype's whole range, its extremes
    included."""
    info = np.iinfo(dtype)
    rng = np.random.RandomState(seed)
    a = rng.randint(info.min, int(info.max) + 1, size=SHAPE, dtype=np.int64)
    a.reshape(-1)[:4] = (info.min, info.max, 0, 1)
    return a.astype(dtype)


def _jax_head(comps, kind, use_mct, precision, signed):
    """forward_transform_batch's head (go_jpeg2000_tpu/models/
    transforms.py:223-233), eagerly."""
    x = jnp.asarray(comps).astype(jnp.int32)
    if not signed:
        x = x - (1 << (precision - 1))
    c = x.shape[1]
    if use_mct and c >= 3:
        fwd = jmct.forward_rct if kind == dwt.REV53 else jmct.forward_ict
        y, u, v = fwd(x[:, 0], x[:, 1], x[:, 2])
        x = jnp.stack([y, u, v] + [x[:, i] for i in range(3, c)], axis=1)
    if kind == dwt.IRR97:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def _jax_tail(x, kind, use_mct, precision, signed):
    """The batched inverse's tail (go_jpeg2000_tpu/models/transforms.py
    :345-355), eagerly: (int32 samples, the narrowed ones)."""
    x = jnp.asarray(x)
    c = x.shape[1]
    if use_mct and c >= 3:
        inv = jmct.inverse_rct if kind == dwt.REV53 else jmct.inverse_ict
        r, g, b = inv(x[:, 0], x[:, 1], x[:, 2])
        x = jnp.stack([r, g, b] + [x[:, i] for i in range(3, c)], axis=1)
    if kind == dwt.IRR97:
        x = jnp.rint(x).astype(jnp.int32)
    if not signed:
        x = x + (1 << (precision - 1))
    x = jmct.clamp_to_precision(x, precision, signed)
    if precision <= 8:
        narrow = x.astype(jnp.int8 if signed else jnp.uint8)
    elif precision <= 16:
        narrow = x.astype(jnp.int16 if signed else jnp.uint16)
    else:
        narrow = x
    return np.asarray(x), np.asarray(narrow)


def _tail_input(head, kind, seed):
    """The head's coefficients moved a little: 5/3 by -3..3 with int32's
    extremes among them, 9/7 by halves (rounding ties) and kept within
    2^29, so the inverse ICT stays inside int32."""
    rng = np.random.RandomState(seed)
    if kind == dwt.REV53:
        x = (head.astype(np.int64) + rng.randint(-3, 4, head.shape)).astype(
            np.int32)
        x.reshape(-1)[-3:] = (np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                              -1)
        return x
    x = head + rng.randint(-4, 5, head.shape).astype(np.float32) / 2
    return np.clip(x, -2.0 ** 29, 2.0 ** 29).astype(np.float32)


def _equal(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    if want.dtype == np.uint16:
        got = got.view(np.uint16)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_head_and_tail_match_jax(dtype, precision, signed):
    seed = precision * 7 + DTYPES.index(dtype) * 2 + signed
    batch = _samples(dtype, seed)
    x = tt.upload(batch, CPU)
    for kind in (dwt.REV53, dwt.IRR97):
        for use_mct in (False, True):
            # one reference on 4 components; the functions work plane by
            # plane, so 1 and 3 components are its first planes
            ref = _jax_head(batch, kind, use_mct, precision, signed)
            for c in (1, 3, 4):
                got = tt.coefficients(x[:, :c], kind, use_mct, precision,
                                      signed)
                want = (ref[:, :c] if not use_mct or c >= 3 else
                        _jax_head(batch[:, :c], kind, use_mct, precision,
                                  signed))
                _equal(got, np.ascontiguousarray(want))
            coef = _tail_input(ref, kind, seed)
            want32, want_narrow = _jax_tail(coef, kind, use_mct, precision,
                                            signed)
            for c in (1, 3, 4):
                xt = torch.from_numpy(coef[:, :c].copy())
                for narrow, want in ((False, want32), (True, want_narrow)):
                    if c < 3 and use_mct:
                        want = _jax_tail(coef[:, :c], kind, True, precision,
                                         signed)[int(narrow)]
                    got = tt.samples(xt, kind, use_mct, precision, signed,
                                     narrow=narrow)
                    _equal(got, np.ascontiguousarray(want[:, :c]))


def test_cpu_tensors_never_launch_the_kernels():
    mct_cuda.reset_counts()
    batch = _samples(np.uint16, 1)
    x = tt.upload(batch, CPU)
    assert x.dtype == torch.uint16           # shipped narrow, as on the card
    coef = tt.coefficients(x, dwt.REV53, True, 16, False)
    assert torch.equal(coef, tt.coefficients_plain(x, dwt.REV53, True, 16,
                                                   False))
    out = tt.samples(coef, dwt.REV53, True, 16, False)
    assert np.array_equal(out.numpy().view(np.uint16), batch)
    img = (batch[0].transpose(1, 2, 0)[..., :3] >> 8).astype(np.uint8)
    for lossless in (True, False):
        data = tp.encode(img, tp.Options(lossless=lossless), device="cpu")
        tp.decode(data, device="cpu")
    assert mct_cuda.LAUNCHES == {"mct_forward": 0, "mct_inverse": 0}
    # the wrappers take a card's tensor only: no plain route inside them
    with pytest.raises(ValueError):
        mct_cuda.mct_forward(x, dwt.REV53, True, 16, False)
    with pytest.raises(ValueError):
        mct_cuda.mct_inverse(coef, dwt.REV53, True, 16, False)
    assert mct_cuda.LAUNCHES == {"mct_forward": 0, "mct_inverse": 0}


def test_cuda_without_a_card_still_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = _samples(np.uint8, 2)[0, :3].transpose(1, 2, 0).copy()
    with pytest.raises(RuntimeError):
        tp.encode(img, tp.Options(lossless=True), device="cuda")
    with pytest.raises(RuntimeError):
        tp.encode_batch([img], tp.Options(lossless=True), device="cuda")
    data = tp.encode(img, tp.Options(lossless=True), device="cpu")
    with pytest.raises(RuntimeError):
        tp.decode(data, device="cuda")
