"""What tests/test_torch_codec.py and test_torch_codec_paths.py share: the
JAX package's options of the batch slices, the frames, and the checks of
which branch a batch took."""
import numpy as np

import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.options import Format, Options

OPTS = Options(format=Format.J2K, lossless=True, high_throughput=True,
               num_resolutions=6)
# the JAX bench's lossy HT leg (bench.py htlossy97_512)
LOSSY = Options(format=Format.J2K, lossless=False, quality=85,
                num_resolutions=6, high_throughput=True)


def frames(n, shape, seed, dtype=np.uint8):
    """Smooth noise, as bench.py's natural_image makes it."""
    rng = np.random.RandomState(seed)
    hi = np.iinfo(dtype).max + 1
    out = []
    for _ in range(n):
        a = rng.randint(0, hi, size=shape).astype(np.float64)
        for ax in (0, 1):
            a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
        out.append(a.astype(dtype))
    return out


def psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(peak ** 2 / mse)


def assert_fused():
    """The last encode ran the fused device HT encode and no host entropy."""
    snap = tp.counters.snapshot()
    assert snap.get("enc.fused_chunks", 0) > 0
    assert snap.get("enc.host_entropy_frames", 0) == 0


def assert_device_decode(n_chunks=1):
    """The last decode ran the device HT branch and no host HT decode."""
    snap = tp.counters.snapshot()
    assert snap.get("dec.device_ht_chunks", 0) == n_chunks
    assert snap.get("dec.host_ht_frames", 0) == 0
