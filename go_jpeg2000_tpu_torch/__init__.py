"""go_jpeg2000_tpu_torch — the PyTorch/CUDA port of go_jpeg2000_tpu.

The JAX package (go_jpeg2000_tpu) stays as the reference; this package mirrors
its module names and is held to it byte for byte.  It imports torch and
numpy, never jax.

The ported slices run the HTJ2K batch paths, lossless 5/3 and lossy 9/7,
and the Part-1 (EBCOT) lossless 5/3 batch path:

    encode_batch(images, opts=None, device="cuda") -> List[bytes]
    decode_batch(streams, config=None, device="cuda") -> List[np.ndarray]

HTJ2K encode runs DC shift, RCT or ICT, the DWT, deadzone quantization and
the HT cleanup coding on the device, and Tier-2 on the host; decode runs
Tier-2 and the HT cleanup's MEL/VLC control phase on the host, and the
MagSgn decode, block assembly, dequantization, inverse DWT and inverse
colour transform on the device.  Part-1 encode (high_throughput=False)
runs DC shift, RCT, the DWT, the EBCOT Tier-1 decisions and, by default,
the MQ coder on the device (backend "device"; "hybrid" MQ-codes the
decision streams on the host, "native" codes blocks on the host), and
Tier-2 on the host; decode runs Tier-2 and the EBCOT block decoder on the
host and block assembly, the inverse DWT and inverse RCT on the device.
On an NVIDIA Hopper card the DWT levels, the HT stages and the EBCOT
stages run in hand-written CUDA kernels (csrc/*.cu), the elementwise
colour and level steps as torch ops; the host work runs in the native C++
coder (native/j2k_native.cpp, the port's copy of the JAX package's).
The tile-sharded pipeline (BASELINE config 4: multi-tile images over a
(dp, sp) grid of torch.distributed ranks, or one process) is in
go_jpeg2000_tpu_torch.parallel: encode_sharded, decode_sharded, make_grid.
Tensors carry an explicit device: "cuda" without a card raises; tests pass
device="cpu".  Options outside the slices raise NotImplementedError naming
the ROADMAP item that brings them.
"""

from .options import (Config, Format, Options, config_from_reference,
                      default_options, options_from_reference)
from .models.encoder import encode_batch
from .models.decoder import DecodeError, decode_batch
from .utils.metrics import counters

__version__ = "0.1.0"

__all__ = [
    "encode_batch", "decode_batch", "DecodeError",
    "Options", "Config", "Format", "default_options", "counters",
    "options_from_reference", "config_from_reference",
]
