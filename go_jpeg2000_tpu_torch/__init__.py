"""go_jpeg2000_tpu_torch — the PyTorch/CUDA port of go_jpeg2000_tpu.

The JAX package (go_jpeg2000_tpu) stays as the reference; this package mirrors
its module names and is held to it byte for byte.  It imports torch and
numpy, never jax.

The ported slices run the HTJ2K batch paths, lossless 5/3 and lossy 9/7:

    encode_batch(images, opts=None, device="cuda") -> List[bytes]
    decode_batch(streams, config=None, device="cuda") -> List[np.ndarray]

with DC shift, RCT and the 5/3 DWT, or ICT, the 9/7 DWT and deadzone
quantization, on the device (hand-written CUDA level kernels on an NVIDIA
Hopper card, csrc/dwt53.cu and csrc/dwt97.cu) and HT block coding plus
Tier-2 on the host (the JAX package's native C++ coder, built from its one
source).  Tensors carry an explicit device: "cuda" without a card raises;
tests pass device="cpu".  Options outside the slice raise
NotImplementedError naming the ROADMAP item that brings them.
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
