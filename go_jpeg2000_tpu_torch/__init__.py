"""go_jpeg2000_tpu_torch — the PyTorch/CUDA port of go_jpeg2000_tpu.

The JAX package (go_jpeg2000_tpu) stays as the reference; this package mirrors
its module names and is held to it byte for byte.  It imports torch and
numpy, never jax.

Public API (the JAX package's, with an explicit device):

    encode(image, opts=None, device="cuda") -> bytes
    decode(data, config=None, device="cuda") -> np.ndarray
    decode_metadata(data) -> Metadata
    encode_batch(images, opts=None, device="cuda") -> List[bytes]
    decode_batch(streams, config=None, device="cuda") -> List[np.ndarray]

`encode` and `decode` take one image: any number of components, unsigned
or signed samples of 1 to 29 bits lossless (31 lossy), J2K or JP2, one
tile or a tile grid with tile and image offsets, HTJ2K or Part-1 (EBCOT,
any code-block style), lossless 5/3 or lossy 9/7, with any number of
quality layers, a compression_ratio budget, SOP, EPH, PLT, PPT, PPM and
TLM markers and POC progression changes; backend "python" codes blocks
with the Python coders.  `decode` also takes region, reduced and layered
decodes and the JP2 colour spaces.  Per tile the device
runs DC shift, RCT or ICT, the DWT levels and the 9/7 quantization (and
their inverses on decode); the host runs the native block coder, PCRD and
the Python Tier-2.  The batch API codes frames of one shape together:
HTJ2K encode runs DC shift, RCT or ICT, the DWT, deadzone quantization
and the HT cleanup coding on the device, and Tier-2 on the host; decode
runs Tier-2 and the HT cleanup's MEL/VLC control phase on the host, and
the MagSgn decode, block assembly, dequantization, inverse DWT and
inverse colour transform on the device.  Part-1 encode
(high_throughput=False) runs DC shift, RCT, the DWT, the EBCOT Tier-1
decisions and, by default, the MQ coder on the device (backend "device";
"hybrid" MQ-codes the decision streams on the host, "native" codes blocks
on the host), and Tier-2 on the host; decode runs Tier-2 and the EBCOT
block decoder on the host and block assembly, the inverse DWT and inverse
RCT on the device.  What the batch paths do not take they hand to
`encode` and `decode` one image at a time.  On an NVIDIA Hopper card the
DWT levels, the HT stages and the EBCOT stages run in hand-written CUDA
kernels (csrc/*.cu), the elementwise colour and level steps as torch ops;
the host work runs in the native C++ coder (native/j2k_native.cpp, the
port's copy of the JAX package's).  The tile-sharded pipeline (BASELINE
config 4: multi-tile images over a (dp, sp) grid of torch.distributed
ranks, or one process) is in go_jpeg2000_tpu_torch.parallel:
encode_sharded, decode_sharded, make_grid; so is the multi-host
decomposition (BASELINE config 5: one process a host, each owning its
tiles): encode_multihost, decode_multihost.  go_jpeg2000_tpu_torch.entry
holds entry and dryrun_multichip.  Tensors carry an explicit
device: "cuda" without a card raises; tests pass device="cpu".  What the
JAX package refuses the port refuses too, with ValueError.
"""

from .options import (ColorSpace, ComponentMetadata, Config, Format,
                      Metadata, Options, Profile, ProgressionOrder,
                      config_from_reference, default_options,
                      options_from_reference)
from .models.encoder import encode, encode_batch
from .models.decoder import DecodeError, decode, decode_batch, decode_metadata
from .utils.metrics import counters

__version__ = "0.1.0"

__all__ = [
    "encode", "decode", "decode_metadata", "encode_batch", "decode_batch",
    "DecodeError", "Options", "Config", "Metadata", "ComponentMetadata",
    "Format", "Profile", "ProgressionOrder", "ColorSpace", "default_options",
    "counters", "options_from_reference", "config_from_reference",
]
