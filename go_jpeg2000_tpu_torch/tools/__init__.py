"""The port's profiling and scaling tools, one module per tool of the JAX
package's `tools/` directory, under the same name:

- profile_stages: the encode and decode entry points in their stages
  (host ms, device ms from CUDA events, bytes copied, the unattributed
  remainder, the device idle share as a bracket), per path (HT 5/3 and
  9/7 batches, Part-1 paths A, B and C, the single-image API, config 2,
  config 4), at 1 to N threads of the native coder, on other checkouts;
- profile_kernel_stages: the kernels of one fused HT encode program and
  one HT decode program, each between a CUDA event pair, with the glue;
- bench_config4_scale: config 4 through encode_sharded/decode_sharded at
  several sizes, on one process or a gloo grid of ranks;
- multihost_scaling: encode_multihost at 1, 2 and 4 hosts;
- benchmark_compare: the port against OpenJPEG (Pillow), 64 to 512 px.

Each runs as `python -m go_jpeg2000_tpu_torch.tools.<name> [--device
cpu]`; the default device is "cuda", which raises without a card.  They
import torch, numpy and the port, never jax; `_clock` holds what they
share.
"""
