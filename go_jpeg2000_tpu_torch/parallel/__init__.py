"""The tile-sharded pipeline (BASELINE config 4): encode and decode of a
multi-tile image over a (dp, sp) grid of torch.distributed ranks, or one
process; and the multi-host decomposition (BASELINE config 5): one OS
process a host, each owning its tiles, a pipe reduction server between
them.

    encode_sharded(image, opts=None, grid=None, device="cuda") -> bytes
    decode_sharded(data, config=None, grid=None, device="cuda") -> ndarray
    make_grid(group=None, dp=None, sp=None) -> Grid
    encode_multihost(image, opts=None, n_hosts=2, device="cuda") -> bytes
    decode_multihost(data, config=None, n_hosts=2, device="cuda") -> ndarray
"""
from .mesh import Grid, make_grid
from .multihost import decode_multihost, encode_multihost
from .sharded import decode_sharded, encode_sharded

__all__ = ["encode_sharded", "decode_sharded", "make_grid", "Grid",
           "encode_multihost", "decode_multihost"]
