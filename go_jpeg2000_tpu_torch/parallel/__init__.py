"""The tile-sharded pipeline (BASELINE config 4): encode and decode of a
multi-tile image over a (dp, sp) grid of torch.distributed ranks, or one
process.

    encode_sharded(image, opts=None, grid=None, device="cuda") -> bytes
    decode_sharded(data, config=None, grid=None, device="cuda") -> ndarray
    make_grid(group=None, dp=None, sp=None) -> Grid
"""
from .mesh import Grid, make_grid
from .sharded import decode_sharded, encode_sharded

__all__ = ["encode_sharded", "decode_sharded", "make_grid", "Grid"]
