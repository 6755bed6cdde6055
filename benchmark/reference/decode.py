"""The reference decode of the benchmark's lossless codestreams: the
plain reader (codestream.py), the HT cleanup decoder (ht_block.py) and
the inverse transforms (transform.py).  Imports nothing of the program."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import codestream, ht_block, transform


def block_values(blk: codestream.Block, mb: int) -> np.ndarray:
    """A block's coefficients (5/3) or indices (9/7): the cleanup pass's
    magnitudes at bit-plane P - 1, with P = Mb - zero bit-planes (T.814
    7.1)."""
    if blk.passes == 0:
        return np.zeros((blk.h, blk.w), np.int64)
    p = mb - blk.zero_bitplanes
    if p < 1:
        raise ValueError(f"{blk.zero_bitplanes} zero bit-planes of {mb}")
    v = ht_block.decode_cleanup(blk.data, blk.w, blk.h, p)
    return v.astype(np.int64) << (p - 1)


def mb_of(cfg: Dict, comp: int, res: int, band: str) -> int:
    """Mb = guard bits + eps_b - 1 (E-2), from the configuration's steps."""
    levels = cfg["codec"]["num_resolutions"] - 1
    eps = transform.steps(cfg, comp)[
        transform.band_order(levels).index((res, band))][0]
    guard = 3 if cfg["codec"]["high_throughput"] else 2
    return guard + eps - 1


def pyramids(blocks: List[codestream.Block], cfg: Dict
             ) -> List[transform.Pyramid]:
    """Each component's band values [1, h, w] from its code-blocks."""
    levels = cfg["codec"]["num_resolutions"] - 1
    sizes = codestream.band_sizes(cfg["columns"], cfg["rows"], levels)
    out = [{k: np.zeros((h, w), np.int64) for k, (w, h) in sizes.items()}
           for _ in range(cfg["samples_per_pixel"])]
    for blk in blocks:
        out[blk.comp][(blk.res, blk.band)][
            blk.y0:blk.y0 + blk.h, blk.x0:blk.x0 + blk.w] = block_values(
                blk, mb_of(cfg, blk.comp, blk.res, blk.band))
    return [{k: torch.from_numpy(v)[None] for k, v in p.items()} for p in out]


def decode(data: bytes, cfg: Dict, dtype: Optional[torch.dtype] = None
           ) -> np.ndarray:
    """The frame a lossless codestream holds, [H, W] or [H, W, C]."""
    _main, blocks = codestream.read(data)
    return transform.inverse(pyramids(blocks, cfg), cfg, dtype)[0]
