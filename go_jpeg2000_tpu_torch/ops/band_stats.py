"""Band statistics of a wavelet pyramid: per leaf, the sum of squares and
the count of nonzero coefficients.

The statistics half of the JAX package's sharded transform step
(go_jpeg2000_tpu/parallel/sharded.py make_tile_transform_step, before its
psum).  `band_stats` takes every leaf of a pyramid at once: a CPU tensor
goes to the plain torch version (`band_stats_plain`), a CUDA tensor to the
hand-written kernel csrc/band_stats.cu (one launch for all leaves), or the
call raises.  The library is built by ops/cuda_build.py on first use.

Sums are float64 and counts int64 (the JAX package sums both in float32,
which is inexact past 2^24).  LAUNCHES["band_stats"] goes up by one each
time the kernel is launched, and only there.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import cuda_build

LAUNCHES: Dict[str, int] = {"band_stats": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_counts() -> None:
    LAUNCHES["band_stats"] = 0


def leaves_of(pyr: List[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
    """A pyramid's leaves in the JAX step's order: levels ascending, then
    HL, LH, HH and, at the top level, LL."""
    return [entry[k] for entry in pyr for k in ("HL", "LH", "HH", "LL")
            if k in entry]


def band_stats_plain(leaves: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squares float64 [L], nonzero count int64 [L])."""
    sums = torch.stack([leaf.to(torch.float64).square().sum()
                        for leaf in leaves])
    counts = torch.stack([(leaf != 0).sum() for leaf in leaves])
    return sums, counts.to(torch.int64)


def load() -> ctypes.CDLL:
    """Build (if needed) and bind csrc/band_stats.cu."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load("band_stats")
        p = ctypes.c_void_p
        lib.band_stats.restype = ctypes.c_int
        lib.band_stats.argtypes = [p, p, ctypes.c_int, ctypes.c_int, p, p, p]
        lib.band_stats_max_leaves.restype = ctypes.c_int
        _lib = lib
        return _lib


def band_stats(leaves: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squares float64 [L], nonzero count int64 [L]) of the leaves,
    all int32 or all float32, on one device."""
    leaves = list(leaves)
    dev = leaves[0].device
    if dev.type == "cpu":
        return band_stats_plain(leaves)
    name = "band_stats"
    dtype = leaves[0].dtype
    if dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{name}: int32 or float32 leaves, got {dtype}")
    lib = load()
    if len(leaves) > lib.band_stats_max_leaves():
        raise ValueError(f"{name}: {len(leaves)} leaves, at most "
                         f"{lib.band_stats_max_leaves()}")
    for leaf in leaves:
        if (leaf.device != dev or leaf.dtype != dtype
                or not leaf.is_contiguous()):
            raise ValueError(f"{name}: leaves must be contiguous {dtype} "
                             f"tensors on {dev}")
    ptrs = (ctypes.c_void_p * len(leaves))(*[leaf.data_ptr()
                                              for leaf in leaves])
    lens = (ctypes.c_longlong * len(leaves))(*[leaf.numel()
                                                for leaf in leaves])
    sums = torch.empty(len(leaves), dtype=torch.float64, device=dev)
    counts = torch.empty(len(leaves), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.band_stats(ptrs, lens, len(leaves),
                            int(dtype == torch.float32), sums.data_ptr(),
                            counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return sums, counts
