"""The port's operators: plain torch versions and the CUDA kernels' wrappers.

Every wrapper of a CUDA kernel adds one to its module's LAUNCHES where it
launches the kernel; kernel_launches reads every module's counts and
reset_launches sets them all to 0.
"""
from __future__ import annotations

from typing import Dict

from . import (band_stats, dwt_cuda, ebcot_cuda, ht_dec_cuda, ht_enc_cuda,
               mct_cuda)

_COUNTED = (dwt_cuda, ht_enc_cuda, ht_dec_cuda, ebcot_cuda, band_stats,
            mct_cuda)


def kernel_launches() -> Dict[str, int]:
    """This process's launch count of every CUDA kernel of the port."""
    out: Dict[str, int] = {}
    for mod in _COUNTED:
        out.update(mod.LAUNCHES)
    return out


def reset_launches() -> None:
    """Set every kernel's launch count (and dwt_cuda.PLAIN_LEVELS) to 0."""
    for mod in _COUNTED:
        mod.reset_counts()
