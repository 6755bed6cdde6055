"""Hand-written CUDA kernels of the device HT decode (csrc/ht_dec.cu).

The port's counterpart of the JAX package's device HT decode program:

  magsgn_decode_blocks -> ht_magsgn_decode, replaces
                          ht_tpu_decode.magsgn_decode_blocks
  blocks_to_pyramid    -> ht_blocks_to_pyramid, replaces
                          ht_tpu_decode.blocks_to_pyramid_dev (its leaf-row
                          descriptors, ops/block_layout.py, and the leaves'
                          views are cached per plan and batch)

A CPU tensor goes to the plain torch version (ops/ht_dec.py).  A CUDA
tensor goes to the kernel, or the call raises: there is no fallback, and a
failed build or launch is an error.  The library is built by
ops/cuda_build.py on first use, with the port's other CUDA sources.

Counts: LAUNCHES[name] goes up by one each time a wrapper launches its
kernel, and only there.  Launches go through ht_enc_cuda.run; neither
wrapper waits for the card after a plan's first call.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import torch

from . import block_layout, cuda_build, ht_dec
from .ht_enc_cuda import _check, run

LAUNCHES: Dict[str, int] = {"ht_magsgn_decode": 0, "ht_blocks_to_pyramid": 0}
# ht_magsgn_decode's CTA: at most MS_THREADS threads of QUADS_PER_THREAD
# consecutive quads, and the MagSgn words it stages in shared memory
MS_THREADS = 256
QUADS_PER_THREAD = 4
STAGE_WORDS = 4096

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load() -> ctypes.CDLL:
    """Build (if needed) and bind csrc/ht_dec.cu."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load("ht_dec")
        if (lib.ht_dec_layout_fields() != block_layout.LAYOUT_FIELDS
                or lib.ht_dec_magsgn_threads() != MS_THREADS
                or lib.ht_dec_quads_per_thread() != QUADS_PER_THREAD
                or lib.ht_dec_stage_words() != STAGE_WORDS):
            raise RuntimeError("csrc/ht_dec.cu and ops/ht_dec_cuda.py "
                               "disagree on the slot layout or the MagSgn "
                               "CTA")
        p, i = ctypes.c_void_p, ctypes.c_int
        sigs = {"ht_magsgn_decode": [p, p, ctypes.c_longlong, p, i, i, i, i,
                                     i, p],
                "ht_blocks_to_pyramid": [p, p, i, i, i, i, i, i, p, p]}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args + [p]          # and the stream
        _lib = lib
        return _lib


def _launch(name: str, device: torch.device, *args) -> None:
    run(load(), name, device, *args)
    LAUNCHES[name] += 1


def magsgn_decode_blocks(qinfo: torch.Tensor, pool: torch.Tensor,
                         woff: torch.Tensor, cbh: int, cbw: int
                         ) -> torch.Tensor:
    """Quad words int32 [NB, QH, QW] (uint32 patterns), MagSgn pool int32
    [P] and block word offsets int64 [NB] -> int32 coefficients
    [NB, cbh, cbw]; ht_dec.magsgn_decode_blocks."""
    if qinfo.device.type == "cpu":
        return ht_dec.magsgn_decode_blocks(qinfo, pool, woff, cbh, cbw)
    name = "ht_magsgn_decode"
    dev = qinfo.device
    _check(qinfo, name, torch.int32, 3, dev)
    _check(pool, name, torch.int32, 1, dev)
    _check(woff, name, torch.int64, 1, dev)
    nb, qh, qw = qinfo.shape
    if (woff.shape != (nb,) or pool.numel() == 0 or 2 * qh < cbh
            or 2 * qw < cbw or 4 * 255 * qh * qw >= 1 << 31):
        raise ValueError(f"{name}: quads {tuple(qinfo.shape)}, pool "
                         f"{tuple(pool.shape)}, offsets {tuple(woff.shape)} "
                         f"do not cover {cbh}x{cbw} blocks")
    out = torch.empty((nb, cbh, cbw), dtype=torch.int32, device=dev)
    if nb and cbh and cbw:
        _launch(name, dev, qinfo.data_ptr(), pool.data_ptr(), pool.numel(),
                woff.data_ptr(), nb, qh, qw, cbh, cbw, out.data_ptr())
    return out


_LAYOUTS: Dict = {}


def pyramid_layout(plan, n: int, n_comps: int, nl: int, dequant: bool,
                   dev: torch.device):
    """ht_blocks_to_pyramid's static half for a plan and batch, cached per
    (plan, n, components, levels, dequant, device): (leaf-row descriptors
    int32 [rows, LAYOUT_FIELDS] and the leaves' element offsets int64 [L],
    both on `dev`; the buffer's length; [(pyramid level, band, shape,
    strides, offset)] of the leaves' views, each leaf's start on a 16-byte
    boundary).  Raises ValueError for a plan the kernel cannot take."""
    def build():
        keys, shapes, rows = block_layout.row_descriptors(plan, n_comps, nl,
                                                          dequant)
        off, total = block_layout.leaf_offsets(shapes, n, n_comps)
        views = [(lv, band, (n, n_comps, bh, bw),
                  (n_comps * bh * bw, bh * bw, bw, 1), int(o))
                 for (lv, band), (bh, bw), o in zip(keys, shapes, off)]
        return (torch.from_numpy(rows).to(dev), torch.from_numpy(off).to(dev),
                total, views)
    return block_layout.plan_cache(_LAYOUTS, plan,
                                   (n, n_comps, nl, dequant, dev), build)


def blocks_to_pyramid(coeffs: torch.Tensor, plan, n: int, n_comps: int,
                      nl: int, dequant: bool = False
                      ) -> List[Dict[str, torch.Tensor]]:
    """Block slots int32 [n*nb, cbh, cbw] -> stacked pyramid leaves
    [n, C, bh, bw], int32, or float32 midpoint-dequantized with
    plan.deltas (dequant=True); ht_dec.blocks_to_pyramid.  On the card the
    leaves are contiguous views of one buffer that the kernel fills, and
    nothing is copied to or from the host after a plan's first call."""
    if coeffs.device.type == "cpu":
        return ht_dec.blocks_to_pyramid(coeffs, plan, n, n_comps, nl,
                                        dequant)
    name = "ht_blocks_to_pyramid"
    dev = coeffs.device
    _check(coeffs, name, torch.int32, 3, dev)
    if (coeffs.shape != (n * plan.nb, plan.cbh, plan.cbw)
            or coeffs.data_ptr() % 16):
        raise ValueError(f"{name}: slots {tuple(coeffs.shape)} for {n} "
                         f"frames of {plan.nb} {plan.cbh}x{plan.cbw} blocks, "
                         "16-byte aligned")
    rows, off, total, views = pyramid_layout(plan, n, n_comps, nl, dequant,
                                             dev)
    buf = torch.empty(total, dtype=torch.float32 if dequant else torch.int32,
                      device=dev)
    if n:
        _launch(name, dev, rows.data_ptr(), off.data_ptr(), rows.shape[0], n,
                plan.nb, plan.cbh, plan.cbw, int(dequant), coeffs.data_ptr(),
                buf.data_ptr())
    stacked: List[Dict[str, torch.Tensor]] = [dict()
                                              for _ in range(max(1, nl))]
    for lv, band, shape, strides, at in views:
        stacked[lv][band] = buf.as_strided(shape, strides, at)
    return stacked
