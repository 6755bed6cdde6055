"""Hand-written CUDA kernels of the device HT decode (csrc/ht_dec.cu).

The port's counterpart of the JAX package's device HT decode program:

  magsgn_decode_blocks -> ht_magsgn_decode, replaces
                          ht_tpu_decode.magsgn_decode_blocks
  blocks_to_pyramid    -> ht_blocks_to_pyramid, replaces
                          ht_tpu_decode.blocks_to_pyramid_dev

A CPU tensor goes to the plain torch version (ops/ht_dec.py).  A CUDA
tensor goes to the kernel, or the call raises: there is no fallback, and a
failed build or launch is an error.  The library is built by
ops/cuda_build.py on first use, with the port's other CUDA sources.

Counts: LAUNCHES[name] goes up by one each time a wrapper launches its
kernel, and only there.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from . import cuda_build, ht_dec
from .ht_enc_cuda import _check

LAUNCHES: Dict[str, int] = {"ht_magsgn_decode": 0, "ht_blocks_to_pyramid": 0}
# int64 fields per band in ht_blocks_to_pyramid's table (checked at load)
BAND_FIELDS = 11
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
        if (lib.ht_dec_band_fields() != BAND_FIELDS
                or lib.ht_dec_magsgn_threads() != MS_THREADS
                or lib.ht_dec_quads_per_thread() != QUADS_PER_THREAD
                or lib.ht_dec_stage_words() != STAGE_WORDS):
            raise RuntimeError("csrc/ht_dec.cu and ops/ht_dec_cuda.py "
                               "disagree on the band table or the MagSgn "
                               "CTA")
        p, i = ctypes.c_void_p, ctypes.c_int
        sigs = {"ht_magsgn_decode": [p, p, ctypes.c_longlong, p, i, i, i, i,
                                     i, p],
                "ht_blocks_to_pyramid": [p, i, i, i, i, i, i, i, p, p]}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args + [p]          # and the stream
        _lib = lib
        return _lib


def _launch(name: str, device: torch.device, *args) -> None:
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
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


def _layout(plan, n: int, n_comps: int, nl: int, dequant: bool,
            dev: torch.device):
    """The leaves' places in one flat buffer and the kernel's band table on
    `dev`, cached per plan and batch: (table, buffer length, [(pyramid
    level, band, shape, strides, offset)]).  A band's first table field is
    its leaf's element offset in the buffer."""
    key = (id(plan), n, n_comps, nl, dequant, str(dev))
    if key in _LAYOUTS:
        return _LAYOUTS[key]
    leaves: Dict = {}                 # (level, band) -> (offset, shape)
    total = 0
    table = np.zeros((len(plan.band_specs), BAND_FIELDS), np.int64)
    comps: Dict = {}
    slot = 0
    for bi, (c, lev, band, gy, gx, eh, ew, bh, bw, oy, ox) in \
            enumerate(plan.band_specs):
        where = (ht_dec.leaf_level(lev, band, nl), band)
        if where not in leaves:
            leaves[where] = (total, (n, n_comps, bh, bw))
            total += n * n_comps * bh * bw
        off, shape = leaves[where]
        if shape[2:] != (bh, bw) or not 0 <= c < n_comps:
            raise ValueError(f"ht_blocks_to_pyramid: band "
                             f"{plan.band_specs[bi]} does not fit its leaf "
                             f"{shape}")
        comps.setdefault(where, set()).add(c)
        delta = np.float32(plan.deltas[bi] if dequant else 1.0)
        table[bi] = (off, c, bh, bw, gx, eh, ew, oy, ox, slot,
                     int(delta.view(np.int32)))
        slot += gy * gx
    if slot != plan.nb or any(len(s) != n_comps for s in comps.values()):
        raise ValueError(f"ht_blocks_to_pyramid: the plan's bands do not "
                         f"cover {plan.nb} slots and {n_comps} components")
    _LAYOUTS[key] = (torch.from_numpy(table).to(dev), total, [
        (lv, band, shape, (n_comps * sh[0] * sh[1], sh[0] * sh[1], sh[1], 1),
         off) for (lv, band), (off, shape) in leaves.items()
        for sh in [shape[2:]]])
    return _LAYOUTS[key]


def blocks_to_pyramid(coeffs: torch.Tensor, plan, n: int, n_comps: int,
                      nl: int, dequant: bool = False
                      ) -> List[Dict[str, torch.Tensor]]:
    """Block slots int32 [n*nb, cbh, cbw] -> stacked pyramid leaves
    [n, C, bh, bw], int32, or float32 midpoint-dequantized with
    plan.deltas (dequant=True); ht_dec.blocks_to_pyramid.  On the card the
    leaves are contiguous views of one buffer that the kernel fills."""
    if coeffs.device.type == "cpu":
        return ht_dec.blocks_to_pyramid(coeffs, plan, n, n_comps, nl,
                                        dequant)
    name = "ht_blocks_to_pyramid"
    dev = coeffs.device
    _check(coeffs, name, torch.int32, 3, dev)
    if (tuple(coeffs.shape) != (n * plan.nb, plan.cbh, plan.cbw)
            or n > 65535):
        raise ValueError(f"{name}: slots {tuple(coeffs.shape)} for {n} "
                         f"frames of {plan.nb} {plan.cbh}x{plan.cbw} blocks")
    table, total, leaves = _layout(plan, n, n_comps, nl, dequant, dev)
    buf = torch.empty(total, dtype=torch.float32 if dequant else torch.int32,
                      device=dev)
    if n:
        _launch(name, dev, table.data_ptr(), table.shape[0], n_comps, n,
                plan.nb, plan.cbh, plan.cbw, int(dequant), coeffs.data_ptr(),
                buf.data_ptr())
    stacked: List[Dict[str, torch.Tensor]] = [dict()
                                              for _ in range(max(1, nl))]
    for lv, band, shape, strides, off in leaves:
        stacked[lv][band] = buf.as_strided(shape, strides, off)
    return stacked
