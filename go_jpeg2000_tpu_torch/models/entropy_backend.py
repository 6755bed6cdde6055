"""Entropy backend dispatch: the native (C++) HT and EBCOT batch coders,
or the Python oracles.

Port of go_jpeg2000_tpu/models/entropy_backend.py.  Backends "auto",
"native", "device" and "hybrid" code blocks with the native library and
raise where it is missing (the port never falls back on its own);
backend "python" codes them with the port's copies of the JAX package's
Python coders (ops/ht.py, ops/t1.py), HT refinement passes included,
which give the native coder's bytes.  Decoding is always native.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..native import loader
from ..ops import ht, t1
from ..utils import markers as mk


def require_native() -> None:
    """Raise unless the native library is built and loaded."""
    if not loader.available():
        raise RuntimeError("the native entropy library (j2k_native.cpp) "
                           "could not be built or loaded")


def _energy(coeffs) -> float:
    return float((np.abs(coeffs).astype(np.float64) ** 2).sum())


def _encode_ht(job, refinement: bool = False,
               require_exact: bool = True) -> t1.T1EncodeResult:
    """One HT block through the Python coder: the refined 3-pass set where
    asked and usable, else cleanup only, signalled as one bitplane."""
    coeffs = job[0]
    if refinement:
        res = _encode_ht_refined(coeffs, require_exact)
        if res is not None:
            return res
    seg, numbps, _u_max = ht.encode_cleanup(coeffs)
    if numbps == 0:
        return t1.T1EncodeResult(b"", 0, [], [])
    p = t1.PassInfo(2, 0, len(seg), _energy(coeffs), True)
    return t1.T1EncodeResult(seg, 1, [p], [len(seg)])


def _encode_ht_refined(coeffs, require_exact: bool
                       ) -> Optional[t1.T1EncodeResult]:
    """The 3-pass HT set (cleanup at shift 1, SigProp and MagRef at bit 0),
    three truncation points for PCRD; None where the block takes a
    cleanup-only set (nothing to refine, or the set would lose isolated odd
    units and exactness is asked for)."""
    c = np.asarray(coeffs, dtype=np.int64)
    mags = np.abs(c)
    if mags.size == 0 or int(mags.max()) <= 1:
        return None
    halved_sig = (mags >> 1) != 0
    _n_m, n_new, n_lost = ht.sigprop_stats(c, halved_sig.astype(np.uint8))
    if n_lost and require_exact:
        return None
    cup, spp, mrp, numbps, _u_max = ht.encode_refined(c)
    if numbps < 2:
        return None
    data = cup + spp + mrp
    odd = (mags & 1).astype(np.float64)
    d_total = float((mags.astype(np.float64) ** 2).sum())
    # residual energy after each pass (the decoder's reconstruction)
    resid_cup = (float((odd[halved_sig] ** 2).sum())
                 + float((mags[~halved_sig].astype(np.float64) ** 2).sum()))
    resid_spp = resid_cup - float(n_new)
    resid_mrp = float(n_lost)
    passes = [
        t1.PassInfo(2, 1, len(cup), d_total - resid_cup, True),
        t1.PassInfo(0, 0, len(cup) + len(spp), d_total - resid_spp, False),
        t1.PassInfo(1, 0, len(data), d_total - resid_mrp, True),
    ]
    return t1.T1EncodeResult(data, numbps, passes,
                             [len(cup), len(spp) + len(mrp)])


def encode_blocks_batch(jobs: Sequence[Tuple], backend: str = "auto",
                        ht_refinement: bool = False,
                        ht_require_exact: bool = True,
                        exact_rates: bool = True
                        ) -> List[t1.T1EncodeResult]:
    """jobs: (coeffs int32 [h,w], band_name, cb_style, mb) per block, all HT
    or all EBCOT code-blocks.  exact_rates=False lets the native EBCOT
    coder report monotone upper bounds of the pass rates instead of the
    exact D.4.1 truncation lengths (nothing reads them with one layer and
    no budget); the Python EBCOT coder always computes them."""
    ht_jobs = bool(jobs) and bool(jobs[0][2] & mk.CBSTYLE_HT)
    if backend == "python":
        if ht_jobs:
            return [_encode_ht(j, ht_refinement, ht_require_exact)
                    for j in jobs]
        return [t1.encode_block(j[0], j[1], cb_style=j[2]) for j in jobs]
    require_native()
    if jobs and not ht_jobs:
        sty_extra = 0 if exact_rates else loader.STY_FAST_RATES
        return loader.encode_blocks([(j[0], j[1], j[2] | sty_extra)
                                     for j in jobs])
    out = []
    if not ht_refinement:
        res = loader.ht_encode_blocks([j[0] for j in jobs])
        for (seg, numbps, _umax), j in zip(res, jobs):
            if numbps == 0:
                out.append(t1.T1EncodeResult(b"", 0, [], []))
                continue
            p = t1.PassInfo(2, 0, len(seg), _energy(j[0]), True)
            out.append(t1.T1EncodeResult(seg, 1, [p], [len(seg)]))
        return out
    res = loader.ht_encode_refined_blocks(
        [j[0] for j in jobs], require_exact=ht_require_exact)
    for (data, numbps, lc, lspp, lref, refined, dist), j in zip(res, jobs):
        if numbps == 0:
            out.append(t1.T1EncodeResult(b"", 0, [], []))
            continue
        if not refined:
            p = t1.PassInfo(2, 0, len(data), _energy(j[0]), True)
            out.append(t1.T1EncodeResult(data, 1, [p], [len(data)]))
            continue
        d_total, resid_cup, resid_spp, resid_mrp = dist
        passes = [
            t1.PassInfo(2, 1, lc, d_total - resid_cup, True),
            t1.PassInfo(0, 0, lc + lspp, d_total - resid_spp, False),
            t1.PassInfo(1, 0, lc + lref, d_total - resid_mrp, True),
        ]
        out.append(t1.T1EncodeResult(data, numbps, passes, [lc, lref]))
    return out


def decode_blocks_batch(jobs: Sequence[Tuple]) -> List[np.ndarray]:
    """jobs: (data, w, h, numbps, num_passes, band, cb_style,
    segment_lengths) per block, all HT or all EBCOT code-blocks, threaded
    across blocks.  HT: the native cleanup decoder, or, where a block
    carries refinement passes, the native refined decoder for all of them
    (cleanup and refinement segment lengths from segment_lengths).  EBCOT:
    the native T1 decoder."""
    require_native()
    if not (jobs and jobs[0][6] & mk.CBSTYLE_HT):
        return loader.decode_blocks(jobs)
    if not any(j[4] > 1 for j in jobs):
        return loader.ht_decode_blocks(
            [(bytes(j[0]), j[1], j[2], j[3]) for j in jobs])
    njobs = []
    for j in jobs:
        d = bytes(j[0])
        segs = list(j[7] or [])
        lc = min(segs[0] if segs else len(d), len(d))
        lr = min(segs[1] if len(segs) > 1 else 0, len(d) - lc)
        njobs.append((d, j[1], j[2], j[3], j[4], lc, lr))
    return loader.ht_decode_refined_blocks(njobs)
