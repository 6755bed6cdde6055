"""The reference's work on single frames, spread over worker processes.

The plain reference is Python and NumPy, about a second a 512 x 512
frame for the HT block decoder, so the checks and the controls hand it
out frame by frame to up to WORKERS processes (spawned, one torch thread
each; they import the reference and nothing of the program) once the
window has closed, and wait for every one to end.  Small jobs, as in the
CPU tests, run in the calling process.
"""
from __future__ import annotations

import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Sequence

import numpy as np

WORKERS = 8
INLINE_PIXELS = 1 << 21


def _init_worker() -> None:
    import torch
    torch.set_num_threads(1)


def pmap(fn: Callable, jobs: Sequence, pixels: int) -> List:
    """[fn(job) for job in jobs], in worker processes when the jobs hold
    `pixels` or more."""
    n = min(WORKERS, len(os.sched_getaffinity(0)), len(jobs))
    if pixels < INLINE_PIXELS or n < 2:
        return [fn(j) for j in jobs]
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
            "spawn"), initializer=_init_worker) as ex:
        return list(ex.map(fn, jobs))


def encoded_frame(job) -> Dict:
    """The numbers of one frame's codestream: whether it parses, which
    header fields differ from those the configuration states, and, where
    asked, how many of its code-blocks' values differ from the reference
    transform's (and by how much at most), and how many of its blocks'
    bytes differ from the reference HT coder's on those values.

    job: (codestream, frame [H, W(, C)], cfg, wanted header, values?,
    segments?)"""
    from .operation import header_gaps
    from .reference import codestream as ref_cs
    from .reference import decode as ref_dec
    from .reference import ht_block
    from .reference import transform as ref_tf
    data, frame, cfg, want, values, segments = job
    out = {"unparsed": None, "header": [], "values": 0, "gap": 0,
           "total": 0, "segments": 0}
    try:
        main, blocks = ref_cs.read(data)
        out["header"] = header_gaps(main, want)
        if out["header"] or not values:
            return out
        ref = ref_tf.forward(frame[None], cfg)
        for blk in blocks:
            got = ref_dec.block_values(
                blk, ref_dec.mb_of(cfg, blk.comp, blk.res, blk.band))
            exp = ref[blk.comp][(blk.res, blk.band)][
                0, blk.y0:blk.y0 + blk.h, blk.x0:blk.x0 + blk.w].numpy()
            out["values"] += int((got != exp).sum())
            out["gap"] = max(out["gap"], int(np.abs(got - exp).max()))
            out["total"] += got.size
            if segments:
                coded = ht_block.encode_cleanup(got)[0] if got.any() else b""
                out["segments"] += coded != blk.data
    except (ValueError, IndexError, struct.error) as exc:
        out["unparsed"] = str(exc)[:200] or type(exc).__name__
    return out


def control_codestream(job) -> bytes:
    """The reference's codestream of one frame with its transform in a
    lower precision: (frame, cfg, wanted header, torch dtype name)."""
    import torch

    from .reference import transform as ref_tf
    from .reference import write
    frame, cfg, want, dtype = job
    pyrs = ref_tf.forward(frame[None], cfg, getattr(torch, dtype))
    try:
        return write.codestream_of(
            want, [{k: v[0].numpy() for k, v in p.items()} for p in pyrs])
    except ValueError:
        return b""          # values the header cannot hold: no codestream


def control_decoded(job) -> np.ndarray:
    """The reference decode of one codestream with its inverse transform
    in a lower precision: (codestream, cfg, torch dtype name)."""
    import torch

    from .reference import decode as ref_dec
    data, cfg, dtype = job
    return ref_dec.decode(data, cfg, getattr(torch, dtype))
