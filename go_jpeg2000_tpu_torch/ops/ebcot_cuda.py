"""Hand-written CUDA kernels of the device EBCOT encode (csrc/ebcot_enc.cu).

The port's counterpart of the JAX package's device EBCOT program:

  decision_slots -> ebcot_decision_slots, replaces ebcot_device.decision_slots
  compact_rows   -> ebcot_compact_rows, replaces mq_device.compact_rows then
                    pool_rows on the decision rows
  mq_encode      -> ebcot_mq_encode, replaces mq_device.mq_encode_scan and
                    the compact_rows(drop_first) of its staging rows
  pool_rows      -> ebcot_pool_rows, replaces mq_device.pool_rows on the MQ
                    segment rows

A CPU tensor goes to the plain torch version (ops/ebcot_device.py,
ops/mq_device.py).  A CUDA tensor goes to the kernel, or the call raises:
there is no fallback, and a failed build or launch is an error.  The
library is built by ops/cuda_build.py on first use, with the port's other
CUDA sources.

Layouts shared by the kernels and the plain versions: the decisions of all
blocks in one pool, block b's at off[b] (the exclusive scan of ndec); the
MQ segment rows in one buffer, block b's row at 3 * off[b] + 3 * b with
room for 3 * ndec[b] + 3 bytes (a decision commits at most 3 bytes, the
flush at most 3, the sentinel commit is not stored); the segments in one
pool at the exclusive scan of their lengths.

Counts: LAUNCHES[name] goes up by one each time a wrapper launches its
kernel, and only there.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda_build, ebcot_device, mq_device

LAUNCHES: Dict[str, int] = {"ebcot_decision_slots": 0,
                            "ebcot_compact_rows": 0, "ebcot_mq_encode": 0,
                            "ebcot_pool_rows": 0}
# the decision kernel's plane limit (magnitudes shifted by up to p + 2 bits
# in int32): plans have at most max_mn - 2 = 29 planes
MAX_PLANES = 29
# decision bytes the MQ kernel stages at a time (mq_device.stress_streams
# puts stream lengths around it)
MQ_CHUNK = 1024
# slot bytes a compaction CTA counts and compacts (a chunk of a row; the
# last chunk of a row may be shorter): at most the library's
# ebcot_compact_max_chunk
COMPACT_CHUNK = 8192
MAX_SMEM_BYTES = 232448
# the decision kernel's CTA (one per code-block and plane): threads, the
# columns a thread resolves in order per fixpoint sweep, and the columns
# whose slots it stages in shared memory at a time
DEC_THREADS = 128
RUN_COLS = 8
STAGE_COLS = 1024

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load() -> ctypes.CDLL:
    """Build (if needed) and bind csrc/ebcot_enc.cu."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load("ebcot_enc")
        lib.ebcot_decision_smem.restype = ctypes.c_longlong
        lib.ebcot_decision_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        if (lib.ebcot_slots_per_column() != ebcot_device.SLOTS_PER_COLUMN
                or lib.ebcot_max_planes() != MAX_PLANES
                or lib.ebcot_mq_chunk() != MQ_CHUNK
                or lib.ebcot_decision_threads() != DEC_THREADS
                or lib.ebcot_decision_run_cols() != RUN_COLS
                or lib.ebcot_decision_stage_cols() != STAGE_COLS
                or lib.ebcot_compact_max_chunk() < COMPACT_CHUNK
                or any(lib.ebcot_decision_smem(h, w) != decision_smem(h, w)
                       for h, w in ((64, 64), (4, 1024), (8, 3)))):
            raise RuntimeError("csrc/ebcot_enc.cu and ops/ebcot_cuda.py "
                               "disagree on the slot layout, plane limit, "
                               "MQ chunk, decision CTA or compaction chunk")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {"ebcot_decision_slots": [p, p, p, p, i, i, i, i, p, p, p],
                "ebcot_chunk_count": [p, i, ll, i, p, p, p, p, p],
                "ebcot_chunk_write": [p, i, ll, i, p, p, p, p],
                "ebcot_mq_encode": [p, ll, p, p, i, p, p, p],
                "ebcot_pool_rows": [p, p, p, i, p, p, p]}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
        return _lib


def _call(symbol: str, device: torch.device, *args) -> None:
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, symbol)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, dim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def decision_smem(h: int, w: int) -> int:
    """Shared memory of the decision kernel's CTA for h x w blocks: the
    slot stage (at most STAGE_COLS columns, 16 bytes of alignment slack),
    a 32-bit word per padded stripe column and three bytes per padded
    column."""
    ncol = (h // 4) * w
    nwords = (h // 4 + 2) * (w + 2)
    stage = (min(ncol, STAGE_COLS) * ebcot_device.SLOTS_PER_COLUMN + 31) \
        & ~15
    return stage + 4 * nwords + 3 * ((nwords + 3) & ~3)


def decision_slots(mags: torch.Tensor, signs: torch.Tensor,
                   band_class: torch.Tensor, valid: torch.Tensor,
                   max_planes: int) -> torch.Tensor:
    """Dense decision slots uint8 [B, max_planes * slots_per_plane(H, W)]
    of int32 mags and signs [B, H, W], band classes int32 [B] and a bool
    valid mask [B, H, W]; ebcot_device.decision_slots."""
    if not 0 <= max_planes <= MAX_PLANES:
        raise ValueError(f"decision_slots: {max_planes} bitplanes, the "
                         f"kernel takes at most {MAX_PLANES}")
    if mags.device.type == "cpu":
        return ebcot_device.decision_slots(mags, signs, band_class, valid,
                                           max_planes)
    name = "ebcot_decision_slots"
    dev = mags.device
    _check(mags, name, torch.int32, 3, dev)
    _check(signs, name, torch.int32, 3, dev)
    _check(valid, name, torch.bool, 3, dev)
    _check(band_class, name, torch.int32, 1, dev)
    nb, h, w = mags.shape
    if (h % 4 or signs.shape != mags.shape or valid.shape != mags.shape
            or band_class.shape != (nb,) or nb * max_planes >= 1 << 31
            or decision_smem(h, w) > MAX_SMEM_BYTES):
        raise ValueError(f"{name}: blocks {tuple(mags.shape)} not supported "
                         "(height a multiple of 4, state in shared memory)")
    t = max_planes * ebcot_device.slots_per_plane(h, w)
    slots = torch.empty((nb, t), dtype=torch.uint8, device=dev)
    if nb and t:
        stats = torch.empty((nb, 2), dtype=torch.int32, device=dev)
        _call(name, dev, mags.data_ptr(), signs.data_ptr(), valid.data_ptr(),
              band_class.data_ptr(), nb, h, w, max_planes, stats.data_ptr(),
              slots.data_ptr())
        LAUNCHES[name] += 1
    return slots


def compact_rows_plain(slots: torch.Tensor):
    """The plain version of compact_rows: mq_device.compact_rows, then
    mq_device.pool_rows, on the slots' device."""
    sv = slots != ebcot_device.EMPTY
    ndec = sv.sum(dim=1, dtype=torch.int64)
    largest = int(ndec.max()) if ndec.numel() else 0
    aligned = mq_device.compact_rows(slots, sv, largest)
    pool = mq_device.pool_rows(aligned, ndec, int(ndec.sum()))
    return pool, ndec.to(torch.int32), torch.cumsum(ndec, 0) - ndec, largest


def compact_rows(slots: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Each row's non-0xFF slots, in order, concatenated: (decision pool
    uint8 [sum ndec], ndec int32 [B], offsets int64 [B] (the exclusive scan
    of ndec), the largest ndec).  The kernels count each COMPACT_CHUNK-byte
    chunk of a row, scan the rows, and write the chunks that hold a
    decision; the pool is sized exactly from the scan (one small
    device-to-host copy, the wrapper's only wait for the card)."""
    if slots.device.type == "cpu":
        return compact_rows_plain(slots)
    name = "ebcot_compact_rows"
    dev = slots.device
    _check(slots, name, torch.uint8, 2, dev)
    nb, t = slots.shape
    if not nb or not t:
        return (torch.empty(0, dtype=torch.uint8, device=dev),
                torch.zeros(nb, dtype=torch.int32, device=dev),
                torch.zeros(nb, dtype=torch.int64, device=dev), 0)
    chunks = nb * -(-t // COMPACT_CHUNK)
    if chunks >= 1 << 31:
        raise ValueError(f"{name}: {chunks} chunks of {COMPACT_CHUNK} bytes "
                         "are more than one launch takes")
    counts = torch.empty(chunks, dtype=torch.int32, device=dev)
    ndec = torch.empty(nb, dtype=torch.int32, device=dev)
    off = torch.empty(nb, dtype=torch.int64, device=dev)
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    _call("ebcot_chunk_count", dev, slots.data_ptr(), nb, t, COMPACT_CHUNK,
          counts.data_ptr(), ndec.data_ptr(), off.data_ptr(),
          stats.data_ptr())
    total, largest = (int(v) for v in stats.cpu())
    pool = torch.empty(total, dtype=torch.uint8, device=dev)
    _call("ebcot_chunk_write", dev, slots.data_ptr(), nb, t, COMPACT_CHUNK,
          counts.data_ptr(), off.data_ptr(), pool.data_ptr())
    LAUNCHES[name] += 1
    return pool, ndec, off, largest


def compact_stress_slots() -> Dict[str, np.ndarray]:
    """Slot rows uint8 [B, T] at the compaction kernels' edges: rows of
    only 0xFF; a decision at the first and the last byte of every chunk of
    COMPACT_CHUNK bytes, and runs of decisions across 16-byte boundaries at
    both ends of a chunk; T a multiple of neither 16 nor the chunk; rows
    shorter than 16 bytes; planes of 64x64 slots whose top planes are 0xFF
    fill (the decision kernel's planes above a block's bit count); a dense
    and a sparse set."""
    rng = np.random.RandomState(0)
    chunk = COMPACT_CHUNK

    def live(shape, p):
        out = np.full(shape, ebcot_device.EMPTY, np.uint8)
        mask = rng.rand(*shape) < p
        out[mask] = rng.randint(0, ebcot_device.EMPTY, int(mask.sum()))
        return out

    edges = np.full((4, 3 * chunk), ebcot_device.EMPTY, np.uint8)
    edges[:, ::chunk] = 1
    edges[:, chunk - 1::chunk] = 2
    edges[1, chunk - 21:chunk + 13] = 3          # across a chunk boundary
    edges[2, 2 * chunk + 5:3 * chunk - 7] = 4    # off 16 at both ends
    plane = ebcot_device.slots_per_plane(64, 64)
    fill = live((5, 11 * plane), 0.4)
    for b, top in enumerate((0, 3, 7, 10, 11)):
        fill[b, :top * plane] = ebcot_device.EMPTY
    return {"all_ff": np.full((3, 2 * chunk + 100), ebcot_device.EMPTY,
                              np.uint8),
            "chunk_edges": edges,
            "ragged_t": live((5, 2 * chunk + 4099), 0.3),
            "short_rows": live((7, 13), 0.6),
            "fill_planes": fill,
            "dense": live((2, 20000), 1.0),
            "sparse": live((6, 3 * chunk + 16), 0.001)}


def pool_stress_rows() -> Dict[str, Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
    """MQ segment rows at the segment-pool kernel's edges, as (ndec int32
    [B], lens int32 [B], the row buffer uint8 [row_bytes(ndec)]; row b at
    3 off[b] + 3 b): short rows at every phase of source and pool; rows of
    length 0 among them, and a batch where every length is 0; rows far
    longer than one step of a warp's copy (2 KB); a single row; and more
    rows than POOL_MAX_CTAS CTAs of a row a warp take, so a warp takes a
    run of two and the last tile is partial."""
    rng = np.random.RandomState(1)

    def rows(ndec, lens):
        ndec = np.asarray(ndec, np.int32)
        lens = np.minimum(np.asarray(lens, np.int64), 3 * ndec + 3)
        lens[ndec == 0] = 0
        buf = rng.randint(0, 256, 3 * int(ndec.sum()) + 3 * ndec.size)
        return ndec, lens.astype(np.int32), buf.astype(np.uint8)

    n = rng.randint(1, 12, 160)
    long_n = rng.randint(0, 40, 9)
    long_n[[2, 6]] = (3000, 700)
    many = rng.randint(0, 4, 4 * 1024 + 5)
    return {"phases": rows(n, rng.randint(1, 40, n.size)),
            "zero_rows": rows(np.where(rng.rand(60) < 0.5, 0, 9),
                              rng.randint(0, 30, 60)),
            "all_empty": rows(rng.randint(0, 9, 20), np.zeros(20)),
            "long_rows": rows(long_n, 3 * long_n + 3),
            "single": rows([5], [17]),
            "many_rows": rows(many, rng.randint(0, 13, many.size))}


def row_bytes(ndec: torch.Tensor) -> int:
    """Length of the MQ segment row buffer for these decision counts (for
    a caller without the decision pool: it syncs to sum the counts)."""
    return 3 * int(ndec.to(torch.int64).sum()) + 3 * ndec.numel()


def _pool_row_bytes(pool: torch.Tensor, nb: int) -> int:
    """row_bytes from the decision pool, which compact_rows sizes to the sum
    of the counts exactly: no device-to-host copy."""
    return 3 * pool.numel() + 3 * nb


def _row_starts(off: torch.Tensor) -> torch.Tensor:
    return 3 * off + 3 * torch.arange(off.numel(), device=off.device)


def mq_encode_plain(pool, ndec, off, largest):
    """The plain version of mq_encode: decision rows aligned to UNROLL, the
    lockstep scan, the staging rows compacted (sentinel dropped) and laid
    out as the kernel's row buffer, on the pool's device."""
    nb = ndec.numel()
    dev = pool.device
    ndec64 = ndec.to(torch.int64)
    U = mq_device.UNROLL
    t_cap = max(U, -(-largest // U) * U)
    local = torch.arange(t_cap, device=dev).expand(nb, t_cap)
    inside = local < ndec64.view(nb, 1)
    aligned = torch.full((nb, t_cap), ebcot_device.EMPTY, dtype=torch.uint8,
                         device=dev)
    aligned[inside] = pool[(off.view(nb, 1) + local)[inside]]
    xs_tm = aligned.t().reshape(t_cap // U, U, nb)
    sb, sv, lens = mq_device.mq_encode_scan(xs_tm, ndec64)
    width = 3 * t_cap + 3
    seg = mq_device.compact_rows(sb, sv, width, drop_first=True)
    rows = torch.zeros(_pool_row_bytes(pool, nb), dtype=torch.uint8,
                       device=dev)
    cols = torch.arange(width, device=dev).expand(nb, width)
    used = cols < lens.to(torch.int64).view(nb, 1)
    rows[(_row_starts(off).view(nb, 1) + cols)[used]] = seg[used]
    return rows, lens


def mq_encode(pool: torch.Tensor, ndec: torch.Tensor, off: torch.Tensor,
              largest: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """MQ-code every block's decision stream (compact_rows' outputs):
    (segment row buffer uint8 [row_bytes(ndec)], segment lengths int32
    [B]).  A segment keeps its trailing 0xFF; a block without decisions
    has length 0.  The pool holds exactly sum(ndec) decisions; any base
    address and offsets will do (the kernel stages from the 16-byte
    boundary below each stream)."""
    if pool.device.type == "cpu":
        return mq_encode_plain(pool, ndec, off, largest)
    name = "ebcot_mq_encode"
    dev = pool.device
    _check(pool, name, torch.uint8, 1, dev)
    _check(ndec, name, torch.int32, 1, dev)
    _check(off, name, torch.int64, 1, dev)
    nb = ndec.numel()
    if off.numel() != nb:
        raise ValueError(f"{name}: {off.numel()} offsets for {nb} blocks")
    rows = torch.empty(_pool_row_bytes(pool, nb), dtype=torch.uint8,
                       device=dev)
    lens = torch.empty(nb, dtype=torch.int32, device=dev)
    if nb:
        _call(name, dev, pool.data_ptr(), pool.numel(), off.data_ptr(),
              ndec.data_ptr(), nb, rows.data_ptr(), lens.data_ptr())
        LAUNCHES[name] += 1
    return rows, lens


def pool_rows_plain(rows: torch.Tensor, off: torch.Tensor,
                    lens: torch.Tensor):
    """The plain version of pool_rows, on the rows' device."""
    nb = lens.numel()
    lens64 = lens.to(torch.int64)
    width = int(lens64.max()) if nb else 0
    cols = torch.arange(width, device=rows.device).expand(nb, width)
    used = cols < lens64.view(nb, 1)
    seg = rows[(_row_starts(off).view(nb, 1) + cols)[used]]
    pool = torch.zeros(rows.numel(), dtype=torch.uint8, device=rows.device)
    pool[:seg.numel()] = seg
    return pool, lens64.sum().view(1)


def pool_rows(rows: torch.Tensor, off: torch.Tensor, lens: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The segments of the row buffer in one pool, block b's at the
    exclusive scan of lens: (pool uint8, allocated at the row buffer's
    length, of which the first `total` bytes are written; total int64 [1]
    on the device)."""
    if rows.device.type == "cpu":
        return pool_rows_plain(rows, off, lens)
    name = "ebcot_pool_rows"
    dev = rows.device
    _check(rows, name, torch.uint8, 1, dev)
    _check(off, name, torch.int64, 1, dev)
    _check(lens, name, torch.int32, 1, dev)
    nb = lens.numel()
    if off.numel() != nb:
        raise ValueError(f"{name}: {off.numel()} offsets for {nb} rows")
    pool = torch.empty(rows.numel(), dtype=torch.uint8, device=dev)
    # the kernel writes the total; zeros only where no kernel runs
    total = (torch.empty if nb else torch.zeros)(1, dtype=torch.int64,
                                                 device=dev)
    if nb:
        _call(name, dev, rows.data_ptr(), off.data_ptr(), lens.data_ptr(),
              nb, total.data_ptr(), pool.data_ptr())
        LAUNCHES[name] += 1
    return pool, total
