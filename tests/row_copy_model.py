"""A numpy model of the warp copy of go_jpeg2000_tpu_torch/csrc/row_copy.cuh
(the pool kernels ht_compact_pool and ebcot_pool_rows), for the CPU tests
of both kernels.

Memory is flat numpy byte arrays, each with a base phase: its byte 0 sits
`phase` bytes past a 16-byte boundary.  The model walks the same 16-byte
windows as the kernel: a lane's source windows (one load inside the row,
the row's own bytes at its ends), the next window taken from the next
lane, from lane 0 of the next slab or from lane 31's extra load, the
realignment by r = (src - dst) mod 16, and the stores (whole inside the
row's range of the pool, else the widest aligned pieces that stay inside
it).  Every load and store is checked against the row's range and its
alignment."""
import os
import re

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "go_jpeg2000_tpu_torch", "csrc")


def define(source: str, name: str) -> int:
    """An integer #define of a CUDA source under csrc/."""
    with open(os.path.join(_CSRC, source)) as f:
        text = f.read()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


class Mem:
    """A byte array at a base phase; addresses are phase + index."""

    def __init__(self, data: np.ndarray, phase: int):
        self.data = data.view(np.uint8).reshape(-1)
        self.phase = phase

    def addr(self, index: int) -> int:
        return self.phase + index


def _store_pieces(lo: int, hi: int):
    """store_bytes' stores for bytes [lo, hi) of a window: (offset,
    size)."""
    out = []
    for h in range(2):
        if lo <= 8 * h and hi >= 8 * h + 8:
            out.append((8 * h, 8))
            continue
        for i in range(2 * h, 2 * h + 2):
            if lo <= 4 * i and hi >= 4 * i + 4:
                out.append((4 * i, 4))
                continue
            for j in range(4 * i, 4 * i + 4, 2):
                if lo <= j and hi >= j + 2:
                    out.append((j, 2))
                    continue
                for b in (j, j + 1):
                    if lo <= b < hi:
                        out.append((b, 1))
    return out


def warp_copy(dst: Mem, d_index: int, src: Mem, s_index: int, n: int,
              stores: list, unroll: int) -> None:
    """warp_copy<unroll>(dst + d_index, src + s_index, n): writes dst.data,
    appends each store (address, size) to `stores`, and checks every load
    and store."""
    if n <= 0:
        return
    d, s = dst.addr(d_index), src.addr(s_index)
    e = d + n
    d0 = d & ~15
    s0 = s - (d - d0)
    r = s0 & 15
    a0 = s0 - r
    nwin = (e - d0 + 15) >> 4

    def window(k):
        a = a0 + 16 * k
        if a >= s and a + 16 <= s + n:
            assert a % 16 == 0
            return src.data[a - src.phase:a - src.phase + 16]
        idx = a + np.arange(16)
        inside = (idx >= s) & (idx < s + n)
        w = np.zeros(16, np.uint8)
        w[inside] = src.data[idx[inside] - src.phase]
        return w

    for k0 in range(0, nwin, 32 * unroll):
        loaded = {}
        for k in range(k0, min(k0 + 32 * unroll, nwin)):
            u, lane = divmod(k - k0, 32)
            if k not in loaded:
                loaded[k] = window(k)
            v = loaded[k]
            if r:
                # window k + 1: the next lane's, lane 0's of the next slab,
                # or lane 31's extra load after the last slab
                if lane < 31:
                    nxt = k0 + 32 * u + lane + 1
                elif u + 1 < unroll:
                    nxt = k0 + 32 * (u + 1)
                else:
                    nxt = k0 + 32 * unroll
                if nxt not in loaded:
                    loaded[nxt] = window(nxt)
                v = np.concatenate([v, loaded[nxt]])[r:r + 16]
            a = d0 + 16 * k
            if a >= d and a + 16 <= e:
                pieces = [(0, 16)]
            else:
                pieces = _store_pieces(max(d - a, 0), min(e - a, 16))
            for off, size in pieces:
                at = a + off
                assert at % size == 0, "unaligned store"
                assert d <= at and at + size <= e, \
                    "a store outside the row's range of the pool"
                dst.data[at - dst.phase:at - dst.phase + size] = \
                    v[off:off + size]
                stores.append((at, size))


def check_stores(stores: list, lo: int, hi: int) -> None:
    """The stores of a pool cover [lo, hi) exactly once."""
    seen = np.zeros(hi - lo, np.int32)
    for at, size in stores:
        assert lo <= at and at + size <= hi
        seen[at - lo:at - lo + size] += 1
    assert (seen == 1).all(), "a pool byte stored twice or never"
