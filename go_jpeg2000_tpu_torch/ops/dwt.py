"""Discrete wavelet transform (ISO/IEC 15444-1 Annex F) as torch ops.

Port of go_jpeg2000_tpu/ops/dwt.py: the reversible (integer) 5/3 and the
irreversible (float32) 9/7 lifting DWT, 2-D and multi-level, for any
subband coordinate parity (tile origins need not be even), with
whole-sample symmetric extension.  It runs on the tensor's own device and
is the plain version of the hand-written CUDA level kernels in
ops/dwt_cuda.py (csrc/dwt53.cu, csrc/dwt97.cu): the CPU path and the
oracle the kernels are held to on the card (they take every level,
a row shard's level at an even origin and height, any width).

  5/3:  H[2n+1] -= floor((X[2n] + X[2n+2]) / 2)
        L[2n]   += floor((H[2n-1] + H[2n+1] + 2) / 4)
  9/7:  four lifting steps (alpha, beta, gamma, delta) + K scaling.

`>>` on a signed int32 tensor is an arithmetic shift, i.e. the floor the
standard asks for.  The 9/7 steps keep the JAX package's operation order,
`c + ALPHA * (l + r)` and `x * (1.0 / K)`, each a separately rounded
float32 op, so the result equals the JAX package's eager lifting bit for
bit (and the CUDA kernel's, which rounds the same ops the same way).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# 9/7 lifting constants (Table F.4)
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001

REV53 = "53"
IRR97 = "97"


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------- 1-D core

def _neighbours(x: torch.Tensor, axis: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x[i-1], x[i+1]) along `axis` with whole-sample symmetric extension
    by one sample each side (F.3.7); the axis has at least 2 samples."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    left = (idx - 1).abs()                       # -1 -> 1
    right = idx + 1
    right[n - 1] = n - 2                         # n -> n - 2
    return x.index_select(axis, left), x.index_select(axis, right)


def _parity_mask(n: int, start_parity: int, want_odd: bool, ndim: int,
                 axis: int, device) -> torch.Tensor:
    odd = ((torch.arange(n, device=device) + start_parity) % 2) == 1
    mask = odd if want_odd else ~odd
    shape = [1] * ndim
    shape[axis] = n
    return mask.reshape(shape)


def _lift(x: torch.Tensor, axis: int, start_parity: int, want_odd: bool, f
          ) -> torch.Tensor:
    """x[u] = f(x[u], x[u-1], x[u+1]) for samples of the requested parity,
    with symmetric extension at the interval boundaries."""
    left, right = _neighbours(x, axis)
    mask = _parity_mask(x.shape[axis], start_parity, want_odd, x.ndim, axis,
                        x.device)
    return torch.where(mask, f(x, left, right), x)


def _forward_1d_53(x: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    """In-place-interleaved forward 5/3 along `axis`; `parity` is the
    absolute coordinate parity of the first sample (0=even)."""
    n = x.shape[axis]
    if n == 0:
        return x
    if n == 1:
        # F.3.7: single-sample signal; odd-origin high-pass doubles.
        return x * 2 if parity == 1 else x
    x = _lift(x, axis, parity, True, lambda c, l, r: c - ((l + r) >> 1))
    x = _lift(x, axis, parity, False, lambda c, l, r: c + ((l + r + 2) >> 2))
    return x


def _inverse_1d_53(x: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    n = x.shape[axis]
    if n == 0:
        return x
    if n == 1:
        return x >> 1 if parity == 1 else x
    x = _lift(x, axis, parity, False, lambda c, l, r: c - ((l + r + 2) >> 2))
    x = _lift(x, axis, parity, True, lambda c, l, r: c + ((l + r) >> 1))
    return x


def _scale_by_parity(x: torch.Tensor, axis: int, parity: int,
                     even_scale: float, odd_scale: float) -> torch.Tensor:
    odd = _parity_mask(x.shape[axis], parity, True, x.ndim, axis, x.device)
    return torch.where(odd, x * odd_scale, x * even_scale)


def _forward_1d_97(x: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    if x.shape[axis] <= 1:
        return x
    x = _lift(x, axis, parity, True, lambda c, l, r: c + ALPHA * (l + r))
    x = _lift(x, axis, parity, False, lambda c, l, r: c + BETA * (l + r))
    x = _lift(x, axis, parity, True, lambda c, l, r: c + GAMMA * (l + r))
    x = _lift(x, axis, parity, False, lambda c, l, r: c + DELTA * (l + r))
    return _scale_by_parity(x, axis, parity, 1.0 / K, K)


def _inverse_1d_97(x: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    if x.shape[axis] <= 1:
        return x
    x = _scale_by_parity(x, axis, parity, K, 1.0 / K)
    x = _lift(x, axis, parity, False, lambda c, l, r: c - DELTA * (l + r))
    x = _lift(x, axis, parity, True, lambda c, l, r: c - GAMMA * (l + r))
    x = _lift(x, axis, parity, False, lambda c, l, r: c - BETA * (l + r))
    x = _lift(x, axis, parity, True, lambda c, l, r: c - ALPHA * (l + r))
    return x


_FORWARD_1D = {REV53: _forward_1d_53, IRR97: _forward_1d_97}
_INVERSE_1D = {REV53: _inverse_1d_53, IRR97: _inverse_1d_97}


def _take(x: torch.Tensor, axis: int, start: int) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, None, 2)
    return x[tuple(idx)]


def _deinterleave(x: torch.Tensor, axis: int, parity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split an interleaved signal into (low, high) by absolute parity."""
    even, odd = _take(x, axis, 0), _take(x, axis, 1)
    return (even, odd) if parity == 0 else (odd, even)


def _interleave(low: torch.Tensor, high: torch.Tensor, axis: int,
                parity: int) -> torch.Tensor:
    n = low.shape[axis] + high.shape[axis]
    first, second = (low, high) if parity == 0 else (high, low)
    shape = list(low.shape)
    shape[axis] = n
    out = torch.empty(shape, dtype=low.dtype, device=low.device)
    idx = [slice(None)] * out.ndim
    idx[axis] = slice(0, n, 2)
    out[tuple(idx)] = first
    idx[axis] = slice(1, n, 2)
    out[tuple(idx)] = second
    return out


# ---------------------------------------------------------------- 2-D level

def forward_2d(a: torch.Tensor, kind: str = REV53, u0: int = 0, v0: int = 0
               ) -> Dict[str, torch.Tensor]:
    """One 2-D decomposition of `a` (shape [..., H, W], origin (v0, u0)).

    Column (vertical) transform first, then rows — the Annex F 2D_SD
    ordering whose inverse (2D_SR) interleaves rows first.  Returns a dict
    with LL/HL/LH/HH.  `kind` is REV53 (int32 samples) or IRR97 (float32).
    """
    fwd = _FORWARD_1D[kind]
    a = fwd(a, a.ndim - 2, v0 & 1)                     # vertical
    a = fwd(a, a.ndim - 1, u0 & 1)                     # horizontal
    lo_y, hi_y = _deinterleave(a, a.ndim - 2, v0 & 1)
    ll, hl = _deinterleave(lo_y, lo_y.ndim - 1, u0 & 1)
    lh, hh = _deinterleave(hi_y, hi_y.ndim - 1, u0 & 1)
    return {"LL": ll, "HL": hl, "LH": lh, "HH": hh}


def inverse_2d(bands: Dict[str, torch.Tensor], kind: str = REV53,
               u0: int = 0, v0: int = 0) -> torch.Tensor:
    inv = _INVERSE_1D[kind]
    ll, hl, lh, hh = bands["LL"], bands["HL"], bands["LH"], bands["HH"]
    lo_y = _interleave(ll, hl, ll.ndim - 1, u0 & 1)
    hi_y = _interleave(lh, hh, lh.ndim - 1, u0 & 1)
    a = _interleave(lo_y, hi_y, lo_y.ndim - 2, v0 & 1)
    a = inv(a, a.ndim - 1, u0 & 1)                     # horizontal first
    a = inv(a, a.ndim - 2, v0 & 1)                     # then vertical
    return a


# ------------------------------------------------- 2-D level on a row shard
#
# Port of the halo lifting of go_jpeg2000_tpu/parallel/sharded.py
# (_odd_update_sharded, _even_update_sharded, _vlift53_sharded,
# _vlift97_sharded and their inverses, dwt_level_sharded,
# idwt_level_sharded).  The JAX package exchanges one boundary row per
# lifting step; here each of the sp row shards of a signal packs its edge
# rows once a level (pack_edges: its first and last EDGE_ROWS rows, or all
# of them), every shard gets them all as one tensor `edges` [sp, N, E, W]
# (parallel/sharded.py), and a shard reads each row of the globally
# extended signal that its vertical lifting reaches beyond its own rows
# from there, or from itself where the reflection at a global edge leads
# back into it (halo_source).  So a shard of any even height lifts
# exactly as the whole signal does.  These are the plain versions of the
# level kernels' halo form (csrc/dwt53.cu, csrc/dwt97.cu) and of the edge
# packing kernel (csrc/dwt_edges.cu), with the same contract.

# rows of the signal that one level's vertical lifting reads (above, below)
# a shard whose first row has an even global index, forward and inverse
HALO_DEPTH = {(REV53, False): (2, 1), (IRR97, False): (4, 3),
              (REV53, True): (1, 2), (IRR97, True): (3, 4)}
# rows at each end of a row shard that its edge slot carries: the
# lifting's farthest reach beyond a shard (HALO_DEPTH), so every row that
# another shard reads is among them; a shard of at most 2 * EDGE_ROWS rows
# sends all of them
EDGE_ROWS = max(max(d) for d in HALO_DEPTH.values())


def reflect(i: int, n: int) -> int:
    """Whole-sample symmetric extension of index i into [0, n), applied
    until the index is inside (as the level kernels do)."""
    while i < 0 or i >= n:
        i = -i if i < 0 else 2 * n - 2 - i
    return i


def edge_count(h: int) -> int:
    """Rows E of the edge slot of a shard of h rows (interleaved rows for
    an inverse level)."""
    return min(h, 2 * EDGE_ROWS)


def halo_source(g: int, h: int, sp: int, rank: int) -> Tuple[int, int]:
    """Row g (-4 <= g < h + 4, relative to the first row) of row shard
    `rank` of sp shards of h rows, in the globally extended signal: (s, i)
    with the global row reflected over the sp * h rows (whole-sample
    symmetric extension) and split into its shard s and row i there.  For
    s != rank, row i is at index edge_index(i, h) of edges[s]; for s ==
    rank it is the shard's own row i."""
    return divmod(reflect(rank * h + g, sp * h), h)


def edge_index(i: int, h: int) -> int:
    """Row i of a shard of h rows in its edge slot (the first EDGE_ROWS
    rows, then the last EDGE_ROWS); AssertionError for a row the slot does
    not carry."""
    e = edge_count(h)
    if i < e // 2:
        return i
    if i < h - e // 2:
        raise AssertionError(f"row {i} of a shard of {h} rows is not an "
                             "edge row")
    return i - (h - e)


def shard_edges(rows: torch.Tensor) -> torch.Tensor:
    """The edge slot of a forward level's row shard rows [N, h, W]: its
    first and last EDGE_ROWS rows [N, E, W], or all of them when it has no
    more than twice that."""
    if rows.shape[-2] <= 2 * EDGE_ROWS:
        return rows
    return torch.cat([rows[:, :EDGE_ROWS], rows[:, -EDGE_ROWS:]], dim=1)


def pair_rows(bands: Dict[str, torch.Tensor]) -> torch.Tensor:
    """An inverse level's input rows as its kernel loads them: interleaved
    row 2m is [LL[m] | HL[m]], row 2m+1 is [LH[m] | HH[m]] (the bands' rows
    from the first, which must be even)."""
    lo = torch.cat([bands["LL"], bands["HL"]], dim=-1)
    hi = torch.cat([bands["LH"], bands["HH"]], dim=-1)
    rows = torch.stack([lo, hi], dim=-2)
    return rows.reshape(rows.shape[:-3] + (-1, rows.shape[-1]))


def pair_edges(bands: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The edge slot of an inverse level's row shard, from its bands' first
    and last EDGE_ROWS / 2 rows only: shard_edges of its interleaved rows
    in pair_rows' layout."""
    if bands["LL"].shape[-2] <= EDGE_ROWS:
        return pair_rows(bands)
    k = EDGE_ROWS // 2
    return torch.cat([pair_rows({b: v[:, :k] for b, v in bands.items()}),
                      pair_rows({b: v[:, -k:] for b, v in bands.items()})],
                     dim=1)


def pack_edges(src, out=None) -> torch.Tensor:
    """A row shard's edge slot [N, E, W]: shard_edges of a forward level's
    rows (a tensor), pair_edges of an inverse level's bands (a dict);
    written into `out` (a slot of edges) when it is given."""
    got = pair_edges(src) if isinstance(src, dict) else shard_edges(src)
    if out is None:
        return got
    return out.copy_(got)


def halos_from_edges(edges: torch.Tensor, own: torch.Tensor, rank: int,
                     depth: Tuple[int, int]):
    """(above, below) [N, a, W] and [N, b, W] for depth = (a, b): the rows
    of the globally extended signal just outside row shard `rank`, whose
    own rows are `own` [N, h, W] (pair_rows' layout for an inverse level),
    read from every shard's edge slot, edges [sp, N, E, W], or from the
    shard itself (halo_source)."""
    a, b = depth
    h = own.shape[-2]
    sp = edges.shape[0]
    if edges.shape[-2] != edge_count(h):
        raise ValueError(f"edge slots of {edges.shape[-2]} rows, expected "
                         f"{edge_count(h)} for shards of {h} rows")

    def rows(gs):
        out = []
        for g in gs:
            s, i = halo_source(g, h, sp, rank)
            out.append(own[:, i] if s == rank
                       else edges[s][:, edge_index(i, h)])
        return torch.stack(out, dim=1)

    return rows(range(-a, 0)), rows(range(h, h + b))


def forward_2d_halo(a: torch.Tensor, kind: str = REV53, edges=None,
                    rank: int = 0) -> Dict[str, torch.Tensor]:
    """One 2-D level of row shard `rank` a [N, h, W] (first row at an even
    global index, h even, any W) of sp = edges.shape[0] shards of one
    signal; edges [sp, N, E, W] holds every shard's pack_edges.  Without
    edges this is forward_2d."""
    if edges is None:
        return forward_2d(a, kind)
    depth = HALO_DEPTH[(kind, False)]
    fwd = _FORWARD_1D[kind]
    above, below = halos_from_edges(edges, a, rank, depth)
    ext = torch.cat([above, a, below], dim=-2)
    ext = fwd(ext, ext.ndim - 2, depth[0] & 1)          # vertical
    a = ext.narrow(ext.ndim - 2, depth[0], a.shape[-2])
    a = fwd(a, a.ndim - 1, 0)                           # horizontal
    lo_y, hi_y = _deinterleave(a, a.ndim - 2, 0)
    ll, hl = _deinterleave(lo_y, lo_y.ndim - 1, 0)
    lh, hh = _deinterleave(hi_y, hi_y.ndim - 1, 0)
    return {"LL": ll, "HL": hl, "LH": lh, "HH": hh}


def inverse_2d_halo(bands: Dict[str, torch.Tensor], kind: str = REV53,
                    edges=None, rank: int = 0) -> torch.Tensor:
    """Inverse of forward_2d_halo: the bands of row shard `rank` -> its
    rows [N, h, W]; edges [sp, N, E, W] holds every shard's pack_edges of
    its bands (interleaved rows in pair_rows' layout).  Without edges this
    is inverse_2d."""
    if edges is None:
        return inverse_2d(bands, kind)
    depth = HALO_DEPTH[(kind, True)]
    inv = _INVERSE_1D[kind]
    rows = pair_rows(bands)
    above, below = halos_from_edges(edges, rows, rank, depth)
    ext = torch.cat([above, rows, below], dim=-2)
    wl = bands["LL"].shape[-1]
    ext = _interleave(ext[..., :wl], ext[..., wl:], ext.ndim - 1, 0)
    ext = inv(ext, ext.ndim - 1, 0)                     # horizontal first
    ext = inv(ext, ext.ndim - 2, depth[0] & 1)          # then vertical
    return ext.narrow(ext.ndim - 2, depth[0], rows.shape[-2])

# ------------------------------------------------------------- multi-level

def level_origins(u0: int, v0: int, levels: int) -> List[Tuple[int, int]]:
    """Origin (u, v) of each level's input signal, level 1 first."""
    out = [(u0, v0)]
    for _ in range(levels):
        out.append((ceil_div(out[-1][0], 2), ceil_div(out[-1][1], 2)))
    return out


def decompose(a: torch.Tensor, levels: int, kind: str = REV53,
              u0: int = 0, v0: int = 0) -> List[Dict[str, torch.Tensor]]:
    """Multi-level decomposition.

    Returns a list of `levels` dicts {HL, LH, HH} ordered from decomposition
    level 1 (finest, first applied) to `levels` (coarsest), with the final
    LL stored in the last dict as well.
    """
    out: List[Dict[str, torch.Tensor]] = []
    cur = a
    for lev, (cu, cv) in enumerate(level_origins(u0, v0, levels)[:levels],
                                   start=1):
        bands = forward_2d(cur, kind, cu, cv)
        entry = {"HL": bands["HL"], "LH": bands["LH"], "HH": bands["HH"]}
        cur = bands["LL"]
        if lev == levels:
            entry["LL"] = cur
        out.append(entry)
    if levels == 0:
        out.append({"LL": a})
    return out


def reconstruct(pyramid: List[Dict[str, torch.Tensor]], kind: str = REV53,
                u0: int = 0, v0: int = 0) -> torch.Tensor:
    """Inverse of :func:`decompose`."""
    levels = len(pyramid) if "HL" in pyramid[-1] else len(pyramid) - 1
    if levels == 0:
        return pyramid[0]["LL"]
    origins = level_origins(u0, v0, levels)
    cur = pyramid[levels - 1]["LL"]
    for lev in range(levels, 0, -1):
        cu, cv = origins[lev - 1]
        entry = pyramid[lev - 1]
        cur = inverse_2d({"LL": cur, "HL": entry["HL"],
                          "LH": entry["LH"], "HH": entry["HH"]},
                         kind, cu, cv)
    return cur


def subband_shapes(h: int, w: int, levels: int, u0: int = 0, v0: int = 0
                   ) -> List[Dict[str, Tuple[int, int]]]:
    """Static band shapes for decompose() without running it."""
    out = []
    cu0, cv0, cu1, cv1 = u0, v0, u0 + w, v0 + h
    for lev in range(1, levels + 1):
        nlx = ceil_div(cu1, 2) - ceil_div(cu0, 2)
        nhx = cu1 // 2 - cu0 // 2
        nly = ceil_div(cv1, 2) - ceil_div(cv0, 2)
        nhy = cv1 // 2 - cv0 // 2
        entry = {"HL": (nly, nhx), "LH": (nhy, nlx), "HH": (nhy, nhx)}
        cu0, cv0, cu1, cv1 = (ceil_div(cu0, 2), ceil_div(cv0, 2),
                              ceil_div(cu1, 2), ceil_div(cv1, 2))
        if lev == levels:
            entry["LL"] = (nly, nlx)
        out.append(entry)
    if levels == 0:
        out.append({"LL": (h, w)})
    return out
