// The edge rows of a row shard, shared by the level kernels' halo form
// (csrc/dwt53.cu, csrc/dwt97.cu) and the packing kernel (csrc/dwt_edges.cu).
//
// A signal of sp * h rows is split into sp row shards of h rows (h even,
// each first row at an even global index).  Each shard packs its edge slot:
// its first e/2 and last e/2 rows, e = min(h, 2 * EDGE_ROWS), so all of them
// when h <= 2 * EDGE_ROWS (for an inverse level the interleaved rows, [LL|HL]
// or [LH|HH], built from the bands).  Every shard gets every slot as one
// tensor, edges [sp, n, e, w].  A level kernel reads a row g outside its
// shard (g < 0 or g >= h, relative to its first row) of the globally
// extended signal: the global row rank * h + g, reflected over the sp * h
// rows (whole-sample symmetric extension), lies in shard s at row i; for
// s == rank that is the shard's own row i (a reflection at a global edge
// that leads back into it), else row edge_index(i) of edges[s].  The
// lifting reaches at most EDGE_ROWS rows beyond a shard (ops/dwt.py
// HALO_DEPTH), so every row that another shard reads is in its slot; a
// shard of 2 rows, shorter than the 9/7 lifting's reach, reads shards
// beyond its neighbours.  ops/dwt.py (halo_source, edge_index,
// pack_edges) is the plain version of the same rule.

#pragma once

#include <stdint.h>

#define EDGE_ROWS 4

// Row i of a shard of h rows in its edge slot of e rows.
__host__ __device__ __forceinline__ int edge_index(int i, int h, int e) {
  return i < (e >> 1) ? i : i - (h - e);
}

// The shard row that row r of an edge slot of e rows holds.
__host__ __device__ __forceinline__ int edge_source_row(int r, int h, int e) {
  return r < (e >> 1) ? r : r + (h - e);
}

// Row g (< 0 or >= h) of shard `rank` of sp shards of h rows, in a frame
// of n: a pointer to its row in edges (rows of w words) when another shard
// holds it, else nullptr with *g set to the shard's own row.  Any h.
template <typename T>
__device__ __forceinline__ const T* edge_row(const T* edges, int sp, int rank,
                                            int e, int n, int frame, int* g,
                                            int h, int w) {
  const int total = sp * h;
  int gg = rank * h + *g;
  while (gg < 0 || gg >= total) {
    if (gg < 0) gg = -gg;
    if (gg >= total) gg = 2 * total - 2 - gg;
  }
  const int s = gg / h, i = gg - s * h;
  if (s == rank) {
    *g = i;
    return nullptr;
  }
  return edges + (((int64_t)s * n + frame) * e + edge_index(i, h, e)) * w;
}

// edge_row for a level kernel's row g at any g: nullptr with *g unchanged
// inside the shard.  GENERAL takes any h (edge_row); otherwise the shard
// has at least 2 * EDGE_ROWS rows, so a row the lifting reaches beyond it
// (at most EDGE_ROWS) is in the neighbour's slot, next to its end, or, at
// a global edge, the shard's own row reflected once: no loop, no division.
template <bool GENERAL, typename T>
__device__ __forceinline__ const T* shard_edge_row(const T* edges, int sp,
                                                  int rank, int e, int n,
                                                  int frame, int* g, int h,
                                                  int w) {
  if (*g >= 0 && *g < h) return nullptr;
  if (GENERAL) return edge_row(edges, sp, rank, e, n, frame, g, h, w);
  if (*g < 0) {
    if (rank > 0)
      return edges + (((int64_t)(rank - 1) * n + frame) * e + e + *g) * w;
    *g = -*g;
  } else {
    if (rank < sp - 1)
      return edges + (((int64_t)(rank + 1) * n + frame) * e + *g - h) * w;
    *g = 2 * h - 2 - *g;
  }
  return nullptr;
}
