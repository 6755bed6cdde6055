// One 2-D level of the reversible 5/3 lifting DWT (ISO/IEC 15444-1 Annex F),
// forward and inverse, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   dwt53_fwd_level  <- go_jpeg2000_tpu/ops/dwt_pallas.py _dwt53_level_kernel
//                       (plus the strided deinterleave XLA ran after it,
//                       dwt_pallas.py _level_fn)
//   dwt53_inv_level  <- go_jpeg2000_tpu/ops/dwt_pallas.py _idwt53_level_kernel
//                       (plus the band interleave before it,
//                       dwt_pallas.py _interleave_bands)
// The plain torch version is go_jpeg2000_tpu_torch/ops/dwt.py; the Python
// wrapper, build and launch counts are in ops/dwt_cuda.py.
//
// Bound: memory.  A level reads and writes each int32 sample once, 8 bytes
// per sample, with a few integer adds and shifts in between, so the time is
// the bytes over the card's bandwidth (about 67 MB for level 1 of 32 frames
// of 512x512, some 20 us at the H100's data-sheet 3.35 TB/s).  The TPU
// kernel held a whole frame in VMEM; a Hopper block has at most 227 KB of
// shared memory.
//
// The pair frame.  The level's origin (u0, v0) may have either parity; pu =
// u0 & 1 and pv = v0 & 1.  Work is laid out on pairs anchored at even
// global coordinates: column pair q holds local columns 2q - pu (even
// globally, low-pass) and 2q - pu + 1 (odd, high-pass); its low sample is
// column q - pu of the low bands (LL, LH) and its high sample column q of
// the high bands (HL, HH).  Rows pair the same way with pv, and a strip
// starts at local row 32s - pv, so every strip starts on a low-pass row
// whatever the origin.  Columns and rows outside the level (column -1 at
// pu = 1, a row past an odd height) are read through the whole-sample
// symmetric extension, which keeps a sample's global parity, are lifted
// like any other and are never stored.  Band sizes are those of
// ops/dwt.py subband_shapes: low ceil((u0 + n) / 2) - ceil(u0 / 2), high
// floor((u0 + n) / 2) - floor(u0 / 2).  A 1-sample axis takes Annex F's
// rule instead of the lifting: at odd parity the forward doubles and the
// inverse halves (>> 1) the sample, at even parity it passes through.
//
// Forward: a warp per (frame, strip of FWD_STRIP output rows, tile of 30
// output column pairs), no shared memory and no barrier.  Lane l holds
// column pair 30t + l - 1 (at an even origin and width, one 8-byte load a
// row): lane 0 is the tile's left halo (2 columns), lane 31 its right halo
// (1 column needed).  Each lane loads its FWD_STRIP + 3 rows (2 above, 1
// below the strip) into registers before it computes any, so every load
// of the strip is in flight at once; lifts its two columns vertically
// there (predict on odd rows, update on even); then lifts each row
// horizontally with two warp shuffles (the next pair's even sample, the
// previous pair's detail) and stores the row's low and high samples
// straight into the four band tensors, 30 consecutive words a band per
// warp.  Index arithmetic is per thread and row, never per sample, and no
// loop divides.  Reads beyond the ideal: 3 rows per FWD_STRIP (9%) and 2
// pairs per 30 (7%), most of them hits in L2.
//
// Inverse: the same design the other way round (2D_SR: rows first, then
// columns): a warp per (frame, strip of INV_STRIP output rows, tile of
// PAIRS output column pairs), lane l holding column pair 30t + l - 1.  A
// lane reads its pair's low-pass sample from LL or LH and its high-pass
// sample from HL or HH (two 4-byte loads a row, coalesced across the warp;
// the symmetric extension keeps a column's parity, so a reflected pair's
// two samples come from their own band columns), for its INV_STRIP + 3 rows
// (1 above, 2 below the strip), every load before any arithmetic.  Each
// row is lifted horizontally with two shuffles (undo the update on the
// even column with the previous pair's raw detail, then the predict on the
// odd column with the next pair's updated even sample), then each column
// vertically in registers; lanes 1..30 store their two columns, at an even
// origin and width as one 8-byte store a row, 240 contiguous bytes a warp.
// Lane 0 is the left halo (its raw detail), lane 31 the right (its updated
// even sample, from lane 30's detail and its own).  The forward kernel
// writes straight into the four band tensors and the inverse reads
// straight from them: the deinterleave and interleave XLA did outside the
// TPU kernel cost no extra pass over device memory.
//
// Integer exactness: (l + r) >> 1 and (l + r + 2) >> 2 are arithmetic
// shifts of signed int32 (floor division), never '/', which truncates toward
// zero.  Signal edges use whole-sample symmetric extension (i < 0 -> -i,
// i >= n -> 2n - 2 - i), applied until the index is inside, so 2- and
// 3-sample axes reflect both neighbours onto their own samples as
// ops/dwt.py does.
//
// Row shards (the halo form; replaces the row-shard lifting of
// go_jpeg2000_tpu/parallel/sharded.py, _odd_update_sharded,
// _even_update_sharded, _vlift53_sharded, _vlift53_inverse_sharded): x (for
// the inverse, the bands) may be row shard `rank` of sp shards of one
// signal.  `edges` [sp, n, e, w] then holds every shard's edge slot (its
// first and last rows, packed by csrc/dwt_edges.cu; for the inverse,
// interleaved rows with the low-pass half of the row first, [LL|HL] or
// [LH|HH]), and a warp whose strip reaches past the shard reads each row
// there through edge_row (csrc/dwt_edges.cuh): the global row, reflected
// over the whole signal, from the slot of the shard that holds it, or from
// its own rows where a reflection at a global edge leads back into the
// shard.  The JAX package exchanged one row per lifting step; the slots
// are exchanged once per level, so a shard of 2 rows, shorter than the
// lifting's reach, still lifts exactly as the whole signal.  A null
// `edges` is one shard: the signal is x itself.

// Geometry: any origin parity and any H, W >= 1 without edges; a row shard
// at an even origin and an even H >= 2, any W >= 1 (ops/dwt_cuda.py checks).
// Kernels launch on the caller's stream, allocate nothing, launch nothing
// for an empty level, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dwt_edges.cuh"

#define FWD_STRIP 32      // forward: output rows per warp (even)
#define INV_STRIP 32      // inverse: output rows per warp (even)
#define PAIRS 30          // output column pairs per warp (lanes 1 .. 30)
#define HALO 3            // forward: 2 rows above, 1 below; inverse: 1, 2
#define FWD_ABOVE 2
#define INV_ABOVE 1
#define THREADS 128
static_assert(FWD_STRIP == INV_STRIP, "warp_task lays out one strip height");

// Whole-sample symmetric extension of index i into [0, n).  A 1-sample axis
// (only the general instance, ODD below, meets one) maps every index to 0.
template <bool ODD>
__device__ __forceinline__ int reflect(int i, int n) {
  if (ODD && n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// The lifting steps in int32 arithmetic that wraps modulo 2^32, as torch's
// int32 (and XLA's) does: a 28- or 29-bit sample after the RCT overflows a
// sum of two neighbours, and signed overflow is undefined in C++, so the
// sums run in uint32_t.  `>>` of a negative int is an arithmetic shift in
// nvcc.  Below 28 bits nothing wraps and the code is the same.
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
// predict: c -/+ floor((l + r) / 2); update: c +/- floor((l + r + 2) / 4)
__device__ __forceinline__ int predict_sub(int c, int l, int r) {
  return wsub(c, wadd(l, r) >> 1);
}
__device__ __forceinline__ int predict_add(int c, int l, int r) {
  return wadd(c, wadd(l, r) >> 1);
}
__device__ __forceinline__ int update_add(int c, int l, int r) {
  return wadd(c, wadd(wadd(l, r), 2) >> 2);
}
__device__ __forceinline__ int update_sub(int c, int l, int r) {
  return wsub(c, wadd(wadd(l, r), 2) >> 2);
}

// Row g (-FWD_ABOVE <= g < h + HALO - FWD_ABOVE) of a level of h rows in
// a frame of n: with SHARD, x is row shard `rank` of sp, and a row outside
// it is the row of the globally extended signal (shard_edge_row; GENERAL =
// ODD takes any shard height, the even instance shards of at least
// 2 * EDGE_ROWS rows); else x is the whole signal, reflected.
template <bool ODD, bool SHARD>
__device__ __forceinline__ const int* shard_row(const int* x,
                                              const int* edges, int sp,
                                              int rank, int e, int n,
                                              int frame, int g, int h,
                                              int w) {
  if (SHARD) {
    const int* row =
        shard_edge_row<ODD>(edges, sp, rank, e, n, frame, &g, h, w);
    return row ? row : x + ((int64_t)frame * h + g) * w;
  }
  return x + ((int64_t)frame * h + reflect<ODD>(g, h)) * w;
}

// Each kernel comes in two instances.  ODD is the general one: any origin
// parity, any H and W >= 1.  The other takes an even origin, even H and W
// >= 2 and 8-byte aligned tensors (most levels of every path), where the
// pair frame is the level's own: every test on the geometry below folds
// away at compile time, and the code is the even-origin kernel's.  Each
// comes again with SHARD, for a row shard (edges given): the even one for
// shards of whole strips (h a multiple of 32), where a strip's own rows
// take no test and the few beyond the shard are found with no loop or
// division (shard_edge_row), the general one for any shard (2-row shards
// too).  Without SHARD the code is the unsharded kernel's alone (but for
// the inverse's run-time test below).  The inverse also takes a whole
// level of whole strips as one shard, as its shard instance's strips
// take no row test: at [32, 512, 512] on an H100 (700 W; kernel_times.py)
// it ran 0.0272 ms alone, the unsharded instance 0.0311.
//
// A warp's task in the pair frame: tile task % tiles, strip (task / tiles)
// % strips, frame task / (tiles * strips); m0 the strip's first row pair,
// r0 = 2 m0 - pv its first (low-pass, possibly virtual) row, rr the rows
// r0 .. r0 + rr - 1 it covers (those below 0 are virtual), re = rr rounded
// up to whole row pairs, the rows it lifts; p the lane's column pair and
// c0 = 2p - pu its low column.  False for the spare warps of the last
// block.
struct Task {
  int frame, m0, r0, rr, re, lane, p, c0;
};

template <bool ODD>
__device__ __forceinline__ bool warp_task(int n, int h, int pu, int pv,
                                          int strips, int tiles, int left,
                                          Task* t) {
  const int64_t task =
      (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (task >= (int64_t)n * strips * tiles) return false;
  t->lane = threadIdx.x & 31;
  const int64_t fs = task / tiles;
  t->m0 = (int)(fs % strips) * (FWD_STRIP / 2);
  t->r0 = 2 * t->m0 - pv;
  t->frame = (int)(fs / strips);
  t->rr = min(FWD_STRIP, h - t->r0);
  t->re = ODD ? t->rr + (t->rr & 1) : t->rr;
  t->p = (int)(task % tiles) * PAIRS + t->lane - left;
  t->c0 = 2 * t->p - pu;
  return true;
}

// Band sizes of a level of n samples at origin parity o: low, high.
__device__ __forceinline__ int low_size(int n, int o) {
  return ((n + o + 1) >> 1) - o;
}
__device__ __forceinline__ int high_size(int n, int o) { return (n + o) >> 1; }

// x [n, h, w] at origin parity (pu, pv) -> ll [n, nly, nlx], hl [n, nly,
// nhx], lh [n, nhy, nlx], hh [n, nhy, nhx].  Register row j holds local row
// r0 - 2 + j of the lane's two columns (global parity j & 1).
template <bool ODD, bool SHARD>
__global__ void __launch_bounds__(THREADS)
dwt53_fwd_kernel(const int* __restrict__ x, const int* __restrict__ edges,
                 int sp, int rank, int e, int* __restrict__ ll,
                 int* __restrict__ hl, int* __restrict__ lh,
                 int* __restrict__ hh, int n, int h, int w, int upar,
                 int vpar, int strips, int tiles, int vec) {
  const int pu = ODD ? upar : 0, pv = ODD ? vpar : 0;
  Task t;
  if (!warp_task<ODD>(n, h, pu, pv, strips, tiles, 1, &t)) return;
  // the even shard instance takes shards of whole strips: rr = re = 32
  if (SHARD && !ODD) t.rr = t.re = FWD_STRIP;
  const int re = t.re;
  const int x0 = reflect<ODD>(t.c0, w), x1 = reflect<ODD>(t.c0 + 1, w);
  // vec: even origin and width, so x0 is even: one 8-byte load
  const bool pair = (!ODD || vec) && x1 == x0 + 1;

  int2 v[FWD_STRIP + 3];
#pragma unroll
  for (int j = 0; j < FWD_STRIP + 3; ++j) {
    if (j > re + 2) break;                     // rows r0 - 2 .. r0 + re
    const int g = t.r0 - FWD_ABOVE + j;
    // a whole strip's own rows need no test (the even shard instance)
    const int* row =
        SHARD && !ODD && j >= FWD_ABOVE && j < FWD_STRIP + FWD_ABOVE
            ? x + ((int64_t)t.frame * h + g) * w
            : shard_row<ODD, SHARD>(x, edges, sp, rank, e, n, t.frame, g, h,
                                    w);
    if (pair) {
      v[j] = *reinterpret_cast<const int2*>(row + x0);
    } else {
      v[j].x = row[x0];
      v[j].y = row[x1];
    }
  }
  if (!ODD || h > 1) {
    // vertical predict on odd rows r0-1 .. r0+re-1 (register rows 1, 3, ..)
#pragma unroll
    for (int j = 1; j < FWD_STRIP + 2; j += 2) {
      if (j > re + 1) break;
      v[j].x = predict_sub(v[j].x, v[j - 1].x, v[j + 1].x);
      v[j].y = predict_sub(v[j].y, v[j - 1].y, v[j + 1].y);
    }
    // vertical update on even rows r0 .. r0+re-2 (register rows 2, 4, ..)
#pragma unroll
    for (int j = 2; j < FWD_STRIP + 2; j += 2) {
      if (j > re) break;
      v[j].x = update_add(v[j].x, v[j - 1].x, v[j + 1].x);
      v[j].y = update_add(v[j].y, v[j - 1].y, v[j + 1].y);
    }
  } else if (pv) {                             // one high-pass row: doubled
#pragma unroll
    for (int j = 0; j < FWD_STRIP + 3; ++j) {
      if (j > re + 2) break;
      v[j].x = wadd(v[j].x, v[j].x);
      v[j].y = wadd(v[j].y, v[j].y);
    }
  }
  // horizontal lifting of each output row, then the stores: low rows to
  // LL | HL, high rows to LH | HH; low columns to LL | LH, high to HL | HH
  const int nlx = ODD ? low_size(w, pu) : w >> 1;
  const int nhx = ODD ? high_size(w, pu) : w >> 1;
  const bool live = t.lane >= 1 && t.lane <= PAIRS;
  const bool lo_ok = live && (ODD ? t.c0 >= 0 && t.c0 < w : t.p < nlx);
  const bool hi_ok = ODD ? live && t.c0 + 1 < w : lo_ok;
  // band offsets of row pair m0: low rows m0 - pv, high rows m0
  const int64_t lrow =
      (int64_t)t.frame * (ODD ? low_size(h, pv) : h >> 1) + t.m0 - pv;
  const int64_t hrow =
      (int64_t)t.frame * (ODD ? high_size(h, pv) : h >> 1) + t.m0;
  const int64_t ll0 = lrow * nlx + t.p - pu, hl0 = lrow * nhx + t.p;
  const int64_t lh0 = hrow * nlx + t.p - pu, hh0 = hrow * nhx + t.p;
#pragma unroll
  for (int k = 0; k < FWD_STRIP; ++k) {
    if (k >= t.rr) break;
    if (ODD && t.r0 + k < 0) continue;         // virtual row (warp-uniform)
    const int a = v[k + 2].x, b = v[k + 2].y;
    int s0, d;
    if (!ODD || w > 1) {
      const int next = __shfl_down_sync(0xffffffffu, a, 1);
      d = predict_sub(b, a, next);       // x[2p+1] -= (x[2p]+x[2p+2])/2
      const int prev = __shfl_up_sync(0xffffffffu, d, 1);
      s0 = update_add(a, prev, d);  // x[2p] += (d[p-1]+d[p]+2)/4
    } else {                                   // one column
      s0 = a;
      d = pu ? wadd(b, b) : b;
    }
    const int64_t o = k >> 1;
    if (k & 1) {
      if (lo_ok) lh[lh0 + o * nlx] = s0;
      if (hi_ok) hh[hh0 + o * nhx] = d;
    } else {
      if (lo_ok) ll[ll0 + o * nlx] = s0;
      if (hi_ok) hl[hl0 + o * nhx] = d;
    }
  }
}

// ll, hl, lh, hh (shapes as the forward kernel's) -> out [n, h, w] at
// origin parity (pu, pv).  Register row j holds interleaved local row
// r0 - 1 + j of the lane's two columns: a high-pass row when j is even.
template <bool ODD, bool SHARD>
__global__ void __launch_bounds__(THREADS)
dwt53_inv_kernel(const int* __restrict__ ll, const int* __restrict__ hl,
                 const int* __restrict__ lh, const int* __restrict__ hh,
                 const int* __restrict__ edges, int sp, int rank, int e,
                 int* __restrict__ out, int n, int h, int w, int upar,
                 int vpar, int strips, int tiles, int vec) {
  const int pu = ODD ? upar : 0, pv = ODD ? vpar : 0;
  Task t;
  if (!warp_task<ODD>(n, h, pu, pv, strips, tiles, 1, &t)) return;
  // the even shard instance takes shards of whole strips: rr = re = 32
  if (SHARD && !ODD) t.rr = t.re = FWD_STRIP;
  const int re = t.re;
  const int nlx = ODD ? low_size(w, pu) : w >> 1;
  const int nhx = ODD ? high_size(w, pu) : w >> 1;
  // the band columns of the lane's low and high samples: column c0 reflects
  // to a low (globally even) column, c0 + 1 to a high one; a 1-column
  // level has only the one its parity gives
  int ml = 0, mh = 0;
  bool rl = !pu, rh = pu;
  if (!ODD || w > 1) {
    ml = ((reflect<ODD>(t.c0, w) + pu) >> 1) - pu;
    mh = (reflect<ODD>(t.c0 + 1, w) + pu) >> 1;
    rl = rh = true;
  }
  const int nly = ODD ? low_size(h, pv) : h >> 1;
  const int nhy = ODD ? high_size(h, pv) : h >> 1;
  // the frame's first sample in each band (one offset at an even geometry)
  const int64_t bll = (int64_t)t.frame * nly * nlx;
  const int64_t bhl = (int64_t)t.frame * nly * nhx;
  const int64_t blh = (int64_t)t.frame * nhy * nlx;
  const int64_t bhh = (int64_t)t.frame * nhy * nhx;

  int2 v[INV_STRIP + HALO];
#pragma unroll
  for (int j = 0; j < INV_STRIP + HALO; ++j) {
    if (j > re + 2) break;                     // rows r0 - 1 .. r0 + re + 1
    int g = t.r0 - INV_ABOVE + j;
    // a whole strip's own rows need no test (the even shard instance)
    const bool own = SHARD && !ODD && j >= INV_ABOVE &&
                     j < INV_STRIP + INV_ABOVE;
    // the unsharded instances test `edges` (null for them) at run time
    // rather than at compile time: ptxas then keeps the even one at 109
    // registers without a spill, where the folded test left it at 96
    // registers and 12 bytes spilled, 3-8% slower on an H100
    // (kernel_times.py --ptxas, --dwt-only)
    const int* lo =
        (SHARD ? !own : edges != nullptr)
            ? shard_edge_row<ODD || !SHARD>(edges, sp, rank, e, n, t.frame,
                                            &g, h, w)
            : nullptr;
    const int* hi;
    if (lo) {
      hi = lo + nlx;
    } else {                                   // a shard's own row: in range
      const int r = (SHARD ? g : reflect<ODD>(g, h)) + pv;   // bit 0: parity
      const int m = (r >> 1) - ((r & 1) ? 0 : pv);   // its band row
      lo = ((r & 1) ? lh + blh : ll + bll) + (int64_t)m * nlx;
      hi = ((r & 1) ? hh + bhh : hl + bhl) + (int64_t)m * nhx;
    }
    v[j].x = rl ? lo[ml] : 0;
    v[j].y = rh ? hi[mh] : 0;
  }
  // rows first: undo the update on the even column with the previous
  // pair's raw detail, then the predict on the odd column with the next
  // pair's updated even sample
  if (!ODD || w > 1) {
#pragma unroll
    for (int j = 0; j < INV_STRIP + HALO; ++j) {
      if (j > re + 2) break;
      const int prev = __shfl_up_sync(0xffffffffu, v[j].y, 1);
      const int s0 = update_sub(v[j].x, prev, v[j].y);
      const int next = __shfl_down_sync(0xffffffffu, s0, 1);
      v[j].x = s0;
      v[j].y = predict_add(v[j].y, s0, next);
    }
  } else if (pu) {                             // one high-pass column
#pragma unroll
    for (int j = 0; j < INV_STRIP + HALO; ++j) {
      if (j > re + 2) break;
      v[j].y >>= 1;
    }
  }
  // then columns: undo the update on even rows r0 .. r0+re (register rows
  // 1, 3, ..), then the predict on odd rows r0+1 .. r0+re-1 (rows 2, 4, ..)
  if (!ODD || h > 1) {
#pragma unroll
    for (int j = 1; j < INV_STRIP + 2; j += 2) {
      if (j > re + 1) break;
      v[j].x = update_sub(v[j].x, v[j - 1].x, v[j + 1].x);
      v[j].y = update_sub(v[j].y, v[j - 1].y, v[j + 1].y);
    }
#pragma unroll
    for (int j = 2; j < INV_STRIP + 1; j += 2) {
      if (j > re) break;
      v[j].x = predict_add(v[j].x, v[j - 1].x, v[j + 1].x);
      v[j].y = predict_add(v[j].y, v[j - 1].y, v[j + 1].y);
    }
  } else if (pv) {                             // one high-pass row
#pragma unroll
    for (int j = 0; j < INV_STRIP + HALO; ++j) {
      if (j > re + 2) break;
      v[j].x >>= 1;
      v[j].y >>= 1;
    }
  }
  // rows r0 .. r0+rr-1 (register rows 1 .. rr), columns c0 and c0 + 1; at
  // an even origin and width (vec) as one 8-byte store
  if (t.lane < 1 || t.lane > PAIRS) return;
  if (!ODD) {
    if (t.p >= (w >> 1)) return;
    int2* o =
        reinterpret_cast<int2*>(out + ((int64_t)t.frame * h + t.r0) * w) + t.p;
#pragma unroll
    for (int k = 0; k < INV_STRIP; ++k) {
      if (k >= t.rr) break;
      o[(int64_t)k * (w >> 1)] = v[k + 1];
    }
    return;
  }
  const bool lo_ok = t.c0 >= 0 && t.c0 < w, hi_ok = t.c0 + 1 < w;
  if (vec && !hi_ok) return;
  const int64_t obase = ((int64_t)t.frame * h + t.r0) * w;
#pragma unroll
  for (int k = 0; k < INV_STRIP; ++k) {
    if (k >= t.rr) break;
    if (t.r0 + k < 0) continue;                // virtual row
    int* row = out + obase + (int64_t)k * w;
    if (vec) {
      reinterpret_cast<int2*>(row)[t.p] = v[k + 1];
    } else {
      if (lo_ok) row[t.c0] = v[k + 1].x;
      if (hi_ok) row[t.c0 + 1] = v[k + 1].y;
    }
  }
}

static unsigned blocks_for(int64_t tasks) {
  const int per_block = THREADS / 32;
  return (unsigned)((tasks + per_block - 1) / per_block);
}

// Warp tasks of a level: strips of FWD_STRIP (= INV_STRIP) rows in the
// pair frame, tiles of PAIRS column pairs.
static int64_t level_tasks(int n, int h, int w, int pu, int pv, int* strips,
                           int* tiles) {
  *strips = (h + pv + FWD_STRIP - 1) / FWD_STRIP;
  *tiles = (((w + pu + 1) >> 1) + PAIRS - 1) / PAIRS;
  return (int64_t)n * *strips * *tiles;
}

// The even instance's geometry: even origin, even H and W >= 2.
static bool even_level(int h, int w, int pu, int pv) {
  return !pu && !pv && !(h & 1) && !(w & 1) && h >= 2 && w >= 2;
}

static bool aligned8(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 7) == 0;
}

extern "C" {

int dwt53_fwd_strip_rows(void) { return FWD_STRIP; }
int dwt53_inv_strip_rows(void) { return INV_STRIP; }
int dwt53_halo_rows(void) { return HALO; }
int dwt53_fwd_above(void) { return FWD_ABOVE; }
int dwt53_inv_above(void) { return INV_ABOVE; }

// pu, pv: the level origin's parity (u0 & 1, v0 & 1)
// edges [sp, n, e, w] (null: one shard); x is shard `rank` of sp
int dwt53_fwd_level(const void* x, const void* edges, int sp, int rank, int e,
                    void* ll, void* hl, void* lh, void* hh, int n, int h,
                    int w, int pu, int pv, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  int strips, tiles;
  const int64_t tasks = level_tasks(n, h, w, pu, pv, &strips, &tiles);
  const int vec = !pu && !(w & 1) && aligned8(x, edges, edges);
  const bool fast = even_level(h, w, pu, pv) && vec &&
                    (!edges || h % FWD_STRIP == 0);
  auto* kernel = edges ? (fast ? dwt53_fwd_kernel<false, true>
                               : dwt53_fwd_kernel<true, true>)
                       : (fast ? dwt53_fwd_kernel<false, false>
                               : dwt53_fwd_kernel<true, false>);
  kernel<<<blocks_for(tasks), THREADS, 0, (cudaStream_t)stream>>>(
    (const int*)x, (const int*)edges, sp, rank, e, (int*)ll, (int*)hl,
    (int*)lh, (int*)hh, n, h, w, pu, pv, strips, tiles, vec);
  return (int)cudaGetLastError();
}

int dwt53_inv_level(const void* ll, const void* hl, const void* lh,
                    const void* hh, const void* edges, int sp, int rank,
                    int e, void* out, int n, int h, int w, int pu, int pv,
                    void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  int strips, tiles;
  const int64_t tasks = level_tasks(n, h, w, pu, pv, &strips, &tiles);
  const int vec = !pu && !(w & 1) && aligned8(out, out, out);
  const bool fast = even_level(h, w, pu, pv) && vec &&
                    (!edges || h % FWD_STRIP == 0);
  // a whole signal of whole strips is one shard (sp = 1: its rows beyond
  // it are its own, reflected once): the shard instance, which tests no
  // row of a strip, takes it faster than the unsharded one
  const bool shard = edges || (fast && h % FWD_STRIP == 0);
  auto* kernel = shard ? (fast ? dwt53_inv_kernel<false, true>
                               : dwt53_inv_kernel<true, true>)
                       : (fast ? dwt53_inv_kernel<false, false>
                               : dwt53_inv_kernel<true, false>);
  kernel<<<blocks_for(tasks), THREADS, 0, (cudaStream_t)stream>>>(
    (const int*)ll, (const int*)hl, (const int*)lh, (const int*)hh,
    (const int*)edges, sp, rank, e, (int*)out, n, h, w, pu, pv, strips,
    tiles, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
