// One 2-D level of the irreversible 9/7 lifting DWT (ISO/IEC 15444-1 Annex F),
// forward and inverse, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   dwt97_fwd_level  <- go_jpeg2000_tpu/ops/dwt_pallas.py _dwt97_level_kernel
//                       (plus the strided deinterleave XLA ran after it,
//                       dwt_pallas.py _level_fn)
//   dwt97_inv_level  <- go_jpeg2000_tpu/ops/dwt_pallas.py _idwt97_level_kernel
//                       (plus the band interleave before it,
//                       dwt_pallas.py _interleave_bands)
// The plain torch version is go_jpeg2000_tpu_torch/ops/dwt.py; the Python
// wrapper, build and launch counts are in ops/dwt_cuda.py.
//
// Bound: memory.  A level reads and writes each float32 sample once, 8 bytes
// per sample, with four lifting steps and a scaling per axis in between
// (about 30 flops per sample), far below the card's flop rate.
//
// Design (both directions): a warp per (frame, strip of STRIP output rows,
// tile of PAIRS output column pairs), no shared memory, no barrier and no
// division in a loop, in the pair frame of csrc/dwt53.cu: the level's
// origin may have either parity (pu = u0 & 1, pv = v0 & 1); column pair q
// holds local columns 2q - pu (globally even, low-pass) and 2q - pu + 1
// (high-pass), band columns q - pu and q, rows the same way with pv, and a
// strip starts at local row 32s - pv, on a low-pass row.  Lane l holds
// column pair p = PAIRS * tile + l - 2; pairs and rows off the level read
// their samples through the whole-sample symmetric extension, which keeps
// a sample's global parity, so lifting the extended signal gives the
// extension of the lifted signal exactly (the stencils are symmetric);
// they are lifted and never stored.  The parity then decides nothing
// inside the lifting: alpha and gamma always lift the odd (high-pass)
// samples, beta and delta the even ones, the forward scales even samples
// by 1/K and odd ones by K, the inverse the reverse.  Each lane loads all
// its rows into registers before it computes any, so every load of the
// strip is in flight at once, lifts its two columns vertically in
// registers, and lifts each row horizontally with four warp shuffles: each
// step reaches one pair, alternately right (alpha, gamma: the next pair's
// even sample) and left (beta, delta: the previous pair's odd sample).  A
// lane's value is then right where every step's neighbours were: lanes
// 0..30 after the first step, 1..30, 1..29, and 2..29 after the fourth, so
// lanes 0-1 and 30-31 are halo pairs and lanes 2..29 store.  Reads beyond
// the ideal: 7 rows per STRIP and 4 pairs per 32, most of them hits in L2.
// A 1-sample axis passes through at either parity, unlifted and unscaled,
// as ops/dwt.py's _forward_1d_97 and _inverse_1d_97 do.
//
// The vertical halo is 7 rows.  Forward, for output rows [r0, r0 + rr),
// r0 globally even and rr rounded up to whole row pairs:
//   delta (even rows r0 .. r0+rr-2)  needs gamma rows r0-1 .. r0+rr-1,
//   gamma (odd rows r0-1 .. r0+rr-1) needs beta  rows r0-2 .. r0+rr,
//   beta  (even rows r0-2 .. r0+rr)  needs alpha rows r0-3 .. r0+rr+1,
//   alpha (odd rows r0-3 .. r0+rr+1) needs input rows r0-4 .. r0+rr+2,
// so 4 rows above and 3 below.  The inverse (2D_SR: rows first, then
// columns) runs the steps the other way round (delta on even, gamma on odd,
// beta on even, alpha on odd) for output rows r0 .. r0+rr-1 and needs
// interleaved rows r0-3 .. r0+rr+3: 3 above and 4 below.
//
// Exactness: every step is written with __fadd_rn/__fsub_rn/__fmul_rn in the
// plain version's order, c + ALPHA * (l + r), so nvcc cannot contract it into
// an FMA and each op is rounded once, as torch rounds it.  The constants are
// the float32 roundings of the doubles, and the scalings use the float32
// rounding of the double 1.0 / K, as torch's `x * (1.0 / K)` does.  The
// kernels then equal the plain version bit for bit.
//
// Row shards (the halo form; replaces the row-shard lifting of
// go_jpeg2000_tpu/parallel/sharded.py, _odd_update_sharded,
// _even_update_sharded, _vlift97_sharded, _vlift97_inverse_sharded): as in
// csrc/dwt53.cu, x (for the inverse, the bands) may be row shard `rank` of
// sp shards of one signal, and `edges` [sp, n, e, w] holds every shard's
// edge slot (for the inverse, interleaved rows with the low-pass half
// first), packed by csrc/dwt_edges.cu and exchanged once per level; a warp
// reads each row its strip reaches past the shard through edge_row
// (csrc/dwt_edges.cuh).  The lifting reaches 4 rows, so a 2-row shard
// reads shards beyond its neighbours, and the reflection at a global edge
// is taken over the whole signal.  A null `edges` is one shard.

// Geometry: any origin parity and any H, W >= 1 without edges; a row shard
// at an even origin and an even H >= 2, any W >= 1 (ops/dwt_cuda.py checks).
// Kernels launch on the caller's stream, allocate nothing, launch nothing
// for an empty level, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dwt_edges.cuh"

#define FWD_STRIP 32      // forward: output rows per warp (even)
#define INV_STRIP 32      // inverse: output rows per warp (even)
#define PAIRS 28          // output column pairs per warp (lanes 2 .. 29)
#define HALO 7            // forward: 4 rows above, 3 below; inverse: 3, 4
#define FWD_ABOVE 4
#define INV_ABOVE 3
#define THREADS 128
// CTAs an SM must hold, as ptxas' register target, of the shard kernels:
// the unsharded even ones' occupancy (forward 96 registers, 5 CTAs;
// inverse 114, 4), which their shard bodies exceed without it (142 and
// 134 registers; the unsharded kernels take no such hint, which ptxas
// would follow at the cost of their own choice)
#define FWD_SHARD_BLOCKS 5
#define INV_SHARD_BLOCKS 4
static_assert(FWD_STRIP == INV_STRIP, "warp_task lays out one strip height");

#define ALPHA_D -1.586134342059924
#define BETA_D -0.052980118572961
#define GAMMA_D 0.882911075530934
#define DELTA_D 0.443506852043971
#define K_D 1.230174104914001

__device__ __constant__ float kAlpha = (float)ALPHA_D;
__device__ __constant__ float kBeta = (float)BETA_D;
__device__ __constant__ float kGamma = (float)GAMMA_D;
__device__ __constant__ float kDelta = (float)DELTA_D;
__device__ __constant__ float kK = (float)K_D;
__device__ __constant__ float kInvK = (float)(1.0 / K_D);

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

// Row g (-FWD_ABOVE <= g < h + HALO - FWD_ABOVE) of a level of h rows in
// a frame of n: with SHARD, x is row shard `rank` of sp, and a row outside
// it is the row of the globally extended signal (shard_edge_row; GENERAL =
// ODD takes any shard height, the even instance shards of at least
// 2 * EDGE_ROWS rows); else x is the whole signal, reflected.
template <bool ODD, bool SHARD>
__device__ __forceinline__ const float* shard_row(const float* x,
                                              const float* edges, int sp,
                                              int rank, int e, int n,
                                              int frame, int g, int h,
                                              int w) {
  if (SHARD) {
    const float* row =
        shard_edge_row<ODD>(edges, sp, rank, e, n, frame, &g, h, w);
    return row ? row : x + ((int64_t)frame * h + g) * w;
  }
  return x + ((int64_t)frame * h + reflect<ODD>(g, h)) * w;
}

// c + k * (l + r), each op rounded once
__device__ __forceinline__ float lift_add(float c, float k, float l, float r) {
  return __fadd_rn(c, __fmul_rn(k, __fadd_rn(l, r)));
}

// c - k * (l + r), each op rounded once
__device__ __forceinline__ float lift_sub(float c, float k, float l, float r) {
  return __fsub_rn(c, __fmul_rn(k, __fadd_rn(l, r)));
}

// The next lane's even sample and the previous lane's odd sample.
__device__ __forceinline__ float next_a(float a) {
  return __shfl_down_sync(0xffffffffu, a, 1);
}
__device__ __forceinline__ float prev_b(float b) {
  return __shfl_up_sync(0xffffffffu, b, 1);
}

// Each kernel comes in two instances, as in csrc/dwt53.cu: ODD, the
// general one (any origin parity, any H and W >= 1), and one for an even
// origin, even H and W >= 2 and 8-byte aligned tensors, where every test
// on the geometry folds away at compile time; each again with SHARD for a
// row shard (the even one for shards of whole strips, h a multiple of 32,
// the general one for any), so the unsharded kernels carry no shard code.
//
// A warp's task in the pair frame (as in csrc/dwt53.cu): tile task %
// tiles, strip (task / tiles) % strips, frame task / (tiles * strips); m0
// the strip's first row pair, r0 = 2 m0 - pv its first (low-pass, possibly
// virtual) row, rr the rows r0 .. r0 + rr - 1 it covers (those below 0 are
// virtual), re = rr rounded up to whole row pairs, the rows it lifts; p
// the lane's column pair and c0 = 2p - pu its low column.  False for the
// spare warps of the last block.
struct Task {
  int frame, m0, r0, rr, re, lane, p, c0;
};

template <bool ODD>
__device__ __forceinline__ bool warp_task(int n, int h, int pu, int pv,
                                          int strips, int tiles, Task* t) {
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
  t->p = (int)(task % tiles) * PAIRS + t->lane - 2;
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
// r0 - 4 + j of the lane's two columns (S + 7 rows; global parity j & 1).
template <bool ODD, bool SHARD>
__device__ __forceinline__ void
dwt97_fwd_body(const float* __restrict__ x, const float* __restrict__ edges,
               int sp, int rank, int e, float* __restrict__ ll,
               float* __restrict__ hl, float* __restrict__ lh,
               float* __restrict__ hh, int n, int h, int w, int upar,
               int vpar, int strips, int tiles, int vec) {
  const int pu = ODD ? upar : 0, pv = ODD ? vpar : 0;
  Task t;
  if (!warp_task<ODD>(n, h, pu, pv, strips, tiles, &t)) return;
  // the even shard instance takes shards of whole strips: rr = re = 32
  if (SHARD && !ODD) t.rr = t.re = FWD_STRIP;
  const int re = t.re;
  const int x0 = reflect<ODD>(t.c0, w), x1 = reflect<ODD>(t.c0 + 1, w);
  // vec: even origin and width, so x0 is even: one 8-byte load
  const bool pair = (!ODD || vec) && x1 == x0 + 1;

  float2 v[FWD_STRIP + HALO];
#pragma unroll
  for (int j = 0; j < FWD_STRIP + HALO; ++j) {
    if (j > re + 6) break;                     // rows r0 - 4 .. r0 + re + 2
    const int g = t.r0 - FWD_ABOVE + j;
    // a whole strip's own rows need no test (the even shard instance)
    const float* row =
        SHARD && !ODD && j >= FWD_ABOVE && j < FWD_STRIP + FWD_ABOVE
            ? x + ((int64_t)t.frame * h + g) * w
            : shard_row<ODD, SHARD>(x, edges, sp, rank, e, n, t.frame, g, h,
                                    w);
    if (pair) {
      v[j] = *reinterpret_cast<const float2*>(row + x0);
    } else {
      v[j].x = row[x0];
      v[j].y = row[x1];
    }
  }
  // vertical lifting (a 1-row level has none): alpha on odd rows r0-3 ..
  // r0+re+1 (register rows 1, 3, ..), beta on even rows r0-2 .. r0+re,
  // gamma on odd rows r0-1 .. r0+re-1, delta on even rows r0 .. r0+re-2
  if (!ODD || h > 1) {
#pragma unroll
    for (int j = 1; j < FWD_STRIP + 6; j += 2) {
      if (j > re + 5) break;
      v[j].x = lift_add(v[j].x, kAlpha, v[j - 1].x, v[j + 1].x);
      v[j].y = lift_add(v[j].y, kAlpha, v[j - 1].y, v[j + 1].y);
    }
#pragma unroll
    for (int j = 2; j < FWD_STRIP + 5; j += 2) {
      if (j > re + 4) break;
      v[j].x = lift_add(v[j].x, kBeta, v[j - 1].x, v[j + 1].x);
      v[j].y = lift_add(v[j].y, kBeta, v[j - 1].y, v[j + 1].y);
    }
#pragma unroll
    for (int j = 3; j < FWD_STRIP + 4; j += 2) {
      if (j > re + 3) break;
      v[j].x = lift_add(v[j].x, kGamma, v[j - 1].x, v[j + 1].x);
      v[j].y = lift_add(v[j].y, kGamma, v[j - 1].y, v[j + 1].y);
    }
#pragma unroll
    for (int j = 4; j < FWD_STRIP + 3; j += 2) {
      if (j > re + 2) break;
      v[j].x = lift_add(v[j].x, kDelta, v[j - 1].x, v[j + 1].x);
      v[j].y = lift_add(v[j].y, kDelta, v[j - 1].y, v[j + 1].y);
    }
  }
  // per output row: the vertical scaling (even rows x 1/K, odd rows x K),
  // the horizontal lifting (2D_SD: columns, then rows), and the stores with
  // the horizontal scaling: low rows to LL | HL, high rows to LH | HH; low
  // columns (x 1/K) to LL | LH, high columns (x K) to HL | HH.  A 1-sample
  // axis is neither lifted nor scaled.
  const int nlx = ODD ? low_size(w, pu) : w >> 1;
  const int nhx = ODD ? high_size(w, pu) : w >> 1;
  const bool live = t.lane >= 2 && t.lane < 2 + PAIRS;
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
    float a = v[k + 4].x, b = v[k + 4].y;
    if (!ODD || h > 1) {
      const float s = (k & 1) ? kK : kInvK;
      a = __fmul_rn(a, s);
      b = __fmul_rn(b, s);
    }
    float lo = a, hi = b;
    if (!ODD || w > 1) {
      b = lift_add(b, kAlpha, a, next_a(a));   // x[2p+1] += a(x[2p]+x[2p+2])
      a = lift_add(a, kBeta, prev_b(b), b);    // x[2p] += b(x[2p-1]+x[2p+1])
      b = lift_add(b, kGamma, a, next_a(a));
      a = lift_add(a, kDelta, prev_b(b), b);
      lo = __fmul_rn(a, kInvK);
      hi = __fmul_rn(b, kK);
    }
    const int64_t o = k >> 1;
    if (k & 1) {
      if (lo_ok) lh[lh0 + o * nlx] = lo;
      if (hi_ok) hh[hh0 + o * nhx] = hi;
    } else {
      if (lo_ok) ll[ll0 + o * nlx] = lo;
      if (hi_ok) hl[hl0 + o * nhx] = hi;
    }
  }
}

// ll, hl, lh, hh (shapes as the forward kernel's) -> out [n, h, w] at
// origin parity (pu, pv).  Register row j holds interleaved local row
// r0 - 3 + j of the lane's two columns (S + 7 rows): a high-pass row when
// j is even.
template <bool ODD, bool SHARD>
__device__ __forceinline__ void
dwt97_inv_body(const float* __restrict__ ll, const float* __restrict__ hl,
               const float* __restrict__ lh, const float* __restrict__ hh,
               const float* __restrict__ edges, int sp, int rank, int e,
               float* __restrict__ out, int n, int h, int w, int upar,
               int vpar, int strips, int tiles, int vec) {
  const int pu = ODD ? upar : 0, pv = ODD ? vpar : 0;
  Task t;
  if (!warp_task<ODD>(n, h, pu, pv, strips, tiles, &t)) return;
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

  // every row's loads first, with nothing that waits for them in between
  float2 v[INV_STRIP + HALO];
#pragma unroll
  for (int j = 0; j < INV_STRIP + HALO; ++j) {
    if (j > re + 6) break;                     // rows r0 - 3 .. r0 + re + 3
    int g = t.r0 - INV_ABOVE + j;
    // a whole strip's own rows need no test (the even shard instance)
    const bool own = SHARD && !ODD && j >= INV_ABOVE &&
                     j < INV_STRIP + INV_ABOVE;
    const float* lo =
        SHARD && !own
            ? shard_edge_row<ODD>(edges, sp, rank, e, n, t.frame, &g, h, w)
            : nullptr;
    const float* hi;
    if (lo) {
      hi = lo + nlx;
    } else {                                   // a shard's own row: in range
      const int r = (SHARD ? g : reflect<ODD>(g, h)) + pv;   // bit 0: parity
      const int m = (r >> 1) - ((r & 1) ? 0 : pv);   // its band row
      lo = ((r & 1) ? lh + blh : ll + bll) + (int64_t)m * nlx;
      hi = ((r & 1) ? hh + bhh : hl + bhl) + (int64_t)m * nhx;
    }
    v[j].x = rl ? lo[ml] : 0.0f;
    v[j].y = rh ? hi[mh] : 0.0f;
  }
  // 2D_SR: rows first: the horizontal scaling (even column x K, odd x
  // 1/K), four shuffles, then the vertical scaling (register row 0 is odd:
  // even j x 1/K, odd j x K); a 1-sample axis is neither lifted nor scaled
#pragma unroll
  for (int j = 0; j < INV_STRIP + HALO; ++j) {
    if (j > re + 6) break;
    float a = v[j].x, b = v[j].y;
    if (!ODD || w > 1) {
      a = __fmul_rn(a, kK);
      b = __fmul_rn(b, kInvK);
      a = lift_sub(a, kDelta, prev_b(b), b);
      b = lift_sub(b, kGamma, a, next_a(a));
      a = lift_sub(a, kBeta, prev_b(b), b);
      b = lift_sub(b, kAlpha, a, next_a(a));
    }
    if (!ODD || h > 1) {
      const float s = (j & 1) ? kK : kInvK;
      a = __fmul_rn(a, s);
      b = __fmul_rn(b, s);
    }
    v[j].x = a;
    v[j].y = b;
  }
  // then columns: delta on even rows r0-2 .. r0+re+2 (register rows 1, 3,
  // ..), gamma on odd rows r0-1 .. r0+re+1, beta on even rows r0 .. r0+re,
  // alpha on odd rows r0+1 .. r0+re-1
  if (!ODD || h > 1) {
#pragma unroll
    for (int j = 1; j < INV_STRIP + 6; j += 2) {
      if (j > re + 5) break;
      v[j].x = lift_sub(v[j].x, kDelta, v[j - 1].x, v[j + 1].x);
      v[j].y = lift_sub(v[j].y, kDelta, v[j - 1].y, v[j + 1].y);
    }
#pragma unroll
    for (int j = 2; j < INV_STRIP + 5; j += 2) {
      if (j > re + 4) break;
      v[j].x = lift_sub(v[j].x, kGamma, v[j - 1].x, v[j + 1].x);
      v[j].y = lift_sub(v[j].y, kGamma, v[j - 1].y, v[j + 1].y);
    }
#pragma unroll
    for (int j = 3; j < INV_STRIP + 4; j += 2) {
      if (j > re + 3) break;
      v[j].x = lift_sub(v[j].x, kBeta, v[j - 1].x, v[j + 1].x);
      v[j].y = lift_sub(v[j].y, kBeta, v[j - 1].y, v[j + 1].y);
    }
#pragma unroll
    for (int j = 4; j < INV_STRIP + 3; j += 2) {
      if (j > re + 2) break;
      v[j].x = lift_sub(v[j].x, kAlpha, v[j - 1].x, v[j + 1].x);
      v[j].y = lift_sub(v[j].y, kAlpha, v[j - 1].y, v[j + 1].y);
    }
  }
  // rows r0 .. r0+rr-1 (register rows 3 .. rr+2), columns c0 and c0 + 1; at
  // an even origin and width (vec) as one 8-byte store
  if (t.lane < 2 || t.lane >= 2 + PAIRS) return;
  if (!ODD) {
    if (t.p >= (w >> 1)) return;
    float2* o = reinterpret_cast<float2*>(
                    out + ((int64_t)t.frame * h + t.r0) * w) + t.p;
#pragma unroll
    for (int k = 0; k < INV_STRIP; ++k) {
      if (k >= t.rr) break;
      o[(int64_t)k * (w >> 1)] = v[k + 3];
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
    float* row = out + obase + (int64_t)k * w;
    if (vec) {
      reinterpret_cast<float2*>(row)[t.p] = v[k + 3];
    } else {
      if (lo_ok) row[t.c0] = v[k + 3].x;
      if (hi_ok) row[t.c0 + 1] = v[k + 3].y;
    }
  }
}

// The kernels: the unsharded ones with ptxas' own register choice, the
// shard ones with FWD_SHARD_BLOCKS and INV_SHARD_BLOCKS as its target.
// One template with a template-dependent bound, SHARD ? blocks : 1, is no
// substitute: a bound of 1 CTA moves ptxas' choice for the unsharded
// instances (even forward 96 -> 101 registers, 0.0143 -> 0.0189 ms alone
// at [16, 512, 512] on an H100; kernel_times.py --ptxas).
#define FWD_PARAMS                                                          \
  const float *__restrict__ x, const float *__restrict__ edges, int sp,    \
      int rank, int e, float *__restrict__ ll, float *__restrict__ hl,     \
      float *__restrict__ lh, float *__restrict__ hh, int n, int h, int w,  \
      int upar, int vpar, int strips, int tiles, int vec
#define FWD_ARGS                                                            \
  x, edges, sp, rank, e, ll, hl, lh, hh, n, h, w, upar, vpar, strips,      \
      tiles, vec
#define INV_PARAMS                                                          \
  const float *__restrict__ ll, const float *__restrict__ hl,              \
      const float *__restrict__ lh, const float *__restrict__ hh,          \
      const float *__restrict__ edges, int sp, int rank, int e,            \
      float *__restrict__ out, int n, int h, int w, int upar, int vpar,    \
      int strips, int tiles, int vec
#define INV_ARGS                                                            \
  ll, hl, lh, hh, edges, sp, rank, e, out, n, h, w, upar, vpar, strips,    \
      tiles, vec

template <bool ODD>
__global__ void __launch_bounds__(THREADS) dwt97_fwd_kernel(FWD_PARAMS) {
  dwt97_fwd_body<ODD, false>(FWD_ARGS);
}
template <bool ODD>
__global__ void __launch_bounds__(THREADS, FWD_SHARD_BLOCKS)
    dwt97_fwd_shard_kernel(FWD_PARAMS) {
  dwt97_fwd_body<ODD, true>(FWD_ARGS);
}
template <bool ODD>
__global__ void __launch_bounds__(THREADS) dwt97_inv_kernel(INV_PARAMS) {
  dwt97_inv_body<ODD, false>(INV_ARGS);
}
template <bool ODD>
__global__ void __launch_bounds__(THREADS, INV_SHARD_BLOCKS)
    dwt97_inv_shard_kernel(INV_PARAMS) {
  dwt97_inv_body<ODD, true>(INV_ARGS);
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

int dwt97_fwd_strip_rows(void) { return FWD_STRIP; }
int dwt97_inv_strip_rows(void) { return INV_STRIP; }
int dwt97_halo_rows(void) { return HALO; }
int dwt97_fwd_above(void) { return FWD_ABOVE; }
int dwt97_inv_above(void) { return INV_ABOVE; }

// pu, pv: the level origin's parity (u0 & 1, v0 & 1)
// edges [sp, n, e, w] (null: one shard); x is shard `rank` of sp
int dwt97_fwd_level(const void* x, const void* edges, int sp, int rank, int e,
                    void* ll, void* hl, void* lh, void* hh, int n, int h,
                    int w, int pu, int pv, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  int strips, tiles;
  const int64_t tasks = level_tasks(n, h, w, pu, pv, &strips, &tiles);
  const int vec = !pu && !(w & 1) && aligned8(x, edges, edges);
  const bool fast = even_level(h, w, pu, pv) && vec &&
                    (!edges || h % FWD_STRIP == 0);
  auto* kernel = edges ? (fast ? dwt97_fwd_shard_kernel<false>
                               : dwt97_fwd_shard_kernel<true>)
                       : (fast ? dwt97_fwd_kernel<false>
                               : dwt97_fwd_kernel<true>);
  kernel<<<blocks_for(tasks), THREADS, 0, (cudaStream_t)stream>>>(
    (const float*)x, (const float*)edges, sp, rank, e, (float*)ll,
    (float*)hl, (float*)lh, (float*)hh, n, h, w, pu, pv, strips, tiles,
    vec);
  return (int)cudaGetLastError();
}

int dwt97_inv_level(const void* ll, const void* hl, const void* lh,
                    const void* hh, const void* edges, int sp, int rank,
                    int e, void* out, int n, int h, int w, int pu, int pv,
                    void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  int strips, tiles;
  const int64_t tasks = level_tasks(n, h, w, pu, pv, &strips, &tiles);
  const int vec = !pu && !(w & 1) && aligned8(out, out, out);
  const bool fast = even_level(h, w, pu, pv) && vec &&
                    (!edges || h % FWD_STRIP == 0);
  auto* kernel = edges ? (fast ? dwt97_inv_shard_kernel<false>
                               : dwt97_inv_shard_kernel<true>)
                       : (fast ? dwt97_inv_kernel<false>
                               : dwt97_inv_kernel<true>);
  kernel<<<blocks_for(tasks), THREADS, 0, (cudaStream_t)stream>>>(
    (const float*)ll, (const float*)hl, (const float*)lh, (const float*)hh,
    (const float*)edges, sp, rank, e, (float*)out, n, h, w, pu, pv,
    strips, tiles, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
