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
// division in a loop.  Lane l holds column pair p = PAIRS * tile + l - 2,
// that is columns 2p and 2p + 1; pairs off the frame read their columns
// through the whole-sample symmetric extension, which keeps a column's
// parity, so lifting the extended signal gives the extension of the lifted
// signal exactly (the stencils are symmetric).  Each lane loads all its rows
// into registers before it computes any, so every load of the strip is in
// flight at once, lifts its two columns vertically in registers, and lifts
// each row horizontally with four warp shuffles: each step reaches one pair,
// alternately right (alpha, gamma: the next pair's even sample) and left
// (beta, delta: the previous pair's odd sample).  A lane's value is then
// right where every step's neighbours were: lanes 0..30 after the first
// step, 1..30, 1..29, and 2..29 after the fourth, so lanes 0-1 and 30-31
// are halo pairs and lanes 2..29 store.  Reads beyond the ideal: 7 rows per
// STRIP and 4 pairs per 32, most of them hits in L2.  Any even width takes
// the kernels.
//
// The vertical halo is 7 rows.  Forward, for output rows [r0, r0 + rr),
// r0 even:
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
// csrc/dwt53.cu, x may be one row shard, and `above` [n, 4 (inverse 3), w]
// and `below` [n, 3 (inverse 4), w] are the rows of the globally extended
// signal just outside it (for the inverse, interleaved rows with the
// low-pass half first), built once per level from every shard's edge rows.
// A null pointer is a global edge, where the shard reflects on itself.  The
// lifting reaches 4 rows, so a 2-row shard takes rows of shards beyond its
// neighbours; the halo brings them, already reflected at the global edges.
//
// Geometry: even origin, even H and W (>= 2) at this level; other levels
// take the plain version.  Kernels launch on the caller's stream, allocate
// nothing, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define FWD_STRIP 32      // forward: output rows per warp (even)
#define INV_STRIP 32      // inverse: output rows per warp (even)
#define PAIRS 28          // output column pairs per warp (lanes 2 .. 29)
#define HALO 7            // forward: 4 rows above, 3 below; inverse: 3, 4
#define FWD_ABOVE 4
#define INV_ABOVE 3
#define THREADS 128

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

__device__ __forceinline__ int reflect(int i, int n) {
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// Row g (-ha <= g < h + hb) of a shard of h rows in a frame: from the halo
// above or below where one is given, else the shard's own row (reflected).
__device__ __forceinline__ const float* shard_row(const float* x,
                                                  const float* above,
                                                  const float* below,
                                                  int frame, int g, int h,
                                                  int w, int ha, int hb) {
  if (g < 0 && above) return above + ((int64_t)frame * ha + ha + g) * w;
  if (g >= h && below) return below + ((int64_t)frame * hb + g - h) * w;
  return x + ((int64_t)frame * h + reflect(g, h)) * w;
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

// The warp's task: tile task % tiles, strip (task / tiles) % strips, frame
// task / (tiles * strips).  False for the spare warps of the last block.
struct Task {
  int frame, r0, rr, p, lane;
};

__device__ __forceinline__ bool warp_task(int n, int h, int strips,
                                          int tiles, int strip, Task* t) {
  const int64_t task =
      (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (task >= (int64_t)n * strips * tiles) return false;
  t->lane = threadIdx.x & 31;
  const int64_t fs = task / tiles;
  t->r0 = (int)(fs % strips) * strip;
  t->frame = (int)(fs / strips);
  t->rr = min(strip, h - t->r0);               // even: h and r0 are even
  t->p = (int)(task % tiles) * PAIRS + t->lane - 2;
  return true;
}

// x [n, h, w] -> ll, hl, lh, hh [n, h/2, w/2].  Register row j holds input
// row r0 - 4 + j of the lane's two columns (S + 7 rows).
__global__ void __launch_bounds__(THREADS)
dwt97_fwd_kernel(const float* __restrict__ x, const float* __restrict__ above,
                 const float* __restrict__ below, float* __restrict__ ll,
                 float* __restrict__ hl, float* __restrict__ lh,
                 float* __restrict__ hh, int n, int h, int w, int strips,
                 int tiles, int vec) {
  Task t;
  if (!warp_task(n, h, strips, tiles, FWD_STRIP, &t)) return;  // whole warps
  const int rr = t.rr;
  const int w2 = w >> 1;
  const int c0 = reflect(2 * t.p, w), c1 = reflect(2 * t.p + 1, w);
  const bool pair = vec && c1 == c0 + 1;       // c0 even: one 8-byte load

  float2 v[FWD_STRIP + HALO];
#pragma unroll
  for (int j = 0; j < FWD_STRIP + HALO; ++j) {
    if (j > rr + 6) break;                     // rows r0 - 4 .. r0 + rr + 2
    const float* row = shard_row(x, above, below, t.frame,
                                 t.r0 - FWD_ABOVE + j, h, w, FWD_ABOVE,
                                 HALO - FWD_ABOVE);
    if (pair) {
      v[j] = *reinterpret_cast<const float2*>(row + c0);
    } else {
      v[j].x = row[c0];
      v[j].y = row[c1];
    }
  }
  // vertical lifting: alpha on odd rows r0-3 .. r0+rr+1 (register rows 1,
  // 3, ..), beta on even rows r0-2 .. r0+rr, gamma on odd rows r0-1 ..
  // r0+rr-1, delta on even rows r0 .. r0+rr-2
#pragma unroll
  for (int j = 1; j < FWD_STRIP + 6; j += 2) {
    if (j > rr + 5) break;
    v[j].x = lift_add(v[j].x, kAlpha, v[j - 1].x, v[j + 1].x);
    v[j].y = lift_add(v[j].y, kAlpha, v[j - 1].y, v[j + 1].y);
  }
#pragma unroll
  for (int j = 2; j < FWD_STRIP + 5; j += 2) {
    if (j > rr + 4) break;
    v[j].x = lift_add(v[j].x, kBeta, v[j - 1].x, v[j + 1].x);
    v[j].y = lift_add(v[j].y, kBeta, v[j - 1].y, v[j + 1].y);
  }
#pragma unroll
  for (int j = 3; j < FWD_STRIP + 4; j += 2) {
    if (j > rr + 3) break;
    v[j].x = lift_add(v[j].x, kGamma, v[j - 1].x, v[j + 1].x);
    v[j].y = lift_add(v[j].y, kGamma, v[j - 1].y, v[j + 1].y);
  }
#pragma unroll
  for (int j = 4; j < FWD_STRIP + 3; j += 2) {
    if (j > rr + 2) break;
    v[j].x = lift_add(v[j].x, kDelta, v[j - 1].x, v[j + 1].x);
    v[j].y = lift_add(v[j].y, kDelta, v[j - 1].y, v[j + 1].y);
  }
  // per output row: the vertical scaling (even rows x 1/K, odd rows x K),
  // the horizontal lifting (2D_SD: columns, then rows), and the stores with
  // the horizontal scaling: even rows to LL | HL, odd rows to LH | HH; even
  // columns low (x 1/K), odd columns high (x K)
  const bool out = t.lane >= 2 && t.lane < 2 + PAIRS && t.p < w2;
  const int64_t obase =
      ((int64_t)t.frame * (h >> 1) + (t.r0 >> 1)) * w2 + t.p;
#pragma unroll
  for (int k = 0; k < FWD_STRIP; ++k) {
    if (k >= rr) break;
    const float s = (k & 1) ? kK : kInvK;
    float a = __fmul_rn(v[k + 4].x, s), b = __fmul_rn(v[k + 4].y, s);
    b = lift_add(b, kAlpha, a, next_a(a));     // x[2p+1] += a(x[2p]+x[2p+2])
    a = lift_add(a, kBeta, prev_b(b), b);      // x[2p] += b(x[2p-1]+x[2p+1])
    b = lift_add(b, kGamma, a, next_a(a));
    a = lift_add(a, kDelta, prev_b(b), b);
    if (out) {
      const int64_t o = obase + (int64_t)(k >> 1) * w2;
      const float lo = __fmul_rn(a, kInvK), hi = __fmul_rn(b, kK);
      if (k & 1) {
        lh[o] = lo;
        hh[o] = hi;
      } else {
        ll[o] = lo;
        hl[o] = hi;
      }
    }
  }
}

// ll, hl, lh, hh [n, h/2, w/2] -> out [n, h, w].  Register row j holds
// interleaved row r0 - 3 + j of the lane's two columns (S + 7 rows): an odd
// (high-pass) row when j is even.
__global__ void __launch_bounds__(THREADS)
dwt97_inv_kernel(const float* __restrict__ ll, const float* __restrict__ hl,
                 const float* __restrict__ lh, const float* __restrict__ hh,
                 const float* __restrict__ above,
                 const float* __restrict__ below, float* __restrict__ out,
                 int n, int h, int w, int strips, int tiles) {
  Task t;
  if (!warp_task(n, h, strips, tiles, INV_STRIP, &t)) return;  // whole warps
  const int rr = t.rr;
  const int w2 = w >> 1;
  // column 2p reflects to an even column, the low half's sample c0 / 2;
  // column 2p + 1 to an odd one, the high half's sample c1 / 2
  const int m0 = reflect(2 * t.p, w) >> 1, m1 = reflect(2 * t.p + 1, w) >> 1;
  const int64_t bbase = (int64_t)t.frame * (h >> 1) * w2;

  // every row's loads first, with nothing that waits for them in between
  float2 v[INV_STRIP + HALO];
#pragma unroll
  for (int j = 0; j < INV_STRIP + HALO; ++j) {
    if (j > rr + 6) break;                     // rows r0 - 3 .. r0 + rr + 3
    const int g = t.r0 - INV_ABOVE + j;
    const float *lo, *hi;
    if (g < 0 && above) {
      lo = above + ((int64_t)t.frame * INV_ABOVE + INV_ABOVE + g) * w;
      hi = lo + w2;
    } else if (g >= h && below) {
      lo = below + ((int64_t)t.frame * (HALO - INV_ABOVE) + g - h) * w;
      hi = lo + w2;
    } else {
      const int r = reflect(g, h);
      const int64_t i = bbase + (int64_t)(r >> 1) * w2;
      lo = ((r & 1) ? lh : ll) + i;
      hi = ((r & 1) ? hh : hl) + i;
    }
    v[j].x = lo[m0];
    v[j].y = hi[m1];
  }
  // 2D_SR: rows first: the horizontal scaling (even column x K, odd x
  // 1/K), four shuffles, then the vertical scaling (register row 0 is odd:
  // even j x 1/K, odd j x K)
#pragma unroll
  for (int j = 0; j < INV_STRIP + HALO; ++j) {
    if (j > rr + 6) break;
    float a = __fmul_rn(v[j].x, kK), b = __fmul_rn(v[j].y, kInvK);
    a = lift_sub(a, kDelta, prev_b(b), b);
    b = lift_sub(b, kGamma, a, next_a(a));
    a = lift_sub(a, kBeta, prev_b(b), b);
    b = lift_sub(b, kAlpha, a, next_a(a));
    const float s = (j & 1) ? kK : kInvK;
    v[j].x = __fmul_rn(a, s);
    v[j].y = __fmul_rn(b, s);
  }
  // then columns: delta on even rows r0-2 .. r0+rr+2 (register rows 1, 3,
  // ..), gamma on odd rows r0-1 .. r0+rr+1, beta on even rows r0 .. r0+rr,
  // alpha on odd rows r0+1 .. r0+rr-1
#pragma unroll
  for (int j = 1; j < INV_STRIP + 6; j += 2) {
    if (j > rr + 5) break;
    v[j].x = lift_sub(v[j].x, kDelta, v[j - 1].x, v[j + 1].x);
    v[j].y = lift_sub(v[j].y, kDelta, v[j - 1].y, v[j + 1].y);
  }
#pragma unroll
  for (int j = 2; j < INV_STRIP + 5; j += 2) {
    if (j > rr + 4) break;
    v[j].x = lift_sub(v[j].x, kGamma, v[j - 1].x, v[j + 1].x);
    v[j].y = lift_sub(v[j].y, kGamma, v[j - 1].y, v[j + 1].y);
  }
#pragma unroll
  for (int j = 3; j < INV_STRIP + 4; j += 2) {
    if (j > rr + 3) break;
    v[j].x = lift_sub(v[j].x, kBeta, v[j - 1].x, v[j + 1].x);
    v[j].y = lift_sub(v[j].y, kBeta, v[j - 1].y, v[j + 1].y);
  }
#pragma unroll
  for (int j = 4; j < INV_STRIP + 3; j += 2) {
    if (j > rr + 2) break;
    v[j].x = lift_sub(v[j].x, kAlpha, v[j - 1].x, v[j + 1].x);
    v[j].y = lift_sub(v[j].y, kAlpha, v[j - 1].y, v[j + 1].y);
  }
  // rows r0 .. r0+rr-1 (register rows 3 .. rr+2), columns 2p and 2p+1 as
  // one 8-byte store
  if (t.lane < 2 || t.lane >= 2 + PAIRS || t.p >= w2) return;
  float2* o = reinterpret_cast<float2*>(
      out + ((int64_t)t.frame * h + t.r0) * w) + t.p;
#pragma unroll
  for (int k = 0; k < INV_STRIP; ++k) {
    if (k >= rr) break;
    o[(int64_t)k * w2] = v[k + 3];
  }
}

extern "C" {

int dwt97_fwd_strip_rows(void) { return FWD_STRIP; }
int dwt97_inv_strip_rows(void) { return INV_STRIP; }
int dwt97_halo_rows(void) { return HALO; }
int dwt97_fwd_above(void) { return FWD_ABOVE; }
int dwt97_inv_above(void) { return INV_ABOVE; }

static unsigned blocks_for(int64_t tasks) {
  const int per_block = THREADS / 32;
  return (unsigned)((tasks + per_block - 1) / per_block);
}

int dwt97_fwd_level(const void* x, const void* above, const void* below,
                    void* ll, void* hl, void* lh, void* hh, int n, int h,
                    int w, void* stream) {
  const int strips = (h + FWD_STRIP - 1) / FWD_STRIP;
  const int tiles = (w / 2 + PAIRS - 1) / PAIRS;
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(above) |
                    reinterpret_cast<uintptr_t>(below)) & 7) == 0;
  dwt97_fwd_kernel<<<blocks_for((int64_t)n * strips * tiles), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float*)x, (const float*)above, (const float*)below, (float*)ll,
      (float*)hl, (float*)lh, (float*)hh, n, h, w, strips, tiles, vec);
  return (int)cudaGetLastError();
}

int dwt97_inv_level(const void* ll, const void* hl, const void* lh,
                    const void* hh, const void* above, const void* below,
                    void* out, int n, int h, int w, void* stream) {
  const int strips = (h + INV_STRIP - 1) / INV_STRIP;
  const int tiles = (w / 2 + PAIRS - 1) / PAIRS;
  dwt97_inv_kernel<<<blocks_for((int64_t)n * strips * tiles), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float*)ll, (const float*)hl, (const float*)lh, (const float*)hh,
      (const float*)above, (const float*)below, (float*)out, n, h, w, strips,
      tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
