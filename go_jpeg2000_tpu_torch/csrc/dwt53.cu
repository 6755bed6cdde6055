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
// Forward: a warp per (frame, strip of FWD_STRIP output rows, tile of 30
// output column pairs), no shared memory and no barrier.  Lane l holds
// column pair 30t + l - 1 (columns 2p, 2p+1, one 8-byte load a row; pairs
// off the frame's edge read their columns through the symmetric
// extension): lane 0 is the tile's left halo (2 columns), lane 31 its
// right halo (1 column needed).  Each lane loads its FWD_STRIP + 3 rows
// (2 above, 1 below the strip) into registers before it computes any, so
// every load of the strip is in flight at once; lifts its two columns
// vertically there (predict on odd rows, update on even); then lifts each
// row horizontally with two warp shuffles (the next pair's even sample,
// the previous pair's detail) and stores the row's low and high halves
// straight into the four band tensors, 30 consecutive words a band per
// warp.  Index arithmetic is per thread and row, never per sample, and no
// loop divides.  Reads beyond the ideal: 3 rows per FWD_STRIP (9%) and 2
// pairs per 30 (7%), most of them hits in L2.  Any even width takes the
// kernel.
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
// vertically in registers; lanes 1..30 store their two columns as one
// 8-byte store a row, 240 contiguous bytes a warp.  Lane 0 is the left
// halo (its raw detail), lane 31 the right (its updated even sample, from
// lane 30's detail and its own).  Neither kernel uses shared memory or a
// barrier, so any even width takes both.  The forward kernel writes
// straight into the four band tensors and the inverse reads straight from
// them: the deinterleave and interleave XLA did outside the TPU kernel cost
// no extra pass over device memory.
//
// Integer exactness: (l + r) >> 1 and (l + r + 2) >> 2 are arithmetic
// shifts of signed int32 (floor division), never '/', which truncates toward
// zero.  Signal edges use whole-sample symmetric extension (i < 0 -> -i,
// i >= n -> 2n - 2 - i), applied until the index is inside, so a 2-sample
// axis reflects both neighbours onto its own samples as ops/dwt.py does.
//
// Row shards (the halo form; replaces the row-shard lifting of
// go_jpeg2000_tpu/parallel/sharded.py, _odd_update_sharded,
// _even_update_sharded, _vlift53_sharded, _vlift53_inverse_sharded): x may be
// one row shard of taller frames.  `above` [n, HA, w] and `below` [n, HB, w]
// are then the rows of the globally extended signal just outside it (the
// forward kernel's input rows; for the inverse, interleaved rows with the
// low-pass half of the row first, [LL|HL] or [LH|HH]), and a warp reads
// them where its strip reaches past the shard.  The JAX package exchanged
// one row per lifting step; these are built once per level from every
// shard's edge rows (parallel/sharded.py), so a shard of 2 rows, shorter
// than the lifting's reach, still lifts exactly as the whole signal.  A null
// pointer is a global edge, where the shard reflects on itself as before.
//
// Geometry: even origin, even H and W (>= 2) at this level; other levels
// take the plain version.  Kernels launch on the caller's stream, allocate
// nothing, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define FWD_STRIP 32      // forward: output rows per warp (even)
#define INV_STRIP 32      // inverse: output rows per warp (even)
#define PAIRS 30          // output column pairs per warp (lanes 1 .. 30)
#define HALO 3            // forward: 2 rows above, 1 below; inverse: 1, 2
#define FWD_ABOVE 2
#define INV_ABOVE 1
#define THREADS 128

__device__ __forceinline__ int reflect(int i, int n) {
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

// Row g (-ha <= g < h + hb) of a shard of h rows in a frame: from the halo
// above or below where one is given, else the shard's own row (reflected).
__device__ __forceinline__ const int* shard_row(const int* x, const int* above,
                                                const int* below, int frame,
                                                int g, int h, int w, int ha,
                                                int hb) {
  if (g < 0 && above) return above + ((int64_t)frame * ha + ha + g) * w;
  if (g >= h && below) return below + ((int64_t)frame * hb + g - h) * w;
  return x + ((int64_t)frame * h + reflect(g, h)) * w;
}

// x [n, h, w] -> ll, hl, lh, hh [n, h/2, w/2].  Warp task t: tile
// t % tiles, strip (t / tiles) % strips, frame t / (tiles * strips).
// Register row j holds input row r0 - 2 + j of the lane's two columns.
__global__ void __launch_bounds__(THREADS)
dwt53_fwd_kernel(const int* __restrict__ x, const int* __restrict__ above,
                 const int* __restrict__ below, int* __restrict__ ll,
                 int* __restrict__ hl, int* __restrict__ lh,
                 int* __restrict__ hh, int n, int h, int w, int strips,
                 int tiles, int vec) {
  const int64_t task =
      (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (task >= (int64_t)n * strips * tiles) return;   // whole warps
  const int lane = threadIdx.x & 31;
  const int tile = (int)(task % tiles);
  const int64_t fs = task / tiles;
  const int r0 = (int)(fs % strips) * FWD_STRIP;
  const int frame = (int)(fs / strips);
  const int rr = min(FWD_STRIP, h - r0);       // even: h and r0 are even
  const int w2 = w >> 1;
  const int p = tile * PAIRS + lane - 1;   // this lane's column pair
  const int c0 = reflect(2 * p, w), c1 = reflect(2 * p + 1, w);
  const bool pair = vec && c1 == c0 + 1;       // c0 even: one 8-byte load

  int2 v[FWD_STRIP + 3];
#pragma unroll
  for (int j = 0; j < FWD_STRIP + 3; ++j) {
    if (j > rr + 2) break;                     // rows r0 - 2 .. r0 + rr
    const int* row = shard_row(x, above, below, frame, r0 - FWD_ABOVE + j,
                               h, w, FWD_ABOVE, HALO - FWD_ABOVE);
    if (pair) {
      v[j] = *reinterpret_cast<const int2*>(row + c0);
    } else {
      v[j].x = row[c0];
      v[j].y = row[c1];
    }
  }
  // vertical predict on odd rows r0-1 .. r0+rr-1 (register rows 1, 3, ..)
#pragma unroll
  for (int j = 1; j < FWD_STRIP + 2; j += 2) {
    if (j > rr + 1) break;
    v[j].x = predict_sub(v[j].x, v[j - 1].x, v[j + 1].x);
    v[j].y = predict_sub(v[j].y, v[j - 1].y, v[j + 1].y);
  }
  // vertical update on even rows r0 .. r0+rr-2 (register rows 2, 4, ..)
#pragma unroll
  for (int j = 2; j < FWD_STRIP + 2; j += 2) {
    if (j > rr) break;
    v[j].x = update_add(v[j].x, v[j - 1].x, v[j + 1].x);
    v[j].y = update_add(v[j].y, v[j - 1].y, v[j + 1].y);
  }
  // horizontal lifting of each output row, then the stores: even rows to
  // LL | HL, odd rows to LH | HH; even columns low, odd columns high
  const bool out = lane >= 1 && lane <= PAIRS && p < w2;
  const int64_t obase =
      ((int64_t)frame * (h >> 1) + (r0 >> 1)) * w2 + p;
#pragma unroll
  for (int k = 0; k < FWD_STRIP; ++k) {
    if (k >= rr) break;
    const int a = v[k + 2].x, b = v[k + 2].y;
    const int next = __shfl_down_sync(0xffffffffu, a, 1);
    const int d = predict_sub(b, a, next);       // x[2p+1] -= (x[2p]+x[2p+2])/2
    const int prev = __shfl_up_sync(0xffffffffu, d, 1);
    const int s0 = update_add(a, prev, d);  // x[2p] += (d[p-1]+d[p]+2)/4
    if (out) {
      const int64_t o = obase + (int64_t)(k >> 1) * w2;
      if (k & 1) {
        lh[o] = s0;
        hh[o] = d;
      } else {
        ll[o] = s0;
        hl[o] = d;
      }
    }
  }
}

// ll, hl, lh, hh [n, h/2, w/2] -> out [n, h, w].  Warp task t as in the
// forward kernel.  Register row j holds interleaved row r0 - 1 + j of the
// lane's two columns: an odd (high-pass) row when j is even.
__global__ void __launch_bounds__(THREADS)
dwt53_inv_kernel(const int* __restrict__ ll, const int* __restrict__ hl,
                 const int* __restrict__ lh, const int* __restrict__ hh,
                 const int* __restrict__ above, const int* __restrict__ below,
                 int* __restrict__ out, int n, int h, int w, int strips,
                 int tiles) {
  const int64_t task =
      (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (task >= (int64_t)n * strips * tiles) return;   // whole warps
  const int lane = threadIdx.x & 31;
  const int tile = (int)(task % tiles);
  const int64_t fs = task / tiles;
  const int r0 = (int)(fs % strips) * INV_STRIP;
  const int frame = (int)(fs / strips);
  const int rr = min(INV_STRIP, h - r0);       // even: h and r0 are even
  const int w2 = w >> 1;
  const int p = tile * PAIRS + lane - 1;       // this lane's column pair
  // column 2p reflects to an even column, the low half's sample m0; column
  // 2p + 1 to an odd one, the high half's sample m1
  const int m0 = reflect(2 * p, w) >> 1, m1 = reflect(2 * p + 1, w) >> 1;
  const int64_t bbase = (int64_t)frame * (h >> 1) * w2;

  int2 v[INV_STRIP + HALO];
#pragma unroll
  for (int j = 0; j < INV_STRIP + HALO; ++j) {
    if (j > rr + 2) break;                     // rows r0 - 1 .. r0 + rr + 1
    const int g = r0 - INV_ABOVE + j;
    const int *lo, *hi;
    if (g < 0 && above) {
      lo = above + ((int64_t)frame * INV_ABOVE + INV_ABOVE + g) * w;
      hi = lo + w2;
    } else if (g >= h && below) {
      lo = below + ((int64_t)frame * (HALO - INV_ABOVE) + g - h) * w;
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
  // rows first: undo the update on the even column with the previous
  // pair's raw detail, then the predict on the odd column with the next
  // pair's updated even sample
#pragma unroll
  for (int j = 0; j < INV_STRIP + HALO; ++j) {
    if (j > rr + 2) break;
    const int prev = __shfl_up_sync(0xffffffffu, v[j].y, 1);
    const int s0 = update_sub(v[j].x, prev, v[j].y);
    const int next = __shfl_down_sync(0xffffffffu, s0, 1);
    v[j].x = s0;
    v[j].y = predict_add(v[j].y, s0, next);
  }
  // then columns: undo the update on even rows r0 .. r0+rr (register rows
  // 1, 3, ..), then the predict on odd rows r0+1 .. r0+rr-1 (rows 2, 4, ..)
#pragma unroll
  for (int j = 1; j < INV_STRIP + 2; j += 2) {
    if (j > rr + 1) break;
    v[j].x = update_sub(v[j].x, v[j - 1].x, v[j + 1].x);
    v[j].y = update_sub(v[j].y, v[j - 1].y, v[j + 1].y);
  }
#pragma unroll
  for (int j = 2; j < INV_STRIP + 1; j += 2) {
    if (j > rr) break;
    v[j].x = predict_add(v[j].x, v[j - 1].x, v[j + 1].x);
    v[j].y = predict_add(v[j].y, v[j - 1].y, v[j + 1].y);
  }
  // rows r0 .. r0+rr-1 (register rows 1 .. rr), columns 2p and 2p+1 as one
  // 8-byte store
  if (lane < 1 || lane > PAIRS || p >= w2) return;
  int2* o = reinterpret_cast<int2*>(out + ((int64_t)frame * h + r0) * w) + p;
#pragma unroll
  for (int k = 0; k < INV_STRIP; ++k) {
    if (k >= rr) break;
    o[(int64_t)k * w2] = v[k + 1];
  }
}

static unsigned blocks_for(int64_t tasks) {
  const int per_block = THREADS / 32;
  return (unsigned)((tasks + per_block - 1) / per_block);
}

extern "C" {

int dwt53_fwd_strip_rows(void) { return FWD_STRIP; }
int dwt53_inv_strip_rows(void) { return INV_STRIP; }
int dwt53_halo_rows(void) { return HALO; }
int dwt53_fwd_above(void) { return FWD_ABOVE; }
int dwt53_inv_above(void) { return INV_ABOVE; }

int dwt53_fwd_level(const void* x, const void* above, const void* below,
                    void* ll, void* hl, void* lh, void* hh, int n, int h,
                    int w, void* stream) {
  const int strips = (h + FWD_STRIP - 1) / FWD_STRIP;
  const int tiles = (w / 2 + PAIRS - 1) / PAIRS;
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(above) |
                    reinterpret_cast<uintptr_t>(below)) & 7) == 0;
  dwt53_fwd_kernel<<<blocks_for((int64_t)n * strips * tiles), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const int*)x, (const int*)above, (const int*)below, (int*)ll,
      (int*)hl, (int*)lh, (int*)hh, n, h, w, strips, tiles, vec);
  return (int)cudaGetLastError();
}

int dwt53_inv_level(const void* ll, const void* hl, const void* lh,
                    const void* hh, const void* above, const void* below,
                    void* out, int n, int h, int w, void* stream) {
  const int strips = (h + INV_STRIP - 1) / INV_STRIP;
  const int tiles = (w / 2 + PAIRS - 1) / PAIRS;
  dwt53_inv_kernel<<<blocks_for((int64_t)n * strips * tiles), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const int*)ll, (const int*)hl, (const int*)lh, (const int*)hh,
      (const int*)above, (const int*)below, (int*)out, n, h, w, strips,
      tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
