// The edge slot of a row shard for the halo form of the DWT level kernels,
// for NVIDIA Hopper (sm_90a): one launch packs a shard's first and last
// EDGE_ROWS rows (csrc/dwt_edges.cuh) into its slot of the edges tensor
// that the shards then exchange.
//
// Replaces the send side of the row-shard lifting of the JAX package:
//   dwt_pack_edges  <- go_jpeg2000_tpu/parallel/sharded.py
//                      _odd_update_sharded, _even_update_sharded (the
//                      boundary rows each lifting step sends with ppermute)
// The plain torch version is go_jpeg2000_tpu_torch/ops/dwt.py pack_edges
// (shard_edges, pair_edges); the Python wrapper, build and launch count are
// in ops/dwt_cuda.py.
//
// Forward level (pairs = 0): slot row r of frame f is row edge_source_row(r)
// of the shard's rows s0 [n, h, w].  Inverse level (pairs = 1): the shard
// has h interleaved rows of w samples and four bands s0..s3 = LL [n, h/2,
// lw], HL [n, h/2, w - lw], LH, HH (LL's and HL's widths), lw = ceil(w/2)
// at the even column origin of a halo level; slot row r is interleaved row
// i = edge_source_row(r) in ops/dwt.py pair_rows' layout, its first lw
// words from LL (i even) or LH (i odd) row i/2, the rest from HL or HH.
// The geometry is a halo level's: h even, w any.
//
// Bound: memory, each slot word read once and written once.  A thread
// copies 16-byte units (4 words) where every row and band row starts
// 16-byte aligned, else words: consecutive threads consecutive units of a
// slot row, ROWS rows a turn with their loads in flight together (a
// grid-stride copy dividing 64-bit unit indices took 1.7 times the bound
// on a 12.6 MB slot).
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "dwt_edges.cuh"

#define MAX_THREADS 256
#define ROWS 8            // slot rows a block copies a turn
#define MAX_GRID_Y 65535

// A block's threads take consecutive units (V: 16 bytes or one word) of a
// slot row, ROWS rows a turn, every load of the turn before its stores;
// blocks stride over the n * e rows by gridDim.y * ROWS.
template <typename V>
__global__ void __launch_bounds__(MAX_THREADS)
edges_pack_kernel(const uint32_t* __restrict__ s0,
                  const uint32_t* __restrict__ s1,
                  const uint32_t* __restrict__ s2,
                  const uint32_t* __restrict__ s3, uint32_t* __restrict__ dst,
                  int n, int h, int w, int e, int pairs) {
  constexpr int UNIT = sizeof(V) / 4;          // words a unit holds
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * UNIT;
  if (c >= w) return;
  const int lw = (w + 1) >> 1, hw = w >> 1;    // low and high band widths
  const int64_t rows = (int64_t)n * e;
  for (int64_t r0 = (int64_t)blockIdx.y * ROWS; r0 < rows;
       r0 += (int64_t)gridDim.y * ROWS) {
    const int64_t f0 = r0 / e;
    const int rem = (int)(r0 - f0 * e);
    V buf[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (r0 + k >= rows) break;
      const int64_t f = f0 + (rem + k) / e;
      const int i = edge_source_row((rem + k) % e, h, e);
      const uint32_t* src;
      if (!pairs) {
        src = s0 + (f * h + i) * w + c;
      } else {
        const int64_t band_row = f * (h >> 1) + (i >> 1);
        src = c < lw ? ((i & 1) ? s2 : s0) + band_row * lw + c
                     : ((i & 1) ? s3 : s1) + band_row * hw + (c - lw);
      }
      buf[k] = *reinterpret_cast<const V*>(src);
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (r0 + k >= rows) break;
      *reinterpret_cast<V*>(dst + (r0 + k) * w + c) = buf[k];
    }
  }
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

extern "C" {

int dwt_edge_rows(void) { return EDGE_ROWS; }

// s1..s3 are ignored (may be null) when pairs == 0
int dwt_pack_edges(const void* s0, const void* s1, const void* s2,
                   const void* s3, void* dst, int n, int h, int w, int e,
                   int pairs, void* stream) {
  if (n <= 0 || e <= 0 || w <= 0) return 0;
  const bool vec =
      (pairs ? (w & 7) == 0 : (w & 3) == 0) && aligned16(s0) &&
      aligned16(dst) &&
      (!pairs || (aligned16(s1) && aligned16(s2) && aligned16(s3)));
  const int units = vec ? w / 4 : w;
  const int threads = units >= MAX_THREADS ? MAX_THREADS : (units + 31) & ~31;
  const int64_t groups = ((int64_t)n * e + ROWS - 1) / ROWS;
  const dim3 grid((units + threads - 1) / threads,
                  (unsigned)(groups < MAX_GRID_Y ? groups : MAX_GRID_Y));
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t *a = (const uint32_t*)s0, *b = (const uint32_t*)s1,
                 *c = (const uint32_t*)s2, *d = (const uint32_t*)s3;
  if (vec)
    edges_pack_kernel<uint4><<<grid, threads, 0, st>>>(
        a, b, c, d, (uint32_t*)dst, n, h, w, e, pairs);
  else
    edges_pack_kernel<uint32_t><<<grid, threads, 0, st>>>(
        a, b, c, d, (uint32_t*)dst, n, h, w, e, pairs);
  return (int)cudaGetLastError();
}

}  // extern "C"
