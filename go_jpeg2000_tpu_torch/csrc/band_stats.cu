// Band statistics of a wavelet pyramid for NVIDIA Hopper (sm_90a): for every
// leaf (one band over a batch of tiles and components), the sum of the
// squared coefficients and the count of nonzero coefficients, in one launch.
//
// Replaces the statistics half of the JAX package's sharded transform step,
// go_jpeg2000_tpu/parallel/sharded.py make_tile_transform_step (local_step:
// jnp.sum(a * a) and jnp.sum(a != 0) per leaf, before the psum over the
// mesh).  The plain torch version and the Python wrapper are
// go_jpeg2000_tpu_torch/ops/band_stats.py.
//
// Bound: memory.  The kernel reads each coefficient once (4 bytes) and does
// a multiply, an add and a compare on it, so the time is the bytes over the
// card's bandwidth: about 805 MB, 0.24 ms at 3.35 TB/s, for the level pyramid
// of an 8192x8192 RGB image in 512x512 tiles.  The leaves differ in length by
// up to 4^levels, so the grid is segmented: each leaf gets its own run of
// blocks of ITEMS * THREADS coefficients, a block finds its leaf in the
// table of first blocks, sums in registers (coalesced loads, the threads of
// a warp on neighbouring addresses), reduces with warp shuffles and then
// across its warps in shared memory, and adds its result with one atomic per
// output into the leaf's sum and count.
//
// Exactness: the count is an unsigned 64-bit integer (the JAX package counts
// in float32, which is inexact past 2^24 nonzeros; a level-1 band of the
// image above has 50 M coefficients).  The squares are taken and summed in
// float64: a float32 or int32 coefficient's square is exact in float64, and
// only the order of the float64 sum varies between runs (atomics).
//
// Entry point: band_stats(ptrs, lens, n_leaves, is_float, sums, counts,
// stream) with host arrays of the leaves' device pointers and lengths; it
// zeroes sums (double [n]) and counts (uint64 [n]) on the stream, launches,
// and returns cudaGetLastError().  It allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEAVES 64
#define THREADS 256
#define ITEMS 16          // coefficients per thread and block
#define WARPS (THREADS / 32)

struct Leaves {
  const void* ptr[MAX_LEAVES];
  long long len[MAX_LEAVES];
  int block0[MAX_LEAVES + 1];   // first block of each leaf; [n] = all blocks
  int n;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const Leaves L, double* __restrict__ sums,
             unsigned long long* __restrict__ counts) {
  int leaf = 0;
  while (blockIdx.x >= (unsigned)L.block0[leaf + 1]) leaf++;
  const T* p = (const T*)L.ptr[leaf];
  const long long start =
      (long long)(blockIdx.x - L.block0[leaf]) * (THREADS * ITEMS);
  const long long end = min(start + (long long)(THREADS * ITEMS), L.len[leaf]);
  double s = 0.0;
  unsigned long long c = 0;
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const T v = p[i];
    const double d = (double)v;
    s += d * d;
    c += (v != (T)0);
  }
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    c += __shfl_down_sync(0xffffffffu, c, o);
  }
  __shared__ double ws[WARPS];
  __shared__ unsigned long long wc[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = s;
    wc[warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? ws[lane] : 0.0;
    c = lane < WARPS ? wc[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      c += __shfl_down_sync(0xffffffffu, c, o);
    }
    if (lane == 0) {
      atomicAdd(&sums[leaf], s);
      atomicAdd(&counts[leaf], c);
    }
  }
}

extern "C" {

int band_stats_max_leaves(void) { return MAX_LEAVES; }

int band_stats(const void* const* ptrs, const long long* lens, int n_leaves,
               int is_float, void* sums, void* counts, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Leaves L;
  long long blocks = 0;
  for (int i = 0; i < n_leaves; i++) {
    L.ptr[i] = ptrs[i];
    L.len[i] = lens[i];
    L.block0[i] = (int)blocks;
    blocks += (lens[i] + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  }
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  L.block0[n_leaves] = (int)blocks;
  L.n = n_leaves;
  cudaMemsetAsync(sums, 0, sizeof(double) * n_leaves, st);
  cudaMemsetAsync(counts, 0, sizeof(unsigned long long) * n_leaves, st);
  if (blocks > 0) {
    if (is_float)
      stats_kernel<float><<<(unsigned)blocks, THREADS, 0, st>>>(
          L, (double*)sums, (unsigned long long*)counts);
    else
      stats_kernel<int><<<(unsigned)blocks, THREADS, 0, st>>>(
          L, (double*)sums, (unsigned long long*)counts);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
