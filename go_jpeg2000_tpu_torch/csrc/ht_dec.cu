// The device half of the HTJ2K cleanup decode, for NVIDIA Hopper (sm_90a):
// per-sample MagSgn extraction and block-to-pyramid assembly.
//
// Replaces the JAX package's TPU programs (written in jnp):
//   ht_magsgn_decode      <- go_jpeg2000_tpu/ops/ht_tpu_decode.py
//                            magsgn_decode_blocks
//   ht_blocks_to_pyramid  <- go_jpeg2000_tpu/ops/ht_tpu_decode.py
//                            blocks_to_pyramid_dev (with the midpoint
//                            dequantization of lossy plans)
// The host (native ht_t2_parse_frames) keeps the MEL/VLC control phase and
// hands over one word per quad (U | rho << 8 | ek << 12 | e1 << 16) and the
// unstuffed MagSgn words of every block.  The plain torch versions are
// go_jpeg2000_tpu_torch/ops/ht_dec.py magsgn_decode_blocks and
// blocks_to_pyramid; the wrappers, build and launch counts are in
// ops/ht_dec_cuda.py.  Both kernels equal their plain versions exactly,
// float32 leaves bit for bit.
//
// What bounds them on the H100: bytes.  Each does a few dozen integer
// operations per sample and moves 4 bytes per quad of quad words, the pool
// (about the compressed size), 4 bytes per sample of block slots, and 4
// bytes per sample of leaves, so the time is those bytes over the 3.35 TB/s
// of device memory, plus launch latency on small batches.  The TPU forms
// gathered every sample's two-word window and reordered quads with stacks
// and reshapes, each a pass through memory; here:
//
// * ht_magsgn_decode: one CUDA block per code-block and one thread per quad
//   (a 64x64 block has 1024 quads; larger quad grids loop with a carry).
//   Each thread decodes its quad word and its four field lengths
//   m_n = rho_n ? U - ek_n : 0; a block-wide exclusive scan of the quad
//   totals (warp shuffles and shared memory, as ht_pack_bits in ht_enc.cu
//   scans) gives each sample its bit position, woff * 32 + prefix, as an
//   int64 (the JAX package's int32 positions limited a batch to 2^31 bits).
//   Each sample reads pool[wi] and pool[wi + 1], clamped to the pool's last
//   word as jnp.take(mode="clip") clamps; the high word is guarded when the
//   shift is 0 (a shift by 32 is undefined in C++), as is the mask when m
//   could reach 32.  The thread writes its quad's two 2-sample pairs into
//   the two raster rows, so a warp's stores cover two contiguous row runs.
//   Quads that carry no code (word 0) give 0.
// * ht_blocks_to_pyramid: the mirror of ht_extract_blocks (ht_enc.cu), with
//   the same 11-field band table (leaf, component, band h/w, grid width gx,
//   cell eh/ew, grid offset oy/ox, first slot, quantizer step), read in the
//   opposite direction; the leaf field is the leaf's element offset in one
//   output buffer, so the table depends on the plan alone and the wrapper
//   keeps it on the card.  One CUDA block per slot; thread 0 finds the
//   slot's band, and the threads walk the slot's valid samples row by row,
//   one thread per leaf sample, so slot reads and leaf writes are coalesced
//   runs of a leaf row.  Each sample is written straight into its place in
//   the leaves (contiguous views of that buffer).  Lossy plans write
//   float32
//   sign(q) * (|q| + 0.5) * delta with __fadd_rn and __fmul_rn (no FMA
//   contraction, and this file must not be built with --use_fast_math), as
//   ops/quant.py dequantize rounds on the card and on the CPU, so a CUDA
//   decode equals the CPU decode bit for bit.
//
// Kernels launch on the caller's stream and allocate nothing; each entry
// point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_QUAD_THREADS 1024

// band table of ht_blocks_to_pyramid: BAND_FIELDS int64 per band, bands in
// slot order (must match ops/ht_dec_cuda.py and ht_enc.cu)
#define BAND_FIELDS 11
enum { B_LEAF, B_COMP, B_BH, B_BW, B_GX, B_EH, B_EW, B_OY, B_OX, B_SLOT0,
       B_DELTA };

// Exclusive scan of v over the block (blockDim.x a multiple of 32, at most
// 1024).  Returns the thread's exclusive prefix and puts the block total in
// *total; sh holds 32 ints.
__device__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nwarps ? sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) sh[lane] = s;
  }
  __syncthreads();
  const int prefix = (wid ? sh[wid - 1] : 0) + x - v;
  *total = sh[nwarps - 1];
  __syncthreads();
  return prefix;
}

// ------------------------------------------------------- ht_magsgn_decode

__global__ void __launch_bounds__(MAX_QUAD_THREADS) magsgn_kernel(
    const unsigned* __restrict__ qinfo, const unsigned* __restrict__ pool,
    long long pool_words, const long long* __restrict__ woff, int qh, int qw,
    int cbh, int cbw, int* __restrict__ out) {
  __shared__ int sh[32];
  const int b = blockIdx.x;
  const int nq = qh * qw;
  const unsigned* qi = qinfo + (int64_t)b * nq;
  int* dst = out + (int64_t)b * cbh * cbw;
  const long long last = pool_words - 1;
  long long base = woff[b] * 32;
  for (int q0 = 0; q0 < nq; q0 += blockDim.x) {
    const int q = q0 + (int)threadIdx.x;
    const unsigned info = q < nq ? qi[q] : 0u;
    const int u = info & 0xFF, rho = (info >> 8) & 0xF;
    const int ek = (info >> 12) & 0xF, e1 = (info >> 16) & 0xF;
    int m[4], tot = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = ((rho >> i) & 1) ? u - ((ek >> i) & 1) : 0;
      tot += m[i];
    }
    int total;
    long long pos = base + block_exclusive_scan(tot, sh, &total);
    base += total;
    if (q >= nq) continue;
    int c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] = 0;
      if (!((rho >> i) & 1)) continue;
      const int mi = m[i];
      const long long wi = pos >> 5;
      const int s = (int)(pos & 31);
      const unsigned lo = pool[wi < last ? wi : last] >> s;
      const unsigned hi = s ? pool[wi + 1 < last ? wi + 1 : last] << (32 - s)
                            : 0u;
      unsigned v = (lo | hi) & (mi >= 32 ? 0xffffffffu : (1u << mi) - 1u);
      if (mi < 32) v |= (unsigned)((e1 >> i) & 1) << mi;
      const int mu = (int)((v >> 1) + 1u);
      c[i] = (v & 1u) ? -mu : mu;
      pos += mi;
    }
    // n0..n3 = (0,0), (1,0), (0,1), (1,1): rows y and y + 1, columns x and
    // x + 1
    const int qy = q / qw, qx = q - (q / qw) * qw;
    const int y = 2 * qy, x = 2 * qx;
    const int vals[2][2] = {{c[0], c[2]}, {c[1], c[3]}};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (y + r >= cbh) break;
      int* row = dst + (int64_t)(y + r) * cbw + x;
      if (x + 1 < cbw && !(cbw & 1)) {
        *reinterpret_cast<int2*>(row) = make_int2(vals[r][0], vals[r][1]);
      } else {
        if (x < cbw) row[0] = vals[r][0];
        if (x + 1 < cbw) row[1] = vals[r][1];
      }
    }
  }
}

// --------------------------------------------------- ht_blocks_to_pyramid

__global__ void __launch_bounds__(THREADS) to_pyramid_kernel(
    const long long* __restrict__ table, int n_bands, int n_comps, int nb,
    int cbh, int cbw, int is_float, const int* __restrict__ coeffs,
    void* __restrict__ leaves) {
  __shared__ long long d[BAND_FIELDS];
  const int j = blockIdx.x, n = blockIdx.y;
  if (threadIdx.x == 0) {
    int b = 0;
    while (b + 1 < n_bands && table[(b + 1) * BAND_FIELDS + B_SLOT0] <= j) ++b;
    for (int f = 0; f < BAND_FIELDS; ++f) d[f] = table[b * BAND_FIELDS + f];
  }
  __syncthreads();
  const int bh = (int)d[B_BH], bw = (int)d[B_BW], gx = (int)d[B_GX];
  const int eh = (int)d[B_EH], ew = (int)d[B_EW];
  const int oy = (int)d[B_OY], ox = (int)d[B_OX];
  const int k = j - (int)d[B_SLOT0];
  const int yy = k / gx, xx = k - (k / gx) * gx;
  // first-row and first-column cells of an offset grid hold their samples
  // from the slot's top-left corner (the JAX version's roll)
  const int y0 = yy == 0 ? 0 : yy * eh - oy;
  const int x0 = xx == 0 ? 0 : xx * ew - ox;
  const int rows = min(yy == 0 ? eh - oy : eh, bh - y0);
  const int cols = min(xx == 0 ? ew - ox : ew, bw - x0);
  if (rows <= 0 || cols <= 0) return;
  const int64_t plane =
      d[B_LEAF] + ((int64_t)n * n_comps + d[B_COMP]) * bh * bw;
  const float delta = __int_as_float((int)d[B_DELTA]);
  const int* src = coeffs + ((int64_t)n * nb + j) * cbh * cbw;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - (i / cols) * cols;
    const int q = src[r * cbw + c];
    const int64_t at = plane + (int64_t)(y0 + r) * bw + x0 + c;
    if (is_float) {
      const float a = __fmul_rn(__fadd_rn(__int2float_rn(abs(q)), 0.5f),
                                delta);
      ((float*)leaves)[at] = q < 0 ? -a : (q > 0 ? a : 0.f);
    } else {
      ((int*)leaves)[at] = q;
    }
  }
}

extern "C" {

int ht_dec_band_fields(void) { return BAND_FIELDS; }
int ht_dec_max_quad_threads(void) { return MAX_QUAD_THREADS; }

int ht_magsgn_decode(const void* qinfo, const void* pool,
                     long long pool_words, const void* woff, int nblocks,
                     int qh, int qw, int cbh, int cbw, void* out,
                     void* stream) {
  const int nq = qh * qw;
  int threads = ((nq + 31) / 32) * 32;
  threads = threads < 32 ? 32
                         : (threads > MAX_QUAD_THREADS ? MAX_QUAD_THREADS
                                                       : threads);
  magsgn_kernel<<<nblocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)qinfo, (const unsigned*)pool, pool_words,
      (const long long*)woff, qh, qw, cbh, cbw, (int*)out);
  return (int)cudaGetLastError();
}

int ht_blocks_to_pyramid(const void* table, int n_bands, int n_comps,
                         int n_frames, int nb, int cbh, int cbw, int is_float,
                         const void* coeffs, void* leaves, void* stream) {
  dim3 grid(nb, n_frames);
  to_pyramid_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n_bands, n_comps, nb, cbh, cbw, is_float,
      (const int*)coeffs, leaves);
  return (int)cudaGetLastError();
}

}  // extern "C"
