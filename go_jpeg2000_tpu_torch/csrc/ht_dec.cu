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
// * ht_magsgn_decode: one CUDA block of up to MS_THREADS threads per
//   code-block, each thread MS_QUADS consecutive quads (a 64x64 block: 256
//   threads of 4 quads; larger quad grids loop with a carry).  At its
//   start the CTA stages the block's MagSgn words in shared memory with
//   16-byte cp.async copies, from the 16-byte boundary at or below woff[b]
//   to woff[b + 1] and the word after it (the pool's end for the last
//   block), at most STAGE_WORDS words, so the copy overlaps the quad-word
//   loads (one 16-byte load a thread) and the scan.  Each thread decodes
//   its quad words and their field lengths m_n = rho_n ? U - ek_n : 0,
//   and one block-wide exclusive scan of the thread totals (warp shuffles
//   and shared memory, as ht_pack_bits in ht_enc.cu scans) gives each
//   thread its first field's bit position relative to the block's first
//   word, a 32-bit count (a block holds at most 4 * 255 bits a quad);
//   word indices add woff as int64, so a batch may hold more than 2^31
//   bits, the JAX package's limit.  A field is the funnel shift of two
//   consecutive words.  When every word a thread's fields read lies in the
//   window (blocks laid out one after another, as the parser lays them),
//   each field is two independent shared-memory loads; otherwise (a block
//   whose words overflow the window, offsets that are not contiguous)
//   each word comes from the window where it lies there and from device
//   memory elsewhere, clamped to the pool's last word as
//   jnp.take(mode="clip") clamps.  The mask is guarded when m could reach
//   32.  Four consecutive quads of a quad row are 8 samples of two rows,
//   stored as two 32-byte runs; an odd width, a quad row off 4 or a
//   partial row takes per-quad stores.  Quads that carry no code (word 0)
//   give 0.
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
#define MS_THREADS 256         // threads of a MagSgn CTA, at most
#define MS_QUADS 4             // consecutive quads a thread decodes
#define STAGE_WORDS 4096       // MagSgn words a CTA stages (16 KB)

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

// 16-byte cp.async into shared memory, zero-filled past `bytes` source
// bytes (cp-size 16, src-size bytes)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// end of the cp.async helpers

// Pool word i, clamped to the pool: from the staged window [a0, a0 + n)
// where it lies there, else from device memory.
__device__ __forceinline__ unsigned pool_word(const unsigned* win,
                                              long long a0, long long n,
                                              const unsigned* pool,
                                              long long last, long long i) {
  i = i < last ? i : last;
  i = i > 0 ? i : 0;
  const unsigned long long k = (unsigned long long)(i - a0);
  return k < (unsigned long long)n ? win[k] : pool[i];
}

// The fields of a thread's quads, from bit `rel` past the block's first
// word w0.  INSIDE: every word they read lies in the window (from word
// dw of it), so each field is two independent shared-memory loads and a
// funnel shift; otherwise each word goes through pool_word.
template <bool INSIDE>
__device__ __forceinline__ void decode_fields(
    const unsigned (&info)[MS_QUADS], int rel, int dw, const unsigned* win,
    long long a0, long long staged, const unsigned* pool, long long last,
    long long w0, int (&c)[MS_QUADS][4]) {
#pragma unroll
  for (int k = 0; k < MS_QUADS; ++k) {
    const int u = info[k] & 0xFF, rho = (info[k] >> 8) & 0xF;
    const int ek = (info[k] >> 12) & 0xF, e1 = (info[k] >> 16) & 0xF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mi = ((rho >> i) & 1) ? u - ((ek >> i) & 1) : 0;
      const int wi = rel >> 5;
      unsigned lo, hi;
      if (INSIDE) {
        lo = win[dw + wi];
        hi = win[dw + wi + 1];
      } else {
        lo = pool_word(win, a0, staged, pool, last, w0 + wi);
        hi = pool_word(win, a0, staged, pool, last, w0 + wi + 1);
      }
      unsigned v = __funnelshift_r(lo, hi, (unsigned)rel) &
                   (mi >= 32 ? 0xffffffffu : (1u << mi) - 1u);
      if (mi < 32) v |= (unsigned)((e1 >> i) & 1) << mi;
      const int mu = (int)((v >> 1) + 1u);
      c[k][i] = ((rho >> i) & 1) ? ((v & 1u) ? -mu : mu) : 0;
      rel += mi;
    }
  }
}

__global__ void __launch_bounds__(MS_THREADS) magsgn_kernel(
    const unsigned* __restrict__ qinfo, const unsigned* __restrict__ pool,
    long long pool_words, const long long* __restrict__ woff, int nb, int qh,
    int qw, int cbh, int cbw, int* __restrict__ out) {
  __shared__ __align__(16) unsigned win[STAGE_WORDS];
  __shared__ int sh[32];
  const int b = blockIdx.x;
  const int nq = qh * qw;
  const unsigned* qi = qinfo + (int64_t)b * nq;
  int* dst = out + (int64_t)b * cbh * cbw;
  const long long last = pool_words - 1;
  const long long w0 = woff[b];

  // stage the window
  long long a0 = w0 & ~3LL;
  a0 = a0 > 0 ? a0 : 0;
  long long a1 = b + 1 < nb ? woff[b + 1] + 1 : pool_words;
  a1 = min(a1, min(pool_words, a0 + STAGE_WORDS));
  const long long staged = a1 > a0 ? a1 - a0 : 0;
  if (!((uintptr_t)pool & 15)) {
    for (long long i = 4 * threadIdx.x; i < staged; i += 4 * blockDim.x)
      cp_async16(win + i, pool + a0 + i,
                 (int)min(16LL, 4 * (pool_words - a0 - i)));
  } else {
    for (long long i = threadIdx.x; i < staged; i += blockDim.x)
      win[i] = pool[a0 + i];
  }
  // the block's first word within the window (0-3 when staged)
  const long long dw64 = w0 - a0;
  const int dw = dw64 >= 0 && dw64 <= 3 ? (int)dw64 : 0;

  const bool vec = !(nq & 3) && !((uintptr_t)qinfo & 15);
  const bool wide = !(qw & 3) && !(cbw & 3);
  int base = 0;                // bits before this round's quads
  for (int q0 = 0; q0 < nq; q0 += MS_QUADS * blockDim.x) {
    const int qs = q0 + MS_QUADS * (int)threadIdx.x;
    unsigned info[MS_QUADS];
    if (vec && qs + MS_QUADS <= nq) {
      const uint4 v = *reinterpret_cast<const uint4*>(qi + qs);
      info[0] = v.x;
      info[1] = v.y;
      info[2] = v.z;
      info[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < MS_QUADS; ++k)
        info[k] = qs + k < nq ? qi[qs + k] : 0u;
    }
    int tot = 0;
#pragma unroll
    for (int k = 0; k < MS_QUADS; ++k) {
      const int u = info[k] & 0xFF, rho = (info[k] >> 8) & 0xF;
      const int ek = (info[k] >> 12) & 0xF;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tot += ((rho >> i) & 1) ? u - ((ek >> i) & 1) : 0;
    }
    int total;
    const int rel = base + block_exclusive_scan(tot, sh, &total);
    base += total;
    if (q0 == 0) {             // the window has landed, for every thread
      cp_async_wait_all();
      __syncthreads();
    }
    if (qs >= nq) continue;
    int c[MS_QUADS][4];
    // the last word the thread's fields read: the one after the word of
    // its last bit
    if (dw64 == dw && dw + ((rel + tot) >> 5) + 1 < staged)
      decode_fields<true>(info, rel, dw, win, a0, staged, pool, last, w0, c);
    else
      decode_fields<false>(info, rel, dw, win, a0, staged, pool, last, w0,
                           c);
    // n0..n3 = (0,0), (1,0), (0,1), (1,1): rows y and y + 1, columns x and
    // x + 1
    const int qy = qs / qw, qx = qs - qy * qw;
    const int y = 2 * qy, x = 2 * qx;
    if (wide && x + 2 * MS_QUADS <= cbw) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (y + r >= cbh) break;
        int4* row = reinterpret_cast<int4*>(dst + (int64_t)(y + r) * cbw + x);
        row[0] = make_int4(c[0][r], c[0][r + 2], c[1][r], c[1][r + 2]);
        row[1] = make_int4(c[2][r], c[2][r + 2], c[3][r], c[3][r + 2]);
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < MS_QUADS; ++k) {
      const int q = qs + k;
      if (q >= nq) break;
      const int ky = q / qw, kx = q - ky * qw;
      const int yk = 2 * ky, xk = 2 * kx;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (yk + r >= cbh) break;
        int* row = dst + (int64_t)(yk + r) * cbw + xk;
        if (xk + 1 < cbw && !(cbw & 1)) {
          *reinterpret_cast<int2*>(row) = make_int2(c[k][r], c[k][r + 2]);
        } else {
          if (xk < cbw) row[0] = c[k][r];
          if (xk + 1 < cbw) row[1] = c[k][r + 2];
        }
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
int ht_dec_stage_words(void) { return STAGE_WORDS; }
int ht_dec_quads_per_thread(void) { return MS_QUADS; }
int ht_dec_magsgn_threads(void) { return MS_THREADS; }

int ht_magsgn_decode(const void* qinfo, const void* pool,
                     long long pool_words, const void* woff, int nblocks,
                     int qh, int qw, int cbh, int cbw, void* out,
                     void* stream) {
  const int nq = qh * qw;
  const int per = (nq + MS_QUADS - 1) / MS_QUADS;
  int threads = ((per + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > MS_THREADS ? MS_THREADS : threads);
  magsgn_kernel<<<nblocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)qinfo, (const unsigned*)pool, pool_words,
      (const long long*)woff, nblocks, qh, qw, cbh, cbw, (int*)out);
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
