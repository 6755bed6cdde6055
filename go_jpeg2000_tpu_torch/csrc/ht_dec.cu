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
// * ht_blocks_to_pyramid: the mirror of ht_extract_blocks (ht_enc.cu), built
//   for bytes.  The leaves are views of one buffer, each leaf's start on a
//   16-byte boundary.  A warp takes one leaf row of a frame (AS_WARPS rows
//   a CTA) and walks the aligned 16-byte windows of the buffer that the row
//   falls in, AS_WINDOWS a lane a step, their gathers issued before any
//   store.  It reads the row's descriptor (block_layout.cuh: leaf, row
//   offset, first slot, slot row, grid offset, log2 cell width, quantizer
//   step), per frame and kept on the card, through the read-only cache;
//   each sample's slot and column are shifts and masks of its column.  A
//   window whose four samples sit in one slot row reads them with one
//   16-byte load where aligned, else with the two aligned windows of the
//   slot row they fall in, realigned in registers; a window across two grid
//   cells reads its samples one by one.  Only the slots' valid samples are
//   used.  Windows inside the row are stored whole, the row's end windows
//   (odd widths share them with the next row) by their own samples.  Lossy
//   plans write float32 sign(q) * (|q| + 0.5) * delta with __fadd_rn and
//   __fmul_rn (no FMA contraction, and this file must not be built with
//   --use_fast_math), as ops/quant.py dequantize rounds on the card and on
//   the CPU, so a CUDA decode equals the CPU decode bit for bit.
//
// Kernels launch on the caller's stream and allocate nothing; each entry
// point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_layout.cuh"

#define MS_THREADS 256         // threads of a MagSgn CTA, at most
#define MS_QUADS 4             // consecutive quads a thread decodes
#define STAGE_WORDS 4096       // MagSgn words a CTA stages (16 KB)

#define AS_WARPS 8             // leaf rows of an assembly CTA, a warp each
#define AS_WINDOWS 2           // 16-byte leaf windows a lane takes a step

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

// float32 bits of sign(q) * (|q| + 0.5) * delta, 0 for q = 0
__device__ __forceinline__ int dequant(int q, float delta) {
  const float a = __fmul_rn(__fadd_rn(__int2float_rn(abs(q)), 0.5f), delta);
  return __float_as_int(q < 0 ? -a : (q > 0 ? a : 0.f));
}

// Leaf row i of every frame: rows holds n_rows descriptors of a frame,
// leaf_off each leaf's element offset in the buffer (a multiple of 4).
template <bool FLOAT>
__global__ void __launch_bounds__(AS_WARPS * 32) to_pyramid_kernel(
    const int4* __restrict__ rows, const long long* __restrict__ leaf_off,
    int n_rows, int n_frames, int nb, int slot_shift,
    const int* __restrict__ coeffs, int* __restrict__ buf) {
  const int i = blockIdx.x * AS_WARPS + (threadIdx.x >> 5);
  if (i >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int4 d0 = __ldg(rows + 2 * i);       // leaf, bw, off, fstride
  const int4 d1 = __ldg(rows + 2 * i + 1);   // slot, srow, ox | lw, delta
  const int bw = d0.y, ox = d1.z & 0xFFFF, lw = d1.z >> 16;
  const int cmask = (1 << lw) - 1;
  const float delta = __int_as_float(d1.w);
  const int64_t row0 = __ldg(leaf_off + d0.x) + d0.z;
  for (int f = blockIdx.y; f < n_frames; f += gridDim.y) {
    const int64_t e0 = row0 + (int64_t)f * d0.w;   // the row's first sample
    const int64_t k0 = e0 >> 2, k1 = (e0 + bw - 1) >> 2;
    // word of the row's sample x in the slots: its cell's slot, slot row
    // and column (first-column cells hold theirs from column 0)
    const int* srow =
        coeffs + (((int64_t)f * nb + d1.x) << slot_shift) + d1.y;
    auto at = [&](int x) -> const int* {
      const int xs = x + ox, xx = xs >> lw;
      return srow + ((int64_t)xx << slot_shift) + (xs & cmask) -
             (xx ? 0 : ox);
    };
    for (int64_t k = k0 + lane; k <= k1; k += 32 * AS_WINDOWS) {
      int4 val[AS_WINDOWS];
#pragma unroll
      for (int u = 0; u < AS_WINDOWS; ++u) {
        const int64_t kk = k + 32 * u;
        if (kk > k1) break;
        const int x0 = (int)(4 * kk - e0);
        int w[4] = {0, 0, 0, 0};
        const int* p = x0 >= 0 && x0 + 4 <= bw ? at(x0) : nullptr;
        if (p && at(x0 + 3) == p + 3) {
          // one slot row: its aligned window(s), realigned
          const int m = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
          const int4 a = __ldg(reinterpret_cast<const int4*>(p - m));
          const int4 b = m ? __ldg(reinterpret_cast<const int4*>(p - m + 4))
                           : a;
          val[u] = realign_words(a, b, m);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (x0 + t >= 0 && x0 + t < bw) w[t] = __ldg(at(x0 + t));
          val[u] = make_int4(w[0], w[1], w[2], w[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < AS_WINDOWS; ++u) {
        const int64_t kk = k + 32 * u;
        if (kk > k1) break;
        int4 v = val[u];
        if (FLOAT)
          v = make_int4(dequant(v.x, delta), dequant(v.y, delta),
                        dequant(v.z, delta), dequant(v.w, delta));
        const int x0 = (int)(4 * kk - e0);
        if (x0 >= 0 && x0 + 4 <= bw) {
          reinterpret_cast<int4*>(buf)[kk] = v;
        } else {
          const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (x0 + t >= 0 && x0 + t < bw) buf[4 * kk + t] = w[t];
        }
      }
    }
  }
}

extern "C" {

int ht_dec_layout_fields(void) { return LAYOUT_FIELDS; }
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

// rows: n_rows leaf-row descriptors of a frame (LAYOUT_FIELDS int32 each,
// block_layout.cuh) and leaf_off: int64 element offsets of the leaves in
// the buffer, both on the card
int ht_blocks_to_pyramid(const void* rows, const void* leaf_off, int n_rows,
                         int n_frames, int nb, int cbh, int cbw, int is_float,
                         const void* coeffs, void* leaves, void* stream) {
  int slot_shift = 0;
  while ((1LL << slot_shift) < (long long)cbh * cbw) ++slot_shift;
  if (n_rows < 1 || n_frames < 1 || nb < 1 || cbw < 4 ||
      (1LL << slot_shift) != (long long)cbh * cbw || (cbw & (cbw - 1)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_rows + AS_WARPS - 1) / AS_WARPS,
            n_frames < 65535 ? n_frames : 65535);
  if (is_float)
    to_pyramid_kernel<true><<<grid, AS_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int4*)rows, (const long long*)leaf_off, n_rows, n_frames, nb,
        slot_shift, (const int*)coeffs, (int*)leaves);
  else
    to_pyramid_kernel<false><<<grid, AS_WARPS * 32, 0,
                               (cudaStream_t)stream>>>(
        (const int4*)rows, (const long long*)leaf_off, n_rows, n_frames, nb,
        slot_shift, (const int*)coeffs, (int*)leaves);
  return (int)cudaGetLastError();
}

}  // extern "C"
