// The device half of the fused HTJ2K encode, for NVIDIA Hopper (sm_90a):
// code-block extraction, the HT cleanup-pass fields, bit packing and stream
// compaction.
//
// Replaces the JAX package's TPU programs (written in jnp):
//   ht_extract_blocks  <- go_jpeg2000_tpu/models/fused_encode.py
//                         _extract_blocks (with the deadzone quantization
//                         of lossy plans)
//   ht_cleanup_pack    <- go_jpeg2000_tpu/ops/ht_tpu.py cleanup_fields (the
//                         field computation, with _direct_enc_table, _bitlen
//                         and _uvlc_fields, and the packing of its three
//                         streams, _pack_bits and _segmented_or_scan)
//   ht_compact_pool    <- go_jpeg2000_tpu/ops/ht_tpu.py compact_pool and
//                         cleanup_fields_compact
// The plain torch versions are go_jpeg2000_tpu_torch/models/fused_encode.py
// extract_blocks and ops/ht_enc.py cleanup_fields and assemble_pool; the
// wrappers, build and launch counts are in ops/ht_enc_cuda.py.  Every
// kernel's output equals its plain version's exactly (the distortion too:
// both sum float32 squares in float64 and round once).
//
// What bounds them on the H100: bytes, but for the cleanup kernel.  The
// others do a few integer operations per sample or word and move 8 to 16
// bytes per sample (the leaves, the block, the word rows, the pool), so
// their time is the bytes over the 3.35 TB/s of device memory, plus launch
// latency on small batches; the cleanup kernel reads 4 bytes a sample and
// writes about 4.4 (the rows at 31 bits a sample), and its few dozen
// integer operations a sample bound it.  What the TPU forms did about the
// TPU does not carry over: they sorted and OR-scanned because scatters
// serialize there.  Here:
//
// * ht_extract_blocks: built for bytes.  The slots are written whole, as
//   16-byte vectors in order: a thread stores EX_VECS vectors 256 apart, so
//   a warp writes 512 contiguous bytes a store (two 64-wide slot rows, or
//   eight 16-wide ones) and a CTA of 256 threads a 16 KB run of slots (one
//   64x64 slot, four 32x32 ones); every index is a shift or a mask, since
//   the slot sizes are powers of two.  Each lane reads its slot's
//   descriptor (block_layout.cuh: leaf, valid rows and columns, offsets,
//   quantizer step) through the read-only cache; the descriptors are per
//   frame and stay on the card, so nothing walks a table and no barrier
//   waits.  The leaves' pointers come by value (LeafPtrs), one per
//   distinct leaf.  A vector of the valid samples reads its four leaf
//   words with one 16-byte load where they are aligned, else from the one
//   or two aligned windows they fall in, realigned in registers (offset
//   grids, odd band widths); no load reaches outside the slot row's run of
//   the leaf.  Padding vectors (rows or columns past the band) are stored
//   as zeros with no load.  A batch may be a subset of the leaves' frames
//   (a tile-origin class of a tile batch): frame f then reads leaf frame
//   tiles[f], so no gathered copy of the leaves is made.  9/7 leaves are
//   quantized on the way: sign(c) * floor(|c| / delta) with IEEE division
//   (__fdiv_rn; this file must not be built with --use_fast_math), which
//   is what ops/quant.py quantize computes on the card and on the CPU;
//   -0.0 gives 0.
// * ht_cleanup_pack: one CUDA block per code-block, which computes every
//   field of the cleanup pass and packs the three streams itself, so no
//   field reaches device memory (the two kernels it replaced wrote 17
//   values and 17 lengths as int32 a quad pair, 69.6 KB a 64x64 block,
//   and read them back).  Every field is a pure function of the block's
//   coefficients, and the line state of a quad needs only the quad row
//   above, so nothing walks the block in sequence.  The block is read once
//   with 16-byte loads into shared memory, beside the three stream rows,
//   zeroed (at 64x64: 16 KB of block, 4 KB of quad info, a MagSgn row of at
//   most 15.5 KB, 2 KB of VLC and 192 bytes of MEL, about 38 KB: 5 CTAs an
//   SM).  Phase 1, one thread per quad, puts rho, the quad's largest
//   exponent and the n1/n3 exponents into shared memory (4 bytes a quad).
//   Phase 2 takes rounds of one quad pair a thread: each thread reads its
//   samples and neighbours there, looks up the 8192-entry direct VLC table
//   through the read-only cache (__ldg: lookups diverge, which constant
//   memory would serialize) and keeps the pair's 8 MagSgn, 6 VLC and 3 MEL
//   fields in registers; one block-wide exclusive scan of the pair's bit
//   counts (the three streams packed in one 64-bit sum: warp shuffles, the
//   warp totals through shared memory, a running base across rounds) gives
//   each pair its bit offset in each row, in pack_bits' order (pair-major,
//   LSB first); the thread gathers its fields in a 64-bit register and
//   puts each word as it fills: the words that lie whole inside its bits
//   are stored, its first and last word are ORed (atomicOr), since the
//   neighbouring pairs share them.  The rows then leave with 16-byte
//   stores, zeros past the stream included, with the bit counts.  numbps,
//   u_max and the distortion are block reductions (warp shuffles; the
//   distortion sums the float32 squares in double and rounds once).
// * ht_compact_pool: two launches, since the VLC and MEL rows' places need
//   the whole MagSgn and VLC totals.  The scan is one CTA of 1024 threads
//   over the three streams together, a thread a tile of 8 rows (a copy
//   CTA's): two 16-byte loads of each stream's bit counts, one
//   warp-shuffle scan and one barrier pair give every tile its offsets
//   (8192 rows a round, two rounds for a config-4 tile-origin class of
//   12,864 blocks, where the first version took 39 serial block scans and
//   wrote every row's offset); it writes the three totals.  The copy is a
//   warp per (row, stream), a tile a CTA: the warp finds its row's offset
//   from the tile's and the tile's word counts (a shuffle scan), moves the
//   row's used words with 16-byte loads and stores, realigned in registers
//   to the pool's phase (row_copy.cuh: interior windows whole, the two end
//   windows by the row's own bytes), and each CTA writes two of the six
//   meta rows for its tile.  The copy is a programmatic dependent launch
//   (Hopper): its CTAs start and write the meta rows while the scan runs,
//   then wait for the scan (griddepcontrol).  The output is allocated at
//   its bound by the wrapper, and only the used prefix [6*Nb | MagSgn |
//   VLC | MEL] is copied to the host.
//
// Kernels launch on the caller's stream and allocate nothing; each entry
// point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_layout.cuh"
#include "row_copy.cuh"

#define THREADS 256
#define SCAN_THREADS 1024      // threads of the pool scan (one CTA)
#define COPY_WARPS 8           // rows of a pool-copy CTA (a warp each): a tile
#define SCAN_ROWS (SCAN_THREADS * COPY_WARPS)   // rows scanned per round
#define HT_COPY_UNROLL 2       // windows a lane of the pool copy takes a step
#define TABLE_SIZE 8192

#define EX_THREADS 256         // threads of an extraction CTA
#define EX_VECS 4              // 16-byte slot vectors a thread stores

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ int bitlen(unsigned v) { return 32 - __clz(v); }

struct Uvlc {
  int p, pl, s, sl;
};

// UVLC prefix/suffix for a biased value t >= 1 (ops/ht.py
// _uvlc_encode_value)
__device__ __forceinline__ Uvlc uvlc(int t) {
  Uvlc r;
  r.p = t == 1 ? 1 : (t == 2 ? 2 : (t <= 4 ? 4 : 0));
  r.pl = t == 1 ? 1 : (t == 2 ? 2 : 3);
  r.s = t <= 2 ? 0 : (t <= 4 ? t - 3 : t - 5);
  r.sl = t <= 2 ? 0 : (t <= 4 ? 1 : 5);
  return r;
}

// ------------------------------------------------------ ht_extract_blocks

// sign(c) * floor(|c| / delta) of four float32 bit patterns
__device__ __forceinline__ int4 quantize4(int4 x, float delta) {
  int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float f = __int_as_float(w[k]);
    const int q = (int)floorf(__fdiv_rn(fabsf(f), delta));
    w[k] = f < 0.f ? -q : (f > 0.f ? q : 0);
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// Slot vector v of a frame (frame_vecs of them): slot j = v >> slot_shift,
// row r and first column c of the vector from v's low bits.  Frame f of the
// batch reads leaf frame tiles[f] (f where tiles is null).  A thread
// issues the loads of all its vectors before it quantizes or stores any.
template <bool FLOAT>
__global__ void __launch_bounds__(EX_THREADS) extract_kernel(
    const __grid_constant__ LeafPtrs leaves, const int4* __restrict__ desc,
    const int* __restrict__ tiles, int n_frames, int slot_shift,
    int row_shift, int frame_vecs, int4* __restrict__ out) {
  const int v0 = blockIdx.x * (EX_THREADS * EX_VECS) + threadIdx.x;
  const int slot_mask = (1 << slot_shift) - 1;
  const int row_mask = (1 << row_shift) - 1;
  for (int f = blockIdx.y; f < n_frames; f += gridDim.y) {
    const int64_t lf = tiles ? __ldg(tiles + f) : f;   // the leaf frame
    int4 val[EX_VECS];
    float delta[EX_VECS];
#pragma unroll
    for (int u = 0; u < EX_VECS; ++u) {
      const int v = v0 + u * EX_THREADS;
      val[u] = make_int4(0, 0, 0, 0);
      delta[u] = 1.f;
      if (v >= frame_vecs) continue;
      const int j = v >> slot_shift, w = v & slot_mask;
      const int r = w >> row_shift, c = (w & row_mask) << 2;
      const int4 d0 = __ldg(desc + 2 * j);          // leaf, rows, cols, bw
      if (r >= d0.y || c >= d0.z) continue;         // padding: no load
      const int4 d1 = __ldg(desc + 2 * j + 1);      // off, fstride, delta
      const int* lo = static_cast<const int*>(leaves.p[d0.x]) +
                      lf * d1.y + d1.x + r * d0.w;
      val[u] = run_words(lo + c, lo, lo + d0.z);
      delta[u] = __int_as_float(d1.z);
    }
    if (FLOAT) {
#pragma unroll
      for (int u = 0; u < EX_VECS; ++u) val[u] = quantize4(val[u], delta[u]);
    }
#pragma unroll
    for (int u = 0; u < EX_VECS; ++u) {
      const int v = v0 + u * EX_THREADS;
      if (v < frame_vecs) out[(int64_t)f * frame_vecs + v] = val[u];
    }
  }
}

// -------------------------------------------------------- ht_cleanup_pack

// The four samples of quad (qy, qx), n0..n3 = TL, BL, TR, BR, from the
// block in shared memory: magnitude and MagSgn value v = 2*(mag-1) + sign
// (0 for a zero or padded sample).
__device__ __forceinline__ void load_quad(const int* blk, int w, int hb,
                                          int wb, int qy, int qx, int qw,
                                          unsigned* v, unsigned* mag) {
  int2 rows[2] = {make_int2(0, 0), make_int2(0, 0)};
  if (qx < qw) {
    rows[0] = *reinterpret_cast<const int2*>(blk + 2 * qy * w + 2 * qx);
    rows[1] = *reinterpret_cast<const int2*>(blk + (2 * qy + 1) * w + 2 * qx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = 2 * qy + (i & 1), x = 2 * qx + (i >> 1);
    const int c = (i >> 1) ? rows[i & 1].y : rows[i & 1].x;
    const bool in = qx < qw && y < hb && x < wb;
    const unsigned m = in ? (unsigned)abs(c) : 0u;
    mag[i] = m;
    v[i] = m ? ((m - 1u) << 1) | (c < 0 ? 1u : 0u) : 0u;
  }
}

// One stream word of a pair at word index wi of its shared row: `owned`
// words lie whole inside the pair's bits and are stored, the others (the
// pair's first and last word, which it shares with its neighbours) ORed.
// Rows start zeroed, so zero words are skipped; words at or past n_words
// are dropped.
__device__ __forceinline__ void put_word(unsigned* row, int n_words, int wi,
                                         unsigned word, bool owned) {
  if (!word || wi >= n_words) return;
  if (owned)
    row[wi] = word;
  else
    atomicOr(&row[wi], word);
}

// A pair's N fields of one stream (lengths 0 .. 31, LSB first, in stream
// order) at bit offset off of the stream's shared row: the fields gather
// in a 64-bit register, each whole word leaves as it fills.
template <int N>
__device__ __forceinline__ void put_fields(unsigned* row, int n_words,
                                           unsigned off, const int* v,
                                           const int* l) {
  int wi = (int)(off >> 5), nb = (int)(off & 31);
  uint64_t acc = 0;
  bool first = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (!l[k]) continue;
    acc |= (uint64_t)((unsigned)v[k] & ((1u << l[k]) - 1u)) << nb;
    nb += l[k];                                 // at most 31 + 31
    if (nb >= 32) {
      put_word(row, n_words, wi, (unsigned)acc, !first);
      first = false;
      ++wi;
      acc >>= 32;
      nb -= 32;
    }
  }
  if (nb) put_word(row, n_words, wi, (unsigned)acc, false);
}

// The rows of one stream: `words` int32 [Nb, n_words], `bits` [Nb].
struct StreamOut {
  int* words;
  int* bits;
  int n_words;
};
struct CleanupOut {
  StreamOut s[3];                               // MagSgn, VLC, MEL
};

// Words rounded up to whole 16-byte vectors.
__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) & ~3;
}

// Dynamic shared memory: the block [h * w] | quad info [qh * qwp] | the
// MagSgn, VLC and MEL rows, each from a 16-byte boundary.  The quad info
// word is rho | emax << 8 | e(n1) << 16 | e(n3) << 24.
__global__ void __launch_bounds__(THREADS) cleanup_pack_kernel(
    const int* __restrict__ coeffs, const int* __restrict__ hs,
    const int* __restrict__ ws, int h, int w,
    const int* __restrict__ tbl, const CleanupOut out,
    int* __restrict__ numbps, int* __restrict__ u_max,
    float* __restrict__ dist) {
  extern __shared__ __align__(16) int smem[];
  __shared__ unsigned s_maxmag;
  __shared__ int s_umax;
  __shared__ double s_dist[THREADS / 32];
  __shared__ unsigned long long s_warp[2][THREADS / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int qh = h >> 1, qw = w >> 1, qwp = qw + (qw & 1), pairs = qwp >> 1;
  const int hb = min(hs[b], h), wb = min(ws[b], w);
  const int n_ms = out.s[0].n_words, n_vl = out.s[1].n_words,
            n_me = out.s[2].n_words;
  int* blk = smem;
  int* qinfo = smem + h * w;
  unsigned* ms_row = reinterpret_cast<unsigned*>(qinfo + round4(qh * qwp));
  unsigned* vl_row = ms_row + round4(n_ms);
  unsigned* me_row = vl_row + round4(n_vl);
  if (threadIdx.x == 0) {
    s_maxmag = 0u;
    s_umax = 0;
  }

  // the block, read once with 16-byte loads (h * w is a multiple of 4),
  // and the three rows zeroed
  const int4* src = reinterpret_cast<const int4*>(coeffs + (int64_t)b * h * w);
#pragma unroll 4
  for (int i = threadIdx.x; i < (h * w) >> 2; i += blockDim.x)
    reinterpret_cast<int4*>(blk)[i] = __ldg(src + i);
  const int row4 = (round4(n_ms) + round4(n_vl) + round4(n_me)) >> 2;
  for (int i = threadIdx.x; i < row4; i += blockDim.x)
    reinterpret_cast<int4*>(ms_row)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // phase 1: one thread per quad
  unsigned maxmag = 0u;
  double dsum = 0.0;
  for (int q = threadIdx.x; q < qh * qwp; q += blockDim.x) {
    const int qy = q / qwp, qx = q - (q / qwp) * qwp;
    unsigned v[4], mag[4];
    load_quad(blk, w, hb, wb, qy, qx, qw, v, mag);
    int rho = 0, emax = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (mag[i]) rho |= 1 << i;
      emax = max(emax, bitlen(v[i]));
      maxmag = max(maxmag, mag[i]);
      const float fm = (float)mag[i];
      dsum += (double)__fmul_rn(fm, fm);
    }
    qinfo[q] = rho | (emax << 8) | (bitlen(v[1]) << 16) | (bitlen(v[3]) << 24);
  }
  __syncthreads();

  // phase 2: a round of blockDim.x consecutive quad pairs, one a thread;
  // each pair's fields stay in registers while one scan of their lengths
  // (the three streams' sums packed in 64 bits: MagSgn below bit 32, VLC
  // below 48, MEL above; no sum carries into the next) gives every pair
  // its bit offset in each row, in pack_bits' order (pair-major)
  const int qh_b = (hb + 1) >> 1, qw_b = (wb + 1) >> 1;
  const int npairs = qh * pairs;
  int umax = 0, parity = 0;
  unsigned long long carry = 0;
  for (int rb = 0; rb < npairs; rb += blockDim.x) {
    const int pi = rb + threadIdx.x;
    int msv[8], msl[8], vlv[6], vll[6], mev[3], mel[3];
#pragma unroll
    for (int i = 0; i < 8; ++i) msv[i] = msl[i] = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) vlv[i] = vll[i] = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) mev[i] = mel[i] = 0;
    if (pi < npairs) {
      const int qy = pi / pairs, p = pi - (pi / pairs) * pairs;
      const bool init = qy == 0;
      const int* row = qinfo + qy * qwp;
      const int* up = row - qwp;  // the quad row above (not read when init)
      int u[2], kap[2], uoff[2], rhos[2], azc[2], cwd[2], cwdl[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int qx = 2 * p + k;
        const int info = row[qx];
        const int rho = info & 15, emax = (info >> 8) & 0xFF;
        const int rho_w = qx > 0 ? (row[qx - 1] & 15) : 0;
        int ctx, kappa;
        if (init) {
          ctx = ((rho_w & 1) | (rho_w >> 1)) & 7;
          kappa = 1;
        } else {
          // line state entry q <- n1 of quad q and n3 of quad q-1 (row
          // above)
          int ls_sig[2], ls_e[2];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int q = qx + t;
            int s = 0, e = 0;
            if (q < qwp) {
              s |= (up[q] >> 1) & 1;
              e = max(e, (up[q] >> 16) & 0xFF);
            }
            if (q >= 1) {
              s |= (up[q - 1] >> 3) & 1;
              e = max(e, (up[q - 1] >> 24) & 0xFF);
            }
            ls_sig[t] = s;
            ls_e[t] = e;
          }
          ctx = ls_sig[0] | (((rho_w & 0xC) != 0) << 1) | (ls_sig[1] << 2);
          kappa = __popc(rho) > 1 ? max(1, max(ls_e[0], ls_e[1]) - 1) : 1;
        }
        const bool exists = qx < qw_b && qy < qh_b;
        const bool coded = exists && (ctx != 0 || rho != 0);
        const int uu = max(kappa, emax);
        const int uo = (uu - kappa > 0) && coded;
        if (coded) umax = max(umax, uu);

        unsigned v[4], mag[4];
        load_quad(blk, w, hb, wb, qy, qx, qw, v, mag);
        const int ush = max(uu - 1, 0);
        int msb = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) msb |= (int)((v[i] >> ush) & 1u) << i;
        const int idx =
            ((((init ? 0 : 1) * 8 + ctx) * 16 + rho) * 2 + uo) * 16 + msb;
        const int entry = __ldg(tbl + idx);
        const int cl = coded ? (entry >> 16) & 0xF : 0;
        const int ek = (entry >> 4) & 0xF;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = min(max(uu - ((ek >> i) & 1), 0), 31);
          const int len = (((rho >> i) & 1) && coded) ? m : 0;
          msv[4 * k + i] = len ? (int)v[i] : 0;
          msl[4 * k + i] = len;
        }
        u[k] = uu;
        kap[k] = kappa;
        uoff[k] = uo;
        rhos[k] = rho;
        azc[k] = exists && ctx == 0;
        cwd[k] = cl ? (entry >> 8) & 0xFF : 0;
        cwdl[k] = cl;
      }

      // per-pair u coding (initial stripe: the "big" pair form) and MEL
      const int mode = uoff[0] + 2 * uoff[1];
      const int u0i = u[0] - 1, u1i = u[1] - 1;
      const bool big = u0i > 2 && u1i > 2;
      const bool m3 = mode == 3, m1 = mode == 1, m2 = mode == 2;
      int sv[4], sl[4];
      if (init) {
        const Uvlc I0 = uvlc(max(u0i, 1)), I1 = uvlc(max(u1i, 1));
        const Uvlc B0 = uvlc(max(u0i - 2, 1)), B1 = uvlc(max(u1i - 2, 1));
        const bool u0b = u0i > 2;
        sv[0] = m3 ? (big ? B0.p : I0.p) : (m1 ? I0.p : (m2 ? I1.p : 0));
        sl[0] = m3 ? (big ? B0.pl : I0.pl) : (m1 ? I0.pl : (m2 ? I1.pl : 0));
        sv[1] = m3 ? (big ? B1.p : (u0b ? u1i - 1 : I1.p))
                   : (m1 ? I0.s : (m2 ? I1.s : 0));
        sl[1] = m3 ? (big ? B1.pl : (u0b ? 1 : I1.pl))
                   : (m1 ? I0.sl : (m2 ? I1.sl : 0));
        sv[2] = m3 ? (big ? B0.s : I0.s) : 0;
        sl[2] = m3 ? (big ? B0.sl : I0.sl) : 0;
        sv[3] = m3 ? (big ? B1.s : (u0b ? 0 : I1.s)) : 0;
        sl[3] = m3 ? (big ? B1.sl : (u0b ? 0 : I1.sl)) : 0;
      } else {
        const Uvlc N0 = uvlc(max(u[0] - kap[0], 1));
        const Uvlc N1 = uvlc(max(u[1] - kap[1], 1));
        sv[0] = (m3 || m1) ? N0.p : (m2 ? N1.p : 0);
        sl[0] = (m3 || m1) ? N0.pl : (m2 ? N1.pl : 0);
        sv[1] = m3 ? N1.p : (m1 ? N0.s : (m2 ? N1.s : 0));
        sl[1] = m3 ? N1.pl : (m1 ? N0.sl : (m2 ? N1.sl : 0));
        sv[2] = m3 ? N0.s : 0;
        sl[2] = m3 ? N0.sl : 0;
        sv[3] = m3 ? N1.s : 0;
        sl[3] = m3 ? N1.sl : 0;
      }
      vlv[0] = cwd[0];
      vlv[1] = cwd[1];
      vll[0] = cwdl[0];
      vll[1] = cwdl[1];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        vlv[2 + t] = sv[t];
        vll[2 + t] = sl[t];
      }
      mev[0] = rhos[0] != 0;
      mev[1] = rhos[1] != 0;
      mev[2] = big;
      mel[0] = azc[0];
      mel[1] = azc[1];
      mel[2] = init && m3;
    }

    // the pair's bits per stream, then the block-wide exclusive scan
    unsigned nms = 0, nvl = 0, nme = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) nms += msl[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) nvl += vll[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) nme += mel[i];
    const unsigned long long own = nms | (unsigned long long)nvl << 32 |
                                   (unsigned long long)nme << 48;
    unsigned long long incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[parity][warp] = incl;
    __syncthreads();
    unsigned long long off = carry + incl - own;
    for (int k = 0; k < nwarps; ++k) {
      const unsigned long long t = s_warp[parity][k];
      off += k < warp ? t : 0ull;
      carry += t;
    }
    parity ^= 1;
    put_fields<8>(ms_row, n_ms, (unsigned)off, msv, msl);
    put_fields<6>(vl_row, n_vl, (unsigned)(off >> 32) & 0xFFFFu, vlv, vll);
    put_fields<3>(me_row, n_me, (unsigned)(off >> 48), mev, mel);
  }
  __syncthreads();

  // the rows out, 16-byte stores where the row is 16-byte aligned
  const unsigned* rows[3] = {ms_row, vl_row, me_row};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int n = out.s[s].n_words;
    int* dst = out.s[s].words + (int64_t)b * n;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x)
        reinterpret_cast<int4*>(dst)[i] =
            reinterpret_cast<const int4*>(rows[s])[i];
      done = n & ~3;
    }
    for (int i = done + threadIdx.x; i < n; i += blockDim.x)
      dst[i] = (int)rows[s][i];
  }

  // block reductions: numbps, u_max, distortion
  for (int o = 16; o > 0; o >>= 1) {
    maxmag = max(maxmag, __shfl_down_sync(0xffffffffu, maxmag, o));
    umax = max(umax, __shfl_down_sync(0xffffffffu, umax, o));
    dsum += __shfl_down_sync(0xffffffffu, dsum, o);
  }
  if (lane == 0) {
    atomicMax(&s_maxmag, maxmag);
    atomicMax(&s_umax, umax);
    s_dist[warp] = dsum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int i = 0; i < nwarps; ++i) t += s_dist[i];
    numbps[b] = bitlen(s_maxmag);
    u_max[b] = max(1, s_umax);
    dist[b] = (float)t;
    out.s[0].bits[b] = (int)(carry & 0xFFFFFFFFull);
    out.s[1].bits[b] = (int)((carry >> 32) & 0xFFFFull);
    out.s[2].bits[b] = (int)(carry >> 48);
  }
}

// -------------------------------------------------------- ht_compact_pool

// A row's used words, ceil(bits / 32).
__device__ __forceinline__ int row_words(int bits) {
  return (int)(((long long)bits + 31) >> 5);
}

static_assert(COPY_WARPS == 8, "tile_words loads a tile as two int4");

// The word count of the tile of COPY_WARPS rows from r0 (rows past nb
// count 0): two 16-byte loads when the tile is whole and bits aligned.
__device__ __forceinline__ int tile_words(const int* __restrict__ bits,
                                          int r0, int nb) {
  int w = 0;
  if (r0 + COPY_WARPS <= nb && (reinterpret_cast<uintptr_t>(bits) & 15) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(bits + r0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(bits + r0) + 1);
    w = row_words(a.x) + row_words(a.y) + row_words(a.z) + row_words(a.w) +
        row_words(b.x) + row_words(b.y) + row_words(b.z) + row_words(b.w);
  } else {
    for (int r = r0; r < min(r0 + COPY_WARPS, nb); ++r)
      w += row_words(__ldg(bits + r));
  }
  return w;
}

// tiles[s * ntiles + x]: stream s's word offset, in its pool, of tile x
// (rows x * COPY_WARPS on, one copy CTA's); totals[s] the stream's total.
// A thread a tile, SCAN_THREADS tiles a round.
__global__ void __launch_bounds__(SCAN_THREADS) ht_pool_scan_kernel(
    const int* __restrict__ ms_bits, const int* __restrict__ vlc_bits,
    const int* __restrict__ mel_bits, int nb, long long* __restrict__ tiles,
    long long* __restrict__ totals) {
  __shared__ long long warp_incl[3][32];
  // the copy grid may launch now; it waits for this grid's end to read
  asm volatile("griddepcontrol.launch_dependents;");
  const int* bits_of[3] = {ms_bits, vlc_bits, mel_bits};
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ntiles = (nb + COPY_WARPS - 1) / COPY_WARPS;
  long long carry[3] = {0, 0, 0};
  for (int base = 0; base < nb; base += SCAN_ROWS) {
    const int tile = base / COPY_WARPS + t;
    int own[3];
#pragma unroll
    for (int s = 0; s < 3; ++s)
      own[s] = tile_words(bits_of[s], tile * COPY_WARPS, nb);
    long long incl[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      long long v = own[s];               // at most 8 * 2^26 words
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      incl[s] = v;
      if (lane == 31) warp_incl[s][warp] = v;
    }
    __syncthreads();
    if (warp < 3) {                         // warp s scans stream s's warps
      long long v = warp_incl[warp][lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      warp_incl[warp][lane] = v;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (tile < ntiles)
        tiles[(long long)s * ntiles + tile] =
            carry[s] + (warp ? warp_incl[s][warp - 1] : 0) + incl[s] - own[s];
      carry[s] += warp_incl[s][31];
    }
    __syncthreads();                        // the next round rewrites
  }
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < 3; ++s) totals[s] = carry[s];
  }
}

// A warp per (row, stream) moves the row's used words to the pool; CTA
// (x, s) also writes meta rows 2s and 2s + 1 of its COPY_WARPS rows.
__global__ void __launch_bounds__(COPY_WARPS * 32) ht_pool_copy_kernel(
    const int* __restrict__ ms_words, int mw, const int* __restrict__ vlc_words,
    int vw, const int* __restrict__ mel_words, int ew,
    const int* __restrict__ ms_bits, const int* __restrict__ vlc_bits,
    const int* __restrict__ mel_bits, const int* __restrict__ numbps,
    const int* __restrict__ u_max, const int* __restrict__ dist_bits,
    const long long* __restrict__ tiles, const long long* __restrict__ totals,
    int nb, int* __restrict__ out) {
  const int s = blockIdx.y, lane = threadIdx.x & 31;
  const int first = blockIdx.x * COPY_WARPS;
  if (threadIdx.x < 2 * COPY_WARPS) {
    const int m = 2 * s + threadIdx.x / COPY_WARPS;
    const int r = first + threadIdx.x % COPY_WARPS;
    const int* meta[6] = {ms_bits, vlc_bits, mel_bits, numbps, u_max,
                          dist_bits};
    if (r < nb) out[(long long)m * nb + r] = meta[m][r];
  }
  // the scan's offsets and totals: wait for the scan grid to finish
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int warp = threadIdx.x >> 5, row = first + warp;
  if (row >= nb) return;
  const int* words = s == 0 ? ms_words : (s == 1 ? vlc_words : mel_words);
  const int width = s == 0 ? mw : (s == 1 ? vw : ew);
  const int* bits = s == 0 ? ms_bits : (s == 1 ? vlc_bits : mel_bits);
  // the tile's word counts, one a lane; the warp's row sits at the tile's
  // offset plus the counts of the rows before it
  const int cnt = lane < COPY_WARPS && first + lane < nb
                      ? row_words(__ldg(bits + first + lane))
                      : 0;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < COPY_WARPS; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int before = __shfl_sync(0xffffffffu, incl - cnt, warp);
  const int nw = min(width, __shfl_sync(0xffffffffu, cnt, warp));
  const int ntiles = (nb + COPY_WARPS - 1) / COPY_WARPS;
  const long long at = 6 * (long long)nb + (s >= 1 ? totals[0] : 0) +
                       (s == 2 ? totals[1] : 0) +
                       tiles[(long long)s * ntiles + blockIdx.x] + before;
  warp_copy<HT_COPY_UNROLL>(
      reinterpret_cast<uint8_t*>(out + at),
      reinterpret_cast<const uint8_t*>(words + (long long)row * width),
      4 * (long long)nw, lane);
}

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return 0;
}

extern "C" {

int ht_enc_layout_fields(void) { return LAYOUT_FIELDS; }
int ht_enc_max_leaves(void) { return MAX_LEAVES; }
int ht_enc_table_size(void) { return TABLE_SIZE; }

static int log2_exact(long long v) {
  int s = 0;
  while ((1LL << s) < v) ++s;
  return (1LL << s) == v ? s : -1;
}

// desc: nb slot descriptors (LAYOUT_FIELDS int32 each, block_layout.cuh) on
// the card; leaf_ptrs: n_leaves host pointers, passed by value; tiles: null,
// or int32 [n_frames] on the card, the leaf frame of each batch frame
int ht_extract_blocks(const void* desc, const void* const* leaf_ptrs,
                      int n_leaves, int n_frames, int nb, int cbh, int cbw,
                      int is_float, const void* tiles, void* out,
                      void* stream) {
  const int slot_shift = log2_exact((long long)cbh * cbw / 4);
  const int row_shift = log2_exact(cbw / 4);
  const long long frame_vecs = (long long)nb * cbh * cbw / 4;
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n_frames < 1 || nb < 1 ||
      cbw < 4 || slot_shift < 0 || row_shift < 0 ||
      frame_vecs > (1LL << 31) - EX_THREADS * EX_VECS)
    return (int)cudaErrorInvalidValue;
  LeafPtrs leaves = {};
  for (int i = 0; i < n_leaves; ++i) leaves.p[i] = leaf_ptrs[i];
  const int per_cta = EX_THREADS * EX_VECS;
  dim3 grid((unsigned)((frame_vecs + per_cta - 1) / per_cta),
            n_frames < 65535 ? n_frames : 65535);
  if (is_float)
    extract_kernel<true><<<grid, EX_THREADS, 0, (cudaStream_t)stream>>>(
        leaves, (const int4*)desc, (const int*)tiles, n_frames, slot_shift,
        row_shift, (int)frame_vecs, (int4*)out);
  else
    extract_kernel<false><<<grid, EX_THREADS, 0, (cudaStream_t)stream>>>(
        leaves, (const int4*)desc, (const int*)tiles, n_frames, slot_shift,
        row_shift, (int)frame_vecs, (int4*)out);
  return (int)cudaGetLastError();
}

// threads of the cleanup kernel for h x w blocks: a thread per quad pair,
// at least 2 and at most THREADS / 32 warps
static int cleanup_threads(int h, int w) {
  const int qw = w >> 1, npairs = (h >> 1) * ((qw + (qw & 1)) >> 1);
  const int t = (npairs + 31) / 32 * 32;
  return t < 64 ? 64 : (t > THREADS ? THREADS : t);
}

static size_t cleanup_smem(int h, int w, int n_ms, int n_vl, int n_me) {
  const int qw = w >> 1, quads = (h >> 1) * (qw + (qw & 1));
  return sizeof(int) * ((size_t)h * w + round4(quads) + round4(n_ms) +
                        round4(n_vl) + round4(n_me));
}

// coeffs int32 [nblocks, h, w]; the three streams' word rows [nblocks,
// n_words] and bit counts [nblocks]
int ht_cleanup_pack(const void* coeffs, const void* hs, const void* ws,
                    int nblocks, int h, int w, const void* tbl,
                    void* ms_words, int ms_n, void* ms_bits,
                    void* vlc_words, int vlc_n, void* vlc_bits,
                    void* mel_words, int mel_n, void* mel_bits,
                    void* numbps, void* u_max, void* dist, void* stream) {
  if (nblocks < 1 || h < 2 || w < 2 || (h & 1) || (w & 1) || ms_n < 0 ||
      vlc_n < 0 || mel_n < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cleanup_smem(h, w, ms_n, vlc_n, mel_n);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int rc = set_smem((const void*)cleanup_pack_kernel, smem);
  if (rc) return rc;
  CleanupOut out = {{{(int*)ms_words, (int*)ms_bits, ms_n},
                     {(int*)vlc_words, (int*)vlc_bits, vlc_n},
                     {(int*)mel_words, (int*)mel_bits, mel_n}}};
  cleanup_pack_kernel<<<nblocks, cleanup_threads(h, w), smem,
                        (cudaStream_t)stream>>>(
      (const int*)coeffs, (const int*)hs, (const int*)ws, h, w,
      (const int*)tbl, out, (int*)numbps, (int*)u_max, (float*)dist);
  return (int)cudaGetLastError();
}

// offs: int64 scratch of at least 3 * ceil(nb / COPY_WARPS) (the tiles'
// offsets)
int ht_compact_pool(const void* ms_words, int mw, const void* ms_bits,
                    const void* vlc_words, int vw, const void* vlc_bits,
                    const void* mel_words, int ew, const void* mel_bits,
                    const void* numbps, const void* u_max, const void* dist,
                    int nb, void* offs, void* totals, void* out,
                    void* stream) {
  ht_pool_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)ms_bits, (const int*)vlc_bits, (const int*)mel_bits, nb,
      (long long*)offs, (long long*)totals);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid((nb + COPY_WARPS - 1) / COPY_WARPS, 3);
  // a programmatic dependent launch: the copy's CTAs start (and write the
  // meta rows) while the scan runs, and wait for it before reading offsets
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(COPY_WARPS * 32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(
      &cfg, ht_pool_copy_kernel, (const int*)ms_words, mw,
      (const int*)vlc_words, vw, (const int*)mel_words, ew,
      (const int*)ms_bits, (const int*)vlc_bits, (const int*)mel_bits,
      (const int*)numbps, (const int*)u_max, (const int*)dist,
      (const long long*)offs, (const long long*)totals, nb, (int*)out);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
