// The device half of the Part-1 (EBCOT) lossless encode, for NVIDIA Hopper
// (sm_90a): the Tier-1 decisions, their compaction, the MQ coder and the
// byte pool.
//
// Replaces the JAX package's TPU programs (written in jnp):
//   ebcot_decision_slots <- go_jpeg2000_tpu/ops/ebcot_device.py
//                           decision_slots (with _plane_slots)
//   ebcot_compact_rows   <- go_jpeg2000_tpu/ops/mq_device.py compact_rows
//                           then pool_rows, on the decision rows
//   ebcot_mq_encode      <- go_jpeg2000_tpu/ops/mq_device.py mq_encode_scan
//                           (with _one_decision, _byteout, _flush) and the
//                           compact_rows(drop_first) of its staging rows
//   ebcot_pool_rows      <- go_jpeg2000_tpu/ops/mq_device.py pool_rows, on
//                           the MQ segment rows
// The plain torch versions are go_jpeg2000_tpu_torch/ops/ebcot_device.py
// decision_slots and ops/mq_device.py; the wrappers, build and launch
// counts are in ops/ebcot_cuda.py.  Every output equals its plain
// version's exactly.
//
// What bounds them on the H100:
// * ebcot_decision_slots: operations.  It writes one byte per potential
//   decision, 5.75 bytes per sample and bitplane for 64x64 blocks (145 MB
//   for 560 blocks and 11 planes), and does some 200 integer operations
//   per sample and coded plane.  No state crosses a plane (each plane's
//   flags come from the magnitudes alone), so the grid is one CUDA block
//   per (code-block, plane), 128 threads: 6,160 CTAs for 560 blocks of 11
//   planes instead of 560 CTAs that each walk their planes in series.  A
//   small pre-pass (block_stats_kernel) finds each block's largest valid
//   magnitude and last valid row; a CTA whose plane is at or above the
//   block's bit count fills its plane's slots with 0xFF by 16-byte stores
//   and exits.  A live CTA keeps its plane's state as one 32-bit word per
//   stripe column, a nibble per flag with row r in bit r (under 5 KB for
//   64x64), so a sample's 8 neighbours come from the 3 x 3 words around
//   its column by shifts, with no byte loads.  SPP membership is a monotone
//   fixpoint: each thread takes runs of RUN_COLS consecutive columns of a
//   stripe and resolves them in visiting order (rows inside a column,
//   columns inside the run) from the previous sweep's values of the column
//   left of the run and of the stripe above (double-buffered), until a
//   sweep changes nothing (__syncthreads_or); a chain moves RUN_COLS
//   columns and one stripe a sweep, where the whole-block Jacobi sweep of
//   the plain version moves one sample.  Every iterate lies below the
//   unique fixpoint (the dependence follows the visiting order), so the
//   result is exact on any input.  MRP and the cleanup pass, run-length
//   test included, are closed-form, one thread per column; the plane's
//   slots are staged in shared memory (the cleanup's stride-11 bytes
//   stay there) and leave with 16-byte stores.
// * ebcot_compact_rows: bytes (it reads the slots and writes the decision
//   pool).  Each row is cut into chunks of a fixed length (the wrapper's
//   COMPACT_CHUNK bytes; any row length), and a CUDA block per (row, chunk)
//   counts the chunk's decisions from 16-byte loads, four slots at a time
//   (__vsetne4 and __popc); a head or tail off 16 bytes is read by bytes
//   and its bytes outside the chunk count as 0xFF.  One block sums each
//   row's chunk counts (a thread a row) and scans the rows (offsets, total,
//   largest count).  Then a CUDA block per (row, chunk) whose count is not
//   0 (a chunk of 0xFF fill, such as the decision kernel's planes above a
//   block's bit count, is not read again) finds its place in the pool (the
//   row's offset and the counts of the row's chunks before it), loads the
//   chunk by 16 bytes, gives each live byte its place by a block scan of
//   per-thread counts (warp shuffles), stages the chunk's decisions in
//   shared memory at the pool's alignment, and writes them by 16-byte
//   stores, by bytes only in the two windows it shares with its
//   neighbours.  The TPU form sorted (scatters serialize there); here the
//   scan gives each decision its place.
// * ebcot_mq_encode: the serial dependence of the MQ coder: the time is
//   the longest block's decision count times the latency of one decision's
//   dependent chain, so the design is for latency.  Two warps code each
//   code-block (MQ_PAIRS blocks a CTA: two a CTA ran faster than one on
//   the H100, PERF.md), and lane 0 of each runs one half of the C.3
//   encoder, so neither loop diverges and no global load sits on either
//   chain.  The model warp stages the block's decisions in shared memory in
//   chunks of MQ_CHUNK bytes with 16-byte cp.async copies from the aligned
//   address below the stream (double-buffered: chunk t+1 is in flight while
//   chunk t is coded) and runs A and the context states: each context keeps
//   its state word (Qe, state index, SWITCH, MPS) and the words of its two
//   successor states in a shared-memory slot; the next decision's slot is
//   loaded before this decision's store (a select repairs the case of one
//   context twice in a row) and the successors' successors come from a
//   47-entry table in one load each, so the new slot is ready whichever way
//   the decision goes; the MPS/LPS cases and the conditional exchange are
//   selects and A renormalizes in closed form (n = clz16(A) shifts).  Per
//   decision it writes a record (the Qe that C takes, n) to a shared ring.
//   The byte warp runs C and CT over the records of the chunk before (a
//   named barrier per chunk joins the two), with BYTEOUT and stuffing when
//   the shifts reach CT (at most three CT-bounded chunks, as the TPU form),
//   commits bytes (final once committed: a carry only changes the byte
//   still held in a register) to a shared-memory buffer, and writes them to
//   the segment row with coalesced stores after every chunk and after the
//   flush.  A decision commits at most 3 bytes (at most 15 renormalization
//   shifts, and a BYTEOUT reloads CT with at least 7) and the flush at most
//   3, so a row of 3 * ndec + 3 bytes always holds the segment.
// * ebcot_pool_rows: bytes, in one launch.  A CTA of POOL_WARPS warps owns
//   a tile of consecutive rows, a run of rows a warp.  It finds the tile's
//   place in the pool by summing the lengths of every row before the tile
//   itself (16-byte loads, from L2 after the first CTAs): no CTA waits on
//   another's published prefix, so no scheduling order can deadlock and no
//   flags need zeroing before the launch.  A warp sum per run and one
//   barrier give each warp its base; each warp then copies its rows in
//   turn with 16-byte loads and stores, realigned in registers to the
//   pool's phase (row_copy.cuh), and the tile holding the last row writes
//   the total.  A row per warp while the grid stays under POOL_MAX_CTAS
//   CTAs, so the lengths summed over all CTAs stay under POOL_MAX_CTAS *
//   nb.  The pool is allocated at its bound and only its used prefix is
//   copied to the host.
//
// Kernels launch on the caller's stream and allocate nothing; each entry
// point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_copy.cuh"

#define DEC_THREADS 128        // threads of a (code-block, plane) CTA
#define STATS_THREADS 256
#define RUN_COLS 8             // columns a thread resolves in order per sweep
#define STAGE_COLS 1024        // columns whose slots a CTA stages at a time
#define CMP_THREADS 256        // threads of a compaction CTA
#define CMP_TILES 3            // 16-byte windows a compaction thread holds
// the longest chunk a compaction CTA takes: its 16-byte windows, one more
// for a start off 16 bytes, fit CMP_TILES * CMP_THREADS
#define CMP_MAX_CHUNK ((CMP_TILES * CMP_THREADS - 1) * 16)
#define SCAN_THREADS 1024
#define POOL_WARPS 4           // warps of a segment-pool CTA, a row run each
#define POOL_MAX_CTAS 1024     // grid size above which the runs grow
#define POOL_COPY_UNROLL 4     // windows a segment-copy lane takes a step
#define MQ_PAIRS 2             // code-blocks (two warps each) per CTA
#define MQ_CHUNK 1024          // decision bytes a warp stages at a time
#define NUM_CTX 19
#define NUM_QE 47
#define EMPTY 0xFF
#define SLOTS_PER_COLUMN 23
#define MAX_PLANES 29

// bytes of the decision kernel's slot stage for `cols` columns (and up
// to 15 bytes of shift, so the stage and the slots agree modulo 16)
__host__ __device__ __forceinline__ int stage_bytes(int cols) {
  return (cols * SLOTS_PER_COLUMN + 31) & ~15;
}

// ---------------------------------------------------------------- helpers

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

// ------------------------------------------------------ ebcot_decision_slots

// A stripe column's state in one plane, one 32-bit word: a nibble per flag,
// row r of the column in bit r of each nibble (N_* is the nibble's shift).
#define N_BASE 0    // inside the block and not significant before the plane
#define N_SIGN 4    // negative
#define N_SIN 8     // significant before the plane
#define N_BIT 12    // the plane's magnitude bit
#define N_ETA 16    // significant before the plane above (MRP context 16)
#define N_MEM 20    // in the plane's SPP (written by the fixpoint)

__device__ __forceinline__ unsigned nib(unsigned word, int at) {
  return (word >> at) & 0xFu;
}

// A flag's 6-bit column: bit 0 the row above the stripe (row 3 of the
// stripe above), bits 1-4 the stripe's rows 0-3, bit 5 the row below (row 0
// of the stripe below).  For the stripe's row r, bits r, r + 1 and r + 2
// are the rows above, level with and below it.
__device__ __forceinline__ unsigned ext(unsigned above, unsigned mid,
                                        unsigned below) {
  return ((above >> 3) & 1u) | (mid << 1) | ((below & 1u) << 5);
}

// The four rows' "any of the 8 neighbours" from the 6-bit columns on the
// left, in the centre and on the right.
__device__ __forceinline__ unsigned any8(unsigned l, unsigned c, unsigned r) {
  return (l | (l >> 1) | (l >> 2) | c | (c >> 2) | r | (r >> 1) | (r >> 2)) &
         0xFu;
}

// Row r's neighbour mask, bit k for the offsets (dy, dx) of the plain
// version in order: (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1).
// l and rt are the left and right 6-bit columns, cn the centre as its row
// r - 1 is seen (N), cs as its row r + 1 is seen (S).
__device__ __forceinline__ unsigned mask8(unsigned l, unsigned cn,
                                          unsigned cs, unsigned rt, int r) {
  return ((l >> r) & 1u) | (((cn >> r) & 1u) << 1) | (((rt >> r) & 1u) << 2) |
         (((l >> (r + 1)) & 1u) << 3) | (((rt >> (r + 1)) & 1u) << 4) |
         (((l >> (r + 2)) & 1u) << 5) | (((cs >> (r + 2)) & 1u) << 6) |
         (((rt >> (r + 2)) & 1u) << 7);
}

__device__ __forceinline__ int zc_primary(int h, int v, int d) {
  if (h == 2) return 8;
  if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
  if (v == 2) return 4;
  if (v == 1) return 3;
  if (d >= 2) return 2;
  return d == 1 ? 1 : 0;
}

__device__ __forceinline__ int zc_hh(int h, int v, int d) {
  const int hv = h + v;
  if (d >= 3) return 8;
  if (d == 2) return hv >= 1 ? 7 : 6;
  if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
  return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
}

// zero-coding context (Table D.1) from a neighbour mask; band class 0 =
// LL/LH, 1 = HL, 2 = HH
__device__ __forceinline__ int zc_ctx(unsigned m, int bc) {
  const int h = __popc(m & 0x18u), v = __popc(m & 0x42u);
  const int d = __popc(m & 0xA5u);
  return bc == 0 ? zc_primary(h, v, d)
                 : (bc == 1 ? zc_primary(v, h, d) : zc_hh(h, v, d));
}

// sign-coding slot (Table D.3) of row r: context | (sign ^ xor) << 5, from
// the neighbour mask m and the signs' 6-bit columns
__device__ __forceinline__ int sc_slot(unsigned m, unsigned sl, unsigned sc,
                                       unsigned sr, int r, int sign) {
  const int n = ((m >> 1) & 1) ? (((sc >> r) & 1) ? -1 : 1) : 0;
  const int wv = ((m >> 3) & 1) ? (((sl >> (r + 1)) & 1) ? -1 : 1) : 0;
  const int e = ((m >> 4) & 1) ? (((sr >> (r + 1)) & 1) ? -1 : 1) : 0;
  const int s = ((m >> 6) & 1) ? (((sc >> (r + 2)) & 1) ? -1 : 1) : 0;
  const int hc = max(-1, min(1, wv + e));
  const int vc = max(-1, min(1, n + s));
  const int ctx = hc == 0 ? 9 + (vc != 0) : 12 + hc * vc;
  const int xr = (hc < 0) || (hc == 0 && vc < 0);
  return ctx | ((sign ^ xr) << 5);
}

// The CTA writes n bytes of shared memory to device memory: 16-byte
// stores where the two addresses agree modulo 16, bytes at the ends.
__device__ void store_run(uint8_t* dst, const uint8_t* src, int64_t n) {
  const int t = threadIdx.x, nt = blockDim.x;
  int64_t head = n;
  if (!(((uintptr_t)dst ^ (uintptr_t)src) & 15)) {
    head = min(n, (int64_t)((16 - ((uintptr_t)dst & 15)) & 15));
    const int64_t body = (n - head) >> 4;
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    for (int64_t i = t; i < body; i += nt) d4[i] = s4[i];
    for (int64_t i = head + 16 * body + t; i < n; i += nt) dst[i] = src[i];
  }
  for (int64_t i = t; i < head; i += nt) dst[i] = src[i];
}

// The CTA fills n bytes of device memory with 0xFF.
__device__ void fill_empty(uint8_t* dst, int64_t n) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int64_t head = min(n, (int64_t)((16 - ((uintptr_t)dst & 15)) & 15));
  const int64_t body = (n - head) >> 4;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const uint4 ff = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int64_t i = t; i < body; i += nt) d4[i] = ff;
  for (int64_t i = t; i < head; i += nt) dst[i] = EMPTY;
  for (int64_t i = head + 16 * body + t; i < n; i += nt) dst[i] = EMPTY;
}

// Per code-block: its largest valid magnitude (a plane at or above its bit
// count codes nothing) and the number of rows down to its last valid
// sample (a stripe below them takes no run-length mode), in stats[2b] and
// stats[2b + 1].
__global__ void __launch_bounds__(STATS_THREADS) block_stats_kernel(
    const int* __restrict__ mags, const uint8_t* __restrict__ valid, int hw,
    int w, int* __restrict__ stats) {
  __shared__ int s_max, s_last;
  if (threadIdx.x == 0) {
    s_max = 0;
    s_last = -1;
  }
  __syncthreads();
  const int64_t at = (int64_t)blockIdx.x * hw;
  int mx = 0, last = -1;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    if (valid[at + i]) {
      mx = max(mx, mags[at + i]);
      last = i;
    }
  }
  for (int o = 16; o; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  if (!(threadIdx.x & 31)) {
    atomicMax(&s_max, mx);
    atomicMax(&s_last, last);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = s_max;
    stats[2 * blockIdx.x + 1] = s_last < 0 ? 0 : s_last / w + 1;
  }
}

__global__ void __launch_bounds__(DEC_THREADS) decision_kernel(
    const int* __restrict__ mags, const int* __restrict__ signs,
    const uint8_t* __restrict__ valid, const int* __restrict__ bclass,
    const int* __restrict__ stats, int h, int w, int max_planes,
    uint8_t* __restrict__ slots) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int gn = h >> 2, ncol = gn * w, pw = w + 2;
  const int nwords = (gn + 2) * pw;
  const int b = blockIdx.x / max_planes;
  const int pi = blockIdx.x - b * max_planes;
  const int p = max_planes - 1 - pi;
  const int64_t plane_slots = (int64_t)ncol * SLOTS_PER_COLUMN;
  uint8_t* out = slots + ((int64_t)b * max_planes + pi) * plane_slots;
  const int maxmag = stats[2 * b];
  if (maxmag <= 0 || p >= 32 - __clz(maxmag)) {   // nothing coded here
    fill_empty(out, plane_slots);
    return;
  }
  const int hval = stats[2 * b + 1];
  const int bc = bclass[b];
  // shared memory: the slot stage, the words (padded by a column on each
  // side and a stripe above and below), each column's "a neighbour was
  // significant before the plane" nibble, and the fixpoint's two buffers
  // of SPP membership | new significance << 4 per column
  uint8_t* stage = smem;
  unsigned* wd = reinterpret_cast<unsigned*>(
      smem + stage_bytes(min(ncol, STAGE_COLS)));
  uint8_t* ns = reinterpret_cast<uint8_t*>(wd + nwords);
  const int nwp = (nwords + 3) & ~3;
  uint8_t* nw[2] = {ns + nwp, ns + 2 * nwp};

  // the plane's flags, one thread per column, coalesced along x
  const int64_t hw = (int64_t)h * w;
  const int* bm = mags + b * hw;
  const int* bsg = signs + b * hw;
  const uint8_t* bv = valid + b * hw;
  for (int i = threadIdx.x; i < nwords; i += blockDim.x) {
    nw[0][i] = 0;
    nw[1][i] = 0;
  }
  for (int i = threadIdx.x; i < 2 * pw; i += blockDim.x)
    wd[i < pw ? i : (gn + 1) * pw + i - pw] = 0;
  for (int i = threadIdx.x; i < 2 * gn; i += blockDim.x)
    wd[((i >> 1) + 1) * pw + (i & 1) * (pw - 1)] = 0;
  for (int col = threadIdx.x; col < ncol; col += blockDim.x) {
    const int g = col / w, x = col - g * w;
    unsigned word = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t s = (int64_t)(4 * g + r) * w + x;
      if (bv[s]) {
        const int m = bm[s];
        const unsigned sin = (m >> (p + 1)) > 0;
        word |= ((sin ^ 1u) << (N_BASE + r)) | (sin << (N_SIN + r)) |
                (((unsigned)(m >> p) & 1u) << (N_BIT + r)) |
                ((unsigned)((m >> (p + 2)) > 0) << (N_ETA + r));
      }
      if (bsg[s]) word |= 1u << (N_SIGN + r);
    }
    wd[(g + 1) * pw + x + 1] = word;
  }
  __syncthreads();
  for (int col = threadIdx.x; col < ncol; col += blockDim.x) {
    const int g = col / w, x = col - g * w;
    const unsigned* a = wd + g * pw + x;   // stripe above, column x - 1
    unsigned e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      e[k] = ext(nib(a[k], N_SIN), nib(a[pw + k], N_SIN),
                 nib(a[2 * pw + k], N_SIN));
    ns[(g + 1) * pw + x + 1] = (uint8_t)any8(e[0], e[1], e[2]);
  }
  __syncthreads();

  // SPP membership: sweeps over runs of RUN_COLS columns until none
  // changes; each sweep also writes the column's membership into its word
  // (no other thread reads a word during the sweeps)
  const int runs = (w + RUN_COLS - 1) / RUN_COLS;
  int cur = 0;
  for (;;) {
    const uint8_t* src = nw[cur];
    uint8_t* dst = nw[cur ^ 1];
    int changed = 0;
    for (int j = threadIdx.x; j < gn * runs; j += blockDim.x) {
      const int g = j / runs;
      const int x0 = (j - g * runs) * RUN_COLS;
      const int x1 = min(x0 + RUN_COLS, w);
      const int row = (g + 1) * pw;       // column -1 of stripe g
      const uint8_t* up = src + g * pw;   // column -1 of stripe g - 1
      unsigned left = src[row + x0] >> 4;
      unsigned ul = up[x0] >> 7, uc = up[x0 + 1] >> 7;
      for (int x = x0; x < x1; ++x) {
        const int idx = row + x + 1;
        const unsigned ur = up[x + 2] >> 7;
        const unsigned wv = wd[idx];
        const unsigned base = nib(wv, N_BASE), bit = nib(wv, N_BIT);
        // triggers from outside the column: a neighbour significant before
        // the plane, the left column's W, NW and SW, the stripe above
        const unsigned t = ns[idx] | left | (left >> 1) |
                           ((left << 1) & 0xFu) | ul | uc | ur;
        unsigned mem = 0, nwb = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const unsigned tr = (t >> r) | (r ? nwb >> (r - 1) : 0u);
          const unsigned m = (base >> r) & tr & 1u;
          mem |= m << r;
          nwb |= (m & (bit >> r)) << r;
        }
        const unsigned v = mem | (nwb << 4);
        changed |= v != src[idx];
        dst[idx] = (uint8_t)v;
        wd[idx] = (wv & ~(0xFu << N_MEM)) | (mem << N_MEM);
        left = nwb;
        ul = uc;
        uc = ur;
      }
    }
    cur ^= 1;
    if (!__syncthreads_or(changed)) break;
  }

  // every slot of the plane, one thread per column, staged in shared
  // memory (in chunks of STAGE_COLS columns for blocks of more)
  for (int c0 = 0; c0 < ncol; c0 += STAGE_COLS) {
    const int n = min(STAGE_COLS, ncol - c0);
    uint8_t* dspp = out + 8 * (int64_t)c0;
    uint8_t* sspp = stage + ((uintptr_t)dspp & 15);
    uint8_t* smrp = sspp + 8 * n;
    uint8_t* scup = sspp + 12 * n;
    for (int col = c0 + threadIdx.x; col < c0 + n; col += blockDim.x) {
      const int g = col / w, x = col - g * w;
      const unsigned* a = wd + g * pw + x;
      // 6-bit columns: significant before the plane, new in the SPP,
      // significant after it, significant in the cleanup, sign
      unsigned si[3], nv[3], sa[3], bcl[3], sg[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        unsigned f[3][5];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const unsigned v = a[j * pw + k];
          const unsigned sn = nib(v, N_SIN), mb = nib(v, N_MEM);
          const unsigned bt = nib(v, N_BIT);
          f[j][0] = sn;
          f[j][1] = mb & bt;
          f[j][2] = sn | (mb & bt);
          f[j][3] = nib(v, N_BASE) & ~mb & bt;
          f[j][4] = nib(v, N_SIGN);
        }
        si[k] = ext(f[0][0], f[1][0], f[2][0]);
        nv[k] = ext(f[0][1], f[1][1], f[2][1]);
        sa[k] = ext(f[0][2], f[1][2], f[2][2]);
        bcl[k] = ext(f[0][3], f[1][3], f[2][3]);
        sg[k] = ext(f[0][4], f[1][4], f[2][4]);
      }
      const unsigned own = a[pw + 1];
      const unsigned sin = nib(own, N_SIN), bit = nib(own, N_BIT);
      const unsigned mem = nib(own, N_MEM), eta = nib(own, N_ETA);
      const unsigned sign = nib(own, N_SIGN);
      const unsigned cand = nib(own, N_BASE) & ~mem;
      // visit-time states: a neighbour counts if significant before (SPP:
      // before the plane; cleanup: after the SPP), or new in the pass and
      // visited before (left column except the row below the stripe, N,
      // and NE from the stripe above)
      const unsigned spl = si[0] | (nv[0] & 0x1Fu), spr = si[2] | (nv[2] & 1u);
      const unsigned spn = si[1] | nv[1];
      const unsigned cul = sa[0] | (bcl[0] & 0x1Fu);
      const unsigned cur_r = sa[2] | (bcl[2] & 1u);
      const unsigned cun = sa[1] | bcl[1];
      const unsigned any_sa = any8(sa[0], sa[1], sa[2]);
      // the run-length test: neighbours as coded before the column
      const unsigned nbc = any_sa | ((bcl[0] | (bcl[0] >> 1)) & 0xFu) |
                           ((bcl[0] >> 2) & 0x7u) | ((bcl[1] | bcl[2]) & 1u);
      const bool rl = 4 * g + 4 <= hval && (cand & ~nbc & 0xFu) == 0xFu;
      const int fs = bit ? __ffs(bit) - 1 : 4;
      const int i = col - c0;
      uint8_t* cc = scup + 11 * i;
      cc[0] = rl ? (uint8_t)(17 | (fs < 4 ? 32 : 0)) : EMPTY;
      cc[1] = (rl && fs < 4) ? (uint8_t)(18 | (((fs >> 1) & 1) << 5)) : EMPTY;
      cc[2] = (rl && fs < 4) ? (uint8_t)(18 | ((fs & 1) << 5)) : EMPTY;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int bt = (bit >> r) & 1, sn = (sign >> r) & 1;
        // SPP
        int sa0 = EMPTY, sb0 = EMPTY;
        if ((mem >> r) & 1) {
          const unsigned m = mask8(spl, spn, si[1], spr, r);
          sa0 = zc_ctx(m, bc) | (bt << 5);
          if (bt) sb0 = sc_slot(m, sg[0], sg[1], sg[2], r, sn);
        }
        sspp[8 * i + 2 * r] = (uint8_t)sa0;
        sspp[8 * i + 2 * r + 1] = (uint8_t)sb0;
        // MRP
        smrp[4 * i + r] =
            (sin >> r) & 1
                ? (uint8_t)(((eta >> r) & 1 ? 16 : ((any_sa >> r) & 1 ? 15
                                                                       : 14)) |
                            (bt << 5))
                : (uint8_t)EMPTY;
        // cleanup
        const bool zc_emit = ((cand >> r) & 1) && (!rl || r > fs);
        const bool sc_emit = (zc_emit && bt) || (rl && r == fs);
        int ca = EMPTY, cb = EMPTY;
        if (zc_emit || sc_emit) {
          const unsigned m = mask8(cul, cun, sa[1], cur_r, r);
          if (zc_emit) ca = zc_ctx(m, bc) | (bt << 5);
          if (sc_emit) cb = sc_slot(m, sg[0], sg[1], sg[2], r, sn);
        }
        cc[3 + 2 * r] = (uint8_t)ca;
        cc[4 + 2 * r] = (uint8_t)cb;
      }
    }
    __syncthreads();
    if (n == ncol) {
      store_run(out, sspp, plane_slots);
    } else {
      store_run(dspp, sspp, 8 * n);
      store_run(out + 8 * (int64_t)ncol + 4 * c0, smrp, 4 * n);
      store_run(out + 12 * (int64_t)ncol + 11 * (int64_t)c0, scup, 11 * n);
      __syncthreads();
    }
  }
}

// -------------------------------------------------------- ebcot_compact_rows

// One chunk of a slot row: bytes [lo, hi), covered by the 16-byte windows
// from the boundary a0 at or below lo; chunk `col` of row `row`.
struct Chunk {
  uintptr_t lo, hi, a0;
  int nwin, col;
  int64_t row;
};

__device__ __forceinline__ Chunk chunk_at(const uint8_t* slots, int64_t t,
                                          int chunk, int cpr) {
  Chunk c;
  c.row = (int64_t)blockIdx.x / cpr;
  c.col = (int)((int64_t)blockIdx.x - c.row * cpr);
  const int64_t s = c.row * t + (int64_t)c.col * chunk;
  const int64_t e = min(s + chunk, (c.row + 1) * t);
  c.lo = reinterpret_cast<uintptr_t>(slots + s);
  c.hi = reinterpret_cast<uintptr_t>(slots + e);
  c.a0 = c.lo & ~(uintptr_t)15;
  c.nwin = (int)((c.hi + 15 - c.a0) >> 4);
  return c;
}

// Window k of the chunk: one 16-byte load inside it; in the head and tail
// windows the chunk's bytes one by one and 0xFF (no decision) elsewhere;
// all 0xFF past the last window.
__device__ __forceinline__ uint4 chunk_window(const Chunk& c, int k) {
  const uintptr_t a = c.a0 + 16 * (uintptr_t)k;
  if (k < c.nwin && a >= c.lo && a + 16 <= c.hi)
    return *reinterpret_cast<const uint4*>(a);
  unsigned w[4] = {~0u, ~0u, ~0u, ~0u};
  if (k < c.nwin) {
    for (int j = 0; j < 16; ++j) {
      if (a + j < c.lo || a + j >= c.hi) continue;
      const unsigned b = *reinterpret_cast<const uint8_t*>(a + j);
      const int at = 8 * (j & 3);
      w[j >> 2] = (w[j >> 2] & ~(0xFFu << at)) | (b << at);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bit j set for each byte j of the window that is not 0xFF.
__device__ __forceinline__ unsigned live_mask(uint4 v) {
  const unsigned m[4] = {__vsetne4(v.x, ~0u), __vsetne4(v.y, ~0u),
                         __vsetne4(v.z, ~0u), __vsetne4(v.w, ~0u)};
  unsigned out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out |= ((m[i] | (m[i] >> 7) | (m[i] >> 14) | (m[i] >> 21)) & 0xFu)
           << (4 * i);
  return out;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// counts[row * cpr + col]: the decisions of each chunk
__global__ void __launch_bounds__(CMP_THREADS) chunk_count_kernel(
    const uint8_t* __restrict__ slots, int64_t t, int chunk, int cpr,
    int* __restrict__ counts) {
  __shared__ int sh[CMP_THREADS / 32];
  const Chunk c = chunk_at(slots, t, chunk, cpr);
  uint4 v[CMP_TILES];
#pragma unroll
  for (int k = 0; k < CMP_TILES; ++k)
    v[k] = chunk_window(c, k * CMP_THREADS + threadIdx.x);
  int n = 0;
#pragma unroll
  for (int k = 0; k < CMP_TILES; ++k)
    n += __popc(__vsetne4(v[k].x, ~0u)) + __popc(__vsetne4(v[k].y, ~0u)) +
         __popc(__vsetne4(v[k].z, ~0u)) + __popc(__vsetne4(v[k].w, ~0u));
  n = warp_sum(n);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x < 32) {
    n = warp_sum(threadIdx.x < CMP_THREADS / 32 ? sh[threadIdx.x] : 0);
    if (threadIdx.x == 0) counts[blockIdx.x] = n;
  }
}

// ndec[b]: the sum of row b's chunk counts (a thread a row); off: the
// exclusive scan of ndec; stats = {total, largest count}
__global__ void __launch_bounds__(SCAN_THREADS) rows_scan_kernel(
    const int* __restrict__ counts, int nb, int cpr, int* __restrict__ ndec,
    long long* __restrict__ off, long long* __restrict__ stats) {
  __shared__ int sh[32];
  __shared__ int s_max;
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  long long carry = 0;
  int my_max = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int v = 0;
    if (i < nb) {
      const int* c = counts + (int64_t)i * cpr;
#pragma unroll 8
      for (int k = 0; k < cpr; ++k) v += c[k];
      ndec[i] = v;
    }
    my_max = max(my_max, v);
    int tot;
    const int excl = block_exclusive_scan(v, sh, &tot);
    if (i < nb) off[i] = carry + excl;
    carry += tot;
  }
  atomicMax(&s_max, my_max);
  __syncthreads();
  if (threadIdx.x == 0) {
    stats[0] = carry;
    stats[1] = s_max;
  }
}

// Each chunk's decisions at the pool offset off[row] + the counts of the
// row's chunks before it.
__global__ void __launch_bounds__(CMP_THREADS) chunk_write_kernel(
    const uint8_t* __restrict__ slots, int64_t t, int chunk, int cpr,
    const int* __restrict__ counts, const long long* __restrict__ off,
    uint8_t* __restrict__ pool) {
  __shared__ __align__(16) uint8_t stage[CMP_MAX_CHUNK + 32];
  __shared__ int sh[32];
  __shared__ long long s_base;
  const int cnt = counts[blockIdx.x];
  if (cnt == 0) return;                  // no decision: not read again
  const Chunk c = chunk_at(slots, t, chunk, cpr);
  uint4 v[CMP_TILES];
#pragma unroll
  for (int k = 0; k < CMP_TILES; ++k)
    v[k] = chunk_window(c, k * CMP_THREADS + threadIdx.x);
  if (threadIdx.x < 32) {
    int n = 0;
    for (int i = threadIdx.x; i < c.col; i += 32)
      n += counts[c.row * cpr + i];
    n = warp_sum(n);
    if (threadIdx.x == 0) s_base = off[c.row] + n;
  }
  __syncthreads();
  uint8_t* d0 = pool + s_base;
  // stage[shift + i] is pool byte d0 + i: the stage and the pool agree
  // modulo 16
  const int shift = (int)(reinterpret_cast<uintptr_t>(d0) & 15);
  int carry = shift;
#pragma unroll
  for (int k = 0; k < CMP_TILES; ++k) {
    if (k * CMP_THREADS >= c.nwin) break;           // the same for the CTA
    unsigned m = live_mask(v[k]);
    int tot;
    int pos = carry + block_exclusive_scan(__popc(m), sh, &tot);
    const unsigned w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      stage[pos++] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
    }
    carry += tot;
  }
  __syncthreads();
  const uintptr_t lo = reinterpret_cast<uintptr_t>(d0), hi = lo + cnt;
  const uintptr_t g0 = lo & ~(uintptr_t)15;
  const int nout = (int)((hi + 15 - g0) >> 4);
  for (int k = threadIdx.x; k < nout; k += CMP_THREADS) {
    const uintptr_t a = g0 + 16 * (uintptr_t)k;
    if (a >= lo && a + 16 <= hi) {
      *reinterpret_cast<uint4*>(a) =
          *reinterpret_cast<const uint4*>(stage + 16 * k);
    } else {                             // shared with a neighbouring chunk
      for (int j = 0; j < 16; ++j)
        if (a + j >= lo && a + j < hi)
          *reinterpret_cast<uint8_t*>(a + j) = stage[16 * k + j];
    }
  }
}

// ---------------------------------------------------------- ebcot_mq_encode

// ISO/IEC 15444-1 Table C.2: Qe, NMPS, NLPS, SWITCH
__constant__ uint16_t QE[NUM_QE] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
__constant__ uint8_t NMPS[NUM_QE] = {
    1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
__constant__ uint8_t NLPS[NUM_QE] = {
    1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
__constant__ uint8_t SWITCH[NUM_QE] = {
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// A context's state in one word: Qe | index << 16 | SWITCH << 22 | MPS << 31.
__device__ __forceinline__ uint32_t ctx_word(int i) {
  return QE[i] | ((uint32_t)i << 16) | ((uint32_t)SWITCH[i] << 22);
}

// A context's slot: its word and the words of its NMPS and NLPS successor
// states.
__device__ __forceinline__ uint4 ctx_slot(int i) {
  return make_uint4(ctx_word(i), ctx_word(NMPS[i]), ctx_word(NLPS[i]), 0u);
}

// Shared memory by 32-bit shared-window address: the coding loops keep
// their buffers' addresses in registers (opaque to the compiler, which
// would otherwise recompute the shared window's base in every iteration).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned lds_u8(unsigned a) {
  unsigned short v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ unsigned lds_u32(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint2 lds_v2(unsigned a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds_v4(unsigned a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_u8(unsigned a, unsigned v) {
  asm volatile("st.shared.u8 [%0], %1;" ::"r"(a), "h"((unsigned short)v)
               : "memory");
}
__device__ __forceinline__ void sts_u32(unsigned a, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_v4(unsigned a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// the pair's two warps: named barrier 1 + pair, 64 threads
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + pair) : "memory");
}
// end of the shared-memory helpers

// The interval register's half of the coder: A and the context states.
// Each decision's record for the other half is (Qe if C takes it, else 0)
// | n << 16, n the renormalization shifts.
__device__ __forceinline__ void mq_model(unsigned buf, int p0, int p1,
                                         unsigned ctx, unsigned succ,
                                         unsigned rec, uint32_t& a) {
  asm volatile("" : "+r"(buf), "+r"(ctx), "+r"(succ), "+r"(rec), "+r"(p1));
  int x = lds_u8(buf + p0);
  uint4 s = lds_v4(ctx + 16 * (x & 0x1F));
  int xn = lds_u8(buf + p0 + 1);
#pragma unroll 2
  for (int p = p0; p < p1; ++p) {
    const int xnn = lds_u8(buf + p + 2);
    const int cx = x & 0x1F, cxn = xn & 0x1F;
    const uint4 sl = lds_v4(ctx + 16 * cxn);
    const uint2 tn = lds_v2(succ + 8 * ((s.y >> 16) & 0x3F));
    const uint2 tl = lds_v2(succ + 8 * ((s.z >> 16) & 0x3F));
    const uint32_t q = s.x & 0xFFFFu;
    const bool mps = (uint32_t)(x >> 5) == (s.x >> 31);
    const uint32_t a1 = a - q;
    const bool low = a1 < q;
    const bool renorm_mps = mps && !(a1 & 0x8000u);
    // CODEMPS: A = Qe if it renormalizes with A < Qe, else C += Qe;
    // CODELPS: C += Qe if A < Qe, else A = Qe.  C takes Qe when A keeps
    // A - Qe.
    const bool keep_a = mps ? !(renorm_mps && low) : low;
    a = keep_a ? a1 : q;
    const int n = __clz(a) - 16;           // 0 unless it renormalizes
    a <<= n;
    sts_u32(rec + 4 * p, (keep_a ? q : 0u) | (uint32_t)n << 16);
    uint4 snew = s;
    if (renorm_mps)
      snew = make_uint4(s.y | (s.x & 0x80000000u), tn.x, tn.y, 0u);
    if (!mps)                                        // MPS ^= SWITCH
      snew = make_uint4(s.z | ((s.x ^ (s.x << 9)) & 0x80000000u), tl.x, tl.y,
                        0u);
    sts_v4(ctx + 16 * cx, snew);
    s = cxn == cx ? snew : sl;
    x = xn;
    xn = xnn;
  }
}

// The code register's half: C, CT, BYTEOUT and stuffing.  `last` holds the
// buffer's last byte, which a carry may still change; bytes before it are
// final.  nout counts the bytes committed into the pair's output buffer in
// this chunk, from -1: the first commit is the sentinel (OpenJPEG's byte
// before the buffer), which lands in a guard byte and is not written out.
struct MqRegs {
  uint32_t c, last;
  int ct, nout;
  unsigned ob;
};

// BYTEOUT (C.3.2) on the register model: commit `last`, load the next byte.
__device__ __forceinline__ void byteout(MqRegs& r) {
  uint32_t commit = r.last;
  bool stuff;
  if (r.last == 0xFF) {
    stuff = true;
  } else if (r.c >= 0x8000000u) {
    commit = r.last + 1;                 // carry into the last byte
    stuff = commit == 0xFF;
    if (stuff) r.c &= 0x7FFFFFFu;
  } else {
    stuff = false;
  }
  if (stuff) {
    r.last = (r.c >> 20) & 0xFF;
    r.c &= 0xFFFFFu;
    r.ct = 7;
  } else {
    r.last = (r.c >> 19) & 0xFF;
    r.c &= 0x7FFFFu;
    r.ct = 8;
  }
  sts_u8(r.ob + r.nout++, commit);
}

// C's part of RENORME for the decisions of buf[p0, p1): n shifts, taken at
// once while they stay below CT, else in at most three CT-bounded chunks
// with a BYTEOUT each time CT reaches 0 (it reloads CT with 7 or 8, and
// n <= 15).
__device__ __forceinline__ void mq_bytes(unsigned rec, int p0, int p1,
                                         MqRegs& r) {
  asm volatile("" : "+r"(rec), "+r"(p1));
  uint32_t rn = lds_u32(rec + 4 * p0);
#pragma unroll 2
  for (int p = p0; p < p1; ++p) {
    const uint32_t rnn = lds_u32(rec + 4 * p + 4);
    r.c += rn & 0xFFFFu;
    int n = rn >> 16;
    if (n < r.ct) {
      r.c <<= n;
      r.ct -= n;
    } else {
      do {
        const int k = min(n, r.ct);
        r.c <<= k;
        r.ct -= k;
        n -= k;
        if (r.ct == 0) byteout(r);
      } while (n > 0);
    }
    rn = rnn;
  }
}

// One pair's staging buffers: the context slots, two chunks of decisions
// (16 bytes of slack for the look-ahead), two chunks of records, the
// chunk's committed bytes (a decision commits at most 3, the flush at most
// 3, plus the guard) and A after the last decision.
struct __align__(16) MqPair {
  uint4 ctx[32];
  uint8_t dec[2][MQ_CHUNK + 16];
  uint32_t rec[2][MQ_CHUNK + 4];
  uint8_t out[3 * MQ_CHUNK + 16];
  uint32_t a_end;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage the 16-byte-aligned chunk at `from` (its first `bytes` bytes
// needed) into dst: whole segments inside the pool [lo, hi) by cp.async,
// the pool's ragged first and last segments byte by byte.
__device__ __forceinline__ void stage_chunk(uint8_t* dst, const uint8_t* from,
                                            int bytes, const uint8_t* lo,
                                            const uint8_t* hi, int lane) {
  for (int i = 16 * lane; i < bytes; i += 16 * 32) {
    const uint8_t* g = from + i;
    if (g >= lo && g + 16 <= hi) {
      cp_async16(dst + i, g);
    } else {
      for (int j = 0; j < 16; ++j)
        if (g + j >= lo && g + j < hi) dst[i + j] = g[j];
    }
  }
}

// Two warps code each code-block: the model warp stages the decisions and
// runs A and the context states (mq_model), the byte warp runs C
// (mq_bytes), writes the segment and its length.  Step t of the pair's
// loop models chunk t and codes the bytes of chunk t - 1; a named barrier
// ends each step.
__global__ void __launch_bounds__(MQ_PAIRS * 64) mq_kernel(
    const uint8_t* __restrict__ dec, long long dec_len,
    const long long* __restrict__ off, const int* __restrict__ ndec, int nb,
    uint8_t* __restrict__ rows, int* __restrict__ lens) {
  // each state's successor words: those of its NMPS and NLPS states
  __shared__ uint2 succ[NUM_QE];
  __shared__ MqPair pairs[MQ_PAIRS];
  for (int i = threadIdx.x; i < NUM_QE; i += blockDim.x)
    succ[i] = make_uint2(ctx_word(NMPS[i]), ctx_word(NLPS[i]));
  __syncthreads();
  const int lane = threadIdx.x & 31, pair = threadIdx.x >> 6;
  const bool model = ((threadIdx.x >> 5) & 1) == 0;
  const int b = blockIdx.x * MQ_PAIRS + pair;
  if (b >= nb) return;
  const int n = ndec[b];
  if (n == 0) {
    if (!model && lane == 0) lens[b] = 0;
    return;
  }
  MqPair& pp = pairs[pair];
  const long long start = off[b];
  const uint8_t* src = dec + start;
  const int head = (int)((uintptr_t)src & 15);
  const uint8_t* base = src - head;
  const int span = head + n;
  const int nch = (span + MQ_CHUNK - 1) / MQ_CHUNK;
  if (model) {
    const uint8_t* hi = dec + dec_len;
    // initial states (Table D.7): ZC 0 = 4, RL = 3, UNI = 46, the rest 0
    pp.ctx[lane] = ctx_slot(lane == 0 ? 4 : lane == 17 ? 3 : lane == 18 ? 46
                                                                       : 0);
    stage_chunk(pp.dec[0], base, min(span, MQ_CHUNK), dec, hi, lane);
    cp_async_commit();
    uint32_t a = 0x8000u;
    for (int t = 0; t < nch; ++t) {
      if (t + 1 < nch)
        stage_chunk(pp.dec[(t + 1) & 1],
                    base + (long long)(t + 1) * MQ_CHUNK,
                    min(span - (t + 1) * MQ_CHUNK, MQ_CHUNK), dec, hi, lane);
      cp_async_commit();
      cp_async_wait1();                // chunk t has landed
      __syncwarp();
      if (lane == 0) {
        mq_model(smem_addr(pp.dec[t & 1]), t ? 0 : head,
                 min(MQ_CHUNK, span - t * MQ_CHUNK), smem_addr(pp.ctx),
                 smem_addr(succ), smem_addr(pp.rec[t & 1]), a);
        if (t + 1 == nch) pp.a_end = a;
      }
      pair_sync(pair);
    }
    pair_sync(pair);
    return;
  }
  uint8_t* row = rows + 3 * start + 3 * (long long)b;
  const uint8_t* ob = pp.out + 1;
  MqRegs r;
  r.c = 0;
  r.ct = 12;
  r.last = 0;
  r.nout = -1;
  r.ob = smem_addr(ob);
  int written = 0;
  pair_sync(pair);
  for (int t = 0; t < nch; ++t) {
    if (lane == 0) {
      mq_bytes(smem_addr(pp.rec[t & 1]), t ? 0 : head,
               min(MQ_CHUNK, span - t * MQ_CHUNK), r);
      if (t + 1 == nch) {
        // FLUSH (C.3.4, OpenJPEG's form): SETBITS, two byteouts, the last
        // byte
        const uint32_t tempc = r.c + pp.a_end - 1;
        r.c |= 0xFFFFu;
        if (r.c >= tempc) r.c -= 0x8000u;
        r.c <<= r.ct;
        byteout(r);
        r.c <<= r.ct;
        byteout(r);
        sts_u8(r.ob + r.nout++, r.last);
      }
    }
    __syncwarp();
    const int m = max(__shfl_sync(0xffffffffu, r.nout, 0), 0);
    for (int i = lane; i < m; i += 32) row[written + i] = ob[i];
    written += m;
    r.nout -= m;
    __syncwarp();
    pair_sync(pair);
  }
  if (lane == 0) lens[b] = written;      // commits after the sentinel
}

// ---------------------------------------------------------- ebcot_pool_rows

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [blockIdx.x * POOL_WARPS * run, + POOL_WARPS * run): warp w copies
// `run` of them, each segment to the exclusive scan of lens; total[0]
// gets the sum of lens.
__global__ void __launch_bounds__(POOL_WARPS * 32) seg_pool_kernel(
    const uint8_t* __restrict__ rows, const long long* __restrict__ off,
    const int* __restrict__ lens, int nb, int run,
    long long* __restrict__ total, uint8_t* __restrict__ pool) {
  __shared__ long long sh[2 * POOL_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * POOL_WARPS * run;
  // the lengths of every row before the tile
  long long before = 0;
  int i = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(lens) & 15) == 0) {
    const int4* l4 = reinterpret_cast<const int4*>(lens);
    for (int q = threadIdx.x; q < first / 4; q += blockDim.x) {
      const int4 v = __ldg(l4 + q);
      before += (long long)v.x + v.y + v.z + v.w;
    }
    i = (first & ~3) + threadIdx.x;
  }
  for (; i < first; i += blockDim.x) before += lens[i];
  const int r0 = min(first + warp * run, nb), r1 = min(r0 + run, nb);
  long long mine = 0;
  for (int r = r0 + lane; r < r1; r += 32) mine += lens[r];
  before = warp_sum64(before);
  mine = warp_sum64(mine);
  if (lane == 0) {
    sh[warp] = before;
    sh[POOL_WARPS + warp] = mine;
  }
  __syncthreads();
  long long base = 0, tile = 0;
#pragma unroll
  for (int k = 0; k < POOL_WARPS; ++k) {
    base += sh[k] + (k < warp ? sh[POOL_WARPS + k] : 0);
    tile += sh[k] + sh[POOL_WARPS + k];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) total[0] = tile;
  for (int r = r0; r < r1; ++r) {
    const int n = lens[r];
    warp_copy<POOL_COPY_UNROLL>(pool + base,
                                rows + 3 * off[r] + 3 * (long long)r, n,
                                lane);
    base += n;
  }
}

extern "C" {

int ebcot_slots_per_column(void) { return SLOTS_PER_COLUMN; }
int ebcot_max_planes(void) { return MAX_PLANES; }

// shared memory of the decision kernel for an h x w block: the slot stage,
// the padded words, and three bytes a padded column
static size_t decision_smem(int h, int w) {
  const int ncol = (h / 4) * w;
  const size_t nwords = (size_t)(h / 4 + 2) * (w + 2);
  return (size_t)stage_bytes(ncol < STAGE_COLS ? ncol : STAGE_COLS) +
         4 * nwords + 3 * ((nwords + 3) & ~(size_t)3);
}

long long ebcot_decision_smem(int h, int w) { return (long long)decision_smem(h, w); }
int ebcot_decision_threads(void) { return DEC_THREADS; }
int ebcot_decision_run_cols(void) { return RUN_COLS; }
int ebcot_decision_stage_cols(void) { return STAGE_COLS; }

// stats: int32 [nb, 2] scratch (largest valid magnitude, rows to the last
// valid sample), written by the pre-pass
int ebcot_decision_slots(const void* mags, const void* signs,
                         const void* valid, const void* bclass, int nb,
                         int h, int w, int max_planes, void* stats,
                         void* slots, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  block_stats_kernel<<<nb, STATS_THREADS, 0, st>>>(
      (const int*)mags, (const uint8_t*)valid, h * w, w, (int*)stats);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const size_t smem = decision_smem(h, w);
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(
        decision_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
  }
  decision_kernel<<<nb * max_planes, DEC_THREADS, smem, st>>>(
      (const int*)mags, (const int*)signs, (const uint8_t*)valid,
      (const int*)bclass, (const int*)stats, h, w, max_planes,
      (uint8_t*)slots);
  return (int)cudaGetLastError();
}

// counts: int32 [nb * cpr] scratch, cpr = ceil(t / chunk) chunks a row;
// ndec, off and {total, largest count} of the slot rows
int ebcot_chunk_count(const void* slots, int nb, long long t, int chunk,
                      void* counts, void* ndec, void* off, void* stats,
                      void* stream) {
  if (chunk < 1 || chunk > CMP_MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const int cpr = (int)((t + chunk - 1) / chunk);
  chunk_count_kernel<<<(unsigned)((int64_t)nb * cpr), CMP_THREADS, 0,
                       (cudaStream_t)stream>>>((const uint8_t*)slots, t,
                                               chunk, cpr, (int*)counts);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rows_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)counts, nb, cpr, (int*)ndec, (long long*)off,
      (long long*)stats);
  return (int)cudaGetLastError();
}

int ebcot_chunk_write(const void* slots, int nb, long long t, int chunk,
                      const void* counts, const void* off, void* pool,
                      void* stream) {
  if (chunk < 1 || chunk > CMP_MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const int cpr = (int)((t + chunk - 1) / chunk);
  chunk_write_kernel<<<(unsigned)((int64_t)nb * cpr), CMP_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)slots, t, chunk, cpr, (const int*)counts,
      (const long long*)off, (uint8_t*)pool);
  return (int)cudaGetLastError();
}

int ebcot_compact_max_chunk(void) { return CMP_MAX_CHUNK; }

int ebcot_mq_chunk(void) { return MQ_CHUNK; }

int ebcot_mq_encode(const void* dec, long long dec_len, const void* off,
                    const void* ndec, int nb, void* rows, void* lens,
                    void* stream) {
  const int grid = (nb + MQ_PAIRS - 1) / MQ_PAIRS;
  mq_kernel<<<grid, MQ_PAIRS * 64, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)dec, dec_len, (const long long*)off, (const int*)ndec,
      nb, (uint8_t*)rows, (int*)lens);
  return (int)cudaGetLastError();
}

int ebcot_pool_rows(const void* rows, const void* off, const void* lens,
                    int nb, void* total, void* pool, void* stream) {
  if (nb <= 0) return 0;
  const int per_cta = POOL_WARPS * POOL_MAX_CTAS;
  const int run = (nb + per_cta - 1) / per_cta;
  const int grid = (nb + POOL_WARPS * run - 1) / (POOL_WARPS * run);
  seg_pool_kernel<<<grid, POOL_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const long long*)off, (const int*)lens, nb, run,
      (long long*)total, (uint8_t*)pool);
  return (int)cudaGetLastError();
}

}  // extern "C"
