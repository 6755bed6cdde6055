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
// * ebcot_decision_slots: bytes.  It writes one byte per potential
//   decision, 5.75 bytes per sample and bitplane for 64x64 blocks (145 MB
//   for 560 blocks and 11 planes), and does a few dozen integer operations
//   per sample and plane.  One CUDA block per code-block keeps the block's
//   state in shared memory (a padded (H+2) x (W+2) byte map of per-sample
//   flags and two byte maps of SPP membership, under 20 KB for any block of
//   at most 4096 samples) and loops over the planes inside the kernel.  The
//   SPP membership fixpoint is iterated Jacobi-style over the whole block
//   with __syncthreads_or until no sample changes (as many sweeps as the
//   longest propagation chain); MRP and the cleanup pass are closed-form,
//   with one thread per stripe column for the run-length test.  Threads
//   walk the samples in slot order (stripe, column, row), so consecutive
//   threads write consecutive slots; planes above the block's bit count
//   are filled with 0xFF.
// * ebcot_compact_rows: bytes (it reads the slots twice and writes the
//   decision pool).  One CUDA block per row counts its decisions; one
//   block scans the counts (offsets, total, largest count); then one CUDA
//   block per row runs a block scan over tiles of the row and writes its
//   decisions at its offset.  The TPU form sorted (scatters serialize
//   there); here the scan gives each decision its place.
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
// * ebcot_pool_rows: bytes.  One block scans the segment lengths (pool
//   offsets and total); a grid of one CUDA block per row copies each
//   segment to its place.  The pool is allocated at its bound and only its
//   used prefix is copied to the host.
//
// Kernels launch on the caller's stream and allocate nothing; each entry
// point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#define DEC_THREADS 512
#define ROW_THREADS 256
#define ROW_TILE 16            // bytes per thread per tile of a slot row
#define SCAN_THREADS 1024
#define MQ_PAIRS 2             // code-blocks (two warps each) per CTA
#define MQ_CHUNK 1024          // decision bytes a warp stages at a time
#define COPY_THREADS 128
#define NUM_CTX 19
#define NUM_QE 47
#define EMPTY 0xFF
#define SLOTS_PER_COLUMN 23
#define MAX_PLANES 29

// flag bits of the per-sample state map
#define F_SIN 1      // significant before this plane
#define F_BIT 2      // this plane's magnitude bit
#define F_NEW 4      // became significant in this plane's SPP
#define F_BC 8       // becomes significant in this plane's cleanup
#define F_VALID 16   // inside the block's true extent
#define F_SIGN 32    // negative

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

// neighbour k of the 8 offsets (dy, dx), in the order of the plain version:
// (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1)
__constant__ int NB_DY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int NB_DX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

// Is neighbour k visited before the sample (column=false: the SPP and
// cleanup sample order, _before_sample) or before the sample's run-length
// column is tested (column=true, _before_column)?  r = row in the stripe.
__device__ __forceinline__ bool before(int k, int r, bool column) {
  switch (k) {
    case 0: case 3: return true;
    case 1: return column ? r == 0 : true;
    case 2: return r == 0;
    case 5: return r < 3;
    default: return false;
  }
}

// 8-bit mask of the neighbours significant at visit time: a neighbour
// counts if it has a `stat` flag, or a `neu` flag and is visited before.
__device__ __forceinline__ unsigned nb_state(const uint8_t* st, int idx,
                                             int pw, int r, int stat,
                                             int neu, bool column) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int f = st[idx + NB_DY[k] * pw + NB_DX[k]];
    if ((f & stat) || ((f & neu) && before(k, r, column))) m |= 1u << k;
  }
  return m;
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
  const int h = ((m >> 3) & 1) + ((m >> 4) & 1);
  const int v = ((m >> 1) & 1) + ((m >> 6) & 1);
  const int d = (m & 1) + ((m >> 2) & 1) + ((m >> 5) & 1) + ((m >> 7) & 1);
  return bc == 0 ? zc_primary(h, v, d)
                 : (bc == 1 ? zc_primary(v, h, d) : zc_hh(h, v, d));
}

// sign-coding slot (Table D.3): context | (sign ^ xor) << 5
__device__ __forceinline__ int sc_slot(const uint8_t* st, int idx, int pw,
                                       unsigned m, int sign) {
  int c[8];
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    const int f = st[idx + NB_DY[k] * pw + NB_DX[k]];
    c[k] = ((m >> k) & 1) ? ((f & F_SIGN) ? -1 : 1) : 0;
  }
  const int hc = max(-1, min(1, c[3] + c[4]));
  const int vc = max(-1, min(1, c[1] + c[6]));
  const int ctx = hc == 0 ? 9 + (vc != 0) : 12 + hc * vc;
  const int xr = (hc < 0) || (hc == 0 && vc < 0);
  return ctx | ((sign ^ xr) << 5);
}

__global__ void __launch_bounds__(DEC_THREADS) decision_kernel(
    const int* __restrict__ mags, const int* __restrict__ signs,
    const uint8_t* __restrict__ valid, const int* __restrict__ bclass,
    int h, int w, int max_planes, uint8_t* __restrict__ slots) {
  extern __shared__ uint8_t smem[];
  const int pw = w + 2;
  const int npad = (h + 2) * pw;
  const int g_stripes = h >> 2;
  const int ncol = g_stripes * w;
  const int nsamp = ncol * 4;
  uint8_t* st = smem;                    // flags, padded
  uint8_t* mem[2] = {smem + npad, smem + 2 * npad};   // SPP membership
  uint8_t* colst = smem + 3 * npad;      // per column: rl | fs << 1
  __shared__ int s_max, s_hval;

  const int b = blockIdx.x;
  const int64_t hw = (int64_t)h * w;
  const int* bm = mags + b * hw;
  const int bc = bclass[b];
  const int64_t plane_slots = (int64_t)ncol * SLOTS_PER_COLUMN;
  uint8_t* out = slots + (int64_t)b * max_planes * plane_slots;

  if (threadIdx.x == 0) {
    s_max = 0;
    s_hval = 0;
  }
  for (int i = threadIdx.x; i < 3 * npad; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  int my_max = 0, my_h = 0;
  for (int i = threadIdx.x; i < nsamp; i += blockDim.x) {
    const int col = i >> 2, r = i & 3;
    const int g = col / w, x = col - g * w, y = 4 * g + r;
    const int64_t s = (int64_t)y * w + x;
    const bool v = valid[b * hw + s] != 0;
    st[(y + 1) * pw + x + 1] =
        (v ? F_VALID : 0) | (signs[b * hw + s] ? F_SIGN : 0);
    if (v) {
      my_max = max(my_max, bm[s]);
      my_h = max(my_h, y + 1);
    }
  }
  atomicMax(&s_max, my_max);
  atomicMax(&s_hval, my_h);
  __syncthreads();
  const int live_planes = s_max > 0 ? 32 - __clz(s_max) : 0;
  const int hval = s_hval;

  for (int p = max_planes - 1; p >= 0; --p) {
    uint8_t* po = out + (int64_t)(max_planes - 1 - p) * plane_slots;
    if (p >= live_planes) {              // nothing is coded in this plane
      for (int64_t i = threadIdx.x; i < plane_slots; i += blockDim.x)
        po[i] = EMPTY;
      continue;
    }
    // phase 1: significance before the plane and the plane's bit
    for (int i = threadIdx.x; i < nsamp; i += blockDim.x) {
      const int col = i >> 2, r = i & 3;
      const int g = col / w, x = col - g * w, y = 4 * g + r;
      const int idx = (y + 1) * pw + x + 1;
      const int f = st[idx] & (F_VALID | F_SIGN);
      const int m = bm[(int64_t)y * w + x];
      const bool v = f & F_VALID;
      st[idx] = f | ((v && (m >> (p + 1)) > 0) ? F_SIN : 0) |
                ((v && ((m >> p) & 1)) ? F_BIT : 0);
    }
    __syncthreads();
    // phase 2: SPP membership, the least fixpoint above base & nb_sin
    for (int i = threadIdx.x; i < nsamp; i += blockDim.x) {
      const int col = i >> 2, r = i & 3;
      const int g = col / w, x = col - g * w, y = 4 * g + r;
      const int idx = (y + 1) * pw + x + 1;
      const int f = st[idx];
      const bool base = (f & F_VALID) && !(f & F_SIN);
      mem[0][idx] = base && nb_state(st, idx, pw, r, F_SIN, 0, false);
    }
    int cur = 0;
    for (;;) {
      __syncthreads();
      int changed = 0;
      for (int i = threadIdx.x; i < nsamp; i += blockDim.x) {
        const int col = i >> 2, r = i & 3;
        const int g = col / w, x = col - g * w, y = 4 * g + r;
        const int idx = (y + 1) * pw + x + 1;
        const int f = st[idx];
        const bool base = (f & F_VALID) && !(f & F_SIN);
        bool m2 = false;
        if (base) {
          m2 = nb_state(st, idx, pw, r, F_SIN, 0, false) != 0;
          // a neighbour visited before that became significant in the SPP
          for (int k = 0; k < 6 && !m2; ++k) {
            if (k == 4 || !before(k, r, false)) continue;
            const int n = idx + NB_DY[k] * pw + NB_DX[k];
            m2 = mem[cur][n] && (st[n] & F_BIT);
          }
        }
        mem[cur ^ 1][idx] = m2;
        changed |= m2 != (mem[cur][idx] != 0);
      }
      cur ^= 1;
      if (!__syncthreads_or(changed)) break;
    }
    const uint8_t* member = mem[cur];
    // phase 3: new SPP significance and cleanup significance
    for (int i = threadIdx.x; i < nsamp; i += blockDim.x) {
      const int col = i >> 2, r = i & 3;
      const int g = col / w, x = col - g * w, y = 4 * g + r;
      const int idx = (y + 1) * pw + x + 1;
      const int f = st[idx];
      const bool bit = f & F_BIT;
      const bool mb = member[idx];
      const bool cand = (f & F_VALID) && !(f & F_SIN) && !mb;
      st[idx] = f | ((mb && bit) ? F_NEW : 0) | ((cand && bit) ? F_BC : 0);
    }
    __syncthreads();
    // phase 4: the run-length test, one thread per stripe column
    for (int col = threadIdx.x; col < ncol; col += blockDim.x) {
      const int g = col / w, x = col - g * w;
      const bool full = 4 * g + 4 <= hval;
      bool rl = full;
      int fs = 4;
      for (int r = 3; r >= 0; --r) {
        const int idx = (4 * g + r + 1) * pw + x + 1;
        const int f = st[idx];
        const bool cand = (f & F_VALID) && !(f & F_SIN) && !member[idx];
        if (f & F_BIT) fs = r;
        if (!cand || nb_state(st, idx, pw, r, F_SIN | F_NEW, F_BC, true))
          rl = false;
      }
      colst[col] = (rl ? 1 : 0) | (fs << 1);
    }
    __syncthreads();
    // phase 5: every slot of the plane, in slot order
    uint8_t* spp = po;
    uint8_t* mrp = po + (int64_t)ncol * 8;
    uint8_t* cup = po + (int64_t)ncol * 12;
    for (int i = threadIdx.x; i < nsamp; i += blockDim.x) {
      const int col = i >> 2, r = i & 3;
      const int g = col / w, x = col - g * w, y = 4 * g + r;
      const int idx = (y + 1) * pw + x + 1;
      const int f = st[idx];
      const int bit = (f & F_BIT) ? 1 : 0;
      const int sign = (f & F_SIGN) ? 1 : 0;
      // SPP
      int a = EMPTY, bsl = EMPTY;
      if (member[idx]) {
        const unsigned m = nb_state(st, idx, pw, r, F_SIN, F_NEW, false);
        a = zc_ctx(m, bc) | (bit << 5);
        if (f & F_NEW) bsl = sc_slot(st, idx, pw, m, sign);
      }
      spp[2 * (int64_t)i] = (uint8_t)a;
      spp[2 * (int64_t)i + 1] = (uint8_t)bsl;
      // MRP
      int mr = EMPTY;
      if (f & F_SIN) {
        const int mg = bm[(int64_t)y * w + x];
        const bool eta = (mg >> (p + 2)) > 0;
        const bool any =
            nb_state(st, idx, pw, r, F_SIN | F_NEW, 0, false) != 0;
        mr = (eta ? 16 : (any ? 15 : 14)) | (bit << 5);
      }
      mrp[i] = (uint8_t)mr;
      // cleanup
      const int cs = colst[col];
      const bool in_rl = cs & 1;
      const int fs = cs >> 1;
      uint8_t* cc = cup + (int64_t)col * 11;
      if (r == 0) {
        const bool any_bit = fs < 4;
        cc[0] = in_rl ? (uint8_t)(17 | (any_bit ? 32 : 0)) : EMPTY;
        cc[1] = (in_rl && any_bit) ? (uint8_t)(18 | (((fs >> 1) & 1) << 5))
                                   : EMPTY;
        cc[2] = (in_rl && any_bit) ? (uint8_t)(18 | ((fs & 1) << 5)) : EMPTY;
      }
      const bool cand = (f & F_VALID) && !(f & F_SIN) && !member[idx];
      const bool zc_emit = cand && (!in_rl || r > fs);
      const bool sc_emit = (zc_emit && bit) || (in_rl && r == fs && fs < 4);
      int ca = EMPTY, cb = EMPTY;
      if (zc_emit || sc_emit) {
        const unsigned m =
            nb_state(st, idx, pw, r, F_SIN | F_NEW, F_BC, false);
        if (zc_emit) ca = zc_ctx(m, bc) | (bit << 5);
        if (sc_emit) cb = sc_slot(st, idx, pw, m, sign);
      }
      cc[3 + 2 * r] = (uint8_t)ca;
      cc[4 + 2 * r] = (uint8_t)cb;
    }
    __syncthreads();
  }
}

// -------------------------------------------------------- ebcot_compact_rows

__global__ void __launch_bounds__(ROW_THREADS) count_kernel(
    const uint8_t* __restrict__ slots, int64_t t, int* __restrict__ ndec) {
  __shared__ int sh[32];
  const uint8_t* row = slots + blockIdx.x * t;
  int n = 0;
  for (int64_t i = threadIdx.x; i < t; i += blockDim.x) n += row[i] != EMPTY;
  int tot;
  block_exclusive_scan(n, sh, &tot);
  if (threadIdx.x == 0) ndec[blockIdx.x] = tot;
}

// exclusive scan of ndec into off; stats = {total, largest count}
__global__ void __launch_bounds__(SCAN_THREADS) rows_scan_kernel(
    const int* __restrict__ ndec, int nb, long long* __restrict__ off,
    long long* __restrict__ stats) {
  __shared__ int sh[32];
  __shared__ int s_max;
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  long long carry = 0;
  int my_max = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? ndec[i] : 0;
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

__global__ void __launch_bounds__(ROW_THREADS) compact_write_kernel(
    const uint8_t* __restrict__ slots, int64_t t,
    const long long* __restrict__ off, uint8_t* __restrict__ pool) {
  __shared__ int sh[32];
  const uint8_t* row = slots + blockIdx.x * t;
  uint8_t* dst = pool + off[blockIdx.x];
  long long carry = 0;
  const int64_t tile = (int64_t)blockDim.x * ROW_TILE;
  for (int64_t base = 0; base < t; base += tile) {
    const int64_t start = base + (int64_t)threadIdx.x * ROW_TILE;
    uint8_t v[ROW_TILE];
    int n = 0;
#pragma unroll
    for (int j = 0; j < ROW_TILE; ++j) {
      v[j] = start + j < t ? row[start + j] : EMPTY;
      n += v[j] != EMPTY;
    }
    int tot;
    int pos = block_exclusive_scan(n, sh, &tot);
#pragma unroll
    for (int j = 0; j < ROW_TILE; ++j)
      if (v[j] != EMPTY) dst[carry + pos++] = v[j];
    carry += tot;
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

__global__ void __launch_bounds__(SCAN_THREADS) lens_scan_kernel(
    const int* __restrict__ lens, int nb, long long* __restrict__ pool_off,
    long long* __restrict__ total) {
  __shared__ int sh[32];
  long long carry = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int tot;
    const int excl = block_exclusive_scan(i < nb ? lens[i] : 0, sh, &tot);
    if (i < nb) pool_off[i] = carry + excl;
    carry += tot;
  }
  if (threadIdx.x == 0) total[0] = carry;
}

__global__ void __launch_bounds__(COPY_THREADS) pool_copy_kernel(
    const uint8_t* __restrict__ rows, const long long* __restrict__ off,
    const int* __restrict__ lens, const long long* __restrict__ pool_off,
    uint8_t* __restrict__ pool) {
  const int b = blockIdx.x;
  const uint8_t* src = rows + 3 * off[b] + 3 * (int64_t)b;
  uint8_t* dst = pool + pool_off[b];
  const int n = lens[b];
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

extern "C" {

int ebcot_slots_per_column(void) { return SLOTS_PER_COLUMN; }
int ebcot_max_planes(void) { return MAX_PLANES; }

// shared memory of the decision kernel for an h x w block
static size_t decision_smem(int h, int w) {
  return 3 * (size_t)(h + 2) * (w + 2) + (size_t)(h / 4) * w;
}

int ebcot_decision_slots(const void* mags, const void* signs,
                         const void* valid, const void* bclass, int nb,
                         int h, int w, int max_planes, void* slots,
                         void* stream) {
  const size_t smem = decision_smem(h, w);
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        decision_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
  }
  decision_kernel<<<nb, DEC_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)mags, (const int*)signs, (const uint8_t*)valid,
      (const int*)bclass, h, w, max_planes, (uint8_t*)slots);
  return (int)cudaGetLastError();
}

// the counts, offsets and {total, largest count} of the slot rows
int ebcot_compact_count(const void* slots, int nb, long long t, void* ndec,
                        void* off, void* stats, void* stream) {
  count_kernel<<<nb, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)slots, t, (int*)ndec);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rows_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)ndec, nb, (long long*)off, (long long*)stats);
  return (int)cudaGetLastError();
}

int ebcot_compact_write(const void* slots, int nb, long long t,
                        const void* off, void* pool, void* stream) {
  compact_write_kernel<<<nb, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)slots, t, (const long long*)off, (uint8_t*)pool);
  return (int)cudaGetLastError();
}

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
                    int nb, void* pool_off, void* total, void* pool,
                    void* stream) {
  lens_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)lens, nb, (long long*)pool_off, (long long*)total);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  pool_copy_kernel<<<nb, COPY_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const long long*)off, (const int*)lens,
      (const long long*)pool_off, (uint8_t*)pool);
  return (int)cudaGetLastError();
}

}  // extern "C"
