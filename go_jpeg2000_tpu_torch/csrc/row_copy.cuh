// Copying variable-length rows into one pool, a warp a row, for NVIDIA
// Hopper (sm_90a).  Included by ht_enc.cu (ht_compact_pool: word rows) and
// ebcot_enc.cu (ebcot_pool_rows: byte rows).
//
// A row of n bytes at any address goes to any address of the pool.  The
// warp walks the pool's 16-byte windows that the row falls in: in a step,
// lane k takes windows k, k + 32, ... (U of them, the template parameter)
// and issues the loads of all their source windows before it stores any.
// A source window is the aligned 16 bytes at the matching place of the
// row, one load inside the row; at the row's two ends only the row's own
// bytes are loaded, so no load reaches outside the row.  Pool window k
// holds bytes r .. r + 15 of source windows k and k + 1, with r = (src -
// dst) mod 16 the same for the whole row: window k + 1 comes from the
// next lane by a shuffle, and the bytes are realigned in registers by
// funnel shifts.  Windows inside the row's range of the pool are stored
// whole; the two end windows, which the row may share with its
// neighbours, by their bytes inside the range (8, 4, 2 and 1-byte
// stores), so no store touches another row's bytes.

#ifndef ROW_COPY_CUH
#define ROW_COPY_CUH

#include <stdint.h>

// Bytes r .. r + 15 (0 <= r < 16) of the 32 bytes x | y, as one window.
__device__ __forceinline__ uint4 realign(uint4 x, uint4 y, int r) {
  const bool h = r & 8, q = r & 4;
  // six words from word 2h on, then five from word 2h + q on
  const unsigned t0 = h ? x.z : x.x, t1 = h ? x.w : x.y, t2 = h ? y.x : x.z,
                 t3 = h ? y.y : x.w, t4 = h ? y.z : y.x, t5 = h ? y.w : y.y;
  const unsigned u0 = q ? t1 : t0, u1 = q ? t2 : t1, u2 = q ? t3 : t2,
                 u3 = q ? t4 : t3, u4 = q ? t5 : t4;
  const unsigned s = 8u * (unsigned)(r & 3);
  return make_uint4(__funnelshift_r(u0, u1, s), __funnelshift_r(u1, u2, s),
                    __funnelshift_r(u2, u3, s), __funnelshift_r(u3, u4, s));
}

// The aligned source window at a of a row [lo, hi): one 16-byte load when
// it lies inside the row, else the row's bytes in it (0 elsewhere), and no
// load at all when it misses the row.
__device__ __forceinline__ uint4 row_window(uintptr_t a, uintptr_t lo,
                                            uintptr_t hi) {
  if (a >= lo && a + 16 <= hi)
    return __ldg(reinterpret_cast<const uint4*>(a));
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (a + 16 > lo && a < hi) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (a + j >= lo && a + j < hi)
        w[j >> 2] |= (unsigned)__ldg(reinterpret_cast<const uint8_t*>(a + j))
                     << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bytes [lo, hi) (0 <= lo < hi <= 16) of v into the aligned window at a,
// by the widest aligned stores that stay inside [lo, hi).
__device__ __forceinline__ void store_bytes(uintptr_t a, uint4 v, int lo,
                                            int hi) {
  const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (lo <= 8 * h && hi >= 8 * h + 8) {
      *reinterpret_cast<uint2*>(a + 8 * h) =
          make_uint2(x[2 * h], x[2 * h + 1]);
      continue;
    }
#pragma unroll
    for (int i = 2 * h; i < 2 * h + 2; ++i) {
      if (lo <= 4 * i && hi >= 4 * i + 4) {
        *reinterpret_cast<unsigned*>(a + 4 * i) = x[i];
        continue;
      }
#pragma unroll
      for (int j = 4 * i; j < 4 * i + 4; j += 2) {
        if (lo <= j && hi >= j + 2) {
          *reinterpret_cast<uint16_t*>(a + j) =
              (uint16_t)(x[i] >> (8 * (j & 3)));
          continue;
        }
        if (j >= lo && j < hi)
          *reinterpret_cast<uint8_t*>(a + j) = (uint8_t)(x[i] >> (8 * (j & 3)));
        if (j + 1 >= lo && j + 1 < hi)
          *reinterpret_cast<uint8_t*>(a + j + 1) =
              (uint8_t)(x[i] >> (8 * ((j + 1) & 3)));
      }
    }
  }
}

__device__ __forceinline__ uint4 shfl_down4(uint4 v) {
  return make_uint4(__shfl_down_sync(0xffffffffu, v.x, 1),
                    __shfl_down_sync(0xffffffffu, v.y, 1),
                    __shfl_down_sync(0xffffffffu, v.z, 1),
                    __shfl_down_sync(0xffffffffu, v.w, 1));
}

__device__ __forceinline__ uint4 shfl_first4(uint4 v) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, 0),
                    __shfl_sync(0xffffffffu, v.y, 0),
                    __shfl_sync(0xffffffffu, v.z, 0),
                    __shfl_sync(0xffffffffu, v.w, 0));
}

// The warp copies the n bytes at src to dst; every lane calls it with the
// same arguments.
template <int U>
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src,
                                          long long n, int lane) {
  if (n <= 0) return;
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = d + (uintptr_t)n;
  const uintptr_t d0 = d & ~(uintptr_t)15;   // the first pool window
  const uintptr_t s0 = s - (d - d0);         // the row's byte for d0
  const int r = (int)(s0 & 15);
  const uintptr_t a0 = s0 - (uintptr_t)r;    // its aligned source window
  const long long nwin = (long long)((e - d0 + 15) >> 4);
  for (long long k0 = 0; k0 < nwin; k0 += 32 * U) {
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u] = row_window(a0 + 16 * (uintptr_t)(k0 + 32 * u + lane), s, s + n);
    uint4 last = make_uint4(0u, 0u, 0u, 0u);   // lane 31's window k + 1
    if (r && lane == 31)
      last = row_window(a0 + 16 * (uintptr_t)(k0 + 32 * U), s,
                        s + n);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint4 v = x[u];
      if (r) {                                 // the same for the warp
        const uint4 down = shfl_down4(x[u]);
        // window k + 1: the next lane's, or for lane 31 lane 0's of the
        // next slab (its own extra load after the last slab)
        uint4 next = last;
        if (u + 1 < U) next = shfl_first4(x[(u + 1) % U]);
        v = realign(x[u], lane == 31 ? next : down, r);
      }
      const long long k = k0 + 32 * u + lane;
      if (k >= nwin) continue;
      const uintptr_t a = d0 + 16 * (uintptr_t)k;
      if (a >= d && a + 16 <= e)
        *reinterpret_cast<uint4*>(a) = v;
      else
        store_bytes(a, v, a < d ? (int)(d - a) : 0,
                    a + 16 > e ? (int)(e - a) : 16);
    }
  }
}

#endif  // ROW_COPY_CUH
