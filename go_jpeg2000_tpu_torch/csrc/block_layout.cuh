// The code-block slot layout shared by ht_extract_blocks (ht_enc.cu) and
// ht_blocks_to_pyramid (ht_dec.cu), for NVIDIA Hopper (sm_90a).
//
// A plan's pyramid leaves are [n, C, bh, bw] tensors, one per (level, band),
// and its code-block slots int32 [n, nb, cbh, cbw] (cbh and cbw powers of
// two, at least 4).  The wrappers (ops/ht_enc_cuda.py, ops/ht_dec_cuda.py)
// build the per-frame descriptors of a plan once, on the host, and keep them
// on the card; every frame of a batch shares them:
//
// * extraction: one descriptor per slot (LAYOUT_FIELDS int32): the slot's
//   leaf (an index into the launch's LeafPtrs), its valid rows and columns,
//   the leaf's row length bw, the element offset of the slot's first sample
//   in one frame of the leaf ((c * bh + y0) * bw + x0), the leaf's elements
//   per frame (C * bh * bw) and the band's quantizer step (float32 bits);
// * assembly: one descriptor per leaf row of a frame (LAYOUT_FIELDS int32):
//   the row's leaf, bw, the element offset of the row in one frame of the
//   leaf ((c * bh + y) * bw), the leaf's elements per frame, the slot of the
//   row's first grid cell within a frame, the word offset of the row in
//   that slot (r * cbw), the grid offset ox and log2 of the cell width
//   (ox | lw << 16), and the quantizer step.
//
// Offset grids (tiles off the code-block grid) anchor their first-row and
// first-column cells at the slot's top-left corner: the JAX version's roll.
//
// The leaves' pointers change with every call, so the extraction takes them
// by value (LeafPtrs, a kernel parameter), one per distinct leaf: at most
// 3 * 32 + 1 for the 32 decomposition levels a codestream may have.

#ifndef BLOCK_LAYOUT_CUH
#define BLOCK_LAYOUT_CUH

#include <stdint.h>

#define MAX_LEAVES 97          // distinct leaves of a launch: 3 * 32 + 1
#define LAYOUT_FIELDS 8        // int32 fields of a slot or row descriptor

struct LeafPtrs {
  const void* p[MAX_LEAVES];
};

// Words m .. m + 3 (0 <= m < 4) of the eight words x | y.
__device__ __forceinline__ int4 realign_words(int4 x, int4 y, int m) {
  const bool h = m & 2, q = m & 1;
  const int t0 = h ? x.z : x.x, t1 = h ? x.w : x.y, t2 = h ? y.x : x.z,
            t3 = h ? y.y : x.w, t4 = h ? y.z : y.x;
  return make_int4(q ? t1 : t0, q ? t2 : t1, q ? t3 : t2, q ? t4 : t3);
}

// The aligned 4-word window at a of a run of words [lo, hi): one 16-byte
// load when it lies inside the run, else the run's words in it (0
// elsewhere), and no load at all when it misses the run.
__device__ __forceinline__ int4 run_window(const int* a, const int* lo,
                                           const int* hi) {
  if (a >= lo && a + 4 <= hi) return __ldg(reinterpret_cast<const int4*>(a));
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (a + k >= lo && a + k < hi) w[k] = __ldg(a + k);
  return make_int4(w[0], w[1], w[2], w[3]);
}

// Words src .. src + 3 of the run [lo, hi) (lo <= src < hi), 0 past hi:
// the one or two aligned windows they fall in, realigned in registers.  No
// load reaches outside the run.
__device__ __forceinline__ int4 run_words(const int* src, const int* lo,
                                          const int* hi) {
  const int m = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int* a = src - m;
  const int4 x = run_window(a, lo, hi);
  if (m == 0) return x;
  const int4 y = src + 4 - m < hi ? run_window(a + 4, lo, hi)
                                  : make_int4(0, 0, 0, 0);
  return realign_words(x, y, m);
}

#endif  // BLOCK_LAYOUT_CUH
