// One 2-D level of the irreversible 9/7 lifting DWT (ISO/IEC 15444-1 Annex F),
// forward and inverse, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   dwt97_fwd_level  <- go_jpeg2000_tpu/ops/dwt_pallas.py _dwt97_level_kernel
//                       (plus the strided deinterleave XLA ran after it,
//                       dwt_pallas.py _level_fn)
//   dwt97_inv_level  <- go_jpeg2000_tpu/ops/dwt_pallas.py _idwt97_level_kernel
//                       (plus the band interleave before it,
//                       dwt_pallas.py _interleave_bands)
// The plain torch version is go_jpeg2000_tpu_torch/ops/dwt.py; the Python
// wrapper, build and launch counts are in ops/dwt_cuda.py.
//
// Bound: memory.  A level reads and writes each float32 sample once, 8 bytes
// per sample, with four lifting steps and a scaling per axis in between
// (about 20 flops per sample), far below the card's flop rate.  The design is
// that of csrc/dwt53.cu: each block owns one frame and a strip of STRIP
// output rows at full width, loads the strip plus the rows the vertical
// lifting reaches into (the halo), lifts in shared memory and stores once,
// straight into the four band tensors (forward) or out of them (inverse).
//
// The halo is deeper than 5/3's: each of the four vertical steps reaches one
// row further.  Forward, for output rows [r0, r0 + rr) with r0 even:
//   delta (even rows r0 .. r0+rr-2)  needs gamma rows r0-1 .. r0+rr-1,
//   gamma (odd rows r0-1 .. r0+rr-1) needs beta  rows r0-2 .. r0+rr,
//   beta  (even rows r0-2 .. r0+rr)  needs alpha rows r0-3 .. r0+rr+1,
//   alpha (odd rows r0-3 .. r0+rr+1) needs input rows r0-4 .. r0+rr+2,
// so 4 rows above and 3 below.  The inverse runs the steps the other way
// round (delta on even, gamma on odd, beta on even, alpha on odd) for
// output rows r0 .. r0+rr-1 and needs interleaved rows r0-3 .. r0+rr+3:
// 3 above and 4 below.  Both are HALO = 7 rows.
//
// Exactness: every step is written with __fadd_rn/__fsub_rn/__fmul_rn in the
// plain version's order, c + ALPHA * (l + r), so nvcc cannot contract it into
// an FMA and each op is rounded once, as torch rounds it.  The constants are
// the float32 roundings of the doubles, and the scalings use the float32
// rounding of the double 1.0 / K, as torch's `x * (1.0 / K)` does.  The
// kernel then equals the plain version bit for bit.  Signal edges use
// whole-sample symmetric extension applied until the index is inside (the
// lifting stencils are symmetric, so lifting the extension gives the
// extension of the lifted signal, exactly).
//
// Row shards (the halo form; replaces the row-shard lifting of
// go_jpeg2000_tpu/parallel/sharded.py, _odd_update_sharded,
// _even_update_sharded, _vlift97_sharded, _vlift97_inverse_sharded): as in
// csrc/dwt53.cu, x may be one row shard, and `above` [n, 4 (inverse 3), w]
// and `below` [n, 3 (inverse 4), w] are the rows of the globally extended
// signal just outside it (for the inverse, interleaved rows with the
// low-pass half first), built once per level from every shard's edge rows.
// A null pointer is a global edge, where the shard reflects on itself.  The
// lifting reaches 4 rows, so a 2-row shard takes rows of shards beyond its
// neighbours; the halo brings them, already reflected at the global edges.
//
// Geometry: even origin, even H and W (>= 2) at this level; other levels
// take the plain version.  Kernels launch on the caller's stream, allocate
// nothing, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define STRIP 16          // output rows per block (even)
#define HALO 7            // forward: 4 rows above, 3 below; inverse: 3, 4
#define FWD_ABOVE 4
#define INV_ABOVE 3
#define THREADS 256

#define ALPHA_D -1.586134342059924
#define BETA_D -0.052980118572961
#define GAMMA_D 0.882911075530934
#define DELTA_D 0.443506852043971
#define K_D 1.230174104914001

__device__ __constant__ float kAlpha = (float)ALPHA_D;
__device__ __constant__ float kBeta = (float)BETA_D;
__device__ __constant__ float kGamma = (float)GAMMA_D;
__device__ __constant__ float kDelta = (float)DELTA_D;
__device__ __constant__ float kK = (float)K_D;
__device__ __constant__ float kInvK = (float)(1.0 / K_D);

__device__ __forceinline__ int reflect(int i, int n) {
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// Row g (-ha <= g < h + hb) of a shard of h rows in a frame: from the halo
// above or below where one is given, else the shard's own row (reflected).
__device__ __forceinline__ const float* shard_row(const float* x,
                                                  const float* above,
                                                  const float* below,
                                                  int frame, int g, int h,
                                                  int w, int ha, int hb) {
  if (g < 0 && above) return above + ((int64_t)frame * ha + ha + g) * w;
  if (g >= h && below) return below + ((int64_t)frame * hb + g - h) * w;
  return x + ((int64_t)frame * h + reflect(g, h)) * w;
}

// c + k * (l + r), each op rounded once
__device__ __forceinline__ float lift_add(float c, float k, float l, float r) {
  return __fadd_rn(c, __fmul_rn(k, __fadd_rn(l, r)));
}

// c - k * (l + r), each op rounded once
__device__ __forceinline__ float lift_sub(float c, float k, float l, float r) {
  return __fsub_rn(c, __fmul_rn(k, __fadd_rn(l, r)));
}

// One horizontal lifting step on columns of parity `odd` of shared rows
// rows0 .. rows0+nrows-1 (row stride w, w even): x[c] = x[c] +/- k * (x[c-1]
// + x[c+1]), column -1 reflecting to 1 and column w to w-2.
__device__ __forceinline__ void hstep(float* s, int rows0, int nrows, int w,
                                      int odd, float k, bool add) {
  const int w2 = w >> 1;
  for (int e = threadIdx.x; e < nrows * w2; e += blockDim.x) {
    float* row = s + (rows0 + e / w2) * w;
    const int c = 2 * (e % w2) + odd;
    const int l = (c > 0) ? c - 1 : 1;
    const int r = (c + 1 < w) ? c + 1 : w - 2;
    row[c] = add ? lift_add(row[c], k, row[l], row[r])
                 : lift_sub(row[c], k, row[l], row[r]);
  }
  __syncthreads();
}

// One vertical lifting step on the `count` shared rows j0, j0+2, ..:
// s[j] = s[j] +/- k * (s[j-1] + s[j+1]).
__device__ __forceinline__ void vstep(float* s, int j0, int count, int w,
                                      float k, bool add) {
  for (int e = threadIdx.x; e < count * w; e += blockDim.x) {
    const int j = j0 + 2 * (e / w), c = e % w;
    float* p = s + j * w + c;
    *p = add ? lift_add(*p, k, p[-w], p[w]) : lift_sub(*p, k, p[-w], p[w]);
  }
  __syncthreads();
}

// Scale the `nrows` shared rows j0, j0+1, .. by the parity of their signal
// rows: row j0 is odd when first_odd is 1, and the parity alternates.
__device__ __forceinline__ void vscale(float* s, int j0, int nrows, int w,
                                       int first_odd, float even_scale,
                                       float odd_scale) {
  for (int e = threadIdx.x; e < nrows * w; e += blockDim.x) {
    const int k = e / w;
    const bool odd = ((k + first_odd) & 1) != 0;
    float* p = s + (j0 + k) * w + e % w;
    *p = __fmul_rn(*p, odd ? odd_scale : even_scale);
  }
  __syncthreads();
}

// x [n, h, w] -> ll, hl, lh, hh [n, h/2, w/2].  Block b: frame b / strips,
// output rows [r0, r0 + rr).  Shared row j holds input row r0 - 4 + j, so a
// shared row's parity is its input row's parity.
__global__ void __launch_bounds__(THREADS)
dwt97_fwd_kernel(const float* __restrict__ x, const float* __restrict__ above,
                 const float* __restrict__ below, float* __restrict__ ll,
                 float* __restrict__ hl, float* __restrict__ lh,
                 float* __restrict__ hh, int h, int w, int strips) {
  extern __shared__ float s[];
  const int frame = blockIdx.x / strips;
  const int r0 = (blockIdx.x % strips) * STRIP;
  const int rr = min(STRIP, h - r0);           // even: h and r0 are even
  const int nload = rr + HALO;
  const int w2 = w >> 1;

  for (int e = threadIdx.x; e < nload * w; e += blockDim.x) {
    const int j = e / w, c = e % w;
    s[j * w + c] = shard_row(x, above, below, frame, r0 - FWD_ABOVE + j, h, w,
                             FWD_ABOVE, HALO - FWD_ABOVE)[c];
  }
  __syncthreads();
  vstep(s, 1, rr / 2 + 3, w, kAlpha, true);    // odd rows r0-3 .. r0+rr+1
  vstep(s, 2, rr / 2 + 2, w, kBeta, true);     // even rows r0-2 .. r0+rr
  vstep(s, 3, rr / 2 + 1, w, kGamma, true);    // odd rows r0-1 .. r0+rr-1
  vstep(s, 4, rr / 2, w, kDelta, true);        // even rows r0 .. r0+rr-2
  vscale(s, 4, rr, w, 0, kInvK, kK);           // rows r0 .. r0+rr-1
  hstep(s, 4, rr, w, 1, kAlpha, true);         // 2D_SD: columns, then rows
  hstep(s, 4, rr, w, 0, kBeta, true);
  hstep(s, 4, rr, w, 1, kGamma, true);
  hstep(s, 4, rr, w, 0, kDelta, true);

  // even row -> LL|HL, odd row -> LH|HH; even column -> low (x 1/K),
  // odd column -> high (x K): the horizontal scaling happens in the store
  const int64_t obase = (int64_t)frame * (h >> 1) * w2;
  for (int e = threadIdx.x; e < rr * w2; e += blockDim.x) {
    const int k = e / w2, m = e % w2;
    const float* row = s + (4 + k) * w;
    const int64_t o = obase + (int64_t)((r0 + k) >> 1) * w2 + m;
    const float lo = __fmul_rn(row[2 * m], kInvK);
    const float hi = __fmul_rn(row[2 * m + 1], kK);
    if (k & 1) {
      lh[o] = lo;
      hh[o] = hi;
    } else {
      ll[o] = lo;
      hl[o] = hi;
    }
  }
}

// ll, hl, lh, hh [n, h/2, w/2] -> out [n, h, w].  Shared row j holds
// interleaved row r0 - 3 + j: shared row j is an odd (high-pass) row when j
// is even.
__global__ void __launch_bounds__(THREADS)
dwt97_inv_kernel(const float* __restrict__ ll, const float* __restrict__ hl,
                 const float* __restrict__ lh, const float* __restrict__ hh,
                 const float* __restrict__ above,
                 const float* __restrict__ below, float* __restrict__ out,
                 int h, int w, int strips) {
  extern __shared__ float s[];
  const int frame = blockIdx.x / strips;
  const int r0 = (blockIdx.x % strips) * STRIP;
  const int rr = min(STRIP, h - r0);
  const int nload = rr + HALO;
  const int w2 = w >> 1;
  const int64_t bbase = (int64_t)frame * (h >> 1) * w2;

  // 2D_SR: rows first.  The horizontal scaling (even column x K, odd
  // column x 1/K) happens in the load.
  for (int e = threadIdx.x; e < nload * w2; e += blockDim.x) {
    const int j = e / w2, m = e % w2;
    const int g = r0 - INV_ABOVE + j;
    float* row = s + j * w;
    float lo, hi;
    if (g < 0 && above) {
      const float* src =
          above + ((int64_t)frame * INV_ABOVE + INV_ABOVE + g) * w;
      lo = src[m];
      hi = src[w2 + m];
    } else if (g >= h && below) {
      const float* src =
          below + ((int64_t)frame * (HALO - INV_ABOVE) + g - h) * w;
      lo = src[m];
      hi = src[w2 + m];
    } else {
      const int r = reflect(g, h);
      const int64_t i = bbase + (int64_t)(r >> 1) * w2 + m;
      lo = (r & 1) ? lh[i] : ll[i];
      hi = (r & 1) ? hh[i] : hl[i];
    }
    row[2 * m] = __fmul_rn(lo, kK);
    row[2 * m + 1] = __fmul_rn(hi, kInvK);
  }
  __syncthreads();
  hstep(s, 0, nload, w, 0, kDelta, false);
  hstep(s, 0, nload, w, 1, kGamma, false);
  hstep(s, 0, nload, w, 0, kBeta, false);
  hstep(s, 0, nload, w, 1, kAlpha, false);
  // then columns: shared row 0 is interleaved row r0 - 3, odd
  vscale(s, 0, nload, w, 1, kK, kInvK);
  vstep(s, 1, rr / 2 + 3, w, kDelta, false);   // even rows r0-2 .. r0+rr+2
  vstep(s, 2, rr / 2 + 2, w, kGamma, false);   // odd rows r0-1 .. r0+rr+1
  vstep(s, 3, rr / 2 + 1, w, kBeta, false);    // even rows r0 .. r0+rr
  vstep(s, 4, rr / 2, w, kAlpha, false);       // odd rows r0+1 .. r0+rr-1

  const int64_t obase = (int64_t)frame * h * w + (int64_t)r0 * w;
  for (int e = threadIdx.x; e < rr * w; e += blockDim.x) {
    out[obase + e] = s[3 * w + e];              // shared rows 3 .. rr+2
  }
}

static size_t smem_bytes(int w) {
  return (size_t)(STRIP + HALO) * (size_t)w * sizeof(float);
}

extern "C" {

int dwt97_strip_rows(void) { return STRIP; }
int dwt97_halo_rows(void) { return HALO; }
int dwt97_fwd_above(void) { return FWD_ABOVE; }
int dwt97_inv_above(void) { return INV_ABOVE; }

int dwt97_fwd_level(const void* x, const void* above, const void* below,
                    void* ll, void* hl, void* lh, void* hh, int n, int h,
                    int w, void* stream) {
  const int strips = (h + STRIP - 1) / STRIP;
  const size_t smem = smem_bytes(w);
  cudaFuncSetAttribute(dwt97_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dwt97_fwd_kernel<<<n * strips, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)above, (const float*)below, (float*)ll,
      (float*)hl, (float*)lh, (float*)hh, h, w, strips);
  return (int)cudaGetLastError();
}

int dwt97_inv_level(const void* ll, const void* hl, const void* lh,
                    const void* hh, const void* above, const void* below,
                    void* out, int n, int h, int w, void* stream) {
  const int strips = (h + STRIP - 1) / STRIP;
  const size_t smem = smem_bytes(w);
  cudaFuncSetAttribute(dwt97_inv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dwt97_inv_kernel<<<n * strips, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)ll, (const float*)hl, (const float*)lh, (const float*)hh,
      (const float*)above, (const float*)below, (float*)out, h, w, strips);
  return (int)cudaGetLastError();
}

}  // extern "C"
