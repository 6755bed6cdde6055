// The colour and level-shift head and tail of the transform chains
// (ISO/IEC 15444-1 Annex G) for NVIDIA Hopper (sm_90a), one pass each:
//
//   mct_forward  the samples [N, C, H, W] as uploaded (uint8, int8, int16,
//                uint16 or int32) -> widen, DC shift (unsigned samples),
//                RCT (5/3, int32) or ICT (9/7, float32) on components 0-2
//                and the DC shift alone on the others -> the contiguous
//                [N, C, H, W] int32 or float32 input of the first DWT level;
//   mct_inverse  the last inverse level's output [N, C, H, W] (int32 for
//                5/3, float32 for 9/7) -> inverse RCT or ICT on components
//                0-2, rounding half to even (9/7), DC shift, clamp to the
//                precision's range and narrowing (uint8, int8, int16 or
//                int32) -> contiguous [N, C, H, W].
//
// Replaces the jnp heads and tails that XLA fused into the JAX package's
// device programs: go_jpeg2000_tpu/ops/mct.py forward_rct, forward_ict,
// inverse_rct, inverse_ict, clamp_to_precision and the DC shifts, as
// go_jpeg2000_tpu/models/fused_encode.py _fused_fn, ops/ht_tpu_decode.py
// fused_decode_fn, parallel/sharded.py make_tile_transform_step and
// make_tile_inverse_step and models/transforms.py chain them.  The plain
// torch versions are go_jpeg2000_tpu_torch/models/transforms.py
// coefficients_plain and samples_plain; the Python wrapper is
// ops/mct_cuda.py.
//
// Bound: memory.  Each sample is read once and each output written once,
// with a few integer or float32 operations per sample.
//
// Design: a streaming pass with no shared memory and no barrier.  A thread
// takes K = 4 consecutive pixels of one frame across all components, so the
// three planes of RCT or ICT are read and written at their own offsets and
// no stacked copy is made: one 16-byte vector of the int32 or float32 side
// and one of 4, 8 or 16 bytes of the samples' side, so a warp's every load
// and store covers one contiguous run (a thread with 16 samples of 1 byte
// stored 64 bytes apart by a warp ran at 11% of the bound).  A grid row a
// frame, grid-stride along it.  A chunk aligned in every plane it touches
// moves by vectors; a chunk at the end of a plane, or a plane off its
// vector size (odd shapes, views), moves one sample at a time.  The input's frame and
// component strides are arguments, so a row shard's view of a contiguous
// batch is read in place; a plane itself must be contiguous.
//
// Exactness: integer sums run in uint32_t, so 29-31-bit samples wrap as
// torch's int32 ops wrap; `>> 2` of the int32 result is the arithmetic
// shift.  The ICT is written with __fmul_rn and __fadd_rn in the plain
// version's order, ((m0 * r + m1 * g) + m2 * b), so nvcc cannot contract
// it into an FMA and every op rounds once, as torch rounds it, with the
// float32 constants of ops/mct.py as hex literals.  The 9/7 tail rounds
// half to even and converts as torch's round then .to(torch.int32) do on
// the card (cvt.rni.s32.f32: saturating, NaN to 0).
//
// Entry points: mct_forward(...) and mct_inverse(...), below; each launches
// on the caller's stream, allocates nothing, launches nothing for an empty
// tensor and returns cudaGetLastError() (cudaErrorInvalidValue for a dtype
// code it does not know).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define BLOCKS_PER_SM 16

// dtype codes of the wrapper (ops/mct_cuda.py)
enum { D_U8 = 0, D_I8 = 1, D_I16 = 2, D_U16 = 3, D_I32 = 4, D_F32 = 5 };
// colour transform of components 0-2
enum { MCT_NONE = 0, MCT_RCT = 1, MCT_ICT = 2 };

// go_jpeg2000_tpu_torch/ops/mct.py _ICT_FWD and _ICT_INV, as float32
__constant__ float kFwd[3][3] = {
    {0x1.322d0ep-2f, 0x1.2c8b44p-1f, 0x1.d2f1aap-4f},
    {-0x1.599242p-3f, -0x1.5336dep-2f, 0x1.0p-1f},
    {0x1.0p-1f, -0x1.acbc8cp-2f, -0x1.4d0dd0p-4f}};
#define INV_R_CR 0x1.66e978p+0f     // 1.402
#define INV_G_CB -0x1.606530p-2f    // -0.344136
#define INV_G_CR -0x1.6da33cp-1f    // -0.714136
#define INV_B_CB 0x1.c5a1cap+0f     // 1.772

// pixels a thread takes at a time: one 16-byte vector of the 4-byte side
// (int32 or float32), 4, 8 or 16 bytes of the samples' side
#define K 4

template <int B>
struct Vec;
template <>
struct Vec<4> {
  typedef uint32_t T;
};
template <>
struct Vec<8> {
  typedef uint2 T;
};
template <>
struct Vec<16> {
  typedef uint4 T;
};

// whether p is aligned to a vector of K samples
template <typename T>
__device__ __forceinline__ bool aligned(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & (K * sizeof(T) - 1)) == 0;
}

// K samples of T from p: one vector load when `vec`, else the first cnt
template <typename T>
__device__ __forceinline__ void load(const T* __restrict__ p, bool vec,
                                     int cnt, T (&v)[K]) {
  typedef typename Vec<K * sizeof(T)>::T V;
  if (vec) {
    union {
      V u;
      T t[K];
    } b;
    b.u = *reinterpret_cast<const V*>(p);
#pragma unroll
    for (int i = 0; i < K; i++) v[i] = b.t[i];
  } else {
#pragma unroll
    for (int i = 0; i < K; i++) v[i] = i < cnt ? p[i] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ p, bool vec, int cnt,
                                      const T (&v)[K]) {
  typedef typename Vec<K * sizeof(T)>::T V;
  if (vec) {
    union {
      V u;
      T t[K];
    } b;
#pragma unroll
    for (int i = 0; i < K; i++) b.t[i] = v[i];
    *reinterpret_cast<V*>(p) = b.u;
  } else {
#pragma unroll
    for (int i = 0; i < K; i++)
      if (i < cnt) p[i] = v[i];
  }
}

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

template <typename T>
__device__ __forceinline__ T from_int(int32_t x);
template <>
__device__ __forceinline__ int32_t from_int<int32_t>(int32_t x) { return x; }
template <>
__device__ __forceinline__ float from_int<float>(int32_t x) {
  return __int2float_rn(x);
}

// in: samples, frame stride sn and component stride sc (elements), each
// plane of P contiguous pixels; out: contiguous [n, c, P]; shift: the DC
// shift (0 for signed samples)
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
mct_fwd_kernel(const Tin* __restrict__ in, long long sn, long long sc,
               Tout* __restrict__ out, int n, int c, long long P, int mct,
               uint32_t shift) {
  const long long per = (P + K - 1) / K;
  const int c0 = mct != MCT_NONE ? 3 : 0;
  for (long long f = blockIdx.y; f < n; f += gridDim.y)
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x;
       q < per; q += (long long)gridDim.x * THREADS) {
    const long long p0 = q * K;
    const int cnt = (int)min((long long)K, P - p0);
    const Tin* src = in + f * sn + p0;
    Tout* dst = out + f * c * P + p0;
    if (c0) {
      const Tin* s[3] = {src, src + sc, src + 2 * sc};
      Tout* d[3] = {dst, dst + P, dst + 2 * P};
      bool vec = cnt == K;
#pragma unroll
      for (int j = 0; j < 3; j++)
        vec = vec && aligned(s[j]) && aligned(d[j]);
      Tin a[3][K];
#pragma unroll
      for (int j = 0; j < 3; j++) load(s[j], vec, cnt, a[j]);
      Tout o[3][K];
#pragma unroll
      for (int i = 0; i < K; i++) {
        const int32_t r = sub32((int32_t)a[0][i], (int32_t)shift);
        const int32_t gg = sub32((int32_t)a[1][i], (int32_t)shift);
        const int32_t b = sub32((int32_t)a[2][i], (int32_t)shift);
        if (mct == MCT_RCT) {
          o[0][i] = from_int<Tout>(add32(add32(r, add32(gg, gg)), b) >> 2);
          o[1][i] = from_int<Tout>(sub32(b, gg));
          o[2][i] = from_int<Tout>(sub32(r, gg));
        } else {
          const float fr = __int2float_rn(r), fg = __int2float_rn(gg),
                      fb = __int2float_rn(b);
          float y[3];
#pragma unroll
          for (int j = 0; j < 3; j++)
            y[j] = __fadd_rn(__fadd_rn(__fmul_rn(kFwd[j][0], fr),
                                       __fmul_rn(kFwd[j][1], fg)),
                             __fmul_rn(kFwd[j][2], fb));
          // an ICT only runs with float32 output
#pragma unroll
          for (int j = 0; j < 3; j++) o[j][i] = (Tout)y[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 3; j++) store(d[j], vec, cnt, o[j]);
    }
    for (int j = c0; j < c; j++) {
      const Tin* s = src + j * sc;
      Tout* d = dst + j * P;
      const bool vec = cnt == K && aligned(s) && aligned(d);
      Tin a[K];
      load(s, vec, cnt, a);
      Tout o[K];
#pragma unroll
      for (int i = 0; i < K; i++)
        o[i] = from_int<Tout>(sub32((int32_t)a[i], (int32_t)shift));
      store(d, vec, cnt, o);
    }
  }
}

__device__ __forceinline__ int32_t to_int(int32_t x) { return x; }
// round half to even, saturating, NaN to 0: torch.round then .to(int32)
__device__ __forceinline__ int32_t to_int(float x) {
  return __float2int_rn(x);
}

// in: int32 or float32 coefficients (frame stride sn, component stride sc,
// planes of P contiguous pixels); out: contiguous [n, c, P]; the samples
// clamped to [lo, hi] after the DC shift
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
mct_inv_kernel(const Tin* __restrict__ in, long long sn, long long sc,
               Tout* __restrict__ out, int n, int c, long long P, int mct,
               uint32_t shift, int32_t lo, int32_t hi) {
  const long long per = (P + K - 1) / K;
  const int c0 = mct != MCT_NONE ? 3 : 0;
  for (long long f = blockIdx.y; f < n; f += gridDim.y)
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x;
       q < per; q += (long long)gridDim.x * THREADS) {
    const long long p0 = q * K;
    const int cnt = (int)min((long long)K, P - p0);
    const Tin* src = in + f * sn + p0;
    Tout* dst = out + f * c * P + p0;
    if (c0) {
      const Tin* s[3] = {src, src + sc, src + 2 * sc};
      Tout* d[3] = {dst, dst + P, dst + 2 * P};
      bool vec = cnt == K;
#pragma unroll
      for (int j = 0; j < 3; j++)
        vec = vec && aligned(s[j]) && aligned(d[j]);
      Tin a[3][K];
#pragma unroll
      for (int j = 0; j < 3; j++) load(s[j], vec, cnt, a[j]);
      Tout o[3][K];
#pragma unroll
      for (int i = 0; i < K; i++) {
        int32_t x[3];
        if (mct == MCT_RCT) {
          const int32_t y = (int32_t)a[0][i], u = (int32_t)a[1][i],
                        v = (int32_t)a[2][i];
          const int32_t gg = sub32(y, add32(u, v) >> 2);
          x[0] = add32(v, gg);
          x[1] = gg;
          x[2] = add32(u, gg);
        } else {
          const float y = (float)a[0][i], cb = (float)a[1][i],
                      cr = (float)a[2][i];
          x[0] = to_int(__fadd_rn(y, __fmul_rn(INV_R_CR, cr)));
          x[1] = to_int(__fadd_rn(__fadd_rn(y, __fmul_rn(INV_G_CB, cb)),
                                  __fmul_rn(INV_G_CR, cr)));
          x[2] = to_int(__fadd_rn(y, __fmul_rn(INV_B_CB, cb)));
        }
#pragma unroll
        for (int j = 0; j < 3; j++)
          o[j][i] = (Tout)min(max(add32(x[j], (int32_t)shift), lo), hi);
      }
#pragma unroll
      for (int j = 0; j < 3; j++) store(d[j], vec, cnt, o[j]);
    }
    for (int j = c0; j < c; j++) {
      const Tin* s = src + j * sc;
      Tout* d = dst + j * P;
      const bool vec = cnt == K && aligned(s) && aligned(d);
      Tin a[K];
      load(s, vec, cnt, a);
      Tout o[K];
#pragma unroll
      for (int i = 0; i < K; i++)
        o[i] = (Tout)min(max(add32(to_int(a[i]), (int32_t)shift), lo), hi);
      store(d, vec, cnt, o);
    }
  }
}

// a frame per grid row (strided past 65535 frames), blocks along the frame
// to about BLOCKS_PER_SM per SM in all
static dim3 grid_for(int n, long long P) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  const int y = min(n, 65535);
  const long long along = ((P + K - 1) / K + THREADS - 1) / THREADS;
  const long long x = min(along, max(1ll, (long long)sms * BLOCKS_PER_SM / y));
  return dim3((unsigned)x, (unsigned)y);
}

template <typename Tin, typename Tout>
static void launch_fwd(const void* in, long long sn, long long sc, void* out,
                       int n, int c, long long P, int mct, uint32_t shift,
                       cudaStream_t st) {
  mct_fwd_kernel<Tin, Tout><<<grid_for(n, P), THREADS, 0, st>>>(
      (const Tin*)in, sn, sc, (Tout*)out, n, c, P, mct, shift);
}

template <typename Tin, typename Tout>
static void launch_inv(const void* in, long long sn, long long sc, void* out,
                       int n, int c, long long P, int mct, uint32_t shift,
                       int32_t lo, int32_t hi, cudaStream_t st) {
  mct_inv_kernel<Tin, Tout><<<grid_for(n, P), THREADS, 0, st>>>(
      (const Tin*)in, sn, sc, (Tout*)out, n, c, P, mct, shift, lo, hi);
}

template <typename Tout>
static int fwd_by_input(int in_dtype, const void* in, long long sn,
                        long long sc, void* out, int n, int c, long long P,
                        int mct, uint32_t shift, cudaStream_t st) {
  switch (in_dtype) {
    case D_U8:
      launch_fwd<uint8_t, Tout>(in, sn, sc, out, n, c, P, mct, shift, st);
      break;
    case D_I8:
      launch_fwd<int8_t, Tout>(in, sn, sc, out, n, c, P, mct, shift, st);
      break;
    case D_I16:
      launch_fwd<int16_t, Tout>(in, sn, sc, out, n, c, P, mct, shift, st);
      break;
    case D_U16:
      launch_fwd<uint16_t, Tout>(in, sn, sc, out, n, c, P, mct, shift, st);
      break;
    case D_I32:
      launch_fwd<int32_t, Tout>(in, sn, sc, out, n, c, P, mct, shift, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Tin>
static int inv_by_output(int out_dtype, const void* in, long long sn,
                         long long sc, void* out, int n, int c, long long P,
                         int mct, uint32_t shift, int32_t lo, int32_t hi,
                         cudaStream_t st) {
  switch (out_dtype) {
    case D_U8:
      launch_inv<Tin, uint8_t>(in, sn, sc, out, n, c, P, mct, shift, lo, hi,
                               st);
      break;
    case D_I8:
      launch_inv<Tin, int8_t>(in, sn, sc, out, n, c, P, mct, shift, lo, hi,
                              st);
      break;
    case D_I16:
      launch_inv<Tin, int16_t>(in, sn, sc, out, n, c, P, mct, shift, lo, hi,
                               st);
      break;
    case D_I32:
      launch_inv<Tin, int32_t>(in, sn, sc, out, n, c, P, mct, shift, lo, hi,
                               st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// in_dtype: D_U8 .. D_I32; float_out: 9/7 (float32 output) else int32;
// mct: MCT_NONE, MCT_RCT (int32 output) or MCT_ICT (float32 output), with
// c >= 3
int mct_forward(const void* in, long long sn, long long sc, int in_dtype,
                void* out, int float_out, int n, int c, long long P, int mct,
                unsigned int shift, void* stream) {
  if (n <= 0 || c <= 0 || P <= 0) return 0;
  if ((mct != MCT_NONE && c < 3) || (mct == MCT_RCT && float_out) ||
      (mct == MCT_ICT && !float_out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (float_out)
    return fwd_by_input<float>(in_dtype, in, sn, sc, out, n, c, P, mct,
                               shift, st);
  return fwd_by_input<int32_t>(in_dtype, in, sn, sc, out, n, c, P, mct,
                               shift, st);
}

// in_dtype: D_I32 (5/3) or D_F32 (9/7); out_dtype: D_U8, D_I8, D_I16 or
// D_I32; mct: MCT_NONE, MCT_RCT (int32 input) or MCT_ICT (float32 input)
int mct_inverse(const void* in, long long sn, long long sc, int in_dtype,
                void* out, int out_dtype, int n, int c, long long P, int mct,
                unsigned int shift, int lo, int hi, void* stream) {
  if (n <= 0 || c <= 0 || P <= 0) return 0;
  if ((mct != MCT_NONE && c < 3) || (mct == MCT_RCT && in_dtype != D_I32) ||
      (mct == MCT_ICT && in_dtype != D_F32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == D_F32)
    return inv_by_output<float>(out_dtype, in, sn, sc, out, n, c, P, mct,
                                shift, lo, hi, st);
  if (in_dtype == D_I32)
    return inv_by_output<int32_t>(out_dtype, in, sn, sc, out, n, c, P, mct,
                                  shift, lo, hi, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
