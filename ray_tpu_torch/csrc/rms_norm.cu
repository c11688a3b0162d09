// Row RMSNorm for Hopper (sm_90a): y = (x * rsqrt(mean(x^2) + eps)) * w.
//
// Replaces the Pallas kernel _rms_kernel (ray_tpu/ops/norms.py), which
// normalised 256-row blocks held in VMEM. Here every row is independent
// work for one CTA (one warp when the row is short), so any row count runs,
// including the 8 rows of a decode step and ragged prefill buckets.
//
// Bound: bytes. A row of d elements is read twice (statistics pass and
// scaling pass; the second read hits L1/L2) and written once, with ~4 flops
// per element, far below the card's ~295 flops per byte of HBM traffic.
// Design against that: 16-byte vector loads and stores (8 bf16/fp16 or
// 4 f32 values per thread access), neighbouring threads on neighbouring
// addresses, f32 statistics reduced with warp shuffles and, across warps,
// one shared-memory pass; one rsqrt per row.
//
// C interface (called through ctypes by ray_tpu_torch/ops/norms.py):
//   int rtt_rms_norm(x, w, y, rows, d, x_dtype, w_dtype, eps, stream)
// dtype codes: 0 = float32, 1 = float16, 2 = bfloat16. y has x's dtype.
// d must be a positive multiple of 8; x, y 16-byte aligned, w aligned to
// one pack of its type. Returns a cudaError_t (0 = launched), or -1 for an
// unsupported dtype code.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N values of T moved as one aligned access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the CTA; blockDim.x is a multiple of 32, at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = warp_sum(lane < nwarps ? part[lane] : 0.f);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

// Sum of squares of one row, over vectors i0, i0+step, ...
template <typename T, int VEC>
__device__ __forceinline__ float row_sumsq(const Pack<T, VEC>* xr, int nvec,
                                           int i0, int step) {
  float ss = 0.f;
  for (int i = i0; i < nvec; i += step) {
    const Pack<T, VEC> p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(p.v[j]);
      ss += f * f;
    }
  }
  return ss;
}

template <typename T, typename W, int VEC>
__device__ __forceinline__ void row_scale(const Pack<T, VEC>* xr,
                                          const Pack<W, VEC>* wv,
                                          Pack<T, VEC>* yr, int nvec, int i0,
                                          int step, float r) {
  for (int i = i0; i < nvec; i += step) {
    const Pack<T, VEC> p = xr[i];
    const Pack<W, VEC> q = wv[i];
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // Same rounding points as the reference: (x * rsqrt) then * w, in f32.
      o.v[j] = from_f32<T>((to_f32(p.v[j]) * r) * to_f32(q.v[j]));
    }
    yr[i] = o;
  }
}

// One CTA per row (rows of more than 32 vectors).
template <typename T, typename W>
__global__ void rms_norm_cta_kernel(const T* __restrict__ x,
                                    const W* __restrict__ w,
                                    T* __restrict__ y, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t off = static_cast<int64_t>(blockIdx.x) * d;
  const auto* xr = reinterpret_cast<const Pack<T, VEC>*>(x + off);
  auto* yr = reinterpret_cast<Pack<T, VEC>*>(y + off);
  const auto* wv = reinterpret_cast<const Pack<W, VEC>*>(w);
  const int nvec = d / VEC;
  const float ss = block_sum(row_sumsq<T, VEC>(xr, nvec, threadIdx.x, blockDim.x));
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  row_scale<T, W, VEC>(xr, wv, yr, nvec, threadIdx.x, blockDim.x, r);
}

// One warp per row (rows of at most 32 vectors); 4 rows per CTA.
template <typename T, typename W>
__global__ void rms_norm_warp_kernel(const T* __restrict__ x,
                                     const W* __restrict__ w,
                                     T* __restrict__ y, int64_t rows, int d,
                                     float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int64_t off = row * d;
  const auto* xr = reinterpret_cast<const Pack<T, VEC>*>(x + off);
  auto* yr = reinterpret_cast<Pack<T, VEC>*>(y + off);
  const auto* wv = reinterpret_cast<const Pack<W, VEC>*>(w);
  const int nvec = d / VEC;
  const float ss = warp_sum(row_sumsq<T, VEC>(xr, nvec, lane, 32));
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  row_scale<T, W, VEC>(xr, wv, yr, nvec, lane, 32, r);
}

constexpr int kWarpRowsPerCta = 4;

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int64_t rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  if (nvec <= 32) {
    const int64_t grid = (rows + kWarpRowsPerCta - 1) / kWarpRowsPerCta;
    rms_norm_warp_kernel<T, W><<<static_cast<unsigned>(grid),
                                 32 * kWarpRowsPerCta, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  } else {
    int threads = ((nvec + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    rms_norm_cta_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0,
                                stream>>>(xp, wp, yp, d, eps);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch_w(const void* x, const void* w, void* y, int64_t rows, int d,
               int w_dtype, float eps, cudaStream_t s) {
  switch (w_dtype) {
    case 0: return launch<T, float>(x, w, y, rows, d, eps, s);
    case 1: return launch<T, __half>(x, w, y, rows, d, eps, s);
    case 2: return launch<T, __nv_bfloat16>(x, w, y, rows, d, eps, s);
    default: return -1;
  }
}

}  // namespace

extern "C" int rtt_rms_norm(const void* x, const void* w, void* y,
                            int64_t rows, int d, int x_dtype, int w_dtype,
                            float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 8 != 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return dispatch_w<float>(x, w, y, rows, d, w_dtype, eps, s);
    case 1: return dispatch_w<__half>(x, w, y, rows, d, w_dtype, eps, s);
    case 2: return dispatch_w<__nv_bfloat16>(x, w, y, rows, d, w_dtype, eps, s);
    default: return -1;
  }
}

extern "C" const char* rtt_error_string(int code) {
  if (code == -1) return "unsupported dtype code";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
