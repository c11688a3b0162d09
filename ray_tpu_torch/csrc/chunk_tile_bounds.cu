// Tile bounds of the ring-attention chunk kernels' positions, for Hopper
// (sm_90a): for every 64-wide block of qpos [Sq] and of kpos [Skv], its min
// and max, and the min of the whole of kpos. K6 and K7
// (flash_chunk_fwd.cu, flash_chunk_bwd.cu) read them to class each
// (q tile, kv tile) pair as masked, visible or partial without reading the
// positions of every tile in every CTA. The positions need not be sorted.
//
// A pre-pass of the chunk kernels: the TPU kernels (ray_tpu/ops/
// attention.py:735, :779) make a full pass and need no bounds. Bound:
// bytes, (Sq + Skv) int32 read once; at S16384 that is 128 KB, a few
// microseconds, so one CTA of 1024 threads does it all (one warp a block,
// shuffles for the min and max; a block reduction for the chunk's min).
//
// C interface (ctypes, ray_tpu_torch/ops/attention.py):
//   int rtt_chunk_tile_bounds(qpos, kpos, out, Sq, Skv, stream)
// out int32 [2 * ceil(Sq/64) + 2 * ceil(Skv/64) + 1]: (min, max) of each q
// block, then of each kv block, then min(kpos). Returns a cudaError_t.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kThreads = 1024;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    chunk_tile_bounds_kernel(const int* __restrict__ qpos,
                             const int* __restrict__ kpos,
                             int* __restrict__ out, int Sq, int Skv) {
  __shared__ int warp_mins[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (Sq + kBlock - 1) / kBlock, nk = (Skv + kBlock - 1) / kBlock;
  for (int blk = warp; blk < nq + nk; blk += kThreads / 32) {
    const bool is_q = blk < nq;
    const int* pos = is_q ? qpos : kpos;
    const int n = is_q ? Sq : Skv;
    const int i0 = (is_q ? blk : blk - nq) * kBlock;
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = i0 + lane; i < min(i0 + kBlock, n); i += 32) {
      const int p = pos[i];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      out[2 * blk] = lo;
      out[2 * blk + 1] = hi;
    }
  }
  int lo = INT_MAX;
  for (int i = threadIdx.x; i < Skv; i += kThreads) lo = min(lo, kpos[i]);
  lo = warp_min(lo);
  if (lane == 0) warp_mins[warp] = lo;
  __syncthreads();
  if (warp == 0) {
    lo = warp_min(warp_mins[lane]);
    if (lane == 0) out[2 * (nq + nk)] = lo;
  }
}

}  // namespace

extern "C" int rtt_chunk_tile_bounds(const void* qpos, const void* kpos,
                                     void* out, int Sq, int Skv,
                                     void* stream) {
  if (Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  chunk_tile_bounds_kernel<<<1, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qpos), static_cast<const int*>(kpos),
      static_cast<int*>(out), Sq, Skv);
  return cudaGetLastError();
}

extern "C" int rtt_chunk_tile_bounds_smem_bytes(int) { return 0; }

extern "C" const char* rtt_chunk_tile_bounds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
