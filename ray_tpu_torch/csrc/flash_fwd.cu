// Flash-attention forward for Hopper (sm_90a): out = softmax(q k^T * scale) v
// with the row logsumexp, GQA-native (k/v keep their Hkv heads).
//
// Replaces the Pallas kernel _flash_fwd_kernel (ray_tpu/ops/attention.py),
// which walked kv blocks of one packed q tile held in VMEM, in grid order.
// Here one CTA of 4 warps owns a 64-row q tile of one (batch, q head) and
// reads the kv head h / (H / Hkv); each warp owns 16 of the q rows. K/V
// tiles are re-read by the rep q heads of a kv head and come from L2.
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_fwd_plain in ray_tpu_torch/ops/attention.py:
//   qs  = bf16(q * scale * log2(e))                 (once per q tile)
//   s   = qs . k^T in f32 (mma.sync m16n8k16, bf16 in, f32 accumulate)
//   masked logits (causal kpos > qpos, or past the ragged kv tail) = -1e30
//   online softmax in base 2 over 64-wide kv tiles:
//     m' = max(m, rowmax s); p = exp2(s - m'); alpha = exp2(m - m')
//     p16 = bf16(p); l = l*alpha + rowsum(p16); o = o*alpha + p16 . v
//   out = bf16(o / max(l, 1e-30)); lse = (m + log2 l) * ln 2   (natural log)
// l sums the same bf16 p that multiplies v, so o/l and lse agree (the
// TPU kernel's ones-column trick computes the same sum on the MXU).
//
// Bound: operations. At the training shape (B4 H32 Hkv8 S2048 D64, causal)
// the two products are ~68.7 GFLOP against ~85 MB of traffic: ~69 us at
// 989 TFLOP/s versus ~25 us at 3.35 TB/s. Design against that, simple
// first: tensor cores through mma.sync with f32 accumulators in registers,
// Q fragments loaded once into registers, K and V^T tiles staged in padded
// shared memory (row pitch +8 bf16, so fragment loads hit 8 distinct bank
// groups), causal kv tiles past the diagonal skipped, the heaviest q tiles
// scheduled first. Not yet: wgmma, TMA, cp.async double buffering, warp
// specialisation.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_fwd(q, k, v, out, lse, B, H, Hkv, Sq, Skv, D,
//                     scale_log2, causal, stream)
// q/out [B,H,Sq,D], k/v [B,Hkv,Skv,D] bf16 contiguous and 16-byte aligned,
// lse [B,H,Sq] f32. D is 64 or 128; any Sq, Skv >= 1; H % Hkv == 0.
// Returns a cudaError_t (0 = launched) or -1 for an unsupported D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;  // bf16 values per 16-byte access
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for one m16n8k16 tile, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
constexpr int smem_bytes() {
  return (kBlockM * (D + 8) + kBlockN * (D + 8) + D * (kBlockN + 8)) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int H, int Hkv, int Sq, int Skv, float scale2,
                     int causal) {
  constexpr int LD = D + 8;         // pitch of the Q and K tiles
  constexpr int LDV = kBlockN + 8;  // pitch of the transposed V tile
  constexpr int ROW_VECS = D / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * LD;
  __nv_bfloat16* sVt = sK + kBlockN * LD;

  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within an 8-row group of a fragment
  const int t = lane & 3;   // column pair within a fragment
  const size_t q_base = ((size_t)b * H + h) * Sq * D;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Skv * D;

  // Q tile, pre-scaled and rounded to bf16 once (rows past Sq are zero).
  for (int i = tid; i < kBlockM * ROW_VECS; i += kThreads) {
    const int r = i / ROW_VECS, c = (i % ROW_VECS) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < Sq)
      raw = *reinterpret_cast<const uint4*>(q + q_base + (size_t)(m0 + r) * D + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint4 o;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      oe[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale2);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = o;
  }
  __syncthreads();

  const int wr = warp * 16;  // this warp's first row in the tile
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = sQ + (wr + g) * LD + kk * 16 + 2 * t;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int row0 = m0 + wr + g;  // this thread's two q rows
  const int row1 = row0 + 8;

  const int n_end = causal ? min(Skv, m0 + kBlockM) : Skv;
  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBlockN * ROW_VECS; i += kThreads) {
      const int r = i / ROW_VECS, c = (i % ROW_VECS) * kVec;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (n0 + r < Skv) {
        const size_t off = kv_base + (size_t)(n0 + r) * D + c;
        kr = *reinterpret_cast<const uint4*>(k + off);
        vr = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kr;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sVt[(c + j) * LDV + r] = ve[j];
    }
    __syncthreads();

    // s = qs . k^T for this warp's 16 rows x 64 kv columns.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* p = sK + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma16816(s[nt], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        if (col >= Skv || (causal && col > row)) s[nt][e] = kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m_run[0], quad_max(mx0));
    const float mn1 = fmaxf(m_run[1], quad_max(mx1));
    const float alpha0 = exp2f(m_run[0] - mn0);
    const float alpha1 = exp2f(m_run[1] - mn1);
    m_run[0] = mn0;
    m_run[1] = mn1;

    // p in bf16; l sums exactly the rounded values that multiply v.
    uint32_t pk[kBlockN / 8][2];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      pk[nt][0] = pack_bf16(exp2f(s[nt][0] - mn0), exp2f(s[nt][1] - mn0));
      pk[nt][1] = pack_bf16(exp2f(s[nt][2] - mn1), exp2f(s[nt][3] - mn1));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&pk[nt][0]));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&pk[nt][1]));
      sum0 += a.x + a.y;
      sum1 += c.x + c.y;
    }
    l_run[0] = l_run[0] * alpha0 + quad_sum(sum0);
    l_run[1] = l_run[1] * alpha1 + quad_sum(sum1);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }

    // o += p16 . v: the s accumulators of two kv tiles are one A fragment.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                             pk[2 * kk + 1][1]};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* p = sVt + (dt * 8 + g) * LDV + kk * 16 + 2 * t;
        mma16816(o[dt], a, ld32(p), ld32(p + 8));
      }
    }
  }

  const float l0 = fmaxf(l_run[0], 1e-30f);
  const float l1 = fmaxf(l_run[1], 1e-30f);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(out + q_base + (size_t)row0 * D + col) =
          pack_bf16(o[dt][0] / l0, o[dt][1] / l0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(out + q_base + (size_t)row1 * D + col) =
          pack_bf16(o[dt][2] / l1, o[dt][3] / l1);
  }
  if (t == 0) {
    float* lse_row = lse + ((size_t)b * H + h) * Sq;
    if (row0 < Sq) lse_row[row0] = (m_run[0] + log2f(l0)) * kLn2;
    if (row1 < Sq) lse_row[row1] = (m_run[1] + log2f(l1)) * kLn2;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Hkv, int Sq, int Skv,
                   float scale2, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, H, Hkv, Sq, Skv, scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int Hkv,
                             int Sq, int Skv, int D, float scale2, int causal,
                             void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64: return launch<64>(q, k, v, out, l, B, H, Hkv, Sq, Skv, scale2, causal, s);
    case 128: return launch<128>(q, k, v, out, l, B, H, Hkv, Sq, Skv, scale2, causal, s);
    default: return -1;
  }
}

extern "C" int rtt_flash_fwd_smem_bytes(int D) {
  return D == 64 ? smem_bytes<64>() : D == 128 ? smem_bytes<128>() : -1;
}

extern "C" const char* rtt_flash_fwd_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
