// Split flash-attention backward, dq pass, for Hopper (sm_90a): dq from the
// forward's saved logsumexp, one write per q tile, no atomics.
//
// Replaces the Pallas kernel _flash_bwd_dq_kernel (ray_tpu/ops/attention.py),
// which ran a grid over (batch * q head, q block) and walked the kv blocks of
// its kv head up to the causal diagonal in a fori_loop. The shape carries
// over to Hopper as it is: one CTA of 4 warps per (batch * q head, 64-row q
// tile) reads kv head h / (H / Hkv) and loops over the 64-row kv tiles up to
// the diagonal (causal: ceil((m0 + 64) / 64) tiles, the TPU bound
// ceil((qi + 1) * bq / bk)). Each warp owns 16 q rows and keeps their dq in
// f32 registers across the whole loop, then writes it once in bf16. Nothing
// is shared between CTAs, so dq is the same bit for bit on every run (the
// fused K3 adds dq into an f32 buffer with atomics, in no fixed order).
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_bwd_dq_plain in ray_tpu_torch/ops/attention.py:
//   qs  = bf16(q * scale * log2 e)        (the forward's rounding)
//   s   = qs . k^T (f32), masked to -1e30; p = exp2(s - lse * log2 e)
//   dp  = dO . v^T (f32)
//   ds  = bf16(p * (dp - delta) * scale)  (delta = rowsum(dO * O), f32)
//   dq += ds . k                          (k unscaled; f32 accumulate)
// Unlike K3, the softmax scale is applied to ds in f32 before its rounding,
// not folded into the q/k operands.
//
// Bound: operations. Three products per kept (q, k) pair, 6 * D FLOPs: ~103
// GFLOP at the training shape (B4 H32 Hkv8 S2048 D64 causal), ~104 us at
// 989 TFLOP/s, against ~120 MB of traffic (~36 us at 3.35 TB/s). Simple
// first: mma.sync m16n8k16 (bf16 in, f32 accumulate), the q/dO tiles staged
// once per CTA and k, v and k^T once per kv tile in padded shared memory
// (row pitch +8 bf16), the ds accumulators reused in registers as the A
// operand of the dq product, the heaviest causal q tiles scheduled first.
// Not yet: wgmma, TMA, cp.async double buffering.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_bwd_dq(q, k, v, dout, lse, delta, dq,
//                        B, H, Hkv, Sq, Skv, D, scale, scale_log2, causal,
//                        stream)
// q/dout/dq [B,H,Sq,D], k/v [B,Hkv,Skv,D] bf16 contiguous and 16-byte
// aligned; lse/delta [B,H,Sq] f32. D is 64 or 128; any Sq, Skv >= 1.
// Returns a cudaError_t or -1 for an unsupported D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[nt] += A . B for the 16 rows a_row0.. of a_tile, where B[kk][n] =
// bt[n][kk]: bt holds B transposed, one row per output column (pitch ldb).
template <int NT, int KT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const __nv_bfloat16* a_tile,
                                         int lda, int a_row0,
                                         const __nv_bfloat16* bt, int ldb,
                                         int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const __nv_bfloat16* ap = a_tile + (a_row0 + g) * lda + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * lda), ld32(ap + 8),
                           ld32(ap + 8 * lda + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* p = bt + (nt * 8 + g) * ldb + kk * 16 + 2 * t;
      mma16816(c[nt], a, ld32(p), ld32(p + 8));
    }
  }
}

template <int D>
struct Smem {
  static constexpr int LD = D + 8;         // pitch of [row][D] tiles
  static constexpr int LDN = kBlockN + 8;  // pitch of the [D][kv] tile
  static constexpr int Q = 0;                    // qs rows  [M][LD]
  static constexpr int DO = Q + kBlockM * LD;    // dO rows  [M][LD]
  static constexpr int K = DO + kBlockM * LD;    // k rows   [N][LD]
  static constexpr int V = K + kBlockN * LD;     // v rows   [N][LD]
  static constexpr int KT = V + kBlockN * LD;    // k^T      [D][LDN]
  static constexpr int END = KT + D * LDN;       // in bf16 elements
  static constexpr int BYTES = END * 2 + 2 * kBlockM * 4;  // + lse2, delta
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                        int Sq, int Skv, float scale, float scale2,
                        int causal) {
  using L = Smem<D>;
  constexpr int ROW_VECS = D / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sQ = sm + L::Q;
  __nv_bfloat16* sdO = sm + L::DO;
  __nv_bfloat16* sK = sm + L::K;
  __nv_bfloat16* sV = sm + L::V;
  __nv_bfloat16* sKt = sm + L::KT;
  float* sL = reinterpret_cast<float*>(sm + L::END);
  float* sDelta = sL + kBlockM;

  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heavy tiles first
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;  // this warp's q rows in the tile
  const size_t q_base = (size_t)bh * Sq * D;
  const size_t row_base = (size_t)bh * Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Skv * D;

  // The CTA's q tile: qs = bf16(q * scale2) and dO rows (zero past Sq).
  for (int i = tid; i < kBlockM * ROW_VECS; i += kThreads) {
    const int r = i / ROW_VECS, c = (i % ROW_VECS) * kVec;
    uint4 qr = make_uint4(0u, 0u, 0u, 0u), gr = qr;
    if (m0 + r < Sq) {
      const size_t off = q_base + (size_t)(m0 + r) * D + c;
      qr = *reinterpret_cast<const uint4*>(q + off);
      gr = *reinterpret_cast<const uint4*>(dout + off);
    }
    const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qr);
    uint4 qs;
    __nv_bfloat16* qse = reinterpret_cast<__nv_bfloat16*>(&qs);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      qse[j] = __float2bfloat16_rn(__bfloat162float(qe[j]) * scale2);
    *reinterpret_cast<uint4*>(sQ + r * L::LD + c) = qs;
    *reinterpret_cast<uint4*>(sdO + r * L::LD + c) = gr;
  }
  if (tid < kBlockM) {
    const bool in = m0 + tid < Sq;
    sL[tid] = in ? lse[row_base + m0 + tid] * kLog2e : 0.f;
    sDelta[tid] = in ? delta[row_base + m0 + tid] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;
  const int row0 = m0 + wr + g;  // this thread's two q rows
  const int row1 = row0 + 8;

  const int n_end = causal ? min(Skv, m0 + kBlockM) : Skv;
  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous kv tile
    for (int i = tid; i < kBlockN * ROW_VECS; i += kThreads) {
      const int r = i / ROW_VECS, c = (i % ROW_VECS) * kVec;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (n0 + r < Skv) {
        const size_t off = kv_base + (size_t)(n0 + r) * D + c;
        kr = *reinterpret_cast<const uint4*>(k + off);
        vr = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + r * L::LD + c) = kr;
      *reinterpret_cast<uint4*>(sV + r * L::LD + c) = vr;
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kr);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sKt[(c + j) * L::LDN + r] = ke[j];
    }
    __syncthreads();

    // s = qs . k^T and dp = dO . v^T: this warp's 16 q rows x 64 kv columns.
    float st[kBlockN / 8][4], dpt[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    mma_rows<kBlockN / 8, D / 16>(st, sQ, L::LD, wr, sK, L::LD, g, t);
    mma_rows<kBlockN / 8, D / 16>(dpt, sdO, L::LD, wr, sV, L::LD, g, t);

    // ds = bf16(p * (dp - delta) * scale), packed as A fragments.
    const float l2[2] = {sL[wr + g], sL[wr + g + 8]};
    const float dl[2] = {sDelta[wr + g], sDelta[wr + g + 8]};
    uint32_t dsk[kBlockN / 8][2];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int hi = e >> 1;
        const int row = hi ? row1 : row0;
        float s = st[nt][e];
        if (col >= Skv || (causal && col > row)) s = kNegInf;
        const float p = exp2f(s - l2[hi]);
        dsv[e] = p * (dpt[nt][e] - dl[hi]) * scale;
      }
      dsk[nt][0] = pack_bf16(dsv[0], dsv[1]);
      dsk[nt][1] = pack_bf16(dsv[2], dsv[3]);
    }

    // dq += ds . k: the ds accumulators of two kv column tiles are one A
    // fragment; k^T supplies B one output column (head dim) per row.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {dsk[2 * kk][0], dsk[2 * kk][1],
                             dsk[2 * kk + 1][0], dsk[2 * kk + 1][1]};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* p = sKt + (dt * 8 + g) * L::LDN + kk * 16 + 2 * t;
        mma16816(dq_acc[dt], a, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + q_base + (size_t)row0 * D + col) =
          pack_bf16(dq_acc[dt][0], dq_acc[dt][1]);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + q_base + (size_t)row1 * D + col) =
          pack_bf16(dq_acc[dt][2], dq_acc[dt][3]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int Hkv, int Sq, int Skv,
                   float scale, float scale2, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), H, Hkv, Sq, Skv, scale, scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Hkv, int Sq, int Skv, int D, float scale,
                                float scale2, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      (long long)B * H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, l, dl, dq, B, H, Hkv, Sq, Skv, scale,
                        scale2, causal, s);
    case 128:
      return launch<128>(q, k, v, dout, l, dl, dq, B, H, Hkv, Sq, Skv, scale,
                         scale2, causal, s);
    default:
      return -1;
  }
}

extern "C" int rtt_flash_bwd_dq_smem_bytes(int D) {
  return D == 64 ? Smem<64>::BYTES : D == 128 ? Smem<128>::BYTES : -1;
}

extern "C" const char* rtt_flash_bwd_dq_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
