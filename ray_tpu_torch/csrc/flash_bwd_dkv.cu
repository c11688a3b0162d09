// Split flash-attention backward, dk/dv pass, for Hopper (sm_90a): dk and dv
// per q head from the forward's saved logsumexp, no atomics.
//
// Replaces the Pallas kernel _flash_bwd_dkv_kernel
// (ray_tpu/ops/attention.py), which ran a grid over (batch * q head, kv
// block) and walked the q blocks that can see its kv block in a fori_loop
// (causal: from the block holding the kv tile's first row). The shape
// carries over to Hopper as it is, and it is FlashAttention-2's dk/dv loop
// without dq: one CTA of 4 warps per (batch * q head, 64-row kv tile) of kv
// head h / (H / Hkv); each warp owns 16 kv rows and keeps their dk and dv in
// f32 registers across the q loop, then stores them once in bf16, per q
// head ([B, H, Skv, D]). The caller folds the rep q heads of a kv head in
// f32 and rounds once more (ray_tpu/ops/attention.py's wrapper contract),
// so dk/dv round twice, as on the TPU. Nothing is shared between CTAs: the
// result is the same bit for bit on every run.
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_bwd_dkv_plain in ray_tpu_torch/ops/attention.py:
//   qs  = bf16(q * scale * log2 e)        (the forward's rounding)
//   s   = qs . k^T (f32), masked to -1e30; p = exp2(s - lse * log2 e)
//   dv += bf16(p)^T . dO
//   dp  = dO . v^T (f32); ds = bf16(p * (dp - delta) * scale)
//   dk += ds^T . q                        (q unscaled; f32 accumulate)
// The kernel computes the transposed products (s^T = k . qs^T, dp^T =
// v . dO^T) so that a warp's accumulator rows are its kv rows, and those
// accumulators are the A operands of the dv and dk products as they are.
//
// Bound: operations. Four products per kept (q, k) pair, 8 * D FLOPs: ~137
// GFLOP at the training shape (B4 H32 Hkv8 S2048 D64 causal), ~139 us at
// 989 TFLOP/s, against ~153 MB of traffic (~46 us at 3.35 TB/s). Simple
// first: mma.sync m16n8k16 (bf16 in, f32 accumulate), the k/v tile staged
// once per CTA and each q tile once per loop step in padded shared memory
// (row pitch +8 bf16), q and dO also written transposed when staged, as the
// B operands of the dk and dv products. Not yet: wgmma, TMA, cp.async
// double buffering, the GQA fold inside the kernel.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv,
//                         B, H, Hkv, Sq, Skv, D, scale, scale_log2, causal,
//                         stream)
// q/dout [B,H,Sq,D], k/v [B,Hkv,Skv,D], dk/dv [B,H,Skv,D] (per q head) bf16
// contiguous and 16-byte aligned; lse/delta [B,H,Sq] f32. D is 64 or 128;
// any Sq, Skv >= 1. Returns a cudaError_t or -1 for an unsupported D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per loop step
constexpr int kBlockN = 64;  // kv rows per CTA, 16 per warp
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
  static constexpr int LDM = kBlockM + 8;  // pitch of [D][q] tiles
  static constexpr int K = 0;                    // k rows   [N][LD]
  static constexpr int V = K + kBlockN * LD;     // v rows   [N][LD]
  static constexpr int Q = V + kBlockN * LD;     // qs rows  [M][LD]
  static constexpr int QT = Q + kBlockM * LD;    // q^T      [D][LDM]
  static constexpr int DO = QT + D * LDM;        // dO rows  [M][LD]
  static constexpr int DOT = DO + kBlockM * LD;  // dO^T     [D][LDM]
  static constexpr int END = DOT + D * LDM;      // in bf16 elements
  static constexpr int BYTES = END * 2 + 2 * kBlockM * 4;  // + lse2, delta
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                         int Sq, int Skv, float scale, float scale2,
                         int causal) {
  using L = Smem<D>;
  constexpr int ROW_VECS = D / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sm + L::K;
  __nv_bfloat16* sV = sm + L::V;
  __nv_bfloat16* sQ = sm + L::Q;
  __nv_bfloat16* sQt = sm + L::QT;
  __nv_bfloat16* sdO = sm + L::DO;
  __nv_bfloat16* sdOt = sm + L::DOT;
  float* sL = reinterpret_cast<float*>(sm + L::END);
  float* sDelta = sL + kBlockM;

  const int n0 = blockIdx.x * kBlockN;  // causal: the heaviest tiles first
  const int bh = blockIdx.y;            // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;  // this warp's kv rows in the tile
  const size_t q_base = (size_t)bh * Sq * D;
  const size_t row_base = (size_t)bh * Sq;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Skv * D;
  const size_t out_base = (size_t)bh * Skv * D;  // dk/dv per q head

  // The CTA's kv tile: k and v rows (zero past Skv).
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
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int kv0 = n0 + wr + g;  // this thread's two kv rows
  const int kv1 = kv0 + 8;
  // Causal: q tiles before the one holding row n0 see none of this tile.
  const int m_start = causal ? (n0 / kBlockM) * kBlockM : 0;

  for (int m0 = m_start; m0 < Sq; m0 += kBlockM) {
    __syncthreads();  // the previous q tile is consumed everywhere
    for (int i = tid; i < kBlockM * ROW_VECS; i += kThreads) {
      const int r = i / ROW_VECS, c = (i % ROW_VECS) * kVec;
      uint4 qr = make_uint4(0u, 0u, 0u, 0u), gr = qr;
      if (m0 + r < Sq) {
        const size_t off = q_base + (size_t)(m0 + r) * D + c;
        qr = *reinterpret_cast<const uint4*>(q + off);
        gr = *reinterpret_cast<const uint4*>(dout + off);
      }
      const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qr);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gr);
      uint4 qs;
      __nv_bfloat16* qse = reinterpret_cast<__nv_bfloat16*>(&qs);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        qse[j] = __float2bfloat16_rn(__bfloat162float(qe[j]) * scale2);
        sQt[(c + j) * L::LDM + r] = qe[j];
        sdOt[(c + j) * L::LDM + r] = ge[j];
      }
      *reinterpret_cast<uint4*>(sQ + r * L::LD + c) = qs;
      *reinterpret_cast<uint4*>(sdO + r * L::LD + c) = gr;
    }
    if (tid < kBlockM) {
      const bool in = m0 + tid < Sq;
      sL[tid] = in ? lse[row_base + m0 + tid] * kLog2e : 0.f;
      sDelta[tid] = in ? delta[row_base + m0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T = k . qs^T and dp^T = v . dO^T: 16 kv rows x 64 q columns.
    float st[kBlockM / 8][4], dpt[kBlockM / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    mma_rows<kBlockM / 8, D / 16>(st, sK, L::LD, wr, sQ, L::LD, g, t);
    mma_rows<kBlockM / 8, D / 16>(dpt, sV, L::LD, wr, sdO, L::LD, g, t);

    // p^T and ds^T = bf16(p * (dp - delta) * scale), packed as A fragments.
    uint32_t pk[kBlockM / 8][2], dsk[kBlockM / 8][2];
#pragma unroll
    for (int nt = 0; nt < kBlockM / 8; ++nt) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        const int qpos = m0 + ql;
        const int kvpos = e < 2 ? kv0 : kv1;
        float s = st[nt][e];
        if (qpos >= Sq || kvpos >= Skv || (causal && kvpos > qpos))
          s = kNegInf;
        pv[e] = exp2f(s - sL[ql]);
        dsv[e] = pv[e] * (dpt[nt][e] - sDelta[ql]) * scale;
      }
      pk[nt][0] = pack_bf16(pv[0], pv[1]);
      pk[nt][1] = pack_bf16(pv[2], pv[3]);
      dsk[nt][0] = pack_bf16(dsv[0], dsv[1]);
      dsk[nt][1] = pack_bf16(dsv[2], dsv[3]);
    }

    // dv += bf16(p)^T . dO and dk += ds^T . q, contracted over the q tile.
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      const uint32_t ap[4] = {pk[2 * kk][0], pk[2 * kk][1],
                              pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
      const uint32_t as[4] = {dsk[2 * kk][0], dsk[2 * kk][1],
                              dsk[2 * kk + 1][0], dsk[2 * kk + 1][1]};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int off = (dt * 8 + g) * L::LDM + kk * 16 + 2 * t;
        mma16816(dv_acc[dt], ap, ld32(sdOt + off), ld32(sdOt + off + 8));
        mma16816(dk_acc[dt], as, ld32(sQt + off), ld32(sQt + off + 8));
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (kv0 < Skv) {
      const size_t off = out_base + (size_t)kv0 * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dk_acc[dt][0], dk_acc[dt][1]);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (kv1 < Skv) {
      const size_t off = out_base + (size_t)kv1 * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dk_acc[dt][2], dk_acc[dt][3]);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Hkv, int Sq, int Skv,
                   float scale, float scale2, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((Skv + kBlockN - 1) / kBlockN, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      Hkv, Sq, Skv, scale, scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int Hkv, int Sq, int Skv, int D,
                                 float scale, float scale2, int causal,
                                 void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      (long long)B * H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, l, dl, dk, dv, B, H, Hkv, Sq, Skv,
                        scale, scale2, causal, s);
    case 128:
      return launch<128>(q, k, v, dout, l, dl, dk, dv, B, H, Hkv, Sq, Skv,
                         scale, scale2, causal, s);
    default:
      return -1;
  }
}

extern "C" int rtt_flash_bwd_dkv_smem_bytes(int D) {
  return D == 64 ? Smem<64>::BYTES : D == 128 ? Smem<128>::BYTES : -1;
}

extern "C" const char* rtt_flash_bwd_dkv_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
