// Fused flash-attention backward for Hopper (sm_90a): dq, dk and dv in one
// kernel from the forward's saved logsumexp, with dk/dv folded to the kv
// heads (GQA).
//
// Replaces the Pallas kernel _flash_bwd_fused_kernel
// (ray_tpu/ops/attention.py). That kernel ran a grid over (packed q heads,
// q blocks) and carried dk/dv in VMEM scratch across the *sequential* q
// axis. Hopper runs CTAs in parallel and in no order, so nothing can carry
// over between them. The design is FlashAttention-2's instead: one CTA of
// 4 warps per (batch, kv head, 64-row kv tile). It loops over the rep q
// heads of that kv head and over the q tiles that can see the kv tile
// (causal: the diagonal tile onwards), keeps dk/dv for its tile in f32
// registers (each warp owns 16 kv rows), so the GQA fold costs nothing, and
// adds each q tile's dq contribution into a zeroed f32 buffer with float2
// atomicAdd. The caller casts that buffer. The order of dq's sums therefore
// changes from run to run (f32 rounding only; dk/dv are deterministic).
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_bwd_plain in ray_tpu_torch/ops/attention.py. s is recomputed
// exactly as the port's forward computes it:
//   qs   = bf16(q * scale * log2 e)     (the forward's rounding)
//   q_sc = bf16(q * scale)   k_sc = bf16(k * scale)   (operand scale folding)
//   s    = qs . k^T (f32), masked to -1e30; p = exp2(s - lse * log2 e)
//   dp   = dO . v^T (f32); ds = p * (dp - delta)   (delta = rowsum(dO*O))
//   dv  += bf16(p)^T . dO;  dk += bf16(ds)^T . q_sc;  dq += bf16(ds) . k_sc
// The kernel computes the transposed products (s^T = k . qs^T, dp^T =
// v . dO^T) so that a warp's accumulator rows are its kv rows; bf16(ds) is
// written to shared memory once, as [q][kv], for the dq product.
//
// Bound: operations. Five products per (q tile, kv tile) pair, ~2.5x the
// forward's FLOPs: ~172 GFLOP at the training shape, ~174 us at 989
// TFLOP/s. Simple first: mma.sync m16n8k16 (bf16 in, f32 accumulate),
// operands staged in padded shared memory (row pitch +8 bf16), the
// operands a product needs transposed (q_sc, dO, k_sc) written transposed
// when the tile is staged. Not yet: wgmma, TMA, cp.async double buffering,
// a deterministic dq pass.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_bwd(q, k, v, dout, lse, delta, dq_acc, dk, dv,
//                     B, H, Hkv, Sq, Skv, D, scale, scale_log2, causal,
//                     stream)
// q/dout [B,H,Sq,D], k/v/dk/dv [B,Hkv,Skv,D] bf16 contiguous and 16-byte
// aligned; lse/delta [B,H,Sq] f32; dq_acc [B,H,Sq,D] f32, zeroed by the
// caller. D is 64 or 128. Returns a cudaError_t or -1 for an unsupported D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per inner tile
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

// A fragment (16 x 16, row-major) of rows r0.., columns c0.. of a tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int ld, int r0, int c0, int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// c[nt] += A . B where B[kk][n] = bt[n][kk]: bt holds B transposed, one
// row per output column (pitch ld), so both halves of a B fragment are
// 32-bit loads.
template <int NT, int KT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const __nv_bfloat16* a_tile,
                                         int lda, int a_row0,
                                         const __nv_bfloat16* bt, int ldb,
                                         int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    load_a(a, a_tile, lda, a_row0, kk * 16, g, t);
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
  static constexpr int LDN = kBlockN + 8;  // pitch of [D][kv] and [q][kv]
  static constexpr int K = 0;                          // k rows   [N][LD]
  static constexpr int V = K + kBlockN * LD;           // v rows   [N][LD]
  static constexpr int KT = V + kBlockN * LD;          // k_sc^T   [D][LDN]
  static constexpr int Q = KT + D * LDN;               // qs rows  [M][LD]
  static constexpr int QT = Q + kBlockM * LD;          // q_sc^T   [D][LDM]
  static constexpr int DO = QT + D * LDM;              // dO rows  [M][LD]
  static constexpr int DOT = DO + kBlockM * LD;        // dO^T     [D][LDM]
  static constexpr int DS = DOT + D * LDM;             // bf16 ds  [M][LDN]
  static constexpr int END = DS + kBlockM * LDN;       // in bf16 elements
  static constexpr int BYTES = END * 2 + 2 * kBlockM * 4;  // + lse2, delta
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Hkv, int Sq,
                     int Skv, float scale, float scale2, int causal) {
  using L = Smem<D>;
  constexpr int ROW_VECS = D / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sm + L::K;
  __nv_bfloat16* sV = sm + L::V;
  __nv_bfloat16* sKt = sm + L::KT;
  __nv_bfloat16* sQ = sm + L::Q;
  __nv_bfloat16* sQt = sm + L::QT;
  __nv_bfloat16* sdO = sm + L::DO;
  __nv_bfloat16* sdOt = sm + L::DOT;
  __nv_bfloat16* sdS = sm + L::DS;
  float* sL = reinterpret_cast<float*>(sm + L::END);
  float* sDelta = sL + kBlockM;

  const int n0 = blockIdx.x * kBlockN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;  // this warp's kv rows (and q rows for dq)
  const size_t kv_base = ((size_t)b * Hkv + hk) * Skv * D;

  // The CTA's kv tile: raw k and v rows, and k_sc = bf16(k * scale)^T.
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
    for (int j = 0; j < kVec; ++j)
      sKt[(c + j) * L::LDN + r] =
          __float2bfloat16_rn(__bfloat162float(ke[j]) * scale);
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int kv0 = n0 + wr + g;  // this thread's two kv rows
  const int kv1 = kv0 + 8;
  const int m_start = causal ? (n0 / kBlockM) * kBlockM : 0;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const size_t q_base = ((size_t)b * H + h) * Sq * D;
    const size_t row_base = ((size_t)b * H + h) * Sq;
    for (int m0 = m_start; m0 < Sq; m0 += kBlockM) {
      __syncthreads();  // the previous q tile is consumed everywhere
      for (int i = tid; i < kBlockM * ROW_VECS; i += kThreads) {
        const int rr = i / ROW_VECS, c = (i % ROW_VECS) * kVec;
        uint4 qr = make_uint4(0u, 0u, 0u, 0u), gr = qr;
        if (m0 + rr < Sq) {
          const size_t off = q_base + (size_t)(m0 + rr) * D + c;
          qr = *reinterpret_cast<const uint4*>(q + off);
          gr = *reinterpret_cast<const uint4*>(dout + off);
        }
        const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qr);
        const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gr);
        uint4 qs;
        __nv_bfloat16* qse = reinterpret_cast<__nv_bfloat16*>(&qs);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float f = __bfloat162float(qe[j]);
          qse[j] = __float2bfloat16_rn(f * scale2);
          sQt[(c + j) * L::LDM + rr] = __float2bfloat16_rn(f * scale);
          sdOt[(c + j) * L::LDM + rr] = ge[j];
        }
        *reinterpret_cast<uint4*>(sQ + rr * L::LD + c) = qs;
        *reinterpret_cast<uint4*>(sdO + rr * L::LD + c) = gr;
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

      // p^T and ds^T in place; bf16(ds) also to shared memory as [q][kv].
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
          dsv[e] = pv[e] * (dpt[nt][e] - sDelta[ql]);
        }
        pk[nt][0] = pack_bf16(pv[0], pv[1]);
        pk[nt][1] = pack_bf16(pv[2], pv[3]);
        dsk[nt][0] = pack_bf16(dsv[0], dsv[1]);
        dsk[nt][1] = pack_bf16(dsv[2], dsv[3]);
        const __nv_bfloat16* d0 = reinterpret_cast<const __nv_bfloat16*>(&dsk[nt][0]);
        const __nv_bfloat16* d1 = reinterpret_cast<const __nv_bfloat16*>(&dsk[nt][1]);
        const int ql = nt * 8 + 2 * t;
        sdS[ql * L::LDN + wr + g] = d0[0];
        sdS[(ql + 1) * L::LDN + wr + g] = d0[1];
        sdS[ql * L::LDN + wr + g + 8] = d1[0];
        sdS[(ql + 1) * L::LDN + wr + g + 8] = d1[1];
      }

      // dv += bf16(p)^T . dO and dk += bf16(ds)^T . q_sc (k over q).
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
      __syncthreads();  // bf16(ds) of all four warps is in shared memory

      // dq[q rows wr..wr+15] += bf16(ds) . k_sc, added to the f32 buffer.
      float dq[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
      mma_rows<D / 8, kBlockN / 16>(dq, sdS, L::LDN, wr, sKt, L::LDN, g, t);
      const int q0 = m0 + wr + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + 2 * t;
        if (q0 < Sq)
          atomicAdd(reinterpret_cast<float2*>(dq_acc + (row_base + q0) * D + col),
                    make_float2(dq[dt][0], dq[dt][1]));
        if (q0 + 8 < Sq)
          atomicAdd(reinterpret_cast<float2*>(dq_acc + (row_base + q0 + 8) * D + col),
                    make_float2(dq[dt][2], dq[dt][3]));
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (kv0 < Skv) {
      const size_t off = kv_base + (size_t)kv0 * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dk_acc[dt][0], dk_acc[dt][1]);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (kv1 < Skv) {
      const size_t off = kv_base + (size_t)kv1 * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(dk_acc[dt][2], dk_acc[dt][3]);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   float* dq_acc, void* dk, void* dv, int B, int H, int Hkv,
                   int Sq, int Skv, float scale, float scale2, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((Skv + kBlockN - 1) / kBlockN, Hkv, B);
  flash_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, dq_acc,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      Hkv, Sq, Skv, scale, scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq_acc, void* dk,
                             void* dv, int B, int H, int Hkv, int Sq, int Skv,
                             int D, float scale, float scale2, int causal,
                             void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      Hkv > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, l, dl, acc, dk, dv, B, H, Hkv, Sq, Skv,
                        scale, scale2, causal, s);
    case 128:
      return launch<128>(q, k, v, dout, l, dl, acc, dk, dv, B, H, Hkv, Sq, Skv,
                         scale, scale2, causal, s);
    default:
      return -1;
  }
}

extern "C" int rtt_flash_bwd_smem_bytes(int D) {
  return D == 64 ? Smem<64>::BYTES : D == 128 ? Smem<128>::BYTES : -1;
}

extern "C" const char* rtt_flash_bwd_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
