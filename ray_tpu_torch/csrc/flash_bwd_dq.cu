// Split flash-attention backward, dq pass, for Hopper (sm_90a): dq from the
// forward's saved logsumexp, one write per q row, no atomics.
//
// Replaces the Pallas kernel _flash_bwd_dq_kernel (ray_tpu/ops/attention.py),
// which ran a grid over (batch * q head, q block) and walked the kv blocks of
// its kv head up to the causal diagonal in a fori_loop. On Hopper one CTA
// takes 128 q rows of one q head and loops over the 64-row kv tiles of kv
// head h / (H / Hkv) up to the diagonal. Its dq stays in f32 registers
// across the whole loop and is written once in bf16. Nothing is shared
// between CTAs, so dq is the same bit for bit on every run (the fused K3
// adds dq into an f32 buffer with atomics, in no fixed order).
//
// Bound: operations. Three products per kept (q, k) pair, 6 * D FLOPs: ~103
// GFLOP at the training shape (B4 H32 Hkv8 S2048 D64 causal), ~104 us at
// 989 TFLOP/s, against ~120 MB of traffic (~36 us at 3.35 TB/s). At
// ViT-B/16's shape (B128 H12 S197 D64, non-causal) bytes bound it: ~196 MB
// against ~23 GFLOP. What the design does about it:
// - 128 q rows per CTA: two consumer warpgroups of 64 rows read each
//   staged K/V tile, then one producer warp. The grid is linear over
//   (q tile, batch * head), the last q tiles (the longest under causal)
//   first, so B * H has no 65535 limit.
// - Asynchronous staging: the producer's one thread loads the CTA's q and
//   dO rows once and K and V tiles into a ring of 3 stages at D 64 (2 at D
//   128) by TMA (64 x 64 bf16 boxes, 128-byte swizzle, rows past the end
//   zero-filled), with full/empty mbarriers between it and the consumers,
//   so tile j + 1 loads while tile j computes. The tensor maps are made on
//   the host by cuTensorMapEncodeTiled (hopper.cuh).
// - qs = bf16(q * scale * log2 e) is made once per CTA, in place over the
//   staged q rows (each warpgroup its own 64), 16 bytes a thread.
// - wgmma for all three products: s = qs . K^T and dp = dO . V^T with both
//   operands in shared memory (m64n64k16, K and V read K-major), dq += ds .
//   K with ds packed from s's and dp's accumulators as the register A
//   operand and K read MN-major (m64nDk16). No tile is transposed by hand.
// - Tile classes: a kv tile past a warpgroup's diagonal is not computed
//   (the loop ends there); the mask runs only on the diagonal tile and on
//   the ragged last kv tile. The skip and the mask change no value.
// 128 rows of one q head, not 64 rows each of two q heads of one kv head:
// timed in turns on the card at the training shape, the two-head CTA ran
// slower, though both warpgroups then need the same kv tiles.
// Not yet: one warpgroup's exp2 overlapped with its next products (FA3's
// ping-pong, slower in K5's trials), a persistent grid.
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_bwd_dq_plain in ray_tpu_torch/ops/attention.py:
//   qs  = bf16(q * scale * log2 e)        (the forward's rounding)
//   s   = qs . k^T (f32), masked to -1e30; p = exp2(s - lse * log2 e)
//   dp  = dO . v^T (f32)
//   ds  = bf16(p * (dp - delta) * scale)  (delta = rowsum(dO * O), f32)
//   dq += ds . k                          (k unscaled; f32 accumulate)
// lse * log2 e is rounded as a product before the subtraction (no fused
// multiply-add). wgmma may sum a product in another order than the twin's
// matmul, so the result is held to the twin's tolerances, not its bits.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_bwd_dq(q, k, v, dout, lse, delta, dq,
//                        B, H, Hkv, Sq, Skv, D, scale, scale_log2, causal,
//                        stream)
// q/dout/dq [B,H,Sq,D], k/v [B,Hkv,Skv,D] bf16 contiguous and 16-byte
// aligned; lse/delta [B,H,Sq] f32. D is 64 or 128; any Sq, Skv >= 1; H %
// Hkv == 0. Returns a cudaError_t (0 = launched), -1 for an unsupported D,
// -2/-3 when the tensor maps cannot be made.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr int kWG = 2;                      // consumer warpgroups
constexpr int kBlockM = 64 * kWG;           // q rows per CTA
constexpr int kBlockN = 64;                 // kv rows per staged tile
constexpr int kConsumers = 128 * kWG;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kBox = 64 * 64 * 2;           // one 64 x 64 bf16 TMA box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBoxes = D / 64;            // boxes across a row
  static constexpr int kRows = kBoxes * kBox;      // 64 rows x D
  // Byte offsets from the 1024-aligned base: qs and dO rows (kWG blocks of
  // 64 rows each), the K/V stages, the barriers.
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kWG * kRows;
  static constexpr int kStage0 = kDO + kWG * kRows;
  static constexpr int kStage = 2 * kRows;          // K then V
  static constexpr int kBars = kStage0 + kStages * kStage;
  static constexpr int kSmem = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int BH, int H,
                        int Hkv, int Sq, int Skv, float scale, float scale2,
                        int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int nqt = (Sq + kBlockM - 1) / kBlockM;
  const int mt = nqt - 1 - blockIdx.x / BH;  // last (heaviest) q tiles first
  const int bh = blockIdx.x % BH;            // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int m0 = mt * kBlockM;
  // kv tiles the CTA loads: up to the diagonal of its last row.
  const int nkt = ((causal ? min(Skv, m0 + kBlockM) : Skv) + kBlockN - 1) /
                  kBlockN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, 2 * kWG * C::kRows);
#pragma unroll
      for (int rb = 0; rb < kWG; ++rb)
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          const int off = rb * C::kRows + bx * kBox;
          tma_load_3d(smem + C::kQ + off, &tm_q, qbar, bx * 64, m0 + rb * 64,
                      bh);
          tma_load_3d(smem + C::kDO + off, &tm_do, qbar, bx * 64,
                      m0 + rb * 64, bh);
        }
      const int plane = b * Hkv + hk;
      for (int j = 0; j < nkt; ++j) {
        const int s = j % C::kStages;
        mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::kStage);
        unsigned char* kt = smem + C::kStage0 + s * C::kStage;
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          tma_load_3d(kt + bx * kBox, &tm_k, &full[s], bx * 64, j * kBlockN,
                      plane);
          tma_load_3d(kt + C::kRows + bx * kBox, &tm_v, &full[s], bx * 64,
                      j * kBlockN, plane);
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg owns q rows r0 .. r0 + 63 ----
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = m0 + wg * 64;
  const bool live = r0 < Sq;  // a warpgroup past Sq only keeps the ring going
  const int row0 = r0 + warp * 16 + g;  // this thread's two q rows
  const int row1 = row0 + 8;
  const size_t row_base = (size_t)bh * Sq;
  float l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (row0 < Sq) {
    l2[0] = __fmul_rn(lse[row_base + row0], kLog2e);
    dl[0] = delta[row_base + row0];
  }
  if (row1 < Sq) {
    l2[1] = __fmul_rn(lse[row_base + row1], kLog2e);
    dl[1] = delta[row_base + row1];
  }
  // kv tiles this warpgroup computes: up to the diagonal of its own rows.
  const int nkt_wg =
      !live ? 0
            : causal ? (min(Skv, r0 + 64) + kBlockN - 1) / kBlockN : nkt;

  // qs = bf16(q * scale * log2 e) in place over this warpgroup's q rows.
  unsigned char* qrows = smem + C::kQ + wg * C::kRows;
  mbar_wait(qbar, 0);
  if (live) {
    for (int i = threadIdx.x & 127; i < C::kRows / 16; i += 128) {
      uint4 raw = reinterpret_cast<const uint4*>(qrows)[i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w[e]);
        w[e] = pack_bf16(f.x * scale2, f.y * scale2);
      }
      reinterpret_cast<uint4*>(qrows)[i] = raw;
    }
    fence_proxy_async();  // the generic writes, before wgmma reads them
  }
  named_barrier_sync(1 + wg, 128);
  const uint32_t qaddr = smem_u32(qrows);
  const uint32_t doaddr = smem_u32(smem + C::kDO + wg * C::kRows);

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  float sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    const int s = j % C::kStages;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    if (j < nkt_wg) {
      const int n0 = j * kBlockN;
      // The diagonal tile and the ragged last tile take the mask.
      const bool masked = n0 + kBlockN > Skv || (causal && n0 + 63 > r0);
      const uint32_t kaddr = smem_u32(smem + C::kStage0 + s * C::kStage);
      const uint32_t vaddr = kaddr + C::kRows;

      // s = qs . K^T and dp = dO . V^T: 64 q rows x 64 kv columns.
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_m64n64k16_ss<0>(sc, wgmma_desc(qaddr + off, 16, 1024),
                              wgmma_desc(kaddr + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_m64n64k16_ss<0>(dp, wgmma_desc(doaddr + off, 16, 1024),
                              wgmma_desc(vaddr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // ds = bf16(p * (dp - delta) * scale), packed as A fragments.
      uint32_t dsa[kBlockN / 16][4];
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * nt + e];
          if (masked) {
            const int col = n0 + nt * 8 + 2 * t + (e & 1);
            if (col >= Skv || (causal && col > (e < 2 ? row0 : row1)))
              x = kNegInf;
          }
          const float p = exp2f(x - l2[e >> 1]);
          v[e] = p * (dp[4 * nt + e] - dl[e >> 1]) * scale;
        }
        dsa[nt / 2][(nt & 1) * 2] = pack_bf16(v[0], v[1]);
        dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
      }

      // dq += ds . K, K read MN-major: kv rows 16 kk .. 16 kk + 15.
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t desc = wgmma_desc(kaddr + kk * 2048, kBox, 1024);
        if constexpr (D == 64)
          wgmma_m64n64k16_rs<1>(dqa, dsa[kk], desc, 1);
        else
          wgmma_m64n128k16_rs<1>(dqa, dsa[kk], desc, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
    }
    mbar_arrive(&empty[s]);
  }

  if (!live) return;
  const size_t q_base = row_base * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + q_base + (size_t)row0 * D + col) =
          pack_bf16(dqa[4 * dt], dqa[4 * dt + 1]);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + q_base + (size_t)row1 * D + col) =
          pack_bf16(dqa[4 * dt + 2], dqa[4 * dt + 3]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Hkv, int Sq, int Skv, float scale, float scale2, int causal,
           cudaStream_t stream) {
  constexpr int smem = Cfg<D>::kSmem;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap tq, tdo, tk, tv;
  int err = rtt_make_tile_map(&tq, q, B * H, Sq, D);
  if (err == 0) err = rtt_make_tile_map(&tdo, dout, B * H, Sq, D);
  if (err == 0) err = rtt_make_tile_map(&tk, k, B * Hkv, Skv, D);
  if (err == 0) err = rtt_make_tile_map(&tv, v, B * Hkv, Skv, D);
  if (err) return err;
  const int grid = ((Sq + kBlockM - 1) / kBlockM) * B * H;
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<__nv_bfloat16*>(dq), B * H, H,
      Hkv, Sq, Skv, scale, scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Hkv, int Sq, int Skv, int D, float scale,
                                float scale2, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      (long long)((Sq + kBlockM - 1) / kBlockM) * B * H > INT_MAX)
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
  return D == 64 ? Cfg<64>::kSmem : D == 128 ? Cfg<128>::kSmem : -1;
}

extern "C" const char* rtt_flash_bwd_dq_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  if (code == -2) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == -3) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
