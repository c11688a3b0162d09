// Flash-attention forward for Hopper (sm_90a): out = softmax(q k^T * scale) v
// with the row logsumexp, GQA-native (k/v keep their Hkv heads).
//
// Replaces the Pallas kernel _flash_fwd_kernel (ray_tpu/ops/attention.py),
// which walked kv blocks of one packed q tile held in VMEM, in grid order.
// Here one CTA owns 128 q rows of one (batch, q head) and reads kv
// head h / (H / Hkv) tile by tile; K/V tiles are re-read by the rep q heads
// of a kv head and come from L2.
//
// Bound: operations. At the training shape (B4 H32 Hkv8 S2048 D64, causal)
// the two products are ~68.7 GFLOP against ~85 MB of traffic: ~69 us at
// 989 TFLOP/s versus ~25 us at 3.35 TB/s. At ViT-B/16's attention (B128
// H12 S197 D64, non-causal) ~15.3 GFLOP against ~78 MB: bytes, ~23 us.
// What the design does about it (the ring's K6, flash_chunk_fwd.cu, with
// the positions known at compile time, so the tile classes need no
// pre-pass):
// - Two 64-row consumer warpgroups plus one producer warp a CTA, 128 q
//   rows (kWG below: three warpgroups, 192 rows, timed slower); each
//   staged K/V tile serves every row of the CTA. The grid is
//   linear over (q tile, batch * head), the last q tiles (the longest
//   under causal) first, so B * H has no 65535 limit.
// - Asynchronous staging: the producer's one thread loads the CTA's q rows
//   once and K and V tiles into a ring of 3 stages at D 64 (2 at D 128) by
//   TMA (64 x 64 bf16 boxes, 128-byte swizzle, rows past the end
//   zero-filled), full/empty mbarriers between it and the consumers, so
//   tile j + 1 loads while tile j computes.
// - qs = bf16(q * scale * log2 e) made once per CTA, in place over the
//   staged q rows (each warpgroup its own 64), 16 bytes a thread.
// - wgmma for both products: s = qs . K^T with both operands in shared
//   memory (m64n64k16, K read K-major), o += p . V with bf16 p straight
//   from s's accumulators as the register A operand and V read MN-major
//   (m64nDk16). Nothing is transposed by hand.
// - Tile classes, static: under causal a kv tile past a warpgroup's
//   diagonal is not computed (its loop ends there; the CTA loads up to its
//   last row's diagonal); the mask runs only on the diagonal tile and on
//   the ragged last kv tile.
// Not yet: one tile's softmax overlapped with the next tile's s product
// inside a warpgroup (FA3's ping-pong; slower in K5's trials, spilled in
// K6's), a persistent grid, setmaxnreg.
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_fwd_plain in ray_tpu_torch/ops/attention.py:
//   qs  = bf16(q * scale * log2(e))                 (once per q tile)
//   s   = qs . k^T in f32
//   masked logits (causal kpos > qpos, or past the ragged kv tail) = -1e30
//   online softmax in base 2 over 64-wide kv tiles, in ascending order:
//     m' = max(m, rowmax s); p = exp2(s - m'); alpha = exp2(m - m')
//     p16 = bf16(p); l = l*alpha + rowsum(p16); o = o*alpha + p16 . v
//   out = bf16(o / max(l, 1e-30)); lse = (m + log2 l) * ln 2   (natural log)
// l sums the same bf16 p that multiplies v, so o/l and lse agree (the
// TPU kernel's ones-column trick computes the same sum on the MXU). wgmma
// may sum a product in another order than the twin's matmul, so the result
// is held to the twin's tolerances, not its bits.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_fwd(q, k, v, out, lse, B, H, Hkv, Sq, Skv, D,
//                     scale_log2, causal, stream)
// q/out [B,H,Sq,D], k/v [B,Hkv,Skv,D] bf16 contiguous and 16-byte aligned,
// lse [B,H,Sq] f32. D is 64 or 128; any Sq, Skv >= 1; H % Hkv == 0.
// Returns a cudaError_t (0 = launched), -1 for an unsupported D,
// -2/-3 when the tensor maps cannot be made.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr int kBlockN = 64;        // kv rows per staged tile
constexpr int kBox = 64 * 64 * 2;  // one 64 x 64 bf16 TMA box
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D, int WG>
struct Cfg {
  static constexpr int kBlockM = 64 * WG;        // q rows per CTA
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBoxes = D / 64;           // boxes across a row
  static constexpr int kRows = kBoxes * kBox;     // 64 rows x D
  // Byte offsets from the 1024-aligned base: q rows (WG blocks of 64), the
  // K/V stages, the barriers (full, empty, q).
  static constexpr int kStage0 = WG * kRows;
  static constexpr int kStage = 2 * kRows;        // K then V
  static constexpr int kBars = kStage0 + kStages * kStage;
  static constexpr int kSmem = kBars + (2 * kStages + 1) * 8 + 1024;
};

// Consumer warpgroups a CTA, 64 q rows each: two (128 rows) at every Sq
// and D. Three (192 rows, D 64) need 13 warps, which caps a thread at 128
// registers and keeps one CTA an SM; at 128 rows two CTAs share an SM and
// each hides the other's softmax. 192 timed slower at every shape tried
// (devbench/pair_flash.py builds it as an ablation; NVIDIA H100 80GB
// HBM3, 700 W; PERF.md), most at ViT's S 197, whose second 192-row tile
// holds 5 rows.
constexpr int kWG = 2;

template <int D, int WG>
__global__ void __launch_bounds__(Cfg<D, WG>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int BH, int H, int Hkv, int Sq, int Skv, float scale2,
                     int causal) {
  using C = Cfg<D, WG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int nqt = (Sq + C::kBlockM - 1) / C::kBlockM;
  const int mt = nqt - 1 - blockIdx.x / BH;  // last (heaviest) q tiles first
  const int bh = blockIdx.x % BH;            // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int m0 = mt * C::kBlockM;
  // kv tiles the CTA loads: up to the diagonal of its last row.
  const int nkt =
      ((causal ? min(Skv, m0 + C::kBlockM) : Skv) + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::kConsumers) {  // the producer warp
    if (threadIdx.x == C::kConsumers) {
      mbar_expect_tx(qbar, WG * C::kRows);
#pragma unroll
      for (int rb = 0; rb < WG; ++rb)
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx)
          tma_load_3d(smem + rb * C::kRows + bx * kBox, &tm_q, qbar, bx * 64,
                      m0 + rb * 64, bh);
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
  // kv tiles this warpgroup computes: up to the diagonal of its own rows.
  const int nkt_wg =
      !live ? 0
            : causal ? (min(Skv, r0 + 64) + kBlockN - 1) / kBlockN : nkt;

  // qs = bf16(q * scale * log2 e) in place over this warpgroup's q rows.
  unsigned char* qrows = smem + wg * C::kRows;
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

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < nkt; ++j) {
    const int s = j % C::kStages;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    if (j < nkt_wg) {
      const int n0 = j * kBlockN;
      // The diagonal tile and the ragged last tile take the mask.
      const bool masked = n0 + kBlockN > Skv || (causal && n0 + 63 > r0);
      const uint32_t kaddr = smem_u32(smem + C::kStage0 + s * C::kStage);
      const uint32_t vaddr = kaddr + C::kRows;

      // s = qs . K^T: 64 q rows x 64 kv columns.
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_m64n64k16_ss<0>(sc, wgmma_desc(qaddr + off, 16, 1024),
                              wgmma_desc(kaddr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        if (masked) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + nt * 8 + 2 * t + (e & 1);
            if (col >= Skv || (causal && col > (e < 2 ? row0 : row1)))
              sc[4 * nt + e] = kNegInf;
          }
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
      }
      const float mn0 = fmaxf(m_run[0], quad_max(mx0));
      const float mn1 = fmaxf(m_run[1], quad_max(mx1));
      const float alpha0 = exp2f(m_run[0] - mn0);
      const float alpha1 = exp2f(m_run[1] - mn1);
      m_run[0] = mn0;
      m_run[1] = mn1;

      // p in bf16; l sums exactly the rounded values that multiply v.
      uint32_t pa[kBlockN / 16][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const uint32_t lo = pack_bf16(exp2f(sc[4 * nt] - mn0),
                                      exp2f(sc[4 * nt + 1] - mn0));
        const uint32_t hi = pack_bf16(exp2f(sc[4 * nt + 2] - mn1),
                                      exp2f(sc[4 * nt + 3] - mn1));
        const float2 a = unpack_bf16(lo), c = unpack_bf16(hi);
        sum0 += a.x + a.y;
        sum1 += c.x + c.y;
        pa[nt / 2][(nt & 1) * 2] = lo;
        pa[nt / 2][(nt & 1) * 2 + 1] = hi;
      }
      l_run[0] = l_run[0] * alpha0 + quad_sum(sum0);
      l_run[1] = l_run[1] * alpha1 + quad_sum(sum1);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[4 * dt] *= alpha0;
        o[4 * dt + 1] *= alpha0;
        o[4 * dt + 2] *= alpha1;
        o[4 * dt + 3] *= alpha1;
      }

      // o += p16 . V, V read MN-major: kv rows 16 kk .. 16 kk + 15.
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t desc = wgmma_desc(vaddr + kk * 2048, kBox, 1024);
        if constexpr (D == 64)
          wgmma_m64n64k16_rs<1>(o, pa[kk], desc, 1);
        else
          wgmma_m64n128k16_rs<1>(o, pa[kk], desc, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    mbar_arrive(&empty[s]);
  }

  if (!live) return;
  const float l0 = fmaxf(l_run[0], 1e-30f);
  const float l1 = fmaxf(l_run[1], 1e-30f);
  const size_t q_base = (size_t)bh * Sq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(out + q_base + (size_t)row0 * D + col) =
          pack_bf16(o[4 * dt] / l0, o[4 * dt + 1] / l0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(out + q_base + (size_t)row1 * D + col) =
          pack_bf16(o[4 * dt + 2] / l1, o[4 * dt + 3] / l1);
  }
  if (t == 0) {
    float* lse_row = lse + (size_t)bh * Sq;
    if (row0 < Sq) lse_row[row0] = (m_run[0] + log2f(l0)) * kLn2;
    if (row1 < Sq) lse_row[row1] = (m_run[1] + log2f(l1)) * kLn2;
  }
}

template <int D, int WG>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int Hkv, int Sq, int Skv, float scale2,
           int causal, cudaStream_t stream) {
  using C = Cfg<D, WG>;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = rtt_make_tile_map(&tq, q, B * H, Sq, D);
  if (err == 0) err = rtt_make_tile_map(&tk, k, B * Hkv, Skv, D);
  if (err == 0) err = rtt_make_tile_map(&tv, v, B * Hkv, Skv, D);
  if (err) return err;
  const int grid = ((Sq + C::kBlockM - 1) / C::kBlockM) * B * H;
  flash_fwd_kernel<D, WG><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, B * H, H, Hkv, Sq,
      Skv, scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int Hkv,
                             int Sq, int Skv, int D, float scale2, int causal,
                             void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      (long long)((Sq + 64 * kWG - 1) / (64 * kWG)) * B * H > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return launch<64, kWG>(q, k, v, out, l, B, H, Hkv, Sq, Skv, scale2,
                           causal, s);
  if (D == 128)
    return launch<128, kWG>(q, k, v, out, l, B, H, Hkv, Sq, Skv, scale2,
                            causal, s);
  return -1;
}

extern "C" int rtt_flash_fwd_smem_bytes(int D) {
  return D == 64 ? Cfg<64, kWG>::kSmem : D == 128 ? Cfg<128, kWG>::kSmem : -1;
}

extern "C" const char* rtt_flash_fwd_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  if (code == -2) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == -3) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
