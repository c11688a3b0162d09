// Flash-attention forward of local q against one visiting K/V chunk, for
// Hopper (sm_90a): out = softmax(q k^T * scale) v in f32 and the row
// logsumexp, masked by GLOBAL positions loaded at run time, GQA-native.
//
// Replaces the Pallas kernel _flash_chunk_fwd_kernel
// (ray_tpu/ops/attention.py:735), the inner step of ring attention: each
// ring step attends the local q block to a chunk whose global offset is a
// runtime value, so causality comes from position vectors, not from tile
// indices. The Pallas grid cannot skip on runtime positions and makes a
// full pass; a CTA here reads its own tile bounds and skips.
//
// Bound: operations, over the (q, k) pairs the mask keeps: at the CP
// step's shape (B1 H32 Hkv8 S16384 D64, positions 0..S-1, causal) 1100
// GFLOP, 1.11 ms at 989 TFLOP/s, against 0.2 ms of traffic. What the
// design does about it:
// - Tile classes. A pre-pass (chunk_tile_bounds.cu) gives the min and max
//   position of every 64-block of qpos and kpos and the chunk's min kpos
//   (cmin). Under `causal` a (q rows, kv tile) pair is masked when kmin >
//   qmax, visible when kmax <= qmin, partial otherwise. A masked pair is
//   skipped unless the rows hold one that sees no key of the chunk (qmin <
//   cmin): such rows visit every tile as before and keep out = mean of v,
//   lse ~ -6.9e29. The skip is exact for every other row: a masked tile
//   after a visible one adds exp2(-1e30 - m) = 0 with alpha 1, one before
//   it is wiped by alpha = exp2(-1e30 - m') = 0. Only visible tiles go
//   unmasked. The CTA loads a kv tile that any of its warpgroups needs;
//   each warpgroup skips the compute of a tile that is masked for its own
//   64 rows. Grid order puts the last q tiles (the longest under causal
//   positions) first.
// - 192 q rows of one head per staged K/V tile at D 64 (128 at D 128):
//   three (two) consumer warpgroups of 64 rows, then one producer warp.
// - Asynchronous staging: the producer's one thread issues TMA loads
//   (cp.async.bulk.tensor, 64 x 64 bf16 boxes, 128-byte swizzle, rows past
//   Skv zero-filled) of K and V into a ring of 3 stages at D 64 (2 at D
//   128), full/empty mbarriers between it and the consumers, so tile j + 1
//   loads while tile j computes. The tensor maps are encoded on the host
//   with cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no
//   libcuda link) and passed as __grid_constant__ parameters.
// - wgmma for both products: s = qs . K^T (m64n64k16, A = qs fragments in
//   registers, B = K K-major from shared memory) and o += p . V (m64nDk16,
//   A = bf16 p straight from s's accumulators, B = V read MN-major through
//   its descriptor). Nothing is transposed by hand.
// Not yet: overlapping one tile's softmax with the next tile's s product
// inside a warpgroup (FA3's ping-pong), a persistent grid, register
// rebalancing with setmaxnreg, block_k 128.
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_chunk_fwd_plain in ray_tpu_torch/ops/attention.py:
//   qs  = bf16(q * scale * log2(e))                 (once per CTA)
//   s   = qs . k^T in f32; causal: -1e30 where kpos[j] > qpos[i] (never
//         -inf), on partial tiles; columns past Skv -inf
//   online softmax in base 2 over 64-wide kv tiles, in ascending order:
//     m' = max(m, rowmax s); p = exp2(s - m'); alpha = exp2(m - m')
//     p16 = bf16(p); l = l*alpha + rowsum(p16); o = o*alpha + p16 . v
//   out = o / max(l, 1e-30) in f32; lse = (m + log2 l) * ln 2
// wgmma may sum a product in another order than the twin's matmul, so the
// result is held to the twin's tolerances (chip_smoke.py, the cuda tests),
// not to its bits.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_chunk_fwd(q, k, v, qpos, kpos, bounds, out, lse,
//                           B, H, Hkv, Sq, Skv, D, scale_log2, causal, stream)
// q [B,H,Sq,D], k/v [B,Hkv,Skv,D] bf16 contiguous and 16-byte aligned;
// qpos [Sq], kpos [Skv] int32; bounds the pre-pass's int32 output; out
// [B,H,Sq,D] and lse [B,H,Sq] f32. D is 64 or 128; any Sq, Skv >= 1; H %
// Hkv == 0. Returns a cudaError_t (0 = launched), -1 for an unsupported D,
// -2/-3 when the tensor maps cannot be made.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kBox = 64 * 64 * 2;          // one 64 x 64 bf16 TMA box
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  // Consumer warpgroups of 64 q rows: three at D 64, two at D 128 (the
  // register file holds no more at one CTA an SM).
  static constexpr int kWG = D == 64 ? 3 : 2;
  static constexpr int kBlockM = 64 * kWG;  // q rows per CTA
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBoxes = D / 64;  // 64-column boxes per tile
  static constexpr int kTile = kBoxes * kBox;
  static constexpr int kStage = 2 * kTile;  // K then V
  // Stages, the full and empty barriers, and slack to align to 1024.
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_chunk_fwd_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __nv_bfloat16* __restrict__ q,
                           const int* __restrict__ qpos,
                           const int* __restrict__ kpos,
                           const int* __restrict__ bounds,
                           float* __restrict__ out, float* __restrict__ lse,
                           int H, int Hkv, int Sq, int Skv, float scale2,
                           int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStage);
  uint64_t* empty = full + C::kStages;

  // Grid (B, H, q tiles): the batch on x, which has no 65535 limit.
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int mt = gridDim.z - 1 - blockIdx.z;  // last q tiles first
  const int m0 = mt * C::kBlockM;
  const int hk = h / (H / Hkv);
  const int nq64 = (Sq + 63) / 64;
  const int nkt = (Skv + kBlockN - 1) / kBlockN;
  const int2* qb = reinterpret_cast<const int2*>(bounds);
  const int2* kb = qb + nq64;
  const int cmin = bounds[2 * (nq64 + nkt)];

  // The CTA's rows are the 64-blocks kWG mt .. kWG mt + kWG - 1 that exist.
  int2 cq = qb[C::kWG * mt];
#pragma unroll
  for (int w = 1; w < C::kWG; ++w) {
    if (C::kWG * mt + w < nq64) {
      const int2 x = qb[C::kWG * mt + w];
      cq = make_int2(min(cq.x, x.x), max(cq.y, x.y));
    }
  }
  // A kv tile is loaded unless it is masked for every row of the CTA.
  const bool load_all = !causal || cq.x < cmin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::kConsumers) {  // the producer warp
    if (threadIdx.x == C::kConsumers) {
      const int plane = b * Hkv + hk;
      int it = 0;
      for (int j = 0; j < nkt; ++j) {
        if (!load_all && kb[j].x > cq.y) continue;
        const int s = it % C::kStages;
        const uint32_t ph = (it / C::kStages) & 1;
        ++it;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], C::kStage);
        unsigned char* kt = smem + s * C::kStage;
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx) {
          tma_load_3d(kt + bx * kBox, &tm_k, &full[s], bx * 64, j * kBlockN,
                      plane);
          tma_load_3d(kt + C::kTile + bx * kBox, &tm_v, &full[s], bx * 64,
                      j * kBlockN, plane);
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg owns rows r0 .. r0 + 63 ----
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = m0 + wg * 64;
  const bool live = r0 < Sq;  // a warpgroup past Sq only keeps the ring going
  const int2 wq = live ? qb[r0 / 64] : make_int2(0, 0);
  const bool nokey = causal && live && wq.x < cmin;
  const int row0 = r0 + warp * 16 + g;  // this thread's two q rows
  const int row1 = row0 + 8;
  const int qp0 = row0 < Sq ? qpos[row0] : 0;  // rows past Sq are not stored
  const int qp1 = row1 < Sq ? qpos[row1] : 0;
  const size_t q_base = ((size_t)b * H + h) * Sq * D;

  // qs = bf16(q * scale * log2 e) as wgmma A fragments, once.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? row1 : row0;
      const int col = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      uint32_t raw = 0u;
      if (row < Sq)
        raw = *reinterpret_cast<const uint32_t*>(q + q_base + (size_t)row * D +
                                                 col);
      const float2 f = unpack_bf16(raw);
      qf[kk][i] = pack_bf16(f.x * scale2, f.y * scale2);
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  int it = 0;
  for (int j = 0; j < nkt; ++j) {
    const int2 kj = kb[j];
    if (!load_all && kj.x > cq.y) continue;  // the producer skipped it too
    const int s = it % C::kStages;
    const uint32_t ph = (it / C::kStages) & 1;
    ++it;
    const int n0 = j * kBlockN;
    const bool ragged = n0 + kBlockN > Skv;
    // 0: skip (masked for these rows), 1: visible, 2: partial (mask).
    int cls;
    if (!live)
      cls = 0;
    else if (!causal)
      cls = ragged ? 2 : 1;
    else if (kj.x > wq.y && !nokey)
      cls = 0;
    else if (kj.y <= wq.x && !ragged)
      cls = 1;
    else
      cls = 2;
    mbar_wait(&full[s], ph);
    if (cls != 0) {
      const uint32_t kaddr = smem_u32(smem + s * C::kStage);
      const uint32_t vaddr = kaddr + C::kTile;

      // s = qs . K^T: 64 rows x 64 kv columns a warpgroup.
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_rs<0>(
            sc, qf[kk],
            wgmma_desc(kaddr + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        if (cls == 2) {
          const int c0 = n0 + nt * 8 + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + (e & 1);
            if (c >= Skv)
              sc[4 * nt + e] = -INFINITY;  // past the chunk: p is exactly 0
            else if (causal && kpos[c] > (e < 2 ? qp0 : qp1))
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
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(out + q_base + (size_t)row0 * D + col) =
          make_float2(o[4 * dt] / l0, o[4 * dt + 1] / l0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(out + q_base + (size_t)row1 * D + col) =
          make_float2(o[4 * dt + 2] / l1, o[4 * dt + 3] / l1);
  }
  if (t == 0) {
    float* lse_row = lse + ((size_t)b * H + h) * Sq;
    if (row0 < Sq) lse_row[row0] = (m_run[0] + log2f(l0)) * kLn2;
    if (row1 < Sq) lse_row[row1] = (m_run[1] + log2f(l1)) * kLn2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, const int* bounds, float* out, float* lse, int B,
           int H, int Hkv, int Sq, int Skv, float scale2, int causal,
           cudaStream_t stream) {
  constexpr int smem = Cfg<D>::kSmem;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_chunk_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap tk, tv;
  int err = rtt_make_tile_map(&tk, k, B * Hkv, Skv, D);
  if (err == 0) err = rtt_make_tile_map(&tv, v, B * Hkv, Skv, D);
  if (err) return err;
  const dim3 grid(B, H, (Sq + Cfg<D>::kBlockM - 1) / Cfg<D>::kBlockM);
  flash_chunk_fwd_kernel<D><<<grid, Cfg<D>::kThreads, smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), qpos, kpos, bounds, out,
      lse, H, Hkv, Sq, Skv, scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_chunk_fwd(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kpos,
                                   const void* bounds, void* out, void* lse,
                                   int B, int H, int Hkv, int Sq, int Skv,
                                   int D, float scale2, int causal,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      H > 65535 || (Sq + 127) / 128 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  const int* bd = static_cast<const int*>(bounds);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, qp, kp, bd, o, l, B, H, Hkv, Sq, Skv, scale2,
                        causal, s);
    case 128:
      return launch<128>(q, k, v, qp, kp, bd, o, l, B, H, Hkv, Sq, Skv,
                         scale2, causal, s);
    default:
      return -1;
  }
}

extern "C" int rtt_flash_chunk_fwd_smem_bytes(int D) {
  return D == 64 ? Cfg<64>::kSmem : D == 128 ? Cfg<128>::kSmem : -1;
}

extern "C" const char* rtt_flash_chunk_fwd_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  if (code == -2) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == -3) return "cuTensorMapEncodeTiled refused the K/V tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
