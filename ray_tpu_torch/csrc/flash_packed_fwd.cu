// Head-packed flash-attention forward for Hopper (sm_90a): the three mask
// schedules of the TPU head-packing experiments, as one kernel template.
//
// Replaces the Pallas kernels of devbench/prof_flash_pack.py:
//   _packed_fwd_kernel     (K10, rtt_packed_fwd): every kv tile up to the
//                          causal bound masked by global positions;
//   _packed_fwd_epi_kernel (K8, rtt_packed_fwd_epi): a mask-free loop over
//                          the fully visible kv tiles, then a masked loop
//                          over the partial-diagonal ones;
//   _packed_fwd_inl_kernel (K9, rtt_packed_fwd_inl): block_q == block_k; a
//                          mask-free loop over the tiles left of the
//                          diagonal, then the diagonal tile alone under a
//                          local triangular mask.
// On the TPU a grid row held `pack` q heads of one kv head as one
// [pack*block_q, D] tile, so every product and vector op grew pack-fold.
// Here one CTA owns one q tile (block_q rows) of `pack` q heads that share
// a kv head: pack * block_q / 64 consumer warpgroups (1, 2 or 4), warpgroup
// w on head w / (block_q / 64) of the pack, rows m0 + 64 (w % (block_q /
// 64)). Each K/V tile is staged once and read by every warpgroup of the
// CTA, where K2 (flash_fwd.cu, whose machinery this is) stages it once per
// q head and the rep heads of a kv head re-read it from L2.
//
// Bound: operations. At B4 H32 Hkv8 S2048 D64 causal the two products are
// 68.7 GFLOP, ~69 us at 989 TFLOP/s, against ~25 us for the ~84 MB that
// must move. What the design does about it:
// - Asynchronous staging: thread 0 loads each warpgroup's 64 q rows once
//   and K and V tiles of block_k rows (block_k / 64 boxes of 64 x 64 bf16 a
//   row block, 128-byte swizzle) into a ring of 3 stages at D 64 (2 at D
//   128) by TMA, with full/empty mbarriers between it and the consumers, so
//   tile j + 1 loads while tile j computes. There is no producer warp: a
//   CTA of four warpgroups plus one warp would put five warps on one
//   scheduler and cap a thread at 96 registers (a quarter of the register
//   file over the fullest scheduler's warps); with 16 warps the cap is 128,
//   with 8 it is 255. Thread 0 refills a stage as soon as every consumer
//   has released it, so its warpgroup waits on the slowest one; the other
//   warpgroups run up to the ring's depth ahead.
// - qs = bf16(q * scale * log2 e) made in place over each warpgroup's
//   staged q rows, 16 bytes a thread.
// - wgmma for both products: s = qs . K^T with both operands in shared
//   memory (m64n64k16, K read K-major; at block_k 128 two 64-column
//   products into two accumulators, whose row max is taken over both before
//   any p: each element of s is the same sum over D either way, so this is
//   one 128-wide tile's arithmetic), and o += p . V with bf16 p straight
//   from s's accumulators as the register A operand and V read MN-major
//   (m64nDk16), walking V's row blocks. Nothing is transposed by hand.
// - The grid is linear over (q tile, pack of heads), the last (heaviest
//   under causal) q tiles first, so B * H / pack has no 65535 limit.
// Not yet: a producer warpgroup with setmaxnreg, FA3's ping-pong, a
// persistent grid.
//
// Arithmetic, K2's and the TPU kernels' (the plain twins are in
// ray_tpu_torch/devbench/prof_flash_pack.py):
//   qs = bf16(q * scale * log2 e); s = qs . k^T in f32;
//   -1e30 where kpos > qpos on the tiles the schedule masks; base-2 online
//   softmax over block_k-wide tiles; p16 = bf16(p) feeds both p16 . v and
//   the row sum l; out = bf16(o / max(l, 1e-30)), lse = (m + log2 l) ln 2.
// The schedules differ only in which tiles they mask: K10 every tile in
// [0, n_end), K8 the tiles from m0 / block_k on, K9 tile qi alone, whose
// local mask (row r % block_q against column c) is the global one there,
// since that tile starts at m0. A warpgroup stops after the last kv tile
// that reaches its own last row, in all three alike: a tile wholly past
// its rows would add exp2(-1e30 - m) = 0 with alpha = 1. A fully visible
// tile has nothing to mask. So for one block_k the three give the same
// bits at every pack, and at block_k 64 K2's.
//
// Tiles: block_q and block_k in {64, 128}, pack in {1, 2, 4}, pack *
// block_q <= 256 rows a CTA at D 64 (16 warps, 128 registers a thread) and
// <= 128 at D 128 (8 warps; o alone takes 64 registers there).
//
// C interface (called through ctypes by
// ray_tpu_torch/devbench/prof_flash_pack.py):
//   int rtt_packed_fwd{,_epi,_inl}(q, k, v, out, lse, B, H, Hkv, S, D,
//                                  pack, block_q, block_k, scale_log2,
//                                  causal, stream)
// q/out [B,H,S,D], k/v [B,Hkv,S,D] bf16, contiguous and 16-byte aligned;
// lse [B,H,S] f32. Returns a cudaError_t (0 = launched) or a negative code
// for a shape the kernels do not take (rtt_flash_packed_fwd_error_string).

#include <limits.h>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr int kMaxRows = 256;       // pack * block_q a CTA at D 64 (16 warps)
constexpr int kMaxRowsD128 = 128;   // at D 128 (8 warps)
constexpr int kNarrowRows = 128;    // up to here a CTA runs 256 threads
constexpr int kBox = 64 * 64 * 2;   // one 64 x 64 bf16 TMA box
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

enum Schedule { kMasked = 0, kEpilogue = 1, kInline = 2 };

enum Error {
  kErrHeadDim = -1,
  kErrTile = -2,
  kErrPack = -3,
  kErrRagged = -4,
  kErrInline = -5,
  kErrGrid = -6,
  kErrNoEncoder = -7,
  kErrMap = -8,
};

template <int D, int BK>
struct Cfg {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBoxes = D / 64;        // boxes across a row
  static constexpr int kRows = kBoxes * kBox;  // 64 rows x D
  static constexpr int kHalves = BK / 64;      // 64-row blocks of a kv tile
  static constexpr int kTile = kHalves * kRows;  // one K (or V) tile
  static constexpr int kStage = 2 * kTile;       // K then V
  // Byte offsets from the 1024-aligned base, for a CTA of `rows` q rows:
  // q (rows / 64 blocks of 64), the K/V stages, the barriers (full, empty,
  // q).
  __host__ __device__ static constexpr int stage0(int rows) {
    return rows / 64 * kRows;
  }
  __host__ __device__ static constexpr int bars(int rows) {
    return stage0(rows) + kStages * kStage;
  }
  __host__ __device__ static constexpr int smem(int rows) {
    return bars(rows) + (2 * kStages + 1) * 8 + 1024;
  }
};

// WIDE: a CTA of more than kNarrowRows rows (D 64 only), 16 warps and so
// 128 registers a thread; otherwise up to 8 warps and 255.
template <int D, int BK, int SCHED, bool WIDE>
__global__ void __launch_bounds__(WIDE ? kMaxRows * 2 : kNarrowRows * 2, 1)
    packed_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      int H, int rep, int S, int pack, int block_q,
                      float scale2, int causal) {
  using C = Cfg<D, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nwg = blockDim.x >> 7;  // consumer warpgroups: pack * block_q / 64
  const int rows = nwg * 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars(rows));
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;
  unsigned char* stages = smem + C::stage0(rows);

  // A linear grid over (q tile, pack of heads), the pack fastest and the
  // last (heaviest) q tiles first.
  const int nq = S / block_q;
  const int npacks = gridDim.x / nq;
  const int qx = blockIdx.x / npacks;
  const int qi = causal ? nq - 1 - qx : qx;
  const int m0 = qi * block_q;
  const int bh0 = (blockIdx.x % npacks) * pack;  // flat (batch, q head) of head 0
  const int plane_kv = (bh0 / H) * (H / rep) + (bh0 % H) / rep;
  const int blocks = block_q / 64;  // 64-row blocks of one head's q tile

  // The schedule: kv tiles [0, n_free) run mask-free, [n_free, n_end)
  // masked. Causal: K10 masks every tile up to the bound; K8 only those
  // that reach past the q tile's first row, tile j being fully visible iff
  // (j+1)*block_k - 1 <= m0; K9's diagonal tile is tile qi.
  const int nkv = S / BK;
  int n_free = nkv, n_end = nkv;
  if (causal) {
    n_end = min((m0 + block_q + BK - 1) / BK, nkv);
    n_free = SCHED == kMasked ? 0 : SCHED == kEpilogue ? m0 / BK : qi;
  }

  const int tid = threadIdx.x;
  auto load_tile = [&](int j) {  // thread 0: kv tile j into its stage
    const int s = j % C::kStages;
    unsigned char* kt = stages + s * C::kStage;
    mbar_expect_tx(&full[s], C::kStage);
#pragma unroll
    for (int h = 0; h < C::kHalves; ++h)
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        const int off = h * C::kRows + bx * kBox;
        tma_load_3d(kt + off, &tm_k, &full[s], bx * 64, j * BK + h * 64,
                    plane_kv);
        tma_load_3d(kt + C::kTile + off, &tm_v, &full[s], bx * 64,
                    j * BK + h * 64, plane_kv);
      }
  };
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, rows / 64 * C::kRows);
    for (int w = 0; w < nwg; ++w)
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx)
        tma_load_3d(smem + w * C::kRows + bx * kBox, &tm_q, qbar, bx * 64,
                    m0 + (w % blocks) * 64, bh0 + w / blocks);
    for (int j = 0; j < min(C::kStages, n_end); ++j) load_tile(j);
  }
  __syncwarp();

  // ---- warpgroup wg owns rows r0 .. r0 + 63 of head `head` of the pack ----
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int head = wg / blocks;
  const int r0 = m0 + (wg % blocks) * 64;
  const int row0 = r0 + warp * 16 + g;  // this thread's two q rows
  const int row1 = row0 + 8;
  // kv tiles this warpgroup computes: up to the one holding its last row.
  const int nkt_wg = causal ? min((r0 + 64 + BK - 1) / BK, n_end) : n_end;

  // qs = bf16(q * scale * log2 e) in place over this warpgroup's q rows.
  unsigned char* qrows = smem + wg * C::kRows;
  mbar_wait(qbar, 0);
  for (int i = tid & 127; i < C::kRows / 16; i += 128) {
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
  named_barrier_sync(1 + wg, 128);
  const uint32_t qaddr = smem_u32(qrows);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float sc[C::kHalves][32];
#pragma unroll
  for (int h = 0; h < C::kHalves; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[h][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_end; ++j) {
    const int s = j % C::kStages;
    mbar_wait(&full[s], (j / C::kStages) & 1);
    if (j < nkt_wg) {
      const int n0 = j * BK;
      const bool masked = j >= n_free;
      const uint32_t kaddr = smem_u32(stages + s * C::kStage);
      const uint32_t vaddr = kaddr + C::kTile;

      // s = qs . K^T: 64 q rows x block_k kv columns, 64 at a time.
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h) fence_regs(sc[h]);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
          wgmma_m64n64k16_ss<0>(
              sc[h], wgmma_desc(qaddr + off, 16, 1024),
              wgmma_desc(kaddr + h * C::kRows + off, 16, 1024), kk > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h) fence_regs(sc[h]);

      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (masked) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = n0 + h * 64 + nt * 8 + 2 * t + (e & 1);
              if (col > (e < 2 ? row0 : row1)) sc[h][4 * nt + e] = kNegInf;
            }
          }
          mx0 = fmaxf(mx0, fmaxf(sc[h][4 * nt], sc[h][4 * nt + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[h][4 * nt + 2], sc[h][4 * nt + 3]));
        }
      const float mn0 = fmaxf(m_run[0], quad_max(mx0));
      const float mn1 = fmaxf(m_run[1], quad_max(mx1));
      const float alpha0 = exp2f(m_run[0] - mn0);
      const float alpha1 = exp2f(m_run[1] - mn1);
      m_run[0] = mn0;
      m_run[1] = mn1;

      // p in bf16; l sums exactly the rounded values that multiply v.
      uint32_t pa[BK / 16][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int h = 0; h < C::kHalves; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t lo = pack_bf16(exp2f(sc[h][4 * nt] - mn0),
                                        exp2f(sc[h][4 * nt + 1] - mn0));
          const uint32_t hi = pack_bf16(exp2f(sc[h][4 * nt + 2] - mn1),
                                        exp2f(sc[h][4 * nt + 3] - mn1));
          const float2 a = unpack_bf16(lo), c = unpack_bf16(hi);
          sum0 += a.x + a.y;
          sum1 += c.x + c.y;
          pa[h * 4 + nt / 2][(nt & 1) * 2] = lo;
          pa[h * 4 + nt / 2][(nt & 1) * 2 + 1] = hi;
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

      // o += p16 . V, V read MN-major: kv rows 16 kk .. 16 kk + 15, in row
      // block kk / 4 of the tile.
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t desc =
            wgmma_desc(vaddr + (kk / 4) * C::kRows + (kk % 4) * 2048, kBox,
                       1024);
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
    if (tid == 0 && j + C::kStages < n_end) {
      // Every consumer has released tile j's stage: tile j + kStages in.
      mbar_wait(&empty[s], (j / C::kStages) & 1);
      load_tile(j + C::kStages);
    }
    __syncwarp();
  }

  const float l0 = fmaxf(l_run[0], 1e-30f);
  const float l1 = fmaxf(l_run[1], 1e-30f);
  const size_t q_base = (size_t)(bh0 + head) * S * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + q_base + (size_t)row0 * D + col) =
        pack_bf16(o[4 * dt] / l0, o[4 * dt + 1] / l0);
    *reinterpret_cast<uint32_t*>(out + q_base + (size_t)row1 * D + col) =
        pack_bf16(o[4 * dt + 2] / l1, o[4 * dt + 3] / l1);
  }
  if (t == 0) {
    float* lse_row = lse + (size_t)(bh0 + head) * S;
    lse_row[row0] = (m_run[0] + log2f(l0)) * kLn2;
    lse_row[row1] = (m_run[1] + log2f(l1)) * kLn2;
  }
}

template <int D, int BK, int SCHED, bool WIDE>
int launch_kernel(const CUtensorMap& tq, const CUtensorMap& tk,
                  const CUtensorMap& tv, void* out, float* lse, int B, int H,
                  int Hkv, int S, int pack, int block_q, float scale2,
                  int causal, cudaStream_t stream) {
  using C = Cfg<D, BK>;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_fwd_kernel<D, BK, SCHED, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::smem(WIDE ? kMaxRows : kNarrowRows));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int rows = pack * block_q;
  const int grid = (S / block_q) * (B * H / pack);
  packed_fwd_kernel<D, BK, SCHED, WIDE><<<grid, rows * 2, C::smem(rows),
                                          stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, H, H / Hkv, S, pack,
      block_q, scale2, causal);
  return cudaGetLastError();
}

template <int D, int BK, int SCHED>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int Hkv, int S, int pack, int block_q, float scale2,
           int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = rtt_make_tile_map(&tq, q, B * H, S, D);
  if (err == 0) err = rtt_make_tile_map(&tk, k, B * Hkv, S, D);
  if (err == 0) err = rtt_make_tile_map(&tv, v, B * Hkv, S, D);
  if (err) return err == -2 ? kErrNoEncoder : kErrMap;
  if constexpr (D == 64) {
    if (pack * block_q > kNarrowRows)
      return launch_kernel<D, BK, SCHED, true>(tq, tk, tv, out, lse, B, H,
                                               Hkv, S, pack, block_q, scale2,
                                               causal, stream);
  }
  return launch_kernel<D, BK, SCHED, false>(tq, tk, tv, out, lse, B, H, Hkv,
                                            S, pack, block_q, scale2, causal,
                                            stream);
}

template <int SCHED>
int dispatch(const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int H, int Hkv, int S, int D, int pack,
             int block_q, int block_k, float scale2, int causal,
             void* stream) {
  if (D != 64 && D != 128) return kErrHeadDim;
  if ((block_q != 64 && block_q != 128) || (block_k != 64 && block_k != 128))
    return kErrTile;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 ||
      (pack != 1 && pack != 2 && pack != 4) || (H / Hkv) % pack != 0 ||
      pack * block_q > (D == 64 ? kMaxRows : kMaxRowsD128))
    return kErrPack;
  if (S % block_q != 0 || S % block_k != 0) return kErrRagged;
  if (SCHED == kInline && block_q != block_k) return kErrInline;
  if ((long long)(S / block_q) * B * H / pack > INT_MAX) return kErrGrid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define RTT_PACKED_LAUNCH(DD, BB)                                          \
  return launch<DD, BB, SCHED>(q, k, v, out, l, B, H, Hkv, S, pack, block_q, \
                               scale2, causal, s)
  if (D == 64) {
    if (block_k == 64) RTT_PACKED_LAUNCH(64, 64);
    RTT_PACKED_LAUNCH(64, 128);
  }
  if (block_k == 64) RTT_PACKED_LAUNCH(128, 64);
  RTT_PACKED_LAUNCH(128, 128);
#undef RTT_PACKED_LAUNCH
}

}  // namespace

extern "C" int rtt_packed_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int H, int Hkv,
                              int S, int D, int pack, int block_q, int block_k,
                              float scale2, int causal, void* stream) {
  return dispatch<kMasked>(q, k, v, out, lse, B, H, Hkv, S, D, pack, block_q,
                           block_k, scale2, causal, stream);
}

extern "C" int rtt_packed_fwd_epi(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int H, int Hkv,
                                  int S, int D, int pack, int block_q,
                                  int block_k, float scale2, int causal,
                                  void* stream) {
  return dispatch<kEpilogue>(q, k, v, out, lse, B, H, Hkv, S, D, pack,
                             block_q, block_k, scale2, causal, stream);
}

extern "C" int rtt_packed_fwd_inl(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int H, int Hkv,
                                  int S, int D, int pack, int block_q,
                                  int block_k, float scale2, int causal,
                                  void* stream) {
  return dispatch<kInline>(q, k, v, out, lse, B, H, Hkv, S, D, pack, block_q,
                           block_k, scale2, causal, stream);
}

// Dynamic shared memory of a CTA of pack * block_q rows, or -1 for a
// head_dim or block_k the kernels do not take.
extern "C" int rtt_flash_packed_fwd_smem_bytes(int D, int block_k, int rows) {
  if (D == 64) return block_k == 64 ? Cfg<64, 64>::smem(rows)
                    : block_k == 128 ? Cfg<64, 128>::smem(rows) : -1;
  if (D == 128) return block_k == 64 ? Cfg<128, 64>::smem(rows)
                     : block_k == 128 ? Cfg<128, 128>::smem(rows) : -1;
  return -1;
}

extern "C" const char* rtt_flash_packed_fwd_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "unsupported head_dim (64 or 128)";
    case kErrTile: return "unsupported block_q / block_k (64 or 128)";
    case kErrPack:
      return "pack must be 1, 2 or 4, divide H / Hkv, and give "
             "pack * block_q <= 256 rows at D 64, 128 at D 128";
    case kErrRagged: return "S must be a multiple of block_q and block_k";
    case kErrInline: return "the inline-diagonal kernel needs block_q == block_k";
    case kErrGrid: return "S / block_q * B * H / pack above INT_MAX";
    case kErrNoEncoder:
      return "cuTensorMapEncodeTiled not found: no TMA tensor maps";
    case kErrMap: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
