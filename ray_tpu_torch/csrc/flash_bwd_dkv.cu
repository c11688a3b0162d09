// Split flash-attention backward, dk/dv pass, for Hopper (sm_90a): dk and dv
// from the forward's saved logsumexp, folded over the q heads of each kv
// head inside the kernel, no atomics.
//
// Replaces the Pallas kernel _flash_bwd_dkv_kernel
// (ray_tpu/ops/attention.py), which ran a grid over (batch * q head, kv
// block), walked the q blocks that can see its kv block in a fori_loop and
// wrote dk/dv per q head, and the JAX wrapper's GQA fold after it (the rep
// q heads of a kv head summed in f32 and rounded once more,
// ray_tpu/ops/attention.py:1063-1069). Here one CTA takes 128 kv rows of
// one kv head and walks every q head of that kv head in order, each over
// the 64-row q tiles that can see its rows. For each q head, dk and dv
// accumulate in f32 registers; at the head's end they are rounded to bf16
// (the TPU kernel's per-head output) and added as f32 into the fold; after
// the last head the fold is rounded once and written as [B, Hkv, Skv, D].
// The per-head buffers of dk/dv and the wrapper's fold are gone. Nothing
// is shared between CTAs: the result is the same bit for bit on every run.
//
// Bound: operations. Four products per kept (q, k) pair, 8 * D FLOPs: ~137
// GFLOP at the training shape (B4 H32 Hkv8 S2048 D64 causal), ~139 us at
// 989 TFLOP/s, against ~103 MB of traffic with dk/dv folded. At ViT-B/16's
// shape (B128 H12 S197 D64, non-causal) bytes bound it: ~235 MB against
// ~31 GFLOP. What the design does about it:
// - 128 kv rows per CTA: two warpgroups of 64 kv rows read each staged q
//   tile. There is no producer warp: with 9 warps a thread may hold at
//   most 168 registers (a quarter of the register file for the three
//   warps of the fullest scheduler), and s^T, dp^T, dk and dv need more
//   at both head dims; with 8 warps the cap is 255. The grid is linear
//   over (kv tile, batch * kv head), the first kv tiles (the longest
//   under causal) first, so B * Hkv has no 65535 limit.
// - Asynchronous staging: thread 0 loads the CTA's K and V rows once, and
//   each q tile's q and dO rows into a ring of 2 stages, by TMA (64 x 64
//   bf16 boxes, 128-byte swizzle, rows past the end zero-filled, one
//   mbarrier a stage); threads 0..127 copy the tile's lse and delta beside
//   them by cp.async. Tile i + 1 is issued right after the barrier that
//   starts tile i (every thread is then done with tile i - 1, whose stage
//   it takes), so it loads while tile i computes.
// - qs = bf16(q * scale * log2 e) is made once per staged tile, by the 256
//   threads, 16 bytes each, into a buffer of the stage beside q (dk needs
//   q unscaled).
// - wgmma for all four products, with the kv rows as M: s^T = K . qs^T and
//   dp^T = V . dO^T with both operands in shared memory (q and dO read
//   K-major), then dv += bf16(p)^T . dO and dk += bf16(ds)^T . q with the
//   A operands packed from s^T's and dp^T's accumulators and dO and q read
//   MN-major through their descriptors. Nothing is transposed by hand.
// - Tile classes: a q tile wholly before a warpgroup's kv rows is not
//   computed (the q loop starts at the CTA's diagonal; the upper
//   warpgroup skips the one tile hidden from it); the mask runs only on
//   the diagonal tile and on ragged tiles.
// - The route at each head dim. D 64: the products as above, a q tile
//   whole (s^T and dp^T m64n64k16), the fold in shared memory. D 128: the
//   q tile in two halves of 32 columns (s^T and dp^T m64n32k16), so that
//   dk, dv, s^T and dp^T fit in a thread's registers without a spill; the
//   fold (128 rows x 128 columns x 2 in f32, 128 KB) does not fit in
//   shared memory beside K, V and two stages, so it goes to an f32
//   scratch in device memory that the wrapper allocates, one slice per
//   CTA, touched only at the ends of the q heads.
// Tried on the card and dropped, none faster at the training shape: a
// third stage; warpgroups decoupled by per-stage empty barriers, each with
// its own qs; s^T and dp^T in separate groups so that p and ds are made
// while dp^T and dv run; FA3's ping-pong between the warpgroups (slower);
// p^T and ds^T through shared memory, so that dv/dk read both operands
// there (slower). Removing parts one at a time put most of the time in
// dv/dk and the waits around them, not in s^T/dp^T or the staging.
// Not yet: a persistent grid, setmaxnreg with a producer warpgroup.
//
// Arithmetic, kept identical to the TPU kernel and to the plain twins
// (fold_heads of flash_bwd_dkv_plain, ray_tpu_torch/ops/attention.py):
//   qs  = bf16(q * scale * log2 e)        (the forward's rounding)
//   s   = qs . k^T (f32), masked to -1e30; p = exp2(s - lse * log2 e)
//   dv_h += bf16(p)^T . dO
//   dp  = dO . v^T (f32); ds = bf16(p * (dp - delta) * scale)
//   dk_h += ds^T . q                      (q unscaled; f32 accumulate)
//   dk = bf16(sum over the kv head's q heads h of f32(bf16(dk_h))), dv alike
// lse * log2 e is rounded as a product before the subtraction (no fused
// multiply-add). wgmma may sum a product in another order than the twin's
// matmul, and the fold adds the heads in order 0..rep-1, so the result is
// held to the twin's tolerances, not its bits.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, fold,
//                         B, H, Hkv, Sq, Skv, D, scale, scale_log2, causal,
//                         stream)
// q/dout [B,H,Sq,D], k/v/dk/dv [B,Hkv,Skv,D] bf16 contiguous and 16-byte
// aligned; lse/delta [B,H,Sq] f32; fold an f32 scratch of
// rtt_flash_bwd_dkv_fold_floats(B, Hkv, Skv, D) floats (0 at D 64: null
// is fine). D is 64 or 128; any Sq, Skv >= 1; H % Hkv == 0. Returns a
// cudaError_t (0 = launched), -1 for an unsupported D, -2/-3 when the
// tensor maps cannot be made.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr int kWG = 2;                      // consumer warpgroups
constexpr int kBlockN = 64 * kWG;           // kv rows per CTA
constexpr int kBlockM = 64;                 // q rows per staged tile
constexpr int kThreads = 128 * kWG;
constexpr int kBox = 64 * 64 * 2;           // one 64 x 64 bf16 TMA box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kStages = 2;
  static constexpr int kBoxes = D / 64;           // boxes across a row
  static constexpr int kRows = kBoxes * kBox;     // 64 rows x D
  static constexpr int kQW = D == 64 ? 64 : 32;   // q columns a part
  static constexpr int kParts = kBlockM / kQW;
  static constexpr bool kFoldSmem = D == 64;
  static constexpr int kLDF = kFoldSmem ? D + 8 : D;  // f32 fold pitch
  static constexpr int kFold = 2 * kBlockN * kLDF;    // floats: dk, dv
  // Byte offsets from the 1024-aligned base: K and V rows (kWG blocks of
  // 64 rows each), the stages, the fold (D 64), the barriers. A stage
  // holds q, dO, qs, then lse * log2 e and delta [64] f32 each.
  static constexpr int kK = 0;
  static constexpr int kV = kK + kWG * kRows;
  static constexpr int kStage0 = kV + kWG * kRows;
  static constexpr int kSRows = 3 * kRows;
  static constexpr int kStage = (kSRows + 2 * kBlockM * 4 + 1023) / 1024 * 1024;
  static constexpr int kFoldOff = kStage0 + kStages * kStage;
  static constexpr int kBars = kFoldOff + (kFoldSmem ? kFold * 4 : 0);
  static constexpr int kSmem = kBars + (kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         float* __restrict__ fold_scratch, int BHkv, int H,
                         int Hkv, int Sq, int Skv, float scale, float scale2,
                         int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* kvbar = full + C::kStages;

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x / BHkv) * kBlockN;  // first kv tiles first
  const int plane_kv = blockIdx.x % BHkv;         // b * Hkv + hk
  const int b = plane_kv / Hkv;
  const int hk = plane_kv % Hkv;
  const int rep = H / Hkv;
  const int nqt = (Sq + kBlockM - 1) / kBlockM;
  // Causal: q tiles before the one holding row n0 see none of these rows.
  const int mt0 = causal ? n0 / kBlockM : 0;
  const int per_head = max(nqt - mt0, 0);  // q tiles a q head
  const int ntile = rep * per_head;

  // Tile it = (q head it / per_head, q tile mt0 + it % per_head) into
  // stage it % kStages: q and dO by TMA from thread 0, lse and delta by
  // cp.async from threads 0..127.
  auto plane_of = [&](int it) { return b * H + hk * rep + it / per_head; };
  auto m0_of = [&](int it) { return (mt0 + it % per_head) * kBlockM; };
  auto stage_in = [&](int it) {
    const int s = it % C::kStages;
    unsigned char* st = smem + C::kStage0 + s * C::kStage;
    const int plane = plane_of(it), m0 = m0_of(it);
    if (tid == 0) {
      mbar_expect_tx(&full[s], 2 * C::kRows);
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        tma_load_3d(st + bx * kBox, &tm_q, &full[s], bx * 64, m0, plane);
        tma_load_3d(st + C::kRows + bx * kBox, &tm_do, &full[s], bx * 64, m0,
                    plane);
      }
    }
    if (tid < 2 * kBlockM) {
      const int i = tid % kBlockM;
      const bool ok = m0 + i < Sq;
      const size_t row = (size_t)plane * Sq + (ok ? m0 + i : 0);
      cp_async4(st + C::kSRows + tid * 4,
                tid < kBlockM ? lse + row : delta + row, ok);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kvbar, 2 * kWG * C::kRows);
#pragma unroll
    for (int rb = 0; rb < kWG; ++rb)
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        const int off = rb * C::kRows + bx * kBox;
        tma_load_3d(smem + C::kK + off, &tm_k, kvbar, bx * 64, n0 + rb * 64,
                    plane_kv);
        tma_load_3d(smem + C::kV + off, &tm_v, kvbar, bx * 64, n0 + rb * 64,
                    plane_kv);
      }
  }
  if (ntile > 0) stage_in(0);
  cp_async_commit();

  // ---- warpgroup wg owns kv rows c0 .. c0 + 63 ----
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = n0 + wg * 64;
  const bool live = c0 < Skv;  // a warpgroup past Skv computes nothing
  const int kv0 = c0 + warp * 16 + g;  // this thread's two kv rows
  const int kv1 = kv0 + 8;
  const uint32_t kaddr = smem_u32(smem + C::kK + wg * C::kRows);
  const uint32_t vaddr = smem_u32(smem + C::kV + wg * C::kRows);
  float* fold = C::kFoldSmem
                    ? reinterpret_cast<float*>(smem + C::kFoldOff)
                    : fold_scratch + (size_t)blockIdx.x * C::kFold;
  const int frow = wg * 64 + warp * 16 + g;  // the thread's fold rows: frow,
                                             // frow + 8

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float st_[C::kQW / 2], dpt[C::kQW / 2];
#pragma unroll
  for (int i = 0; i < C::kQW / 2; ++i) st_[i] = dpt[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int it = 0, r = 0; r < rep; ++r) {
    for (int mt = mt0; mt < nqt; ++mt, ++it) {
      const int s = it % C::kStages;
      unsigned char* stg = smem + C::kStage0 + s * C::kStage;
      float* rows = reinterpret_cast<float*>(stg + C::kSRows);
      cp_async_wait<0>();  // this thread's lse/delta rows of tile it
      if (tid < kBlockM) rows[tid] = __fmul_rn(rows[tid], kLog2e);
      mbar_wait(&full[s], (it / C::kStages) & 1);

      // qs = bf16(q * scale * log2 e) beside q, 16 bytes a thread.
      for (int i = tid; i < C::kRows / 16; i += kThreads) {
        uint4 raw = reinterpret_cast<const uint4*>(stg)[i];
        uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(w[e]);
          w[e] = pack_bf16(f.x * scale2, f.y * scale2);
        }
        reinterpret_cast<uint4*>(stg + 2 * C::kRows)[i] = raw;
      }
      fence_proxy_async();  // the generic writes, before wgmma reads them
      // Every thread is done with tile it - 1, and tile it's qs and rows
      // are in: tile it + 1 loads into the stage tile it - 1 held.
      __syncthreads();
      if (it + 1 < ntile) stage_in(it + 1);
      cp_async_commit();

      const int m0 = mt * kBlockM;
      if (live && !(causal && m0 + kBlockM - 1 < c0)) {
        // The diagonal tile and ragged tiles take the mask.
        const bool masked = (causal && m0 < c0 + 63) || m0 + kBlockM > Sq ||
                            c0 + 64 > Skv;
        const uint32_t qaddr = smem_u32(stg);
        const uint32_t doaddr = qaddr + C::kRows;
        const uint32_t qsaddr = qaddr + 2 * C::kRows;
#pragma unroll
        for (int part = 0; part < C::kParts; ++part) {
          const int qc = part * C::kQW;  // the part's first q column

          // s^T = K . qs^T and dp^T = V . dO^T: 64 kv rows x kQW q columns.
          fence_regs(st_);
          fence_regs(dpt);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
            const uint64_t da = wgmma_desc(kaddr + off, 16, 1024);
            const uint64_t db = wgmma_desc(qsaddr + qc * 128 + off, 16, 1024);
            if constexpr (C::kQW == 64)
              wgmma_m64n64k16_ss<0>(st_, da, db, kk > 0);
            else
              wgmma_m64n32k16_ss<0>(st_, da, db, kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
            const uint64_t da = wgmma_desc(vaddr + off, 16, 1024);
            const uint64_t db = wgmma_desc(doaddr + qc * 128 + off, 16, 1024);
            if constexpr (C::kQW == 64)
              wgmma_m64n64k16_ss<0>(dpt, da, db, kk > 0);
            else
              wgmma_m64n32k16_ss<0>(dpt, da, db, kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(st_);
          fence_regs(dpt);

          // bf16(p)^T and bf16(ds)^T, packed as A fragments.
          uint32_t pa[C::kQW / 16][4], da_[C::kQW / 16][4];
#pragma unroll
          for (int nt = 0; nt < C::kQW / 8; ++nt) {
            float pv[4], dsv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ql = qc + nt * 8 + 2 * t + (e & 1);
              float x = st_[4 * nt + e];
              if (masked) {
                const int qpos = m0 + ql;
                const int kvpos = e < 2 ? kv0 : kv1;
                if (qpos >= Sq || kvpos >= Skv || (causal && kvpos > qpos))
                  x = kNegInf;
              }
              pv[e] = exp2f(x - rows[ql]);
              dsv[e] = pv[e] * (dpt[4 * nt + e] - rows[kBlockM + ql]) * scale;
            }
            pa[nt / 2][(nt & 1) * 2] = pack_bf16(pv[0], pv[1]);
            pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
            da_[nt / 2][(nt & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
            da_[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
          }

          // dv += bf16(p)^T . dO and dk += bf16(ds)^T . q, dO and q read
          // MN-major: q rows qc + 16 kk .. + 15.
          fence_regs(dva);
          fence_regs(dka);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::kQW / 16; ++kk) {
            const uint32_t off = (qc + 16 * kk) * 128;
            const uint64_t dd = wgmma_desc(doaddr + off, kBox, 1024);
            const uint64_t dq_ = wgmma_desc(qaddr + off, kBox, 1024);
            if constexpr (D == 64) {
              wgmma_m64n64k16_rs<1>(dva, pa[kk], dd, 1);
              wgmma_m64n64k16_rs<1>(dka, da_[kk], dq_, 1);
            } else {
              wgmma_m64n128k16_rs<1>(dva, pa[kk], dd, 1);
              wgmma_m64n128k16_rs<1>(dka, da_[kk], dq_, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
        }
      }
    }

    // The end of q head r: round its dk/dv to bf16, add them into the fold
    // in f32 (each thread its own elements); after the last head, round
    // the fold once and write it.
    const bool last = r == rep - 1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int fr = frow + 8 * hi;
        const int kv = (hi ? kv1 : kv0);
        float2 xk = unpack_bf16(pack_bf16(dka[4 * dt + 2 * hi],
                                          dka[4 * dt + 2 * hi + 1]));
        float2 xv = unpack_bf16(pack_bf16(dva[4 * dt + 2 * hi],
                                          dva[4 * dt + 2 * hi + 1]));
        float2* fk = reinterpret_cast<float2*>(fold + fr * C::kLDF + col);
        float2* fv = reinterpret_cast<float2*>(
            fold + (kBlockN + fr) * C::kLDF + col);
        if (r > 0) {
          const float2 ak = *fk, av = *fv;
          xk.x = ak.x + xk.x;
          xk.y = ak.y + xk.y;
          xv.x = av.x + xv.x;
          xv.y = av.y + xv.y;
        }
        if (!last) {
          *fk = xk;
          *fv = xv;
        } else if (kv < Skv) {
          const size_t off = ((size_t)plane_kv * Skv + kv) * D + col;
          *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(xk.x, xk.y);
          *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(xv.x, xv.y);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv,
           float* fold, int B, int H, int Hkv, int Sq, int Skv, float scale,
           float scale2, int causal, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::kSmem;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  if (!Cfg<D>::kFoldSmem && fold == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  int err = rtt_make_tile_map(&tq, q, B * H, Sq, D);
  if (err == 0) err = rtt_make_tile_map(&tdo, dout, B * H, Sq, D);
  if (err == 0) err = rtt_make_tile_map(&tk, k, B * Hkv, Skv, D);
  if (err == 0) err = rtt_make_tile_map(&tv, v, B * Hkv, Skv, D);
  if (err) return err;
  const int grid = ((Skv + kBlockN - 1) / kBlockN) * B * Hkv;
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), fold, B * Hkv, H, Hkv, Sq, Skv, scale,
      scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 void* fold, int B, int H, int Hkv, int Sq,
                                 int Skv, int D, float scale, float scale2,
                                 int causal, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      (long long)((Skv + kBlockN - 1) / kBlockN) * B * Hkv > INT_MAX ||
      (long long)B * H > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* f = static_cast<float*>(fold);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, l, dl, dk, dv, f, B, H, Hkv, Sq, Skv,
                        scale, scale2, causal, s);
    case 128:
      return launch<128>(q, k, v, dout, l, dl, dk, dv, f, B, H, Hkv, Sq, Skv,
                         scale, scale2, causal, s);
    default:
      return -1;
  }
}

// Floats of the f32 fold scratch a launch needs (0 where the fold sits in
// shared memory).
extern "C" long long rtt_flash_bwd_dkv_fold_floats(int B, int Hkv, int Skv,
                                                   int D) {
  if (D != 128) return 0;
  return (long long)((Skv + kBlockN - 1) / kBlockN) * B * Hkv *
         Cfg<128>::kFold;
}

extern "C" int rtt_flash_bwd_dkv_smem_bytes(int D) {
  return D == 64 ? Cfg<64>::kSmem : D == 128 ? Cfg<128>::kSmem : -1;
}

extern "C" const char* rtt_flash_bwd_dkv_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  if (code == -2) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == -3) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
