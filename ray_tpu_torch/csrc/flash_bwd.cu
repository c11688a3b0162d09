// Fused flash-attention backward for Hopper (sm_90a): dq, dk and dv in one
// pass from the forward's saved logsumexp, dk/dv summed over the q heads of
// each kv head (GQA) inside the kernel.
//
// Replaces the Pallas kernel _flash_bwd_fused_kernel
// (ray_tpu/ops/attention.py), which ran a grid over (packed q heads, q
// blocks), computed dq, dk and dv of each tile pair in one pass and carried
// dk/dv in VMEM scratch across the *sequential* q axis. Hopper runs CTAs in
// parallel and in no order, so nothing carries over between them: one CTA
// takes 128 kv rows of one (batch, kv head), walks every q head of that kv
// head and, within each, the 64-row q tiles that can see its rows, and
// keeps dk and dv in f32 registers across all of them (the GQA sum costs
// nothing and is rounded once). dq of a (q tile, kv tile) pair is summed
// into an f32 buffer [B,H,Sq,D] across CTAs in ascending kv-tile order (an
// ordered reduction, as FlashAttention-3's deterministic backward does);
// the caller casts it. dq, dk and dv are the same bits on every run, as the
// TPU kernel's are.
//
// Bound: operations. Five products per kept (q, k) pair, 10 * D FLOPs: ~172
// GFLOP at the training shape (B4 H32 Hkv8 S2048 D64 causal), ~174 us at
// 989 TFLOP/s, against ~168 MB of HBM traffic; dq's sums across CTAs add
// ~0.57 GB of f32 reductions into L2 there (272 kept (64-row q tile,
// 128-row kv tile) pairs per (batch, q head), 16 KB each), and each tile's
// turn (a poll, a fence) sits on its CTA's critical path. What the design
// does about it:
// - 128 kv rows per CTA, two consumer warpgroups of 64 kv rows; no producer
//   warp (with 8 warps a thread may hold 255 registers; 9 would cap it at
//   168, too few for dk, dv, s^T and dp^T). Thread 0 issues the TMA loads.
// - Asynchronous staging: K and V rows once per CTA; each q tile's q, dO
//   and O rows through a ring of 2 stages by TMA (64 x 64 bf16 boxes,
//   128-byte swizzle, rows past the end zero-filled, one mbarrier a stage),
//   lse beside them by cp.async. Tile i + 1 is issued right after the
//   barrier that starts tile i, so it loads while tile i computes.
// - k_sc = bf16(k * scale) is made once per CTA. In one pass over each
//   staged q tile, 16 bytes a thread, the 256 threads make qs = bf16(q *
//   scale * log2 e) over the O rows (after reading them), q_sc = bf16(q *
//   scale) over q, and delta = rowsum(dO * O) in f32 (each row's 8 or 16
//   chunks summed in registers, then over the 8 lanes that hold them).
//   The wrapper no longer makes delta: in PyTorch it took about a fifth
//   of the whole backward at the training shape (devbench/pair_flash.py;
//   PERF.md).
// - wgmma for all five products, with the kv rows as M for four: s^T =
//   K . qs^T and dp^T = V . dO^T with both operands in shared memory, then
//   dv += bf16(p)^T . dO and dk += bf16(ds)^T . q_sc with the A operands
//   packed from s^T's and dp^T's accumulators and dO, q_sc read MN-major.
//   bf16(ds)^T also goes to shared memory, [kv][q] with 128-byte swizzle,
//   and dq = bf16(ds) . k_sc reads it back as an MN-major (transposed) A,
//   M = 64 q rows, K = the CTA's 128 kv rows; the two warpgroups split
//   dq's columns (N = D / 2 each), so neither idles.
// - dq across CTAs, in a fixed order: each warp owns 16 q rows x D / 2
//   columns of a q tile's dq and one turn counter for them (dq_sem, [B, H,
//   q tiles, 8 warps] int32, zeroed by the wrapper with the f32 buffer).
//   The CTA of kv tile j waits until the counter reads j (the poll runs
//   while the tile's dq product does), adds its part by float4 reductions
//   (red.global.add; lanes t and t ^ 1 trade halves first, so one float4
//   goes where two float2 did), fences until they have landed and passes
//   the turn. Every CTA of kv tile j visits every q tile that kv tiles 0
//   .. j - 1 visit (causal: q tile m is visited by kv tiles 0 .. m / 2;
//   non-causal: by all), so turn j follows exactly j earlier turns and
//   none is skipped. No deadlock: a CTA waits only on CTAs of the same
//   plane with lower kv tiles, whose linear block indices are lower;
//   blocks are dispatched in ascending linear order, so those are running
//   or done whenever this one runs, and the lowest unfinished one waits on
//   nothing. The f32 atomics this replaced summed in arrival order
//   (run-to-run noise in dq's last bits); the designs tried on the way and
//   their times are in PERF.md. dv/dk's products of a tile run on while
//   ds^T is shared and dq is issued.
// - The grid is linear over (kv tile, batch * kv head), the first kv tiles
//   (the longest under causal) first, so B * Hkv has no 65535 limit.
//   Grouping a few planes' CTAs together, so that those in flight share
//   their dq buffers in L2, timed no faster.
// - Tile classes: a q tile wholly before a warpgroup's kv rows is not
//   computed (its ds^T rows are zeroed for dq); the mask runs only on the
//   diagonal tile and on ragged tiles.
// - The route at each head dim: D 64, a q tile whole (s^T and dp^T
//   m64n64k16); D 128, the q tile in two halves of 32 columns (m64n32k16),
//   so that dk, dv, s^T and dp^T fit in a thread's registers.
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_bwd_plain in ray_tpu_torch/ops/attention.py:
//   qs   = bf16(q * scale * log2 e)     (the forward's rounding)
//   q_sc = bf16(q * scale)   k_sc = bf16(k * scale)   (operand scale folding)
//   s    = qs . k^T (f32), masked to -1e30; p = exp2(s - lse * log2 e)
//   dp   = dO . v^T (f32); ds = p * (dp - delta); delta = rowsum(dO * O)
//                            in f32 from the bf16 dO and O
//   dv  += bf16(p)^T . dO;  dk += bf16(ds)^T . q_sc;  dq += bf16(ds) . k_sc
//   dk, dv: f32 over every q head of the kv head, rounded to bf16 once.
// lse * log2 e is rounded as a product before the subtraction (no fused
// multiply-add). wgmma may sum a product in another order than the twin's
// matmul, so the result is held to the twin's tolerances, not its bits.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_bwd(q, k, v, dout, lse, out, dq_acc, dq_sem, dk, dv,
//                     B, H, Hkv, Sq, Skv, D, scale, scale_log2, causal,
//                     stream)
// q/dout/out [B,H,Sq,D], k/v/dk/dv [B,Hkv,Skv,D] bf16 contiguous and
// 16-byte aligned; lse [B,H,Sq] f32; dq_acc [B,H,Sq,D] f32 and dq_sem
// int32 [B * H * ceil(Sq / 64) * 8], both zeroed by the caller. D is 64 or
// 128; any Sq, Skv >= 1; H % Hkv == 0. Returns a cudaError_t (0 =
// launched), -1 for an unsupported D, -2/-3
// when the tensor maps cannot be made.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr int kWG = 2;                      // consumer warpgroups
constexpr int kBlockN = 64 * kWG;           // kv rows per CTA
constexpr int kBlockM = 64;                 // q rows per staged tile
constexpr int kThreads = 128 * kWG;
constexpr int kDqTurns = 4 * kWG;           // dq turn counters a q tile
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
  // Byte offsets from the 1024-aligned base: K, V and k_sc rows (kWG blocks
  // of 64 rows each), the stages, bf16 ds^T [128 kv][64 q], the barriers.
  // A stage holds q_sc (made over q), dO, qs (made over O), then
  // lse * log2 e and delta [64] f32 each.
  static constexpr int kK = 0;
  static constexpr int kV = kK + kWG * kRows;
  static constexpr int kKsc = kV + kWG * kRows;
  static constexpr int kStage0 = kKsc + kWG * kRows;
  static constexpr int kSRows = 3 * kRows;
  static constexpr int kStage =
      (kSRows + 2 * kBlockM * 4 + 1023) / 1024 * 1024;
  static constexpr int kDs = kStage0 + kStages * kStage;
  static constexpr int kBars = kDs + kBlockN * kBlockM * 2;
  static constexpr int kSmem = kBars + (kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o,
                     const float* __restrict__ lse,
                     float* __restrict__ dq_acc, int* __restrict__ dq_sem,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int BHkv, int H,
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
  // stage it % kStages: q, dO and O by TMA from thread 0, lse by cp.async
  // from threads 0..63.
  auto plane_of = [&](int it) { return b * H + hk * rep + it / per_head; };
  auto m0_of = [&](int it) { return (mt0 + it % per_head) * kBlockM; };
  auto stage_in = [&](int it) {
    const int s = it % C::kStages;
    unsigned char* st = smem + C::kStage0 + s * C::kStage;
    const int plane = plane_of(it), m0 = m0_of(it);
    if (tid == 0) {
      mbar_expect_tx(&full[s], 3 * C::kRows);
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        tma_load_3d(st + bx * kBox, &tm_q, &full[s], bx * 64, m0, plane);
        tma_load_3d(st + C::kRows + bx * kBox, &tm_do, &full[s], bx * 64, m0,
                    plane);
        tma_load_3d(st + 2 * C::kRows + bx * kBox, &tm_o, &full[s], bx * 64,
                    m0, plane);
      }
    }
    if (tid < kBlockM) {
      const bool ok = m0 + tid < Sq;
      cp_async4(st + C::kSRows + tid * 4,
                lse + (size_t)plane * Sq + (ok ? m0 + tid : 0), ok);
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
  const int lrow = wg * 64 + warp * 16 + g;  // this thread's two kv rows in
  const int kv0 = n0 + lrow;                 // the CTA: lrow, lrow + 8
  const int kv1 = kv0 + 8;
  const uint32_t kaddr = smem_u32(smem + C::kK + wg * C::kRows);
  const uint32_t vaddr = smem_u32(smem + C::kV + wg * C::kRows);
  const uint32_t kscaddr = smem_u32(smem + C::kKsc);
  unsigned char* ds_t = smem + C::kDs;
  const uint32_t dsaddr = smem_u32(ds_t);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float st_[C::kQW / 2], dpt[C::kQW / 2];
#pragma unroll
  for (int i = 0; i < C::kQW / 2; ++i) st_[i] = dpt[i] = 0.f;
  float dqa[D / 4];  // dq: 64 q rows x this warpgroup's D / 2 columns
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dqa[i] = 0.f;
  const int kt = n0 / kBlockN;  // this CTA's turn on every q tile it visits

  // k_sc = bf16(k * scale) beside K, once, 16 bytes a thread.
  mbar_wait(kvbar, 0);
  for (int i = tid; i < kWG * C::kRows / 16; i += kThreads) {
    uint4 raw = reinterpret_cast<const uint4*>(smem + C::kK)[i];
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      w[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    reinterpret_cast<uint4*>(smem + C::kKsc)[i] = raw;
  }

  for (int it = 0; it < ntile; ++it) {
    const int s = it % C::kStages;
    unsigned char* stg = smem + C::kStage0 + s * C::kStage;
    float* rows = reinterpret_cast<float*>(stg + C::kSRows);
    cp_async_wait<0>();  // this thread's lse row of tile it
    if (tid < kBlockM) rows[tid] = __fmul_rn(rows[tid], kLog2e);
    mbar_wait(&full[s], (it / C::kStages) & 1);

    // One pass, 16 bytes a thread: delta = rowsum(dO * O), then qs =
    // bf16(q * scale * log2 e) over O and q_sc = bf16(q * scale) over q.
    // Chunk i is row (i % 512) / 8 of box i / 512 in all three tiles, so a
    // thread's chunks fall in rows tid / 8 (even passes) and tid / 8 + 32
    // (odd), and the 8 lanes tid / 8 * 8 .. + 7 hold all of a row's.
    float dl[2] = {0.f, 0.f};
#pragma unroll
    for (int m = 0; m < C::kRows / 16 / kThreads; ++m) {
      const int i = tid + m * kThreads;
      uint4 raw = reinterpret_cast<const uint4*>(stg)[i];
      uint4 qs = raw;
      const uint4 dor = reinterpret_cast<const uint4*>(stg + C::kRows)[i];
      const uint4 orow = reinterpret_cast<const uint4*>(stg + 2 * C::kRows)[i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
      uint32_t* ws = reinterpret_cast<uint32_t*>(&qs);
      const uint32_t* wd = reinterpret_cast<const uint32_t*>(&dor);
      const uint32_t* wo = reinterpret_cast<const uint32_t*>(&orow);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w[e]);
        const float2 fd = unpack_bf16(wd[e]), fo = unpack_bf16(wo[e]);
        dl[m & 1] += fd.x * fo.x + fd.y * fo.y;
        ws[e] = pack_bf16(f.x * scale2, f.y * scale2);
        w[e] = pack_bf16(f.x * scale, f.y * scale);
      }
      reinterpret_cast<uint4*>(stg + 2 * C::kRows)[i] = qs;
      reinterpret_cast<uint4*>(stg)[i] = raw;
    }
#pragma unroll
    for (int x = 1; x < 8; x <<= 1) {
      dl[0] += __shfl_xor_sync(0xffffffffu, dl[0], x);
      dl[1] += __shfl_xor_sync(0xffffffffu, dl[1], x);
    }
    if ((tid & 7) == 0) {
      rows[kBlockM + tid / 8] = dl[0];
      rows[kBlockM + tid / 8 + 32] = dl[1];
    }
    fence_proxy_async();  // the generic writes, before wgmma reads them
    // Every thread is done with tile it - 1 (its stage, ds^T and dq
    // products), and tile it's qs, q_sc and rows are in: tile it + 1 loads
    // into the stage tile it - 1 held.
    __syncthreads();
    if (it + 1 < ntile) stage_in(it + 1);
    cp_async_commit();

    const int m0 = m0_of(it);
    const uint32_t qaddr = smem_u32(stg);  // q_sc
    const uint32_t doaddr = qaddr + C::kRows;
    const uint32_t qsaddr = qaddr + 2 * C::kRows;
    uint32_t pa[C::kQW / 16][4], da_[C::kQW / 16][4];
    if (live && !(causal && m0 + kBlockM - 1 < c0)) {
      // The diagonal tile and ragged tiles take the mask.
      const bool masked = (causal && m0 < c0 + 63) || m0 + kBlockM > Sq ||
                          c0 + 64 > Skv;
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

        // bf16(p)^T and bf16(ds)^T, packed as A fragments; bf16(ds)^T also
        // to shared memory, [kv row][q column], 128-byte swizzle.
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
            dsv[e] = pv[e] * (dpt[4 * nt + e] - rows[kBlockM + ql]);
          }
          const uint32_t d0 = pack_bf16(dsv[0], dsv[1]);
          const uint32_t d1 = pack_bf16(dsv[2], dsv[3]);
          pa[nt / 2][(nt & 1) * 2] = pack_bf16(pv[0], pv[1]);
          pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
          da_[nt / 2][(nt & 1) * 2] = d0;
          da_[nt / 2][(nt & 1) * 2 + 1] = d1;
          const int chunk = qc / 8 + nt;  // 16-byte chunk of the q row
          const int sw = (chunk ^ g) * 16 + 4 * t;  // lrow % 8 == g
          *reinterpret_cast<uint32_t*>(ds_t + lrow * 128 + sw) = d0;
          *reinterpret_cast<uint32_t*>(ds_t + (lrow + 8) * 128 + sw) = d1;
        }

        // dv += bf16(p)^T . dO and dk += bf16(ds)^T . q_sc, dO and q_sc
        // read MN-major: q rows qc + 16 kk .. + 15. The last part's run on
        // while ds^T is shared and dq is issued; each earlier part's end
        // here, before the next part reuses pa and da_.
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
        if (part + 1 < C::kParts) {
          wgmma_wait<0>();
          fence_regs(pa);
          fence_regs(da_);
        }
      }
    } else {
      // Nothing of this tile reaches these kv rows: zeros in their ds^T.
      uint4* z = reinterpret_cast<uint4*>(ds_t + wg * 64 * 128);
      for (int i = tid & 127; i < 64 * 128 / 16; i += 128)
        z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();  // ds^T's generic writes, before wgmma reads them
    __syncthreads();      // both warpgroups' ds^T rows are in

    // dq[64 q rows, columns wg * D/2 ..] = bf16(ds) . k_sc: A = ds^T read
    // MN-major (M = q contiguous), B = k_sc read MN-major, K = 128 kv rows.
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint64_t da = wgmma_desc(dsaddr + kk * 2048, kBox, 1024);
      if constexpr (D == 64) {
        const uint64_t db =
            wgmma_desc(kscaddr + kk * 2048 + wg * 64, kBox, 1024);
        wgmma_m64n32k16_ss<1, 1>(dqa, da, db, kk > 0);
      } else {
        const uint64_t db = wgmma_desc(
            kscaddr + (kk / 4) * C::kRows + wg * kBox + (kk % 4) * 2048, kBox,
            1024);
        wgmma_m64n64k16_ss<1, 1>(dqa, da, db, kk > 0);
      }
    }
    wgmma_commit();
    int* turn = dq_sem + ((size_t)plane_of(it) * nqt + m0 / kBlockM) *
                             kDqTurns + wg * 4 + warp;
    turn_wait(turn, kt);  // polled while the product runs
    wgmma_wait<0>();  // dq, and dv/dk of the last part
    fence_regs(dqa);
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da_);

    // dq's f32 sum across CTAs, in kv-tile order: this warp's turn on its
    // 16 rows x D / 2 columns is the CTA's kv tile. Lanes t and t ^ 1 trade
    // halves, so that each holds 4 adjacent columns of one row (row g for
    // even t, g + 8 for odd): one float4 where there were two float2.
    float* base = dq_acc + (size_t)plane_of(it) * Sq * D + wg * (D / 2);
    const bool odd = t & 1;
    const int row = m0 + warp * 16 + g + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float rx = __shfl_xor_sync(
          0xffffffffu, odd ? dqa[4 * j] : dqa[4 * j + 2], 1);
      const float ry = __shfl_xor_sync(
          0xffffffffu, odd ? dqa[4 * j + 1] : dqa[4 * j + 3], 1);
      const float4 val =
          odd ? make_float4(rx, ry, dqa[4 * j + 2], dqa[4 * j + 3])
              : make_float4(dqa[4 * j], dqa[4 * j + 1], rx, ry);
      if (row < Sq)
        atomicAdd(reinterpret_cast<float4*>(base + (size_t)row * D + j * 8 +
                                            4 * (t >> 1)),
                  val);
    }
    turn_pass(turn);
  }

  // dk and dv of the kv head: f32 over every q head, rounded once.
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int kv = hi ? kv1 : kv0;
      if (kv < Skv) {
        const size_t off = ((size_t)plane_kv * Skv + kv) * D + col;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(dka[4 * dt + 2 * hi], dka[4 * dt + 2 * hi + 1]);
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(dva[4 * dt + 2 * hi], dva[4 * dt + 2 * hi + 1]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const void* out, float* dq_acc, int* dq_sem,
           void* dk, void* dv, int B, int H, int Hkv, int Sq, int Skv,
           float scale, float scale2, int causal, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::kSmem;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap tq, tdo, to, tk, tv;
  int err = rtt_make_tile_map(&tq, q, B * H, Sq, D);
  if (err == 0) err = rtt_make_tile_map(&tdo, dout, B * H, Sq, D);
  if (err == 0) err = rtt_make_tile_map(&to, out, B * H, Sq, D);
  if (err == 0) err = rtt_make_tile_map(&tk, k, B * Hkv, Skv, D);
  if (err == 0) err = rtt_make_tile_map(&tv, v, B * Hkv, Skv, D);
  if (err) return err;
  const int grid = ((Skv + kBlockN - 1) / kBlockN) * B * Hkv;
  flash_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, to, lse, dq_acc, dq_sem,
      static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B * Hkv, H, Hkv, Sq, Skv, scale,
      scale2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* out, void* dq_acc, void* dq_sem,
                             void* dk, void* dv, int B, int H, int Hkv,
                             int Sq, int Skv, int D, float scale,
                             float scale2, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      (long long)((Skv + kBlockN - 1) / kBlockN) * B * Hkv > INT_MAX ||
      (long long)B * H > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  int* sem = static_cast<int*>(dq_sem);
  if (D == 64)
    return launch<64>(q, k, v, dout, l, out, acc, sem, dk, dv, B, H, Hkv, Sq,
                      Skv, scale, scale2, causal, s);
  if (D == 128)
    return launch<128>(q, k, v, dout, l, out, acc, sem, dk, dv, B, H, Hkv, Sq,
                       Skv, scale, scale2, causal, s);
  return -1;
}

extern "C" int rtt_flash_bwd_dq_turns(void) { return kDqTurns; }

extern "C" int rtt_flash_bwd_smem_bytes(int D) {
  return D == 64 ? Cfg<64>::kSmem : D == 128 ? Cfg<128>::kSmem : -1;
}

extern "C" const char* rtt_flash_bwd_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  if (code == -2) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == -3) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
