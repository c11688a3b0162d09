// Fused backward of the ring-attention chunk step for Hopper (sm_90a): dq,
// dk and dv of local q against one visiting K/V chunk, from the forward's
// saved logsumexp and the cotangents of BOTH outputs (out and lse), masked
// by GLOBAL positions loaded at run time, dk/dv folded to the kv heads.
//
// Replaces the Pallas kernel _flash_chunk_bwd_kernel
// (ray_tpu/ops/attention.py:779). That kernel ran a grid over (q heads, q
// blocks) and carried each q head's dk/dv in VMEM scratch across the
// *sequential* q axis, in a full pass. Hopper runs CTAs in parallel and in
// no order, so the design is FlashAttention-2's: one CTA of 8 warps per
// (batch, kv head, 128-row kv tile) loops over the rep q heads of that kv
// head and over the 64-row q tiles it needs, keeps dk/dv for its tile in
// f32 registers (each warp owns 16 kv rows), so the GQA fold costs
// nothing, and adds each q tile's dq contribution into an f32 buffer in
// ascending kv-tile order (below), so that dq, dk and dv are the same bits
// on every run, as the TPU kernel's are. The caller casts that buffer. The
// TPU kernel
// rounds each q head's dk/dv to bf16 before the wrapper's f32 fold; this
// kernel folds in f32 and rounds once (the twin does the same).
//
// Bound: operations, over the (q, k) pairs the mask keeps: five products,
// 2750 GFLOP at the CP step's shape (B1 H32 Hkv8 S16384 D64, positions
// 0..S-1, causal), 2.78 ms at 989 TFLOP/s. What the design does about it:
// - Tile classes, from the pre-pass's bounds (chunk_tile_bounds.cu): a q
//   tile whose every position is below the CTA's least kv position (kmin >
//   qmax) is skipped, unless it holds a row that sees no key of the chunk
//   (qmin < cmin, the chunk's min kpos), which is visited as before. The
//   skip is exact: there p = exp2(-1e30 - lse * log2 e) = 0, so ds = 0 and
//   dv, dk and dq each add 0. A visible pair (kmax <= qmin, both tiles
//   whole) takes no mask; a partial one masks per element. The grid puts
//   the first kv tiles (the longest under causal positions) first.
// - Asynchronous staging: q, dO, lse, g_lse, delta and qpos of the next q
//   tile load by cp.async into the other of two stages while this one
//   computes. No transposed copies: every fragment comes from row-major
//   tiles through ldmatrix (.trans for p^T . dO, ds^T . q_sc and ds . k_sc),
//   in shared memory padded to 8 rows a bank cycle.
// - qs = bf16(q * scale * log2 e) and q_sc = bf16(q * scale) are made once
//   per staged q tile, 16 bytes a thread, in shared memory; k_sc = bf16(k *
//   scale) once per CTA.
// - 128 kv rows per CTA, so each staged q tile serves 128 kv rows, and dq's
//   product is split over the 8 warps (16 q rows x D/2 columns each). At D
//   128 a warp takes the q tile in two halves of 32 columns, so that s, dp,
//   dk and dv fit in its registers without a spill.
// - dq across CTAs, in a fixed order, as K3 (flash_bwd.cu) sums it: each
//   warp owns 16 q rows x D / 2 columns of a q tile's dq and one turn
//   counter for them (dq_sem, [B, H, q tiles, 8 warps] int32, zeroed by
//   the wrapper with the f32 buffer). A CTA's turn on a q tile is the
//   number of lower kv tiles that visit it, counted from the pre-pass's
//   bounds with the same test the visit takes (a warp ballot over 32 kv
//   tiles at a time), so a skipped pair holds no turn and the waiter
//   never waits for it. The CTA waits until the counter reads its turn,
//   adds its part by float2 reductions (red.global.add), fences until they
//   have landed and passes the turn. No deadlock: a CTA waits only on CTAs
//   of lower kv tiles (blockIdx.z), whose linear block indices are lower;
//   blocks are dispatched in ascending linear order. The f32 atomics this
//   replaced summed in arrival order; the designs tried on the way and
//   their times are in PERF.md.
// Products by mma.sync m16n8k16 (bf16 in, f32 accumulate). Not yet: wgmma
// (the register budget of dk, dv, s and dp at D 128 needs warp
// specialisation with setmaxnreg), TMA.
//
// Arithmetic, kept identical to the TPU kernel and to the plain twin
// flash_chunk_bwd_plain in ray_tpu_torch/ops/attention.py:
//   qs   = bf16(q * scale * log2 e)     (the forward's rounding)
//   q_sc = bf16(q * scale)   k_sc = bf16(k * scale)   (operand scale folding)
//   s    = qs . k^T (f32); causal: -1e30 where kpos > qpos
//   p    = exp2(s - lse * log2 e)
//   dp   = dO . v^T (f32); ds = p * (dp + (g_lse - delta))
//   dv  += bf16(p)^T . dO;  dk += bf16(ds)^T . q_sc;  dq += bf16(ds) . k_sc
// with delta = rowsum(g_out * out) in f32 and dO = bf16(g_out), both from
// the wrapper. lse * log2 e is stored to shared memory before the
// subtraction, so no fused multiply-add forms: on a row that saw no key,
// lse * log2 e is -1e30 exactly in f32, p = exp2(0) = 1, and since the
// combine gave that row weight 0, dO, delta and g_lse are 0 and so is ds
// (never 0 * inf). Rows and columns past the ragged ends are -inf: p = 0.
// The kernel computes the transposed products (s^T = k . qs^T, dp^T =
// v . dO^T) so that a warp's accumulator rows are its kv rows; bf16(ds)^T is
// written to shared memory once, as [kv][q], for the dq product.
//
// C interface (called through ctypes by ray_tpu_torch/ops/attention.py):
//   int rtt_flash_chunk_bwd(q, k, v, qpos, kpos, bounds, dout, lse, delta,
//                           glse, dq_acc, dq_sem, dk, dv, B, H, Hkv, Sq,
//                           Skv, D, scale, scale_log2, causal, stream)
// q/dout [B,H,Sq,D], k/v/dk/dv [B,Hkv,Skv,D] bf16 contiguous and 16-byte
// aligned; qpos [Sq], kpos [Skv] int32; bounds the pre-pass's int32
// output; lse/delta/glse [B,H,Sq] f32; dq_acc [B,H,Sq,D] f32 and dq_sem
// int32 [B * H * ceil(Sq / 64) * 8], both zeroed by the caller. D is 64 or
// 128. Returns a cudaError_t or -1 for an unsupported D.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace rtt;

constexpr int kBlockM = 64;   // q rows per staged tile
constexpr int kBlockN = 128;  // kv rows per CTA, 16 per warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDqTurns = kWarps;  // dq turn counters a q tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets. Tiles are row-major bf16 with a pitch of D + 8 (ldmatrix
// rows fall in distinct banks); a stage holds one q tile's inputs.
template <int D>
struct Smem {
  static constexpr int LD = D + 8;
  static constexpr int LDS = kBlockM + 8;  // pitch of ds^T [kv][q]
  static constexpr int K = 0;
  static constexpr int V = K + kBlockN * LD * 2;
  static constexpr int KSC = V + kBlockN * LD * 2;
  static constexpr int QSC = KSC + kBlockN * LD * 2;
  static constexpr int DST = QSC + kBlockM * LD * 2;
  static constexpr int ROWS = DST + kBlockN * LDS * 2;  // lse2, bias, qpos
  static constexpr int STAGES = ROWS + 3 * kBlockM * 4;
  // In a stage: q (made qs in place) [M][LD], dO [M][LD], then lse, g_lse,
  // delta (f32) and qpos (int32) [M] each.
  static constexpr int S_DO = kBlockM * LD * 2;
  static constexpr int S_ROWS = 2 * kBlockM * LD * 2;
  static constexpr int STAGE = S_ROWS + 4 * kBlockM * 4;
  static constexpr int BYTES = STAGES + 2 * STAGE;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_chunk_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ qpos,
                           const int* __restrict__ kpos,
                           const int* __restrict__ bounds,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ glse,
                           float* __restrict__ dq_acc,
                           int* __restrict__ dq_sem,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                           int Sq, int Skv, float scale, float scale2,
                           int causal) {
  using L = Smem<D>;
  constexpr int LD = L::LD;
  constexpr int VECS = D / 8;  // 16-byte chunks a row
  constexpr int QH = D == 128 ? 2 : 1;  // q-column parts of a q tile
  constexpr int QW = kBlockM / QH;      // q columns a part
  constexpr int NTH = QW / 8;           // 8-column chunks a part
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  __nv_bfloat16* sKsc = reinterpret_cast<__nv_bfloat16*>(smem + L::KSC);
  __nv_bfloat16* sQsc = reinterpret_cast<__nv_bfloat16*>(smem + L::QSC);
  __nv_bfloat16* sDsT = reinterpret_cast<__nv_bfloat16*>(smem + L::DST);
  float* sL = reinterpret_cast<float*>(smem + L::ROWS);
  float* sBias = sL + kBlockM;
  int* sQpos = reinterpret_cast<int*>(sBias + kBlockM);

  // Grid (B, Hkv, kv tiles): the batch on x, which has no 65535 limit.
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int n0 = blockIdx.z * kBlockN;  // first kv tiles first
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;  // this warp's kv rows
  const size_t kv_base = ((size_t)b * Hkv + hk) * Skv * D;

  const int nqt = (Sq + kBlockM - 1) / kBlockM;
  const int nk64 = (Skv + 63) / 64;
  const int2* qb = reinterpret_cast<const int2*>(bounds);
  const int2* kb = qb + nqt;
  const int cmin = bounds[2 * (nqt + nk64)];
  int2 ck = kb[n0 / 64];
  if (n0 / 64 + 1 < nk64) {
    const int2 x = kb[n0 / 64 + 1];
    ck = make_int2(min(ck.x, x.x), max(ck.y, x.y));
  }
  const bool kv_whole = n0 + kBlockN <= Skv;
  // Visit q tile mt unless it is masked for every kv row here and every
  // row of it sees some key of the chunk.
  auto visits = [&](int mt) {
    if (!causal) return true;
    const int2 x = qb[mt];
    return x.y >= ck.x || x.x < cmin;
  };
  // This CTA's turn on q tile mt: the lower kv tiles that visit it (the
  // test of visits(), for each of them), counted by the whole warp.
  const int kt = n0 / kBlockN;
  auto turn_of = [&](int mt) {
    const int2 x = qb[mt];
    if (!causal || x.x < cmin) return kt;
    int n = 0;
    for (int j0 = 0; j0 < kt; j0 += 32) {
      const int j = j0 + (threadIdx.x & 31);
      bool lower = false;
      if (j < kt) {
        int kmin = kb[2 * j].x;
        if (2 * j + 1 < nk64) kmin = min(kmin, kb[2 * j + 1].x);
        lower = x.y >= kmin;
      }
      n += __popc(__ballot_sync(0xffffffffu, lower));
    }
    return n;
  };
  auto next_tile = [&](int mt) {
    do ++mt;
    while (mt < nqt && !visits(mt));
    return mt;
  };

  // One q tile's inputs (rep head r, tile mt) into stage st.
  auto stage_in = [&](int r, int mt, int st) {
    unsigned char* base = smem + L::STAGES + st * L::STAGE;
    const int h = hk * rep + r;
    const size_t row_base = ((size_t)b * H + h) * Sq;
    const int m0 = mt * kBlockM;
    for (int i = tid; i < 2 * kBlockM * VECS; i += kThreads) {
      const int which = i / (kBlockM * VECS);  // 0: q, 1: dO
      const int rr = (i / VECS) % kBlockM, c = (i % VECS) * 8;
      const bool ok = m0 + rr < Sq;
      const size_t off = (row_base + (ok ? m0 + rr : 0)) * D + c;
      cp_async16(base + which * L::S_DO + (rr * LD + c) * 2,
                 (which ? dout : q) + off, ok);
    }
    {
      const int which = tid / kBlockM, rr = tid % kBlockM;  // 4 x 64 rows
      const bool ok = m0 + rr < Sq;
      const size_t i = ok ? m0 + rr : 0;
      const void* src = which == 0   ? (const void*)(lse + row_base + i)
                        : which == 1 ? (const void*)(glse + row_base + i)
                        : which == 2 ? (const void*)(delta + row_base + i)
                                     : (const void*)(qpos + i);
      cp_async4(base + L::S_ROWS + (which * kBlockM + rr) * 4, src, ok);
    }
  };

  // The CTA's kv tile, then the first q tile.
  for (int i = tid; i < 2 * kBlockN * VECS; i += kThreads) {
    const int which = i / (kBlockN * VECS);  // 0: k, 1: v
    const int rr = (i / VECS) % kBlockN, c = (i % VECS) * 8;
    const bool ok = n0 + rr < Skv;
    const size_t off = kv_base + (size_t)(ok ? n0 + rr : 0) * D + c;
    cp_async16((which ? sV : sK) + rr * LD + c, (which ? v : k) + off, ok);
  }
  cp_async_commit();
  int r = 0, mt = visits(0) ? 0 : next_tile(0);
  if (mt >= nqt) r = rep;  // nothing to visit: dk = dv = 0
  if (r < rep) stage_in(r, mt, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int i = tid; i < kBlockN * VECS; i += kThreads) {
    const int rr = i / VECS, c = (i % VECS) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(sK + rr * LD + c);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_bf16(w[j]);
      ow[j] = pack_bf16(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(sKsc + rr * LD + c) = o;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int kv0 = n0 + wr + g;  // this thread's two kv rows
  const int kv1 = kv0 + 8;
  const int kp0 = kv0 < Skv ? kpos[kv0] : 0;  // rows past Skv are -inf
  const int kp1 = kv1 < Skv ? kpos[kv1] : 0;
  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8.
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;

  for (int it = 0; r < rep; ++it) {
    const int st = it & 1;
    unsigned char* base = smem + L::STAGES + st * L::STAGE;
    __nv_bfloat16* sQs = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(base + L::S_DO);
    const float* rows = reinterpret_cast<const float*>(base + L::S_ROWS);
    const int h = hk * rep + r;
    const size_t row_base = ((size_t)b * H + h) * Sq;
    const int m0 = mt * kBlockM;
    const int2 qt = qb[mt];
    const bool visible =
        !causal ? (kv_whole && m0 + kBlockM <= Sq)
                : (ck.y <= qt.x && kv_whole && m0 + kBlockM <= Sq);

    cp_async_wait<0>();
    __syncthreads();  // this stage landed; the previous tile is consumed
    int nr = r, nmt = next_tile(mt);
    if (nmt >= nqt) {
      ++nr;
      nmt = visits(0) ? 0 : next_tile(0);
    }
    if (nr < rep) stage_in(nr, nmt, st ^ 1);
    cp_async_commit();

    // qs in place and q_sc beside it; the rows' lse * log2 e and bias.
    for (int i = tid; i < kBlockM * VECS; i += kThreads) {
      const int rr = i / VECS, c = (i % VECS) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(sQs + rr * LD + c);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
      uint4 qs, qsc;
      uint32_t* a = reinterpret_cast<uint32_t*>(&qs);
      uint32_t* s = reinterpret_cast<uint32_t*>(&qsc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack_bf16(w[j]);
        a[j] = pack_bf16(f.x * scale2, f.y * scale2);
        s[j] = pack_bf16(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(sQs + rr * LD + c) = qs;
      *reinterpret_cast<uint4*>(sQsc + rr * LD + c) = qsc;
    }
    if (tid < kBlockM) {
      sL[tid] = rows[tid] * kLog2e;
      sBias[tid] = rows[kBlockM + tid] - rows[2 * kBlockM + tid];
      sQpos[tid] = reinterpret_cast<const int*>(rows)[3 * kBlockM + tid];
    }
    __syncthreads();

    // Per part of QH q-column parts (two at D 128, so that s, dp, dk and
    // dv fit in registers together): s^T = k . qs^T and dp^T = v . dO^T
    // (16 kv rows x QW q columns), p^T and ds^T, bf16(ds)^T to shared
    // memory as [kv][q], then dv += bf16(p)^T . dO and dk += bf16(ds)^T .
    // q_sc over those q rows.
#pragma unroll 1
    for (int qh = 0; qh < QH; ++qh) {
      const int qc = qh * QW;  // the part's first q column
      float st_[NTH][4], dpt[NTH][4];
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st_[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        const int aoff = (wr + lr + l8 * 8) * LD + kk * 16 + l16 * 8;
        ldmatrix_x4(ak, sK + aoff);
        ldmatrix_x4(av, sV + aoff);
#pragma unroll
        for (int np = 0; np < NTH / 2; ++np) {
          uint32_t bq[4], bo[4];
          const int boff =
              (qc + np * 16 + lr + l16 * 8) * LD + kk * 16 + l8 * 8;
          ldmatrix_x4(bq, sQs + boff);
          ldmatrix_x4(bo, sdO + boff);
          mma16816(st_[2 * np], ak, bq[0], bq[1]);
          mma16816(st_[2 * np + 1], ak, bq[2], bq[3]);
          mma16816(dpt[2 * np], av, bo[0], bo[1]);
          mma16816(dpt[2 * np + 1], av, bo[2], bo[3]);
        }
      }

      uint32_t pk[NTH][2], dsk[NTH][2];
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qc + nt * 8 + 2 * t + (e & 1);
          const bool hi = e >= 2;
          float s = st_[nt][e];
          if (!visible) {
            if (m0 + ql >= Sq || (hi ? kv1 : kv0) >= Skv)
              s = -INFINITY;  // past either end: p is exactly 0
            else if (causal && (hi ? kp1 : kp0) > sQpos[ql])
              s = kNegInf;
          }
          pv[e] = exp2f(s - sL[ql]);
          dsv[e] = pv[e] * (dpt[nt][e] + sBias[ql]);
        }
        pk[nt][0] = pack_bf16(pv[0], pv[1]);
        pk[nt][1] = pack_bf16(pv[2], pv[3]);
        dsk[nt][0] = pack_bf16(dsv[0], dsv[1]);
        dsk[nt][1] = pack_bf16(dsv[2], dsv[3]);
        const int col = qc + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(sDsT + (wr + g) * L::LDS + col) =
            dsk[nt][0];
        *reinterpret_cast<uint32_t*>(sDsT + (wr + g + 8) * L::LDS + col) =
            dsk[nt][1];
      }

#pragma unroll
      for (int kk = 0; kk < NTH / 2; ++kk) {
        const uint32_t ap[4] = {pk[2 * kk][0], pk[2 * kk][1],
                                pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
        const uint32_t as[4] = {dsk[2 * kk][0], dsk[2 * kk][1],
                                dsk[2 * kk + 1][0], dsk[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bo[4], bq[4];
          const int off =
              (qc + kk * 16 + lr + l8 * 8) * LD + dp * 16 + l16 * 8;
          ldmatrix_x4_trans(bo, sdO + off);
          ldmatrix_x4_trans(bq, sQsc + off);
          mma16816(dv_acc[2 * dp], ap, bo[0], bo[1]);
          mma16816(dv_acc[2 * dp + 1], ap, bo[2], bo[3]);
          mma16816(dk_acc[2 * dp], as, bq[0], bq[1]);
          mma16816(dk_acc[2 * dp + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // bf16(ds)^T of all eight warps is in shared memory

    // dq[16 q rows x D/2 columns a warp] += bf16(ds) . k_sc, into the f32
    // buffer.
    {
      const int mq = (warp & 3) * 16;
      const int dh = (warp >> 2) * (D / 2);
      float dq[D / 16][4];
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        dq[c][0] = dq[c][1] = dq[c][2] = dq[c][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, sDsT + (kk * 16 + lr + l16 * 8) * L::LDS + mq +
                                 l8 * 8);
#pragma unroll
        for (int dp = 0; dp < D / 32; ++dp) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, sKsc + (kk * 16 + lr + l8 * 8) * LD + dh +
                                    dp * 16 + l16 * 8);
          mma16816(dq[2 * dp], a, bk[0], bk[1]);
          mma16816(dq[2 * dp + 1], a, bk[2], bk[3]);
        }
      }
      // This warp's turn on its 16 rows x D / 2 columns of the q tile.
      const int q0 = m0 + mq + g;
      int* turn = dq_sem + (((size_t)b * H + h) * nqt + mt) * kDqTurns + warp;
      turn_wait(turn, turn_of(mt));
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int col = dh + c * 8 + 2 * t;
        if (q0 < Sq)
          atomicAdd(reinterpret_cast<float2*>(dq_acc + (row_base + q0) * D + col),
                    make_float2(dq[c][0], dq[c][1]));
        if (q0 + 8 < Sq)
          atomicAdd(
              reinterpret_cast<float2*>(dq_acc + (row_base + q0 + 8) * D + col),
              make_float2(dq[c][2], dq[c][3]));
      }
      turn_pass(turn);
    }
    r = nr;
    mt = nmt;
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (kv0 < Skv) {
      const size_t off = kv_base + (size_t)kv0 * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(dk_acc[dt][0], dk_acc[dt][1]);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (kv1 < Skv) {
      const size_t off = kv_base + (size_t)kv1 * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(dk_acc[dt][2], dk_acc[dt][3]);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qpos, const int* kpos, const int* bounds,
                   const void* dout, const float* lse, const float* delta,
                   const float* glse, float* dq_acc, int* dq_sem, void* dk,
                   void* dv, int B,
                   int H, int Hkv, int Sq, int Skv, float scale, float scale2,
                   int causal, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_chunk_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(B, Hkv, (Skv + kBlockN - 1) / kBlockN);
  flash_chunk_bwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qpos, kpos, bounds,
      static_cast<const __nv_bfloat16*>(dout), lse, delta, glse, dq_acc,
      dq_sem, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Hkv, Sq, Skv, scale, scale2,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_chunk_bwd(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kpos,
                                   const void* bounds, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* glse, void* dq_acc,
                                   void* dq_sem, void* dk, void* dv, int B,
                                   int H, int Hkv, int Sq, int Skv, int D,
                                   float scale, float scale2, int causal,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      Hkv > 65535 || (Skv + kBlockN - 1) / kBlockN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  const int* bd = static_cast<const int*>(bounds);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* gl = static_cast<const float*>(glse);
  float* acc = static_cast<float*>(dq_acc);
  int* sem = static_cast<int*>(dq_sem);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, qp, kp, bd, dout, l, dl, gl, acc, sem, dk,
                        dv, B, H, Hkv, Sq, Skv, scale, scale2, causal, s);
    case 128:
      return launch<128>(q, k, v, qp, kp, bd, dout, l, dl, gl, acc, sem, dk,
                         dv, B, H, Hkv, Sq, Skv, scale, scale2, causal, s);
    default:
      return -1;
  }
}

extern "C" int rtt_flash_chunk_bwd_dq_turns(void) { return kDqTurns; }

extern "C" int rtt_flash_chunk_bwd_smem_bytes(int D) {
  return D == 64 ? Smem<64>::BYTES : D == 128 ? Smem<128>::BYTES : -1;
}

extern "C" const char* rtt_flash_chunk_bwd_error_string(int code) {
  if (code == -1) return "unsupported head_dim (64 or 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
