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
// a kv head, one warp per 16 rows of one head (pack*block_q/16 warps, at
// most 16). Each K/V tile is staged in padded shared memory once and read
// by the warps of all `pack` heads, where K2 (flash_fwd.cu) stages it once
// per q head and the rep heads of a kv head re-read it from L2.
//
// Arithmetic, K2's and the TPU kernels' (the plain twins are in
// ray_tpu_torch/devbench/prof_flash_pack.py):
//   qs = bf16(q * scale * log2 e); s = qs . k^T in f32 (mma.sync m16n8k16);
//   -1e30 where kpos > qpos on the tiles the schedule masks; base-2 online
//   softmax over block_k-wide tiles; p16 = bf16(p) feeds both p16 . v and
//   the row sum l; out = bf16(o / max(l, 1e-30)), lse = (m + log2 l) ln 2.
// The schedules differ only in which tiles they mask. A fully visible tile
// has nothing to mask, and a tile wholly right of a row's diagonal adds
// exp2(-1e30 - m) = 0 with alpha = 1. So for one block_k the three give
// the same bits, and at block_k 64 K2's.
//
// Bound: operations. At B4 H32 Hkv8 S2048 D64 causal the two products are
// 68.7 GFLOP, ~69 us at 989 TFLOP/s, against ~25 us for the ~84 MB that
// must move. Tiles: block_q and block_k in {64, 128}, pack in {1, 2, 4},
// pack * block_q <= 256 rows a CTA at D 64 and <= 128 at D 128. Registers
// decide those limits:
//   - a CTA of 16 warps (256 rows) has 65536 / 512 = 128 registers a
//     thread; at D 128 o alone takes 64 of them, so D 128 stops at 8 warps
//     (launch bound 256 threads: up to 255 registers, as K2 uses 168);
//   - Q fragments stay in registers (as in K2), except at D 64, block_k
//     128, where each warp re-reads them from shared memory every kv tile;
//   - at D 64, block_k 128 the s tile (64 f32 a thread) does not fit
//     beside o under 128 registers: s is computed in four 32-column
//     chunks, the first three of which wait in a per-warp f32 stash in
//     shared memory (each thread reads back what it wrote) while the last
//     is computed, so the row max covers the whole tile and p, l and p.v
//     run in the same order, with the same bits, as in one pass (two
//     64-column chunks spill 4-20 bytes at 128 registers).
// Simple first: no wgmma, TMA or cp.async; all threads stage K and V^T
// between two barriers; the heaviest causal q tiles launch first.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 256;  // pack * block_q a CTA at D 64 (16 warps)
constexpr int kMaxRowsD128 = 128;  // at D 128 (8 warps)
constexpr int kNarrowRows = 128;   // up to here a CTA runs 256 threads
constexpr int kVec = 8;  // bf16 values per 16-byte access
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
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for one m16n8k16 tile, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, int BK>
struct Cfg {
  static constexpr int LD = D + 8;    // pitch of the Q and K tiles
  static constexpr int LDV = BK + 8;  // pitch of the transposed V tile
  static constexpr bool kStash = D == 64 && BK == 128;
  static constexpr bool kQRegs = !kStash;
  static constexpr int kChunks = kStash ? 4 : 1;  // s chunks of a kv tile
  static constexpr int NT = BK / 8 / kChunks;     // 8-column n tiles a chunk
};

// Bytes of one warp's s stash: the chunks of a kv tile but the last, as
// NT x 4 f32 per lane.
template <int D, int BK>
__host__ __device__ constexpr int stash_bytes() {
  return (Cfg<D, BK>::kChunks - 1) * Cfg<D, BK>::NT * 4 * 32 * 4;
}

template <int D, int BK>
constexpr int smem_bytes(int rows) {
  return (rows * (D + 8) + BK * (D + 8) + D * (BK + 8)) * 2 +
         rows / 16 * stash_bytes<D, BK>();
}

// A warp's Q fragments (its 16 rows of one head): held in registers, or
// re-read from the staged tile at each use.
template <int D, int BK>
struct QFrag {
  static constexpr int LD = Cfg<D, BK>::LD;
  uint32_t r[Cfg<D, BK>::kQRegs ? D / 16 : 1][4];
  const __nv_bfloat16* base;  // this thread's element of sQ at kk = 0

  __device__ __forceinline__ void load(int kk, uint32_t (&a)[4]) const {
    const __nv_bfloat16* p = base + kk * 16;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * LD);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * LD + 8);
  }
  __device__ __forceinline__ void init(const __nv_bfloat16* p) {
    base = p;
    if constexpr (Cfg<D, BK>::kQRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load(kk, r[kk]);
    }
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&a)[4]) const {
    if constexpr (Cfg<D, BK>::kQRegs) {
      a[0] = r[kk][0];
      a[1] = r[kk][1];
      a[2] = r[kk][2];
      a[3] = r[kk][3];
    } else {
      load(kk, a);
    }
  }
};

// s = qs . k^T for this warp's 16 rows and the staged K tile's columns
// [c0, c0 + 8*NT). MASKED: -1e30 where col_base + column > row0 (+8 for a
// thread's second row); the caller passes global positions, or K9's local
// ones on the diagonal tile.
template <int D, int BK, bool MASKED>
__device__ __forceinline__ void scores(float (&s)[Cfg<D, BK>::NT][4],
                                       const QFrag<D, BK>& qf,
                                       const __nv_bfloat16* sK, int c0, int g,
                                       int t, int row0, int col_base) {
  constexpr int NT = Cfg<D, BK>::NT;
  constexpr int LD = Cfg<D, BK>::LD;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    qf.get(kk, a);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* p = sK + (c0 + nt * 8 + g) * LD + kk * 16 + 2 * t;
      mma16816(s[nt], a, ld32(p), ld32(p + 8));
    }
  }
  if constexpr (MASKED) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col_base + c0 + nt * 8 + 2 * t + (e & 1);
        if (col > row0 + (e < 2 ? 0 : 8)) s[nt][e] = kNegInf;
      }
    }
  }
}

// One kv tile of the online softmax for this warp's 16 rows. ``stash``
// is this warp's f32 stash (kStash only), indexed by lane so that every
// thread reads back exactly what it wrote.
template <int D, int BK, bool MASKED>
__device__ __forceinline__ void kv_step(const QFrag<D, BK>& qf,
                                        const __nv_bfloat16* sK,
                                        const __nv_bfloat16* sVt,
                                        float* stash, int lane,
                                        float (&o)[D / 8][4], float (&m_run)[2],
                                        float (&l_run)[2], int g, int t,
                                        int row0, int col_base) {
  using C = Cfg<D, BK>;
  constexpr int NT = C::NT;
  constexpr int LDV = C::LDV;
  float s[NT][4];
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int ch = 0; ch < C::kChunks; ++ch) {
    scores<D, BK, MASKED>(s, qf, sK, ch * NT * 8, g, t, row0, col_base);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      if (ch < C::kChunks - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          stash[((ch * NT + nt) * 4 + e) * 32 + lane] = s[nt][e];
      }
    }
  }
  const float mn0 = fmaxf(m_run[0], quad_max(mx0));
  const float mn1 = fmaxf(m_run[1], quad_max(mx1));
  const float alpha0 = exp2f(m_run[0] - mn0);
  const float alpha1 = exp2f(m_run[1] - mn1);
  m_run[0] = mn0;
  m_run[1] = mn1;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    o[dt][0] *= alpha0;
    o[dt][1] *= alpha0;
    o[dt][2] *= alpha1;
    o[dt][3] *= alpha1;
  }

  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int ch = 0; ch < C::kChunks; ++ch) {
    // p in bf16; l sums exactly the rounded values that multiply v. The
    // last chunk's s is still in registers, the earlier ones in the stash.
    uint32_t pk[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = ch < C::kChunks - 1
                   ? stash[((ch * NT + nt) * 4 + e) * 32 + lane]
                   : s[nt][e];
      pk[nt][0] = pack_bf16(exp2f(x[0] - mn0), exp2f(x[1] - mn0));
      pk[nt][1] = pack_bf16(exp2f(x[2] - mn1), exp2f(x[3] - mn1));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&pk[nt][0]));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&pk[nt][1]));
      sum0 += a.x + a.y;
      sum1 += c.x + c.y;
    }
    // o += p16 . v: the s accumulators of two n tiles are one A fragment.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                             pk[2 * kk + 1][1]};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* p =
            sVt + (dt * 8 + g) * LDV + ch * NT * 8 + kk * 16 + 2 * t;
        mma16816(o[dt], a, ld32(p), ld32(p + 8));
      }
    }
  }
  l_run[0] = l_run[0] * alpha0 + quad_sum(sum0);
  l_run[1] = l_run[1] * alpha1 + quad_sum(sum1);
}

// WIDE: a CTA of more than kNarrowRows rows (D 64 only), up to 16 warps
// and so 128 registers a thread; otherwise up to 8 warps and 255.
template <int D, int BK, int SCHED, bool WIDE>
__global__ void __launch_bounds__(WIDE ? kMaxRows * 2 : kNarrowRows * 2)
    packed_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      int H, int rep, int S, int pack, int block_q,
                      float scale2, int causal) {
  using C = Cfg<D, BK>;
  constexpr int LD = C::LD;
  constexpr int LDV = C::LDV;
  constexpr int ROW_VECS = D / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = pack * block_q;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + rows * LD;
  __nv_bfloat16* sVt = sK + BK * LD;
  float* stash = reinterpret_cast<float*>(sVt + D * LDV);

  // A linear grid over (pack of heads, q tile), q tile fastest: the order
  // of the former (q tiles, B * H / pack) grid, with no 65535 limit.
  const int nq = S / block_q;
  const int qx = blockIdx.x % nq;
  const int qi = causal ? nq - 1 - qx : qx;  // heavy first
  const int m0 = qi * block_q;
  const int bh0 = (blockIdx.x / nq) * pack;  // flat (batch, q head) of head 0 of the pack
  const int hk = (bh0 % H) / rep;
  const size_t kv_base = ((size_t)(bh0 / H) * (H / rep) + hk) * S * D;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within an 8-row group of a fragment
  const int t = lane & 3;   // column pair within a fragment
  const int head = warp / (block_q / 16);       // this warp's head in the pack
  const int wr = (warp % (block_q / 16)) * 16;  // its first row in the q tile

  // Q tiles of the pack's heads, pre-scaled and rounded to bf16 once; CTA
  // row r is row r % block_q of head r / block_q.
  for (int i = tid; i < rows * ROW_VECS; i += nthreads) {
    const int r = i / ROW_VECS, c = (i % ROW_VECS) * kVec;
    const size_t src =
        ((size_t)(bh0 + r / block_q) * S + m0 + r % block_q) * D + c;
    const uint4 raw = *reinterpret_cast<const uint4*>(q + src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint4 o;
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      oe[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale2);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = o;
  }
  __syncthreads();

  stash += warp * (stash_bytes<D, BK>() / 4);
  QFrag<D, BK> qf;
  qf.init(sQ + (head * block_q + wr + g) * LD + 2 * t);
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int lrow = wr + g;    // this thread's first row within the q tile
  const int grow = m0 + lrow;  // and its position in the sequence

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
  for (int j = 0; j < n_end; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * ROW_VECS; i += nthreads) {
      const int r = i / ROW_VECS, c = (i % ROW_VECS) * kVec;
      const size_t off = kv_base + (size_t)(j * BK + r) * D + c;
      *reinterpret_cast<uint4*>(sK + r * LD + c) =
          *reinterpret_cast<const uint4*>(k + off);
      const uint4 vr = *reinterpret_cast<const uint4*>(v + off);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int jj = 0; jj < kVec; ++jj) sVt[(c + jj) * LDV + r] = ve[jj];
    }
    __syncthreads();
    if (j < n_free) {
      kv_step<D, BK, false>(qf, sK, sVt, stash, lane, o, m_run, l_run, g, t,
                            0, 0);
    } else if constexpr (SCHED == kInline) {
      // The diagonal tile: local row against local column, for every qi.
      kv_step<D, BK, true>(qf, sK, sVt, stash, lane, o, m_run, l_run, g, t,
                           lrow, 0);
    } else {
      kv_step<D, BK, true>(qf, sK, sVt, stash, lane, o, m_run, l_run, g, t,
                           grow, j * BK);
    }
  }

  const float l0 = fmaxf(l_run[0], 1e-30f);
  const float l1 = fmaxf(l_run[1], 1e-30f);
  const size_t row_base = (size_t)(bh0 + head) * S + grow;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + row_base * D + col) =
        pack_bf16(o[dt][0] / l0, o[dt][1] / l0);
    *reinterpret_cast<uint32_t*>(out + (row_base + 8) * D + col) =
        pack_bf16(o[dt][2] / l1, o[dt][3] / l1);
  }
  if (t == 0) {
    lse[row_base] = (m_run[0] + log2f(l0)) * kLn2;
    lse[row_base + 8] = (m_run[1] + log2f(l1)) * kLn2;
  }
}

template <int D, int BK, int SCHED, bool WIDE>
cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int H, int Hkv, int S,
                          int pack, int block_q, float scale2, int causal,
                          cudaStream_t stream) {
  static bool smem_set = false;  // once per process, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_fwd_kernel<D, BK, SCHED, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D, BK>(WIDE ? kMaxRows : kNarrowRows));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int rows = pack * block_q;
  const int grid = (S / block_q) * (B * H / pack);
  packed_fwd_kernel<D, BK, SCHED, WIDE><<<grid, rows / 16 * 32,
                                          smem_bytes<D, BK>(rows), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, H, H / Hkv, S, pack, block_q, scale2, causal);
  return cudaGetLastError();
}

template <int D, int BK, int SCHED>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Hkv, int S, int pack,
                   int block_q, float scale2, int causal,
                   cudaStream_t stream) {
  if constexpr (D == 64) {
    if (pack * block_q > kNarrowRows)
      return launch_kernel<D, BK, SCHED, true>(q, k, v, out, lse, B, H, Hkv,
                                               S, pack, block_q, scale2,
                                               causal, stream);
  }
  return launch_kernel<D, BK, SCHED, false>(q, k, v, out, lse, B, H, Hkv, S,
                                            pack, block_q, scale2, causal,
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
  if (D == 64) return block_k == 64 ? smem_bytes<64, 64>(rows)
                    : block_k == 128 ? smem_bytes<64, 128>(rows) : -1;
  if (D == 128) return block_k == 64 ? smem_bytes<128, 64>(rows)
                     : block_k == 128 ? smem_bytes<128, 128>(rows) : -1;
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
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
