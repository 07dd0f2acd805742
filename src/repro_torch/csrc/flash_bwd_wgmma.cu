// Flash attention backward on the tensor cores, bf16, head_dim 64 or 128
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py
//   * flash_backward -> _dq_kernel  (:156, pallas_call at :245)
//   * flash_backward -> _dkv_kernel (:191, pallas_call at :271) with the
//     sum over each KV head's G query heads (:301-302)
// for bf16 inputs at head_dim 64 and 128; f32 inputs and other head_dims
// stay on flash_dq_kernel / flash_dkv_kernel of csrc/flash_attention.cu.
// What they compute is that file's contract (flash_attention.cu:7-26):
// q, o, do, dq [B, H, S, hd] and k, v, dk, dv [B, KH, T, hd], each read and
// written through its (batch, head, row) strides, so the model layout
// [B, S, H, hd] is used in place; lse and delta = Σ do·o [B, H, S] f32
// contiguous (delta from the wrapper, as the reference computes it outside
// Pallas, :242-243); query head h reads KV head h / G;
//   p  = exp(s·scale − lse), selected where live(q, k) (never multiplied
//        by a 0/1 mask: a dead row's s − lse overflows), else 0;
//   ds = p·(dp − delta)·scale with dp = do·vᵀ;
//   dq = Σ_k ds·k;  dv = Σ pᵀ·do and dk = Σ dsᵀ·q over the G query heads
//        of the KV head, summed in f32 and stored once in k's dtype;
// rows with no live key give zero gradients; k-tiles (q-tiles) in which
// nothing can be live are skipped.
//
// Numerics. Every product sums bf16 operands in f32. p and ds are f32, and
// rounded to bf16 where they are the A operand of a product (ds·k, pᵀ·do,
// dsᵀ·q): the one change from the FMA kernels, which keep them in f32, as
// the forward rounds p for p·v. The exponent runs in log2 units (exp2 of
// s·scale·log2 e − lse·log2 e), which moves p by ~1e-7 relative.
//
// Design (shared tiles are stacks of 64-column chunks stored by TMA with
// the 128-byte swizzle, sm90.cuh; tile skipping and masks, flash_sm90.cuh):
//   * dq (warp-specialised, as flash_fwd_wgmma.cu). A block owns QR =
//     64 * NWG query rows of one (b, h): NWG consumer warpgroups of 64
//     rows and a producer warp. The producer loads Q and dO once, then
//     streams the K and V tiles (64 rows) of every live k-tile through a
//     ring of STAGES stages. Per k-tile a warpgroup forms S = Q·Kᵀ and
//     dP = dO·Vᵀ (wgmma m64n64k16, all four operands K-major, one commit
//     group), P and dS in the accumulator registers (lse and delta per
//     row, read once), and dQ += dS·K (dS packed to bf16 as the register A
//     operand; K read MN-major with the transpose flag, as the forward
//     reads V). The q-tile is the slowest grid axis, taken last to first:
//     under a causal mask the heaviest blocks start first.
//   * dk/dv. A block owns 64 key rows of one (b, KV head) and keeps K and
//     V in shared memory. Its items are the G query heads x the run of
//     q-tiles (64 rows) that can see the key tile; two consumer
//     warpgroups take alternate items. The transposed problem keeps the
//     key rows as M: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (K-major), Pᵀ and dSᵀ with
//     lse and delta per column (each thread's 16 columns of the
//     accumulator map, read from shared memory), dV += Pᵀ·dO and
//     dK += dSᵀ·Q (register A operands; dO and Q read MN-major, so the one
//     stored tile serves both readings, as K and V do in the forward).
//     Registers bound the design: dK, dV, Sᵀ and dPᵀ hold 192 f32 a thread
//     at hd 128. A block of two warpgroups and a producer warp is given
//     registers as 384 threads, 168 each, and spilled 1 KB a thread; so
//     the block is the two warpgroups alone (256 threads, up to 255
//     registers), and warp 0 of each loads that warpgroup's own items
//     into its own ring of RING stages: the next item's lse and delta into
//     registers a step ahead, then, once the warpgroup has finished with
//     the stage (a named barrier), the stage's lse and delta and, by TMA,
//     its Q and dO. At the end warpgroup 1 hands its f32 dK and dV through
//     shared memory and warpgroup 0 adds them in a fixed order and
//     stores: no atomics, no per-head scratch, the result is
//     deterministic. The k-tile is the slowest grid axis, first to last:
//     under a causal mask the first key tiles see the most q-tiles.
//   * In dq a warpgroup whose rows see no live pair in a k-tile skips its
//     products but still waits for and releases the stage, so the ring
//     stays in step. A tile in which every pair is live skips the mask.
//
// Bound on the card: at the training shapes (8 x 256 causal, 16 heads, 4
// KV heads, hd 128) dq moves ~30 MB (0.0088 ms at 3.35 TB/s) and dk/dv
// ~25 MB (0.0076 ms) against ~3.3 / 4.4 GFLOP of needed products (0.0034 /
// 0.0045 ms at 989 TFLOP/s): bytes bound both. At 2 x 1024 the products
// bound them (0.013 / 0.017 ms).
// Not done yet: overlap of one tile's elementwise work with the next
// tile's products, 128-row tiles, a persistent grid, and one kernel for
// dq and dk/dv.

#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;
using namespace flash90;

constexpr int STAGES = 3;  // K/V tiles in flight in dq
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long base,
                                           long long row_stride, int row0,
                                           int col0, int rows,
                                           const float (&acc)[D / 2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    if (row >= rows) continue;
    bf16* dst = out + base + (long long)row * row_stride;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + col0) =
          __floats2bfloat162_rn(acc[4 * i + 2 * j], acc[4 * i + 2 * j + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D, int NWG>
struct DqTiles {
  static constexpr int QR = 64 * NWG;
  static constexpr int CHUNKS = D / 64;
  static constexpr int Q_BYTES = QR * D * 2;   // one of Q, dO
  static constexpr int KV_BYTES = KR * D * 2;  // one of K, V
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int THREADS = 128 * NWG + 32;
  // Q, dO, the stages, barriers (q_full, full[s], empty[s]), alignment.
  static constexpr int SMEM =
      2 * Q_BYTES + STAGES * STAGE + 8 * (1 + 2 * STAGES) + 1024;
};

// P and dS of one k-tile from the score registers sc (S) and dp (dP) of
// this thread's rows row0, row0 + 8 and columns k0 + 8 (t / 4) + col0 +
// t % 2 (sm90.cuh's accumulator map); dS packed to bf16 in da, the
// register A operand of dS·K. lse2 is lse·log2 e of the two rows, dl their
// delta.
template <bool MASKED>
__device__ __forceinline__ void dq_scores(
    const float (&sc)[KR / 2], const float (&dp)[KR / 2],
    uint32_t (&da)[KR / 16][4], int row0, int col0, int k0,
    const float (&lse2)[2], const float (&dl)[2], int q_len, int kv_len,
    int causal, int window, float scale) {
  const float sl = scale * kLog2e;
#pragma unroll
  for (int t = 0; t < KR / 2; t += 2) {
    const int j = (t / 2) % 2;
    float ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p = exp2f(sc[t + e] * sl - lse2[j]);
      if (MASKED && !live(row0 + 8 * j, k0 + 8 * (t / 4) + col0 + e, q_len,
                          kv_len, causal, window))
        p = 0.f;
      ds[e] = p * (dp[t + e] - dl[j]) * scale;
    }
    // registers 8 kk + 2 q + {0, 1} -> a[q] of k step kk
    da[t / 8][(t % 8) / 2] = pack_bf16(ds[0], ds[1]);
  }
}

template <int D, int NWG>
__global__ void __launch_bounds__(DqTiles<D, NWG>::THREADS, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      Layout lo, int H, int KH, int S, int q_len, int kv_len,
                      int causal, int window, float scale) {
  using TL = DqTiles<D, NWG>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + TL::Q_BYTES;
  const uint32_t kv_s = do_s + TL::Q_BYTES;
  const uint32_t bars = kv_s + STAGES * TL::STAGE;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int q0 = (gridDim.z - 1 - blockIdx.z) * TL::QR;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_kt = q0 < q_len ? (kv_len + KR - 1) / KR : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer warp: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * TL::Q_BYTES);
#pragma unroll
      for (int c = 0; c < TL::CHUNKS; ++c) {
        tma_load_4d(q_s + c * TL::QR * 128, &q_map, q_full, 64 * c, q0, h, b);
        tma_load_4d(do_s + c * TL::QR * 128, &do_map, q_full, 64 * c, q0, h,
                    b);
      }
      int it = 0;
      for (int ik = 0; ik < n_kt; ++ik) {
        const int k0 = ik * KR;
        if (!tile_live(q0, TL::QR, k0, causal, window)) continue;
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const uint32_t ks = kv_s + s * TL::STAGE, vs = ks + TL::KV_BYTES;
        mbar_expect_tx(full(s), TL::STAGE);
#pragma unroll
        for (int c = 0; c < TL::CHUNKS; ++c) {
          tma_load_4d(ks + c * KR * 128, &k_map, full(s), 64 * c, k0, kh, b);
          tma_load_4d(vs + c * KR * 128, &v_map, full(s), 64 * c, k0, kh, b);
        }
        ++it;
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows qw .. qw + 63; this thread's rows are row0
  // and row0 + 8.
  const int wg = warp / 4;
  const int qw = q0 + 64 * wg;
  const int row0 = qw + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  float lse2[2], dl[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    const long long at = ((long long)b * H + h) * S + row;
    lse2[j] = row < S ? lse[at] * kLog2e : 0.f;
    dl[j] = row < S ? delta[at] : 0.f;
  }
  float acc[D / 2];
  zero(acc);

  mbar_wait(q_full, 0);
  const uint32_t qa = q_s + wg * 64 * 128, doa = do_s + wg * 64 * 128;
  int it = 0;
  for (int ik = 0; ik < n_kt; ++ik) {
    const int k0 = ik * KR;
    if (!tile_live(q0, TL::QR, k0, causal, window)) continue;
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    ++it;
    if (qw < q_len && tile_live(qw, 64, k0, causal, window)) {
      const uint32_t ks = kv_s + s * TL::STAGE, vs = ks + TL::KV_BYTES;
      float sc[KR / 2], dp[KR / 2];
      zero(sc);
      zero(dp);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns into the chunk
        mma_ss<0>(sc, desc_k(qa + (kk / 4) * TL::QR * 128 + off),
                  desc_k(ks + (kk / 4) * KR * 128 + off));
        mma_ss<0>(dp, desc_k(doa + (kk / 4) * TL::QR * 128 + off),
                  desc_k(vs + (kk / 4) * KR * 128 + off));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      uint32_t da[KR / 16][4];
      if (tile_full(qw, k0, q_len, kv_len, causal, window))
        dq_scores<false>(sc, dp, da, row0, col0, k0, lse2, dl, q_len, kv_len,
                         causal, window, scale);
      else
        dq_scores<true>(sc, dp, da, row0, col0, k0, lse2, dl, q_len, kv_len,
                        causal, window, scale);

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk)
        mma_rs<1>(acc, da[kk], desc_mn(ks + kk * 2048, KR * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  store_rows<D>(dq, (long long)b * lo.b + (long long)h * lo.h, lo.s, row0,
                col0, S, acc);
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvTiles {
  static constexpr int CHUNKS = D / 64;
  static constexpr int KV_BYTES = KR * D * 2;  // one of K, V (the block's)
  static constexpr int Q_BYTES = KR * D * 2;   // one of Q, dO (a q-tile's)
  static constexpr int STAGE = 2 * Q_BYTES;
  static constexpr int VEC = 2 * KR;           // lse·log2 e, then delta (f32)
  static constexpr int WGS = 2;                // consumer warpgroups
  static constexpr int RING = 2;               // stages of each warpgroup
  static constexpr int THREADS = 128 * WGS;    // no producer warp
  // K, V, the WGS x RING stages, their vectors, barriers (kv_full, then
  // full[stage]), alignment.
  static constexpr int SMEM = 2 * KV_BYTES + WGS * RING * (STAGE + VEC * 4) +
                              8 * (1 + WGS * RING) + 1024;
  // warpgroup 1's dK and dV hand-over reuses the stages
  static_assert(D * 128 * 4 <= WGS * RING * STAGE, "hand-over");
};

// Pᵀ and dSᵀ of one q-tile from the score registers sc (Sᵀ) and dp (dPᵀ)
// of this thread's key rows row0, row0 + 8 and query columns q0 + 8 i +
// col0 + {0, 1}; both packed to bf16 in pa and da, the register A operands
// of Pᵀ·dO and dSᵀ·Q. lse2 and dl (shared memory) hold the q-tile's
// lse·log2 e and delta by column.
template <bool MASKED>
__device__ __forceinline__ void dkv_scores(
    const float (&sc)[KR / 2], const float (&dp)[KR / 2],
    uint32_t (&pa)[KR / 16][4], uint32_t (&da)[KR / 16][4], int row0,
    int col0, int q0, const float* lse2, const float* dl, int q_len,
    int kv_len, int causal, int window, float scale) {
  const float sl = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < KR / 8; ++i) {
    const int c = 8 * i + col0;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
    const float lv[2] = {l2.x, l2.y}, dv[2] = {d2.x, d2.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = 4 * i + 2 * j;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = exp2f(sc[t + e] * sl - lv[e]);
        if (MASKED && !live(q0 + c + e, row0 + 8 * j, q_len, kv_len, causal,
                            window))
          p[e] = 0.f;
        ds[e] = p[e] * (dp[t + e] - dv[e]) * scale;
      }
      // registers 8 kk + 2 q + {0, 1} -> a[q] of k step kk
      pa[t / 8][(t % 8) / 2] = pack_bf16(p[0], p[1]);
      da[t / 8][(t % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::THREADS, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       Layout lk, Layout lv, int H, int KH, int S, int T_,
                       int q_len, int kv_len, int causal, int window,
                       float scale) {
  using TL = DkvTiles<D>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t k_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + TL::KV_BYTES;
  const uint32_t ring = v_s + TL::KV_BYTES;
  const uint32_t vecs = ring + TL::WGS * TL::RING * TL::STAGE;
  const uint32_t bars = vecs + TL::WGS * TL::RING * TL::VEC * 4;
  uint8_t* const gbase = smem + (k_s - smem_u32(smem));  // generic of k_s
  auto vec = [&](int si) {  // stage si's lse·log2 e [KR], then delta [KR]
    return reinterpret_cast<float*>(gbase + (vecs - k_s) + si * TL::VEC * 4);
  };
  const uint32_t kv_full = bars;
  auto full = [&](int si) { return bars + 8 * (1 + si); };

  const int k0 = blockIdx.z * KR;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;

  // The live q-tiles of this key tile are one run [lo, hi) (the causal
  // bound rises with q, the window's falls); the items are its G heads x
  // those q-tiles, and warpgroup wg takes items wg, wg + WGS, ...
  const int n_qt = k0 < kv_len ? (q_len + KR - 1) / KR : 0;
  int lo = n_qt, hi = 0;
  for (int iq = 0; iq < n_qt; ++iq)
    if (tile_live(iq * KR, KR, k0, causal, window)) {
      lo = min(lo, iq);
      hi = iq + 1;
    }
  const int L = hi > lo ? hi - lo : 0;
  const int n_mine = (G * L - wg + TL::WGS - 1) / TL::WGS;  // wg's items

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int si = 0; si < TL::WGS * TL::RING; ++si)
      mbar_init(full(si), 32);  // the loading warp's lanes, one with bytes
    mbar_fence_init();
  }
  __syncthreads();

  // Warp 0 of each warpgroup loads that warpgroup's items: the lse·log2 e
  // and delta of its item n (query rows lane, lane + 32) into registers a
  // step ahead (fetch), then into the stage with Q and dO by TMA (issue).
  const bool loader = warp % 4 == 0;
  float pre[4];
  auto item = [&](int n, int& h, int& q0) {
    const int it = wg + TL::WGS * n;
    h = kh * G + it / L;
    q0 = (lo + it % L) * KR;
  };
  auto fetch = [&](int n) {
    if (n >= n_mine) return;
    int h, q0;
    item(n, h, q0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = q0 + lane + 32 * j;
      const long long at = ((long long)b * H + h) * S + row;
      pre[j] = row < S ? lse[at] * kLog2e : 0.f;
      pre[2 + j] = row < S ? delta[at] : 0.f;
    }
  };
  auto issue = [&](int n) {
    if (n >= n_mine) return;
    int h, q0;
    item(n, h, q0);
    const int si = wg * TL::RING + n % TL::RING;
    float* v = vec(si);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      v[lane + 32 * j] = pre[j];
      v[KR + lane + 32 * j] = pre[2 + j];
    }
    if (lane == 0) {
      const uint32_t qs = ring + si * TL::STAGE, dos = qs + TL::Q_BYTES;
      mbar_expect_tx(full(si), TL::STAGE);
#pragma unroll
      for (int c = 0; c < TL::CHUNKS; ++c) {
        tma_load_4d(qs + c * KR * 128, &q_map, full(si), 64 * c, q0, h, b);
        tma_load_4d(dos + c * KR * 128, &do_map, full(si), 64 * c, q0, h, b);
      }
    } else {
      mbar_arrive(full(si));
    }
  };
  if (loader) {
    if (wg == 0 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * TL::KV_BYTES);
#pragma unroll
      for (int c = 0; c < TL::CHUNKS; ++c) {
        tma_load_4d(k_s + c * KR * 128, &k_map, kv_full, 64 * c, k0, kh, b);
        tma_load_4d(v_s + c * KR * 128, &v_map, kv_full, 64 * c, k0, kh, b);
      }
    }
    for (int n = 0; n < TL::RING; ++n) {
      fetch(n);
      issue(n);
    }
  }

  // This thread's key rows are row0 and row0 + 8.
  const int row0 = k0 + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);

  mbar_wait(kv_full, 0);
  for (int n = 0; n < n_mine; ++n) {
    if (loader) fetch(n + TL::RING);  // in flight during this item
    int h, q0;
    item(n, h, q0);
    const int si = wg * TL::RING + n % TL::RING;
    mbar_wait(full(si), (n / TL::RING) & 1);
    const uint32_t qs = ring + si * TL::STAGE, dos = qs + TL::Q_BYTES;
    float sc[KR / 2], dp[KR / 2];
    zero(sc);
    zero(dp);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * KR * 128 + (kk % 4) * 32;
      mma_ss<0>(sc, desc_k(k_s + off), desc_k(qs + off));
      mma_ss<0>(dp, desc_k(v_s + off), desc_k(dos + off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    uint32_t pa[KR / 16][4], da[KR / 16][4];
    const float* v = vec(si);
    if (tile_full(q0, k0, q_len, kv_len, causal, window))
      dkv_scores<false>(sc, dp, pa, da, row0, col0, q0, v, v + KR, q_len,
                        kv_len, causal, window, scale);
    else
      dkv_scores<true>(sc, dp, pa, da, row0, col0, q0, v, v + KR, q_len,
                       kv_len, causal, window, scale);

    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk)
      mma_rs<1>(dv_acc, pa[kk], desc_mn(dos + kk * 2048, KR * 128));
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk)
      mma_rs<1>(dk_acc, da[kk], desc_mn(qs + kk * 2048, KR * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    // every warp of the warpgroup is done with the stage: refill it
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (loader) issue(n + TL::RING);
  }

  // Every item is consumed, so the stages are free: warpgroup 1 writes its
  // sums there, warpgroup 0 adds them to its own (a fixed order).
  float* red = reinterpret_cast<float*>(gbase + (ring - k_s));
  const int t = threadIdx.x % 128;
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  if (wg == 1) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      red[i * 128 + t] = dk_acc[i];
      red[(D / 2 + i) * 128 + t] = dv_acc[i];
    }
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] += red[i * 128 + t];
    dv_acc[i] += red[(D / 2 + i) * 128 + t];
  }
  store_rows<D>(dk, (long long)b * lk.b + (long long)kh * lk.h, lk.s, row0,
                col0, T_, dk_acc);
  store_rows<D>(dv, (long long)b * lv.b + (long long)kh * lv.h, lv.s, row0,
                col0, T_, dv_acc);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

Layout layout(const long long* st, int i) {
  return Layout{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// The maps of q, k, v, do (st: their (batch, head, row) strides, then the
// outputs'); q and do in boxes of q_box rows, k and v of KR rows.
int encode_inputs(CUtensorMap (&maps)[4], const void* q, const void* k,
                  const void* v, const void* dout, const long long* st,
                  int D, int B, int H, int KH, int S, int T_, int q_box) {
  return encode_qkv(&maps[0], q, st, D, S, H, B, q_box) ||
         encode_qkv(&maps[1], k, st + 3, D, T_, KH, B, KR) ||
         encode_qkv(&maps[2], v, st + 6, D, T_, KH, B, KR) ||
         encode_qkv(&maps[3], dout, st + 9, D, S, H, B, q_box);
}

template <int D, int NWG>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const long long* st, int B, int H, int KH, int S, int T_,
              int q_len, int kv_len, int causal, int window, float scale,
              int smem_bytes, void* stream) {
  using TL = DqTiles<D, NWG>;
  if (smem_bytes < TL::SMEM) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || S == 0) return 0;
  CUtensorMap maps[4];
  if (encode_inputs(maps, q, k, v, dout, st, D, B, H, KH, S, T_, TL::QR))
    return kEncodeFailed;
  auto kernel = flash_dq_wgmma_kernel<D, NWG>;
  static int opted = 0;  // the shared memory this kernel is opted into
  if (int e = set_smem(kernel, smem_bytes, opted)) return e;
  dim3 grid(H, B, (S + TL::QR - 1) / TL::QR);
  kernel<<<grid, TL::THREADS, smem_bytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse,
      (const float*)delta, (bf16*)dq, layout(st, 4), H, KH, S, q_len,
      kv_len, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, const long long* st, int B, int H, int KH,
               int S, int T_, int q_len, int kv_len, int causal, int window,
               float scale, int smem_bytes, void* stream) {
  using TL = DkvTiles<D>;
  if (smem_bytes < TL::SMEM) return (int)cudaErrorInvalidValue;
  if (B == 0 || KH == 0 || T_ == 0) return 0;
  CUtensorMap maps[4];
  if (encode_inputs(maps, q, k, v, dout, st, D, B, H, KH, S, T_, KR))
    return kEncodeFailed;
  auto kernel = flash_dkv_wgmma_kernel<D>;
  static int opted = 0;  // the shared memory this kernel is opted into
  if (int e = set_smem(kernel, smem_bytes, opted)) return e;
  dim3 grid(KH, B, (T_ + KR - 1) / KR);
  kernel<<<grid, TL::THREADS, smem_bytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, layout(st, 4),
      layout(st, 5), H, KH, S, T_, q_len, kv_len, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, do, dq [B, H, S, hd]; k, v [B, KH, T, hd], bf16, each by the (batch,
// head, row) element strides st[3 i .. 3 i + 2] (i = q, k, v, do, dq), hd
// contiguous; lse, delta [B, H, S] f32. hd is 64 or 128; q_rows (64 or
// 128) and smem_bytes come from the wrapper's plan.
int flash_dq_wgmma_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, const long long* st, int B, int H, int KH,
                        int S, int T_, int hd, int q_len, int kv_len,
                        int causal, int window, float scale, int q_rows,
                        int smem_bytes, void* stream) {
#define FLASH_DQ_CASE(D, NWG)                                               \
  if (hd == D && q_rows == 64 * NWG)                                        \
    return launch_dq<D, NWG>(q, k, v, dout, lse, delta, dq, st, B, H, KH,   \
                             S, T_, q_len, kv_len, causal, window, scale,   \
                             smem_bytes, stream);
  FLASH_DQ_CASE(64, 1)
  FLASH_DQ_CASE(64, 2)
  FLASH_DQ_CASE(128, 1)
  FLASH_DQ_CASE(128, 2)
#undef FLASH_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

// The same inputs; dk, dv [B, KH, T, hd] bf16 by the strides st[12 ..
// 17]. smem_bytes comes from the wrapper's plan.
int flash_dkv_wgmma_bf16(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv,
                         const long long* st, int B, int H, int KH, int S,
                         int T_, int hd, int q_len, int kv_len, int causal,
                         int window, float scale, int smem_bytes,
                         void* stream) {
  if (hd == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, st, B, H, KH,
                          S, T_, q_len, kv_len, causal, window, scale,
                          smem_bytes, stream);
  if (hd == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, st, B, H, KH,
                           S, T_, q_len, kv_len, causal, window, scale,
                           smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
