// Flash attention forward on the tensor cores, bf16, head_dim 64 or 128
// (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
//   * flash_forward (_fwd_kernel, pallas_call at :122)
// for bf16 inputs at head_dim 64 and 128; f32 inputs and other head_dims
// stay on flash_fwd_kernel of csrc/flash_attention.cu. What it computes is
// that kernel's contract (flash_attention.cu:7-18): GQA with query head h
// reading KV head h / G; s = q·kᵀ·scale, softcap·tanh(s/softcap) when
// softcap > 0; live(q, k) = q < q_len && k < kv_len && (!causal || k <= q)
// && (window <= 0 || q - k < window); online softmax over the live keys,
// o = acc / l in q's dtype and with q's strides, lse = m + log l in f32; a
// row with no live key writes o = 0 and lse = kNeg exactly; k-tiles in which
// no element can be live are skipped (_tile_live, flash_attention.py:46-57).
//
// Numerics. q·kᵀ sums bf16 products in f32 (exact products), as the FMA
// kernel does. The softmax runs in log2 units (s·log2 e, exp2), which
// moves p by ~1e-7 relative. p is f32 for the row sum l, and rounded to
// bf16 as the A operand of p·v: the one real change from the FMA kernel,
// which keeps p in f32. It moves o by about one bf16 ulp of p, well inside
// the bf16 tier (2e-2 · min(1, max|o|)); lse does not see it.
//
// Design (warp-specialised):
//   * A block owns QR = 64 * NWG query rows of one (b, h): NWG consumer
//     warpgroups of 64 rows each, and a producer warp after them. The
//     wrapper's plan (kernels/flash_attention.py, flash_wgmma_plan) takes
//     NWG = 1 for S <= 64, else 2.
//   * The producer loads the Q tile once, then the K and V tiles (64 rows)
//     of every live k-tile through a ring of STAGES = 3 stages (2 and 4
//     were no faster on the H100), all by TMA
//     over 4D maps [B, heads, rows, hd] built from the wrapper's (batch,
//     head, row) strides, so the model layout [B, S, H, hd] is read in
//     place; rows past S or T read as zero. Full barriers complete on the
//     TMA bytes; an empty barrier takes one arrival from every consumer
//     warp.
//   * S = Q·Kᵀ: wgmma m64n64k16 with Q and K both K-major in shared memory.
//     Scale, softcap and masks act on the accumulator registers; the row
//     max and sum come from the four lanes that share a row (shfl_xor 1,
//     2). The scores never touch shared memory.
//   * O += P·V: P packed to bf16 in registers is the register A operand of
//     wgmma m64n{hd}k16; V is read as it lies (MN-major, transpose flag).
//     The online-softmax rescale of O happens after the previous P·V group
//     has completed (wait_group 0 before the rescale).
//   * A warpgroup whose 64 rows cannot see a k-tile of the block skips its
//     products but still waits for and releases the stage, so the ring
//     stays in step. A tile in which every pair is live skips the mask.
//   * The q-tile is the slowest grid axis, walked from the last tile: under
//     a causal mask the blocks with the most k-tiles start first, and the
//     light ones fill the tail.
//
// Bound on the card: at the training shapes (8 x 256 causal, 16 heads, 4
// KV heads, hd 128) the call moves ~21 MB (6.3 us at 3.35 TB/s) against
// ~2.2 GFLOP of needed products (2.2 us at 989 TFLOP/s): bytes bound it.
// Not done yet: overlapping one tile's softmax with the next tile's Q·Kᵀ,
// 128-row k-tiles, and a persistent grid.

#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;
using namespace flash90;

constexpr int STAGES = 3;  // K/V tiles in flight
constexpr float kLn2 = 0.6931471805599453f;

template <int D, int NWG>
struct Tiles {
  static constexpr int QR = 64 * NWG;
  static constexpr int CHUNKS = D / 64;            // 64-column chunks
  static constexpr int Q_BYTES = QR * D * 2;
  static constexpr int KV_BYTES = KR * D * 2;      // one of K, V
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int THREADS = 128 * NWG + 32;
};

// Shared memory a launch needs: Q, the stages, barriers (q_full, then
// full[s] and empty[s]) and up to 1024 bytes to align Q. The wrapper's
// plan computes the same number; the launcher refuses a smaller one.
template <int D, int NWG>
constexpr int smem_needed() {
  return Tiles<D, NWG>::Q_BYTES + STAGES * Tiles<D, NWG>::STAGE +
         8 * (1 + 2 * STAGES) + 1024;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One online-softmax step on the score registers sc of a k-tile (the
// accumulator layout of sm90.cuh; this thread's rows row0 and row0 + 8,
// columns k0 + 8 (t / 4) + col0 + t % 2): scale, softcap and, where
// MASKED, the live mask (dead scores become kNeg and their p exactly 0);
// the new row maxima m and sums l; acc rescaled; p packed to bf16 in pa,
// the register A operand of the P·V product. Scores and maxima are kept
// in log2 units (exp2 instead of exp); kNeg stays kNeg.
template <bool MASKED, int D>
__device__ __forceinline__ void softmax_step(
    float (&sc)[KR / 2], float (&m)[2], float (&l)[2], float (&acc)[D / 2],
    uint32_t (&pa)[KR / 16][4], int row0, int col0, int k0, int q_len,
    int kv_len, int causal, int window, float scale, float softcap) {
  constexpr float kLog2e = 1.4426950408889634f;
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int t = 0; t < KR / 2; ++t) {
    const int j = (t / 2) % 2;
    float x = sc[t] * scale;
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    x *= kLog2e;
    if (MASKED && !live(row0 + 8 * j, k0 + 8 * (t / 4) + col0 + t % 2,
                        q_len, kv_len, causal, window))
      x = kNeg;
    sc[t] = x;
    mx[j] = fmaxf(mx[j], x);
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float m_new = fmaxf(m[j], quad_max(mx[j]));
    alpha[j] = exp2f(m[j] - m_new);
    m[j] = m_new;
  }
#pragma unroll
  for (int t = 0; t < KR / 2; t += 2) {
    const int j = (t / 2) % 2;
    float p[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[e] = exp2f(sc[t + e] - m[j]);
      if (MASKED && sc[t + e] == kNeg) p[e] = 0.f;  // dead: exactly 0
    }
    sum[j] += p[0] + p[1];
    // registers 8 kk + 2 q + {0, 1} -> a[q] of k step kk
    pa[t / 8][(t % 8) / 2] = pack_bf16(p[0], p[1]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + quad_sum(sum[j]);
#pragma unroll
  for (int t = 0; t < D / 2; ++t) acc[t] *= alpha[(t / 2) % 2];
}

template <int D, int NWG>
__global__ void __launch_bounds__(Tiles<D, NWG>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       Layout lo, int H, int KH, int S, int q_len,
                       int kv_len, int causal, int window, float scale,
                       float softcap) {
  using TL = Tiles<D, NWG>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + TL::Q_BYTES;
  const uint32_t bars = kv_s + STAGES * TL::STAGE;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  // The q-tile is the slowest grid axis, taken last to first: under a
  // causal mask the tiles with the most live k-tiles start first.
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
      mbar_expect_tx(q_full, TL::Q_BYTES);
#pragma unroll
      for (int c = 0; c < TL::CHUNKS; ++c)
        tma_load_4d(q_s + c * TL::QR * 128, &q_map, q_full, 64 * c, q0, h,
                    b);
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

  // Consumer warpgroup wg: rows qw .. qw + 63; this thread's rows are
  // row0 and row0 + 8 (the accumulator layout of sm90.cuh).
  const int wg = warp / 4;
  const int qw = q0 + 64 * wg;
  const int row0 = qw + 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  int it = 0;
  for (int ik = 0; ik < n_kt; ++ik) {
    const int k0 = ik * KR;
    if (!tile_live(q0, TL::QR, k0, causal, window)) continue;
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    ++it;
    if (qw < q_len && tile_live(qw, 64, k0, causal, window)) {
      const uint32_t ks = kv_s + s * TL::STAGE, vs = ks + TL::KV_BYTES;
      float sc[KR / 2];
#pragma unroll
      for (int i = 0; i < KR / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns into the chunk
        mma_ss<0>(sc,
                  desc_k(q_s + (kk / 4) * TL::QR * 128 + wg * 64 * 128 + off),
                  desc_k(ks + (kk / 4) * KR * 128 + off));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      uint32_t pa[KR / 16][4];
      if (tile_full(qw, k0, q_len, kv_len, causal, window))
        softmax_step<false, D>(sc, m, l, acc, pa, row0, col0, k0, q_len,
                               kv_len, causal, window, scale, softcap);
      else
        softmax_step<true, D>(sc, m, l, acc, pa, row0, col0, k0, q_len,
                              kv_len, causal, window, scale, softcap);

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk)
        mma_rs<1>(acc, pa[kk], desc_mn(vs + kk * 2048, KR * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(empty(s));
  }

  const long long base = (long long)b * lo.b + (long long)h * lo.h;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    if (row >= S) continue;
    const float denom = l[j] == 0.f ? 1.f : l[j];
    bf16* dst = o + base + (long long)row * lo.s;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + col0) =
          __floats2bfloat162_rn(acc[4 * i + 2 * j] / denom,
                                acc[4 * i + 2 * j + 1] / denom);
    if (lane % 4 == 0)
      lse[((long long)b * H + h) * S + row] =
          l[j] == 0.f ? kNeg : m[j] * kLn2 + logf(denom);
  }
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const long long* st, int B, int H, int KH, int S, int T_,
           int q_len, int kv_len, int causal, int window, float scale,
           float softcap, int smem_bytes, void* stream) {
  using TL = Tiles<D, NWG>;
  if (smem_bytes < smem_needed<D, NWG>()) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || S == 0) return 0;
  CUtensorMap q_map, k_map, v_map;
  if (encode_qkv(&q_map, q, st, D, S, H, B, TL::QR) ||
      encode_qkv(&k_map, k, st + 3, D, T_, KH, B, KR) ||
      encode_qkv(&v_map, v, st + 6, D, T_, KH, B, KR))
    return kEncodeFailed;
  auto kernel = flash_fwd_wgmma_kernel<D, NWG>;
  static int opted = 0;  // the shared memory this kernel is opted into
  if (int e = set_smem(kernel, smem_bytes, opted)) return e;
  dim3 grid(H, B, (S + TL::QR - 1) / TL::QR);
  const Layout lo{st[9], st[10], st[11]};
  kernel<<<grid, TL::THREADS, smem_bytes, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, (bf16*)o, (float*)lse, lo, H, KH, S, q_len,
      kv_len, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o [B, H, S, hd]; k, v [B, KH, T, hd], bf16, each by the (batch, head,
// row) element strides st[3 i .. 3 i + 2] (i = q, k, v, o), hd contiguous;
// lse [B, H, S] f32. hd is 64 or 128; q_rows (64 or 128) and smem_bytes
// come from the wrapper's plan.
int flash_fwd_wgmma_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, const long long* st, int B,
                         int H, int KH, int S, int T_, int hd, int q_len,
                         int kv_len, int causal, int window, float scale,
                         float softcap, int q_rows, int smem_bytes,
                         void* stream) {
#define FLASH_WGMMA_CASE(D, NWG)                                            \
  if (hd == D && q_rows == 64 * NWG)                                        \
    return launch<D, NWG>(q, k, v, o, lse, st, B, H, KH, S, T_, q_len,      \
                          kv_len, causal, window, scale, softcap,           \
                          smem_bytes, stream);
  FLASH_WGMMA_CASE(64, 1)
  FLASH_WGMMA_CASE(64, 2)
  FLASH_WGMMA_CASE(128, 1)
  FLASH_WGMMA_CASE(128, 2)
#undef FLASH_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
