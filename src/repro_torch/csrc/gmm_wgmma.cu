// Grouped expert GEMM for bf16 operands on the tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/gmm.py for its bf16
// uses:
//   * gmm_tiled (_gmm_kernel, pallas_call at gmm.py:69)
//       out[m-tile] = lhs[m-tile] @ rhs[tile_group[m-tile]]
// with lhs [Mp, K] bf16 row-major (rows sorted by group, every group
// starting on a block_m boundary, pad rows zero), rhs [G, K, N] bf16
// row-major, tile_group [Mp / block_m] int32; f32 sums, rounded once to the
// output type: bf16 (the forward's down projection, ops.py:270) or f32 (the
// MoE backward's recompute of g and u, ops.py:285). The f32-operand and
// transposed-weight variants and the fused GLU stay on the FMA kernel of
// csrc/gmm.cu.
//
// Design (warp-specialised, one output tile per block):
//   * A block owns tile_m rows (one block_m tile or a part of one, so one
//     group) and BN = 256 columns. tile_m is the largest of 128, 64, 32,
//     16 and 8 that divides block_m (the wrapper's plan): any block_m that
//     is a multiple of 8, as the reference's capacity routing produces
//     (ops.py:625-627), is taken. NWG = tile_m / 64 consumer warpgroups
//     (one under 64 rows) own 64 rows each and accumulate in f32
//     registers with wgmma.m64n256k16.f32.bf16.bf16; a producer warp after
//     them issues the loads. Under 64 rows the warpgroup still issues m64
//     products: the lhs box brings tile_m rows, the shared rows past them
//     hold stale data that reaches only their own output rows, and the
//     store keeps the tile's rows (up to 8x the tensor-core work at
//     block_m 8; no main-path call uses these tiles yet). These tiles have
//     an instantiation of their own (PART), so the 64- and 128-row tiles
//     keep a store and a byte count without a run-time row bound.
//   * A ring of STAGES = 4 stages in shared memory, each one 64-deep
//     k-slice:
//     the lhs slice [tile_m, 64] (one TMA box over the 2D map of lhs) and
//     the weight slice [64, BN] (BN / 64 boxes over the 3D map of rhs,
//     group coordinate g = tile_group[m0 / block_m]), 128-byte swizzle.
//     A full barrier per stage completes on the TMA bytes; an empty barrier
//     per stage takes one arrival from every consumer warp once its
//     products of the stage are done. The producer keeps up to STAGES
//     slices in flight. 256 columns and 4 stages were among the fastest
//     of 128- and 256-wide tiles with 3-5 stages at the serve and train
//     shapes on the H100.
//   * The weight is read as it lies (N contiguous): the B operand is
//     MN-major, taken with wgmma's transpose flag; nothing is copied.
//   * Each consumer keeps one product group in flight (wait_group 1): the
//     tensor cores run slice k while slice k - 1's stage is released.
//   * TMA fills out-of-bounds elements with zeros, which covers a ragged K
//     and N; the epilogue masks the N edge and writes every row, pad rows
//     included (they are zero, as the plain version gives).
// The host encodes the two tensor maps on every call (strides must be
// multiples of 16 bytes: K % 8 == 0 and N % 8 == 0, 16-byte aligned
// pointers; the wrapper checks) and takes the row tile and shared-memory
// size from the wrapper's plan (kernels/gmm.py, gmm_wgmma_plan).
//
// Bound on the card: at the serving shapes (a 256-token prefill chunk
// routed top-2 over 24 experts, d_ff 7168 -> d 2048) the call needs the
// 704 MB weight stream, 0.21 ms at 3.35 TB/s; at the training shapes
// (4096 routed rows over 12 experts) it is bound by bytes too (0.15 ms)
// while the padded tiles (5632 rows) cost ~165 GFLOP of tensor-core work.
// Not done yet: a persistent grid with the epilogue of one tile under the
// loads of the next, TMA stores, and skipping all-pad tiles.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int BK = 64;     // k-depth of one stage: one 128-byte swizzled row
constexpr int BN = 256;    // columns of an output tile
constexpr int STAGES = 4;  // k-slices in flight

template <int NWG>
struct Tile {
  static constexpr int M = 64 * NWG;           // lhs rows in shared memory
  static constexpr int A_BYTES = M * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int THREADS = 128 * NWG + 32;
};

// Shared memory a launch needs: the stages, their two barriers each, and
// up to 1024 bytes to align the first stage. kernels/gmm.py computes the
// same number (gmm_wgmma_plan); the launcher refuses a smaller one.
template <int NWG>
constexpr int smem_needed() {
  return STAGES * Tile<NWG>::STAGE + 16 * STAGES + 1024;
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// PART: a tile of tile_m < 64 rows (NWG = 1); else tile_m = 64 NWG.
template <typename TO, int NWG, bool PART>
__global__ void __launch_bounds__(Tile<NWG>::THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const int* __restrict__ tile_group, TO* __restrict__ out,
                 int K, int N, int block_m, int tile_m) {
  using T = Tile<NWG>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * T::STAGE;  // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  if (!PART) tile_m = T::M;
  const int m0 = blockIdx.y * tile_m, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer warp: one lane issues every load
    if (lane == 0) {
      const int g = tile_group[m0 / block_m];
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        const uint32_t a = base + s * T::STAGE, b = a + T::A_BYTES;
        mbar_expect_tx(full(s), tile_m * BK * 2 + T::B_BYTES);
        tma_load_2d(a, &lhs_map, full(s), kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(b + j * BK * 128, &w_map, full(s), n0 + 64 * j,
                      kt * BK, g);
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows m0 + 64 wg .. + 63.
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    const uint32_t a = base + s * T::STAGE + wg * 64 * 128;
    const uint32_t b = base + s * T::STAGE + T::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_ss<1>(acc, desc_k(a + kk * 32), desc_mn(b + kk * 2048, BK * 128));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // the previous slice's products are done
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // This thread's rows: r and r + 8 of the tile; under PART those past
  // tile_m were computed from stale shared rows and are not stored.
  const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = n0 + 8 * i + 2 * (lane % 4);
    if (c < N) {  // N % 8 == 0: c < N implies c + 1 < N
      if (!PART || r < tile_m)
        store2(out + (size_t)(m0 + r) * N + c, acc[4 * i], acc[4 * i + 1]);
      if (!PART || r + 8 < tile_m)
        store2(out + (size_t)(m0 + r + 8) * N + c, acc[4 * i + 2],
               acc[4 * i + 3]);
    }
  }
}

template <typename TO, int NWG, bool PART>
int launch(const void* lhs, const void* w, const void* tile_group, void* out,
           int Mp, int K, int N, int G, int block_m, int tile_m,
           int smem_bytes, void* stream) {
  using T = Tile<NWG>;
  const bool tile_ok = PART ? tile_m < 64 && tile_m % 8 == 0
                            : tile_m == T::M;
  if (smem_bytes < smem_needed<NWG>() || !tile_ok || Mp % tile_m ||
      block_m % tile_m || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap lhs_map, w_map;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)Mp};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {BK, (cuuint32_t)tile_m};
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)G};
  const cuuint64_t w_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t w_box[3] = {64, BK, 1};
  if (encode_bf16(&lhs_map, lhs, 2, a_dims, a_strides, a_box) ||
      encode_bf16(&w_map, w, 3, w_dims, w_strides, w_box))
    return kEncodeFailed;
  auto kernel = gmm_wgmma_kernel<TO, NWG, PART>;
  static int opted = 0;  // the shared memory this kernel is opted into
  if (int e = set_smem(kernel, smem_bytes, opted)) return e;
  dim3 grid((N + BN - 1) / BN, Mp / tile_m);
  kernel<<<grid, T::THREADS, smem_bytes, (cudaStream_t)stream>>>(
      lhs_map, w_map, (const int*)tile_group, (TO*)out, K, N, block_m,
      tile_m);
  return (int)cudaGetLastError();
}

template <typename TO>
int dispatch(const void* lhs, const void* w, const void* tile_group,
             void* out, int Mp, int K, int N, int G, int block_m, int tile_m,
             int smem_bytes, void* stream) {
  if (tile_m == 128)
    return launch<TO, 2, false>(lhs, w, tile_group, out, Mp, K, N, G,
                                block_m, tile_m, smem_bytes, stream);
  if (tile_m == 64)
    return launch<TO, 1, false>(lhs, w, tile_group, out, Mp, K, N, G,
                                block_m, tile_m, smem_bytes, stream);
  if (tile_m == 32 || tile_m == 16 || tile_m == 8)
    return launch<TO, 1, true>(lhs, w, tile_group, out, Mp, K, N, G,
                               block_m, tile_m, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out = lhs @ rhs[g] per m-tile; lhs [Mp, K] bf16, rhs [G, K, N] bf16, both
// row-major; out [Mp, N] bf16 (gmm_wgmma_bf16) or f32 (gmm_wgmma_f32).
// tile_m (128, 64, 32, 16 or 8, dividing block_m) and smem_bytes come from
// the wrapper's plan.
int gmm_wgmma_bf16(const void* lhs, const void* rhs, const void* tile_group,
                   void* out, int Mp, int K, int N, int G, int block_m,
                   int tile_m, int smem_bytes, void* stream) {
  return dispatch<bf16>(lhs, rhs, tile_group, out, Mp, K, N, G, block_m,
                        tile_m, smem_bytes, stream);
}

int gmm_wgmma_f32(const void* lhs, const void* rhs, const void* tile_group,
                  void* out, int Mp, int K, int N, int G, int block_m,
                  int tile_m, int smem_bytes, void* stream) {
  return dispatch<float>(lhs, rhs, tile_group, out, Mp, K, N, G, block_m,
                         tile_m, smem_bytes, stream);
}

}  // extern "C"
