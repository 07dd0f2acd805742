// Grouped expert GEMM of an f32 lhs against a bf16 weight on the tensor
// cores, held to the f32 tier by an exact three-term bf16 split of the lhs
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py:gmm_tiled
// (_gmm_kernel, pallas_call at gmm.py:69) for the MoE backward's f32-lhs
// products (src/repro/kernels/ops.py:419-435; kernels/ops.py, _MoEFFN):
//   y = h @ wo (the router-scale gradient's recompute of the unscaled
//   rows), dh = dout @ wo^T,  dx = dg @ wi_gate^T + du @ wi_up^T
// i.e. out[m-tile] = lhs[m-tile] @ W[tile_group[m-tile]] with lhs [Mp, K]
// f32 row-major (rows sorted by group, every group starting on a block_m
// boundary, pad rows zero), tile_group [Mp / block_m] int32, out [Mp, N]
// f32, and the weight bf16 as it lies, in one of two layouts (a tag of the
// kernel): WeightKN, [G, K, N] row-major (y's wo); WeightNK, [G, N, K]
// row-major (the data gradients' swapaxes(W, 1, 2) view, never copied).
// The reference widens both tiles to f32 before its dot; csrc/gmm.cu (FMA)
// keeps K or N off the multiples of 8 and the f32 x f32 types (the
// wrapper's route, kernels/gmm.py:gmm_route).
//
// Numerics. Each f32 lhs value x is split into three bf16 terms (sm90.cuh
// split3: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)) whose
// sum is x exactly for 2^-110 <= |x| < (2 - 2^-8) 2^127. W is exact in
// bf16, so the three products hi.W, mid.W and lo.W, each exact in f32, sum
// to the reference's products: nothing is left out. All three go into one
// f32 wgmma accumulator.
//
// Design (the warp-specialised shape of gmm_wgmma.cu):
//   * A block owns tile_m rows (the largest of 128, 64, 32, 16 and 8 that
//     divides block_m: one group) and BN = 256 columns. NWG = tile_m / 64
//     consumer warpgroups (one under 64 rows) own 64 rows each and
//     accumulate in f32 registers with wgmma.m64n256k16; a producer warp
//     after them issues the loads. Under 64 rows the shared rows past the
//     tile hold stale data that reaches only their own output rows, which
//     are not stored (PART), as in gmm_wgmma.cu.
//   * A ring of STAGES = 3 stages in shared memory, each one 64-deep
//     k-slice: the f32 lhs slice [tile_m, 64] as two TMA boxes of 32 f32
//     columns (128-byte rows, 128-byte swizzle) and the weight slice
//     [64 k, BN n] bf16 (32 KB in either layout) from a 3D map at group
//     coordinate g. WeightNK: one box [BN rows of n, 64 k], K-major,
//     wgmma's native B layout (no transpose flag). WeightKN: BN / 64 boxes
//     [64 rows of k, 64 n], MN-major, read with the transpose flag as
//     gmm_wgmma.cu reads the same weight (+2048 bytes per 16-deep k step,
//     the 64-column chunks BK * 128 bytes apart). Full and empty barriers
//     per stage as in gmm_wgmma.cu: 4 bytes of shared memory an lhs
//     element, no split planes.
//   * The A operand comes from registers (mma_rs): for each 16-deep k step
//     a consumer thread reads its m64k16 fragment (four f32 pairs) from the
//     swizzled slice, splits each pair into three bf16x2 words and issues
//     the three products hi.W, mid.W, lo.W as one commit group, then waits
//     for it (wait_group 0) before it splits the next fragment; the other
//     consumer warpgroup's products fill the tensor cores meanwhile. No
//     fence.proxy.async or block barrier sits between split and product.
//     (Double-buffered fragments with wait_group 1 measured 8% slower on
//     the H100: ptxas serialized those products, warning C7515.)
//   * TMA fills out-of-bounds elements with zeros (a ragged K; the N edge),
//     and the epilogue masks the N edge and writes every row of the tile,
//     pad rows included (zero, as the plain version gives).
//
// Bound on the card: operations. At the training shapes (4096 routed rows,
// d 2048, f 7168, 12 experts) the three products need 3 x 2 x 4096 x 2048
// x 7168 = 361 GFLOP of bf16 tensor-core work (0.365 ms at 989 TFLOP/s);
// the bytes (the f32 lhs and output, the used weights) take ~0.15 ms. The
// grid also runs the pad rows (5632 rows).
// Not done yet: a persistent grid, skipping all-pad tiles, TMA stores.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int BK = 64;      // k-depth of one stage
constexpr int BN = 256;     // output columns of a tile: rows of W
constexpr int STAGES = 3;   // k-slices in flight
constexpr int TERMS = 3;    // bf16 terms of an f32 lhs value

// The weight's layout (see the note above); TRANS_B is wgmma's flag.
struct WeightNK { static constexpr int TRANS_B = 0; };  // [G, N, K]
struct WeightKN { static constexpr int TRANS_B = 1; };  // [G, K, N]

template <int NWG>
struct Tile {
  static constexpr int M = 64 * NWG;            // lhs rows in shared memory
  static constexpr int A_CHUNK = M * 128;       // [M, 32] f32
  static constexpr int A_BYTES = 2 * A_CHUNK;   // [M, 64] f32
  static constexpr int B_BYTES = BN * BK * 2;   // 256 x 64 bf16
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int THREADS = 128 * NWG + 32;
};

// Shared memory a launch needs: the stages, their two barriers each, and
// up to 1024 bytes to align the first stage. kernels/gmm.py computes the
// same number (gmm_wgmma_plan with an f32 lhs); the launcher refuses a
// smaller one.
template <int NWG>
constexpr int smem_needed() {
  return STAGES * Tile<NWG>::STAGE + 16 * STAGES + 1024;
}

// Byte offset of the f32 pair (row r, columns c, c + 1; c even) in a stage's
// lhs slice: two 32-column chunks of `chunk` bytes, 128-byte rows, the
// 16-byte pieces permuted by r % 8 (the TMA 128-byte swizzle).
__device__ __forceinline__ int a_off(int r, int c, int chunk) {
  return (c / 32) * chunk + r * 128 + ((((c % 32) / 4) ^ (r % 8)) << 4) +
         (c % 4) * 4;
}

// PART: a tile of tile_m < 64 rows (NWG = 1); else tile_m = 64 NWG.
template <typename W, int NWG, bool PART>
__global__ void __launch_bounds__(Tile<NWG>::THREADS, 1)
gmm_f32_wgmma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const int* __restrict__ tile_group,
                     float* __restrict__ out, int K, int N, int block_m,
                     int tile_m) {
  using T = Tile<NWG>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
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
        mbar_expect_tx(full(s), 2 * tile_m * 128 + T::B_BYTES);
        tma_load_2d(a, &lhs_map, full(s), kt * BK, m0);
        tma_load_2d(a + T::A_CHUNK, &lhs_map, full(s), kt * BK + 32, m0);
        if constexpr (W::TRANS_B) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(b + j * BK * 128, &w_map, full(s), n0 + 64 * j,
                        kt * BK, g);
        } else {
          tma_load_3d(b, &w_map, full(s), kt * BK, n0, g);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows m0 + 64 wg .. + 63. This thread's A
  // fragment rows: r and r + 8 of the tile (sm90.cuh's register layout).
  const int wg = warp / 4;
  const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    const uint8_t* a = smem + s * T::STAGE;
    const uint32_t b = base + s * T::STAGE + T::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t f[TERMS][4];  // the split terms of this thread's fragment
      const int c = 16 * kk + 2 * (lane % 4);
      // a[0]: (r, c); a[1]: (r + 8, c); a[2]: (r, c + 8); a[3]: (r + 8, c + 8)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(
            a + a_off(r + 8 * (i % 2), c + 8 * (i / 2), T::A_CHUNK));
        uint32_t t[TERMS];
        split3(v.x, v.y, t);
#pragma unroll
        for (int p = 0; p < TERMS; ++p) f[p][i] = t[p];
      }
      fence_regs(acc);
      wgmma_fence();  // the fragment's registers are written before wgmma
#pragma unroll
      for (int p = 0; p < TERMS; ++p)
        mma_rs<W::TRANS_B>(acc, f[p],
                           W::TRANS_B ? desc_mn(b + kk * 2048, BK * 128)
                                      : desc_k(b + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int p = 0; p < TERMS; ++p)  // read by the products until here
        fence_regs(f[p]);
    }
    if (lane == 0) mbar_arrive(empty(s));  // this slice's products are done
  }

  // Accumulator map (sm90.cuh): register 4 i + e holds row r + 8 (e / 2) and
  // column n0 + 8 i + 2 (lane % 4) + e % 2. Under PART the rows past tile_m
  // were computed from stale shared rows and are not stored.
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = n0 + 8 * i + 2 * (lane % 4);
    if (c < N) {  // N % 8 == 0: c < N implies c + 1 < N
      if (!PART || r < tile_m)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + r) * N + c) =
            make_float2(acc[4 * i], acc[4 * i + 1]);
      if (!PART || r + 8 < tile_m)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + r + 8) * N + c) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

template <typename W, int NWG, bool PART>
int launch(const void* lhs, const void* w, const void* tile_group, void* out,
           int Mp, int K, int N, int G, int block_m, int tile_m,
           int smem_bytes, void* stream) {
  using T = Tile<NWG>;
  const bool tile_ok = PART ? tile_m < 64 && tile_m % 8 == 0
                            : tile_m == T::M;
  if (smem_bytes < smem_needed<NWG>() || smem_bytes > 232448 || !tile_ok ||
      Mp % tile_m || block_m % tile_m || K <= 0 || N <= 0 || K % 8 ||
      N % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap lhs_map, w_map;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)Mp};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t a_box[2] = {32, (cuuint32_t)tile_m};
  // WeightKN: [G, K, N], boxes of 64 n x 64 k; WeightNK: [G, N, K], boxes
  // of 64 k x BN n.
  const cuuint64_t w_inner = W::TRANS_B ? N : K, w_outer = W::TRANS_B ? K : N;
  const cuuint64_t w_dims[3] = {w_inner, w_outer, (cuuint64_t)G};
  const cuuint64_t w_strides[2] = {w_inner * 2, (cuuint64_t)N * K * 2};
  const cuuint32_t w_box[3] = {64, W::TRANS_B ? (cuuint32_t)BK : BN, 1};
  if (encode_f32(&lhs_map, lhs, 2, a_dims, a_strides, a_box) ||
      encode_bf16(&w_map, w, 3, w_dims, w_strides, w_box))
    return kEncodeFailed;
  auto kernel = gmm_f32_wgmma_kernel<W, NWG, PART>;
  static int opted = 0;  // the shared memory this kernel is opted into
  if (int e = set_smem(kernel, smem_bytes, opted)) return e;
  dim3 grid((N + BN - 1) / BN, Mp / tile_m);
  kernel<<<grid, T::THREADS, smem_bytes, (cudaStream_t)stream>>>(
      lhs_map, w_map, (const int*)tile_group, (float*)out, K, N, block_m,
      tile_m);
  return (int)cudaGetLastError();
}

template <typename W>
int dispatch(const void* lhs, const void* w, const void* tile_group,
             void* out, int Mp, int K, int N, int G, int block_m, int tile_m,
             int smem_bytes, void* stream) {
  if (tile_m == 128)
    return launch<W, 2, false>(lhs, w, tile_group, out, Mp, K, N, G,
                               block_m, tile_m, smem_bytes, stream);
  if (tile_m == 64)
    return launch<W, 1, false>(lhs, w, tile_group, out, Mp, K, N, G,
                               block_m, tile_m, smem_bytes, stream);
  if (tile_m == 32 || tile_m == 16 || tile_m == 8)
    return launch<W, 1, true>(lhs, w, tile_group, out, Mp, K, N, G, block_m,
                              tile_m, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out [Mp, N] f32 = lhs @ W[g]^T per m-tile; lhs [Mp, K] f32, W [G, N, K]
// bf16, both row-major and 16-byte aligned, K % 8 == 0 and N % 8 == 0.
// tile_m (128, 64, 32, 16 or 8, dividing block_m) and smem_bytes come from
// the wrapper's plan (gmm_wgmma_plan with an f32 lhs); returns
// cudaErrorInvalidValue otherwise (the wrapper checks first).
int gmm_t_f32_bf16_f32(const void* lhs, const void* w,
                       const void* tile_group, void* out, int Mp, int K,
                       int N, int G, int block_m, int tile_m, int smem_bytes,
                       void* stream) {
  return dispatch<WeightNK>(lhs, w, tile_group, out, Mp, K, N, G, block_m,
                            tile_m, smem_bytes, stream);
}

// The same with W [G, K, N] bf16 row-major: out = lhs @ W[g] per m-tile
// (csrc/gmm.cu's FMA entry of these operand types is gmm_f32_bf16_f32).
int gmm_f32_bf16_f32_wgmma(const void* lhs, const void* w,
                           const void* tile_group, void* out, int Mp, int K,
                           int N, int G, int block_m, int tile_m,
                           int smem_bytes, void* stream) {
  return dispatch<WeightKN>(lhs, w, tile_group, out, Mp, K, N, G, block_m,
                            tile_m, smem_bytes, stream);
}

}  // extern "C"
