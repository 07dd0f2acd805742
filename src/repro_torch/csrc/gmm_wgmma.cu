// Grouped expert GEMM and fused GLU for bf16 operands on the tensor cores
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gmm.py for their bf16
// uses:
//   * gmm_tiled (_gmm_kernel, pallas_call at gmm.py:69)
//       out[m-tile] = lhs[m-tile] @ rhs[tile_group[m-tile]]
//   * _gmm_glu_call (_gmm_glu_kernel, pallas_call at gmm.py:222), reached
//     from gmm_glu_tiled_pair / gmm_glu_tiled (gmm_glu_wgmma_kernel below)
//       out[m-tile] = silu(lhs @ Wg[g]) * (lhs @ Wu[g]),  g = tile_group[..]
// with lhs [Mp, K] bf16 row-major (rows sorted by group, every group
// starting on a block_m boundary, pad rows zero), rhs [G, K, N] bf16
// row-major, tile_group [Mp / block_m] int32; f32 sums, rounded once to the
// output type: bf16 (the forward's down projection, ops.py:270, and the
// GLU, ops.py:268) or f32 (the MoE backward's recompute of g and u,
// ops.py:285). The f32-lhs data gradient against a transposed bf16 weight
// runs on gmm_f32_wgmma.cu; the other f32-operand variants, the f32 GLU and
// shapes off the multiples of 8 stay on the FMA kernel of csrc/gmm.cu.
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
// The GLU streams two weights: 1.41 GB at the serving shapes (0.42 ms); at
// the training shapes its 241 GFLOP of needed products (0.24 ms) bound it.
// Not done yet: a persistent grid with the epilogue of one tile under the
// loads of the next, TMA stores, and skipping all-pad tiles.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int BK = 64;     // k-depth of one stage: one 128-byte swizzled row
constexpr int BN = 256;    // columns of an output tile
constexpr int STAGES = 4;  // k-slices in flight
constexpr int GLU_BAND = 4;  // row tiles the GLU's block order walks together

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

// The fused GLU (_gmm_glu_kernel, gmm.py:132): out = g * logistic(g) * u
// with g = lhs @ Wg[group], u = lhs @ Wu[group], f32 sums, rounded once to
// bf16. The mainloop above with a tile of BN / 2 = 128 output columns: a
// stage's four 64-column weight chunks are the gate's columns n0 .. n0 + 127
// (chunks 0, 1, from gate_map) and the up weight's (chunks 2, 3, from
// up_map at column u_off + n0), so a stage has the bytes of the plain
// GEMM's and the lhs slice feeds both products. Each consumer warpgroup
// holds two m64n128 f32 accumulators (64 + 64 registers a thread, the
// m64n256 product's 128). The weight maps cover [G, K, ldw]: the pair form
// (gmm_glu_tiled_pair) passes one map of each weight and u_off = 0, the
// stacked form (gmm_glu_tiled, [G, K, 2N]) one map twice and u_off = N, so
// nothing is copied. Gate columns past N of the stacked form read the up
// half; they reach only output columns past N, which are not stored.
// Block order: bands of GLU_BAND row tiles, each band walked column slice
// by column slice, row tile fastest. The ~132 blocks in flight (4 rows x
// 33 column slices) share each weight slice among the band's row tiles (a
// group's row tiles, at the training shapes) and read 33 neighbouring
// slices of each weight row (the serving shapes, about one row tile a
// group). On the H100 the bands took 0.63 ms at the training shapes and
// 0.56 ms at the serving shapes; the GEMM's order (columns first) 0.76 and
// 0.57, rows first 0.64 and 0.61.
template <int NWG, bool PART>
__global__ void __launch_bounds__(Tile<NWG>::THREADS, 1)
gmm_glu_wgmma_kernel(const __grid_constant__ CUtensorMap lhs_map,
                     const __grid_constant__ CUtensorMap gate_map,
                     const __grid_constant__ CUtensorMap up_map,
                     const int* __restrict__ tile_group,
                     bf16* __restrict__ out, int K, int N, int u_off,
                     int block_m, int tile_m) {
  using T = Tile<NWG>;
  constexpr int GN = BN / 2;  // output columns of a tile
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * T::STAGE;  // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  if (!PART) tile_m = T::M;
  const int n_n = (N + GN - 1) / GN, n_m = gridDim.x / n_n;
  const int band = blockIdx.x / (GLU_BAND * n_n);
  const int band_rows = min(GLU_BAND, n_m - band * GLU_BAND);
  const int in_band = blockIdx.x - band * GLU_BAND * n_n;
  const int m0 = (band * GLU_BAND + in_band % band_rows) * tile_m;
  const int n0 = in_band / band_rows * GN;
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
        for (int j = 0; j < 2; ++j) {
          tma_load_3d(b + j * BK * 128, &gate_map, full(s), n0 + 64 * j,
                      kt * BK, g);
          tma_load_3d(b + (2 + j) * BK * 128, &up_map, full(s),
                      u_off + n0 + 64 * j, kt * BK, g);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows m0 + 64 wg .. + 63.
  const int wg = warp / 4;
  float acc_g[GN / 2], acc_u[GN / 2];
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc_g[i] = acc_u[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    const uint32_t a = base + s * T::STAGE + wg * 64 * 128;
    const uint32_t b = base + s * T::STAGE + T::A_BYTES;
    fence_regs(acc_g);
    fence_regs(acc_u);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      mma_ss<1>(acc_g, desc_k(a + kk * 32), desc_mn(b + kk * 2048, BK * 128));
      mma_ss<1>(acc_u, desc_k(a + kk * 32),
                desc_mn(b + 2 * BK * 128 + kk * 2048, BK * 128));
    }
    wgmma_commit();
    fence_regs(acc_g);
    fence_regs(acc_u);
    wgmma_wait<1>();  // the previous slice's products are done
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc_g);
  fence_regs(acc_u);

  // The reference's epilogue order on the f32 sums, one rounding to bf16.
  auto glu = [](float g, float u) { return g * (1.f / (1.f + expf(-g))) * u; };
  const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < GN / 8; ++i) {
    const int c = n0 + 8 * i + 2 * (lane % 4);
    if (c < N) {  // N % 8 == 0: c < N implies c + 1 < N
      if (!PART || r < tile_m)
        store2(out + (size_t)(m0 + r) * N + c, glu(acc_g[4 * i], acc_u[4 * i]),
               glu(acc_g[4 * i + 1], acc_u[4 * i + 1]));
      if (!PART || r + 8 < tile_m)
        store2(out + (size_t)(m0 + r + 8) * N + c,
               glu(acc_g[4 * i + 2], acc_u[4 * i + 2]),
               glu(acc_g[4 * i + 3], acc_u[4 * i + 3]));
    }
  }
}

// The host side of both kernels. w: [G, K, ldw] bf16 (the plain GEMM: its
// rhs, ldw = N); w_up and u_off: the GLU's up weight map and column offset
// (unused by the plain GEMM).
template <typename TO, int NWG, bool PART, bool GLU>
int launch(const void* lhs, const void* w, const void* w_up,
           const void* tile_group, void* out, int Mp, int K, int N, int G,
           int ldw, int u_off, int block_m, int tile_m, int smem_bytes,
           void* stream) {
  using T = Tile<NWG>;
  const bool tile_ok = PART ? tile_m < 64 && tile_m % 8 == 0
                            : tile_m == T::M;
  if (smem_bytes < smem_needed<NWG>() || !tile_ok || Mp % tile_m ||
      block_m % tile_m || K <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap lhs_map, w_map, up_map;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)Mp};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {BK, (cuuint32_t)tile_m};
  const cuuint64_t w_dims[3] = {(cuuint64_t)ldw, (cuuint64_t)K,
                                (cuuint64_t)G};
  const cuuint64_t w_strides[2] = {(cuuint64_t)ldw * 2,
                                   (cuuint64_t)K * ldw * 2};
  const cuuint32_t w_box[3] = {64, BK, 1};
  if (encode_bf16(&lhs_map, lhs, 2, a_dims, a_strides, a_box) ||
      encode_bf16(&w_map, w, 3, w_dims, w_strides, w_box) ||
      (GLU && encode_bf16(&up_map, w_up, 3, w_dims, w_strides, w_box)))
    return kEncodeFailed;
  static int opted = 0;  // the shared memory this kernel is opted into
  if constexpr (GLU) {
    auto kernel = gmm_glu_wgmma_kernel<NWG, PART>;
    if (int e = set_smem(kernel, smem_bytes, opted)) return e;
    dim3 grid(Mp / tile_m * ((N + BN / 2 - 1) / (BN / 2)));
    kernel<<<grid, T::THREADS, smem_bytes, (cudaStream_t)stream>>>(
        lhs_map, w_map, up_map, (const int*)tile_group, (bf16*)out, K, N,
        u_off, block_m, tile_m);
  } else {
    auto kernel = gmm_wgmma_kernel<TO, NWG, PART>;
    if (int e = set_smem(kernel, smem_bytes, opted)) return e;
    dim3 grid((N + BN - 1) / BN, Mp / tile_m);
    kernel<<<grid, T::THREADS, smem_bytes, (cudaStream_t)stream>>>(
        lhs_map, w_map, (const int*)tile_group, (TO*)out, K, N, block_m,
        tile_m);
  }
  return (int)cudaGetLastError();
}

template <typename TO, bool GLU>
int dispatch(const void* lhs, const void* w, const void* w_up,
             const void* tile_group, void* out, int Mp, int K, int N, int G,
             int ldw, int u_off, int block_m, int tile_m, int smem_bytes,
             void* stream) {
  if (tile_m == 128)
    return launch<TO, 2, false, GLU>(lhs, w, w_up, tile_group, out, Mp, K, N,
                                     G, ldw, u_off, block_m, tile_m,
                                     smem_bytes, stream);
  if (tile_m == 64)
    return launch<TO, 1, false, GLU>(lhs, w, w_up, tile_group, out, Mp, K, N,
                                     G, ldw, u_off, block_m, tile_m,
                                     smem_bytes, stream);
  if (tile_m == 32 || tile_m == 16 || tile_m == 8)
    return launch<TO, 1, true, GLU>(lhs, w, w_up, tile_group, out, Mp, K, N,
                                    G, ldw, u_off, block_m, tile_m,
                                    smem_bytes, stream);
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
  return dispatch<bf16, false>(lhs, rhs, nullptr, tile_group, out, Mp, K, N,
                               G, N, 0, block_m, tile_m, smem_bytes, stream);
}

int gmm_wgmma_f32(const void* lhs, const void* rhs, const void* tile_group,
                  void* out, int Mp, int K, int N, int G, int block_m,
                  int tile_m, int smem_bytes, void* stream) {
  return dispatch<float, false>(lhs, rhs, nullptr, tile_group, out, Mp, K, N,
                                G, N, 0, block_m, tile_m, smem_bytes, stream);
}

// out [Mp, N] bf16 = silu(lhs @ Wg[g]) * (lhs @ Wu[g]) per m-tile; lhs
// [Mp, K] bf16; w_gate and w_up [G, K, ldw] bf16 row-major, the up weight of
// output column n at column u_off + n of w_up. K, N, ldw and u_off are
// multiples of 8 and the tensors 16-byte aligned (the wrapper's route);
// tile_m and smem_bytes from the wrapper's plan (gmm_wgmma_plan).
int gmm_glu_wgmma(const void* lhs, const void* w_gate, const void* w_up,
                  const void* tile_group, void* out, int Mp, int K, int N,
                  int G, int ldw, int u_off, int block_m, int tile_m,
                  int smem_bytes, void* stream) {
  return dispatch<bf16, true>(lhs, w_gate, w_up, tile_group, out, Mp, K, N,
                              G, ldw, u_off, block_m, tile_m, smem_bytes,
                              stream);
}

}  // extern "C"
