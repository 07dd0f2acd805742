// Expert weight gradient over tile-aligned groups, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py:gmm_dw_tiled
// (_dw_kernel, pallas_call at gmm.py:300), which the MoE FFN's backward
// calls three times per layer (ops.py:427, :432-433):
//   drhs[g] = sum over the m-tiles t of group g of lhs_t^T @ dout_t
// as [G, K, N] f32. A group that owns no tile gets exact zeros
// (gmm.py:321-324); the trailing pad tiles that the pack metadata clips to
// group G-1 (ops.py:223-225) hold zero rows and add nothing.
//
// Layout contract (the packed domain of ops.moe_ffn): lhs [Mp, K] row-major
// (bf16 or f32; bf16 is widened exactly, as the reference's astype(f32)),
// dout [Mp, N] f32 row-major, tile_group [Mp / block_m] int32 and
// non-decreasing (groups are contiguous runs of tiles), out [G, K, N] f32.
//
// Design. The TPU kernel walks the m-tiles on a sequential grid axis and
// carries each group's sum by revisiting the same output block; CUDA
// blocks run in no order. Here one block owns one (group, 64-row k-tile,
// 64-column n-tile) output tile: it finds its group's run of m-tiles by a
// binary search of tile_group (no host sync, no offsets array), then loops
// over those rows 16 at a time, staging a [16, 64] slice of lhs and of
// dout in shared memory (both read row-major, so neighbouring threads read
// neighbouring addresses) and keeping the f32 sums in registers (each
// thread owns a 4 x 4 micro-tile). A group's rows are a multiple of
// block_m, so of 8 but not always of 16: a last stage of 8 rows is masked
// to zero past the group's end, never read from the next group or past
// Mp (an instantiation of its own, taken where block_m % 16 == 8: the
// others keep the unmasked loop). One store per output, no atomics: the
// result is deterministic, and an empty group's loop runs zero times and
// stores zeros. Multiplies are FMA on the FP32 pipe; TF32 tensor cores
// would round the f32 dout and are not used.
//
// Bound on the card: operations. At the training shapes (4096 routed rows,
// d 2048, f 7168, 12 experts) each call does 2 * 4096 * 2048 * 7168 f32
// multiply-adds (~120 GFLOP, 1.8 ms at the 67 TFLOP/s FP32 peak) against
// ~0.9 GB of traffic (0.26 ms at 3.35 TB/s). This first version also runs
// the pad rows (Mp = 5632) and reaches a fraction of the FP32 peak;
// register-blocked or tensor-core (3xTF32 / bf16-split) versions are the
// later fix.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;       // output rows (the K axis) per block
constexpr int BN = 64;       // output columns (the N axis) per block
constexpr int BR = 16;       // packed rows per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// First index i in [0, n) with tile_group[i] > g (upper) or >= g (lower).
__device__ __forceinline__ int search(const int* tile_group, int n, int g,
                                      bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    int t = tile_group[mid];
    if (upper ? t <= g : t < g) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One stage: rows [r0, r0 + BR) of lhs and dout into shared memory as f32
// (where TAIL, the rows at or past row_hi as zeros), then acc += the
// stage's lhsᵀ·dout for this thread's 4 x 4 outputs.
template <bool TAIL, typename TA>
__device__ __forceinline__ void dw_stage(float (&As)[BR][BK],
                                         float (&Bs)[BR][BN],
                                         const TA* __restrict__ lhs,
                                         const float* __restrict__ dout,
                                         int r0, int row_hi, int k0, int n0,
                                         int K, int N, float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < (BR * BK) / THREADS; ++i) {
    int idx = tid + i * THREADS;
    int r = idx / BK, c = idx % BK;
    int k = k0 + c;
    As[r][c] = k < K && (!TAIL || r0 + r < row_hi)
                   ? to_f32(lhs[(size_t)(r0 + r) * K + k]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < (BR * BN) / THREADS; ++i) {
    int idx = tid + i * THREADS;
    int r = idx / BN, c = idx % BN;
    int n = n0 + c;
    Bs[r][c] = n < N && (!TAIL || r0 + r < row_hi)
                   ? dout[(size_t)(r0 + r) * N + n] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < BR; ++rr) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[rr][ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[rr][tx * 4 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
  __syncthreads();
}

// TAIL: block_m % 16 == 8, so a group may end half-way through a stage.
template <typename TA, bool TAIL>
__global__ void __launch_bounds__(THREADS)
gmm_dw_kernel(const TA* __restrict__ lhs, const float* __restrict__ dout,
              const int* __restrict__ tile_group, float* __restrict__ out,
              int K, int N, int n_tiles, int block_m) {
  __shared__ float As[BR][BK];
  __shared__ float Bs[BR][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BK;
  const int g = blockIdx.z;
  const int row_lo = search(tile_group, n_tiles, g, false) * block_m;
  const int row_hi = search(tile_group, n_tiles, g, true) * block_m;

  float acc[4][4] = {};
  if constexpr (TAIL) {
    int r0 = row_lo;
    for (; r0 + BR <= row_hi; r0 += BR)
      dw_stage<false>(As, Bs, lhs, dout, r0, row_hi, k0, n0, K, N, acc);
    if (r0 < row_hi)  // 8 rows left: an odd number of 8-row tiles
      dw_stage<true>(As, Bs, lhs, dout, r0, row_hi, k0, n0, K, N, acc);
  } else {
    for (int r0 = row_lo; r0 < row_hi; r0 += BR)
      dw_stage<false>(As, Bs, lhs, dout, r0, row_hi, k0, n0, K, N, acc);
  }

  float* o = out + (size_t)g * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx * 4 + j;
      if (n < N) o[(size_t)k * N + n] = acc[i][j];
    }
  }
}

template <typename TA>
int launch(const void* lhs, const void* dout, const void* tile_group,
           void* out, int G, int K, int N, int n_tiles, int block_m,
           void* stream) {
  if (block_m <= 0 || block_m % 8) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (K + BK - 1) / BK, G);
  auto kernel = block_m % BR ? gmm_dw_kernel<TA, true>
                             : gmm_dw_kernel<TA, false>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const TA*)lhs, (const float*)dout, (const int*)tile_group,
      (float*)out, K, N, n_tiles, block_m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entries take block_m % 8 == 0 and return cudaErrorInvalidValue
// otherwise; the wrapper checks first.
// gmm_dw_<lhs>: out [G, K, N] f32 = per-group lhs^T @ dout, dout f32.
int gmm_dw_bf16(const void* lhs, const void* dout, const void* tile_group,
                void* out, int G, int K, int N, int n_tiles, int block_m,
                void* stream) {
  return launch<__nv_bfloat16>(lhs, dout, tile_group, out, G, K, N, n_tiles,
                               block_m, stream);
}

int gmm_dw_f32(const void* lhs, const void* dout, const void* tile_group,
               void* out, int G, int K, int N, int n_tiles, int block_m,
               void* stream) {
  return launch<float>(lhs, dout, tile_group, out, G, K, N, n_tiles, block_m,
                       stream);
}

}  // extern "C"
