// Grouped expert GEMMs over tile-aligned groups, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gmm.py:
//   * gmm_tiled      (_gmm_kernel, pallas_call at gmm.py:69)
//       out[m-tile] = lhs[m-tile] @ rhs[tile_group[m-tile]]
//   * _gmm_glu_call  (_gmm_glu_kernel, pallas_call at gmm.py:222), reached
//     from gmm_glu_tiled_pair / gmm_glu_tiled
//       out[m-tile] = silu(lhs @ Wg[g]) * (lhs @ Wu[g]),  g = tile_group[..]
//
// Layout contract (the packed domain of ops.moe_ffn): lhs [Mp, K] row-major,
// rows sorted by group and every group starting on a block_m boundary;
// tile_group [Mp / block_m] int32. The weight element (k, n) of group g is
// read at W + g * gstride + k * ldw + n, or, for a transposed operand
// (TRANS_B: the backward's swapaxes(W, 1, 2), read by stride instead of
// copied), at W + g * gstride + n * ldw + k.
//
// Types. lhs, rhs and out each have their own type. This file keeps the
// uses with an f32 operand: f32 x f32 -> f32 (the f32 policy's forward),
// and in the MoE backward (ops.py:414-437) f32 x bf16 -> f32 (y = h @ wo
// on the unrounded f32 h) and f32 x bf16^T -> f32 / f32 x f32^T -> f32
// (data gradients against the transposed weights), plus the fused GLU in
// bf16 and f32. bf16 x bf16 -> bf16 / f32 (the forward's down projection
// and the backward's recompute of g and u) runs on the tensor cores in
// gmm_wgmma.cu, and so do f32 x bf16 and f32 x bf16^T where K and N are
// multiples of 8 (gmm_f32_wgmma.cu): here they keep the other shapes. Only
// those combinations are exported below.
//
// Design. One CUDA block per (m-tile, 64-column n-tile). The m-tile has
// rows = min(64, the largest power of two dividing block_m) rows, so it
// lies in one group: any block_m that is a multiple of 8 is taken, as the
// reference's capacity routing produces (ops.py:625-627); the block keeps
// its 64-row thread layout and masks the rows past its tile out of the
// loads and the store (up to 8x wasted FMA work at block_m 8). The block
// reads tile_group itself and selects its group's weight pointer (the TPU
// kernel's scalar-prefetched index map). A loop over 16-deep k-tiles staged
// in shared memory replaces the TPU's sequential k grid axis; sums stay in
// f32 registers (each thread owns a 4x4 micro-tile; the GLU variant owns a
// gate and an up micro-tile that share every lhs tile), and the silu*mul
// epilogue runs on the f32 sums before the single store. Ragged K/N edges
// are masked in the loads, so the wrapper pads nothing. Operands are
// widened to f32 in shared memory (exact for bf16) and multiplied with
// FMA: the simple first version, with no tensor cores. A transposed
// operand is loaded k-fastest, so neighbouring threads still read
// neighbouring addresses, into a shared tile padded by one column so the
// k-fastest stores hit distinct banks.
//
// Bound on the card: the fused GLU at the serving shapes (K = 2048,
// N = 7168, 24 experts, a few hundred routed rows) needs a weight stream,
// ~1.4 GB per call, so its floor is bytes / 3.35 TB/s. At the training
// shapes (4096 routed rows over 12 experts) the f32-operand calls are bound
// by the FP32 pipe's operations. This kernel runs every padded row on the
// FP32 pipe, so it sits far above either floor; the GLU can reuse the
// tensor-core mainloop of gmm_wgmma.cu, and the f32 operands need a
// bf16-split or 3xTF32 scheme (later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TA, typename TB, typename TO, bool GLU, bool TRANS_B>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const TA* __restrict__ lhs, const TB* __restrict__ w_gate,
           const TB* __restrict__ w_up, const int* __restrict__ tile_group,
           TO* __restrict__ out, int K, int N, int ldw, int u_off,
           int block_m, int rows) {
  constexpr int BNP = TRANS_B ? BN + 1 : BN;
  __shared__ float As[BK][BM];
  __shared__ float Bg[BK][BNP];
  __shared__ float Bu[GLU ? BK : 1][GLU ? BNP : 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * rows;
  const int n0 = blockIdx.x * BN;
  const int g = tile_group[m0 / block_m];
  const size_t gstride = (size_t)(TRANS_B ? N : K) * ldw;
  const TB* wg = w_gate + g * gstride;
  const TB* wu = GLU ? w_up + g * gstride + u_off : nullptr;

  float acc_g[4][4] = {};
  float acc_u[GLU ? 4 : 1][GLU ? 4 : 1] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      int idx = tid + i * THREADS;
      int r = idx / BK, c = idx % BK;
      int k = k0 + c;
      As[c][r] = k < K && r < rows ? to_f32(lhs[(size_t)(m0 + r) * K + k])
                                   : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      int idx = tid + i * THREADS;
      // k-fastest for a transposed operand, n-fastest otherwise: either way
      // neighbouring threads read neighbouring addresses.
      int r = TRANS_B ? idx % BK : idx / BN;
      int c = TRANS_B ? idx / BK : idx % BN;
      int k = k0 + r, n = n0 + c;
      bool in = k < K && n < N;
      size_t at = TRANS_B ? (size_t)n * ldw + k : (size_t)k * ldw + n;
      Bg[r][c] = in ? to_f32(wg[at]) : 0.f;
      if constexpr (GLU) Bu[r][c] = in ? to_f32(wu[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bg[4], bu[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bg[j] = Bg[kk][tx * 4 + j];
        if constexpr (GLU) bu[j] = Bu[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_g[i][j] = fmaf(a[i], bg[j], acc_g[i][j]);
          if constexpr (GLU) acc_u[i][j] = fmaf(a[i], bu[j], acc_u[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ty * 4 + i >= rows) break;
    int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc_g[i][j];
      if constexpr (GLU) {
        float gate = v;
        v = gate * (1.f / (1.f + expf(-gate))) * acc_u[i][j];
      }
      out[(size_t)m * N + n] = from_f32<TO>(v);
    }
  }
}

template <typename TA, typename TB, typename TO, bool GLU, bool TRANS_B>
int launch(const void* lhs, const void* w_gate, const void* w_up,
           const void* tile_group, void* out, int Mp, int K, int N, int ldw,
           int u_off, int block_m, void* stream) {
  if (block_m <= 0 || block_m % 8 || Mp % block_m)
    return (int)cudaErrorInvalidValue;
  const int pow2 = block_m & -block_m;  // largest power of two dividing it
  const int rows = pow2 < BM ? pow2 : BM;
  dim3 grid((N + BN - 1) / BN, Mp / rows);
  gmm_kernel<TA, TB, TO, GLU, TRANS_B>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const TA*)lhs, (const TB*)w_gate, (const TB*)w_up,
          (const int*)tile_group, (TO*)out, K, N, ldw, u_off, block_m, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gmm_<lhs>_<rhs>_<out>: out = lhs @ rhs[g], rhs row-major [G, K, ldw].
// gmm_t_<lhs>_<rhs>_<out>: the same with rhs[g] = W[g]^T, W row-major
// [G, N, ldw] (ldw >= K), read by stride. Every entry takes a block_m
// that is a multiple of 8 and divides Mp (a CUDA block's rows are min(64,
// the largest power of two dividing block_m)) and returns
// cudaErrorInvalidValue otherwise; the wrapper checks first.
#define GMM_ENTRY(NAME, TA, TB, TO, TRANS)                                  \
  int NAME(const void* lhs, const void* rhs, const void* tile_group,       \
           void* out, int Mp, int K, int N, int ldw, int block_m,          \
           void* stream) {                                                  \
    return launch<TA, TB, TO, false, TRANS>(lhs, rhs, nullptr, tile_group, \
                                            out, Mp, K, N, ldw, 0, block_m, \
                                            stream);                        \
  }

using bf16 = __nv_bfloat16;
GMM_ENTRY(gmm_f32_f32_f32, float, float, float, false)
GMM_ENTRY(gmm_f32_bf16_f32, float, bf16, float, false)
GMM_ENTRY(gmm_t_f32_bf16_f32, float, bf16, float, true)
GMM_ENTRY(gmm_t_f32_f32_f32, float, float, float, true)

int gmm_glu_bf16(const void* lhs, const void* w_gate, const void* w_up,
                 const void* tile_group, void* out, int Mp, int K, int N,
                 int ldw, int u_off, int block_m, void* stream) {
  return launch<bf16, bf16, bf16, true, false>(
      lhs, w_gate, w_up, tile_group, out, Mp, K, N, ldw, u_off, block_m,
      stream);
}

int gmm_glu_f32(const void* lhs, const void* w_gate, const void* w_up,
                const void* tile_group, void* out, int Mp, int K, int N,
                int ldw, int u_off, int block_m, void* stream) {
  return launch<float, float, float, true, false>(
      lhs, w_gate, w_up, tile_group, out, Mp, K, N, ldw, u_off, block_m,
      stream);
}

}  // extern "C"
