// Paged single-token decode attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (_paged_decode_kernel, pallas_call at paged_attention.py:109, reached
// from paged_decode_forward). Per slot b and KV head h it computes, for the
// G query heads of that group, one online-softmax pass over the slot's pages
// named by page_table[b, :]:
//   * line l of table slot j sits at key position j * page_size + l, live
//     when it is <= q_pos[b] (and within `window` of it when window > 0);
//   * table slots holding -1 are skipped, masked lines contribute exactly 0;
//   * a slot with no live key divides by 1 (output 0); q_pos < 0 writes 0;
//   * optional tanh soft-cap of the scaled logits. All math in f32.
//
// Layout: q / out [B, KH, G, hd]; pools [P, page_size, KH, hd] (one layer's
// pool, contiguous); page_table [B, MP] int32; q_pos [B] int32.
//
// Design. One block per (b, h) with one warp per query head, so all G heads
// of a group share every K/V page read. The block walks the table slots in
// order (the TPU's sequential page axis); for a live slot it stages the
// head's page lines of K and V in shared memory (f32, rows padded by one
// word so lane-per-line reads hit distinct banks), each lane scores one
// line, the warp reduces max and sum with shuffles, and each lane keeps
// hd/32 output accumulators. The TPU wrapper's padding of G to 8 and hd to
// 128 is not needed here and is not done.
//
// Bound on the card: bytes. Decode reads every live K/V line once,
// 2 * pos * KH * hd * 2 bytes per slot, against ~4 flops per byte; the
// floor is those bytes / 3.35 TB/s. At serving sizes (a few slots, a few
// hundred positions) the grid has only B * KH blocks, so launch latency
// and the serial page walk dominate, not bandwidth.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // as the TPU kernel
constexpr int kMaxChunks = 4;   // page_size <= 128 (one line per lane)
constexpr int kMaxDims = 8;     // head_dim <= 256 (hd / 32 per lane)

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ q_pos, T* __restrict__ out, int KH, int G,
    int hd, int ps, int MP, float scale, float softcap, int window) {
  extern __shared__ float smem[];
  const int row = hd + 1;
  float* Ks = smem;              // [ps][hd + 1]
  float* Vs = Ks + ps * row;     // [ps][hd + 1]
  float* Qs = Vs + ps * row;     // [G][hd]

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_dims = hd / 32;
  const size_t qo = (((size_t)b * KH + h) * G + warp) * hd;
  const int qp = q_pos[b];

  if (qp < 0) {
    for (int i = 0; i < n_dims; ++i) out[qo + lane + 32 * i] = from_f32<T>(0.f);
    return;
  }
  for (int i = 0; i < n_dims; ++i)
    Qs[warp * hd + lane + 32 * i] = to_f32(q[qo + lane + 32 * i]);

  float m = kNeg, l = 0.f;
  float acc[kMaxDims];
#pragma unroll
  for (int i = 0; i < kMaxDims; ++i) acc[i] = 0.f;

  const int n_chunks = (ps + 31) / 32;
  for (int j = 0; j < MP; ++j) {
    const int page = page_table[b * MP + j];
    if (page < 0) continue;  // unallocated table slot: skipped
    __syncthreads();         // previous page fully consumed (and Qs staged)
    for (int idx = threadIdx.x; idx < ps * hd; idx += blockDim.x) {
      int line = idx / hd, d = idx % hd;
      size_t src = (((size_t)page * ps + line) * KH + h) * hd + d;
      Ks[line * row + d] = to_f32(k_pool[src]);
      Vs[line * row + d] = to_f32(v_pool[src]);
    }
    __syncthreads();

    float s[kMaxChunks];
    bool live[kMaxChunks];
    float m_page = kNeg;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      s[c] = kNeg;
      live[c] = false;
      int line = c * 32 + lane;
      if (c >= n_chunks || line >= ps) continue;
      const float* kr = Ks + line * row;
      const float* qr = Qs + warp * hd;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      float sc = dot * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      int kpos = j * ps + line;
      bool ok = kpos <= qp && (window <= 0 || qp - kpos < window);
      live[c] = ok;
      s[c] = ok ? sc : kNeg;
      m_page = fmaxf(m_page, s[c]);
    }
    const float m_new = fmaxf(m, warp_max(m_page));
    float p[kMaxChunks];
    float p_sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      p[c] = live[c] ? expf(s[c] - m_new) : 0.f;
      p_sum += p[c];
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p_sum);
#pragma unroll
    for (int i = 0; i < kMaxDims; ++i) acc[i] *= alpha;
    for (int line = 0; line < ps; ++line) {
      float pl = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
        if (c == line / 32) pl = __shfl_sync(0xffffffffu, p[c], line % 32);
      const float* vr = Vs + line * row;
#pragma unroll
      for (int i = 0; i < kMaxDims; ++i)
        if (i < n_dims) acc[i] = fmaf(pl, vr[lane + 32 * i], acc[i]);
    }
    m = m_new;
  }

  const float denom = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < kMaxDims; ++i)
    if (i < n_dims) out[qo + lane + 32 * i] = from_f32<T>(acc[i] / denom);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* q_pos, void* out, int B,
           int KH, int G, int hd, int ps, int MP, float scale, float softcap,
           int window, void* stream) {
  size_t smem = (size_t)(2 * ps * (hd + 1) + G * hd) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, KH);
  paged_decode_kernel<T><<<grid, G * 32, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool,
      (const int*)page_table, (const int*)q_pos, (T*)out, KH, G, hd, ps, MP,
      scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                      const void* page_table, const void* q_pos, void* out,
                      int B, int KH, int G, int hd, int ps, int MP,
                      float scale, float softcap, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, q_pos, out, B,
                               KH, G, hd, ps, MP, scale, softcap, window,
                               stream);
}

int paged_decode_f32(const void* q, const void* k_pool, const void* v_pool,
                     const void* page_table, const void* q_pos, void* out,
                     int B, int KH, int G, int hd, int ps, int MP,
                     float scale, float softcap, int window, void* stream) {
  return launch<float>(q, k_pool, v_pool, page_table, q_pos, out, B, KH, G,
                       hd, ps, MP, scale, softcap, window, stream);
}

}  // extern "C"
