// Flash attention forward, dq and dk/dv, GQA-aware, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   * flash_fwd  <- flash_forward  (_fwd_kernel, pallas_call at :122)
//   * flash_dq   <- flash_backward (_dq_kernel,  pallas_call at :245)
//   * flash_dkv  <- flash_backward (_dkv_kernel, pallas_call at :271, and
//                   the sum over each KV head's G query heads at :301-302)
// What they compute is the Pallas bodies' arithmetic, all in f32 (q, k, v
// and do are widened to f32 as flash_attention.py:77-79 does; p stays f32
// in the p·v product):
//   s = q·kᵀ·scale (softcap·tanh(s/softcap) in the forward when > 0);
//   live(q, k) = q < q_len && k < kv_len && (!causal || k <= q)
//                && (window <= 0 || q - k < window), positions counted from
//                0 in both sequences;
//   forward: online softmax over the live keys, o = acc / l, lse = m + log l;
//            a row with no live key writes o = 0 and lse = kNeg exactly;
//   dq:  p = exp(s - lse) where live (selected, never multiplied by a 0/1
//        mask: a dead row's s - lse overflows to inf), ds = p·(dp - delta)
//        ·scale with dp = do·vᵀ, dq = Σ_k ds·k;
//   dkv: dv = Σ pᵀ·do, dk = Σ dsᵀ·q over the G query heads of the KV head.
// delta = Σ do·o (f32) comes from the wrapper, as in the reference.
//
// Layout: q, o, do, dq [B, H, S, hd]; k, v, dk, dv [B, KH, T, hd]; each by
// its (batch, head, row) element strides, head_dim contiguous, so the model
// layout [B, S, H, hd] is read and written without a transpose copy.
// lse, delta [B, H, S] f32 contiguous. Query head h reads KV head h / G.
//
// Design. CUDA blocks run in no order, so the TPU's sequential grid axis
// becomes a loop inside the block. One block of 256 threads owns one
// TILE-row tile of its output (TILE = 64 for hd <= 128, 32 above, so that
// every tile fits in shared memory at hd 256):
//   * flash_fwd / flash_dq: a (b, h, q-tile) loops over its live k-tiles;
//   * flash_dkv: a (b, KV head, k-tile) loops over its G query heads and
//     their live q-tiles, keeping dk and dv in registers, and stores them
//     once in k's dtype: no atomics, no per-query-head scratch, the result
//     is deterministic.
// A k-tile (q-tile) is skipped when no element of it can be live
// (_tile_live, flash_attention.py:46-57), and also past kv_len (q_len),
// where every element is masked: a skipped tile adds exactly nothing.
// Tiles are staged in shared memory as f32, rows padded by 4 floats so the
// 16-byte reads of 8 neighbouring rows hit distinct banks. The score tile
// is a 16 x 16 grid of threads each owning (TILE/16)^2 scores; the row
// phases (softmax, the products into o, dq, dk, dv) give each row
// 256 / TILE threads, each owning float4 column groups of it.
//
// Bound on the card. At the training shapes (8 x 256 causal, 16 heads,
// 4 KV heads, hd 128, bf16) each kernel moves ~21-30 MB (6-9 us at
// 3.35 TB/s) against ~2-4.5 GFLOP of products (2-5 us at the 989 TFLOP/s
// bf16 tensor-core rate): bytes bound it. These kernels multiply with FMA
// on the FP32 pipe out of shared memory (no mma / wgmma, no TMA), so their
// products, not their bytes, set their time. bf16 at head_dim 64 and 128,
// the model's, runs on the tensor cores instead: the forward in
// flash_fwd_wgmma.cu, dq and dk/dv in flash_bwd_wgmma.cu (the wrapper's
// flash_fwd_route / flash_bwd_route). These kernels keep f32 inputs and
// the other head_dims. The dkv grid has only B * KH * (T / TILE) blocks
// (128 at the training shapes) and each walks G * (live q-tiles): it is
// the slowest of the three.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // as the TPU kernel
constexpr int THREADS = 256;
constexpr int kMaxGroups = 8;  // float4 column groups per thread (hd <= 256)

struct Layout {  // element strides of [batch, head, row, hd]
  long long b, h, s;
};

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

__device__ __forceinline__ bool live(int q, int k, int q_len, int kv_len,
                                     int causal, int window) {
  return q < q_len && k < kv_len && (!causal || k <= q) &&
         (window <= 0 || q - k < window);
}

// Whether tile (q0, k0) of TILE x TILE can hold a live element.
__device__ __forceinline__ bool tile_live(int q0, int k0, int tile,
                                          int causal, int window) {
  if (causal && k0 > q0 + tile - 1) return false;
  if (window > 0 && q0 - (k0 + tile - 1) >= window) return false;
  return true;
}

// Stage rows [row0, row0 + TILE) of one head into dst [TILE][ld] as f32;
// rows past n_rows are zero.
template <typename T, int TILE>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          Layout L, int b, int head,
                                          int row0, int n_rows, int hd,
                                          int ld) {
  const T* base = src + b * L.b + head * L.h;
  for (int idx = threadIdx.x; idx < TILE * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd, row = row0 + r;
    dst[r * ld + d] = row < n_rows ? to_f32(base[row * L.s + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * Bt[tx + 16 j][d] over TILE-row
// tiles A and Bt [TILE][ld] in shared memory.
template <int TILE>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         int hd, int ld,
                                         float (&acc)[TILE / 16][TILE / 16]) {
  constexpr int R = TILE / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    float4 a[R], bt[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < R; ++j)
      bt[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[i][j] = fmaf(a[i].x, bt[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bt[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bt[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bt[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 x) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

// Reductions over the TPR neighbouring lanes that share one row.
template <int TPR>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Store the float4 column groups of one row, divided by denom, in T.
template <typename T, int TPR>
__device__ __forceinline__ void store_row(T* dst,
                                          const float4 (&acc)[kMaxGroups],
                                          int part, int ng, float denom) {
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g >= ng) break;
    const int c = 4 * (part + TPR * g);
    dst[c] = from_f32<T>(acc[g].x / denom);
    dst[c + 1] = from_f32<T>(acc[g].y / denom);
    dst[c + 2] = from_f32<T>(acc[g].z / denom);
    dst[c + 3] = from_f32<T>(acc[g].w / denom);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Layout lq, Layout lk, Layout lv,
                 Layout lo, int H, int KH, int S, int T_, int hd, int q_len,
                 int kv_len, int causal, int window, float scale,
                 float softcap) {
  constexpr int R = TILE / 16, TPR = THREADS / TILE, PLD = TILE + 1;
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* Qs = smem;            // [TILE][ld]
  float* Ks = Qs + TILE * ld;  // [TILE][ld]
  float* Vs = Ks + TILE * ld;  // [TILE][ld]
  float* Ps = Vs + TILE * ld;  // [TILE][TILE + 1]: scores, then p

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int ng = hd / (4 * TPR);

  load_tile<T, TILE>(Qs, q, lq, b, h, q0, S, hd, ld);
  float m = kNeg, l = 0.f;
  float4 acc[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g)
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n_kt = q0 < q_len ? (kv_len + TILE - 1) / TILE : 0;
  for (int ik = 0; ik < n_kt; ++ik) {
    const int k0 = ik * TILE;
    if (!tile_live(q0, k0, TILE, causal, window)) continue;
    __syncthreads();  // the previous tile is consumed (and Qs staged)
    load_tile<T, TILE>(Ks, k, lk, b, kh, k0, T_, hd, ld);
    load_tile<T, TILE>(Vs, v, lv, b, kh, k0, T_, hd, ld);
    __syncthreads();

    float s[R][R];
    tile_dot<TILE>(Qs, Ks, hd, ld, s);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        Ps[row * PLD + col] =
            live(q0 + row, k0 + col, q_len, kv_len, causal, window) ? x
                                                                    : kNeg;
      }
    __syncthreads();

    // Online softmax of row r over this tile (TPR lanes per row).
    float mx = kNeg;
    for (int c = part; c < TILE; c += TPR) mx = fmaxf(mx, Ps[r * PLD + c]);
    const float m_new = fmaxf(m, row_max<TPR>(mx));
    float sum = 0.f;
    for (int c = part; c < TILE; c += TPR) {
      const bool ok = live(q0 + r, k0 + c, q_len, kv_len, causal, window);
      const float p = ok ? expf(Ps[r * PLD + c] - m_new) : 0.f;
      Ps[r * PLD + c] = p;
      sum += p;
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + row_sum<TPR>(sum);
    m = m_new;
    __syncwarp();  // the row's p values (written by its TPR lanes) visible
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      acc[g].x *= alpha; acc[g].y *= alpha; acc[g].z *= alpha;
      acc[g].w *= alpha;
    }
    for (int c = 0; c < TILE; ++c) {
      const float p = Ps[r * PLD + c];
      const float4* vr = reinterpret_cast<const float4*>(Vs + c * ld);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
        if (g < ng) fma4(acc[g], p, vr[part + TPR * g]);
    }
  }

  const int row = q0 + r;
  if (row < S) {
    const float denom = l == 0.f ? 1.f : l;
    store_row<T, TPR>(o + b * lo.b + h * lo.h + row * lo.s, acc, part, ng,
                      denom);
    if (part == 0)
      lse[((long long)b * H + h) * S + row] =
          l == 0.f ? kNeg : m + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// Backward: dq
// ---------------------------------------------------------------------------

template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldq,
                int H, int KH, int S, int T_, int hd, int q_len, int kv_len,
                int causal, int window, float scale) {
  constexpr int R = TILE / 16, TPR = THREADS / TILE, PLD = TILE + 1;
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* Qs = smem;             // [TILE][ld]
  float* DOs = Qs + TILE * ld;  // [TILE][ld]
  float* Ks = DOs + TILE * ld;  // [TILE][ld]
  float* Vs = Ks + TILE * ld;   // [TILE][ld]
  float* Ps = Vs + TILE * ld;   // [TILE][TILE + 1]: ds
  float* Ls = Ps + TILE * PLD;  // [TILE]: lse of the rows
  float* Ds = Ls + TILE;        // [TILE]: delta of the rows

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int ng = hd / (4 * TPR);

  load_tile<T, TILE>(Qs, q, lq, b, h, q0, S, hd, ld);
  load_tile<T, TILE>(DOs, dout, ldo, b, h, q0, S, hd, ld);
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const long long at = ((long long)b * H + h) * S + q0 + i;
    Ls[i] = q0 + i < S ? lse[at] : 0.f;
    Ds[i] = q0 + i < S ? delta[at] : 0.f;
  }
  float4 acc[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g)
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n_kt = q0 < q_len ? (kv_len + TILE - 1) / TILE : 0;
  for (int ik = 0; ik < n_kt; ++ik) {
    const int k0 = ik * TILE;
    if (!tile_live(q0, k0, TILE, causal, window)) continue;
    __syncthreads();
    load_tile<T, TILE>(Ks, k, lk, b, kh, k0, T_, hd, ld);
    load_tile<T, TILE>(Vs, v, lv, b, kh, k0, T_, hd, ld);
    __syncthreads();

    float s[R][R], dp[R][R];
    tile_dot<TILE>(Qs, Ks, hd, ld, s);
    tile_dot<TILE>(DOs, Vs, hd, ld, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        const bool ok = live(q0 + row, k0 + col, q_len, kv_len, causal,
                             window);
        const float p = ok ? expf(s[i][j] * scale - Ls[row]) : 0.f;
        Ps[row * PLD + col] = p * (dp[i][j] - Ds[row]) * scale;
      }
    __syncthreads();
    for (int c = 0; c < TILE; ++c) {
      const float ds = Ps[r * PLD + c];
      const float4* kr = reinterpret_cast<const float4*>(Ks + c * ld);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
        if (g < ng) fma4(acc[g], ds, kr[part + TPR * g]);
    }
  }

  const int row = q0 + r;
  if (row < S)
    store_row<T, TPR>(dq + b * ldq.b + h * ldq.h + row * ldq.s, acc, part,
                      ng, 1.f);
}

// ---------------------------------------------------------------------------
// Backward: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                 Layout ldo, Layout ldk, Layout ldv, int H, int KH, int S,
                 int T_, int hd, int q_len, int kv_len, int causal,
                 int window, float scale) {
  constexpr int R = TILE / 16, TPR = THREADS / TILE, PLD = TILE + 1;
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + 4;
  float* Ks = smem;              // [TILE][ld]
  float* Vs = Ks + TILE * ld;    // [TILE][ld]
  float* Qs = Vs + TILE * ld;    // [TILE][ld]
  float* DOs = Qs + TILE * ld;   // [TILE][ld]
  float* Ps = DOs + TILE * ld;   // [TILE q][TILE + 1]: p
  float* DSs = Ps + TILE * PLD;  // [TILE q][TILE + 1]: ds
  float* Ls = DSs + TILE * PLD;  // [TILE]
  float* Ds = Ls + TILE;         // [TILE]

  const int k0 = blockIdx.x * TILE, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;  // r: key row
  const int ng = hd / (4 * TPR);

  load_tile<T, TILE>(Ks, k, lk, b, kh, k0, T_, hd, ld);
  load_tile<T, TILE>(Vs, v, lv, b, kh, k0, T_, hd, ld);
  float4 acc_k[kMaxGroups], acc_v[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    acc_k[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_v[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int n_qt = k0 < kv_len ? (q_len + TILE - 1) / TILE : 0;
  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    for (int iq = 0; iq < n_qt; ++iq) {
      const int q0 = iq * TILE;
      if (!tile_live(q0, k0, TILE, causal, window)) continue;
      __syncthreads();  // the previous q-tile is consumed (and K, V staged)
      load_tile<T, TILE>(Qs, q, lq, b, h, q0, S, hd, ld);
      load_tile<T, TILE>(DOs, dout, ldo, b, h, q0, S, hd, ld);
      for (int i = threadIdx.x; i < TILE; i += THREADS) {
        const long long at = ((long long)b * H + h) * S + q0 + i;
        Ls[i] = q0 + i < S ? lse[at] : 0.f;
        Ds[i] = q0 + i < S ? delta[at] : 0.f;
      }
      __syncthreads();

      float s[R][R], dp[R][R];
      tile_dot<TILE>(Qs, Ks, hd, ld, s);   // rows: queries, cols: keys
      tile_dot<TILE>(DOs, Vs, hd, ld, dp);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int row = ty + 16 * i, col = tx + 16 * j;
          const bool ok = live(q0 + row, k0 + col, q_len, kv_len, causal,
                               window);
          const float p = ok ? expf(s[i][j] * scale - Ls[row]) : 0.f;
          Ps[row * PLD + col] = p;
          DSs[row * PLD + col] = p * (dp[i][j] - Ds[row]) * scale;
        }
      __syncthreads();
      for (int c = 0; c < TILE; ++c) {  // c: query row of the tile
        const float p = Ps[c * PLD + r], ds = DSs[c * PLD + r];
        const float4* dor = reinterpret_cast<const float4*>(DOs + c * ld);
        const float4* qr = reinterpret_cast<const float4*>(Qs + c * ld);
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < ng) {
            fma4(acc_v[g], p, dor[part + TPR * g]);
            fma4(acc_k[g], ds, qr[part + TPR * g]);
          }
      }
    }
  }

  const int row = k0 + r;
  if (row < T_) {
    store_row<T, TPR>(dk + b * ldk.b + kh * ldk.h + row * ldk.s, acc_k,
                      part, ng, 1.f);
    store_row<T, TPR>(dv + b * ldv.b + kh * ldv.h + row * ldv.s, acc_v,
                      part, ng, 1.f);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

Layout layout(const long long* st, int i) {
  return Layout{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int TILE>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const long long* st, int B, int H, int KH, int S, int T_, int hd,
        int q_len, int kv_len, int causal, int window, float scale,
        float softcap, void* stream) {
  const size_t smem =
      (size_t)(3 * TILE * (hd + 4) + TILE * (TILE + 1)) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, TILE>;
  if (int e = set_smem(kernel, smem)) return e;
  dim3 grid((S + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
      layout(st, 0), layout(st, 1), layout(st, 2), layout(st, 3), H, KH, S,
      T_, hd, q_len, kv_len, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int TILE>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, const long long* st,
       int B, int H, int KH, int S, int T_, int hd, int q_len, int kv_len,
       int causal, int window, float scale, void* stream) {
  const size_t smem = (size_t)(4 * TILE * (hd + 4) + TILE * (TILE + 1) +
                               2 * TILE) * sizeof(float);
  auto kernel = flash_dq_kernel<T, TILE>;
  if (int e = set_smem(kernel, smem)) return e;
  dim3 grid((S + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq_out, layout(st, 0),
      layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 4), H, KH, S,
      T_, hd, q_len, kv_len, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int TILE>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv,
        const long long* st, int B, int H, int KH, int S, int T_, int hd,
        int q_len, int kv_len, int causal, int window, float scale,
        void* stream) {
  const size_t smem = (size_t)(4 * TILE * (hd + 4) + 2 * TILE * (TILE + 1) +
                               2 * TILE) * sizeof(float);
  auto kernel = flash_dkv_kernel<T, TILE>;
  if (int e = set_smem(kernel, smem)) return e;
  dim3 grid((T_ + TILE - 1) / TILE, KH, B);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, layout(st, 0),
      layout(st, 1), layout(st, 2), layout(st, 3), layout(st, 4),
      layout(st, 5), H, KH, S, T_, hd, q_len, kv_len, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper checks hd % 32 == 0 and hd <= 256; TILE 64 keeps every tile
// within shared memory up to hd 128, TILE 32 above.
#define FLASH_ENTRY_POINTS(SUFFIX, T)                                         \
  int flash_fwd_##SUFFIX(const void* q, const void* k, const void* v,        \
                         void* o, void* lse, const long long* st, int B,     \
                         int H, int KH, int S, int T_, int hd, int q_len,    \
                         int kv_len, int causal, int window, float scale,    \
                         float softcap, void* stream) {                      \
    return hd <= 128                                                          \
               ? fwd<T, 64>(q, k, v, o, lse, st, B, H, KH, S, T_, hd, q_len, \
                            kv_len, causal, window, scale, softcap, stream)  \
               : fwd<T, 32>(q, k, v, o, lse, st, B, H, KH, S, T_, hd, q_len, \
                            kv_len, causal, window, scale, softcap, stream); \
  }                                                                           \
  int flash_dq_##SUFFIX(const void* q, const void* k, const void* v,         \
                        const void* dout, const void* lse,                   \
                        const void* delta, void* dq_out, const long long* st, \
                        int B, int H, int KH, int S, int T_, int hd,         \
                        int q_len, int kv_len, int causal, int window,       \
                        float scale, void* stream) {                         \
    return hd <= 128                                                          \
               ? dq<T, 64>(q, k, v, dout, lse, delta, dq_out, st, B, H, KH,  \
                           S, T_, hd, q_len, kv_len, causal, window, scale,  \
                           stream)                                            \
               : dq<T, 32>(q, k, v, dout, lse, delta, dq_out, st, B, H, KH,  \
                           S, T_, hd, q_len, kv_len, causal, window, scale,  \
                           stream);                                           \
  }                                                                           \
  int flash_dkv_##SUFFIX(const void* q, const void* k, const void* v,        \
                         const void* dout, const void* lse,                  \
                         const void* delta, void* dk, void* dv,              \
                         const long long* st, int B, int H, int KH, int S,   \
                         int T_, int hd, int q_len, int kv_len, int causal,  \
                         int window, float scale, void* stream) {            \
    return hd <= 128                                                          \
               ? dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, st, B, H, KH, \
                            S, T_, hd, q_len, kv_len, causal, window, scale, \
                            stream)                                           \
               : dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, st, B, H, KH, \
                            S, T_, hd, q_len, kv_len, causal, window, scale, \
                            stream);                                          \
  }

extern "C" {
FLASH_ENTRY_POINTS(bf16, __nv_bfloat16)
FLASH_ENTRY_POINTS(f32, float)
}  // extern "C"
