// Paged single-token decode attention, split across blocks ("flash
// decoding"), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (_paged_decode_kernel, pallas_call at paged_attention.py:109, reached
// from paged_decode_forward). Per slot b and KV head h it computes, for the
// G query heads of that group, an online softmax over the slot's pages
// named by page_table[b, :]:
//   * line l of table slot j sits at key position j * page_size + l, live
//     when it is <= q_pos[b] (and within `window` of it when window > 0);
//   * table slots holding -1 are skipped, masked lines contribute exactly 0;
//   * a slot with no live key divides by 1 (output 0); q_pos < 0 writes 0;
//   * optional tanh soft-cap of the scaled logits. All math in f32.
//
// Layout: q / out [B, KH, G, hd]; pools [P, page_size, KH, hd] (one layer's
// pool, contiguous, 16-byte aligned); page_table [B, MP] int32; q_pos [B]
// int32; part: the wrapper's f32 scratch of the partials, acc [B * KH,
// splits, G, hd] then (m, l) [B * KH, splits, G, 2].
//
// Bound on the card: bytes. Decode reads every live K/V line once, 2 * pos
// * KH * hd * 2 bytes a slot (bf16), against about one operation per byte
// (G = 4 query rows per KV head: 4 G hd operations per 4 hd bytes of a
// line), far below the ~295 operations per byte at which the H100's tensor
// cores would be the limit, so the kernel keeps to the FMA pipe and spends
// its design on the bytes: many of them in flight, each read once.
//
// Design. The TPU walks a slot's pages in order (its sequential grid axis);
// here the walk is split across blocks:
//   * Grid (B * KH, splits). Block (bh, s) owns the table slots [s * pps,
//     (s + 1) * pps) of slot b (pps >= 1 pages; the wrapper picks splits
//     from B * KH, MP and the SM count so the grid covers the card) and
//     serves all G query heads of KV head h, so each K/V line is read once.
//     Only the key positions of the split that are live (a contiguous
//     range: the frontier and the window) are visited.
//   * The block walks its live lines in tiles of TL = 32 (whatever the page
//     size) through a ring of STAGES shared-memory stages filled with
//     16-byte cp.async copies of the input type (a line of hd 128 in bf16
//     is 256 bytes: 16 copies), the next tiles' copies in flight while the
//     current one is scored. Lines of -1 table slots or outside the live
//     range are not read: the copy fills zeros.
//   * Scoring: warp w takes heads w, w + 4, ...; lane i scores line i of
//     the tile (16-byte reads of K, each lane starting at another chunk so
//     the 8 lanes of a quarter-warp hit distinct banks) and the warp's
//     shuffles give the tile's max and sum: the online softmax of the TPU
//     kernel. Then each thread owns 4 output columns of one head and adds
//     p * V over the tile's lines (neighbouring threads, neighbouring
//     columns).
//   * Each block writes its partial (m, l, acc[G, hd]) in f32: m = -inf and
//     l = 0 for a split with no live line. A second kernel, one block per
//     (b, h), combines the splits in split order (no float atomics, so
//     reruns are bit-identical), skipping m = -inf (no exp(-inf - -inf)),
//     and divides by l (by 1 where no split had a live line). One C call
//     launches both kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TL = 32;         // key lines of a tile (one per lane)
constexpr int THREADS = 128;   // 4 warps
constexpr int NW = THREADS / 32;
constexpr int MAX_G = 32;      // query heads a KV head (8 a warp)
constexpr int MAX_HD = 256;
constexpr int HEADS_PER_WARP = MAX_G / NW;
// 4-column output units a thread owns: G * hd / 4 <= 2048 over 128 threads
constexpr int MAX_UNITS = MAX_G * MAX_HD / 4 / THREADS;

// Tiles in flight: bf16 3 (16 KB each at hd 128), f32 2.
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 2 ? 3 : 2;
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared memory of a launch: q in f32 [G, hd], the ring of K and V tiles,
// the tile's probabilities [G, TL] and rescale factors [G].
// kernels/paged_attention.py (paged_decode_plan) computes the same.
template <typename T>
__host__ __device__ constexpr int smem_needed(int G, int hd) {
  return align16(G * hd * 4) + stages<T>() * 2 * TL * hd * (int)sizeof(T) +
         G * TL * 4 + G * 4;
}

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

// 16 bytes global -> shared, asynchronously; zeros (nothing read) when
// !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q . k over one 16-byte chunk of a K line (8 bf16 or 4 f32 values).
__device__ __forceinline__ float dot_chunk(const __nv_bfloat16* k,
                                           const float* q, float acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  const float4 q0 = *reinterpret_cast<const float4*>(q);
  const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
  const float qs[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 kv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    acc = fmaf(qs[2 * i], kv.x, acc);
    acc = fmaf(qs[2 * i + 1], kv.y, acc);
  }
  return acc;
}
__device__ __forceinline__ float dot_chunk(const float* k, const float* q,
                                           float acc) {
  const float4 kv = *reinterpret_cast<const float4*>(k);
  const float4 qv = *reinterpret_cast<const float4*>(q);
  acc = fmaf(qv.x, kv.x, acc);
  acc = fmaf(qv.y, kv.y, acc);
  acc = fmaf(qv.z, kv.z, acc);
  return fmaf(qv.w, kv.w, acc);
}

// Four consecutive values of a V line, widened to f32.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(v);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* v) {
  return *reinterpret_cast<const float4*>(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ page_table,
                          const int* __restrict__ q_pos,
                          float* __restrict__ part, int KH, int G, int hd,
                          int ps, int MP, int pps, float scale, float softcap,
                          int window) {
  constexpr int STAGES = stages<T>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int bh = blockIdx.x, split = blockIdx.y, S = gridDim.y;
  const int b = bh / KH, h = bh % KH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int line = hd * (int)sizeof(T);         // bytes of a K or V line
  const int stage_bytes = 2 * TL * line;
  float* Qs = reinterpret_cast<float*>(smem);   // [G, hd]
  uint8_t* ring = smem + align16(G * hd * 4);   // STAGES x (K, V) tiles
  float* Ps = reinterpret_cast<float*>(ring + STAGES * stage_bytes);
  float* As = Ps + G * TL;                      // [G] rescale factors
  const size_t rows = (size_t)gridDim.x * S * G;
  float* acc_out = part + ((size_t)bh * S + split) * G * hd;
  float* ml_out = part + rows * hd + ((size_t)bh * S + split) * G * 2;

  // The split's live key positions [lo, hi]: its table slots [j0, j1),
  // the frontier q_pos and the window.
  const int qp = q_pos[b];
  const int j0 = split * pps, j1 = min(MP, j0 + pps);
  const int f_base = j0 * ps;
  const int lo = max(f_base, window > 0 ? qp - window + 1 : 0);
  const int hi = min(j1 * ps - 1, qp);
  if (qp < 0 || lo > hi) {  // no live line: m = -inf, l = 0
    for (int g = tid; g < G; g += THREADS) {
      ml_out[2 * g] = -INFINITY;
      ml_out[2 * g + 1] = 0.f;
    }
    return;
  }
  const int i0 = (lo - f_base) / TL;
  const int n_tiles = (hi - f_base) / TL - i0 + 1;
  const int* table = page_table + (size_t)b * MP;
  const int chunks = line / 16;                 // 16-byte copies a line

  // The page holding key position kpos, or -1 where the line is not read.
  auto page_of = [&](int kpos) {
    return kpos >= lo && kpos <= hi ? table[kpos / ps] : -1;
  };
  auto load_tile = [&](int i, int s) {
    uint8_t* kd = ring + s * stage_bytes;
    uint8_t* vd = kd + TL * line;
    const int kpos0 = f_base + (i0 + i) * TL;
    for (int c = tid; c < TL * chunks; c += THREADS) {
      const int r = c / chunks, col = c % chunks;
      const int kpos = kpos0 + r;
      const int page = page_of(kpos);
      const size_t src =
          page >= 0 ? (((size_t)page * ps + kpos % ps) * KH + h) * line +
                          col * 16
                    : 0;
      cp_async16(kd + r * line + col * 16,
                 reinterpret_cast<const uint8_t*>(k_pool) + src, page >= 0);
      cp_async16(vd + r * line + col * 16,
                 reinterpret_cast<const uint8_t*>(v_pool) + src, page >= 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int e = tid; e < G * hd; e += THREADS)
    Qs[e] = to_f32(q[(size_t)bh * G * hd + e]);

  float m[HEADS_PER_WARP], l[HEADS_PER_WARP];
#pragma unroll
  for (int k = 0; k < HEADS_PER_WARP; ++k) {
    m[k] = -INFINITY;
    l[k] = 0.f;
  }
  const int units = G * hd / 4, per_head = hd / 4;
  float4 acc[MAX_UNITS];
#pragma unroll
  for (int u = 0; u < MAX_UNITS; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int rot = lane % chunks;  // this lane's first chunk of a K line

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage and Ps are free
    if (t + STAGES - 1 < n_tiles)
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint8_t* ks = ring + (t % STAGES) * stage_bytes;
    const uint8_t* vs = ks + TL * line;

    // Scores and the online softmax: lane = line of the tile.
    const int kpos = f_base + (i0 + t) * TL + lane;
    const bool live = page_of(kpos) >= 0;
    const T* kl = reinterpret_cast<const T*>(ks + lane * line);
#pragma unroll
    for (int k = 0; k < HEADS_PER_WARP; ++k) {
      const int g = warp + NW * k;
      if (g >= G) break;  // warp-uniform
      float sc = -INFINITY;
      if (live) {
        const float* qg = Qs + g * hd;
        // four partial sums (chunks is a multiple of 4): a quarter of the
        // dependent FMA chain
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        for (int i = 0, c = rot; i < chunks; i += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = c * 16 / (int)sizeof(T);  // first element
            dot[j] = dot_chunk(kl + e, qg + e, dot[j]);
            if (++c == chunks) c = 0;
          }
        }
        sc = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      }
      const float m_new = fmaxf(m[k], warp_max(sc));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // warp-uniform: some line live so far
        alpha = expf(m[k] - m_new);  // 0 while m[k] = -inf
        p = live ? expf(sc - m_new) : 0.f;
        l[k] = l[k] * alpha + warp_sum(p);
        m[k] = m_new;
      }
      Ps[g * TL + lane] = p;
      if (lane == 0) As[g] = alpha;
    }
    __syncthreads();  // Ps and As of every head

    // acc[g, d0 .. d0 + 3] = alpha acc + sum over the tile's lines p v.
#pragma unroll
    for (int u = 0; u < MAX_UNITS; ++u) {
      const int unit = tid + THREADS * u;
      if (unit >= units) break;
      const int g = unit / per_head, d0 = (unit % per_head) * 4;
      const float a = As[g];
      float4 o = make_float4(acc[u].x * a, acc[u].y * a, acc[u].z * a,
                             acc[u].w * a);
      const float* pg = Ps + g * TL;
#pragma unroll 8
      for (int r = 0; r < TL; ++r) {
        const float p = pg[r];
        const float4 v = load4(reinterpret_cast<const T*>(vs + r * line) + d0);
        o.x = fmaf(p, v.x, o.x);
        o.y = fmaf(p, v.y, o.y);
        o.z = fmaf(p, v.z, o.z);
        o.w = fmaf(p, v.w, o.w);
      }
      acc[u] = o;
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < MAX_UNITS; ++u) {
    const int unit = tid + THREADS * u;
    if (unit >= units) break;
    const int g = unit / per_head, d0 = (unit % per_head) * 4;
    *reinterpret_cast<float4*>(acc_out + g * hd + d0) = acc[u];
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < HEADS_PER_WARP; ++k) {
      const int g = warp + NW * k;
      if (g >= G) break;
      ml_out[2 * g] = m[k];
      ml_out[2 * g + 1] = l[k];
    }
  }
}

// out[b, h] = (sum_s e^(m_s - M) acc_s) / (sum_s e^(m_s - M) l_s) over the
// splits s in order, M = max_s m_s; splits with m_s = -inf are skipped;
// 0 where no split had a live line or q_pos < 0. With lse (may be null):
// lse[b, h] = M + log(sum_s e^(m_s - M) l_s), the log of the softmax's
// denominator in the scaled-score domain, and -inf where out is 0 for
// want of a live line (the weight a log-sum-exp merge gives it is 0).
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ q_pos,
                            T* __restrict__ out, float* __restrict__ lse,
                            int KH, int G, int hd, int S) {
  const int bh = blockIdx.x;
  const bool dead = q_pos[bh / KH] < 0;
  const size_t rows = (size_t)gridDim.x * S * G;
  const float* acc = part + (size_t)bh * S * G * hd;
  const float* ml = part + rows * hd + (size_t)bh * S * G * 2;
  T* o = out + (size_t)bh * G * hd;
  const int per_head = hd / 4;
  for (int unit = threadIdx.x; unit < G * per_head; unit += THREADS) {
    const int g = unit / per_head, d0 = (unit % per_head) * 4;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    float M = -INFINITY;
    if (!dead)
      for (int s = 0; s < S; ++s) M = fmaxf(M, ml[(s * G + g) * 2]);
    float L = 0.f;
    if (M != -INFINITY) {
      for (int s = 0; s < S; ++s) {
        const float ms = ml[(s * G + g) * 2];
        if (ms == -INFINITY) continue;
        const float w = expf(ms - M);
        L += w * ml[(s * G + g) * 2 + 1];
        const float4 a =
            *reinterpret_cast<const float4*>(acc + (s * G + g) * hd + d0);
        r.x += w * a.x;
        r.y += w * a.y;
        r.z += w * a.z;
        r.w += w * a.w;
      }
      const float denom = L == 0.f ? 1.f : L;
      r = make_float4(r.x / denom, r.y / denom, r.z / denom, r.w / denom);
    }
    if (lse != nullptr && d0 == 0)
      lse[(size_t)bh * G + g] = M == -INFINITY ? -INFINITY : M + logf(L);
    o[g * hd + d0] = from_f32<T>(r.x);
    o[g * hd + d0 + 1] = from_f32<T>(r.y);
    o[g * hd + d0 + 2] = from_f32<T>(r.z);
    o[g * hd + d0 + 3] = from_f32<T>(r.w);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* q_pos, void* part, void* out,
           void* lse, int B, int KH, int G, int hd, int ps, int MP,
           int splits, int pps, int smem_bytes, float scale, float softcap,
           int window, void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || G > MAX_G || hd <= 0 || hd % 32 ||
      hd > MAX_HD || ps <= 0 || ps > 128 || MP < 0 || pps <= 0 ||
      splits != (MP > 0 ? (MP + pps - 1) / pps : 1) ||
      smem_bytes < smem_needed<T>(G, hd) || smem_bytes > 232448 ||
      (reinterpret_cast<uintptr_t>(k_pool) |
       reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_split_kernel<T>;
  static int opted = 0;  // the shared memory this kernel is opted into
  if (smem_bytes > 48 * 1024 && smem_bytes != opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    opted = smem_bytes;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  kernel<<<dim3(B * KH, splits), THREADS, smem_bytes, st>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool,
      (const int*)page_table, (const int*)q_pos, (float*)part, KH, G, hd, ps,
      MP, pps, scale, softcap, window);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  paged_decode_combine_kernel<T><<<B * KH, THREADS, 0, st>>>(
      (const float*)part, (const int*)q_pos, (T*)out, (float*)lse, KH, G,
      hd, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B, KH, G, hd] = decode attention of q over the paged pools (see the
// note above); part: f32 scratch of B * KH * splits * G * (hd + 2) values;
// lse: null, or f32 [B, KH, G] receiving each row's log-sum-exp (the
// combine kernel's note). splits = ceil(MP / pps) (1 when MP = 0) and
// smem_bytes come from the wrapper's plan (paged_decode_plan); returns
// cudaErrorInvalidValue for shapes the kernel does not take (hd % 32,
// hd > 256, page_size > 128, G > 32) or pools that are not 16-byte
// aligned (the wrapper checks first).
int paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                      const void* page_table, const void* q_pos, void* part,
                      void* out, void* lse, int B, int KH, int G, int hd,
                      int ps, int MP, int splits, int pps, int smem_bytes,
                      float scale, float softcap, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, q_pos, part,
                               out, lse, B, KH, G, hd, ps, MP, splits, pps,
                               smem_bytes, scale, softcap, window, stream);
}

int paged_decode_f32(const void* q, const void* k_pool, const void* v_pool,
                     const void* page_table, const void* q_pos, void* part,
                     void* out, void* lse, int B, int KH, int G, int hd,
                     int ps, int MP, int splits, int pps, int smem_bytes,
                     float scale, float softcap, int window, void* stream) {
  return launch<float>(q, k_pool, v_pool, page_table, q_pos, part, out, lse,
                       B, KH, G, hd, ps, MP, splits, pps, smem_bytes, scale,
                       softcap, window, stream);
}

}  // extern "C"
