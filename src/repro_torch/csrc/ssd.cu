// mamba2 SSD (state-space duality) chunk scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd.py: ssd_pallas
// (_ssd_kernel, pallas_call at :82). It computes what _ssd_kernel
// computes, all in f32. Per (batch, head), over the chunks of Q rows in
// order, with x̄ = x·dt and la = dt·A (the same single f32 multiplies as
// ops.py:679-681):
//   cum = inclusive cumsum(la) within the chunk, total = cum[last];
//   y   = (C·Bᵀ ⊙ L)·x̄ + exp(cum)·(C·S),  L[i, j] = exp(cum_i - cum_j) for
//         j <= i and 0 above the diagonal (a select: the reference's
//         exp(-60)·0 is exactly 0);
//   S  <- exp(total)·S + Bᵀ·(x̄ ⊙ exp(total - cum));
// and at the end the final S transposed to [hd, ns]. B and C are shared by
// the heads of a batch. The last chunk's rows past T are masked in place
// of the reference's zero pad (la = 0, x̄ = 0: the pad was a no-op).
//
// Layout: x [b, T, h, hd] (bf16 or f32), dt [b, T, h] f32, A [h] f32, B and
// C [b, T, ns] in x's dtype, each read by its element strides with the last
// axis contiguous, so the slices of the conv output that the model hands
// over are read in place; y [b, T, h, hd] in x's dtype; state [b, h, hd, ns]
// f32, contiguous.
//
// Design. The TPU walks the chunk axis as a sequential grid dimension and
// keeps S in a VMEM scratch. Here one block of 256 threads owns one
// (batch, head) and loops over the chunks itself, with S ([ns, hd] f32, 32
// KB at ns 128, hd 64) in shared memory. A 256-row chunk does not fit in
// shared memory whole (x̄, B and C alone are ~320 KB in f32), so the
// intra-chunk term is tiled: 64-row i-tiles of C, and for each the j-tiles
// <= i of B and x̄; tiles above the diagonal are skipped outright. Each
// i-tile's y starts from the inter-chunk term exp(cum)·(C·S), takes the
// masked, decayed G = C·Bᵀ tile through shared memory and adds G·x̄; after
// the last i-tile the state update walks the j-tiles once more. Products
// are register-blocked FMA on the FP32 pipe: a 16 x 16 thread grid, each
// thread 4 x 4 of a G tile and 4 rows x hd/16 columns of y. The cumsum is
// one thread's loop in row order (the order of torch.cumsum on the CPU).
//
// Bound on the card. At the training shape (b 2, T 2048, h 80, hd 64, ns
// 128, Q 256) the work that is needed is ~16 GFLOP of f32 products (the
// causal half of G·x̄, C·S, the state update, and C·Bᵀ once per batch and
// chunk): 0.24 ms at the 67 TFLOP/s f32 rate, against ~92 MB of bytes
// (0.03 ms): operations bound it. This kernel does ~31 GFLOP (C·Bᵀ per
// head, full 64 x 64 diagonal tiles) without tensor cores: tensor cores
// would round the f32 x̄ (TF32), and the first version is right before it
// is fast. 160 (batch, head) blocks run on 132 SMs, one each (~140 KB of
// shared memory): two waves, the second one fifth full. Sharing C·Bᵀ
// across the heads of a batch, or splitting hd over two blocks, are the
// later fixes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int TR = 64;        // rows of an i- or j-tile
constexpr int G_LD = TR + 16; // padded row of the G tile (2 rows of a warp
                              // land 16 banks apart)
constexpr int MAX_NS = 128;   // the wrapper checks ns % 16 == 0, ns <= 128

struct Strides {  // element strides
  long long xb, xt, xh, db, dtt, dh, bb, bt, cb, ct, yb, yt, yh;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// N contiguous floats of shared memory (16-byte aligned when N % 4 == 0).
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// dst[r][c] = r < live ? src[r * row_stride + c] : 0 for r < TR, c < width
// (width % 4 == 0, width / 4 <= THREADS: the threads of one column group
// start on every row below THREADS / (width / 4) and stride by it).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int live,
                                          int width) {
  const int w4 = width / 4;
  const int c = (threadIdx.x % w4) * 4;
  for (int r = threadIdx.x / w4; r < TR; r += THREADS / w4) {
    float* d = dst + r * ld + c;
    if (r < live) {
      const T* s = src + r * row_stride + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = to_f32(s[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = 0.f;
    }
  }
}

// X[r][c] = x[r][c]·dt[r] (·wt[r] when wt is given) for r < live, else 0.
template <typename T, int HD>
__device__ __forceinline__ void load_xbar(float* X, const T* x,
                                          long long xt, const float* dt,
                                          long long dtt, const float* wt,
                                          int live) {
  constexpr int W4 = HD / 4;
  const int c = (threadIdx.x % W4) * 4;
  for (int r = threadIdx.x / W4; r < TR; r += THREADS / W4) {
    float* d = X + r * HD + c;
    if (r < live) {
      const T* s = x + r * xt + c;
      const float dtr = dt[r * dtt];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xb = to_f32(s[q]) * dtr;
        d[q] = wt ? xb * wt[r] : xb;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state, Strides st, int T_, int H, int ns,
                int Q) {
  constexpr int CPT = HD / 16;  // y / S columns per thread
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nsp = ns + 4;       // padded row of the B / C tiles
  const int nr = ns / 16;       // S rows per thread in the state update
  const int Qr = (Q + TR - 1) / TR * TR;

  extern __shared__ float4 smem4[];
  float* S_s = reinterpret_cast<float*>(smem4);  // [ns][HD]
  float* C_s = S_s + ns * HD;                     // [TR][nsp]
  float* B_s = C_s + TR * nsp;                    // [TR][nsp]
  float* X_s = B_s + TR * nsp;                    // [TR][HD]
  float* G_s = X_s + TR * HD;                     // [TR][G_LD]
  float* cum_s = G_s + TR * G_LD;                 // [Qr]
  float* ecum_s = cum_s + Qr;                     // [Qr] exp(cum)
  float* w_s = ecum_s + Qr;                       // [Qr] exp(total - cum)

  const float a = A[h];
  const T* xh = x + b * st.xb + h * st.xh;
  const float* dth = dt + b * st.db + h * st.dh;
  const T* Bb = Bm + b * st.bb;
  const T* Cb = Cm + b * st.cb;
  T* yh = y + b * st.yb + h * st.yh;

  for (int i = tid; i < ns * HD; i += THREADS) S_s[i] = 0.f;

  for (int c0 = 0; c0 < T_; c0 += Q) {
    const int rows = min(Q, T_ - c0);  // live rows of this chunk
    const int nt = (rows + TR - 1) / TR;
    const T* xc = xh + c0 * st.xt;
    const float* dtc = dth + c0 * st.dtt;
    const T* Bc = Bb + c0 * st.bt;
    const T* Cc = Cb + c0 * st.ct;

    for (int r = tid; r < rows; r += THREADS) cum_s[r] = dtc[r * st.dtt] * a;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        s += cum_s[r];
        cum_s[r] = s;
      }
    }
    __syncthreads();
    const float total = cum_s[rows - 1];
    for (int r = tid; r < nt * TR; r += THREADS) {
      const float cr = r < rows ? cum_s[r] : total;
      if (r >= rows) cum_s[r] = total;  // masked rows: la = 0
      ecum_s[r] = expf(cr);
      w_s[r] = expf(total - cr);
    }
    __syncthreads();

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * TR;
      load_tile(C_s, nsp, Cc + i0 * st.ct, st.ct, rows - i0, ns);
      __syncthreads();

      // Inter-chunk term: exp(cum_i)·(C_i·S).
      float acc[4][CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < CPT; ++k) acc[r][k] = 0.f;
      for (int n = 0; n < ns; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(
              C_s + (ty + 16 * r) * nsp + n);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float sv[CPT];
          lds<CPT>(S_s + (n + q) * HD + tx * CPT, sv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < CPT; ++k)
              acc[r][k] = fmaf(lane(cv[r], q), sv[k], acc[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ecum_s[i0 + ty + 16 * r];
#pragma unroll
        for (int k = 0; k < CPT; ++k) acc[r][k] *= e;
      }

      // Intra-chunk term over the j-tiles at or below the diagonal.
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TR;
        load_tile(B_s, nsp, Bc + j0 * st.bt, st.bt, rows - j0, ns);
        load_xbar<T, HD>(X_s, xc + j0 * st.xt, st.xt, dtc + j0 * st.dtt,
                         st.dtt, nullptr, rows - j0);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
        for (int n = 0; n < ns; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            cv[r] = *reinterpret_cast<const float4*>(
                C_s + (ty + 16 * r) * nsp + n);
            bv[r] = *reinterpret_cast<const float4*>(
                B_s + (tx + 16 * r) * nsp + n);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              g[r][c] = fmaf(cv[r].x, bv[c].x, g[r][c]);
              g[r][c] = fmaf(cv[r].y, bv[c].y, g[r][c]);
              g[r][c] = fmaf(cv[r].z, bv[c].z, g[r][c]);
              g[r][c] = fmaf(cv[r].w, bv[c].w, g[r][c]);
            }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            G_s[(ty + 16 * r) * G_LD + tx + 16 * c] =
                j <= i ? g[r][c] * expf(cum_s[i] - cum_s[j]) : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < TR; j += 4) {
          float4 gv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            gv[r] = *reinterpret_cast<const float4*>(
                G_s + (ty + 16 * r) * G_LD + j);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float xv[CPT];
            lds<CPT>(X_s + (j + q) * HD + tx * CPT, xv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < CPT; ++k)
                acc[r][k] = fmaf(lane(gv[r], q), xv[k], acc[r][k]);
          }
        }
        __syncthreads();  // B_s, X_s and G_s are reloaded next
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < rows) {
          T* out = yh + (long long)(c0 + i) * st.yt + tx * CPT;
#pragma unroll
          for (int k = 0; k < CPT; ++k) out[k] = from_f32<T>(acc[r][k]);
        }
      }
    }

    // State update: S <- exp(total)·S + Σ_j B_jᵀ·(x̄_j·exp(total - cum_j)).
    float sacc[MAX_NS / 16][CPT];
    const float et = expf(total);
#pragma unroll
    for (int r = 0; r < MAX_NS / 16; ++r)
      if (r < nr) {
        float sv[CPT];
        lds<CPT>(S_s + (ty + 16 * r) * HD + tx * CPT, sv);
#pragma unroll
        for (int k = 0; k < CPT; ++k) sacc[r][k] = et * sv[k];
      }
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * TR;
      load_tile(B_s, nsp, Bc + j0 * st.bt, st.bt, rows - j0, ns);
      load_xbar<T, HD>(X_s, xc + j0 * st.xt, st.xt, dtc + j0 * st.dtt,
                       st.dtt, w_s + j0, rows - j0);
      __syncthreads();
      for (int j = 0; j < TR; ++j) {
        float xv[CPT];
        lds<CPT>(X_s + j * HD + tx * CPT, xv);
#pragma unroll
        for (int r = 0; r < MAX_NS / 16; ++r)
          if (r < nr) {
            const float bv = B_s[j * nsp + ty + 16 * r];
#pragma unroll
            for (int k = 0; k < CPT; ++k)
              sacc[r][k] = fmaf(bv, xv[k], sacc[r][k]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < MAX_NS / 16; ++r)
      if (r < nr) {
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          S_s[(ty + 16 * r) * HD + tx * CPT + k] = sacc[r][k];
      }
    __syncthreads();
  }

  // Final state, transposed to [hd, ns].
  float* out = state + ((long long)b * H + h) * HD * ns;
  for (int i = tid; i < HD * ns; i += THREADS)
    out[i] = S_s[(i % ns) * HD + i / ns];
}

template <typename T, int HD>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* state, const long long* st, int b,
           int T_, int h, int ns, int Q, void* stream) {
  const int Qr = (Q + TR - 1) / TR * TR;
  const size_t smem = (size_t)(ns * HD + 2 * TR * (ns + 4) + TR * HD +
                               TR * G_LD + 3 * Qr) * sizeof(float);
  auto kernel = ssd_scan_kernel<T, HD>;
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return (int)e;
  const Strides s{st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                  st[7], st[8], st[9], st[10], st[11], st[12]};
  kernel<<<dim3(h, b), THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (T*)y, (float*)state, s, T_, h, ns, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* B,
             const void* C, void* y, void* state, const long long* st,
             int b, int T_, int h, int hd, int ns, int Q, void* stream) {
  if (ns % 16 || ns <= 0 || ns > MAX_NS || Q <= 0 || T_ <= 0)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<T, 32>(x, dt, A, B, C, y, state, st, b, T_, h, ns, Q,
                           stream);
    case 64:
      return launch<T, 64>(x, dt, A, B, C, y, state, st, b, T_, h, ns, Q,
                           stream);
    case 128:
      return launch<T, 128>(x, dt, A, B, C, y, state, st, b, T_, h, ns, Q,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// st: the 13 element strides x (b, t, h), dt (b, t, h), B (b, t), C (b, t),
// y (b, t, h). Returns the launch's cudaError_t.
extern "C" {
int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                  const void* B, const void* C, void* y, void* state,
                  const long long* st, int b, int T_, int h, int hd, int ns,
                  int Q, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, A, B, C, y, state, st, b, T_, h, hd,
                                 ns, Q, stream);
}
int ssd_scan_f32(const void* x, const void* dt, const void* A,
                 const void* B, const void* C, void* y, void* state,
                 const long long* st, int b, int T_, int h, int hd, int ns,
                 int Q, void* stream) {
  return dispatch<float>(x, dt, A, B, C, y, state, st, b, T_, h, hd, ns, Q,
                         stream);
}
}  // extern "C"
