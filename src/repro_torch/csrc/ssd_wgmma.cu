// mamba2 SSD chunk scan on the tensor cores, bf16 x, B and C, held to the
// f32 state tier by an exact three-term bf16 split (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd.py: ssd_pallas
// (_ssd_kernel, pallas_call at :82) for bf16 inputs at head_dim 64 or 128,
// state 64 or 128 and a chunk of 64, 128, 192 or 256 rows; f32 inputs and
// the other shapes stay on csrc/ssd.cu (the wrapper's route,
// kernels/ssd.py:ssd_route). It computes what ssd_scan_kernel computes
// (ssd.cu:1-21): per (batch, head) and chunk of Q rows, with la = dt·A and
// cum its inclusive cumsum in the chunk, total = cum[last],
//   y   = (C·Bᵀ ⊙ L)·x̄ + exp(cum)·(C·S_prev),  L[i, j] = exp(cum_i - cum_j)
//         for j <= i, 0 above the diagonal,
//   S_c = exp(total)·S_prev + (B ⊙ exp(total - cum))ᵀ·x̄,  x̄ = x·dt,
// y in x's dtype and the final state, transposed to [hd, ns], in f32.
//
// Numerics. x is bf16 and exact as a bf16 operand; dt is f32. Instead of
// forming the f32 x̄, dt is folded into the f32 factors:
//   y_intra = M·x,          M = (C·Bᵀ ⊙ L)·dt_j            [Q, Q]
//   y_inter = exp(cum)·(C·S_prev)
//   ΔS_cᵀ   = (x ⊙ dt·exp(total - cum))ᵀ·B                 [hd, ns]
//   S_c     = exp(total_c)·S_{c-1} + ΔS_c
// C·Bᵀ is bf16·bf16 (exact products, f32 sums). Each f32 factor (M, S_prev
// and x ⊙ dt·w) is split in the kernel into three bf16 terms whose sum is
// exact (sm90.cuh split3), and each term goes through the tensor cores
// against the exact bf16 x, C or B: three products for each. Every
// product of two bf16 values is exact in f32, so the result differs from
// the plain version only by f32 sums in another order and by the rounding
// of the factors (one f32 rounding each, where the plain version rounds
// x̄, B ⊙ w and G ⊙ L). The factor products use __fmul_rn so that no
// multiply is fused into the split's subtractions.
//
// Design: mamba2's own decomposition for GPUs (Dao & Gu, arXiv:2405.21060,
// the SSD algorithm: chunk states, state passing, chunk outputs), three
// launches on the caller's stream, parallel over chunks:
//   (a) ssd_chunk_states_kernel, one block of one warpgroup per (batch,
//       head, chunk, 64 columns of hd): ΔS_cᵀ [64, ns] = (x ⊙ dt·w)ᵀ·B
//       over the chunk's rows in 64-row slices, wgmma m64n{ns}k16 with
//       both operands MN-major (the factor as A with the transpose flag),
//       into an f32 scratch [b·h, nc, hd, ns]; the chunk's total into
//       [b·h, nc]. The factor is on x's side: 64 columns to split, where
//       B ⊙ dt·w would be ns; B is copied as it is. 45 KB at ns 128.
//   (b) ssd_state_pass_kernel, per (batch, head) and 4 elements of
//       [hd, ns] a thread, over the chunks in order: replaces ΔS_c in the
//       scratch by S_{c-1}, the state entering chunk c, and writes the final
//       state. Elementwise, bound by the scratch's bytes.
//   (c) ssd_chunk_out_kernel, one block of one warpgroup per (batch, head,
//       chunk, 64-row i-tile, 64 columns of hd): the inter-chunk term
//       C_i·S_prev (A = C_i and B = S_prevᵀ both K-major), 64 state
//       columns at a time, scaled by exp(cum_i) in registers; then for
//       every j-tile at or below the diagonal G = C_i·B_jᵀ (m64n64,
//       K-major), M formed and split in the accumulator registers, which
//       are the register A operand of M·x_j (x_j MN-major, the transpose
//       flag), as flash attention's P·V. The j-tiles go through two
//       buffers, the next one loading under the current one's products;
//       the second buffer is the region that held S_prevᵀ's planes, so a
//       block takes 69 KB at ns 128 and three blocks share an SM. The
//       i-tile is the fastest grid axis, last first: the blocks of one
//       chunk run together and share its tiles in L2. C·Bᵀ is recomputed
//       per head (not shared across the heads of a batch).
// Both tiled kernels run the chunk's cumsum as a block scan in f64 (pairs
// of rows per thread, a shuffle scan per warp, the warps' totals in order;
// la itself is the f32 product dt·A, as in the reference) and take every
// exponent's argument, cum_i - cum_j, total - cum_j, cum_i and total, as
// an f64 difference rounded once to f32. An f32 block scan sums in
// another order than the reference's sequential cumsum, and a difference
// of two prefix sums near |cum| ~ 10^3 then loses their shared rounding:
// up to 3e-5 · max of the state apart from the JAX kernel in a CPU
// emulation, against 6e-6 with the f64 scan (tests/test_torch_ssd.py).
// The same scan code runs in (a) and (c), so both see the same cum.
// Operands are read in place by their strides (x, B and C may be views of
// the conv output) with 16-byte cp.async copies into 128-byte-swizzled
// tiles (rows past T read as zeros), so every row stride and base must be
// 16-byte aligned: the route sends other calls to csrc/ssd.cu. One store
// per output, no atomics: reruns are bit-identical.
//
// Bound on the card. At the training shape (b 2, T 2048, h 80, hd 64, ns
// 128, Q 256) the needed work is 3 x (the causal half of M·x, C·S_prev
// but for the first chunk, the state update) + C·Bᵀ once per (batch,
// chunk) = 46.5 GFLOP of bf16 products (0.047 ms at 989 TFLOP/s), against
// ~92 MB of bytes (0.027 ms): operations bound it. This design does ~66
// GFLOP (C·Bᵀ per head, full 64 x 64 diagonal tiles) and moves the f32
// scratch (42 MB) through (b) and (c).
// Not done yet: C·Bᵀ shared across heads; more than one warpgroup a
// chunk-output block (each now waits on its loads, products and exps in
// turn, three blocks an SM); folding (b) into (c).

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int THREADS = 128;    // one warpgroup
constexpr int TR = 64;          // rows of a tile: an i-tile, j-tile or slice
constexpr int HS = 64;          // head_dim columns per block
constexpr int MAX_Q = 256;      // rows of a chunk
constexpr int TILE = TR * 128;  // 64 rows of one 64-column bf16 chunk
constexpr int PASS_THREADS = 256;

struct Strides {  // element strides
  long long xb, xt, xh, db, dtt, dh, bb, bt, cb, ct, yb, yt, yh;
};

// Shared memory of a launch: the tiles, the chunk's cum (f64) and its dt
// (or w) rows (f32), the scan's four warp totals (f64), and up to 1024
// bytes to align the tiles. kernels/ssd.py computes the same numbers
// (ssd_wgmma_plan); the launcher refuses smaller ones.
constexpr int SCAN_BYTES = MAX_Q * 8 + MAX_Q * 4 + 4 * 8;
template <int NS>
constexpr int states_smem() {  // three planes of x ⊙ dt·w and B, a slice
  return 3 * TILE + (NS / 64) * TILE + SCAN_BYTES + 1024;
}
template <int NS>
constexpr int out_smem() {  // C_i, a region of three [64, 64] planes of
                            // S_prevᵀ (later j-tile buffer 1), B_j and x_j
  return 2 * (NS / 64) * TILE + 4 * TILE + SCAN_BYTES + 1024;
}

// Byte offset of (row r, column c) in a tile of `rows` rows: 64-column
// chunks `rows` * 128 bytes apart, 128-byte rows, the 16-byte pieces
// permuted by r % 8 (the 128-byte swizzle of sm90.cuh).
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (c / 64) * rows * 128 + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4) +
         (c % 8) * 2;
}

// 16 bytes from global to shared memory, asynchronously; `bytes` = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [0, 64) of a [rows, W] bf16 operand (row stride in elements, its
// columns contiguous) into a swizzled 64-row tile at dst; rows at or past
// `live` are zeros.
template <int W>
__device__ __forceinline__ void copy_tile(uint32_t dst, const bf16* src,
                                          long long row_stride, int live) {
  constexpr int PIECES = W / 8;  // 16-byte pieces a row
#pragma unroll
  for (int k = 0; k < TR * PIECES / THREADS; ++k) {
    const int q = threadIdx.x + THREADS * k;
    const int r = q / PIECES, c = (q % PIECES) * 8;
    const bool ok = r < live;
    cp_async16(dst + swz(TR, r, c), ok ? src + r * row_stride + c : src,
               ok ? 16 : 0);
  }
}

// Makes the tiles written by cp.async and by st.shared visible to wgmma
// (the async proxy) and to every thread.
__device__ __forceinline__ void tiles_ready() {
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
}

// cum_s[r], r < Q: the inclusive cumsum, in f64, of la_r = dt_r·a (an f32
// product) over the chunk's rows (la = 0 at and past `live`, as the
// reference's zero pad). Thread t holds rows 2t and 2t + 1: a shuffle scan
// of the pair sums per warp, the warps' totals added in order, then the
// pair's own rows.
__device__ __forceinline__ void chunk_cumsum(double* cum_s, double* warp_s,
                                             const float* dt, long long dtt,
                                             float a, int live, int Q) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int r = 2 * t;
  const double v0 = r < live ? __fmul_rn(dt[r * dtt], a) : 0.f;
  const double v1 = r + 1 < live ? __fmul_rn(dt[(r + 1) * dtt], a) : 0.f;
  double incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  double before = 0.0;
  for (int w = 0; w < warp; ++w) before += warp_s[w];
  const double c0 = (before + excl) + v0;
  if (r < Q) cum_s[r] = c0;
  if (r + 1 < Q) cum_s[r + 1] = c0 + v1;
  __syncthreads();
}

// exp of an f64 exponent rounded once to f32.
__device__ __forceinline__ float exp_of(double v) {
  return expf(__double2float_rn(v));
}

template <int NS>
__global__ void __launch_bounds__(THREADS, 4)
ssd_chunk_states_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const bf16* __restrict__ Bm,
                        float* __restrict__ dS, float* __restrict__ totals,
                        Strides st, int T_, int H, int hd, int Q, int nc) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023u)) & 1023u);
  // three planes [64, 64] of x ⊙ dt·w, then B [64, NS], both MN-major
  const uint32_t f_s = smem_u32(smem), b_s = f_s + 3 * TILE;
  double* cum_s = reinterpret_cast<double*>(smem + 3 * TILE + (NS / 64) * TILE);
  double* warp_s = cum_s + MAX_Q;
  float* w_s = reinterpret_cast<float*>(warp_s + 4);

  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  const int hs = hd / HS, c = blockIdx.y / hs, d0 = (blockIdx.y % hs) * HS;
  const int c0 = c * Q, live = min(Q, T_ - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* dtc = dt + b * st.db + h * st.dh + c0 * st.dtt;

  chunk_cumsum(cum_s, warp_s, dtc, st.dtt, A[h], live, Q);
  const double total = cum_s[Q - 1];
  for (int r = threadIdx.x; r < Q; r += THREADS)
    w_s[r] = r < live ? __fmul_rn(dtc[r * st.dtt], exp_of(total - cum_s[r]))
                      : 0.f;
  if (d0 == 0 && threadIdx.x == 0)
    totals[(long long)bh * nc + c] = __double2float_rn(total);
  __syncthreads();

  const bf16* xc = x + b * st.xb + h * st.xh + c0 * st.xt + d0;
  const bf16* Bc = Bm + b * st.bb + c0 * st.bt;
  float acc[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < live; j0 += TR) {
    copy_tile<NS>(b_s, Bc + j0 * st.bt, st.bt, live - j0);
    // x ⊙ dt·w for the slice's rows, split into three planes [64, 64]
#pragma unroll
    for (int k = 0; k < TR * 8 / THREADS; ++k) {  // 8 pieces of 16 bytes a row
      const int q = threadIdx.x + THREADS * k;
      const int r = q / 8, cc = (q % 8) * 8;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (r < live - j0)
        u = __ldg(reinterpret_cast<const uint4*>(xc + (j0 + r) * st.xt + cc));
      const float w = w_s[j0 + r];
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
      uint32_t t[4][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v[e]);
        split3(__fmul_rn(f.x, w), __fmul_rn(f.y, w), t[e]);
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint4*>(smem + p * TILE + swz(TR, r, cc)) =
            make_uint4(t[0][p], t[1][p], t[2][p], t[3][p]);
    }
    tiles_ready();
    // ΔSᵀ[d, n] += Σ_j (x ⊙ dt·w)[j, d]·B[j, n]: both operands MN-major,
    // the factor as A with the transpose flag; each k step is 16 rows
    // (2048 bytes).
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk)
#pragma unroll
      for (int p = 0; p < 3; ++p)
        mma_ss<1, 1>(acc, desc_mn(f_s + p * TILE + kk * 2048, TILE),
                     desc_mn(b_s + kk * 2048, TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // the tiles are rewritten by the next slice
  }

  // Accumulator map (sm90.cuh): register 4 i + e holds row (hd column)
  // 16 warp + lane / 4 + 8 (e / 2) and column (state) 8 i + 2 (lane % 4)
  // + e % 2.
  float* o = dS + ((long long)bh * nc + c) * hd * NS;
  const int r = d0 + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < NS / 8; ++i) {
    const int n = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<float2*>(o + (long long)r * NS + n) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(o + (long long)(r + 8) * NS + n) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// Over the chunks in order: S_prev[c] = S; S = exp(total_c)·S + ΔS_c; the
// scratch's ΔS_c is replaced by S_prev[c] and the last S is the final
// state. Four consecutive elements of [hd, ns] a thread; the loads of
// PASS_BATCH chunks are issued before their chain of updates.
constexpr int PASS_BATCH = 4;

__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(float* __restrict__ dS,
                      const float* __restrict__ totals,
                      float* __restrict__ state, int nc, int n_elem) {
  const long long bh = blockIdx.x;
  const int e = (blockIdx.y * PASS_THREADS + threadIdx.x) * 4;
  if (e >= n_elem) return;
  float4* base = reinterpret_cast<float4*>(dS + bh * nc * n_elem + e);
  const int stride = n_elem / 4;  // float4s between chunks
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float4 d[PASS_BATCH];
    float et[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (c0 + k < nc) {
        d[k] = base[(long long)(c0 + k) * stride];
        et[k] = expf(totals[bh * nc + c0 + k]);
      }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (c0 + k < nc) {
        base[(long long)(c0 + k) * stride] = S;
        S = make_float4(fmaf(et[k], S.x, d[k].x), fmaf(et[k], S.y, d[k].y),
                        fmaf(et[k], S.z, d[k].z), fmaf(et[k], S.w, d[k].w));
      }
  }
  *reinterpret_cast<float4*>(state + bh * n_elem + e) = S;
}

// Rows [0, 64) and columns [n0, n0 + 64) of S_prevᵀ (f32, row stride NS),
// split into three K-major bf16 planes [64, 64] at `planes`, TILE apart.
template <int NS>
__device__ __forceinline__ void split_state(uint8_t* planes, const float* sp,
                                            int n0) {
#pragma unroll 4
  for (int k = 0; k < TR * 16 / THREADS; ++k) {  // 16 float4 a row
    const int q = threadIdx.x + THREADS * k;
    const int r = q / 16, cc = (q % 16) * 4;
    const float4 v = *reinterpret_cast<const float4*>(sp + r * NS + n0 + cc);
    uint32_t lo[3], hi[3];
    split3(v.x, v.y, lo);
    split3(v.z, v.w, hi);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(planes + p * TILE + swz(TR, r, cc)) =
          make_uint2(lo[p], hi[p]);
  }
}

template <int NS>
__global__ void __launch_bounds__(THREADS, 3)
ssd_chunk_out_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm,
                     const float* __restrict__ S_prev,
                     bf16* __restrict__ y, Strides st, int T_, int H,
                     int hd, int Q, int nc) {
  constexpr int CT = (NS / 64) * TILE;  // a [64, NS] bf16 tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023u)) & 1023u);
  // C_i [64, NS] K-major; region r: the three planes of one 64-column half
  // of S_prevᵀ (K-major), then the second j-tile buffer; the first j-tile
  // buffer: B_j [64, NS] K-major, then x_j [64, 64] MN-major.
  const uint32_t c_s = smem_u32(smem);
  const uint32_t r_s = c_s + CT;
  const uint32_t b0_s = r_s + 3 * TILE;
  double* cum_s = reinterpret_cast<double*>(smem + 2 * CT + 4 * TILE);
  double* warp_s = cum_s + MAX_Q;
  float* dt_s = reinterpret_cast<float*>(warp_s + 4);

  // the i-tiles of one (batch, head, chunk) are neighbours in the grid, so
  // they find x_j, B_j and S_prev in L2; the heavy one first
  const int nt = Q / TR, it = nt - 1 - blockIdx.x % nt;
  const int bh = blockIdx.x / nt, h = bh % H, b = bh / H;
  const int hs = hd / HS, c = blockIdx.y / hs, d0 = (blockIdx.y % hs) * HS;
  const int c0 = c * Q, live = min(Q, T_ - c0), i0 = it * TR;
  if (i0 >= live) return;  // the whole i-tile lies past T
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* dtc = dt + b * st.db + h * st.dh + c0 * st.dtt;
  const bf16* xc = x + b * st.xb + h * st.xh + c0 * st.xt + d0;
  const bf16* Bc = Bm + b * st.bb + c0 * st.bt;
  const float* sp = S_prev + ((long long)bh * nc + c) * hd * NS +
                    (long long)d0 * NS;  // S_prevᵀ rows d0 .. d0 + 63

  copy_tile<NS>(c_s, Cm + b * st.cb + (c0 + i0) * st.ct, st.ct, live - i0);
  copy_tile<NS>(b0_s, Bc, st.bt, live);
  copy_tile<HS>(b0_s + CT, xc, st.xt, live);
  if (c > 0) split_state<NS>(smem + CT, sp, 0);
  chunk_cumsum(cum_s, warp_s, dtc, st.dtt, A[h], live, Q);
  for (int r = threadIdx.x; r < Q; r += THREADS)
    dt_s[r] = r < live ? dtc[r * st.dtt] : 0.f;
  tiles_ready();

  // This thread's rows of the accumulators: i0 + row0 and i0 + row0 + 8.
  const int row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  float acc[HS / 2];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) acc[i] = 0.f;

  if (c > 0) {  // y = exp(cum_i)·(C_i·S_prev): three terms of S_prev,
                // 64 state columns at a time
    for (int n0 = 0; n0 < NS; n0 += 64) {
      if (n0 > 0) {  // the previous half's products have completed
        __syncthreads();
        split_state<NS>(smem + CT, sp, n0);
        fence_proxy_async();
        __syncthreads();
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          mma_ss<0>(acc, desc_k(c_s + (n0 / 64) * TILE + kk * 32),
                    desc_k(r_s + p * TILE + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    const float e0 = exp_of(cum_s[i0 + row0]);
    const float e1 = exp_of(cum_s[i0 + row0 + 8]);
#pragma unroll
    for (int t = 0; t < HS / 2; ++t) acc[t] *= (t / 2) % 2 ? e1 : e0;
    __syncthreads();  // region r becomes the second j-tile buffer
  }

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TR;
    const uint32_t bj = jt % 2 ? r_s : b0_s, xj = bj + CT;
    if (jt < it) {  // j-tile jt + 1 into the other buffer, under this one
      const uint32_t bn = jt % 2 ? b0_s : r_s;
      copy_tile<NS>(bn, Bc + (j0 + TR) * st.bt, st.bt, live - j0 - TR);
      copy_tile<HS>(bn + CT, xc + (j0 + TR) * st.xt, st.xt, live - j0 - TR);
    }
    // G = C_i·B_jᵀ, both K-major
    float g[TR / 2];
#pragma unroll
    for (int i = 0; i < TR / 2; ++i) g[i] = 0.f;
    fence_regs(g);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
      const uint32_t off = (kk / 4) * TILE + (kk % 4) * 32;
      mma_ss<0>(g, desc_k(c_s + off), desc_k(bj + off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(g);

    // M = G ⊙ exp(cum_i - cum_j)·dt_j for j <= i (a select before the exp:
    // above the diagonal the exponent is positive), split into three
    // register A operands: registers 8 kk + 2 q + {0, 1} -> a[q] of k step
    // kk (sm90.cuh).
    uint32_t pa[3][TR / 16][4];
#pragma unroll
    for (int t = 0; t < TR / 2; t += 2) {
      const int i = i0 + row0 + 8 * ((t / 2) % 2);
      const int j = j0 + 8 * (t / 4) + col0;
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        m[e] = j + e <= i
                   ? __fmul_rn(__fmul_rn(g[t + e],
                                         exp_of(cum_s[i] - cum_s[j + e])),
                               dt_s[j + e])
                   : 0.f;
      uint32_t s3[3];
      split3(m[0], m[1], s3);
#pragma unroll
      for (int p = 0; p < 3; ++p) pa[p][t / 8][(t % 8) / 2] = s3[p];
    }
    // y += M·x_j: x_j MN-major (the transpose flag), 16 rows a k step
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int kk = 0; kk < TR / 16; ++kk)
        mma_rs<1>(acc, pa[p][kk], desc_mn(xj + kk * 2048, TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // j-tile jt + 1 has landed, and no warp reads tile jt any more
    if (jt < it) tiles_ready();
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = i0 + row0 + 8 * e;
    if (i >= live) continue;
    bf16* dst = y + b * st.yb + (long long)(c0 + i) * st.yt + h * st.yh + d0;
#pragma unroll
    for (int k = 0; k < HS / 8; ++k)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * k + col0) =
          __floats2bfloat162_rn(acc[4 * k + 2 * e], acc[4 * k + 2 * e + 1]);
  }
}

template <int NS>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* state, void* scratch,
           void* totals, const Strides& s, int b, int T_, int h, int hd,
           int Q, int smem_states, int smem_out, void* stream) {
  if (smem_states < states_smem<NS>() || smem_out < out_smem<NS>() ||
      smem_states > 232448 || smem_out > 232448)
    return (int)cudaErrorInvalidValue;
  const int nc = (T_ + Q - 1) / Q, bh = b * h;
  const cudaStream_t st = (cudaStream_t)stream;
  auto k_states = ssd_chunk_states_kernel<NS>;
  auto k_out = ssd_chunk_out_kernel<NS>;
  static int opted_states = 0, opted_out = 0;
  if (int e = set_smem(k_states, smem_states, opted_states)) return e;
  if (int e = set_smem(k_out, smem_out, opted_out)) return e;
  k_states<<<dim3(bh, nc * (hd / HS)), THREADS, smem_states, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (float*)scratch, (float*)totals, s, T_, h, hd, Q, nc);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const int n_elem = hd * NS;
  ssd_state_pass_kernel<<<dim3(bh, (n_elem / 4 + PASS_THREADS - 1) /
                                       PASS_THREADS),
                          PASS_THREADS, 0, st>>>(
      (float*)scratch, (const float*)totals, (float*)state, nc, n_elem);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  k_out<<<dim3(Q / TR * bh, nc * (hd / HS)), THREADS, smem_out, st>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const float*)scratch, (bf16*)y, s, T_, h, hd, Q, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [b, T, h, hd], B and C [b, T, ns] bf16, read by the element strides
// st[0 .. 2] (x: b, t, h), st[6 .. 7] (B: b, t), st[8 .. 9] (C: b, t), all
// multiples of 8 with 16-byte aligned bases, the last axis contiguous; dt
// [b, T, h] f32 by st[3 .. 5]; A [h] f32; y [b, T, h, hd] bf16 by st[10 ..
// 12]; state [b, h, hd, ns] f32, contiguous; scratch [b, h, nc, hd, ns]
// and totals [b, h, nc] f32, nc = ceil(T / Q). Takes hd 64 or 128, ns 64
// or 128, Q a multiple of 64 up to 256, and the shared memory of the
// wrapper's plan; returns cudaErrorInvalidValue otherwise (the wrapper
// checks first), else the first launch error.
int ssd_wgmma_bf16(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state,
                   void* scratch, void* totals, const long long* st, int b,
                   int T_, int h, int hd, int ns, int Q, int smem_states,
                   int smem_out, void* stream) {
  if (b <= 0 || T_ <= 0 || h <= 0 || Q <= 0 || Q % TR || Q > MAX_Q ||
      (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const Strides s{st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                  st[7], st[8], st[9], st[10], st[11], st[12]};
  if (ns == 64)
    return launch<64>(x, dt, A, B, C, y, state, scratch, totals, s, b, T_, h,
                      hd, Q, smem_states, smem_out, stream);
  if (ns == 128)
    return launch<128>(x, dt, A, B, C, y, state, scratch, totals, s, b, T_,
                       h, hd, Q, smem_states, smem_out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
