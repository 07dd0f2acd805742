// Expert weight gradient on the tensor cores, held to the f32 tier by an
// exact three-term bf16 split (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py:gmm_dw_tiled
// (_dw_kernel, pallas_call at gmm.py:300), which the MoE FFN's backward
// calls three times per layer (kernels/ops.py, _MoEFFN.backward: dwo on
// the f32 h, dwg and dwu on the packed x):
//   drhs[g] = sum over the m-tiles t of group g of lhs_t^T @ dout_t
// as [G, K, N] f32, with lhs [Mp, K] bf16 or f32 and dout [Mp, N] f32, both
// row-major, tile_group [Mp / block_m] int32 and non-decreasing. A group
// that owns no tile gets exact zeros; the trailing pad tiles (zero rows,
// clipped to group G-1) add nothing. csrc/gmm_dw.cu (FMA) keeps the shapes
// this kernel does not take (K or N not a multiple of 8; the wrapper's
// route, kernels/gmm.py:gmm_dw_route).
//
// Numerics. The reference widens every tile to f32 before its dot
// (gmm.py:268-270). Here each f32 operand x is split into three bf16 terms
//   hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
// (round to nearest; each difference is exact in f32), whose sum is x
// exactly for 2^-110 <= |x| < (2 - 2^-8) 2^127 (below, lo falls under
// bf16's subnormal grid; above, hi rounds to inf). Every product of two
// bf16 terms is exact in f32, and all of a block's products go into one
// f32 wgmma accumulator:
//   * f32 lhs: the six products hi.hi, hi.mid, mid.hi, hi.lo, mid.mid and
//     lo.hi; the three left out (mid.lo, lo.mid, lo.lo) are each below
//     2^-24 |a||b|;
//   * bf16 lhs (exact as it is): x.hi, x.mid and x.lo, nothing left out.
// The number of products is a constant of this source, not a knob.
//
// Design. One block of two warpgroups (256 threads) owns one (group g,
// 128-row K tile, 128-column N tile) output tile: warpgroup w the K rows
// 64 w .. 64 w + 63, one m64n128 f32 accumulator (64 registers a thread).
// The block finds g's rows [row_lo, row_hi) by a binary search of
// tile_group (as csrc/gmm_dw.cu: no host sync, no offsets array) and walks
// them in 64-row slices, the wgmma k axis (4 x k16).
//   * Both operands are contracted over their row axis, so both are
//     MN-major: lhs^T is the A operand read from shared memory with the
//     A-transpose flag (sm90.cuh mma_ss<1, 1>, desc_mn), dout the B operand
//     with the B-transpose flag. wgmma takes MN-major operands only for
//     16-bit types, which is why the split is to bf16 and not to TF32.
//   * The split is done in the kernel, so HBM traffic stays at the
//     operands' own 4 (2) bytes an element and no scratch is allocated (a
//     split pre-pass would write [3, Mp, N] bf16 planes: 242 MB for the
//     train run's dg). Every thread loads its share of the next slice from
//     global memory into registers (16-byte loads, neighbouring threads on
//     neighbouring addresses) before it issues the current slice's
//     products, and splits and stores it into the other of two
//     shared-memory stages while the tensor cores run: each stage holds
//     the A planes (hi, mid, lo of an f32 lhs; the bf16 lhs as it is) and
//     the three B planes, each [64 rows, 128 columns] bf16 in two 64-column
//     chunks with the 128-byte swizzle that TMA would write (sm90.cuh).
//     Then fence.proxy.async, the products' wait and a block barrier.
//     No TMA: the lhs arrives through the same loads as dout, so there is
//     no tensor map to encode per call.
//   * Group edges. A group's rows are a multiple of block_m, which is a
//     multiple of 8 (the reference's capacity routing takes 8/16/32), so a
//     64-row slice can run past row_hi into the next group or to Mp. The
//     loads write zeros to every plane of both operands for the rows at or
//     past row_hi (and the columns past K or N), so those rows add nothing
//     whatever the next group holds; no separate tail instantiation.
//   * One store per output, no atomics: reruns are bit-identical, and an
//     empty group's loop runs zero times and stores zeros.
//
// Bound on the card: operations. At the train shapes (4096 routed rows,
// d 2048, f 7168, 12 experts) the f32 lhs costs 6 x 2 x 4096 x 7168 x 2048
// = 721 GFLOP of bf16 products (0.73 ms at 989 TFLOP/s), the bf16 lhs
// half that (0.36 ms); the bytes (0.86 GB: the 704 MB output and the
// operands once) take 0.26 ms at 3.35 TB/s. The grid also runs the pad
// rows (Mp = 5632). Each block streams its group's rows of both operands
// from L2 (~5 GB over all blocks at the f32 shape).
// Not done yet: a persistent grid with the epilogue under the next tile's
// loads, 256-wide tiles (half the L2 traffic per product), TMA stores.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int BM = 128;       // output rows (the K axis) per block
constexpr int BN = 128;       // output columns (the N axis) per block
static_assert(BM == BN, "a slice of lhs and of dout has the same width");
constexpr int BR = 64;        // packed rows per slice: the wgmma k axis
constexpr int THREADS = 256;  // two warpgroups
constexpr int STAGES = 2;
constexpr int CHUNK = BR * 128;       // 64 rows of one 64-column chunk
constexpr int PLANE = 2 * CHUNK;      // [64, 128] bf16: one split term
constexpr int F4_PER_THREAD = BR * BM / 4 / THREADS;  // f32: 8 x 16 bytes
constexpr int U4_PER_THREAD = BR * BM / 8 / THREADS;  // bf16: 4 x 16 bytes

// The split of an lhs type: A planes in a stage, and the A and B plane of
// each product p (p unrolled, so both fold to constants), largest first.
template <typename TA>
struct Split;
template <>
struct Split<float> {  // hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi
  static constexpr int A_PLANES = 3;
  static constexpr int PASSES = 6;
  static __device__ constexpr int pa(int p) {
    return p == 2 || p == 4 ? 1 : p == 5 ? 2 : 0;
  }
  static __device__ constexpr int pb(int p) {
    return p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0;
  }
};
template <>
struct Split<bf16> {  // x.hi, x.mid, x.lo
  static constexpr int A_PLANES = 1;
  static constexpr int PASSES = 3;
  static __device__ constexpr int pa(int) { return 0; }
  static __device__ constexpr int pb(int p) { return p; }
};

template <typename TA>
struct Stage {
  static constexpr int A_BYTES = Split<TA>::A_PLANES * PLANE;
  static constexpr int BYTES = A_BYTES + 3 * PLANE;
};

// Shared memory a launch needs: the stages and up to 1024 bytes to align
// the first. kernels/gmm.py computes the same number (gmm_dw_wgmma_plan);
// the launcher refuses a smaller one.
template <typename TA>
constexpr int smem_needed() {
  return STAGES * Stage<TA>::BYTES + 1024;
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

// Byte offset of (row r, column c) in a plane: 64-column chunks, 128-byte
// rows, the 16-byte pieces permuted by r % 8 (the TMA 128-byte swizzle).
__device__ __forceinline__ int swz(int r, int c) {
  return (c / 64) * CHUNK + r * 128 + ((((c % 64) / 8) ^ (r % 8)) << 4) +
         (c % 8) * 2;
}

// Split 4 f32 values (columns c .. c + 3 of row r) into the three planes
// at `planes`, 8 bytes each (sm90.cuh split3).
__device__ __forceinline__ void put_split(uint8_t* planes, int r, int c,
                                          float4 v) {
  uint32_t c01[3], c23[3];  // columns c, c + 1 and c + 2, c + 3
  split3(v.x, v.y, c01);
  split3(v.z, v.w, c23);
  const int off = swz(r, c);
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint2*>(planes + p * PLANE + off) =
        make_uint2(c01[p], c23[p]);
}

// One slice's share of this thread, in registers between its loads and its
// split: 16-byte pieces of lhs (f32: 4 values; bf16: 8) and of dout.
template <typename TA>
struct Slice {
  static constexpr int NA = sizeof(TA) == 4 ? F4_PER_THREAD : U4_PER_THREAD;
  static constexpr int A_COLS = 16 / sizeof(TA);  // columns per piece
  uint4 a[NA];
  float4 b[F4_PER_THREAD];
};

// Piece j of this thread: row and first column in a [64, 128] slice (of
// lhs or dout) cut in `COLS`-column pieces; one warp reads 512 contiguous
// bytes.
template <int COLS>
__device__ __forceinline__ void piece(int j, int& r, int& c) {
  const int q = threadIdx.x + THREADS * j;
  r = q / (BM / COLS);
  c = (q % (BM / COLS)) * COLS;
}

// Load rows [r0, r0 + 64) of the block's lhs columns [k0, k0 + 128) and
// dout columns [n0, n0 + 128), zeros at or past row_hi, K or N.
template <typename TA>
__device__ __forceinline__ void load_slice(Slice<TA>& s,
                                           const TA* __restrict__ lhs,
                                           const float* __restrict__ dout,
                                           int r0, int row_hi, int k0,
                                           int n0, int K, int N) {
  constexpr int AC = Slice<TA>::A_COLS;
#pragma unroll
  for (int j = 0; j < Slice<TA>::NA; ++j) {
    int r, c;
    piece<AC>(j, r, c);
    s.a[j] = r0 + r < row_hi && k0 + c < K
                 ? __ldg(reinterpret_cast<const uint4*>(
                       lhs + (size_t)(r0 + r) * K + k0 + c))
                 : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < F4_PER_THREAD; ++j) {
    int r, c;
    piece<4>(j, r, c);
    s.b[j] = r0 + r < row_hi && n0 + c < N
                 ? __ldg(reinterpret_cast<const float4*>(
                       dout + (size_t)(r0 + r) * N + n0 + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Write a loaded slice into a stage: the A planes, then the B planes.
template <typename TA>
__device__ __forceinline__ void store_slice(uint8_t* stage,
                                            const Slice<TA>& s) {
  constexpr int AC = Slice<TA>::A_COLS;
#pragma unroll
  for (int j = 0; j < Slice<TA>::NA; ++j) {
    int r, c;
    piece<AC>(j, r, c);
    if constexpr (sizeof(TA) == 4) {
      const uint4 u = s.a[j];
      put_split(stage, r, c,
                make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                            __uint_as_float(u.z), __uint_as_float(u.w)));
    } else {  // bf16: one plane, the 16-byte piece as it is
      *reinterpret_cast<uint4*>(stage + swz(r, c)) = s.a[j];
    }
  }
  uint8_t* b = stage + Stage<TA>::A_BYTES;
#pragma unroll
  for (int j = 0; j < F4_PER_THREAD; ++j) {
    int r, c;
    piece<4>(j, r, c);
    put_split(b, r, c, s.b[j]);
  }
}

template <typename TA>
__global__ void __launch_bounds__(THREADS, 1)
gmm_dw_wgmma_kernel(const TA* __restrict__ lhs,
                    const float* __restrict__ dout,
                    const int* __restrict__ tile_group,
                    float* __restrict__ out, int K, int N, int n_tiles,
                    int block_m) {
  using SP = Split<TA>;
  using ST = Stage<TA>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);

  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, g = blockIdx.z;
  const int row_lo = search(tile_group, n_tiles, g, false) * block_m;
  const int row_hi = search(tile_group, n_tiles, g, true) * block_m;
  const int ns = (row_hi - row_lo + BR - 1) / BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  Slice<TA> regs;
  if (ns > 0) {
    load_slice(regs, lhs, dout, row_lo, row_hi, k0, n0, K, N);
    store_slice(smem, regs);
  }
  fence_proxy_async();
  __syncthreads();

  for (int i = 0; i < ns; ++i) {
    const int s = i & 1;
    const bool more = i + 1 < ns;
    if (more)  // next slice's loads in flight under this slice's products
      load_slice(regs, lhs, dout, row_lo + (i + 1) * BR, row_hi, k0, n0, K,
                 N);
    // This warpgroup's A: its 64-column chunk of each A plane.
    const uint32_t a = base + s * ST::BYTES + wg * CHUNK;
    const uint32_t b = base + s * ST::BYTES + ST::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
      for (int p = 0; p < SP::PASSES; ++p)
        mma_ss<1, 1>(acc, desc_mn(a + SP::pa(p) * PLANE + kk * 2048, CHUNK),
                     desc_mn(b + SP::pb(p) * PLANE + kk * 2048, CHUNK));
    wgmma_commit();
    if (more) store_slice(smem + (s ^ 1) * ST::BYTES, regs);
    fence_proxy_async();
    fence_regs(acc);
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // stage s is free, stage s ^ 1 is written
  }

  // Accumulator map (sm90.cuh): register 4 i + e holds K row
  // 16 (warp % 4) + lane / 4 + 8 (e / 2) of this warpgroup's 64 and
  // column 8 i + 2 (lane % 4) + e % 2.
  float* o = out + (size_t)g * K * N;
  const int r = k0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = n0 + 8 * i + 2 * (lane % 4);
    if (c < N) {  // N % 8 == 0: c < N implies c + 1 < N
      if (r < K)
        *reinterpret_cast<float2*>(o + (size_t)r * N + c) =
            make_float2(acc[4 * i], acc[4 * i + 1]);
      if (r + 8 < K)
        *reinterpret_cast<float2*>(o + (size_t)(r + 8) * N + c) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

template <typename TA>
int launch(const void* lhs, const void* dout, const void* tile_group,
           void* out, int G, int K, int N, int n_tiles, int block_m,
           int smem_bytes, void* stream) {
  if (block_m <= 0 || block_m % 8 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
      G <= 0 || smem_bytes < smem_needed<TA>() ||
      smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  auto kernel = gmm_dw_wgmma_kernel<TA>;
  static int opted = 0;  // the shared memory this kernel is opted into
  if (int e = set_smem(kernel, smem_bytes, opted)) return e;
  dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, G);
  kernel<<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const TA*)lhs, (const float*)dout, (const int*)tile_group,
      (float*)out, K, N, n_tiles, block_m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [G, K, N] f32 = per-group lhs^T @ dout; lhs [Mp, K] bf16
// (gmm_dw_wgmma_bf16) or f32 (gmm_dw_wgmma_f32), dout [Mp, N] f32, all
// row-major and 16-byte aligned. Takes block_m % 8 == 0, K % 8 == 0 and
// N % 8 == 0, and smem_bytes from the wrapper's plan; returns
// cudaErrorInvalidValue otherwise (the wrapper checks first).
int gmm_dw_wgmma_bf16(const void* lhs, const void* dout,
                      const void* tile_group, void* out, int G, int K, int N,
                      int n_tiles, int block_m, int smem_bytes,
                      void* stream) {
  return launch<bf16>(lhs, dout, tile_group, out, G, K, N, n_tiles, block_m,
                      smem_bytes, stream);
}

int gmm_dw_wgmma_f32(const void* lhs, const void* dout,
                     const void* tile_group, void* out, int G, int K, int N,
                     int n_tiles, int block_m, int smem_bytes, void* stream) {
  return launch<float>(lhs, dout, tile_group, out, G, K, N, n_tiles,
                       block_m, smem_bytes, stream);
}

}  // extern "C"
