// Pieces shared by the tensor-core flash attention kernels
// (flash_fwd_wgmma.cu, flash_bwd_wgmma.cu): the structural mask of
// csrc/flash_attention.cu:7-18, the skipping of tiles in which nothing can
// be live (_tile_live, src/repro/kernels/flash_attention.py:46-57), and the
// 4D tensor maps through which TMA reads q, k, v and do in place.

#pragma once

#include "sm90.cuh"

namespace flash90 {

constexpr float kNeg = -0.7f * 3.4028234663852886e38f;  // as the TPU kernel
constexpr int KR = 64;  // rows of a k-tile, of a q-tile and of a warpgroup

struct Layout {  // element strides of [batch, head, row, hd]
  long long b, h, s;
};

__device__ __forceinline__ bool live(int q, int k, int q_len, int kv_len,
                                     int causal, int window) {
  return q < q_len && k < kv_len && (!causal || k <= q) &&
         (window <= 0 || q - k < window);
}

// Whether query rows [q0, q0 + rows) and keys [k0, k0 + KR) can hold a
// live element.
__device__ __forceinline__ bool tile_live(int q0, int rows, int k0,
                                          int causal, int window) {
  if (causal && k0 > q0 + rows - 1) return false;
  if (window > 0 && q0 - (k0 + KR - 1) >= window) return false;
  return true;
}

// Whether every (query, key) pair of query rows [q0, q0 + KR) and keys
// [k0, k0 + KR) is live, so the mask can be skipped.
__device__ __forceinline__ bool tile_full(int q0, int k0, int q_len,
                                          int kv_len, int causal,
                                          int window) {
  return q0 + KR <= q_len && k0 + KR <= kv_len &&
         (!causal || k0 + KR - 1 <= q0) &&
         (window <= 0 || q0 + KR - 1 - k0 < window);
}

// The 4D map of one of q, k, v, do: dims {hd, rows, heads, B}, the element
// strides st[0..2] of (batch, head, row); a box of 64 columns x box_rows.
// Rows past `rows` read as zero.
inline int encode_qkv(CUtensorMap* map, const void* base, const long long* st,
                      int D, int rows, int heads, int B, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return sm90::encode_bf16(map, base, 4, dims, strides, box);
}

}  // namespace flash90
