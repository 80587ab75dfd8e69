// The pieces of a row's cumulative distribution that the two resample
// kernels share: the systematic kernel (resample_count.cu, K1) and the
// sorted-grid kernel (resample_sorted.cu, K3).
//
// Both work in warp chunks: warp w of a block owns a contiguous chunk of the
// row's weights, read 128 a step, 4 neighbouring weights a lane (16-byte loads
// where the row allows). The chunk sums, in f64, give each warp its prefix and
// the row total with no block-wide reduce; a shuffle scan across the lanes
// gives each weight its inclusive f64 cumulative sum; cdf_of rounds cum/total
// to f32 as the host does (f64 divide, then round), without a divide per
// weight. The f64 accumulation makes two summation orders agree on the f32 cdf
// except where the f64 error straddles an f32 rounding point, so a kernel and
// its plain version (which also sums in f64) agree on the ancestors of all but
// a vanishing share of slots, at any N.
#pragma once

#include <cuda_runtime.h>

namespace smc {

constexpr int kStep = 128;  // weights or slots per warp step, 4 a lane
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// The f32 rounding of the correctly rounded f64 quotient cum / total, as the
// host computes it. cum * (1 / total) is within 2^-51 of that quotient,
// relatively, so where both ends of q (1 -+ 2^-50) round to the same f32, so
// does the quotient; only the rare q near an f32 rounding point divides.
__device__ __forceinline__ float cdf_of(double cum, double total, double inv) {
  const double q = __dmul_rn(cum, inv);
  const float lo = __double2float_rn(__dmul_rn(q, 1.0 - 0x1p-50));
  const float hi = __double2float_rn(__dmul_rn(q, 1.0 + 0x1p-50));
  return lo == hi ? lo : __double2float_rn(__ddiv_rn(cum, total));
}

// the 4 values of a lane at j, j + 1, j + 2, j + 3 (0 at and past `end`);
// `vec`: the row is 16-byte aligned and `end` a multiple of 4
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int j, int end, bool vec) {
  if (vec && j < end) return *reinterpret_cast<const float4*>(row + j);
  return make_float4(j < end ? row[j] : 0.0f, j + 1 < end ? row[j + 1] : 0.0f,
                     j + 2 < end ? row[j + 2] : 0.0f, j + 3 < end ? row[j + 3] : 0.0f);
}

// The f64 sum of the weights [begin, end) of a warp's chunk, in every lane.
__device__ __forceinline__ double chunk_sum(const float* __restrict__ w_row, int begin, int end,
                                            bool vec, int lane) {
  double part = 0.0;
  for (int j = begin + 4 * lane; j < end; j += kStep) {
    const float4 q = load4(w_row, j, end, vec);
    part += (static_cast<double>(q.x) + q.y) + (static_cast<double>(q.z) + q.w);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kFull, part, d);
  return part;
}

// One warp step of the cumulative sum: the lane's 4 weights q, the running
// sum `run` before the step. Fills cum[0..3] with the inclusive f64 sums of
// the lane's weights and advances `run` past the step's 128 weights.
__device__ __forceinline__ void lane_scan(float4 q, int lane, double& run, double cum[4]) {
  const double l0 = q.x, l1 = l0 + q.y, l2 = l1 + q.z, l3 = l2 + q.w;
  double incl = l3;  // inclusive scan of the lanes' sums
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  double before = __shfl_up_sync(kFull, incl, 1);
  before = run + (lane == 0 ? 0.0 : before);
  cum[0] = before + l0, cum[1] = before + l1, cum[2] = before + l2, cum[3] = before + l3;
  run += __shfl_sync(kFull, incl, 31);
}

// Warp chunks: the least power of two >= kStep that covers n with `warps`
// warps, as a shift.
inline int chunk_shift(int n, int warps) {
  int shift = 7;
  while ((warps << shift) < n) ++shift;
  return shift;
}

}  // namespace smc
