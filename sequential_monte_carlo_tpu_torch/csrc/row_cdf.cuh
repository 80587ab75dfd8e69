// The cumulative distribution of one row of weights, for the sorted-grid
// resample kernel (resample_sorted.cu). The systematic kernel
// (resample_count.cu) has its own single-read segment scan.
//
// The row's sum, then its inclusive cumulative sum, are block-wide reductions
// over chunks of the row (cub::BlockReduce, BlockScan), accumulated in f64 and
// rounded to an f32 cdf: two summation orders then give the same f32 cdf except
// where the f64 error straddles an f32 rounding point, so a kernel and its
// plain version (which also sums in f64) agree on the ancestors of all but a
// vanishing share of slots, at any N.
#pragma once

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace smc {

constexpr int kThreads = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;

// Running prefix across the chunks of one row (called by the first warp).
struct RunningPrefix {
  double total;
  __device__ double operator()(double chunk_sum) {
    double old = total;
    total += chunk_sum;
    return old;
  }
};

// Calls emit(j, cdf_j) once for every j < n, with cdf_j = f32(cumsum(w)_j /
// sum(w)). Every thread of a kThreads-wide block must call it; it ends with a
// barrier, so what emit stores to shared memory is visible on return.
template <class Emit>
__device__ void row_cdf(const float* __restrict__ w_row, int n, Emit emit) {
  using BlockReduce = cub::BlockReduce<double, kThreads>;
  using BlockScan = cub::BlockScan<double, kThreads>;
  __shared__ union {
    typename BlockReduce::TempStorage reduce;
    typename BlockScan::TempStorage scan;
  } tmp;
  __shared__ double total_s;

  double part = 0.0;
  for (int j = threadIdx.x; j < n; j += kThreads) part += w_row[j];
  const double row_sum = BlockReduce(tmp.reduce).Sum(part);
  if (threadIdx.x == 0) total_s = row_sum;
  __syncthreads();  // total_s is visible and tmp may be reused
  const double total = total_s;

  RunningPrefix prefix{0.0};
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + threadIdx.x;
    double v = j < n ? static_cast<double>(w_row[j]) : 0.0;
    BlockScan(tmp.scan).InclusiveSum(v, v, prefix);
    if (j < n) emit(j, __double2float_rn(__ddiv_rn(v, total)));
    __syncthreads();  // tmp.scan is reused by the next chunk
  }
}

}  // namespace smc
