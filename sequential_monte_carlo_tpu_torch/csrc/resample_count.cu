// Systematic resample + ancestor gather, count formulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// sequential_monte_carlo_tpu/kernels/resample_walk.py::resample_gather_walk,
// count route (_count_kernel, called with u0): the same contract, with
// count_ancestors as its oracle. For each row m of weights w (M, N) and offset
// u0[m] in [0, 1):
//
//   cdf_j  = cumsum(w)_j / sum(w)
//   s_hi_j = ceil(N * cdf_j - u0)        (s_hi_{N-1} forced to N)
//   a_o    = #{j : s_hi_j <= o}, clipped to N - 1
//   out[m, c, o] = xs[m, c, a_o]          for every component c < C
//
// What bounds it on the H100: memory. The cloud is 6 MB at M=512, N=1024, C=3
// and 50 MB at N=8192. A call reads w and xs and writes the gathered cloud,
// (2C + 1) * 4 * M * N bytes: 15 MB and 117 MB, about 4 and 35 microseconds at
// 3.35 TB/s. At the smaller size launch and host overhead dominate.
//
// Design: one block per θ-row. The row's f32 cdf comes from the f64 block
// scan of row_cdf.cuh, and each span goes to shared memory as an int (4 N
// bytes, so N up to about 58,000). Each output slot then finds its ancestor by
// a binary search over the spans in shared memory, and the gather reads xs
// directly: Hopper has a fast dynamic gather, so the TPU kernel's byte planes,
// int8 selection matmuls, chunk-walk bounds and autotuned tiles have no
// counterpart here. Ancestors are non-decreasing in o, so neighbouring threads
// read neighbouring addresses of xs. The f32 arithmetic that decides a span
// (product, difference, ceil) is rounded op by op, as on the host.
#include <cuda_runtime.h>

#include "row_cdf.cuh"

namespace {

__global__ void __launch_bounds__(smc::kThreads)
resample_count_kernel(const float* __restrict__ u0, const float* __restrict__ w,
                      const float* __restrict__ xs, float* __restrict__ out,
                      int* __restrict__ anc, int n, int c) {
  extern __shared__ int span[];  // n ints: s_hi

  const long long row = blockIdx.x;
  const float offset = u0[row];
  const float nf = static_cast<float>(n);
  smc::row_cdf(w + row * n, n, [&](int j, float cdf) {
    const float s = ceilf(__fsub_rn(__fmul_rn(nf, cdf), offset));
    span[j] = j == n - 1 ? n : static_cast<int>(s);
  });

  const float* xs_row = xs + row * c * n;
  float* out_row = out + row * c * n;
  for (int o = threadIdx.x; o < n; o += smc::kThreads) {
    int lo = 0, hi = n;  // first j with s_hi_j > o
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (span[mid] <= o) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int a = lo < n - 1 ? lo : n - 1;
    if (anc != nullptr) anc[row * n + o] = a;
    for (int k = 0; k < c; ++k) {
      out_row[static_cast<long long>(k) * n + o] =
          xs_row[static_cast<long long>(k) * n + a];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `anc` may be null. Pointers are device pointers to contiguous f32 / int32
// arrays: u0 (m), w (m, n), xs and out (m, c, n), anc (m, n).
int smc_resample_count(const float* u0, const float* w, const float* xs,
                       float* out, int* anc, int m, int n, int c,
                       cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(n) * sizeof(int);
  if (smem > smc::kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        resample_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  resample_count_kernel<<<m, smc::kThreads, smem, stream>>>(u0, w, xs, out, anc, n, c);
  return cudaGetLastError();
}

const char* smc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
