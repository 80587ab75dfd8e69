// Resample + ancestor gather on explicit sorted grids, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels with one contract:
//   sequential_monte_carlo_tpu/kernels/resample_walk.py::resample_gather_walk,
//     band route (_kernel, called with an explicit grid u);
//   sequential_monte_carlo_tpu/kernels/resample_pallas.py::resample_gather
//     (dense f32 selection matmul) and ::resample_gather_bytes (int8 byte
//     planes), the walk's fallback on shapes it cannot tile.
// For each row m of weights w (M, N) and sorted uniforms u (M, N) in [0, 1):
//
//   cdf_j  = cumsum(w)_j / sum(w), with cdf_{N-1} set to 1 + 1e-6
//   a_i    = the first j with u_i <= cdf_j   (searchsorted side="left")
//   out[m, c, i] = xs[m, c, a_i]           for every component c < C
//
// u_i == 0 lands in bucket 0, and a_i <= N - 1 for every u_i < 1 + 1e-6, so a
// point-mass row never reads past N. The TPU needed three kernels because it
// has no fast dynamic gather and Mosaic tiles only some shapes; neither holds
// here, so one kernel takes every shape.
//
// What bounds it on the H100: memory. A call reads u, w and xs and writes the
// gathered cloud, (2C + 2) * 4 * M * N bytes: 8.4 MB at M=512, N=1024, C=1 and
// 134 MB at N=8192, C=3, about 2.5 and 40 microseconds at 3.35 TB/s.
//
// Design: one block per θ-row. The row's f32 cdf comes from the f64 block scan
// of row_cdf.cuh into shared memory (4 N bytes, so N up to about 58,000). Each
// output slot then finds its ancestor by a binary search over the cdf in shared
// memory and gathers xs directly. The grid is sorted, so neighbouring threads
// search neighbouring values and read neighbouring addresses of xs.
#include <cuda_runtime.h>

#include "row_cdf.cuh"

namespace {

__global__ void __launch_bounds__(smc::kThreads)
resample_sorted_kernel(const float* __restrict__ u, const float* __restrict__ w,
                       const float* __restrict__ xs, float* __restrict__ out,
                       int* __restrict__ anc, int n, int c) {
  extern __shared__ float cdf[];  // n floats

  const long long row = blockIdx.x;
  smc::row_cdf(w + row * n, n, [&](int j, float v) {
    cdf[j] = j == n - 1 ? 1.0f + 1e-6f : v;
  });

  const float* u_row = u + row * n;
  const float* xs_row = xs + row * c * n;
  float* out_row = out + row * c * n;
  for (int i = threadIdx.x; i < n; i += smc::kThreads) {
    const float ui = u_row[i];
    int lo = 0, hi = n - 1;  // first j with cdf_j >= u_i; cdf_{N-1} covers u < 1
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] < ui) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (anc != nullptr) anc[row * n + i] = lo;
    for (int k = 0; k < c; ++k) {
      out_row[static_cast<long long>(k) * n + i] =
          xs_row[static_cast<long long>(k) * n + lo];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `anc` may be null. Pointers are device pointers to contiguous f32 / int32
// arrays: u, w and anc (m, n), xs and out (m, c, n).
int smc_resample_sorted(const float* u, const float* w, const float* xs,
                        float* out, int* anc, int m, int n, int c,
                        cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (smem > smc::kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        resample_sorted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  resample_sorted_kernel<<<m, smc::kThreads, smem, stream>>>(u, w, xs, out, anc, n, c);
  return cudaGetLastError();
}

}  // extern "C"
