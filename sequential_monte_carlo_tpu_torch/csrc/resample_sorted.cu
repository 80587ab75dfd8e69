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
// The grid may be shorter than the row: u (M, n_out) with w (M, N) and xs
// (M, C, N) gives out (M, C, n_out). The ancestors of a grid's slots depend
// only on their u and the row's cdf, so the window [b n_out, (b + 1) n_out) of
// a whole grid gives the whole output's slots of that window bit for bit: a
// rank that holds particles [b N/R, (b + 1) N/R) of a row (particle-axis
// sharding) resamples its own slots from the row's whole cloud.
//
// u_i == 0 lands in bucket 0, and a_i <= N - 1 for every u_i < 1 + 1e-6, so a
// point-mass row never reads past N. The TPU needed three kernels because it
// has no fast dynamic gather and Mosaic tiles only some shapes; neither holds
// here, so one kernel takes every shape and any sorted grid (stratified,
// systematic, the ablations' tilings).
//
// What bounds it on the H100: memory. A call reads u, w and xs and writes the
// gathered cloud, (2C + 2) * 4 * M * N bytes: 8.4 MB at M=512, N=1024, C=1 and
// 134 MB at N=8192, C=3, about 2.5 and 40 microseconds at 3.35 TB/s.
//
// Design: one block per θ-row (256 threads up to N=2048, 512 above), the
// row's f32 cdf in shared memory (4 N bytes: N up to kMaxN = 57,344; the large
// route below takes longer rows). Warp w
// owns the contiguous chunk [w K, (w + 1) K) of the row, K the least power of
// two >= 128 that covers N with the block's warps, both of weights and of
// output slots; every step of a warp covers 128 neighbours, 4 a lane.
//  1. The cdf as the systematic kernel builds it (row_cdf.cuh): one HBM read
//     of w, each warp's chunk summed in f64 (16-byte loads), the chunk sums
//     giving each warp its prefix and the row total with no block-wide
//     reduce; then the chunk again from L2, a shuffle scan across the lanes,
//     cdf_of for the f32 rounding of cum/total without a divide per weight,
//     and 16-byte shared-memory stores. One block barrier.
//     Steps 2 and 3 split the n_out slots over the warps in chunks of their
//     own (the same chunks as the weights' when n_out = N).
//  2. Ancestors without a full search per slot. The grid is sorted, so
//     ancestors never decrease along the row. A lane loads its 4 neighbouring
//     u (16 bytes), binary-searches the first one in [carry, N), carry the
//     ancestor of the warp's last slot so far, and then merges its other
//     three with the cdf: it gallops forward from the ancestor before, capped
//     by the next lane's first ancestor, so a slot costs O(1) shared-memory
//     loads where the weights are spread and none in a point mass. (A binary
//     search for every slot measured slower under flat, skewed and
//     point-mass weights; a full merge path, each lane placing an equal
//     diagonal of the merged sequence, was not built: its diagonal search
//     costs what the lane's first search does.)
//  3. Coalesced gather as the systematic kernel does it: lane l takes its 4
//     slots' ancestors (non-decreasing, so neighbouring lanes read
//     neighbouring addresses) and writes one 16-byte store per plane and,
//     when asked, one for the ancestors.
//
// Rows above kMaxN (the large route): the row's cdf does not fit in shared
// memory, so it lives in a scratch of M x N floats in device memory that the
// caller passes, written in step 1 and searched in step 2 through L2 (at
// 64 x 65,536, 16 MB, well inside the H100's 50 MB). The steps are the same;
// one block of 1024 threads takes a row. Below kMaxN the shared-memory kernel
// is the one that runs, unchanged.
#include <cuda_runtime.h>

#include <cstdint>

#include "row_cdf.cuh"

namespace {

using smc::kFull;
using smc::kStep;

constexpr int kMaxN = 57344;  // 224 KB of cdf, within the 227 KB a block may use
constexpr float kCdfLast = 1.0f + 1e-6f;  // the last bucket covers every u < 1

// The first j in [lo, n) with cdf_j >= v, or n - 1.
__device__ __forceinline__ int search(const float* cdf, int lo, int n, float v) {
  int len = n - 1 - lo;  // candidates lo..n-2 before the last
  while (len > 0) {
    const int half = len >> 1;
    if (cdf[lo + half] < v) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

// The first j in [lo, hi] with cdf_j >= v, or hi, for v not below cdf's
// entries before lo: gallops 1, 2, 4, ... past lo, then halves the bracket.
__device__ __forceinline__ int gallop(const float* cdf, int lo, int hi, float v) {
  int probe = lo;
  for (int stride = 1; probe < hi && cdf[probe] < v; stride <<= 1) {
    lo = probe + 1;
    probe = min(probe + stride, hi);
  }
  while (lo < probe) {
    const int mid = (lo + probe) >> 1;
    if (cdf[mid] < v) {
      lo = mid + 1;
    } else {
      probe = mid;
    }
  }
  return lo;
}

// kGlobal: the row's cdf lives in `scratch` (M x N floats), not in shared
// memory.
template <int kThreads, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
resample_sorted_kernel(const float* __restrict__ u, const float* __restrict__ w,
                       const float* __restrict__ xs, float* __restrict__ out,
                       int* __restrict__ anc, float* scratch, int n, int c, int shift,
                       int n_out, int out_shift, bool vec) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 smem_cdf4[];  // n floats
  const long long row = blockIdx.x;
  float4* cdf4 = kGlobal ? reinterpret_cast<float4*>(scratch + row * n) : smem_cdf4;
  float* cdf = reinterpret_cast<float*>(cdf4);
  __shared__ double chunk_sum[kWarps];

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float* w_row = w + row * n;
  const int begin = min(warp << shift, n), end = min(begin + (1 << shift), n);

  // 1. the cdf: chunk sums, then the chunk's f32 cdf into shared memory
  const double part = smc::chunk_sum(w_row, begin, end, vec, lane);
  if (lane == 0) chunk_sum[warp] = part;
  __syncthreads();
  double run = 0.0, total = 0.0;
  for (int q = 0; q < kWarps; ++q) {
    if (q < warp) run += chunk_sum[q];
    total += chunk_sum[q];
  }
  const double inv = __drcp_rn(total);
  for (int b = begin; b < end; b += kStep) {
    const int j = b + 4 * lane;
    double cum[4];
    smc::lane_scan(smc::load4(w_row, j, end, vec), lane, run, cum);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = j + i == n - 1 ? kCdfLast : smc::cdf_of(cum[i], total, inv);
    if (vec && j < end) {
      cdf4[j >> 2] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (j + i < end) cdf[j + i] = v[i];
      }
    }
  }
  __syncthreads();  // the row's cdf is in

  // 2 and 3. the slot chunk: ancestors by search and merge, then the gather
  const float* u_row = u + row * n_out;
  const float* xs_row = xs + row * c * n;
  float* out_row = out + row * c * n_out;
  const int o_begin = min(warp << out_shift, n_out);
  const int o_end = min(o_begin + (1 << out_shift), n_out);
  int carry = 0;  // the ancestor of the chunk's last slot so far
  for (int b = o_begin; b < o_end; b += kStep) {
    const int o = b + 4 * lane;
    const float4 uq = smc::load4(u_row, o, o_end, vec);  // 0 past the chunk: ancestor carry
    const int a0 = search(cdf, carry, n, uq.x);
    const int next = __shfl_down_sync(kFull, a0, 1);
    const int cap = lane == 31 || o + 4 >= o_end ? n - 1 : next;
    const int a1 = gallop(cdf, a0, cap, uq.y);
    const int a2 = gallop(cdf, a1, cap, uq.z);
    const int a3 = gallop(cdf, a2, cap, uq.w);
    carry = __shfl_sync(kFull, a3, 31);
    if (o >= o_end) continue;
    const int a[4] = {a0, a1, a2, a3};
    if (vec) {
      if (anc != nullptr) {
        *reinterpret_cast<int4*>(anc + row * n_out + o) = make_int4(a0, a1, a2, a3);
      }
      for (int k = 0; k < c; ++k) {
        const float* src = xs_row + static_cast<long long>(k) * n;
        *reinterpret_cast<float4*>(out_row + static_cast<long long>(k) * n_out + o) =
            make_float4(src[a0], src[a1], src[a2], src[a3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (o + i >= o_end) break;
        if (anc != nullptr) anc[row * n_out + o + i] = a[i];
        for (int k = 0; k < c; ++k) {
          out_row[static_cast<long long>(k) * n_out + o + i] =
              xs_row[static_cast<long long>(k) * n + a[i]];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int kThreads>
cudaError_t launch(const float* u, const float* w, const float* xs, float* out, int* anc, int m,
                   int n, int c, int n_out, cudaStream_t stream) {
  const int shift = smc::chunk_shift(n, kThreads / 32);
  const int out_shift = smc::chunk_shift(n_out, kThreads / 32);
  const bool vec = n % 4 == 0 && n_out % 4 == 0 && aligned16(u) && aligned16(w) && aligned16(xs) &&
                   aligned16(out) && (anc == nullptr || aligned16(anc));
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  static bool carveout = false;  // once per instance: all of the SM's shared memory
  if (!carveout) {
    cudaError_t err = cudaFuncSetAttribute(resample_sorted_kernel<kThreads, false>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carveout = true;
  }
  if (smem > smc::kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(resample_sorted_kernel<kThreads, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  resample_sorted_kernel<kThreads, false><<<m, kThreads, smem, stream>>>(
      u, w, xs, out, anc, nullptr, n, c, shift, n_out, out_shift, vec);
  return cudaGetLastError();
}

// The large route: the cdf in `scratch`, no dynamic shared memory.
cudaError_t launch_global(const float* u, const float* w, const float* xs, float* out,
                          int* anc, float* scratch, int m, int n, int c, int n_out,
                          cudaStream_t stream) {
  constexpr int kThreads = 1024;
  const int shift = smc::chunk_shift(n, kThreads / 32);
  const int out_shift = smc::chunk_shift(n_out, kThreads / 32);
  const bool vec = n % 4 == 0 && n_out % 4 == 0 && aligned16(u) && aligned16(w) &&
                   aligned16(xs) && aligned16(out) && aligned16(scratch) &&
                   (anc == nullptr || aligned16(anc));
  resample_sorted_kernel<kThreads, true><<<m, kThreads, 0, stream>>>(
      u, w, xs, out, anc, scratch, n, c, shift, n_out, out_shift, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest N of the shared-memory route (its cdf lives in shared
// memory); above it the large route keeps the cdf in `scratch`.
int smc_resample_sorted_max_n() { return kMaxN; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `anc` may be null. `scratch` (m, n floats) is read only above
// smc_resample_sorted_max_n(), where it is required. Pointers are device
// pointers to contiguous f32 / int32 arrays: w and scratch (m, n), xs (m, c,
// n), u and anc (m, n_out), out (m, c, n_out).
int smc_resample_sorted(const float* u, const float* w, const float* xs,
                        float* out, int* anc, float* scratch, int m, int n, int c, int n_out,
                        cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_out <= 0) return cudaSuccess;
  if (c <= 0) return cudaErrorInvalidValue;
  if (n > kMaxN) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    return launch_global(u, w, xs, out, anc, scratch, m, n, c, n_out, stream);
  }
  if (n <= 2048) return launch<256>(u, w, xs, out, anc, m, n, c, n_out, stream);
  return launch<512>(u, w, xs, out, anc, m, n, c, n_out, stream);
}

}  // extern "C"
