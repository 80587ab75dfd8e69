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
// A call may ask for one window of output slots, [slot_lo, slot_lo + n_out):
// the cdf and the marks still cover the whole row, and out (M, C, n_out)
// holds the whole output's slots of the window bit for bit. A rank that holds
// particles [b N/R, (b + 1) N/R) of a row (particle-axis sharding) writes
// only its own slots from the row's whole cloud.
//
// What bounds it on the H100: memory. A call reads w and xs and writes the
// gathered cloud, (2C + 1) * 4 * M * N bytes: 15 MB at M=512, N=1024, C=3 and
// 117 MB at N=8192, about 4 and 35 microseconds at 3.35 TB/s. At the smaller
// size launch and host overhead dominate.
//
// Design: one block per θ-row (256 threads up to N=2048, 512 above), with the
// row's marks in shared memory (4 N bytes: N up to kMaxN = 56,832; the large
// route below takes longer rows). Warp w
// owns the contiguous chunk [w K, (w + 1) K) of the row, K the least power of
// two >= 128 that covers N with the block's warps, both of weights and of
// output slots. Every step of a warp covers 128 neighbours, 4 a lane, so
// loads, stores and shared-memory accesses are coalesced. (A thread per
// contiguous segment, tried first, puts a warp's loads 128 bytes apart and
// its shared-memory marks in one bank, 32-way conflicts: no faster than the
// binary search it replaced.)
//  1. One read of w from HBM. Each warp sums its chunk in f64 with 16-byte
//     loads; the chunk sums give each warp its prefix and the row total, with
//     no block-wide reduce or scan over the row. The walk reads the chunk
//     again, from L2: at 40 registers a thread more rows are resident than
//     with the chunk held in registers (measured faster at 512x8192). The
//     chunk sum, the lane scan and cdf_of are row_cdf.cuh's, shared with the
//     sorted-grid kernel.
//  2. Spans without a search per slot. The count formula says that slots
//     [s_hi_{j-1}, s_hi_j) take ancestor j. Each warp walks its chunk 128
//     weights a step, with a running f64 sum: 4 serial sums in each lane and a
//     shuffle scan across the lanes. It rounds each cdf to f32 (cdf_of: the
//     quotient's f32 rounding from a multiply by 1 / total, dividing only
//     where that rounding could differ) and each span op by op in f32, as the
//     host does, and marks the first slot of every non-empty run with its j
//     (a shared-memory atomicMax). A run's length costs nothing, so a
//     point-mass row, whose one j owns all N slots, costs one mark, and the
//     work is the same for every row.
//  3. Ancestors by a max-scan of the marks: a_o = the largest mark at or
//     before o. Each warp scans the marks of its slot chunk 4 a lane with
//     shuffles, carrying the running ancestor; the carry into a chunk is the
//     largest mark of the chunks before it, which the walk records. This is
//     the count formula whenever the spans are non-decreasing, and a
//     non-decreasing systematic draw whatever the marks, so two summation
//     orders can only move the slot at an f64 error that straddles an f32
//     rounding point.
//  4. Coalesced gather: lane l takes 4 neighbouring slots, gathers xs by their
//     ancestors (non-decreasing, so neighbouring lanes read neighbouring
//     addresses) and writes one 16-byte store per plane.
// With a window, steps 3 and 4 stop at its end, a warp whose slot chunk
// lies wholly before it skips them (its largest mark reaches the warps after
// it through chunk_max), and only the window's slots are written, 16 bytes at
// a time where slot_lo and n_out are multiples of 4.
// Two block barriers per row (marks initialised, marks complete). What holds
// it back now (PERF.md): the walk is compute (an f64 scan and a span per
// weight) that the gather cannot start before, and the resident rows' walks
// and gathers overlap only in part.
//
// Rows above kMaxN (the large route): the marks do not fit in shared memory,
// so they live in the row's ancestor output (M x N ints in device memory,
// which the caller must then pass), read and written through L2 (at
// 64 x 65,536, 16 MB, well inside the H100's 50 MB). Steps 1-4 are the same;
// the max-scan of step 3 reads a slot's marks and writes its ancestor back
// over them, which is safe because each slot's four marks are read and its
// ancestors written by one lane, and no warp reads another's slot chunk. One
// block of 1024 threads takes a row. Below kMaxN the shared-memory kernel is
// the one that runs, unchanged.
#include <cuda_runtime.h>

#include "row_cdf.cuh"

namespace {

using smc::kFull;
using smc::kStep;
using smc::cdf_of;
using smc::load4;

constexpr int kMaxN = 56832;  // 222 KB of ancestors, within the 227 KB a block may use

// s_hi of a cumulative weight: N * cdf - u0 rounded op by op, then ceil
__device__ __forceinline__ int span_of(double cum, double total, double inv, float nf,
                                       float offset) {
  const float cdf = cdf_of(cum, total, inv);
  return static_cast<int>(ceilf(__fsub_rn(__fmul_rn(nf, cdf), offset)));
}

// kThreads: 256 for rows up to 2048, 512 above, 1024 on the large route;
// warp chunks of 2^shift slots. kGlobal: the marks live in `scratch` (the
// ancestor output, M x N), and the ancestors are written over them.
template <int kThreads, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
resample_count_kernel(const float* __restrict__ u0, const float* __restrict__ w,
                      const float* __restrict__ xs, float* __restrict__ out,
                      int* __restrict__ anc, int* scratch, int n, int c, int shift,
                      int slot_lo, int n_out) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ int smem_marks[];  // n ints: j at the first slot of j's run, else -1
  __shared__ double chunk_sum[kWarps];
  __shared__ int chunk_max[kWarps];  // the largest mark in each slot chunk

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long row = blockIdx.x;
  int* marks = kGlobal ? scratch + row * n : smem_marks;
  const float* w_row = w + row * n;
  const bool vec = (n & 3) == 0;
  const int chunk = 1 << shift;
  const int begin = min(warp << shift, n), end = min(begin + chunk, n);
  const int steps = begin < end ? (end - begin + kStep - 1) / kStep : 0;

  if (vec) {
    for (int i = 4 * t; i < n; i += 4 * kThreads) {
      *reinterpret_cast<int4*>(marks + i) = make_int4(-1, -1, -1, -1);
    }
  } else {
    for (int i = t; i < n; i += kThreads) marks[i] = -1;
  }
  if (t < kWarps) chunk_max[t] = -1;

  // 1. the warp's chunk of w, summed in f64
  const double part = smc::chunk_sum(w_row, begin, end, vec, lane);
  if (lane == 0) chunk_sum[warp] = part;
  __syncthreads();  // marks, chunk_max and chunk_sum are in

  double prefix = 0.0, total = 0.0;
  for (int q = 0; q < kWarps; ++q) {
    if (q < warp) prefix += chunk_sum[q];
    total += chunk_sum[q];
  }
  const double inv = __drcp_rn(total);

  // 2. the chunk's spans, 128 a step; a mark at the first slot of every
  // non-empty run
  const float nf = static_cast<float>(n);
  const float offset = u0[row];
  int prev = warp == 0 ? 0 : span_of(prefix, total, inv, nf, offset);  // s_hi before the chunk
  double run = prefix;
  auto walk = [&](int s, float4 q) {
    const int j = begin + s * kStep + 4 * lane;
    double cum[4];
    smc::lane_scan(q, lane, run, cum);
    int hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = j + i >= end ? -1 : j + i == n - 1 ? n : span_of(cum[i], total, inv, nf, offset);
    }
    int lo = __shfl_up_sync(kFull, hi[3], 1);
    if (lane == 0) lo = prev;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (hi[i] < 0) break;  // past the chunk's end
      if (hi[i] > lo) {
        atomicMax(&marks[lo], j + i);
        atomicMax(&chunk_max[lo >> shift], j + i);
      }
      lo = hi[i];
    }
    // the last lane that holds a weight hands its span to the next step
    const unsigned held = __ballot_sync(kFull, hi[0] >= 0);
    prev = __shfl_sync(kFull, lo, 31 - __clz(held));
  };
  // the chunk again, from cache
  for (int s = 0; s < steps; ++s) walk(s, load4(w_row, begin + s * kStep + 4 * lane, end, vec));
  __syncthreads();  // every mark is in

  // 3 and 4. the slot chunk: max-scan of the marks, then the gather of the
  // window's slots
  int carry = -1;
  for (int q = 0; q < warp; ++q) carry = max(carry, chunk_max[q]);
  const float* xs_row = xs + row * c * n;
  float* out_row = out + row * c * n_out;
  int* anc_row = anc == nullptr ? nullptr : anc + row * n_out;
  const int slot_hi = slot_lo + n_out;
  const bool wvec = vec && ((slot_lo | n_out) & 3) == 0;  // 16-byte window stores
  const int per_lane = vec ? 4 : 1;
  const int stop = end <= slot_lo ? begin : min(end, slot_hi);
  for (int b = begin; b < stop; b += 32 * per_lane) {
    const int o = b + lane * per_lane;
    int p[4];
    if (vec) {
      const int4 mk = o < end ? *reinterpret_cast<const int4*>(marks + o)
                              : make_int4(-1, -1, -1, -1);
      p[0] = mk.x, p[1] = max(p[0], mk.y), p[2] = max(p[1], mk.z), p[3] = max(p[2], mk.w);
    } else {
      p[0] = p[1] = p[2] = p[3] = o < end ? marks[o] : -1;
    }
    int incl = p[3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, up);
    }
    int before = __shfl_up_sync(kFull, incl, 1);
    before = max(lane == 0 ? -1 : before, carry);
    carry = max(carry, __shfl_sync(kFull, incl, 31));
    if (o >= end) continue;
    if (vec) {
      const int4 a = make_int4(max(before, p[0]), max(before, p[1]), max(before, p[2]),
                               max(before, p[3]));
      if (kGlobal) *reinterpret_cast<int4*>(marks + o) = a;  // over the slot's own marks
      if (o + 4 <= slot_lo || o >= slot_hi) continue;
      if (wvec) {
        const int q = o - slot_lo;
        if (!kGlobal && anc_row != nullptr) *reinterpret_cast<int4*>(anc_row + q) = a;
        for (int k = 0; k < c; ++k) {
          const float* src = xs_row + static_cast<long long>(k) * n;
          *reinterpret_cast<float4*>(out_row + static_cast<long long>(k) * n_out + q) =
              make_float4(src[a.x], src[a.y], src[a.z], src[a.w]);
        }
      } else {
        const int ai[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = o + i - slot_lo;
          if (q < 0 || q >= n_out) continue;
          if (!kGlobal && anc_row != nullptr) anc_row[q] = ai[i];
          for (int k = 0; k < c; ++k) {
            out_row[static_cast<long long>(k) * n_out + q] =
                xs_row[static_cast<long long>(k) * n + ai[i]];
          }
        }
      }
    } else {
      const int a = max(before, p[0]);
      if (kGlobal) marks[o] = a;
      const int q = o - slot_lo;
      if (q < 0 || q >= n_out) continue;
      if (!kGlobal && anc_row != nullptr) anc_row[q] = a;
      for (int k = 0; k < c; ++k) {
        out_row[static_cast<long long>(k) * n_out + q] = xs_row[static_cast<long long>(k) * n + a];
      }
    }
  }
}

template <int kThreads>
cudaError_t launch(const float* u0, const float* w, const float* xs, float* out, int* anc,
                   int m, int n, int c, int slot_lo, int n_out, cudaStream_t stream) {
  const int shift = smc::chunk_shift(n, kThreads / 32);
  const size_t smem = static_cast<size_t>(n) * sizeof(int);
  static bool carveout = false;  // once per instance: all of the SM's shared memory
  if (!carveout) {
    cudaError_t err = cudaFuncSetAttribute(resample_count_kernel<kThreads, false>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carveout = true;
  }
  if (smem > smc::kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(resample_count_kernel<kThreads, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  resample_count_kernel<kThreads, false><<<m, kThreads, smem, stream>>>(
      u0, w, xs, out, anc, nullptr, n, c, shift, slot_lo, n_out);
  return cudaGetLastError();
}

// The large route: marks in the ancestor output `anc`, no dynamic shared memory.
cudaError_t launch_global(const float* u0, const float* w, const float* xs, float* out,
                          int* anc, int m, int n, int c, int slot_lo, int n_out,
                          cudaStream_t stream) {
  constexpr int kThreads = 1024;
  const int shift = smc::chunk_shift(n, kThreads / 32);
  resample_count_kernel<kThreads, true><<<m, kThreads, 0, stream>>>(
      u0, w, xs, out, nullptr, anc, n, c, shift, slot_lo, n_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest N of the shared-memory route (its marks live in shared
// memory); above it the large route keeps them in `anc`.
int smc_resample_count_max_n() { return kMaxN; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// Writes the output slots [slot_lo, slot_lo + n_out) of each row (0 and n
// for the whole output). `anc` may be null for n <= smc_resample_count_max_n()
// and is required above it, where it holds the marks and then every slot's
// ancestor, (m, n); below it, when given, the window's ancestors (m, n_out).
// Pointers are device pointers to contiguous f32 / int32 arrays: u0 (m),
// w (m, n), xs (m, c, n), out (m, c, n_out), 16-byte aligned.
int smc_resample_count(const float* u0, const float* w, const float* xs,
                       float* out, int* anc, int m, int n, int c, int slot_lo, int n_out,
                       cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (c <= 0 || slot_lo < 0 || n_out <= 0 || n_out > n - slot_lo) return cudaErrorInvalidValue;
  if (n > kMaxN) {
    if (anc == nullptr) return cudaErrorInvalidValue;
    return launch_global(u0, w, xs, out, anc, m, n, c, slot_lo, n_out, stream);
  }
  if (n <= 2048) return launch<256>(u0, w, xs, out, anc, m, n, c, slot_lo, n_out, stream);
  return launch<512>(u0, w, xs, out, anc, m, n, c, slot_lo, n_out, stream);
}

const char* smc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
