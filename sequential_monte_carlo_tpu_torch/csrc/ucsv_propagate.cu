// Fused UC-SV propagate + reweight (+ optional per-row normalize), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// sequential_monte_carlo_tpu/kernels/ucsv_pallas.py::ucsv_propagate_reweight.
// For every θ-row m and particle i of the planar cloud (x, log σε, log ση),
// with three N(0, 1) draws z0, z1, z2:
//
//   x'     = x + exp(½ log σε) z0
//   log σε' = log σε + γε[m] z1
//   log ση' = log ση + γη[m] z2
//   logw   = −½ ((y − x') exp(−½ log ση'))² − ½ log ση' − ½ log 2π
//
// and, with normalize, lse_m = log Σ_i exp(logw_mi), log_norm = logw − lse_m,
// ess_m = (Σ e)² / Σ e² with e = exp(logw − max_m). logw is a Gaussian
// log-density, always finite, so the normalize needs no −inf guard.
//
// Draws: Philox-4x32-10 keyed by the two halves of the int64 seed, counter
// (particle i, row_offset + row, 0, 0), turned into uniforms and normals as
// Triton's tl.philox, uint_to_uniform_float and pair_uniform_to_normal do
// (triton/language/random.py, Triton 3.6): z0, z1 from (r0, r1), z2 from
// (r2, r3). So this kernel draws the normals that the fused propagate kernel
// (kernels/propagate.py, UC-SV instance) draws at the same seed, and a call on
// rows r..M with row_offset = r draws what rows r..M of the full call draw.
//
// What bounds it on the H100: memory. A call reads three planes and writes
// three planes and logw, 7 * 4 * M * N bytes: 14.7 MB at M=512, N=1024 and
// 117 MB at N=8192, 4.4 and 35 microseconds at 3.35 TB/s. The TPU kernel read
// γ as two (M, N) broadcasts; here γ is one scalar per row, read once.
//
// Design: one block per θ-row, looping over N; neighbouring threads take
// neighbouring particles. The cloud is read through its row and plane strides,
// so a view of a wider cloud (the auxiliary filter's split-off planes) needs
// no copy. expf/logf/sinf/cosf are the full-precision library functions (no
// fast math). With normalize, each thread keeps an online max with rescaled
// Σe and Σe²; a warp-shuffle and shared-memory reduction combines them, and a
// second pass rewrites the row's logw (which this thread wrote, mostly still
// in L2) to log_norm.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kHalfLog2Pi = 0.9189385332046727f;

// Philox-4x32 constants (triton/language/random.py::philox_impl, uint32).
constexpr uint32_t kKeyA = 0x9E3779B9u;
constexpr uint32_t kKeyB = 0xBB67AE85u;
constexpr uint32_t kRoundA = 0xD2511F53u;
constexpr uint32_t kRoundB = 0xCD9E8D57u;

__device__ __forceinline__ void philox10(uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                         uint32_t& c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t a0 = c0, a2 = c2;
    c0 = __umulhi(kRoundB, a2) ^ c1 ^ k0;
    c2 = __umulhi(kRoundA, a0) ^ c3 ^ k1;
    c1 = kRoundB * a2;
    c3 = kRoundA * a0;
    k0 += kKeyA;
    k1 += kKeyB;
  }
}

// triton/language/random.py::uint_to_uniform_float for 32-bit input: the bits
// as an int32 x, x < 0 mapped to −x − 1 (= ~x), times 4.6566127342e-10 in f32.
__device__ __forceinline__ float uniform(uint32_t r) {
  int x = static_cast<int>(r);
  if (x < 0) x = ~x;
  return __fmul_rn(__int2float_rn(x), 4.6566127342e-10f);
}

// triton/language/random.py::pair_uniform_to_normal (Box–Muller).
__device__ __forceinline__ void pair_to_normal(float u1, float u2, float& n1, float& n2) {
  u1 = fmaxf(1.0e-7f, u1);
  const float th = __fmul_rn(6.283185307179586f, u2);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  n1 = __fmul_rn(r, cosf(th));
  n2 = __fmul_rn(r, sinf(th));
}

struct Moments {  // online log-sum-exp: max, Σ exp(lw − max), Σ exp(2(lw − max))
  float m, s1, s2;
};

__device__ __forceinline__ Moments combine(Moments a, Moments b) {
  const float m = fmaxf(a.m, b.m);
  const float ka = a.m == -INFINITY ? 0.0f : expf(a.m - m);  // empty side
  const float kb = b.m == -INFINITY ? 0.0f : expf(b.m - m);
  return {m, a.s1 * ka + b.s1 * kb, a.s2 * ka * ka + b.s2 * kb * kb};
}

__global__ void __launch_bounds__(kThreads)
ucsv_propagate_kernel(const long long* __restrict__ seed_ptr, const float* __restrict__ y_ptr,
                      const float* __restrict__ ge, long long ge_stride,
                      const float* __restrict__ gn, long long gn_stride,
                      const float* __restrict__ cloud, long long row_stride,
                      long long plane_stride, float* __restrict__ out,
                      float* __restrict__ logw, float* __restrict__ lse_out,
                      float* __restrict__ ess_out, int n, int row_offset) {
  const long long row = blockIdx.x;
  const unsigned long long seed = static_cast<unsigned long long>(*seed_ptr);
  const uint32_t k0 = static_cast<uint32_t>(seed & 0xffffffffull);
  const uint32_t k1 = static_cast<uint32_t>((seed >> 32) & 0xffffffffull);
  const uint32_t grow = static_cast<uint32_t>(row + row_offset);
  const float y = *y_ptr;
  const float gamma_eps = ge[row * ge_stride];
  const float gamma_eta = gn[row * gn_stride];

  const float* x_in = cloud + row * row_stride;
  const float* se_in = x_in + plane_stride;
  const float* sn_in = x_in + 2 * plane_stride;
  float* x_out = out + row * 3 * n;
  float* se_out = x_out + n;
  float* sn_out = x_out + 2 * n;
  float* lw_row = logw + row * n;
  const bool normalize = lse_out != nullptr;

  Moments acc = {-INFINITY, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    uint32_t r0 = static_cast<uint32_t>(i), r1 = grow, r2 = 0u, r3 = 0u;
    philox10(r0, r1, r2, r3, k0, k1);
    float z0, z1, z2, z3;
    pair_to_normal(uniform(r0), uniform(r1), z0, z1);
    pair_to_normal(uniform(r2), uniform(r3), z2, z3);

    const float x = x_in[i], se = se_in[i], sn = sn_in[i];
    const float x_new = x + expf(0.5f * se) * z0;
    const float se_new = se + gamma_eps * z1;
    const float sn_new = sn + gamma_eta * z2;
    const float zz = (y - x_new) * expf(-0.5f * sn_new);
    const float lw = -0.5f * zz * zz - 0.5f * sn_new - kHalfLog2Pi;
    x_out[i] = x_new;
    se_out[i] = se_new;
    sn_out[i] = sn_new;
    lw_row[i] = lw;
    if (normalize) {
      const float m_new = fmaxf(acc.m, lw);
      const float alpha = expf(acc.m - m_new);  // 0 while acc.m is −inf
      const float e = expf(lw - m_new);
      acc = {m_new, acc.s1 * alpha + e, acc.s2 * alpha * alpha + e * e};
    }
  }
  if (!normalize) return;

  // block reduction of the per-thread moments: warps by shuffles, then warp 0
  for (int off = 16; off > 0; off >>= 1) {
    const Moments other = {__shfl_xor_sync(0xffffffffu, acc.m, off),
                           __shfl_xor_sync(0xffffffffu, acc.s1, off),
                           __shfl_xor_sync(0xffffffffu, acc.s2, off)};
    acc = combine(acc, other);
  }
  __shared__ Moments part[kWarps];
  __shared__ float row_lse;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? part[lane] : Moments{-INFINITY, 0.0f, 0.0f};
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      const Moments other = {__shfl_xor_sync(0xffffffffu, acc.m, off),
                             __shfl_xor_sync(0xffffffffu, acc.s1, off),
                             __shfl_xor_sync(0xffffffffu, acc.s2, off)};
      acc = combine(acc, other);
    }
    if (lane == 0) {
      row_lse = acc.m + logf(acc.s1);
      lse_out[row] = row_lse;
      ess_out[row] = (acc.s1 * acc.s1) / acc.s2;
    }
  }
  __syncthreads();
  const float lse = row_lse;
  for (int i = threadIdx.x; i < n; i += kThreads) lw_row[i] -= lse;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// seed: one int64; y: one f32; ge, gn: m f32 with the given element strides;
// cloud: (m, 3, n) f32 read through row_stride and plane_stride (elements),
// unit stride along n; out: contiguous (m, 3, n); logw: contiguous (m, n);
// lse and ess: (m) f32, both null for the raw log-weights (no normalize).
int smc_ucsv_propagate(const long long* seed, const float* y, const float* ge,
                       long long ge_stride, const float* gn, long long gn_stride,
                       const float* cloud, long long row_stride, long long plane_stride,
                       float* out, float* logw, float* lse, float* ess, int m, int n,
                       int row_offset, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  ucsv_propagate_kernel<<<m, kThreads, 0, stream>>>(seed, y, ge, ge_stride, gn, gn_stride,
                                                    cloud, row_stride, plane_stride, out, logw,
                                                    lse, ess, n, row_offset);
  return cudaGetLastError();
}

}  // extern "C"
