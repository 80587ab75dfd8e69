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
// log-density, always finite, so the normalize needs no −inf guard but for
// the slots past the row's end.
//
// Draws: Philox-4x32-10 keyed by the two halves of the int64 seed, counter
// (particle_offset + i, row_offset + row, 0, 0), turned into uniforms and normals as
// Triton's tl.philox, uint_to_uniform_float and pair_uniform_to_normal do
// (triton/language/random.py, Triton 3.6): z0, z1 from (r0, r1), z2 from
// (r2, r3). So this kernel draws the normals that the fused propagate kernel
// (kernels/propagate.py, UC-SV instance) draws at the same seed, and a call on
// rows r..M with row_offset = r draws what rows r..M of the full call draw,
// and a call on particles p..N with particle_offset = p what particles p..N
// of it draw (particle-axis sharding: a rank's slice of every row). A
// particle's result depends only on its inputs and its counter, not on where
// it lies in the launch nor on the access route (16- or 4-byte) that took it,
// so a slice at any offset and of any width returns the whole call's columns
// bit for bit.
// The arithmetic is that of the fused propagate kernel's compiled UC-SV
// update, read from its PTX: exp is ex2.approx of x·log2 e and sqrt is
// sqrt.approx (one MUFU operation each), while log, sin and cos are the CUDA
// math library's accurate functions, as Triton's tl.log, tl.sin and tl.cos
// are; every rounding step is written out (no contraction left to the
// compiler), so the two kernels agree bit for bit where Triton compiles the
// update as that PTX shows: rows of a multiple of 16 particles (at other N
// its specialization rounds otherwise, and the two agree within 1e-5).
//
// What bounds it on the H100: memory. A call reads three planes and writes
// three planes and logw, 7 * 4 * M * N bytes: 14.7 MB at M=512, N=1024 and
// 117 MB at N=8192, 4.4 and 35 microseconds at 3.35 TB/s. The work a
// particle needs takes less time at the card's rates than its bytes: on the
// raw route about 150 issued instructions, 34 32-bit multiplies (both halves
// of Philox's 32x32 -> 64-bit products, less the first, which the previous
// particle's plus a constant gives) and 4 MUFU operations (two sqrt, two
// exp), as chip_smoke.py::propagate_work derives them from the function;
// tools/sass_count.py holds them against this kernel's machine code.
//
// Design. The cloud is read through its row and plane strides, so a view of
// a wider cloud (the auxiliary filter's split-off planes) needs no copy. A
// thread takes 4 neighbouring particles, with 16-byte loads and stores where
// the strides, N and the pointers allow (the APF's view: row stride 4N, plane
// stride N) and 4-byte ones otherwise, and issues all its loads before its
// Philox work. The key schedule, the same for every particle, is computed once
// a thread. γ is one scalar per row, read once.
//  - Raw log-weights (the auxiliary filter's second stage): a row is split
//    over blocks of 256 threads, 1024 particles each, grid (M, ⌈N / 1024⌉),
//    so that many warps are in flight at any N.
//  - Normalized, N <= 1024: one block holds its row in registers between the
//    row's reduction and the subtraction of lse, so log_norm is written once:
//    the block's max, then one exp a particle and the block's two sums (a
//    single pass of online moments, rescaled up the reduction tree, measured
//    slower at 512x1024).
//  - Normalized, N > 1024: one block loops over its row 1024 particles a
//    step. Pass 1 writes the planes with streaming stores (evict first) and
//    the raw log-weights with an L2 evict-last policy, and keeps a running
//    max per thread, rescaled once per 4 particles, so one exp a particle; a
//    warp-shuffle and shared-memory reduction gives lse and ess; pass 2
//    rewrites the row's logw from L2. (A split of a normalized row over
//    blocks finished by atomics was correct and no faster for the fused
//    propagate kernel, PERF.md, so it is not tried here.)
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4 * kThreads;  // particles a block takes at a time
constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr float kLog2E = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Philox-4x32 constants (triton/language/random.py::philox_impl, uint32).
constexpr uint32_t kKeyA = 0x9E3779B9u;
constexpr uint32_t kKeyB = 0xBB67AE85u;
constexpr uint32_t kRoundA = 0xD2511F53u;
constexpr uint32_t kRoundB = 0xCD9E8D57u;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp as Triton lowers tl.exp on f32: ex2.approx of x·log2 e
__device__ __forceinline__ float fast_exp(float x) { return ex2_approx(__fmul_rn(x, kLog2E)); }

// The row's key schedule, the same for every particle.
struct Keys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ Keys key_schedule(unsigned long long seed) {
  Keys k;
  k.k0[0] = static_cast<uint32_t>(seed & 0xffffffffull);
  k.k1[0] = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    k.k0[r] = k.k0[r - 1] + kKeyA;
    k.k1[r] = k.k1[r - 1] + kKeyB;
  }
  return k;
}

// Philox-4x32-10 of the counter (i, row, 0, 0).
__device__ __forceinline__ uint4 philox10(uint32_t i, uint32_t row, const Keys& k) {
  uint32_t c0 = i, c1 = row, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned long long p0 = static_cast<unsigned long long>(kRoundB) * c2;
    const unsigned long long p2 = static_cast<unsigned long long>(kRoundA) * c0;
    c0 = static_cast<uint32_t>(p0 >> 32) ^ c1 ^ k.k0[r];
    c2 = static_cast<uint32_t>(p2 >> 32) ^ c3 ^ k.k1[r];
    c1 = static_cast<uint32_t>(p0);
    c3 = static_cast<uint32_t>(p2);
  }
  return make_uint4(c0, c1, c2, c3);
}

// triton/language/random.py::uint_to_uniform_float for 32-bit input: the bits
// as an int32 x, x < 0 mapped to −x − 1 (= ~x), times 4.6566127342e-10 in f32.
__device__ __forceinline__ float uniform(uint32_t r) {
  int x = static_cast<int>(r);
  if (x < 0) x = ~x;
  return __fmul_rn(__int2float_rn(x), 4.6566127342e-10f);
}

// triton/language/random.py::pair_uniform_to_normal (Box–Muller); r·sin θ is
// only taken for the first pair
__device__ __forceinline__ float box_muller_radius(float u1) {
  return sqrt_approx(__fmul_rn(-2.0f, logf(fmaxf(1.0e-7f, u1))));
}

struct Particle {
  float x, se, sn, lw;
};

// One particle: its draws, its move and its observation log-weight.
__device__ __forceinline__ Particle step(uint32_t i, uint32_t grow, const Keys& k, float x,
                                        float se, float sn, float ge, float gn, float y) {
  const uint4 r = philox10(i, grow, k);
  const float th01 = __fmul_rn(6.283185307179586f, uniform(r.y));
  const float rad01 = box_muller_radius(uniform(r.x));
  const float z0 = __fmul_rn(rad01, cosf(th01));
  const float z1 = __fmul_rn(rad01, sinf(th01));
  const float th23 = __fmul_rn(6.283185307179586f, uniform(r.w));
  const float z2 = __fmul_rn(box_muller_radius(uniform(r.z)), cosf(th23));

  // the update op for op as the fused propagate kernel's compiled UC-SV
  // update rounds it (its PTX): the vol steps are a multiply then an add, ½
  // log ση' is shared by the exp and the log-weight, which is one fma
  Particle p;
  p.x = __fmaf_rn(fast_exp(__fmul_rn(0.5f, se)), z0, x);
  p.se = __fadd_rn(__fmul_rn(ge, z1), se);
  p.sn = __fadd_rn(__fmul_rn(gn, z2), sn);
  const float half_sn = __fmul_rn(-0.5f, p.sn);
  const float zz = __fmul_rn(__fsub_rn(y, p.x), fast_exp(half_sn));
  p.lw = __fsub_rn(__fmaf_rn(zz, __fmul_rn(-0.5f, zz), half_sn), kHalfLog2Pi);
  return p;
}

// 4 neighbouring values at j.. of a row (16 bytes when vec; 0 past n)
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int j, int n, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p + j);
  return make_float4(j < n ? p[j] : 0.0f, j + 1 < n ? p[j + 1] : 0.0f,
                     j + 2 < n ? p[j + 2] : 0.0f, j + 3 < n ? p[j + 3] : 0.0f);
}

__device__ __forceinline__ float4 load4_stream(const float* __restrict__ p, int j, int n,
                                               bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const float4*>(p + j));
  return load4(p, j, n, false);
}

// kind 0: plain stores; 1: streaming (evict first); 2: the L2 policy `pol`
template <int kKind>
__device__ __forceinline__ void store4(float* __restrict__ p, int j, int n, bool vec, float4 v,
                                       unsigned long long pol = 0) {
  if (vec) {
    float4* q = reinterpret_cast<float4*>(p + j);
    if (kKind == 0) {
      *q = v;
    } else if (kKind == 1) {
      __stcs(q, v);
    } else {
      asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(q),
                   "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol)
                   : "memory");
    }
    return;
  }
  if (j < n) p[j] = v.x;
  if (j + 1 < n) p[j + 1] = v.y;
  if (j + 2 < n) p[j + 2] = v.z;
  if (j + 3 < n) p[j + 3] = v.w;
}

struct Row {  // one θ-row's pointers and scalars
  const float *x, *se, *sn;
  float *x_out, *se_out, *sn_out, *lw;
  float ge, gn, y;
  uint32_t grow, pofs;  // the counter's row word, and the first particle's index
  Keys keys;
};

__device__ __forceinline__ Row row_of(const long long* seed_ptr, const float* y_ptr,
                                      const float* ge, long long ge_stride, const float* gn,
                                      long long gn_stride, const float* cloud,
                                      long long row_stride, long long plane_stride, float* out,
                                      float* logw, int n, int row_offset, int particle_offset,
                                      long long row) {
  Row r;
  r.x = cloud + row * row_stride;
  r.se = r.x + plane_stride;
  r.sn = r.x + 2 * plane_stride;
  r.x_out = out + row * 3 * n;
  r.se_out = r.x_out + n;
  r.sn_out = r.x_out + 2 * n;
  r.lw = logw + row * n;
  r.ge = ge[row * ge_stride];
  r.gn = gn[row * gn_stride];
  r.y = *y_ptr;
  r.grow = static_cast<uint32_t>(row + row_offset);
  r.pofs = static_cast<uint32_t>(particle_offset);
  r.keys = key_schedule(static_cast<unsigned long long>(*seed_ptr));
  return r;
}

// The 4 particles at i..i+3 of a row: loads first, then draws and updates;
// stores the planes (kKind as store4) and returns the 4 log-weights.
template <int kKind, bool vec>
__device__ __forceinline__ float4 step4(const Row& r, int i, int n) {
  const float4 x = kKind == 1 ? load4_stream(r.x, i, n, vec) : load4(r.x, i, n, vec);
  const float4 se = kKind == 1 ? load4_stream(r.se, i, n, vec) : load4(r.se, i, n, vec);
  const float4 sn = kKind == 1 ? load4_stream(r.sn, i, n, vec) : load4(r.sn, i, n, vec);
  const uint32_t ci = r.pofs + static_cast<uint32_t>(i);  // the counter's particle word
  const Particle p0 = step(ci, r.grow, r.keys, x.x, se.x, sn.x, r.ge, r.gn, r.y);
  const Particle p1 = step(ci + 1, r.grow, r.keys, x.y, se.y, sn.y, r.ge, r.gn, r.y);
  const Particle p2 = step(ci + 2, r.grow, r.keys, x.z, se.z, sn.z, r.ge, r.gn, r.y);
  const Particle p3 = step(ci + 3, r.grow, r.keys, x.w, se.w, sn.w, r.ge, r.gn, r.y);
  store4<kKind>(r.x_out, i, n, vec, make_float4(p0.x, p1.x, p2.x, p3.x));
  store4<kKind>(r.se_out, i, n, vec, make_float4(p0.se, p1.se, p2.se, p3.se));
  store4<kKind>(r.sn_out, i, n, vec, make_float4(p0.sn, p1.sn, p2.sn, p3.sn));
  return make_float4(p0.lw, p1.lw, p2.lw, p3.lw);
}

#define UCSV_ARGS                                                                          \
  const long long *__restrict__ seed, const float *__restrict__ y,                        \
      const float *__restrict__ ge, long long ge_stride, const float *__restrict__ gn,     \
      long long gn_stride, const float *__restrict__ cloud, long long row_stride,          \
      long long plane_stride, float *__restrict__ out, float *__restrict__ logw, int n,    \
      int row_offset, int particle_offset
#define UCSV_ROW                                                                            \
  row_of(seed, y, ge, ge_stride, gn, gn_stride, cloud, row_stride, plane_stride, out, logw, \
         n, row_offset, particle_offset, blockIdx.x)

// Raw log-weights: grid (M, ⌈N / kTile⌉), 4 particles a thread.
template <bool vec>
__global__ void __launch_bounds__(kThreads) ucsv_raw_kernel(UCSV_ARGS) {
  const int i = blockIdx.y * kTile + 4 * threadIdx.x;
  if (i >= n) return;
  const Row r = UCSV_ROW;
  store4<0>(r.lw, i, n, vec, step4<0, vec>(r, i, n));
}

struct Moments {  // online log-sum-exp: max, Σ exp(lw − max), Σ exp(2(lw − max))
  float m, s1, s2;
};

__device__ __forceinline__ float scale_to(float from, float to) {  // exp(from − to), 0 for −inf
  return from == to ? 1.0f : fast_exp(from - to);
}

__device__ __forceinline__ Moments combine(Moments a, Moments b) {
  const float m = fmaxf(a.m, b.m);
  const float ka = a.m == -INFINITY ? 0.0f : scale_to(a.m, m);  // empty side
  const float kb = b.m == -INFINITY ? 0.0f : scale_to(b.m, m);
  return {m, a.s1 * ka + b.s1 * kb, a.s2 * ka * ka + b.s2 * kb * kb};
}

// Fold 4 log-weights (−inf past the row's end) into the thread's moments:
// one rescale of the running sums, one exp a particle.
__device__ __forceinline__ void accumulate(Moments& acc, float4 lw) {
  const float m4 = fmaxf(fmaxf(lw.x, lw.y), fmaxf(lw.z, lw.w));
  if (m4 == -INFINITY) return;
  const float m = fmaxf(acc.m, m4);
  const float alpha = acc.m == -INFINITY ? 0.0f : scale_to(acc.m, m);
  float s1 = acc.s1 * alpha, s2 = acc.s2 * alpha * alpha;
  const float v[4] = {lw.x, lw.y, lw.z, lw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e = v[k] == -INFINITY ? 0.0f : fast_exp(v[k] - m);
    s1 += e;
    s2 += e * e;
  }
  acc = {m, s1, s2};
}

// The block's lse (to every thread); thread 0 writes lse and ess of the row.
__device__ __forceinline__ float row_lse(Moments acc, float* lse_out, float* ess_out,
                                         long long row) {
  __shared__ Moments part[kWarps];
  __shared__ float lse_s;
  for (int off = 16; off > 0; off >>= 1) {
    const Moments other = {__shfl_xor_sync(kFull, acc.m, off), __shfl_xor_sync(kFull, acc.s1, off),
                           __shfl_xor_sync(kFull, acc.s2, off)};
    acc = combine(acc, other);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? part[lane] : Moments{-INFINITY, 0.0f, 0.0f};
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      const Moments other = {__shfl_xor_sync(kFull, acc.m, off),
                             __shfl_xor_sync(kFull, acc.s1, off),
                             __shfl_xor_sync(kFull, acc.s2, off)};
      acc = combine(acc, other);
    }
    if (lane == 0) {
      lse_s = acc.m + logf(acc.s1);
      lse_out[row] = lse_s;
      ess_out[row] = (acc.s1 * acc.s1) / acc.s2;
    }
  }
  __syncthreads();
  return lse_s;
}

__device__ __forceinline__ float4 masked(float4 v, int i, int n) {
  return make_float4(i < n ? v.x : -INFINITY, i + 1 < n ? v.y : -INFINITY,
                     i + 2 < n ? v.z : -INFINITY, i + 3 < n ? v.w : -INFINITY);
}

__device__ __forceinline__ float4 minus(float4 v, float s) {
  return make_float4(v.x - s, v.y - s, v.z - s, v.w - s);
}

// The block's max and its sums of two values, in every thread; the order is
// fixed, so a row's result does not depend on its neighbours.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[kWarps];
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) v = fmaxf(v, part[q]);
  return v;
}

__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 t = part[0];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) t = make_float2(t.x + part[q].x, t.y + part[q].y);
  return t;
}

// Normalized, N <= kTile: the row in registers, log_norm written once. The
// block's max first, then one exp a particle and the block's two sums.
template <bool vec>
__global__ void __launch_bounds__(kThreads)
ucsv_norm_kernel(UCSV_ARGS, float* __restrict__ lse_out, float* __restrict__ ess_out) {
  const int i = 4 * threadIdx.x;
  float4 lw = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  const Row r = UCSV_ROW;
  if (i < n) lw = masked(step4<0, vec>(r, i, n), i, n);
  const float mx = block_max(fmaxf(fmaxf(lw.x, lw.y), fmaxf(lw.z, lw.w)));
  const float v[4] = {lw.x, lw.y, lw.z, lw.w};
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e = v[k] == -INFINITY ? 0.0f : fast_exp(v[k] - mx);
    s1 += e;
    s2 += e * e;
  }
  const float2 s = block_sum2(s1, s2);
  const float lse = mx + logf(s.x);
  if (threadIdx.x == 0) {
    lse_out[blockIdx.x] = lse;
    ess_out[blockIdx.x] = (s.x * s.x) / s.y;
  }
  if (i < n) store4<0>(r.lw, i, n, vec, minus(lw, lse));
}

// Normalized, N > kTile: a loop over the row, logw kept in L2 for pass 2.
template <bool vec>
__global__ void __launch_bounds__(kThreads)
ucsv_norm_loop_kernel(UCSV_ARGS, float* __restrict__ lse_out, float* __restrict__ ess_out) {
  unsigned long long keep;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  Moments acc = {-INFINITY, 0.0f, 0.0f};
  const Row r = UCSV_ROW;
  for (int i = 4 * threadIdx.x; i < n; i += kTile) {
    const float4 lw = masked(step4<1, vec>(r, i, n), i, n);
    store4<2>(r.lw, i, n, vec, lw, keep);
    accumulate(acc, lw);
  }
  const float lse = row_lse(acc, lse_out, ess_out, blockIdx.x);
  for (int i = 4 * threadIdx.x; i < n; i += kTile) {  // this thread's own pass-1 values
    store4<0>(r.lw, i, n, vec, minus(load4_stream(r.lw, i, n, vec), lse));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <bool vec>
void launch(const long long* seed, const float* y, const float* ge, long long ge_stride,
            const float* gn, long long gn_stride, const float* cloud, long long row_stride,
            long long plane_stride, float* out, float* logw, float* lse, float* ess, int m, int n,
            int row_offset, int particle_offset, cudaStream_t stream) {
  if (lse == nullptr) {
    const dim3 grid(m, (n + kTile - 1) / kTile);
    ucsv_raw_kernel<vec><<<grid, kThreads, 0, stream>>>(seed, y, ge, ge_stride, gn, gn_stride,
                                                        cloud, row_stride, plane_stride, out,
                                                        logw, n, row_offset,
                                                        particle_offset);
  } else if (n <= kTile) {
    ucsv_norm_kernel<vec><<<m, kThreads, 0, stream>>>(seed, y, ge, ge_stride, gn, gn_stride,
                                                      cloud, row_stride, plane_stride, out, logw,
                                                      n, row_offset, particle_offset, lse,
                                                      ess);
  } else {
    ucsv_norm_loop_kernel<vec><<<m, kThreads, 0, stream>>>(seed, y, ge, ge_stride, gn,
                                                           gn_stride, cloud, row_stride,
                                                           plane_stride, out, logw, n,
                                                           row_offset, particle_offset, lse,
                                                           ess);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// seed: one int64; y: one f32; ge, gn: m f32 with the given element strides;
// cloud: (m, 3, n) f32 read through row_stride and plane_stride (elements),
// unit stride along n; out: contiguous (m, 3, n); logw: contiguous (m, n);
// lse and ess: (m) f32, both null for the raw log-weights (no normalize);
// row_offset and particle_offset: the global index of row 0 and of particle 0
// in the draws' counters.
int smc_ucsv_propagate(const long long* seed, const float* y, const float* ge,
                       long long ge_stride, const float* gn, long long gn_stride,
                       const float* cloud, long long row_stride, long long plane_stride,
                       float* out, float* logw, float* lse, float* ess, int m, int n,
                       int row_offset, int particle_offset, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  // 16-byte accesses where every row and plane starts on 16 bytes
  const bool vec = n % 4 == 0 && row_stride % 4 == 0 && plane_stride % 4 == 0 &&
                   aligned16(cloud) && aligned16(out) && aligned16(logw);
  (vec ? launch<true> : launch<false>)(seed, y, ge, ge_stride, gn, gn_stride, cloud, row_stride,
                                       plane_stride, out, logw, lse, ess, m, n, row_offset,
                                       particle_offset, stream);
  return cudaGetLastError();
}

}  // extern "C"
