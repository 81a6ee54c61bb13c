// The TPU's vector-unit probes (kernel #12) as CUDA kernels, for the card's
// own FP32 ceiling on the WENO-5 body.
//
// Replaces, body for body and loop for loop:
// - scripts/weno_vpu_microbench.py time_for_k (pallas_call :99, body
//   weno5_body :55-74): microbench_kernel<K>, R passes over a float32 slab,
//   each pass K independent WENO-5 bodies on values derived from the carried
//   slab, folded back into it;
// - scripts/vpu_mix_probe.py measure (pallas_call :114): mix_kernel<B>, the
//   same protocol with one body per pass, for the bodies fma_chain,
//   weno_nodiv, weno_true, weno_recip and weno_approx_recip (the JAX TPU
//   kernels' approximate weight reciprocal, schemes.py:513-522, as
//   rcp.approx.ftz.f32; a measurement only, no model path takes it);
// - scripts/repro_bf16_smoothness.py kernel (pallas_call :79):
//   smoothness_kernel<S>, one WENO-5 reconstruction per element of a slab
//   whose five values are row shifts of -2..2, zero beyond the first and last
//   rows, with β and τ/(β+ε) in S (bf16 rounded as common.cuh's bf16 type
//   rounds, or float) and the rest in float32.
//
// Constants are the float32 (or bf16) roundings of the scripts' Python
// floats, as JAX rounds its weakly typed constants. The fold-back factor is a
// runtime argument, so the compiler can neither drop the bodies nor fold the
// factor; the timed runs pass the scripts' 1e-20, the checks 1.0.
//
// Bound: operations. One element per thread, everything in registers; the
// slab is read and written once. nvcc contracts products and sums into FMAs
// in the float32 bodies (the flop accounting counts the scripts' 87 + 3 or
// + 7 operations all the same). Divisions are exact (no --use_fast_math):
// an IEEE float32 division is a multi-instruction sequence with a slow path,
// which weno_true against weno_recip and weno_approx_recip measures.
#include "common.cuh"

namespace {

constexpr float kTwelfth13 = (float)(13.0 / 12.0);
constexpr float kSixth = (float)(1.0 / 6.0);
constexpr float kEps = 1e-8f;

// Body codes, as kernels/vpu_probes.py numbers them.
constexpr int kFmaChain = 0;
constexpr int kWenoNodiv = 1;
constexpr int kWenoTrue = 2;
constexpr int kWenoRecip = 3;
constexpr int kWenoApproxRecip = 4;

template <typename S>
__device__ __forceinline__ S sq(S x) { return x * x; }

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The Jiang–Shu indicators of the scripts' body, and τ = |β0 − β2|.
template <typename S>
__device__ __forceinline__ void smoothness(S c0, S c1, S c2, S c3, S c4, S& b0, S& b1,
                                           S& b2, S& tau) {
  const S k = S(kTwelfth13), q = S(0.25f), two = S(2.0f), three = S(3.0f),
          four = S(4.0f);
  b0 = k * sq(c0 - two * c1 + c2) + q * sq(c0 - four * c1 + three * c2);
  b1 = k * sq(c1 - two * c2 + c3) + q * sq(c1 - c3);
  b2 = k * sq(c2 - two * c3 + c4) + q * sq(three * c2 - four * c3 + c4);
  tau = oc::absval(b0 - b2);
}

// (a0·p0 + a1·p1 + a2·p2)·inv with the three candidate stencils.
__device__ __forceinline__ float combine(float a0, float a1, float a2, float inv, float c0,
                                         float c1, float c2, float c3, float c4) {
  const float p0 = (2.0f * c0 - 7.0f * c1 + 11.0f * c2) * kSixth;
  const float p1 = (-c1 + 5.0f * c2 + 2.0f * c3) * kSixth;
  const float p2 = (2.0f * c2 + 5.0f * c3 - c4) * kSixth;
  return (a0 * p0 + a1 * p1 + a2 * p2) * inv;
}

// One probe body on five values (the scripts' fma_chain, weno_nodiv,
// weno_true = weno5_body, weno_recip, and the approximate reciprocal).
template <int B>
__device__ __forceinline__ float body(float c0, float c1, float c2, float c3, float c4) {
  if constexpr (B == kFmaChain) {
    float r = c0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      r = r * c1 + c2;
      r = r * c3 + c4;
      r = r * c1 + c0;
      r = r * c2 + c3;
    }
    return r;
  } else {
    float b0, b1, b2, tau;
    smoothness(c0, c1, c2, c3, c4, b0, b1, b2, tau);
    float w0, w1, w2;   // τ/(β_s+ε), or the body's stand-in for it
    if constexpr (B == kWenoNodiv) {
      w0 = tau * (b0 + kEps);
      w1 = tau * (b1 + kEps);
      w2 = tau * (b2 + kEps);
    } else if constexpr (B == kWenoTrue) {
      w0 = tau / (b0 + kEps);
      w1 = tau / (b1 + kEps);
      w2 = tau / (b2 + kEps);
    } else if constexpr (B == kWenoRecip) {
      w0 = tau * (1.0f / (b0 + kEps));
      w1 = tau * (1.0f / (b1 + kEps));
      w2 = tau * (1.0f / (b2 + kEps));
    } else {
      w0 = tau * rcp_approx(b0 + kEps);
      w1 = tau * rcp_approx(b1 + kEps);
      w2 = tau * rcp_approx(b2 + kEps);
    }
    const float a0 = 0.1f * (1.0f + w0);
    const float a1 = 0.6f * (1.0f + w1);
    const float a2 = 0.3f * (1.0f + w2);
    const float inv = B == kWenoNodiv ? 1e-6f * (a0 + a1 + a2) : 1.0f / (a0 + a1 + a2);
    return combine(a0, a1, a2, inv, c0, c1, c2, c3, c4);
  }
}

// time_for_k's loop: per pass fi = x + 1e-7·i, then K bodies on
// fi·(1 + 1e-4·s) and its four scaled copies, each folded into x.
template <int K>
__global__ void __launch_bounds__(256)
microbench_kernel(const float* __restrict__ in, float* __restrict__ out, int n, int reps,
                  float fold) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float x = in[e];
  for (int i = 0; i < reps; ++i) {
    const float fi = x + 1e-7f * (float)i;
    float acc = x;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float f = fi * (float)(1.0 + 1e-4 * s);
      acc = acc + fold * body<kWenoTrue>(f, f * 1.0001f, f * 0.9999f, f * 1.0002f,
                                         f * 0.9998f);
    }
    x = acc;
  }
  out[e] = x;
}

// measure's loop: per pass fi = x·(1 + 1e-7·i) and one body, folded into x.
template <int B>
__global__ void __launch_bounds__(256)
mix_kernel(const float* __restrict__ in, float* __restrict__ out, int n, int reps,
           float fold) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float x = in[e];
  for (int i = 0; i < reps; ++i) {
    const float fi = x * (1.0f + 1e-7f * (float)i);
    x = x + fold * body<B>(fi, fi * 1.0001f, fi * 0.9999f, fi * 1.0002f, fi * 0.9998f);
  }
  out[e] = x;
}

// The bf16-smoothness repro on a (rows, cols) slab, rows outermost.
template <typename S>
__global__ void __launch_bounds__(256)
smoothness_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int cols) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)rows * cols) return;
  const int r = (int)(e / cols);
  auto at = [&](int o) { return r + o >= 0 && r + o < rows ? x[e + (long long)o * cols] : 0.0f; };
  const float c0 = at(-2), c1 = at(-1), c2 = x[e], c3 = at(1), c4 = at(2);
  S b0, b1, b2, tau;
  smoothness(S(c0), S(c1), S(c2), S(c3), S(c4), b0, b1, b2, tau);
  const S eps = S(kEps);
  const float a0 = 0.1f * (1.0f + (float)(tau / (b0 + eps)));
  const float a1 = 0.6f * (1.0f + (float)(tau / (b1 + eps)));
  const float a2 = 0.3f * (1.0f + (float)(tau / (b2 + eps)));
  out[e] = combine(a0, a1, a2, 1.0f / (a0 + a1 + a2), c0, c1, c2, c3, c4);
}

constexpr int kThreads = 256;

template <int K>
int launch_microbench(const float* in, float* out, int n, int reps, float fold,
                      cudaStream_t s) {
  microbench_kernel<K><<<oc::blocks_for(n, kThreads), kThreads, 0, s>>>(in, out, n, reps,
                                                                        fold);
  return (int)cudaGetLastError();
}

template <int B>
int launch_mix(const float* in, float* out, int n, int reps, float fold, cudaStream_t s) {
  mix_kernel<B><<<oc::blocks_for(n, kThreads), kThreads, 0, s>>>(in, out, n, reps, fold);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K: 8, 16 or 32 bodies a pass; in, out: n float32 values on the card.
int oc_weno_microbench(int K, const void* in, void* out, int n, int reps, double fold,
                       void* stream) {
  const float* x = (const float*)in;
  float* y = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  if (K == 8) return launch_microbench<8>(x, y, n, reps, (float)fold, s);
  if (K == 16) return launch_microbench<16>(x, y, n, reps, (float)fold, s);
  if (K == 32) return launch_microbench<32>(x, y, n, reps, (float)fold, s);
  return (int)cudaErrorInvalidValue;
}

// body: 0 fma_chain, 1 weno_nodiv, 2 weno_true, 3 weno_recip,
// 4 weno_approx_recip.
int oc_vpu_mix(int body, const void* in, void* out, int n, int reps, double fold,
               void* stream) {
  const float* x = (const float*)in;
  float* y = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const float f = (float)fold;
  if (n < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  if (body == kFmaChain) return launch_mix<kFmaChain>(x, y, n, reps, f, s);
  if (body == kWenoNodiv) return launch_mix<kWenoNodiv>(x, y, n, reps, f, s);
  if (body == kWenoTrue) return launch_mix<kWenoTrue>(x, y, n, reps, f, s);
  if (body == kWenoRecip) return launch_mix<kWenoRecip>(x, y, n, reps, f, s);
  if (body == kWenoApproxRecip) return launch_mix<kWenoApproxRecip>(x, y, n, reps, f, s);
  return (int)cudaErrorInvalidValue;
}

// sdtype: OC_FLOAT32 or OC_BFLOAT16 for β and τ/(β+ε); x, out: (rows, cols)
// float32 on the card.
int oc_bf16_smoothness(int sdtype, const void* x, void* out, int rows, int cols,
                       void* stream) {
  const long long n = (long long)rows * cols;
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = oc::blocks_for(n, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (sdtype == OC_BFLOAT16)
    smoothness_kernel<oc::bf16><<<blocks, kThreads, 0, s>>>((const float*)x, (float*)out,
                                                             rows, cols);
  else if (sdtype == OC_FLOAT32)
    smoothness_kernel<float><<<blocks, kThreads, 0, s>>>((const float*)x, (float*)out,
                                                          rows, cols);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
