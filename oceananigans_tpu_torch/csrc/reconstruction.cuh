// The reconstructions of the advection kernels (advection_kernel.cuh: #1
// and #6; sw_kernel.cuh: #8) for every scheme of
// oceananigans_tpu/advection/schemes.py: Centered(2B) for B = 1..6,
// UpwindBiased(2B-1) and WENO(2B-1) (B >= 2), each with its near-wall order
// cascade, a different one along each axis (a FluxFormAdvection), and the
// coefficient table they read.
//
// Every coefficient comes from the Python scheme objects
// (kernels/fused_advection.py coefficient_table) through a table passed by
// value, so the kernels hold no constants of their own. A kernel is
// instantiated for one buffer K (the deepest reach of the scheme's axes)
// and one family (Centered, UpwindBiased or WENO: WENO when any axis is), both
// compile-time choices; each axis's family and buffer (at most K) come at
// run time from the table's last kAxisEntries values, so a FluxFormAdvection
// takes the instantiation of its deepest axis and no other: a thinner
// bounded z of the instantiation's family only caps the cascade's level,
// any other difference runs the launch through biased_any and symmetric_any
// (loops over the runtime buffer). The table holds the rows of every buffer
// up to K.
//
// The reconstructions follow the port's plain versions
// (advection/schemes.py): a reconstruction at buffer B reads the cells of
// its line at offsets β-B .. β+B-1 from the reconstruction point, selected
// by the advecting velocity's sign (cell n at β-B+n when it is > 0, at
// β+B-1-n when not: the reference's selected-shift evaluation, Centered
// included). WENO-(2B-1) is WENO-Z: α = γ(1 + (τ/(β+ε))²) with τ = |Σ_s t_s
// β_s| and τ/(β+ε) saturated, the smoothness indicators β_s in the
// smoothness type S, the stencil values and the weighted sum in the field
// type T. S is float or double, or bf16 (common.cuh) with float fields: then
// every smoothness operation rounds to bfloat16 as the plain version does,
// and τ/(β+ε) is an exact division in bfloat16 (the JAX TPU kernels take it
// in float32 with the approximate reciprocal instead).
#pragma once

#include "common.cuh"

namespace oc {

// Scheme families, as kernels/fused_advection.py numbers them.
constexpr int kCentered = 0;
constexpr int kUpwind = 1;
constexpr int kWeno = 2;

// The deepest buffer a kernel is built for (Centered(12), UpwindBiased(11),
// WENO(11)).
constexpr int kMaxBuffer = 6;

// ---- the coefficient table -------------------------------------------------------
//
// For a kernel of buffer K, a flat float64 array in this order (offsets in
// elements), the linear part first:
//   sym_b   b = 1..K   Centered(2b): 2b coefficients, cells β-b .. β+b-1
//   ub_k    k = 1..K   UpwindBiased(2k-1): 2k-1 coefficients, cells β-k ..
//                      β+k-2 of the left-biased orientation
//   wc_k    k = 2..K   WENO-(2k-1) stencil s, cell j (k × k; offset β-1-s+j)
// then the smoothness part:
//   wf_k    k = 2..K   smoothness factor m of stencil s, cell j (k × k × k;
//                      the rows past a stencil's factors zero)
//   wg_k    k = 2..K   optimal weights (k)
//   wt_k    k = 2..K   τ coefficients (k)
//   ε, the saturation of τ/(β+ε)
__host__ __device__ constexpr int off_sym(int b) { return b * (b - 1); }
__host__ __device__ constexpr int off_ub(int K, int k) { return K * (K + 1) + (k - 1) * (k - 1); }
__host__ __device__ constexpr int off_wc(int K, int k) {
  int o = K * (K + 1) + K * K;
  for (int i = 2; i < k; ++i) o += i * i;
  return o;
}
__host__ __device__ constexpr int lin_size(int K) { return off_wc(K, K + 1); }
__host__ __device__ constexpr int off_wf(int k) {
  int o = 0;
  for (int i = 2; i < k; ++i) o += i * i * i;
  return o;
}
__host__ __device__ constexpr int off_wg(int K, int k) {
  int o = off_wf(K + 1);
  for (int i = 2; i < k; ++i) o += i;
  return o;
}
__host__ __device__ constexpr int off_wt(int K, int k) {
  return off_wg(K, K + 1) + off_wg(K, k) - off_wf(K + 1);
}
__host__ __device__ constexpr int off_eps(int K) { return off_wt(K, K + 1); }
__host__ __device__ constexpr int smooth_size(int K) { return off_eps(K) + 2; }
__host__ __device__ constexpr int table_size(int K) { return lin_size(K) + smooth_size(K); }

// After the table: each axis's family (x, y, z), then its buffer (x, y, z).
constexpr int kAxisEntries = 6;
__host__ __device__ constexpr int coefs_size(int K) { return table_size(K) + kAxisEntries; }

// Whether a launch takes the per-axis code: an axis whose family is not F
// or (along x and y, and along z unless it is bounded, where the cascade
// caps it) whose buffer is not K. A WENO kernel's UpwindBiased(1) axis is
// its family's buffer-1 level (WENO's cascade ends in UpwindBiased(1)), and
// is encoded so (host side).
inline bool any_axis(int F, int K, int* fam, const int* buf, bool bounded_z) {
  for (int a = 0; a < 3; ++a)
    if (F == kWeno && fam[a] == kUpwind && buf[a] == 1) fam[a] = kWeno;
  for (int a = 0; a < 3; ++a)
    if (fam[a] != F || (buf[a] != K && (a < 2 || !bounded_z))) return true;
  return false;
}

// The axes' families and buffers from a table of buffer K (host side):
// false unless each family is one of the kernel's (WENO only in a WENO
// kernel, W, and with a buffer of 2 or more) and each buffer is 1..K.
inline bool axis_codes(const double* coefs, int K, bool W, int* fam, int* buf) {
  for (int a = 0; a < 3; ++a) {
    fam[a] = (int)coefs[table_size(K) + a];
    buf[a] = (int)coefs[table_size(K) + 3 + a];
    if (fam[a] < kCentered || fam[a] > kWeno || buf[a] < 1 || buf[a] > K ||
        (fam[a] == kWeno && (!W || buf[a] < 2)))
      return false;
  }
  return true;
}

template <typename R, int N>
struct Flat {
  R v[N];
};

// A table entry in the field or smoothness type. The bfloat16 smoothness
// entries arrive rounded to bfloat16 (coefficient_table rounds them, as
// PyTorch and JAX round a constant that meets a bfloat16 array), so their
// conversion is exact.
template <typename R>
inline R from_table(double v) {
  return (R)v;
}
template <>
inline bf16 from_table<bf16>(double v) {
  return bf16::from_host(v);
}

// The table of a kernel of buffer K: the linear part in the field type T;
// for WENO (W) the smoothness part in S (a linear kernel keeps one unused
// entry).
template <int K, bool W, typename T, typename S>
struct Tabs {
  Flat<T, lin_size(K)> lin;
  Flat<S, W ? smooth_size(K) : 1> sm;

  static Tabs make(const double* v) {
    Tabs t;
    for (int n = 0; n < lin_size(K); ++n) t.lin.v[n] = from_table<T>(v[n]);
    for (int n = 0; n < (W ? smooth_size(K) : 1); ++n)
      t.sm.v[n] = from_table<S>(W ? v[lin_size(K) + n] : 0.0);
    return t;
  }
};

// ---- reconstructions on a line --------------------------------------------------
// `a(o)` / `q(o)` read the line at offset o from the reconstruction point.

// Centered(2B): Σ_n c[n]·a(β-B+n), summed in the plain version's order.
template <int B, typename T, typename A>
__device__ __forceinline__ T centered(const T* c, int beta, A a) {
  T acc = c[0] * a(beta - B);
#pragma unroll
  for (int n = 1; n < 2 * B; ++n) acc = acc + c[n] * a(beta - B + n);
  return acc;
}

// A linear reconstruction of L cells on the selected cells c: Σ_n coef[n]·c[n].
template <int L, typename T>
__device__ __forceinline__ T linear(const T* coef, const T* c) {
  T acc = coef[0] * c[0];
#pragma unroll
  for (int n = 1; n < L; ++n) acc = acc + coef[n] * c[n];
  return acc;
}

// ---- WENO-Z, shared with the hydrostatic kernel (vi_kernel.cuh) -------------------

// The smoothness indicator of one stencil of buffer B in S: Σ_m (Σ_j f(m, j)·v[j])²
// over its B cells v, f(m, j) the factor of row m and cell j.
template <int B, typename S, typename F>
__device__ __forceinline__ S smoothness_indicator(F f, const S* v) {
  S beta = S(0);
#pragma unroll
  for (int m = 0; m < B; ++m) {
    S lin = f(m, 0) * v[0];
#pragma unroll
    for (int j = 1; j < B; ++j) lin = lin + f(m, j) * v[j];
    beta = m == 0 ? lin * lin : beta + lin * lin;
  }
  return beta;
}

// WENO-Z of the B stencil values p with smoothness indicators b: α_s =
// γ(s)(1 + (τ/(b_s+ε))²) with τ = |Σ_s t(s) b_s| (the terms of a zero t(s)
// skipped, as the plain version skips them) and τ/(b_s+ε) saturated at rmax;
// the weights in S, the weighted sum Σ α_s p_s / Σ α_s in T.
template <int B, typename T, typename S, typename G, typename Tau>
__device__ __forceinline__ T weno_z(const T* p, const S* b, G gam, Tau t, S eps, S rmax) {
  S tau = b[0];
#pragma unroll
  for (int s = 1; s < B; ++s)
    if ((float)t(s) != 0.0f) tau = tau + t(s) * b[s];
  tau = absval(tau);
  T num = T(0), den = T(0);
#pragma unroll
  for (int s = 0; s < B; ++s) {
    S r = tau / (b[s] + eps);
    r = r > rmax ? rmax : r;
    const T alpha = (T)(gam(s) * (S(1) + r * r));
    num = num + alpha * p[s];
    den = den + alpha;
  }
  return num / den;
}

// WENO-(2B-1) on the selected cells c[0 .. 2B-2]: stencil s takes cells
// B-1-s .. 2B-2-s.
template <int B, int K, typename T, typename S>
__device__ __forceinline__ T weno(const Tabs<K, true, T, S>& tab, const T* c) {
  const T* wc = tab.lin.v + off_wc(K, B);
  const S* wf = tab.sm.v + off_wf(B);
  const S* wg = tab.sm.v + off_wg(K, B);
  const S* wt = tab.sm.v + off_wt(K, B);
  T p[B];
  S b[B];
#pragma unroll
  for (int s = 0; s < B; ++s) {
    const int o = B - 1 - s;
    T acc = wc[s * B] * c[o];
#pragma unroll
    for (int j = 1; j < B; ++j) acc = acc + wc[s * B + j] * c[o + j];
    p[s] = acc;
    S v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = (S)c[o + j];
    b[s] = smoothness_indicator<B>([&](int m, int j) { return wf[(s * B + m) * B + j]; }, v);
  }
  return weno_z<B>(p, b, [&](int s) { return wg[s]; }, [&](int s) { return wt[s]; },
                   tab.sm.v[off_eps(K)], tab.sm.v[off_eps(K) + 1]);
}

// The advected value of the scheme at buffer B (B = K: the scheme itself;
// below it, the buffer schemes of the cascade), selected by pos: WENO
// (B >= 2), UpwindBiased(2B-1) (WENO's B = 1 is UpwindBiased(1)) or
// Centered(2B) selected. The 2B cells β-B .. β+B-1 are read whatever the
// sign (the mirror of that window is the window reversed), so the loads do
// not wait for the advecting velocity; cell n of the selected orientation
// is then d[n] when pos, d[2B-1-n] when not.
template <int B, int K, bool W, typename T, typename S, typename Q>
__device__ __forceinline__ T biased(int fam, const Tabs<K, W, T, S>& tab, int beta, bool pos,
                                    Q q) {
  T d[2 * B], c[2 * B];
#pragma unroll
  for (int n = 0; n < 2 * B; ++n) d[n] = q(beta - B + n);
#pragma unroll
  for (int n = 0; n < 2 * B; ++n) c[n] = pos ? d[n] : d[2 * B - 1 - n];
  if constexpr (W && B >= 2) {
    return weno<B>(tab, c);
  } else {
    if (!W && fam == kCentered) return linear<2 * B>(tab.lin.v + off_sym(B), c);
    return linear<2 * B - 1>(tab.lin.v + off_ub(K, B), c);
  }
}

// The advected value at a buffer Ba <= K and a family fam known only at run
// time (the axes of a launch whose FluxFormAdvection is not all the
// instantiation's scheme): the same operations in the same order as
// biased<Ba> of that family, by loops over Ba that are not unrolled, in a
// function of its own (one body an instantiation and accessor type; an
// unrolled body a buffer and family at every call site took the deepest
// source's nvcc time from about 340 to 478 s on the card's host, and
// runtime checks inside the unrolled paths slowed #1 by 14% and #8 by 39%).
// Slower than the unrolled code; only such launches take it.
template <int K, bool W, typename T, typename S, typename Q>
__device__ __forceinline__ T biased_any_inline(int Ba, int fam, const Tabs<K, W, T, S>& tab,
                                               int beta, bool pos, Q q) {
  T c[2 * K];
#pragma unroll 1
  for (int n = 0; n < 2 * Ba; ++n) {
    const int m = pos ? n : 2 * Ba - 1 - n;
    c[n] = q(beta - Ba + m);
  }
  if constexpr (W) {
    if (Ba >= 2 && fam == kWeno) {
      const T* wc = tab.lin.v + off_wc(K, Ba);
      const S* wf = tab.sm.v + off_wf(Ba);
      const S* wg = tab.sm.v + off_wg(K, Ba);
      const S* wt = tab.sm.v + off_wt(K, Ba);
      T p[K];
      S b[K];
#pragma unroll 1
      for (int s = 0; s < Ba; ++s) {
        const int o = Ba - 1 - s;
        T acc = wc[s * Ba] * c[o];
#pragma unroll 1
        for (int j = 1; j < Ba; ++j) acc = acc + wc[s * Ba + j] * c[o + j];
        p[s] = acc;
        S beta_s = S(0);
#pragma unroll 1
        for (int m = 0; m < Ba; ++m) {
          const S* f = wf + (s * Ba + m) * Ba;
          S lin = f[0] * (S)c[o];
#pragma unroll 1
          for (int j = 1; j < Ba; ++j) lin = lin + f[j] * (S)c[o + j];
          beta_s = m == 0 ? lin * lin : beta_s + lin * lin;
        }
        b[s] = beta_s;
      }
      const S eps = tab.sm.v[off_eps(K)], rmax = tab.sm.v[off_eps(K) + 1];
      S tau = b[0];
#pragma unroll 1
      for (int s = 1; s < Ba; ++s)
        if ((float)wt[s] != 0.0f) tau = tau + wt[s] * b[s];
      tau = absval(tau);
      T num = T(0), den = T(0);
#pragma unroll 1
      for (int s = 0; s < Ba; ++s) {
        S r = tau / (b[s] + eps);
        r = r > rmax ? rmax : r;
        const T alpha = (T)(wg[s] * (S(1) + r * r));
        num = num + alpha * p[s];
        den = den + alpha;
      }
      return num / den;
    }
  }
  const bool sym = fam == kCentered;
  const T* coef = tab.lin.v + (sym ? off_sym(Ba) : off_ub(K, Ba));
  const int L = sym ? 2 * Ba : 2 * Ba - 1;
  T acc = coef[0] * c[0];
#pragma unroll 1
  for (int n = 1; n < L; ++n) acc = acc + coef[n] * c[n];
  return acc;
}

// biased_any_inline as a function of its own, for accessors that hold no
// reference to the caller's locals (advection_stencils.cuh's Line): one
// body an instantiation and accessor type. The shallow-water kernel, whose
// accessors are lambdas over its locals, takes the inline version: a call
// would put those locals in local memory on every path.
template <int K, bool W, typename T, typename S, typename Q>
__device__ __noinline__ T biased_any(int Ba, int fam, const Tabs<K, W, T, S>& tab, int beta,
                                     bool pos, Q q) {
  return biased_any_inline(Ba, fam, tab, beta, pos, q);
}

// The interpolation of an advecting velocity at buffer Ba <= K of family
// fam known only at run time: symmetric<Ba> of that family (Centered(2Ba)
// for Centered, Centered(max(2Ba-2, 2)) for UpwindBiased and WENO), by a
// loop. biased_any and symmetric_any serve a launch whose axes are not all
// the instantiation's (advection_stencils.cuh kAny, sw_kernel.cuh); every
// other launch runs the unrolled code above.
template <int K, bool W, typename T, typename S, typename A>
__device__ __forceinline__ T symmetric_any(int Ba, int fam, const Tabs<K, W, T, S>& tab, int beta,
                                           A a) {
  const int Bv = fam == kCentered ? Ba : (Ba > 1 ? Ba - 1 : 1);
  const T* c = tab.lin.v + off_sym(Bv);
  T acc = c[0] * a(beta - Bv);
#pragma unroll 1
  for (int n = 1; n < 2 * Bv; ++n) acc = acc + c[n] * a(beta - Bv + n);
  return acc;
}

// The advecting velocity's interpolation at buffer B: the scheme's
// advecting-velocity scheme, Centered(2B) for Centered and
// Centered(max(2B-2, 2)) for UpwindBiased and WENO.
template <int B, int K, bool W, typename T, typename S, typename A>
__device__ __forceinline__ T symmetric(int fam, const Tabs<K, W, T, S>& tab, int beta, A a) {
  constexpr int Bv = B > 1 ? B - 1 : 1;
  if (!W && fam == kCentered) return centered<B>(tab.lin.v + off_sym(B), beta, a);
  return centered<Bv>(tab.lin.v + off_sym(Bv), beta, a);
}

// ---- the near-wall cascade along a bounded axis ------------------------------------

// The buffer a scheme of buffer K takes at index kk (0 .. N-1 inside) along
// a bounded axis of N cells: the largest B >= 2 with B-β <= kk <= N-B, else 1
// (advection/schemes.py cascade_mask on the global index). The hydrostatic
// kernel takes its closed form, min(K, kk + β, N - kk) (vi_kernel.cuh level).
__device__ __forceinline__ int cascade_level(int K, int kk, int beta, int N) {
#pragma unroll
  for (int B = K; B >= 2; --B)
    if (kk >= B - beta && kk <= N - B) return B;
  return 1;
}

template <int B, int K, bool W, typename T, typename S, typename Q>
__device__ __forceinline__ T biased_level(int level, int fam, const Tabs<K, W, T, S>& tab,
                                          int beta, bool pos, Q q) {
  if constexpr (B > 1) {
    if (level < B) return biased_level<B - 1>(level, fam, tab, beta, pos, q);
  }
  return biased<B>(fam, tab, beta, pos, q);
}

template <int B, int K, bool W, typename T, typename S, typename A>
__device__ __forceinline__ T symmetric_level(int level, int fam, const Tabs<K, W, T, S>& tab,
                                             int beta, A a) {
  if constexpr (B > 1) {
    if (level < B) return symmetric_level<B - 1>(level, fam, tab, beta, a);
  }
  return symmetric<B>(fam, tab, beta, a);
}

}  // namespace oc
