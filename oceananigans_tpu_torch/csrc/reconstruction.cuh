// WENO reconstructions, the coefficient table and the periodic-axis
// interpolation and upwind reconstruction shared by the advection kernels
// (fused_advection.cu, fused_shallow_water.cu).
//
// Every stencil coefficient comes from the Python scheme objects
// (kernels/fused_advection.py coefficient_table) through a table passed by
// value, so the kernels hold no constants of their own. The reconstructions
// follow oceananigans_tpu/advection/schemes.py WENO._biased: WENO-Z weights
// α = γ(1 + (τ/(β+ε))²) with τ/(β+ε) saturated, the smoothness indicators β
// in the smoothness type S, the stencil values and the weighted sum in the
// field type T. S is float or double, or bf16 (common.cuh) with float fields:
// then every smoothness operation rounds to bfloat16 as the plain version
// does, and τ/(β+ε) is an exact division in bfloat16 (the JAX TPU kernels
// take it in float32 with the approximate reciprocal instead).
#pragma once

#include "common.cuh"

namespace oc {

// Coefficient table, filled from a flat float64 array in this order.
template <typename R>
struct Tab {
  R c4[4];          // Centered(4) symmetric, cells at offsets β-2 .. β+1
  R c2[2];          // Centered(2) symmetric, cells at offsets β-1, β
  R w5c[3][3];      // WENO-5 stencil s, cell j (offset β-1-s+j)
  R w5f[3][3][3];   // WENO-5 smoothness factor m of stencil s, cell j
  R w5g[3];         // WENO-5 optimal weights
  R w3c[2][2];      // WENO-3 stencils
  R w3f[2][2][2];   // WENO-3 smoothness factors
  R w3g[2];         // WENO-3 optimal weights
  R eps;            // ε in α = γ(1 + (τ/(β+ε))²)
  R rmax;           // saturation of τ/(β+ε)
};

constexpr int kTabSize = 4 + 2 + 9 + 27 + 3 + 4 + 8 + 2 + 2;

template <typename R>
Tab<R> make_tab(const double* v) {
  Tab<R> t;
  R* dst = reinterpret_cast<R*>(&t);
  for (int n = 0; n < kTabSize; ++n) dst[n] = (R)v[n];
  return t;
}

// The bfloat16 smoothness table: its entries arrive rounded to bfloat16 (by
// kernels/fused_advection.py coefficient_table, as PyTorch and JAX round a
// constant that meets a bfloat16 array), so the conversion is exact.
template <>
inline Tab<bf16> make_tab<bf16>(const double* v) {
  Tab<bf16> t;
  bf16* dst = reinterpret_cast<bf16*>(&t);
  for (int n = 0; n < kTabSize; ++n) dst[n] = bf16::from_host(v[n]);
  return t;
}


// WENO-5 on the upwind-selected cells q[0..4] (left-biased orientation:
// offsets β-3 .. β+1, mirrored when the advecting velocity is not > 0).
template <typename T, typename S>
__device__ __forceinline__ T weno5(const T* q, const Tab<T>& tt, const Tab<S>& ts) {
  T ps[3];
  S b[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const T* c = q + 2 - s;
    ps[s] = tt.w5c[s][0] * c[0] + tt.w5c[s][1] * c[1] + tt.w5c[s][2] * c[2];
    const S v0 = (S)c[0], v1 = (S)c[1], v2 = (S)c[2];
    S beta = S(0);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const S lin = ts.w5f[s][m][0] * v0 + ts.w5f[s][m][1] * v1 + ts.w5f[s][m][2] * v2;
      beta = beta + lin * lin;
    }
    b[s] = beta;
  }
  const S tau = absval(b[0] - b[2]);
  T num = T(0), den = T(0);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    S r = tau / (b[s] + ts.eps);
    r = r > ts.rmax ? ts.rmax : r;
    const T alpha = (T)(ts.w5g[s] * (S(1) + r * r));
    num = num + alpha * ps[s];
    den = den + alpha;
  }
  return num / den;
}

// WENO-3 on q[0..2] (offsets β-2 .. β).
template <typename T, typename S>
__device__ __forceinline__ T weno3(const T* q, const Tab<T>& tt, const Tab<S>& ts) {
  T ps[2];
  S b[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const T* c = q + 1 - s;
    ps[s] = tt.w3c[s][0] * c[0] + tt.w3c[s][1] * c[1];
    const S v0 = (S)c[0], v1 = (S)c[1];
    S beta = S(0);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const S lin = ts.w3f[s][m][0] * v0 + ts.w3f[s][m][1] * v1;
      beta = beta + lin * lin;
    }
    b[s] = beta;
  }
  const S tau = absval(b[0] - b[1]);
  T num = T(0), den = T(0);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    S r = tau / (b[s] + ts.eps);
    r = r > ts.rmax ? ts.rmax : r;
    const T alpha = (T)(ts.w3g[s] * (S(1) + r * r));
    num = num + alpha * ps[s];
    den = den + alpha;
  }
  return num / den;
}

// Scheme codes, as kernels/fused_advection.py numbers them.
constexpr int kWeno5 = 0;
constexpr int kCentered2 = 1;

// Symmetric interpolation along a periodic axis (the scheme's advecting-
// velocity stencil: Centered(4) for WENO(5), Centered(2) for itself);
// `a(o)` reads the interpolated quantity at offset o.
template <int SCH, typename T, typename Read>
__device__ __forceinline__ T symmetric(const Tab<T>& tt, int beta, Read a) {
  if constexpr (SCH == kCentered2)
    return tt.c2[0] * a(beta - 1) + tt.c2[1] * a(beta);
  else
    return tt.c4[0] * a(beta - 2) + tt.c4[1] * a(beta - 1) + tt.c4[2] * a(beta)
         + tt.c4[3] * a(beta + 1);
}

// Centered(2) "upwind" value: the selected cells in the left-biased order,
// as the reference's selected-shift evaluation forms them.
template <typename T>
__device__ __forceinline__ T centered2(const Tab<T>& tt, bool pos, T lo, T hi) {
  return tt.c2[0] * (pos ? lo : hi) + tt.c2[1] * (pos ? hi : lo);
}

// Upwind reconstruction along a periodic axis, selected by vel > 0; `q(o)`
// reads the advected field at offset o from the reconstruction point.
template <int SCH, typename T, typename S, typename Read>
__device__ __forceinline__ T upwind(const Tab<T>& tt, const Tab<S>& ts, int beta, T vel,
                                    Read q) {
  const bool pos = vel > T(0);
  if constexpr (SCH == kCentered2) {
    return centered2(tt, pos, q(beta - 1), q(beta));
  } else {
    T c[5];
#pragma unroll
    for (int n = 0; n < 5; ++n) c[n] = pos ? q(beta - 3 + n) : q(beta + 2 - n);
    return weno5(c, tt, ts);
  }
}

}  // namespace oc
