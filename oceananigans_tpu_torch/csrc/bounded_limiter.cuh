// The bounds-preserving limiter of the padded tendency kernel #6
// (advection_kernel.cuh, kBnd; instantiated in advection_bounded_k2.cu ..
// advection_bounded_k6.cu): the tracer fluxes of WENO(2K-1, bounds=(lo,
// hi)), as oceananigans_tpu/advection/fluxes.py _div_Uc_bounded forms them
// (the port's plain version: advection/fluxes.py _div_Uc_bounded).
//
// Along each axis, cell i has a factor θ_i ≤ 1 from its mean c, its two
// outward reconstructions (right-biased at its left face i, cR; left-biased
// at its right face i + 1, cL) and p̃ = (c − ω̂cR − ω̂cL)/(1 − 2ω̂), ω̂ = 5/18:
//
//   M = max(p̃, cL, cR),  m = min(p̃, cL, cR)
//   θ = min(|(hi − c)/(M − c + ε₂)|, |(lo − c)/(m − c + ε₂)|, 1),  ε₂ = 1e-20
//
// and its two limited values θ(cR − c) + c at face i and θ(cL − c) + c at
// face i + 1. Face i's flux is A·u·(u > 0 ? the value cell i − 1 gives it
//                                          : the value cell i gives it).
//
// A face of the tile takes the values of the cells on both its sides, so a
// block forms them over its tile plus one cell each way along the flux's
// axis (cells -1 .. T), into shared memory, before that axis's fluxes: two
// reconstructions a cell, each once, as the plain version forms them. Those
// cells' reconstructions read cells -K .. T+K-1 (a biased stencil of buffer
// K is 2K-1 cells wide), which the staged box already holds: the reach
// stays the scheme's. A flat axis has no limiter and no flux. The products
// and differences round apart (no FMA contraction; the sources that
// instantiate it build with -fmad=false, so that the reconstructions do
// too: kernels/build.py SOURCE_FLAGS) and the ratios are exact divisions,
// in the plain version's order; max and min propagate a NaN as
// torch.maximum / torch.minimum do.
#pragma once

#include <type_traits>

#include "advection_stencils.cuh"

namespace oc {

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b) {
  if constexpr (std::is_same<T, float>::value)
    return __fmul_rn(a, b);
  else
    return __dmul_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T add_rn(T a, T b) {
  if constexpr (std::is_same<T, float>::value)
    return __fadd_rn(a, b);
  else
    return __dadd_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) {
  if constexpr (std::is_same<T, float>::value)
    return __fsub_rn(a, b);
  else
    return __dsub_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

// The biased reconstruction at the face through `at` (the cell on the
// face's high side) along axis ax (0 x, 1 y, 2 z) of a tracer box of
// stride st, left-biased when pos; along z at the order level of face
// index k (the cascade on a bounded z).
template <int ZM, int K, int F, typename T, typename S>
__device__ __forceinline__ T bounded_recon(const Stencil<K, F, T, S>& P, int ax, int k, bool pos,
                                           const T* at, int st) {
  const Line<T> q(at, st, 0);
  if (P.any) {
    if constexpr (ZM != kZFlat) {
      if (ax == 2) return recon_z<true>(P, z_level<ZM, true>(P, k, 0), pos, q);
    }
    return recon_xy<true>(P, ax, pos, q);
  }
  if constexpr (ZM != kZFlat) {
    if (ax == 2) return recon_z<false>(P, z_level<ZM>(P, k, 0), pos, q);
  }
  return recon_xy<false>(P, ax, pos, q);
}

// The stride of a tracer box along axis ax.
template <typename Q>
__device__ __forceinline__ int box_stride(const Q& r, int ax) {
  return ax == 0 ? r.csx : ax == 1 ? r.csy : 1;
}

// The limited values of the cell at padded (i, j) and z index k along axis
// ax, from the tracer box a: θ(cR − c) + c at its low face into *at_low,
// θ(cL − c) + c at its high face into *at_high.
template <int ZM, int K, int F, typename T, typename S, typename Q>
__device__ __forceinline__ void limited_values(const Stencil<K, F, T, S>& P, const Q& r,
                                               const T* a, int ax, int i, int j, int k, T lo,
                                               T hi, T* at_low, T* at_high) {
  const int st = box_stride(r, ax);
  const T* at = a + r.at_c(i, j, k);
  const T c = at[0];
  const T cR = bounded_recon<ZM>(P, ax, k, false, at, st);
  const T cL = bounded_recon<ZM>(P, ax, k + 1, true, at + st, st);
  constexpr double kOmega = 5.0 / 18.0;
  const T om = T(kOmega), den = T(1.0 - 2.0 * kOmega), eps = T(1e-20);
  const T pt = sub_rn(sub_rn(c, mul_rn(om, cR)), mul_rn(om, cL)) / den;
  const T M = nan_max(nan_max(pt, cL), cR);
  const T m = nan_min(nan_min(pt, cL), cR);
  const T up = fabs(sub_rn(hi, c) / add_rn(sub_rn(M, c), eps));
  const T down = fabs(sub_rn(lo, c) / add_rn(sub_rn(m, c), eps));
  const T th = nan_min(nan_min(up, down), T(1));
  if (at_low != nullptr) *at_low = add_rn(mul_rn(th, sub_rn(cR, c)), c);
  if (at_high != nullptr) *at_high = add_rn(mul_rn(th, sub_rn(cL, c)), c);
}

// The limited flux of -∇·(𝐯c) through the face at padded (i, j) and z
// index k along axis ax, with the limited values its low-side cell (vl) and
// its high-side cell (vh) give it; A the face area.
template <typename T, typename Q>
__device__ __forceinline__ T limited_flux(const Q& r, int ax, int i, int j, int k, T A, T vl,
                                          T vh) {
  const T vel = r.box(ax)[r.at(i, j, k)];
  return mul_rn(mul_rn(A, vel), vel > T(0) ? vl : vh);
}

}  // namespace oc
