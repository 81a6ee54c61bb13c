// Flux-form advection stencils of the block-tiled advection kernels
// (fused_advection.cu: the RK3 stage update #1 and the tendency #6): the
// flux of -∇·(𝐯q) through one face at a time (face_flux_x/y/z) for u at
// (f, c, c), v at (c, f, c), w at (c, c, f) and a tracer at (c, c, c),
// written once against a read policy that says where the stencil's values
// come from.
//
// The stencils are those of oceananigans_tpu/advection/fluxes.py div_Uu /
// div_Uv / div_Uw / div_Uc: advecting velocities by the scheme's symmetric
// interpolation of A·q (the face velocity itself for tracers), advected
// values by the upwind-selected reconstruction. Along the bounded z the order
// cascades near the walls on the global z index, as the TPU kernels' tile
// grid keeps z global (WENO5 → WENO3 → UpwindBiased(1) for the advected
// value, Centered(4) → Centered(2) for the advecting velocity). Schemes:
// WENO(5) and Centered(2) (SCH, a compile-time choice); every coefficient
// comes from the table of kernels/fused_advection.py coefficient_table.
//
// Read policies (R) of a kernel's staging, which fills a block's shared
// boxes (staged, tracer_at, in_place, at_z):
// - PaddedRead: padded fields whose halos, z included, were filled
//   beforehand; every read takes the halo values as they are, and a z index
//   outside the padded array (never read by a stencil when Hz is at least
//   the reach) stages 0.
// - CompactRead: the z-compact layout (no z halo). z reads outside [0, Nz)
//   go through the boundary mirrors the z halo would have carried (the
//   oceananigans_tpu/operators/shifts.py shift_zbc kinds): even for u, v and
//   tracers, a[-1-m] = a[m], a[N+m] = a[N-1-m]; odd about the faces for w,
//   a[-m] = -a[m], a[N] = 0, a[N+m] = -a[N-m]. The fluxes through the
//   boundary faces are zero (R::kWalls). With kCorr (the deferred
//   correction of the previous RK3 stage) every velocity read is corrected
//   on the fly from the pressure p, q = q* − Δt_prev·∂p, with w's bottom
//   face pinned to 0. kCorr is a compile-time choice, so that a read is a
//   plain load, or the loads and the correction, with no branch around it.
//   kRn (float32 fields only) rounds the correction's product and difference
//   apart, as the plain version does, where nvcc would contract them into
//   one FMA: the bfloat16-smoothness instantiation takes it, since a
//   corrected velocity one ulp away can move a bfloat16 rounding of the
//   smoothness downstream.
// - SharedRead: a block's tile in shared memory, what the face fluxes read.
//   Its boxes hold u, v, w and the advected tracer over the tile plus the
//   stencil's reach, staged through one of the two policies above, so a
//   read, at padded (i, j) and z index k, is one shared-memory load of the
//   value the staging policy gives there; kWalls is the staging policy's.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "reconstruction.cuh"

namespace oc {

// ---- read policies ------------------------------------------------------------
// Positions are padded x, padded y and the z index (0 <= k < Nz inside).

template <typename T>
struct PaddedRead {
  static constexpr bool kWalls = false;
  const T* vel[3];   // u, v, w: padded, halos filled
  Geom g;            // Hz >= the reach

  // the staging: velocity d (0 u, 1 v, 2 w) at z index k, 0 outside the
  // padded array; the offset of a tracer's value at z index k (-1: stage 0);
  // whether z indices [zs, ze) are read in place; the offset of (i, j, k)
  __device__ __forceinline__ T staged(int d, int i, int j, int k) const {
    const int kk = k + g.Hz;
    return kk >= 0 && kk < g.PZ() ? vel[d][g.at(i, j, kk)] : T(0);
  }
  __device__ __forceinline__ long long tracer_at(int i, int j, int k) const {
    const int kk = k + g.Hz;
    return kk >= 0 && kk < g.PZ() ? g.at(i, j, kk) : -1;
  }
  __device__ __forceinline__ bool in_place(int zs, int ze) const {
    return zs + g.Hz >= 0 && ze + g.Hz <= g.PZ();
  }
  __device__ __forceinline__ long long at_z(int i, int j, int k) const {
    return g.at(i, j, k + g.Hz);
  }
};

template <typename T, bool kCorr, bool kRn = false>
struct CompactRead {
  static_assert(!kRn || std::is_same<T, float>::value, "kRn takes float32 fields");
  static constexpr bool kWalls = true;
  const T* vel[3];   // u*, v*, w*: padded in x and y, no z halo
  const T* p;        // padded pressure of the deferred correction (kCorr)
  T cx, cy, cz;      // Δt_prev/Δx, Δt_prev/Δy, Δt_prev/Δz (kCorr)
  Geom g;            // Hz = 0

  // q* − f·(p[at] − p[below])
  __device__ __forceinline__ T corrected(T q, T f, long long at, long long below) const {
    if constexpr (kRn)
      return __fsub_rn(q, __fmul_rn(f, __fsub_rn(p[at], p[below])));
    else
      return q - f * (p[at] - p[below]);
  }
  __device__ __forceinline__ T u(int i, int j, int k) const {
    const long long at = g.at(i, j, k);
    if constexpr (kCorr)
      return corrected(vel[0][at], cx, at, g.at(i - 1, j, k));
    else
      return vel[0][at];
  }
  __device__ __forceinline__ T v(int i, int j, int k) const {
    const long long at = g.at(i, j, k);
    if constexpr (kCorr)
      return corrected(vel[1][at], cy, at, g.at(i, j - 1, k));
    else
      return vel[1][at];
  }
  __device__ __forceinline__ T w(int i, int j, int k) const {
    const long long at = g.at(i, j, k);
    if constexpr (kCorr) {
      if (k == 0) return T(0);
      return corrected(vel[2][at], cz, at, at - 1);
    } else {
      return vel[2][at];
    }
  }
  __device__ __forceinline__ int even(int k) const {
    return k < 0 ? -k - 1 : (k >= g.Nz ? 2 * g.Nz - 1 - k : k);
  }
  __device__ __forceinline__ T w_z(int i, int j, int k) const {
    const int N = g.Nz;
    if (k < 0) return -k < N ? -w(i, j, -k) : T(0);
    if (k >= N) return k == N ? T(0) : -w(i, j, 2 * N - k);
    return w(i, j, k);
  }

  // the staging, as PaddedRead's: the corrected velocities through the z
  // mirrors (0 where a mirror leaves the column: Nz below the reach, never
  // read), a tracer through the even mirror
  __device__ __forceinline__ T staged(int d, int i, int j, int k) const {
    if (d == 2) return k <= 2 * g.Nz ? w_z(i, j, k) : T(0);
    const int e = even(k);
    return e < 0 || e >= g.Nz ? T(0) : d == 0 ? u(i, j, e) : v(i, j, e);
  }
  __device__ __forceinline__ long long tracer_at(int i, int j, int k) const {
    const int e = even(k);
    return e < 0 || e >= g.Nz ? -1 : g.at(i, j, e);
  }
  __device__ __forceinline__ bool in_place(int zs, int ze) const {
    return zs >= 0 && ze <= g.Nz;
  }
  __device__ __forceinline__ long long at_z(int i, int j, int k) const {
    return g.at(i, j, k);
  }
};

template <typename T, bool kWalls_>
struct SharedRead {
  static constexpr bool kWalls = kWalls_;
  const T* vel[3];   // the staged u, v, w boxes
  int ox, oy, oz;    // padded x, padded y and z index of a box's first cell
  int sx, sy;        // box strides along x and y; z is contiguous
  int cz, csx, csy;  // a tracer box's: first z index and strides

  __device__ __forceinline__ int at(int i, int j, int k) const {
    return (i - ox) * sx + (j - oy) * sy + (k - oz);
  }
  __device__ __forceinline__ int at_c(int i, int j, int k) const {
    return (i - ox) * csx + (j - oy) * csy + (k - cz);
  }
  __device__ __forceinline__ T u(int i, int j, int k) const { return vel[0][at(i, j, k)]; }
  __device__ __forceinline__ T v(int i, int j, int k) const { return vel[1][at(i, j, k)]; }
  __device__ __forceinline__ T w(int i, int j, int k) const { return vel[2][at(i, j, k)]; }
  __device__ __forceinline__ T u_z(int i, int j, int k) const { return u(i, j, k); }
  __device__ __forceinline__ T v_z(int i, int j, int k) const { return v(i, j, k); }
  __device__ __forceinline__ T w_z(int i, int j, int k) const { return w(i, j, k); }
  // a: the staged box of the advected tracer
  __device__ __forceinline__ T c(const T* a, int i, int j, int k) const { return a[at_c(i, j, k)]; }
  __device__ __forceinline__ T c_z(const T* a, int i, int j, int k) const { return c(a, i, j, k); }
};

// A read policy with the scalars every stencil takes.
template <typename T, typename S, typename R>
struct Stencil {
  R rd;
  T Ax, Ay, Az, V;   // face areas and cell volume (regular grid)
  Tab<T> tt;         // stencil coefficients in the field type
  Tab<S> ts;         // smoothness factors, weights, ε, saturation
};

// ---- bounded-z interpolation and reconstruction ----------------------------------

// Symmetric interpolation along z at index kk; `a(kz)` reads A·q at absolute
// z index kz. WENO(5) cascades Centered(4) → Centered(2) outside [3-β, N-3].
template <int SCH, typename T, typename S, typename R, typename Read>
__device__ __forceinline__ T interp_z(const Stencil<T, S, R>& P, int kk, int beta, Read a) {
  if constexpr (SCH == kWeno5) {
    if (kk >= 3 - beta && kk <= P.rd.g.Nz - 3)
      return P.tt.c4[0] * a(kk + beta - 2) + P.tt.c4[1] * a(kk + beta - 1)
           + P.tt.c4[2] * a(kk + beta) + P.tt.c4[3] * a(kk + beta + 1);
  }
  return P.tt.c2[0] * a(kk + beta - 1) + P.tt.c2[1] * a(kk + beta);
}

// Upwind reconstruction along z at index kk; `q(kz)` reads at absolute z
// index kz. WENO(5): WENO-5 on [3-β, N-3], WENO-3 on [2-β, N-2],
// UpwindBiased(1) elsewhere.
template <int SCH, typename T, typename S, typename R, typename Read>
__device__ __forceinline__ T recon_z(const Stencil<T, S, R>& P, int kk, int beta, T vel,
                                     Read q) {
  const bool pos = vel > T(0);
  if constexpr (SCH == kCentered2) {
    return centered2(P.tt, pos, q(kk + beta - 1), q(kk + beta));
  } else {
    const int N = P.rd.g.Nz;
    T c[5];
    if (kk >= 3 - beta && kk <= N - 3) {
#pragma unroll
      for (int n = 0; n < 5; ++n) c[n] = pos ? q(kk + beta - 3 + n) : q(kk + beta + 2 - n);
      return weno5(c, P.tt, P.ts);
    }
    if (kk >= 2 - beta && kk <= N - 2) {
#pragma unroll
      for (int n = 1; n < 4; ++n) c[n] = pos ? q(kk + beta - 3 + n) : q(kk + beta + 2 - n);
      return weno3(c + 1, P.tt, P.ts);
    }
    return pos ? q(kk + beta - 1) : q(kk + beta);
  }
}

// ---- face fluxes, each once ---------------------------------------------------------
//
// The flux of -∇·(𝐯q) through one face, for component `comp` (0 u, 1 v, 2 w, 3
// and up the tracer whose values `a` points to, read as r.c(a, ...)). P
// gives the metrics, the tables and Nz; Q the reads. Positions are padded x,
// padded y and the z index of the face or centre the flux goes through:
//   x: u at the centre i, v at the (f, f, c) face i, w at the (f, c, f) face
//      i, a tracer at the face i;
//   y: u at the (f, f, c) face j, v at the centre j, w at the (c, f, f)
//      face j, a tracer at the face j;
//   z: u at the (f, c, f) face k, v at the (c, f, f) face k, w at the
//      centre k, a tracer at the face k; zero through the top wall (k = Nz)
//      and, for w, below the bottom face (k < 0).
template <int SCH, typename T, typename S, typename R, typename Q>
__device__ __forceinline__ T face_flux_x(const Stencil<T, S, R>& P, const Q& r, int comp,
                                         const T* a, int i, int j, int k) {
  if (comp == 0) {
    const T ut = symmetric<SCH>(P.tt, 1, [&](int o) { return P.Ax * r.u(i + o, j, k); });
    return ut * upwind<SCH>(P.tt, P.ts, 1, ut, [&](int o) { return r.u(i + o, j, k); });
  }
  if (comp == 1) {
    const T ut = symmetric<SCH>(P.tt, 0, [&](int o) { return P.Ax * r.u(i, j + o, k); });
    return ut * upwind<SCH>(P.tt, P.ts, 0, ut, [&](int o) { return r.v(i + o, j, k); });
  }
  if (comp == 2) {
    const T ut = interp_z<SCH>(P, k, 0, [&](int kz) { return P.Ax * r.u_z(i, j, kz); });
    return ut * upwind<SCH>(P.tt, P.ts, 0, ut, [&](int o) { return r.w(i + o, j, k); });
  }
  const T vel = r.u(i, j, k);
  return (P.Ax * vel) * upwind<SCH>(P.tt, P.ts, 0, vel, [&](int o) { return r.c(a, i + o, j, k); });
}

template <int SCH, typename T, typename S, typename R, typename Q>
__device__ __forceinline__ T face_flux_y(const Stencil<T, S, R>& P, const Q& r, int comp,
                                         const T* a, int i, int j, int k) {
  if (comp == 0) {
    const T vt = symmetric<SCH>(P.tt, 0, [&](int o) { return P.Ay * r.v(i + o, j, k); });
    return vt * upwind<SCH>(P.tt, P.ts, 0, vt, [&](int o) { return r.u(i, j + o, k); });
  }
  if (comp == 1) {
    const T vt = symmetric<SCH>(P.tt, 1, [&](int o) { return P.Ay * r.v(i, j + o, k); });
    return vt * upwind<SCH>(P.tt, P.ts, 1, vt, [&](int o) { return r.v(i, j + o, k); });
  }
  if (comp == 2) {
    const T vt = interp_z<SCH>(P, k, 0, [&](int kz) { return P.Ay * r.v_z(i, j, kz); });
    return vt * upwind<SCH>(P.tt, P.ts, 0, vt, [&](int o) { return r.w(i, j + o, k); });
  }
  const T vel = r.v(i, j, k);
  return (P.Ay * vel) * upwind<SCH>(P.tt, P.ts, 0, vel, [&](int o) { return r.c(a, i, j + o, k); });
}

template <int SCH, typename T, typename S, typename R, typename Q>
__device__ __forceinline__ T face_flux_z(const Stencil<T, S, R>& P, const Q& r, int comp,
                                         const T* a, int i, int j, int k) {
  if (comp == 2) {
    if (Q::kWalls && k < 0) return T(0);
    const T wt = interp_z<SCH>(P, k, 1, [&](int kz) { return P.Az * r.w_z(i, j, kz); });
    return wt * recon_z<SCH>(P, k, 1, wt, [&](int kz) { return r.w_z(i, j, kz); });
  }
  if (Q::kWalls && k == P.rd.g.Nz) return T(0);
  if (comp == 0) {
    const T wt = symmetric<SCH>(P.tt, 0, [&](int o) { return P.Az * r.w(i + o, j, k); });
    return wt * recon_z<SCH>(P, k, 0, wt, [&](int kz) { return r.u_z(i, j, kz); });
  }
  if (comp == 1) {
    const T wt = symmetric<SCH>(P.tt, 0, [&](int o) { return P.Az * r.w(i, j + o, k); });
    return wt * recon_z<SCH>(P, k, 0, wt, [&](int kz) { return r.v_z(i, j, kz); });
  }
  const T vel = r.w(i, j, k);
  return (P.Az * vel) * recon_z<SCH>(P, k, 0, vel, [&](int kz) { return r.c_z(a, i, j, kz); });
}

// Components one launch takes (kernels/build.py BATCH): the
// per-component pointers ride in the kernel's parameter block, so a call
// with more components launches once per batch of at most kBatch.
constexpr int kBatch = 32;

}  // namespace oc
