// Flux-form advection stencils of the block-tiled advection kernels
// (advection_kernel.cuh: the RK3 stage update #1 and the tendency #6): the
// flux of -∇·(𝐯q) through one face at a time (face_flux_x/y/z) for u at
// (f, c, c), v at (c, f, c), w at (c, c, f) and a tracer at (c, c, c),
// written once against the block's staged boxes.
//
// The stencils are those of oceananigans_tpu/advection/fluxes.py div_Uu /
// div_Uv / div_Uw / div_Uc: advecting velocities by the scheme's symmetric
// interpolation of A·q (the face velocity itself for tracers), advected
// values by the upwind-selected reconstruction (reconstruction.cuh). Along
// a bounded z the order cascades near the walls on the global z index, as
// the TPU kernels' tile grid keeps z global (a periodic or flat z has no
// cascade, as the TPU kernel's slab grid keeps z's topology): a scheme of
// buffer K takes its
// buffer schemes down to buffer 1 (WENO(9) → 7 → 5 → 3 → UpwindBiased(1),
// UpwindBiased(5) → 3 → 1, Centered(8) → 6 → 4 → 2), the advecting
// velocity's interpolation with them. Every scheme of
// oceananigans_tpu/advection/schemes.py: Centered(2-12), UpwindBiased(1-11)
// and WENO(3-11); the buffer K and the family are compile-time choices, and
// every coefficient comes from the table of
// kernels/fused_advection.py coefficient_table. A FluxFormAdvection takes
// its deepest axis's instantiation: a thinner bounded z of its family caps
// the cascade (the flux functions as they are), any other axis of another
// family or buffer sends the launch through the kAny flux functions, every
// axis at run time (reconstruction.cuh biased_any).
//
// Each face flux reads one line of a staged box per term: the advecting
// velocity's line (A·u, A·v or A·w along the interpolated axis) and the
// advected field's line along the flux's axis, each at a stride of its box,
// so that a face flux of any momentum component is one interpolation and
// one reconstruction, and a tracer's one reconstruction.
//
// Read policies (R) of a kernel's staging, which fills a block's shared
// boxes (staged, tracer_at, in_place, at_z):
// - PaddedRead: padded fields whose halos, z included, were filled
//   beforehand (a bounded or periodic z, Hz at least the reach; or a flat z,
//   Nz = 1 and Hz = 0, which no stencil reads along); every read takes the
//   halo values as they are, and a z index outside the padded array (never
//   read by a stencil) stages 0.
// - CompactRead: the z-compact layout (no z halo). z reads outside [0, Nz)
//   go through the boundary mirrors the z halo would have carried (the
//   oceananigans_tpu/operators/shifts.py shift_zbc kinds): even for u, v and
//   tracers, a[-1-m] = a[m], a[N+m] = a[N-1-m]; odd about the faces for w,
//   a[-m] = -a[m], a[N] = 0, a[N+m] = -a[N-m]. The fluxes through the
//   boundary faces are zero (R::kWalls). Given a pressure p (the deferred
//   correction of the previous RK3 stage) every velocity read is corrected
//   on the fly, q = q* − Δt_prev·∂p, with w's bottom face pinned to 0; the
//   staging reads each velocity once a block, so the choice is a branch
//   uniform across the launch. kRn (float32 fields only) rounds the
//   correction's product and difference apart, as the plain version does,
//   where nvcc would contract them into one FMA: the bfloat16-smoothness
//   instantiation takes it, since a corrected velocity one ulp away can move
//   a bfloat16 rounding of the smoothness downstream.
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

// The z topology of a launch (kernels/fused_advection.py Z_MODES), a
// compile-time property of the read policy: a bounded z takes the near-wall
// cascade on the z index (padded or z-compact), a periodic z reads its filled
// halos and has no cascade, a flat z (Nz = 1, no z halo) has no z flux and no
// z reach.
constexpr int kZBounded = 0, kZPeriodic = 1, kZFlat = 2;

// ---- read policies ------------------------------------------------------------
// Positions are padded x, padded y and the z index (0 <= k < Nz inside).

template <typename T, int ZM = kZBounded>
struct PaddedRead {
  static constexpr bool kWalls = false;
  static constexpr int kZMode = ZM;
  const T* vel[3];   // u, v, w: padded, halos filled
  Geom g;            // Hz >= the reach (a flat z: Nz = 1, Hz = 0)

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

template <typename T, bool kRn = false>
struct CompactRead {
  static_assert(!kRn || std::is_same<T, float>::value, "kRn takes float32 fields");
  static constexpr bool kWalls = true;
  static constexpr int kZMode = kZBounded;
  const T* vel[3];   // u*, v*, w*: padded in x and y, no z halo
  const T* p;        // padded pressure of the deferred correction, or null
  T cx, cy, cz;      // Δt_prev/Δx, Δt_prev/Δy, Δt_prev/Δz (with p)
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
    return p != nullptr ? corrected(vel[0][at], cx, at, g.at(i - 1, j, k)) : vel[0][at];
  }
  __device__ __forceinline__ T v(int i, int j, int k) const {
    const long long at = g.at(i, j, k);
    return p != nullptr ? corrected(vel[1][at], cy, at, g.at(i, j - 1, k)) : vel[1][at];
  }
  __device__ __forceinline__ T w(int i, int j, int k) const {
    const long long at = g.at(i, j, k);
    if (p == nullptr) return vel[2][at];
    if (k == 0) return T(0);
    return corrected(vel[2][at], cz, at, at - 1);
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

template <typename T, bool kWalls_, int ZM>
struct SharedRead {
  static constexpr bool kWalls = kWalls_;
  static constexpr int kZMode = ZM;
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
  // the box of velocity component d (0 u, 1 v, 2 w), chosen by selects:
  // indexing vel by a runtime d would put the whole struct in local memory
  __device__ __forceinline__ const T* box(int d) const {
    return d == 0 ? vel[0] : d == 1 ? vel[1] : vel[2];
  }
};

// The scalars every stencil takes, with the coefficient table of a kernel
// of buffer K and family F (kCentered, kUpwind or kWeno), both compile-time
// choices.
template <int K, int F, typename T, typename S>
struct Stencil {
  static constexpr int fam = F;
  T Ax, Ay, Az, V;   // face areas and cell volume (regular grid)
  int Nz;            // the bounded z's cells (the cascade)
  Tabs<K, F == kWeno, T, S> tab;
  int af[3], ak[3];  // each axis's family and buffer (a FluxFormAdvection's)
  int any;           // an axis that is not (F, K), bar a bounded z's
                     // buffer: the launch takes the per-axis fluxes
};

// An axis's family and buffer, x or y by a select (indexing by a runtime
// axis would put the struct in local memory).
template <int K, int F, typename T, typename S>
__device__ __forceinline__ int axis_fam(const Stencil<K, F, T, S>& P, int ax) {
  return ax == 0 ? P.af[0] : ax == 1 ? P.af[1] : P.af[2];
}
template <int K, int F, typename T, typename S>
__device__ __forceinline__ int axis_buf(const Stencil<K, F, T, S>& P, int ax) {
  return ax == 0 ? P.ak[0] : ax == 1 ? P.ak[1] : P.ak[2];
}

// The order level along z at index kk with orientation β: the cascade on a
// bounded z (capped at z's buffer, which a FluxFormAdvection's thin z
// lowers: min(cascade_level(K), Kz) is cascade_level(Kz), the cascade's
// condition holding for every buffer below one it holds for), the scheme's
// own buffer on a periodic one; kAny: z's buffer at run time there too.
template <int ZM, bool kAny = false, int K, int F, typename T, typename S>
__device__ __forceinline__ int z_level(const Stencil<K, F, T, S>& P, int kk, int beta) {
  if constexpr (ZM == kZBounded) {
    const int L = cascade_level(K, kk, beta, P.Nz);
    return L < P.ak[2] ? L : P.ak[2];
  } else {
    return kAny ? P.ak[2] : K;
  }
}

// ---- face fluxes, each once ---------------------------------------------------------
//
// The flux of -∇·(𝐯q) through one face, for component `comp` (0 u, 1 v, 2 w, 3
// and up the tracer whose box `a` points to). P gives the metrics and the
// table; r the staged boxes. Positions are padded x, padded y and the z
// index of the face or centre the flux goes through:
//   x: u at the centre i, v at the (f, f, c) face i, w at the (f, c, f) face
//      i, a tracer at the face i;
//   y: u at the (f, f, c) face j, v at the centre j, w at the (c, f, f)
//      face j, a tracer at the face j;
//   z: u at the (f, c, f) face k, v at the (c, f, f) face k, w at the
//      centre k, a tracer at the face k; zero through the top wall (k = Nz)
//      and, for w, below the bottom face (k < 0), and zero on a flat z.
// The advecting velocity is the scheme's interpolation of A·u (A·v, A·w)
// along x or y (periodic: the scheme's own buffer) or along z (the cascade
// on the z index), or, for a tracer, the face velocity; the advected value
// is the reconstruction along the flux's axis, selected by its sign.

// A line of a staged box at stride st, through the point at `at`, counted
// from the reconstruction's orientation β: q(o) reads offset β + o, so that
// the reconstructions take β = 0 and their offsets are compile-time
// constants.
template <typename T>
struct Line {
  const T* p;
  int st;
  __device__ __forceinline__ Line(const T* at, int st_, int beta)
      : p(at + beta * st_), st(st_) {}
  __device__ __forceinline__ T operator()(int o) const { return p[o * st]; }
};

// The advecting velocity interpolated along z at index kk (the cascade on
// kk with orientation β) from A times the line through w0; on a flat z the
// interpolation is the identity, A times the value at w0. kAny (here and
// below): each axis's own family and buffer at run time (a FluxFormAdvection
// whose axes are not all the instantiation's), else the instantiation's
// family F and buffer K, a bounded z's cascade capped at z's buffer.
template <int ZM, bool kAny, int K, int F, typename T, typename S>
__device__ __forceinline__ T interp_z(const Stencil<K, F, T, S>& P, int kk, int beta, T A,
                                      const T* w0) {
  if constexpr (ZM == kZFlat) {
    return A * w0[0];
  } else {
    const Line<T> l(w0, 1, beta);
    const auto a = [&](int o) { return A * l(o); };
    if constexpr (kAny)
      return symmetric_any(z_level<ZM, true>(P, kk, beta), P.af[2], P.tab, 0, a);
    else
      return symmetric_level<K>(z_level<ZM>(P, kk, beta), P.fam, P.tab, 0, a);
  }
}

// The advecting velocity interpolated along x (comp 0's β = 1) or y from A
// times the line through v0, for momentum component comp along the flux's
// axis `along` (0 x, 1 y).
template <bool kAny, int K, int F, typename T, typename S, typename Q>
__device__ __forceinline__ T interp_xy(const Stencil<K, F, T, S>& P, const Q& r, int along,
                                       int beta, T A, const T* v0) {
  const Line<T> l(v0, along == 0 ? r.sx : r.sy, beta);
  const auto a = [&](int o) { return A * l(o); };
  if constexpr (kAny)
    return symmetric_any(axis_buf(P, along), axis_fam(P, along), P.tab, 0, a);
  else
    return symmetric<K>(P.fam, P.tab, 0, a);
}

// The advected value along x (0) or y (1).
template <bool kAny, int K, int F, typename T, typename S>
__device__ __forceinline__ T recon_xy(const Stencil<K, F, T, S>& P, int ax, bool pos,
                                      const Line<T>& q) {
  if constexpr (kAny)
    return biased_any(axis_buf(P, ax), axis_fam(P, ax), P.tab, 0, pos, q);
  else
    return biased<K>(P.fam, P.tab, 0, pos, q);
}

// The advected value along z at level L (z_level's).
template <bool kAny, int K, int F, typename T, typename S>
__device__ __forceinline__ T recon_z(const Stencil<K, F, T, S>& P, int L, bool pos,
                                     const Line<T>& q) {
  if constexpr (kAny)
    return biased_any(L, P.af[2], P.tab, 0, pos, q);
  else
    return biased_level<K>(L, P.fam, P.tab, 0, pos, q);
}

template <bool kAny = false, int K, int F, typename T, typename S, typename Q>
__device__ __forceinline__ T face_flux_x(const Stencil<K, F, T, S>& P, const Q& r, int comp,
                                         const T* a, int i, int j, int k) {
  const int at = r.at(i, j, k);
  if (comp >= 3) {
    const T vel = r.vel[0][at];
    const Line<T> q(a + r.at_c(i, j, k), r.csx, 0);
    return (P.Ax * vel) * recon_xy<kAny>(P, 0, vel > T(0), q);
  }
  const T* u0 = r.vel[0] + at;
  const T adv = comp == 2 ? interp_z<Q::kZMode, kAny>(P, k, 0, P.Ax, u0)
                          : interp_xy<kAny>(P, r, comp, comp == 0 ? 1 : 0, P.Ax, u0);
  const Line<T> q(r.box(comp) + at, r.sx, comp == 0 ? 1 : 0);
  return adv * recon_xy<kAny>(P, 0, adv > T(0), q);
}

template <bool kAny = false, int K, int F, typename T, typename S, typename Q>
__device__ __forceinline__ T face_flux_y(const Stencil<K, F, T, S>& P, const Q& r, int comp,
                                         const T* a, int i, int j, int k) {
  const int at = r.at(i, j, k);
  if (comp >= 3) {
    const T vel = r.vel[1][at];
    const Line<T> q(a + r.at_c(i, j, k), r.csy, 0);
    return (P.Ay * vel) * recon_xy<kAny>(P, 1, vel > T(0), q);
  }
  const T* v0 = r.vel[1] + at;
  const T adv = comp == 2 ? interp_z<Q::kZMode, kAny>(P, k, 0, P.Ay, v0)
                          : interp_xy<kAny>(P, r, comp, comp == 1 ? 1 : 0, P.Ay, v0);
  const Line<T> q(r.box(comp) + at, r.sy, comp == 1 ? 1 : 0);
  return adv * recon_xy<kAny>(P, 1, adv > T(0), q);
}

template <bool kAny = false, int K, int F, typename T, typename S, typename Q>
__device__ __forceinline__ T face_flux_z(const Stencil<K, F, T, S>& P, const Q& r, int comp,
                                         const T* a, int i, int j, int k) {
  constexpr int ZM = Q::kZMode;
  if constexpr (ZM == kZFlat) return T(0);
  if (Q::kWalls && (comp == 2 ? k < 0 : k == P.Nz)) return T(0);
  const int at = r.at(i, j, k);
  if (comp >= 3) {
    const T vel = r.vel[2][at];
    const Line<T> q(a + r.at_c(i, j, k), 1, 0);
    return (P.Az * vel) * recon_z<kAny>(P, z_level<ZM, kAny>(P, k, 0), vel > T(0), q);
  }
  const T* w0 = r.vel[2] + at;
  const T adv = comp == 2 ? interp_z<ZM, kAny>(P, k, 1, P.Az, w0)
                          : interp_xy<kAny>(P, r, comp, 0, P.Az, w0);
  const int beta = comp == 2 ? 1 : 0;
  const Line<T> q(r.box(comp) + at, 1, beta);
  return adv * recon_z<kAny>(P, z_level<ZM, kAny>(P, k, beta), adv > T(0), q);
}

// Components one launch takes (kernels/build.py BATCH): the
// per-component pointers ride in the kernel's parameter block, so a call
// with more components launches once per batch of at most kBatch.
constexpr int kBatch = 32;

}  // namespace oc
