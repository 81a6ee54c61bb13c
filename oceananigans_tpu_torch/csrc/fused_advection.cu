// WENO-5 flux-form momentum advection fused with the RK3 stage update.
//
// Replaces oceananigans_tpu/kernels/fused_advection.py _build_update_group
// (via build_fused_advection_update), for u, v, w without tracers, in the
// z-compact layout:
//
//   G   = -∇·(𝐯 q)                          for q = u, v, w
//   new = q + γΔt·G + ζΔt·G⁻                 (ζΔt·G⁻ only when G⁻ is given)
//
// With a pressure p (the deferred correction of the previous RK3 stage),
// every stencil read of u, v, w is corrected on the fly, q = q* − Δt_prev·∂p
// (w's bottom face pinned to 0), and G is the tendency of the corrected
// fields, while `new` adds the increment to the UNCORRECTED q*, exactly as
// the TPU kernel does (the carried correction ends up in the next solve's
// pressure, and the last stage's projection removes it).
//
// The stencils are those of oceananigans_tpu/advection/fluxes.py div_Uu /
// div_Uv / div_Uw: advecting velocities by Centered(4) interpolation of A·q,
// advected values by the upwind-selected WENO-5 (WENO-Z weights, smoothness
// indicators in the smoothness type S, r = τ/(β+ε) saturated at 1e12). Along
// the bounded z axis the boundary conditions are read through the halo-free
// mirrors (even for u and v, odd about the faces for w), the order cascades
// near the walls on the global z index (WENO5 → WENO3 → UpwindBiased(1),
// Centered(4) → Centered(2)), and the boundary-face fluxes are zero. All
// coefficients come from the Python scheme objects through a table passed by
// value.
//
// Bound: arithmetic. Each output cell evaluates six WENO-5 reconstructions
// (two fluxes per direction) with four divisions each, about 600 floating
// point operations per component, against 16 B of compulsory traffic per
// component in float32 (read q, write G and new, read G⁻). Design: the
// simplest correct form. One thread per (component, cell), z fastest across
// threads for contiguous reads, the component uniform per block (blockIdx.y)
// so warps never diverge on it; every thread recomputes the two face fluxes
// it needs per axis instead of sharing them through shared memory, and
// stencil reads go through L1/L2. Divisions are exact `/`. `new` is stored
// with its periodic x/y halo images, replacing the TPU kernel's strip DMAs.
#include "common.cuh"
#include "reconstruction.cuh"

namespace {

using oc::kTabSize;
using oc::make_tab;
using oc::Tab;
using oc::weno3;
using oc::weno5;

template <typename T, typename S>
struct Params {
  const T* q[3];      // u*, v*, w* (padded)
  const T* p;         // padded pressure, or null
  const T* gm[3];     // previous-stage tendencies (interior), or null
  T* G[3];            // tendencies out (interior)
  T* out[3];          // new fields out (padded, periodic halos written)
  oc::Geom g;
  T gdt, zdt;         // γΔt, ζΔt
  T cx, cy, cz;       // Δt_prev/Δx, Δt_prev/Δy, Δt_prev/Δz
  T Ax, Ay, Az, V;    // face areas and cell volume (regular grid)
  int has_gm, has_corr;
  Tab<T> tt;          // stencil coefficients in the field type
  Tab<S> ts;          // smoothness factors, weights, ε, saturation
};

// ---- reads ----------------------------------------------------------------

// u or v at padded (i, j) and z index 0 <= k < Nz, corrected when a pressure
// is given; d = 0 for u (x-difference of p), 1 for v (y-difference).
template <typename T, typename S>
__device__ __forceinline__ T read_uv(const Params<T, S>& P, int d, int i, int j, int k) {
  const long long c = P.g.at(i, j, k);
  T val = P.q[d][c];
  if (P.has_corr) {
    const T pc = P.p[c];
    if (d == 0)
      val = val - P.cx * (pc - P.p[P.g.at(i - 1, j, k)]);
    else
      val = val - P.cy * (pc - P.p[P.g.at(i, j - 1, k)]);
  }
  return val;
}

template <typename T, typename S>
__device__ __forceinline__ T read_w(const Params<T, S>& P, int i, int j, int k) {
  const long long c = P.g.at(i, j, k);
  if (!P.has_corr) return P.q[2][c];
  if (k == 0) return T(0);
  return P.q[2][c] - P.cz * (P.p[c] - P.p[c - 1]);
}

// Halo-free z reads: any z index, mapped through the boundary mirror.
// Even (u, v): a[-1-m] = a[m], a[N+m] = a[N-1-m].
template <typename T, typename S>
__device__ __forceinline__ T read_uv_z(const Params<T, S>& P, int d, int i, int j, int kz) {
  const int N = P.g.Nz;
  if (kz < 0) kz = -kz - 1;
  else if (kz >= N) kz = 2 * N - 1 - kz;
  return read_uv(P, d, i, j, kz);
}

// Odd about the faces (w): a[-m] = -a[m], a[N] = 0, a[N+m] = -a[N-m].
template <typename T, typename S>
__device__ __forceinline__ T read_w_z(const Params<T, S>& P, int i, int j, int kz) {
  const int N = P.g.Nz;
  if (kz < 0) return -kz < N ? -read_w(P, i, j, -kz) : T(0);
  if (kz >= N) return kz == N ? T(0) : -read_w(P, i, j, 2 * N - kz);
  return read_w(P, i, j, kz);
}

// ---- reconstructions --------------------------------------------------------

// Upwind WENO-5 along a periodic axis. `rd(o)` reads the advected field at
// offset o from the reconstruction point along the axis.
template <typename T, typename S, typename Read>
__device__ __forceinline__ T upwind5(const Params<T, S>& P, int beta, T vel, Read rd) {
  T q[5];
  const bool pos = vel > T(0);
#pragma unroll
  for (int n = 0; n < 5; ++n) q[n] = pos ? rd(beta - 3 + n) : rd(beta + 2 - n);
  return weno5(q, P.tt, P.ts);
}

// Upwind reconstruction along bounded z at reconstruction index kk, with the
// near-wall order cascade: WENO-5 on [3-β, N-3], WENO-3 on [2-β, N-2],
// UpwindBiased(1) elsewhere. `rd(kz)` reads at absolute z index kz (mirrored).
template <typename T, typename S, typename Read>
__device__ __forceinline__ T upwind_z(const Params<T, S>& P, int kk, int beta, T vel,
                                      Read rd) {
  const int N = P.g.Nz;
  const bool pos = vel > T(0);
  T q[5];
  if (kk >= 3 - beta && kk <= N - 3) {
#pragma unroll
    for (int n = 0; n < 5; ++n) q[n] = pos ? rd(kk + beta - 3 + n) : rd(kk + beta + 2 - n);
    return weno5(q, P.tt, P.ts);
  }
  if (kk >= 2 - beta && kk <= N - 2) {
#pragma unroll
    for (int n = 1; n < 4; ++n) q[n] = pos ? rd(kk + beta - 3 + n) : rd(kk + beta + 2 - n);
    return weno3(q + 1, P.tt, P.ts);
  }
  return pos ? rd(kk + beta - 1) : rd(kk + beta);
}

// Centered(4) along a periodic axis; `rd(o)` reads A·q at offset o.
template <typename T, typename S, typename Read>
__device__ __forceinline__ T sym4(const Params<T, S>& P, int beta, Read rd) {
  return P.tt.c4[0] * rd(beta - 2) + P.tt.c4[1] * rd(beta - 1)
       + P.tt.c4[2] * rd(beta) + P.tt.c4[3] * rd(beta + 1);
}

// Centered interpolation along bounded z at index kk with the cascade:
// Centered(4) on [3-β, N-3], Centered(2) elsewhere. `rd(kz)` reads A·q at
// absolute z index kz (mirrored).
template <typename T, typename S, typename Read>
__device__ __forceinline__ T sym_z(const Params<T, S>& P, int kk, int beta, Read rd) {
  if (kk >= 3 - beta && kk <= P.g.Nz - 3)
    return P.tt.c4[0] * rd(kk + beta - 2) + P.tt.c4[1] * rd(kk + beta - 1)
         + P.tt.c4[2] * rd(kk + beta) + P.tt.c4[3] * rd(kk + beta + 1);
  return P.tt.c2[0] * rd(kk + beta - 1) + P.tt.c2[1] * rd(kk + beta);
}

// ---- tendencies -------------------------------------------------------------

// G_u at padded (i, j), z index k: -∇·(𝐯u) at (f, c, c).
template <typename T, typename S>
__device__ T tendency_u(const Params<T, S>& P, int i, int j, int k) {
  const int N = P.g.Nz;
  T F[2];
  // x: fluxes at the centers i-1, i
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int c = i - 1 + m;
    T ut = sym4(P, 1, [&](int o) { return P.Ax * read_uv(P, 0, c + o, j, k); });
    F[m] = ut * upwind5(P, 1, ut, [&](int o) { return read_uv(P, 0, c + o, j, k); });
  }
  const T tx = F[1] - F[0];
  // y: fluxes at the (f, f, c) faces j, j+1
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int jj = j + m;
    T vt = sym4(P, 0, [&](int o) { return P.Ay * read_uv(P, 1, i + o, jj, k); });
    F[m] = vt * upwind5(P, 0, vt, [&](int o) { return read_uv(P, 0, i, jj + o, k); });
  }
  const T ty = F[1] - F[0];
  // z: fluxes at the (f, c, f) faces k, k+1; the top boundary face has none
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int kk = k + m;
    if (kk == N) { F[m] = T(0); continue; }
    T wt = sym4(P, 0, [&](int o) { return P.Az * read_w(P, i + o, j, kk); });
    F[m] = wt * upwind_z(P, kk, 0, wt, [&](int kz) { return read_uv_z(P, 0, i, j, kz); });
  }
  const T tz = F[1] - F[0];
  return -(((tx + ty) + tz) / P.V);
}

// G_v: -∇·(𝐯v) at (c, f, c).
template <typename T, typename S>
__device__ T tendency_v(const Params<T, S>& P, int i, int j, int k) {
  const int N = P.g.Nz;
  T F[2];
  // x: fluxes at the (f, f, c) faces i, i+1
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int ii = i + m;
    T ut = sym4(P, 0, [&](int o) { return P.Ax * read_uv(P, 0, ii, j + o, k); });
    F[m] = ut * upwind5(P, 0, ut, [&](int o) { return read_uv(P, 1, ii + o, j, k); });
  }
  const T tx = F[1] - F[0];
  // y: fluxes at the centers j-1, j
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int c = j - 1 + m;
    T vt = sym4(P, 1, [&](int o) { return P.Ay * read_uv(P, 1, i, c + o, k); });
    F[m] = vt * upwind5(P, 1, vt, [&](int o) { return read_uv(P, 1, i, c + o, k); });
  }
  const T ty = F[1] - F[0];
  // z: fluxes at the (c, f, f) faces k, k+1
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int kk = k + m;
    if (kk == N) { F[m] = T(0); continue; }
    T wt = sym4(P, 0, [&](int o) { return P.Az * read_w(P, i, j + o, kk); });
    F[m] = wt * upwind_z(P, kk, 0, wt, [&](int kz) { return read_uv_z(P, 1, i, j, kz); });
  }
  const T tz = F[1] - F[0];
  return -(((tx + ty) + tz) / P.V);
}

// G_w: -∇·(𝐯w) at (c, c, f).
template <typename T, typename S>
__device__ T tendency_w(const Params<T, S>& P, int i, int j, int k) {
  T F[2];
  // x: fluxes at the (f, c, f) faces i, i+1; u interpolated in z
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int ii = i + m;
    T ut = sym_z(P, k, 0, [&](int kz) { return P.Ax * read_uv_z(P, 0, ii, j, kz); });
    F[m] = ut * upwind5(P, 0, ut, [&](int o) { return read_w(P, ii + o, j, k); });
  }
  const T tx = F[1] - F[0];
  // y: fluxes at the (c, f, f) faces j, j+1; v interpolated in z
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int jj = j + m;
    T vt = sym_z(P, k, 0, [&](int kz) { return P.Ay * read_uv_z(P, 1, i, jj, kz); });
    F[m] = vt * upwind5(P, 0, vt, [&](int o) { return read_w(P, i, jj + o, k); });
  }
  const T ty = F[1] - F[0];
  // z: fluxes at the centers k-1, k; none below the bottom face
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int kk = k - 1 + m;
    if (kk < 0) { F[m] = T(0); continue; }
    T wt = sym_z(P, kk, 1, [&](int kz) { return P.Az * read_w_z(P, i, j, kz); });
    F[m] = wt * upwind_z(P, kk, 1, wt, [&](int kz) { return read_w_z(P, i, j, kz); });
  }
  const T tz = F[1] - F[0];
  return -(((tx + ty) + tz) / P.V);
}

// Stage update and stores of component C (a compile-time index, so the
// parameter arrays are never indexed dynamically).
template <int C, typename T, typename S>
__device__ __forceinline__ void finish(const Params<T, S>& P, long long n, int I, int J,
                                       int k, T G) {
  T inc = P.gdt * G;
  if (P.has_gm) inc = inc + P.zdt * P.gm[C][n];
  P.G[C][n] = G;
  const T q = P.q[C][P.g.at(I + P.g.Hx, J + P.g.Hy, k)];
  oc::store_with_images(P.out[C], P.g, I, J, k, q + inc);
}

template <typename T, typename S>
__global__ void __launch_bounds__(256)
advection_update_kernel(const __grid_constant__ Params<T, S> P) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= P.g.interior_cells()) return;
  int I, J, k;
  P.g.split(n, I, J, k);
  const int i = I + P.g.Hx, j = J + P.g.Hy;
  if (blockIdx.y == 0)
    finish<0>(P, n, I, J, k, tendency_u(P, i, j, k));
  else if (blockIdx.y == 1)
    finish<1>(P, n, I, J, k, tendency_v(P, i, j, k));
  else
    finish<2>(P, n, I, J, k, tendency_w(P, i, j, k));
}

template <typename T, typename S>
int launch(const void* const* q, const void* p, const void* const* gm, void* const* G,
           void* const* out, oc::Geom g, double gdt, double zdt, double cdt,
           double Ax, double Ay, double Az, double V, double inv_dx, double inv_dy,
           double inv_dz, const double* coefs, int has_gm, int has_corr,
           cudaStream_t stream) {
  Params<T, S> P;
  for (int c = 0; c < 3; ++c) {
    P.q[c] = (const T*)q[c];
    P.gm[c] = (const T*)gm[c];
    P.G[c] = (T*)G[c];
    P.out[c] = (T*)out[c];
  }
  P.p = (const T*)p;
  P.g = g;
  P.gdt = (T)gdt;
  P.zdt = (T)zdt;
  const T c_dt = (T)cdt;
  P.cx = c_dt * (T)inv_dx;
  P.cy = c_dt * (T)inv_dy;
  P.cz = c_dt * (T)inv_dz;
  P.Ax = (T)Ax;
  P.Ay = (T)Ay;
  P.Az = (T)Az;
  P.V = (T)V;
  P.has_gm = has_gm;
  P.has_corr = has_corr;
  P.tt = make_tab<T>(coefs);
  P.ts = make_tab<S>(coefs);
  const int threads = 256;
  dim3 grid(oc::blocks_for(g.interior_cells(), threads), 3);
  advection_update_kernel<T, S><<<grid, threads, 0, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype / sdtype: OC_FLOAT32 or OC_FLOAT64 for the fields and for the WENO
// smoothness arithmetic. Scalars arrive as doubles holding field-dtype
// values; coefs is the host table of Tab (kTabSize float64 values).
int oc_fused_advection_update(int dtype, int sdtype, const void* u, const void* v,
                              const void* w, const void* p, const void* gm0,
                              const void* gm1, const void* gm2, void* G0, void* G1,
                              void* G2, void* o0, void* o1, void* o2, int Nx, int Ny,
                              int Nz, int Hx, int Hy, double gdt, double zdt,
                              double cdt, double Ax, double Ay, double Az, double V,
                              double inv_dx, double inv_dy, double inv_dz,
                              const double* coefs, int ncoefs, int has_gm,
                              int has_corr, void* stream) {
  if (ncoefs != kTabSize) return (int)cudaErrorInvalidValue;
  const void* q[3] = {u, v, w};
  const void* gm[3] = {gm0, gm1, gm2};
  void* G[3] = {G0, G1, G2};
  void* out[3] = {o0, o1, o2};
  oc::Geom g{Nx, Ny, Nz, Hx, Hy};
  cudaStream_t s = (cudaStream_t)stream;
#define OC_ARGS q, p, gm, G, out, g, gdt, zdt, cdt, Ax, Ay, Az, V, inv_dx, inv_dy, \
                inv_dz, coefs, has_gm, has_corr, s
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32) return launch<float, float>(OC_ARGS);
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64) return launch<float, double>(OC_ARGS);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32) return launch<double, float>(OC_ARGS);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64) return launch<double, double>(OC_ARGS);
#undef OC_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
