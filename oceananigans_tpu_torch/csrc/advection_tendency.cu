// Tendency-only flux-form advection for momentum and tracers, padded layout.
//
// Replaces oceananigans_tpu/kernels/fused_advection.py build_fused_advection
// (the pallas_call at :232), the tendency megakernel the model runs when
// other tendencies (buoyancy, closure, boundary fluxes) are added to G before
// the stage update:
//
//   G_u, G_v, G_w = -∇·(𝐯u), -∇·(𝐯v), -∇·(𝐯w),   G_c = -∇·(𝐯c) per tracer
//
// at every interior cell, written to one (3 + n_tracers, Nx, Ny, Nz) array.
// The inputs are padded (Nx+2Hx, Ny+2Hy, Nz+2Hz) fields whose halos were
// filled beforehand (periodic x/y wrap, bounded-z boundary conditions):
// every stencil read takes the halo values as they are, with no boundary
// mirrors and no special boundary faces. The stencils are those of
// oceananigans_tpu/advection/fluxes.py div_Uu / div_Uv / div_Uw / div_Uc:
// advecting velocities by the scheme's symmetric interpolation of A·q (the
// face velocity itself for tracers), advected values by the upwind-selected
// reconstruction. Along the bounded z the order cascades near the walls on
// the global z index, as the TPU kernel's tile grid keeps z global
// (WENO5 → WENO3 → UpwindBiased(1) for the advected value, Centered(4) →
// Centered(2) for the advecting velocity). Schemes: WENO(5) and Centered(2),
// selected at compile time; every coefficient comes from the table of
// kernels/fused_advection.py coefficient_table.
//
// Bound: arithmetic for WENO(5). Each component-cell evaluates six WENO-5
// reconstructions (two face fluxes per direction) of about 100 floating-point
// operations each plus the interpolations, about 750 in all, against 8 B of
// compulsory traffic per component-cell in float32 (read the padded input,
// write G). Design: the simplest correct form, as fused_advection.cu: one
// thread per (component, cell), z fastest across threads, the component
// uniform per block (blockIdx.y) so warps never diverge on it; each thread
// recomputes the two face fluxes it needs per axis, and stencil reads go
// through L1/L2. Divisions are exact.
#include "common.cuh"
#include "reconstruction.cuh"

namespace {

using oc::kTabSize;
using oc::make_tab;
using oc::Tab;

constexpr int kMaxComponents = 3 + 8;   // u, v, w and up to 8 tracers
using oc::kCentered2;
using oc::kWeno5;

template <typename T, typename S>
struct Params {
  const T* q[kMaxComponents];  // u, v, w, tracers: padded, halos filled
  T* G;                        // (n_components, Nx, Ny, Nz) out
  oc::Geom g;                  // with the z halo Hz >= 1
  T Ax, Ay, Az, V;             // face areas and cell volume (regular grid)
  Tab<T> tt;                   // stencil coefficients in the field type
  Tab<S> ts;                   // smoothness factors, weights, ε, saturation
};

// Component f at padded (i, j) and absolute z index kz (-Hz <= kz < Nz+Hz).
template <typename T, typename S>
__device__ __forceinline__ T rd(const Params<T, S>& P, const T* f, int i, int j, int kz) {
  return f[P.g.at(i, j, kz + P.g.Hz)];
}

// ---- schemes ----------------------------------------------------------------

// Symmetric interpolation along a periodic axis; `a(o)` reads A·q at offset o.
template <int SCH, typename T, typename S, typename Read>
__device__ __forceinline__ T interp(const Params<T, S>& P, int beta, Read a) {
  return oc::symmetric<SCH>(P.tt, beta, a);
}

// Symmetric interpolation along the bounded z at index kk; `a(kz)` reads A·q
// at absolute z index kz. WENO(5) cascades Centered(4) → Centered(2) outside
// [3-β, N-3].
template <int SCH, typename T, typename S, typename Read>
__device__ __forceinline__ T interp_z(const Params<T, S>& P, int kk, int beta, Read a) {
  if constexpr (SCH == kWeno5) {
    if (kk >= 3 - beta && kk <= P.g.Nz - 3)
      return P.tt.c4[0] * a(kk + beta - 2) + P.tt.c4[1] * a(kk + beta - 1)
           + P.tt.c4[2] * a(kk + beta) + P.tt.c4[3] * a(kk + beta + 1);
  }
  return P.tt.c2[0] * a(kk + beta - 1) + P.tt.c2[1] * a(kk + beta);
}

// Upwind reconstruction along a periodic axis; `q(o)` reads the advected
// field at offset o from the reconstruction point.
template <int SCH, typename T, typename S, typename Read>
__device__ __forceinline__ T recon(const Params<T, S>& P, int beta, T vel, Read q) {
  return oc::upwind<SCH>(P.tt, P.ts, beta, vel, q);
}

// Upwind reconstruction along the bounded z at index kk; `q(kz)` reads at
// absolute z index kz. WENO(5): WENO-5 on [3-β, N-3], WENO-3 on [2-β, N-2],
// UpwindBiased(1) elsewhere.
template <int SCH, typename T, typename S, typename Read>
__device__ __forceinline__ T recon_z(const Params<T, S>& P, int kk, int beta, T vel, Read q) {
  const bool pos = vel > T(0);
  if constexpr (SCH == kCentered2) {
    return oc::centered2(P.tt, pos, q(kk + beta - 1), q(kk + beta));
  } else {
    const int N = P.g.Nz;
    T c[5];
    if (kk >= 3 - beta && kk <= N - 3) {
#pragma unroll
      for (int n = 0; n < 5; ++n) c[n] = pos ? q(kk + beta - 3 + n) : q(kk + beta + 2 - n);
      return oc::weno5(c, P.tt, P.ts);
    }
    if (kk >= 2 - beta && kk <= N - 2) {
#pragma unroll
      for (int n = 1; n < 4; ++n) c[n] = pos ? q(kk + beta - 3 + n) : q(kk + beta + 2 - n);
      return oc::weno3(c + 1, P.tt, P.ts);
    }
    return pos ? q(kk + beta - 1) : q(kk + beta);
  }
}

// ---- tendencies -------------------------------------------------------------

// G_u at padded (i, j), z index k: -∇·(𝐯u) at (f, c, c).
template <int SCH, typename T, typename S>
__device__ T tendency_u(const Params<T, S>& P, int i, int j, int k) {
  const T *u = P.q[0], *v = P.q[1], *w = P.q[2];
  T F[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // x: centers i-1, i
    const int c = i - 1 + m;
    const T ut = interp<SCH>(P, 1, [&](int o) { return P.Ax * rd(P, u, c + o, j, k); });
    F[m] = ut * recon<SCH>(P, 1, ut, [&](int o) { return rd(P, u, c + o, j, k); });
  }
  const T tx = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // y: (f, f, c) faces j, j+1
    const int jj = j + m;
    const T vt = interp<SCH>(P, 0, [&](int o) { return P.Ay * rd(P, v, i + o, jj, k); });
    F[m] = vt * recon<SCH>(P, 0, vt, [&](int o) { return rd(P, u, i, jj + o, k); });
  }
  const T ty = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // z: (f, c, f) faces k, k+1
    const int kk = k + m;
    const T wt = interp<SCH>(P, 0, [&](int o) { return P.Az * rd(P, w, i + o, j, kk); });
    F[m] = wt * recon_z<SCH>(P, kk, 0, wt, [&](int kz) { return rd(P, u, i, j, kz); });
  }
  const T tz = F[1] - F[0];
  return -(((tx + ty) + tz) / P.V);
}

// G_v: -∇·(𝐯v) at (c, f, c).
template <int SCH, typename T, typename S>
__device__ T tendency_v(const Params<T, S>& P, int i, int j, int k) {
  const T *u = P.q[0], *v = P.q[1], *w = P.q[2];
  T F[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // x: (f, f, c) faces i, i+1
    const int ii = i + m;
    const T ut = interp<SCH>(P, 0, [&](int o) { return P.Ax * rd(P, u, ii, j + o, k); });
    F[m] = ut * recon<SCH>(P, 0, ut, [&](int o) { return rd(P, v, ii + o, j, k); });
  }
  const T tx = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // y: centers j-1, j
    const int c = j - 1 + m;
    const T vt = interp<SCH>(P, 1, [&](int o) { return P.Ay * rd(P, v, i, c + o, k); });
    F[m] = vt * recon<SCH>(P, 1, vt, [&](int o) { return rd(P, v, i, c + o, k); });
  }
  const T ty = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // z: (c, f, f) faces k, k+1
    const int kk = k + m;
    const T wt = interp<SCH>(P, 0, [&](int o) { return P.Az * rd(P, w, i, j + o, kk); });
    F[m] = wt * recon_z<SCH>(P, kk, 0, wt, [&](int kz) { return rd(P, v, i, j, kz); });
  }
  const T tz = F[1] - F[0];
  return -(((tx + ty) + tz) / P.V);
}

// G_w: -∇·(𝐯w) at (c, c, f).
template <int SCH, typename T, typename S>
__device__ T tendency_w(const Params<T, S>& P, int i, int j, int k) {
  const T *u = P.q[0], *v = P.q[1], *w = P.q[2];
  T F[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // x: (f, c, f) faces i, i+1; u in z
    const int ii = i + m;
    const T ut = interp_z<SCH>(P, k, 0, [&](int kz) { return P.Ax * rd(P, u, ii, j, kz); });
    F[m] = ut * recon<SCH>(P, 0, ut, [&](int o) { return rd(P, w, ii + o, j, k); });
  }
  const T tx = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // y: (c, f, f) faces j, j+1; v in z
    const int jj = j + m;
    const T vt = interp_z<SCH>(P, k, 0, [&](int kz) { return P.Ay * rd(P, v, i, jj, kz); });
    F[m] = vt * recon<SCH>(P, 0, vt, [&](int o) { return rd(P, w, i, jj + o, k); });
  }
  const T ty = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // z: centers k-1, k
    const int kk = k - 1 + m;
    const T wt = interp_z<SCH>(P, kk, 1, [&](int kz) { return P.Az * rd(P, w, i, j, kz); });
    F[m] = wt * recon_z<SCH>(P, kk, 1, wt, [&](int kz) { return rd(P, w, i, j, kz); });
  }
  const T tz = F[1] - F[0];
  return -(((tx + ty) + tz) / P.V);
}

// G_c: -∇·(𝐯c) at (c, c, c); the advecting velocity is the face velocity.
template <int SCH, typename T, typename S>
__device__ T tendency_c(const Params<T, S>& P, const T* c, int i, int j, int k) {
  const T *u = P.q[0], *v = P.q[1], *w = P.q[2];
  T F[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // x: faces i, i+1
    const int ii = i + m;
    const T vel = rd(P, u, ii, j, k);
    F[m] = (P.Ax * vel) * recon<SCH>(P, 0, vel, [&](int o) { return rd(P, c, ii + o, j, k); });
  }
  const T tx = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // y: faces j, j+1
    const int jj = j + m;
    const T vel = rd(P, v, i, jj, k);
    F[m] = (P.Ay * vel) * recon<SCH>(P, 0, vel, [&](int o) { return rd(P, c, i, jj + o, k); });
  }
  const T ty = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // z: faces k, k+1
    const int kk = k + m;
    const T vel = rd(P, w, i, j, kk);
    F[m] = (P.Az * vel) * recon_z<SCH>(P, kk, 0, vel, [&](int kz) { return rd(P, c, i, j, kz); });
  }
  const T tz = F[1] - F[0];
  return -(((tx + ty) + tz) / P.V);
}

template <int SCH, typename T, typename S>
__global__ void __launch_bounds__(256)
advection_tendency_kernel(const __grid_constant__ Params<T, S> P) {
  const long long cells = P.g.interior_cells();
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= cells) return;
  int I, J, k;
  P.g.split(n, I, J, k);
  const int i = I + P.g.Hx, j = J + P.g.Hy;
  const int comp = blockIdx.y;
  T G;
  if (comp == 0)
    G = tendency_u<SCH>(P, i, j, k);
  else if (comp == 1)
    G = tendency_v<SCH>(P, i, j, k);
  else if (comp == 2)
    G = tendency_w<SCH>(P, i, j, k);
  else
    G = tendency_c<SCH>(P, P.q[comp], i, j, k);
  P.G[comp * cells + n] = G;
}

template <int SCH, typename T, typename S>
int launch(const void* const* q, int nc, void* G, oc::Geom g, double Ax, double Ay,
           double Az, double V, const double* coefs, cudaStream_t stream) {
  Params<T, S> P;
  for (int c = 0; c < kMaxComponents; ++c) P.q[c] = c < nc ? (const T*)q[c] : nullptr;
  P.G = (T*)G;
  P.g = g;
  P.Ax = (T)Ax;
  P.Ay = (T)Ay;
  P.Az = (T)Az;
  P.V = (T)V;
  P.tt = make_tab<T>(coefs);
  P.ts = make_tab<S>(coefs);
  const int threads = 256;
  dim3 grid(oc::blocks_for(g.interior_cells(), threads), nc);
  advection_tendency_kernel<SCH, T, S><<<grid, threads, 0, stream>>>(P);
  return (int)cudaGetLastError();
}

template <int SCH>
int dispatch(int dtype, int sdtype, const void* const* q, int nc, void* G, oc::Geom g,
             double Ax, double Ay, double Az, double V, const double* coefs,
             cudaStream_t s) {
  if constexpr (SCH == kCentered2) {   // no smoothness arithmetic
    if (dtype == OC_FLOAT32) return launch<SCH, float, float>(q, nc, G, g, Ax, Ay, Az, V, coefs, s);
    if (dtype == OC_FLOAT64) return launch<SCH, double, double>(q, nc, G, g, Ax, Ay, Az, V, coefs, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32)
    return launch<SCH, float, float>(q, nc, G, g, Ax, Ay, Az, V, coefs, s);
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64)
    return launch<SCH, float, double>(q, nc, G, g, Ax, Ay, Az, V, coefs, s);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32)
    return launch<SCH, double, float>(q, nc, G, g, Ax, Ay, Az, V, coefs, s);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64)
    return launch<SCH, double, double>(q, nc, G, g, Ax, Ay, Az, V, coefs, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// scheme: 0 WENO(5), 1 Centered(2). dtype / sdtype: OC_FLOAT32 or OC_FLOAT64
// for the fields and for the WENO smoothness arithmetic. q: host array of nc
// device pointers (u, v, w, tracers); G: device (nc, Nx, Ny, Nz) output;
// coefs: the host table of Tab (kTabSize float64 values).
int oc_advection_tendency(int scheme, int dtype, int sdtype, const void* const* q,
                          int nc, void* G, int Nx, int Ny, int Nz, int Hx, int Hy,
                          int Hz, double Ax, double Ay, double Az, double V,
                          const double* coefs, int ncoefs, void* stream) {
  if (ncoefs != kTabSize || nc < 3 || nc > kMaxComponents || Hz < 1)
    return (int)cudaErrorInvalidValue;
  oc::Geom g{Nx, Ny, Nz, Hx, Hy, Hz};
  cudaStream_t s = (cudaStream_t)stream;
  if (scheme == kWeno5) return dispatch<kWeno5>(dtype, sdtype, q, nc, G, g, Ax, Ay, Az, V, coefs, s);
  if (scheme == kCentered2)
    return dispatch<kCentered2>(dtype, sdtype, q, nc, G, g, Ax, Ay, Az, V, coefs, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
