// Conservative shallow-water tendency and RK3 stage update, 2D (z flat).
//
// Replaces oceananigans_tpu/kernels/fused_shallow_water.py
// build_fused_sw_update (the pallas_call at :169). For the prognostic fields
// uh, vh, h and each tracer c (padded (Nx+2Hx, Ny+2Hy, 1) arrays whose
// periodic halos were filled beforehand) it computes, at every interior
// cell, what oceananigans_tpu/models/shallow_water.py conservative_tendencies
// computes:
//
//   G_uh = -∇·(𝐮 uh) - ∂x(g h²/2) - g ℑx(h) ∂x hB + f ℑxᶠ ℑyᶜ vh     (f, c)
//   G_vh = -∇·(𝐮 vh) - ∂y(g h²/2) - g ℑy(h) ∂y hB - f ℑyᶠ ℑxᶜ uh     (c, f)
//   G_h  = -div_xy(uh, vh) V / Az                                       (c, c)
//   G_c  = -∇·(𝐔 c) + c ∇·𝐔                                            (c, c)
//
// and the stage update new = q + γΔt·G (+ ζΔt·G⁻ with the previous stage's
// G⁻). The momentum fluxes follow the flux-form stencils of the 3D advection
// kernels: advecting transports by the scheme's symmetric interpolation of
// uh or vh (Centered(4) for WENO(5)), advected velocities u = uh/ℑx(h) and
// v = vh/ℑy(h) by the upwind reconstruction selected by the transport's
// sign. The advected velocity is a derived field: every selected cell of u
// is formed from uh and two values of h before the reconstruction sees it,
// which is why the model's halo is the scheme's reach plus one. Tracers take
// the face transport itself as the advecting velocity. f is the constant
// Coriolis parameter (FPlane, or ConstantCartesianCoriolis's fz); 0 skips the
// term. Schemes: WENO(5) and Centered(2), a compile-time choice fed by the
// coefficient table of kernels/fused_advection.py coefficient_table.
//
// Bound: the compulsory traffic, 40-52 B per interior cell and stage in
// float32 for uh, vh and h, binds it; the function needs about 550
// floating-point operations per cell (each face flux and each derived
// velocity once), about half as long at the float32 rate. Design: the
// simplest correct form, as advection_tendency.cu: one thread per
// (component, interior cell), y fastest across threads (y is contiguous),
// the component uniform per block (blockIdx.y); each thread recomputes the
// two face fluxes it needs per axis and every velocity they select (about
// 1,100 operations per cell), and the stencil reads go through L1/L2.
// `new` goes to separate padded buffers (neighbours still read q); its halo
// slots are left for the next stage's wrap. Offsets are 64-bit. Divisions
// are exact. A launch takes at most kBatch fields (their pointers ride in
// the parameter block); kernels/fused_shallow_water.py launches once per
// batch, and every field's result depends only on its own values and uh, vh,
// h, so the batching does not change a bit of it.
#include "common.cuh"
#include "reconstruction.cuh"

namespace {

using oc::kCentered2;
using oc::kTabSize;
using oc::kWeno5;
using oc::make_tab;
using oc::Tab;

constexpr int kBatch = 32;   // fields per launch (kernels/build.py BATCH)

template <typename T, typename S>
struct Params {
  const T* prog[3];         // uh, vh, h: padded, halos filled
  const T* q[kBatch];       // the batch's fields (of uh, vh, h, tracers)
  T* out[kBatch];           // the batch's new fields: padded, interiors written
  int first;                // field index of q[0]
  const T* hB;              // bathymetry, padded, halos filled
  const T* Gm;              // (nf, Nx, Ny) previous-stage tendencies or null
  T* G;                     // (nf, Nx, Ny) out, all fields
  oc::Geom g;               // Nz = 1, Hz = 0
  T dx, dy, Ax, Ay, Az, V;  // spacings, face areas, cell volume (regular grid)
  T half_g, g_acc, f;       // g/2, g, Coriolis parameter (0: none)
  T gamma_dt, zeta_dt;
  Tab<T> tt;                // stencil coefficients in the field type
  Tab<S> ts;                // smoothness factors, weights, ε, saturation
};

template <typename T, typename S>
__device__ __forceinline__ T rd(const Params<T, S>& P, const T* a, int i, int j) {
  return a[P.g.at(i, j, 0)];
}

// u = uh / ℑx(h) at (f, c) and v = vh / ℑy(h) at (c, f).
template <typename T, typename S>
__device__ __forceinline__ T vel_u(const Params<T, S>& P, int i, int j) {
  const T* h = P.prog[2];
  return rd(P, P.prog[0], i, j) / (T(0.5) * (rd(P, h, i, j) + rd(P, h, i - 1, j)));
}

template <typename T, typename S>
__device__ __forceinline__ T vel_v(const Params<T, S>& P, int i, int j) {
  const T* h = P.prog[2];
  return rd(P, P.prog[1], i, j) / (T(0.5) * (rd(P, h, i, j) + rd(P, h, i, j - 1)));
}

// g h²/2 at (c, c).
template <typename T, typename S>
__device__ __forceinline__ T head(const Params<T, S>& P, int i, int j) {
  const T h = rd(P, P.prog[2], i, j);
  return (P.half_g * h) * h;
}

// G_uh at padded (i, j).
template <int SCH, typename T, typename S>
__device__ T tendency_uh(const Params<T, S>& P, int i, int j) {
  const T *uh = P.prog[0], *vh = P.prog[1], *h = P.prog[2];
  T F[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // x: centers i-1, i
    const int c = i - 1 + m;
    const T ut = oc::symmetric<SCH>(P.tt, 1, [&](int o) { return rd(P, uh, c + o, j); });
    F[m] = (P.dy * ut)
         * oc::upwind<SCH>(P.tt, P.ts, 1, ut, [&](int o) { return vel_u(P, c + o, j); });
  }
  const T fx = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // y: (f, f) faces j, j+1
    const int jj = j + m;
    const T vt = oc::symmetric<SCH>(P.tt, 0, [&](int o) { return rd(P, vh, i + o, jj); });
    F[m] = (P.dx * vt)
         * oc::upwind<SCH>(P.tt, P.ts, 0, vt, [&](int o) { return vel_u(P, i, jj + o); });
  }
  const T fy = F[1] - F[0];
  const T div = (fx + fy) / P.Az;
  const T hx = T(0.5) * (rd(P, h, i, j) + rd(P, h, i - 1, j));
  const T dhB = (rd(P, P.hB, i, j) - rd(P, P.hB, i - 1, j)) / P.dx;
  T G = (-div - (head(P, i, j) - head(P, i - 1, j)) / P.dx) - (P.g_acc * hx) * dhB;
  if (P.f != T(0)) {
    const T vc0 = T(0.5) * (rd(P, vh, i, j + 1) + rd(P, vh, i, j));
    const T vc1 = T(0.5) * (rd(P, vh, i - 1, j + 1) + rd(P, vh, i - 1, j));
    G = G + P.f * (T(0.5) * (vc0 + vc1));
  }
  return G;
}

// G_vh at padded (i, j).
template <int SCH, typename T, typename S>
__device__ T tendency_vh(const Params<T, S>& P, int i, int j) {
  const T *uh = P.prog[0], *vh = P.prog[1], *h = P.prog[2];
  T F[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // x: (f, f) faces i, i+1
    const int ii = i + m;
    const T ut = oc::symmetric<SCH>(P.tt, 0, [&](int o) { return rd(P, uh, ii, j + o); });
    F[m] = (P.dy * ut)
         * oc::upwind<SCH>(P.tt, P.ts, 0, ut, [&](int o) { return vel_v(P, ii + o, j); });
  }
  const T fx = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // y: centers j-1, j
    const int c = j - 1 + m;
    const T vt = oc::symmetric<SCH>(P.tt, 1, [&](int o) { return rd(P, vh, i, c + o); });
    F[m] = (P.dx * vt)
         * oc::upwind<SCH>(P.tt, P.ts, 1, vt, [&](int o) { return vel_v(P, i, c + o); });
  }
  const T fy = F[1] - F[0];
  const T div = (fx + fy) / P.Az;
  const T hy = T(0.5) * (rd(P, h, i, j) + rd(P, h, i, j - 1));
  const T dhB = (rd(P, P.hB, i, j) - rd(P, P.hB, i, j - 1)) / P.dy;
  T G = (-div - (head(P, i, j) - head(P, i, j - 1)) / P.dy) - (P.g_acc * hy) * dhB;
  if (P.f != T(0)) {
    const T uc0 = T(0.5) * (rd(P, uh, i + 1, j) + rd(P, uh, i, j));
    const T uc1 = T(0.5) * (rd(P, uh, i + 1, j - 1) + rd(P, uh, i, j - 1));
    G = G - P.f * (T(0.5) * (uc0 + uc1));
  }
  return G;
}

// G_h at padded (i, j).
template <typename T, typename S>
__device__ T tendency_h(const Params<T, S>& P, int i, int j) {
  const T *uh = P.prog[0], *vh = P.prog[1];
  const T dU = P.Ax * rd(P, uh, i + 1, j) - P.Ax * rd(P, uh, i, j);
  const T dV = P.Ay * rd(P, vh, i, j + 1) - P.Ay * rd(P, vh, i, j);
  return ((-((dU + dV) / P.V)) * P.V) / P.Az;
}

// G_c at padded (i, j): advective form, -∇·(𝐔c) + c ∇·𝐔.
template <int SCH, typename T, typename S>
__device__ T tendency_c(const Params<T, S>& P, const T* c, int i, int j) {
  const T *uh = P.prog[0], *vh = P.prog[1];
  const T dU = P.dy * rd(P, uh, i + 1, j) - P.dy * rd(P, uh, i, j);
  const T dV = P.dx * rd(P, vh, i, j + 1) - P.dx * rd(P, vh, i, j);
  const T divU = (dU + dV) / P.Az;
  T F[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // x: faces i, i+1
    const int ii = i + m;
    const T vel = rd(P, uh, ii, j);
    F[m] = (P.dy * vel)
         * oc::upwind<SCH>(P.tt, P.ts, 0, vel, [&](int o) { return rd(P, c, ii + o, j); });
  }
  const T fx = F[1] - F[0];
#pragma unroll
  for (int m = 0; m < 2; ++m) {          // y: faces j, j+1
    const int jj = j + m;
    const T vel = rd(P, vh, i, jj);
    F[m] = (P.dx * vel)
         * oc::upwind<SCH>(P.tt, P.ts, 0, vel, [&](int o) { return rd(P, c, i, jj + o); });
  }
  const T fy = F[1] - F[0];
  return -((fx + fy) / P.Az) + rd(P, c, i, j) * divU;
}

template <int SCH, typename T, typename S>
__global__ void __launch_bounds__(256)
sw_update_kernel(const __grid_constant__ Params<T, S> P) {
  const long long cells = P.g.interior_cells();
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= cells) return;
  const int I = (int)(n / P.g.Ny), J = (int)(n % P.g.Ny);
  const int i = I + P.g.Hx, j = J + P.g.Hy;
  const int b = blockIdx.y, comp = P.first + b;
  T G;
  if (comp == 0)
    G = tendency_uh<SCH>(P, i, j);
  else if (comp == 1)
    G = tendency_vh<SCH>(P, i, j);
  else if (comp == 2)
    G = tendency_h(P, i, j);
  else
    G = tendency_c<SCH>(P, P.q[b], i, j);
  const long long at = comp * cells + n;
  P.G[at] = G;
  T inc = P.gamma_dt * G;
  if (P.Gm != nullptr) inc = inc + P.zeta_dt * P.Gm[at];
  P.out[b][P.g.at(i, j, 0)] = rd(P, P.q[b], i, j) + inc;
}

struct Args {
  const void* const* prog;   // uh, vh, h
  const void* const* q;      // the batch's fields
  void* const* out;
  int nb, first;
  const void* hB;
  const void* Gm;
  void* G;
  oc::Geom g;
  double dx, dy, Ax, Ay, Az, V, g_acc, f, gamma_dt, zeta_dt;
  const double* coefs;
  cudaStream_t stream;
};

template <int SCH, typename T, typename S>
int launch(const Args& a) {
  Params<T, S> P;
  for (int d = 0; d < 3; ++d) P.prog[d] = (const T*)a.prog[d];
  for (int c = 0; c < kBatch; ++c) {
    P.q[c] = c < a.nb ? (const T*)a.q[c] : nullptr;
    P.out[c] = c < a.nb ? (T*)a.out[c] : nullptr;
  }
  P.first = a.first;
  P.hB = (const T*)a.hB;
  P.Gm = (const T*)a.Gm;
  P.G = (T*)a.G;
  P.g = a.g;
  P.dx = (T)a.dx;
  P.dy = (T)a.dy;
  P.Ax = (T)a.Ax;
  P.Ay = (T)a.Ay;
  P.Az = (T)a.Az;
  P.V = (T)a.V;
  P.half_g = (T)(0.5 * a.g_acc);
  P.g_acc = (T)a.g_acc;
  P.f = (T)a.f;
  P.gamma_dt = (T)a.gamma_dt;
  P.zeta_dt = (T)a.zeta_dt;
  P.tt = make_tab<T>(a.coefs);
  P.ts = make_tab<S>(a.coefs);
  const int threads = 256;
  dim3 grid(oc::blocks_for(a.g.interior_cells(), threads), a.nb);
  sw_update_kernel<SCH, T, S><<<grid, threads, 0, a.stream>>>(P);
  return (int)cudaGetLastError();
}

template <int SCH>
int dispatch(int dtype, int sdtype, const Args& a) {
  if constexpr (SCH == kCentered2) {   // no smoothness arithmetic
    if (dtype == OC_FLOAT32) return launch<SCH, float, float>(a);
    if (dtype == OC_FLOAT64) return launch<SCH, double, double>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32) return launch<SCH, float, float>(a);
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64) return launch<SCH, float, double>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32) return launch<SCH, double, float>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64) return launch<SCH, double, double>(a);
  if (dtype == OC_FLOAT32 && sdtype == OC_BFLOAT16) return launch<SCH, float, oc::bf16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// scheme: 0 WENO(5), 1 Centered(2). dtype: OC_FLOAT32 or OC_FLOAT64 for the
// fields; sdtype: OC_FLOAT32, OC_FLOAT64 or (with float32 fields) OC_BFLOAT16
// for the WENO smoothness arithmetic. prog: host array of
// the uh, vh, h device pointers; q, out: host arrays of the batch's nb device
// pointers (fields first .. first+nb-1 of uh, vh, h, tracers; padded inputs
// and outputs); hB: padded bathymetry; Gm: device (nf, Nx, Ny) of all fields
// or null for the first stage; G: device (nf, Nx, Ny) output of all fields;
// coefs: the host table of Tab (kTabSize float64 values); f: the constant
// Coriolis parameter, 0 for none.
int oc_fused_sw_update(int scheme, int dtype, int sdtype, const void* const* prog,
                       const void* const* q, void* const* out, int nb, int first,
                       const void* hB, const void* Gm,
                       void* G, int Nx, int Ny, int Hx, int Hy, double dx, double dy,
                       double Ax, double Ay, double Az, double V, double g_acc,
                       double f, double gamma_dt, double zeta_dt, const double* coefs,
                       int ncoefs, void* stream) {
  if (ncoefs != kTabSize || nb < 1 || nb > kBatch || first < 0)
    return (int)cudaErrorInvalidValue;
  Args a{prog, q, out, nb, first, hB, Gm, G, oc::Geom{Nx, Ny, 1, Hx, Hy, 0}, dx, dy, Ax, Ay, Az, V,
         g_acc, f, gamma_dt, zeta_dt, coefs, (cudaStream_t)stream};
  if (scheme == kWeno5) return dispatch<kWeno5>(dtype, sdtype, a);
  if (scheme == kCentered2) return dispatch<kCentered2>(dtype, sdtype, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
