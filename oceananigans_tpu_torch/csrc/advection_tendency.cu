// Tendency-only flux-form advection for momentum and tracers.
//
// Replaces oceananigans_tpu/kernels/fused_advection.py build_fused_advection
// (the pallas_call at :232), the tendency megakernel the model runs when
// other tendencies (buoyancy, closure, boundary fluxes) are added to G before
// the stage update:
//
//   G_u, G_v, G_w = -∇·(𝐯u), -∇·(𝐯v), -∇·(𝐯w),   G_c = -∇·(𝐯c) per tracer
//
// at every interior cell, written to one (3 + n_tracers, Nx, Ny, Nz) array.
// Two layouts, selected by Hz as the TPU kernel selects them (:166):
// - padded (Hz >= 1): (Nx+2Hx, Ny+2Hy, Nz+2Hz) fields whose halos were
//   filled beforehand (periodic x/y wrap, bounded-z boundary conditions);
//   every stencil read takes the halo values as they are;
// - z-compact (Hz = 0): (Nx+2Hx, Ny+2Hy, Nz) fields with filled x/y halos;
//   z reads go through the boundary mirrors (even for u, v and tracers, odd
//   about the faces for w) and the boundary-face fluxes are zero.
// The stencil bodies, read policies and the near-wall order cascade are those
// of advection_stencils.cuh; schemes WENO(5) and Centered(2).
//
// Bound: arithmetic for WENO(5). Each component-cell evaluates six WENO-5
// reconstructions (two face fluxes per direction) of about 100 floating-point
// operations each plus the interpolations, about 750 in all, against 8 B of
// compulsory traffic per component-cell in float32 (read the padded input,
// write G). Design: the simplest correct form: one thread per (component,
// cell), z fastest across threads, the component uniform per block
// (blockIdx.y) so warps never diverge on it; each thread recomputes the two
// face fluxes it needs per axis, and stencil reads go through L1/L2.
// Divisions are exact. A launch takes at most kBatch components (their
// pointers ride in the parameter block); the wrapper launches once per batch,
// and every component's result depends only on its own field and u, v, w, so
// the batching does not change a bit of it.
#include "advection_stencils.cuh"

namespace {

using oc::kBatch;
using oc::kCentered2;
using oc::kTabSize;
using oc::kWeno5;

template <typename T, typename S, typename R>
struct Params {
  oc::Stencil<T, S, R> st;
  const T* q[kBatch];   // the batch's advected fields (tracers; u, v, w read through st)
  T* G;                 // (nb, Nx, Ny, Nz) out: the batch's slice of G
  int first;            // component index of the batch's first field
};

template <int SCH, typename T, typename S, typename R>
__global__ void __launch_bounds__(256)
advection_tendency_kernel(const __grid_constant__ Params<T, S, R> P) {
  const oc::Geom& g = P.st.rd.g;
  const long long cells = g.interior_cells();
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= cells) return;
  int I, J, k;
  g.split(n, I, J, k);
  const int b = blockIdx.y;
  P.G[b * cells + n] = oc::tendency<SCH>(P.st, P.first + b, P.q[b], I + g.Hx, J + g.Hy, k);
}

struct Args {
  const void* const* vel;   // u, v, w
  const void* const* q;     // the batch's fields
  int nb, first;
  void* G;
  oc::Geom g;
  double Ax, Ay, Az, V;
  const double* coefs;
  cudaStream_t stream;
};

template <int SCH, typename T, typename S, typename R>
int run(const Args& a, R rd) {
  Params<T, S, R> P;
  for (int d = 0; d < 3; ++d) rd.vel[d] = (const T*)a.vel[d];
  rd.g = a.g;
  P.st.rd = rd;
  P.st.Ax = (T)a.Ax;
  P.st.Ay = (T)a.Ay;
  P.st.Az = (T)a.Az;
  P.st.V = (T)a.V;
  P.st.tt = oc::make_tab<T>(a.coefs);
  P.st.ts = oc::make_tab<S>(a.coefs);
  for (int c = 0; c < kBatch; ++c) P.q[c] = c < a.nb ? (const T*)a.q[c] : nullptr;
  P.G = (T*)a.G;
  P.first = a.first;
  const int threads = 256;
  dim3 grid(oc::blocks_for(a.g.interior_cells(), threads), a.nb);
  advection_tendency_kernel<SCH, T, S, R><<<grid, threads, 0, a.stream>>>(P);
  return (int)cudaGetLastError();
}

template <int SCH, typename T, typename S>
int launch(const Args& a) {
  if (a.g.Hz == 0) {
    oc::CompactRead<T, false> rd{};   // no deferred correction
    return run<SCH, T, S>(a, rd);
  }
  return run<SCH, T, S>(a, oc::PaddedRead<T>{});
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
// for the WENO smoothness arithmetic. vel: host array of
// the u, v, w device pointers; q: host array of the batch's nb device
// pointers, components first .. first+nb-1 of (u, v, w, tracers...); G:
// device (nb, Nx, Ny, Nz) output; Hz = 0 selects the z-compact layout;
// coefs: the host table of Tab (kTabSize float64 values).
int oc_advection_tendency(int scheme, int dtype, int sdtype, const void* const* vel,
                          const void* const* q, int nb, int first, void* G, int Nx,
                          int Ny, int Nz, int Hx, int Hy, int Hz, double Ax, double Ay,
                          double Az, double V, const double* coefs, int ncoefs,
                          void* stream) {
  if (ncoefs != kTabSize || nb < 1 || nb > kBatch || first < 0 || Hz < 0)
    return (int)cudaErrorInvalidValue;
  Args a{vel, q, nb, first, G, oc::Geom{Nx, Ny, Nz, Hx, Hy, Hz}, Ax, Ay, Az, V, coefs,
         (cudaStream_t)stream};
  if (scheme == kWeno5) return dispatch<kWeno5>(dtype, sdtype, a);
  if (scheme == kCentered2) return dispatch<kCentered2>(dtype, sdtype, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
