// Flux-form advection of momentum and tracers fused with the RK3 stage update,
// z-compact layout.
//
// Replaces oceananigans_tpu/kernels/fused_advection.py _build_update_group
// (via build_fused_advection_update; the pallas_call at :626), momentum and
// tracer groups alike:
//
//   G   = -∇·(𝐯 q)                          for q = u, v, w and each tracer
//   new = q + γΔt·G + ζΔt·G⁻                 (ζΔt·G⁻ only when G⁻ is given)
//
// With a pressure p (the deferred correction of the previous RK3 stage),
// every stencil read of u, v, w is corrected on the fly, q = q* − Δt_prev·∂p
// (w's bottom face pinned to 0), and G is the tendency of the corrected
// fields; the tracers are advected by the corrected velocities and are never
// corrected themselves. `new` adds the increment to the UNCORRECTED q*,
// exactly as the TPU kernel does (the carried correction ends up in the next
// solve's pressure, and the last stage's projection removes it).
//
// The stencils, the read policy of the z-compact layout (halo-free mirrors
// along z, zero boundary-face fluxes, the corrected reads) and the near-wall
// order cascade are those of advection_stencils.cuh, shared with the
// tendency-only kernel; schemes WENO(5) and Centered(2).
//
// Layout: one launch covers a batch of components of (u, v, w, tracers...)
// (at most kBatch, their pointers in the parameter block); the wrapper
// launches once per batch. The TPU kernel's groups (momentum, then tracers in
// batches of 4) are a VMEM workaround; the groups are independent, and here
// every component's result depends only on its own field and u, v, w, p, so
// the batching does not change a bit of it.
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
#include "advection_stencils.cuh"

namespace {

using oc::kBatch;
using oc::kCentered2;
using oc::kTabSize;
using oc::kWeno5;

// The read policy: bfloat16 smoothness rounds the correction as the plain
// version does (CompactRead's kRn).
template <typename T, typename S, bool C>
using Read = oc::CompactRead<T, C, std::is_same<S, oc::bf16>::value>;

template <typename T, typename S, bool C>
struct Params {
  oc::Stencil<T, S, Read<T, S, C>> st;   // u*, v*, w* (p, Δt_prev/Δ)
  const T* q[kBatch];    // the batch's fields q* (padded, uncorrected)
  const T* gm[kBatch];   // previous-stage tendencies (interior), or null
  T* G[kBatch];          // tendencies out (interior)
  T* out[kBatch];        // new fields out (padded, periodic halos written)
  int first;             // component index of q[0]: 0 u, 1 v, 2 w, 3+ tracers
  T gdt, zdt;            // γΔt, ζΔt
};

template <int SCH, typename T, typename S, bool C>
__global__ void __launch_bounds__(256)
advection_update_kernel(const __grid_constant__ Params<T, S, C> P) {
  const oc::Geom& g = P.st.rd.g;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= g.interior_cells()) return;
  int I, J, k;
  g.split(n, I, J, k);
  const int i = I + g.Hx, j = J + g.Hy, b = blockIdx.y;
  const T G = oc::tendency<SCH>(P.st, P.first + b, P.q[b], i, j, k);
  T inc = P.gdt * G;
  if (P.gm[b] != nullptr) inc = inc + P.zdt * P.gm[b][n];
  P.G[b][n] = G;
  oc::store_with_images(P.out[b], g, I, J, k, P.q[b][g.at(i, j, k)] + inc);
}

struct Args {
  const void* const* vel;   // u*, v*, w*
  const void* p;
  const void* const* q;
  const void* const* gm;
  void* const* G;
  void* const* out;
  int nb, first;
  oc::Geom g;
  double gdt, zdt, cdt, Ax, Ay, Az, V, inv_dx, inv_dy, inv_dz;
  const double* coefs;
  cudaStream_t stream;
};

// C: the corrected variant (a pressure is given).
template <int SCH, typename T, typename S, bool C>
int launch_variant(const Args& a) {
  Params<T, S, C> P;
  Read<T, S, C>& rd = P.st.rd;
  for (int d = 0; d < 3; ++d) rd.vel[d] = (const T*)a.vel[d];
  rd.p = (const T*)a.p;
  const T c_dt = (T)a.cdt;
  rd.cx = c_dt * (T)a.inv_dx;
  rd.cy = c_dt * (T)a.inv_dy;
  rd.cz = c_dt * (T)a.inv_dz;
  rd.g = a.g;
  P.st.Ax = (T)a.Ax;
  P.st.Ay = (T)a.Ay;
  P.st.Az = (T)a.Az;
  P.st.V = (T)a.V;
  P.st.tt = oc::make_tab<T>(a.coefs);
  P.st.ts = oc::make_tab<S>(a.coefs);
  for (int c = 0; c < kBatch; ++c) {
    const bool on = c < a.nb;
    P.q[c] = on ? (const T*)a.q[c] : nullptr;
    P.gm[c] = on && a.gm != nullptr ? (const T*)a.gm[c] : nullptr;
    P.G[c] = on ? (T*)a.G[c] : nullptr;
    P.out[c] = on ? (T*)a.out[c] : nullptr;
  }
  P.first = a.first;
  P.gdt = (T)a.gdt;
  P.zdt = (T)a.zdt;
  const int threads = 256;
  dim3 grid(oc::blocks_for(a.g.interior_cells(), threads), a.nb);
  advection_update_kernel<SCH, T, S, C><<<grid, threads, 0, a.stream>>>(P);
  return (int)cudaGetLastError();
}

template <int SCH, typename T, typename S>
int launch(const Args& a) {
  return a.p != nullptr ? launch_variant<SCH, T, S, true>(a)
                        : launch_variant<SCH, T, S, false>(a);
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
// the u*, v*, w* device pointers; p: the padded pressure, or null for no
// correction. q, G, out: host arrays of the batch's nb device pointers
// (components first .. first+nb-1 of u, v, w, tracers...); gm: such an array
// of the previous stage's tendencies, or null on the first stage. Scalars
// arrive as doubles holding field-dtype values; coefs is the host table of
// Tab (kTabSize float64 values).
int oc_fused_advection_update(int scheme, int dtype, int sdtype, const void* const* vel,
                              const void* p, const void* const* q,
                              const void* const* gm, void* const* G, void* const* out,
                              int nb, int first, int Nx, int Ny, int Nz, int Hx, int Hy,
                              double gdt, double zdt, double cdt, double Ax, double Ay,
                              double Az, double V, double inv_dx, double inv_dy,
                              double inv_dz, const double* coefs, int ncoefs,
                              void* stream) {
  if (ncoefs != kTabSize || nb < 1 || nb > kBatch || first < 0)
    return (int)cudaErrorInvalidValue;
  Args a{vel, p, q, gm, G, out, nb, first, oc::Geom{Nx, Ny, Nz, Hx, Hy, 0},
         gdt, zdt, cdt, Ax, Ay, Az, V, inv_dx, inv_dy, inv_dz, coefs,
         (cudaStream_t)stream};
  if (scheme == kWeno5) return dispatch<kWeno5>(dtype, sdtype, a);
  if (scheme == kCentered2) return dispatch<kCentered2>(dtype, sdtype, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
