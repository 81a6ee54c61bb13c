// Conservative shallow-water tendency and RK3 stage update, 2D (z flat):
// the kernel template of #8.
//
// Replaces oceananigans_tpu/kernels/fused_shallow_water.py
// build_fused_sw_update (:43; the pallas_call at :169). For the prognostic
// fields uh, vh, h and each tracer c (padded (Nx+2Hx, Ny+2Hy, 1) arrays whose
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
// uh or vh (the scheme's advecting-velocity scheme: Centered(2K-2) for
// WENO(2K-1)), advected velocities u = uh/ℑx(h) and v = vh/ℑy(h) by the
// upwind reconstruction selected by the transport's sign. Tracers take the
// face transport itself as the advecting velocity and, as the plain
// version's biased_pair gives them, a Centered scheme's symmetric value. f
// is the constant Coriolis parameter (FPlane, or ConstantCartesianCoriolis's
// fz); 0 skips the term. Schemes: every scheme the 3D kernels take
// (Centered(2-12), UpwindBiased(1-11), WENO(3-11); the periodic 2-D domain
// has no cascade), the buffer K and the family compile-time choices
// (advection_k1.cu .. advection_k6.cu instantiate this template), fed by
// the coefficient table of kernels/fused_advection.py
// coefficient_table; fused_shallow_water.cu holds the C entries.
//
// Bound: the compulsory traffic, 40-52 B per interior cell and stage in
// float32 for uh, vh and h (4.17 ms at 16392² and 3.35 TB/s); the function
// needs about 550 floating-point operations per cell, and at the card's own
// rate for the WENO-5 body with exact divisions (22.7 Tflop/s, the #12
// probe on a slab that fills every SM) those take about 6.7 ms at 16384²,
// so in practice the arithmetic binds. No tensor cores: the WENO weights
// are nonlinear in the data, and nothing here is a product wgmma could take.
//
// Design: one block owns a TX × TY tile of interior cells (y fastest across
// threads, y is contiguous) and works through it in phases separated by
// __syncthreads() (tiles.cuh):
//   staging  uh, vh, h and hB over the tile plus a ring of R = reach + 1
//            cells (K + 1 for a scheme of buffer K), 16-byte loads where the window is
//            aligned; plain loads through registers, no cp.async or TMA:
//            the staging is a small share of a kernel that the arithmetic
//            binds, and plain copies keep every phase a loop that a block
//            of any thread count runs the same way;
//   A        u = uh/ℑx(h), v = vh/ℑy(h) once on every cell a flux of the
//            tile selects (the tile plus the reach), and ½gh² once;
//   B        each face flux once: uh's x-fluxes at TX + 1 centres and its
//            y-fluxes at TY + 1 (f, f) faces, vh's the same way;
//   C        per cell: the flux differences, the gravity head, the
//            bathymetry and Coriolis terms, G and the stage update;
//   tracers  each tracer of the launch in turn: stage it, its face fluxes
//            with the face transports as velocity, its update; uh and vh
//            stay resident.
// Every face flux goes through one code path wherever it lies in the tile,
// so a tile edge contracts no FMA differently from the tile's inside, and
// the stage on a mesh's blocks equals the serial stage bit for bit. The
// expressions are those of the plain version; divisions are exact. The tile,
// the block count and the dynamic shared memory come from
// kernels/fused_shallow_water.py launch_plan; the C entry recomputes and
// checks them. At float32 a 32 × 32 tile with 256 threads takes 64.8 KB of
// shared memory at WENO(5) (three blocks an SM), 79.1 KB at WENO(11);
// float64 takes a 16 × 32 tile (73.4 KB at WENO(5)). Registers and spills: `-Xptxas -v` (chip_smoke.py prints them).
// `new` goes to separate padded buffers; its halo slots are left for the
// next stage's wrap. A launch takes at most kBatch fields (their pointers
// ride in the parameter block); kernels/fused_shallow_water.py launches once
// per batch, and every field's result depends only on its own values and
// uh, vh, h, so the batching does not change a bit of it.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "reconstruction.cuh"
#include "tiles.cuh"

namespace oc {

// The arguments of one launch of #8, from the C entry.
struct SwArgs {
  const void* const* prog;   // uh, vh, h
  const void* const* q;      // the batch's fields
  void* const* out;
  int nb, first;
  const void* hB;
  const void* Gm;
  void* G;
  Geom g;
  double dx, dy, Ax, Ay, Az, V, g_acc, f, gamma_dt, zeta_dt;
  const double* coefs;
  int TX, TY, threads, blocks, smem;   // the launch plan
  cudaStream_t stream;
  int* per_sm;   // non-null: report the blocks an SM holds instead of launching
};

// One function per buffer K (advection_kK.cu): fam kCentered, kUpwind or
// kWeno; dtype and sdtype the codes of common.cuh.
int sw_k1(int fam, int dtype, int sdtype, const SwArgs& a);
int sw_k2(int fam, int dtype, int sdtype, const SwArgs& a);
int sw_k3(int fam, int dtype, int sdtype, const SwArgs& a);
int sw_k4(int fam, int dtype, int sdtype, const SwArgs& a);
int sw_k5(int fam, int dtype, int sdtype, const SwArgs& a);
int sw_k6(int fam, int dtype, int sdtype, const SwArgs& a);

}  // namespace oc

namespace {
namespace sw {

constexpr int kBatch = 32;     // fields per launch (kernels/build.py BATCH)
constexpr int kThreads = 256;  // the most threads a block takes

// Element offsets of a block's shared arrays for a TX × TY tile and a
// stencil reach r (ring R = r + 1); kernels/fused_shallow_water.py
// smem_bytes computes the same total.
struct Layout {
  int W, Wd, Wh;        // strides: staged TY + 2R, derived TY + 2r, head and y-fluxes TY + 1
  int uh, vh, h, hB, c; // staged (TX + 2R) × W
  int u, v;             // derived (TX + 2r) × Wd
  int hd;               // ½gh², (TX + 1) × Wh from (-1, -1)
  int fx0, fx1;         // x-fluxes (TX + 1) × TY
  int fy0, fy1;         // y-fluxes TX × Wh
  int total;

  __host__ __device__ Layout(int TX, int TY, int r) {
    const int R = r + 1;
    W = TY + 2 * R;
    Wd = TY + 2 * r;
    Wh = TY + 1;
    const int staged = oc::align_elems((TX + 2 * R) * W);
    const int derived = oc::align_elems((TX + 2 * r) * Wd);
    const int fx = oc::align_elems((TX + 1) * TY);
    const int fy = oc::align_elems(TX * Wh);
    int o = 0;
    uh = o; o += staged;
    vh = o; o += staged;
    h = o; o += staged;
    hB = o; o += staged;
    c = o; o += staged;
    u = o; o += derived;
    v = o; o += derived;
    hd = o; o += oc::align_elems((TX + 1) * Wh);
    fx0 = o; o += fx;
    fx1 = o; o += fx;
    fy0 = o; o += fy;
    fy1 = o; o += fy;
    total = o;
  }
};

template <int K, int F, typename T, typename S>
struct Params {
  static constexpr int fam = F;   // kCentered, kUpwind or kWeno
  const T* prog[3];         // uh, vh, h: padded, halos filled
  const T* q[kBatch];       // the batch's fields (of uh, vh, h, tracers)
  T* out[kBatch];           // the batch's new fields: padded, interiors written
  int nb, first;            // fields first .. first + nb - 1
  const T* hB;              // bathymetry, padded, halos filled
  const T* Gm;              // (nf, Nx, Ny) previous-stage tendencies or null
  T* G;                     // (nf, Nx, Ny) out, all fields
  oc::Geom g;               // Nz = 1, Hz = 0
  T dx, dy, Ax, Ay, Az, V;  // spacings, face areas, cell volume (regular grid)
  T half_g, g_acc, f;       // g/2, g, Coriolis parameter (0: none)
  T gamma_dt, zeta_dt;
  oc::Tabs<K, F == oc::kWeno, T, S> tab;   // the scheme's coefficient table
  int af[3], ak[3];         // each axis's family and buffer (a FluxFormAdvection's)
  int any;                  // x or y not (F, K): the launch takes the per-axis fluxes
  int TX, TY, tiles_y;      // the tile and the number of tiles along y
};

// The reconstruction and the symmetric interpolation along x (ax 0) or y
// (ax 1): with kAny that axis's family and buffer at run time, else the
// instantiation's family F and buffer K.
template <bool kAny, int K, int F, typename T, typename S, typename Q>
__device__ __forceinline__ T recon(const Params<K, F, T, S>& P, int ax, int beta, bool pos,
                                   Q q) {
  if constexpr (kAny)
    return oc::biased_any_inline(ax == 0 ? P.ak[0] : P.ak[1], ax == 0 ? P.af[0] : P.af[1],
                                 P.tab, beta, pos, q);
  else
    return oc::biased<K>(P.fam, P.tab, beta, pos, q);
}
template <bool kAny, int K, int F, typename T, typename S, typename Q>
__device__ __forceinline__ T interp(const Params<K, F, T, S>& P, int ax, int beta, Q q) {
  if constexpr (kAny)
    return oc::symmetric_any(ax == 0 ? P.ak[0] : P.ak[1], ax == 0 ? P.af[0] : P.af[1], P.tab,
                             beta, q);
  else
    return oc::symmetric<K>(P.fam, P.tab, beta, q);
}

// A tracer's advected value: a Centered scheme's symmetric value (the plain
// version's biased_pair gives both sides that), else the reconstruction
// selected by pos.
template <bool kAny, int K, int F, typename T, typename S, typename Q>
__device__ __forceinline__ T tracer_value(const Params<K, F, T, S>& P, int ax, bool pos, Q q) {
  if constexpr (kAny) {
    if ((ax == 0 ? P.af[0] : P.af[1]) == oc::kCentered) return interp<true>(P, ax, 0, q);
    return recon<true>(P, ax, 0, pos, q);
  } else {
    if (F == oc::kCentered) return oc::centered<K>(P.tab.lin.v + oc::off_sym(K), 0, q);
    return oc::biased<K>(P.fam, P.tab, 0, pos, q);
  }
}

// K: the scheme's buffer (its reach); F: its family.
template <int K, int F, typename T, typename S>
__global__ void __launch_bounds__(kThreads)
sw_update_kernel(const __grid_constant__ Params<K, F, T, S> P) {
  constexpr int r = K, R = r + 1;
  extern __shared__ __align__(16) unsigned char oc_smem[];
  T* const sm = reinterpret_cast<T*>(oc_smem);
  const Layout L(P.TX, P.TY, r);
  const oc::Geom& g = P.g;
  const int bx = blockIdx.x / P.tiles_y, by = blockIdx.x - bx * P.tiles_y;
  const int x0 = bx * P.TX, y0 = by * P.TY;   // the tile's first interior cell
  const int ex = oc::imin(P.TX, g.Nx - x0), ey = oc::imin(P.TY, g.Ny - y0);
  const int TY = P.TY, Ws = L.W, Wd = L.Wd, Wh = L.Wh;
  const int PY = g.PY();
  const int last = P.first + P.nb;

  // reads at tile-relative (a, b): staged a, b in [-R, e + R), derived in
  // [-r, e + r), ½gh² in [-1, e)
  const T *s_uh = sm + L.uh, *s_vh = sm + L.vh, *s_h = sm + L.h, *s_hB = sm + L.hB;
  const T *s_c = sm + L.c, *s_u = sm + L.u, *s_v = sm + L.v, *s_hd = sm + L.hd;
  T *fx0 = sm + L.fx0, *fx1 = sm + L.fx1, *fy0 = sm + L.fy0, *fy1 = sm + L.fy1;
  auto st = [&](const T* s, int a, int b) { return s[(a + R) * Ws + (b + R)]; };
  auto UH = [&](int a, int b) { return st(s_uh, a, b); };
  auto VH = [&](int a, int b) { return st(s_vh, a, b); };
  auto H = [&](int a, int b) { return st(s_h, a, b); };
  auto HB = [&](int a, int b) { return st(s_hB, a, b); };
  auto C = [&](int a, int b) { return st(s_c, a, b); };
  auto U = [&](int a, int b) { return s_u[(a + r) * Wd + (b + r)]; };
  auto Vv = [&](int a, int b) { return s_v[(a + r) * Wd + (b + r)]; };
  auto HD = [&](int a, int b) { return s_hd[(a + 1) * Wh + (b + 1)]; };

  // staging: the tile and its ring
  const long long org = (long long)(x0 + g.Hx - R) * PY + (y0 + g.Hy - R);
  const int rows = ex + 2 * R, width = ey + 2 * R;
  oc::stage_rows(sm + L.uh, Ws, P.prog[0] + org, PY, rows, width);
  oc::stage_rows(sm + L.vh, Ws, P.prog[1] + org, PY, rows, width);
  oc::stage_rows(sm + L.h, Ws, P.prog[2] + org, PY, rows, width);
  oc::stage_rows(sm + L.hB, Ws, P.hB + org, PY, rows, width);
  __syncthreads();

  const int nxf = (ex + 1) * ey, nyf = ex * (ey + 1);
  if (P.first <= 1) {   // uh or vh in this launch
    // A: the derived velocities and ½gh², once each
    const int dw = ey + 2 * r;
    oc::for_rect((ex + 2 * r) * dw, dw, [&](int a, int b) {
      a -= r;
      b -= r;
      sm[L.u + (a + r) * Wd + (b + r)] = UH(a, b) / (T(0.5) * (H(a, b) + H(a - 1, b)));
      sm[L.v + (a + r) * Wd + (b + r)] = VH(a, b) / (T(0.5) * (H(a, b) + H(a, b - 1)));
    });
    oc::for_rect((ex + 1) * (ey + 1), ey + 1, [&](int a, int b) {
      const T h = H(a - 1, b - 1);
      sm[L.hd + a * Wh + b] = (P.half_g * h) * h;
    });
    __syncthreads();
    // B: each face flux of uh and vh once (kAny: a FluxFormAdvection whose
    // x or y is not the instantiation's, each axis's scheme at run time)
    const auto momentum_fluxes = [&](auto any) {
      constexpr bool A = decltype(any)::value;
      oc::for_rect(nxf, ey, [&](int a, int b) {
        const int c = a - 1;                       // uh: the centre c
        T t = interp<A>(P, 0, 1, [&](int o) { return UH(c + o, b); });
        fx0[a * TY + b] = (P.dy * t) * recon<A>(P, 0, 1, t > T(0),
                                                [&](int o) { return U(c + o, b); });
        t = interp<A>(P, 1, 0, [&](int o) { return UH(a, b + o); });   // vh: face a
        fx1[a * TY + b] = (P.dy * t) * recon<A>(P, 0, 0, t > T(0),
                                                [&](int o) { return Vv(a + o, b); });
      });
      oc::for_rect(nyf, ey + 1, [&](int a, int b) {
        T t = interp<A>(P, 0, 0, [&](int o) { return VH(a + o, b); });  // uh: face b
        fy0[a * Wh + b] = (P.dx * t) * recon<A>(P, 1, 0, t > T(0),
                                                [&](int o) { return U(a, b + o); });
        const int c = b - 1;                       // vh: the centre c
        t = interp<A>(P, 1, 1, [&](int o) { return VH(a, c + o); });
        fy1[a * Wh + b] = (P.dx * t) * recon<A>(P, 1, 1, t > T(0),
                                                [&](int o) { return Vv(a, c + o); });
      });
    };
    if (P.any)
      momentum_fluxes(std::true_type());
    else
      momentum_fluxes(std::false_type());
    __syncthreads();
  }

  const long long cells = g.interior_cells();
  auto store = [&](int comp, long long at, long long pad, T q, T G) {
    P.G[comp * cells + at] = G;
    T inc = P.gamma_dt * G;
    if (P.Gm != nullptr) inc = inc + P.zeta_dt * P.Gm[comp * cells + at];
    P.out[comp - P.first][pad] = q + inc;
  };

  // C: uh, vh and h
  const int stop = oc::imin(last, 3);
  if (P.first < stop) {
    oc::for_rect(ex * ey, ey, [&](int a, int b) {
      const long long at = (long long)(x0 + a) * g.Ny + (y0 + b);
      const long long pad = g.at(x0 + a + g.Hx, y0 + b + g.Hy, 0);
      for (int comp = P.first; comp < stop; ++comp) {
        T G, q;
        if (comp == 0) {
          const T fx = fx0[(a + 1) * TY + b] - fx0[a * TY + b];
          const T fy = fy0[a * Wh + b + 1] - fy0[a * Wh + b];
          const T div = (fx + fy) / P.Az;
          const T hx = T(0.5) * (H(a, b) + H(a - 1, b));
          const T dhB = (HB(a, b) - HB(a - 1, b)) / P.dx;
          G = (-div - (HD(a, b) - HD(a - 1, b)) / P.dx) - (P.g_acc * hx) * dhB;
          if (P.f != T(0)) {
            const T vc0 = T(0.5) * (VH(a, b + 1) + VH(a, b));
            const T vc1 = T(0.5) * (VH(a - 1, b + 1) + VH(a - 1, b));
            G = G + P.f * (T(0.5) * (vc0 + vc1));
          }
          q = UH(a, b);
        } else if (comp == 1) {
          const T fx = fx1[(a + 1) * TY + b] - fx1[a * TY + b];
          const T fy = fy1[a * Wh + b + 1] - fy1[a * Wh + b];
          const T div = (fx + fy) / P.Az;
          const T hy = T(0.5) * (H(a, b) + H(a, b - 1));
          const T dhB = (HB(a, b) - HB(a, b - 1)) / P.dy;
          G = (-div - (HD(a, b) - HD(a, b - 1)) / P.dy) - (P.g_acc * hy) * dhB;
          if (P.f != T(0)) {
            const T uc0 = T(0.5) * (UH(a + 1, b) + UH(a, b));
            const T uc1 = T(0.5) * (UH(a + 1, b - 1) + UH(a, b - 1));
            G = G - P.f * (T(0.5) * (uc0 + uc1));
          }
          q = VH(a, b);
        } else {
          const T dU = P.Ax * UH(a + 1, b) - P.Ax * UH(a, b);
          const T dV = P.Ay * VH(a, b + 1) - P.Ay * VH(a, b);
          G = ((-((dU + dV) / P.V)) * P.V) / P.Az;
          q = H(a, b);
        }
        store(comp, at, pad, q, G);
      }
    });
  }

  // tracers: stage, face fluxes, update, one tracer at a time
  for (int comp = P.first > 3 ? P.first : 3; comp < last; ++comp) {
    __syncthreads();   // the previous phase has read s_c and the flux arrays
    oc::stage_rows(sm + L.c, Ws, P.q[comp - P.first] + org, PY, rows, width);
    __syncthreads();
    const auto tracer_fluxes = [&](auto any) {
      constexpr bool A = decltype(any)::value;
      oc::for_rect(nxf, ey, [&](int a, int b) {
        const T vel = UH(a, b);
        fx0[a * TY + b] = (P.dy * vel) *
                          tracer_value<A>(P, 0, vel > T(0), [&](int o) { return C(a + o, b); });
      });
      oc::for_rect(nyf, ey + 1, [&](int a, int b) {
        const T vel = VH(a, b);
        fy0[a * Wh + b] = (P.dx * vel) *
                          tracer_value<A>(P, 1, vel > T(0), [&](int o) { return C(a, b + o); });
      });
    };
    if (P.any)
      tracer_fluxes(std::true_type());
    else
      tracer_fluxes(std::false_type());
    __syncthreads();
    oc::for_rect(ex * ey, ey, [&](int a, int b) {
      const T dU = P.dy * UH(a + 1, b) - P.dy * UH(a, b);
      const T dV = P.dx * VH(a, b + 1) - P.dx * VH(a, b);
      const T divU = (dU + dV) / P.Az;
      const T fx = fx0[(a + 1) * TY + b] - fx0[a * TY + b];
      const T fy = fy0[a * Wh + b + 1] - fy0[a * Wh + b];
      const T G = -((fx + fy) / P.Az) + C(a, b) * divU;
      store(comp, (long long)(x0 + a) * g.Ny + (y0 + b),
            g.at(x0 + a + g.Hx, y0 + b + g.Hy, 0), C(a, b), G);
    });
  }
}

template <int K, int F, typename T, typename S>
int launch(const oc::SwArgs& a) {
  constexpr int R = K + 1;
  const long long want = (long long)Layout(a.TX, a.TY, K).total * sizeof(T);
  const int tiles_y = oc::ceil_div(a.g.Ny, a.TY);
  if (a.smem != want || a.smem > oc::kMaxSmemBytes || a.g.Hx < R || a.g.Hy < R ||
      a.blocks != oc::ceil_div(a.g.Nx, a.TX) * tiles_y)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      sw_update_kernel<K, F, T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  if (a.per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.per_sm, sw_update_kernel<K, F, T, S>, a.threads, a.smem);
  Params<K, F, T, S> P;
  for (int d = 0; d < 3; ++d) P.prog[d] = (const T*)a.prog[d];
  for (int c = 0; c < kBatch; ++c) {
    P.q[c] = c < a.nb ? (const T*)a.q[c] : nullptr;
    P.out[c] = c < a.nb ? (T*)a.out[c] : nullptr;
  }
  P.nb = a.nb;
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
  P.tab = oc::Tabs<K, F == oc::kWeno, T, S>::make(a.coefs);
  if (!oc::axis_codes(a.coefs, K, F == oc::kWeno, P.af, P.ak))
    return (int)cudaErrorInvalidValue;
  {
    // z is flat: only x and y count
    int fam[3] = {P.af[0], P.af[1], F}, buf[3] = {P.ak[0], P.ak[1], K};
    P.any = oc::any_axis(F, K, fam, buf, false);
    P.af[0] = fam[0];
    P.af[1] = fam[1];
  }
  P.TX = a.TX;
  P.TY = a.TY;
  P.tiles_y = tiles_y;
  sw_update_kernel<K, F, T, S><<<a.blocks, a.threads, a.smem, a.stream>>>(P);
  return (int)cudaGetLastError();
}

// The instantiations of buffer K, one per family: the linear families take
// the field type alone (no smoothness arithmetic), WENO (K >= 2) the five
// smoothness pairs.
template <int K>
int dispatch(int fam, int dtype, int sdtype, const oc::SwArgs& a) {
  using oc::kCentered;
  using oc::kUpwind;
  using oc::kWeno;
  if (a.nb < 1 || a.nb > kBatch || a.first < 0 || a.TX < 1 || a.TY < 1 || a.threads < 32 ||
      a.threads > kThreads || a.threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (fam == kCentered && dtype == OC_FLOAT32) return launch<K, kCentered, float, float>(a);
  if (fam == kCentered && dtype == OC_FLOAT64) return launch<K, kCentered, double, double>(a);
  if (fam == kUpwind && dtype == OC_FLOAT32) return launch<K, kUpwind, float, float>(a);
  if (fam == kUpwind && dtype == OC_FLOAT64) return launch<K, kUpwind, double, double>(a);
  if constexpr (K >= 2) {
    if (fam != kWeno) return (int)cudaErrorInvalidValue;
    if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32) return launch<K, kWeno, float, float>(a);
    if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64) return launch<K, kWeno, float, double>(a);
    if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32) return launch<K, kWeno, double, float>(a);
    if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64)
      return launch<K, kWeno, double, double>(a);
    if (dtype == OC_FLOAT32 && sdtype == OC_BFLOAT16)
      return launch<K, kWeno, float, oc::bf16>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace sw

template <int K>
int sw_dispatch(int fam, int dtype, int sdtype, const oc::SwArgs& a) {
  return sw::dispatch<K>(fam, dtype, sdtype, a);
}

}  // namespace
