// Conservative shallow-water tendency and RK3 stage update, 2D (z flat).
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
// uh or vh (Centered(4) for WENO(5)), advected velocities u = uh/ℑx(h) and
// v = vh/ℑy(h) by the upwind reconstruction selected by the transport's
// sign. Tracers take the face transport itself as the advecting velocity. f
// is the constant Coriolis parameter (FPlane, or ConstantCartesianCoriolis's
// fz); 0 skips the term. Schemes: WENO(5) and Centered(2), a compile-time
// choice fed by the coefficient table of kernels/fused_advection.py
// coefficient_table.
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
//            cells (4 for WENO(5)), 16-byte loads where the window is
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
// shared memory (three blocks an SM); float64 takes a 16 × 32 tile (73.4
// KB). Registers and spills: `-Xptxas -v` (chip_smoke.py prints them).
// `new` goes to separate padded buffers; its halo slots are left for the
// next stage's wrap. A launch takes at most kBatch fields (their pointers
// ride in the parameter block); kernels/fused_shallow_water.py launches once
// per batch, and every field's result depends only on its own values and
// uh, vh, h, so the batching does not change a bit of it.
#include "common.cuh"
#include "reconstruction.cuh"
#include "tiles.cuh"

namespace {

using oc::kCentered2;
using oc::kTabSize;
using oc::kWeno5;
using oc::make_tab;
using oc::Tab;

constexpr int kBatch = 32;     // fields per launch (kernels/build.py BATCH)
constexpr int kThreads = 256;  // the most threads a block takes

// the stencil's reach: cells a face flux reads on either side
template <int SCH>
constexpr int kReach = SCH == kWeno5 ? 3 : 1;

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

template <typename T, typename S>
struct Params {
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
  Tab<T> tt;                // stencil coefficients in the field type
  Tab<S> ts;                // smoothness factors, weights, ε, saturation
  int TX, TY, tiles_y;      // the tile and the number of tiles along y
};

template <int SCH, typename T, typename S>
__global__ void __launch_bounds__(kThreads)
sw_update_kernel(const __grid_constant__ Params<T, S> P) {
  constexpr int r = kReach<SCH>, R = r + 1;
  extern __shared__ __align__(16) unsigned char oc_smem[];
  T* const sm = reinterpret_cast<T*>(oc_smem);
  const Layout L(P.TX, P.TY, r);
  const oc::Geom& g = P.g;
  const int bx = blockIdx.x / P.tiles_y, by = blockIdx.x - bx * P.tiles_y;
  const int x0 = bx * P.TX, y0 = by * P.TY;   // the tile's first interior cell
  const int ex = oc::imin(P.TX, g.Nx - x0), ey = oc::imin(P.TY, g.Ny - y0);
  const int TY = P.TY, W = L.W, Wd = L.Wd, Wh = L.Wh;
  const int PY = g.PY();
  const int last = P.first + P.nb;

  // reads at tile-relative (a, b): staged a, b in [-R, e + R), derived in
  // [-r, e + r), ½gh² in [-1, e)
  const T *s_uh = sm + L.uh, *s_vh = sm + L.vh, *s_h = sm + L.h, *s_hB = sm + L.hB;
  const T *s_c = sm + L.c, *s_u = sm + L.u, *s_v = sm + L.v, *s_hd = sm + L.hd;
  T *fx0 = sm + L.fx0, *fx1 = sm + L.fx1, *fy0 = sm + L.fy0, *fy1 = sm + L.fy1;
  auto st = [&](const T* s, int a, int b) { return s[(a + R) * W + (b + R)]; };
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
  oc::stage_rows(sm + L.uh, W, P.prog[0] + org, PY, rows, width);
  oc::stage_rows(sm + L.vh, W, P.prog[1] + org, PY, rows, width);
  oc::stage_rows(sm + L.h, W, P.prog[2] + org, PY, rows, width);
  oc::stage_rows(sm + L.hB, W, P.hB + org, PY, rows, width);
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
    // B: each face flux of uh and vh once
    oc::for_rect(nxf, ey, [&](int a, int b) {
      const int c = a - 1;                         // uh: the centre c
      T t = oc::symmetric<SCH>(P.tt, 1, [&](int o) { return UH(c + o, b); });
      fx0[a * TY + b] =
          (P.dy * t) * oc::upwind<SCH>(P.tt, P.ts, 1, t, [&](int o) { return U(c + o, b); });
      t = oc::symmetric<SCH>(P.tt, 0, [&](int o) { return UH(a, b + o); });   // vh: face a
      fx1[a * TY + b] =
          (P.dy * t) * oc::upwind<SCH>(P.tt, P.ts, 0, t, [&](int o) { return Vv(a + o, b); });
    });
    oc::for_rect(nyf, ey + 1, [&](int a, int b) {
      T t = oc::symmetric<SCH>(P.tt, 0, [&](int o) { return VH(a + o, b); });  // uh: face b
      fy0[a * Wh + b] =
          (P.dx * t) * oc::upwind<SCH>(P.tt, P.ts, 0, t, [&](int o) { return U(a, b + o); });
      const int c = b - 1;                         // vh: the centre c
      t = oc::symmetric<SCH>(P.tt, 1, [&](int o) { return VH(a, c + o); });
      fy1[a * Wh + b] =
          (P.dx * t) * oc::upwind<SCH>(P.tt, P.ts, 1, t, [&](int o) { return Vv(a, c + o); });
    });
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
    oc::stage_rows(sm + L.c, W, P.q[comp - P.first] + org, PY, rows, width);
    __syncthreads();
    oc::for_rect(nxf, ey, [&](int a, int b) {
      const T vel = UH(a, b);
      fx0[a * TY + b] =
          (P.dy * vel) * oc::upwind<SCH>(P.tt, P.ts, 0, vel, [&](int o) { return C(a + o, b); });
    });
    oc::for_rect(nyf, ey + 1, [&](int a, int b) {
      const T vel = VH(a, b);
      fy0[a * Wh + b] =
          (P.dx * vel) * oc::upwind<SCH>(P.tt, P.ts, 0, vel, [&](int o) { return C(a, b + o); });
    });
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
  int TX, TY, threads, blocks, smem;   // the launch plan
  cudaStream_t stream;
  int* per_sm;   // non-null: report the blocks an SM holds instead of launching
};

template <int SCH, typename T, typename S>
int launch(const Args& a) {
  constexpr int R = kReach<SCH> + 1;
  const long long want = (long long)Layout(a.TX, a.TY, kReach<SCH>).total * sizeof(T);
  const int tiles_y = oc::ceil_div(a.g.Ny, a.TY);
  if (a.smem != want || a.smem > oc::kMaxSmemBytes || a.g.Hx < R || a.g.Hy < R ||
      a.blocks != oc::ceil_div(a.g.Nx, a.TX) * tiles_y)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      sw_update_kernel<SCH, T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  if (a.per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.per_sm, sw_update_kernel<SCH, T, S>, a.threads, a.smem);
  Params<T, S> P;
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
  P.tt = make_tab<T>(a.coefs);
  P.ts = make_tab<S>(a.coefs);
  P.TX = a.TX;
  P.TY = a.TY;
  P.tiles_y = tiles_y;
  sw_update_kernel<SCH, T, S><<<a.blocks, a.threads, a.smem, a.stream>>>(P);
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
// Coriolis parameter, 0 for none. TX, TY, threads, blocks, smem: the launch
// plan of kernels/fused_shallow_water.py launch_plan (the tile, the threads
// a block, ceil(Nx/TX)·ceil(Ny/TY) blocks and the dynamic shared memory in
// bytes), refused unless they agree with the tile's layout.
int oc_fused_sw_update(int scheme, int dtype, int sdtype, const void* const* prog,
                       const void* const* q, void* const* out, int nb, int first,
                       const void* hB, const void* Gm,
                       void* G, int Nx, int Ny, int Hx, int Hy, double dx, double dy,
                       double Ax, double Ay, double Az, double V, double g_acc,
                       double f, double gamma_dt, double zeta_dt, const double* coefs,
                       int ncoefs, int TX, int TY, int threads, int blocks, int smem,
                       void* stream) {
  if (ncoefs != kTabSize || nb < 1 || nb > kBatch || first < 0 || TX < 1 || TY < 1 ||
      threads < 32 || threads > kThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{prog, q, out, nb, first, hB, Gm, G, oc::Geom{Nx, Ny, 1, Hx, Hy, 0}, dx, dy, Ax, Ay,
         Az, V, g_acc, f, gamma_dt, zeta_dt, coefs, TX, TY, threads, blocks, smem,
         (cudaStream_t)stream, nullptr};
  if (scheme == kWeno5) return dispatch<kWeno5>(dtype, sdtype, a);
  if (scheme == kCentered2) return dispatch<kCentered2>(dtype, sdtype, a);
  return (int)cudaErrorInvalidValue;
}

// The blocks of the launch plan's shape that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *per_sm.
int oc_fused_sw_update_blocks_per_sm(int scheme, int dtype, int sdtype, int TX, int TY,
                                     int threads, int smem, int* per_sm) {
  const int H = (scheme == kWeno5 ? 3 : 1) + 1;
  Args a{};
  a.nb = 1;
  a.g = oc::Geom{TX, TY, 1, H, H, 0};
  a.TX = TX;
  a.TY = TY;
  a.threads = threads;
  a.blocks = 1;
  a.smem = smem;
  a.per_sm = per_sm;
  if (scheme == kWeno5) return dispatch<kWeno5>(dtype, sdtype, a);
  if (scheme == kCentered2) return dispatch<kCentered2>(dtype, sdtype, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
