// The fused hydrostatic tendency: vector-invariant momentum plus tracers.
//
// Replaces oceananigans_tpu/kernels/fused_vector_invariant.py
// _build_phase_call (via build_fused_hydrostatic_tendency, the pallas_call at
// :381) and _build_phase_call_packed (via
// build_fused_hydrostatic_tendency_packed, :739; its packed (y, z) layout is
// a TPU lane view, the same function). From padded u (fcc), v (cfc), w (ccf),
// the hydrostatic pressure anomaly ph (ccc, optional) and up to 8 tracers,
// halos filled, it computes what the TPU function's four phases compute with
// the operators of oceananigans_tpu/advection/vector_invariant.py,
// coriolis.py and advection/fluxes.py div_Uc:
//
//   Gu = -h_u - b_u - z_u - (f×U)ˣ - δx ph/Δx     (fcc; summed ((h+b)+z)+f)
//   Gv = -h_v - b_v - z_v - (f×U)ʸ - δy ph/Δy     (cfc)
//   Gc = -∇·(𝐯c)                                   (ccc)
//
// h: the vorticity flux (enstrophy or energy conserving, or the WENO-5/7/9
// reconstruction of ζ along the transport, with the smoothness of the
// velocity stencil ℑy u, ℑx v); b: the Bernoulli head (energy conserving K,
// or self-upwinded WENO-5 with the Centered(4) cross term); z: vertical
// advection (energy conserving, or WENO-5 with the ONLY_SELF divergence flux
// Φᵟ). Every read of a shifted position outside the padded array is 0, as
// the plain version's zero-filled shifts give, so the two agree on every cell
// they both write: the interiors, and on a bounded x (y) the boundary-face
// row of u (v). The near-wall order cascade (WENO 9 → 7 → 5 → 3 →
// UpwindBiased(1), Centered(4) → Centered(2)) is selected on the global
// padded index along every bounded axis, as advection/schemes.py
// _cascade_select does.
//
// Bound: operations. For the hydro_row configuration at 512x256x32 the
// function needs about 1,800 floating-point operations per cell (chip_smoke.py
// counts them: each derived field, face flux and reconstruction once), 0.114
// ms at the float32 rate; its compulsory bytes (u, v, w, T in; Gu, Gv, G_T
// out) take 0.045 ms at 3.35 TB/s (H100 SXM).
//
// Design: one launch, one block per TX × TY × TZ tile of output cells (the
// interior plus the boundary-face rows; z fastest across threads, a ragged
// edge masked), and no device-memory scratch. The block stages u and v over
// the tile plus a reach R = max(WENO vorticity buffer, 3) + 1 along x and y
// (zeros outside the padded array), and the tile's metric rows, into shared
// memory; then it works through the TPU function's four phases in turn,
// each forming its derived fields once over the box less one cell a side
// into one work buffer that the next phase reuses (tiles.cuh's loops,
// strided by the block's thread count, separated by __syncthreads()):
//   vorticity   ζ (and ℑy u, ℑx v for WENO), then per u and v point the
//               vorticity flux into the per-cell sums Gu, Gv;
//   Bernoulli   for u, then for v, the ½u² and ½v² differences and ℑx u,
//               ℑy v (or K), and each point's head;
//   vertical    w over the tile plus 2 and u, v over the tile's columns
//               plus 3 along z, each z face flux of u and v once, then
//               δx(Ax u), δy(Ay v), Φᵟ and the flux differences;
//   forces      Coriolis and −δph (ph staged over the tile plus one), Gu and
//               Gv written; then each tracer staged over the tile plus 3
//               and each of its face fluxes formed once, and Gc from the
//               differences.
// The reconstructions are one non-inlined function per field type, with the
// WENO orders inlined in it, reading each stencil's cells in place from a
// shared-memory box by the line's stride (holding a WENO-9's 27 cells and
// smoothness operands in registers left room for one block an SM). Coefficients live in constant memory (VITab), uploaded once per
// device by oc_vi_set_tables. Metrics are per-y rows in the field type.
// Divisions are exact. The tile, the block count and the dynamic shared
// memory come from kernels/fused_vector_invariant.py launch_plan; the C
// entry recomputes and checks them. Registers and spills: `-Xptxas -v`
// (chip_smoke.py prints them).
#include "common.cuh"
#include "reconstruction.cuh"
#include "tiles.cuh"

namespace {

constexpr int kMaxTracers = 8;
constexpr int kThreads = 256;  // the most threads a block takes
constexpr int kInFlight = 4;   // staging loads in flight a thread
constexpr int kRz = 3;         // z reach of the WENO-5 vertical and tracer reconstructions
constexpr int kRc = 3;         // horizontal reach of a tracer box

// Metric rows, as kernels/fused_vector_invariant.py ROWS orders them.
enum Row {
  kDxFCC, kDxCFC, kDyFCC, kDyCFC, kAzFFC, kAzFCC, kAzCFC, kAzCCF, kAxFCC, kAyCFC,
  kVFCC, kVCFC, kVCCC, kF, kNumRows
};

// Coefficients for WENO buffers k = 2..5 (index k-2), zero-padded to 5.
template <typename R>
struct VITab {
  R coef[4][5][5];      // stencil s, cell j (offset β-1-s+j)
  R fac[4][5][5][5];    // smoothness factor m of stencil s, cell j
  R gam[4][5];          // optimal weights
  R tau[4][5];          // global smoothness indicator coefficients
  R c4[4];              // Centered(4), cells at offsets β-2 .. β+1
  R c2[2];              // Centered(2), cells at offsets β-1, β
  R eps, rmax;
};
constexpr int kTableSize = 100 + 500 + 20 + 20 + 4 + 2 + 2;

__constant__ VITab<float> kTabF;
__constant__ VITab<double> kTabD;

template <typename R> __device__ __forceinline__ const VITab<R>& vtab();
template <> __device__ __forceinline__ const VITab<float>& vtab<float>() { return kTabF; }
template <> __device__ __forceinline__ const VITab<double>& vtab<double>() { return kTabD; }

// Element offsets of a block's shared arrays for a TX × TY × TZ tile and a
// horizontal reach R; kernels/fused_vector_invariant.py smem_bytes computes
// the same total. Box coordinates (A, B, c) count from (i0 - R, j0 - R, k0),
// the tile's first output cell less the reach.
struct Layout {
  int BY, sx, sy;      // box strides: (TY + 2R)·TZ along A, TZ along B
  int box;             // one box: u, v, or a derived field, (TX + 2R)(TY + 2R) TZ
  int wby, wbz, wsz;   // the w box from (i0 - 2, j0 - 2, k0): (TX + 3)(TY + 3)(TZ + 1)
  int col, fz;         // a z column box TX·TY·(TZ + 2kRz); z face fluxes TX·TY·(TZ + 1)
  int phb;             // the ph box from (i0 - 1, j0 - 1, k0): (TX + 1)(TY + 1) TZ
  int tby, tbz, tb;    // a tracer box from (i0 - kRc, j0 - kRc, k0 - kRz)
  int tfx, tfy;        // tracer fluxes (TX + 1)·TY·TZ, TX·(TY + 1)·TZ (and fz)
  int U, V, acc[2], rows, work, total;

  __host__ __device__ Layout(int TX, int TY, int TZ, int R) {
    BY = TY + 2 * R;
    sy = TZ;
    sx = BY * TZ;
    box = oc::align_elems((TX + 2 * R) * BY * TZ);
    wby = TY + 3;
    wbz = TZ + 1;
    wsz = oc::align_elems((TX + 3) * wby * wbz);
    col = oc::align_elems(TX * TY * (TZ + 2 * kRz));
    fz = oc::align_elems(TX * TY * (TZ + 1));
    phb = oc::align_elems((TX + 1) * (TY + 1) * TZ);
    tby = TY + 2 * kRc;
    tbz = TZ + 2 * kRz;
    tb = oc::align_elems((TX + 2 * kRc) * tby * tbz);
    tfx = oc::align_elems((TX + 1) * TY * TZ);
    tfy = oc::align_elems(TX * (TY + 1) * TZ);
    const int cells = oc::align_elems(TX * TY * TZ);
    int o = 0;
    U = o; o += box;
    V = o; o += box;
    acc[0] = o; o += cells;
    acc[1] = o; o += cells;
    rows = o; o += oc::align_elems(kNumRows * BY);
    work = o;
    // the work buffer holds, phase by phase: ζ, ℑy u, ℑx v (three boxes);
    // three Bernoulli fields; w, the z face fluxes of u and v, then the u
    // and v columns or δx(Ax u) and δy(Ay v); w and ph; w, a tracer box and
    // its fluxes
    const int c2 = 2 * col > 2 * box ? 2 * col : 2 * box;
    int need = 3 * box;
    need = need > wsz + 2 * fz + c2 ? need : wsz + 2 * fz + c2;
    need = need > wsz + phb ? need : wsz + phb;
    need = need > wsz + tb + tfx + tfy + fz ? need : wsz + tb + tfx + tfy + fz;
    total = o + need;
  }
};

template <typename T>
struct Params {
  const T* u; const T* v; const T* w; const T* ph;
  const T* c[kMaxTracers];
  T* G[2 + kMaxTracers];        // Gu, Gv, Gc... (padded)
  const T* rows;                // kNumRows x PY
  oc::Geom g;
  int bx, by;                   // bounded x / y
  int vort, kv;                 // 0 enstrophy, 1 energy, 2 WENO (buffer kv)
  int upw;                      // 0 energy conserving, 1 WENO(5) ONLY_SELF
  int cor;                      // 0 none, 1 FPlane, 2 spherical energy, 3 spherical enstrophy
  int tsch;                     // tracers: 0 Centered(2), 1 WENO(5)
  int ntr, with_ph;
  T dzf;                        // Δz at z faces (regular z)
  int TX, TY, TZ, R;            // the tile and the reach
  int tiles_y, tiles_z;         // tiles along y and z
};

// -- reconstructions -------------------------------------------------------------

// How a reconstruction's smoothness is formed: from the reconstructed line
// itself, from one line s1, from s1 and s2 summed as indicators, or from
// the line s1 + s2.
enum Smooth { kSelf, kOne, kTwo, kSum };

// β of stencil s in S over the K cells q(0 .. K-1) (reconstruction.cuh's
// smoothness indicator, the factors from VITab).
template <int K, typename S, typename Q>
__device__ __forceinline__ S smoothness(int s, Q q) {
  const VITab<S>& ts = vtab<S>();
  S v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = (S)q(j);
  return oc::smoothness_indicator<K>([&](int m, int j) { return ts.fac[K - 2][s][m][j]; }, v);
}

// WENO of buffer K on the 2K-1 upwind-selected cells of the line through v
// with stride st in a shared box (v at the reconstruction point), read in
// place stencil by stencil: cell n of the left-biased orientation sits at
// offset β-K+n when pos, β+K-1-n when not; the smoothness of the line
// itself or of s1 (and s2, or s1 + s2) at the same offsets; the weights
// reconstruction.cuh's WENO-Z.
template <int K, typename T, typename S>
__device__ __forceinline__ T weno_line(int beta, bool pos, const T* v, int st, int nsm,
                                       const T* s1, const T* s2) {
  const VITab<T>& tt = vtab<T>();
  const VITab<S>& ts = vtab<S>();
  const int first = (pos ? beta - K : beta + K - 1) * st;   // cell 0
  const int step = pos ? st : -st;
  auto cell = [&](const T* a, int n) { return a[first + n * step]; };
  T p[K];
  S b[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int o = K - 1 - s;
    T acc = tt.coef[K - 2][s][0] * cell(v, o);
#pragma unroll
    for (int j = 1; j < K; ++j) acc = acc + tt.coef[K - 2][s][j] * cell(v, o + j);
    p[s] = acc;
    if (nsm == kSelf) {
      b[s] = smoothness<K, S>(s, [&](int j) { return cell(v, o + j); });
    } else if (nsm == kSum) {
      b[s] = smoothness<K, S>(s, [&](int j) { return cell(s1, o + j) + cell(s2, o + j); });
    } else {
      S beta_s = smoothness<K, S>(s, [&](int j) { return cell(s1, o + j); });
      if (nsm == kTwo) beta_s = beta_s + smoothness<K, S>(s, [&](int j) { return cell(s2, o + j); });
      b[s] = beta_s;
    }
  }
  return oc::weno_z<K>(p, b, [&](int s) { return ts.gam[K - 2][s]; },
                       [&](int s) { return ts.tau[K - 2][s]; }, ts.eps, ts.rmax);
}

// The upwind reconstruction at buffer K (1: UpwindBiased(1)) of the line
// through v with stride st in a shared box (v at the reconstruction point),
// selected by pos (the advecting velocity > 0); the smoothness lines s1, s2
// share v's stride.
template <typename T, typename S>
__device__ __noinline__ T recon(int K, int beta, bool pos, const T* v, int st, int nsm,
                                const T* s1, const T* s2) {
  switch (K) {
    case 5: return weno_line<5, T, S>(beta, pos, v, st, nsm, s1, s2);
    case 4: return weno_line<4, T, S>(beta, pos, v, st, nsm, s1, s2);
    case 3: return weno_line<3, T, S>(beta, pos, v, st, nsm, s1, s2);
    case 2: return weno_line<2, T, S>(beta, pos, v, st, nsm, s1, s2);
    default: return pos ? v[(beta - 1) * st] : v[beta * st];
  }
}

// The buffer a scheme of buffer Kmax reaches at padded index p along an axis
// (the near-wall cascade on a bounded axis, reconstruction.cuh's
// cascade_level; 1 = UpwindBiased(1)).
__device__ __forceinline__ int cascade(int Kmax, bool bounded, int p, int H, int N, int beta) {
  return bounded ? oc::cascade_level(Kmax, p - H, beta, N) : Kmax;
}

// Centered(4) where `c4` holds, else Centered(2); a(o) reads offset o.
template <typename T, typename F>
__device__ __forceinline__ T sym(bool c4, int beta, F a) {
  const VITab<T>& tt = vtab<T>();
  if (c4)
    return tt.c4[0] * a(beta - 2) + tt.c4[1] * a(beta - 1) + tt.c4[2] * a(beta) +
           tt.c4[3] * a(beta + 1);
  return tt.c2[0] * a(beta - 1) + tt.c2[1] * a(beta);
}

// -- the kernel ------------------------------------------------------------------

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) vi_tendency_kernel(const __grid_constant__ Params<T> P) {
  extern __shared__ __align__(16) unsigned char oc_smem[];
  T* const sm = reinterpret_cast<T*>(oc_smem);
  const oc::Geom& g = P.g;
  const int TY = P.TY, TZ = P.TZ, R = P.R;
  const Layout L(P.TX, TY, TZ, R);
  int t = blockIdx.x;
  const int bz = t % P.tiles_z;
  t /= P.tiles_z;
  const int ty = t % P.tiles_y, tx = t / P.tiles_y;
  const int x0 = tx * P.TX, y0 = ty * TY, z0 = bz * TZ;   // the tile's first output cell
  const int ex = oc::imin(P.TX, g.Nx + P.bx - x0), ey = oc::imin(TY, g.Ny + P.by - y0),
            ez = oc::imin(TZ, g.Nz - z0);
  const int i0 = x0 + g.Hx, j0 = y0 + g.Hy, k0 = z0 + g.Hz;   // padded
  const int PX = g.PX(), PY = g.PY(), PZ = g.PZ();
  const int bxe = ex + 2 * R, bye = ey + 2 * R;           // the box's extents
  T* const U = sm + L.U;
  T* const V = sm + L.V;
  T* const acc_u = sm + L.acc[0];
  T* const acc_v = sm + L.acc[1];
  T* const rows = sm + L.rows;
  T* const work = sm + L.work;

  // box coordinates (A, B, c) and the padded array
  auto inb = [&](int A, int B) {
    return (unsigned)(i0 - R + A) < (unsigned)PX && (unsigned)(j0 - R + B) < (unsigned)PY;
  };
  auto at = [&](int A, int B, int c) { return (A * L.BY + B) * TZ + c; };
  auto row = [&](int r, int B) { return rows[r * L.BY + B]; };
  // metric row r times u or v at (A, B, c), 0 outside the padded array: a
  // shifted read of the plain version's product tensor
  auto mU = [&](int r, int A, int B, int c) { return inb(A, B) ? row(r, B) * U[at(A, B, c)] : T(0); };
  auto mV = [&](int r, int A, int B, int c) { return inb(A, B) ? row(r, B) * V[at(A, B, c)] : T(0); };
  // the padded index of box coordinates
  auto pi = [&](int A) { return i0 - R + A; };
  auto pj = [&](int B) { return j0 - R + B; };

  // staging: u and v over the box, the metric rows over its y
  for (int d = 0; d < 2; ++d) {
    const T* const src = d == 0 ? P.u : P.v;
    oc::stage_box<kInFlight>(d == 0 ? U : V, bxe * bye * ez, bye, ez,
                             [&](int A, int B, int c, int& slot) {
                               slot = at(A, B, c);
                               return inb(A, B) ? src[g.at(pi(A), pj(B), k0 + c)] : T(0);
                             });
  }
  oc::for_rect(kNumRows * bye, bye, [&](int r, int B) {
    const int j = pj(B);
    rows[r * L.BY + B] = (unsigned)j < (unsigned)PY ? P.rows[(long long)r * PY + j] : T(0);
  });
  __syncthreads();

  // the derived fields' region: the box less one cell a side; the output
  // cells (a, b, c) at box (R + a, R + b, c), accumulator slot m
  const int nD = (bxe - 2) * (bye - 2) * ez;
  auto for_derived = [&](auto body) {
    oc::for_box(nD, bye - 2, ez, [&](int a, int b, int c) { body(a + 1, b + 1, c); });
  };
  auto for_cells = [&](auto body) {
    oc::for_box(ex * ey * ez, ey, ez, [&](int a, int b, int c) {
      body(a, b, c, R + a, R + b, (a * TY + b) * TZ + c);
    });
  };
  const int nx_u = g.Nx + P.bx, ny_u = g.Ny, nx_v = g.Nx, ny_v = g.Ny + P.by;
  auto has_u = [&](int a, int b) { return x0 + a < nx_u && y0 + b < ny_u; };
  auto has_v = [&](int a, int b) { return x0 + a < nx_v && y0 + b < ny_v; };

  // v̂ = ℑx(ℑy(Δx v)) / Δx at fcc; û = ℑy(ℑx(Δy u)) / Δy at cfc
  auto iyc = [&](int A, int B, int c) {
    return inb(A, B) ? T(0.5) * (mV(kDxCFC, A, B + 1, c) + mV(kDxCFC, A, B, c)) : T(0);
  };
  auto ixc = [&](int A, int B, int c) {
    return inb(A, B) ? T(0.5) * (mU(kDyFCC, A + 1, B, c) + mU(kDyFCC, A, B, c)) : T(0);
  };
  auto vhat = [&](int A, int B, int c) {
    return (T(0.5) * (iyc(A, B, c) + iyc(A - 1, B, c))) / row(kDxFCC, B);
  };
  auto uhat = [&](int A, int B, int c) {
    return (T(0.5) * (ixc(A, B, c) + ixc(A, B - 1, c))) / row(kDyCFC, B);
  };

  // -- phase 1: the vorticity flux ---------------------------------------------
  {
    T* const zeta = work;
    T* const su = work + L.box;
    T* const sv = work + 2 * L.box;
    const bool weno_vort = P.vort == 2;
    for_derived([&](int A, int B, int c) {
      const int n = at(A, B, c);
      T z = T(0), a1 = T(0), a2 = T(0);
      if (inb(A, B)) {
        // ζ = (δx(Δy v) - δy(Δx u)) / Az at ffc
        const T dxa = mV(kDyCFC, A, B, c) - mV(kDyCFC, A - 1, B, c);
        const T dyb = mU(kDxFCC, A, B, c) - mU(kDxFCC, A, B - 1, c);
        z = (dxa - dyb) / row(kAzFFC, B);
        a1 = T(0.5) * (U[n] + U[at(A, B - 1, c)]);
        a2 = T(0.5) * (V[n] + V[at(A - 1, B, c)]);
      }
      zeta[n] = z;
      if (weno_vort) {
        su[n] = a1;
        sv[n] = a2;
      }
    });
    __syncthreads();
    for_cells([&](int a, int b, int c, int A, int B, int m) {
      const int n = at(A, B, c);
      if (has_u(a, b)) {
        T Gh;
        if (P.vort == 0) {
          const T iyz = T(0.5) * (zeta[at(A, B + 1, c)] + zeta[n]);
          Gh = -((-iyz) * vhat(A, B, c));
        } else if (P.vort == 1) {
          // ℑy(ζ ℑx(Δx v)) / Δx
          auto zvx = [&](int BB) {
            if (!inb(A, BB)) return T(0);
            const T vx = T(0.5) * (mV(kDxCFC, A, BB, c) + mV(kDxCFC, A - 1, BB, c));
            return zeta[at(A, BB, c)] * vx;
          };
          Gh = -((-(T(0.5) * (zvx(B + 1) + zvx(B)))) / row(kDxFCC, B));
        } else {
          const T vh = vhat(A, B, c);
          const int K = cascade(P.kv, P.by, pj(B), g.Hy, g.Ny, 1);
          const T r = recon<T, S>(K, 1, vh > T(0), zeta + n, L.sy, kTwo, su + n, sv + n);
          Gh = -((-vh) * r);
        }
        acc_u[m] = Gh;
      }
      if (has_v(a, b)) {
        T Gh;
        if (P.vort == 0) {
          const T ixz = T(0.5) * (zeta[at(A + 1, B, c)] + zeta[n]);
          Gh = -(ixz * uhat(A, B, c));
        } else if (P.vort == 1) {
          // ℑx(ζ ℑy(Δy u)) / Δy
          auto zuy = [&](int AA) {
            if (!inb(AA, B)) return T(0);
            const T uy = T(0.5) * (mU(kDyFCC, AA, B, c) + mU(kDyFCC, AA, B - 1, c));
            return zeta[at(AA, B, c)] * uy;
          };
          Gh = -((T(0.5) * (zuy(A + 1) + zuy(A))) / row(kDyCFC, B));
        } else {
          const T uh = uhat(A, B, c);
          const int K = cascade(P.kv, P.bx, pi(A), g.Hx, g.Nx, 1);
          const T r = recon<T, S>(K, 1, uh > T(0), zeta + n, L.sx, kTwo, su + n, sv + n);
          Gh = -(uh * r);
        }
        acc_v[m] = Gh;
      }
    });
    __syncthreads();
  }

  // -- phase 2: the Bernoulli head, for u then for v ---------------------------------
  auto hu = [&](int A, int B, int c) {
    const T x = U[at(A, B, c)];
    return (T(0.5) * x) * x;
  };
  auto hv = [&](int A, int B, int c) {
    const T x = V[at(A, B, c)];
    return (T(0.5) * x) * x;
  };
  if (P.upw) {
    T* const f0 = work;
    T* const f1 = work + L.box;
    T* const f2 = work + 2 * L.box;
    // u: δx(u²/2) (f0), ℑx u (f1), δx(v²/2) at ffc (f2)
    for_derived([&](int A, int B, int c) {
      const int n = at(A, B, c);
      const bool in = inb(A, B);
      f0[n] = in ? hu(A + 1, B, c) - hu(A, B, c) : T(0);
      f1[n] = in ? T(0.5) * (U[at(A + 1, B, c)] + U[n]) : T(0);
      f2[n] = in ? hv(A, B, c) - hv(A - 1, B, c) : T(0);
    });
    __syncthreads();
    for_cells([&](int a, int b, int c, int A, int B, int m) {
      if (!has_u(a, b)) return;
      const int i = pi(A), j = pj(B);
      const bool c4y = !P.by || (j >= g.Hy + 2 - 1 && j <= g.Hy + g.Ny - 2);
      const T dKvs = sym<T>(c4y, 1, [&](int o) { return f2[at(A, B + o, c)]; });
      const T uc = U[at(A, B, c)];
      const int K = cascade(3, P.bx, i, g.Hx, g.Nx, 0);
      const int n = at(A, B, c);
      const T dKur = recon<T, S>(K, 0, uc > T(0), f0 + n, L.sx, kOne, f1 + n, nullptr);
      acc_u[m] = acc_u[m] + -((dKur + dKvs) / row(kDxFCC, B));
    });
    __syncthreads();
    // v: δy(v²/2) (f0), ℑy v (f1), δy(u²/2) at ffc (f2)
    for_derived([&](int A, int B, int c) {
      const int n = at(A, B, c);
      const bool in = inb(A, B);
      f0[n] = in ? hv(A, B + 1, c) - hv(A, B, c) : T(0);
      f1[n] = in ? T(0.5) * (V[at(A, B + 1, c)] + V[n]) : T(0);
      f2[n] = in ? hu(A, B, c) - hu(A, B - 1, c) : T(0);
    });
    __syncthreads();
    for_cells([&](int a, int b, int c, int A, int B, int m) {
      if (!has_v(a, b)) return;
      const int i = pi(A), j = pj(B);
      const bool c4x = !P.bx || (i >= g.Hx + 2 - 1 && i <= g.Hx + g.Nx - 2);
      const T dKus = sym<T>(c4x, 1, [&](int o) { return f2[at(A + o, B, c)]; });
      const T vc = V[at(A, B, c)];
      const int K = cascade(3, P.by, j, g.Hy, g.Ny, 0);
      const int n = at(A, B, c);
      const T dKvr = recon<T, S>(K, 0, vc > T(0), f0 + n, L.sy, kOne, f1 + n, nullptr);
      acc_v[m] = acc_v[m] + -((dKvr + dKus) / row(kDyCFC, B));
    });
  } else {
    // K = (ℑx(u²) + ℑy(v²)) / 2 at ccc
    T* const Kf = work;
    for_derived([&](int A, int B, int c) {
      T k = T(0);
      if (inb(A, B)) {
        auto sq = [](T x) { return x * x; };
        const T ixuu = T(0.5) * (sq(U[at(A + 1, B, c)]) + sq(U[at(A, B, c)]));
        const T iyvv = T(0.5) * (sq(V[at(A, B + 1, c)]) + sq(V[at(A, B, c)]));
        k = T(0.5) * (ixuu + iyvv);
      }
      Kf[at(A, B, c)] = k;
    });
    __syncthreads();
    for_cells([&](int a, int b, int c, int A, int B, int m) {
      const T k = Kf[at(A, B, c)];
      if (has_u(a, b))
        acc_u[m] = acc_u[m] + -((k - Kf[at(A - 1, B, c)]) / row(kDxFCC, B));
      if (has_v(a, b))
        acc_v[m] = acc_v[m] + -((k - Kf[at(A, B - 1, c)]) / row(kDyCFC, B));
    });
  }
  __syncthreads();

  // -- phase 3: vertical advection -------------------------------------------------
  // w from (i0 - 2, j0 - 2, k0) over (ex + 3)(ey + 3)(ez + 1), kept through
  // phase 4; W(A, B, c) reads it at box coordinates, c the z face
  T* const wbox = work;
  auto wat = [&](int A, int B, int c) { return ((A - R + 2) * L.wby + (B - R + 2)) * L.wbz + c; };
  auto W = [&](int A, int B, int c) { return wbox[wat(A, B, c)]; };
  auto inz = [&](int c) { return k0 + c < PZ; };
  oc::stage_box<kInFlight>(wbox, (ex + 3) * (ey + 3) * (ez + 1), ey + 3, ez + 1,
                           [&](int a, int b, int c, int& slot) {
                             slot = (a * L.wby + b) * L.wbz + c;
                             const int i = i0 - 2 + a, j = j0 - 2 + b, k = k0 + c;
                             return (unsigned)i < (unsigned)PX && (unsigned)j < (unsigned)PY &&
                                            k < PZ
                                        ? P.w[g.at(i, j, k)]
                                        : T(0);
                           });
  // Az·w at (A, B, face c), 0 outside the padded array
  auto mW = [&](int A, int B, int c) {
    return inb(A, B) && inz(c) ? row(kAzCCF, B) * W(A, B, c) : T(0);
  };
  T* const Fzu = work + L.wsz;
  T* const Fzv = Fzu + L.fz;
  T* const rest = Fzv + L.fz;
  {
    // u and v over the tile's columns, z from k0 - kRz
    T* const ucol = rest;
    T* const vcol = rest + L.col;
    const int cz = TZ + 2 * kRz, ncol = ex * ey * (ez + 2 * kRz);
    for (int d = 0; d < 2; ++d) {
      const T* const src = d == 0 ? P.u : P.v;
      oc::stage_box<kInFlight>(d == 0 ? ucol : vcol, ncol, ey, ez + 2 * kRz,
                               [&](int a, int b, int c, int& slot) {
                                 slot = (a * TY + b) * cz + c;
                                 const int k = k0 - kRz + c;
                                 return (unsigned)k < (unsigned)PZ
                                            ? src[g.at(i0 + a, j0 + b, k)]
                                            : T(0);
                               });
    }
    __syncthreads();
    // each z face flux of u and v once: faces k0 .. k0 + ez
    oc::for_box(ex * ey * (ez + 1), ey, ez + 1, [&](int a, int b, int c) {
      const int A = R + a, B = R + b, f = (a * TY + b) * (TZ + 1) + c;
      const int i = pi(A), j = pj(B), kk = k0 + c;
      const T* const uc = ucol + (a * TY + b) * cz + c + kRz;
      const T* const vc = vcol + (a * TY + b) * cz + c + kRz;
      T fu = T(0), fv = T(0);
      if (inz(c)) {
        if (P.upw) {
          // ŵ = WENO(5).symmetric_x(Az w) at fcf (Centered(4) off the x walls),
          // times the z reconstruction of u; likewise for v
          const int Kz = cascade(3, true, kk, g.Hz, g.Nz, 0);
          if (has_u(a, b)) {
            const bool w4 = !P.bx || (i >= g.Hx + 3 && i <= g.Hx + g.Nx - 3);
            const T wh = sym<T>(w4, 0, [&](int o) { return mW(A + o, B, c); });
            fu = wh * recon<T, S>(Kz, 0, wh > T(0), uc, 1, kSelf, nullptr, nullptr);
          }
          if (has_v(a, b)) {
            const bool w4 = !P.by || (j >= g.Hy + 3 && j <= g.Hy + g.Ny - 3);
            const T wh = sym<T>(w4, 0, [&](int o) { return mW(A, B + o, c); });
            fv = wh * recon<T, S>(Kz, 0, wh > T(0), vc, 1, kSelf, nullptr, nullptr);
          }
        } else {
          // ℑx(Az w)·δz(u)/Δz at fcf; ℑy(Az w)·δz(v)/Δz at cff
          const T ixa = T(0.5) * (mW(A, B, c) + mW(A - 1, B, c));
          fu = ixa * ((uc[0] - uc[-1]) / P.dzf);
          const T iya = T(0.5) * (mW(A, B, c) + mW(A, B - 1, c));
          fv = iya * ((vc[0] - vc[-1]) / P.dzf);
        }
      }
      Fzu[f] = fu;
      Fzv[f] = fv;
    });
    __syncthreads();
  }
  if (P.upw) {
    // δx(Ax u) and δy(Ay v); Φᵟ = u (ℑ(δy(Ay v)) + the WENO-5 of δx(Ax u)
    // with the smoothness of δx(Ax u) + δy(Ay v)), and likewise for v
    T* const dU = rest;
    T* const dV = rest + L.box;
    for_derived([&](int A, int B, int c) {
      const int n = at(A, B, c);
      const bool in = inb(A, B);
      dU[n] = in ? mU(kAxFCC, A + 1, B, c) - mU(kAxFCC, A, B, c) : T(0);
      dV[n] = in ? mV(kAyCFC, A, B + 1, c) - mV(kAyCFC, A, B, c) : T(0);
    });
    __syncthreads();
    for_cells([&](int a, int b, int c, int A, int B, int m) {
      const int i = pi(A), j = pj(B), n = at(A, B, c), f = (a * TY + b) * (TZ + 1) + c;
      if (has_u(a, b)) {
        const T uc = U[n];
        const bool c4x = !P.bx || (i >= g.Hx + 2 && i <= g.Hx + g.Nx - 2);
        const T dvs = sym<T>(c4x, 0, [&](int o) { return dV[at(A + o, B, c)]; });
        const int K = cascade(3, P.bx, i, g.Hx, g.Nx, 0);
        const T rdiv = recon<T, S>(K, 0, uc > T(0), dU + n, L.sx, kSum, dU + n, dV + n);
        const T phi = uc * (dvs + rdiv);
        const T az = Fzu[f + 1] - Fzu[f];
        acc_u[m] = acc_u[m] + -((phi + az) / row(kVFCC, B));
      }
      if (has_v(a, b)) {
        const T vc = V[n];
        const bool c4y = !P.by || (j >= g.Hy + 2 && j <= g.Hy + g.Ny - 2);
        const T dus = sym<T>(c4y, 0, [&](int o) { return dU[at(A, B + o, c)]; });
        const int K = cascade(3, P.by, j, g.Hy, g.Ny, 0);
        const T rdiv = recon<T, S>(K, 0, vc > T(0), dV + n, L.sy, kSum, dU + n, dV + n);
        const T phi = vc * (dus + rdiv);
        const T az = Fzv[f + 1] - Fzv[f];
        acc_v[m] = acc_v[m] + -((phi + az) / row(kVCFC, B));
      }
    });
  } else {
    for_cells([&](int a, int b, int c, int A, int B, int m) {
      const int f = (a * TY + b) * (TZ + 1) + c;
      if (has_u(a, b))
        acc_u[m] = acc_u[m] + -((T(0.5) * (Fzu[f + 1] + Fzu[f])) / row(kAzFCC, B));
      if (has_v(a, b))
        acc_v[m] = acc_v[m] + -((T(0.5) * (Fzv[f + 1] + Fzv[f])) / row(kAzCFC, B));
    });
  }
  __syncthreads();

  // -- phase 4: forces, then the tracers ------------------------------------------------
  T* const phb = work + L.wsz;   // ph from (i0 - 1, j0 - 1, k0)
  auto PH = [&](int A, int B, int c) {
    return phb[((A - R + 1) * (TY + 1) + (B - R + 1)) * TZ + c];
  };
  if (P.with_ph) {
    oc::stage_box<kInFlight>(phb, (ex + 1) * (ey + 1) * ez, ey + 1, ez,
                             [&](int a, int b, int c, int& slot) {
                               slot = (a * (TY + 1) + b) * TZ + c;
                               const int i = i0 - 1 + a, j = j0 - 1 + b;
                               return (unsigned)i < (unsigned)PX && (unsigned)j < (unsigned)PY
                                          ? P.ph[g.at(i, j, k0 + c)]
                                          : T(0);
                             });
    __syncthreads();
  }
  for_cells([&](int a, int b, int c, int A, int B, int m) {
    const long long out = g.at(pi(A), pj(B), k0 + c);
    if (has_u(a, b)) {
      bool have_f = false;
      T Gf = T(0);
      if (P.cor == 1) {
        // FPlane: -f ℑx(ℑy v)
        auto iyv = [&](int AA) {
          return inb(AA, B) ? T(0.5) * (V[at(AA, B + 1, c)] + V[at(AA, B, c)]) : T(0);
        };
        Gf = -((-row(kF, B)) * (T(0.5) * (iyv(A) + iyv(A - 1))));
        have_f = true;
      } else if (P.cor == 2) {
        auto fvx = [&](int BB) {
          if (!inb(A, BB)) return T(0);
          const T vx = T(0.5) * (mV(kDxCFC, A, BB, c) + mV(kDxCFC, A - 1, BB, c));
          return row(kF, BB) * vx;
        };
        Gf = -((-(T(0.5) * (fvx(B + 1) + fvx(B)))) / row(kDxFCC, B));
        have_f = true;
      } else if (P.cor == 3) {
        const T iyf = T(0.5) * (row(kF, B + 1) + row(kF, B));
        Gf = -(((-iyf) * (T(0.5) * (iyc(A, B, c) + iyc(A - 1, B, c)))) / row(kDxFCC, B));
        have_f = true;
      }
      if (P.with_ph) {
        const T Gp = -((PH(A, B, c) - PH(A - 1, B, c)) / row(kDxFCC, B));
        Gf = have_f ? Gf + Gp : Gp;
      }
      P.G[0][out] = acc_u[m] + Gf;
    }
    if (has_v(a, b)) {
      bool have_f = false;
      T Gf = T(0);
      if (P.cor == 1) {
        auto ixu = [&](int BB) {
          return inb(A, BB) ? T(0.5) * (U[at(A + 1, BB, c)] + U[at(A, BB, c)]) : T(0);
        };
        Gf = -(row(kF, B) * (T(0.5) * (ixu(B) + ixu(B - 1))));
        have_f = true;
      } else if (P.cor == 2) {
        auto fuy = [&](int AA) {
          if (!inb(AA, B)) return T(0);
          const T uy = T(0.5) * (mU(kDyFCC, AA, B, c) + mU(kDyFCC, AA, B - 1, c));
          return row(kF, B) * uy;
        };
        Gf = -((T(0.5) * (fuy(A + 1) + fuy(A))) / row(kDyCFC, B));
        have_f = true;
      } else if (P.cor == 3) {
        Gf = -((row(kF, B) * (T(0.5) * (ixc(A, B, c) + ixc(A, B - 1, c)))) / row(kDyCFC, B));
        have_f = true;
      }
      if (P.with_ph) {
        const T Gp = -((PH(A, B, c) - PH(A, B - 1, c)) / row(kDyCFC, B));
        Gf = have_f ? Gf + Gp : Gp;
      }
      P.G[1][out] = acc_v[m] + Gf;
    }
  });

  // tracers: -∇·(𝐯c), each face flux once
  T* const cbox = work + L.wsz;
  T* const Fx = cbox + L.tb;
  T* const Fy = Fx + L.tfx;
  T* const Fz = Fy + L.tfy;
  const int tsx = L.tby * L.tbz, tsy = L.tbz;
  // the selected value at a face (ii, jj, kk) of the tracer box's line with
  // stride st through the cell above the face (cell offset 0)
  auto chat = [&](const T* line, int st, bool pos, int K) {
    if (P.tsch == 0) {
      const VITab<T>& tt = vtab<T>();
      const T lo = line[-st], hi = line[0];
      return tt.c2[0] * (pos ? lo : hi) + tt.c2[1] * (pos ? hi : lo);
    }
    return recon<T, S>(K, 0, pos, line, st, kSelf, nullptr, nullptr);
  };
  for (int tr = 0; tr < P.ntr; ++tr) {
    __syncthreads();   // the previous phase's reads are done
    const T* const src = P.c[tr];
    oc::stage_box<kInFlight>(cbox, (ex + 2 * kRc) * (ey + 2 * kRc) * (ez + 2 * kRz),
                             ey + 2 * kRc, ez + 2 * kRz, [&](int a, int b, int c, int& slot) {
                               slot = (a * L.tby + b) * L.tbz + c;
                               const int i = i0 - kRc + a, j = j0 - kRc + b, k = k0 - kRz + c;
                               return (unsigned)i < (unsigned)PX && (unsigned)j < (unsigned)PY &&
                                              (unsigned)k < (unsigned)PZ
                                          ? src[g.at(i, j, k)]
                                          : T(0);
                             });
    __syncthreads();
    auto cat = [&](int a, int b, int c) { return cbox + ((a + kRc) * L.tby + b + kRc) * L.tbz + c + kRz; };
    oc::for_box((ex + 1) * ey * ez, ey, ez, [&](int a, int b, int c) {
      const int A = R + a, B = R + b;
      T f = T(0);
      if (inb(A, B)) {
        const T vel = U[at(A, B, c)];
        f = (row(kAxFCC, B) * vel) *
            chat(cat(a, b, c), tsx, vel > T(0), cascade(3, P.bx, pi(A), g.Hx, g.Nx, 0));
      }
      Fx[(a * TY + b) * TZ + c] = f;
    });
    oc::for_box(ex * (ey + 1) * ez, ey + 1, ez, [&](int a, int b, int c) {
      const int A = R + a, B = R + b;
      T f = T(0);
      if (inb(A, B)) {
        const T vel = V[at(A, B, c)];
        f = (row(kAyCFC, B) * vel) *
            chat(cat(a, b, c), tsy, vel > T(0), cascade(3, P.by, pj(B), g.Hy, g.Ny, 0));
      }
      Fy[(a * (TY + 1) + b) * TZ + c] = f;
    });
    oc::for_box(ex * ey * (ez + 1), ey, ez + 1, [&](int a, int b, int c) {
      const int A = R + a, B = R + b;
      T f = T(0);
      if (inz(c)) {
        const T vel = W(A, B, c);
        f = (row(kAzCCF, B) * vel) *
            chat(cat(a, b, c), 1, vel > T(0), cascade(3, true, k0 + c, g.Hz, g.Nz, 0));
      }
      Fz[(a * TY + b) * (TZ + 1) + c] = f;
    });
    __syncthreads();
    T* const Gc = P.G[2 + tr];
    for_cells([&](int a, int b, int c, int A, int B, int) {
      if (x0 + a >= g.Nx || y0 + b >= g.Ny) return;
      const int x = (a * TY + b) * TZ + c, y = (a * (TY + 1) + b) * TZ + c,
                z = (a * TY + b) * (TZ + 1) + c;
      const T total = ((Fx[x + TY * TZ] - Fx[x]) + (Fy[y + TZ] - Fy[y])) + (Fz[z + 1] - Fz[z]);
      Gc[g.at(pi(A), pj(B), k0 + c)] = -(total / row(kVCCC, B));
    });
  }
}

// The reach of a configuration's box: the WENO vorticity buffer or the
// WENO-5 reach 3, and one more for the derived fields' own stencils.
int reach_of(int vort, int kv) { return (vort == 2 && kv > 3 ? kv : 3) + 1; }

struct Args {
  const void* const* in;
  void* const* out;
  const void* rows;
  const int* cf;
  double dzf;
  int TX, TY, TZ, threads, blocks, smem;
  cudaStream_t stream;
  int* per_sm;   // non-null: report the blocks an SM holds instead of launching
};

template <typename T, typename S>
int launch(const Args& a) {
  const int* cf = a.cf;
  const oc::Geom g{cf[0], cf[1], cf[2], cf[3], cf[4], cf[5]};
  const int R = reach_of(cf[8], cf[9]);
  const int tiles_y = oc::ceil_div(g.Ny + cf[7], a.TY), tiles_z = oc::ceil_div(g.Nz, a.TZ);
  const long long want = (long long)Layout(a.TX, a.TY, a.TZ, R).total * sizeof(T);
  if (a.smem != want || a.smem > oc::kMaxSmemBytes ||
      a.blocks != oc::ceil_div(g.Nx + cf[6], a.TX) * tiles_y * tiles_z)
    return (int)cudaErrorInvalidValue;
  auto* kernel = vi_tendency_kernel<T, S>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  if (a.per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.per_sm, kernel, a.threads,
                                                              a.smem);
  Params<T> P;
  P.u = (const T*)a.in[0];
  P.v = (const T*)a.in[1];
  P.w = (const T*)a.in[2];
  P.ph = (const T*)a.in[3];
  const int ntr = cf[13];
  for (int t = 0; t < kMaxTracers; ++t) P.c[t] = t < ntr ? (const T*)a.in[4 + t] : nullptr;
  for (int c = 0; c < 2 + kMaxTracers; ++c) P.G[c] = c < 2 + ntr ? (T*)a.out[c] : nullptr;
  P.rows = (const T*)a.rows;
  P.g = g;
  P.bx = cf[6];
  P.by = cf[7];
  P.vort = cf[8];
  P.kv = cf[9];
  P.upw = cf[10];
  P.cor = cf[11];
  P.tsch = cf[12];
  P.ntr = ntr;
  P.with_ph = cf[14];
  P.dzf = (T)a.dzf;
  P.TX = a.TX;
  P.TY = a.TY;
  P.TZ = a.TZ;
  P.R = R;
  P.tiles_y = tiles_y;
  P.tiles_z = tiles_z;
  kernel<<<a.blocks, a.threads, a.smem, a.stream>>>(P);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, int sdtype, const Args& a) {
  if (a.cf[13] < 0 || a.cf[13] > kMaxTracers || a.TX < 1 || a.TY < 1 || a.TZ < 1 ||
      a.threads < 32 || a.threads > kThreads || a.threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32) return launch<float, float>(a);
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64) return launch<float, double>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32) return launch<double, float>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64) return launch<double, double>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Upload the coefficient table (kTableSize float64 values, VITab order) to
// the current device's constant memory, in float64 and rounded to float32.
int oc_vi_set_tables(const double* vals, int n) {
  if (n != kTableSize) return (int)cudaErrorInvalidValue;
  VITab<double> d;
  VITab<float> f;
  double* dd = reinterpret_cast<double*>(&d);
  float* ff = reinterpret_cast<float*>(&f);
  for (int i = 0; i < kTableSize; ++i) {
    dd[i] = vals[i];
    ff[i] = (float)vals[i];
  }
  cudaError_t e = cudaMemcpyToSymbol(kTabD, &d, sizeof(d));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(kTabF, &f, sizeof(f));
}

// dtype / sdtype: OC_FLOAT32 or OC_FLOAT64 for the fields and the WENO
// smoothness. in: host array of device pointers u, v, w, ph (or null),
// tracers; out: Gu, Gv, Gc... (padded, zeroed by the caller); rows: the
// (kNumRows, PY) metric rows; cf: Nx, Ny, Nz, Hx, Hy, Hz, bounded x, bounded
// y, vorticity code, vorticity WENO buffer, upwind code, Coriolis code,
// tracer scheme code, number of tracers, with_ph; dzf: Δz at z faces. TX,
// TY, TZ, threads, blocks, smem: the launch plan of
// kernels/fused_vector_invariant.py launch_plan (the tile,
// ceil((Nx + bx)/TX)·ceil((Ny + by)/TY)·ceil(Nz/TZ) blocks and the dynamic
// shared memory in bytes), refused unless they agree with the tile's
// layout.
int oc_fused_vi_tendency(int dtype, int sdtype, const void* const* in, void* const* out,
                         const void* rows, const int* cf, double dzf, int TX, int TY,
                         int TZ, int threads, int blocks, int smem, void* stream) {
  const Args a{in, out, rows, cf, dzf, TX, TY, TZ, threads, blocks, smem,
               (cudaStream_t)stream, nullptr};
  return dispatch(dtype, sdtype, a);
}

// The blocks of the launch plan's shape that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *per_sm, for a
// configuration whose vorticity code and WENO buffer are vort and kv.
int oc_vi_blocks_per_sm(int dtype, int sdtype, int vort, int kv, int TX, int TY, int TZ,
                        int threads, int smem, int* per_sm) {
  const int cf[15] = {TX, TY, TZ, 1, 1, 1, 0, 0, vort, kv, 0, 0, 0, 0, 0};
  const Args a{nullptr, nullptr, nullptr, cf, 0.0, TX, TY, TZ, threads, 1, smem,
               nullptr, per_sm};
  return dispatch(dtype, sdtype, a);
}

}  // extern "C"
