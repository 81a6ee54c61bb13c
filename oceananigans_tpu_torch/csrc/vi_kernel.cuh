// The fused hydrostatic tendency (#10): vector-invariant momentum plus
// tracers, one template instantiated per deepest buffer KM
// (vi_k3.cu .. vi_k6.cu; with the multi-dimensional stencil vi_md_k3.cu ..
// vi_md_k6.cu), the C entries in fused_vector_invariant.cu.
//
// Replaces oceananigans_tpu/kernels/fused_vector_invariant.py
// _build_phase_call (via build_fused_hydrostatic_tendency, the pallas_call at
// :381) and _build_phase_call_packed (via
// build_fused_hydrostatic_tendency_packed, :739; its packed (y, z) layout is
// a TPU lane view, the same function). From padded u (fcc), v (cfc), w (ccf),
// the hydrostatic pressure anomaly ph (ccc, optional) and up to kBatch
// tracers a launch, halos filled, it computes what the TPU function's four
// phases compute with the operators of
// oceananigans_tpu/advection/vector_invariant.py, coriolis.py and
// advection/fluxes.py div_Uc:
//
//   Gu = -h_u - b_u - z_u - (f×U)ˣ - δx ph/Δx     (fcc; summed ((h+b)+z)+f)
//   Gv = -h_v - b_v - z_v - (f×U)ʸ - δy ph/Δy     (cfc)
//   Gc = -∇·(𝐯c)                                   (ccc)
//
// h: the vorticity flux (enstrophy or energy conserving, or a scheme's
// reconstruction of ζ along the transport, a WENO's smoothness from the
// velocity stencil ℑy u, ℑx v or from ζ itself); b: the Bernoulli head
// (energy conserving K, or a self-upwinded reconstruction with the
// symmetric cross term); z: vertical advection (energy conserving, or a
// scheme's flux divergence with the divergence flux Φᵟ, ONLY_SELF or
// CROSS_AND_SELF). Each reconstruction or symmetric interpolation is a
// *site* of its own family (Centered, UpwindBiased, WENO) and buffer, so a
// per-axis FluxFormAdvection and mixed schemes are sites of different
// codes. Every read of a shifted position outside the padded array is 0, as
// the plain version's zero-filled shifts give, so the two agree on every
// cell they both write: the interiors, and on a bounded x (y) the
// boundary-face row of u (v) at the high wall (on a shard's block of a
// device mesh only where that side is the global grid's wall: elsewhere
// the face is an interior face of the global grid, which the neighbouring
// shard owns). The near-wall order cascade (WENO 11 → 9 → 7 → 5 → 3 →
// UpwindBiased(1), UpwindBiased(2K-1) → ... → UpwindBiased(1), Centered(2K)
// → ... → Centered(2)) is selected on the global index along every bounded
// axis (reconstruction.cuh cascade_level; a shard's block passes its offset
// and the global N), as advection/schemes.py _cascade_select does.
//
// A stretched y or z (x is never stretched: JAX refuses it) changes the
// coefficients and the metrics. Coefficients: along a uniform axis every
// site reads the constant table VITab; along a stretched one its per-slot
// rows, staged with the metric rows: the left- and right-biased ENO
// coefficients of each level, derived on their own (the right ones are not
// the left ones mirrored there), WENO's optimal weights and smoothness
// factors the uniform ones (advection/schemes.py), and a Centered site (and
// each symmetric interpolation) the symmetric rows read without the upwind
// selection, as the plain version evaluates them there. Metrics: on the two
// grid types this kernel takes each metric is a y row times a z column, so
// on a stretched z the rows of Ax, Ay and V hold their horizontal factor
// and a z column of Δz at centres multiplies them (a float64 product equal
// to the grid's own), and δz reads Δz at the faces from a z column.
//
// Bound: operations. For the hydro_row configuration at 512x256x32 the
// function needs about 1,800 floating-point operations per cell
// (chip_smoke.py vi_flop counts them by scheme, buffer and tracer count:
// each derived field, face flux and reconstruction once), 0.114 ms at the
// float32 rate; its compulsory bytes (u, v, w, T in; Gu, Gv, G_T out) take
// 0.045 ms at 3.35 TB/s (H100 SXM).
//
// Design: one launch per kBatch tracers (the first also forms Gu and Gv),
// one block per TX × TY × TZ tile of output cells (the interior plus the
// boundary-face rows; z fastest across threads, a ragged edge masked), and
// no device-memory scratch. The block stages u and v over the tile plus a
// reach R = max(the horizontal sites' buffers, 3) + 1 along x and y (zeros
// outside the padded array), the y rows over that box's y and the z rows
// over the tile's z faces, into shared memory; then it works through the TPU
// function's four phases in turn, each forming its derived fields once over
// the box less one cell a side into one work buffer that the next phase
// reuses (tiles.cuh's loops, strided by the block's thread count, separated
// by __syncthreads()):
//   vorticity   ζ (and ℑy u, ℑx v for the velocity stencil), then per u
//               and v point the vorticity flux into the per-cell sums;
//   Bernoulli   for u, then for v, the ½u² and ½v² differences and ℑx u,
//               ℑy v (or K), and each point's head;
//   vertical    w over the tile plus Rw, u and v over the tile's columns
//               plus Rz along z, each z face flux of u and v once, then
//               δx(Ax u), δy(Ay v) (or their sum), Φᵟ and the differences;
//   forces      Coriolis and −δph (ph staged over the tile plus one), Gu and
//               Gv written; then each tracer staged over the tile plus Rc
//               (Rz along z) and each of its face fluxes formed once, and Gc
//               from the differences.
// The reconstructions are one non-inlined function (recon), the levels up to
// KM inlined in it, reading each stencil's cells in place from a
// shared-memory box by the line's stride; the one-cell levels of a uniform
// axis are inline. Each buffer builds a lean and a full variant: the lean
// one, for uniform axes whose symmetric sites stop at Centered(4) (the
// WENO-5 configurations), holds no per-slot path and two symmetric levels
// (full_variant chooses).
//
// The multi-dimensional stencil (VectorInvariant(multi_dimensional_stencil=
// True), advection/vector_invariant.py _md) filters the upwinded vorticity,
// the Bernoulli head's cross interpolation and reconstruction and the
// ONLY_SELF divergence flux's sum along the other horizontal axis with the
// 5-point centred WENO filter (md_filter). Each filtered value needs the
// unfiltered ones 2 cells either side: the box reach R grows by 2
// (vi_config), and a phase first forms each filtered quantity over the tile
// plus 2 along its filter's axis into an md buffer, (TX + 4)(TY + 4) TZ,
// two a phase, then filters per output cell. Float32 row H takes the 8x8x8
// tile (two blocks an SM; 16x8x8 would need 148,304 B a block). The filter
// lives in a family of its own (MD: a lean and a full variant with the
// filter, instantiated in vi_md_k3.cu .. vi_md_k6.cu for the smoothness in
// the fields' dtype or bfloat16), so that the other variants keep their
// registers: with the filter behind a runtime flag in the full variant
// every full configuration took 168 registers and one block an SM (the
// stretched ocean row's #10 4.29 ms against 3.11), and with it in both
// variants the lean one spilled. Divisions are exact. The tile,
// the block count and the dynamic shared memory come from
// kernels/fused_vector_invariant.py launch_plan; the C entry recomputes and
// checks them. Registers and spills: `-Xptxas -v` (chip_smoke.py prints
// them). No small local array is indexed by a runtime value.
#pragma once

#include "common.cuh"
#include "reconstruction.cuh"
#include "tiles.cuh"

#include <initializer_list>

namespace oc {
namespace vi {

constexpr int kBatch = 32;     // tracers a launch
constexpr int kThreads = 256;  // the most threads a block takes
constexpr int kInFlight = 4;   // staging loads in flight a thread

// Metric rows, as kernels/fused_vector_invariant.py ROWS orders them, then
// the Coriolis rows; on a stretched z kAxFCC, kAyCFC and kV* hold the
// horizontal factor (Δy, Δx, Az).
enum Row {
  kDxFCC, kDxCFC, kDyFCC, kDyCFC, kAzFFC, kAzFCC, kAzCFC, kAzCCF, kAxFCC, kAyCFC,
  kVFCC, kVCFC, kVCCC, kFC, kFF, kOyC, kOzC, kOzF, kNumRows
};
// z columns: Δz at centres and faces, fy(1 − z/R) and fz(1 + 2z/R) at centres.
enum ZCol { kDzC, kDzF, kOyZ, kOzZ, kNumZCols };
// Sites (fused_vector_invariant.py SITES).
enum Site {
  kVortX, kVortY, kKeX, kKeY, kKcX, kKcY, kVz, kVsX, kVsY, kDivX, kDivY, kDcX, kDcY,
  kTx, kTy, kTz, kNumSites
};
// How a WENO's smoothness is formed: from the reconstructed line itself, from
// one line s1, from s1 and s2 summed as indicators, or from the line s1 + s2.
enum Smooth { kSelf, kOne, kTwo, kSum };
// Coriolis codes.
enum Cor { kCorNone, kCorPlane, kCorSphereEnergy, kCorSphereEnstrophy, kCorCartesian,
           kCorNonTraditional };

// The constant table of a uniform axis: WENO buffers k = 2..6 (index k-2),
// zero-padded to 6; Centered(2b) and UpwindBiased(2k-1) for b, k = 1..6.
template <typename R>
struct VITab {
  R coef[5][6][6];      // stencil s, cell j (offset β-1-s+j)
  R fac[5][6][6][6];    // smoothness factor m of stencil s, cell j
  R gam[5][6];          // optimal weights
  R tau[5][6];          // global smoothness indicator coefficients
  R cen[6][12];         // Centered(2b), cells β-b .. β+b-1
  R ub[6][11];          // UpwindBiased(2k-1), cells β-k .. β+k-2 (left-biased)
  R eps, rmax;
};
constexpr int kTableSize = 180 + 1080 + 30 + 30 + 72 + 66 + 2;

// Every translation unit that instantiates the kernel holds its own copy
// (no relocatable device code: internal linkage); set_tables fills this
// unit's.
namespace {

__constant__ VITab<float> kTabF;
__constant__ VITab<double> kTabD;
__constant__ VITab<bf16> kTabB;

template <typename R> __device__ __forceinline__ const VITab<R>& vtab();
template <> __device__ __forceinline__ const VITab<float>& vtab<float>() { return kTabF; }
template <> __device__ __forceinline__ const VITab<double>& vtab<double>() { return kTabD; }
template <> __device__ __forceinline__ const VITab<bf16>& vtab<bf16>() { return kTabB; }

// Upload the tables (kTableSize float64 values, VITab order; the bf16 copy
// rounded to bfloat16 by the caller) to the current device.
int set_tables(const double* vals, const double* vals_bf16) {
  static VITab<double> d;
  static VITab<float> f;
  static VITab<bf16> b;
  double* dd = reinterpret_cast<double*>(&d);
  float* ff = reinterpret_cast<float*>(&f);
  bf16* bb = reinterpret_cast<bf16*>(&b);
  for (int i = 0; i < kTableSize; ++i) {
    dd[i] = vals[i];
    ff[i] = (float)vals[i];
    bb[i] = bf16::from_host(vals_bf16[i]);
  }
  cudaError_t e = cudaMemcpyToSymbol(kTabD, &d, sizeof(d));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(kTabF, &f, sizeof(f));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(kTabB, &b, sizeof(b));
}

}  // namespace

// Per-slot rows of a stretched axis (fused_vector_invariant.py weno_off ..
// cen_off): the first row of a level's left (side 0) or right (side 1)
// coefficients in its entry.
__host__ __device__ __forceinline__ int weno_off(int k, int side) {
  if (k == 1) return side;
  int o = 2;
  for (int i = 2; i < k; ++i) o += 2 * i * i;
  return o + side * k * k;
}
__host__ __device__ __forceinline__ int ub_off(int k, int side) {
  return 2 * (k - 1) * (k - 1) + side * (2 * k - 1);
}
__host__ __device__ __forceinline__ int cen_off(int b) { return b * (b - 1); }

// The int configuration of a launch (fused_vector_invariant.py conf_array).
enum Conf {
  cNx, cNy, cNz, cHx, cHy, cHz, cBx, cBy, cVort, cVortSm, cKe, cVert, cUpw, cCor, cNtr,
  cWithPh, cMomentum, cKM, cR, cRw, cRz, cRc, cNyRows, cNzRows, cZs, cMd, cCx, cCy, cHox,
  cHoy, cGnx, cGny, cHead,
  cFam = cHead, cK = cFam + kNumSites, cBase = cK + kNumSites, cSize = cBase + kNumSites
};

// Element offsets of a block's shared arrays for a TX × TY × TZ tile, the
// reaches and the staged rows; kernels/fused_vector_invariant.py smem_bytes
// computes the same total. Box coordinates (A, B, c) count from
// (i0 - R, j0 - R, k0), the tile's first output cell less the reach.
struct Layout {
  int BY, sx, sy;      // box strides: (TY + 2R)·TZ along A, TZ along B
  int box;             // one box: u, v, or a derived field, (TX + 2R)(TY + 2R) TZ
  int wby, wbz, wsz;   // the w box from (i0 - Rw, j0 - Rw, k0): (TX + 2Rw - 1)(TY + 2Rw - 1)(TZ + 1)
  int col, fz;         // a z column box TX·TY·(TZ + 2Rz); z face fluxes TX·TY·(TZ + 1)
  int phb;             // the ph box from (i0 - 1, j0 - 1, k0): (TX + 1)(TY + 1) TZ
  int tby, tbz, tb;    // a tracer box from (i0 - Rc, j0 - Rc, k0 - Rz)
  int tfx, tfy;        // tracer fluxes (TX + 1)·TY·TZ, TX·(TY + 1)·TZ (and fz)
  int zs;              // the z rows' stride: TZ + 1 faces
  int mdb;             // the multi-dimensional stencil: a reconstruction over the tile
                       // plus 2 along the filtered axis, (TX + 4)(TY + 4) TZ (0 without it)
  int U, V, acc[2], rows, zrows, work, total;

  __host__ __device__ Layout(int TX, int TY, int TZ, int R, int Rw, int Rz, int Rc,
                             int ny_rows, int nz_rows, int md) {
    BY = TY + 2 * R;
    sy = TZ;
    sx = BY * TZ;
    box = align_elems((TX + 2 * R) * BY * TZ);
    wby = TY + 2 * Rw - 1;
    wbz = TZ + 1;
    wsz = align_elems((TX + 2 * Rw - 1) * wby * wbz);
    col = align_elems(TX * TY * (TZ + 2 * Rz));
    fz = align_elems(TX * TY * (TZ + 1));
    phb = align_elems((TX + 1) * (TY + 1) * TZ);
    tby = TY + 2 * Rc;
    tbz = TZ + 2 * Rz;
    tb = align_elems((TX + 2 * Rc) * tby * tbz);
    tfx = align_elems((TX + 1) * TY * TZ);
    tfy = align_elems(TX * (TY + 1) * TZ);
    zs = TZ + 1;
    mdb = md ? align_elems((TX + 4) * (TY + 4) * TZ) : 0;
    const int cells = align_elems(TX * TY * TZ);
    int o = 0;
    U = o; o += box;
    V = o; o += box;
    acc[0] = o; o += cells;
    acc[1] = o; o += cells;
    rows = o; o += align_elems(ny_rows * BY);
    zrows = o; o += align_elems(nz_rows * zs);
    work = o;
    // the work buffer holds, phase by phase: ζ, ℑy u, ℑx v (three boxes);
    // three Bernoulli fields; w, the z face fluxes of u and v, then the u
    // and v columns or the divergence fields; w and ph; w, a tracer box and
    // its fluxes. The multi-dimensional stencil adds two reconstruction
    // buffers to the first three phases.
    const int c2 = 2 * col > 2 * box ? 2 * col : 2 * box;
    int need = 3 * box + 2 * mdb;
    need = need > wsz + 2 * fz + c2 + 2 * mdb ? need : wsz + 2 * fz + c2 + 2 * mdb;
    need = need > wsz + phb ? need : wsz + phb;
    need = need > wsz + tb + tfx + tfy + fz ? need : wsz + tb + tfx + tfy + fz;
    total = o + need;
  }
};

template <typename T>
struct Params {
  const T* u; const T* v; const T* w; const T* ph;
  const T* c[kBatch];
  T* G[2 + kBatch];             // Gu, Gv, Gc... (padded)
  const T* rows;                // ny_rows x PY: the metric and Coriolis rows, then coefficients
  const T* zrows;               // nz_rows x PZ: the z columns, then coefficients
  Geom g;
  int bx, by;                   // a wall on the high x / y side: its face row is output
  int cx, cy;                   // a bounded x / y: the near-wall cascade
  int hox, hoy, gnx, gny;       // the cascade's H - offset and global N (a shard's block)
  int vort, vort_sm;            // 0 enstrophy, 1 energy, 2 a scheme; its smoothness
  int ke, vert, upw;            // a scheme for the Bernoulli head / the vertical term; CROSS_AND_SELF
  int cor;                      // Cor
  int ntr, with_ph, momentum;
  int md;                       // the multi-dimensional stencil
  int zs;                       // stretched z: Ax, Ay, V rows times Δz
  int ny_rows, nz_rows;
  T fx, fy, fz;                 // the Cartesian rotation
  int fam[kNumSites], K[kNumSites], base[kNumSites];
  int TX, TY, TZ, R, Rw, Rz, Rc;
  int tiles_y, tiles_z;
};

// -- reconstructions -------------------------------------------------------------

template <int B>
struct Lv {
  static constexpr int k = B;
};

// f(Lv<b>) for the runtime level b (1 .. KM): the levels are compile-time
// inside f.
template <int KM, typename R, typename F>
__device__ __forceinline__ R at_level(int b, F f) {
  if constexpr (KM > 1) {
    if (b >= KM) return f(Lv<KM>{});
    return at_level<KM - 1, R>(b, f);
  } else {
    return f(Lv<1>{});
  }
}

// β of stencil s in S over the K cells q(0 .. K-1) (the factors from VITab).
template <int K, typename S, typename Q>
__device__ __forceinline__ S smoothness(int s, Q q) {
  const VITab<S>& ts = vtab<S>();
  S v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = (S)q(j);
  return smoothness_indicator<K>([&](int m, int j) { return ts.fac[K - 2][s][m][j]; }, v);
}

// The reconstruction at one level of the line through v with stride st in a
// shared box (v at the reconstruction point), by the advecting velocity's
// sign pos: cell n of the selected orientation sits at offset β-K+n when
// pos, β+K-1-n when not. PS: the coefficients are per-slot rows, cf the
// level's first coefficient of the selected side and cst the rows' stride
// (a stretched axis); else the constant table's (a uniform axis, no
// per-slot load).
template <int K, typename T, typename S, bool PS>
__device__ __forceinline__ T weno_line(int beta, bool pos, const T* v, int st, int nsm,
                                       const T* s1, const T* s2, const T* cf, int cst) {
  const VITab<T>& tt = vtab<T>();
  const VITab<S>& ts = vtab<S>();
  const int first = (pos ? beta - K : beta + K - 1) * st;   // cell 0
  const int step = pos ? st : -st;
  auto cell = [&](const T* a, int n) { return a[first + n * step]; };
  auto coef = [&](int s, int j) {
    if constexpr (PS) return cf[(s * K + j) * cst];
    else return tt.coef[K - 2][s][j];
  };
  T p[K];
  S b[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int o = K - 1 - s;
    T acc = coef(s, 0) * cell(v, o);
#pragma unroll
    for (int j = 1; j < K; ++j) acc = acc + coef(s, j) * cell(v, o + j);
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
  return weno_z<K>(p, b, [&](int s) { return ts.gam[K - 2][s]; },
                   [&](int s) { return ts.tau[K - 2][s]; }, ts.eps, ts.rmax);
}

// UpwindBiased(2K-1) on the selected cells.
template <int K, typename T, bool PS>
__device__ __forceinline__ T ub_line(int beta, bool pos, const T* v, int st, const T* cf,
                                     int cst) {
  const VITab<T>& tt = vtab<T>();
  const int first = (pos ? beta - K : beta + K - 1) * st;
  const int step = pos ? st : -st;
  auto coef = [&](int n) {
    if constexpr (PS) return cf[n * cst];
    else return tt.ub[K - 1][n];
  };
  T acc = coef(0) * v[first];
#pragma unroll
  for (int n = 1; n < 2 * K - 1; ++n) acc = acc + coef(n) * v[first + n * step];
  return acc;
}

// Centered(2K): on a uniform axis the selected cells (the plain version's
// selected-shift evaluation), on a stretched one the symmetric value.
template <int K, typename T, bool PS>
__device__ __forceinline__ T centered_line(int beta, bool pos, const T* v, int st, const T* cf,
                                           int cst) {
  if constexpr (PS) {
    const T* a = v + (beta - K) * st;
    T acc = cf[0] * a[0];
#pragma unroll
    for (int n = 1; n < 2 * K; ++n) acc = acc + cf[n * cst] * a[n * st];
    return acc;
  } else {
    const VITab<T>& tt = vtab<T>();
    const int first = (pos ? beta - K : beta + K - 1) * st;
    const int step = pos ? st : -st;
    T acc = tt.cen[K - 1][0] * v[first];
#pragma unroll
    for (int n = 1; n < 2 * K; ++n) acc = acc + tt.cen[K - 1][n] * v[first + n * step];
    return acc;
  }
}

template <int KM, typename T, typename S, bool PS>
__device__ __forceinline__ T recon_at(int fam, int K, int beta, bool pos, const T* v, int st,
                                      int nsm, const T* s1, const T* s2, const T* cf, int cst) {
  // the rows of a level's coefficients (PS only)
  auto rows_at = [&](int first_row) { return PS ? cf + first_row * cst : cf; };
  return at_level<KM, T>(K, [&](auto L) -> T {
    constexpr int k = decltype(L)::k;
    const int side = pos ? 0 : 1;
    if (fam == kCentered)
      return centered_line<k, T, PS>(beta, pos, v, st, rows_at(cen_off(k)), cst);
    if constexpr (k >= 2) {
      if (fam == kWeno)
        return weno_line<k, T, S, PS>(beta, pos, v, st, nsm, s1, s2,
                                       rows_at(weno_off(k, side)), cst);
    }
    return ub_line<k, T, PS>(beta, pos, v, st,
                              rows_at(fam == kWeno ? weno_off(1, side) : ub_off(k, side)), cst);
  });
}

// The advected value of a site of family fam at level K (already cascaded:
// WENO(2K-1) for K >= 2, else UpwindBiased(1); UpwindBiased(2K-1);
// Centered(2K)); smoothness nsm from s1, s2 (v's stride); cf: null on a
// uniform axis, else the site's entry's first row at the output slot (rows
// cst apart). FULL: the kernel variant of a configuration with a stretched
// axis (without it only the constant-table path is built).
template <int KM, typename T, typename S, bool FULL>
__device__ __noinline__ T recon(int fam, int K, int beta, bool pos, const T* v, int st, int nsm,
                                const T* s1, const T* s2, const T* cf, int cst) {
  if constexpr (FULL) {
    if (cf != nullptr)
      return recon_at<KM, T, S, true>(fam, K, beta, pos, v, st, nsm, s1, s2, cf, cst);
  }
  return recon_at<KM, T, S, false>(fam, K, beta, pos, v, st, nsm, s1, s2, cf, cst);
}

// recon at a site, with the one-cell levels of a uniform axis inline
// (Centered(2) and UpwindBiased(1): a tracer's Centered(2) faces and every
// scheme's near-wall level), so that they cost no call.
template <int KM, typename T, typename S, bool FULL>
__device__ __forceinline__ T advected(int fam, int K, int beta, bool pos, const T* v, int st,
                                      int nsm, const T* s1, const T* s2, const T* cf, int cst) {
  if (K == 1 && (!FULL || cf == nullptr)) {
    const VITab<T>& tt = vtab<T>();
    const T lo = v[(beta - 1) * st], hi = v[beta * st];
    if (fam == kCentered) return tt.cen[0][0] * (pos ? lo : hi) + tt.cen[0][1] * (pos ? hi : lo);
    return tt.ub[0][0] * (pos ? lo : hi);
  }
  return recon<KM, T, S, FULL>(fam, K, beta, pos, v, st, nsm, s1, s2, cf, cst);
}

// The symmetric interpolation of a site of family fam at level L (already
// cascaded): Centered(2b) with b = L for Centered, max(L-1, 1) for
// UpwindBiased and WENO (their advecting-velocity schemes); a(o) reads
// offset o; cf as recon's (the entry's Centered rows). The lean kernel
// (FULL false) holds Centered(2) and Centered(4) alone: building every level
// to KM into its six inlined sites cost the hydro_row's kernel 2% on the
// card, and a loop over the deeper ones 5%.
template <int KM, typename T, bool FULL, typename A>
__device__ __forceinline__ T symm(int fam, int L, int beta, A a, const T* cf, int cst) {
  const int b = fam == kCentered ? L : (L > 1 ? L - 1 : 1);
  return at_level<FULL ? KM : 2, T>(b, [&](auto Lb) -> T {
    constexpr int B = decltype(Lb)::k;
    if constexpr (FULL) {
      if (cf != nullptr) {
        const T* c = cf + cen_off(B) * cst;
        T acc = c[0] * a(beta - B);
#pragma unroll
        for (int n = 1; n < 2 * B; ++n) acc = acc + c[n * cst] * a(beta - B + n);
        return acc;
      }
    }
    const VITab<T>& tt = vtab<T>();
    T acc = tt.cen[B - 1][0] * a(beta - B);
#pragma unroll
    for (int n = 1; n < 2 * B; ++n) acc = acc + tt.cen[B - 1][n] * a(beta - B + n);
    return acc;
  });
}

// The level a site of buffer K takes at padded index p along an axis (the
// near-wall cascade on a bounded axis): reconstruction.cuh's cascade_level,
// the largest B >= 2 with B - β <= kk <= N - B (kk = p - H), else 1, in
// its closed form min(K, kk + β, N - kk), branch-free. On a shard's block H
// is the halo less the block's offset and N the global grid's, so that kk
// is the global index and the cascade counts from the global walls.
__device__ __forceinline__ int level(int K, bool bounded, int p, int H, int N, int beta) {
  if (!bounded) return K;
  const int kk = p - H;
  const int L = imin(K, imin(kk + beta, N - kk));
  return L >= 2 ? L : 1;
}

// -- the multi-dimensional stencil ---------------------------------------------------

// advection/multidimensional.py FILTER_CONSTANTS, the float64 values of the
// plain version's constants: the optimal weights G1, G3, G2P, G2M (3 each),
// the stencils' coefficients A1, A2, A3 (9 each, row-major), σ+, σ-, ε. The
// float table holds them rounded to float32, as the plain version rounds a
// Python constant that meets a float32 tensor.
#define OC_MD_CONSTANTS \
    0.24484385831693256, 0.6229007633587786, 0.13988896611054838, 0.13988896611054838, \
    0.6229007633587786, 0.24484385831693256, 0.042056074766355145, 0.9158878504672898, \
    0.042056074766355145, 0.13432835820895522, 0.7313432835820896, 0.13432835820895522, \
    -0.16031583397703753, 0.7079300025748168, 0.4523858314022207, 0.2269825006437042, \
    0.9333333333333333, -0.16031583397703753, 1.614280835264446, -0.8412633359081502, \
    0.2269825006437042, -0.041666666666666664, 0.08333333333333333, 0.9583333333333334, \
    -0.041666666666666664, 1.0833333333333333, -0.041666666666666664, 0.9583333333333334, \
    0.08333333333333333, -0.041666666666666664, 0.2269825006437042, -0.8412633359081502, \
    1.614280835264446, -0.16031583397703753, 0.9333333333333333, 0.2269825006437042, \
    0.4523858314022207, 0.7079300025748168, -0.16031583397703753, 2.675, 1.675, 1e-08

namespace {

__constant__ double kMdD[42] = {OC_MD_CONSTANTS};
__constant__ float kMdF[42] = {OC_MD_CONSTANTS};

template <typename T> __device__ __forceinline__ T md_const(int i);
template <> __device__ __forceinline__ float md_const<float>(int i) { return kMdF[i]; }
template <> __device__ __forceinline__ double md_const<double>(int i) { return kMdD[i]; }

}  // namespace

enum { kMdG1 = 0, kMdG3 = 3, kMdG2P = 6, kMdG2M = 9, kMdA1 = 12, kMdA2 = 21, kMdA3 = 30,
       kMdSigP = 39, kMdSigM = 40, kMdEps = 41 };

// The 5-point centred WENO filter of multidimensional.py
// centered_weno5_filter at the middle of q[-2 .. 2] (q(o) reads offset o), in
// the plain version's order of operations.
template <typename T, typename Q>
__device__ __forceinline__ T md_filter(Q q) {
  const T m2 = q(-2), m1 = q(-1), c0 = q(0), p1 = q(1), p2 = q(2);
  auto K = [](int i) { return md_const<T>(i); };
  auto beta = [&](T d2, T d1) { return (T)(13.0 / 12.0) * d2 * d2 + T(0.25) * d1 * d1; };
  const T b0 = beta(m2 - T(2) * m1 + c0, m2 - T(4) * m1 + T(3) * c0);
  const T b1 = beta(m1 - T(2) * c0 + p1, m1 - p1);
  const T b2 = beta(c0 - T(2) * p1 + p2, T(3) * c0 - T(4) * p1 + p2);
  const T eps = K(kMdEps);
  const T e0 = b0 + eps, e1 = b1 + eps, e2 = b2 + eps;
  const T i0 = e0 * e0, i1 = e1 * e1, i2 = e2 * e2;
  // the three stencils' values at the points of A (one row a stencil)
  auto recon = [&](int A, int st) {
    const T x0 = st == 0 ? m2 : st == 1 ? m1 : c0;
    const T x1 = st == 0 ? m1 : st == 1 ? c0 : p1;
    const T x2 = st == 0 ? c0 : st == 1 ? p1 : p2;
    return K(A + 3 * st) * x0 + K(A + 3 * st + 1) * x1 + K(A + 3 * st + 2) * x2;
  };
  auto point = [&](int G, int A) {
    const T a0 = K(G) / i0, a1 = K(G + 1) / i1, a2 = K(G + 2) / i2;
    const T s = a0 + a1 + a2;
    return (a0 / s) * recon(A, 0) + (a1 / s) * recon(A, 1) + (a2 / s) * recon(A, 2);
  };
  const T q1 = point(kMdG1, kMdA1), q3 = point(kMdG3, kMdA3);
  const T q2 = K(kMdSigP) * point(kMdG2P, kMdA2) - K(kMdSigM) * point(kMdG2M, kMdA2);
  return q1 / T(6) + T(2) * q2 / T(3) + q3 / T(6);
}

// -- the kernel ------------------------------------------------------------------

// The kernel's body. MD: the multi-dimensional stencil's family
// (vi_md_k3.cu .. vi_md_k6.cu); the other instantiations hold no filter code.
template <typename T, typename S, int KM, bool FULL, bool MD>
__device__ __forceinline__ void vi_tendency(const Params<T>& P) {
  extern __shared__ __align__(16) unsigned char oc_smem[];
  T* const sm = reinterpret_cast<T*>(oc_smem);
  const Geom& g = P.g;
  const int TY = P.TY, TZ = P.TZ, R = P.R, Rw = P.Rw, Rz = P.Rz, Rc = P.Rc;
  const bool md = MD && P.md;
  const Layout L(P.TX, TY, TZ, R, Rw, Rz, Rc, P.ny_rows, P.nz_rows, md);
  int t = blockIdx.x;
  const int bz = t % P.tiles_z;
  t /= P.tiles_z;
  const int ty = t % P.tiles_y, tx = t / P.tiles_y;
  const int x0 = tx * P.TX, y0 = ty * TY, z0 = bz * TZ;   // the tile's first output cell
  const int ex = imin(P.TX, g.Nx + P.bx - x0), ey = imin(TY, g.Ny + P.by - y0),
            ez = imin(TZ, g.Nz - z0);
  const int i0 = x0 + g.Hx, j0 = y0 + g.Hy, k0 = z0 + g.Hz;   // padded
  const int PX = g.PX(), PY = g.PY(), PZ = g.PZ();
  const int bxe = ex + 2 * R, bye = ey + 2 * R;           // the box's extents
  T* const U = sm + L.U;
  T* const V = sm + L.V;
  T* const acc_u = sm + L.acc[0];
  T* const acc_v = sm + L.acc[1];
  T* const rows = sm + L.rows;
  T* const zrows = sm + L.zrows;
  T* const work = sm + L.work;

  // box coordinates (A, B, c) and the padded array
  auto inb = [&](int A, int B) {
    return (unsigned)(i0 - R + A) < (unsigned)PX && (unsigned)(j0 - R + B) < (unsigned)PY;
  };
  auto at = [&](int A, int B, int c) { return (A * L.BY + B) * TZ + c; };
  auto row = [&](int r, int B) { return rows[r * L.BY + B]; };
  auto zcol = [&](int r, int c) { return zrows[r * L.zs + c]; };
  // the metrics that vary with z on a stretched z: the row times Δz
  auto mz = [&](int r, int B, int c) {
    if constexpr (FULL) {
      if (P.zs) return row(r, B) * zcol(kDzC, c);
    }
    return row(r, B);
  };
  // metric row r times u or v at (A, B, c), 0 outside the padded array: a
  // shifted read of the plain version's product tensor
  auto mU = [&](int r, int A, int B, int c) { return inb(A, B) ? row(r, B) * U[at(A, B, c)] : T(0); };
  auto mV = [&](int r, int A, int B, int c) { return inb(A, B) ? row(r, B) * V[at(A, B, c)] : T(0); };
  // the padded index of box coordinates
  auto pi = [&](int A) { return i0 - R + A; };
  auto pj = [&](int B) { return j0 - R + B; };
  // a site's per-slot coefficients at box y B or tile z face c (null on a
  // uniform axis)
  auto cfy = [&](int s, int B) {
    return FULL && P.base[s] >= 0 ? rows + (kNumRows + P.base[s]) * L.BY + B : (const T*)nullptr;
  };
  auto cfz = [&](int s, int c) {
    return FULL && P.base[s] >= 0 ? zrows + (kNumZCols + P.base[s]) * L.zs + c : (const T*)nullptr;
  };

  // staging: u and v over the box, the y rows over its y, the z rows over
  // the tile's faces
  for (int d = 0; d < 2; ++d) {
    const T* const src = d == 0 ? P.u : P.v;
    stage_box<kInFlight>(d == 0 ? U : V, bxe * bye * ez, bye, ez,
                         [&](int A, int B, int c, int& slot) {
                           slot = at(A, B, c);
                           return inb(A, B) ? src[g.at(pi(A), pj(B), k0 + c)] : T(0);
                         });
  }
  for_rect(P.ny_rows * bye, bye, [&](int r, int B) {
    const int j = pj(B);
    rows[r * L.BY + B] = (unsigned)j < (unsigned)PY ? P.rows[(long long)r * PY + j] : T(0);
  });
  for_rect(P.nz_rows * (ez + 1), ez + 1, [&](int r, int c) {
    const int k = k0 + c;
    zrows[r * L.zs + c] = k < PZ ? P.zrows[(long long)r * PZ + k] : T(0);
  });
  __syncthreads();

  // the derived fields' region: the box less one cell a side; the output
  // cells (a, b, c) at box (R + a, R + b, c), accumulator slot m
  const int nD = (bxe - 2) * (bye - 2) * ez;
  auto for_derived = [&](auto body) {
    for_box(nD, bye - 2, ez, [&](int a, int b, int c) { body(a + 1, b + 1, c); });
  };
  auto for_cells = [&](auto body) {
    for_box(ex * ey * ez, ey, ez, [&](int a, int b, int c) {
      body(a, b, c, R + a, R + b, (a * TY + b) * TZ + c);
    });
  };
  const int nx_u = g.Nx + P.bx, ny_u = g.Ny, nx_v = g.Nx, ny_v = g.Ny + P.by;
  auto has_u = [&](int a, int b) { return x0 + a < nx_u && y0 + b < ny_u; };
  auto has_v = [&](int a, int b) { return x0 + a < nx_v && y0 + b < ny_v; };
  const int KVx = P.K[kVortX], KVy = P.K[kVortY];

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

  // the multi-dimensional stencil: a filtered reconstruction is formed
  // unfiltered over the tile plus 2 along the axis it is filtered on (0
  // outside the padded array, as the plain version's shifts read), into an
  // md buffer at (a + 2, b + 2, c), then filtered per output cell
  auto mdat = [&](int a, int b, int c) { return ((a + 2) * (TY + 4) + b + 2) * TZ + c; };
  auto for_md_x = [&](auto body) {
    for_box((ex + 4) * ey * ez, ey, ez, [&](int a, int b, int c) { body(a - 2, b, c); });
  };
  auto for_md_y = [&](auto body) {
    for_box(ex * (ey + 4) * ez, ey + 4, ez, [&](int a, int b, int c) { body(a, b - 2, c); });
  };
  auto filt_x = [&](const T* q, int a, int b, int c) {
    return md_filter<T>([&](int o) { return q[mdat(a + o, b, c)]; });
  };
  auto filt_y = [&](const T* q, int a, int b, int c) {
    return md_filter<T>([&](int o) { return q[mdat(a, b + o, c)]; });
  };

  if (P.momentum) {
    // -- phase 1: the vorticity flux ---------------------------------------------
    T* const zeta = work;
    T* const su = work + L.box;
    T* const sv = work + 2 * L.box;
    T* const mdx = work + 3 * L.box;   // md buffers of phases 1 and 2
    T* const mdy = mdx + L.mdb;
    const bool two = P.vort == 2 && P.vort_sm == kTwo;
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
      if (two) {
        su[n] = a1;
        sv[n] = a2;
      }
    });
    __syncthreads();
    // the reconstruction of ζ along y at a u point (along x at a v point),
    // over the tile plus 2 with the stencil; the per-cell path below keeps
    // its own expression
    auto vort_u = [&](int A, int B, int c) {
      const int n = at(A, B, c);
      const int K = level(KVy, P.cy, pj(B), P.hoy, P.gny, 1);
      return advected<KM, T, S, FULL>(P.fam[kVortY], K, 1, vhat(A, B, c) > T(0), zeta + n, L.sy,
                                      P.vort_sm, su + n, sv + n, cfy(kVortY, B), L.BY);
    };
    auto vort_v = [&](int A, int B, int c) {
      const int n = at(A, B, c);
      const int K = level(KVx, P.cx, pi(A), P.hox, P.gnx, 1);
      return advected<KM, T, S, FULL>(P.fam[kVortX], K, 1, uhat(A, B, c) > T(0), zeta + n, L.sx,
                                      P.vort_sm, su + n, sv + n, nullptr, 0);
    };
    const bool md1 = md && P.vort == 2;
    if (md1) {
      // u's filtered along x, v's along y
      for_md_x([&](int a, int b, int c) {
        const int A = R + a, B = R + b;
        mdx[mdat(a, b, c)] = inb(A, B) ? vort_u(A, B, c) : T(0);
      });
      for_md_y([&](int a, int b, int c) {
        const int A = R + a, B = R + b;
        mdy[mdat(a, b, c)] = inb(A, B) ? vort_v(A, B, c) : T(0);
      });
      __syncthreads();
    }
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
          T r;
          if (md1) {
            r = filt_x(mdx, a, b, c);
          } else {
            const int K = level(KVy, P.cy, pj(B), P.hoy, P.gny, 1);
            r = advected<KM, T, S, FULL>(P.fam[kVortY], K, 1, vh > T(0), zeta + n, L.sy,
                                         P.vort_sm, su + n, sv + n, cfy(kVortY, B), L.BY);
          }
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
          T r;
          if (md1) {
            r = filt_y(mdy, a, b, c);
          } else {
            const int K = level(KVx, P.cx, pi(A), P.hox, P.gnx, 1);
            r = advected<KM, T, S, FULL>(P.fam[kVortX], K, 1, uh > T(0), zeta + n, L.sx,
                                         P.vort_sm, su + n, sv + n, nullptr, 0);
          }
          Gh = -(uh * r);
        }
        acc_v[m] = Gh;
      }
    });
    __syncthreads();

    // -- phase 2: the Bernoulli head, for u then for v ---------------------------------
    auto hu = [&](int A, int B, int c) {
      const T x = U[at(A, B, c)];
      return (T(0.5) * x) * x;
    };
    auto hv = [&](int A, int B, int c) {
      const T x = V[at(A, B, c)];
      return (T(0.5) * x) * x;
    };
    if (P.ke) {
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
      // the cross interpolation of δx(v²/2) along y (filtered along x) and
      // the reconstruction of δx(u²/2) along x (filtered along y)
      auto ke_u_sym = [&](int A, int B, int c) {
        return symm<KM, T, FULL>(P.fam[kKcY], level(P.K[kKcY], P.cy, pj(B), P.hoy, P.gny, 1), 1,
                                 [&](int o) { return f2[at(A, B + o, c)]; }, cfy(kKcY, B), L.BY);
      };
      auto ke_u_rec = [&](int A, int B, int c) {
        const int n = at(A, B, c);
        const int K = level(P.K[kKeX], P.cx, pi(A), P.hox, P.gnx, 0);
        return advected<KM, T, S, FULL>(P.fam[kKeX], K, 0, U[n] > T(0), f0 + n, L.sx, kOne, f1 + n,
                                        nullptr, nullptr, 0);
      };
      if (md) {
        for_md_x([&](int a, int b, int c) {
          const int A = R + a, B = R + b;
          mdx[mdat(a, b, c)] = inb(A, B) ? ke_u_sym(A, B, c) : T(0);
        });
        for_md_y([&](int a, int b, int c) {
          const int A = R + a, B = R + b;
          mdy[mdat(a, b, c)] = inb(A, B) ? ke_u_rec(A, B, c) : T(0);
        });
        __syncthreads();
      }
      for_cells([&](int a, int b, int c, int A, int B, int m) {
        if (!has_u(a, b)) return;
        const int i = pi(A), j = pj(B), n = at(A, B, c);
        const T dKvs = md ? filt_x(mdx, a, b, c)
                          : symm<KM, T, FULL>(P.fam[kKcY],
                                              level(P.K[kKcY], P.cy, j, P.hoy, P.gny, 1), 1,
                                              [&](int o) { return f2[at(A, B + o, c)]; },
                                              cfy(kKcY, B), L.BY);
        const T uc = U[n];
        const int K = level(P.K[kKeX], P.cx, i, P.hox, P.gnx, 0);
        const T dKur = md ? filt_y(mdy, a, b, c)
                          : advected<KM, T, S, FULL>(P.fam[kKeX], K, 0, uc > T(0), f0 + n, L.sx,
                                                     kOne, f1 + n, nullptr, nullptr, 0);
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
      // the cross interpolation of δy(u²/2) along x (filtered along y) and
      // the reconstruction of δy(v²/2) along y (filtered along x)
      auto ke_v_sym = [&](int A, int B, int c) {
        return symm<KM, T, FULL>(P.fam[kKcX], level(P.K[kKcX], P.cx, pi(A), P.hox, P.gnx, 1), 1,
                                 [&](int o) { return f2[at(A + o, B, c)]; }, nullptr, 0);
      };
      auto ke_v_rec = [&](int A, int B, int c) {
        const int n = at(A, B, c);
        const int K = level(P.K[kKeY], P.cy, pj(B), P.hoy, P.gny, 0);
        return advected<KM, T, S, FULL>(P.fam[kKeY], K, 0, V[n] > T(0), f0 + n, L.sy, kOne, f1 + n,
                                        nullptr, cfy(kKeY, B), L.BY);
      };
      if (md) {
        for_md_y([&](int a, int b, int c) {
          const int A = R + a, B = R + b;
          mdy[mdat(a, b, c)] = inb(A, B) ? ke_v_sym(A, B, c) : T(0);
        });
        for_md_x([&](int a, int b, int c) {
          const int A = R + a, B = R + b;
          mdx[mdat(a, b, c)] = inb(A, B) ? ke_v_rec(A, B, c) : T(0);
        });
        __syncthreads();
      }
      for_cells([&](int a, int b, int c, int A, int B, int m) {
        if (!has_v(a, b)) return;
        const int i = pi(A), j = pj(B), n = at(A, B, c);
        const T dKus = md ? filt_y(mdy, a, b, c)
                          : symm<KM, T, FULL>(P.fam[kKcX],
                                              level(P.K[kKcX], P.cx, i, P.hox, P.gnx, 1), 1,
                                              [&](int o) { return f2[at(A + o, B, c)]; },
                                              nullptr, 0);
        const T vc = V[n];
        const int K = level(P.K[kKeY], P.cy, j, P.hoy, P.gny, 0);
        const T dKvr = md ? filt_x(mdx, a, b, c)
                          : advected<KM, T, S, FULL>(P.fam[kKeY], K, 0, vc > T(0), f0 + n, L.sy,
                                                     kOne, f1 + n, nullptr, cfy(kKeY, B), L.BY);
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
  }

  // -- phase 3: vertical advection -------------------------------------------------
  // w from (i0 - Rw, j0 - Rw, k0) over (ex + 2Rw - 1)(ey + 2Rw - 1)(ez + 1),
  // kept through phase 4; W(A, B, c) reads it at box coordinates, c the z face
  T* const wbox = work;
  auto wat = [&](int A, int B, int c) {
    return ((A - R + Rw) * L.wby + (B - R + Rw)) * L.wbz + c;
  };
  auto W = [&](int A, int B, int c) { return wbox[wat(A, B, c)]; };
  auto inz = [&](int c) { return k0 + c < PZ; };
  stage_box<kInFlight>(wbox, (ex + 2 * Rw - 1) * (ey + 2 * Rw - 1) * (ez + 1),
                       ey + 2 * Rw - 1, ez + 1, [&](int a, int b, int c, int& slot) {
                         slot = (a * L.wby + b) * L.wbz + c;
                         const int i = i0 - Rw + a, j = j0 - Rw + b, k = k0 + c;
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
  if (P.momentum) {
    {
      // u and v over the tile's columns, z from k0 - Rz
      T* const ucol = rest;
      T* const vcol = rest + L.col;
      const int cz = TZ + 2 * Rz, ncol = ex * ey * (ez + 2 * Rz);
      for (int d = 0; d < 2; ++d) {
        const T* const src = d == 0 ? P.u : P.v;
        stage_box<kInFlight>(d == 0 ? ucol : vcol, ncol, ey, ez + 2 * Rz,
                             [&](int a, int b, int c, int& slot) {
                               slot = (a * TY + b) * cz + c;
                               const int k = k0 - Rz + c;
                               return (unsigned)k < (unsigned)PZ ? src[g.at(i0 + a, j0 + b, k)]
                                                                 : T(0);
                             });
      }
      __syncthreads();
      // each z face flux of u and v once: faces k0 .. k0 + ez
      for_box(ex * ey * (ez + 1), ey, ez + 1, [&](int a, int b, int c) {
        const int A = R + a, B = R + b, f = (a * TY + b) * (TZ + 1) + c;
        const int i = pi(A), j = pj(B), kk = k0 + c;
        const T* const uc = ucol + (a * TY + b) * cz + c + Rz;
        const T* const vc = vcol + (a * TY + b) * cz + c + Rz;
        T fu = T(0), fv = T(0);
        if (inz(c)) {
          if (P.vert) {
            // ŵ = the vertical scheme's symmetric Az w at fcf (cff), times
            // the z reconstruction of u (v)
            const int Kz = level(P.K[kVz], true, kk, g.Hz, g.Nz, 0);
            const T* const cz_ = cfz(kVz, c);
            if (has_u(a, b)) {
              const T wh = symm<KM, T, FULL>(P.fam[kVsX], level(P.K[kVsX], P.cx, i, P.hox, P.gnx, 0), 0,
                                       [&](int o) { return mW(A + o, B, c); }, nullptr, 0);
              fu = wh * advected<KM, T, S, FULL>(P.fam[kVz], Kz, 0, wh > T(0), uc, 1, kSelf, nullptr,
                                        nullptr, cz_, L.zs);
            }
            if (has_v(a, b)) {
              const T wh = symm<KM, T, FULL>(P.fam[kVsY], level(P.K[kVsY], P.cy, j, P.hoy, P.gny, 0), 0,
                                       [&](int o) { return mW(A, B + o, c); }, cfy(kVsY, B),
                                       L.BY);
              fv = wh * advected<KM, T, S, FULL>(P.fam[kVz], Kz, 0, wh > T(0), vc, 1, kSelf, nullptr,
                                        nullptr, cz_, L.zs);
            }
          } else {
            // ℑx(Az w)·δz(u)/Δz at fcf; ℑy(Az w)·δz(v)/Δz at cff
            const T dzf = zcol(kDzF, c);
            const T ixa = T(0.5) * (mW(A, B, c) + mW(A - 1, B, c));
            fu = ixa * ((uc[0] - uc[-1]) / dzf);
            const T iya = T(0.5) * (mW(A, B, c) + mW(A, B - 1, c));
            fv = iya * ((vc[0] - vc[-1]) / dzf);
          }
        }
        Fzu[f] = fu;
        Fzv[f] = fv;
      });
      __syncthreads();
    }
    if (P.vert) {
      // δx(Ax u) and δy(Ay v) (ONLY_SELF), or their sum (CROSS_AND_SELF);
      // Φᵟ = u (the cross interpolation of δy(Ay v) + the reconstruction
      // of δx(Ax u) with the smoothness of δx(Ax u) + δy(Ay v)), or u times
      // the reconstruction of the sum; likewise for v
      T* const dU = rest;
      T* const dV = rest + L.box;
      const bool cross_self = P.upw;
      for_derived([&](int A, int B, int c) {
        const int n = at(A, B, c);
        const bool in = inb(A, B);
        const T Axu1 = inb(A + 1, B) ? mz(kAxFCC, B, c) * U[at(A + 1, B, c)] : T(0);
        const T Axu0 = in ? mz(kAxFCC, B, c) * U[n] : T(0);
        const T Ayv1 = inb(A, B + 1) ? mz(kAyCFC, B + 1, c) * V[at(A, B + 1, c)] : T(0);
        const T Ayv0 = in ? mz(kAyCFC, B, c) * V[n] : T(0);
        const T du = in ? Axu1 - Axu0 : T(0);
        const T dv = in ? Ayv1 - Ayv0 : T(0);
        if (cross_self) {
          dU[n] = du + dv;
        } else {
          dU[n] = du;
          dV[n] = dv;
        }
      });
      __syncthreads();
      // ONLY_SELF: the cross interpolation plus the reconstruction of the
      // divergence at a u point (filtered along y) and at a v point
      // (filtered along x)
      auto div_u = [&](int A, int B, int c) {
        const int n = at(A, B, c), i = pi(A);
        const T dvs = symm<KM, T, FULL>(P.fam[kDcX], level(P.K[kDcX], P.cx, i, P.hox, P.gnx, 0), 0,
                                        [&](int o) { return dV[at(A + o, B, c)]; }, nullptr, 0);
        const T rdiv = advected<KM, T, S, FULL>(P.fam[kDivX],
                                                level(P.K[kDivX], P.cx, i, P.hox, P.gnx, 0), 0,
                                                U[n] > T(0), dU + n, L.sx, kSum, dU + n, dV + n,
                                                nullptr, 0);
        return dvs + rdiv;
      };
      auto div_v = [&](int A, int B, int c) {
        const int n = at(A, B, c), j = pj(B);
        const T dus = symm<KM, T, FULL>(P.fam[kDcY], level(P.K[kDcY], P.cy, j, P.hoy, P.gny, 0), 0,
                                        [&](int o) { return dU[at(A, B + o, c)]; }, cfy(kDcY, B),
                                        L.BY);
        const T rdiv = advected<KM, T, S, FULL>(P.fam[kDivY],
                                                level(P.K[kDivY], P.cy, j, P.hoy, P.gny, 0), 0,
                                                V[n] > T(0), dV + n, L.sy, kSum, dU + n, dV + n,
                                                cfy(kDivY, B), L.BY);
        return dus + rdiv;
      };
      const bool md3 = md && !cross_self;
      T* const mdx3 = rest + (L.col > L.box ? 2 * L.col : 2 * L.box);
      T* const mdy3 = mdx3 + L.mdb;
      if (md3) {
        for_md_y([&](int a, int b, int c) {
          const int A = R + a, B = R + b;
          mdy3[mdat(a, b, c)] = inb(A, B) ? div_u(A, B, c) : T(0);
        });
        for_md_x([&](int a, int b, int c) {
          const int A = R + a, B = R + b;
          mdx3[mdat(a, b, c)] = inb(A, B) ? div_v(A, B, c) : T(0);
        });
        __syncthreads();
      }
      for_cells([&](int a, int b, int c, int A, int B, int m) {
        const int i = pi(A), j = pj(B), n = at(A, B, c), f = (a * TY + b) * (TZ + 1) + c;
        if (has_u(a, b)) {
          const T uc = U[n];
          const int K = level(P.K[kDivX], P.cx, i, P.hox, P.gnx, 0);
          T phi;
          if (cross_self) {
            phi = uc * advected<KM, T, S, FULL>(P.fam[kDivX], K, 0, uc > T(0), dU + n, L.sx, kSelf,
                                       nullptr, nullptr, nullptr, 0);
          } else if (md3) {
            phi = uc * filt_y(mdy3, a, b, c);
          } else {
            const T dvs = symm<KM, T, FULL>(P.fam[kDcX], level(P.K[kDcX], P.cx, i, P.hox, P.gnx, 0), 0,
                                      [&](int o) { return dV[at(A + o, B, c)]; }, nullptr, 0);
            const T rdiv = advected<KM, T, S, FULL>(P.fam[kDivX], K, 0, uc > T(0), dU + n, L.sx, kSum,
                                           dU + n, dV + n, nullptr, 0);
            phi = uc * (dvs + rdiv);
          }
          const T az = Fzu[f + 1] - Fzu[f];
          acc_u[m] = acc_u[m] + -((phi + az) / mz(kVFCC, B, c));
        }
        if (has_v(a, b)) {
          const T vc = V[n];
          const int K = level(P.K[kDivY], P.cy, j, P.hoy, P.gny, 0);
          T phi;
          if (cross_self) {
            phi = vc * advected<KM, T, S, FULL>(P.fam[kDivY], K, 0, vc > T(0), dU + n, L.sy, kSelf,
                                       nullptr, nullptr, cfy(kDivY, B), L.BY);
          } else if (md3) {
            phi = vc * filt_x(mdx3, a, b, c);
          } else {
            const T dus = symm<KM, T, FULL>(P.fam[kDcY], level(P.K[kDcY], P.cy, j, P.hoy, P.gny, 0), 0,
                                      [&](int o) { return dU[at(A, B + o, c)]; }, cfy(kDcY, B),
                                      L.BY);
            const T rdiv = advected<KM, T, S, FULL>(P.fam[kDivY], K, 0, vc > T(0), dV + n, L.sy, kSum,
                                           dU + n, dV + n, cfy(kDivY, B), L.BY);
            phi = vc * (dus + rdiv);
          }
          const T az = Fzv[f + 1] - Fzv[f];
          acc_v[m] = acc_v[m] + -((phi + az) / mz(kVCFC, B, c));
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

    // -- phase 4: forces ---------------------------------------------------------------
    T* const phb = work + L.wsz;   // ph from (i0 - 1, j0 - 1, k0)
    auto PH = [&](int A, int B, int c) {
      return phb[((A - R + 1) * (TY + 1) + (B - R + 1)) * TZ + c];
    };
    if (P.with_ph) {
      stage_box<kInFlight>(phb, (ex + 1) * (ey + 1) * ez, ey + 1, ez,
                           [&](int a, int b, int c, int& slot) {
                             slot = (a * (TY + 1) + b) * TZ + c;
                             const int i = i0 - 1 + a, j = j0 - 1 + b;
                             return (unsigned)i < (unsigned)PX && (unsigned)j < (unsigned)PY
                                        ? P.ph[g.at(i, j, k0 + c)]
                                        : T(0);
                           });
      __syncthreads();
    }
    // 4-point means: v at fcc, u at cfc, w (at centres) at fcc and cfc
    auto iyv = [&](int AA, int B, int c) {
      return inb(AA, B) ? T(0.5) * (V[at(AA, B + 1, c)] + V[at(AA, B, c)]) : T(0);
    };
    auto ixu = [&](int A, int BB, int c) {
      return inb(A, BB) ? T(0.5) * (U[at(A + 1, BB, c)] + U[at(A, BB, c)]) : T(0);
    };
    auto izw = [&](int AA, int BB, int c) {
      return inb(AA, BB) ? T(0.5) * (W(AA, BB, c + 1) + W(AA, BB, c)) : T(0);
    };
    for_cells([&](int a, int b, int c, int A, int B, int m) {
      const long long out = g.at(pi(A), pj(B), k0 + c);
      if (has_u(a, b)) {
        bool have_f = true;
        T Gf = T(0);
        auto v_fcc = [&]() { return T(0.5) * (iyv(A, B, c) + iyv(A - 1, B, c)); };
        if (P.cor == kCorPlane) {
          // -f ℑx(ℑy v), f at the y centres
          Gf = -((-row(kFC, B)) * v_fcc());
        } else if (P.cor == kCorSphereEnergy) {
          auto fvx = [&](int BB) {
            if (!inb(A, BB)) return T(0);
            const T vx = T(0.5) * (mV(kDxCFC, A, BB, c) + mV(kDxCFC, A - 1, BB, c));
            return row(kFF, BB) * vx;
          };
          Gf = -((-(T(0.5) * (fvx(B + 1) + fvx(B)))) / row(kDxFCC, B));
        } else if (P.cor == kCorSphereEnstrophy) {
          const T iyf = T(0.5) * (row(kFF, B + 1) + row(kFF, B));
          Gf = -(((-iyf) * (T(0.5) * (iyc(A, B, c) + iyc(A - 1, B, c)))) / row(kDxFCC, B));
        } else if (P.cor == kCorCartesian) {
          const T w_fcc = T(0.5) * (izw(A, B, c) + izw(A - 1, B, c));
          Gf = -(P.fy * w_fcc - P.fz * v_fcc());
        } else if (P.cor == kCorNonTraditional) {
          // ℑx(2Ωʸ ℑz w − 2Ωᶻ ℑy v), the product at the cell centres
          auto prod = [&](int AA) {
            if (!inb(AA, B)) return T(0);
            const T Oy = zcol(kOyZ, c) + row(kOyC, B), Oz = zcol(kOzZ, c) + row(kOzC, B);
            return Oy * izw(AA, B, c) - Oz * iyv(AA, B, c);
          };
          Gf = -(T(0.5) * (prod(A) + prod(A - 1)));
        } else {
          have_f = false;
        }
        if (P.with_ph) {
          const T Gp = -((PH(A, B, c) - PH(A - 1, B, c)) / row(kDxFCC, B));
          Gf = have_f ? Gf + Gp : Gp;
        }
        P.G[0][out] = acc_u[m] + Gf;
      }
      if (has_v(a, b)) {
        bool have_f = true;
        T Gf = T(0);
        auto u_cfc = [&]() { return T(0.5) * (ixu(A, B, c) + ixu(A, B - 1, c)); };
        if (P.cor == kCorPlane) {
          Gf = -(row(kFF, B) * u_cfc());
        } else if (P.cor == kCorSphereEnergy) {
          auto fuy = [&](int AA) {
            if (!inb(AA, B)) return T(0);
            const T uy = T(0.5) * (mU(kDyFCC, AA, B, c) + mU(kDyFCC, AA, B - 1, c));
            return row(kFF, B) * uy;
          };
          Gf = -((T(0.5) * (fuy(A + 1) + fuy(A))) / row(kDyCFC, B));
        } else if (P.cor == kCorSphereEnstrophy) {
          Gf = -((row(kFF, B) * (T(0.5) * (ixc(A, B, c) + ixc(A, B - 1, c)))) / row(kDyCFC, B));
        } else if (P.cor == kCorCartesian) {
          const T w_cfc = T(0.5) * (izw(A, B, c) + izw(A, B - 1, c));
          Gf = -(P.fz * u_cfc() - P.fx * w_cfc);
        } else if (P.cor == kCorNonTraditional) {
          Gf = -((zcol(kOzZ, c) + row(kOzF, B)) * u_cfc());
        } else {
          have_f = false;
        }
        if (P.with_ph) {
          const T Gp = -((PH(A, B, c) - PH(A, B - 1, c)) / row(kDyCFC, B));
          Gf = have_f ? Gf + Gp : Gp;
        }
        P.G[1][out] = acc_v[m] + Gf;
      }
    });
  }

  // -- the tracers: -∇·(𝐯c), each face flux once -----------------------------------
  T* const cbox = work + L.wsz;
  T* const Fx = cbox + L.tb;
  T* const Fy = Fx + L.tfx;
  T* const Fz = Fy + L.tfy;
  const int tsx = L.tby * L.tbz, tsy = L.tbz;
  for (int tr = 0; tr < P.ntr; ++tr) {
    __syncthreads();   // the previous phase's reads are done
    const T* const src = P.c[tr];
    stage_box<kInFlight>(cbox, (ex + 2 * Rc) * (ey + 2 * Rc) * (ez + 2 * Rz), ey + 2 * Rc,
                         ez + 2 * Rz, [&](int a, int b, int c, int& slot) {
                           slot = (a * L.tby + b) * L.tbz + c;
                           const int i = i0 - Rc + a, j = j0 - Rc + b, k = k0 - Rz + c;
                           return (unsigned)i < (unsigned)PX && (unsigned)j < (unsigned)PY &&
                                          (unsigned)k < (unsigned)PZ
                                      ? src[g.at(i, j, k)]
                                      : T(0);
                         });
    __syncthreads();
    // the cell above the face (ii, jj, kk): the line's offset 0
    auto cat = [&](int a, int b, int c) { return cbox + ((a + Rc) * L.tby + b + Rc) * L.tbz + c + Rz; };
    for_box((ex + 1) * ey * ez, ey, ez, [&](int a, int b, int c) {
      const int A = R + a, B = R + b;
      T f = T(0);
      if (inb(A, B)) {
        const T vel = U[at(A, B, c)];
        const int K = level(P.K[kTx], P.cx, pi(A), P.hox, P.gnx, 0);
        f = (mz(kAxFCC, B, c) * vel) * advected<KM, T, S, FULL>(P.fam[kTx], K, 0, vel > T(0), cat(a, b, c),
                                                       tsx, kSelf, nullptr, nullptr, nullptr, 0);
      }
      Fx[(a * TY + b) * TZ + c] = f;
    });
    for_box(ex * (ey + 1) * ez, ey + 1, ez, [&](int a, int b, int c) {
      const int A = R + a, B = R + b;
      T f = T(0);
      if (inb(A, B)) {
        const T vel = V[at(A, B, c)];
        const int K = level(P.K[kTy], P.cy, pj(B), P.hoy, P.gny, 0);
        f = (mz(kAyCFC, B, c) * vel) * advected<KM, T, S, FULL>(P.fam[kTy], K, 0, vel > T(0), cat(a, b, c),
                                                       tsy, kSelf, nullptr, nullptr,
                                                       cfy(kTy, B), L.BY);
      }
      Fy[(a * (TY + 1) + b) * TZ + c] = f;
    });
    for_box(ex * ey * (ez + 1), ey, ez + 1, [&](int a, int b, int c) {
      const int A = R + a, B = R + b;
      T f = T(0);
      if (inz(c)) {
        const T vel = W(A, B, c);
        const int K = level(P.K[kTz], true, k0 + c, g.Hz, g.Nz, 0);
        f = (row(kAzCCF, B) * vel) * advected<KM, T, S, FULL>(P.fam[kTz], K, 0, vel > T(0), cat(a, b, c),
                                                     1, kSelf, nullptr, nullptr, cfz(kTz, c),
                                                     L.zs);
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
      Gc[g.at(pi(A), pj(B), k0 + c)] = -(total / mz(kVCCC, B, c));
    });
  }
}

// The kernels: the lean variant and the stencil's family at the registers
// ptxas takes, the full variant without the stencil held to two blocks an
// SM (128 registers, as before the stencil's family: left free it takes
// 166 at float32 and one block an SM, the stretched ocean row's #10 4.21 ms
// against 3.11).
template <typename T, typename S, int KM, bool FULL, bool MD>
__global__ void __launch_bounds__(kThreads) vi_tendency_kernel(const __grid_constant__ Params<T> P) {
  vi_tendency<T, S, KM, FULL, MD>(P);
}
template <typename T, typename S, int KM>
__global__ void __launch_bounds__(kThreads, 2)
    vi_tendency_full_kernel(const __grid_constant__ Params<T> P) {
  vi_tendency<T, S, KM, true, false>(P);
}

// The kernel a variant launches (only that one is instantiated).
template <typename T, typename S, int KM, bool FULL, bool MD>
auto kernel_of() {
  if constexpr (FULL && !MD) {
    return vi_tendency_full_kernel<T, S, KM>;
  } else {
    return vi_tendency_kernel<T, S, KM, FULL, MD>;
  }
}

// -- the launch -------------------------------------------------------------------

struct Args {
  const void* const* in;
  void* const* out;
  const void* rows;
  const void* zrows;
  const int* cf;
  const double* cor_f;
  int TX, TY, TZ, threads, blocks, smem;
  cudaStream_t stream;
  int* per_sm;   // non-null: report the blocks an SM holds instead of launching
};

// Whether the reaches cover the sites (the box, the w box, the columns and
// the tracer box): R past every horizontal site's buffer (and 2 more with
// the multi-dimensional stencil), Rw every symmetric w site's Centered
// buffer, Rz the z sites', Rc the horizontal tracer sites'.
inline bool reaches_cover(const int* cf) {
  auto Kof = [&](int s) { return cf[cK + s]; };
  if (cf[cMd] != 0 && cf[cMd] != 1) return false;
  const int horizontal[] = {kVortX, kVortY, kKeX, kKeY, kKcX, kKcY, kDivX, kDivY, kDcX, kDcY};
  for (int s : horizontal)
    if (Kof(s) + 1 + 2 * cf[cMd] > cf[cR]) return false;
  const int w_sites[] = {kVsX, kVsY};
  for (int s : w_sites) {
    const int b = cf[cFam + s] == kCentered ? Kof(s) : (Kof(s) > 1 ? Kof(s) - 1 : 1);
    if (b > cf[cRw]) return false;
  }
  if (Kof(kVz) > cf[cRz] || Kof(kTz) > cf[cRz]) return false;
  if (Kof(kTx) > cf[cRc] || Kof(kTy) > cf[cRc]) return false;
  for (int s = 0; s < kNumSites; ++s)
    if (Kof(s) < 0 || Kof(s) > cf[cKM] || cf[cFam + s] < 0 || cf[cFam + s] > kWeno)
      return false;
  return cf[cRw] >= 2 && cf[cR] >= 2 && cf[cRz] >= 1 && cf[cRc] >= 1;
}

template <typename T, typename S, int KM, bool FULL, bool MD>
int launch(const Args& a) {
  const int* cf = a.cf;
  const Geom g{cf[cNx], cf[cNy], cf[cNz], cf[cHx], cf[cHy], cf[cHz]};
  const int tiles_y = ceil_div(g.Ny + cf[cBy], a.TY), tiles_z = ceil_div(g.Nz, a.TZ);
  const long long want = (long long)Layout(a.TX, a.TY, a.TZ, cf[cR], cf[cRw], cf[cRz], cf[cRc],
                                           cf[cNyRows], cf[cNzRows], cf[cMd])
                             .total *
                         sizeof(T);
  if (a.smem != want || a.smem > kMaxSmemBytes || !reaches_cover(cf) ||
      cf[cNyRows] < kNumRows || cf[cNzRows] < kNumZCols || cf[cMd] != (MD ? 1 : 0) ||
      a.blocks != ceil_div(g.Nx + cf[cBx], a.TX) * tiles_y * tiles_z)
    return (int)cudaErrorInvalidValue;
  auto* kernel = kernel_of<T, S, KM, FULL, MD>();
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
  const int ntr = cf[cNtr];
  for (int t = 0; t < kBatch; ++t) P.c[t] = t < ntr ? (const T*)a.in[4 + t] : nullptr;
  for (int c = 0; c < 2 + kBatch; ++c) P.G[c] = c < 2 + ntr ? (T*)a.out[c] : nullptr;
  P.rows = (const T*)a.rows;
  P.zrows = (const T*)a.zrows;
  P.g = g;
  P.bx = cf[cBx];
  P.by = cf[cBy];
  P.cx = cf[cCx];
  P.cy = cf[cCy];
  P.hox = cf[cHox];
  P.hoy = cf[cHoy];
  P.gnx = cf[cGnx];
  P.gny = cf[cGny];
  P.vort = cf[cVort];
  P.vort_sm = cf[cVortSm];
  P.ke = cf[cKe];
  P.vert = cf[cVert];
  P.upw = cf[cUpw];
  P.cor = cf[cCor];
  P.ntr = ntr;
  P.with_ph = cf[cWithPh];
  P.momentum = cf[cMomentum];
  P.md = cf[cMd];
  P.zs = cf[cZs];
  P.ny_rows = cf[cNyRows];
  P.nz_rows = cf[cNzRows];
  P.fx = (T)a.cor_f[0];
  P.fy = (T)a.cor_f[1];
  P.fz = (T)a.cor_f[2];
  for (int s = 0; s < kNumSites; ++s) {
    P.fam[s] = cf[cFam + s];
    P.K[s] = cf[cK + s];
    P.base[s] = cf[cBase + s];
  }
  P.TX = a.TX;
  P.TY = a.TY;
  P.TZ = a.TZ;
  P.R = cf[cR];
  P.Rw = cf[cRw];
  P.Rz = cf[cRz];
  P.Rc = cf[cRc];
  P.tiles_y = tiles_y;
  P.tiles_z = tiles_z;
  kernel<<<a.blocks, a.threads, a.smem, a.stream>>>(P);
  return (int)cudaGetLastError();
}

// Whether a configuration takes the full kernel variant: it reads per-slot
// coefficients or Δz columns (a stretched y or z), or a symmetric site
// reaches past Centered(4).
inline bool full_variant(const int* cf) {
  bool full = cf[cZs] != 0;
  for (int s = 0; s < kNumSites; ++s) full = full || cf[cBase + s] >= 0;
  for (int s : {kKcX, kKcY, kVsX, kVsY, kDcX, kDcY}) {
    const int K = cf[cK + s];
    full = full || (cf[cFam + s] == kCentered ? K : K - 1) > 2;
  }
  return full;
}

// The lean or full variant, or with the multi-dimensional stencil (MD, the
// vi_md_k<K>.cu units) the full variant with the filter.
template <typename T, typename S, int KM, bool MD>
int launch_variant(const Args& a) {
  return full_variant(a.cf) ? launch<T, S, KM, true, MD>(a) : launch<T, S, KM, false, MD>(a);
}

// The launch for the fields' and the smoothness' dtype codes at buffer KM.
// The MD family takes the smoothness in the fields' dtype, or bfloat16 with
// float32 fields (vi_config refuses the other pairs with the stencil).
template <int KM, bool MD = false>
int dispatch(int dtype, int sdtype, const Args& a) {
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32) return launch_variant<float, float, KM, MD>(a);
  if (dtype == OC_FLOAT32 && sdtype == OC_BFLOAT16) return launch_variant<float, bf16, KM, MD>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64) return launch_variant<double, double, KM, MD>(a);
  if constexpr (!MD) {
    if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64) return launch_variant<float, double, KM, MD>(a);
    if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32) return launch_variant<double, float, KM, MD>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// Each vi_k<K>.cu (vi_md_k<K>.cu: with the multi-dimensional stencil): this
// buffer's launch and its unit's tables.
int vi_k3(int dtype, int sdtype, const Args& a);
int vi_k4(int dtype, int sdtype, const Args& a);
int vi_k5(int dtype, int sdtype, const Args& a);
int vi_k6(int dtype, int sdtype, const Args& a);
int vi_k3_tables(const double* v, const double* vb);
int vi_k4_tables(const double* v, const double* vb);
int vi_k5_tables(const double* v, const double* vb);
int vi_k6_tables(const double* v, const double* vb);
int vi_md_k3(int dtype, int sdtype, const Args& a);
int vi_md_k4(int dtype, int sdtype, const Args& a);
int vi_md_k5(int dtype, int sdtype, const Args& a);
int vi_md_k6(int dtype, int sdtype, const Args& a);
int vi_md_k3_tables(const double* v, const double* vb);
int vi_md_k4_tables(const double* v, const double* vb);
int vi_md_k5_tables(const double* v, const double* vb);
int vi_md_k6_tables(const double* v, const double* vb);

}  // namespace vi
}  // namespace oc
