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
// out) take 0.045 ms at 3.35 TB/s (H100 SXM). The scratch below is this
// design's own traffic (0.19 ms more if written and read once).
// Design: the simplest correct form. One call, two launches: vi_derive writes
// the derived fields once per padded cell into scratch arrays (ζ, û, v̂, ℑy u,
// ℑx v, δx(u²/2), δy(v²/2), δy(u²/2), δx(v²/2), ℑx u, ℑy v, δx(Ax u),
// δy(Ay v), or K), so that no reconstruction re-forms a derived value per
// stencil read; vi_assemble takes one thread per (component, output cell), z
// fastest, the component uniform per block, and reads its stencils through
// L1/L2. The reconstructions are one non-inlined function per field type,
// with the WENO orders inlined in it, to bound the code size. Coefficients
// live in constant memory (VITab), uploaded once per device by
// oc_vi_set_tables. Metrics are per-y rows in the field type. Divisions are
// exact. Offsets are 64-bit.
//
// ptxas (sm_90a, -O3, on an H100 build): vi_assemble<float, float>
// 118 registers, <double, double> 192, <float, double> 160, <double, float>
// 156; vi_derive 32 (float) and 34 (double); no spills, no stack frame in
// any of them. At 512x256x32 float32 the call takes about 3.6 ms against
// its 0.114 ms bound (PERF.md).
#include "common.cuh"

namespace {

constexpr int kMaxTracers = 8;
constexpr int kNumScratch = 14;

// Metric rows, as kernels/fused_vector_invariant.py ROWS orders them.
enum Row {
  kDxFCC, kDxCFC, kDyFCC, kDyCFC, kAzFFC, kAzFCC, kAzCFC, kAzCCF, kAxFCC, kAyCFC,
  kVFCC, kVCFC, kVCCC, kF, kNumRows
};

// Scratch arrays, as SCRATCH orders them.
enum Scr {
  sZeta, sVhat, sUhat, sSu, sSv, sDu2, sDv2, sDu2y, sDv2x, sIxu, sIyv, sDU, sDV, sK
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

__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }

template <typename T>
struct Params {
  const T* u; const T* v; const T* w; const T* ph;
  const T* c[kMaxTracers];
  T* G[2 + kMaxTracers];        // Gu, Gv, Gc...
  T* s[kNumScratch];            // scratch, padded (null when not needed)
  const T* rows;                // kNumRows x PY
  oc::Geom g;
  int bx, by;                   // bounded x / y
  int vort, kv;                 // 0 enstrophy, 1 energy, 2 WENO (buffer kv)
  int upw;                      // 0 energy conserving, 1 WENO(5) ONLY_SELF
  int cor;                      // 0 none, 1 FPlane, 2 spherical energy, 3 spherical enstrophy
  int tsch;                     // tracers: 0 Centered(2), 1 WENO(5)
  int ntr, with_ph;
  T dzc, dzf;                   // Δz at centers and z faces (regular z)
};

template <typename T>
__device__ __forceinline__ bool inb(const Params<T>& P, int i, int j, int k) {
  return (unsigned)i < (unsigned)P.g.PX() && (unsigned)j < (unsigned)P.g.PY() &&
         (unsigned)k < (unsigned)P.g.PZ();
}

// a at padded (i, j, k), 0 outside the padded array.
template <typename T>
__device__ __forceinline__ T rd(const Params<T>& P, const T* a, int i, int j, int k) {
  return inb(P, i, j, k) ? a[P.g.at(i, j, k)] : T(0);
}

template <typename T>
__device__ __forceinline__ T row(const Params<T>& P, int r, int j) {
  return P.rows[(long long)r * P.g.PY() + j];
}

// metric row r times a at (i, j, k), 0 outside: a shifted read of the
// plain version's product tensor.
template <typename T>
__device__ __forceinline__ T mrd(const Params<T>& P, int r, const T* a, int i, int j, int k) {
  return inb(P, i, j, k) ? row(P, r, j) * a[P.g.at(i, j, k)] : T(0);
}

// -- lines and reconstructions -------------------------------------------------

// One array (or the sum of two) along one axis from a position: get(o) reads
// offset o, 0 outside the padded array.
template <typename T>
struct Line {
  const T* a;
  const T* b;          // added to a when not null
  long long base, stride;
  int p, n;            // position along the axis and its padded extent
  __device__ __forceinline__ T get(int o) const {
    const int q = p + o;
    if ((unsigned)q >= (unsigned)n) return T(0);
    const long long at = base + (long long)o * stride;
    return b ? a[at] + b[at] : a[at];
  }
};

template <typename T>
__device__ __forceinline__ Line<T> line(const Params<T>& P, const T* a, const T* b, int axis,
                                        int i, int j, int k) {
  Line<T> L;
  L.a = a;
  L.b = b;
  L.base = P.g.at(i, j, k);
  if (axis == 0) { L.stride = (long long)P.g.PY() * P.g.PZ(); L.p = i; L.n = P.g.PX(); }
  else if (axis == 1) { L.stride = P.g.PZ(); L.p = j; L.n = P.g.PY(); }
  else { L.stride = 1; L.p = k; L.n = P.g.PZ(); }
  return L;
}

// β = Σ_m (Σ_j fac[m][j]·v[j])² in S over the K cells v.
template <int K, typename S, typename T>
__device__ __forceinline__ S smoothness(int s, const T* v) {
  const VITab<S>& ts = vtab<S>();
  S beta = S(0);
#pragma unroll
  for (int m = 0; m < K; ++m) {
    S lin = ts.fac[K - 2][s][m][0] * (S)v[0];
#pragma unroll
    for (int j = 1; j < K; ++j) lin = lin + ts.fac[K - 2][s][m][j] * (S)v[j];
    beta = m == 0 ? lin * lin : beta + lin * lin;
  }
  return beta;
}

// WENO of buffer K on the 2K-1 selected cells c (left-biased orientation),
// the smoothness from c itself (nsm = 0) or summed over s1 (and s2).
template <int K, typename T, typename S>
__device__ __forceinline__ T weno(const T* c, int nsm, const T* s1, const T* s2) {
  const VITab<T>& tt = vtab<T>();
  const VITab<S>& ts = vtab<S>();
  T p[K];
  S b[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int o = K - 1 - s;
    T acc = tt.coef[K - 2][s][0] * c[o];
#pragma unroll
    for (int j = 1; j < K; ++j) acc = acc + tt.coef[K - 2][s][j] * c[o + j];
    p[s] = acc;
    if (nsm == 0) {
      b[s] = smoothness<K, S>(s, c + o);
    } else {
      S beta = smoothness<K, S>(s, s1 + o);
      if (nsm > 1) beta = beta + smoothness<K, S>(s, s2 + o);
      b[s] = beta;
    }
  }
  S tau = b[0];
#pragma unroll
  for (int s = 1; s < K; ++s)
    if (ts.tau[K - 2][s] != S(0)) tau = tau + ts.tau[K - 2][s] * b[s];
  tau = absval(tau);
  T num = T(0), den = T(0);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    S r = tau / (b[s] + ts.eps);
    r = r > ts.rmax ? ts.rmax : r;
    const T alpha = (T)(ts.gam[K - 2][s] * (S(1) + r * r));
    num = num + alpha * p[s];
    den = den + alpha;
  }
  return num / den;
}

template <int K, typename T, typename S>
__device__ __forceinline__ T weno_line(int beta, bool pos, const Line<T>& v, int nsm,
                                       const Line<T>& s1, const Line<T>& s2) {
  T c[2 * K - 1], a1[2 * K - 1], a2[2 * K - 1];
#pragma unroll
  for (int n = 0; n < 2 * K - 1; ++n) {
    const int o = beta - K + n;
    const int so = pos ? o : 2 * beta - 1 - o;
    c[n] = v.get(so);
    if (nsm > 0) a1[n] = s1.get(so);
    if (nsm > 1) a2[n] = s2.get(so);
  }
  return weno<K, T, S>(c, nsm, a1, a2);
}

// The upwind reconstruction of v at buffer K (1: UpwindBiased(1)), selected
// by pos (the advecting velocity > 0), with nsm smoothness lines.
template <typename T, typename S>
__device__ __noinline__ T recon(int K, int beta, bool pos, Line<T> v, int nsm, Line<T> s1,
                                Line<T> s2) {
  switch (K) {
    case 5: return weno_line<5, T, S>(beta, pos, v, nsm, s1, s2);
    case 4: return weno_line<4, T, S>(beta, pos, v, nsm, s1, s2);
    case 3: return weno_line<3, T, S>(beta, pos, v, nsm, s1, s2);
    case 2: return weno_line<2, T, S>(beta, pos, v, nsm, s1, s2);
    default: return pos ? v.get(beta - 1) : v.get(beta);
  }
}

// The buffer a scheme of buffer Kmax reaches at padded index p along an axis
// (the near-wall cascade on a bounded axis; 1 = UpwindBiased(1)).
__device__ __forceinline__ int cascade(int Kmax, bool bounded, int p, int H, int N, int beta) {
  if (!bounded) return Kmax;
  for (int R = Kmax; R >= 2; --R)
    if (p >= H + R - beta && p <= H + N - R) return R;
  return 1;
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

// -- launch 1: derived fields ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) vi_derive(const __grid_constant__ Params<T> P) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)P.g.PX() * P.g.PY() * P.g.PZ();
  if (n >= total) return;
  const int PZ = P.g.PZ(), PY = P.g.PY();
  const int k = (int)(n % PZ);
  const int j = (int)((n / PZ) % PY);
  const int i = (int)(n / ((long long)PZ * PY));
  const T *u = P.u, *v = P.v;
  // ζ = (δx(Δy v) - δy(Δx u)) / Az at ffc
  {
    const T dxa = mrd(P, kDyCFC, v, i, j, k) - mrd(P, kDyCFC, v, i - 1, j, k);
    const T dyb = mrd(P, kDxFCC, u, i, j, k) - mrd(P, kDxFCC, u, i, j - 1, k);
    P.s[sZeta][n] = (dxa - dyb) / row(P, kAzFFC, j);
  }
  if (P.s[sVhat]) {
    // v̂ = ℑx(ℑy(Δx v)) / Δx at fcc; û = ℑy(ℑx(Δy u)) / Δy at cfc
    auto iyc = [&](int ii) {
      return inb(P, ii, j, k)
                 ? T(0.5) * (mrd(P, kDxCFC, v, ii, j + 1, k) + mrd(P, kDxCFC, v, ii, j, k))
                 : T(0);
    };
    P.s[sVhat][n] = (T(0.5) * (iyc(i) + iyc(i - 1))) / row(P, kDxFCC, j);
    auto ixc = [&](int jj) {
      return inb(P, i, jj, k)
                 ? T(0.5) * (mrd(P, kDyFCC, u, i + 1, jj, k) + mrd(P, kDyFCC, u, i, jj, k))
                 : T(0);
    };
    P.s[sUhat][n] = (T(0.5) * (ixc(j) + ixc(j - 1))) / row(P, kDyCFC, j);
  }
  if (P.s[sSu]) {
    P.s[sSu][n] = T(0.5) * (rd(P, u, i, j, k) + rd(P, u, i, j - 1, k));
    P.s[sSv][n] = T(0.5) * (rd(P, v, i, j, k) + rd(P, v, i - 1, j, k));
  }
  if (P.upw) {
    auto hu = [&](int ii, int jj) {
      const T a = rd(P, u, ii, jj, k);
      return (T(0.5) * a) * a;
    };
    auto hv = [&](int ii, int jj) {
      const T a = rd(P, v, ii, jj, k);
      return (T(0.5) * a) * a;
    };
    P.s[sDu2][n] = hu(i + 1, j) - hu(i, j);
    P.s[sDv2][n] = hv(i, j + 1) - hv(i, j);
    P.s[sDu2y][n] = hu(i, j) - hu(i, j - 1);
    P.s[sDv2x][n] = hv(i, j) - hv(i - 1, j);
    P.s[sIxu][n] = T(0.5) * (rd(P, u, i + 1, j, k) + rd(P, u, i, j, k));
    P.s[sIyv][n] = T(0.5) * (rd(P, v, i, j + 1, k) + rd(P, v, i, j, k));
    P.s[sDU][n] = mrd(P, kAxFCC, u, i + 1, j, k) - mrd(P, kAxFCC, u, i, j, k);
    P.s[sDV][n] = mrd(P, kAyCFC, v, i, j + 1, k) - mrd(P, kAyCFC, v, i, j, k);
  } else {
    // K = (ℑx(u²) + ℑy(v²)) / 2 at ccc
    auto sq = [&](const T* a, int ii, int jj) {
      const T x = rd(P, a, ii, jj, k);
      return x * x;
    };
    const T ixuu = T(0.5) * (sq(u, i + 1, j) + sq(u, i, j));
    const T iyvv = T(0.5) * (sq(v, i, j + 1) + sq(v, i, j));
    P.s[sK][n] = T(0.5) * (ixuu + iyvv);
  }
}

// -- launch 2: the tendencies ---------------------------------------------------

template <typename T, typename S>
__device__ T tendency_u(const Params<T>& P, int i, int j, int k) {
  const oc::Geom& g = P.g;
  const T *u = P.u, *v = P.v, *w = P.w;
  const T dx_fcc = row(P, kDxFCC, j);
  const Line<T> none{};
  // vorticity flux
  T Gh;
  if (P.vort == 0) {
    const T iyz = T(0.5) * (rd(P, P.s[sZeta], i, j + 1, k) + rd(P, P.s[sZeta], i, j, k));
    Gh = -((-iyz) * P.s[sVhat][g.at(i, j, k)]);
  } else if (P.vort == 1) {
    // ℑy(ζ ℑx(Δx v)) / Δx
    auto zvx = [&](int jj) {
      if (!inb(P, i, jj, k)) return T(0);
      const T vx = T(0.5) * (mrd(P, kDxCFC, v, i, jj, k) + mrd(P, kDxCFC, v, i - 1, jj, k));
      return P.s[sZeta][g.at(i, jj, k)] * vx;
    };
    Gh = -((-(T(0.5) * (zvx(j + 1) + zvx(j)))) / dx_fcc);
  } else {
    const T vh = P.s[sVhat][g.at(i, j, k)];
    const int K = cascade(P.kv, P.by, j, g.Hy, g.Ny, 1);
    const T r = recon<T, S>(K, 1, vh > T(0), line(P, P.s[sZeta], (const T*)nullptr, 1, i, j, k), 2,
                            line(P, P.s[sSu], (const T*)nullptr, 1, i, j, k),
                            line(P, P.s[sSv], (const T*)nullptr, 1, i, j, k));
    Gh = -((-vh) * r);
  }
  // Bernoulli head
  T Gb;
  if (!P.upw) {
    Gb = -((rd(P, P.s[sK], i, j, k) - rd(P, P.s[sK], i - 1, j, k)) / dx_fcc);
  } else {
    const T* dv2x = P.s[sDv2x];
    const bool c4y = !P.by || (j >= g.Hy + 2 - 1 && j <= g.Hy + g.Ny - 2);
    const T dKvs = sym<T>(c4y, 1, [&](int o) { return rd(P, dv2x, i, j + o, k); });
    const T uc = u[g.at(i, j, k)];
    const int K = cascade(3, P.bx, i, g.Hx, g.Nx, 0);
    const T dKur = recon<T, S>(K, 0, uc > T(0), line(P, P.s[sDu2], (const T*)nullptr, 0, i, j, k),
                               1, line(P, P.s[sIxu], (const T*)nullptr, 0, i, j, k), none);
    Gb = -((dKur + dKvs) / dx_fcc);
  }
  // vertical advection
  T Gz;
  if (!P.upw) {
    auto azw = [&](int ii, int kk) { return mrd(P, kAzCCF, w, ii, j, kk); };
    auto prod = [&](int kk) {
      if (!inb(P, i, j, kk)) return T(0);
      const T ixa = T(0.5) * (azw(i, kk) + azw(i - 1, kk));
      const T dzu = (rd(P, u, i, j, kk) - rd(P, u, i, j, kk - 1)) / P.dzf;
      return ixa * dzu;
    };
    Gz = -((T(0.5) * (prod(k + 1) + prod(k))) / row(P, kAzFCC, j));
  } else {
    const T uc = u[g.at(i, j, k)];
    const T* dV = P.s[sDV];
    const bool c4x = !P.bx || (i >= g.Hx + 2 && i <= g.Hx + g.Nx - 2);
    const T dvs = sym<T>(c4x, 0, [&](int o) { return rd(P, dV, i + o, j, k); });
    const int K = cascade(3, P.bx, i, g.Hx, g.Nx, 0);
    const T rdiv = recon<T, S>(K, 0, uc > T(0), line(P, P.s[sDU], (const T*)nullptr, 0, i, j, k), 1,
                               line(P, P.s[sDU], P.s[sDV], 0, i, j, k), none);
    const T phi = uc * (dvs + rdiv);
    // ŵ = WENO(5).symmetric_x(Az w) at fcf: Centered(4) off the x walls
    const bool w4 = !P.bx || (i >= g.Hx + 3 && i <= g.Hx + g.Nx - 3);
    auto flux = [&](int kk) {
      if (!inb(P, i, j, kk)) return T(0);
      const T wh = sym<T>(w4, 0, [&](int o) { return mrd(P, kAzCCF, w, i + o, j, kk); });
      const int Kz = cascade(3, true, kk, g.Hz, g.Nz, 0);
      const Line<T> none2{};
      return wh * recon<T, S>(Kz, 0, wh > T(0), line(P, u, (const T*)nullptr, 2, i, j, kk), 0, none2,
                              none2);
    };
    const T az = flux(k + 1) - flux(k);
    Gz = -((phi + az) / row(P, kVFCC, j));
  }
  T G = (Gh + Gb) + Gz;
  // forces
  bool have_f = false;
  T Gf = T(0);
  if (P.cor == 1) {
    // FPlane: -f ℑx(ℑy v)
    auto iyv = [&](int ii) {
      return inb(P, ii, j, k) ? T(0.5) * (rd(P, v, ii, j + 1, k) + rd(P, v, ii, j, k)) : T(0);
    };
    Gf = -((-row(P, kF, j)) * (T(0.5) * (iyv(i) + iyv(i - 1))));
    have_f = true;
  } else if (P.cor == 2) {
    auto fvx = [&](int jj) {
      if (!inb(P, i, jj, k)) return T(0);
      const T vx = T(0.5) * (mrd(P, kDxCFC, v, i, jj, k) + mrd(P, kDxCFC, v, i - 1, jj, k));
      return row(P, kF, jj) * vx;
    };
    Gf = -((-(T(0.5) * (fvx(j + 1) + fvx(j)))) / dx_fcc);
    have_f = true;
  } else if (P.cor == 3) {
    const T f1 = j + 1 < g.PY() ? row(P, kF, j + 1) : T(0);
    const T iyf = T(0.5) * (f1 + row(P, kF, j));
    auto iyc = [&](int ii) {
      return inb(P, ii, j, k)
                 ? T(0.5) * (mrd(P, kDxCFC, v, ii, j + 1, k) + mrd(P, kDxCFC, v, ii, j, k))
                 : T(0);
    };
    Gf = -(((-iyf) * (T(0.5) * (iyc(i) + iyc(i - 1)))) / dx_fcc);
    have_f = true;
  }
  if (P.with_ph) {
    const T Gp = -((rd(P, P.ph, i, j, k) - rd(P, P.ph, i - 1, j, k)) / dx_fcc);
    Gf = have_f ? Gf + Gp : Gp;
  }
  return G + Gf;
}

template <typename T, typename S>
__device__ T tendency_v(const Params<T>& P, int i, int j, int k) {
  const oc::Geom& g = P.g;
  const T *u = P.u, *v = P.v, *w = P.w;
  const T dy_cfc = row(P, kDyCFC, j);
  const Line<T> none{};
  T Gh;
  if (P.vort == 0) {
    const T ixz = T(0.5) * (rd(P, P.s[sZeta], i + 1, j, k) + rd(P, P.s[sZeta], i, j, k));
    Gh = -(ixz * P.s[sUhat][g.at(i, j, k)]);
  } else if (P.vort == 1) {
    // ℑx(ζ ℑy(Δy u)) / Δy
    auto zuy = [&](int ii) {
      if (!inb(P, ii, j, k)) return T(0);
      const T uy = T(0.5) * (mrd(P, kDyFCC, u, ii, j, k) + mrd(P, kDyFCC, u, ii, j - 1, k));
      return P.s[sZeta][g.at(ii, j, k)] * uy;
    };
    Gh = -((T(0.5) * (zuy(i + 1) + zuy(i))) / dy_cfc);
  } else {
    const T uh = P.s[sUhat][g.at(i, j, k)];
    const int K = cascade(P.kv, P.bx, i, g.Hx, g.Nx, 1);
    const T r = recon<T, S>(K, 1, uh > T(0), line(P, P.s[sZeta], (const T*)nullptr, 0, i, j, k), 2,
                            line(P, P.s[sSu], (const T*)nullptr, 0, i, j, k),
                            line(P, P.s[sSv], (const T*)nullptr, 0, i, j, k));
    Gh = -(uh * r);
  }
  T Gb;
  if (!P.upw) {
    Gb = -((rd(P, P.s[sK], i, j, k) - rd(P, P.s[sK], i, j - 1, k)) / dy_cfc);
  } else {
    const T* du2y = P.s[sDu2y];
    const bool c4x = !P.bx || (i >= g.Hx + 2 - 1 && i <= g.Hx + g.Nx - 2);
    const T dKus = sym<T>(c4x, 1, [&](int o) { return rd(P, du2y, i + o, j, k); });
    const T vc = v[g.at(i, j, k)];
    const int K = cascade(3, P.by, j, g.Hy, g.Ny, 0);
    const T dKvr = recon<T, S>(K, 0, vc > T(0), line(P, P.s[sDv2], (const T*)nullptr, 1, i, j, k),
                               1, line(P, P.s[sIyv], (const T*)nullptr, 1, i, j, k), none);
    Gb = -((dKvr + dKus) / dy_cfc);
  }
  T Gz;
  if (!P.upw) {
    auto azw = [&](int jj, int kk) { return mrd(P, kAzCCF, w, i, jj, kk); };
    auto prod = [&](int kk) {
      if (!inb(P, i, j, kk)) return T(0);
      const T iya = T(0.5) * (azw(j, kk) + azw(j - 1, kk));
      const T dzv = (rd(P, v, i, j, kk) - rd(P, v, i, j, kk - 1)) / P.dzf;
      return iya * dzv;
    };
    Gz = -((T(0.5) * (prod(k + 1) + prod(k))) / row(P, kAzCFC, j));
  } else {
    const T vc = v[g.at(i, j, k)];
    const T* dU = P.s[sDU];
    const bool c4y = !P.by || (j >= g.Hy + 2 && j <= g.Hy + g.Ny - 2);
    const T dus = sym<T>(c4y, 0, [&](int o) { return rd(P, dU, i, j + o, k); });
    const int K = cascade(3, P.by, j, g.Hy, g.Ny, 0);
    const T rdiv = recon<T, S>(K, 0, vc > T(0), line(P, P.s[sDV], (const T*)nullptr, 1, i, j, k), 1,
                               line(P, P.s[sDU], P.s[sDV], 1, i, j, k), none);
    const T phi = vc * (dus + rdiv);
    const bool w4 = !P.by || (j >= g.Hy + 3 && j <= g.Hy + g.Ny - 3);
    auto flux = [&](int kk) {
      if (!inb(P, i, j, kk)) return T(0);
      const T wh = sym<T>(w4, 0, [&](int o) { return mrd(P, kAzCCF, w, i, j + o, kk); });
      const int Kz = cascade(3, true, kk, g.Hz, g.Nz, 0);
      const Line<T> none2{};
      return wh * recon<T, S>(Kz, 0, wh > T(0), line(P, v, (const T*)nullptr, 2, i, j, kk), 0, none2,
                              none2);
    };
    const T az = flux(k + 1) - flux(k);
    Gz = -((phi + az) / row(P, kVCFC, j));
  }
  T G = (Gh + Gb) + Gz;
  bool have_f = false;
  T Gf = T(0);
  if (P.cor == 1) {
    auto ixu = [&](int jj) {
      return inb(P, i, jj, k) ? T(0.5) * (rd(P, u, i + 1, jj, k) + rd(P, u, i, jj, k)) : T(0);
    };
    Gf = -(row(P, kF, j) * (T(0.5) * (ixu(j) + ixu(j - 1))));
    have_f = true;
  } else if (P.cor == 2) {
    auto fuy = [&](int ii) {
      if (!inb(P, ii, j, k)) return T(0);
      const T uy = T(0.5) * (mrd(P, kDyFCC, u, ii, j, k) + mrd(P, kDyFCC, u, ii, j - 1, k));
      return row(P, kF, j) * uy;
    };
    Gf = -((T(0.5) * (fuy(i + 1) + fuy(i))) / dy_cfc);
    have_f = true;
  } else if (P.cor == 3) {
    auto ixc = [&](int jj) {
      return inb(P, i, jj, k)
                 ? T(0.5) * (mrd(P, kDyFCC, u, i + 1, jj, k) + mrd(P, kDyFCC, u, i, jj, k))
                 : T(0);
    };
    Gf = -((row(P, kF, j) * (T(0.5) * (ixc(j) + ixc(j - 1)))) / dy_cfc);
    have_f = true;
  }
  if (P.with_ph) {
    const T Gp = -((rd(P, P.ph, i, j, k) - rd(P, P.ph, i, j - 1, k)) / dy_cfc);
    Gf = have_f ? Gf + Gp : Gp;
  }
  return G + Gf;
}

// -∇·(𝐯c) at ccc.
template <typename T, typename S>
__device__ T tendency_c(const Params<T>& P, const T* c, int i, int j, int k) {
  const oc::Geom& g = P.g;
  const Line<T> none{};
  auto chat = [&](int axis, int ii, int jj, int kk, T vel) {
    const Line<T> L = line(P, c, (const T*)nullptr, axis, ii, jj, kk);
    const bool pos = vel > T(0);
    if (P.tsch == 0) {
      const VITab<T>& tt = vtab<T>();
      const T lo = L.get(-1), hi = L.get(0);
      return tt.c2[0] * (pos ? lo : hi) + tt.c2[1] * (pos ? hi : lo);
    }
    const int p = axis == 0 ? ii : (axis == 1 ? jj : kk);
    const int H = axis == 0 ? g.Hx : (axis == 1 ? g.Hy : g.Hz);
    const int N = axis == 0 ? g.Nx : (axis == 1 ? g.Ny : g.Nz);
    const bool bounded = axis == 0 ? P.bx : (axis == 1 ? P.by : true);
    return recon<T, S>(cascade(3, bounded, p, H, N, 0), 0, pos, L, 0, none, none);
  };
  auto fx = [&](int ii) {
    if (!inb(P, ii, j, k)) return T(0);
    const T vel = P.u[g.at(ii, j, k)];
    return (row(P, kAxFCC, j) * vel) * chat(0, ii, j, k, vel);
  };
  auto fy = [&](int jj) {
    if (!inb(P, i, jj, k)) return T(0);
    const T vel = P.v[g.at(i, jj, k)];
    return (row(P, kAyCFC, jj) * vel) * chat(1, i, jj, k, vel);
  };
  auto fz = [&](int kk) {
    if (!inb(P, i, j, kk)) return T(0);
    const T vel = P.w[g.at(i, j, kk)];
    return (row(P, kAzCCF, j) * vel) * chat(2, i, j, kk, vel);
  };
  const T total = ((fx(i + 1) - fx(i)) + (fy(j + 1) - fy(j))) + (fz(k + 1) - fz(k));
  return -(total / row(P, kVCCC, j));
}

template <typename T, typename S>
__global__ void __launch_bounds__(256) vi_assemble(const __grid_constant__ Params<T> P) {
  const oc::Geom& g = P.g;
  const int NXK = g.Nx + P.bx, NYK = g.Ny + P.by;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)NXK * NYK * g.Nz) return;
  const int K = (int)(n % g.Nz);
  const int J = (int)((n / g.Nz) % NYK);
  const int I = (int)(n / ((long long)g.Nz * NYK));
  const int comp = blockIdx.y;
  if (comp == 0) {
    if (J >= g.Ny) return;
  } else if (comp == 1) {
    if (I >= g.Nx) return;
  } else if (I >= g.Nx || J >= g.Ny) {
    return;
  }
  const int i = I + g.Hx, j = J + g.Hy, k = K + g.Hz;
  T G;
  if (comp == 0)
    G = tendency_u<T, S>(P, i, j, k);
  else if (comp == 1)
    G = tendency_v<T, S>(P, i, j, k);
  else
    G = tendency_c<T, S>(P, P.c[comp - 2], i, j, k);
  P.G[comp][g.at(i, j, k)] = G;
}

template <typename T, typename S>
int launch(const void* const* in, void* const* out, void* const* scratch, const void* rows,
           const int* cf, double dzc, double dzf, cudaStream_t stream) {
  Params<T> P;
  P.u = (const T*)in[0];
  P.v = (const T*)in[1];
  P.w = (const T*)in[2];
  P.ph = (const T*)in[3];
  const int ntr = cf[13];
  for (int t = 0; t < kMaxTracers; ++t) P.c[t] = t < ntr ? (const T*)in[4 + t] : nullptr;
  for (int c = 0; c < 2 + kMaxTracers; ++c) P.G[c] = c < 2 + ntr ? (T*)out[c] : nullptr;
  for (int s = 0; s < kNumScratch; ++s) P.s[s] = (T*)scratch[s];
  P.rows = (const T*)rows;
  P.g = oc::Geom{cf[0], cf[1], cf[2], cf[3], cf[4], cf[5]};
  P.bx = cf[6];
  P.by = cf[7];
  P.vort = cf[8];
  P.kv = cf[9];
  P.upw = cf[10];
  P.cor = cf[11];
  P.tsch = cf[12];
  P.ntr = ntr;
  P.with_ph = cf[14];
  P.dzc = (T)dzc;
  P.dzf = (T)dzf;
  const int threads = 256;
  const long long padded = (long long)P.g.PX() * P.g.PY() * P.g.PZ();
  vi_derive<T><<<oc::blocks_for(padded, threads), threads, 0, stream>>>(P);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long cells = (long long)(P.g.Nx + P.bx) * (P.g.Ny + P.by) * P.g.Nz;
  dim3 grid(oc::blocks_for(cells, threads), 2 + ntr);
  vi_assemble<T, S><<<grid, threads, 0, stream>>>(P);
  return (int)cudaGetLastError();
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
// tracers; out: Gu, Gv, Gc... (padded, zeroed by the caller); scratch: 14
// padded device arrays (null where the configuration needs none); rows: the
// (kNumRows, PY) metric rows; cf: Nx, Ny, Nz, Hx, Hy, Hz, bounded x, bounded
// y, vorticity code, vorticity WENO buffer, upwind code, Coriolis code,
// tracer scheme code, number of tracers, with_ph.
int oc_fused_vi_tendency(int dtype, int sdtype, const void* const* in, void* const* out,
                         void* const* scratch, const void* rows, const int* cf, double dzc,
                         double dzf, void* stream) {
  if (cf[13] < 0 || cf[13] > kMaxTracers) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32)
    return launch<float, float>(in, out, scratch, rows, cf, dzc, dzf, s);
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64)
    return launch<float, double>(in, out, scratch, rows, cf, dzc, dzf, s);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32)
    return launch<double, float>(in, out, scratch, rows, cf, dzc, dzf, s);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64)
    return launch<double, double>(in, out, scratch, rows, cf, dzc, dzf, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
