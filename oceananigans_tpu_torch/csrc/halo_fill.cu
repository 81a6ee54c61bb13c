// Halo fills, in place: every halo slot along every axis, and every pinned
// boundary face, of a batch of padded fields in one launch.
//
// oc_fill_halos replaces both TPU fill kernels of
// oceananigans_tpu/kernels/pallas_fill.py: _build_batched (via
// get_batched_fill, the periodic x/y wrap of a batch of fields) and _build
// (via get_pallas_fill, the wrap followed by the bounded-z fix), and the
// bounded x/y fills that the JAX package leaves to XLA. It computes what the
// reference's x -> y -> z sequence of fills computes
// (oceananigans_tpu/boundary_conditions/fill_halos.py _fill_axis), corners
// included.
//
// Design: each written slot comes from one read-only slot. Along each axis a
// fill maps a source slot to each halo slot (kernels/halo_fill.py numbers the
// maps): a periodic wrap copies wrap(n); a center field under Flux/Open
// mirrors the interior; under Value/Gradient it extrapolates from the
// boundary cell c1 alone (c1 - grad·dist); a face field under Open/Value pins
// its boundary face to v (reading nothing) and reflects oddly (2v - r), under
// Flux/Gradient it reflects evenly. The x fill runs over the full y and z,
// the y fill over the full x and z, so after x -> y -> z slot (i, j, k)
// holds Fz_k(Fy_j(Fx_i(a[sx(i), sy(j), sz(k)]))), where each source index is
// an interior slot that no map writes and each map is the identity there.
// One thread forms a slot's final value from one load, applying the three
// maps in order, in the plain version's arithmetic order; no slot that a
// thread reads is written in the launch, so the in-place update has no race.
// The source indices stay unwritten because each axis's map sends every
// slot it writes to a slot that axis leaves as it is. A periodic axis needs
// N >= H for that, and the wrapper and oc_fill_plan refuse less. On a
// bounded axis narrower than its halo needs (N < H for a center field, N <
// H + 1 for a pinned face field), the far halo slots whose source the axis
// itself writes keep their value: the axis's map is the identity there
// (JAX's fill reads that source before it writes it; no stencil of the
// models reaches that far).
//
// Two maps couple x and y. The tripolar north fold (kFold, kFoldFace, on
// the high y side) reads north halo row j from interior row 2E - 2 - j
// (2E - 1 - j for a y-face field, E = Hy + Ny) with x reversed over the
// interior, times the field's sign; an x-face field rolls the reversed index
// by one and keeps the sign of its wrap element. For a field centred in y
// the eastern half of the last interior row takes its folded western half.
// JAX folds the interior x first and wraps x after, so a slot first takes
// its x map into the interior and then folds: still one interior read. The
// one column that reads itself (an x-face field's column Nx/2 of that row,
// Nx even) is filled by one thread, its z ends before its interior; with an
// odd Nx two columns of that row would swap, so oc_fill_plan refuses it. The
// polar cap (kPolarValue, kPolarPinned) extrapolates to, or pins to, the
// zonal mean of the boundary row, which the wrapper computes beforehand into
// a (field, side, z) table; a slot takes the mean at its z source.
//
// Planes: a side's value may vary over the boundary plane (array, callable
// and FieldTimeSeries conditions, evaluated per call by the wrapper over the
// padded transverse extents). kValue, kGradient and kPinned then read the
// plane in place of the scalar, at the slot's position in the sequential
// fill: an x side at the slot's y and z sources (the x fill ran over every
// y and z, and the y and z fills read from those sources), a y side at the
// slot's x and its z source, a z side at the slot's x and y. kPerturbation
// (PerturbationAdvection under a fill given the stage's dt) pins the
// boundary face and every halo slot beyond it to its plane, the face value
// that the wrapper computes before the launch from the face, the face
// inside it and the exterior value (the kernel cannot: that face is a slot
// other blocks write). The planes of a launch are one buffer; each field's
// side holds its offset there, or -1.
//
// Work: per field, the columns (i, j) outside the unwritten x/y box are
// written whole, along z, from their source column: a group of threads per
// column (a warp for a long column, one thread for a 2-D field), 16-byte
// accesses where a row is 16-byte aligned (the z-compact 256, the hydrostatic
// 44). The columns inside the box have only their z ends written (a group of
// up to 2Hz + 1 threads per column, a lane per written slot), a thread the
// same slot of several columns, all loaded before any is stored, so that
// loads stay in flight although the stores may not pass them. Index
// arithmetic is 32-bit; a column's (i, j) is decomposed once per column a
// thread visits. blockIdx.y is the field, blockIdx.x runs over its
// whole-column blocks and then its z-end blocks.
//
// Bound: pure data movement, each written slot read once and written once.
// The z ends of an interior column are a few bytes at both ends of a row, so
// 32-byte DRAM sectors, and not the bytes, set the floor of a bounded-z fill.
// Every slot equals the plain PyTorch version's bit for bit: an
// extrapolation rounds its quotient, product and sum one at a time (the
// products are never contracted into an FMA), as the plain version's
// separate operations do, and the plain version divides by a tensor on the
// field's device (PyTorch multiplies by the reciprocal of a scalar divisor
// on the card).
#include "common.cuh"

namespace {

constexpr int kMaxFields = 32;  // fields per launch (kernels/build.py BATCH)
constexpr int kMaxH = 8;        // halo width of a bounded axis
constexpr int kThreads = 256;

// Side codes, as kernels/halo_fill.py numbers them.
constexpr int kKeep = 0;      // the axis is not filled
constexpr int kWrap = 1;      // periodic
constexpr int kMirror = 2;    // center field, Flux or Open
constexpr int kValue = 3;     // center field, Value: extrapolate from c1
constexpr int kGradient = 4;  // center field, Gradient: extrapolate from c1
constexpr int kPinned = 5;    // face field, Open or Value: pin, reflect oddly
constexpr int kReflect = 6;   // face field, Flux or Gradient: reflect evenly
constexpr int kFold = 7;      // tripolar north fold, field centred in y
constexpr int kFoldFace = 8;  // tripolar north fold, y-face field
constexpr int kPolarValue = 9;    // polar cap, center field
constexpr int kPolarPinned = 10;  // polar cap, face field
constexpr int kPerturbation = 11; // face field, PerturbationAdvection: face and halo take the plane
constexpr int kLastCode = kPerturbation;

// What a map does to the value it reads.
constexpr int kCopy = 0, kPin = 1, kOdd = 2, kValueLo = 3, kValueHi = 4,
              kGradLo = 5, kGradHi = 6,
              kFoldRow = 7,    // read the folded slot, times the sign
              kSubstRow = 8;   // the last row of a centre-y fold: fold the eastern half

struct Axis {
  int N, H, P;                // interior cells, halo, padded extent
  double half[2];             // half the spacing of the low / high boundary cell
  double dist[2][kMaxH];      // low: x[H] - x[m]; high: x[H+N+m] - x[H+N-1]
};

struct Field {
  void* p;
  signed char code[3][2];     // per axis: low side, high side
  signed char face_x;         // an x-face field (the fold's x reversal)
  signed char polar;          // a polar cap on a y side
  signed char planes_xy;      // a plane on an x or y side
  double v[3][2];             // scalar conditions (0 for none); a fold's sign
  int plane[3][2];            // offsets of the sides' planes in the buffer, or -1
  int whole_blocks, end_blocks;
};

struct Params {
  Axis ax[3];
  Field f[kMaxFields];
  const void* means;          // polar caps: [field][side][z] zonal means
  const void* planes;         // the planes of the launch's fields
  int nf, elem_size;
  int whole_shift, end_shift;  // log2 of the threads per column
  int blocks;                  // gridDim.x
};

static_assert(sizeof(Params) <= 4096, "kernel parameter block too large");

// The slots [lo, hi) along an axis that its map leaves as they are: a kept
// side (an axis that is not filled, or a shard's side that the halo
// exchange fills) leaves its whole halo.
__host__ __device__ __forceinline__ void kept(const Axis& a, const signed char* c,
                                              int& lo, int& hi) {
  lo = c[0] == kKeep ? 0
                     : a.H + (c[0] == kPinned || c[0] == kPolarPinned ||
                              c[0] == kPerturbation);
  hi = c[1] == kKeep ? a.P : a.H + a.N + (c[1] == kReflect) - (c[1] == kFold);
}

template <typename T>
struct Map {
  int src, op;
  T v, half, dist;
  int polar;  // -1, or the side (0 low, 1 high) whose zonal mean v takes
  int plane;  // -1, or the offset of the plane v takes
};

template <typename T>
__host__ __device__ __forceinline__ Map<T> mk(int src, int op, T v, T half, T dist,
                                              int polar = -1) {
  Map<T> m;
  m.src = src; m.op = op; m.v = v; m.half = half; m.dist = dist; m.polar = polar;
  m.plane = -1;
  return m;
}

template <typename T>
__host__ __device__ __forceinline__ Map<T> side_map_scalar(const Axis& a,
                                                           const signed char* c,
                                                           const double* v, int lo,
                                                           int hi, int n) {
  if (n >= lo && n < hi) return mk<T>(n, kCopy, T(0), T(1), T(0));
  const int H = a.H, E = a.H + a.N;  // E: the first slot past the interior
  if (n < lo) {
    switch (c[0]) {
      case kPerturbation: return mk<T>(n, kPin, T(0), T(1), T(0));
      case kWrap: return mk<T>(n + a.N, kCopy, T(0), T(1), T(0));
      case kMirror: return mk<T>(2 * H - 1 - n, kCopy, T(0), T(1), T(0));
      case kValue: return mk<T>(H, kValueLo, (T)v[0], (T)a.half[0], (T)a.dist[0][n]);
      case kPolarValue:
        return mk<T>(H, kValueLo, T(0), (T)a.half[0], (T)a.dist[0][n], 0);
      case kGradient: return mk<T>(H, kGradLo, (T)v[0], T(1), (T)a.dist[0][n]);
      case kPinned:
        return n == H ? mk<T>(n, kPin, (T)v[0], T(1), T(0))
                      : mk<T>(2 * H - n, kOdd, (T)(2.0 * v[0]), T(1), T(0));
      case kPolarPinned:
        return n == H ? mk<T>(n, kPin, T(0), T(1), T(0), 0)
                      : mk<T>(2 * H - n, kOdd, T(0), T(1), T(0), 0);
      default: return mk<T>(2 * H - n, kCopy, T(0), T(1), T(0));  // kReflect
    }
  }
  switch (c[1]) {
    case kPerturbation: return mk<T>(n, kPin, T(0), T(1), T(0));
    case kWrap: return mk<T>(n - a.N, kCopy, T(0), T(1), T(0));
    case kMirror: return mk<T>(2 * E - 1 - n, kCopy, T(0), T(1), T(0));
    case kValue:
      return mk<T>(E - 1, kValueHi, (T)v[1], (T)a.half[1], (T)a.dist[1][n - E]);
    case kPolarValue:
      return mk<T>(E - 1, kValueHi, T(0), (T)a.half[1], (T)a.dist[1][n - E], 1);
    case kGradient:
      return mk<T>(E - 1, kGradHi, (T)v[1], T(1), (T)a.dist[1][n - E]);
    case kPinned:
      return n == E ? mk<T>(n, kPin, (T)v[1], T(1), T(0))
                    : mk<T>(2 * E - n, kOdd, (T)(2.0 * v[1]), T(1), T(0));
    case kPolarPinned:
      return n == E ? mk<T>(n, kPin, T(0), T(1), T(0), 1)
                    : mk<T>(2 * E - n, kOdd, T(0), T(1), T(0), 1);
    case kFold:
      return n == E - 1 ? mk<T>(n, kSubstRow, (T)v[1], T(1), T(0))
                        : mk<T>(2 * E - 2 - n, kFoldRow, (T)v[1], T(1), T(0));
    case kFoldFace: return mk<T>(2 * E - 1 - n, kFoldRow, (T)v[1], T(1), T(0));
    default: return mk<T>(2 * E - n, kCopy, T(0), T(1), T(0));  // kReflect
  }
}

// The side's map with the offset of the side's plane, where it reads one
// (kValue, kGradient, kPinned with a plane condition; kPerturbation).
template <typename T>
__host__ __device__ __forceinline__ Map<T> side_map(const Axis& a, const signed char* c,
                                                    const double* v, const int* pl,
                                                    int lo, int hi, int n) {
  Map<T> m = side_map_scalar<T>(a, c, v, lo, hi, n);
  if (m.op != kCopy && m.op != kFoldRow && m.op != kSubstRow && m.polar < 0) {
    const int s = n < lo ? 0 : 1;
    if (pl[s] >= 0) m.plane = pl[s];
  }
  return m;
}

// The map of slot n along an axis: its side's map, or the identity where
// that reads a slot the axis writes (a bounded axis narrower than its halo
// needs; the fold's substituted row reads its own slots through the x fold).
template <typename T>
__host__ __device__ __forceinline__ Map<T> map_at(const Axis& a, const signed char* c,
                                                  const double* v, const int* pl,
                                                  int lo, int hi, int n) {
  const Map<T> m = side_map<T>(a, c, v, pl, lo, hi, n);
  if (m.op != kPin && m.op != kSubstRow && (m.src < lo || m.src >= hi))
    return mk<T>(n, kCopy, T(0), T(1), T(0));
  return m;
}

// A polar-cap map takes its value from the zonal mean at z slot kz (twice
// it for the odd reflection, as 2v - r).
template <typename T>
__device__ __forceinline__ Map<T> with_mean(Map<T> m, const T* means, int kz, int PZ) {
  if (m.polar >= 0) {
    const T mean = means[m.polar * PZ + kz];
    m.v = m.op == kOdd ? T(2) * mean : mean;
  }
  return m;
}

// A plane map takes its value from the plane at index `at` of its transverse
// extents (twice it for the odd reflection, as 2v - r).
template <typename T>
__device__ __forceinline__ Map<T> with_plane(Map<T> m, const T* planes, int at) {
  if (m.plane >= 0) {
    const T v = planes[m.plane + at];
    m.v = m.op == kOdd ? T(2) * v : v;
  }
  return m;
}

// The fold's x source and factor: x reversed over the interior (rolled by
// one for an x-face field, whose wrap element i = 0 keeps its sign), times
// the sign.
template <typename T>
__device__ __forceinline__ void fold_x(const Axis& X, bool face_x, T sign, int& sx, T& s) {
  const int i0 = sx - X.H;
  const bool wrap_element = face_x && i0 == 0;
  sx = X.H + (face_x ? (wrap_element ? 0 : X.N - i0) : X.N - 1 - i0);
  s = wrap_element ? (sign < T(0) ? -sign : sign) : sign;
}

// A rounded product that the compiler may not contract into an FMA.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// The plain version's arithmetic: grad = (c1 - v) / half, c1 - grad·dist.
template <typename T>
__device__ __forceinline__ T apply(const Map<T>& m, T r) {
  switch (m.op) {
    case kPin: return m.v;
    case kOdd: return m.v - r;
    case kValueLo: return r - mul_rn((r - m.v) / m.half, m.dist);
    case kValueHi: return r + mul_rn((m.v - r) / m.half, m.dist);
    case kGradLo: return r - mul_rn(m.v, m.dist);
    case kGradHi: return r + mul_rn(m.v, m.dist);
    default: return r;
  }
}

template <typename T, int V> struct Vec { using type = T; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 2> { using type = double2; };

// Column c of a field's whole columns (outside the kept x/y box: the low
// and high x strips over the full y, then the low and high y strips over the
// kept x) as (i, j); false past the last one.
__device__ __forceinline__ bool whole_column(int c, int PX, int PY, int xlo, int xhi,
                                             int ylo, int yhi, int& i, int& j) {
  const int low_x = xlo * PY, high_x = (PX - xhi) * PY, nxk = xhi - xlo;
  if (c < low_x) {
    i = c / PY; j = c - i * PY;
    return true;
  }
  c -= low_x;
  if (c < high_x) {
    i = c / PY; j = c - i * PY; i += xhi;
    return true;
  }
  c -= high_x;
  if (c < nxk * ylo) {
    i = c / ylo; j = c - i * ylo; i += xlo;
    return true;
  }
  c -= nxk * ylo;
  const int w = PY - yhi;
  if (c < nxk * w) {
    i = c / w; j = c - i * w; i += xlo; j += yhi;
    return true;
  }
  return false;
}

// A thread of the z ends loads one slot of this many columns before it uses
// any of them: a load stalls the thread only where its value is first used,
// so the batch's loads are in flight together. Its stores follow.
constexpr int kEndItems = 8;

// V values per access: 16 / sizeof(T) where every row is 16-byte aligned,
// else 1. Offsets are 32-bit (the wrapper takes fields of < 2^31 values).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) fill_halos_kernel(const __grid_constant__ Params P) {
  using VT = typename Vec<T, V>::type;
  const Field& f = P.f[blockIdx.y];
  T* a = (T*)f.p;
  const Axis &X = P.ax[0], &Y = P.ax[1], &Z = P.ax[2];
  int xlo, xhi, ylo, yhi, zlo, zhi;
  kept(X, f.code[0], xlo, xhi);
  kept(Y, f.code[1], ylo, yhi);
  kept(Z, f.code[2], zlo, zhi);
  const int PY = Y.P, PZ = Z.P, nxk = xhi - xlo, nyk = yhi - ylo;
  const T* planes = (const T*)P.planes;
  int b = blockIdx.x;
  if (b < f.whole_blocks) {
    // a whole column: a group of W lanes, each lane its chunks lane,
    // lane + W, ... (the loads of one column cannot pass its stores, so the
    // parallelism is across groups)
    const int shift = P.whole_shift, W = 1 << shift;
    int i, j;
    if (!whole_column(b * (kThreads >> shift) + (threadIdx.x >> shift), X.P, PY,
                      xlo, xhi, ylo, yhi, i, j))
      return;
    const Map<T> mx = map_at<T>(X, f.code[0], f.v[0], f.plane[0], xlo, xhi, i);
    Map<T> my = map_at<T>(Y, f.code[1], f.v[1], f.plane[1], ylo, yhi, j);
    int sx = mx.src;
    T s = T(1);
    const bool fold = my.op == kFoldRow ||
                      (my.op == kSubstRow && sx - X.H >= X.N / 2);
    if (fold) fold_x(X, f.face_x, my.v, sx, s);
    if (my.op == kFoldRow || my.op == kSubstRow) my.op = kCopy;
    const bool pinned = mx.op == kPin || my.op == kPin;
    const T* means = f.polar ? (const T*)P.means + blockIdx.y * 2 * PZ : nullptr;
    const T* src = a + (sx * PY + my.src) * PZ;
    T* dst = a + (i * PY + j) * PZ;
    if (src == dst && !pinned) {
      // the column reads itself: one thread, its z ends before its interior
      // (which it leaves as it is unless the fold changes it)
      if ((threadIdx.x & (W - 1)) != 0) return;
      for (int pass = 0; pass < 2; ++pass)
        for (int k = 0; k < PZ; ++k) {
          const bool inner = k >= zlo && k < zhi;
          if (inner != (pass == 1) || (inner && !fold)) continue;
          const Map<T> mz = with_plane(
              map_at<T>(Z, f.code[2], f.v[2], f.plane[2], zlo, zhi, k), planes,
              i * PY + j);
          const T r = mz.op == kPin ? T(0) : src[mz.src] * s;
          dst[k] = apply(mz, r);
        }
      return;
    }
    for (int q = threadIdx.x & (W - 1); q < PZ / V; q += W) {
      const int k0 = q * V;
      if (V > 1 && !pinned && !f.polar && !f.planes_xy && k0 >= zlo &&
          k0 + V <= zhi) {
        VT val = *reinterpret_cast<const VT*>(src + k0);
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int v = 0; v < V; ++v)
          e[v] = apply(my, apply(mx, fold ? e[v] * s : e[v]));
        *reinterpret_cast<VT*>(dst + k0) = val;
        continue;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const Map<T> mz = with_plane(
            map_at<T>(Z, f.code[2], f.v[2], f.plane[2], zlo, zhi, k0 + v), planes,
            i * PY + j);
        const Map<T> myk = with_plane(with_mean(my, means, mz.src, PZ), planes,
                                      i * PZ + mz.src);
        const Map<T> mxk = with_plane(mx, planes, my.src * PZ + mz.src);
        T r = pinned || mz.op == kPin ? T(0) : src[mz.src];
        if (fold) r = r * s;
        dst[k0 + v] = apply(mz, apply(myk, apply(mxk, r)));
      }
    }
    return;
  }
  // the z ends of the columns inside the kept x/y box: lane t of a group
  // owns written slot t of each column the group visits, kEndItems columns
  // G apart
  b -= f.whole_blocks;
  if (b >= f.end_blocks) return;
  const int shift = P.end_shift, G = kThreads >> shift;
  const int t = threadIdx.x & ((1 << shift) - 1);
  if (t >= zlo + PZ - zhi) return;
  const int k = t < zlo ? t : zhi + (t - zlo);
  const Map<T> mz = map_at<T>(Z, f.code[2], f.v[2], f.plane[2], zlo, zhi, k);
  if (mz.op == kCopy && mz.src == k) return;  // a slot a narrow z keeps
  const int ncols = nxk * nyk;
  int c = b * G * kEndItems + (threadIdx.x >> shift);
  int ci = c / nyk, cj = c - ci * nyk;
  T val[kEndItems];
  int col[kEndItems];
#pragma unroll
  for (int u = 0; u < kEndItems; ++u) {
    col[u] = c < ncols ? ((xlo + ci) * PY + ylo + cj) * PZ : -1;
    val[u] = col[u] >= 0 && mz.op != kPin ? a[col[u] + mz.src] : T(0);
    c += G;
    for (cj += G; cj >= nyk; cj -= nyk) ++ci;
  }
#pragma unroll
  for (int u = 0; u < kEndItems; ++u)
    if (col[u] >= 0)
      a[col[u] + k] = apply(with_plane(mz, planes, col[u] / PZ), val[u]);
}

int log2_at_least(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

// Blocks for `columns` columns, a block covering (kThreads >> shift) x
// passes of them.
int blocks_of(long long columns, int shift, int passes) {
  const long long per = (long long)(kThreads >> shift) * passes;
  return (int)((columns + per - 1) / per);
}

}  // namespace

extern "C" {

const char* oc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int oc_fill_params_size() { return (int)sizeof(Params); }

// Build the parameter block of one launch into `out` (oc_fill_params_size()
// bytes, pointers left null): nf fields of one padded shape, elem_size 4 or
// 8. Per axis a (x, y, z): N[a], H[a], P[a]; half[2a + s] and dist[(2a +
// s)·kMaxH + m] for its low (s = 0) and high (s = 1) side (float64, from the
// grid's center coordinates). Per field f: codes[6f + 2a + s],
// values[6f + 2a + s] (a fold's sign), face_x[f] (an x-face field), and
// plane_offsets[6f + 2a + s]: the offset of the side's plane in the planes
// buffer (elements; its transverse extents in axis order, contiguous), or
// -1.
int oc_fill_plan(void* out, int nf, int elem_size, const int* N, const int* H,
                 const int* P, const double* half, const double* dist,
                 const int* codes, const double* values, const int* face_x,
                 const int* plane_offsets) {
  if (nf < 1 || nf > kMaxFields || (elem_size != 4 && elem_size != 8) ||
      (long long)P[0] * P[1] * P[2] >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Params* p = (Params*)out;
  memset(p, 0, sizeof(Params));
  for (int a = 0; a < 3; ++a) {
    if (H[a] < 0 || H[a] > kMaxH || P[a] != N[a] + 2 * H[a])
      return (int)cudaErrorInvalidValue;
    p->ax[a].N = N[a];
    p->ax[a].H = H[a];
    p->ax[a].P = P[a];
    for (int s = 0; s < 2; ++s) {
      p->ax[a].half[s] = half[2 * a + s];
      for (int m = 0; m < kMaxH; ++m) p->ax[a].dist[s][m] = dist[(2 * a + s) * kMaxH + m];
    }
  }
  p->nf = nf;
  p->elem_size = elem_size;
  const int vec = (P[2] * elem_size) % 16 == 0 ? 16 / elem_size : 1;
  const int chunks = P[2] / vec;
  p->whole_shift = log2_at_least(chunks < 32 ? chunks : 32);
  int end_slots = 0;
  for (int f = 0; f < nf; ++f) {
    p->f[f].face_x = (signed char)(face_x[f] != 0);
    for (int a = 0; a < 3; ++a)
      for (int s = 0; s < 2; ++s) {
        const int c = codes[6 * f + 2 * a + s];
        const bool fold = c == kFold || c == kFoldFace;
        const bool polar = c == kPolarValue || c == kPolarPinned;
        // folds on the north side, polar caps on the y sides only
        if (c < kKeep || c > kLastCode || (c != kKeep && H[a] == 0) ||
            (c == kWrap && N[a] < H[a]) || (fold && (a != 1 || s != 1)) ||
            (polar && a != 1))
          return (int)cudaErrorInvalidValue;
        const int off = plane_offsets[6 * f + 2 * a + s];
        // a plane belongs to a side whose map reads a value; the
        // perturbation face always reads one
        if ((off >= 0 && c != kValue && c != kGradient && c != kPinned &&
             c != kPerturbation) ||
            (off < 0 && c == kPerturbation))
          return (int)cudaErrorInvalidValue;
        p->f[f].code[a][s] = (signed char)c;
        p->f[f].v[a][s] = values[6 * f + 2 * a + s];
        p->f[f].plane[a][s] = off;
        if (off >= 0 && a < 2) p->f[f].planes_xy = 1;
        if (polar) p->f[f].polar = 1;
      }
    const int cy = p->f[f].code[1][1];
    // an x-face field centred in y with an odd Nx would swap two columns of
    // the substituted row
    if ((cy == kFold || cy == kFoldFace) &&
        (p->f[f].code[0][0] != kWrap || N[0] <= 2 * H[0] ||
         (cy == kFold && p->f[f].face_x && N[0] % 2)))
      return (int)cudaErrorInvalidValue;
    int zlo, zhi;
    kept(p->ax[2], p->f[f].code[2], zlo, zhi);
    if (zlo + P[2] - zhi > end_slots) end_slots = zlo + P[2] - zhi;
  }
  p->end_shift = log2_at_least(end_slots > 0 ? end_slots : 1);
  for (int f = 0; f < nf; ++f) {
    int lo[3], hi[3];
    for (int a = 0; a < 3; ++a) kept(p->ax[a], p->f[f].code[a], lo[a], hi[a]);
    const long long kept_cols = (long long)(hi[0] - lo[0]) * (hi[1] - lo[1]);
    const long long whole = (long long)P[0] * P[1] - kept_cols;
    const bool ends = lo[2] > 0 || hi[2] < P[2];
    p->f[f].whole_blocks = blocks_of(whole, p->whole_shift, 1);
    p->f[f].end_blocks = ends ? blocks_of(kept_cols, p->end_shift, kEndItems) : 0;
    const int blocks = p->f[f].whole_blocks + p->f[f].end_blocks;
    if (blocks > p->blocks) p->blocks = blocks;
  }
  return (int)cudaSuccess;
}

// Fill the halos of nf fields in place: `params` from oc_fill_plan (a host
// copy; its pointers are ignored), `ptrs` a host array of nf device pointers.
// `means`: the polar caps' device table [field][side][z] of the field
// dtype (kernels/halo_fill.py polar_means), or null without polar caps;
// `planes`: the launch's planes of the field dtype (kernels/halo_fill.py
// plane_table), or null without them.
int oc_fill_halos(const void* params, void* const* ptrs, int nf, const void* means,
                  const void* planes, void* stream) {
  Params p;
  memcpy(&p, params, sizeof(Params));
  if (nf != p.nf) return (int)cudaErrorInvalidValue;
  p.means = means;
  p.planes = planes;
  for (int f = 0; f < nf; ++f) {
    if (p.f[f].polar && means == nullptr) return (int)cudaErrorInvalidValue;
    for (int a = 0; a < 3; ++a)
      for (int s = 0; s < 2; ++s)
        if (p.f[f].plane[a][s] >= 0 && planes == nullptr)
          return (int)cudaErrorInvalidValue;
  }
  if (p.blocks == 0) return (int)cudaSuccess;
  bool aligned = (p.ax[2].P * p.elem_size) % 16 == 0;
  for (int f = 0; f < nf; ++f) {
    p.f[f].p = ptrs[f];
    aligned = aligned && ((uintptr_t)ptrs[f] % 16 == 0);
  }
  dim3 grid(p.blocks, nf);
  cudaStream_t s = (cudaStream_t)stream;
  if (p.elem_size == 4) {
    if (aligned)
      fill_halos_kernel<float, 4><<<grid, kThreads, 0, s>>>(p);
    else
      fill_halos_kernel<float, 1><<<grid, kThreads, 0, s>>>(p);
  } else {
    if (aligned)
      fill_halos_kernel<double, 2><<<grid, kThreads, 0, s>>>(p);
    else
      fill_halos_kernel<double, 1><<<grid, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
