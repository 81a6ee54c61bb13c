// Halo fills, in place: the batched periodic x/y wrap and the bounded-z fill.
//
// oc_halo_fill replaces the TPU kernel oceananigans_tpu/kernels/pallas_fill.py
// _build_batched (via get_batched_fill), and the wrap half of _build (via
// get_pallas_fill): strip DMAs that wrap x, then wrap y over the full x
// extent, so that corners carry the x-wrapped columns, each axis only where
// its flag says it is periodic (pallas_fill.py:272-273). With both flags,
// every halo slot (i, j) ends up holding the interior cell (wrap_x(i),
// wrap_y(j)); with x alone, the x-halo columns copy the wrapped columns over
// the full y extent (y halos as they stand); with y alone, the y-halo rows
// copy the wrapped rows over the full x extent (x halos as they stand, filled
// beforehand by the bounded x fill). One pass over the halo slots of all
// fields of a batch, over the full padded z (z halos included). Every slot is
// read from slots the pass does not write, so the in-place update has no
// race.
//
// oc_bounded_z_fill replaces the z-fix half of _build (pallas_fill.py:139-201,
// the pallas_call at :233), whose semantics are those of _fill_axis
// (boundary_conditions/fill_halos.py:161-278) along a bounded z: per field, a
// location (center or face in z) and a (classification, scalar value) pair
// for the bottom and for the top. Center fields: Flux/Open mirror the
// interior, Value/Gradient extrapolate linearly from the boundary cell.
// z-face fields: Open/Value pin the boundary face and reflect oddly about
// it, Flux/Gradient reflect evenly and leave the face as it is. It runs after
// the wrap over the full padded x and y, so the corner columns carry wrapped
// values, as the x -> y -> z order of the reference gives.
//
// Bound: pure data movement, launch latency dominates. The wrap moves
// (2Hx·PY + 2Nx·Hy)·PZ elements each way per field, the z-fill about
// 2Hz·PX·PY (about 2 MB per float32 field at 262³). Design: one launch for a
// batch of fields (blockIdx.y = field), one thread per halo element with z
// fastest across threads. A launch takes at most kMaxFields fields (their
// pointers and conditions ride in the parameter block); kernels/halo_fill.py
// launches once per batch of that size, and each field's fill is independent
// of the others', so the batching changes no value. The z-fill reads interior z slots only and
// writes halo and boundary-face slots only, so its in-place update has no
// race either. Copies are exact; an extrapolated slot may differ from the
// plain PyTorch version by rounding (FMA contraction, and PyTorch's division
// by a scalar multiplies by its reciprocal on the card).
#include "common.cuh"

namespace {

constexpr int kMaxFields = 32;   // fields per launch (kernels/build.py BATCH)
constexpr int kMaxHz = 8;

// Boundary classifications, as kernels/halo_fill.py numbers them.
constexpr int kFlux = 0;
constexpr int kOpen = 1;
constexpr int kValue = 2;
constexpr int kGradient = 3;

struct FieldPtrs {
  void* p[kMaxFields];
};

// Strips: with wrap_x, the two x-halo strips over the full y extent; with
// wrap_y, the two y-halo strips over the interior x (wrap_x) or the full x
// extent (no wrap_x). A slot takes the wrapped index along each wrapped axis.
template <typename T>
__global__ void halo_wrap_kernel(FieldPtrs ptrs, oc::Geom g, int wrap_x, int wrap_y,
                                 long long n_halo_cols) {
  T* a = (T*)ptrs.p[blockIdx.y];
  const int PZ = g.PZ();
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_halo_cols * PZ) return;
  const int k = (int)(n % PZ);
  long long c = n / PZ;
  const int PY = g.PY();
  const long long xstrip = wrap_x ? (long long)g.Hx * PY : 0;  // columns in one x strip
  const int ywidth = wrap_x ? g.Nx : g.PX();                     // x extent of a y strip
  const int yx0 = wrap_x ? g.Hx : 0;
  const long long ystrip = (long long)ywidth * g.Hy;             // columns in one y strip
  int i, j;
  if (c < xstrip) {                    // left x strip, full y extent
    i = (int)(c / PY); j = (int)(c % PY);
  } else if (c < 2 * xstrip) {         // right x strip, full y extent
    c -= xstrip;
    i = g.Hx + g.Nx + (int)(c / PY); j = (int)(c % PY);
  } else if (c < 2 * xstrip + ystrip) { // bottom y strip
    c -= 2 * xstrip;
    i = yx0 + (int)(c / g.Hy); j = (int)(c % g.Hy);
  } else {                             // top y strip
    c -= 2 * xstrip + ystrip;
    i = yx0 + (int)(c / g.Hy); j = g.Hy + g.Ny + (int)(c % g.Hy);
  }
  int si = i, sj = j;
  if (wrap_x) si = i < g.Hx ? i + g.Nx : (i >= g.Hx + g.Nx ? i - g.Nx : i);
  if (wrap_y) sj = j < g.Hy ? j + g.Ny : (j >= g.Hy + g.Ny ? j - g.Ny : j);
  a[g.at(i, j, k)] = a[g.at(si, sj, k)];
}

struct ZSpec {
  int face;            // 1 for a z-face field (w), 0 for a center field
  int cls_b, cls_t;    // bottom / top classification
  double v_b, v_t;     // bottom / top scalar condition (0 for none)
};

struct ZFill {
  void* p[kMaxFields];
  ZSpec spec[kMaxFields];
  double half_b, half_t;            // half the boundary-cell spacing
  double dist_b[kMaxHz];            // z_C[Hz] - z_C[s], bottom halo slot s
  double dist_t[kMaxHz];            // z_C[Hz+Nz+m] - z_C[Hz+Nz-1]
};

// Jobs per column: 2Hz + 1. Job s < Hz is bottom slot s; job Hz + m is slot
// Hz + Nz + m (top halo for centers; for faces m = 0 is the top boundary
// face); job 2Hz is the bottom boundary face of a z-face field.
template <typename T>
__global__ void bounded_z_kernel(const __grid_constant__ ZFill P, oc::Geom g) {
  const ZSpec s = P.spec[blockIdx.y];
  const int H = g.Hz, N = g.Nz, jobs = 2 * H + 1;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)g.PX() * g.PY() * jobs) return;
  const int job = (int)(n % jobs);
  T* c = (T*)P.p[blockIdx.y] + (n / jobs) * g.PZ();
  const bool pin_b = s.cls_b == kOpen || s.cls_b == kValue;
  const bool pin_t = s.cls_t == kOpen || s.cls_t == kValue;
  if (!s.face) {
    if (job == 2 * H) return;
    if (job < H) {
      if (s.cls_b == kFlux || s.cls_b == kOpen) {
        c[job] = c[2 * H - 1 - job];
      } else {
        const T c1 = c[H];
        const T grad = s.cls_b == kGradient ? (T)s.v_b : (c1 - (T)s.v_b) / (T)P.half_b;
        c[job] = c1 - grad * (T)P.dist_b[job];
      }
    } else {
      const int m = job - H;
      if (s.cls_t == kFlux || s.cls_t == kOpen) {
        c[H + N + m] = c[H + N - 1 - m];
      } else {
        const T cN = c[H + N - 1];
        const T grad = s.cls_t == kGradient ? (T)s.v_t : ((T)s.v_t - cN) / (T)P.half_t;
        c[H + N + m] = cN + grad * (T)P.dist_t[m];
      }
    }
    return;
  }
  if (job < H) {
    const T r = c[2 * H - job];
    c[job] = pin_b ? (T)(2.0 * s.v_b) - r : r;
  } else if (job == 2 * H) {
    if (pin_b) c[H] = (T)s.v_b;
  } else {
    const int m = job - H;
    if (m == 0) {
      if (pin_t) c[H + N] = (T)s.v_t;
    } else {
      const T r = c[H + N - m];
      c[H + N + m] = pin_t ? (T)(2.0 * s.v_t) - r : r;
    }
  }
}

}  // namespace

extern "C" {

const char* oc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Fill the periodic x/y halos of `nf` padded arrays of one shape in place,
// over the full padded z; wrap_x / wrap_y (0 or 1) say which axes wrap.
// `ptrs` is a host array of nf device pointers; elem_size is 4 or 8.
int oc_halo_fill(void* const* ptrs, int nf, int elem_size, int Nx, int Ny, int Nz,
                 int Hx, int Hy, int Hz, int wrap_x, int wrap_y, void* stream) {
  if (nf < 1 || nf > kMaxFields) return (int)cudaErrorInvalidValue;
  FieldPtrs fp;
  for (int f = 0; f < kMaxFields; ++f) fp.p[f] = f < nf ? ptrs[f] : nullptr;
  oc::Geom g{Nx, Ny, Nz, Hx, Hy, Hz};
  long long cols = (wrap_x ? 2LL * Hx * g.PY() : 0)
                 + (wrap_y ? 2LL * (wrap_x ? Nx : g.PX()) * Hy : 0);
  if (cols == 0) return (int)cudaSuccess;
  const int threads = 256;
  dim3 grid(oc::blocks_for(cols * g.PZ(), threads), nf);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 4)
    halo_wrap_kernel<float><<<grid, threads, 0, s>>>(fp, g, wrap_x, wrap_y, cols);
  else if (elem_size == 8)
    halo_wrap_kernel<double><<<grid, threads, 0, s>>>(fp, g, wrap_x, wrap_y, cols);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Fill the bounded-z halos of `nf` padded arrays in place. Per field f:
// face[f], cls_b[f], cls_t[f] (0 Flux, 1 Open, 2 Value, 3 Gradient) and the
// scalar conditions v_b[f], v_t[f]. half_b, half_t, dist_b[Hz], dist_t[Hz]
// are the grid's z distances (float64, from its center coordinates).
int oc_bounded_z_fill(void* const* ptrs, int nf, int elem_size, const int* face,
                      const int* cls_b, const int* cls_t, const double* v_b,
                      const double* v_t, int Nx, int Ny, int Nz, int Hx, int Hy,
                      int Hz, double half_b, double half_t, const double* dist_b,
                      const double* dist_t, void* stream) {
  if (nf < 1 || nf > kMaxFields || Hz < 1 || Hz > kMaxHz || Nz < Hz + 1)
    return (int)cudaErrorInvalidValue;
  ZFill P;
  for (int f = 0; f < kMaxFields; ++f) {
    const bool on = f < nf;
    P.p[f] = on ? ptrs[f] : nullptr;
    P.spec[f] = ZSpec{on ? face[f] : 0, on ? cls_b[f] : 0, on ? cls_t[f] : 0,
                      on ? v_b[f] : 0.0, on ? v_t[f] : 0.0};
  }
  P.half_b = half_b;
  P.half_t = half_t;
  for (int m = 0; m < kMaxHz; ++m) {
    P.dist_b[m] = m < Hz ? dist_b[m] : 0.0;
    P.dist_t[m] = m < Hz ? dist_t[m] : 0.0;
  }
  oc::Geom g{Nx, Ny, Nz, Hx, Hy, Hz};
  const long long n = (long long)g.PX() * g.PY() * (2 * Hz + 1);
  const int threads = 256;
  dim3 grid(oc::blocks_for(n, threads), nf);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 4)
    bounded_z_kernel<float><<<grid, threads, 0, s>>>(P, g);
  else if (elem_size == 8)
    bounded_z_kernel<double><<<grid, threads, 0, s>>>(P, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
