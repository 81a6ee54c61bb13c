// Batched periodic halo fill, in place.
//
// Replaces the TPU kernel oceananigans_tpu/kernels/pallas_fill.py
// _build_batched (via get_batched_fill), and the wrap half of _build (via
// get_pallas_fill): strip DMAs that wrap x, then wrap y over the full x
// extent, so that corners carry the x-wrapped columns. Done in that order,
// every halo slot (i, j) ends up holding the interior cell (wrap_x(i),
// wrap_y(j)); this kernel writes exactly that, in one pass over the halo
// slots of all fields of a batch. It reads interior cells only and writes
// halo cells only, so the in-place update has no race.
//
// Bound: pure data movement, (2Hx·PY + 2Nx·Hy)·Nz elements read and written
// per field; at 264x264x256 float32 that is about 4.3 MB each way per field,
// a few microseconds of HBM time, so launch latency dominates. Design: one
// launch for the whole batch (blockIdx.y = field), one thread per halo
// element with z fastest across threads, so both the read and the write of a
// warp are contiguous.
#include "common.cuh"

namespace {

constexpr int kMaxFields = 16;

struct FieldPtrs {
  void* p[kMaxFields];
};

template <typename T>
__global__ void halo_wrap_kernel(FieldPtrs ptrs, oc::Geom g, long long n_halo_cols) {
  T* a = (T*)ptrs.p[blockIdx.y];
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_halo_cols * g.Nz) return;
  const int k = (int)(n % g.Nz);
  long long c = n / g.Nz;
  const int PY = g.PY();
  const long long xstrip = (long long)g.Hx * PY;   // columns in one x strip
  const long long ystrip = (long long)g.Nx * g.Hy; // columns in one y strip
  int i, j;
  if (c < xstrip) {                    // left x strip, full y extent
    i = (int)(c / PY); j = (int)(c % PY);
  } else if (c < 2 * xstrip) {         // right x strip, full y extent
    c -= xstrip;
    i = g.Hx + g.Nx + (int)(c / PY); j = (int)(c % PY);
  } else if (c < 2 * xstrip + ystrip) { // bottom y strip, interior x
    c -= 2 * xstrip;
    i = g.Hx + (int)(c / g.Hy); j = (int)(c % g.Hy);
  } else {                             // top y strip, interior x
    c -= 2 * xstrip + ystrip;
    i = g.Hx + (int)(c / g.Hy); j = g.Hy + g.Ny + (int)(c % g.Hy);
  }
  int si = i < g.Hx ? i + g.Nx : (i >= g.Hx + g.Nx ? i - g.Nx : i);
  int sj = j < g.Hy ? j + g.Ny : (j >= g.Hy + g.Ny ? j - g.Ny : j);
  a[g.at(i, j, k)] = a[g.at(si, sj, k)];
}

}  // namespace

extern "C" {

const char* oc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Fill the periodic x/y halos of `nf` padded arrays of one shape in place.
// `ptrs` is a host array of nf device pointers; elem_size is 4 or 8.
int oc_halo_fill(void* const* ptrs, int nf, int elem_size, int Nx, int Ny, int Nz,
                 int Hx, int Hy, void* stream) {
  if (nf < 1 || nf > kMaxFields) return (int)cudaErrorInvalidValue;
  FieldPtrs fp;
  for (int f = 0; f < kMaxFields; ++f) fp.p[f] = f < nf ? ptrs[f] : nullptr;
  oc::Geom g{Nx, Ny, Nz, Hx, Hy};
  long long cols = 2LL * Hx * g.PY() + 2LL * Nx * Hy;
  if (cols == 0) return (int)cudaSuccess;
  const int threads = 256;
  dim3 grid(oc::blocks_for(cols * Nz, threads), nf);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 4)
    halo_wrap_kernel<float><<<grid, threads, 0, s>>>(fp, g, cols);
  else if (elem_size == 8)
    halo_wrap_kernel<double><<<grid, threads, 0, s>>>(fp, g, cols);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
