// The two stencil passes around the pressure solve.
//
// oc_fused_divergence replaces oceananigans_tpu/kernels/fused_projection.py
// build_fused_divergence (dct_z=False): rhs = div(u, v, w) / Δt on the
// interior, w's bottom boundary face read as 0 (the pin) and its missing top
// face as 0 (the lid).
//
// oc_fused_correct replaces build_fused_correct: u, v, w <- u*, v*, w* -
// Δt ∇p from a padded p with valid halos, w's bottom face pinned to 0, each
// result stored with its periodic x/y halo images (the strip DMAs of the
// TPU kernel), so the next stage reads it without a fill.
//
// Bound: memory. The divergence reads 3 fields and writes 1 (16 B per cell
// in float32, plus the neighbour reads that hit L1/L2); the correction reads
// 4 and writes 3 (28 B per cell). Design: one thread per interior cell with
// z fastest across threads, so every read and write of a warp is a
// contiguous run; the x/y neighbours a thread needs are the same z-runs of
// the neighbouring columns, which L2 serves. Division is exact `/`.
#include "common.cuh"

namespace {

template <typename T>
__global__ void divergence_kernel(const T* __restrict__ u, const T* __restrict__ v,
                                  const T* __restrict__ w, T* __restrict__ rhs,
                                  oc::Geom g, T ax_v, T ay_v, T az_v, T inv_dt) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= g.interior_cells()) return;
  int I, J, k;
  g.split(n, I, J, k);
  const int i = I + g.Hx, j = J + g.Hy;
  const long long c = g.at(i, j, k);
  T du = u[g.at(i + 1, j, k)] - u[c];
  T dv = v[g.at(i, j + 1, k)] - v[c];
  T w0 = k == 0 ? T(0) : w[c];
  T w1 = k + 1 == g.Nz ? T(0) : w[c + 1];
  T dw = w1 - w0;
  rhs[n] = (ax_v * du + ay_v * dv + az_v * dw) * inv_dt;
}

template <typename T>
__global__ void correct_kernel(const T* __restrict__ p, const T* __restrict__ us,
                               const T* __restrict__ vs, const T* __restrict__ ws,
                               T* __restrict__ uo, T* __restrict__ vo,
                               T* __restrict__ wo, oc::Geom g, T cx, T cy, T cz) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= g.interior_cells()) return;
  int I, J, k;
  g.split(n, I, J, k);
  const int i = I + g.Hx, j = J + g.Hy;
  const long long c = g.at(i, j, k);
  const T pc = p[c];
  T dpx = pc - p[g.at(i - 1, j, k)];
  T dpy = pc - p[g.at(i, j - 1, k)];
  T un = us[c] - cx * dpx;
  T vn = vs[c] - cy * dpy;
  T wn = k == 0 ? T(0) : ws[c] - cz * (pc - p[c - 1]);
  oc::store_with_images(uo, g, I, J, k, un);
  oc::store_with_images(vo, g, I, J, k, vn);
  oc::store_with_images(wo, g, I, J, k, wn);
}

}  // namespace

extern "C" {

int oc_fused_divergence(int dtype, const void* u, const void* v, const void* w,
                        void* rhs, int Nx, int Ny, int Nz, int Hx, int Hy,
                        double ax_v, double ay_v, double az_v, double inv_dt,
                        void* stream) {
  oc::Geom g{Nx, Ny, Nz, Hx, Hy};
  const int threads = 256;
  unsigned int blocks = oc::blocks_for(g.interior_cells(), threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == OC_FLOAT32)
    divergence_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)u, (const float*)v, (const float*)w, (float*)rhs, g,
        (float)ax_v, (float)ay_v, (float)az_v, (float)inv_dt);
  else if (dtype == OC_FLOAT64)
    divergence_kernel<double><<<blocks, threads, 0, s>>>(
        (const double*)u, (const double*)v, (const double*)w, (double*)rhs, g,
        ax_v, ay_v, az_v, inv_dt);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dt, inv_dx, inv_dy, inv_dz arrive as doubles holding field-dtype values;
// the factors dt·(1/Δx) are formed in the field dtype, as the TPU kernel
// does.
int oc_fused_correct(int dtype, const void* p, const void* u, const void* v,
                     const void* w, void* uo, void* vo, void* wo, int Nx, int Ny,
                     int Nz, int Hx, int Hy, double dt, double inv_dx,
                     double inv_dy, double inv_dz, void* stream) {
  oc::Geom g{Nx, Ny, Nz, Hx, Hy};
  const int threads = 256;
  unsigned int blocks = oc::blocks_for(g.interior_cells(), threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == OC_FLOAT32) {
    float d = (float)dt;
    correct_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)p, (const float*)u, (const float*)v, (const float*)w,
        (float*)uo, (float*)vo, (float*)wo, g, d * (float)inv_dx,
        d * (float)inv_dy, d * (float)inv_dz);
  } else if (dtype == OC_FLOAT64) {
    correct_kernel<double><<<blocks, threads, 0, s>>>(
        (const double*)p, (const double*)u, (const double*)v, (const double*)w,
        (double*)uo, (double*)vo, (double*)wo, g, dt * inv_dx, dt * inv_dy,
        dt * inv_dz);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
