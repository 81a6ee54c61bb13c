// Shared layout helpers for the port's CUDA kernels.
//
// Every field is a padded (Nx + 2Hx, Ny + 2Hy, Nz + 2Hz) array with z
// contiguous. In the z-compact layout Hz = 0 (the bounded-z boundary
// conditions are applied inside the stencil reads); in the padded layout the
// z halos hold them. Interior cell (I, J, k) lives at padded
// (I + Hx, J + Hy, k + Hz). Interior-shaped arrays (tendencies, the
// divergence) are (Nx, Ny, Nz), also z contiguous.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace oc {

struct Geom {
  int Nx, Ny, Nz, Hx, Hy;
  int Hz;  // 0 in the z-compact layout (aggregate initialisation leaves it 0)

  __host__ __device__ __forceinline__ int PX() const { return Nx + 2 * Hx; }
  __host__ __device__ __forceinline__ int PY() const { return Ny + 2 * Hy; }
  __host__ __device__ __forceinline__ int PZ() const { return Nz + 2 * Hz; }

  // linear offset of padded (i, j, k); k is the padded z index
  __device__ __forceinline__ long long at(int i, int j, int k) const {
    return ((long long)i * PY() + j) * PZ() + k;
  }

  __host__ __device__ __forceinline__ long long interior_cells() const {
    return (long long)Nx * Ny * Nz;
  }

  // interior linear index n -> (I, J, k)
  __device__ __forceinline__ void split(long long n, int& I, int& J, int& k) const {
    k = (int)(n % Nz);
    long long c = n / Nz;
    J = (int)(c % Ny);
    I = (int)(c / Ny);
  }
};

// Store `val` at padded (I + Hx, J + Hy, k) and at each periodic image of
// that cell in the x and y halos (corners included), so the array comes out
// with valid periodic halos without a separate fill pass. Needs Nx >= Hx and
// Ny >= Hy.
template <typename T>
__device__ __forceinline__ void store_with_images(T* a, const Geom& g, int I, int J,
                                                  int k, T val) {
  int xs[3], ys[3];
  int nx = 0, ny = 0;
  xs[nx++] = I + g.Hx;
  if (I < g.Hx) xs[nx++] = I + g.Hx + g.Nx;
  if (I >= g.Nx - g.Hx) xs[nx++] = I + g.Hx - g.Nx;
  ys[ny++] = J + g.Hy;
  if (J < g.Hy) ys[ny++] = J + g.Hy + g.Ny;
  if (J >= g.Ny - g.Hy) ys[ny++] = J + g.Hy - g.Ny;
  for (int a_ = 0; a_ < nx; ++a_)
    for (int b_ = 0; b_ < ny; ++b_) a[g.at(xs[a_], ys[b_], k)] = val;
}

inline unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// bfloat16 arithmetic rounded as the plain PyTorch versions and XLA (without
// excess precision) round it: every operation computes in float32 from the
// bfloat16 operands and rounds its result to bfloat16, to nearest even. The
// _rn intrinsics keep nvcc from contracting a product and a sum across a
// rounding. Native bf16 instructions (__hfma, bf16x2) round once where the
// plain version rounds twice, so they are not used here.
struct bf16 {
  unsigned short bits;

  bf16() = default;
  __device__ __forceinline__ explicit bf16(float x)
      : bits(__bfloat16_as_ushort(__float2bfloat16_rn(x))) {}
  __device__ __forceinline__ explicit operator float() const {
    return __uint_as_float((unsigned int)bits << 16);
  }

  // a float64 value that is a bfloat16 value (the coefficient tables' entries
  // arrive rounded), or the bfloat16 nearest its float32 rounding
  static bf16 from_host(double v) {
    const float f = (float)v;
    uint32_t u;
    memcpy(&u, &f, sizeof u);
    bf16 b;
    b.bits = (unsigned short)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
    return b;
  }
};

__device__ __forceinline__ bf16 operator+(bf16 a, bf16 b) {
  return bf16(__fadd_rn(float(a), float(b)));
}
__device__ __forceinline__ bf16 operator-(bf16 a, bf16 b) {
  return bf16(__fsub_rn(float(a), float(b)));
}
__device__ __forceinline__ bf16 operator*(bf16 a, bf16 b) {
  return bf16(__fmul_rn(float(a), float(b)));
}
__device__ __forceinline__ bf16 operator/(bf16 a, bf16 b) {
  return bf16(__fdiv_rn(float(a), float(b)));
}
__device__ __forceinline__ bool operator>(bf16 a, bf16 b) { return float(a) > float(b); }

__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ bf16 absval(bf16 x) { return bf16(fabsf(float(x))); }

}  // namespace oc

// Dtype codes shared with the Python wrappers: fields take the first two,
// the WENO smoothness arithmetic all three.
#define OC_FLOAT32 0
#define OC_FLOAT64 1
#define OC_BFLOAT16 2
