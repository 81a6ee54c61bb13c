// Shared-memory tiles for the block-tiled kernels (fused_shallow_water.cu,
// fused_advection.cu).
//
// A block owns a tile of interior cells and works through it in phases
// separated by __syncthreads(): stage the tile and its ring into shared
// memory, form derived values, form each face flux once, then take the
// differences per cell. Every phase is a loop over its items strided by the
// block's thread count, so a block computes the same values whatever its
// thread count (one thread included), and the items of a phase depend only
// on what earlier phases wrote.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace oc {

// The dynamic shared memory of a launch: every array of a layout starts at a
// multiple of four elements, 16 bytes or more, so the staging copies may
// store 16 bytes a thread.
constexpr int kSmemAlign = 4;

__host__ __device__ __forceinline__ int align_elems(int n) {
  return (n + kSmemAlign - 1) / kSmemAlign * kSmemAlign;
}

// The most dynamic shared memory a block can take on the H100 (227 KB).
constexpr int kMaxSmemBytes = 232448;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// Copy a rows × width window of a row-major array (row stride ld, window
// start src) into shared memory (row stride sld), by the block's threads,
// neighbouring threads on neighbouring elements; 16 bytes a thread where the
// window's width, both strides and both starts allow it, else one element a
// thread.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int sld, const T* src, long long ld,
                                           int rows, int width) {
  constexpr int V = 16 / (int)sizeof(T);
  using VT = typename Vec16<T>::type;
  const bool vec = width % V == 0 && sld % V == 0 && ld % V == 0 &&
                   (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0;
  if (vec) {
    const int nv = width / V;
    for (int n = threadIdx.x; n < rows * nv; n += blockDim.x) {
      const int a = n / nv, q = n - a * nv;
      *reinterpret_cast<VT*>(dst + a * sld + q * V) =
          *reinterpret_cast<const VT*>(src + a * ld + q * V);
    }
  } else {
    for (int n = threadIdx.x; n < rows * width; n += blockDim.x) {
      const int a = n / width, b = n - a * width;
      dst[a * sld + b] = src[a * ld + b];
    }
  }
}

// The items (a, b, c) of an A × B × C box, c fastest, that one thread
// visits in a loop strided by the block's thread count: the first item is
// split once, and each step advances (a, b, c) by carries, with no division
// inside the loop.
struct Walk {
  int a, b, c;         // the current item
  int B, C;            // the box's extents along b and c
  int da, db, dc;      // the stride, split

  __device__ __forceinline__ Walk(int n, int B_, int C_) : B(B_), C(C_) {
    c = n % C;
    b = (n / C) % B;
    a = n / C / B;
    const int s = blockDim.x;
    dc = s % C;
    db = (s / C) % B;
    da = s / C / B;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    int carry = c >= C;
    c -= carry ? C : 0;
    b += db + carry;
    carry = b >= B;
    b -= carry ? B : 0;
    a += da + carry;
  }
};

// Visit the n = A·B·C items of a box (c fastest) by the block's threads:
// body(a, b, c) for each.
template <typename Body>
__device__ __forceinline__ void for_box(int n, int B, int C, Body body) {
  Walk w(threadIdx.x, B, C);
  for (int m = threadIdx.x; m < n; m += blockDim.x, w.next()) body(w.a, w.b, w.c);
}

// Visit the n = A·C items of a rectangle (c fastest) by the block's
// threads: body(a, c) for each.
template <typename Body>
__device__ __forceinline__ void for_rect(int n, int C, Body body) {
  for_box(n, 1, C, [&](int a, int, int c) { body(a, c); });
}

// Fill the n = A·B·C items of a box (c fastest) into shared memory by the
// block's threads, U loads in flight a thread: load(a, b, c, slot) returns
// the item's value and sets slot to its place in dst.
template <int U, typename T, typename Load>
__device__ __forceinline__ void stage_box(T* dst, int n, int B, int C, Load load) {
  Walk w(threadIdx.x, B, C);
  for (int m0 = threadIdx.x; m0 < n; m0 += U * blockDim.x) {
    T v[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      at[u] = -1;
      if (m0 + u * (int)blockDim.x < n) v[u] = load(w.a, w.b, w.c, at[u]);
      w.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

// One element copied from device to shared memory without passing through
// registers (cp.async, 4 or 8 bytes); complete for the copying thread after
// copy_async_wait<N>() has left at most N of its later commit groups in
// flight, and for the block after a __syncthreads() that follows. Without
// the device compiler (a host build of the kernels) the copy is immediate.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"((int)sizeof(T)));
#else
  *dst = *src;
#endif
}

// 16 bytes copied from device to shared memory (cp.async.cg; both addresses
// 16-byte aligned), complete as copy_async's.
template <typename T>
__device__ __forceinline__ void copy_async16(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

__host__ __device__ __forceinline__ int ceil_div(int n, int d) { return (n + d - 1) / d; }

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

}  // namespace oc
