// Halo exchange between the per-shard blocks of a device mesh, in place.
//
// Replaces oceananigans_tpu/parallel/halo_exchange.py _exchange_axis, the
// lax.ppermute strip exchange that the sharded TPU kernels #7
// (kernels/fused_advection.py build_sharded_fused_advection) and #9
// (kernels/fused_shallow_water.py build_sharded_fused_sw_update) run around
// their per-shard Pallas calls, for the blocks that lie on one device. Every
// block is a locally padded (PX, PY, PZ) array, z contiguous, laid out
// [h | n | h] along the exchanged axis. One launch fills the halos of one
// axis for a table of strips: strip s copies into block dst[s] the interior
// edge of block src[s], its neighbour along the axis (itself on a one-shard
// axis, where this is the periodic wrap):
//
//   side 0, the low halo  [0, h)         <- src rows [n, n + h)
//   side 1, the high halo [h + n, n + 2h) <- src rows [h, 2h)
//
// over the full extent of the other two axes, so that the y launch, made
// after the x launch, carries the x halos into the corners (two hops, as in
// the JAX package).
//
// Bound: pure data movement, each halo element read once and written once.
// Design: one thread per halo element, z fastest across threads (contiguous
// along z, and along y for an x strip of a 2-D field), the strip uniform per
// block (blockIdx.y); 64-bit offsets (a batch of 8200² blocks passes 2³¹
// elements). A strip reads only interior slots and writes only halo slots,
// and the wrapper requires n >= h, so no slot is both read and written in
// one launch and the copies are exact.
#include "common.cuh"

namespace {

constexpr int kMaxStrips = 128;

struct Strips {
  void* dst[kMaxStrips];
  const void* src[kMaxStrips];
  int side[kMaxStrips];
};

template <typename T>
__global__ void exchange_kernel(const __grid_constant__ Strips S, int axis, int PY, int PZ,
                                int h, int n, long long per_strip) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per_strip) return;
  const int s = blockIdx.y;
  const int side = S.side[s];
  const int k = (int)(e % PZ);
  const long long c = e / PZ;
  int i, j, si, sj;
  if (axis == 0) {                       // rows of x: h x PY columns
    const int r = (int)(c / PY);
    j = sj = (int)(c % PY);
    i = side ? h + n + r : r;
    si = side ? h + r : n + r;
  } else {                               // rows of y: PX x h columns
    const int r = (int)(c % h);
    i = si = (int)(c / h);
    j = side ? h + n + r : r;
    sj = side ? h + r : n + r;
  }
  T* d = (T*)S.dst[s];
  const T* a = (const T*)S.src[s];
  d[((long long)i * PY + j) * PZ + k] = a[((long long)si * PY + sj) * PZ + k];
}

}  // namespace

extern "C" {

// Fill one axis's halos (axis 0: x, 1: y) of padded (PX, PY, PZ) blocks for
// n_strips strips: host arrays dst[s], src[s] (device pointers) and side[s]
// (0 low, 1 high). h is the halo width and n the local interior along the
// axis (n >= h); elem_size is 4 or 8.
int oc_mesh_halo_exchange(void* const* dst, const void* const* src, const int* side,
                          int n_strips, int elem_size, int axis, int PX, int PY, int PZ,
                          int h, int n, void* stream) {
  if (n_strips < 1 || n_strips > kMaxStrips || (axis != 0 && axis != 1) || h < 1 ||
      n < h)
    return (int)cudaErrorInvalidValue;
  Strips S;
  for (int s = 0; s < kMaxStrips; ++s) {
    const bool on = s < n_strips;
    S.dst[s] = on ? dst[s] : nullptr;
    S.src[s] = on ? src[s] : nullptr;
    S.side[s] = on ? side[s] : 0;
  }
  const long long per_strip =
      (axis == 0 ? (long long)h * PY : (long long)PX * h) * (long long)PZ;
  const int threads = 256;
  dim3 grid(oc::blocks_for(per_strip, threads), n_strips);
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_size == 4)
    exchange_kernel<float><<<grid, threads, 0, st>>>(S, axis, PY, PZ, h, n, per_strip);
  else if (elem_size == 8)
    exchange_kernel<double><<<grid, threads, 0, st>>>(S, axis, PY, PZ, h, n, per_strip);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
