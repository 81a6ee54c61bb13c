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
// axis, where this is the periodic wrap; along a bounded axis the edge
// blocks' outer sides are the global walls and have no strip):
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
constexpr int kBatch = 32;   // fields a fold launch takes (kernels/build.py BATCH)

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

// The tripolar north fold between the top row of shards (kernels/halo_fill.py
// fold_north, the serial fill's kFold and kFoldFace maps, across shards):
// the fold maps global column i to Nx-1-i (Nx-i, and the wrap element i = 0
// onto itself with |sign|, for an x-face field), so the north halo rows of
// shard (i, Sy-1) read the rows below the fold of the shards that own the
// folded columns, mostly shard (Sx-1-i, Sy-1). Halo row Hy+n-1+m (m >= 1)
// takes row Hy+n-1-m (Hy+n-m for a y-face field) at the folded column,
// times the sign; for a field centred in y the last interior row's eastern
// half (global column >= Nx/2) takes its folded western half. Every slot
// of the block's padded x extent is written from the owner of its folded
// global column (the periodic images included), so no x halo is read.
// Reads are of interior slots the launch does not write: the halo rows read
// rows below the last one, the substituted row reads western columns and
// writes eastern ones. The one slot of that row that reads itself, an x-face
// field's column Nx/2, also has periodic images in the neighbours' x halos:
// the thread of its owner's interior slot reads it once and writes it and
// every image, and the images' own threads write nothing (an image that read
// the owner's slot could see it before or after its owner's write).
constexpr int kMaxFoldBlocks = 256;

struct FoldTable {
  void* blk[kMaxFoldBlocks];   // [field][shard x index]: the top row's blocks
  double sign[kBatch];
  int face[kBatch];            // bit 0: x-face field, bit 1: y-face field
};

template <typename T>
__global__ void fold_kernel(const __grid_constant__ FoldTable F, int Sx, int PY, int PZ,
                            int hx, int hy, int nlx, int nly, long long per_block) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per_block) return;
  const int f = blockIdx.y / Sx, i = blockIdx.y % Sx;
  const int face_x = F.face[f] & 1, face_y = (F.face[f] >> 1) & 1;
  const int PX = nlx + 2 * hx, Nx = Sx * nlx;
  const int k = (int)(e % PZ);
  const long long c = e / PZ;
  const int p = (int)(c % PX), r = (int)(c / PX);   // r = 0: the last row; m = r
  int ig = (i * nlx + p - hx) % Nx;
  if (ig < 0) ig += Nx;
  const int last = hy + nly - 1;
  if (r == 0 && (face_y || ig < Nx / 2)) return;
  const int s = face_x ? (Nx - ig) % Nx : Nx - 1 - ig;
  const T sign = (T)F.sign[f];
  const T sg = face_x && ig == 0 ? (sign < T(0) ? -sign : sign) : sign;
  const int owner = s / nlx, sp = s - owner * nlx + hx;
  const int drow = last + r;
  const int srow = r == 0 ? last : (face_y ? last + 1 - r : last - r);
  const T* a = (const T*)F.blk[f * Sx + owner];
  if (r == 0 && s == ig) {
    if (i != owner || p != sp) return;
    const T v = sg * a[((long long)sp * PY + srow) * PZ + k];
    for (int b = 0; b < Sx; ++b)
      for (int t = -2; t <= 2; ++t) {
        const int q = s - b * nlx + hx + t * Nx;
        if (q >= 0 && q < PX)
          ((T*)F.blk[f * Sx + b])[((long long)q * PY + drow) * PZ + k] = v;
      }
    return;
  }
  T* d = (T*)F.blk[f * Sx + i];
  d[((long long)p * PY + drow) * PZ + k] = sg * a[((long long)sp * PY + srow) * PZ + k];
}

}  // namespace

extern "C" {

// The north fold of nf fields across the Sx top shards of a mesh (one
// device): blocks[f * Sx + i] the device pointer of field f's padded
// (PX, PY, PZ) block on shard (i, Sy-1), sign[f] its fold's sign, face[f]
// its x-face (bit 0) and y-face (bit 1) flags; hx, hy the halos and nlx,
// nly the local interior; elem_size 4 or 8.
int oc_mesh_fold_exchange(void* const* blocks, const double* sign, const int* face, int nf,
                          int Sx, int elem_size, int PY, int PZ, int hx, int hy, int nlx,
                          int nly, void* stream) {
  if (nf < 1 || nf > kBatch || Sx < 1 || nf * Sx > kMaxFoldBlocks || hy < 1 ||
      nly < hy + 1 || PY != nly + 2 * hy)
    return (int)cudaErrorInvalidValue;
  // an x-face field centred in y with an odd Nx would swap two columns of
  // the substituted row (the serial fill's oc_fill_plan refuses it too)
  for (int f = 0; f < nf; ++f)
    if (face[f] == 1 && (Sx * nlx) % 2) return (int)cudaErrorInvalidValue;
  FoldTable F;
  for (int n = 0; n < kMaxFoldBlocks; ++n) F.blk[n] = n < nf * Sx ? blocks[n] : nullptr;
  for (int f = 0; f < kBatch; ++f) {
    F.sign[f] = f < nf ? sign[f] : 0.0;
    F.face[f] = f < nf ? face[f] : 0;
  }
  const long long per_block = (long long)(nlx + 2 * hx) * (hy + 1) * PZ;
  const int threads = 256;
  dim3 grid(oc::blocks_for(per_block, threads), nf * Sx);
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_size == 4)
    fold_kernel<float><<<grid, threads, 0, st>>>(F, Sx, PY, PZ, hx, hy, nlx, nly, per_block);
  else if (elem_size == 8)
    fold_kernel<double><<<grid, threads, 0, st>>>(F, Sx, PY, PZ, hx, hy, nlx, nly, per_block);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

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
