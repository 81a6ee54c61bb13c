// The C entries of the fused shallow-water stage (#8): each picks the
// instantiations of the scheme's buffer K (advection_k1.cu ..
// advection_k6.cu, the kernel template and its design in sw_kernel.cuh).
#include "sw_kernel.cuh"

namespace {

int by_buffer(int K, int fam, int dtype, int sdtype, const oc::SwArgs& a) {
  switch (K) {
    case 1: return oc::sw_k1(fam, dtype, sdtype, a);
    case 2: return oc::sw_k2(fam, dtype, sdtype, a);
    case 3: return oc::sw_k3(fam, dtype, sdtype, a);
    case 4: return oc::sw_k4(fam, dtype, sdtype, a);
    case 5: return oc::sw_k5(fam, dtype, sdtype, a);
    case 6: return oc::sw_k6(fam, dtype, sdtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// fam: 0 Centered, 1 UpwindBiased, 2 WENO; K: the scheme's buffer. dtype:
// OC_FLOAT32 or OC_FLOAT64 for the fields; sdtype: OC_FLOAT32, OC_FLOAT64 or
// (with float32 fields) OC_BFLOAT16 for the WENO smoothness arithmetic.
// prog: host array of the uh, vh, h device pointers; q, out: host arrays of
// the batch's nb device pointers (fields first .. first+nb-1 of uh, vh, h,
// tracers; padded inputs and outputs); hB: padded bathymetry; Gm: device
// (nf, Nx, Ny) of all fields or null for the first stage; G: device (nf, Nx,
// Ny) output of all fields; coefs: the host table of reconstruction.cuh
// (coefs_size(K) float64 values: the table, then each axis's family and
// buffer); f: the constant Coriolis parameter, 0 for
// none. TX, TY, threads, blocks, smem: the launch plan of
// kernels/fused_shallow_water.py launch_plan (the tile, the threads a block,
// ceil(Nx/TX)·ceil(Ny/TY) blocks and the dynamic shared memory in bytes),
// refused unless they agree with the tile's layout.
int oc_fused_sw_update(int fam, int K, int dtype, int sdtype, const void* const* prog,
                       const void* const* q, void* const* out, int nb, int first,
                       const void* hB, const void* Gm,
                       void* G, int Nx, int Ny, int Hx, int Hy, double dx, double dy,
                       double Ax, double Ay, double Az, double V, double g_acc,
                       double f, double gamma_dt, double zeta_dt, const double* coefs,
                       int ncoefs, int TX, int TY, int threads, int blocks, int smem,
                       void* stream) {
  if (K < 1 || K > oc::kMaxBuffer || ncoefs != oc::coefs_size(K))
    return (int)cudaErrorInvalidValue;
  const oc::SwArgs a{prog, q, out, nb, first, hB, Gm, G, oc::Geom{Nx, Ny, 1, Hx, Hy, 0},
                     dx, dy, Ax, Ay, Az, V, g_acc, f, gamma_dt, zeta_dt, coefs, TX, TY,
                     threads, blocks, smem, (cudaStream_t)stream, nullptr};
  return by_buffer(K, fam, dtype, sdtype, a);
}

// The blocks of the launch plan's shape that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *per_sm.
int oc_fused_sw_update_blocks_per_sm(int fam, int K, int dtype, int sdtype, int TX, int TY,
                                     int threads, int smem, int* per_sm) {
  const int H = K + 1;
  oc::SwArgs a{};
  a.nb = 1;
  a.g = oc::Geom{TX, TY, 1, H, H, 0};
  a.TX = TX;
  a.TY = TY;
  a.threads = threads;
  a.blocks = 1;
  a.smem = smem;
  a.per_sm = per_sm;
  return by_buffer(K, fam, dtype, sdtype, a);
}

}  // extern "C"
