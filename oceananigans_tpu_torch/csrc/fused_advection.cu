// The C entries of the flux-form advection kernels #1 (the RK3 stage
// update) and #6 (the tendency alone): each picks the instantiations of the
// scheme's buffer K (advection_k1.cu .. advection_k6.cu, the kernel template
// and its design in advection_kernel.cuh).
#include "advection_kernel.cuh"

namespace {

int by_buffer(int K, bool update, int fam, int dtype, int sdtype, const oc::AdvectionArgs& a) {
  switch (K) {
    case 1: return oc::advection_k1(update, fam, dtype, sdtype, a);
    case 2: return oc::advection_k2(update, fam, dtype, sdtype, a);
    case 3: return oc::advection_k3(update, fam, dtype, sdtype, a);
    case 4: return oc::advection_k4(update, fam, dtype, sdtype, a);
    case 5: return oc::advection_k5(update, fam, dtype, sdtype, a);
    case 6: return oc::advection_k6(update, fam, dtype, sdtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool table_ok(int K, int ncoefs) {
  return K >= 1 && K <= oc::kMaxBuffer && ncoefs == oc::coefs_size(K);
}

}  // namespace

extern "C" {

// #1. fam: 0 Centered, 1 UpwindBiased, 2 WENO; K: the scheme's buffer (its
// reach: Centered(2K), UpwindBiased(2K-1), WENO(2K-1)). dtype: OC_FLOAT32 or
// OC_FLOAT64 for the fields; sdtype: OC_FLOAT32, OC_FLOAT64 or (with float32
// fields) OC_BFLOAT16 for the WENO smoothness arithmetic. vel: host array of
// the u*, v*, w* device pointers; p: the padded pressure, or null for no
// correction. q, G, out: host arrays of the batch's nb device pointers
// (components first .. first+nb-1 of u, v, w, tracers...); gm: such an array
// of the previous stage's tendencies, or null on the first stage. Scalars
// arrive as doubles holding field-dtype values; coefs is the host table of
// reconstruction.cuh (coefs_size(K) float64 values: the table, then each
// axis's family and buffer; K the deepest axis's buffer). TX, TY, TZ, threads,
// blocks, smem: the launch plan of kernels/fused_advection.py launch_plan
// (the tile, the threads a block, ceil(Nx/TX)·ceil(Ny/TY)·ceil(Nz/TZ) blocks
// and the dynamic shared memory in bytes), refused unless they agree with
// the tile's layout.
int oc_fused_advection_update(int fam, int K, int dtype, int sdtype, const void* const* vel,
                              const void* p, const void* const* q,
                              const void* const* gm, void* const* G, void* const* out,
                              int nb, int first, int Nx, int Ny, int Nz, int Hx, int Hy,
                              double gdt, double zdt, double cdt, double Ax, double Ay,
                              double Az, double V, double inv_dx, double inv_dy,
                              double inv_dz, const double* coefs, int ncoefs, int TX,
                              int TY, int TZ, int threads, int blocks, int smem,
                              void* stream) {
  if (!table_ok(K, ncoefs)) return (int)cudaErrorInvalidValue;
  const oc::AdvectionArgs a{vel, p, q, gm, G, out, nb, first, oc::Geom{Nx, Ny, Nz, Hx, Hy, 0},
                            gdt, zdt, cdt, Ax, Ay, Az, V, inv_dx, inv_dy, inv_dz, coefs,
                            TX, TY, TZ, threads, blocks, smem, (cudaStream_t)stream, nullptr};
  return by_buffer(K, true, fam, dtype, sdtype, a);
}

// #6. fam, K, dtype, sdtype, vel, coefs and the launch plan as
// oc_fused_advection_update's; q: host array of the batch's nb device
// pointers, components first .. first+nb-1 of (u, v, w, tracers...); G: host
// array of the nb interior-shaped outputs. zmode: the z topology, 0 bounded
// (Hz = 0 selects the z-compact layout, Hz >= the reach the padded one), 1
// periodic (padded, Hz >= the reach), 2 flat (Nz = 1, Hz = 0).
int oc_advection_tendency(int fam, int K, int dtype, int sdtype, const void* const* vel,
                          const void* const* q, int nb, int first, void* const* G, int Nx,
                          int Ny, int Nz, int Hx, int Hy, int Hz, int zmode, double Ax,
                          double Ay, double Az, double V, const double* coefs, int ncoefs,
                          int TX, int TY, int TZ, int threads, int blocks, int smem,
                          void* stream) {
  if (!table_ok(K, ncoefs)) return (int)cudaErrorInvalidValue;
  const oc::AdvectionArgs a{vel, nullptr, q, nullptr, G, nullptr, nb, first,
                            oc::Geom{Nx, Ny, Nz, Hx, Hy, Hz}, 0.0, 0.0, 0.0, Ax, Ay, Az, V,
                            0.0, 0.0, 0.0, coefs, TX, TY, TZ, threads, blocks, smem,
                            (cudaStream_t)stream, nullptr, zmode};
  return by_buffer(K, false, fam, dtype, sdtype, a);
}

// The blocks of the launch plan's shape that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *per_sm, for a
// launch of scheme (fam, K) with or without tracers of kind 0 (#1
// uncorrected), 1 (#1 corrected), 2 (#6 z-compact), 3 (#6 padded), 4 (#6 on a
// periodic z) or 5 (#6 on a flat z).
int oc_advection_blocks_per_sm(int fam, int K, int dtype, int sdtype, int kind, int tracers,
                               int TX, int TY, int TZ, int threads, int smem,
                               int* per_sm) {
  const int H = K + 1;
  static const char dummy = 0;   // a pressure for the corrected variant
  oc::AdvectionArgs a{};
  a.p = kind == 1 ? &dummy : nullptr;
  a.nb = tracers ? 4 : 3;
  a.g = oc::Geom{TX, TY, kind == 5 ? 1 : TZ, H, H, kind == 3 || kind == 4 ? H : 0};
  a.zmode = kind == 4 ? oc::kZPeriodic : kind == 5 ? oc::kZFlat : oc::kZBounded;
  a.TX = TX;
  a.TY = TY;
  a.TZ = TZ;
  a.threads = threads;
  a.blocks = 1;
  a.smem = smem;
  a.per_sm = per_sm;
  return by_buffer(K, kind < 2, fam, dtype, sdtype, a);
}

}  // extern "C"
