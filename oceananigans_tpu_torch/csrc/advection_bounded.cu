// The C entries of the bounded #6 (the padded tendency with the
// bounds-preserving limiter on its tracers, advection_kernel.cuh kBnd and
// bounded_limiter.cuh), whose instantiations live in
// advection_bounded_k2.cu .. advection_bounded_k6.cu, one source a buffer,
// apart from advection_kK.cu, so that the build compiles them in parallel
// with the rest.
#include "advection_kernel.cuh"

namespace oc {

int advection_bounded(int K, int dtype, int sdtype, const AdvectionArgs& a) {
  switch (K) {
    case 2: return advection_bounded_k2(dtype, sdtype, a);
    case 3: return advection_bounded_k3(dtype, sdtype, a);
    case 4: return advection_bounded_k4(dtype, sdtype, a);
    case 5: return advection_bounded_k5(dtype, sdtype, a);
    case 6: return advection_bounded_k6(dtype, sdtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace oc

extern "C" {

// The bounded #6: oc_advection_tendency's arguments without fam (the
// scheme is WENO), with lo and hi the limiter's bounds. K from 2 (WENO(3))
// to 6 (WENO(11)); dtype and sdtype both float32, both float64, or float64
// fields with float32 smoothness; a bounded z padded (Hz >= K), a periodic
// z or a flat z.
int oc_advection_tendency_bounded(int K, int dtype, int sdtype, const void* const* vel,
                                  const void* const* q, int nb, int first, void* const* G,
                                  int Nx, int Ny, int Nz, int Hx, int Hy, int Hz, int zmode,
                                  double Ax, double Ay, double Az, double V, double lo,
                                  double hi, const double* coefs, int ncoefs, int TX, int TY,
                                  int TZ, int threads, int blocks, int smem, void* stream) {
  if (K < 2 || K > oc::kMaxBuffer || ncoefs != oc::coefs_size(K))
    return (int)cudaErrorInvalidValue;
  oc::AdvectionArgs a{vel, nullptr, q, nullptr, G, nullptr, nb, first,
                      oc::Geom{Nx, Ny, Nz, Hx, Hy, Hz}, 0.0, 0.0, 0.0, Ax, Ay, Az, V,
                      0.0, 0.0, 0.0, coefs, TX, TY, TZ, threads, blocks, smem,
                      (cudaStream_t)stream, nullptr, zmode};
  a.lo = lo;
  a.hi = hi;
  return oc::advection_bounded(K, dtype, sdtype, a);
}

// The blocks of the bounded #6's launch plan that one SM holds, into
// *per_sm, with or without tracers, for a z mode (0 bounded, 1 periodic,
// 2 flat).
int oc_advection_bounded_blocks_per_sm(int K, int dtype, int sdtype, int zmode, int tracers,
                                       int TX, int TY, int TZ, int threads, int smem,
                                       int* per_sm) {
  const int H = K + 1;
  oc::AdvectionArgs a{};
  a.nb = tracers ? 4 : 3;
  a.g = oc::Geom{TX, TY, TZ, H, H, zmode == oc::kZFlat ? 0 : H};
  a.zmode = zmode;
  a.TX = TX;
  a.TY = TY;
  a.TZ = TZ;
  a.threads = threads;
  a.blocks = 1;
  a.smem = smem;
  a.per_sm = per_sm;
  a.hi = 1.0;
  return oc::advection_bounded(K, dtype, sdtype, a);
}

}  // extern "C"
