// The block-tiled advection kernels of buffer 2: #1 and #6
// (advection_kernel.cuh) and #8 (sw_kernel.cuh) for Centered(4),
// UpwindBiased(3) and WENO(3), each with its near-wall cascade. One source a
// buffer, so that kernels/build.py compiles the buffers in parallel.
#include "advection_kernel.cuh"
#include "sw_kernel.cuh"

namespace oc {

int advection_k2(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a) {
  return dispatch<2>(update, fam, dtype, sdtype, a);
}

int sw_k2(int fam, int dtype, int sdtype, const SwArgs& a) {
  return sw_dispatch<2>(fam, dtype, sdtype, a);
}

}  // namespace oc
