// The block-tiled advection kernels of buffer 4: #1 and #6
// (advection_kernel.cuh) and #8 (sw_kernel.cuh) for Centered(8),
// UpwindBiased(7) and WENO(7), each with its near-wall cascade. One source a
// buffer, so that kernels/build.py compiles the buffers in parallel.
#include "advection_kernel.cuh"
#include "sw_kernel.cuh"

namespace oc {

int advection_k4(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a) {
  return dispatch<4>(update, fam, dtype, sdtype, a);
}

int sw_k4(int fam, int dtype, int sdtype, const SwArgs& a) {
  return sw_dispatch<4>(fam, dtype, sdtype, a);
}

}  // namespace oc
