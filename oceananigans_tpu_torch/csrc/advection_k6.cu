// The block-tiled advection kernels of buffer 6: #1 and #6
// (advection_kernel.cuh) and #8 (sw_kernel.cuh) for Centered(12),
// UpwindBiased(11) and WENO(11), each with its near-wall cascade. One source a
// buffer, so that kernels/build.py compiles the buffers in parallel.
#include "advection_kernel.cuh"
#include "sw_kernel.cuh"

namespace oc {

int advection_k6(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a) {
  return dispatch<6>(update, fam, dtype, sdtype, a);
}

int sw_k6(int fam, int dtype, int sdtype, const SwArgs& a) {
  return sw_dispatch<6>(fam, dtype, sdtype, a);
}

}  // namespace oc
