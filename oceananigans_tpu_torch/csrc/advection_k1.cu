// The block-tiled advection kernels of buffer 1: #1 and #6
// (advection_kernel.cuh) and #8 (sw_kernel.cuh) for Centered(2) and
// UpwindBiased(1), each with its near-wall cascade. One source a buffer, so
// that kernels/build.py compiles the buffers in parallel.
#include "advection_kernel.cuh"
#include "sw_kernel.cuh"

namespace oc {

int advection_k1(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a) {
  return dispatch<1>(update, fam, dtype, sdtype, a);
}

int sw_k1(int fam, int dtype, int sdtype, const SwArgs& a) {
  return sw_dispatch<1>(fam, dtype, sdtype, a);
}

}  // namespace oc
