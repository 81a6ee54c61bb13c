// The bounded #6 of buffer 4, WENO(7) with the bounds-preserving limiter
// (advection_kernel.cuh dispatch_bounded): one source a buffer, built with
// -fmad=false (kernels/build.py SOURCE_FLAGS).
#include "advection_kernel.cuh"

namespace oc {

int advection_bounded_k4(int dtype, int sdtype, const AdvectionArgs& a) {
  return dispatch_bounded<4>(dtype, sdtype, a);
}

}  // namespace oc
