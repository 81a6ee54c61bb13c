// The bounded #6 of buffer 5, WENO(9) with the bounds-preserving limiter
// (advection_kernel.cuh dispatch_bounded): one source a buffer, built with
// -fmad=false (kernels/build.py SOURCE_FLAGS).
#include "advection_kernel.cuh"

namespace oc {

int advection_bounded_k5(int dtype, int sdtype, const AdvectionArgs& a) {
  return dispatch_bounded<5>(dtype, sdtype, a);
}

}  // namespace oc
