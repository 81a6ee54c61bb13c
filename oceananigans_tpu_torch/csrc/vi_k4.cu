// The fused hydrostatic tendency (#10, vi_kernel.cuh) for configurations
// whose deepest site has buffer 4: Centered(8), UpwindBiased(7) and WENO(7).
// One source a buffer, so that kernels/build.py compiles the buffers in
// parallel; each unit holds its own copy of the constant tables.
#include "vi_kernel.cuh"

namespace oc {
namespace vi {

int vi_k4(int dtype, int sdtype, const Args& a) { return dispatch<4>(dtype, sdtype, a); }

int vi_k4_tables(const double* v, const double* vb) { return set_tables(v, vb); }

}  // namespace vi
}  // namespace oc
