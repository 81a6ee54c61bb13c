// The fused hydrostatic tendency (#10, vi_kernel.cuh) with the multi-
// dimensional stencil (the MD family) for configurations whose deepest site
// has buffer 4: Centered(8), UpwindBiased(7) and WENO(7). A source of its own
// beside vi_k4.cu, so that kernels/build.py compiles the two in parallel; each
// unit holds its own copy of the constant tables.
#include "vi_kernel.cuh"

namespace oc {
namespace vi {

int vi_md_k4(int dtype, int sdtype, const Args& a) { return dispatch<4, true>(dtype, sdtype, a); }

int vi_md_k4_tables(const double* v, const double* vb) { return set_tables(v, vb); }

}  // namespace vi
}  // namespace oc
