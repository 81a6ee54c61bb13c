// The fused hydrostatic tendency (#10, vi_kernel.cuh) with the multi-
// dimensional stencil (the MD family) for configurations whose deepest site
// has buffer 6: Centered(12), UpwindBiased(11) and WENO(11). A source of its
// own beside vi_k6.cu, so that kernels/build.py compiles the two in parallel;
// each unit holds its own copy of the constant tables.
#include "vi_kernel.cuh"

namespace oc {
namespace vi {

int vi_md_k6(int dtype, int sdtype, const Args& a) { return dispatch<6, true>(dtype, sdtype, a); }

int vi_md_k6_tables(const double* v, const double* vb) { return set_tables(v, vb); }

}  // namespace vi
}  // namespace oc
