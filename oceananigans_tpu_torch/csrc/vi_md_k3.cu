// The fused hydrostatic tendency (#10, vi_kernel.cuh) with the multi-
// dimensional stencil (the MD family) for configurations whose deepest site
// has buffer 3 or less: Centered(2-6), UpwindBiased(1-5) and WENO(3-5). A
// source of its own beside vi_k3.cu, so that kernels/build.py compiles the two
// in parallel; each unit holds its own copy of the constant tables.
#include "vi_kernel.cuh"

namespace oc {
namespace vi {

int vi_md_k3(int dtype, int sdtype, const Args& a) { return dispatch<3, true>(dtype, sdtype, a); }

int vi_md_k3_tables(const double* v, const double* vb) { return set_tables(v, vb); }

}  // namespace vi
}  // namespace oc
