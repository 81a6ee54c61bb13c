// The C entries of the fused hydrostatic tendency (#10): the kernel template
// is vi_kernel.cuh, instantiated per deepest buffer in vi_k3.cu .. vi_k6.cu
// and, with the multi-dimensional stencil, in vi_md_k3.cu .. vi_md_k6.cu (a
// configuration whose deepest site has buffer 1 or 2 takes the k3 units).
#include "vi_kernel.cuh"

namespace {

using oc::vi::Args;

int by_buffer(int dtype, int sdtype, const Args& a) {
  if (a.cf[oc::vi::cNtr] < 0 || a.cf[oc::vi::cNtr] > oc::vi::kBatch || a.TX < 1 || a.TY < 1 ||
      a.TZ < 1 || a.threads < 32 || a.threads > oc::vi::kThreads || a.threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  // the multi-dimensional stencil's family, or the lean and full variants
  const bool md = a.cf[oc::vi::cMd] != 0;
  switch (a.cf[oc::vi::cKM]) {
    case 3: return md ? oc::vi::vi_md_k3(dtype, sdtype, a) : oc::vi::vi_k3(dtype, sdtype, a);
    case 4: return md ? oc::vi::vi_md_k4(dtype, sdtype, a) : oc::vi::vi_k4(dtype, sdtype, a);
    case 5: return md ? oc::vi::vi_md_k5(dtype, sdtype, a) : oc::vi::vi_k5(dtype, sdtype, a);
    case 6: return md ? oc::vi::vi_md_k6(dtype, sdtype, a) : oc::vi::vi_k6(dtype, sdtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Upload the coefficient tables (n = kTableSize float64 values, VITab order;
// vals_bf16 the same rounded to bfloat16) to the current device's constant
// memory, in float64, rounded to float32 and in bfloat16, in every unit.
int oc_vi_set_tables(const double* vals, const double* vals_bf16, int n) {
  if (n != oc::vi::kTableSize) return (int)cudaErrorInvalidValue;
  int (*const setters[])(const double*, const double*) = {
      oc::vi::vi_k3_tables,    oc::vi::vi_k4_tables,    oc::vi::vi_k5_tables,
      oc::vi::vi_k6_tables,    oc::vi::vi_md_k3_tables, oc::vi::vi_md_k4_tables,
      oc::vi::vi_md_k5_tables, oc::vi::vi_md_k6_tables};
  for (auto set : setters) {
    const int e = set(vals, vals_bf16);
    if (e != 0) return e;
  }
  return 0;
}

// dtype / sdtype: OC_FLOAT32 or OC_FLOAT64 for the fields, and OC_FLOAT32,
// OC_FLOAT64 or (with float32 fields) OC_BFLOAT16 for the WENO smoothness.
// in: host array of device pointers u, v, w, ph (or null), then this
// launch's tracers; out: Gu, Gv (written when cf's momentum flag is set),
// then the tracers' Gc (padded, zeroed by the caller); rows: the (ny_rows,
// PY) y rows; zrows: the (nz_rows, PZ) z rows; cf: the int configuration
// (vi_kernel.cuh Conf, kernels/fused_vector_invariant.py conf_array);
// cor_f: the Cartesian rotation (fx, fy, fz). TX, TY, TZ, threads, blocks,
// smem: the launch plan of kernels/fused_vector_invariant.py launch_plan
// (the tile, ceil((Nx + bx)/TX)·ceil((Ny + by)/TY)·ceil(Nz/TZ) blocks and
// the dynamic shared memory in bytes), refused unless they agree with the
// tile's layout and the reaches cover the sites.
int oc_fused_vi_tendency(int dtype, int sdtype, const void* const* in, void* const* out,
                         const void* rows, const void* zrows, const int* cf,
                         const double* cor_f, int TX, int TY, int TZ, int threads, int blocks,
                         int smem, void* stream) {
  const Args a{in, out, rows, zrows, cf, cor_f, TX, TY, TZ, threads, blocks, smem,
               (cudaStream_t)stream, nullptr};
  return by_buffer(dtype, sdtype, a);
}

// The blocks of the launch plan's shape that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *per_sm, for the
// configuration cf (its geometry is not read).
int oc_vi_blocks_per_sm(int dtype, int sdtype, const int* cf, int TX, int TY, int TZ,
                        int threads, int smem, int* per_sm) {
  int c[oc::vi::cSize];
  for (int i = 0; i < oc::vi::cSize; ++i) c[i] = cf[i];
  c[oc::vi::cNx] = TX;
  c[oc::vi::cNy] = TY;
  c[oc::vi::cNz] = TZ;
  c[oc::vi::cBx] = c[oc::vi::cBy] = 0;
  const Args a{nullptr, nullptr, nullptr, nullptr, c, nullptr, TX, TY, TZ, threads, 1, smem,
               nullptr, per_sm};
  return by_buffer(dtype, sdtype, a);
}

}  // extern "C"
