// Flux-form advection of momentum and tracers fused with the RK3 stage update,
// z-compact layout.
//
// Replaces oceananigans_tpu/kernels/fused_advection.py _build_update_group
// (:269, via build_fused_advection_update; the pallas_call at :626),
// momentum and tracer groups alike:
//
//   G   = -∇·(𝐯 q)                          for q = u, v, w and each tracer
//   new = q + γΔt·G + ζΔt·G⁻                 (ζΔt·G⁻ only when G⁻ is given)
//
// With a pressure p (the deferred correction of the previous RK3 stage), u,
// v and w are corrected, q = q* − Δt_prev·∂p (w's bottom face pinned to 0),
// and G is the tendency of the corrected fields; the tracers are advected by
// the corrected velocities and are never corrected themselves. `new` adds the
// increment to the UNCORRECTED q*, exactly as the TPU kernel does (the
// carried correction ends up in the next solve's pressure, and the last
// stage's projection removes it).
//
// The stencils (advection_stencils.cuh face_flux_x/y/z: the expressions of
// the tendency functions, one face at a time), the z-compact boundary
// handling (halo-free mirrors along z, zero boundary-face fluxes, the
// corrected reads of CompactRead) and the near-wall order cascade on the
// global z index are those of the tendency-only kernel; schemes WENO(5) and
// Centered(2).
//
// Bound: over u, v, w alone, arithmetic: about 370 floating-point operations
// per component and cell (each face flux once), 0.28 ms at 256³ against the
// datasheet's 67 Tflop/s, about 0.85 ms at the card's own rate for the WENO-5
// body with exact divisions (22.7 Tflop/s, the #12 probe on a slab that
// fills every SM); against 16 B per component of compulsory traffic in
// float32 (read q, write G and new, read G⁻). With tracers the bytes bind
// (1.26 ms for 15 components at 256³). No tensor cores: the WENO weights are
// nonlinear in the data, and nothing here is a product wgmma could take.
//
// Design: one block owns a TX × TY × TZ tile of interior cells (z fastest
// across threads; a ragged edge is masked, Nz need not be a multiple of TZ)
// and works through it in phases separated by __syncthreads() (tiles.cuh):
//   staging     u, v and w over the tile plus the stencil's reach (3 cells
//               each way for WENO(5)), each value formed once by
//               CompactRead's u_z, v_z, w_z: the deferred correction, w's
//               pinned bottom face, the even and odd z mirrors and, with
//               bfloat16 smoothness, the rounded correction (kRn), so each
//               stencil read is one shared-memory load; loads through
//               registers, kInFlight in flight a thread (a corrected value
//               is three loads and arithmetic, not a copy);
//   components  u, v, w, then the tracers of the launch, with the velocity
//               boxes resident throughout. A tracer's box (even z mirrors)
//               is copied by cp.async into one of two buffers while the
//               block works on the component before it, so its loads wait
//               behind arithmetic; then for each component the update's
//               device-memory reads (G⁻, and q* of u, v, w; a tracer's q
//               is in its box) are issued into registers, each face flux
//               is formed once on each axis into shared memory
//               (face_flux_x/y/z through SharedRead), and per cell the
//               differences give G and `new` with its periodic x/y images
//               (store_with_images, in place of the TPU kernel's strip
//               DMAs).
// No TMA: a box is a strided window with mirrored z rows, not a rectangle
// of the array. Every face flux goes through one code path wherever it lies
// in the tile; the loops walk their items with carries, no division. The
// tile, the block count and the dynamic shared memory come from
// kernels/fused_advection.py launch_plan; the C entry recomputes and checks
// them. At float32 a 16 × 8 × 8 tile with 256 threads takes 104.7 KB of
// shared memory with tracers (two blocks an SM) and 65.3 KB without (three);
// float64 takes 8 × 8 × 8 (129.9 KB). Registers and spills: `-Xptxas -v`
// (chip_smoke.py prints them). Divisions are exact `/`.
//
// A launch covers a batch of components of (u, v, w, tracers...) (at most
// kBatch, their pointers in the parameter block); the wrapper launches once
// per batch. The TPU kernel's groups (momentum, then tracers in batches of
// 4) are a VMEM workaround; every component's result depends only on its own
// field and u, v, w, p, so the batching does not change a bit of it.
#include "advection_stencils.cuh"
#include "tiles.cuh"

namespace {

using oc::kBatch;
using oc::kCentered2;
using oc::kTabSize;
using oc::kWeno5;

constexpr int kThreads = 256;  // the most threads a block takes
constexpr int kInFlight = 4;   // staging loads in flight a thread
constexpr int kCells = 4;      // cells a thread updates from registers read ahead

// the stencil's reach: cells a face flux reads on either side
template <int SCH>
constexpr int kReach = SCH == kWeno5 ? 3 : 1;

// The read policy of the staging: bfloat16 smoothness rounds the correction
// as the plain version does (CompactRead's kRn).
template <typename T, typename S, bool C>
using Read = oc::CompactRead<T, C, std::is_same<S, oc::bf16>::value>;

// A tracer box spans z0 - kTracerZ .. z0 + TZ + kTracerZ - 1 (the reach, at
// most 3, rounded up to 16 bytes of float32), so that away from the walls
// its rows are 16-byte aligned copies of the tracer's z columns.
constexpr int kTracerZ = 4;

// Element offsets of a block's shared arrays for a TX × TY × TZ tile and a
// stencil reach r; kernels/fused_advection.py smem_bytes computes the same
// total.
struct Layout {
  int sx, sy;            // velocity box strides: (TY + 2r)(TZ + 2r), TZ + 2r
  int csx, csy;          // tracer box strides: (TY + 2r)(TZ + 2 kTracerZ), TZ + 2 kTracerZ
  int vel[3], c[2];      // boxes: u, v, w over (TX + 2r)(TY + 2r)(TZ + 2r), two tracers
  int fx, fy, fz;        // fluxes (TX + 1)·TY·TZ, TX·(TY + 1)·TZ, TX·TY·(TZ + 1)
  int total;

  __host__ __device__ Layout(int TX, int TY, int TZ, int r, bool tracers) {
    sy = TZ + 2 * r;
    sx = (TY + 2 * r) * sy;
    csy = TZ + 2 * kTracerZ;
    csx = (TY + 2 * r) * csy;
    const int box = oc::align_elems((TX + 2 * r) * sx);
    const int cbox = oc::align_elems((TX + 2 * r) * csx);
    int o = 0;
    for (int d = 0; d < 3; ++d) {
      vel[d] = o;
      o += box;
    }
    for (int d = 0; d < 2; ++d) {
      c[d] = o;
      if (tracers) o += cbox;
    }
    fx = o; o += oc::align_elems((TX + 1) * TY * TZ);
    fy = o; o += oc::align_elems(TX * (TY + 1) * TZ);
    fz = o; o += oc::align_elems(TX * TY * (TZ + 1));
    total = o;
  }
};

template <typename T, typename S, bool C>
struct Params {
  oc::Stencil<T, S, Read<T, S, C>> st;   // u*, v*, w* (p, Δt_prev/Δ): the staging reads
  const T* q[kBatch];    // the batch's fields q* (padded, uncorrected)
  const T* gm[kBatch];   // previous-stage tendencies (interior), or null
  T* G[kBatch];          // tendencies out (interior)
  T* out[kBatch];        // new fields out (padded, periodic halos written)
  int nb, first;         // components first .. first + nb - 1: 0 u, 1 v, 2 w, 3+ tracers
  T gdt, zdt;            // γΔt, ζΔt
  int TX, TY, TZ;        // the tile
  int tiles_y, tiles_z;  // tiles along y and z
};

template <int SCH, typename T, typename S, bool C>
__global__ void __launch_bounds__(kThreads)
advection_update_kernel(const __grid_constant__ Params<T, S, C> P) {
  constexpr int r = kReach<SCH>;
  extern __shared__ __align__(16) unsigned char oc_smem[];
  T* const sm = reinterpret_cast<T*>(oc_smem);
  const int last = P.first + P.nb;
  const int first_tracer = P.first > 3 ? P.first : 3;
  const Layout L(P.TX, P.TY, P.TZ, r, last > 3);
  const auto& rd = P.st.rd;
  const oc::Geom& g = rd.g;
  const int TY = P.TY, TZ = P.TZ;
  int t = blockIdx.x;
  const int bz = t % P.tiles_z;
  t /= P.tiles_z;
  const int by = t % P.tiles_y, bx = t / P.tiles_y;
  const int x0 = bx * P.TX, y0 = by * TY, z0 = bz * TZ;   // the tile's first interior cell
  const int ex = oc::imin(P.TX, g.Nx - x0), ey = oc::imin(TY, g.Ny - y0),
            ez = oc::imin(TZ, g.Nz - z0);
  const int i0 = x0 + g.Hx, j0 = y0 + g.Hy;               // padded
  const oc::SharedRead<T> sr{{sm + L.vel[0], sm + L.vel[1], sm + L.vel[2]},
                             i0 - r, j0 - r, z0 - r, L.sx, L.sy,
                             z0 - kTracerZ, L.csx, L.csy};
  const int wy = ey + 2 * r, wz = ez + 2 * r, nbox = (ex + 2 * r) * wy * wz;

  // a tracer's box, two of them in turn: copies in flight (cp.async) while
  // the block works on the component before. Away from the walls a row is
  // TZ + 2·kTracerZ values of one z column, copied 16 bytes at a time; by
  // the walls, in a ragged z tile or where the rows are not 16-byte
  // aligned, one value at a time with the even z mirrors, and a slot whose
  // mirror falls outside [0, Nz) (Nz < the reach, never read) holds 0.
  constexpr int V = 16 / (int)sizeof(T);
  const int cw = TZ + 2 * kTracerZ;   // a tracer row
  auto tracer_box = [&](int comp) { return sm + L.c[(comp - first_tracer) & 1]; };
  auto stage_tracer = [&](int comp) {
    const T* const q = P.q[comp - P.first];
    T* const box = tracer_box(comp);
    const bool rows = z0 >= kTracerZ && z0 + TZ + kTracerZ <= g.Nz && g.Nz % V == 0 &&
                      (z0 - kTracerZ) % V == 0 && cw % V == 0 && L.csy % V == 0 &&
                      (uintptr_t)q % 16 == 0;
    if (rows) {
      oc::for_box((ex + 2 * r) * wy * (cw / V), wy, cw / V, [&](int a, int b, int v) {
        const T* src = q + g.at(i0 - r + a, j0 - r + b, z0 - kTracerZ + v * V);
        oc::copy_async16(box + a * L.csx + b * L.csy + v * V, src);
      });
    } else {
      oc::for_box((ex + 2 * r) * wy * cw, wy, cw, [&](int a, int b, int c) {
        T* const dst = box + a * L.csx + b * L.csy + c;
        const int e = rd.even(z0 - kTracerZ + c);
        if (e < 0 || e >= g.Nz)
          *dst = T(0);
        else
          oc::copy_async(dst, q + g.at(i0 - r + a, j0 - r + b, e));
      });
    }
    oc::copy_async_commit();
  };
  if (first_tracer < last) stage_tracer(first_tracer);

  // staging: the corrected u, v, w over the tile plus the reach, through
  // CompactRead
  for (int d = 0; d < 3; ++d)
    oc::stage_box<kInFlight>(sm + L.vel[d], nbox, wy, wz, [&](int a, int b, int c, int& at) {
      const int i = i0 - r + a, j = j0 - r + b, k = z0 - r + c;
      at = a * L.sx + b * L.sy + c;
      if (d == 2) return k <= 2 * g.Nz ? rd.w_z(i, j, k) : T(0);
      const int e = rd.even(k);
      return e < 0 || e >= g.Nz ? T(0) : d == 0 ? rd.u(i, j, e) : rd.v(i, j, e);
    });
  __syncthreads();

  T *Fx = sm + L.fx, *Fy = sm + L.fy, *Fz = sm + L.fz;
  const int ncell = ex * ey * ez;
  for (int comp = P.first; comp < last; ++comp) {
    const int bi = comp - P.first;
    if (comp > P.first) __syncthreads();   // the previous component's reads are done
    const T* box = nullptr;
    if (comp >= 3) {
      if (comp + 1 < last) {
        stage_tracer(comp + 1);
        oc::copy_async_wait<1>();
      } else {
        oc::copy_async_wait<0>();
      }
      __syncthreads();
      box = tracer_box(comp);
    }
    // the update's device-memory reads (G⁻; q* of u, v, w), issued ahead of
    // the fluxes for the first kCells cells of this thread
    const T* const gm = P.gm[bi];
    auto cell = [&](int a, int b, int c) {
      return ((long long)(x0 + a) * g.Ny + (y0 + b)) * g.Nz + (z0 + c);
    };
    auto q_of = [&](int a, int b, int c) {
      return comp < 3 ? P.q[bi][g.at(i0 + a, j0 + b, z0 + c)]
                      : box[(a + r) * L.csx + (b + r) * L.csy + (c + kTracerZ)];
    };
    const oc::Walk w0(threadIdx.x, ey, ez);
    T gv[kCells], qv[kCells];
    {
      oc::Walk w = w0;
#pragma unroll
      for (int u = 0; u < kCells; ++u, w.next()) {
        if ((int)threadIdx.x + u * (int)blockDim.x < ncell) {
          gv[u] = gm != nullptr ? gm[cell(w.a, w.b, w.c)] : T(0);
          qv[u] = comp < 3 ? q_of(w.a, w.b, w.c) : T(0);
        }
      }
    }
    // each face flux once; u's x-, v's y- and w's z-fluxes sit at centres
    const int cx = comp == 0, cy = comp == 1, cz = comp == 2;
    oc::for_box((ex + 1) * ey * ez, ey, ez, [&](int a, int b, int c) {
      Fx[(a * TY + b) * TZ + c] =
          oc::face_flux_x<SCH>(P.st, sr, comp, box, i0 + a - cx, j0 + b, z0 + c);
    });
    oc::for_box(ex * (ey + 1) * ez, ey + 1, ez, [&](int a, int b, int c) {
      Fy[(a * (TY + 1) + b) * TZ + c] =
          oc::face_flux_y<SCH>(P.st, sr, comp, box, i0 + a, j0 + b - cy, z0 + c);
    });
    oc::for_box(ex * ey * (ez + 1), ey, ez + 1, [&](int a, int b, int c) {
      Fz[(a * TY + b) * (TZ + 1) + c] =
          oc::face_flux_z<SCH>(P.st, sr, comp, box, i0 + a, j0 + b, z0 + c - cz);
    });
    __syncthreads();
    // per cell: the differences, G and the stage update
    auto update = [&](int a, int b, int c, T gmv, T q) {
      const T tx = Fx[((a + 1) * TY + b) * TZ + c] - Fx[(a * TY + b) * TZ + c];
      const T ty = Fy[(a * (TY + 1) + b + 1) * TZ + c] - Fy[(a * (TY + 1) + b) * TZ + c];
      const T tz = Fz[(a * TY + b) * (TZ + 1) + c + 1] - Fz[(a * TY + b) * (TZ + 1) + c];
      const T G = -(((tx + ty) + tz) / P.st.V);
      T inc = P.gdt * G;
      if (gm != nullptr) inc = inc + P.zdt * gmv;
      P.G[bi][cell(a, b, c)] = G;
      oc::store_with_images(P.out[bi], g, x0 + a, y0 + b, z0 + c, q + inc);
    };
    oc::Walk w = w0;
    int m = threadIdx.x;
#pragma unroll
    for (int u = 0; u < kCells; ++u, m += blockDim.x, w.next())
      if (m < ncell) update(w.a, w.b, w.c, gv[u], comp < 3 ? qv[u] : q_of(w.a, w.b, w.c));
    for (; m < ncell; m += blockDim.x, w.next())   // cells past kCells a thread
      update(w.a, w.b, w.c, gm != nullptr ? gm[cell(w.a, w.b, w.c)] : T(0),
             q_of(w.a, w.b, w.c));
  }
}

struct Args {
  const void* const* vel;   // u*, v*, w*
  const void* p;
  const void* const* q;
  const void* const* gm;
  void* const* G;
  void* const* out;
  int nb, first;
  oc::Geom g;
  double gdt, zdt, cdt, Ax, Ay, Az, V, inv_dx, inv_dy, inv_dz;
  const double* coefs;
  int TX, TY, TZ, threads, blocks, smem;   // the launch plan
  bool corrected;                          // a pressure is given
  cudaStream_t stream;
  int* per_sm;   // non-null: report the blocks an SM holds instead of launching
};

// C: the corrected variant (a pressure is given).
template <int SCH, typename T, typename S, bool C>
int launch_variant(const Args& a) {
  const int tiles_y = oc::ceil_div(a.g.Ny, a.TY), tiles_z = oc::ceil_div(a.g.Nz, a.TZ);
  const long long want =
      (long long)Layout(a.TX, a.TY, a.TZ, kReach<SCH>, a.first + a.nb > 3).total * sizeof(T);
  const int req = kReach<SCH> + (C ? 1 : 0);
  if (a.smem != want || a.smem > oc::kMaxSmemBytes || a.g.Hx < req || a.g.Hy < req ||
      a.TX * a.TY * a.TZ > kCells * a.threads ||
      a.blocks != oc::ceil_div(a.g.Nx, a.TX) * tiles_y * tiles_z)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(advection_update_kernel<SCH, T, S, C>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             a.smem);
  if (e != cudaSuccess) return (int)e;
  if (a.per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.per_sm, advection_update_kernel<SCH, T, S, C>, a.threads, a.smem);
  Params<T, S, C> P;
  Read<T, S, C>& rd = P.st.rd;
  for (int d = 0; d < 3; ++d) rd.vel[d] = (const T*)a.vel[d];
  rd.p = (const T*)a.p;
  const T c_dt = (T)a.cdt;
  rd.cx = c_dt * (T)a.inv_dx;
  rd.cy = c_dt * (T)a.inv_dy;
  rd.cz = c_dt * (T)a.inv_dz;
  rd.g = a.g;
  P.st.Ax = (T)a.Ax;
  P.st.Ay = (T)a.Ay;
  P.st.Az = (T)a.Az;
  P.st.V = (T)a.V;
  P.st.tt = oc::make_tab<T>(a.coefs);
  P.st.ts = oc::make_tab<S>(a.coefs);
  for (int c = 0; c < kBatch; ++c) {
    const bool on = c < a.nb;
    P.q[c] = on ? (const T*)a.q[c] : nullptr;
    P.gm[c] = on && a.gm != nullptr ? (const T*)a.gm[c] : nullptr;
    P.G[c] = on ? (T*)a.G[c] : nullptr;
    P.out[c] = on ? (T*)a.out[c] : nullptr;
  }
  P.nb = a.nb;
  P.first = a.first;
  P.gdt = (T)a.gdt;
  P.zdt = (T)a.zdt;
  P.TX = a.TX;
  P.TY = a.TY;
  P.TZ = a.TZ;
  P.tiles_y = tiles_y;
  P.tiles_z = tiles_z;
  advection_update_kernel<SCH, T, S, C><<<a.blocks, a.threads, a.smem, a.stream>>>(P);
  return (int)cudaGetLastError();
}

template <int SCH, typename T, typename S>
int launch(const Args& a) {
  return a.corrected ? launch_variant<SCH, T, S, true>(a)
                     : launch_variant<SCH, T, S, false>(a);
}

template <int SCH>
int dispatch(int dtype, int sdtype, const Args& a) {
  if constexpr (SCH == kCentered2) {   // no smoothness arithmetic
    if (dtype == OC_FLOAT32) return launch<SCH, float, float>(a);
    if (dtype == OC_FLOAT64) return launch<SCH, double, double>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32) return launch<SCH, float, float>(a);
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64) return launch<SCH, float, double>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32) return launch<SCH, double, float>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64) return launch<SCH, double, double>(a);
  if (dtype == OC_FLOAT32 && sdtype == OC_BFLOAT16) return launch<SCH, float, oc::bf16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// scheme: 0 WENO(5), 1 Centered(2). dtype: OC_FLOAT32 or OC_FLOAT64 for the
// fields; sdtype: OC_FLOAT32, OC_FLOAT64 or (with float32 fields) OC_BFLOAT16
// for the WENO smoothness arithmetic. vel: host array of
// the u*, v*, w* device pointers; p: the padded pressure, or null for no
// correction. q, G, out: host arrays of the batch's nb device pointers
// (components first .. first+nb-1 of u, v, w, tracers...); gm: such an array
// of the previous stage's tendencies, or null on the first stage. Scalars
// arrive as doubles holding field-dtype values; coefs is the host table of
// Tab (kTabSize float64 values). TX, TY, TZ, threads, blocks, smem: the
// launch plan of kernels/fused_advection.py launch_plan (the tile, the
// threads a block, ceil(Nx/TX)·ceil(Ny/TY)·ceil(Nz/TZ) blocks and the
// dynamic shared memory in bytes), refused unless they agree with the
// tile's layout.
int oc_fused_advection_update(int scheme, int dtype, int sdtype, const void* const* vel,
                              const void* p, const void* const* q,
                              const void* const* gm, void* const* G, void* const* out,
                              int nb, int first, int Nx, int Ny, int Nz, int Hx, int Hy,
                              double gdt, double zdt, double cdt, double Ax, double Ay,
                              double Az, double V, double inv_dx, double inv_dy,
                              double inv_dz, const double* coefs, int ncoefs, int TX,
                              int TY, int TZ, int threads, int blocks, int smem,
                              void* stream) {
  if (ncoefs != kTabSize || nb < 1 || nb > kBatch || first < 0 || TX < 1 || TY < 1 ||
      TZ < 1 || threads < 32 || threads > kThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{vel, p, q, gm, G, out, nb, first, oc::Geom{Nx, Ny, Nz, Hx, Hy, 0},
         gdt, zdt, cdt, Ax, Ay, Az, V, inv_dx, inv_dy, inv_dz, coefs,
         TX, TY, TZ, threads, blocks, smem, p != nullptr, (cudaStream_t)stream, nullptr};
  if (scheme == kWeno5) return dispatch<kWeno5>(dtype, sdtype, a);
  if (scheme == kCentered2) return dispatch<kCentered2>(dtype, sdtype, a);
  return (int)cudaErrorInvalidValue;
}

// The blocks of the launch plan's shape that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *per_sm, for the
// corrected or uncorrected variant and a launch with or without tracers.
int oc_fused_advection_update_blocks_per_sm(int scheme, int dtype, int sdtype, int corrected,
                                            int tracers, int TX, int TY, int TZ, int threads,
                                            int smem, int* per_sm) {
  const int H = (scheme == kWeno5 ? 3 : 1) + 1;
  Args a{};
  a.nb = tracers ? 4 : 3;
  a.g = oc::Geom{TX, TY, TZ, H, H, 0};
  a.TX = TX;
  a.TY = TY;
  a.TZ = TZ;
  a.threads = threads;
  a.blocks = 1;
  a.smem = smem;
  a.corrected = corrected != 0;
  a.per_sm = per_sm;
  if (scheme == kWeno5) return dispatch<kWeno5>(dtype, sdtype, a);
  if (scheme == kCentered2) return dispatch<kCentered2>(dtype, sdtype, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
