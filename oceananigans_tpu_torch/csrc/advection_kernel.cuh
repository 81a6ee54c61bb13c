// Flux-form advection of momentum and tracers, z-compact or padded, as
// shared-memory tiles: the RK3 stage update (#1) and the tendency alone
// (#6), one kernel template whose epilogue (kUpdate) and staging read policy
// (R) are compile-time choices, so that every face flux of both goes through
// one code path. fused_advection.cu holds the C entries; advection_k1.cu ..
// advection_k6.cu instantiate the template for each buffer K, one nvcc
// process each.
//
// #1 replaces oceananigans_tpu/kernels/fused_advection.py
// _build_update_group (:269, via build_fused_advection_update; the
// pallas_call at :626), momentum and tracer groups alike, in the z-compact
// layout:
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
// #6 replaces build_fused_advection (:149, the pallas_call at :232), the
// tendency the model runs when other tendencies (buoyancy, closure, boundary
// fluxes) are added to G before the stage update: G = -∇·(𝐯q) for u, v, w
// and each tracer, written straight to the (components, Nx, Ny, Nz) output,
// with no stage update, no G⁻ and no periodic images. Its z is bounded,
// periodic or flat (AdvectionArgs::zmode, from the grid's topology, as the
// TPU kernel's slab grid keeps z's topology, :47 and :166; a compile-time
// property of the read policy, so that each mode has its own
// instantiation), in one of three layouts: padded (a bounded or periodic z,
// Hz >= the reach; halos filled beforehand, z included, read as they are:
// PaddedRead; the cascade only on a bounded z), z-compact (a bounded z with
// Hz = 0: the z mirrors and zero boundary-face fluxes of CompactRead,
// uncorrected) or flat (Nz = 1, Hz = 0: no z flux and no z reach,
// PaddedRead<T, kZFlat>). #7 runs #6 once per shard.
//
// Schemes: every scheme of oceananigans_tpu/advection/schemes.py, as the
// TPU kernels take them (they call the scheme's reconstruction in their
// bodies): Centered(2-12), UpwindBiased(1-11), WENO(3-11), with the
// near-wall order cascade on the global z index of a bounded z
// (advection_stencils.cuh).
//
// Bound: over u, v, w alone, arithmetic: for WENO(5) about 300
// floating-point operations per component and cell (each face flux once;
// chip_smoke.py advection_flop), for WENO(9) about 1,090, for WENO(11)
// about 1,650; 0.22 ms (WENO(5)) and 0.82 ms (WENO(9)) at 256³ against the
// datasheet's 67 Tflop/s; against 16 B per component of compulsory traffic
// in float32 for #1 (read q, write G and new, read G⁻), 8 B for #6 (read
// q, write G).
// With tracers the bytes bind #1 at WENO(5) (1.26 ms for 15 components at
// 256³). No tensor cores: the WENO weights are nonlinear in the data, and
// nothing here is a product wgmma could take.
//
// Design: one block owns a TX × TY × TZ tile of interior cells (z fastest
// across threads; a ragged edge is masked, Nz need not be a multiple of TZ)
// and works through it in phases separated by __syncthreads() (tiles.cuh):
//   staging     u, v and w over the tile plus the stencil's reach (K cells
//               each way for a scheme of buffer K), each value formed once by
//               the read policy's `staged`: for #1 the deferred correction,
//               w's pinned bottom face, the even and odd z mirrors and, with
//               bfloat16 smoothness, the rounded correction (kRn); for the
//               padded #6 a rectangular window of the filled arrays. Each
//               stencil read is then one shared-memory load; loads through
//               registers, kInFlight in flight a thread;
//   components  u, v, w, then the tracers of the launch, with the velocity
//               boxes resident throughout. A tracer's box is copied by
//               cp.async into one of two buffers while the block works on
//               the component before it, so its loads wait behind
//               arithmetic; then (#1) the update's device-memory reads (G⁻,
//               and q* of u, v, w; a tracer's q is in its box) are issued
//               into registers, each face flux is formed once on each axis
//               into shared memory (face_flux_x/y/z through SharedRead), and
//               per cell the differences give G, and for #1 `new` with its
//               periodic x/y images (store_with_images, in place of the TPU
//               kernel's strip DMAs).
// No TMA: a compact box is a strided window with mirrored z rows, not a
// rectangle of the array, and a padded box's rows (Nz + 2Hz = 262 values at
// 256³) are not 16-byte aligned. Every face flux goes through one code path
// wherever it lies in the tile, so #7's shards, whose tiles fall unlike the
// serial grid's, give the serial result bit for bit; the loops walk their
// items with carries, no division. The tile (by the reach and the element
// size: the boxes grow with the reach), the block count and the dynamic
// shared memory come from kernels/fused_advection.py launch_plan; the C
// entries recompute and check them. Registers and spills: `-Xptxas -v`
// (chip_smoke.py prints them). Divisions are exact `/`.
//
// A launch covers a batch of components of (u, v, w, tracers...) (at most
// kBatch, their pointers in the parameter block); the wrapper launches once
// per batch. The TPU kernel's groups (momentum, then tracers in batches of
// 4) are a VMEM workaround; every component's result depends only on its own
// field and u, v, w, p, so the batching does not change a bit of it.
#pragma once

#include "advection_stencils.cuh"
#include "bounded_limiter.cuh"
#include "tiles.cuh"

namespace oc {

// The arguments of one launch of #1 or #6, from the C entries.
struct AdvectionArgs {
  const void* const* vel;   // u, v, w (#1: u*, v*, w*)
  const void* p;            // #1: the pressure, or null
  const void* const* q;
  const void* const* gm;
  void* const* G;
  void* const* out;
  int nb, first;
  Geom g;
  double gdt, zdt, cdt, Ax, Ay, Az, V, inv_dx, inv_dy, inv_dz;
  const double* coefs;
  int TX, TY, TZ, threads, blocks, smem;   // the launch plan
  cudaStream_t stream;
  int* per_sm;   // non-null: report the blocks an SM holds instead of launching
  int zmode;     // #6: kZBounded (0, #1's), kZPeriodic or kZFlat: the read policy's
  double lo, hi; // the bounded #6: the limiter's bounds
};

// One function per buffer K (advection_kK.cu): fam kCentered, kUpwind or
// kWeno; dtype and sdtype the codes of common.cuh. #1 (update) or #6.
int advection_k1(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a);
int advection_k2(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a);
int advection_k3(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a);
int advection_k4(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a);
int advection_k5(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a);
int advection_k6(bool update, int fam, int dtype, int sdtype, const AdvectionArgs& a);

// The bounded #6 (WENO with the bounds-preserving limiter on its tracers,
// bounded_limiter.cuh), padded layout: one function per buffer K
// (advection_bounded_kK.cu; advection_bounded.cu holds the C entries).
int advection_bounded_k2(int dtype, int sdtype, const AdvectionArgs& a);
int advection_bounded_k3(int dtype, int sdtype, const AdvectionArgs& a);
int advection_bounded_k4(int dtype, int sdtype, const AdvectionArgs& a);
int advection_bounded_k5(int dtype, int sdtype, const AdvectionArgs& a);
int advection_bounded_k6(int dtype, int sdtype, const AdvectionArgs& a);
int advection_bounded(int K, int dtype, int sdtype, const AdvectionArgs& a);

}  // namespace oc

namespace {

using oc::kBatch;

constexpr int kThreads = 256;  // the most threads a block takes
constexpr int kInFlight = 4;   // staging loads in flight a thread
constexpr int kCells = 4;      // cells a thread updates from registers read ahead

// Blocks an SM should hold, which caps a thread's registers: Centered(2)'s
// small boxes let three share an SM at float32, the other schemes two
// (128 registers; without a cap ptxas gives the bf16-smoothness
// instantiations 146-158 registers and one block an SM). At float64 the
// shared memory allows one block, and the cap is lifted.
template <int K, int F, typename T>
constexpr int kMinBlocks = sizeof(T) == 8 ? 1 : (K == 1 && F != oc::kWeno ? 3 : 2);

// The read policy of #1's staging: bfloat16 smoothness rounds the correction
// as the plain version does (CompactRead's kRn).
template <typename T, typename S>
using UpdateRead = oc::CompactRead<T, std::is_same<S, oc::bf16>::value>;

// A tracer box spans z0 - tz .. z0 + TZ + tz - 1 with tz the reach rounded
// up to 16 bytes of float32 (at least 4), so that away from the walls its
// rows are 16-byte aligned copies of the tracer's z columns.
__host__ __device__ constexpr int tracer_z(int r) { return r <= 4 ? 4 : (r + 3) / 4 * 4; }

// The reach of the boxes along z: the stencil's r, none on a flat z; and a
// tracer box's, tracer_z(r) or none.
__host__ __device__ constexpr int z_reach(int r, bool flat) { return flat ? 0 : r; }
__host__ __device__ constexpr int tracer_z_reach(int r, bool flat) {
  return flat ? 0 : tracer_z(r);
}

// The limited values at the faces of one axis at a time (the bounded #6):
// the largest of (TX + 1)·TY·TZ, TX·(TY + 1)·TZ and TX·TY·(TZ + 1) (no z
// axis on a flat z).
__host__ __device__ inline int limited_elems(int TX, int TY, int TZ, bool flat) {
  const int x = (TX + 1) * TY * TZ, y = TX * (TY + 1) * TZ;
  const int xy = x > y ? x : y;
  const int z = flat ? 0 : TX * TY * (TZ + 1);
  return xy > z ? xy : z;
}

// Element offsets of a block's shared arrays for a TX × TY × TZ tile, a
// stencil reach r and a z reach rz (r, or 0 on a flat z);
// kernels/fused_advection.py smem_bytes computes the same total.
struct Layout {
  int sx, sy;            // velocity box strides: (TY + 2r)(TZ + 2rz), TZ + 2rz
  int csx, csy;          // tracer box strides: (TY + 2r)(TZ + 2 tz), TZ + 2 tz
  int vel[3], c[2];      // boxes: u, v, w over (TX + 2r)(TY + 2r)(TZ + 2rz), two tracers
  int fx, fy, fz;        // fluxes (TX + 1)·TY·TZ, TX·(TY + 1)·TZ, TX·TY·(TZ + 1)
  int lim;               // the bounded #6 with tracers: limited values (limited_elems)
  int total;

  __host__ __device__ Layout(int TX, int TY, int TZ, int r, bool tracers, bool flat = false,
                             bool bounded = false) {
    sy = TZ + 2 * z_reach(r, flat);
    sx = (TY + 2 * r) * sy;
    csy = TZ + 2 * tracer_z_reach(r, flat);
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
    lim = o;
    if (bounded && tracers) o += oc::align_elems(limited_elems(TX, TY, TZ, flat));
    total = o;
  }
};

template <int K, int F, typename T, typename S, typename R>
struct Params {
  oc::Stencil<K, F, T, S> st;   // metrics and the table
  R rd;                  // u, v, w (#1: u*, v*, w*, p, Δt_prev/Δ): the staging reads
  const T* q[kBatch];    // the batch's fields (padded; #1: uncorrected q*)
  const T* gm[kBatch];   // #1: previous-stage tendencies (interior), or null
  T* G[kBatch];          // tendencies out (interior)
  T* out[kBatch];        // #1: new fields out (padded, periodic halos written)
  int nb, first;         // components first .. first + nb - 1: 0 u, 1 v, 2 w, 3+ tracers
  T gdt, zdt;            // #1: γΔt, ζΔt
  int TX, TY, TZ;        // the tile
  int tiles_y, tiles_z;  // tiles along y and z
  T lo, hi;              // the bounded #6: the limiter's bounds
};

// kUpdate: #1 (the stage update) or #6 (the tendency); R: the staging's read
// policy (CompactRead, or PaddedRead for the padded #6); K: the scheme's
// buffer (its reach); F: its family (kCentered, kUpwind, kWeno); kBnd: the
// bounded #6, whose tracer fluxes take the limiter (bounded_limiter.cuh).
template <int K, int F, typename T, typename S, typename R, bool kUpdate, bool kBnd = false>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<K, F, T>))
advection_kernel(const __grid_constant__ Params<K, F, T, S, R> P) {
  static_assert(!kBnd || (!kUpdate && !R::kWalls && F == oc::kWeno),
                "the limiter takes the padded #6 of a WENO scheme");
  constexpr int r = K;
  // the z reaches: r and tracer_z(r), none on a flat z
  constexpr bool flat = R::kZMode == oc::kZFlat;
  constexpr int rz = z_reach(r, flat), tz = tracer_z_reach(r, flat);
  extern __shared__ __align__(16) unsigned char oc_smem[];
  T* const sm = reinterpret_cast<T*>(oc_smem);
  const int last = P.first + P.nb;
  const int first_tracer = P.first > 3 ? P.first : 3;
  const Layout L(P.TX, P.TY, P.TZ, r, last > 3, flat, kBnd);
  const R& rd = P.rd;
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
  const oc::SharedRead<T, R::kWalls, R::kZMode> sr{{sm + L.vel[0], sm + L.vel[1], sm + L.vel[2]},
                                        i0 - r, j0 - r, z0 - rz, L.sx, L.sy,
                                        z0 - tz, L.csx, L.csy};
  const int wy = ey + 2 * r, wz = ez + 2 * rz, nbox = (ex + 2 * r) * wy * wz;

  // a tracer's box, two of them in turn: copies in flight (cp.async) while
  // the block works on the component before. Where the box's z rows are
  // read in place and 16-byte aligned, a row is TZ + 2·tz values of one z
  // column, copied 16 bytes at a time; elsewhere (by the compact layout's
  // walls, in a ragged z tile, in the padded layout) one value at a time
  // through the read policy, a slot it maps to no value (a mirror outside
  // [0, Nz) when Nz is below the reach, or a z outside the padded array;
  // never read) holding 0.
  constexpr int V = 16 / (int)sizeof(T);
  const int cw = TZ + 2 * tz;   // a tracer row
  // (selects, not an index into L.c: that would put L in local memory)
  auto tracer_box = [&](int comp) {
    return sm + ((comp - first_tracer) & 1 ? L.c[1] : L.c[0]);
  };
  auto stage_tracer = [&](int comp) {
    const T* const q = P.q[comp - P.first];
    T* const box = tracer_box(comp);
    const bool rows = rd.in_place(z0 - tz, z0 + TZ + tz) && g.PZ() % V == 0 &&
                      cw % V == 0 && L.csy % V == 0 &&
                      (uintptr_t)(q + rd.at_z(i0 - r, j0 - r, z0 - tz)) % 16 == 0;
    if (rows) {
      oc::for_box((ex + 2 * r) * wy * (cw / V), wy, cw / V, [&](int a, int b, int v) {
        const T* src = q + rd.at_z(i0 - r + a, j0 - r + b, z0 - tz + v * V);
        oc::copy_async16(box + a * L.csx + b * L.csy + v * V, src);
      });
    } else {
      oc::for_box((ex + 2 * r) * wy * cw, wy, cw, [&](int a, int b, int c) {
        T* const dst = box + a * L.csx + b * L.csy + c;
        const long long at = rd.tracer_at(i0 - r + a, j0 - r + b, z0 - tz + c);
        if (at < 0)
          *dst = T(0);
        else
          oc::copy_async(dst, q + at);
      });
    }
    oc::copy_async_commit();
  };
  if (first_tracer < last) stage_tracer(first_tracer);

  // staging: u, v, w over the tile plus the reach, through the read policy
  for (int d = 0; d < 3; ++d)
    oc::stage_box<kInFlight>(sm + (d == 0 ? L.vel[0] : d == 1 ? L.vel[1] : L.vel[2]), nbox, wy,
                             wz, [&](int a, int b, int c, int& at) {
      at = a * L.sx + b * L.sy + c;
      return rd.staged(d, i0 - r + a, j0 - r + b, z0 - rz + c);
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
    auto cell = [&](int a, int b, int c) {
      return ((long long)(x0 + a) * g.Ny + (y0 + b)) * g.Nz + (z0 + c);
    };
    // #1: the update's device-memory reads (G⁻; q* of u, v, w), issued
    // ahead of the fluxes for the first kCells cells of this thread
    const T* const gm = P.gm[bi];
    auto q_of = [&](int a, int b, int c) {
      return comp < 3 ? P.q[bi][g.at(i0 + a, j0 + b, z0 + c)]
                      : box[(a + r) * L.csx + (b + r) * L.csy + (c + tz)];
    };
    const oc::Walk w0(threadIdx.x, ey, ez);
    T gv[kCells], qv[kCells];
    if constexpr (kUpdate) {
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
    bool limited = false;
    if constexpr (kBnd) limited = comp >= 3;
    if (limited) {
      // the bounded #6's tracer, an axis at a time: the limited values of
      // the tile's cells plus one each way, the low face's into the flux
      // array and the high face's into lim (both by face), then the fluxes
      constexpr int ZM = R::kZMode;
      T* const lim = sm + L.lim;
      oc::for_box((ex + 2) * ey * ez, ey, ez, [&](int a, int b, int c) {
        const int f = (a * TY + b) * TZ + c;   // cell a - 1's high face
        oc::limited_values<ZM>(P.st, sr, box, 0, i0 + a - 1, j0 + b, z0 + c, P.lo, P.hi,
                               a > 0 ? Fx + f - TY * TZ : nullptr, a <= ex ? lim + f : nullptr);
      });
      __syncthreads();
      oc::for_box((ex + 1) * ey * ez, ey, ez, [&](int a, int b, int c) {
        const int f = (a * TY + b) * TZ + c;
        Fx[f] = oc::limited_flux(sr, 0, i0 + a, j0 + b, z0 + c, P.st.Ax, lim[f], Fx[f]);
      });
      __syncthreads();
      oc::for_box(ex * (ey + 2) * ez, ey + 2, ez, [&](int a, int b, int c) {
        const int f = (a * (TY + 1) + b) * TZ + c;
        oc::limited_values<ZM>(P.st, sr, box, 1, i0 + a, j0 + b - 1, z0 + c, P.lo, P.hi,
                               b > 0 ? Fy + f - TZ : nullptr, b <= ey ? lim + f : nullptr);
      });
      __syncthreads();
      oc::for_box(ex * (ey + 1) * ez, ey + 1, ez, [&](int a, int b, int c) {
        const int f = (a * (TY + 1) + b) * TZ + c;
        Fy[f] = oc::limited_flux(sr, 1, i0 + a, j0 + b, z0 + c, P.st.Ay, lim[f], Fy[f]);
      });
      if constexpr (flat) {
        oc::for_box(ex * ey * (ez + 1), ey, ez + 1,
                    [&](int a, int b, int c) { Fz[(a * TY + b) * (TZ + 1) + c] = T(0); });
      } else {
        __syncthreads();
        oc::for_box(ex * ey * (ez + 2), ey, ez + 2, [&](int a, int b, int c) {
          const int f = (a * TY + b) * (TZ + 1) + c;
          oc::limited_values<ZM>(P.st, sr, box, 2, i0 + a, j0 + b, z0 + c - 1, P.lo, P.hi,
                                 c > 0 ? Fz + f - 1 : nullptr, c <= ez ? lim + f : nullptr);
        });
        __syncthreads();
        oc::for_box(ex * ey * (ez + 1), ey, ez + 1, [&](int a, int b, int c) {
          const int f = (a * TY + b) * (TZ + 1) + c;
          Fz[f] = oc::limited_flux(sr, 2, i0 + a, j0 + b, z0 + c, P.st.Az, lim[f], Fz[f]);
        });
      }
    } else if (P.st.any) {
      // a FluxFormAdvection whose axes are not all the instantiation's:
      // each axis's family and buffer at run time
      oc::for_box((ex + 1) * ey * ez, ey, ez, [&](int a, int b, int c) {
        Fx[(a * TY + b) * TZ + c] =
            oc::face_flux_x<true>(P.st, sr, comp, box, i0 + a - cx, j0 + b, z0 + c);
      });
      oc::for_box(ex * (ey + 1) * ez, ey + 1, ez, [&](int a, int b, int c) {
        Fy[(a * (TY + 1) + b) * TZ + c] =
            oc::face_flux_y<true>(P.st, sr, comp, box, i0 + a, j0 + b - cy, z0 + c);
      });
      oc::for_box(ex * ey * (ez + 1), ey, ez + 1, [&](int a, int b, int c) {
        Fz[(a * TY + b) * (TZ + 1) + c] =
            oc::face_flux_z<true>(P.st, sr, comp, box, i0 + a, j0 + b, z0 + c - cz);
      });
    } else {
      oc::for_box((ex + 1) * ey * ez, ey, ez, [&](int a, int b, int c) {
        Fx[(a * TY + b) * TZ + c] =
            oc::face_flux_x(P.st, sr, comp, box, i0 + a - cx, j0 + b, z0 + c);
      });
      oc::for_box(ex * (ey + 1) * ez, ey + 1, ez, [&](int a, int b, int c) {
        Fy[(a * (TY + 1) + b) * TZ + c] =
            oc::face_flux_y(P.st, sr, comp, box, i0 + a, j0 + b - cy, z0 + c);
      });
      oc::for_box(ex * ey * (ez + 1), ey, ez + 1, [&](int a, int b, int c) {
        Fz[(a * TY + b) * (TZ + 1) + c] =
            oc::face_flux_z(P.st, sr, comp, box, i0 + a, j0 + b, z0 + c - cz);
      });
    }
    __syncthreads();
    // per cell: the differences, G (and #1's stage update)
    auto tendency = [&](int a, int b, int c) {
      const T tx = Fx[((a + 1) * TY + b) * TZ + c] - Fx[(a * TY + b) * TZ + c];
      const T ty = Fy[(a * (TY + 1) + b + 1) * TZ + c] - Fy[(a * (TY + 1) + b) * TZ + c];
      const T tz_ = Fz[(a * TY + b) * (TZ + 1) + c + 1] - Fz[(a * TY + b) * (TZ + 1) + c];
      const T G = -(((tx + ty) + tz_) / P.st.V);
      P.G[bi][cell(a, b, c)] = G;
      return G;
    };
    if constexpr (kUpdate) {
      auto update = [&](int a, int b, int c, T gmv, T q) {
        T inc = P.gdt * tendency(a, b, c);
        if (gm != nullptr) inc = inc + P.zdt * gmv;
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
    } else {
      oc::for_box(ncell, ey, ez, [&](int a, int b, int c) { tendency(a, b, c); });
    }
  }
}

// Check the launch plan against the tile's layout and the halos, then
// launch the instantiation (or report its blocks per SM).
template <int K, int F, typename T, typename S, typename R, bool kUpdate, bool kBnd = false>
int launch_with(const oc::AdvectionArgs& a, R rd) {
  constexpr int r = K;
  const int tiles_y = oc::ceil_div(a.g.Ny, a.TY), tiles_z = oc::ceil_div(a.g.Nz, a.TZ);
  constexpr bool flat = R::kZMode == oc::kZFlat;
  const long long want =
      (long long)Layout(a.TX, a.TY, a.TZ, r, a.first + a.nb > 3, flat, kBnd).total *
      sizeof(T);
  const int req = r + (kUpdate && a.p != nullptr ? 1 : 0);
  // a bounded z takes either layout, a periodic z the padded one, a flat z
  // one level and no z halo; #1 takes the z-compact bounded z alone
  const bool z_ok = a.zmode == R::kZMode &&
                    (flat ? a.g.Nz == 1 && a.g.Hz == 0 : R::kWalls || a.g.Hz >= r);
  if (a.smem != want || a.smem > oc::kMaxSmemBytes || a.g.Hx < req || a.g.Hy < req ||
      !z_ok ||
      a.TX * a.TY * a.TZ > kCells * a.threads ||
      a.blocks != oc::ceil_div(a.g.Nx, a.TX) * tiles_y * tiles_z)
    return (int)cudaErrorInvalidValue;
  auto* kernel = advection_kernel<K, F, T, S, R, kUpdate, kBnd>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  if (a.per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.per_sm, kernel, a.threads,
                                                              a.smem);
  Params<K, F, T, S, R> P;
  for (int d = 0; d < 3; ++d) rd.vel[d] = (const T*)a.vel[d];
  rd.g = a.g;
  P.rd = rd;
  P.st.Ax = (T)a.Ax;
  P.st.Ay = (T)a.Ay;
  P.st.Az = (T)a.Az;
  P.st.V = (T)a.V;
  P.st.Nz = a.g.Nz;
  P.st.tab = oc::Tabs<K, F == oc::kWeno, T, S>::make(a.coefs);
  if (!oc::axis_codes(a.coefs, K, F == oc::kWeno, P.st.af, P.st.ak))
    return (int)cudaErrorInvalidValue;
  P.st.any = oc::any_axis(F, K, P.st.af, P.st.ak, R::kZMode == oc::kZBounded);
  for (int c = 0; c < kBatch; ++c) {
    const bool on = c < a.nb;
    P.q[c] = on ? (const T*)a.q[c] : nullptr;
    P.gm[c] = on && a.gm != nullptr ? (const T*)a.gm[c] : nullptr;
    P.G[c] = on ? (T*)a.G[c] : nullptr;
    P.out[c] = on && a.out != nullptr ? (T*)a.out[c] : nullptr;
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
  P.lo = (T)a.lo;
  P.hi = (T)a.hi;
  kernel<<<a.blocks, a.threads, a.smem, a.stream>>>(P);
  return (int)cudaGetLastError();
}

// #1: the correction's pressure and factors when a pressure is given.
template <int K, int F, typename T, typename S>
int launch_update(const oc::AdvectionArgs& a) {
  UpdateRead<T, S> rd{};
  if (a.p != nullptr) {
    rd.p = (const T*)a.p;
    const T c_dt = (T)a.cdt;
    rd.cx = c_dt * (T)a.inv_dx;
    rd.cy = c_dt * (T)a.inv_dy;
    rd.cz = c_dt * (T)a.inv_dz;
  }
  return launch_with<K, F, T, S, UpdateRead<T, S>, true>(a, rd);
}

// #6: the layout follows the z mode and Hz: a bounded z without a halo is
// z-compact, every other z padded, each z mode its own instantiation.
template <int K, int F, typename T, typename S>
int launch_tendency(const oc::AdvectionArgs& a) {
  if (a.zmode == oc::kZPeriodic)
    return launch_with<K, F, T, S, oc::PaddedRead<T, oc::kZPeriodic>, false>(a, {});
  if (a.zmode == oc::kZFlat)
    return launch_with<K, F, T, S, oc::PaddedRead<T, oc::kZFlat>, false>(a, {});
  if (a.g.Hz == 0) return launch_with<K, F, T, S, oc::CompactRead<T>, false>(a, {});
  return launch_with<K, F, T, S, oc::PaddedRead<T>, false>(a, {});
}

// The instantiations of buffer K, one per family: the linear families take
// the field type alone (no smoothness arithmetic), WENO (K >= 2) the five
// smoothness pairs.
template <int K>
int dispatch(bool update, int fam, int dtype, int sdtype, const oc::AdvectionArgs& a) {
  if (a.nb < 1 || a.nb > kBatch || a.first < 0 || a.TX < 1 || a.TY < 1 || a.TZ < 1 ||
      a.threads < 32 || a.threads > kThreads || a.threads % 32 != 0 || a.g.Hz < 0 ||
      a.zmode < oc::kZBounded || a.zmode > oc::kZFlat)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto f, auto t, auto s) {
    constexpr int F = decltype(f)::value;
    using T = decltype(t);
    using S = decltype(s);
    return update ? launch_update<K, F, T, S>(a) : launch_tendency<K, F, T, S>(a);
  };
  auto linear = [&](auto f) {
    if (dtype == OC_FLOAT32) return go(f, float(), float());
    if (dtype == OC_FLOAT64) return go(f, double(), double());
    return (int)cudaErrorInvalidValue;
  };
  if (fam == oc::kCentered) return linear(std::integral_constant<int, oc::kCentered>());
  if (fam == oc::kUpwind) return linear(std::integral_constant<int, oc::kUpwind>());
  if constexpr (K >= 2) {
    using Weno = std::integral_constant<int, oc::kWeno>;
    if (fam != oc::kWeno) return (int)cudaErrorInvalidValue;
    if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32) return go(Weno(), float(), float());
    if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT64) return go(Weno(), float(), double());
    if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32) return go(Weno(), double(), float());
    if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64) return go(Weno(), double(), double());
    if (dtype == OC_FLOAT32 && sdtype == OC_BFLOAT16) return go(Weno(), float(), oc::bf16());
  }
  return (int)cudaErrorInvalidValue;
}

// The bounded #6 of buffer K: the padded layout of a bounded z (with the
// cascade), of a periodic z, or a flat z, each its own instantiation; the
// z-compact layout refused (kernels/fused_advection.py
// bounded_refusal).
template <int K, typename T, typename S>
int launch_bounded(const oc::AdvectionArgs& a) {
  constexpr int W = oc::kWeno;
  if (a.zmode == oc::kZPeriodic)
    return launch_with<K, W, T, S, oc::PaddedRead<T, oc::kZPeriodic>, false, true>(a, {});
  if (a.zmode == oc::kZFlat)
    return launch_with<K, W, T, S, oc::PaddedRead<T, oc::kZFlat>, false, true>(a, {});
  if (a.zmode != oc::kZBounded || a.g.Hz == 0) return (int)cudaErrorInvalidValue;
  return launch_with<K, W, T, S, oc::PaddedRead<T>, false, true>(a, {});
}

// The bounded #6's instantiations of buffer K (>= 2): the smoothness in the
// fields' type, or float32 with float64 fields (WENO's default smoothness),
// each with the three z modes: nine a buffer, about ten seconds of nvcc
// each, one source a buffer (the build's time is the chip script's).
template <int K>
int dispatch_bounded(int dtype, int sdtype, const oc::AdvectionArgs& a) {
  if (a.nb < 1 || a.nb > kBatch || a.first < 0 || a.TX < 1 || a.TY < 1 || a.TZ < 1 ||
      a.threads < 32 || a.threads > kThreads || a.threads % 32 != 0 || a.g.Hz < 0 ||
      !(a.lo <= a.hi))
    return (int)cudaErrorInvalidValue;
  if (dtype == OC_FLOAT32 && sdtype == OC_FLOAT32) return launch_bounded<K, float, float>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT64) return launch_bounded<K, double, double>(a);
  if (dtype == OC_FLOAT64 && sdtype == OC_FLOAT32) return launch_bounded<K, double, float>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
