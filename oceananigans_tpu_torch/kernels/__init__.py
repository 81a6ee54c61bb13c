"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors; it counts its launches in a ``launches`` attribute (the
advection kernels #1, #6 and #8 by scheme variant, and #10 by the buffer
it is instantiated for and its stretched axes, in ``variant_launches``),
and
each plain version counts the calls it served on CUDA tensors in
``cuda_calls``. ``vpu_probes`` holds the vector-unit probes, which run
no model. The sharded stages #7 and #9 (``shard_fused_advection`` and
``shard_fused_sw_update``, each shard's launch on its resident blocks, and
the whole-mesh ``build_sharded_*``) count their per-shard launches, by
variant, under ``build_sharded_fused_advection`` and
``build_sharded_fused_sw_update``; the halo exchange between shards lives
in ``parallel/halo_exchange.py``. The kernels build at first use
(``build.py``).
"""

from ..parallel.halo_exchange import halo_exchange_plain, mesh_halo_exchange
from .fused_advection import (build_sharded_fused_advection,
                              build_sharded_fused_advection_plain,
                              shard_fused_advection,
                              fused_advection_tendency,
                              fused_advection_tendency_plain,
                              fused_advection_update,
                              fused_advection_update_plain)
from .fused_projection import (fused_correct, fused_correct_plain,
                               fused_divergence, fused_divergence_plain)
from .fused_shallow_water import (build_sharded_fused_sw_update,
                                  build_sharded_fused_sw_update_plain,
                                  shard_fused_sw_update,
                                  fused_sw_update, fused_sw_update_plain)
from .fused_vector_invariant import (fused_vi_tendency,
                                     fused_vi_tendency_plain)
from .halo_fill import (ZFill, bounded_z_fill_plain, fill_bounded_axis,
                        fill_halos, fill_halos_plain, fold_north,
                        periodic_halo_fill, periodic_halo_fill_plain)
from .vpu_probes import (bf16_smoothness, bf16_smoothness_plain, vpu_mix,
                         vpu_mix_plain, weno_microbench, weno_microbench_plain)

KERNELS = (fused_advection_update, fused_divergence, fused_correct,
           fill_halos, fused_advection_tendency,
           fused_sw_update, fused_vi_tendency, mesh_halo_exchange,
           build_sharded_fused_sw_update, build_sharded_fused_advection,
           weno_microbench, vpu_mix, bf16_smoothness)
PLAINS = (fused_advection_update_plain, fused_divergence_plain,
          fused_correct_plain, fill_halos_plain, periodic_halo_fill_plain,
          fill_bounded_axis, fold_north, fused_advection_tendency_plain,
          bounded_z_fill_plain,
          fused_sw_update_plain, fused_vi_tendency_plain, halo_exchange_plain,
          build_sharded_fused_sw_update_plain,
          build_sharded_fused_advection_plain, weno_microbench_plain,
          vpu_mix_plain, bf16_smoothness_plain)


# the kernels that also count their launches by scheme variant
# (``variant_launches``: {``fused_advection.variant_name``: launches})
VARIANT_KERNELS = (fused_advection_update, fused_advection_tendency,
                   fused_sw_update, fused_vi_tendency,
                   build_sharded_fused_advection,
                   build_sharded_fused_sw_update)


def reset_counters():
    for fn in KERNELS:
        fn.launches = 0
    for fn in VARIANT_KERNELS:
        fn.variant_launches = {}
    fill_halos.surface_launches = 0
    fill_halos.plane_launches = fill_halos.pa_launches = 0
    for fn in PLAINS:
        fn.cuda_calls = 0


def counters():
    """{kernel name: launches} and {plain name: calls on CUDA tensors}; the
    fill's launches also split into those on 3-D fields
    (``fill_halos_3d``) and on 2-D surface fields (``fill_halos_2d``), and
    the advection kernels' by scheme variant (``fused_advection_update_weno9``:
    the launches of #1 with WENO(9)) and #10's by variant
    (``fused_vi_tendency_k5_z``: its launches at buffer 5 on a stretched
    z); ``fill_halos_planes`` counts the fill launches that read plane
    conditions, ``fill_halos_perturbation`` those with a
    PerturbationAdvection face."""
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    for fn in VARIANT_KERNELS:
        launches.update({f"{fn.__name__}_{name}": n
                         for name, n in fn.variant_launches.items()})
    launches["fill_halos_2d"] = fill_halos.surface_launches
    launches["fill_halos_3d"] = fill_halos.launches - \
        fill_halos.surface_launches
    launches["fill_halos_planes"] = fill_halos.plane_launches
    launches["fill_halos_perturbation"] = fill_halos.pa_launches
    return launches, {fn.__name__: fn.cuda_calls for fn in PLAINS}


__all__ = ["fused_advection_update", "fused_advection_update_plain",
           "fused_advection_tendency", "fused_advection_tendency_plain",
           "fused_divergence", "fused_divergence_plain", "fused_correct",
           "fused_correct_plain", "fill_halos", "fill_halos_plain",
           "periodic_halo_fill", "periodic_halo_fill_plain",
           "fill_bounded_axis", "fold_north", "bounded_z_fill_plain",
           "fused_sw_update", "fused_sw_update_plain",
           "fused_vi_tendency", "fused_vi_tendency_plain",
           "mesh_halo_exchange", "halo_exchange_plain",
           "build_sharded_fused_sw_update",
           "build_sharded_fused_sw_update_plain",
           "build_sharded_fused_advection",
           "build_sharded_fused_advection_plain",
           "shard_fused_advection", "shard_fused_sw_update",
           "weno_microbench", "weno_microbench_plain", "vpu_mix",
           "vpu_mix_plain", "bf16_smoothness", "bf16_smoothness_plain",
           "ZFill", "KERNELS", "PLAINS", "VARIANT_KERNELS",
           "reset_counters", "counters"]
