"""Device meshes, domain decomposition and the halo exchange between shards.

``DistributedFFTPoissonSolver`` and ``DistributedFourierTridiagonalPoissonSolver``
of the JAX package (``parallel/pencil_fft.py``) are not ported yet (ROADMAP.md
queue 1 item 16).
"""

from .distributed import (CPU, GPU, CubedSpherePartition, Distributed, Equal,
                          Fractional, Mesh, Partition, Sizes, XPartition,
                          YPartition)
from .halo_exchange import (halo_exchange_local, halo_exchange_plain,
                            make_halo_exchange, mesh_halo_exchange)

__all__ = ["CPU", "GPU", "Distributed", "Partition", "Mesh", "Equal",
           "Fractional", "Sizes", "XPartition", "YPartition",
           "CubedSpherePartition", "halo_exchange_local", "halo_exchange_plain",
           "make_halo_exchange", "mesh_halo_exchange"]
