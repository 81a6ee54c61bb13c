"""Device meshes, domain decomposition, the meeting points of the shards,
the halo exchange between them and the pencil Poisson solvers."""

from .communicator import Communicator, ShardError
from .distributed import (CPU, GPU, Blocks, CubedSpherePartition,
                          Distributed, Equal, Fractional, Mesh, Partition,
                          Shard, Sizes, XPartition, YPartition)
from .halo_exchange import (halo_exchange_local, halo_exchange_plain,
                            make_halo_exchange, mesh_halo_exchange)
from .pencil_fft import (DistributedFFTPoissonSolver,
                         DistributedFourierTridiagonalPoissonSolver)

__all__ = ["CPU", "GPU", "Distributed", "Partition", "Mesh", "Equal",
           "Fractional", "Sizes", "XPartition", "YPartition",
           "CubedSpherePartition", "Blocks", "Shard",
           "Communicator", "ShardError", "halo_exchange_local",
           "halo_exchange_plain", "make_halo_exchange", "mesh_halo_exchange",
           "DistributedFFTPoissonSolver",
           "DistributedFourierTridiagonalPoissonSolver"]
