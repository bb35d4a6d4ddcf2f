"""Multi-card distribution layer (new capability vs the reference).

The reference is single-GPU (device 0 hardcoded, app/CUDA/util.cpp:19); its
only parallelism is one thread-block per subgrid. Here the subgrid batch
shards over a `jax.sharding.Mesh` via `shard_map`, and the master-grid
accumulation becomes a collective (`psum` / `psum_scatter`) that XLA hands
to NCCL.
"""

from .distributed import (
    distribute_observation,
    hierarchical_psum,
    init_distributed,
    make_hier_mesh,
)
from .mesh import make_mesh, pad_to_multiple
from .sharded import (
    sharded_degridder,
    sharded_grid_to_degridder,
    sharded_grid_to_degridder_gather,
    sharded_gridder,
    sharded_gridder_to_grid,
)

__all__ = [
    "distribute_observation",
    "hierarchical_psum",
    "init_distributed",
    "make_hier_mesh",
    "make_mesh",
    "pad_to_multiple",
    "sharded_gridder",
    "sharded_degridder",
    "sharded_grid_to_degridder",
    "sharded_grid_to_degridder_gather",
    "sharded_gridder_to_grid",
]
