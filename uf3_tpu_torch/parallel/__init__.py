"""
Multi-shard MD and fitting on ``torch.distributed``: the shard mesh,
the sharded Gram and fits, the replicated-positions MD chunk
(``mesh.py``) and the halo-exchange slab decomposition (``halo.py``).
"""

from uf3_tpu_torch.parallel.halo import (SlabDecomposition, decompose,
                                         gather_positions,
                                         halo_md_step_factory,
                                         scatter_velocities)
from uf3_tpu_torch.parallel.mesh import (ShardMesh, ShardedRows,
                                         fit_from_file_sharded, fit_sharded,
                                         make_mesh, sharded_gram,
                                         sharded_md_step_factory)

__all__ = ["ShardMesh", "ShardedRows", "SlabDecomposition", "decompose",
           "fit_from_file_sharded", "fit_sharded", "gather_positions",
           "halo_md_step_factory", "make_mesh", "scatter_velocities",
           "sharded_gram", "sharded_md_step_factory"]
