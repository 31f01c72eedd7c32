"""Multi-device paths: a mesh of shards (:mod:`.mesh`), its collectives
(:mod:`.collectives`), sharded vectors, blocks and DIA operators
(:mod:`.sharded`) and row-sharded SpMV and SpMM (:mod:`.spmv`)."""

from sparse_linear_tpu_torch.dist.mesh import Mesh, card_mesh
from sparse_linear_tpu_torch.dist.sharded import (
    ShardedBlock,
    ShardedDIA,
    ShardedVector,
)

__all__ = ["Mesh", "card_mesh", "ShardedBlock", "ShardedDIA",
           "ShardedVector"]
