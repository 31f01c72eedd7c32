"""Multi-device paths: a mesh of shards (:mod:`.mesh`), its collectives
(:mod:`.collectives`), sharded vectors and DIA operators (:mod:`.sharded`)
and row-sharded SpMV (:mod:`.spmv`)."""

from sparse_linear_tpu_torch.dist.mesh import Mesh, card_mesh
from sparse_linear_tpu_torch.dist.sharded import ShardedDIA, ShardedVector

__all__ = ["Mesh", "card_mesh", "ShardedDIA", "ShardedVector"]
