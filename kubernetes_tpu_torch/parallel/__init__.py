"""The node mesh on one card: the node axis split over shards.

See mesh.py for the mesh and sharded.py for the sharded solve and its
pipeline; commit/arbiter.make_sharded_arbiter and
ops/fold.make_sharded_fold_fns are the commit plane's twins. The
reference's multi-host pair (init_distributed, multihost_node_mesh) waits
for the multi-card transport.
"""

from .mesh import AXIS_NODES, AXIS_PODS, Mesh, node_mesh, node_shards
from .sharded import make_sharded_pipeline

__all__ = [
    "AXIS_NODES",
    "AXIS_PODS",
    "Mesh",
    "node_mesh",
    "node_shards",
    "make_sharded_pipeline",
]
