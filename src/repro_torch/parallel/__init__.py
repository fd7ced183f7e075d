"""Parallelism over ``torch.distributed`` — port of ``repro.parallel``:
the logical-axis sharding rules and their DTensor placements
(``sharding``), and GPipe over a ``pipe`` mesh axis (``pipeline``)."""
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import (MeshShape, ShardingRules,
                                           distribute_tree, local_map,
                                           logical_to_pspec, make_rules,
                                           make_sharder, mesh_axis_size,
                                           to_placements)

__all__ = ["MeshShape", "ShardingRules", "distribute_tree", "local_map",
           "logical_to_pspec", "make_rules", "make_sharder",
           "mesh_axis_size", "pipeline_apply", "to_placements"]
