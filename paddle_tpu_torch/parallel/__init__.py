"""Parallelism: meshes over ``torch.distributed`` ranks, partition rules
and collectives (the counterpart of ``paddle_tpu/parallel``).

Ported so far: the vocab-parallel projection of a stamped training
program (``annotate_spmd`` with a rule table that vocab-shards
``softmax_out.w``), each rank running its shard.  Tensor-parallel
trunks, dp > 1, the DistributedExecutor, ring / ulysses attention,
pipelines and MoE are ROADMAP A7.
"""

from . import collective
from .mesh import default_mesh, make_mesh, mesh_axis_sizes
from .partition_rules import (P, PartitionRules, TrainPartitionRules,
                              annotate_spmd, current_spmd,
                              partition_rules_for, register_partition_rules,
                              registered_families, spmd_lowering,
                              train_partition_rules_for)

__all__ = [
    "P", "PartitionRules", "TrainPartitionRules", "annotate_spmd",
    "collective", "current_spmd", "default_mesh", "make_mesh",
    "mesh_axis_sizes", "partition_rules_for", "register_partition_rules",
    "registered_families", "spmd_lowering", "train_partition_rules_for",
]
