"""Gradient compression and the logical-axis sharding rules of the port:
mirror of :mod:`repro.parallel` (``DTensor`` placements on a
``DeviceMesh`` for the reference's ``PartitionSpec``)."""
from .compression import (compress_lowrank, compressed_psum,
                          decompress_lowrank, dequantize_after_allreduce,
                          error_feedback_update, lowrank_error_feedback,
                          lowrank_wire_bytes, quantize_for_allreduce,
                          svd_lowrank, wire_bytes)
from .sharding import (DEFAULT_RULES, AxisRules, PartitionSpec, axis_rules,
                       current_mesh, current_rules, logical_to_spec,
                       param_spec, shard, to_placements)

__all__ = ["AxisRules", "DEFAULT_RULES", "axis_rules", "current_rules",
           "current_mesh", "logical_to_spec", "param_spec", "shard",
           "PartitionSpec", "to_placements",
           "quantize_for_allreduce", "dequantize_after_allreduce",
           "compressed_psum", "error_feedback_update", "wire_bytes",
           "svd_lowrank", "compress_lowrank", "decompress_lowrank",
           "lowrank_error_feedback", "lowrank_wire_bytes"]
