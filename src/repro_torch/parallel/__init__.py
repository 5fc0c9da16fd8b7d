"""Gradient compression of the port: mirror of the compression half of
:mod:`repro.parallel` (the logical-axis sharding rules wait for training
under a mesh, ROADMAP Queue 1)."""
from .compression import (compress_lowrank, compressed_psum,
                          decompress_lowrank, dequantize_after_allreduce,
                          error_feedback_update, lowrank_error_feedback,
                          lowrank_wire_bytes, quantize_for_allreduce,
                          svd_lowrank, wire_bytes)

__all__ = ["quantize_for_allreduce", "dequantize_after_allreduce",
           "compressed_psum", "error_feedback_update", "wire_bytes",
           "svd_lowrank", "compress_lowrank", "decompress_lowrank",
           "lowrank_error_feedback", "lowrank_wire_bytes"]
