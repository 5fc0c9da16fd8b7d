"""Accumulated (rs_gemm) kernel: CUDA source, wrapper, plain version."""
