"""Fused multi-request kernel (one launch per serving bucket): CUDA
source, wrapper, plain version."""
