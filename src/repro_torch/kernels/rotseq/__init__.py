"""Wavefront kernel (paper SS3): CUDA source, wrapper, plain version."""
