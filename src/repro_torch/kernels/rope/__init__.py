"""Fused RoPE kernel of the LM path: CUDA source, wrapper, plain version."""
