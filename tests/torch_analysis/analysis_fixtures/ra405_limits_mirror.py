# repro-torch-lint: fixture-as=src/repro_torch/kernels/limits.py
"""RA405 fixture: limits retuned without the kernel's source."""
WARP = 32
WAVE_KB = 16
WAVE_WARPS = 8  # expect: RA405
MXU_ROWS = 32
MXU_SLAB = 32
MXU_HALF_ROWS = 64
MXU_HALF_CHUNK = 64
MXU_HALF_CLUSTER = 2
MXU_HALF_STAGES = 4
MXU_HALF_VEC = 8
BATCHED_M_BLK = 2 * WARP
BATCHED_KB = 2 * 8
