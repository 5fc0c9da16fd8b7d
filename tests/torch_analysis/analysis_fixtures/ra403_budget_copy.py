# repro-torch-lint: fixture-as=src/repro_torch/core/bad_budget.py
"""RA403 fixture: on-chip budgets and Hopper limits redefined outside
kernels/limits.py."""

_SMEM_PANEL_BUDGET = 128 * 2**10  # expect: RA403

SMEM_PER_BLOCK = 232_448  # expect: RA403

REGS_PER_THREAD = 255  # expect: RA403
