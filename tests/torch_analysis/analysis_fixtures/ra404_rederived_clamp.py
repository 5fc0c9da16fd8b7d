# repro-torch-lint: fixture-as=src/repro_torch/core/bad_clamp.py
"""RA404 fixture: tile round-up re-derived instead of imported."""


def _round_up(x: int, mult: int) -> int:  # expect: RA404
    return ((x + mult - 1) // mult) * mult  # expect: RA404


def bad_inline_clamp(m: int, m_blk: int) -> int:
    return min(m_blk, ((max(1, m) + 7) // 8) * 8)  # expect: RA404
