# repro-torch-lint: fixture-as=src/repro_torch/core/bad_stencil.py
"""RA301 fixture: hand-inlined 2x2 plane stencils.

Both spellings of the second row (``s*x - c*y`` and ``-s*x + c*y``) are
caught.
"""
import torch


def bad_plain(x, y, c, s):
    xn = c * x + s * y
    yn = s * x - c * y  # expect: RA301
    return xn, yn


def bad_negated(x, y, c, s):
    xn = c * x + s * y
    yn = -s * x + c * y  # expect: RA301
    return torch.stack([xn, yn])


def ok_sum_difference(x, y, a, b):
    # same pairing on both lines: a plain sum/difference, not a plane
    u = a * x + b * y
    v = a * x - b * y
    return u, v
