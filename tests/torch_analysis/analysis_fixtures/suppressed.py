# repro-torch-lint: fixture-as=src/repro_torch/core/suppressed_stencil.py
"""Suppression fixture: findings silenced on the line and the line above.

Must produce zero violations: ``disable=`` on the line, ``disable-next=``
(of a family) on the preceding line, and two ids at once.
"""
import torch


def quieted_inline(x, y, c, s):
    xn = c * x + s * y
    yn = s * x - c * y  # repro-torch-lint: disable=RA301
    return xn, yn


def quieted_next_line(x, y, c, s):
    xn = c * x + s * y
    # repro-torch-lint: disable-next=RA3
    yn = -s * x + c * y
    return xn, yn


def quieted_two(x):
    return torch._C._get_tracing_state(), x.item()  # repro-torch-lint: disable=RA101,RA401
