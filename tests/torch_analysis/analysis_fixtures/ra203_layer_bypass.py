# repro-torch-lint: fixture-as=src/repro_torch/eig/bad_backend_pin.py
"""RA203 fixture: the eig layer reaching below the typed sequence API."""
from repro_torch.core.blocked import rot_sequence_blocked  # expect: RA203
from repro_torch.kernels.limits import round_up


def bad_pinned_apply(A, C, S):
    return rot_sequence_blocked(A, C, S, n_b=round_up(100, 8), k_b=64)  # expect: RA203
