# repro-torch-lint: fixture-as=src/repro_torch/models/bad_kernel_call.py
"""RA202 fixture: a rotseq kernel imported outside the dispatch layer.

A direct kernel call skips the registry's budget guard.
"""
from repro_torch.kernels.rotseq_batched.ops import rot_sequence_batched  # expect: RA202


def bad_direct_launch(A, C, S, G):
    return rot_sequence_batched(A[None], C, S, G=G)  # expect: RA202
