# repro-torch-lint: fixture-as=src/repro_torch/dist/bad_kernel_call.py
"""RA206 fixture: the dist layer importing a kernel directly.

(RA202 fires too: kernel imports are confined to core/api.py.)
"""
from repro_torch.kernels.limits import BATCHED_M_BLK
from repro_torch.kernels.rotseq_batched.ops import rot_sequence_batched  # expect: RA206  # expect: RA202


def bad_sharded_apply(A, C, S):
    return rot_sequence_batched(A, C, S), BATCHED_M_BLK  # expect: RA206  # expect: RA202
