# repro-torch-lint: fixture-as=src/repro_torch/launch/bad_private.py
"""RA101 fixture: private torch API outside compat.py.

Each of these moved or may move between the card's torch and the
host's; the aliased forms are the ones a grep for ``torch._`` misses.
Public names with dunders and ATen op names are fine.
"""
import torch
import torch._C as _C  # expect: RA101
from torch.utils._pytree import tree_map  # expect: RA101
from torch.testing._internal.distributed.fake_pg import FakeStore  # expect: RA101


def bad_device():
    return torch._C._cuda_getDevice()  # expect: RA101


def bad_aliased():
    return _C._cuda_getCurrentRawStream(0)  # expect: RA101


def bad_tree(f, t):
    return tree_map(f, t)  # expect: RA101


def bad_store():
    return FakeStore()  # expect: RA101


def bad_dtensor_internals(x):
    return torch.distributed.tensor._utils.compute_local_shape_and_global_offset(x)  # expect: RA101


def fine_public():
    return torch.__version__, torch.ops.aten._softmax.default, torch.cuda.current_stream
