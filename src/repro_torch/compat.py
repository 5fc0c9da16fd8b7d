"""The port's torch version shim: every private torch name it uses.

Counterpart of :mod:`repro.compat`.  The card runs torch 2.11.0+cu128
and the CPU host 2.13.0+cpu, and a private module of torch may move or
change between two releases without notice; every private name the port
takes (``torch._C``, ``torch.utils._*``, ``torch.testing._internal``,
``torch.distributed.tensor._*``) is reached here and nowhere else
(``repro_torch.analysis`` rule RA101), so this file is the list to read
when torch changes.  Modules that are slow to import, or absent from a
build, are imported where their function is called.

:func:`ieee_float32` is the one place the port turns TF32 off for a
stretch of work (rule RA103).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "TorchDispatchMode", "tree_leaves", "is_functorch_wrapped_tensor",
    "cuda_current_device", "cuda_raw_stream", "cuda_sleep",
    "compute_local_shape_and_global_offset", "fake_store", "ieee_float32",
]

# the leaves of a pytree of tensors, in torch's own flattening order
tree_leaves = _pytree.tree_leaves

# whether a tensor is wrapped by a torch.func transform (vmap, grad)
is_functorch_wrapped_tensor = torch._C._functorch.is_functorch_wrapped_tensor


def _no_cuda(*_args):
    raise RuntimeError("this torch is built without CUDA")


# The current CUDA device's index and a device's current raw stream,
# without the Python of torch.cuda.current_device/current_stream: the
# RoPE wrapper reads them on every launch of the decode step.  A build
# without CUDA has neither; the wrappers reach them only for CUDA tensors.
cuda_current_device = getattr(torch._C, "_cuda_getDevice", _no_cuda)
cuda_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _no_cuda)
# A kernel that spins the current stream for some cycles: chip_smoke.py
# holds the card with it while the host enqueues work to be timed back to
# back on the card.
cuda_sleep = getattr(torch.cuda, "_sleep", _no_cuda)


def compute_local_shape_and_global_offset(shape, mesh, placements):
    """``(local_shape, global_offset)`` of this rank's shard of a tensor
    of ``shape`` placed by ``placements`` on ``mesh`` (DTensor's own
    rule, private to ``torch.distributed.tensor``)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_shape
    return local_shape(shape, mesh, placements)


def fake_store():
    """A store for ``init_process_group("fake", ...)``: torch's ``fake``
    backend, whose collectives do nothing, from its testing package."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


@contextlib.contextmanager
def ieee_float32():
    """Float32 products in full float32: TF32 off for the duration.

    Sets ``torch.backends.cuda.matmul.allow_tf32`` to ``False`` and
    restores what it found on the way out, whatever happens inside.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
