# repro-torch-lint: fixture-as=src/repro_torch/serve/bad_collective.py
"""RA206 fixture: collectives outside the dist layer.

A collective issued from the serve layer is a second distribution path
the comm-extended cost model never sees.  DTensor types and placements
are annotations and stay legal; so is a barrier.
"""
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol  # expect: RA101
from torch.distributed import all_reduce as _ar  # expect: RA206
from torch.distributed.tensor import DTensor, Shard


def bad_allreduce(x):
    dist.all_reduce(x)  # expect: RA206
    return x


def bad_aliased(x):
    _ar(x)  # expect: RA206
    return x


def bad_gather(out, x):
    dist.all_gather_into_tensor(out, x)  # expect: RA206
    return out


def bad_functional(x, group):
    return funcol.all_reduce(x, "sum", group)  # expect: RA206  # expect: RA101


def fine_annotation(x, mesh) -> DTensor:
    return DTensor.from_local(x, mesh, [Shard(0)])


def fine_barrier():
    dist.barrier()
