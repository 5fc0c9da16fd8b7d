"""repro_torch.dist: sharded execution as a first-class plan.

Mirror of :mod:`repro.dist` over ``torch.distributed`` (a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named dimensions
for the reference's mesh, ``DTensor`` placements for its
``PartitionSpec``):

* :func:`plan_sharded` / :class:`ShardedSequencePlan` resolve mesh,
  placements and backend once (``method="auto"`` arbitrates sharded
  against replicated through the comm-extended cost model), then apply
  row-sharded ``(m, n)`` and batched ``(b, m, n)`` targets with one
  planned call a shard (one ``cuda_batched`` launch on the card).
* :func:`rot_sequence_row_sharded`: one-shot convenience over a fresh
  row plan.
* :mod:`repro_torch.dist.colsharded`: the column-panel pipeline and its
  live-window :func:`column_sharded_comm_bytes`.

Every application goes through the planned hooks of
:mod:`repro_torch.core.sequence`; this package imports no kernel module.
"""
from __future__ import annotations

from repro_torch.dist.colsharded import (column_sharded_comm_bytes,
                                         rot_sequence_column_sharded,
                                         rot_sequence_column_sharded_padded)
from repro_torch.dist.plan import (SHARDED_PLAN_DICT_FORMAT,
                                   ShardedSequencePlan, modeled_crossover,
                                   plan_sharded)

__all__ = [
    "ShardedSequencePlan", "plan_sharded", "modeled_crossover",
    "SHARDED_PLAN_DICT_FORMAT",
    "rot_sequence_row_sharded",
    "rot_sequence_column_sharded",
    "rot_sequence_column_sharded_padded",
    "column_sharded_comm_bytes",
]


def rot_sequence_row_sharded(A, seq, mesh=None, *, row_axes=("data",),
                             n_b=None, k_b=None, method: str = "blocked"):
    """Row-sharded application (no stream communication, paper SS7).

    One-shot convenience over :func:`plan_sharded`: rows of ``A`` shard
    over ``row_axes``, the waves are broadcast, and each shard runs one
    planned call with PyTorch's own autograd through the backend.
    ``method`` is a shard-capable backend or ``"auto"``.  Repeated
    applications should hold the :class:`ShardedSequencePlan`.
    """
    from repro_torch.core.sequence import RotationSequence

    if not isinstance(seq, RotationSequence):
        raise TypeError(
            "rot_sequence_row_sharded(A, seq, mesh) requires a "
            "RotationSequence; wrap the waves: RotationSequence(C, S)")
    if mesh is None:
        raise TypeError("rot_sequence_row_sharded() missing required "
                        "argument: 'mesh'")
    plan = plan_sharded(seq, like=A, mesh=mesh, row_axes=row_axes,
                        method=method, n_b=n_b, k_b=k_b)
    return plan.apply(A, direct=True)
