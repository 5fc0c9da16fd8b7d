"""Deprecated wrapper over :mod:`repro_torch.dist`.

Mirror of :mod:`repro.core.distributed`: every entry point warns with a
``DeprecationWarning`` and delegates to :mod:`repro_torch.dist`.

  ==========================================  =============================
  call here                                   repro_torch.dist API
  ==========================================  =============================
  ``rot_sequence_row_sharded(A, seq, mesh)``  ``dist.rot_sequence_row_sharded``
  repeated row-sharded applications           ``dist.plan_sharded(...).apply``
  ``rot_sequence_column_sharded(...)``        ``dist.rot_sequence_column_sharded``
  ``rot_sequence_column_sharded_padded(...)`` ``dist.rot_sequence_column_sharded_padded``
  ``column_sharded_comm_bytes(...)``          ``dist.column_sharded_comm_bytes``
  ==========================================  =============================
"""
from __future__ import annotations

import warnings

__all__ = [
    "rot_sequence_row_sharded",
    "rot_sequence_column_sharded",
    "rot_sequence_column_sharded_padded",
    "column_sharded_comm_bytes",
]


def _warn(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.distributed.{name} is deprecated; use "
        f"repro_torch.dist.{name} (or plan_sharded for repeated "
        f"applications)", DeprecationWarning, stacklevel=3)


def rot_sequence_row_sharded(A, seq, mesh=None, **kw):
    """Deprecated: see :func:`repro_torch.dist.rot_sequence_row_sharded`."""
    from repro_torch import dist

    _warn("rot_sequence_row_sharded")
    return dist.rot_sequence_row_sharded(A, seq, mesh, **kw)


def rot_sequence_column_sharded(A, seq, mesh=None, **kw):
    """Deprecated: see :func:`repro_torch.dist.rot_sequence_column_sharded`."""
    from repro_torch import dist

    _warn("rot_sequence_column_sharded")
    return dist.rot_sequence_column_sharded(A, seq, mesh, **kw)


def rot_sequence_column_sharded_padded(A, seq, mesh=None, **kw):
    """Deprecated: see
    :func:`repro_torch.dist.rot_sequence_column_sharded_padded`."""
    from repro_torch import dist

    _warn("rot_sequence_column_sharded_padded")
    return dist.rot_sequence_column_sharded_padded(A, seq, mesh, **kw)


def column_sharded_comm_bytes(m_loc, n, k, D, n_b, k_b, itemsize=4, **kw):
    """Deprecated: see :func:`repro_torch.dist.column_sharded_comm_bytes`."""
    from repro_torch import dist

    _warn("column_sharded_comm_bytes")
    return dist.column_sharded_comm_bytes(m_loc, n, k, D, n_b, k_b,
                                          itemsize, **kw)
