"""Fused RoPE on q and k: mirror of :mod:`repro.kernels.rope.ops`.

:func:`apply_rope` is the counterpart of the reference's ``apply_rope``
with ``use_kernel=True``: one launch of the fused kernel for the whole
batch on the card, the plain version (exactly ``apply_rope_ref`` on q
and on k) for CPU tensors.  It has no ``use_kernel`` switch: the
tensor's device decides.
"""
from __future__ import annotations

from .kernel import rope as apply_rope
from .ref import apply_rope_ref, rope_tables

__all__ = ["apply_rope", "rope_tables", "apply_rope_ref"]
