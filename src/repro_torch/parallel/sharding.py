"""Logical-axis sharding rules (Megatron TP + ZeRO-3 FSDP + EP): mirror of
the reference's ``parallel/sharding.py`` over ``torch.distributed``.

Model code annotates activations and parameters with *logical* axis names;
this module resolves them to a :class:`PartitionSpec` through the active
:class:`AxisRules`, and a spec to ``DTensor`` placements on a
:class:`~torch.distributed.device_mesh.DeviceMesh` (:func:`to_placements`).
Outside a rules context, or without a mesh, every annotation returns its
input, so the same model code runs single-device and under a mesh.

Default production rules:

  batch   -> ("pod", "data")        activations data-parallel
  heads / kv_heads / ff / vocab / experts -> "model"   tensor/expert parallel
  fsdp    -> parameters additionally shard their largest non-TP axis over
             ("pod", "data")  (ZeRO-3); optimizer state inherits

Sequence parallelism ("seq" -> "model") is an opt-in rule.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["AxisRules", "axis_rules", "current_rules", "current_mesh",
           "shard", "logical_to_spec", "param_spec", "PartitionSpec",
           "to_placements", "NamedSharding", "gather_last_unless",
           "any_dtensor", "DEFAULT_RULES"]

_state = threading.local()


class PartitionSpec:
    """A tensor's sharding over named mesh axes: a tuple of entries, one
    a dimension, each ``None`` (replicated), an axis name or a tuple of
    names (major to minor); printed as the reference's
    ``PartitionSpec``.  Not itself a tuple, so a tree walk
    (:mod:`repro_torch.tree`) stops at it."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a ``DeviceMesh`` (the reference's
    ``NamedSharding``): a leaf of the trees
    :func:`repro_torch.launch.specs.sharding_trees` returns."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


@dataclass(frozen=True)
class AxisRules:
    """logical name -> mesh axis (or tuple of axes, or None)."""
    rules: Dict[str, object] = field(default_factory=dict)
    fsdp_axes: Tuple[str, ...] = ()     # axes used to shard params (ZeRO)
    mesh_shape: Dict[str, int] = field(default_factory=dict)

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.rules.get(logical)


DEFAULT_RULES = AxisRules(
    rules={
        "batch": ("pod", "data"),
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "seq": None,
        "embed": None,
    },
    fsdp_axes=("pod", "data"),
)


def current_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules], mesh=None):
    """Make ``rules`` (and the ``DeviceMesh`` ``mesh``) the active ones on
    this thread for the block."""
    prev = getattr(_state, "rules", None)
    prev_mesh = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = prev
        _state.mesh = prev_mesh


def _dedup(spec_axes, shape=None, rules=None):
    """Drop mesh axes already used earlier in the spec and, when ``shape``
    is known, axes that do not divide the dimension."""
    used = set()
    out = []
    for i, a in enumerate(spec_axes):
        if a is None:
            out.append(None)
            continue
        axes = a if isinstance(a, tuple) else (a,)
        axes = tuple(x for x in axes if x not in used)
        if shape is not None and rules is not None:
            kept = []
            size = 1
            for x in axes:
                nx = rules.mesh_shape.get(x, 1)
                if shape[i] % (size * nx) == 0:
                    kept.append(x)
                    size *= nx
            axes = tuple(kept)
        used.update(axes)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return out


def logical_to_spec(logical: Tuple[Optional[str], ...],
                    rules: Optional[AxisRules] = None,
                    shape: Optional[Tuple[int, ...]] = None) -> P:
    rules = rules or current_rules()
    if rules is None:
        return P()
    return P(*_dedup([rules.resolve(l) for l in logical], shape, rules))


def param_spec(shape: Tuple[int, ...],
               logical: Tuple[Optional[str], ...],
               rules: Optional[AxisRules] = None) -> P:
    """PartitionSpec for a parameter: TP axes from rules + FSDP on the
    largest remaining dimension (ZeRO-3)."""
    rules = rules or current_rules()
    if rules is None:
        return P()
    resolved = [rules.resolve(l) for l in logical]
    # drop TP axes that do not divide their dimension first
    resolved = _dedup(resolved, shape, rules)
    if rules.fsdp_axes:
        used = set()
        for r in resolved:
            used.update(r if isinstance(r, tuple) else (r,))
        free = [i for i, r in enumerate(resolved) if r is None]
        if free:
            # largest free dim that divides the fsdp axis product
            fsdp_size = math.prod(rules.mesh_shape.get(a, 1)
                                  for a in rules.fsdp_axes) or 1
            for i in sorted(free, key=lambda i: -shape[i]):
                if shape[i] % max(fsdp_size, 1) == 0:
                    resolved[i] = tuple(
                        a for a in rules.fsdp_axes if a not in used)
                    break
    return P(*_dedup(resolved))


def to_placements(spec, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(i)`` for
    each mesh dimension that entry ``i`` names, ``Replicate()`` for the
    rest.  Several axes on one tensor dimension shard it in mesh order
    (the first the major one, as in the spec); a spec that names them in
    another order, or an axis the mesh lacks, raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    dim_of = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec!r} names axis {a!r}; the mesh "
                                 f"has {names}")
            if a in dim_of:
                raise ValueError(f"{spec!r} names axis {a!r} twice")
            dim_of[a] = i
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec!r} names {axes} out of the mesh's "
                             f"order {names}")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


def shard(x, *logical: Optional[str]):
    """Constrain an activation to its logical axes' placements (the
    counterpart of ``with_sharding_constraint``).

    Without rules or without a mesh it returns ``x`` itself.  With both, a
    ``DTensor`` is redistributed to the placements (a differentiable
    collective where they differ); a plain tensor raises ``TypeError``:
    under a mesh every activation is a ``DTensor``.
    """
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"shard{logical}: a plain {type(x).__name__} "
                        f"under a mesh; expected a DTensor")
    spec = logical_to_spec(logical, rules, shape=tuple(x.shape))
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def gather_last_unless(x, n: int):
    """A ``DTensor`` whose last dim is split into a number of shards that
    does not divide ``n``, with that dim gathered (its other placements
    kept); ``x`` itself otherwise, and for a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    last = Shard(x.dim() - 1)
    ways = 1
    for i, pl in enumerate(x.placements):
        if pl == last:
            ways *= x.device_mesh.size(i)
    if n % ways == 0:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if pl == last else pl
                                          for pl in x.placements])


def any_dtensor(tree) -> bool:
    """Whether any leaf of ``tree`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import leaves
    return any(isinstance(x, DTensor) for x in leaves(tree))
