"""Sharded execution as a first-class plan: :class:`ShardedSequencePlan`.

Mirror of :mod:`repro.dist.plan` over ``torch.distributed``.  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named dimensions;
``row_axes`` names the dimensions the target's rows shard over (their
extents' product is the shard count ``D``).  :func:`plan_sharded`
resolves mesh, placements and backend once into a frozen
:class:`ShardedSequencePlan`, whose ``apply``/``apply_batched`` run each
rank's row shard of a ``(m, n)`` or ``(b, m, n)`` target through one
planned call of the resolved backend (one ``cuda_batched`` launch a
shard on the card) and wrap the shards as a
:class:`~torch.distributed.tensor.DTensor`.

Row shards are independent (rotations act on column pairs), so the result
equals the replicated application bit for bit on the rotation family.
The only wire traffic is the waves: on every application the source rank
of each row group (row coordinates all 0) broadcasts ``C``/``S`` (and
``G``, or the per-request stacks) to the others, ``D - 1`` copies, which
the communication term of :mod:`repro_torch.core.registry` prices.
``method="auto"`` plans the sharded problem (its own plan-cache class)
and the replicated one and keeps whichever that comm-extended model
prices cheaper; at ``D = 1`` the two tie and the plan stays replicated.

A target is either a ``DTensor`` already placed as the plan places it
(``Shard`` on the row dimensions, ``Replicate`` on the others) or a
plain tensor every rank holds whole, which is distributed without
traffic (each rank keeps its own rows: ``distribute_tensor`` with
``src_data_rank=None``, as a replicated ``jax.Array`` is resharded).
Gradients flow through ``to_local``/``from_local`` into the shard-local
planned call, whose backward is one application of ``seq.T`` a shard
with no collective; differentiate with respect to a ``DTensor`` target
(``distribute_tensor`` makes a new leaf, so a plain tensor's own graph
ends there).  Tensors must live on the mesh's device type (a gloo mesh
on the CPU, an NCCL mesh on the card), and a kernel's failure on a shard
propagates: nothing falls back to the replicated plan or to the CPU.

This package executes only through the planned hooks of
:mod:`repro_torch.core.sequence` and imports no kernel module.  With
:mod:`repro_torch.obs` on, a plan opens ``dist.plan`` and every sharded
application ``dist.apply``/``dist.apply_batched``, counts
``dist.applies`` and ``dist.comm_bytes`` (the bytes its broadcasts
moved), sets the ``dist.devices`` and ``dist.launches_per_shard`` gauges,
observes ``dist.apply_seconds`` and appends a roofline record.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import obs
from repro_torch.core import registry
from repro_torch.core.sequence import (RotationSequence, SequencePlan,
                                       _dtype_name, _problem_of,
                                       _record_roofline, _request_waves,
                                       _timed, planned_apply,
                                       planned_apply_batched, planned_run)

__all__ = ["ShardedSequencePlan", "plan_sharded", "modeled_crossover",
           "SHARDED_PLAN_DICT_FORMAT"]

# sentinel method of degenerate (zero-rotation) plans, as SequencePlan's
_IDENTITY = "identity"

# JSON format version of ShardedSequencePlan.to_dict
SHARDED_PLAN_DICT_FORMAT = 1

# the reference's backend names for the port's, for dicts it wrote
_REFERENCE_METHODS = {"pallas_wave": "cuda_wave", "pallas_mxu": "cuda_mxu",
                      "rotseq_batched": "cuda_batched"}


def _as_tuple(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _mesh_devices(mesh, axes) -> int:
    """Product of the mesh's extents over ``axes`` (the shard count).

    Raises ``TypeError`` for a mesh that is not a ``DeviceMesh`` and
    ``ValueError`` for a dimension the mesh does not name."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh, got "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    d = 1
    for a in _as_tuple(axes):
        if a not in names:
            raise ValueError(f"mesh has no dimension {a!r}; its dimensions "
                             f"are {names}")
        d *= mesh.size(names.index(a))
    return int(d)


def _placements(mesh: DeviceMesh, dims: Dict[str, int]) -> tuple:
    """One placement a mesh dimension: ``Shard(dims[name])`` for the
    named ones, ``Replicate()`` for the rest.  Several dimensions that
    shard one tensor dimension split it in the mesh's order, as the
    reference's ``PartitionSpec`` of those axes does when they are named
    in that order; another order is refused."""
    names = tuple(mesh.mesh_dim_names)
    order = [names.index(a) for a in dims]
    if order != sorted(order):
        raise ValueError(f"axes {tuple(dims)} must follow the mesh's "
                         f"dimension order {names}")
    return tuple(Shard(dims[name]) if name in dims else Replicate()
                 for name in names)


def _check_device(mesh: DeviceMesh, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device.type != mesh.device_type:
            raise ValueError(
                f"tensor on {t.device.type}, mesh on {mesh.device_type}: "
                f"a gloo mesh takes CPU tensors, an NCCL mesh CUDA ones")


def _distribute(A, mesh: DeviceMesh, placements: tuple) -> DTensor:
    """``A`` as a ``DTensor`` placed by ``placements``: a ``DTensor``
    must already be; a plain tensor, whole on every rank, keeps its own
    rows on each (no traffic)."""
    if isinstance(A, DTensor):
        if A.device_mesh != mesh or tuple(A.placements) != placements:
            raise ValueError(
                f"target placed {tuple(A.placements)} on "
                f"{A.device_mesh}; the plan places {placements} on {mesh}: "
                f"redistribute it first")
        return A
    _check_device(mesh, A)
    return distribute_tensor(A, mesh, placements, src_data_rank=None)


def _broadcast_waves(mesh: DeviceMesh, row_axes: Tuple[str, ...],
                     waves: Sequence[Optional[torch.Tensor]]):
    """Replicate ``waves`` over each row group from its source rank (row
    coordinates all 0): along each row axis in turn, among the ranks
    whose later row coordinates are 0, so ``D - 1`` copies move.
    Returns ``(waves, bytes moved)``: the source's own tensors there,
    received copies elsewhere; nothing moves at ``D = 1``."""
    D = _mesh_devices(mesh, row_axes)
    if D == 1:
        return list(waves), 0
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = [None if w is None else w.contiguous() for w in waves]
    for i, axis in enumerate(row_axes):
        if any(coord[names.index(a)] != 0 for a in row_axes[i + 1:]):
            continue
        if coord[names.index(axis)] != 0:
            out = [None if w is None else torch.empty_like(w) for w in out]
        group = mesh.get_group(axis)
        for w in out:
            if w is not None:
                tdist.broadcast(w, group=group, group_src=0)
    nbytes = sum(w.numel() * w.element_size() for w in out if w is not None)
    return out, (D - 1) * nbytes


def plan_sharded(seq: RotationSequence, like=None, *, mesh,
                 row_axes=("data",), m: Optional[int] = None,
                 batch: Optional[int] = None, method: str = "auto",
                 autotune: bool = False, platform: Optional[str] = None,
                 shared_sequence: bool = True,
                 partition: str = "row", col_axis: str = "model",
                 n_b: Optional[int] = None, k_b: Optional[int] = None,
                 **kw) -> "ShardedSequencePlan":
    """Resolve mesh, placements and backend once into a frozen plan.

    ``like``/``m``/``batch`` describe the *global* target as in
    :meth:`RotationSequence.plan` (a 3D ``like`` supplies the batch).
    ``platform`` defaults to the mesh's device type.

    ``method="auto"`` plans two problems through the registry, the
    sharded one (``devices=D``, a plan-cache class of its own) and the
    replicated one, and keeps whichever the comm-extended cost model
    prices cheaper (:attr:`ShardedSequencePlan.execute_sharded`; a tie
    stays replicated).  A named ``method`` must be shard-capable
    (``Capability.supports_sharding``) and always executes sharded.

    ``partition="column"`` plans the column-panel pipeline instead (plain
    rotation sequences, ``blocked`` or ``accumulated``), ``col_axis``
    naming its mesh dimension and ``n_b``/``k_b`` its tiles.
    """
    if mesh is None:
        raise TypeError("plan_sharded() missing required argument: 'mesh'")
    if partition not in ("row", "column"):
        raise ValueError(f"partition must be 'row' or 'column', got "
                         f"{partition!r}")
    row_axes = _as_tuple(row_axes)
    like_shape = getattr(like, "shape", None)
    if like_shape is not None and len(like_shape) == 3:
        if batch is None:
            batch = like_shape[0]
        if m is None:
            m = like_shape[1]
    if m is None:
        m = like_shape[0] if like_shape is not None else max(seq.n, 1)
    batch = 1 if batch is None else max(1, int(batch))
    dtype = _dtype_name(getattr(like, "dtype", None) or seq.dtype)
    n, k = seq.n, seq.k

    if partition == "column":
        devices = _mesh_devices(mesh, col_axis)
        if seq.sign is not None or seq.reflect:
            raise ValueError("the column-sharded pipeline takes plain "
                             "rotation sequences only")
        col_method = "blocked" if method == "auto" else method
        if col_method not in ("blocked", "accumulated"):
            raise ValueError(f"the column-sharded pipeline sweeps tiles as "
                             f"'blocked' or 'accumulated', not "
                             f"{col_method!r}")
        planned = dict(kw, n_b=64 if n_b is None else n_b,
                       k_b=16 if k_b is None else k_b)
        return ShardedSequencePlan(
            sequence=seq, mesh=mesh, row_axes=row_axes, method=col_method,
            kwargs=tuple(sorted(planned.items())), plan=None,
            devices=devices, execute_sharded=True, partition="column",
            col_axis=col_axis)

    devices = _mesh_devices(mesh, row_axes)
    _placements(mesh, dict.fromkeys(row_axes, 0))   # checks the order
    if n < 2 or k < 1 or m < 1:
        return ShardedSequencePlan(
            sequence=seq, mesh=mesh, row_axes=row_axes, method=_IDENTITY,
            kwargs=(), plan=None, devices=devices, execute_sharded=False)

    signs = seq.sign is not None
    if method != "auto":
        spec = registry.get_backend(method)  # raises on unknown
        if signs and not spec.capability.supports_signs:
            raise ValueError(
                f"method {method!r} does not support per-entry signs")
        if not spec.capability.supports_sharding:
            raise ValueError(f"method {method!r} cannot run on a row shard")
        planned = dict(kw)
        if spec.candidates is not registry.no_tiles:
            planned["n_b"] = 64 if n_b is None else n_b
            planned["k_b"] = 16 if k_b is None else k_b
        return ShardedSequencePlan(
            sequence=seq, mesh=mesh, row_axes=row_axes, method=method,
            kwargs=tuple(sorted(planned.items())), plan=None,
            devices=devices, execute_sharded=True)

    platform = platform or mesh.device_type
    common = dict(dtype=dtype, platform=platform, signs=signs, batch=batch,
                  shared_sequence=shared_sequence, live_planes=seq.k_live)
    with obs.span("dist.plan", m=m, n=n, k=k, batch=batch,
                  devices=devices) if obs.enabled() else obs.NULL_SPAN as sp:
        sh_plan = registry.select_plan(m, n, k, sharded=True,
                                       devices=devices, autotune=autotune,
                                       **common)
        rep_plan = registry.select_plan(m, n, k, autotune=autotune,
                                        **common)
        sh_s, rep_s = modeled_crossover(
            m, n, k, devices=devices, sharded_plan=sh_plan,
            replicated_plan=rep_plan, **common)
        execute_sharded = sh_s < rep_s
        chosen = sh_plan if execute_sharded else rep_plan
        sp.set(method=chosen.method, sharded=execute_sharded)
    planned = chosen.kwargs()
    if n_b is not None:
        planned["n_b"] = n_b
    if k_b is not None:
        planned["k_b"] = k_b
    planned.update(kw)
    return ShardedSequencePlan(
        sequence=seq, mesh=mesh, row_axes=row_axes, method=chosen.method,
        kwargs=tuple(sorted(planned.items())), plan=chosen, devices=devices,
        execute_sharded=execute_sharded)


def modeled_crossover(m: int, n: int, k: int, *, devices: int,
                      dtype="float32", platform: str = "cuda",
                      signs: bool = False, batch: int = 1,
                      shared_sequence: bool = True,
                      live_planes: Optional[int] = None,
                      sharded_plan: Optional[registry.Plan] = None,
                      replicated_plan: Optional[registry.Plan] = None
                      ) -> Tuple[float, float]:
    """``(sharded_seconds, replicated_seconds)`` that ``method="auto"``
    compares: each side's ``cost_components`` seconds at its own plan
    (the sharded side with the communication term and a shard's rows),
    so the decision can be reproduced to the digit."""
    common = dict(dtype=dtype, platform=platform, signs=signs, batch=batch,
                  shared_sequence=shared_sequence, live_planes=live_planes)
    if sharded_plan is None:
        sharded_plan = registry.select_plan(m, n, k, sharded=True,
                                            devices=devices, **common)
    if replicated_plan is None:
        replicated_plan = registry.select_plan(m, n, k, **common)
    p_sh = registry.Problem(
        m=m, n=n, k=k, dtype=_dtype_name(dtype), platform=platform,
        signs=signs, batch=batch, shared_sequence=shared_sequence,
        live_planes=live_planes, sharded=True, devices=devices)
    p_rep = dataclasses.replace(p_sh, sharded=False, devices=1)
    sh_s = registry.cost_components(
        sharded_plan.method, p_sh, sharded_plan)["seconds"]
    rep_s = registry.cost_components(
        replicated_plan.method, p_rep, replicated_plan)["seconds"]
    return float(sh_s), float(rep_s)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSequencePlan:
    """A frozen sharded dispatch decision bound to one sequence and mesh.

    Mirrors :class:`~repro_torch.core.sequence.SequencePlan`: frozen,
    rebindable (:meth:`rebind`), serialisable (:meth:`to_dict` /
    :meth:`from_dict`), instrumented, differentiable w.r.t. the target.
    ``execute_sharded=False`` (an ``auto`` outcome) runs the inner
    one-device :class:`SequencePlan` on the whole target instead.
    """

    sequence: RotationSequence
    mesh: Any
    row_axes: Tuple[str, ...]
    method: str
    kwargs: Tuple[Tuple[str, Any], ...]
    plan: Optional[registry.Plan] = None
    devices: int = 1
    execute_sharded: bool = True
    partition: str = "row"
    col_axis: str = "model"

    def __repr__(self) -> str:
        return (f"ShardedSequencePlan(method={self.method!r}, "
                f"devices={self.devices}, "
                f"sharded={self.execute_sharded}, "
                f"partition={self.partition!r}, "
                f"kwargs={dict(self.kwargs)}, seq={self.sequence!r})")

    def _inner(self) -> SequencePlan:
        return SequencePlan(self.sequence, self.method, self.kwargs,
                            self.plan)

    # -- execution ---------------------------------------------------------
    def apply(self, A, *, direct: bool = False):
        """Apply the planned sequence to a ``(m, n)`` target.

        Sharded, ``m`` must divide by ``devices``; each rank runs one
        planned call on its rows and the result is a ``DTensor`` placed
        as the plan places it.  Replicated, the inner plan runs on the
        whole target (a ``DTensor`` is gathered first) and returns a
        plain tensor.  ``direct=True`` keeps PyTorch's own autograd
        through the backend (``apply_direct``'s analogue).
        """
        if self.method == _IDENTITY:
            return A
        if self.partition == "column":
            return self._column_sharded(A)
        if not self.execute_sharded:
            A = A.full_tensor() if isinstance(A, DTensor) else A
            inner = self._inner()
            return inner.apply_direct(A) if direct else inner.apply(A)
        if A.ndim != 2 or A.shape[1] != self.sequence.n:
            raise ValueError(f"plan built for n={self.sequence.n} targets; "
                             f"got A.shape={tuple(A.shape)}")
        self._check_rows(A.shape[0])
        X = _distribute(A, self.mesh,
                        _placements(self.mesh, dict.fromkeys(self.row_axes,
                                                             0)))
        if not obs.enabled():
            return self._row_sharded(X, None, direct)[0]
        with obs.span("dist.apply", method=self.method,
                      devices=self.devices, m=int(A.shape[0]),
                      n=int(A.shape[1])):
            (out, nbytes), dt = _timed(X.to_local().device,
                                       self._row_sharded, X, None, direct)
        self._record_dispatch(A, dt, launches=1, comm_bytes=nbytes)
        return out

    __call__ = apply

    def apply_batched(self, A, sequences=None, *, direct: bool = False):
        """Apply to a batched ``(b, m, n)`` target, sharding its rows.

        The batch dimension is replicated and dimension 1 shards over
        ``row_axes``: every shard holds all ``b`` targets' rows, so a
        fused plan (``cuda_batched``) runs the bucket in one launch a
        shard.  ``sequences`` carries per-request waves as in
        :meth:`SequencePlan.apply_batched`; they are stacked on every
        rank and broadcast from the row group's source.
        """
        if A.ndim != 3:
            raise ValueError(
                f"apply_batched expects A of shape (b, m, n); got "
                f"{tuple(A.shape)}; use apply() for a single target")
        if self.method == _IDENTITY:
            return A
        if self.partition == "column":
            raise ValueError("column-sharded plans take 2D targets; batch "
                             "rows instead (partition='row')")
        if not self.execute_sharded:
            A = A.full_tensor() if isinstance(A, DTensor) else A
            return self._inner().apply_batched(A, sequences=sequences,
                                               direct=direct)
        if A.shape[2] != self.sequence.n:
            raise ValueError(f"plan built for n={self.sequence.n} targets; "
                             f"got A.shape={tuple(A.shape)}")
        self._check_rows(A.shape[1])
        X = _distribute(A, self.mesh,
                        _placements(self.mesh, dict.fromkeys(self.row_axes,
                                                             1)))
        if not obs.enabled():
            return self._row_sharded(X, sequences, direct)[0]
        launches = self._launches_per_shard(int(A.shape[0]),
                                            sequences is None)
        with obs.span("dist.apply_batched", method=self.method,
                      devices=self.devices, batch=int(A.shape[0]),
                      m=int(A.shape[1]), n=int(A.shape[2])):
            (out, nbytes), dt = _timed(X.to_local().device,
                                       self._row_sharded, X, sequences,
                                       direct)
        self._record_dispatch(A, dt, launches=launches, comm_bytes=nbytes,
                              shared=sequences is None)
        return out

    def _row_sharded(self, X: DTensor, sequences, direct: bool):
        """One planned call on this rank's rows of ``X``; returns the
        ``DTensor`` result and the bytes the wave broadcast moved."""
        seq = self.sequence
        local = X.to_local()
        if X.ndim == 2:
            C, S, G = seq.cos, seq.sin, seq.sign
            run = planned_run if direct else planned_apply
        else:
            C, S, G = _request_waves(seq, sequences, X.shape[0])
            run = planned_run if direct else planned_apply_batched
        _check_device(self.mesh, C, S, G)
        (C, S, G), nbytes = _broadcast_waves(self.mesh, self.row_axes,
                                             (C, S, G))
        out = run(self.method, self.kwargs, seq.reflect, local, C, S, G)
        return DTensor.from_local(out, self.mesh, X.placements,
                                  run_check=False, shape=X.shape,
                                  stride=X.stride()), nbytes

    def _column_sharded(self, A):
        from repro_torch.dist.colsharded import \
            rot_sequence_column_sharded_padded
        kw = dict(self.kwargs)
        return rot_sequence_column_sharded_padded(
            A, self.sequence, self.mesh, col_axis=self.col_axis,
            n_b=kw.get("n_b", 64), k_b=kw.get("k_b", 16),
            method=self.method)

    # -- bookkeeping -------------------------------------------------------
    def _check_rows(self, m: int) -> None:
        if int(m) % max(1, self.devices) != 0:
            raise ValueError(
                f"row count {m} does not divide over {self.devices} "
                f"shards ({self.row_axes}); pad the target rows")

    def _launches_per_shard(self, b: int, shared: bool = True) -> int:
        """Backend calls a shard makes for a batch of ``b`` targets: one
        for a fused backend, a flattened shared batch or a mapped one,
        else one a target (the per-request loop)."""
        cap = registry.get_backend(self.method).capability
        if cap.batch_via == "fused" or cap.supports_vmap \
                or (shared and cap.batch_via == "flatten"):
            return 1
        return b

    def comm_components(self, *, batch: int = 1,
                        shared_sequence: bool = True, m: int = 0) -> dict:
        """The plan's modeled communication term (as ``cost_components``
        prices it)."""
        seq = self.sequence
        problem = registry.Problem(
            m=max(1, int(m) or seq.n), n=seq.n, k=seq.k,
            dtype=_dtype_name(seq.dtype), platform=self.mesh.device_type,
            signs=seq.sign is not None, batch=batch,
            shared_sequence=shared_sequence, live_planes=seq.k_live,
            sharded=True, devices=self.devices)
        return registry._comm_components(problem)

    def _record_dispatch(self, A, measured_s: float, *, launches: int,
                         comm_bytes: int, shared: bool = True) -> None:
        """Obs record of one sharded dispatch: the roofline row priced as
        the planner priced the sharded problem, with the bytes the
        broadcast moved and the shard's launches."""
        problem = _problem_of(self.sequence, A, shared,
                              self.mesh.device_type, sharded=True,
                              devices=self.devices)
        _record_roofline(self, problem, measured_s, comm_bytes=comm_bytes,
                         launches_per_shard=launches)
        obs.inc("dist.applies")
        obs.inc("dist.comm_bytes", comm_bytes)
        obs.gauge("dist.devices", self.devices)
        obs.gauge("dist.launches_per_shard", launches)
        obs.observe("dist.apply_seconds", measured_s)

    # -- rebinding / serialisation -----------------------------------------
    def rebind(self, sequence: RotationSequence) -> "ShardedSequencePlan":
        """Bind the frozen decision to a new same-shape sequence."""
        old = self.sequence
        if sequence.shape != old.shape:
            raise ValueError(f"rebind needs matching wave shape "
                             f"{old.shape}; got {sequence.shape}")
        if sequence.sign is not None and old.sign is None \
                and self.method != _IDENTITY \
                and not registry.get_backend(
                    self.method).capability.supports_signs:
            raise ValueError(
                f"plan method {self.method!r} cannot carry per-entry "
                f"signs; re-plan the sign-carrying sequence")
        return dataclasses.replace(self, sequence=sequence)

    def to_dict(self) -> dict:
        """Serialise the decision (not the waves, not the mesh): the
        reference's layout with the torch/CUDA build in place of the JAX
        version, plus the mesh's shape contract (shard count, axes,
        partition).  :meth:`from_dict` binds it to a live mesh."""
        seq = self.sequence
        d = {
            "format": SHARDED_PLAN_DICT_FORMAT,
            "torch": registry._version_str(),
            "method": self.method,
            "kwargs": dict(self.kwargs),
            "devices": self.devices,
            "row_axes": list(self.row_axes),
            "partition": self.partition,
            "col_axis": self.col_axis,
            "execute_sharded": bool(self.execute_sharded),
            "shape": list(seq.shape),
            "dtype": _dtype_name(seq.dtype),
            "signed": seq.sign is not None,
            "reflect": bool(seq.reflect),
        }
        if self.plan is not None:
            d["plan"] = {"method": self.plan.method, "n_b": self.plan.n_b,
                         "k_b": self.plan.k_b,
                         "est_seconds": self.plan.est_seconds,
                         "source": self.plan.source}
        return d

    @classmethod
    def from_dict(cls, d: dict, sequence: RotationSequence,
                  mesh) -> "ShardedSequencePlan":
        """Rebuild a frozen sharded plan bound to ``sequence`` and ``mesh``.

        Takes this class's dicts and the reference's (keyed by a JAX
        version, which says nothing of this build: its backend names map
        to their counterparts and its ``m_blk`` tile is dropped).
        Raises ``ValueError`` on any mismatch (treat it as a miss): the
        format, another torch/CUDA build, the wave signature, a backend
        not registered, or a mesh whose extent over the stored axes is
        not the stored shard count.
        """
        if d.get("format") != SHARDED_PLAN_DICT_FORMAT:
            raise ValueError(f"unsupported ShardedSequencePlan dict format "
                             f"{d.get('format')!r}")
        reference = "torch" not in d and "jax" in d
        if not reference and d.get("torch") != registry._version_str():
            raise ValueError(f"plan serialised under {d.get('torch')!r}; "
                             f"running {registry._version_str()!r}")
        if tuple(d.get("shape", ())) != tuple(sequence.shape):
            raise ValueError(f"plan serialised for wave shape "
                             f"{d.get('shape')}; sequence has "
                             f"{sequence.shape}")
        if d.get("signed", False) != (sequence.sign is not None) \
                or d.get("reflect", False) != bool(sequence.reflect):
            raise ValueError(
                "plan serialised for a different sign/reflect structure")
        if d.get("dtype") != _dtype_name(sequence.dtype):
            raise ValueError(f"plan serialised for dtype "
                             f"{d.get('dtype')!r}; sequence is "
                             f"{sequence.dtype}")
        partition = d.get("partition", "row")
        row_axes = tuple(d.get("row_axes", ("data",)))
        col_axis = d.get("col_axis", "model")
        axes = col_axis if partition == "column" else row_axes
        devices = int(d.get("devices", 1))
        if _mesh_devices(mesh, axes) != devices:
            raise ValueError(
                f"plan serialised for {devices} devices over {axes!r}; "
                f"the mesh has {_mesh_devices(mesh, axes)}: sharded "
                f"decisions never transfer across mesh sizes")
        method = d["method"]
        kwargs = dict(d.get("kwargs", {}))
        pd = d.get("plan")
        if reference:
            method = _REFERENCE_METHODS.get(method, method)
            kwargs.pop("m_blk", None)
        if method != _IDENTITY:
            spec = registry.get_backend(method)  # raises on unknown
            if sequence.sign is not None \
                    and not spec.capability.supports_signs:
                raise ValueError(
                    f"serialised method {method!r} cannot carry signs")
        plan = None
        if pd is not None:
            pmethod = str(pd.get("method", method))
            plan = registry.Plan(
                method=_REFERENCE_METHODS.get(pmethod, pmethod)
                if reference else pmethod,
                n_b=pd.get("n_b"), k_b=pd.get("k_b"),
                est_seconds=float(pd.get("est_seconds", 0.0)),
                source="persisted")
        return cls(sequence=sequence, mesh=mesh, row_axes=row_axes,
                   method=method, kwargs=tuple(sorted(kwargs.items())),
                   plan=plan, devices=devices,
                   execute_sharded=bool(d.get("execute_sharded", True)),
                   partition=partition, col_axis=col_axis)
