"""Per-device cost of one eager step: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference parses the compiled HLO of a jitted step and multiplies
each ``while`` body by its trip count.  The port has no HLO: eager
PyTorch dispatches every op of every loop iteration, so a
``TorchDispatchMode`` that sees each aten op once counts a loop of ``L``
``L`` times with no trip-count parsing.  :func:`analyze_step` runs a
function once under such a mode (on ``meta`` tensors it computes only
shapes) and returns a :class:`StepCost` with the fields of the
reference's ``HloCost``, counted by its rules:

* ``dot_flops``: each matmul, ``bmm``, ``addmm``, einsum product and
  convolution, priced by ``torch.utils.flop_counter``'s registry;
* ``flops``: ``dot_flops`` plus one flop an output element of every
  elementwise op (aten's ``pointwise`` tag, and dtype casts: the
  reference's ``convert``) and every reduction (aten's ``reduction``
  tag, softmax);
* ``transcendentals``: one an output element of ``exp``, ``log``,
  ``tanh``, ``rsqrt``, ``sqrt``, ``pow``, ``sin``, ``cos``, ``sigmoid``,
  ``expm1``, ``log1p``, ``atan2`` and ``erf`` (each also a flop);
* ``bytes``: operands plus result of every op that touches memory (not a
  view, not an allocation alone), ``bytes_lo`` the result only;
* ``collective_bytes``/``collective_counts`` by the reference's names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``):
  the result's bytes on this device.

**Per device.**  Under a mesh the figures are one device's (rank 0's):
an op with a ``DTensor`` argument is not counted but handed back to
``DTensor``'s dispatch (the mode returns ``NotImplemented``), which runs
the rank's local op and the collectives of its redistributions back
through the mode on plain tensors, and those are counted.  The fake
tensors of ``DTensor``'s sharding propagation are not counted.  Uneven
shards are counted as rank 0 holds them: ``Shard`` gives rank 0
``ceil(n / D)`` rows, the largest shard.

**Opaque kernels.**  A kernel launched through raw pointers (the RoPE
kernel) is invisible to a dispatch mode; its wrapper calls
:func:`opaque` with its plain version, which runs that on ``meta``
copies of the operands under the mode, so the card's count equals the
``meta`` run's (where the wrapper runs the plain version itself).

:func:`trace_step` also tracks memory: every storage an op of the step
creates (an op whose result aliases none of its inputs) is live from its
op until it is freed, and ``peak_bytes`` is the largest sum of live
storages during the step (the step's arguments, and views of them,
excluded); ``peak_blocks`` the same with each storage rounded up to the
CUDA caching allocator's 512-byte blocks, the granularity of
``torch.cuda.max_memory_allocated``.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.obs import timing

__all__ = ["StepCost", "StepTrace", "analyze_step", "trace_step", "opaque",
           "COLLECTIVES"]

aten = torch.ops.aten

_BLOCK = 512   # bytes: the CUDA caching allocator rounds every block up

# the reference's names of the functional collectives DTensor dispatches
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_TRANSCENDENTAL = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sin",
                   "cos", "sigmoid", "expm1", "log1p", "atan2", "erf"}

# reductions aten does not tag as one
_REDUCTIONS = {"_softmax", "_log_softmax", "logsumexp", "amax", "amin"}

# allocation alone: no memory traffic
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}

# metadata queries a tensor subclass answers itself (as FlopCounterMode
# hands them back)
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format,
             aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default,
             aten.sym_stride.default, aten.storage_offset.default,
             aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}


@dataclass
class StepCost:
    """Per-device totals of one step (the fields of the reference's
    ``HloCost``)."""
    flops: float = 0.0
    dot_flops: float = 0.0      # matmul / convolution work
    bytes: float = 0.0          # memory upper bound: operands + results
    bytes_lo: float = 0.0       # memory lower bound: results only
    transcendentals: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    def add(self, other: "StepCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.dot_flops += other.dot_flops * mult
        self.bytes += other.bytes * mult
        self.bytes_lo += other.bytes_lo * mult
        self.transcendentals += other.transcendentals * mult
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] += v * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] += v * mult


@dataclass
class StepTrace:
    """:func:`trace_step`'s result: the cost, the step's output, the
    peak of the storages it created (exact and in allocator blocks), and
    the host seconds it took."""
    cost: StepCost
    out: Any
    peak_bytes: int
    peak_blocks: int
    seconds: float


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _is_view(func) -> bool:
    """Every return aliases an input and none is written: a view."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self.live = self.live_blocks = 0
        self.peak = self.peak_blocks = 0
        self._seen = set()
        self._replaying = False

    def _track(self, out):
        if self._replaying:
            return
        for t in _tensors(out):
            if type(t) not in (torch.Tensor, torch.nn.Parameter):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.live_blocks += -(-n // _BLOCK) * _BLOCK
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)
        self.peak_blocks = max(self.peak_blocks, self.live_blocks)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n
        self.live_blocks -= -(-n // _BLOCK) * _BLOCK

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               for t in types):
            from torch.distributed.tensor import DTensor
            if DTensor in types:
                # DTensor's dispatch runs the local op back through here
                return NotImplemented
            return func(*args, **kwargs)   # sharding propagation
        if func._can_decompose():
            # a composite op (matmul, einsum) reaches the mode whole under
            # inference_mode: count the ops it is made of, as autograd
            # would have dispatched them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        if not any(r.alias_info is not None for r in func._schema.returns):
            self._track(out)   # a view or an in-place op allocates nothing
        return out

    def _count(self, func, args, kwargs, out):
        c = self.cost
        packet = func._overloadpacket
        name = packet.__name__
        outs = _tensors(out)
        elems = sum(t.numel() for t in outs)
        kind = COLLECTIVES.get(name)
        if kind is not None:
            c.collective_bytes[kind] += sum(_nbytes(t) for t in outs)
            c.collective_counts[kind] += 1
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            c.dot_flops += f
        else:
            base = name.rstrip("_")
            if base in _TRANSCENDENTAL:
                c.transcendentals += elems
            if (torch.Tag.pointwise in func.tags
                    or torch.Tag.reduction in func.tags
                    or base in _REDUCTIONS or name == "_to_copy"):
                c.flops += elems
        if (_is_view(func) or name in _ALLOCATIONS
                or name in ("wait_tensor", "_wrap_tensor_autograd")):
            return
        lo = sum(_nbytes(t) for t in outs)
        c.bytes_lo += lo
        c.bytes += lo + sum(_nbytes(t) for t in _tensors((args, kwargs)))


_ACTIVE = []


def opaque(plain, *args):
    """Count ``plain(*args)`` in the analysis in progress, if any: the
    plain version of a kernel whose launch the mode cannot see, run on
    ``meta`` copies of the tensor arguments (its storages are not
    tracked).  Called by the kernel's wrapper where it launches."""
    if not _ACTIVE:
        return
    counter = _ACTIVE[-1]
    counter._replaying = True
    try:
        with torch.no_grad():
            plain(*[torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                        device="meta")
                    if isinstance(a, torch.Tensor) else a for a in args])
    finally:
        counter._replaying = False


def trace_step(fn, *args, **kwargs) -> StepTrace:
    """Run ``fn(*args, **kwargs)`` once under the counting mode."""
    counter = _Counter()
    _ACTIVE.append(counter)
    t0 = timing.now()
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    seconds = timing.now() - t0
    cost = counter.cost
    cost.collective_bytes = dict(cost.collective_bytes)
    cost.collective_counts = dict(cost.collective_counts)
    return StepTrace(cost=cost, out=out, peak_bytes=counter.peak,
                     peak_blocks=counter.peak_blocks, seconds=seconds)


def analyze_step(fn, *args, **kwargs) -> StepCost:
    """The per-device :class:`StepCost` of one run of ``fn``."""
    return trace_step(fn, *args, **kwargs).cost
