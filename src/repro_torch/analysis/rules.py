"""The port's invariants as named, suppressible analyzer rules.

Counterpart of :mod:`repro.analysis.rules`.  Every rule of the reference
has a row below: the port's counterpart keeps the reference's id, so a
reader can find one from the other, and a rule the port alone has takes
the next free number of its family.

======  ==========================================  ======================================
id      reference rule                              the port's rule
======  ==========================================  ======================================
RA101   version-sensitive JAX API outside compat    private torch API outside ``compat``
RA102   platform probe outside compat               ``torch.cuda`` probe outside
                                                    ``resolve_device``/``_can_measure``/``hw``
RA103   ``jax_enable_x64`` flipped outside compat   global float32 switch outside
                                                    ``compat.ieee_float32()``
RA104   (port only)                                 jax/jaxlib/``repro`` imported by the port
RA105   (port only)                                 plain version reached on the card, or
                                                    from an ``except`` handler
RA201   ``apply_rotation_sequence`` outside api     same (the package ``__init__`` re-export
                                                    allowed)
RA202   ``kernels.rotseq*`` outside ``core.api``    same
RA203   serve/eig below the typed API               same
RA204   concurrency outside the stream engine       same
RA205   ``Problem(batch>1)`` w/o shared_sequence    same
RA206   SPMD primitive outside dist/parallel        ``torch.distributed`` collective outside
                                                    dist/parallel/compat; dist importing
                                                    kernels
RA301   inline 2x2 stencil, not ``plane_update``    same
RA302   foldable literal sign in traced code        no counterpart (below)
RA303   (port only)                                 CUDA plane form and ``--fmad=false``
RA401   host round-trip in a Pallas body            host round-trip in a wrapper's CUDA
                                                    branch
RA402   reduction over a traced grid index          no counterpart (below)
RA403   ``*_BUDGET`` outside ``limits``             same, and ``SMEM_*``/``REGS_*``
RA404   round-up/clamp re-derived                   same
RA405   (port only)                                 ``.cu`` constants mirror ``limits``
RA501   time/RNG in a key or cost path              same (torch's RNG too)
RA502   ad hoc clock outside ``obs``                same, over ``chip_smoke.py`` and
                                                    ``tools/`` too
======  ==========================================  ======================================

RA302 has no counterpart: eager PyTorch folds no Python scalar into a
contraction (nothing is traced and re-associated), and the kernels'
plane form is RA303's.  RA402 has none: a CUDA launch's grid is host
arithmetic in the wrapper, not a traced value a kernel body can reduce.

Scopes: a rule that the reference confines to the library
(``repro.*``) is confined to ``repro_torch.*``; ``chip_smoke.py`` and
``tools/*.py`` are the port's scripts (module names ``chip_smoke`` and
``tools.*``), and ``tests/test_torch_*.py`` its tests.  Each docstring
says which it covers.

Suppress a single line with ``# repro-torch-lint: disable=RA301`` (or
the family, ``disable=RA3``; ``//`` in a ``.cu`` file); grandfather
legacy hits via the baseline file (``python -m repro_torch.analysis
--update-baseline``).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import (CUDA, PYTHON, CudaSource, ModuleInfo, Rule, Violation,
                     repo_root)

__all__ = ["ALL_RULES", "NO_COUNTERPART", "all_rules", "rules_matching"]


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

PORT = "repro_torch"


def _under(module: str, prefixes: Sequence[str]) -> bool:
    return any(module == p or module.startswith(p + ".") for p in prefixes)


def _in_port(mi) -> bool:
    return _under(mi.module, (PORT,))


def _is_script(mi) -> bool:
    return mi.module == "chip_smoke" or mi.module.startswith("tools.")


def _is_simple(node: ast.AST) -> bool:
    """Leaf-ish operand of a product term: name, attr, index, constant."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return _is_simple(node.operand)
    return isinstance(node, (ast.Name, ast.Attribute, ast.Subscript,
                             ast.Constant))


def _leaf(node: ast.AST) -> str:
    return ast.unparse(node)


def _str_consts(node: ast.AST) -> Optional[Set[str]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = set()
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            out.add(e.value)
        return out
    return None


def _type_compare(test: ast.AST) -> Optional[Tuple[bool, Set[str]]]:
    """``(positive, names)`` of ``x.type == "cpu"``-style tests.

    ``x.type == "cpu"`` and ``x.type in ("cpu", "meta")`` are positive,
    ``!=`` and ``not in`` negative; ``x`` is any device expression
    (``dev``, ``A.device``).
    """
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"):
        return None
    names = _str_consts(test.comparators[0])
    if names is None:
        return None
    op = test.ops[0]
    if isinstance(op, (ast.Eq, ast.In)):
        return True, names
    if isinstance(op, (ast.NotEq, ast.NotIn)):
        return False, names
    return None


def _excludes_cuda(test: ast.AST) -> bool:
    """Whether ``test`` holding means the tensor is not on the card."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _includes_cuda(test.operand)
    if isinstance(test, ast.BoolOp):
        parts = [_excludes_cuda(v) for v in test.values]
        return any(parts) if isinstance(test.op, ast.And) else all(parts)
    if isinstance(test, ast.Attribute) and test.attr == "is_cpu":
        return True
    tc = _type_compare(test)
    if tc is None:
        return False
    positive, names = tc
    return ("cuda" not in names) if positive else ("cuda" in names)


def _includes_cuda(test: ast.AST) -> bool:
    """Whether ``test`` failing means the tensor is not on the card."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _excludes_cuda(test.operand)
    if isinstance(test, ast.BoolOp):
        parts = [_includes_cuda(v) for v in test.values]
        return any(parts) if isinstance(test.op, ast.Or) else all(parts)
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        return True
    tc = _type_compare(test)
    if tc is None:
        return False
    positive, names = tc
    return ("cuda" in names) if positive else ("cuda" not in names)


def _always_exits(stmts: Sequence[ast.stmt]) -> bool:
    """Whether a block always ends in ``return`` or ``raise``."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Return, ast.Raise)):
        return True
    if isinstance(last, ast.If):
        return _always_exits(last.body) and _always_exits(last.orelse)
    return False


def _in_branch(mi: ModuleInfo, node: ast.AST, taken, not_taken,
               after) -> bool:
    """Whether ``node`` lies in a branch of its function chosen by a
    device test: the body of an ``if`` whose test satisfies ``taken``,
    the ``else`` of one whose test satisfies ``not_taken``, or a
    statement after an ``if`` whose test satisfies ``after`` and whose
    body always returns or raises."""
    child, parent = node, mi.parents.get(node)
    while parent is not None:
        if isinstance(parent, ast.If):
            if child in parent.body and taken(parent.test):
                return True
            if child in parent.orelse and not_taken(parent.test):
                return True
        elif isinstance(parent, ast.IfExp):
            if child is parent.body and taken(parent.test):
                return True
            if child is parent.orelse and not_taken(parent.test):
                return True
        for field in ("body", "orelse", "finalbody"):
            block = getattr(parent, field, None)
            if isinstance(block, list) and child in block:
                for prev in block[:block.index(child)]:
                    if isinstance(prev, ast.If) and after(prev.test) \
                            and not prev.orelse and _always_exits(prev.body):
                        return True
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda, ast.Module)):
            return False
        child, parent = parent, mi.parents.get(parent)
    return False


def _off_card(mi: ModuleInfo, node: ast.AST) -> bool:
    """``node`` is reached only for a tensor that is not on the card."""
    return _in_branch(mi, node, _excludes_cuda, _includes_cuda,
                      _includes_cuda)


def _cuda_branch(mi: ModuleInfo, node: ast.AST) -> bool:
    """``node`` is in a wrapper's CUDA branch: under a test the card
    passes, or after the CPU branch has returned."""
    return _in_branch(mi, node, _includes_cuda, _excludes_cuda,
                      _excludes_cuda)


def _moves_to_cpu(mi: ModuleInfo, call: ast.Call) -> bool:
    """``x.cpu()``, ``x.to("cpu")``, ``x.to(device="cpu")`` or
    ``x.to(torch.device("cpu"))``."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cpu" and not call.args:
        return True
    if call.func.attr != "to":
        return False
    values = list(call.args[:1]) + [kw.value for kw in call.keywords
                                    if kw.arg == "device"]
    for v in values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                and v.value.split(":")[0] == "cpu":
            return True
        if isinstance(v, ast.Call) and mi.dotted(v.func) == "torch.device" \
                and v.args and isinstance(v.args[0], ast.Constant) \
                and v.args[0].value == "cpu":
            return True
    return False


# --------------------------------------------------------------------------
# RA1xx — compat isolation and the port's own standing
# --------------------------------------------------------------------------

class RA101PrivateTorchApi(Rule):
    """Private torch API used outside ``repro_torch.compat``.

    Counterpart of the reference's version-sensitive JAX API rule.  The
    card runs torch 2.11.0+cu128 and this repo's CPU host 2.13.0+cpu
    (PR 27), and a private module (``torch._C``, ``torch.utils._*``,
    ``torch.testing._internal``, ``torch.distributed.tensor._*``, any
    segment of a ``torch`` path with one leading underscore) may move or
    change between them without notice: PR 27's dry run reached three
    and the RoPE wrapper two.  Every private name goes through the
    port's version shim, :mod:`repro_torch.compat`, so one module says
    what the port takes from torch's insides.  Op names under
    ``torch.ops`` (``aten._softmax``) are ATen's schema, not Python
    API, and are allowed.  Covers the package, the scripts and the
    tests; every import alias is resolved first.
    """

    id = "RA101"
    title = "private torch API outside compat.py"

    ALLOWED = {"repro_torch.compat"}

    @staticmethod
    def _private(dotted: str) -> Optional[str]:
        parts = dotted.split(".")
        if parts[0] != "torch" or parts[1:2] == ["ops"]:
            return None
        for i, seg in enumerate(parts[1:], start=1):
            if seg.startswith("_") and not (seg.startswith("__")
                                            and seg.endswith("__")):
                return ".".join(parts[:i + 1])
        return None

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if mi.module in self.ALLOWED:
            return
        for line, target in mi.import_targets:
            p = self._private(target)
            if p:
                yield Violation(self.id, mi.logical, line,
                                f"import of private torch API '{p}'; use "
                                f"the repro_torch.compat shim")
        for node, dotted in mi.references():
            p = self._private(dotted)
            if p:
                yield self.hit(mi, node,
                               f"use of private torch API '{p}'; use the "
                               f"repro_torch.compat shim")


class RA102PlatformProbe(Rule):
    """``torch.cuda`` platform probe outside the port's device rule.

    Counterpart of the reference's platform-probe rule.  The port's entry
    points run on the card unless the caller asks for the host, and
    refuse without one rather than fall back (PR 11): that rule has one
    definition, :func:`repro_torch.core.sequence.resolve_device`, plus
    the autotuner's question of whether it can time a problem
    (``core.registry._can_measure``) and the device record
    (:mod:`repro_torch.hw`).  A probe anywhere else in the package
    (``is_available``, ``device_count``, ``get_device_properties``,
    ``get_device_name``, ``get_device_capability``) is a second answer to
    "is this on the card".  Library-scoped: the scripts and tests probe
    the card to refuse or skip, as the chip check must
    (``torch.cuda.is_available()``, ``get_device_name(0)``,
    ``device_count()``).
    """

    id = "RA102"
    title = "torch.cuda probe outside resolve_device/_can_measure/hw"

    PROBES = tuple(f"torch.cuda.{p}" for p in (
        "is_available", "device_count", "get_device_properties",
        "get_device_name", "get_device_capability"))
    ALLOWED_MODULES = {"repro_torch.hw"}
    ALLOWED_FUNCTIONS = {("repro_torch.core.sequence", "resolve_device"),
                         ("repro_torch.core.registry", "_can_measure")}

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi) or mi.module in self.ALLOWED_MODULES:
            return
        for line, target in mi.import_targets:
            if target in self.PROBES:
                yield Violation(self.id, mi.logical, line,
                                f"import of platform probe '{target}'; use "
                                f"repro_torch.core.sequence.resolve_device")
        for node, dotted in mi.references():
            if dotted not in self.PROBES:
                continue
            fn = mi.enclosing_function(node)
            if fn is not None and (mi.module, fn.name) \
                    in self.ALLOWED_FUNCTIONS:
                continue
            yield self.hit(mi, node,
                           f"platform probe '{dotted}'; use "
                           f"repro_torch.core.sequence.resolve_device")


class RA103Float32Switch(Rule):
    """Global float32 switch set outside ``compat.ieee_float32()``.

    Counterpart of the reference's ``jax_enable_x64`` rule.  Incident:
    the same save, flip and restore of ``allow_tf32`` was copied by hand
    into three test modules next to the accumulated path's own, and a
    copy that forgets its ``finally`` leaks TF32 products into every
    later test of the process, where a float32 GEMM that should hold
    1e-5 holds 1e-3.  ``torch.backends.{cuda.matmul,cudnn}.allow_tf32``,
    ``torch.set_float32_matmul_precision``, ``torch.set_default_dtype``
    and ``torch.set_default_device`` are set only inside
    :func:`repro_torch.compat.ieee_float32`, which restores what it
    found.  One exception: the ``main()`` of a script (``chip_smoke.py``,
    ``tools/*.py``) may set each switch once for its own process.
    Covers the package, the scripts and the tests.
    """

    id = "RA103"
    title = "global float32 switch outside compat.ieee_float32()"

    ALLOWED = {"repro_torch.compat"}
    FLAGS = ("torch.backends.cuda.matmul.allow_tf32",
             "torch.backends.cudnn.allow_tf32")
    SETTERS = ("torch.set_float32_matmul_precision",
               "torch.set_default_dtype", "torch.set_default_device")

    def _switches(self, mi: ModuleInfo):
        for node in mi.nodes:
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                dotted = mi.dotted(t) if isinstance(t, ast.Attribute) \
                    else None
                if dotted in self.FLAGS:
                    yield node, dotted
            if isinstance(node, ast.Call) \
                    and mi.dotted(node.func) in self.SETTERS:
                yield node, mi.dotted(node.func)

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if mi.module in self.ALLOWED:
            return
        seen_in_main: Set[str] = set()
        for node, switch in sorted(self._switches(mi),
                                   key=lambda p: p[0].lineno):
            fn = mi.enclosing_function(node)
            if _is_script(mi) and fn is not None and fn.name == "main" \
                    and mi.enclosing_function(fn) is None \
                    and switch not in seen_in_main:
                seen_in_main.add(switch)
                continue
            yield self.hit(mi, node,
                           f"global float32 switch '{switch}' set here; use "
                           f"the repro_torch.compat.ieee_float32() context "
                           f"manager")


class RA104PortStandsAlone(Rule):
    """The port imports ``jax``, ``jaxlib`` or the reference ``repro``.

    Port-only.  The port stands alone: its package, the chip check and
    its tools run on a machine with no JAX, and a module of ``repro``
    that imports no JAX today (``repro.analysis``, ``repro.hw``) may
    tomorrow.  Incident: each slice's isolation test
    (``tests/test_torch_isolation.py``) found only the literal
    ``import`` statements it walked; an aliased import, or
    ``importlib.import_module("jax")``/``__import__("repro.x")`` with a
    literal name, went unseen.  Covers ``src/repro_torch``,
    ``chip_smoke.py`` and ``tools/``; tests import both on purpose.
    """

    id = "RA104"
    title = "jax/jaxlib/repro imported by the port"

    BANNED = ("jax", "jaxlib", "repro")
    DYNAMIC = ("importlib.import_module", "__import__")

    def _banned(self, name: str) -> bool:
        return name.split(".")[0] in self.BANNED

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not (_in_port(mi) or _is_script(mi)):
            return
        for line, target in mi.import_targets:
            if self._banned(target):
                yield Violation(self.id, mi.logical, line,
                                f"import of '{target}'; the port imports "
                                f"torch and numpy, never JAX or repro")
        for node in mi.nodes:
            if not (isinstance(node, ast.Call) and node.args):
                continue
            name = node.args[0]
            if mi.dotted(node.func) in self.DYNAMIC \
                    and isinstance(name, ast.Constant) \
                    and isinstance(name.value, str) \
                    and self._banned(name.value):
                yield self.hit(mi, node,
                               f"dynamic import of '{name.value}'; the port "
                               f"imports torch and numpy, never JAX or "
                               f"repro")


class RA105NoSilentFallback(Rule):
    """A kernel's plain version reached on the card, or from a handler.

    Port-only.  A wrapper runs its kernel's plain version on a CPU tensor
    and, on a CUDA tensor, launches the kernel or raises: it never falls
    back (PR 11).  Incident: the card dropped the RoPE gradient (PR 23)
    and a fallback to the plain version would have hidden it, as the
    chip check counts launches, not answers.  Two confinements:

    * in ``repro_torch.kernels.<k>``, a call into the kernel's own
      ``ref`` module is reached only under a test that the tensor is off
      the card (``dev.type == "cpu"``, ``not q.is_cuda``), or after a
      test that the card passes has returned or raised
      (``kernels/rotseq/kernel.py``);
    * no ``except`` handler in ``src/repro_torch`` or ``chip_smoke.py``
      calls a ``ref``-module or ``*_ref`` function, or moves a tensor to
      the host (``.cpu()``, ``.to("cpu")``).
    """

    id = "RA105"
    title = "plain version reached on the card or from an except handler"

    KERNELS = "repro_torch.kernels"

    @staticmethod
    def _ref_call(dotted: str) -> bool:
        parts = dotted.split(".")
        return "ref" in parts[:-1] or parts[-1].endswith("_ref")

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not (_in_port(mi) or mi.module == "chip_smoke"):
            return
        parts = mi.module.split(".")
        if _under(mi.module, (self.KERNELS,)) and len(parts) >= 4 \
                and parts[3] != "ref":
            own_ref = ".".join(parts[:3] + ["ref"]) + "."
            for node in mi.nodes:
                if not isinstance(node, ast.Call):
                    continue
                dotted = mi.dotted(node.func) or ""
                if dotted.startswith(own_ref) and not _off_card(mi, node):
                    yield self.hit(
                        mi, node,
                        f"plain version '{dotted}' reachable for a CUDA "
                        f"tensor; run it under a device.type == 'cpu' test "
                        f"and launch or raise on the card")
        for handler in mi.nodes:
            if not isinstance(handler, ast.ExceptHandler):
                continue
            for node in ast.walk(handler):
                if not isinstance(node, ast.Call):
                    continue
                dotted = mi.dotted(node.func) or ""
                if self._ref_call(dotted):
                    yield self.hit(
                        mi, node,
                        f"except handler calls the plain version "
                        f"'{dotted}'; a failed launch raises, it never "
                        f"falls back")
                elif _moves_to_cpu(mi, node):
                    yield self.hit(
                        mi, node,
                        "except handler moves a tensor to the host; a "
                        "failed launch raises, it never falls back")


# --------------------------------------------------------------------------
# RA2xx — dispatch layering
# --------------------------------------------------------------------------

class RA201RawApplyOutsideApi(Rule):
    """``apply_rotation_sequence`` used outside ``repro_torch.core.api``.

    Counterpart of the reference rule, same meaning.  Incident (the
    reference's): the raw-array wrapper bypasses ``SequencePlan`` caching
    and re-plans on every call; library code must go through
    ``seq.plan(...)``/``plan.apply(...)``.  A grep for
    ``apply_rotation_sequence\\s*\\(`` misses aliased imports; this rule
    resolves the alias table.  The port's package ``__init__`` re-exports
    the function as the reference's ``repro.core`` does, and both
    re-exports are allowed.
    """

    id = "RA201"
    title = "apply_rotation_sequence outside core/api.py"

    ALLOWED = {"repro_torch.core.api", "repro_torch.core", "repro_torch"}
    TARGETS = {"repro_torch.core.api.apply_rotation_sequence",
               "repro_torch.core.apply_rotation_sequence",
               "repro_torch.apply_rotation_sequence"}

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi) or mi.module in self.ALLOWED:
            return
        for line, target in mi.import_targets:
            if target in self.TARGETS:
                yield Violation(self.id, mi.logical, line,
                                "import of apply_rotation_sequence; use "
                                "seq.plan(...)/plan.apply(...)")
        for node in mi.nodes:
            if not isinstance(node, ast.Call):
                continue
            dotted = mi.dotted(node.func)
            if dotted in self.TARGETS:
                yield self.hit(mi, node,
                               "call to apply_rotation_sequence; use "
                               "seq.plan(...)/plan.apply(...)")


class RA202KernelImportOutsideRegistry(Rule):
    """``repro_torch.kernels.rotseq*`` imported outside the dispatch layer.

    Counterpart of the reference rule, same meaning.  Incident (the
    reference's): the registry's cost model keeps its promises only if
    every rotation-sequence launch flows through it; a direct
    ``rot_sequence_batched(...)`` call skips the budget guard (on the
    card: the Hopper limits the wrappers validate against).  Only
    ``repro_torch.core.api`` (the registered backends) may import the
    ``rotseq*`` kernel packages; kernels may import each other.
    """

    id = "RA202"
    title = "rotseq kernel import outside core/api.py"

    ALLOWED = {"repro_torch.core.api"}
    PREFIX = "repro_torch.kernels.rotseq"

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi) or mi.module in self.ALLOWED:
            return
        if mi.module.startswith("repro_torch.kernels"):
            return
        for line, target in mi.import_targets:
            if target.startswith(self.PREFIX):
                yield Violation(self.id, mi.logical, line,
                                f"direct kernel import '{target}'; "
                                f"dispatch via repro_torch.core.registry")
        for node, dotted in mi.references():
            if dotted.startswith(self.PREFIX):
                yield self.hit(mi, node,
                               f"direct kernel reference '{dotted}'; "
                               f"dispatch via repro_torch.core.registry")


class RA203TypedLayerOnly(Rule):
    """serve/eig layer reaching below the typed sequence API.

    Counterpart of the reference rule, same meaning.  Incident (the
    reference's): when ``tridiagonalize`` briefly imported
    ``core.blocked`` directly it pinned one backend and bypassed plan
    caching.  ``repro_torch.serve`` and ``repro_torch.eig`` touch only
    ``RotationSequence``/``SequencePlan`` (plus the registry); the
    backend zoo (``rot_sequence_*``) and internal core modules are off
    limits.  ``repro_torch.kernels.limits`` is carved out: it is pure
    host arithmetic (Hopper limits, block shapes), importable from every
    layer.
    """

    id = "RA203"
    title = "serve/eig layer bypassing the typed API"

    LAYERS = ("repro_torch.serve", "repro_torch.eig")
    BANNED_PREFIXES = ("repro_torch.kernels", "repro_torch.core.blocked",
                       "repro_torch.core.accumulate", "repro_torch.core.ref")
    CARVE_OUTS = ("repro_torch.kernels.limits",)
    BANNED_NAMES = {
        "rot_sequence_blocked", "rot_sequence_accumulated",
        "rot_sequence_unoptimized", "rot_sequence_wavefront",
        "rot_sequence_wave", "rot_sequence_mxu", "rot_sequence_batched",
    }

    def _banned(self, dotted: str) -> bool:
        if _under(dotted, self.CARVE_OUTS):
            return False
        return (_under(dotted, self.BANNED_PREFIXES)
                or dotted.rsplit(".", 1)[-1] in self.BANNED_NAMES)

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _under(mi.module, self.LAYERS):
            return
        for line, target in mi.import_targets:
            if self._banned(target):
                yield Violation(self.id, mi.logical, line,
                                f"layer import '{target}'; serve/eig use "
                                f"RotationSequence/SequencePlan only")
        for node, dotted in mi.references():
            if self._banned(dotted):
                yield self.hit(mi, node,
                               f"layer reference '{dotted}'; serve/eig "
                               f"use RotationSequence/SequencePlan only")


class RA204StreamConcurrencyDiscipline(Rule):
    """Concurrency primitives outside the stream engine; engine reaching
    below the service.

    Counterpart of the reference rule, same meaning and carve-outs.
    Incident (the reference's): a second ad-hoc worker thread in the
    launcher called ``SequencePlan.apply_batched`` straight from it, and
    the two dispatch paths raced the obs counters and double-resolved a
    bucket plan.  Two confinements:

    * thread/queue primitives (``threading``, ``queue``,
      ``concurrent.futures``, ``_thread``, ``multiprocessing``) live only
      in ``repro_torch.serve.stream``; carve-outs for ``repro_torch.obs``
      (metric/trace/roofline locks), ``repro_torch.ckpt.manager`` (the
      async checkpoint writer) and ``repro_torch.parallel.sharding`` (a
      ``threading.local`` for axis-rule scoping);
    * ``repro_torch.serve.stream`` itself imports nothing of
      ``repro_torch.core`` or ``repro_torch.kernels``.

    Library-scoped: the sweep tools build kernel variants in threads.
    """

    id = "RA204"
    title = "thread/queue primitive outside serve.stream, or engine " \
            "bypassing the service"

    THREAD_ROOTS = ("threading", "queue", "concurrent.futures", "_thread",
                    "multiprocessing")
    ENGINE = "repro_torch.serve.stream"
    CARVE_OUTS = ("repro_torch.obs", "repro_torch.ckpt.manager",
                  "repro_torch.parallel.sharding")
    ENGINE_BANNED_PREFIXES = ("repro_torch.core", "repro_torch.kernels")

    def _thread_primitive(self, dotted: str) -> Optional[str]:
        for root in self.THREAD_ROOTS:
            if dotted == root or dotted.startswith(root + "."):
                return root
        return None

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi):
            return
        if mi.module == self.ENGINE:
            for line, target in mi.import_targets:
                if _under(target, self.ENGINE_BANNED_PREFIXES):
                    yield Violation(
                        self.id, mi.logical, line,
                        f"stream engine import '{target}'; execute only "
                        f"through RotationService/SequencePlan handles")
            return
        if _under(mi.module, self.CARVE_OUTS):
            return
        imported_roots = {t.split(".")[0] for _l, t in mi.import_targets}
        for line, target in mi.import_targets:
            root = self._thread_primitive(target)
            if root:
                yield Violation(
                    self.id, mi.logical, line,
                    f"thread/queue primitive '{root}' outside "
                    f"repro_torch.serve.stream; the stream engine is the "
                    f"one concurrent serving component")
        for node, dotted in mi.references():
            root = self._thread_primitive(dotted)
            # a local variable named `queue` yields chains like
            # "queue.append": only flag roots actually imported here
            if root and dotted.split(".")[0] in imported_roots:
                yield self.hit(
                    mi, node,
                    f"thread/queue reference '{dotted}' outside "
                    f"repro_torch.serve.stream; the stream engine is the "
                    f"one concurrent serving component")


class RA205SilentSharedSequenceDefault(Rule):
    """``Problem(batch>1)`` built outside the plan layers without saying
    whether the batch shares one rotation sequence.

    Counterpart of the reference rule, same meaning.  Incident (the
    reference's): the serving path priced ``b`` independent requests as
    ``Problem(batch=64)``, and the ``shared_sequence=True`` default
    claimed the per-sequence setup was paid once; ``method="auto"`` then
    picked a path ~10x slower than the fused kernel at batch 64.  Any
    ``repro_torch.*`` module outside ``core.registry``/``core.sequence``
    that builds a registry ``Problem`` with a batch that is not literally
    1 spells ``shared_sequence=``.
    """

    id = "RA205"
    title = "batched Problem() without explicit shared_sequence"

    ALLOWED = {"repro_torch.core.registry", "repro_torch.core.sequence"}
    TARGETS = {"repro_torch.core.registry.Problem"}

    @staticmethod
    def _batch_may_exceed_one(node: ast.AST) -> bool:
        if isinstance(node, ast.Constant) and node.value in (0, 1, True):
            return False
        return True

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi) or mi.module in self.ALLOWED:
            return
        for node in mi.nodes:
            if not isinstance(node, ast.Call):
                continue
            if mi.dotted(node.func) not in self.TARGETS:
                continue
            kw_names = {kw.arg for kw in node.keywords}
            if None in kw_names or "shared_sequence" in kw_names:
                continue  # a **splat may carry it; or it is spelled
            batch = next((kw.value for kw in node.keywords
                          if kw.arg == "batch"), None)
            if batch is not None and self._batch_may_exceed_one(batch):
                yield self.hit(
                    mi, node,
                    "Problem(batch=...) without shared_sequence=; a "
                    "per-request bucket priced as a shared-sequence "
                    "batch amortizes setup it actually pays b times — "
                    "say shared_sequence=True/False explicitly")


class RA206CollectiveConfinement(Rule):
    """Collective outside the dist layer, or dist importing kernels.

    Counterpart of the reference's SPMD rule.  Incident (the
    reference's PR 10, and the port's PR 20): sharded execution is a
    first-class plan (``repro_torch.dist``) so that it flows through the
    registry, the plan cache and the obs attribution.  Two confinements:

    * ``torch.distributed`` collectives (``all_reduce``, ``all_gather``,
      ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
      ``all_to_all``, ``all_to_all_single``, ``broadcast``, ``send``,
      ``recv``, and everything of ``_functional_collectives``) are called
      only in ``repro_torch.dist``, ``repro_torch.parallel`` and
      ``repro_torch.compat``: a stray one is a second distribution path
      the comm-extended cost model never sees;
    * ``repro_torch.dist`` imports no ``repro_torch.kernels`` module
      (``kernels.limits`` stays importable): every shard runs through
      the planned :mod:`repro_torch.core.sequence` hooks.

    ``DTensor`` types and placements are annotations, like the
    reference's ``shard``, and are allowed everywhere.  A ``DTensor``
    method that communicates (``redistribute``, ``full_tensor``) is
    called on a value, not a module, and cannot be resolved by name:
    this rule does not see it.
    """

    id = "RA206"
    title = "collective outside repro_torch.dist, or dist importing kernels"

    ALLOWED = ("repro_torch.dist", "repro_torch.parallel",
               "repro_torch.compat")
    DIST = "repro_torch.dist"
    COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                   "reduce_scatter_tensor", "all_to_all",
                   "all_to_all_single", "broadcast", "send", "recv"}
    HOMES = ("torch.distributed", "torch.distributed.distributed_c10d",
             "repro_torch.compat")
    FUNCTIONAL = "torch.distributed._functional_collectives"
    KERNEL_PREFIX = "repro_torch.kernels"
    KERNEL_CARVE_OUTS = ("repro_torch.kernels.limits",)

    def _collective(self, dotted: str) -> bool:
        if dotted.startswith(self.FUNCTIONAL + "."):
            return True
        home, _, name = dotted.rpartition(".")
        return name in self.COLLECTIVES and home in self.HOMES

    def _kernel(self, dotted: str) -> bool:
        if _under(dotted, self.KERNEL_CARVE_OUTS):
            return False
        return _under(dotted, (self.KERNEL_PREFIX,))

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi):
            return
        if _under(mi.module, (self.DIST,)):
            for line, target in mi.import_targets:
                if self._kernel(target):
                    yield Violation(
                        self.id, mi.logical, line,
                        f"kernel import '{target}' in repro_torch.dist; "
                        f"shards execute through the planned "
                        f"repro_torch.core.sequence hooks only")
            for node, dotted in mi.references():
                if self._kernel(dotted):
                    yield self.hit(
                        mi, node,
                        f"kernel reference '{dotted}' in repro_torch.dist; "
                        f"shards execute through the planned "
                        f"repro_torch.core.sequence hooks only")
            return
        if _under(mi.module, self.ALLOWED):
            return
        for line, target in mi.import_targets:
            if self._collective(target):
                yield Violation(
                    self.id, mi.logical, line,
                    f"collective import '{target}' outside "
                    f"repro_torch.dist; distribution goes through "
                    f"repro_torch.dist plans")
        for node, dotted in mi.references():
            if self._collective(dotted):
                yield self.hit(
                    mi, node,
                    f"collective '{dotted}' outside repro_torch.dist; "
                    f"distribution goes through repro_torch.dist plans")


# --------------------------------------------------------------------------
# RA3xx — bitwise contract
# --------------------------------------------------------------------------

def _mult_terms(node: ast.AST) -> Optional[Tuple[str, str, bool]]:
    """Decompose ``a * b`` into (leaf_a, leaf_b, negated).

    ``-a * b`` (parsed as ``(-a) * b``) and ``-(a * b)`` both normalize
    to the positive pair with ``negated=True`` so the crosswise matcher
    sees ``-s*x + c*y`` and ``s*x - c*y`` as the same subtraction form.
    """
    neg = False
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        neg = True
        node = node.operand
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult)):
        return None
    left, right = node.left, node.right
    if isinstance(left, ast.UnaryOp) and isinstance(left.op, ast.USub):
        neg = not neg
        left = left.operand
    if isinstance(right, ast.UnaryOp) and isinstance(right.op, ast.USub):
        neg = not neg
        right = right.operand
    if not (_is_simple(left) and _is_simple(right)):
        return None
    return _leaf(left), _leaf(right), neg


def _two_term_forms(node: ast.BinOp) -> Optional[Tuple[str, frozenset,
                                                       frozenset]]:
    """Classify ``t1 + t2`` / ``t1 - t2`` of two products as add/sub form.

    Returns ``(form, pair1, pair2)`` where each pair is a frozenset of
    the two leaf strings of one product and ``form`` folds all sign
    information: ``c*x + s*y`` -> add; ``s*x - c*y`` and ``-s*x + c*y``
    -> sub.
    """
    if not isinstance(node.op, (ast.Add, ast.Sub)):
        return None
    t1 = _mult_terms(node.left)
    t2 = _mult_terms(node.right)
    if t1 is None or t2 is None:
        return None
    a1, b1, n1 = t1
    a2, b2, n2 = t2
    sub = isinstance(node.op, ast.Sub)
    effective_sub = (n1 != n2) != sub
    return ("sub" if effective_sub else "add",
            frozenset((a1, b1)), frozenset((a2, b2)))


class RA301InlinePlaneStencil(Rule):
    """Inline 2x2 plane application instead of ``plane_update``.

    Counterpart of the reference rule, same meaning.  Incident (the
    reference's PR 5): two hand-inlined copies of the rotation stencil
    drifted, one ``g*(s*x - c*y)`` and one ``-s*x + c*y``, and the same
    sequence produced bit-different planes on different paths.  Every
    crosswise pair ``{c*x + s*y, s*x - c*y}`` over the same four operands
    in ``repro_torch`` is the one canonical
    :func:`repro_torch.core.rotations.plane_update` (whose form the
    CUDA kernels spell, RA303).
    """

    id = "RA301"
    title = "inline 2x2 plane stencil (use plane_update)"

    EXEMPT = {"repro_torch.core.rotations"}

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi) or mi.module in self.EXEMPT:
            return
        for fn in mi.functions():
            adds: List[Tuple[ast.AST, frozenset, frozenset]] = []
            subs: List[Tuple[ast.AST, frozenset, frozenset]] = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.BinOp):
                    continue
                form = _two_term_forms(node)
                if form is None:
                    continue
                kind, p1, p2 = form
                (adds if kind == "add" else subs).append((node, p1, p2))
            reported: Set[int] = set()
            for anode, ap1, ap2 in adds:
                leaves = ap1 | ap2
                if len(leaves) != 4:
                    continue
                for snode, sp1, sp2 in subs:
                    if (sp1 | sp2) != leaves:
                        continue
                    if {sp1, sp2} == {ap1, ap2}:
                        continue  # same pairing: sum/difference, not a plane
                    target = max(anode.lineno, snode.lineno)
                    if target in reported:
                        continue
                    reported.add(target)
                    node = anode if anode.lineno == target else snode
                    yield self.hit(
                        mi, node,
                        "inline 2x2 plane stencil; route through "
                        "repro_torch.core.rotations.plane_update")


_INTRINSIC_RE = re.compile(r"\b(__fadd_rn|__fsub_rn|__fmul_rn)\s*\(")
_FMA_RE = re.compile(r"\b(fmaf|fma|__fmaf_\w+|__fma_rn|__hfma2?)\s*\(")
# the half plane form's roundings to the storage type: ``St::r`` (to the
# half type and back to float32) around each product and the difference,
# ``St::h`` (to the half type) around the two results
# (``Store<T>``, csrc/half_store.cuh)
_ROUND_RE = re.compile(r"\bSt::([rh])\s*\(")
_ROUNDED_RESULT_RE = re.compile(r"\bSt::h\s*\(\s*$")
# the paired form (csrc/half_store.cuh): ``const P2 v = St::p2(a, b);``
# rounds ``a`` and ``b`` (the same product of two planes) to the half
# type in one packed conversion, ``v.x``/``v.y`` being the two; a native
# paired op ``const P2 v = __hadd2(a, b);`` (``__hsub2``, ``__hmul2``)
# computes ``__fadd_rn(a.x, b.x)`` and ``__fadd_rn(a.y, b.y)`` rounded to
# the half type; ``St::bits(a, b)``, ``St::pair(a, b)`` and
# ``make_float2(a, b)`` pair ``a`` and ``b`` unrounded (a product of two
# such pairs by ``__hmul2`` is then a rounded product)
_PAIR_RE = re.compile(r"\bSt::p2\s*\(")
_PAIR_DEF_RE = re.compile(
    r"\b(\w+)\s*=\s*(St::p2|St::bits|St::pair|make_float2|__hadd2|__hsub2"
    r"|__hmul2)\s*\(")
_NATIVE_PAIR = {"__hadd2": "__fadd_rn", "__hsub2": "__fsub_rn",
                "__hmul2": "__fmul_rn"}
_PAIR_LEAF_RE = re.compile(r"^(\w+)\.([xy])$")


def _call_args(code: str, open_idx: int) -> Optional[Tuple[List[str], int]]:
    """Top-level arguments of the call whose ``(`` is at ``open_idx``,
    and the offset of its ``)``."""
    depth, start, args = 0, open_idx + 1, []
    for i in range(open_idx, len(code)):
        c = code[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
            if depth == 0:
                args.append(code[start:i])
                return args, i
        elif c == "," and depth == 1:
            args.append(code[start:i])
            start = i + 1
    return None


def _arg_spans(code: str, open_idx: int) -> Optional[List[Tuple[str, int]]]:
    """Each top-level argument of the call whose ``(`` is at ``open_idx``,
    stripped, with the offset of its first character."""
    parsed = _call_args(code, open_idx)
    if parsed is None:
        return None
    spans, pos = [], open_idx + 1
    for a in parsed[0]:
        spans.append((a.strip(), pos + len(a) - len(a.lstrip())))
        pos += len(a) + 1
    return spans


class _PairedRoundings:
    """The paired values of one source, by name: for each definition its
    offset and its two lanes, each ``(expression, key, rounded)``, where
    ``key`` is where the lane's expression is spelled (an offset, or
    ``(offset, lane)`` for a native paired op's lanes, spelled by
    :attr:`virtual`).  :attr:`args` holds the offsets at which an
    argument of ``St::p2`` starts (a rounded result)."""

    def __init__(self, code: str):
        self.args: Set[int] = set()
        self.defs: Dict[str, List[Tuple[int, List[tuple]]]] = {}
        # a native op's lanes as intrinsic calls: (name, args, key, offset)
        self.virtual: List[Tuple[str, List[str], tuple, int]] = []
        for m in _PAIR_RE.finditer(code):
            self.args.update(off for _, off in
                             _arg_spans(code, m.end() - 1) or [])
        for m in _PAIR_DEF_RE.finditer(code):
            spans = _arg_spans(code, m.end() - 1)
            if spans is None or len(spans) != 2:
                continue
            fn = m.group(2)
            if fn in _NATIVE_PAIR:
                lanes = []
                for lane in "xy":
                    key = (m.start(), lane)
                    args = [f"{a}.{lane}" for a, _ in spans]
                    self.virtual.append((_NATIVE_PAIR[fn], args, key,
                                         m.start()))
                    lanes.append((f"{_NATIVE_PAIR[fn]}({', '.join(args)})",
                                  key, True))
            else:
                lanes = [(a, off, fn == "St::p2") for a, off in spans]
            self.defs.setdefault(m.group(1), []).append((m.start(), lanes))

    def resolve(self, leaf: str, at: int) -> Optional[tuple]:
        """``(expression, key, rounded)`` of the lane that ``v.x``/``v.y``
        reads at offset ``at`` (from the nearest definition of ``v``
        before it); ``None`` for any other leaf."""
        m = _PAIR_LEAF_RE.match(re.sub(r"\s+", "", leaf))
        if not m:
            return None
        before = [lanes for off, lanes in self.defs.get(m.group(1), [])
                  if off < at]
        return before[-1][m.group(2) == "y"] if before else None


def _intrinsic_tree(expr: str, pairs: Optional[_PairedRoundings] = None,
                    at: int = 0):
    """``(name, [args])`` for an expression that is one ``__f*_rn`` call
    (or one rounding ``St::r``/``St::h``, named ``"St::r"``/``"St::h"``),
    else the expression with its whitespace removed (a leaf).  With
    ``pairs``, a leaf ``v.x`` read at offset ``at`` from a paired
    rounding is ``("St::r", [tree])`` of the expression it rounded (from
    ``make_float2``, that expression's tree)."""
    expr = expr.strip()
    for regex, name in ((_INTRINSIC_RE, None), (_ROUND_RE, "St::")):
        m = regex.match(expr)
        if m:
            parsed = _call_args(expr, m.end() - 1)
            if parsed is not None and parsed[1] == len(expr) - 1:
                return ((name or "") + m.group(1),
                        [_intrinsic_tree(a, pairs, at) for a in parsed[0]])
    leaf = re.sub(r"\s+", "", expr)
    hit = pairs.resolve(leaf, at) if pairs is not None else None
    if hit is None:
        return leaf
    key = hit[1]
    tree = _intrinsic_tree(hit[0], pairs,
                           key[0] if isinstance(key, tuple) else key)
    return ("St::r", [tree]) if hit[2] else tree


def _product(tree) -> Optional[Tuple[str, str]]:
    if isinstance(tree, tuple) and tree[0] == "__fmul_rn" \
            and len(tree[1]) == 2 and all(isinstance(a, str)
                                          for a in tree[1]):
        return tree[1][0], tree[1][1]
    return None


def _rounded(tree):
    """The operand of ``St::r(...)``, else ``None``."""
    if isinstance(tree, tuple) and tree[0] == "St::r" and len(tree[1]) == 1:
        return tree[1][0]
    return None


def _plane_products(args) -> Optional[Tuple[Tuple[str, ...], bool]]:
    """The four operands of two products and whether both are rounded
    (the half form); ``None`` if the two arguments are not both plain or
    both rounded products.  Raises ``ValueError`` for a pair of products
    of which only one is rounded."""
    plain = [_product(a) for a in args]
    if all(plain):
        return plain[0] + plain[1], False
    half = [_product(_rounded(a)) for a in args]
    if all(half):
        return half[0] + half[1], True
    if any(plain) and any(half):
        raise ValueError("one product rounded to the half type, the "
                         "other not")
    return None


class RA303CudaPlaneForm(Rule):
    """The CUDA kernels' plane update is not the uncontracted form.

    Port-only.  ``csrc/rotseq_wave.cu`` and ``csrc/rotseq_batched.cu``
    (with the header they share, ``csrc/half_store.cuh``) are held bit
    for bit to their plain versions (``chip_smoke.py``),
    which apply :func:`repro_torch.core.rotations.plane_update`:
    ``x' = c*x + s*y`` and ``y' = g*(s*x - c*y)``, every product and sum
    rounded on its own.  The kernels spell it in
    ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``, which the compiler never
    contracts, and ``kernels/_build.py`` builds with ``--fmad=false`` so
    that nothing else is contracted either.  Incident: one fused
    multiply-add in a plane flips the last bit of a rotation, and the
    bit-for-bit checks then fail only on the card, after a build.  The
    rule holds, by a token scan of the three files (comments stripped):
    no ``fmaf``, ``fma``, ``__fmaf_*`` or ``__fma_rn``; every
    ``__fadd_rn(__fmul_rn(c, x), __fmul_rn(s, y))`` is paired with a
    ``__fmul_rn(g, __fsub_rn(__fmul_rn(s, x), __fmul_rn(c, y)))`` over
    the same four operands and the other way round; each file spells at
    least one such pair.  And ``_build.FLAGS`` holds
    ``--fmad=false``.  The half plane form (bfloat16 and float16, as
    eager PyTorch computes it on half tensors) rounds each product and
    the difference to the half type, ``St::r(...)``, and each result,
    ``St::h(...)``: ``St::h(__fadd_rn(St::r(__fmul_rn(c, x)),
    St::r(__fmul_rn(s, y))))`` pairs with ``St::h(__fmul_rn(g,
    St::r(__fsub_rn(St::r(__fmul_rn(s, x)), St::r(__fmul_rn(c, y))))))``;
    a product, difference or result of that form left unrounded is
    reported too.  The paired spelling of the same form
    (``half_store.cuh``'s ``plane_pair`` and ``plane_pair_native``,
    which the two kernels call in half precision) rounds the same
    operation of two planes
    together: the products in one packed conversion, ``const P2 v =
    St::p2(a0, a1);``, whose ``v.x``/``v.y`` stand for ``St::r`` of the
    argument they name (the nearest definition before them), and the
    sum, the difference and g's product of two half values as one native
    paired op, ``const P2 v = __hadd2(a, b);`` (``__hsub2``,
    ``__hmul2``), read as ``__fadd_rn(a.x, b.x)`` and ``__fadd_rn(a.y,
    b.y)`` each rounded to the half type; ``St::bits``, ``St::pair`` and
    ``make_float2`` pair values unrounded (``plane_pair_native`` takes
    its products as ``__hmul2`` of such pairs).  The same checks hold on
    those lanes, and ``__hfma2``/``__hfma`` are fused multiply-adds too.
    ``rotseq_mxu.cu`` and ``rotseq_mxu_half.cu`` are out
    of scope: they are the GEMM tiers, held to a stated tolerance, the
    first built on ``fmaf`` on purpose; so is ``rope.cu``, whose
    half-split form is RoPE's own (``x1*c - x2*s``, each product rounded
    to the element type).
    """

    id = "RA303"
    title = "CUDA plane update not in the uncontracted form"
    kinds = (PYTHON, CUDA)

    SOURCES = {"repro_torch.csrc.rotseq_wave",
               "repro_torch.csrc.rotseq_batched",
               "repro_torch.csrc.half_store"}
    BUILD = "repro_torch.kernels._build"
    FLAG = "--fmad=false"

    def _check_build(self, mi: ModuleInfo) -> Iterable[Violation]:
        for node in mi.tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "FLAGS"
                    for t in node.targets):
                values = node.value.elts if isinstance(
                    node.value, (ast.List, ast.Tuple)) else []
                if not any(isinstance(v, ast.Constant)
                           and v.value == self.FLAG for v in values):
                    yield self.hit(mi, node,
                                   f"FLAGS lacks '{self.FLAG}': nvcc may "
                                   f"contract the kernels' products into "
                                   f"fused multiply-adds")
                return
        yield self.hit(mi, 1, f"no literal FLAGS list holding "
                              f"'{self.FLAG}'")

    def _check_source(self, cu: CudaSource) -> Iterable[Violation]:
        code = cu.code
        for m in _FMA_RE.finditer(code):
            yield self.hit(cu, cu.line_of(m.start()),
                           f"'{m.group(1)}' fuses a product into a sum; "
                           f"spell the plane with __fmul_rn/__fadd_rn/"
                           f"__fsub_rn")
        adds: Dict[Tuple, List[int]] = {}
        subs: Dict[Tuple, List[int]] = {}
        inner: Set = set()   # keys of the __fsub_rn inside a g-product
        pairs = _PairedRoundings(code)

        def result_rounded(start: int) -> bool:
            return (start in pairs.args
                    or bool(_ROUNDED_RESULT_RE.search(code[:start])))

        # every __f*_rn call: (name, argument texts, key, offset, rounded),
        # those spelled in the source and the lanes of native paired ops
        calls = []
        for m in _INTRINSIC_RE.finditer(code):
            parsed = _call_args(code, m.end() - 1)
            if parsed is not None:
                calls.append((m.group(1), parsed[0], m.start(), m.start(),
                              result_rounded(m.start())))
        calls += [(name, args, key, off, True)
                  for name, args, key, off in pairs.virtual]
        for name, texts, key, at, rounded_result in calls:
            args = [_intrinsic_tree(a, pairs, at) for a in texts]
            line = cu.line_of(at)
            try:
                if name == "__fadd_rn" and len(args) == 2:
                    form = _plane_products(args)
                    if form:
                        adds.setdefault(form, []).append(line)
                        if form[1] and not rounded_result:
                            yield self.hit(cu, line, "half plane form: "
                                           "c*x + s*y not rounded to the "
                                           "half type (St::h, __hadd2)")
                elif name == "__fmul_rn" and len(args) == 2:
                    diff = args[1]
                    half = _rounded(diff) is not None
                    # a difference read from a pair: where it is spelled
                    paired = pairs.resolve(texts[1], at)
                    if half:
                        diff = _rounded(diff)
                    if not (isinstance(diff, tuple)
                            and diff[0] == "__fsub_rn"
                            and len(diff[1]) == 2):
                        continue
                    form = _plane_products(diff[1])
                    if not form:
                        continue
                    inner.add(paired[1] if paired is not None
                              else code.index("__fsub_rn", at + 1))
                    if form[1] != half:
                        raise ValueError("the difference s*x - c*y and its "
                                         "products rounded unlike")
                    (s, x, c, y), rounded = form
                    subs.setdefault(((c, x, s, y), rounded), []).append(line)
                    if rounded and not rounded_result:
                        yield self.hit(cu, line, "half plane form: g*(s*x - "
                                       "c*y) not rounded to the half type "
                                       "(St::h, __hmul2)")
            except ValueError as err:
                yield self.hit(cu, line, f"half plane form: {err}; round "
                               f"each product and sum (St::r, St::p2)")
        for name, texts, key, at, _ in calls:
            if name != "__fsub_rn" or key in inner or len(texts) != 2:
                continue
            try:
                form = _plane_products([_intrinsic_tree(a, pairs, at)
                                        for a in texts])
            except ValueError:
                form = True
            if form:
                yield self.hit(cu, cu.line_of(at),
                               "difference of products outside "
                               "__fmul_rn(g, ...): the plane's second row "
                               "is g*(s*x - c*y)")
        for key, lines in sorted(adds.items()):
            if key not in subs:
                for line in lines:
                    yield self.hit(cu, line,
                                   "c*x + s*y without its partner "
                                   "g*(s*x - c*y) over the same operands")
        for key, lines in sorted(subs.items()):
            if key not in adds:
                for line in lines:
                    yield self.hit(cu, line,
                                   "g*(s*x - c*y) without its partner "
                                   "c*x + s*y over the same operands")
        if not adds and not subs:
            yield self.hit(cu, 1, "no plane update spelled in __fmul_rn/"
                                  "__fadd_rn/__fsub_rn")

    def check(self, mi) -> Iterable[Violation]:
        if mi.kind == PYTHON and mi.module == self.BUILD:
            yield from self._check_build(mi)
        elif mi.kind == CUDA and mi.module in self.SOURCES:
            yield from self._check_source(mi)


# --------------------------------------------------------------------------
# RA4xx — kernel hygiene
# --------------------------------------------------------------------------

class RA401WrapperHostRoundTrip(Rule):
    """Host round-trip in a kernel wrapper's CUDA branch.

    Counterpart of the reference's Pallas-body rule.  A CUDA kernel's
    body is C++, and the Python that can stall it is the wrapper around
    the launch: a ``.item()`` there waits for the card and every launch
    queued before, and the launch path that the chip check times turns
    into a synchronous one.  Incident (the reference's): an ``.item()``
    probe ran green in interpret mode and broke the compiled kernel.  In
    ``repro_torch.kernels.*.kernel`` and ``.ops``, the CUDA branch (under
    a test the card passes, or after the CPU branch has returned) holds
    no ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")`` or ``torch.cuda.synchronize``.
    """

    id = "RA401"
    title = "host round-trip in a kernel wrapper's CUDA branch"

    HOST_METHODS = {"item", "tolist", "numpy"}
    SYNC = "torch.cuda.synchronize"

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        parts = mi.module.split(".")
        if not (len(parts) == 4 and parts[:2] == [PORT, "kernels"]
                and parts[3] in ("kernel", "ops")):
            return
        for node in mi.nodes:
            if not isinstance(node, ast.Call):
                continue
            what = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self.HOST_METHODS:
                what = f".{node.func.attr}()"
            elif _moves_to_cpu(mi, node):
                what = "a copy to the host"
            elif mi.dotted(node.func) == self.SYNC:
                what = self.SYNC
            if what and _cuda_branch(mi, node):
                yield self.hit(mi, node,
                               f"{what} in the CUDA branch of a kernel "
                               f"wrapper waits for the card; keep the "
                               f"launch path asynchronous")


class RA403BudgetConstantOutsideLimits(Rule):
    """On-chip budget or Hopper limit defined outside ``kernels.limits``.

    Counterpart of the reference rule, extended to the Hopper limits.
    Incident (the reference's PR 5): the budget lived in the registry's
    cost guard while the kernel wrapper carried its own copy, coupled
    only by a "mirror the kernel" comment.  Budget constants
    (``*_BUDGET``) and the card's per-block limits (``SMEM_*``,
    ``REGS_*``) are defined once, in :mod:`repro_torch.kernels.limits`,
    and imported everywhere else.
    """

    id = "RA403"
    title = "budget/limit constant defined outside kernels/limits.py"

    EXEMPT = {"repro_torch.kernels.limits"}
    NAME_RE = re.compile(r"^_?[A-Z0-9]*(SMEM|VMEM)[A-Z0-9_]*BUDGET$|"
                         r"^_?[A-Z0-9_]*BUDGET$|^_?(SMEM|REGS)_[A-Z0-9_]*$")

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi) or mi.module in self.EXEMPT:
            return
        for node in mi.nodes:
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and self.NAME_RE.match(t.id) \
                        and t.id not in mi.aliases:
                    yield self.hit(
                        mi, node,
                        f"budget constant '{t.id}' defined here; define "
                        f"in repro_torch.kernels.limits and import it")


def _is_round_up_expr(node: ast.AST) -> bool:
    """Match the hand-inlined ``((x + M-1) // M) * M`` round-up shape."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult)):
        return False
    for div, mult in ((node.left, node.right), (node.right, node.left)):
        if not (isinstance(div, ast.BinOp)
                and isinstance(div.op, ast.FloorDiv)):
            continue
        add = div.left
        m_str = ast.unparse(mult)
        if ast.unparse(div.right) != m_str:
            continue
        # ((x + mult - 1) // mult) parses the numerator as Sub(Add(..), 1)
        if isinstance(add, ast.BinOp) and isinstance(add.op, ast.Sub) \
                and isinstance(add.right, ast.Constant) \
                and add.right.value == 1:
            inner = add.left
            if isinstance(inner, ast.BinOp) \
                    and isinstance(inner.op, ast.Add) \
                    and m_str in (ast.unparse(inner.left),
                                  ast.unparse(inner.right)):
                return True
        if not (isinstance(add, ast.BinOp) and isinstance(add.op, ast.Add)):
            continue
        for k in (add.left, add.right):
            if isinstance(k, ast.Constant) and isinstance(mult, ast.Constant) \
                    and isinstance(k.value, int) \
                    and k.value == mult.value - 1:
                return True
            if ast.unparse(k) == f"{m_str} - 1":
                return True
    return False


class RA404RederivedClamp(Rule):
    """Tile round-up/clamp re-derived instead of imported from limits.

    Counterpart of the reference rule, same meaning.  Incident (the
    reference's PR 5): private ``_round_up`` copies and an inline
    ``((m + 7) // 8) * 8`` let the cost guard's idea of a kernel's
    padded shape drift from the kernel's own.
    :func:`repro_torch.kernels.limits.round_up` is the only definition.
    """

    id = "RA404"
    title = "round-up/clamp re-derived outside kernels/limits.py"

    EXEMPT = {"repro_torch.kernels.limits"}
    HELPER_NAMES = {"round_up", "_round_up", "clamp_m_blk", "_clamp_m_blk"}

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi) or mi.module in self.EXEMPT:
            return
        for fn in mi.functions():
            if fn.name in self.HELPER_NAMES:
                yield self.hit(
                    mi, fn,
                    f"local helper '{fn.name}' shadows "
                    f"repro_torch.kernels.limits; import it instead")
        for node in mi.nodes:
            if isinstance(node, ast.BinOp) and _is_round_up_expr(node):
                yield self.hit(
                    mi, node,
                    "inline ((x + M-1) // M) * M round-up; use "
                    "repro_torch.kernels.limits.round_up")


_CONSTEXPR_RE = re.compile(r"^constexpr\s+int\s+(\w+)\s*=\s*([^;]+);", re.M)


def _int_value(node: ast.AST, env: Dict[str, int]) -> Optional[int]:
    """An integer constant expression of literals and earlier names."""
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp):
        a, b = _int_value(node.left, env), _int_value(node.right, env)
        if a is None or b is None:
            return None
        ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
               ast.Mult: lambda: a * b,
               ast.FloorDiv: lambda: a // b if b else None,
               ast.Pow: lambda: a ** b if 0 <= b < 64 else None}
        fn = ops.get(type(node.op))
        return fn() if fn else None
    return None


def _limits_values(tree: ast.Module) -> Dict[str, Tuple[int, int]]:
    """Module-level integer constants: name -> (value, line)."""
    env: Dict[str, int] = {}
    out: Dict[str, Tuple[int, int]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = _int_value(node.value, env)
            if v is not None:
                env[node.targets[0].id] = v
                out[node.targets[0].id] = (v, node.lineno)
    return out


def _cu_constants(code: str, line_of) -> Dict[str, Tuple[Optional[int], int]]:
    """Namespace-level ``constexpr int`` of a CUDA source (declarations
    at column 0): name -> (value or None if not a literal, line)."""
    out: Dict[str, Tuple[Optional[int], int]] = {}
    for m in _CONSTEXPR_RE.finditer(code):
        try:
            value: Optional[int] = int(m.group(2).strip(), 0)
        except ValueError:
            value = None
        out.setdefault(m.group(1), (value, line_of(m.start())))
    return out


class RA405CudaConstantsMirrorLimits(Rule):
    """A CUDA source's compiled constant differs from ``kernels.limits``.

    Port-only.  The wrappers, the registry's cost model and the tests
    read a kernel's block shape from :mod:`repro_torch.kernels.limits`;
    the kernel is compiled for its own ``constexpr int``.  Incident: a
    kernel retuned in its source alone (a sweep tool builds variants by
    editing these constants) launches with one block shape while the
    wrapper validates, and the cost model prices, another; only one-off
    asserts in four test modules held them together.  Each pair in
    :attr:`MIRRORS` is equal.  The rule reads both files, whichever side
    it is analyzing, and reports on that side, so an edit to either file
    is caught on a cached run too.
    """

    id = "RA405"
    title = "CUDA constexpr differs from the kernels/limits.py mirror"
    kinds = (PYTHON, CUDA)

    # source under csrc/ -> (its constexpr int, the limits name) pairs
    MIRRORS: Dict[str, Tuple[Tuple[str, str], ...]] = {
        "rotseq_wave": (("kBand", "WAVE_KB"), ("kWarps", "WAVE_WARPS")),
        "rotseq_mxu": (("kRows", "MXU_ROWS"), ("kSlab", "MXU_SLAB")),
        "rotseq_mxu_half": (("kRows", "MXU_HALF_ROWS"),
                            ("kChunk", "MXU_HALF_CHUNK"),
                            ("kCluster", "MXU_HALF_CLUSTER"),
                            ("kStages", "MXU_HALF_STAGES"),
                            ("kVec", "MXU_HALF_VEC")),
        "rotseq_batched": (("kBand", "BATCHED_KB"),
                           ("kThreads", "BATCHED_M_BLK")),
    }
    LIMITS = "repro_torch.kernels.limits"
    LIMITS_PATH = "src/repro_torch/kernels/limits.py"
    CSRC = "src/repro_torch/csrc"

    @staticmethod
    def _read(rel: str) -> Optional[str]:
        try:
            with open(os.path.join(repo_root(), rel), encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None

    def _check_source(self, cu: CudaSource) -> Iterable[Violation]:
        pairs = self.MIRRORS.get(cu.module.rsplit(".", 1)[-1])
        if pairs is None or cu.module.rsplit(".", 1)[0] != "repro_torch.csrc":
            return
        text = self._read(self.LIMITS_PATH)
        if text is None:
            yield self.hit(cu, 1, f"cannot read {self.LIMITS_PATH}")
            return
        limits = _limits_values(ast.parse(text))
        consts = _cu_constants(cu.code, cu.line_of)
        for const, name in pairs:
            value, line = consts.get(const, (None, 1))
            want = limits.get(name, (None, 0))[0]
            if value is None or value != want:
                yield self.hit(cu, line,
                               f"constexpr int {const} = {value} but "
                               f"repro_torch.kernels.limits.{name} = {want}; "
                               f"they must be equal")

    def _check_limits(self, mi: ModuleInfo) -> Iterable[Violation]:
        limits = _limits_values(mi.tree)
        for src, pairs in sorted(self.MIRRORS.items()):
            rel = f"{self.CSRC}/{src}.cu"
            text = self._read(rel)
            if text is None:
                yield self.hit(mi, 1, f"cannot read {rel}, which "
                                      f"mirrors limits")
                continue
            cu = CudaSource(rel, text, rel)
            consts = _cu_constants(cu.code, cu.line_of)
            for const, name in pairs:
                want, line = limits.get(name, (None, 1))
                value = consts.get(const, (None, 0))[0]
                if value is None or value != want:
                    yield self.hit(mi, line,
                                   f"{name} = {want} but {rel} has "
                                   f"constexpr int {const} = {value}; they "
                                   f"must be equal")

    def check(self, mi) -> Iterable[Violation]:
        if mi.kind == CUDA:
            yield from self._check_source(mi)
        elif mi.module == self.LIMITS:
            yield from self._check_limits(mi)


# --------------------------------------------------------------------------
# RA5xx — plan-cache determinism + timing discipline
# --------------------------------------------------------------------------

class RA501NondeterministicKeyPath(Rule):
    """Wall-clock or RNG in a cache-key or cost-model function.

    Counterpart of the reference rule, same meaning, with torch's RNG
    beside numpy's.  Incident (the reference's): the on-disk plan store
    replays cached plans across processes; a timestamp or RNG draw
    folded into a plan key (or a cost estimate) makes two identical
    problems hash to different plans.  Measurement helpers
    (``_measure*``) may time things; ``cost_*``/``*_key`` functions
    (the port's ``core/registry.py`` ``cost_*`` and ``_plan_key``) must
    be pure.
    """

    id = "RA501"
    title = "time/random in cache-key or cost-model path"

    FUNC_RE = re.compile(r"^(cost_|plan_key$|cache_key$|fingerprint)|_key$")
    BANNED_ROOTS = ("time", "random", "secrets", "uuid")
    BANNED_PREFIXES = ("numpy.random", "datetime", "os.urandom",
                       "torch.random", "torch.rand", "torch.randn",
                       "torch.randint", "torch.randperm", "torch.normal",
                       "torch.bernoulli", "torch.multinomial",
                       "torch.manual_seed", "torch.seed")

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not _in_port(mi):
            return
        for fn in mi.functions():
            if not self.FUNC_RE.search(fn.name):
                continue
            for node in ast.walk(fn):
                dotted = None
                if isinstance(node, ast.Attribute) and not isinstance(
                        mi.parents.get(node), ast.Attribute):
                    dotted = mi.dotted(node)
                if not dotted:
                    continue
                root = dotted.split(".")[0]
                if root in self.BANNED_ROOTS \
                        or _under(dotted, self.BANNED_PREFIXES):
                    yield self.hit(
                        mi, node,
                        f"nondeterministic '{dotted}' in key/cost path "
                        f"'{fn.name}'; keys and costs must be pure")


class RA502AdHocTiming(Rule):
    """Ad-hoc wall-clock timing outside ``repro_torch.obs``.

    Counterpart of the reference rule, extended to the port's scripts.
    Incident (the reference's PR 7): the benchmarks, the train loop, the
    serve launcher and three examples each carried a private
    ``time.perf_counter()`` stopwatch, and when one serving number was
    found wrong every copy had to be audited by hand.  The port's one
    clock is :mod:`repro_torch.obs.timing` (``now()`` is
    ``perf_counter``); the package, ``chip_smoke.py`` and ``tools/``
    reference none of the reference's list of stdlib clocks and no
    ``timeit``.  A bare ``import time`` stays legal (``time.sleep`` is
    not a clock, nor is ``time.thread_time``, the host thread's CPU
    seconds that ``chip_smoke.py`` reads beside the clock).  Tests are
    out of scope: they assert on behaviour, not on published numbers.
    """

    id = "RA502"
    title = "ad-hoc timing outside repro_torch.obs"

    SCOPES = ("repro_torch", "chip_smoke", "tools")
    EXEMPT = ("repro_torch.obs",)
    CLOCKS = ("time.time", "time.time_ns", "time.perf_counter",
              "time.perf_counter_ns", "time.monotonic",
              "time.monotonic_ns", "time.process_time",
              "time.process_time_ns")

    def _scoped(self, mi: ModuleInfo) -> bool:
        return _under(mi.module, self.SCOPES) \
            and not _under(mi.module, self.EXEMPT)

    @staticmethod
    def _is_timeit(dotted: str) -> bool:
        return dotted == "timeit" or dotted.startswith("timeit.")

    def check(self, mi: ModuleInfo) -> Iterable[Violation]:
        if not self._scoped(mi):
            return
        for line, target in mi.import_targets:
            if self._is_timeit(target):
                yield Violation(self.id, mi.logical, line,
                                "import of timeit; time through "
                                "repro_torch.obs.timing instead")
            elif target in self.CLOCKS:
                yield Violation(self.id, mi.logical, line,
                                f"import of stdlib clock '{target}'; use "
                                f"repro_torch.obs.timing.now()")
        for node, dotted in mi.references():
            if dotted in self.CLOCKS:
                yield self.hit(
                    mi, node,
                    f"ad-hoc clock '{dotted}'; repro_torch.obs.timing is "
                    f"the single sanctioned timing home")
            elif self._is_timeit(dotted):
                yield self.hit(
                    mi, node,
                    f"timeit reference '{dotted}'; time through "
                    f"repro_torch.obs.timing instead")


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

ALL_RULES: Tuple[type, ...] = (
    RA101PrivateTorchApi,
    RA102PlatformProbe,
    RA103Float32Switch,
    RA104PortStandsAlone,
    RA105NoSilentFallback,
    RA201RawApplyOutsideApi,
    RA202KernelImportOutsideRegistry,
    RA203TypedLayerOnly,
    RA204StreamConcurrencyDiscipline,
    RA205SilentSharedSequenceDefault,
    RA206CollectiveConfinement,
    RA301InlinePlaneStencil,
    RA303CudaPlaneForm,
    RA401WrapperHostRoundTrip,
    RA403BudgetConstantOutsideLimits,
    RA404RederivedClamp,
    RA405CudaConstantsMirrorLimits,
    RA501NondeterministicKeyPath,
    RA502AdHocTiming,
)

# reference rules with no counterpart: id -> (the reference's title, why)
NO_COUNTERPART: Dict[str, Tuple[str, str]] = {
    "RA302": ("foldable scalar sign in traced plane_update call",
              "eager PyTorch folds no Python scalar into a contraction; "
              "the kernels' plane form is RA303"),
    "RA402": ("jnp reduction over traced grid dim in kernel body",
              "a CUDA launch's grid is host arithmetic in the wrapper, "
              "not a traced value a kernel body reduces"),
}


def all_rules() -> List[Rule]:
    return [cls() for cls in ALL_RULES]


def rules_matching(selectors: Sequence[str]) -> List[Rule]:
    """Instantiate rules whose id matches any selector prefix.

    ``RA2`` selects the whole family; ``RA203`` one rule.
    """
    out = []
    for cls in ALL_RULES:
        rule = cls()
        if any(rule.id.startswith(sel) for sel in selectors):
            out.append(rule)
    return out
