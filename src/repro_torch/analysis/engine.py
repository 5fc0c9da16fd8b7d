"""Core machinery of the ``repro_torch`` static invariant analyzer.

Mirror of :mod:`repro.analysis.engine`, kept as the port's own copy (the
port imports nothing of ``repro``).  This module knows nothing about the
port's specific invariants (those live in
:mod:`repro_torch.analysis.rules`); it provides the pieces every rule
shares:

* **module model** (:class:`ModuleInfo`): one parsed Python file with
  its AST, a parent map, the *logical* repo path (fixtures can override
  it with a ``# repro-torch-lint: fixture-as=...`` pragma so a file under
  ``tests/torch_analysis/analysis_fixtures/`` is analyzed as if it lived
  at a real path), and a resolved **import alias table**: every
  ``Name``/``Attribute`` chain resolves through it to a fully qualified
  dotted path before any rule looks at it, so ``import torch._C as C``
  followed by ``C._cuda_getDevice()`` is seen as ``torch._C...``.
* **CUDA sources** (:class:`CudaSource`): a ``.cu`` file or a ``.cuh``
  header read as text, its comments blanked with every line kept in
  place, for the rules that check the kernels' sources by a token scan
  (no C++ parsing).
* **suppression** (``# repro-torch-lint: disable=RA301`` on the
  offending line, or ``disable-next=`` on the line above; ``//`` in a
  ``.cu`` file) and a checked-in **baseline** file, so a legacy
  violation can be grandfathered without weakening the gate for new
  code.  The pragma and the cache variable are the port's own names: the
  reference's ``# repro-lint:`` pragmas and ``REPRO_LINT_CACHE`` never
  reach this analyzer, nor its pragmas the reference's.
* **mtime caching**: per-file results are cached under
  ``~/.cache/repro_torch/lint_cache.json`` (override:
  ``REPRO_TORCH_LINT_CACHE``; ``off`` disables) keyed by (mtime, size,
  rules digest), so a rerun re-parses only files that changed.
"""
from __future__ import annotations

import ast
import dataclasses
import glob
import hashlib
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Violation", "ModuleInfo", "CudaSource", "Rule", "analyze_file",
    "analyze_paths", "iter_source_files", "load_baseline",
    "write_baseline", "baseline_key", "repo_root", "default_roots",
    "DEFAULT_BASELINE",
]


_PRAGMA_RE = re.compile(r"#\s*repro-torch-lint:\s*([^#]*)")
_CU_PRAGMA_RE = re.compile(r"//\s*repro-torch-lint:\s*(.*)")
_DIRECTIVE_RE = re.compile(
    r"(disable|disable-next|fixture-as)\s*=\s*([\w./,\- ]+)")

_CACHE_ENV = "REPRO_TORCH_LINT_CACHE"
_CACHE_FORMAT = 1

PYTHON, CUDA = "python", "cuda"
_SUFFIXES = {".py": PYTHON, ".cu": CUDA, ".cuh": CUDA}


# --------------------------------------------------------------------------
# data model
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule hit: ``path:line: RAxxx message``."""
    rule: str          # e.g. "RA201"
    path: str          # logical repo-relative posix path
    line: int
    message: str

    @property
    def family(self) -> str:
        return self.rule[:3]

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def baseline_key(v: Violation) -> str:
    """Stable identity of a violation for baseline matching.

    Line numbers are excluded on purpose: unrelated edits above a
    grandfathered violation must not un-baseline it.
    """
    return f"{v.path}::{v.rule}::{v.message}"


class Rule:
    """Base class: one named, suppressible invariant check.

    Subclasses set ``id`` (e.g. ``"RA201"``), ``title``, the source
    ``kinds`` they check (``"python"``, ``"cuda"`` or both) and
    implement :meth:`check`; the class docstring records the motivating
    incident (shown by ``python -m repro_torch.analysis --list-rules``).
    """

    id: str = ""
    title: str = ""
    kinds: Tuple[str, ...] = (PYTHON,)

    @property
    def family(self) -> str:
        return self.id[:3]

    def check(self, mi) -> Iterable[Violation]:
        raise NotImplementedError

    def hit(self, mi, node, message: str) -> Violation:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Violation(rule=self.id, path=mi.logical, line=line,
                         message=message)


# --------------------------------------------------------------------------
# module model
# --------------------------------------------------------------------------

def _module_name(logical: str) -> str:
    """Dotted module name of a logical repo path.

    ``src/repro_torch/core/api.py`` -> ``repro_torch.core.api``;
    ``src/repro_torch/csrc/rope.cu`` -> ``repro_torch.csrc.rope``
    (a ``.cuh`` header likewise);
    ``chip_smoke.py`` -> ``chip_smoke``; ``tools/x.py`` -> ``tools.x``;
    ``tests/test_x.py`` -> ``tests.test_x`` (never a ``repro_torch.*``
    name, so library-scoped rules skip them automatically).
    """
    p = logical.replace(os.sep, "/")
    if p.startswith("src/"):
        p = p[len("src/"):]
    for suffix in _SUFFIXES:
        if p.endswith(suffix):
            p = p[:-len(suffix)]
    parts = [seg for seg in p.split("/") if seg]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _parse_pragmas(source: str, pragma_re) -> List[Tuple[int, str, str]]:
    out = []
    for i, line in enumerate(source.splitlines(), start=1):
        m = pragma_re.search(line)
        if not m:
            continue
        for dm in _DIRECTIVE_RE.finditer(m.group(1)):
            out.append((i, dm.group(1), dm.group(2).strip()))
    return out


def _suppressions(pragmas) -> Dict[int, Set[str]]:
    sup: Dict[int, Set[str]] = {}
    for line, directive, value in pragmas:
        ids = {tok.strip() for tok in value.split(",") if tok.strip()}
        if directive == "disable":
            sup.setdefault(line, set()).update(ids)
        elif directive == "disable-next":
            sup.setdefault(line + 1, set()).update(ids)
    return sup


class _Source:
    """What both source kinds share: path, logical name, suppressions."""

    kind = ""

    def __init__(self, path: str, source: str, logical: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.logical = logical.replace(os.sep, "/")
        self.module = _module_name(self.logical)
        self.suppressed = _suppressions(self.parse_pragmas(source))

    @staticmethod
    def parse_pragmas(source: str) -> List[Tuple[int, str, str]]:
        raise NotImplementedError

    def is_suppressed(self, v: Violation) -> bool:
        ids = self.suppressed.get(v.line, ())
        return v.rule in ids or v.family in ids


class ModuleInfo(_Source):
    """One parsed Python file plus everything the rules need to query it."""

    kind = PYTHON

    def __init__(self, path: str, source: str, logical: str):
        self.tree = ast.parse(source, filename=path)
        super().__init__(path, source, logical)
        # every node, in ast.walk's order, walked once for all the rules
        self.nodes: List[ast.AST] = [self.tree]
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in self.nodes:     # grows as it goes: breadth first
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
                self.nodes.append(child)
        self._references: Optional[List[Tuple[ast.AST, str]]] = None
        self.aliases = self._collect_aliases()
        # (lineno, fully-qualified dotted target) for every import binding
        self.import_targets = self._collect_import_targets()

    # -- pragmas -----------------------------------------------------------

    @staticmethod
    def parse_pragmas(source: str) -> List[Tuple[int, str, str]]:
        """All ``(lineno, directive, value)`` repro-torch-lint pragmas."""
        return _parse_pragmas(source, _PRAGMA_RE)

    # -- imports and name resolution --------------------------------------

    def _package(self) -> List[str]:
        parts = self.module.split(".") if self.module else []
        if self.logical.endswith("__init__.py"):
            return parts
        return parts[:-1]

    def _from_base(self, node: ast.ImportFrom) -> List[str]:
        base: List[str] = []
        if node.level:
            pkg = self._package()
            drop = node.level - 1
            base = pkg[:len(pkg) - drop] if drop else pkg
        if node.module:
            base = base + node.module.split(".")
        return base

    def _collect_aliases(self) -> Dict[str, str]:
        """Local name -> fully qualified dotted target, from imports."""
        aliases: Dict[str, str] = {}
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for al in node.names:
                    if al.asname:
                        aliases[al.asname] = al.name
                    else:
                        root = al.name.split(".")[0]
                        aliases.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom):
                base = self._from_base(node)
                for al in node.names:
                    if al.name == "*":
                        continue
                    target = ".".join(base + [al.name])
                    aliases[al.asname or al.name] = target
        return aliases

    def _collect_import_targets(self) -> List[Tuple[int, str]]:
        out: List[Tuple[int, str]] = []
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for al in node.names:
                    out.append((node.lineno, al.name))
            elif isinstance(node, ast.ImportFrom):
                base = self._from_base(node)
                for al in node.names:
                    if al.name == "*":
                        out.append((node.lineno, ".".join(base)))
                    else:
                        out.append((node.lineno, ".".join(base + [al.name])))
        return out

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Fully-qualified dotted path of a Name/Attribute chain.

        Resolves the root through the alias table, so ``fc.all_reduce``
        after ``import torch.distributed._functional_collectives as fc``
        yields ``torch.distributed._functional_collectives.all_reduce``.
        """
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self.aliases.get(node.id, node.id))
            return ".".join(reversed(parts))
        return None

    def references(self) -> List[Tuple[ast.AST, str]]:
        """Every maximal Name/Attribute chain, resolved to dotted form."""
        if self._references is not None:
            return self._references
        out: List[Tuple[ast.AST, str]] = []
        for node in self.nodes:
            if isinstance(node, ast.Attribute):
                if isinstance(self.parents.get(node), ast.Attribute):
                    continue  # only the outermost link of a chain
                dd = self.dotted(node)
                if dd:
                    out.append((node, dd))
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                if isinstance(self.parents.get(node), ast.Attribute):
                    continue
                target = self.aliases.get(node.id)
                if target and target != node.id:
                    out.append((node, target))
        self._references = out
        return out

    def functions(self) -> List[ast.AST]:
        return [n for n in self.nodes
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        """The innermost function definition around ``node``, if any."""
        node = self.parents.get(node)
        while node is not None and not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            node = self.parents.get(node)
        return node


def _strip_comments(source: str) -> str:
    """``source`` with C/C++ comments blanked: every character of a
    comment but its newlines becomes a space, so offsets and line numbers
    are kept; string and character literals are left alone."""
    out = list(source)
    i, n = 0, len(source)
    while i < n:
        ch = source[i]
        if ch in "\"'":
            j = i + 1
            while j < n and source[j] != ch and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            i = j + 1
        elif source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = ["\n" if c == "\n" else " " for c in source[i:j]]
            i = j
        else:
            i += 1
    return "".join(out)


class CudaSource(_Source):
    """One CUDA source read as text, for token-scanning rules.

    ``code`` is the source with its comments blanked (line numbers and
    offsets unchanged); :meth:`line_of` maps an offset of it to its line.
    """

    kind = CUDA

    def __init__(self, path: str, source: str, logical: str):
        super().__init__(path, source, logical)
        self.code = _strip_comments(source)
        self._starts = [0] + [m.end() for m in re.finditer("\n", source)]

    @staticmethod
    def parse_pragmas(source: str) -> List[Tuple[int, str, str]]:
        """All ``(lineno, directive, value)`` ``// repro-torch-lint:``
        pragmas."""
        return _parse_pragmas(source, _CU_PRAGMA_RE)

    def line_of(self, offset: int) -> int:
        lo, hi = 0, len(self._starts)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self._starts[mid] <= offset:
                lo = mid
            else:
                hi = mid
        return lo + 1


_SOURCE_OF = {PYTHON: ModuleInfo, CUDA: CudaSource}


def source_kind(path: str) -> Optional[str]:
    return _SUFFIXES.get(os.path.splitext(path)[1])


# --------------------------------------------------------------------------
# walking + caching
# --------------------------------------------------------------------------

def repo_root() -> str:
    """Repository root, derived from this package's location."""
    here = os.path.dirname(os.path.abspath(__file__))  # src/repro_torch/analysis
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json")

_SKIP_DIRS = {"__pycache__", ".git", "analysis_fixtures", ".claude"}

# the port's scripts: the chip check and the tools that time the kernels
_SCRIPTS = ("chip_smoke.py", "tools/wave_sweep.py", "tools/mxu_sweep.py",
            "tools/rope_sweep.py", "tools/rope_bench.py",
            "tools/rope_host.py", "tools/autotune_flush.py")


def default_roots() -> List[str]:
    """The port's package (Python and CUDA sources), its scripts, and its
    tests (``tests/test_torch_*.py``, for the rules scoped to tests)."""
    root = repo_root()
    roots = []
    for rel in ("src/repro_torch",) + _SCRIPTS:
        p = os.path.join(root, rel)
        if os.path.exists(p):
            roots.append(p)
    roots += sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py")))
    return roots


def iter_source_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if source_kind(fn):
                    out.append(os.path.join(dirpath, fn))
    return out


def _logical_path(path: str, source: str, kind: str) -> str:
    """Repo-relative analysis path, honouring ``fixture-as`` pragmas."""
    for _, directive, value in _SOURCE_OF[kind].parse_pragmas(source):
        if directive == "fixture-as":
            return value
    rel = os.path.relpath(os.path.abspath(path), repo_root())
    return rel.replace(os.sep, "/")


def _cache_path() -> Optional[str]:
    override = os.environ.get(_CACHE_ENV)
    if override is not None:
        if override.strip().lower() in ("", "off", "0", "none"):
            return None
        return os.path.expanduser(override)
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", "lint_cache.json")


def _rules_digest(rules: Sequence[Rule]) -> str:
    """Digest of the analyzer's own sources + active rule ids.

    Any edit to the engine or the rule set invalidates every cached
    entry — a stale cache must never mask (or invent) violations.
    """
    h = hashlib.sha256()
    pkg = os.path.dirname(os.path.abspath(__file__))
    for fn in sorted(os.listdir(pkg)):
        if fn.endswith(".py"):
            with open(os.path.join(pkg, fn), "rb") as f:
                h.update(f.read())
    h.update(",".join(sorted(r.id for r in rules)).encode())
    return h.hexdigest()[:16]


def _load_cache(path: str) -> dict:
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(payload, dict) \
            or payload.get("format") != _CACHE_FORMAT:
        return {}
    return payload.get("files", {})


def _store_cache(path: str, files: dict) -> None:
    payload = {"format": _CACHE_FORMAT, "files": files}
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".lint.", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        pass  # read-only cache dir: degrade to uncached


# --------------------------------------------------------------------------
# analysis entry points
# --------------------------------------------------------------------------

def analyze_file(path: str, rules: Sequence[Rule],
                 explicit: bool = False) -> List[Violation]:
    """Run ``rules`` over one file; [] for fixture files unless explicit.

    Fixture files (bearing a ``fixture-as`` pragma) are skipped during
    tree walks — they contain violations *on purpose* — but analyzed
    normally when named directly (the fixture tests do exactly that).
    A rule sees only the source kinds it declares.
    """
    kind = source_kind(path)
    if kind is None:
        return []
    with open(path, encoding="utf-8") as f:
        source = f.read()
    logical = _logical_path(path, source, kind)
    is_fixture = logical != os.path.relpath(
        os.path.abspath(path), repo_root()).replace(os.sep, "/")
    if is_fixture and not explicit:
        return []
    try:
        mi = _SOURCE_OF[kind](path, source, logical)
    except SyntaxError as e:
        return [Violation(rule="RA000", path=logical,
                          line=e.lineno or 1,
                          message=f"syntax error: {e.msg}")]
    out: List[Violation] = []
    seen: Set[Tuple[str, int]] = set()
    for rule in rules:
        if kind not in rule.kinds:
            continue
        for v in rule.check(mi):
            if (v.rule, v.line) in seen:
                continue  # one report per rule per line
            seen.add((v.rule, v.line))
            if not mi.is_suppressed(v):
                out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def analyze_paths(paths: Sequence[str], rules: Sequence[Rule],
                  use_cache: bool = True,
                  explicit_fixtures: bool = False) -> List[Violation]:
    """Analyze files/trees, with the mtime cache on the walk hot path."""
    files = iter_source_files(paths)
    cache_file = _cache_path() if use_cache else None
    cache = _load_cache(cache_file) if cache_file else {}
    digest = _rules_digest(rules)
    out: List[Violation] = []
    fresh: dict = {}
    dirty = False
    for path in files:
        ap = os.path.abspath(path)
        try:
            st = os.stat(ap)
        except OSError:
            continue
        entry = cache.get(ap)
        if (entry is not None and entry.get("digest") == digest
                and entry.get("mtime") == st.st_mtime
                and entry.get("size") == st.st_size):
            vs = [Violation(**d) for d in entry["violations"]]
        else:
            vs = analyze_file(ap, rules, explicit=explicit_fixtures)
            dirty = True
        fresh[ap] = {"digest": digest, "mtime": st.st_mtime,
                     "size": st.st_size,
                     "violations": [dataclasses.asdict(v) for v in vs]}
        out.extend(vs)
    if cache_file and dirty:
        _store_cache(cache_file, fresh)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------

def load_baseline(path: str = DEFAULT_BASELINE) -> Set[str]:
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return set()
    if not isinstance(payload, dict):
        return set()
    return set(payload.get("entries", []))


def write_baseline(violations: Sequence[Violation],
                   path: str = DEFAULT_BASELINE) -> str:
    payload = {
        "format": 1,
        "comment": "Grandfathered repro_torch.analysis violations. Entries "
                   "are path::rule::message (line-independent). Shrink this "
                   "file; never grow it for new code.",
        "entries": sorted({baseline_key(v) for v in violations}),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path
