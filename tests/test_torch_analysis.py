"""Tests for ``repro_torch.analysis``, the port's static invariant analyzer.

Fixture-driven as ``tests/test_analysis.py`` is: every file under
``tests/torch_analysis/analysis_fixtures/`` carries ``expect: RAxxx``
markers, and the analyzer's ``(line, rule-id)`` set on it must equal
them.  Then parity with the reference: on every reference fixture the
port's engine resolves the same imports, references and pragmas, and
each rule whose meaning the port keeps gives the same hits on the
fixture rewritten to the port's module paths.  Then the CUDA rules on
altered copies of the real sources, suppression, the baseline, the
cache, the CLI, and the gate over the port's tree.
"""
import json
import os
import re
import subprocess
import sys

import pytest

from repro.analysis import all_rules as ref_all_rules
from repro.analysis import analyze_file as ref_analyze_file
from repro.analysis import engine as ref_engine
from repro.analysis import rules_matching as ref_rules_matching
from repro_torch.analysis import (NO_COUNTERPART, Violation, all_rules,
                                  analyze_file, analyze_paths,
                                  baseline_key, load_baseline,
                                  rules_matching, write_baseline)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import engine
from repro_torch.analysis.engine import (CudaSource, ModuleInfo,
                                         default_roots, repo_root)
from repro_torch.analysis.rules import RA405CudaConstantsMirrorLimits

ROOT = repo_root()
FIXTURES = os.path.join(ROOT, "tests", "torch_analysis", "analysis_fixtures")
REF_FIXTURES = os.path.join(ROOT, "tests", "analysis_fixtures")
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")

_EXPECT_RE = re.compile(r"(?:#|//)\s*expect:\s*(RA\d+)")
# the two analyzers' pragma prefixes, spelled apart so that neither
# analyzer reads a pragma in this file
PORT_PRAGMA = "repro-torch" + "-lint:"
REF_PRAGMA = "repro" + "-lint:"


def expected_marks(path):
    """(line, rule-id) pairs from ``expect:`` markers in a fixture."""
    out = set()
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            for m in _EXPECT_RE.finditer(line):
                out.add((lineno, m.group(1)))
    return out


def fixture(name):
    return os.path.join(FIXTURES, name)


FIXTURE_FILES = sorted(fn for fn in os.listdir(FIXTURES)
                       if fn.endswith((".py", ".cu")))
REF_FIXTURE_FILES = sorted(fn for fn in os.listdir(REF_FIXTURES)
                           if fn.endswith(".py"))


def to_port(source):
    """A reference fixture as the port's: its pragma prefix, its module
    paths (``repro.`` -> ``repro_torch.``, ``src/repro/`` ->
    ``src/repro_torch/``) and ``benchmarks/`` (which the port does not
    have) as ``tools/``, the port's scripts."""
    source = source.replace(REF_PRAGMA, PORT_PRAGMA)
    source = source.replace("fixture-as=src/repro/",
                            "fixture-as=src/repro_torch/")
    source = source.replace("fixture-as=benchmarks/", "fixture-as=tools/")
    return re.sub(r"\brepro\.", "repro_torch.", source)


def to_port_name(name):
    """A dotted name or logical path of the reference, as the port's."""
    name = re.sub(r"^src/repro/", "src/repro_torch/", name)
    name = re.sub(r"^benchmarks([./]|$)", r"tools\1", name)
    return re.sub(r"^repro(\.|$)", r"repro_torch\1", name)


def _port_copy(tmp_path, name):
    with open(os.path.join(REF_FIXTURES, name)) as f:
        source = to_port(f.read())
    path = tmp_path / name
    path.write_text(source)
    return str(path), source


# --------------------------------------------------------------------------
# (a) per-fixture: violations == expect markers, ids and line numbers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_matches_expect_markers(name):
    path = fixture(name)
    got = {(v.line, v.rule)
           for v in analyze_file(path, all_rules(), explicit=True)}
    assert got == expected_marks(path), (
        f"{name}: analyzer reported {sorted(got)}, "
        f"markers say {sorted(expected_marks(path))}")


def test_every_rule_has_a_failing_fixture():
    covered = {}
    for name in FIXTURE_FILES:
        for _, rule in expected_marks(fixture(name)):
            covered.setdefault(rule, set()).add(name.rsplit(".", 1)[1])
    all_ids = {r.id for r in all_rules()}
    assert all_ids <= set(covered), all_ids - set(covered)
    # the CUDA rules fail on a .cu fixture, and RA303/RA405 on a Python
    # one too (the build flags, the limits side of the mirror)
    assert covered["RA303"] == covered["RA405"] == {"py", "cu"}


@pytest.mark.parametrize("name", ["clean_module.py", "suppressed.py",
                                  "suppressed.cu"])
def test_clean_and_suppressed_fixtures_are_clean(name):
    vs = analyze_file(fixture(name), all_rules(), explicit=True)
    assert vs == [], [v.format() for v in vs]
    assert expected_marks(fixture(name)) == set()


def test_suppressed_fixtures_fire_without_their_pragmas(tmp_path):
    """The suppressed fixtures are not clean by accident: with their
    pragmas removed the findings come back."""
    for name, ids in (("suppressed.py", {"RA301", "RA101"}),
                      ("suppressed.cu", {"RA303"})):
        with open(fixture(name)) as f:
            source = f.read()
        bare = re.sub(r"(#|//) " + re.escape(PORT_PRAGMA) + r" disable\S*",
                      "", source)
        path = tmp_path / name
        path.write_text(bare)
        got = {v.rule for v in analyze_file(str(path), all_rules(),
                                            explicit=True)}
        assert got == ids, (name, got)


def test_list_of_rules_and_no_counterparts_covers_the_reference():
    """One row for every reference rule: its counterpart under the same
    id, or the reason it has none; port-only rules take new ids."""
    ref_ids = {r.id for r in ref_all_rules()}
    port_ids = {r.id for r in all_rules()}
    assert ref_ids == (ref_ids & port_ids) | set(NO_COUNTERPART)
    assert set(NO_COUNTERPART) == {"RA302", "RA402"}
    assert not set(NO_COUNTERPART) & port_ids
    assert port_ids - ref_ids == {"RA104", "RA105", "RA303", "RA405"}
    for rule in all_rules():
        assert rule.title and (type(rule).__doc__ or "").strip(), rule.id


def test_rules_matching_selects_families():
    assert {r.id for r in rules_matching(["RA3"])} == {"RA301", "RA303"}
    assert {r.id for r in rules_matching(["RA1"])} == \
        {"RA101", "RA102", "RA103", "RA104", "RA105"}
    assert [r.id for r in rules_matching(["RA405"])] == ["RA405"]
    assert rules_matching(["RA9"]) == []


def test_library_scoped_rules_ignore_tests_and_scripts(tmp_path):
    """RA102 and RA202 bind the package only: a test or the chip check
    may probe the card and call a kernel."""
    source = ("import torch\n"
              "from repro_torch.kernels.rotseq_batched.ops import "
              "rot_sequence_batched\n"
              "def main():\n"
              "    return torch.cuda.is_available(), rot_sequence_batched\n")
    for logical in ("tests/test_probe.py", "chip_smoke.py"):
        p = tmp_path / "probe.py"
        p.write_text(f"# {PORT_PRAGMA} fixture-as={logical}\n" + source)
        assert analyze_file(str(p), rules_matching(["RA102", "RA202"]),
                            explicit=True) == []


def test_platform_probe_allowed_where_the_device_rule_lives(tmp_path):
    body = ("import torch\n"
            "def resolve_device(device):\n"
            "    return torch.cuda.is_available()\n"
            "def other():\n"
            "    return torch.cuda.is_available()\n")
    got = {}
    for logical in ("src/repro_torch/core/sequence.py",
                    "src/repro_torch/hw.py"):
        p = tmp_path / "probe.py"
        p.write_text(f"# {PORT_PRAGMA} fixture-as={logical}\n" + body)
        got[logical] = [v.line for v in analyze_file(
            str(p), rules_matching(["RA102"]), explicit=True)]
    assert got == {"src/repro_torch/core/sequence.py": [6],
                   "src/repro_torch/hw.py": []}


def test_port_and_reference_pragmas_never_cross(tmp_path):
    """Each analyzer reads its own pragma only."""
    stencil = ("def f(x, y, c, s):\n"
               "    xn = c * x + s * y\n"
               "    yn = s * x - c * y  # {} disable=RA301\n"
               "    return xn, yn\n")
    port_file = tmp_path / "port.py"
    port_file.write_text(f"# {PORT_PRAGMA} fixture-as=src/repro_torch/core/"
                         f"x.py\n" + stencil.format(REF_PRAGMA))
    ref_file = tmp_path / "ref.py"
    ref_file.write_text(f"# {REF_PRAGMA} fixture-as=src/repro/core/x.py\n"
                        + stencil.format(PORT_PRAGMA))
    assert [v.rule for v in analyze_file(
        str(port_file), rules_matching(["RA301"]), explicit=True)] \
        == ["RA301"]
    assert [v.rule for v in ref_analyze_file(
        str(ref_file), ref_rules_matching(["RA301"]), explicit=True)] \
        == ["RA301"]
    # and neither reads the other's fixture-as: a port fixture is a real
    # file to the reference, a reference fixture one to the port
    assert ref_engine._logical_path(str(port_file), port_file.read_text()) \
        != "src/repro_torch/core/x.py"
    assert engine._logical_path(str(ref_file), ref_file.read_text(),
                                "python") != "src/repro/core/x.py"


# --------------------------------------------------------------------------
# (b) engine parity with repro.analysis on the reference's fixtures
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", REF_FIXTURE_FILES)
def test_engine_parity_on_reference_fixtures(name):
    """The port's ModuleInfo resolves what the reference's does: the same
    module name, aliases, import targets and references (after
    ``repro.`` -> ``repro_torch.``), the same pragmas once the prefix is
    mapped, and the same baseline keys."""
    path = os.path.join(REF_FIXTURES, name)
    with open(path) as f:
        source = f.read()
    logical = ref_engine._logical_path(path, source)
    ref = ref_engine.ModuleInfo(path, source, logical)
    port_source = to_port(source)
    port = ModuleInfo(path, port_source, to_port_name(logical))
    moved = _rewritten(source)

    assert port.module == to_port_name(ref.module)
    assert port.aliases == {k: to_port_name(v)
                            for k, v in ref.aliases.items()}
    assert port.import_targets == [(line, to_port_name(t))
                                   for line, t in ref.import_targets]
    assert [(n.lineno, None if n.lineno in moved else n.col_offset, d)
            for n, d in port.references()] == \
        [(n.lineno, None if n.lineno in moved else n.col_offset,
          to_port_name(d)) for n, d in ref.references()]
    assert [f.name for f in port.functions()] == \
        [f.name for f in ref.functions()]
    assert ModuleInfo.parse_pragmas(port_source) == [
        (line, d, to_port_name(v) if d == "fixture-as" else v)
        for line, d, v in ref_engine.ModuleInfo.parse_pragmas(source)]
    assert port.suppressed == ref.suppressed
    for fields in (("RA301", logical, 12, "inline 2x2 plane stencil"),
                   ("RA502", "tools/x.py", 1, "m")):
        assert baseline_key(Violation(*fields)) == \
            ref_engine.baseline_key(ref_engine.Violation(*fields))


def _rewritten(source):
    """Lines whose text the port rewrite changes (column offsets after a
    rewritten name move on them)."""
    return {i for i, (a, b) in enumerate(
        zip(source.splitlines(), to_port(source).splitlines()), start=1)
        if a != b}


def test_engine_parity_on_the_port_tree():
    """On the port's own sources too, the two engines resolve alike (no
    repro.* name appears, so nothing is rewritten)."""
    files = [f for f in engine.iter_source_files(default_roots())
             if f.endswith(".py")]
    assert len(files) > 100
    for path in files:
        with open(path) as f:
            source = f.read()
        logical = os.path.relpath(path, ROOT)
        ref = ref_engine.ModuleInfo(path, source, logical)
        port = ModuleInfo(path, source, logical)
        assert port.aliases == ref.aliases, path
        assert port.import_targets == ref.import_targets, path
        assert [(n.lineno, n.col_offset, d) for n, d in port.references()] \
            == [(n.lineno, n.col_offset, d) for n, d in ref.references()]


# --------------------------------------------------------------------------
# (c) rule parity: the carried-over rules on the reference's fixtures
# --------------------------------------------------------------------------

# rules whose meaning the port keeps, each with the reference fixtures
# that exercise it (the rule's own and the clean and suppressed ones)
PARITY = {
    "RA201": ["ra201_aliased_import.py"],
    "RA202": ["ra202_kernel_import.py", "ra206_dist_kernel_import.py"],
    "RA203": ["ra203_layer_bypass.py"],
    "RA204": ["ra204_thread_outside_stream.py"],
    "RA205": ["ra205_problem_without_shared_sequence.py"],
    "RA206": ["ra206_dist_kernel_import.py"],
    "RA301": ["ra301_inline_stencil.py", "suppressed.py"],
    "RA403": ["ra403_budget_copy.py"],
    "RA404": ["ra404_rederived_clamp.py"],
    "RA501": ["ra501_nondeterministic_key.py"],
    "RA502": ["ra502_adhoc_timing.py", "ra501_nondeterministic_key.py"],
}


@pytest.mark.parametrize("rid,name", [
    (rid, name) for rid, names in sorted(PARITY.items())
    for name in names + ["clean_module.py"]])
def test_rule_parity_on_reference_fixtures(rid, name, tmp_path):
    ref_hits = {(v.line, v.rule) for v in ref_analyze_file(
        os.path.join(REF_FIXTURES, name), ref_rules_matching([rid]),
        explicit=True)}
    path, _ = _port_copy(tmp_path, name)
    port_hits = {(v.line, v.rule) for v in analyze_file(
        path, rules_matching([rid]), explicit=True)}
    assert port_hits == ref_hits
    if name != "clean_module.py" and name != "suppressed.py":
        assert ref_hits, (rid, name)


def test_parity_covers_every_unchanged_rule():
    assert {"RA201", "RA202", "RA203", "RA204", "RA205", "RA404", "RA501",
            "RA502"} <= set(PARITY)


# --------------------------------------------------------------------------
# the CUDA rules on altered copies of the real sources
# --------------------------------------------------------------------------

def _cu_hits(tmp_path, src_name, text, rules=("RA303", "RA405")):
    path = tmp_path / src_name
    path.write_text(f"// {PORT_PRAGMA} fixture-as=src/repro_torch/csrc/"
                    f"{src_name}\n" + text)
    return sorted((v.rule, v.line) for v in analyze_file(
        str(path), rules_matching(list(rules)), explicit=True))


@pytest.mark.parametrize("src_name", ["rotseq_wave.cu", "rotseq_batched.cu",
                                      "half_store.cuh", "rotseq_mxu.cu",
                                      "rotseq_mxu_half.cu", "rope.cu"])
def test_real_cuda_sources_are_clean(src_name):
    assert analyze_file(os.path.join(CSRC, src_name), all_rules()) == []


def test_the_shared_header_is_read_and_checked(tmp_path):
    """``csrc/half_store.cuh`` is among the files the gate reads, and a
    fused multiply-add in a plane pair is reported there."""
    header = os.path.join(CSRC, "half_store.cuh")
    assert header in engine.iter_source_files(engine.default_roots())
    with open(header) as f:
        text = f.read()
    ys = "const P2 ys = __hmul2(g, d);"
    assert text.count(ys) == 2                 # in each plane pair
    at = text.index(ys)
    hits = _cu_hits(tmp_path, "half_store.cuh",
                    text[:at] + "const P2 ys = __hfma2(g, d, cx);"
                    + text[at + len(ys):])
    line = text[:at].count("\n") + 2
    assert ("RA303", line) in hits


@pytest.mark.parametrize("src_name,operand", [("rotseq_wave.cu", "c"),
                                              ("rotseq_batched.cu", "q")])
def test_plane_form_breaks_are_caught_in_the_real_sources(
        tmp_path, src_name, operand):
    with open(os.path.join(CSRC, src_name)) as f:
        text = f.read()
    row = (f"__fsub_rn(__fmul_rn({operand}.y, x), "
           f"__fmul_rn({operand}.x, y))")
    assert text.count(row) == 1
    assert _cu_hits(tmp_path, src_name, text) == []
    def line(s):   # the 1-based line of s in the copy (+1: the pragma)
        return text[:text.index(s)].count("\n") + 2
    # the second row with its products swapped: both rows lose partners
    swapped = text.replace(row, f"__fsub_rn(__fmul_rn({operand}.x, y), "
                                f"__fmul_rn({operand}.y, x))")
    assert [r for r, _ in _cu_hits(tmp_path, src_name, swapped)] == \
        ["RA303", "RA303"]
    # a fused multiply-add for the first product
    add = f"__fadd_rn(__fmul_rn({operand}.x, x),"
    assert text.count(add) == 1
    fused = text.replace(add, f"fmaf({operand}.x, x,")
    assert _cu_hits(tmp_path, src_name, fused) == [
        ("RA303", line(add)), ("RA303", line(row))]


# the seven paired roundings of the band kernels' half planes
# (csrc/half_store.cuh: plane_pair, the fused kernel's, and
# plane_pair_native, the wavefront kernel's), and each spelled unrounded:
# the products' packed conversions (St::p2) or native paired products, the
# native paired sum, difference and g-product
PAIRED = {
    "cx": ("const P2 cx = St::p2(", "const float2 cx = make_float2("),
    "sy": ("const P2 sy = St::p2(", "const float2 sy = make_float2("),
    "sx": ("const P2 sx = St::p2(", "const float2 sx = make_float2("),
    "cy": ("const P2 cy = St::p2(", "const float2 cy = make_float2("),
    "xs": ("const P2 xs = __hadd2(cx, sy);",
           "const float2 xs = make_float2(__fadd_rn(cx.x, sy.x), "
           "__fadd_rn(cx.y, sy.y));"),
    "d": ("const P2 d = __hsub2(sx, cy);",
          "const float2 d = make_float2(__fsub_rn(sx.x, cy.x), "
          "__fsub_rn(sx.y, cy.y));"),
    "ys": ("const P2 ys = __hmul2(g, d);",
           "const float2 ys = make_float2(__fmul_rn(g.x, d.x), "
           "__fmul_rn(g.y, d.y));"),
}
NATIVE = {**PAIRED, **{
    name: (f"const P2 {name} = __hmul2({a}, {b});",
           f"const float2 {name} = make_float2(__fmul_rn({a}.x, {b}.x), "
           f"__fmul_rn({a}.y, {b}.y));")
    for name, a, b in (("cx", "c", "x"), ("sy", "s", "y"),
                       ("sx", "s", "x"), ("cy", "c", "y"))}}


@pytest.mark.parametrize("fn,forms", [("plane_pair", PAIRED),
                                      ("plane_pair_native", NATIVE)])
@pytest.mark.parametrize("name", sorted(PAIRED))
def test_dropped_paired_rounding_is_caught_in_the_real_source(tmp_path,
                                                              name, fn,
                                                              forms):
    """Each of the half plane's paired roundings spelled unrounded (the
    pair made by ``make_float2``) in either plane pair of the header both
    band kernels include is reported on the lines of that plane pair."""
    with open(os.path.join(CSRC, "half_store.cuh")) as f:
        text = f.read()
    start = text.index(f"void {fn}(")
    end = text.index("\n}\n", start)
    spelled, unrounded = forms[name]
    assert text[start:end].count(spelled) == 1
    assert _cu_hits(tmp_path, "half_store.cuh", text) == []
    at = text.index(spelled, start)
    broken = text[:at] + unrounded + text[at + len(spelled):]
    hits = _cu_hits(tmp_path, "half_store.cuh", broken)
    first = text[:text.index("const P2 cx", start)].count("\n") + 2
    last = text[:text.index("const P2 ys", start)].count("\n") + 2
    assert hits and all(r == "RA303" and first <= ln <= last
                        for r, ln in hits), hits


@pytest.mark.parametrize("src_name,const,value", [
    ("rotseq_wave.cu", "kBand", 16), ("rotseq_wave.cu", "kWarps", 12),
    ("rotseq_mxu.cu", "kRows", 32), ("rotseq_mxu.cu", "kSlab", 32),
    ("rotseq_mxu_half.cu", "kRows", 64),
    ("rotseq_mxu_half.cu", "kChunk", 64),
    ("rotseq_mxu_half.cu", "kCluster", 2),
    ("rotseq_mxu_half.cu", "kStages", 4),
    ("rotseq_mxu_half.cu", "kVec", 8),
    ("rotseq_batched.cu", "kBand", 16),
    ("rotseq_batched.cu", "kThreads", 64)])
def test_constant_mirror_breaks_are_caught(tmp_path, src_name, const, value):
    """Each mirrored constant, changed in the source alone, is reported
    on its line."""
    with open(os.path.join(CSRC, src_name)) as f:
        text = f.read()
    decl = f"constexpr int {const} = {value};"
    assert text.count(decl) == 1
    line = text[:text.index(decl)].count("\n") + 2
    changed = text.replace(decl, f"constexpr int {const} = {2 * value};")
    assert _cu_hits(tmp_path, src_name, changed, ["RA405"]) == \
        [("RA405", line)]


def test_mirror_table_is_the_six_pairs_the_tests_assert():
    from repro_torch.kernels import limits
    pairs = {(src, c, n) for src, ps in
             RA405CudaConstantsMirrorLimits.MIRRORS.items() for c, n in ps}
    assert pairs == {
        ("rotseq_wave", "kBand", "WAVE_KB"),
        ("rotseq_wave", "kWarps", "WAVE_WARPS"),
        ("rotseq_mxu", "kRows", "MXU_ROWS"),
        ("rotseq_mxu", "kSlab", "MXU_SLAB"),
        ("rotseq_mxu_half", "kRows", "MXU_HALF_ROWS"),
        ("rotseq_mxu_half", "kChunk", "MXU_HALF_CHUNK"),
        ("rotseq_mxu_half", "kCluster", "MXU_HALF_CLUSTER"),
        ("rotseq_mxu_half", "kStages", "MXU_HALF_STAGES"),
        ("rotseq_mxu_half", "kVec", "MXU_HALF_VEC"),
        ("rotseq_batched", "kBand", "BATCHED_KB"),
        ("rotseq_batched", "kThreads", "BATCHED_M_BLK")}
    for src, const, name in pairs:
        with open(os.path.join(CSRC, src + ".cu")) as f:
            cu = CudaSource(f.name, f.read(), f"src/repro_torch/csrc/{src}.cu")
        assert re.search(rf"^constexpr int {const} = {getattr(limits, name)};",
                         cu.code, re.M), (src, const)


def test_comment_stripping_keeps_lines_and_strings():
    text = ('int a; // fmaf(x)\n/* one\n fmaf(y) */ int b;\n'
            'const char* s = "// not a comment";\n')
    cu = CudaSource("x.cu", text, "src/repro_torch/csrc/x.cu")
    assert cu.code.count("\n") == text.count("\n")
    assert "fmaf" not in cu.code and "int b;" in cu.code
    assert '"// not a comment"' in cu.code
    assert cu.line_of(cu.code.index("int b")) == 3


# --------------------------------------------------------------------------
# (e) baseline and mtime cache
# --------------------------------------------------------------------------

def test_baseline_roundtrip_grandfathers_by_content_not_line(
        tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_LINT_CACHE", "off")
    path = fixture("ra403_budget_copy.py")
    vs = analyze_file(path, rules_matching(["RA403"]), explicit=True)
    assert len(vs) == 3
    bl = tmp_path / "baseline.json"
    write_baseline(vs, str(bl))
    entries = load_baseline(str(bl))
    assert entries == {baseline_key(v) for v in vs}
    assert not any(f"::{v.line}::" in k for v in vs for k in entries)
    assert load_baseline(str(tmp_path / "missing.json")) == set()
    # the CLI honours it: exit 0 with it, 1 without it
    for extra, rc in (([], 0), (["--no-baseline"], 1)):
        assert cli.main(["--baseline", str(bl), "--rules", "RA403", path]
                        + extra) == rc


def test_cache_hits_and_invalidates_on_edit(tmp_path, monkeypatch):
    cache = tmp_path / "lint_cache.json"
    monkeypatch.setenv("REPRO_TORCH_LINT_CACHE", str(cache))
    target = tmp_path / "mod.py"
    target.write_text(f"# {PORT_PRAGMA} fixture-as=src/repro_torch/core/"
                      f"tmp_mod.py\n_SMEM_PANEL_BUDGET = 1\n")
    rules = rules_matching(["RA403"])

    first = analyze_paths([str(target)], rules, explicit_fixtures=True)
    assert [v.rule for v in first] == ["RA403"]
    assert cache.exists()
    payload = json.loads(cache.read_text())
    assert list(payload["files"]) == [str(target)]

    # a warm hit answers from the cache: make analysis fail loudly
    monkeypatch.setattr(engine, "analyze_file", None)
    second = analyze_paths([str(target)], rules, explicit_fixtures=True)
    assert [(v.rule, v.line) for v in second] == \
        [(v.rule, v.line) for v in first]
    monkeypatch.undo()
    monkeypatch.setenv("REPRO_TORCH_LINT_CACHE", str(cache))

    # edit the file (mtime and size change): the violation goes
    target.write_text(f"# {PORT_PRAGMA} fixture-as=src/repro_torch/core/"
                      f"tmp_mod.py\nfrom repro_torch.kernels.limits import "
                      f"SMEM_PER_BLOCK\n")
    os.utime(target, (os.path.getmtime(target) + 5,) * 2)
    assert analyze_paths([str(target)], rules, explicit_fixtures=True) == []


def test_cache_off_and_default_location(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_LINT_CACHE", "off")
    assert engine._cache_path() is None
    vs = analyze_paths([fixture("ra403_budget_copy.py")],
                       rules_matching(["RA403"]), explicit_fixtures=True)
    assert [v.rule for v in vs] == ["RA403"] * 3
    monkeypatch.delenv("REPRO_TORCH_LINT_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert engine._cache_path() == str(tmp_path / "repro_torch" /
                                       "lint_cache.json")


# --------------------------------------------------------------------------
# (d) CLI
# --------------------------------------------------------------------------

def test_cli_module_exit_codes():
    """``python -m repro_torch.analysis``: 1 on a fixture's violation, 2 on
    an unknown selector (one process each)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_LINT_CACHE="off")

    def run(*argv):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *argv],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)

    res = run(os.path.join("tests", "torch_analysis", "analysis_fixtures",
                           "ra201_aliased_import.py"))
    assert res.returncode == 1, res.stdout + res.stderr
    assert res.stdout.count("RA201") == 2
    assert run("--rules", "RA9").returncode == 2


def test_cli_exit_zero_on_a_clean_file(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_LINT_CACHE", "off")
    assert cli.main([fixture("clean_module.py")]) == 0
    assert "0 violations" in capsys.readouterr().out


def test_cli_json_output(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_LINT_CACHE", "off")
    assert cli.main(["--json", fixture("ra403_budget_copy.py")]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert set(payload) == {"violations", "grandfathered"}
    assert [v["rule"] for v in payload["violations"]] == ["RA403"] * 3
    assert set(payload["violations"][0]) == {"rule", "path", "line",
                                             "message"}
    assert payload["violations"][0]["path"] == \
        "src/repro_torch/core/bad_budget.py"


def test_cli_list_rules_names_every_family_and_reference_rule(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    rows = re.findall(r"^(RA\d+)  ", out, re.M)
    assert rows == sorted(rows)
    assert set(rows) == {r.id for r in all_rules()} | set(NO_COUNTERPART)
    assert {r.id for r in ref_all_rules()} <= set(rows)
    for family in ("RA1", "RA2", "RA3", "RA4", "RA5"):
        assert any(r.startswith(family) for r in rows)
    for rid in NO_COUNTERPART:
        assert f"{rid}  no counterpart" in out
    assert "[python, cuda]" in out


# --------------------------------------------------------------------------
# (f) the gate: the port's tree is clean
# --------------------------------------------------------------------------

def test_default_roots_cover_the_port():
    files = {os.path.relpath(f, ROOT)
             for f in engine.iter_source_files(default_roots())}
    for rel in ("src/repro_torch/analysis/rules.py",
                "src/repro_torch/compat.py",
                "src/repro_torch/csrc/rotseq_wave.cu", "chip_smoke.py",
                "tools/autotune_flush.py", "tools/rope_bench.py",
                "tests/test_torch_analysis.py"):
        assert rel in files, rel
    assert not any("analysis_fixtures" in f or f.startswith("src/repro/")
                   for f in files)
    assert not any(f.startswith("tests/test_analysis") for f in files)


def test_whole_tree_has_zero_nonbaselined_violations():
    baseline = load_baseline()
    assert len(baseline) == 0
    vs = [v for v in analyze_paths(default_roots(), all_rules(),
                                   use_cache=False)
          if baseline_key(v) not in baseline]
    assert vs == [], "\n".join(v.format() for v in vs)
