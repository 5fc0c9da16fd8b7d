"""AST-based static invariant analyzer of the port's own sources.

Counterpart of :mod:`repro.analysis`, kept as the port's own copy.  Run
it as ``python -m repro_torch.analysis``.  See
:mod:`repro_torch.analysis.rules` for the rules (each reference rule's
counterpart, and the port's own, two of them over the CUDA sources) and
:mod:`repro_torch.analysis.engine` for the machinery (alias-resolving
import tables, comment-stripped CUDA sources, suppression pragmas,
baseline, mtime cache).
"""
from .engine import (CudaSource, ModuleInfo, Rule, Violation, analyze_file,
                     analyze_paths, baseline_key, load_baseline,
                     write_baseline)
from .rules import ALL_RULES, NO_COUNTERPART, all_rules, rules_matching

__all__ = [
    "CudaSource", "ModuleInfo", "Rule", "Violation", "analyze_file",
    "analyze_paths", "baseline_key", "load_baseline", "write_baseline",
    "ALL_RULES", "NO_COUNTERPART", "all_rules", "rules_matching",
]
