#!/usr/bin/env python3
"""Count the machine instructions of the port's CUDA kernels by opcode.

    python3 tools/sass_ops.py [REGEX]

Builds the kernel library (``kernels/_build.py``) if needed, disassembles
it with ``cuobjdump -sass`` and prints, for every kernel function whose
mangled name matches ``REGEX`` (default: the wavefront, fused and
half accumulated kernels' instantiations), its instruction count, the
most frequent opcodes and its conversions, paired half ops and
widenings (:func:`conversions`), one JSON line each.  The counts are of the whole
function as compiled (its unrolled chunk body included), not of what a
launch executes.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a
card.  ``chip_smoke.py`` imports :func:`functions` and
:func:`conversions` for its ``rotseq_wave_half``,
``rotseq_batched_half`` and ``rotseq_mxu_half`` lines.
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = r"rotseq_(wave|batched|mxu_half)_kernel"
# an instruction line of cuobjdump's listing: /*0a30*/ [@P0] OPCODE ...
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]+)")
# a half plane's conversions (roundings of float32 values to the half
# type, F2F and F2FP), its paired half ops (HADD2, HMUL2, HFMA2 on two
# half values, not the .F32 widening; ptxas also uses HFMA2.MMA to move
# constants) and the opcodes that widen a half value to float32: an
# integer shift, mask, multiply or byte permute (bfloat16, which count
# other integer work too), HADD2.F32 (float16)
_CONVERSION = re.compile(r"^F2FP?\b")
_PAIRED = re.compile(r"^H(ADD|MUL|FMA)2(?!\.F32)")
_WIDENING = re.compile(r"^(SHF\.L|LOP3|PRMT|IMAD\.(U32|SHL)|HADD2\.F32)")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found")


def listing(lib) -> dict:
    """``{mangled name: SASS listing}`` of every function of the shared
    library ``lib``."""
    out = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return dict((part.split("\n", 1) + [""])[:2]
                for part in re.split(r"\n\s*Function : ", out)[1:])


def functions(pattern: str = DEFAULT, lib=None) -> dict:
    """``{mangled name: Counter(opcode -> count)}`` of every kernel
    function whose name matches ``pattern``, in ``lib`` or else in the
    built library (built first if needed)."""
    if lib is None:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build
        _build.build()
        lib = _build._target()
    regex = re.compile(pattern)
    return {name.strip(): collections.Counter(_INSN.findall(body))
            for name, body in listing(lib).items() if regex.search(name)}


def conversions(ops: collections.Counter) -> dict:
    """The conversion opcodes (``F2F*``, ``F2FP*``), paired half ops and
    widening opcodes of one function, each with its count, and their
    totals."""
    out = {}
    for key, total, regex in (
            ("conversions", "conversion_total", _CONVERSION),
            ("paired_ops", "paired_total", _PAIRED),
            ("widenings", "widening_total", _WIDENING)):
        out[key] = {op: n for op, n in ops.items() if regex.match(op)}
        out[total] = sum(out[key].values())
    return out


def main() -> int:
    pattern = sys.argv[1] if len(sys.argv) > 1 else DEFAULT
    for name, ops in functions(pattern).items():
        print(json.dumps({"function": name,
                          "instructions": sum(ops.values()),
                          "top": dict(ops.most_common(16)),
                          **conversions(ops)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
