#!/usr/bin/env python3
"""Count the machine instructions of the port's CUDA kernels by opcode.

    python3 tools/sass_ops.py [REGEX]

Builds the kernel library (``kernels/_build.py``) if needed, disassembles
it with ``cuobjdump -sass`` and prints, for every kernel function whose
mangled name matches ``REGEX`` (default: the wavefront and fused
kernels' instantiations), its instruction count and the most frequent
opcodes, one JSON line each.  The counts are of the whole function as
compiled (its unrolled chunk body included), not of what a launch
executes.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card.
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
DEFAULT = r"rotseq_(wave|batched)_kernel"
# an instruction line of cuobjdump's listing: /*0a30*/ [@P0] OPCODE ...
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]+)")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    pattern = re.compile(sys.argv[1] if len(sys.argv) > 1 else DEFAULT)
    _build.build()
    listing = subprocess.run([_cuobjdump(), "-sass", str(_build._target())],
                             capture_output=True, text=True,
                             check=True).stdout
    for part in re.split(r"\n\s*Function : ", listing)[1:]:
        name = part.split("\n", 1)[0].strip()
        if not pattern.search(name):
            continue
        ops = collections.Counter(_INSN.findall(part))
        print(json.dumps({"function": name,
                          "instructions": sum(ops.values()),
                          "top": dict(ops.most_common(16))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
