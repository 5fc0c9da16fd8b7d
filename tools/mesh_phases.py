#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s RoPE lines and its two phases under a mesh
alone, on one NVIDIA card.

    python3 tools/mesh_phases.py [rope] [mesh_train] [mesh_families]

Builds the kernels, then runs the named phases (all three by default):
``rope`` (``rope_phase`` and ``rope_backward_phase``: every
``ROPE_SHAPES`` case held bit for bit to its plain version, forward and
backward), ``mesh_train`` (SmolLM-135M's step on the ``(1, 1)`` mesh of
a one-rank NCCL group against the step without it) and
``mesh_families`` (every other family's, each at full width with its
depth cut).  Each prints ``chip_smoke.py``'s JSON line.  A failed check
is printed as ``CHECK FAILED: ...`` and the run goes on, so that one
call reports every family; the exit code is 1 if any check failed.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("rope", "mesh_train", "mesh_families")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device", file=sys.stderr)
        return 1
    only = argv or list(PHASES)
    unknown = set(only) - set(PHASES)
    if unknown:
        print(f"mesh_phases: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.rope import kernel as rope_k
    from repro_torch.kernels.rotseq import kernel as wave_k
    from repro_torch.kernels.rotseq_batched import kernel as batched_k
    from repro_torch.kernels.rotseq_mxu import kernel as mxu_k
    from repro_torch.obs import timing
    cs.timing = timing
    failed = []

    def keep_going(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)
            print("CHECK FAILED:", what, flush=True)

    cs.check = keep_going
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = timing.now()
    with tempfile.TemporaryDirectory(prefix="mesh_phases_") as tmp:
        os.environ["REPRO_PLAN_CACHE"] = os.path.join(tmp, "plans.json")
        os.environ["CHIP_SMOKE_TMP"] = tmp
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi, torch.__version__, flush=True)
        _build.build()
        print("build s", timing.now() - t0, flush=True)
        dev = torch.device("cuda", 0)
        kernels = {"rotseq_wave": wave_k, "rotseq_mxu": mxu_k,
                   "rotseq_batched": batched_k, "rope": rope_k}
        if "rope" in only:
            rows = cs.rope_phase(dev)["rows"]
            cs.rope_backward_phase(dev, rows)
        if "mesh_train" in only:
            cs.mesh_train_phase(dev, kernels)
        if "mesh_families" in only:
            cs.mesh_families_phase(dev, kernels, smi)
    print("mesh_phases s", timing.now() - t0, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
