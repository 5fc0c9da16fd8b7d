#!/usr/bin/env python3
"""Time the fused RoPE path of one source tree on one NVIDIA card.

    python3 tools/rope_bench.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so that the same measurement runs on another commit's tree unpacked
with ``git archive``, and measures it with ``chip_smoke.py``'s helpers:
the RoPE kernel's device time a launch by CUPTI at every shape of
``ROPE_SHAPES`` in float32 and bfloat16 (each held bit for bit to the
plain version), the launch floor (a one-element ``add_`` in the same
profiler window), the host microseconds of a wrapper call at the decode
shape, and SmolLM-135M's decode through ``ServeEngine``: ms a step,
device ms a step and its idle share, device launches a step,
``rope_tables`` calls a step and tokens per second.  Prints the card's
name and power limit, then one JSON line.  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch to measure")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rope_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.rope import kernel as rope_k
    from repro_torch.kernels.rope.ref import apply_rope_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    cases, bitwise = [], {}
    for label in cs.ROPE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{label}/{str(dtype).split('.')[-1]}"
            q, k, c, s = cs.rope_inputs(dev, label, dtype, gen)
            oq, ok = rope_k.rope(q, k, c, s)
            bitwise[key] = bool(torch.equal(oq, apply_rope_ref(q, c, s))
                                and torch.equal(ok, apply_rope_ref(k, c, s)))
            cases.append((key, lambda q=q, k=k, c=c, s=s:
                          rope_k.rope(q, k, c, s)))
            if key == "decode/bfloat16":
                host = cs.host_us(lambda: rope_k.rope(q, k, c, s),
                                  cs.ROPE_HOST_CALLS)
    dev_us = cs.device_us(cases, lambda key: cs.rope_reps(key.split("/")[0]))
    del cases
    torch.cuda.empty_cache()
    lm = cs.lm_decode_numbers(dev, {"rope": rope_k})["row"]
    print(json.dumps(dict(
        src=str(Path(args.src).resolve()), bitwise=bitwise,
        device_us=dev_us, host_us_per_call_decode_bf16=min(host),
        host_us_rounds=host,
        path_launches=getattr(rope_k, "PATH_LAUNCHES", None),
        lm_serving={key: lm[key] for key in (
            "decode_steps", "tokens_per_s", "ms_per_step", "ms_per_step_runs",
            "host_cpu_ms_per_step", "host_cpu_ms_per_step_runs",
            "device_ms_per_step", "device_idle_share",
            "device_launches_per_step", "rope_launches_per_step",
            "rope_tables_calls_per_step", "warm_up_rope_tables_by_step",
            "first_outputs")},
        rope_device_ms_per_step=lm["profile"]["rope_device_ms_per_step"])),
        flush=True)
    return 0 if all(bitwise.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
