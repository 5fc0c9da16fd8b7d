#!/usr/bin/env python3
"""Autotune at the eig flush ``(1024, 1024, 32)`` against the plans timed
alone, on one NVIDIA card.

    python3 tools/autotune_flush.py [--src DIR] [--trials N] [--seed S]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``;
another commit's tree unpacked with ``git archive`` works too) and
``chip_smoke.py`` from this checkout, and runs ``chip_smoke.py``'s
autotune point for the eig flush (32 seeded random waves on a ``1024²``
identity, every kernel plan a candidate) ``N`` times in one process,
each on a cleared plan cache.  For each trial it prints autotune's own
``cuda_mxu`` 64/32 over ``cuda_wave`` ratio (its measurement: 20 ms of
turns a candidate through the backend), the pick, the same ratio timed
alone through ``plan.apply`` just after (1 s of turns, the check's
timing), the seconds autotune took, and whether the point's checks
held; then the card's name and power limit.  ``--samples FILE`` also
writes every timed call of each trial (autotune's rounds and the check's)
to a JSON file.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch to measure")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--samples", default=None,
                    help="write every timed call of each trial (autotune's"
                    " and the check's, seconds and ms) to this JSON file")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("autotune_flush: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import RotationSequence
    from repro_torch.core import registry
    from repro_torch.kernels import _build
    from repro_torch.kernels.rotseq import kernel as wave_k
    from repro_torch.kernels.rotseq_batched import kernel as batched_k
    from repro_torch.kernels.rotseq_mxu import kernel as mxu_k
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    failed = []
    cs.check = lambda cond, what: None if cond else failed.append(what)
    dev = torch.device("cuda")
    th = np.random.default_rng(args.seed).uniform(
        0.0, 2.0 * np.pi, (cs.EIG_N - 1, cs.EIG_K_DELAY))
    seq = RotationSequence(torch.from_numpy(np.cos(th)).float().to(dev),
                           torch.from_numpy(np.sin(th)).float().to(dev))
    X = torch.eye(cs.EIG_N, device=dev)
    kernels = {"rotseq_wave": wave_k, "rotseq_mxu": mxu_k,
               "rotseq_batched": batched_k}
    trials, samples = [], []
    if args.samples:
        # every timed call: autotune's (through registry._time_samples)
        # and the check's (chip_smoke.alone_ms, the same rounds, kept)
        orig_samples, orig_alone = registry._time_samples, cs.alone_ms

        def time_samples(fns, device):
            ts = orig_samples(fns, device)
            samples[-1]["autotune"].append(ts)
            return ts

        def alone_ms(fns, seconds=cs.ALONE_SECONDS):
            import random
            import statistics
            first = {name: cs.time_ms(fn, 1) for name, fn in fns.items()}
            rounds = max(5, min(cs.ALONE_MAX_ROUNDS, int(
                seconds * 1e3 / sum(first.values()))))
            ts = {name: [] for name in fns}
            names = list(fns)
            order = random.Random(cs.SEED)
            for _ in range(rounds):
                order.shuffle(names)
                for name in names:
                    ts[name].append(cs.time_ms(fns[name], 1, warm=False))
            samples[-1]["alone"] = ts
            return {name: statistics.median(t) for name, t in ts.items()}

        registry._time_samples, cs.alone_ms = time_samples, alone_ms
    with tempfile.TemporaryDirectory(prefix="autotune_flush_") as tmp:
        os.environ["REPRO_PLAN_CACHE"] = os.path.join(tmp, "plans.json")
        for _ in range(args.trials):
            registry.clear_plan_cache()
            model = registry.select_plan(**cs.plan_problem(seq, X, None))
            registry.clear_plan_cache()
            before = len(failed)
            samples.append({"autotune": [], "alone": {}})
            with cs.measured_candidates() as seen:
                row = cs.autotune_point("eig flush", seq, X, None, model,
                                        kernels, seen)
            tuned = {(c["method"], c["tiles"].get("n_b")): c["ms"]
                     for c in row["candidates"]}
            alone = row["apply_ms_alone"]
            trials.append(dict(
                tune_mxu_over_wave=tuned[("cuda_mxu", 64)]
                / tuned[("cuda_wave", None)],
                pick=row["pick"]["method"],
                alone_mxu_over_wave=alone["cuda_mxu"] / alone["cuda_wave"],
                pick_vs_fastest_kernel=row["pick_vs_fastest_kernel"],
                autotune_s=row["autotune_s"],
                checks_held=len(failed) == before))
            samples[-1]["candidates"] = [
                (c["method"], c["tiles"]) for c in row["candidates"]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(dict(src=args.src, trials=trials)))
    if args.samples:
        with open(args.samples, "w") as f:
            json.dump(dict(nvidia_smi=smi, trials=samples), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
