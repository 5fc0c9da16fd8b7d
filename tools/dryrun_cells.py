#!/usr/bin/env python3
"""The dry run's records as a markdown table, one row a cell.

    python3 tools/dryrun_cells.py [--dir DIR] [ARCH ...]

Reads the records ``python -m repro_torch.launch.dryrun`` wrote to
``DIR`` (default ``experiments/dryrun_torch``) of the given archs (all
by default) and prints, for each ``ok`` cell, the per-device peak GiB
(``argument + temp + output - alias``), whether it fits the H100 record's
memory, the per-device dot flops and the collective counts by kind; then
a count of the cells by status.  Host arithmetic on the meta device, not
a measurement.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rows(directory: str, archs) -> tuple:
    status = collections.Counter()
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        arch = os.path.basename(path).split("__")[0]
        if archs and arch not in archs:
            continue
        status[rec["status"]] += 1
        if rec["status"] != "ok":
            continue
        counts = rec["hlo_cost"]["collective_counts"]
        out.append("| {} | {:.2f} | {} | {:.4e} | {} |".format(
            rec["cell"], rec["fits"]["peak_bytes"] / 2**30,
            rec["fits"]["fits"], rec["hlo_cost"]["dot_flops_per_device"],
            ", ".join(f"{k} {int(v)}" for k, v in sorted(counts.items()))))
    return out, status


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(ROOT / "experiments" /
                                         "dryrun_torch"))
    ap.add_argument("archs", nargs="*")
    args = ap.parse_args()
    table, status = rows(args.dir, set(args.archs))
    print("| cell | peak GiB/device | fits | dot flops/device | "
          "collectives (count) |")
    print("|---|---|---|---|---|")
    print("\n".join(table))
    print(dict(sorted(status.items())))


if __name__ == "__main__":
    main()
