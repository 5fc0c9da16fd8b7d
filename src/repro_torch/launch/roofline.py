"""Roofline analysis over the dry run's records: the port's counterpart of
``repro.launch.roofline``, reading ``experiments/dryrun_torch/``.

Per (arch x shape) cell on one mesh, the three terms of a step on one
device, from the per-device counts of
:mod:`repro_torch.launch.step_analysis`, priced by the port's H100
record (``repro_torch.hw.PLATFORMS["cuda"]``):

  compute    = dot_flops / tc_bf16_flops + (flops - dot_flops) / vpu_flops
  memory     = sqrt(bytes * bytes_lo) / hbm_bw
  collective = wire_bytes / link_bw

``bytes`` is the fusion-blind upper bound (operands and results of every
op), ``bytes_lo`` the fusion-perfect lower bound (results only); the
memory term takes their geometric mean, as the reference does.  Wire
bytes apply the reference's ring factors to each kind's result bytes:
all-gather and reduce-scatter ``(D-1)/D``, all-reduce ``2(D-1)/D``,
all-to-all ``(D-1)/D``, collective-permute 1, with ``D`` the TP width
(16) for every collective, the reference's documented approximation.

``link_bw`` is NVLink's 450 GB/s each way.  That leaves out the mesh's
shape on real machines: a 16-wide ``model`` axis spans two 8-GPU nodes,
so part of its traffic crosses the network between nodes, far slower
than NVLink, and the collective term is a lower bound on a real 256-card
mesh.

Also reports MODEL_FLOPS = 6*N*D_tokens (train) / 2*N_active*D
(decode/prefill), the useful-compute ratio MODEL/dot, the dominant term,
and the roofline fraction = MODEL_FLOPS / (chips * tc_bf16_flops) /
max(term).

Usage: ``python -m repro_torch.launch.roofline [--mesh single]
[--markdown] [--out FILE.md]``
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.hw import PLATFORMS

__all__ = ["PARAMS", "model_flops", "coll_seconds", "analyze", "main"]

_HW = PLATFORMS["cuda"]
PEAK_FLOPS = _HW.tc_bf16_flops   # dense bf16 on the tensor cores
VPU_FLOPS = _HW.vpu_flops        # float32 outside the tensor cores
HBM_BW = _HW.hbm_bw
LINK_BW = _HW.link_bw            # NVLink, each way

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")

# total params and active params per arch (the reference's table:
# active = dense-equivalent params touched per token for MoE)
PARAMS = {
    "starcoder2-3b": (3.030e9, 3.030e9),
    "smollm-135m": (0.135e9, 0.135e9),
    "llama3-405b": (405.9e9, 405.9e9),
    "gemma3-4b": (3.880e9, 3.880e9),
    "recurrentgemma-9b": (9.396e9, 9.396e9),
    "chameleon-34b": (34.29e9, 34.29e9),
    "deepseek-v2-lite-16b": (15.71e9, 2.66e9),
    "kimi-k2-1t-a32b": (1028.3e9, 32.4e9),
    "mamba2-370m": (0.368e9, 0.368e9),
    "whisper-large-v3": (1.535e9, 1.535e9),
}

SHAPE_DIMS = {"train_4k": (4096, 256), "prefill_32k": (32768, 32),
              "decode_32k": (32768, 128), "long_500k": (524288, 1)}


def model_flops(arch: str, kind: str, seq: int, batch: int,
                dec_len: int = 448) -> float:
    _, n_active = PARAMS[arch]
    if kind == "train":
        tokens = seq * batch
        if arch == "whisper-large-v3":
            tokens = (seq + min(dec_len, seq)) * batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    # decode: one token per sequence
    return 2.0 * n_active * batch


def coll_seconds(coll: dict, chips: int, tp: int = 16) -> float:
    """Ring-model collective time per device (seconds)."""
    f = (tp - 1) / tp
    t = 0.0
    t += coll.get("all-gather", 0) * f
    t += coll.get("reduce-scatter", 0) * f
    t += coll.get("all-reduce", 0) * 2 * f
    t += coll.get("all-to-all", 0) * f
    t += coll.get("collective-permute", 0)
    return t / LINK_BW


def analyze(rec: dict, dims=None) -> dict:
    """The three terms of a record (per device), its dominant term and
    roofline fraction; ``dims`` ``(seq, batch)`` for a shape outside
    :data:`SHAPE_DIMS`."""
    chips = rec["chips"]
    hc = rec["hlo_cost"]
    flops_dev = hc["flops_per_device"]
    dot_dev = hc["dot_flops_per_device"]
    compute_s = dot_dev / PEAK_FLOPS + (flops_dev - dot_dev) / VPU_FLOPS
    b_hi = hc["bytes_per_device"]
    b_lo = hc["bytes_lo_per_device"]
    memory_s = (b_hi * max(b_lo, 1)) ** 0.5 / HBM_BW
    coll_s = coll_seconds(hc["collective_bytes_per_device"], chips)
    seq, batch = dims or SHAPE_DIMS[rec["shape"]]
    mf = model_flops(rec["arch"], rec["kind"], seq, batch)
    ideal_s = mf / (chips * PEAK_FLOPS)
    bound_s = max(compute_s, memory_s, coll_s)
    dominant = ("compute" if bound_s == compute_s
                else "memory" if bound_s == memory_s else "collective")
    mem = rec["memory"]
    return {
        "cell": rec["cell"],
        "dot_flops_global": dot_dev * chips,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": flops_dev * chips,
        "useful_ratio": mf / max(dot_dev * chips, 1),
        "roofline_fraction": ideal_s / max(bound_s, 1e-30),
        "mem_gib": (mem["argument_bytes"] + mem["temp_bytes"]
                    + mem["output_bytes"] - mem["alias_bytes"]) / 2**30,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    rows = []
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or rec.get("mesh") != args.mesh:
            continue
        rows.append(analyze(rec))

    hdr = ("| cell | compute s | memory s | collective s | dominant | "
           "useful FLOP ratio | roofline frac | GiB/chip |")
    sep = "|" + "---|" * 8
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['cell']} | {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2%} "
            f"| {r['mem_gib']:.1f} |")
    text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        with open(args.out.replace(".md", ".json"), "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
