#!/usr/bin/env python3
"""Find where a Mamba2 step under a ``(1, 1)`` mesh parts from the step
without it.

    python3 tools/mesh_bisect.py [--cpu]

One Mamba2-370M layer at full width (bf16 compute over float32 masters,
``chip_smoke.py``'s ``TRAIN_BATCH x TRAIN_SEQ`` tokens; 2 x 64 with
``--cpu``): the loss and gradients of one step (``_value_and_grad``)
without a mesh, twice, and under the ``(1, 1)`` ``("data", "model")``
mesh of a one-rank group (NCCL on the card, gloo with ``--cpu``),
twice.  Every output of the block's pieces (``dense``, ``rmsnorm``,
``causal_conv``, ``ssd_chunked``, the embedding, the head, the splits
and the output projection) is recorded with the gradient it receives.
Prints, for each pair of runs (each way against itself, then the two
ways), the pieces whose output or gradient differ (max |d|) and the
relative error of each parameter's gradient that is not zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    import torch
    cpu = argv == ["--cpu"]
    if not cpu and not torch.cuda.is_available():
        print("mesh_bisect: no CUDA device (try --cpu)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(cs.SRC))
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor
    import repro_torch.models.mamba2 as mamba2
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import model_batch
    from repro_torch.launch.mesh import make_rules_for_mesh
    from repro_torch.launch.specs import distribute_tree, sharding_trees
    from repro_torch.obs import timing
    from repro_torch.optim import AdamW
    from repro_torch.parallel.sharding import axis_rules
    from repro_torch.train.step import _value_and_grad
    from repro_torch.tree import flatten_with_paths
    cs.timing = timing
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    rec = []

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def record(name, out):
        for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
            if not isinstance(o, torch.Tensor):
                continue
            at = len(rec)
            rec.append([f"{name}#{i}", full(o).detach().clone(), None])
            if o.requires_grad:
                o.register_hook(lambda g, at=at: rec[at].__setitem__(
                    2, full(g).detach().clone()))

    def wrap(owner, name):
        fn = getattr(owner, name)

        def recorded(*a, **k):
            out = fn(*a, **k)
            record(name, out)
            return out
        setattr(owner, name, recorded)

    for name in ("dense", "rmsnorm", "causal_conv", "ssd_chunked"):
        wrap(mamba2, name)
    for name in ("_embed", "_logits", "_split", "_heads", "_dt", "_out"):
        wrap(mamba2.Mamba2, name)

    def max_d(a, b):
        if a is None or b is None:
            return None if a is None and b is None else "missing"
        return float((a.float() - b.float()).abs().max())

    with tempfile.TemporaryDirectory(prefix="mesh_bisect_") as tmp:
        os.environ["CHIP_SMOKE_TMP"] = tmp
        cfg = dataclasses.replace(get_config(cs.SSM_ARCH), n_layers=1)
        B, S = (2, 64) if cpu else (cs.TRAIN_BATCH, cs.TRAIN_SEQ)
        model, params = cs.train_setup(cfg, dev, cs.SEED + 31)
        _, mesh = cs.dist_mesh(dev, "bisect_store")
        try:
            rules = make_rules_for_mesh(mesh)
            trees = sharding_trees(model, cfg, ShapeConfig("bisect", S, B,
                                                           "train"),
                                   AdamW(lr=cs.TRAIN_LR), rules, mesh)
            placed = distribute_tree(params, trees["params"])
            batch = model_batch(cfg, B, S, 0)
            runs = {}
            for label in ("plain", "plain2", "mesh", "mesh2"):
                rec.clear()
                meshed = label.startswith("mesh")
                with axis_rules(rules, mesh) if meshed \
                        else contextlib.nullcontext():
                    m, g = _value_and_grad(
                        model, cfg, placed if meshed else params,
                        distribute_tree(batch, trees["batch"]) if meshed
                        else batch, False)
                runs[label] = dict(
                    rec=list(rec), loss=float(full(m["loss"])),
                    grads={p: full(x).detach().clone()
                           for p, x in flatten_with_paths(g)})
                print(label, "loss", runs[label]["loss"], flush=True)
        finally:
            tdist.destroy_process_group()
    for a, b in (("plain", "plain2"), ("mesh", "mesh2"), ("plain", "mesh")):
        print(f"{a} vs {b}: {len(runs[a]['rec'])} pieces", flush=True)
        for (name, f0, g0), (_, f1, g1) in zip(runs[a]["rec"],
                                                runs[b]["rec"]):
            df, dg = max_d(f0, f1), max_d(g0, g1)
            if df or dg:
                print(f"  {name}: output {df}, gradient {dg}")
        for path, x in runs[a]["grads"].items():
            y = runs[b]["grads"][path]
            err = float((x.double() - y.double()).norm()
                        / (x.double().norm() + 1e-30))
            if err:
                print(f"  gradient {path}: rel err {err:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
