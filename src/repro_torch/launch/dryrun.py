"""Multi-pod dry run: every (arch x shape x mesh) cell's step on the meta
device, counted per device: the port's counterpart of
``repro.launch.dryrun``.

For every cell this module:
  1. initialises torch's ``fake`` process group of 256 (single pod) or
     512 (multi pod) ranks (``FakeStore`` of
     ``torch.testing._internal.distributed.fake_pg``, a private module of
     torch's tests: no process, no communication) and builds the
     production ``(16, 16)`` or ``(2, 16, 16)`` mesh and its rules
     (sequence parallelism on, as in the reference),
  2. builds the model on ``meta`` and places the parameters (the
     reference's stacked tree: ``cfg.param_dtype`` to train, bf16 to
     serve), the optimizer state (``AdamW(quantized=cfg.dryrun_q8)``),
     the batch and the decode cache as rank 0's ``meta`` shards of
     ``DTensor``s, by ``launch.specs.sharding_trees``,
  3. runs the step once (``make_train_step(grad_accum=
     cfg.dryrun_grad_accum)`` for training, the forward for prefill,
     ``decode_step`` over the cache for decode) under
     :func:`repro_torch.launch.step_analysis.trace_step`, with
     ``CommDebugMode`` beside it to cross-check the collective counts
     (not under grad accumulation, which its module tracker fails on):
     nothing is allocated and nothing is lowered,
  4. writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
     (cached: re-runs skip completed cells) and tears the group down, so
     a sweep runs in one process.

The record has the reference's keys, the cost under ``hlo_cost`` (the
port's is :class:`~repro_torch.launch.step_analysis.StepCost`), the time
it took as ``trace_s``, and ``fits``: the peak ``argument + temp +
output - alias`` against the H100 record's ``hbm_bytes``.  Memory is
per device: ``argument_bytes`` the placed arguments exactly,
``output_bytes`` the step's outputs, ``temp_bytes`` the peak of the
storages the step creates less the outputs it returns, and
``allocator_rounding_bytes`` what the CUDA caching allocator's 512-byte
blocks add to that peak (not counted in ``fits``).  The port's
optimizer update is out of place where the reference donates its
buffers, so a train step's old and new state are both live at its peak
(``alias_bytes`` 0); a decode step writes its cache in place, which is
counted as aliased.

Usage::

  python -m repro_torch.launch.dryrun                       # full sweep
  python -m repro_torch.launch.dryrun --arch smollm-135m    # one arch
  python -m repro_torch.launch.dryrun --arch X --shape train_4k --mesh multi
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

import torch
from torch.func import functional_call

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_skips
from repro_torch.hw import PLATFORMS
from repro_torch.launch.step_analysis import trace_step
from repro_torch.launch.specs import (abstract_cache, abstract_params,
                                      input_specs, sharding_trees)
from repro_torch.models import attention, build_model
from repro_torch.optim import AdamW
from repro_torch.parallel.sharding import axis_rules
from repro_torch.train import make_train_step
from repro_torch.train.step import _Method, _weights
from repro_torch.tree import leaves, map_tree

__all__ = ["run_cell", "step_record", "cell_step", "cell_args", "measure",
           "place_tree", "OUT_DIR", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
WORLD = {"single": 256, "multi": 512}


def _placed(x, sharding):
    """Rank 0's ``meta`` shard of ``x`` as a ``DTensor`` placed by
    ``sharding`` (a ``NamedSharding``); a leaf that is not a tensor as
    it is."""
    if not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.compat import compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(
        x.shape, sharding.mesh, sharding.placements)
    return DTensor.from_local(
        torch.empty(local, dtype=x.dtype, device="meta"), sharding.mesh,
        sharding.placements, run_check=False, shape=x.shape,
        stride=x.stride())


def place_tree(tree, shardings):
    """``tree``'s meta tensors as rank 0's shards (:func:`_placed`)."""
    return map_tree(_placed, tree, shardings)


def cell_step(model, cfg, kind: str, *, optimizer=None, remat: bool = True,
              grad_accum: int = 1, grad_shardings=None):
    """The step of a cell: ``(params, opt_state, batch)`` for ``train``,
    ``(params, batch)`` for ``prefill``, ``(params, cache, batch)`` for
    ``decode``; ``params`` is the reference's stacked tree."""
    if kind == "train":
        return make_train_step(model, cfg, optimizer, remat=remat,
                               grad_accum=grad_accum,
                               grad_shardings=grad_shardings)
    if kind == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            args = ((batch["frames"], batch["dec_tokens"]) if cfg.is_encdec
                    else (batch["tokens"],))
            return functional_call(model, _weights(cfg, params), args)
        return prefill
    method = _Method(model, "decode_step")

    # no_grad, not make_serve_step's inference_mode: DTensor's dispatch
    # refuses inference tensors
    @torch.no_grad()
    def decode(params, cache, batch):
        return functional_call(method, _weights(cfg, params, "model."),
                               (cache, batch["tokens"]))
    return decode


def cell_args(model, cfg, shape, *, optimizer=None, param_dtype=None,
              cache_dtype=torch.bfloat16):
    """The step's abstract arguments as meta tensors: the parameter tree
    in ``param_dtype`` (float32 leaves cast; default ``cfg.param_dtype``
    to train, bf16 to serve), the optimizer's state, the batch, the
    decode cache in ``cache_dtype``."""
    if param_dtype is None:
        param_dtype = (getattr(torch, cfg.param_dtype)
                       if shape.kind == "train" else torch.bfloat16)
    params = map_tree(lambda x: x.to(param_dtype)
                      if x.dtype == torch.float32 else x,
                      abstract_params(model))
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        return params, optimizer.init(params), batch
    if shape.kind == "prefill":
        return params, batch
    return params, abstract_cache(model, cfg, shape, dtype=cache_dtype), batch


def _storages(tree) -> dict:
    """``{storage key: bytes}`` of the (local) tensors of a tree."""
    from torch.distributed.tensor import DTensor
    out = {}
    for x in leaves(tree):
        if isinstance(x, DTensor):
            x = x._local_tensor
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def measure(step, args) -> dict:
    """Run ``step(*args)`` once under the step analysis, from an empty
    RoPE table cache (the tables are built inside the counted step, on
    the card as on ``meta``): the record's ``memory`` (per device),
    ``hlo_cost`` and ``trace_s``."""
    attention._ROPE.clear()
    tr = trace_step(step, *args)
    arg = _storages(args)
    out = _storages(tr.out)
    alias = sum(n for k, n in out.items() if k in arg)
    output = sum(out.values())
    memory = {"argument_bytes": sum(arg.values()), "output_bytes": output,
              "temp_bytes": max(tr.peak_bytes - (output - alias), 0),
              "alias_bytes": alias,
              "allocator_rounding_bytes": tr.peak_blocks - tr.peak_bytes}
    c = tr.cost
    return {"memory": memory, "hlo_cost": {
        "flops_per_device": c.flops,
        "dot_flops_per_device": c.dot_flops,
        "bytes_per_device": c.bytes,
        "bytes_lo_per_device": c.bytes_lo,
        "transcendentals": c.transcendentals,
        "collective_bytes_per_device": dict(c.collective_bytes),
        "collective_counts": dict(c.collective_counts)},
        "trace_s": tr.seconds}


def fits(memory: dict) -> dict:
    """The record's peak against the card's memory."""
    peak = (memory["argument_bytes"] + memory["temp_bytes"]
            + memory["output_bytes"] - memory["alias_bytes"])
    hbm = PLATFORMS["cuda"].hbm_bytes
    return {"peak_bytes": peak, "hbm_bytes": hbm, "fits": peak <= hbm}


def step_record(cfg, shape, *, mesh=None, rules=None, optimizer=None,
                remat: bool = True, grad_accum: int = 1, param_dtype=None,
                cache_dtype=torch.bfloat16) -> dict:
    """:func:`measure` of a cell's step on ``meta``, placed on ``mesh``
    by ``rules`` when given (inside ``axis_rules``), else unplaced; the
    record's ``memory``, ``hlo_cost``, ``trace_s``, ``fits`` and, under
    a mesh, ``comm_debug_counts`` (``CommDebugMode``'s; ``None`` with
    ``grad_accum > 1``, where its module tracker fails)."""
    from torch.distributed.tensor.debug import CommDebugMode
    model = build_model(cfg, device="meta")
    args = cell_args(model, cfg, shape, optimizer=optimizer,
                     param_dtype=param_dtype, cache_dtype=cache_dtype)
    if mesh is None:
        step = cell_step(model, cfg, shape.kind, optimizer=optimizer,
                         remat=remat, grad_accum=grad_accum)
        rec = measure(step, args)
    else:
        with axis_rules(rules, mesh):
            trees = sharding_trees(model, cfg, shape, optimizer, rules, mesh)
            names = {"train": ("params", None, "batch"),
                     "prefill": ("params", "batch"),
                     "decode": ("params", "cache", "batch")}[shape.kind]
            args = [a if n is None else place_tree(a, trees[n])
                    for a, n in zip(args, names)]
            if shape.kind == "train":
                # the moments follow their placed parameters; the step
                # count stays a host scalar, as without a mesh
                args[1] = optimizer.init(args[0])
            step = cell_step(model, cfg, shape.kind, optimizer=optimizer,
                             remat=remat, grad_accum=grad_accum,
                             grad_shardings=trees["params"])
            if grad_accum > 1:
                # CommDebugMode's module tracker fails on a module's
                # second forward in one context (IndexError)
                rec, counts = measure(step, args), None
            else:
                comm = CommDebugMode()
                with comm:
                    rec = measure(step, args)
                counts = {str(k).split(".")[-1]: v
                          for k, v in comm.get_comm_counts().items()}
        rec["comm_debug_counts"] = counts
    rec["fits"] = fits(rec["memory"])
    return rec


def _fake_world(size: int) -> None:
    import torch.distributed as dist

    from repro_torch.compat import fake_store
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=size)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             force: bool = False, seq_parallel=None) -> dict:
    import torch.distributed as dist

    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_rules_for_mesh)
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    path = os.path.join(OUT_DIR, tag + ".json")
    if os.path.exists(path) and not force:
        print(f"[skip cached] {tag}")
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = shape_skips(cfg, shape)
    if skip:
        rec = {"cell": tag, "status": "skipped", "reason": skip}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip] {tag}: {skip}")
        return rec

    # sequence/context parallelism is on by default, as in the reference
    sp = True if seq_parallel is None else seq_parallel
    _fake_world(WORLD[mesh_kind])
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type="cpu")
        rules = make_rules_for_mesh(mesh, seq_parallel=sp)
        grad_accum = cfg.dryrun_grad_accum if shape.kind == "train" else 1
        body = step_record(cfg, shape, mesh=mesh, rules=rules,
                           optimizer=AdamW(lr=1e-4,
                                           quantized=cfg.dryrun_q8),
                           grad_accum=grad_accum)
        chips = int(mesh.size())
    finally:
        dist.destroy_process_group()
    rec = {"cell": tag, "status": "ok", "arch": arch, "shape": shape_name,
           "mesh": mesh_kind, "chips": chips, "kind": shape.kind,
           "seq_parallel": sp, "grad_accum": grad_accum,
           "trace_s": round(body["trace_s"], 1), "memory": body["memory"],
           "fits": body["fits"], "hlo_cost": body["hlo_cost"],
           "comm_debug_counts": body["comm_debug_counts"]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[ok] {tag}: trace {rec['trace_s']:.0f}s "
          f"mem/device ~{rec['fits']['peak_bytes'] / 2**30:.2f} GiB "
          f"(fits {rec['fits']['fits']}) "
          f"flops/device {rec['hlo_cost']['flops_per_device']:.3e}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single",
                                                     "multi"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                try:
                    run_cell(arch, shape, mesh_kind, force=args.force)
                except Exception:
                    failures.append(f"{arch}__{shape}__{mesh_kind}")
                    print(f"[FAIL] {arch}__{shape}__{mesh_kind}")
                    traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run sweep complete")


if __name__ == "__main__":
    main()
