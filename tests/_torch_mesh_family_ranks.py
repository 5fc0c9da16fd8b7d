"""One gloo rank of every model family's steps under a mesh, for
``tests/test_torch_mesh_families.py``.

    python tests/_torch_mesh_family_ranks.py RANK WORLD INIT_FILE OUT_DIR [ARCH ...]

Joins a ``WORLD``-rank gloo group through the ``file://`` rendezvous
``INIT_FILE`` (every group times out after 60 s) and builds the
``("data", "model")`` mesh of ``MESH[WORLD]`` with sequence parallelism
on, as the dry run's rules have it.  For each ``ARCH`` (default
``FAMILIES``) at ``.reduced()`` (float32), from one seeded model:

* ``STEPS`` AdamW steps without a mesh and under it (parameters,
  optimizer state and batch placed by ``sharding_trees``,
  ``grad_shardings`` the parameters' shardings): the losses, the full
  gradients a step, the full parameters after the steps, and every
  gradient's placements beside its parameter's;
* the MoE family also takes its steps with AdamW's 8-bit state (the
  route Kimi-K2's dry run takes);
* a prefill (the forward) without and under the mesh: the full logits;
* one ``decode_step`` from a cache filled by ``WARM`` plain steps,
  without and under the mesh (the cache placed by ``sharding_trees``):
  the full logits and the updated cache; an encoder-decoder's cache is
  made by ``init_cache`` under the mesh too, against the plain one.

``CKPT_ARCH``'s parameters and AdamW state after the mesh steps are
saved by ``CheckpointManager`` (each rank into its own directory) and
restored onto the mesh and onto no mesh.  Mamba2 with ``GROUPS``
``B``/``C`` groups takes the train steps and the prefill too, and the
SSD once a shard runs alone at each of ``SSD_GROUPS`` with its heads
sharded over each of ``SSD_AXES``.  Saves to ``OUT_DIR/rank{RANK}.pt``.
"""
import dataclasses
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed import distributed_c10d
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.func import functional_call

from _torch_mesh_ranks import Recording, full
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import model_batch
from repro_torch.launch.dryrun import cell_step
from repro_torch.launch.mesh import make_rules_for_mesh
from repro_torch.launch.specs import distribute_tree, sharding_trees
from repro_torch.models import build_model
from repro_torch.models.mamba2 import _ssd_per_shard, ssd_chunked
from repro_torch.models.zoo import stack_params
from repro_torch.optim import AdamW
from repro_torch.parallel.sharding import (NamedSharding, axis_rules,
                                           logical_to_spec)
from repro_torch.train import make_train_step
from repro_torch.train.step import _Method, _weights
from repro_torch.tree import flatten_with_paths, map_tree

TIMEOUT = datetime.timedelta(seconds=60)
MESH = {1: (1, 1), 4: (2, 2)}
FAMILIES = ("mamba2-370m", "recurrentgemma-9b", "whisper-large-v3",
            "deepseek-v2-lite-16b")
CKPT_ARCH = "mamba2-370m"
# the SSD's B/C groups: Mamba2 with GROUPS of them, and the SSD alone
# with SSD_HEADS heads in each of SSD_GROUPS, its heads sharded over each
# of SSD_AXES (those of the heads' blocks that hold whole groups keep
# their shards; the others are replicated first)
GROUPS = 2
SSD_HEADS, SSD_GROUPS = 12, (1, 2, 3, 4)
SSD_AXES = (("model",), ("data", "model"))
BATCH, SEQ, STEPS, WARM, SEED, LR = 4, 32, 2, 3, 3, 1e-2
# Adam's eps: an element whose gradient is float noise around zero moves
# by up to |dg| / eps of a step (g / (|g| + eps)); at the default 1e-8 a
# 1e-8 difference between two reduction orders is a whole step
EPS = 1e-6


def batch_of(cfg, step: int) -> dict:
    """The train batch of ``step`` (an encoder-decoder's with seeded stub
    frames ``(BATCH, SEQ, d_model)``)."""
    return model_batch(cfg, BATCH, SEQ, step, seed=SEED)


def placements_of(tree) -> dict:
    return {path: tuple(map(str, x.placements))
            for path, x in flatten_with_paths(tree)
            if isinstance(x, DTensor)}


def train(model, cfg, params0, mesh, rules, opt):
    """``STEPS`` steps of ``opt`` without and under the mesh."""
    trees = sharding_trees(model, cfg, ShapeConfig("mesh", SEQ, BATCH,
                                                   "train"),
                           opt, rules, mesh)
    batches = [batch_of(cfg, s) for s in range(STEPS)]
    plain_rec = Recording(opt)
    plain = make_train_step(model, cfg, plain_rec)
    params, state = params0, opt.init(params0)
    losses = []
    for b in batches:
        params, state, m = plain(params, state, b)
        losses.append(float(m["loss"]))
    rec = Recording(opt)
    meshed = make_train_step(model, cfg, rec, grad_shardings=trees["params"])
    dparams = distribute_tree(params0, trees["params"])
    dstate = opt.init(dparams)
    mesh_losses = []
    with axis_rules(rules, mesh):
        for b in batches:
            dparams, dstate, m = meshed(dparams, dstate,
                                        distribute_tree(b, trees["batch"]))
            mesh_losses.append(float(full(m["loss"])))
    out = dict(losses=losses, mesh_losses=mesh_losses, params=params,
               mesh_params=map_tree(full, dparams),
               grads=plain_rec.grads, mesh_grads=rec.grads,
               placements_seen=rec.seen,
               moments=placements_of(dstate["m"]),
               placements={path: tuple(map(str, sh.placements))
                           for path, sh in flatten_with_paths(
                               trees["params"])})
    return out, (dparams, dstate, trees)


def prefill(model, cfg, params0, mesh, rules):
    shape = ShapeConfig("mesh", SEQ, BATCH, "prefill")
    trees = sharding_trees(model, cfg, shape, None, rules, mesh)
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in
         batch_of(cfg, STEPS).items() if k in trees["batch"]}
    if not cfg.is_encdec:
        b["tokens"] = b["tokens"].long()
    else:
        b["dec_tokens"] = b["dec_tokens"].long()
    step = cell_step(model, cfg, "prefill")
    want = step(params0, b)
    with axis_rules(rules, mesh):
        got = step(distribute_tree(params0, trees["params"]),
                   distribute_tree(b, trees["batch"]))
    return dict(logits=want, mesh_logits=full(got),
                mesh_logits_placements=tuple(map(str, got.placements)))


def _cache(model, cfg, weights, frames=None):
    """A float32 cache of ``BATCH`` x ``SEQ`` slots (an encoder-decoder's
    from ``init_cache`` of ``frames`` through ``functional_call``)."""
    if not cfg.is_encdec:
        return model.init_cache(BATCH, SEQ, dtype=torch.float32)
    return functional_call(_Method(model, "init_cache"), weights,
                           (frames, cfg.dec_len), {"dtype": torch.float32})


def decode(model, cfg, params0, mesh, rules):
    """``WARM`` plain decode steps fill a cache; then one more step
    without and under the mesh, from copies of that cache."""
    shape = ShapeConfig("mesh", SEQ, BATCH, "decode")
    trees = sharding_trees(model, cfg, shape, None, rules, mesh)
    gen = np.random.default_rng(SEED)
    toks = torch.from_numpy(gen.integers(0, cfg.vocab, (WARM + 1, BATCH,
                                                        1)))
    frames = torch.from_numpy(gen.standard_normal(
        (BATCH, SEQ, cfg.d_model)).astype(np.float32))
    step = cell_step(model, cfg, "decode")
    out = {}
    with torch.no_grad():
        cache = _cache(model, cfg, _weights(cfg, params0, "model."), frames)
        if cfg.is_encdec:
            dparams = distribute_tree(params0, trees["params"])
            with axis_rules(rules, mesh):
                frames_at = NamedSharding(mesh, logical_to_spec(
                    ("batch", "seq", "embed"), rules, tuple(frames.shape)))
                mcache = _cache(model, cfg, _weights(cfg, dparams, "model."),
                                distribute_tree(frames, frames_at))
            out["init_cache"] = [{k: c[k] for k in ("xk", "xv")}
                                 for c in cache["layers"]]
            out["mesh_init_cache"] = [{k: full(c[k]) for k in ("xk", "xv")}
                                      for c in mcache["layers"]]
        for t in toks[:WARM]:
            _, cache = step(params0, cache, {"tokens": t})
        dcache = distribute_tree(map_tree(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            cache), trees["cache"])
        want, cache = step(params0, cache, {"tokens": toks[WARM]})
        with axis_rules(rules, mesh):
            got, dcache = step(
                distribute_tree(params0, trees["params"]), dcache,
                distribute_tree({"tokens": toks[WARM]}, trees["batch"]))
    out.update(logits=want, mesh_logits=full(got), cache=cache,
               mesh_cache=map_tree(full, dcache),
               cache_placements=placements_of(dcache))
    return out


def checkpoint(dparams, dstate, trees, directory):
    """Save the placed trees; restore them onto the mesh and onto no
    mesh."""
    tree = {"opt": dstate, "params": dparams}
    shardings = {"opt": {**trees["opt"], "step": None},
                 "params": trees["params"]}
    mgr = CheckpointManager(directory)
    mgr.save(1, tree, blocking=True)
    placed = mgr.restore(1, tree, shardings=shardings, device="cpu")
    plain = mgr.restore(1, tree, device="cpu")
    return dict(saved=map_tree(full, tree), placed=map_tree(full, placed),
                plain=plain, placed_placements=placements_of(placed),
                requested={path: tuple(map(str, sh.placements))
                           for path, sh in flatten_with_paths(shardings)
                           if sh is not None},
                plain_types=sorted({type(x).__name__ for _, x in
                                    flatten_with_paths(plain)}))


def ssd_groups(mesh):
    """``_ssd_per_shard`` with the heads of ``xbar`` and ``dtA`` sharded
    over each of ``SSD_AXES`` (``B``/``C`` replicated), for each of
    ``SSD_GROUPS``: the full output and its placements beside
    ``ssd_chunked``'s."""
    gen = np.random.default_rng(SEED)
    B, L, P, N, chunk = 2, 16, 4, 8, 8
    out = {}
    for G in SSD_GROUPS:
        x = torch.from_numpy(gen.standard_normal(
            (B, L, SSD_HEADS, P)).astype(np.float32))
        a = torch.from_numpy(-gen.random((B, L, SSD_HEADS)).astype(
            np.float32))
        b, c = (torch.from_numpy(gen.standard_normal((B, L, G, N)).astype(
            np.float32)) for _ in range(2))
        want = ssd_chunked(x, a, b, c, chunk)
        for axes in SSD_AXES:
            heads = tuple(Shard(2) if name in axes else Replicate()
                          for name in mesh.mesh_dim_names)
            whole = (Replicate(),) * mesh.ndim
            got = _ssd_per_shard(
                distribute_tensor(x, mesh, heads),
                distribute_tensor(a, mesh, heads),
                distribute_tensor(b, mesh, whole),
                distribute_tensor(c, mesh, whole), chunk)
            out[(G, axes)] = dict(want=want, got=full(got),
                                  placements=tuple(map(str, got.placements)))
    return out


def run(mesh, archs, out_dir, rank):
    rules = make_rules_for_mesh(mesh, seq_parallel=True)
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(SEED))
        params0 = stack_params(cfg, model.params())
        res, placed = train(model, cfg, params0, mesh, rules,
                            AdamW(lr=LR, eps=EPS))
        if cfg.n_experts:
            res["q8"], _ = train(model, cfg, params0, mesh, rules,
                                 AdamW(lr=LR, eps=EPS, quantized=True))
        res["prefill"] = prefill(model, cfg, params0, mesh, rules)
        res["decode"] = decode(model, cfg, params0, mesh, rules)
        if arch == CKPT_ARCH:
            out["ckpt"] = checkpoint(*placed,
                                     os.path.join(out_dir, f"ckpt{rank}"))
        out[arch] = res
    cfg = dataclasses.replace(get_config(CKPT_ARCH).reduced(),
                              ssm_groups=GROUPS)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    params0 = stack_params(cfg, model.params())
    res, _ = train(model, cfg, params0, mesh, rules, AdamW(lr=LR, eps=EPS))
    res["prefill"] = prefill(model, cfg, params0, mesh, rules)
    out["grouped"] = res
    out["ssd_groups"] = ssd_groups(mesh)
    return out


def main(argv) -> None:
    rank, world, init_file, out_dir = argv[1:5]
    archs = argv[5:] or FAMILIES
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    distributed_c10d.default_pg_timeout = TIMEOUT
    tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                             rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", MESH[world],
                                mesh_dim_names=("data", "model"))
        out = run(mesh, archs, out_dir, rank)
    finally:
        tdist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv)
