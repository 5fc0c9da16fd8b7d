"""One gloo rank of the train step under a mesh, for
``tests/test_torch_mesh_train.py``.

    python tests/_torch_mesh_ranks.py RANK WORLD INIT_FILE OUT_DIR

Joins a ``WORLD``-rank gloo group through the ``file://`` rendezvous
``INIT_FILE`` (every group times out after 60 s) and builds the
``("data", "model")`` mesh of ``MESH[WORLD]``.  Reduced SmolLM-135M
(float32) takes ``STEPS`` AdamW steps, with ``grad_accum`` 1 and 2, as
the plain step without a mesh and as the same step under the mesh
(``make_rules_for_mesh``; parameters, optimizer state and batch placed
by ``sharding_trees``; ``grad_shardings`` the parameters' shardings).
Saves to ``OUT_DIR/rank{RANK}.pt``, per ``grad_accum``: both runs'
losses, full gradients a step and full parameters after the steps, and
every gradient's placements beside its parameter's (recorded in the
optimizer's update).
"""
import datetime
import sys

import torch
import torch.distributed as tdist
from torch.distributed import distributed_c10d
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import DataConfig, make_batch
from repro_torch.launch.mesh import make_rules_for_mesh
from repro_torch.launch.specs import distribute_tree, sharding_trees
from repro_torch.models import build_model
from repro_torch.models.zoo import stack_params
from repro_torch.optim import AdamW
from repro_torch.parallel.sharding import axis_rules
from repro_torch.train import make_train_step
from repro_torch.tree import flatten_with_paths, map_tree

TIMEOUT = datetime.timedelta(seconds=60)
MESH = {1: (1, 1), 4: (2, 2)}
BATCH, SEQ, STEPS, SEED = 4, 32, 2, 3


class Recording:
    """An optimizer that records the full gradients it is given and each
    ``DTensor`` gradient's placements beside its parameter's, then
    updates as ``opt`` does."""

    def __init__(self, opt):
        self.opt, self.seen, self.grads = opt, [], []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, **kw):
        pairs = zip(flatten_with_paths(grads), flatten_with_paths(params))
        self.seen.append({path: (tuple(map(str, g.placements)),
                                 tuple(map(str, p.placements)))
                          for (path, g), (_, p) in pairs
                          if isinstance(p, DTensor)})
        self.grads.append(map_tree(full, grads))
        return self.opt.update(grads, state, params, **kw)


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def run(mesh):
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    params0 = stack_params(cfg, model.params())
    batches = [make_batch(DataConfig(cfg.vocab, SEQ, BATCH, seed=SEED), s)
               for s in range(STEPS)]
    opt = AdamW(lr=1e-2)
    rules = make_rules_for_mesh(mesh)
    trees = sharding_trees(model, cfg, ShapeConfig("mesh", SEQ, BATCH,
                                                   "train"),
                           opt, rules, mesh)
    out = {"placements": {path: tuple(map(str, sh.placements))
                          for path, sh in flatten_with_paths(
                              trees["params"])}}
    for accum in (1, 2):
        plain_rec = Recording(opt)
        plain = make_train_step(model, cfg, plain_rec, grad_accum=accum)
        params, state = params0, opt.init(params0)
        losses = []
        for b in batches:
            params, state, m = plain(params, state, b)
            losses.append(float(m["loss"]))
        rec = Recording(opt)
        meshed = make_train_step(model, cfg, rec, grad_accum=accum,
                                 grad_shardings=trees["params"])
        dparams = distribute_tree(params0, trees["params"])
        dstate = opt.init(dparams)
        mesh_losses = []
        with axis_rules(rules, mesh):
            for b in batches:
                dparams, dstate, m = meshed(
                    dparams, dstate, distribute_tree(b, trees["batch"]))
                mesh_losses.append(float(full(m["loss"])))
        out[accum] = dict(
            losses=losses, mesh_losses=mesh_losses,
            params=params, mesh_params=map_tree(full, dparams),
            moments_placed=all(isinstance(x, DTensor) for _, x in
                               flatten_with_paths(dstate["m"])),
            grads=plain_rec.grads, mesh_grads=rec.grads,
            placements_seen=rec.seen)
    return out


def main(argv) -> None:
    rank, world, init_file, out_dir = argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    distributed_c10d.default_pg_timeout = TIMEOUT
    tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                             rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", MESH[world],
                                mesh_dim_names=("data", "model"))
        out = run(mesh)
    finally:
        tdist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv)
