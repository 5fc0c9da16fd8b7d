"""The train step under a mesh: reduced SmolLM-135M on four gloo ranks.

One module fixture starts ``tests/_torch_mesh_ranks.py`` in four
processes (a ``file://`` rendezvous in a tmp dir, 60 s group timeouts),
together under a ``SECONDS`` limit that kills them all on a failure or a
hang.  Each rank builds the ``(2, 2)`` ``("data", "model")`` mesh, the
rules of ``launch.mesh.make_rules_for_mesh`` and the placements of
``launch.specs.sharding_trees`` (FSDP over ``data``, tensor parallel over
``model``), and runs two float32 AdamW steps with ``grad_accum`` 1 and 2
under the mesh and without it.  Held on every rank:

* each step's loss and every gradient leaf within ``TOL`` of the step
  without a mesh (the reductions over shards add in another order);
* the full parameters after the steps within ``TOL``'s ``rtol`` and
  ``TOL``'s ``atol`` plus 5% of the learning rate: Adam's first step
  ``g / (|g| + eps)`` turns the gradients' last-bit differences into up
  to a few percent of a step where ``|g|`` is near ``eps``, as in
  ``tests/test_torch_train.py``;
* each gradient's placements equal to its parameter's, and the moments
  ``DTensor``s;
* the placements of the embedding, an attention and an MLP weight.

And RoPE on ``DTensor`` q and k over a one-rank mesh (gloo on the host;
NCCL on the card, marked ``gpu``): once a shard through its autograd
``Function``, forward and backward bit for bit to the unsharded call,
a placement that shards the sequence or the head dim refused.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
WORLD, SECONDS = 4, 300
TOL = dict(atol=5e-5, rtol=1e-4)
LR = 1e-2   # the rank script's AdamW rate


def _wait(procs, deadline):
    """Wait for every process; kill them all when one fails or time is
    up, and fail with the output of the ones that did."""
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes) or all(
                c == 0 for c in codes):
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    bad = []
    for p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            bad.append(f"{p.args[-3:]} exit {p.returncode}:\n{err[-3000:]}")
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, REPRO_PLAN_CACHE="off",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_ranks.py"),
         str(r), str(WORLD), str(tmp / "rendezvous"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    _wait(procs, time.monotonic() + SECONDS)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _pairs(a, b):
    pa, pb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    return [(p, x, y) for (p, x), (_, y) in zip(pa, pb)]


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_step_loss_and_gradients_match_the_plain_step(ranks, accum):
    for out in ranks:
        run = out[accum]
        torch.testing.assert_close(torch.tensor(run["mesh_losses"]),
                                   torch.tensor(run["losses"]), **TOL)
        assert len(run["mesh_grads"]) == len(run["grads"]) == 2
        for plain, meshed in zip(run["grads"], run["mesh_grads"]):
            for path, want, got in _pairs(plain, meshed):
                assert type(got) is torch.Tensor, path
                torch.testing.assert_close(got, want, **TOL, msg=path)


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_step_parameters_match_the_plain_step(ranks, accum):
    for out in ranks:
        run = out[accum]
        for path, want, got in _pairs(run["params"], run["mesh_params"]):
            torch.testing.assert_close(got, want, rtol=TOL["rtol"],
                                       atol=TOL["atol"] + 0.05 * LR,
                                       msg=path)


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_gradients_carry_their_parameters_placements(ranks, accum):
    for out in ranks:
        run = out[accum]
        assert run["moments_placed"]
        assert len(run["placements_seen"]) == 2
        for seen in run["placements_seen"]:
            assert set(seen) == set(out["placements"])
            for path, (grad, param) in seen.items():
                assert grad == param == out["placements"][path], path


def test_mesh_placements_of_the_smollm_tree(ranks):
    """FSDP over ``data`` on each weight's largest free axis, tensor
    parallel over ``model``: the embedding's vocab, attention's heads,
    the MLP's ``ff``; a stacked group's layer axis never sharded."""
    pl = ranks[0]["placements"]
    assert pl["['embed']['e']"] == ("S(1)", "S(0)")
    assert pl["['group0'][0]['attn']['wq']['w']"] == ("S(1)", "S(2)")
    assert pl["['group0'][0]['attn']['wo']['w']"] == ("S(2)", "S(1)")
    assert pl["['group0'][0]['mlp']['down']['w']"] == ("S(2)", "S(1)")
    assert pl["['ln_f']['g']"] == ("S(0)", "R")
    assert all(out["placements"] == pl for out in ranks)


def _one_rank_mesh(tmp_path, backend, device):
    import datetime

    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    tdist.init_process_group(
        backend, init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


def _rope_inputs(device, dtype):
    from repro_torch.kernels.rope.ops import rope_tables
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((2, 24, 4, 16), generator=gen).to(device, dtype)
    k = torch.randn((2, 24, 2, 16), generator=gen).to(device, dtype)
    cos, sin = rope_tables(torch.arange(24, device=device), 16, 1e4,
                           dtype=dtype)
    return q, k, cos, sin


def _rope_per_shard_case(mesh, device, dtype):
    """RoPE on DTensor q/k (batch over ``data``, heads over ``model``),
    forward and backward, against the unsharded call; a sequence- or
    head-dim-sharded placement raises ``ValueError``."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.kernels.rope import kernel as rope_k
    from repro_torch.kernels.rope.ops import apply_rope
    q, k, cos, sin = _rope_inputs(device, dtype)
    q.requires_grad_(True)
    k.requires_grad_(True)
    gq, gk = torch.randn_like(q), torch.randn_like(k)
    wq, wk = apply_rope(q, k, cos, sin)
    want = torch.autograd.grad((wq, wk), (q, k), (gq, gk))
    pl = (Shard(0), Shard(2))
    dq = distribute_tensor(q.detach(), mesh, pl).requires_grad_(True)
    dk = distribute_tensor(k.detach(), mesh, pl).requires_grad_(True)
    before = rope_k.LAUNCHES
    oq, ok = apply_rope(dq, dk, cos, sin)
    assert isinstance(oq, DTensor) and tuple(oq.placements) == pl
    got = torch.autograd.grad((oq, ok), (dq, dk), (
        distribute_tensor(gq, mesh, pl), distribute_tensor(gk, mesh, pl)))
    launches = rope_k.LAUNCHES - before
    assert torch.equal(oq.full_tensor(), wq)
    assert torch.equal(ok.full_tensor(), wk)
    for g, w in zip(got, want):
        assert torch.equal(g.full_tensor(), w)
    for bad in ((Shard(1), Replicate()), (Replicate(), Shard(3))):
        with pytest.raises(ValueError):
            apply_rope(distribute_tensor(q.detach(), mesh, bad),
                       distribute_tensor(k.detach(), mesh, bad), cos, sin)
    with pytest.raises(ValueError):   # the batch sharded on q only
        apply_rope(distribute_tensor(q.detach(), mesh, pl),
                   distribute_tensor(k.detach(), mesh,
                                     (Replicate(), Shard(2))), cos, sin)
    return launches


def test_rope_runs_once_a_shard_on_dtensors(tmp_path):
    """On the host: the plain version a shard, bit for bit."""
    import torch.distributed as tdist
    mesh = _one_rank_mesh(tmp_path, "gloo", "cpu")
    try:
        _rope_per_shard_case(mesh, "cpu", torch.float32)
    finally:
        tdist.destroy_process_group()


@pytest.mark.gpu
def test_rope_kernel_once_a_shard_over_nccl_on_the_card(tmp_path):
    """On the card, over a one-rank NCCL mesh: the kernel a shard forward
    and backward (two launches), bit for bit to its unsharded launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as tdist
    torch.cuda.set_device(0)
    mesh = _one_rank_mesh(tmp_path, "nccl", "cuda")
    try:
        for dtype in (torch.float32, torch.bfloat16):
            assert _rope_per_shard_case(mesh, "cuda", dtype) == 2
    finally:
        tdist.destroy_process_group()
