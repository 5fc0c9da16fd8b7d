"""Every model family's steps under a mesh: the MoE/MLA, RG-LRU, SSD and
encoder-decoder families on four gloo ranks, and their dry-run records.

One module fixture starts ``tests/_torch_mesh_family_ranks.py`` in four
processes (a ``file://`` rendezvous in a tmp dir, 60 s group timeouts)
and the fake-mesh dry run (``FAKE_SCRIPT``) in a fifth, together under a
``SECONDS`` limit that kills them all on a failure or a hang.  Each rank
builds the ``(2, 2)`` ``("data", "model")`` mesh, the rules of
``launch.mesh.make_rules_for_mesh`` with sequence parallelism on (as the
dry run has them) and the placements of ``launch.specs.sharding_trees``.
For DeepSeek-V2-Lite, RecurrentGemma-9B, Mamba2-370M and
Whisper-large-v3 at ``.reduced()``, float32, held on every rank against
the same calls without a mesh:

* two AdamW steps: each loss and every gradient leaf within ``TOL`` (the
  reductions over shards add in another order), the parameters after
  the steps within ``TOL``'s ``rtol`` and ``TOL``'s ``atol`` plus 5% of
  the learning rate (Adam's first step ``g / (|g| + eps)`` turns a
  gradient's last-bit difference into a few percent of a step where
  ``|g|`` is near ``eps``, as ``tests/test_torch_mesh_train.py`` says),
  each gradient's placements equal to its parameter's; the MoE family's
  steps once more with AdamW's 8-bit state (Kimi-K2's dry-run route);
* a prefill (the forward) and one ``decode_step`` over a cache placed by
  ``sharding_trees``: logits and the updated cache within ``TOL``;
  Whisper's ``init_cache`` under the mesh (its encoder on placed frames)
  within ``TOL`` of the plain one's cross K/V;
* a checkpoint of Mamba2's placed parameters and AdamW state, restored
  onto the mesh and onto no mesh, bit for bit to the saved full tensors,
  each restored placement the requested one;
* Mamba2 with 2 ``B``/``C`` groups: its steps and prefill as above; and
  the SSD once a shard alone, 12 heads in each of ``SSD_GROUPS`` groups
  sharded over each of ``SSD_AXES``, within ``TOL`` of the plain SSD,
  the heads' shards kept exactly where each rank's block holds whole
  groups.

And each family's reduced train step through ``dryrun.step_record`` on
a fake ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh: ``ok``, its
collectives counted as ``CommDebugMode`` counts them, its per-device dot
flops times 8 over the step's without a mesh within ``[1,
MESH_OVERCOUNT]``.
"""
import json
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
MESH_OVERCOUNT = 1.5
FAMILIES = ["deepseek-v2-lite-16b", "recurrentgemma-9b", "mamba2-370m",
            "whisper-large-v3"]
# the rank script's cases of the SSD once a shard
SSD_GROUPS = (1, 2, 3, 4)
SSD_AXES = (("model",), ("data", "model"))

FAKE_SCRIPT = r"""
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.compat import fake_store
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_rules_for_mesh
from repro_torch.optim import AdamW

dist.init_process_group("fake", store=fake_store(), rank=0, world_size=8)
pod = init_device_mesh("cpu", (2, 2, 2),
                       mesh_dim_names=("pod", "data", "model"))
shape = ShapeConfig("mini", 32, 8, "train")
out = {}
for arch in sys.argv[1:]:
    cfg = get_config(arch).reduced()
    rec = dryrun.step_record(
        cfg, shape, mesh=pod, rules=make_rules_for_mesh(pod,
                                                        seq_parallel=True),
        optimizer=AdamW(lr=1e-4))
    plain = dryrun.step_record(cfg, shape, optimizer=AdamW(lr=1e-4))
    out[arch] = dict(rec=rec, plain=plain)
dist.destroy_process_group()
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, REPRO_PLAN_CACHE="off",
                PYTHONPATH=str(ROOT / "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


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
    outs, bad = [], []
    for p in procs:
        out, err = p.communicate()
        outs.append(out)
        if p.returncode != 0:
            bad.append(f"{p.args[-3:]} exit {p.returncode}:\n{err[-3000:]}")
    assert not bad, "\n".join(bad)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_family_ranks.py"),
         str(r), str(WORLD), str(tmp / "rendezvous"), str(tmp)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", FAKE_SCRIPT, *FAMILIES], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = _wait(procs, time.monotonic() + SECONDS)
    return dict(ranks=[torch.load(tmp / f"rank{r}.pt", weights_only=False)
                       for r in range(WORLD)],
                fake=json.loads(outs[-1].splitlines()[-1]))


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


def _pairs(a, b):
    pa, pb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    return [(p, x, y) for (p, x), (_, y) in zip(pa, pb)]


def _close(a, b, **tol):
    for path, want, got in _pairs(a, b):
        assert type(got) is torch.Tensor, path
        torch.testing.assert_close(got, want, **(tol or TOL), msg=path)


def _train_runs(ranks, arch, q8=True):
    for out in ranks:
        yield out[arch]
        if q8 and "q8" in out[arch]:
            yield out[arch]["q8"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_losses_and_gradients_match_the_plain_step(ranks, arch):
    for run in _train_runs(ranks, arch):
        torch.testing.assert_close(torch.tensor(run["mesh_losses"]),
                                   torch.tensor(run["losses"]), **TOL)
        assert len(run["mesh_grads"]) == len(run["grads"]) == 2
        for plain, meshed in zip(run["grads"], run["mesh_grads"]):
            _close(plain, meshed)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_parameters_match_the_plain_step(ranks, arch):
    """The float32 route's; the 8-bit route rounds each moment to a
    quantum of its block's scale, so a gradient's last-bit difference
    can move an element by a whole quantum's share of a step (its
    losses, gradients and placements are held)."""
    for run in _train_runs(ranks, arch, q8=False):
        _close(run["params"], run["mesh_params"], rtol=TOL["rtol"],
               atol=TOL["atol"] + 0.05 * LR)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_gradients_carry_their_parameters_placements(ranks, arch):
    for run in _train_runs(ranks, arch):
        assert len(run["placements_seen"]) == 2
        for seen in run["placements_seen"]:
            assert set(seen) == set(run["placements"])
            for path, (grad, param) in seen.items():
                assert grad == param == run["placements"][path], path
    assert all(out[arch]["placements"] == ranks[0][arch]["placements"]
               for out in ranks)


def test_q8_route_runs_on_the_moe_family(ranks):
    """Kimi-K2's dry-run route, AdamW's 8-bit state, on the MoE family's
    reduced config (its losses and gradients are held above): every
    moment's payload and scales are ``DTensor``s, and the steps differ
    from float32's."""
    for out in ranks:
        run = out["deepseek-v2-lite-16b"]
        q8 = run["q8"]
        assert set(q8["moments"]) == {
            path + f for path in q8["placements"] for f in (".q", ".scale")}
        assert q8["mesh_losses"][0] == pytest.approx(run["mesh_losses"][0],
                                                     rel=TOL["rtol"])
        assert any(not torch.equal(a, b) for _, a, b in
                   _pairs(run["params"], q8["params"]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_prefill_matches_the_plain_forward(ranks, arch):
    for out in ranks:
        run = out[arch]["prefill"]
        torch.testing.assert_close(run["mesh_logits"], run["logits"],
                                   **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_decode_step_matches_the_plain_step(ranks, arch):
    for out in ranks:
        run = out[arch]["decode"]
        torch.testing.assert_close(run["mesh_logits"], run["logits"],
                                   **TOL)
        assert run["mesh_cache"]["idx"] == run["cache"]["idx"]
        _close(run["cache"]["layers"], run["mesh_cache"]["layers"])
        assert run["cache_placements"]


def test_whisper_init_cache_under_the_mesh(ranks):
    """The encoder on placed frames, then each decoder layer's cross K/V:
    those of the plain ``init_cache``."""
    for out in ranks:
        run = out["whisper-large-v3"]["decode"]
        _close(run["init_cache"], run["mesh_init_cache"])


def test_placements_of_the_moe_and_mla_weights(ranks):
    """The experts over ``model`` (expert parallel), FSDP over ``data`` on
    each stack's largest free axis; MLA's up-projection's heads over
    ``model``."""
    pl = ranks[0]["deepseek-v2-lite-16b"]["placements"]
    moe = "['group1'][0]['mlp']"
    for w in ("w_gate", "w_up", "w_down"):
        assert pl[f"{moe}['{w}']"][1] == "S(1)", (w, pl[f"{moe}['{w}']"])
    assert pl["['group0'][0]['attn']['wkv_b']['w']"][1] == "S(2)"


def test_grouped_ssm_steps_match_the_plain_step(ranks):
    """Mamba2 with 2 ``B``/``C`` groups: losses, gradients, parameters
    and the prefill's logits under the mesh, as the families' are held."""
    for out in ranks:
        run = out["grouped"]
        torch.testing.assert_close(torch.tensor(run["mesh_losses"]),
                                   torch.tensor(run["losses"]), **TOL)
        assert len(run["mesh_grads"]) == len(run["grads"]) == 2
        for plain, meshed in zip(run["grads"], run["mesh_grads"]):
            _close(plain, meshed)
        _close(run["params"], run["mesh_params"], rtol=TOL["rtol"],
               atol=TOL["atol"] + 0.05 * LR)
        torch.testing.assert_close(run["prefill"]["mesh_logits"],
                                   run["prefill"]["logits"], **TOL)


@pytest.mark.parametrize("axes", SSD_AXES, ids="+".join)
@pytest.mark.parametrize("groups", SSD_GROUPS)
def test_ssd_once_a_shard_maps_each_head_to_its_group(ranks, groups, axes):
    """A rank's block of heads keeps its shard only where it holds whole
    groups in ``ssd_chunked``'s order (one group, or the groups split as
    the heads are); elsewhere the heads are replicated first.  Either
    way the output is the plain SSD's."""
    blocks = 2 ** len(axes)   # each axis of the (2, 2) mesh splits in two
    keep = groups == 1 or groups % blocks == 0
    for out in ranks:
        case = out["ssd_groups"][(groups, axes)]
        torch.testing.assert_close(case["got"], case["want"], **TOL)
        assert case["placements"] == tuple(
            "S(2)" if keep and name in axes else "R"
            for name in ("data", "model"))


def test_checkpoint_of_a_mesh_tree_round_trips_bit_for_bit(ranks):
    for out in ranks:
        ck = out["ckpt"]
        for saved, got in ((ck["saved"], ck["placed"]),
                           (ck["saved"], ck["plain"])):
            for path, want, have in _pairs(saved, got):
                assert type(have) is torch.Tensor, path
                assert have.dtype == want.dtype, path
                assert torch.equal(have, want), path
        assert ck["plain_types"] == ["Tensor"]


def test_restored_placements_are_the_requested_ones(ranks):
    for out in ranks:
        ck = out["ckpt"]
        assert ck["placed_placements"] == ck["requested"]
        assert len(ck["requested"]) > 3


@pytest.mark.parametrize("arch", FAMILIES)
def test_fake_mesh_step_record(runs, arch):
    rec, plain = runs["fake"][arch]["rec"], runs["fake"][arch]["plain"]
    hc = rec["hlo_cost"]
    assert sum(hc["collective_counts"].values()) > 0
    names = {"all-gather": "all_gather_into_tensor",
             "all-reduce": "all_reduce",
             "reduce-scatter": "reduce_scatter_tensor",
             "all-to-all": "all_to_all"}
    assert {names[k]: v for k, v in hc["collective_counts"].items()} == \
        rec["comm_debug_counts"]
    assert rec["memory"]["temp_bytes"] > 0
    ratio = 8 * hc["dot_flops_per_device"] / \
        plain["hlo_cost"]["dot_flops_per_device"]
    assert 1.0 <= ratio <= MESH_OVERCOUNT, ratio
    assert rec["memory"]["argument_bytes"] < \
        plain["memory"]["argument_bytes"]
