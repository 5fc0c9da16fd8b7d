"""The port's sharded execution (``repro_torch.dist``) against the reference's.

Mirrors eight of the ten tests of ``tests/test_distributed.py`` (all but
the mini dry-run and the HLO collective count, which are XLA's own), then
the services and the eig buffer under a mesh, the argument checks and,
on the card, one rank over NCCL.

The inputs are drawn once with numpy.  The reference runs them in one
subprocess on four forced host devices (as ``test_distributed.py::_run``
does); the port runs them in four gloo ranks on the CPU
(``tests/_torch_dist_ranks.py``), on the meshes ``(2, 2)`` ``("data",
"model")`` and ``(4,)`` ``("data",)``, both started together and given
a time limit.  The port is held to the reference at ``atol = 5e-5 *
max(1, k)``, ``rtol = 5e-5`` (float32), and to its own replicated plans
bit for bit on the rotation family (``blocked``, ``cuda_batched``'s plain
version); the accumulated family (``accumulated``) to ``GEMM_TOL``.
The cost-model tests run in this process against ``repro.core.registry``
at ``platform="cpu"``, where both packages carry the same record.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import registry as jreg
from repro.dist import column_sharded_comm_bytes as j_comm_bytes
from repro.dist import modeled_crossover as j_crossover
from repro_torch import RotationSequence, dist
from repro_torch.core import registry
from repro_torch.core.registry import Problem, _plan_key, _split_key

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
SECONDS = 300    # the reference's subprocess and the ranks, together
GEMM_TOL = 1e-5  # relative Frobenius error, accumulated against blocked

# (m, n, k, n_b, k_b, method): tests/test_distributed.py's four cases
ROWCOL = [(8, 32, 5, 4, 2, "blocked"), (16, 64, 7, 8, 4, "blocked"),
          (8, 32, 9, 8, 3, "accumulated"), (4, 64, 2, 16, 8, "accumulated")]
AUTO = {"small": (64, 32, 8), "large": (2048, 512, 64)}

REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro import dist
from repro.core.sequence import RotationSequence
inp, out = np.load(sys.argv[1]), {}
mesh22 = jax.make_mesh((2, 2), ("data", "model"))
mesh4 = jax.make_mesh((4,), ("data",))
def seq(key, **kw):
    return RotationSequence(jnp.asarray(inp[key + "_C"]),
                            jnp.asarray(inp[key + "_S"]), **kw)
for i, (m, n, k, n_b, k_b, method) in enumerate(%r):
    A, sq = jnp.asarray(inp[f"rc{i}_A"]), seq(f"rc{i}")
    out[f"rc{i}_row"] = np.asarray(dist.rot_sequence_row_sharded(
        A, sq, mesh22, n_b=n_b, k_b=k_b))
    out[f"rc{i}_col"] = np.asarray(dist.rot_sequence_column_sharded_padded(
        A, sq, mesh22, col_axis="model", n_b=n_b, k_b=k_b,
        row_axes=("data",), method=method))
A = jnp.asarray(inp["fp_A"])
G = jnp.asarray(inp["fp_G"])
for name, sq in (("plain", seq("fp")), ("signed", seq("fp", sign=G)),
                 ("reflector", seq("fp", reflect=True))):
    out[f"fp_{name}"] = np.asarray(dist.plan_sharded(
        sq, like=A, mesh=mesh4, method="blocked").apply_batched(A))
A, sq = jnp.asarray(inp["gr_A"]), seq("gr")
rp = sq.plan(like=A, method="blocked")
out["gr_grad"] = np.asarray(jax.grad(lambda x: (rp.apply(x) ** 2).sum())(A))
np.savez(sys.argv[2], **out)
""" % (ROWCOL,)


def _waves(rng, n, k):
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


def _signs(rng, n, k):
    return np.where(rng.standard_normal((n - 1, k)) > 0, 1.0,
                    -1.0).astype(np.float32)


def _inputs() -> dict:
    rng = np.random.default_rng(5)
    inp = {}

    def add(key, m, n, k, lead=()):
        inp[f"{key}_A"] = rng.standard_normal(
            (*lead, m, n)).astype(np.float32)
        inp[f"{key}_C"], inp[f"{key}_S"] = _waves(rng, n, k)

    for i, (m, n, k, *_) in enumerate(ROWCOL):
        add(f"rc{i}", m, n, k)
    add("cw", 16, 32, 5)
    add("fp", 64, 32, 6, lead=(8,))
    inp["fp_G"] = _signs(rng, 32, 6)
    inp["fp_C2"], inp["fp_S2"] = _waves(rng, 32, 6)
    add("gr", 64, 32, 6)
    for label, (m, n, k) in AUTO.items():
        add(f"au_{label}", m, n, k)
    inp["db_C"], inp["db_S"] = _waves(rng, 16, 40)
    inp["db_M3"] = rng.standard_normal((3, 16, 16)).astype(np.float32)
    inp["gr_ref_dict"] = np.array(json.dumps(_reference_dict(inp)))
    return inp


def _reference_dict(inp) -> dict:
    """The reference's ``ShardedSequencePlan.to_dict()`` of the gradient
    case's plan over four ``"data"`` devices.  A named method reads only
    the mesh's extents, so a stand-in of the mesh's ``shape`` serves."""
    import types

    import jax.numpy as jnp
    from repro import dist as jdist
    from repro.core.sequence import RotationSequence as JSeq
    seq = JSeq(jnp.asarray(inp["gr_C"]), jnp.asarray(inp["gr_S"]))
    mesh = types.SimpleNamespace(shape={"data": WORLD})
    return jdist.plan_sharded(seq, like=jnp.asarray(inp["gr_A"]), mesh=mesh,
                              method="blocked").to_dict()


def _wait(procs, deadline):
    """Wait for every process; kill them all when one fails or time is
    up, and fail with the output of the ones that did."""
    import time
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
        out, err = p.communicate()
        if p.returncode != 0:
            bad.append(f"{p.args[-4:]} exit {p.returncode}:\n{err[-3000:]}")
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(inputs, reference outputs, [rank outputs])``."""
    import time
    tmp = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_PLAN_CACHE="off",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ref_out = tmp / "reference.npz"
    init = str(tmp / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inputs), str(ref_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
         str(r), str(WORLD), init, str(inputs), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    _wait(procs, time.monotonic() + SECONDS)
    ref = dict(np.load(ref_out))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return inp, ref, ranks


def _close_to_reference(got, want, k):
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5,
                               atol=5e-5 * max(1, k))


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("case", range(len(ROWCOL)))
def test_row_and_column_sharded_rotseq(runs, case):
    """Row sharding (blocked) equals the replicated plan bit for bit and
    the column pipeline equals the replicated plan of its method (bit for
    bit under ``blocked``, ``GEMM_TOL`` under ``accumulated``), on every
    rank; both match the reference's sharded outputs."""
    _, ref, ranks = runs
    m, n, k, n_b, k_b, method = ROWCOL[case]
    for out in ranks:
        row, col = out[f"rc{case}_row"], out[f"rc{case}_col"]
        assert torch.equal(row, out[f"rc{case}_row_rep"])
        if method == "blocked":
            assert torch.equal(col, out[f"rc{case}_col_rep"])
        else:
            assert _rel(col, out[f"rc{case}_col_rep"]) <= GEMM_TOL
        assert torch.equal(row, ranks[0][f"rc{case}_row"])
    _close_to_reference(ranks[0][f"rc{case}_row"], ref[f"rc{case}_row"], k)
    _close_to_reference(ranks[0][f"rc{case}_col"], ref[f"rc{case}_col"], k)


def test_row_sharded_arguments(runs):
    """Raw wave arrays and a missing mesh are ``TypeError``s; ``mesh=``
    works as a keyword."""
    _, _, ranks = runs
    for out in ranks:
        assert out["raw_arrays_raise"] and out["no_mesh_raises"]
        assert torch.equal(out["mesh_keyword"], ranks[0]["mesh_keyword"])


def test_core_distributed_compat_wrapper(runs):
    """``repro_torch.core.distributed`` warns and delegates to
    ``repro_torch.dist`` with identical results."""
    _, _, ranks = runs
    for out in ranks:
        assert out["cw_warned"] and out["cw_equal"]


@pytest.mark.parametrize("name", ["plain", "signed", "reflector"])
def test_sharded_fused_parity(runs, name):
    """A batch row-sharded over four ranks equals the replicated
    ``apply_batched`` bit for bit (``blocked`` and ``cuda_batched``, and
    per-request waves of mixed structure), and the reference's sharded
    output to tolerance."""
    _, ref, ranks = runs
    for out in ranks:
        for method in ("blocked", "cuda_batched"):
            assert torch.equal(out[f"fp_{name}_{method}"],
                               out[f"fp_{name}_{method}_rep"]), method
            assert torch.equal(out[f"fp_perreq_{method}"],
                               out[f"fp_perreq_{method}_rep"]), method
    _close_to_reference(ranks[0][f"fp_{name}_blocked"], ref[f"fp_{name}"], 6)


def test_sharded_obs(runs):
    """One launch a shard, the mesh size as a gauge, and ``comm_bytes``
    equal to the bytes the wave broadcast moved (``C`` and ``S`` to three
    ranks), in the counter and the roofline row."""
    _, _, ranks = runs
    for out in ranks:
        o = out["fp_obs"]
        moved = (WORLD - 1) * o["wave_bytes"]
        assert o["gauges"]["dist.launches_per_shard"] == 1.0
        assert o["gauges"]["dist.devices"] == float(WORLD)
        assert o["counters"]["dist.applies"] == 1
        assert o["counters"]["dist.comm_bytes"] == moved
        assert len(o["rows"]) == 1
        assert o["rows"][0]["launches_per_shard"] == 1
        assert o["rows"][0]["comm_bytes"] == moved


def test_sharded_plan_grad_and_roundtrip(runs):
    """The gradient through ``ShardedSequencePlan.apply`` (w.r.t. a
    ``DTensor``) equals the replicated port plan's bit for bit and the
    reference's replicated ``jax.grad`` to tolerance; ``to_dict`` /
    ``from_dict`` round-trips with the mesh re-supplied, loads a dict the
    reference wrote, and refuses a mesh of another size."""
    inp, ref, ranks = runs
    for out in ranks:
        assert torch.equal(out["gr_grad"], out["gr_grad_rep"])
        assert out["gr_roundtrip"] and out["gr_other_mesh_raises"]
        assert out["gr_ref_dict_apply"]
    _close_to_reference(ranks[0]["gr_grad"], ref["gr_grad"], 6)
    want = json.loads(str(inp["gr_ref_dict"]))
    assert "jax" in want and "torch" not in want
    method, devices, sharded, kwargs = ranks[0]["gr_ref_dict"]
    assert (method, devices, sharded) == (want["method"], want["devices"],
                                          want["execute_sharded"])
    assert kwargs == {key: val for key, val in want["kwargs"].items()
                      if key != "m_blk"}


@pytest.mark.parametrize("label,expect_sharded",
                         [("small", False), ("large", True)])
def test_auto_crossover_small_and_large(runs, label, expect_sharded):
    """``method="auto"`` keeps the small problem replicated and shards
    the large one at eight devices, as the reference's
    ``modeled_crossover`` decides at ``platform="cpu"``; on the four gloo
    ranks the plan follows ``modeled_crossover`` at four."""
    _, _, ranks = runs
    m, n, k = AUTO[label]
    sh_s, rep_s = dist.modeled_crossover(m, n, k, devices=8,
                                         platform="cpu")
    j_sh, j_rep = j_crossover(m, n, k, devices=8)
    assert (sh_s < rep_s) == (j_sh < j_rep) == expect_sharded, (
        sh_s, rep_s, j_sh, j_rep)
    assert math.isclose(sh_s, j_sh, rel_tol=1e-12)
    assert math.isclose(rep_s, j_rep, rel_tol=1e-12)
    sh4, rep4 = dist.modeled_crossover(m, n, k, devices=WORLD,
                                       platform="cpu")
    for out in ranks:
        assert out[f"au_{label}"][0] == (sh4 < rep4)


def test_comm_term_monotone_in_devices():
    """The communication term: zero unsharded and at one device, rising
    with the mesh, ``ceil(log2 D)`` hops, equal to the reference's."""
    zero = registry.cost_components(
        "blocked", Problem(256, 64, 16, platform="cpu"))["comm"]
    assert zero == {"bytes": 0.0, "hops": 0.0, "seconds": 0.0}
    prev_bytes, prev_secs = -1.0, -1.0
    for D in (1, 2, 4, 8, 16):
        prob = dict(m=256, n=64, k=16, sharded=True, devices=D)
        comm = registry.cost_components(
            "blocked", Problem(platform="cpu", **prob))["comm"]
        assert comm == jreg.cost_components(
            "blocked", jreg.Problem(platform="cpu", **prob))["comm"]
        assert comm["bytes"] > prev_bytes and comm["seconds"] > prev_secs
        assert comm["hops"] == (math.ceil(math.log2(D)) if D > 1 else 0)
        prev_bytes, prev_secs = comm["bytes"], comm["seconds"]


@pytest.mark.parametrize("method", ["unoptimized", "wavefront", "blocked",
                                    "accumulated"])
def test_sharded_cost_equals_reference(method):
    """A sharded problem's seconds and stream split at ``platform="cpu"``
    are the reference's, for every backend both packages share."""
    for D in (1, 4, 8):
        for batch, shared in ((1, True), (16, False)):
            prob = dict(m=512, n=96, k=24, batch=batch, sharded=True,
                        shared_sequence=shared, devices=D)
            got = registry.cost_components(method,
                                           Problem(platform="cpu", **prob))
            want = jreg.cost_components(method,
                                        jreg.Problem(platform="cpu", **prob))
            assert got["seconds"] == want["seconds"], (D, batch)
            assert got["stream"] == want["stream"]
            assert got["comm"] == want["comm"]


def test_sharded_plan_cache_key_isolation():
    """Sharded keys carry ``("sharded", devices)``: a class of their own
    for each device count, apart from the one-device key; the batch and
    per-request markers survive beside it."""
    k1 = _plan_key(Problem(64, 32, 8))
    k8 = _plan_key(Problem(64, 32, 8, sharded=True, devices=8))
    k4 = _plan_key(Problem(64, 32, 8, sharded=True, devices=4))
    assert k8[8] == ("sharded", 8) and k4[8] == ("sharded", 4)
    assert len(k1) == 8
    classes = {_split_key(key)[1] for key in (k1, k8, k4)}
    assert len(classes) == 3
    assert _plan_key(Problem(64, 32, 8, sharded=True, devices=8)) == k8
    kb = _plan_key(Problem(64, 32, 8, sharded=True, devices=8, batch=16,
                           shared_sequence=False, live_planes=40))
    (m, n, k, batch), cls, frac = _split_key(kb)
    assert batch == 16 and cls[3] is False and cls[4] == ("sharded", 8)
    assert frac == 40 / (31 * 8)


def test_sharded_plans_are_never_measured_persisted_or_borrowed(
        tmp_path, monkeypatch):
    """``autotune=True`` ranks a sharded problem by the model, nothing of
    it reaches the store, and it borrows no measured plan of its shape."""
    registry.clear_plan_cache()
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
    try:
        registry._PLAN_CACHE[_plan_key(Problem(64, 32, 8, platform="cpu"))] \
            = registry.Plan("blocked", 64, 16, 1e-6, "measured")
        plan = registry.select_plan(64, 32, 8, platform="cpu", devices=4,
                                    autotune=True)
        assert plan.source == "model"
        assert registry.save_plan_cache() is not None
        stored = json.loads((tmp_path / "plans.json").read_text())["plans"]
        assert [len(e["key"]) for e in stored] == [8]
    finally:
        registry.clear_plan_cache()


def test_column_sharded_comm_bytes_live_window():
    """Live-window accounting equal to the reference's: a padded
    sequence prices fewer live bands than the dense grid, the static
    bound gives the same window, and a shape mismatch raises."""
    m_loc, n, k, D, n_b, k_b = 64, 32, 16, 4, 8, 4
    rng = np.random.default_rng(0)
    C, S = _waves(rng, n, 2)
    live = RotationSequence(torch.from_numpy(C),
                            torch.from_numpy(S)).pad_to(k)
    from repro.core.sequence import RotationSequence as JSeq
    jlive = JSeq(C, S).pad_to(k)
    dense = dist.column_sharded_comm_bytes(m_loc, n, k, D, n_b, k_b)
    assert dense == j_comm_bytes(m_loc, n, k, D, n_b, k_b)
    assert dense["bands"] == 4 and dense["live_bands"] == 4
    win = dist.column_sharded_comm_bytes(m_loc, n, k, D, n_b, k_b,
                                         sequence=live)
    assert win == j_comm_bytes(m_loc, n, k, D, n_b, k_b, sequence=jlive)
    assert win["live_bands"] == 1 and win["pipelined"] < dense["pipelined"]
    bound = dist.column_sharded_comm_bytes(m_loc, n, k, D, n_b, k_b,
                                           live_planes=2 * (n - 1))
    assert bound == j_comm_bytes(m_loc, n, k, D, n_b, k_b,
                                 live_planes=2 * (n - 1))
    with pytest.raises(ValueError):
        dist.column_sharded_comm_bytes(m_loc, n, k + 1, D, n_b, k_b,
                                       sequence=live)


@pytest.mark.parametrize("method", ["blocked", "auto"])
def test_rotation_service_with_a_mesh(runs, method):
    """``RotationService(mesh=...)`` drains equal to the unsharded
    service bit for bit; a named method shards (``DTensor`` results)."""
    _, _, ranks = runs
    for out in ranks:
        assert out[f"sv_{method}"]
    assert ranks[0]["sv_blocked_dtensor"]


def test_stream_engine_with_a_mesh(runs):
    _, _, ranks = runs
    assert all(out["se_equal"] for out in ranks)


@pytest.mark.parametrize("ndim", [2, 3])
def test_delayed_buffer_with_a_mesh(runs, ndim):
    """A ``DelayedRotationBuffer(mesh=...)`` accumulates equal to the
    unsharded buffer bit for bit, 2D and batched, and ends sharded."""
    _, _, ranks = runs
    for out in ranks:
        assert out[f"db_{ndim}d"] and out[f"db_{ndim}d_dtensor"]


def test_mesh_arguments_are_checked(runs):
    """A ``mesh`` that is not a ``DeviceMesh`` is a ``TypeError``, an
    axis it does not name (or named out of its order) a ``ValueError``,
    as are a kernel that cannot run on a shard and rows that do not
    divide."""
    _, _, ranks = runs
    for out in ranks:
        assert out["ck_not_a_mesh"] and out["ck_unknown_axis"]
        assert out["ck_not_shard_capable"] and out["ck_rows"]


@pytest.mark.gpu
def test_one_rank_over_nccl_on_the_card(tmp_path):
    """``D = 1`` on the card: the sharded ``cuda_batched`` plan equals the
    replicated one bit for bit in one launch, and ``auto`` stays
    replicated with the pick of ``seq.plan(like=A)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import datetime

    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import random_sequence
    from repro_torch.kernels.rotseq_batched import kernel as batched_k
    torch.cuda.set_device(0)
    tdist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        gen = torch.Generator().manual_seed(0)
        A = torch.randn((512, 384), generator=gen).cuda()
        seq = random_sequence(384, 40, generator=gen, device="cuda")
        want = seq.plan(like=A, method="cuda_batched").apply(A)
        plan = dist.plan_sharded(seq, like=A, mesh=mesh,
                                 method="cuda_batched")
        before = batched_k.LAUNCHES
        got = plan.apply(A).full_tensor()
        assert batched_k.LAUNCHES - before == 1
        assert torch.equal(got, want)
        auto = dist.plan_sharded(seq, like=A, mesh=mesh)
        assert not auto.execute_sharded
        assert auto.method == seq.plan(like=A).method
    finally:
        tdist.destroy_process_group()
