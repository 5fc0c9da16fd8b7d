"""Measured autotune, the persisted plan cache and cross-shape interpolation.

The port's ``repro_torch.core.registry`` against the reference's
``repro.core.registry``.  The first eleven tests mirror the reference's
(``tests/test_api_dispatch.py``, the five plan-cache tests of
``tests/test_eig.py``, ``tests/test_rotation_service.py``,
``tests/test_serving_cost_model.py``, ``tests/test_rotseq_batched.py``)
with the port's backend names, its key layout
``(m, n, k, dtype, platform, signs, batch, shared_sequence[, "live",
count])`` and the torch/CUDA build string in place of the JAX version.
Then the port against the reference itself: the synthetic waves a
measurement times, bit for bit, and the interpolation decisions on one
planted cache.  Then the port rules (the per-request widening, the
failing candidate, the model's pick kept inside the margin), and ``autotune=`` through every entry point, equal to
``autotune=False`` within the family rule (bit for bit on the rotation
family, 1e-5 relative where a GEMM-family backend takes part).

CPU timings are noisy: like the reference's, these tests assert sources,
cache hits and candidate sets, never which backend wins.  The suite runs
with ``REPRO_PLAN_CACHE=off`` (``tests/conftest.py``); a persistence test
points it at a ``tmp_path`` file and clears the in-memory cache after.
Tests marked ``gpu`` autotune on the card.
"""
import dataclasses
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
from repro_torch import RotationSequence
from repro_torch.core import (apply_rotation_sequence, jacobi_apply_basis,
                              jacobi_eigh, random_sequence)
from repro_torch.core import registry
from repro_torch.core.blocked import rot_sequence_blocked
from repro_torch.core.registry import (Plan, Problem, clear_plan_cache,
                                       plan_cache_stats, select_plan)
from repro_torch.eig import DelayedRotationBuffer, eigh_givens, svd_givens
from repro_torch.launch import serve as launcher
from repro_torch.serve import RotationService, StreamEngine, synthetic_stream

PLAIN = {"unoptimized", "wavefront", "blocked", "accumulated"}
GEMM = {"accumulated", "cuda_mxu"}
GEMM_TOL = 1e-5   # relative Frobenius error where a GEMM backend takes part


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Every test starts and ends with an empty in-memory cache, so no
    measured entry leaks into a later ``auto`` assertion of this worker."""
    clear_plan_cache()
    jreg.clear_plan_cache()
    yield
    clear_plan_cache()
    jreg.clear_plan_cache()


def _persist(monkeypatch, tmp_path):
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(path))
    return path


def _key(**prob) -> tuple:
    return registry._plan_key(Problem(**prob))


def _record_measurements(monkeypatch) -> list:
    """Record ``(problem, plan)`` of every candidate autotune times."""
    seen = []
    orig = registry._measure_plans

    def measure(problem, plans):
        seen.extend((problem, plan) for plan in plans)
        return orig(problem, plans)

    monkeypatch.setattr(registry, "_measure_plans", measure)
    return seen


def _same_family(got, want, methods) -> None:
    if GEMM & set(methods):
        err = float((got.double() - want.double()).norm()
                    / want.double().norm())
        assert err <= GEMM_TOL, (methods, err)
    else:
        assert torch.equal(got, want), methods


# ------------------------------------------- mirrored reference tests ----

def test_cross_shape_plan_interpolation():
    """An unmeasured shape borrows the nearest measured plan of its class
    before the cost model is run (``tests/test_api_dispatch.py``)."""
    donor = select_plan(16, 48, 6, platform="cpu", autotune=True,
                        autotune_top=2)
    assert donor.source == "measured"
    borrowed = select_plan(20, 64, 8, platform="cpu")
    assert borrowed.source == "interpolated"
    assert borrowed.method == donor.method
    assert (borrowed.n_b, borrowed.k_b) == (donor.n_b, donor.k_b)
    hits = plan_cache_stats()["hits"]
    assert select_plan(20, 64, 8, platform="cpu") == borrowed
    assert plan_cache_stats()["hits"] == hits + 1
    # another class (signs) does not borrow it
    assert select_plan(20, 64, 8, platform="cpu",
                       signs=True).source == "model"
    # the nearest of two donors wins
    clear_plan_cache()
    near = _key(m=16, n=48, k=6, platform="cpu")
    far = _key(m=1024, n=4096, k=128, platform="cpu")
    registry._PLAN_CACHE[near] = dataclasses.replace(donor,
                                                     source="measured")
    registry._PLAN_CACHE[far] = dataclasses.replace(
        donor, method="accumulated", n_b=96, k_b=96, source="measured")
    pick = select_plan(20, 64, 8, platform="cpu")
    assert pick.source == "interpolated"
    assert pick.method == donor.method and pick.n_b == donor.n_b
    # beyond the log-distance cap the cost model is the better guess
    assert select_plan(16384, 16384, 2048,
                       platform="cpu").source == "model"
    # autotune=True measures over a borrowed entry
    assert select_plan(20, 64, 8, platform="cpu", autotune=True,
                       autotune_top=1).source == "measured"


def test_autotune_measures_and_caches():
    plan = select_plan(16, 48, 6, platform="cpu", autotune=True,
                       autotune_top=2)
    assert plan.source == "measured"
    assert plan.est_seconds > 0
    again = select_plan(16, 48, 6, platform="cpu", autotune=True,
                        autotune_top=2)
    assert again == plan
    assert plan_cache_stats()["hits"] >= 1
    # a measured plan is reused by plain auto calls ...
    assert select_plan(16, 48, 6, platform="cpu") == plan
    # ... and autotune=True upgrades a model-ranked entry
    clear_plan_cache()
    assert select_plan(16, 48, 6, platform="cpu").source == "model"
    assert select_plan(16, 48, 6, platform="cpu", autotune=True,
                       autotune_top=2).source == "measured"


def test_plan_cache_persistence_roundtrip(tmp_path, monkeypatch):
    path = _persist(monkeypatch, tmp_path)
    plan = select_plan(16, 48, 6, platform="cpu", autotune=True,
                       autotune_top=2)
    assert plan.source == "measured"
    assert path.exists()  # written through on a measurement
    clear_plan_cache()
    assert registry.load_plan_cache() == 1
    again = select_plan(16, 48, 6, platform="cpu", autotune=True)
    assert again.source == "persisted"  # not measured again
    assert (again.method, again.n_b, again.k_b) == (plan.method, plan.n_b,
                                                    plan.k_b)


def test_plan_cache_persistence_disabled(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE", "off")
    assert registry.plan_cache_path() is None
    assert registry.save_plan_cache() is None
    assert registry.load_plan_cache() == 0


def test_plan_cache_ignores_corrupt_file(tmp_path, monkeypatch):
    path = _persist(monkeypatch, tmp_path)
    path.write_text("{not json")
    assert registry.load_plan_cache() == 0


def test_plan_cache_save_merges_foreign_entries(tmp_path, monkeypatch):
    """A writer keeps the plans another process persisted."""
    _persist(monkeypatch, tmp_path)
    key_a = _key(m=8, n=8, k=4, platform="cpu")
    registry._PLAN_CACHE[key_a] = Plan(method="blocked", n_b=8, k_b=4,
                                       est_seconds=1e-6, source="measured")
    registry.save_plan_cache()
    clear_plan_cache()   # "another process": another key, the same file
    key_b = _key(m=16, n=16, k=8, platform="cpu")
    registry._PLAN_CACHE[key_b] = Plan(
        method="accumulated", n_b=16, k_b=16, est_seconds=2e-6,
        source="measured")
    registry.save_plan_cache()
    clear_plan_cache()
    assert registry.load_plan_cache() == 2
    assert set(registry._PLAN_CACHE) == {key_a, key_b}


def test_plan_cache_rejects_other_torch_build(tmp_path, monkeypatch):
    path = _persist(monkeypatch, tmp_path)
    key = _key(m=8, n=8, k=4, platform="cpu")
    registry._PLAN_CACHE[key] = Plan(method="blocked", n_b=8, k_b=4,
                                     est_seconds=1e-6, source="measured")
    assert registry.save_plan_cache() == str(path)
    payload = json.loads(path.read_text())
    assert payload["torch"] == registry._version_str()
    payload["torch"] = "torch 0.0.1 cuda None"
    path.write_text(json.dumps(payload))
    clear_plan_cache()
    assert registry.load_plan_cache() == 0


def test_autotune_upgrades_interpolated_and_persists_once(tmp_path,
                                                          monkeypatch):
    """An interpolated entry upgraded by autotune is measured and
    persisted once: one entry a key across repeated saves
    (``tests/test_rotation_service.py``)."""
    path = _persist(monkeypatch, tmp_path)
    assert select_plan(16, 48, 6, platform="cpu", autotune=True,
                       autotune_top=2).source == "measured"
    assert select_plan(20, 64, 8, platform="cpu").source == "interpolated"
    assert select_plan(20, 64, 8, platform="cpu", autotune=True,
                       autotune_top=1).source == "measured"
    registry.save_plan_cache()
    registry.save_plan_cache()
    keys = [tuple(e["key"]) for e in json.loads(path.read_text())["plans"]]
    assert len(keys) == len(set(keys))
    assert _key(m=20, n=64, k=8, platform="cpu") in keys
    # interpolated entries themselves are never persisted
    clear_plan_cache()
    assert registry.load_plan_cache() == 2
    assert all(p.source == "persisted"
               for p in registry._PLAN_CACHE.values())


# the serving cost model's acceptance bucket (tests/test_serving_cost_model.py)
M, N, K_PAD, LIVE = 16, 32, 8, 155


def _seed_measured(batch, shared, method):
    key = _key(m=M, n=N, k=K_PAD, platform="cuda", batch=batch,
               shared_sequence=shared, live_planes=LIVE)
    registry._PLAN_CACHE[key] = Plan(method=method, est_seconds=1e-6,
                                     source="measured")


def _bucket_plan(batch, shared):
    return select_plan(M, N, K_PAD, platform="cuda", batch=batch,
                       shared_sequence=shared, live_planes=LIVE)


def test_interpolation_never_crosses_the_ownership_class():
    # a measured per-request plan at distance 0 is not borrowed by the
    # shared twin, nor the other way round
    _seed_measured(64, False, "unoptimized")
    assert _bucket_plan(64, True).source == "model"
    clear_plan_cache()
    _seed_measured(64, True, "accumulated")
    assert _bucket_plan(64, False).source == "model"


def test_interpolation_transfers_within_the_per_request_class():
    _seed_measured(64, False, "cuda_batched")
    near = _bucket_plan(32, False)
    assert near.source == "interpolated"
    assert near.method == "cuda_batched"


def test_interpolation_respects_liveness_class():
    """A measured plane-skipping plan keyed with live planes does not
    transfer to the dense grid of the same shape: the dense problem gets
    the model's own plan, at the model's price (here also
    ``cuda_batched``: the wavefront kernel's 7 bands of 96 columns walk
    46 chunk iterations, 30 of them its pipeline's fill); nearby
    live-annotated problems borrow it (``tests/test_rotseq_batched.py``)."""
    registry._PLAN_CACHE[_key(m=4096, n=96, k=102, platform="cuda",
                              live_planes=95 * 8)] = Plan(
        "cuda_batched", est_seconds=1e-5, source="measured")
    model = registry._modeled_plans(
        Problem(m=4096, n=96, k=102, platform="cuda"))[0]
    dense = select_plan(4096, 96, 102, platform="cuda")
    assert dense.source == "model"
    assert (dense.method, dense.n_b, dense.k_b) == (model.method, model.n_b,
                                                    model.k_b)
    assert dense.est_seconds == pytest.approx(model.est_seconds)
    assert dense.est_seconds != 1e-5
    near = select_plan(4096, 96, 102, platform="cuda", live_planes=95 * 10)
    assert near.method == "cuda_batched"
    assert near.source == "interpolated"


# ----------------------------------------- the port against the reference ----

SYNTH = [dict(m=8, n=12, k=5), dict(m=8, n=12, k=5, signs=True),
         dict(m=4, n=33, k=16, live_planes=32 * 5),
         dict(m=4, n=33, k=16, live_planes=32 * 5 + 7, signs=True),
         dict(m=4, n=9, k=3, batch=4, shared_sequence=False)]


@pytest.mark.parametrize("prob", SYNTH)
def test_synthetic_waves_equal_reference(prob):
    """The waves a measurement times are the reference's, bit for bit,
    draw after draw of one generator (a per-request batch draws one set
    a request)."""
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(prob.get("batch", 1)):
        got = registry._synthetic_waves(Problem(platform="cpu", **prob), rt)
        want = jreg._synthetic_waves(jreg.Problem(platform="cpu", **prob),
                                     rj)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.dtype == np.float64
                np.testing.assert_array_equal(g, w)
    assert rt.random() == rj.random()   # both drew as much


# measured entries planted in both registries, each under its own
# package's key for the same problem: (problem, plan)
PLANTED = [
    (dict(m=64, n=64, k=16), dict(method="blocked", n_b=32, k_b=8)),
    (dict(m=256, n=256, k=32), dict(method="accumulated", n_b=64, k_b=64)),
    (dict(m=64, n=64, k=16, signs=True),
     dict(method="blocked", n_b=16, k_b=8)),
    (dict(m=64, n=64, k=16, batch=8),
     dict(method="accumulated", n_b=32, k_b=32)),
    (dict(m=16, n=32, k=8, batch=8, shared_sequence=False, live_planes=155),
     dict(method="blocked", n_b=16, k_b=8)),
    (dict(m=16, n=32, k=8, batch=8, live_planes=155),
     dict(method="accumulated", n_b=16, k_b=16)),
    (dict(m=32, n=32, k=8, dtype="float64"),
     dict(method="blocked", n_b=8, k_b=4)),
]
QUERIES = [
    dict(m=80, n=64, k=16), dict(m=200, n=256, k=32),
    dict(m=128, n=128, k=24), dict(m=4096, n=4096, k=512),
    dict(m=64, n=64, k=12, signs=True), dict(m=64, n=64, k=16, batch=4),
    dict(m=64, n=64, k=16, batch=64),
    dict(m=16, n=32, k=8, batch=16, shared_sequence=False, live_planes=186),
    dict(m=16, n=32, k=8, batch=16, shared_sequence=False),
    dict(m=20, n=32, k=8, batch=8, live_planes=155),
    dict(m=16, n=32, k=8, batch=8, shared_sequence=False, live_planes=155,
         signs=True),
    dict(m=32, n=40, k=8, dtype="float64"), dict(m=32, n=40, k=8),
]


@pytest.mark.parametrize("query", QUERIES)
def test_interpolation_decisions_agree_with_reference(query):
    """On the same planted measurements both registries borrow the same
    donor, or both fall back to the cost model."""
    for prob, plan in PLANTED:
        registry._PLAN_CACHE[_key(platform="cpu", **prob)] = Plan(
            est_seconds=1e-6, source="measured", **plan)
        jreg._PLAN_CACHE[jreg._plan_key(jreg.Problem(
            platform="cpu", **prob))] = jreg.Plan(
                est_seconds=1e-6, source="measured", **plan)
    got = select_plan(platform="cpu", **query)
    want = jreg.select_plan(platform="cpu", **query)
    assert (got.source == "interpolated") == (want.source
                                              == "interpolated")
    assert got.source in ("interpolated", "model")
    if got.source == "interpolated":
        assert (got.method, got.n_b, got.k_b) == (want.method, want.n_b,
                                                  want.k_b)


def test_split_key_decodes_the_port_layout_only():
    dense = _key(m=5, n=9, k=4, platform="cpu", batch=3)
    assert registry._split_key(dense) == (
        (5, 9, 4, 3), ("float32", "cpu", False, True), None)
    live = _key(m=5, n=9, k=4, platform="cpu", batch=3,
                shared_sequence=False, live_planes=16)
    assert registry._split_key(live)[1:] == (
        ("float32", "cpu", False, False), 16 / 32)
    with pytest.raises(ValueError):
        registry._split_key((5, 9, 4, "float32", "cpu", False, False))


def test_load_drops_foreign_layouts_and_unregistered_backends(
        tmp_path, monkeypatch):
    """Entries of another key layout or backend load nothing, and an
    in-memory measured entry wins over disk."""
    path = _persist(monkeypatch, tmp_path)
    good = _key(m=8, n=8, k=4, platform="cpu")
    mine = _key(m=9, n=9, k=4, platform="cpu")
    plans = [
        {"key": list(good), "method": "blocked", "n_b": 8, "k_b": 4,
         "est_seconds": 1e-6},
        {"key": list(mine), "method": "blocked", "n_b": 8, "k_b": 4,
         "est_seconds": 1e-6},
        {"key": [8, 8, 4, "float32", "cpu", False, False],
         "method": "blocked", "n_b": 8, "k_b": 4, "est_seconds": 1e-6},
        {"key": list(_key(m=7, n=8, k=4, platform="cpu")),
         "method": "pallas_wave", "est_seconds": 1e-6},
        {"key": [[8], 8, 4, "float32", "cpu", False, 1, True],
         "method": "blocked", "est_seconds": 1e-6},
    ]
    path.write_text(json.dumps({"format": 1,
                                "torch": registry._version_str(),
                                "plans": plans}))
    held = Plan(method="accumulated", n_b=8, k_b=8, est_seconds=2e-6,
                source="measured")
    registry._PLAN_CACHE[mine] = held
    assert registry.load_plan_cache() == 1
    assert registry._PLAN_CACHE[good].source == "persisted"
    assert registry._PLAN_CACHE[mine] == held
    assert set(registry._PLAN_CACHE) == {good, mine}


# ----------------------------------------------------------- port rules ----

def test_priced_off_device():
    for method in registry.registered_methods():
        kernel = method.startswith("cuda_")
        assert registry._priced_off_device(method, "cpu") == kernel
        assert registry._priced_off_device(method, "cuda") != kernel


def test_per_request_widening_skips_backends_priced_off_device(
        monkeypatch):
    """A per-request batch widens to the best plan of each eligible
    backend, but not to one priced off its device: on the host the
    kernels' plain versions are not timed (the reference would)."""
    seen = _record_measurements(monkeypatch)
    plan = select_plan(M, N, K_PAD, platform="cpu", batch=8,
                       shared_sequence=False, live_planes=LIVE,
                       autotune=True, autotune_top=1)
    assert plan.source == "measured"
    assert {p.method for _, p in seen} == PLAIN
    assert all(prob.sequences == 8 for prob, _ in seen)
    # the reference's rule would have widened to every eligible backend
    eligible = {s.name for s in registry.eligible_backends(seen[0][0])}
    assert eligible - PLAIN == {"cuda_wave", "cuda_mxu", "cuda_batched"}
    # a shared-sequence batch is not widened
    seen.clear()
    select_plan(M, N, K_PAD, platform="cpu", batch=8, live_planes=LIVE,
                autotune=True, autotune_top=1)
    assert len(seen) == 1


@pytest.mark.parametrize("exc", [ValueError, RuntimeError])
def test_a_refused_candidate_is_skipped_and_a_fault_propagates(
        monkeypatch, exc):
    """A backend's ``ValueError`` (its own argument checks, before any
    launch) skips the candidate; any other exception propagates and
    caches nothing."""
    first = registry._modeled_plans(Problem(m=16, n=48, k=6,
                                            platform="cpu"))[0]
    spec = registry.get_backend(first.method)

    def refusing(A, C, S, **kw):
        if (kw.get("n_b"), kw.get("k_b")) == (first.n_b, first.k_b):
            raise exc("refused")
        return spec.fn(A, C, S, **kw)

    monkeypatch.setitem(registry._REGISTRY, first.method,
                        dataclasses.replace(spec, fn=refusing))
    seen = _record_measurements(monkeypatch)
    if exc is ValueError:
        plan = select_plan(16, 48, 6, platform="cpu", autotune=True,
                           autotune_top=3)
        assert plan.source == "measured" and len(seen) == 3
        assert seen[0][1] == first
        assert (plan.method, plan.n_b, plan.k_b) != (first.method,
                                                     first.n_b, first.k_b)
    else:
        with pytest.raises(RuntimeError, match="refused"):
            select_plan(16, 48, 6, platform="cpu", autotune=True)
        assert plan_cache_stats()["size"] == 0


def test_candidates_are_timed_in_turns(monkeypatch):
    """Every candidate gets one warm call, then one timed call a round in
    a shuffled order, for at least 20 ms a candidate in all."""
    order, t = [], 2.0 ** -10   # seconds a call, exact in binary
    monkeypatch.setattr(registry, "_time_call",
                        lambda fn, device: order.append(fn) or t)
    prob = Problem(m=8, n=12, k=5, platform="cpu")
    plans = registry._modeled_plans(prob)[:3]
    assert registry._measure_plans(prob, plans) == [t] * 3
    rounds = math.ceil(registry._MEASURE_SECONDS / t)
    assert len(order) == 3 * rounds
    assert all(len(set(order[i:i + 3])) == 3 for i in range(0, 3 * rounds, 3))


def test_autotune_ranks_by_the_model_where_it_cannot_measure(monkeypatch):
    """Without a card a ``cuda`` problem cannot be timed here: autotune
    ranks by the model, as the reference does for another platform."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = _record_measurements(monkeypatch)
    plan = select_plan(3840, 3840, 180, platform="cuda", autotune=True)
    assert plan.source == "model" and not seen
    assert plan == registry._modeled_plans(
        Problem(m=3840, n=3840, k=180, platform="cuda"))[0]


@pytest.mark.parametrize("gain,keeps_model", [(1.05, True), (1.08, True),
                                              (1.25, False)])
def test_autotune_keeps_the_model_pick_inside_the_margin(monkeypatch, gain,
                                                         keeps_model):
    """A measured candidate replaces the model's pick only when it is
    faster by more than ``_MEASURED_MARGIN``; the pick is measured
    either way."""
    prob = Problem(m=8, n=12, k=5, platform="cpu")
    model = registry._modeled_plans(prob)[0]
    t = 1e-3

    def measure(problem, plans):
        return [t if (pl.method, pl.n_b, pl.k_b)
                == (model.method, model.n_b, model.k_b) else t / gain
                for pl in plans]

    monkeypatch.setattr(registry, "_measure_plans", measure)
    plan = select_plan(8, 12, 5, platform="cpu", autotune=True,
                       autotune_top=3)
    assert plan.source == "measured"
    assert ((plan.method, plan.n_b, plan.k_b)
            == (model.method, model.n_b, model.k_b)) == keeps_model
    assert plan.est_seconds == (t if keeps_model else t / gain)


# --------------------------------------------------------- entry points ----

def _inputs(m, n, k, seed):
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn((m, n), generator=gen)
    return A, random_sequence(n, k, generator=gen, device="cpu")


def test_seq_plan_and_apply_rotation_sequence(monkeypatch):
    seen = _record_measurements(monkeypatch)
    A, seq = _inputs(24, 40, 7, 1)
    plan = seq.plan(like=A, autotune=True)
    assert plan.plan.source == "measured" and seen
    assert plan.to_dict()["plan"]["source"] == "measured"
    model = seq.plan(like=A, autotune=False)   # the measured entry, reused
    assert model.plan == plan.plan
    clear_plan_cache()
    base = apply_rotation_sequence(A, seq.cos, seq.sin, method="auto")
    base_method = seq.plan(like=A).method
    clear_plan_cache()
    out = apply_rotation_sequence(A, seq.cos, seq.sin, method="auto",
                                  autotune=True)
    _same_family(out, base, [base_method, seq.plan(like=A).method])


def test_jacobi_apply_basis_autotune(monkeypatch):
    torch.set_num_threads(1)
    gen = torch.Generator().manual_seed(3)
    X = torch.randn((12, 12), generator=gen, dtype=torch.float64)
    res = jacobi_eigh((X + X.T) / 2, cycles=3)
    want = jacobi_apply_basis(res)
    method = res.rotation_sequence().plan(like=want).method
    clear_plan_cache()
    seen = _record_measurements(monkeypatch)
    got = jacobi_apply_basis(res, autotune=True)
    assert seen and all(prob.signs for prob, _ in seen)
    got_method = res.rotation_sequence().plan(like=want).method
    _same_family(got, want, [method, got_method])


def _flushed(M, recording, **kw):
    buf = DelayedRotationBuffer(M, k_delay=8, **kw)
    buf.push_sequence(recording).flush()
    return buf


def test_delayed_buffer_autotune_measures_on_first_flush_only(monkeypatch):
    rng = np.random.default_rng(4)
    th = rng.uniform(0, 2 * np.pi, (15, 29))
    rec = RotationSequence(torch.from_numpy(np.cos(th)),
                           torch.from_numpy(np.sin(th)))
    eye = torch.eye(16)
    base = _flushed(eye, rec)
    seen = _record_measurements(monkeypatch)
    clear_plan_cache()
    tuned = _flushed(eye, rec, autotune=True)
    assert tuned.autotune and tuned.flushes == base.flushes == 4
    (plan,) = tuned._plans.values()
    assert plan.plan.source == "measured"
    # one resolution measured its candidates; the later flushes rebound
    assert len({id(prob) for prob, _ in seen}) == 1
    assert len({(prob.m, prob.n, prob.k) for prob, _ in seen}) == 1
    (base_plan,) = base._plans.values()
    _same_family(tuned.value, base.value, [plan.method, base_plan.method])
    # a batched accumulator takes autotune through apply_batched
    stack = torch.stack([eye, eye.flip(0)])
    clear_plan_cache()
    b_tuned = _flushed(stack, rec, autotune=True)
    for i in range(2):
        _same_family(b_tuned.value[i], stack[i] @ base.value,
                     [plan.method, base_plan.method,
                      next(iter(b_tuned._plans.values())).method])


@pytest.mark.parametrize("solver", ["qr", "jacobi", "svd"])
def test_eig_solvers_autotune_equal_model(solver, monkeypatch):
    """``eigh_givens`` (QR and Jacobi) and ``svd_givens`` with
    ``autotune=True`` equal their ``autotune=False`` results within the
    family rule; the values come from the host and are equal."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((20, 20))
    H = torch.from_numpy((X + X.T) / 2).float()
    if solver == "svd":
        run = lambda **kw: svd_givens(torch.from_numpy(  # noqa: E731
            X[:, :14]).float(), k_delay=8, **kw)
    else:
        run = lambda **kw: eigh_givens(H, method=solver,  # noqa: E731
                                       k_delay=8, **kw)
    base = run()
    methods = {p.method for p in registry._PLAN_CACHE.values()}
    clear_plan_cache()
    seen = _record_measurements(monkeypatch)
    tuned = run(autotune=True)
    assert seen
    assert any(p.source == "measured"
               for p in registry._PLAN_CACHE.values())
    methods |= {p.method for p in registry._PLAN_CACHE.values()}
    for got, want in zip(tuned, base):
        if got.ndim == 1:
            assert torch.equal(got, want)
        else:
            _same_family(got, want, methods)


def test_rotation_service_and_stream_autotune(monkeypatch):
    requests = synthetic_stream(12, seed=2, device="cpu")
    base = RotationService(slots=4, store=False).apply_many(requests)
    methods = {p.method for p in registry._PLAN_CACHE.values()}
    clear_plan_cache()
    seen = _record_measurements(monkeypatch)
    svc = RotationService(slots=4, autotune=True, store=False)
    tuned = svc.apply_many(requests)
    assert svc.autotune and svc.stats["plans_resolved"] == 3
    assert all(p.plan.source == "measured" for p in svc._plans.values())
    assert {prob.batch for prob, _ in seen} == {4}
    methods |= {p.method for p in svc._plans.values()}
    for got, want in zip(tuned, base):
        _same_family(got, want, methods)
    clear_plan_cache()
    with StreamEngine(slots=4, autotune=True, store=False) as eng:
        tickets = [eng.submit(s, A) for s, A in requests]
        streamed = [t.result(timeout=60.0) for t in tickets]
    assert eng.service.autotune
    methods |= {p.method for p in eng.service._plans.values()}
    for got, want in zip(streamed, base):
        _same_family(got, want, methods)


@pytest.mark.parametrize("mode", [[], ["--stream"]])
def test_launcher_rotations_autotune(mode, capsys, monkeypatch):
    seen = _record_measurements(monkeypatch)
    launcher.main(["--rotations", *mode, "--autotune", "--check",
                   "--device", "cpu", "--requests", "9", "--slots", "4"])
    out = capsys.readouterr().out
    assert "check: " in out and "9 requests in" in out
    assert seen and {prob.batch for prob, _ in seen} == {4}


def test_autotune_in_a_fresh_process_reads_the_store(tmp_path, monkeypatch):
    """A measured plan persisted by one process plans as ``persisted`` in
    another that points at the same file; a neighbouring shape borrows
    it."""
    path = _persist(monkeypatch, tmp_path)
    plan = select_plan(16, 48, 6, platform="cpu", autotune=True,
                       autotune_top=2)
    code = ("import json, repro_torch\n"
            "from repro_torch.core import registry as r\n"
            "p = r.select_plan(16, 48, 6, platform='cpu')\n"
            "q = r.select_plan(20, 56, 7, platform='cpu')\n"
            "print(json.dumps([p.source, p.method, p.n_b, p.k_b, "
            "q.source, q.method]))\n")
    env = dict(os.environ, REPRO_PLAN_CACHE=str(path),
               PYTHONPATH=str(pathlib.Path(__file__).parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.splitlines()[-1]
    assert json.loads(out) == ["persisted", plan.method, plan.n_b,
                               plan.k_b, "interpolated", plan.method]


# -------------------------------------------------------------- the card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4])
def test_autotune_on_the_card_measures_a_kernel(batch, monkeypatch):
    """At a ``1024 x 1024`` target (and a per-request batch of 4) autotune
    measures the hand-written kernels on the card and its pick holds to
    the blocked plain version: bit for bit on the rotation family."""
    dev = _cuda()
    seen = _record_measurements(monkeypatch)
    gen = torch.Generator().manual_seed(7)
    seqs = [random_sequence(1024, 41, generator=gen, device=dev)
            for _ in range(batch)]
    A = torch.randn((batch, 1024, 1024), generator=gen).to(dev)
    if batch == 1:
        plan = seqs[0].plan(like=A[0], autotune=True)
        out = plan.apply(A[0])[None]
    else:
        plan = seqs[0].plan(like=A, autotune=True, shared_sequence=False)
        out = plan.apply_batched(A, sequences=seqs)
    assert plan.plan.source == "measured"
    assert plan.method.startswith("cuda_")
    assert any(p.method.startswith("cuda_") for _, p in seen)
    assert not any(registry._priced_off_device(p.method, "cuda")
                   for _, p in seen)
    want = torch.stack([rot_sequence_blocked(A[i], s.cos, s.sin)
                        for i, s in enumerate(seqs)])
    _same_family(out, want, [plan.method])


def test_shared_sequence_candidates_are_timed_through_plan_apply(
        monkeypatch):
    """A shared-sequence candidate is timed as its caller runs it, through
    ``SequencePlan.apply`` on the problem's synthetic inputs (every
    plan's host packing included), one call a warm-up and one a round."""
    from repro_torch.core import sequence as seqmod
    calls = []
    orig = seqmod.SequencePlan.apply

    def apply(self, A):
        calls.append((self.method, dict(self.kwargs), tuple(A.shape)))
        return orig(self, A)

    monkeypatch.setattr(seqmod.SequencePlan, "apply", apply)
    t = 2.0 ** -10
    monkeypatch.setattr(registry, "_time_call",
                        lambda fn, device: (fn(), t)[1])
    prob = Problem(m=8, n=12, k=5, platform="cpu", batch=3)
    plans = registry._modeled_plans(prob)[:3]
    assert registry._measure_plans(prob, plans) == [t] * 3
    rounds = math.ceil(registry._MEASURE_SECONDS / t)
    assert len(calls) == 3 * (1 + rounds)
    assert {c[2] for c in calls} == {(24, 12)}
    assert {(meth, tuple(sorted(kw.items()))) for meth, kw, _ in calls} \
        == {(pl.method, tuple(sorted(pl.kwargs().items()))) for pl in plans}

