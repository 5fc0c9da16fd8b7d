"""Port parity of ``repro_torch.serve``: RotationService and StreamEngine.

Within the port the contract is bitwise: bucketed results equal
per-request ``seq.plan(like=A).apply(A)`` for plain, signed and
reflector requests, and streamed results equal synchronous drains.  The
reference's own request stream, carried across with
``repro_torch.convert.requests_from_reference``, goes through both
services and agrees to the float32 bound of the other port tests (XLA
on the CPU contracts the plane form).  Each bucket is planned once, a
warm service plans nothing, and the stream engine's close policies,
round robin and backpressure behave as the reference's.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.serve import RotationService as JService
from repro.serve.rotations import synthetic_stream as j_stream
from repro_torch import RotationSequence
from repro_torch.convert import requests_from_reference
from repro_torch.core import registry
from repro_torch.serve import (Backpressure, DeadlineExceeded, EngineClosed,
                               RotationService, StreamEngine,
                               serve_plan_store_path, synthetic_stream)

TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _clean():
    registry.clear_plan_cache()
    yield
    registry.clear_plan_cache()


def _stream(n, seed=0, shapes=None):
    kw = {} if shapes is None else dict(shapes=shapes)
    return synthetic_stream(n, seed=seed, device="cpu", **kw)


def _alone(requests):
    return [seq.plan(like=A).apply(A) for seq, A in requests]


def _equal(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref)


def _signed_mix(n_requests=9, seed=7, m=16, n=24, k=8):
    """Plain, per-entry-sign and all-reflector requests of one shape."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (seq, A) in enumerate(_stream(n_requests, seed,
                                         shapes=((m, n, k),))):
        if i % 3 == 1:
            sign = torch.from_numpy(np.where(rng.random(seq.shape) < 0.5,
                                             1.0, -1.0).astype(np.float32))
            seq = RotationSequence(seq.cos, seq.sin, sign)
        elif i % 3 == 2:
            seq = RotationSequence(seq.cos, seq.sin, None, True)
        out.append((seq, A))
    return out


# -------------------------------------------------------- the service ----

def test_service_bitwise_and_one_plan_per_bucket():
    requests = _stream(24)
    refs = _alone(requests)
    misses0 = registry.plan_cache_stats()["misses"]
    svc = RotationService(slots=8, store=False)
    _equal(svc.apply_many(requests), refs)
    assert registry.plan_cache_stats()["misses"] - misses0 == 3
    assert svc.stats["plans_resolved"] == 3 and svc.stats["batches"] == 3
    misses1 = registry.plan_cache_stats()["misses"]
    _equal(svc.apply_many(requests), refs)   # later drains rebind
    assert registry.plan_cache_stats()["misses"] == misses1
    assert svc.stats["plans_resolved"] == 3


def test_service_agrees_with_the_reference_service():
    """The reference's own stream, carried across: both services agree
    to float32 tolerance, and the port's fused route agrees bitwise with
    its default route."""
    jreqs = j_stream(10, seed=3)
    reqs = requests_from_reference(
        [(s.to_dict(), np.asarray(A)) for s, A in jreqs], device="cpu")
    for (t, tA), (j, jA) in zip(reqs, jreqs):
        assert np.array_equal(t.cos.numpy(), np.asarray(j.cos))
        assert np.array_equal(tA.numpy(), np.asarray(jA))
    jouts = JService(slots=4, store=False).apply_many(jreqs)
    outs = RotationService(slots=4, store=False).apply_many(reqs)
    fused = RotationService(slots=4, store=False,
                            method="cuda_batched").apply_many(reqs)
    for out, f, jout, (seq, _) in zip(outs, fused, jouts, reqs):
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=5e-5 * seq.k, rtol=5e-5)
        assert torch.equal(out, f)


def test_service_partial_batch_pads_slots():
    requests = _stream(5, shapes=((16, 32, 8),))
    svc = RotationService(slots=8, store=False)
    _equal(svc.apply_many(requests), _alone(requests))
    assert svc.stats["padded_slots"] == 3
    assert svc.stats["requests"] == 5 and svc.stats["slots_executed"] == 8


@pytest.mark.parametrize("method", ["auto", "cuda_batched"])
def test_service_signed_and_reflector_requests(method):
    requests = _signed_mix()
    svc = RotationService(slots=4, store=False, method=method)
    _equal(svc.apply_many(requests), _alone(requests))
    # plain bucket + signed bucket (signed and reflector share it)
    assert svc.stats["plans_resolved"] == 2
    queued_signs = [k.signed for k in svc._plans]
    assert sorted(queued_signs) == [False, True]


def test_service_fused_bucket_execution_bitwise():
    requests = _stream(10)      # three buckets, partial drains
    svc = RotationService(slots=4, store=False, method="cuda_batched")
    _equal(svc.apply_many(requests), _alone(requests))
    assert svc.stats["padded_slots"] > 0
    assert {p.method for p in svc._plans.values()} == {"cuda_batched"}


def test_service_wave_padding_buckets_by_pow2():
    svc = RotationService(slots=8, store=False)
    (s5, A), = _stream(1, shapes=((8, 16, 5),))
    (s7, _), = _stream(1, seed=1, shapes=((8, 16, 7),))
    t1, t2 = svc.submit(s5, A), svc.submit(s7, A)
    svc.drain()
    assert svc.stats["plans_resolved"] == 1   # k=5 and k=7 share k_pad=8
    assert svc.stats["padded_waves"] == (8 - 5) + (8 - 7)
    assert torch.equal(svc.result(t1), s5.plan(like=A).apply(A))
    svc.result(t2)
    with pytest.raises(KeyError):
        svc.result(t1)   # collected exactly once
    # admission keeps a plain request's signs implicit
    svc.submit(s5, A)
    (queued,), = [q for q in svc._queues.values() if q]
    assert queued.seq.sign is None and queued.seq.k_live == 15 * 5


def test_service_warm_restart_zero_resolutions(tmp_path):
    store = str(tmp_path / "serve_plans.json")
    requests = _stream(24)
    svc = RotationService(slots=8, store=store)
    outs = svc.apply_many(requests)
    assert svc.stats["plans_resolved"] == 3 and os.path.exists(store)
    registry.clear_plan_cache()
    warm = RotationService(slots=8, store=store)
    _equal(warm.apply_many(requests), outs)
    assert warm.stats["plans_resolved"] == 0
    assert warm.stats["warm_plans"] == 3
    assert registry.plan_cache_stats()["misses"] == 0
    payload = json.loads(open(store).read())
    assert payload["torch"] == registry._version_str()
    assert len(payload["plans"]) == 3


def test_service_store_ignores_stale_and_corrupt_files(tmp_path):
    store = tmp_path / "serve_plans.json"
    requests = _stream(8, shapes=((16, 32, 8),))
    RotationService(slots=8, store=str(store)).apply_many(requests)
    payload = json.loads(store.read_text())
    payload["torch"] = "torch 0.0.1 cuda None"
    store.write_text(json.dumps(payload))
    svc = RotationService(slots=8, store=str(store))
    _equal(svc.apply_many(requests), _alone(requests))
    assert svc.stats["warm_plans"] == 0 and svc.stats["plans_resolved"] == 1
    store.write_text("{not json")
    svc = RotationService(slots=8, store=str(store))
    assert len(svc.apply_many(requests)) == 8
    assert svc.stats["plans_resolved"] == 1


def test_service_functional_with_persistence_off(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_PLAN_CACHE", "off")
    assert serve_plan_store_path() is None
    requests = _stream(12)
    _equal(RotationService(slots=4).apply_many(requests), _alone(requests))
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "p" / "plans.json"))
    assert serve_plan_store_path() == str(tmp_path / "p" / "serve_plans.json")


def test_service_rejects_bad_requests():
    svc = RotationService(slots=2, store=False)
    (seq, A), = _stream(1, shapes=((4, 16, 4),))
    with pytest.raises(ValueError, match="columns"):
        svc.submit(seq, torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="2D"):
        svc.submit(seq, torch.zeros((2, 4, 16)))
    with pytest.raises(ValueError, match="one device"):
        svc.submit(seq, A.to("meta"))
    with pytest.raises(ValueError, match="slots"):
        RotationService(slots=0)
    # a target given as an array goes where the sequence is
    t = svc.submit(seq, A.numpy())
    assert torch.equal(svc.result(t), seq.plan(like=A).apply(A))


# ----------------------------------------------------- the stream engine ----

def _run_stream(engine, requests, **kw):
    tickets = [engine.submit(seq, A, **kw) for seq, A in requests]
    engine.close(drain=True)
    return [t.result(timeout=TIMEOUT) for t in tickets]


@pytest.mark.parametrize("mix", ["shapes", "signed"])
def test_stream_bitwise_equals_sync(mix):
    requests = _stream(14, seed=5) if mix == "shapes" else _signed_mix()
    refs = RotationService(slots=4, store=False).apply_many(requests)
    eng = StreamEngine(slots=4, store=False)
    _equal(_run_stream(eng, requests), refs)
    _equal(refs, _alone(requests))
    assert eng.stats["completed"] == len(requests)


def test_age_close_fires_on_partial_bucket():
    requests = _stream(3, seed=1, shapes=((16, 32, 8),))
    eng = StreamEngine(slots=8, store=False, min_age_s=0.001)
    tickets = [eng.submit(seq, A) for seq, A in requests]
    for t in tickets:       # no close(): the age policy alone serves them
        t.result(timeout=TIMEOUT)
    assert eng.stats["closes_age"] >= 1 and eng.stats["closes_size"] == 0
    assert eng.service.stats["padded_slots"] >= 5
    eng.close()


def test_age_target_scales_with_cost_model():
    requests = _stream(8, seed=2, shapes=((16, 32, 8),))
    eng = StreamEngine(slots=8, store=False, start=False, min_age_s=0.004,
                       max_age_s=0.2, age_factor=8.0)
    key = eng.service._bucket_key(*requests[0])
    assert eng._age_target(key) == eng.min_age_s   # unplanned: the floor
    for seq, A in requests:
        eng.submit(seq, A)
    eng.close(drain=True)     # the inline drain plans the bucket
    est = eng.service.bucket_plan_estimate(key)
    assert est is not None and est > 0
    assert eng._age_target(key) == min(
        eng.max_age_s, max(eng.min_age_s, eng.age_factor * est))


def test_weighted_round_robin_serves_cold_bucket():
    eng = StreamEngine(slots=4, store=False, start=False, max_burst=2)
    hot = _stream(12, seed=3, shapes=((16, 32, 8),))
    cold = _stream(4, seed=4, shapes=((16, 64, 12),))
    for seq, A in hot + cold:
        eng.submit(seq, A)
    order = []
    for _ in range(4):
        with eng._lock:
            key, _, reason = eng._close_next_locked()
        order.append((key.n, reason))
    ns = [n for n, _ in order]
    assert ns[0] == 32 and 64 in ns[:3]
    assert all(r == "size" for _, r in order)
    eng.close(drain=False)


def test_backpressure_fail_policy_rejects():
    eng = StreamEngine(slots=4, store=False, start=False, max_pending=2,
                       backpressure="fail")
    requests = _stream(3, seed=8, shapes=((8, 16, 4),))
    kept = [eng.submit(*requests[0]), eng.submit(*requests[1])]
    with pytest.raises(Backpressure):
        eng.submit(*requests[2])
    assert eng.stats["rejected"] == 1
    eng.close(drain=True)     # the two admitted requests still drain
    _equal([t.result(timeout=TIMEOUT) for t in kept],
           _alone(requests[:2]))


def test_backpressure_shed_policy_drops_expired():
    eng = StreamEngine(slots=4, store=False, start=False, max_pending=3,
                       backpressure="shed")
    requests = _stream(5, seed=9, shapes=((8, 16, 4),))
    doomed = [eng.submit(*requests[i], deadline_s=0.0) for i in range(2)]
    keeper = eng.submit(*requests[2])
    admitted = eng.submit(*requests[3])     # sheds both expired tickets
    for t in doomed:
        with pytest.raises(DeadlineExceeded):
            t.result(timeout=1.0)
    assert eng.stats["shed"] == 2
    eng.submit(*requests[4])
    with pytest.raises(Backpressure):
        eng.submit(*requests[0])
    eng.close(drain=True)
    for t in (keeper, admitted):
        assert t.result(timeout=TIMEOUT) is not None


def test_backpressure_block_policy_waits_for_room():
    eng = StreamEngine(slots=2, store=False, max_pending=2,
                       backpressure="block", min_age_s=0.001)
    requests = _stream(7, seed=10, shapes=((8, 16, 4),))
    _equal(_run_stream(eng, requests), _alone(requests))
    assert eng.stats["submitted"] == eng.stats["completed"] == 7
    assert eng.stats["rejected"] == eng.stats["shed"] == 0


def test_graceful_shutdown_drains_everything():
    requests = _stream(11, seed=11)    # three buckets, none full
    eng = StreamEngine(slots=8, store=False, min_age_s=5.0, max_age_s=10.0)
    tickets = [eng.submit(seq, A) for seq, A in requests]
    eng.close(drain=True)
    assert all(t.done() for t in tickets)
    _equal([t.result() for t in tickets], _alone(requests))
    assert eng.stats["closes_drain"] >= 3


def test_close_without_drain_fails_pending_tickets():
    eng = StreamEngine(slots=8, store=False, start=False)
    requests = _stream(3, shapes=((8, 16, 4),))
    tickets = [eng.submit(seq, A) for seq, A in requests]
    eng.close(drain=False)
    for t in tickets:
        with pytest.raises(EngineClosed):
            t.result(timeout=1.0)
    with pytest.raises(EngineClosed):
        eng.submit(*requests[0])
    with StreamEngine(slots=4, store=False) as ctx:
        done = [ctx.submit(seq, A) for seq, A in requests]
    assert all(t.done() for t in done)


def test_failed_batch_fails_its_tickets():
    """A batch that raises fails its own tickets and never hangs them;
    the engine goes on serving."""
    eng = StreamEngine(slots=2, store=False, min_age_s=0.001)
    bad = _stream(2, shapes=((8, 16, 4),))
    (seq, A), = _stream(1, seed=1, shapes=((8, 20, 4),))
    original = eng.service.execute_batch

    def execute(key, seqs, targets):
        if key.n == 16:
            raise RuntimeError("launch failed")
        return original(key, seqs, targets)

    eng.service.execute_batch = execute
    failed = [eng.submit(s, X) for s, X in bad]
    for t in failed:
        with pytest.raises(RuntimeError, match="launch failed"):
            t.result(timeout=TIMEOUT)
    ok = eng.submit(seq, A)
    assert torch.equal(ok.result(timeout=TIMEOUT), seq.plan(like=A).apply(A))
    eng.close()


def test_engine_rejects_bad_arguments():
    with pytest.raises(ValueError, match="backpressure"):
        StreamEngine(backpressure="drop", start=False, store=False)
    with pytest.raises(ValueError, match="max_pending"):
        StreamEngine(max_pending=0, start=False, store=False)
    with pytest.raises(ValueError, match="service_kw"):
        StreamEngine(service=RotationService(store=False), store=False)


def test_inline_drain_pads_waves_unlike_the_reference():
    """An engine never started drains in ``close()``; the port pads each
    ticket's waves to its bucket there as the scheduler does.  The
    reference's inline drain skips that padding, so a wave count below
    its bucket's fails its tickets (ROADMAP Queue 3)."""
    from repro.serve import StreamEngine as JEngine

    jreqs = j_stream(2, shapes=((8, 16, 5),))
    jeng = JEngine(slots=4, store=False, start=False)
    jtickets = [jeng.submit(s, A) for s, A in jreqs]
    jeng.close(drain=True)
    for t in jtickets:
        with pytest.raises(ValueError, match="pad_to"):
            t.result(timeout=TIMEOUT)
    reqs = requests_from_reference(
        [(s.to_dict(), np.asarray(A)) for s, A in jreqs], device="cpu")
    eng = StreamEngine(slots=4, store=False, start=False)
    tickets = [eng.submit(s, A) for s, A in reqs]
    eng.close(drain=True)
    _equal([t.result(timeout=TIMEOUT) for t in tickets], _alone(reqs))
