"""repro_torch.obs against repro.obs: metrics, tracing, roofline records,
the plan-cache lifecycle, kernel counters and the disabled-path contract.

The first sixteen tests mirror ``tests/test_obs.py`` one for one on the
port.  Where a test drives the reference too, both packages get the same
numpy-seeded inputs and their counters must be equal exactly: the
plan-cache lifecycle cold -> warm -> interpolated -> autotune-upgrade,
and ``launches``/``planes_applied``/``planes_skipped`` of each rotation
kernel wrapper (on the CPU a wrapper counts one launch a call, as the
reference counts in interpret mode).  ``bytes_moved`` is the port
kernel's own traffic and is not held to the reference's.

Then the port's own rules: with obs off no seam synchronizes or reads
the clock and outputs are bit-equal; under ``torch.autograd.grad`` the
forward records one dispatch and the gradient is bit-equal; tensors
wrapped by ``torch.func`` record nothing; the launcher's
``--metrics-json``/``--trace`` against the reference launcher's; and no
module of ``src/repro_torch`` but ``obs/timing.py`` names the clock.
Tests marked ``gpu`` hold the counters to the kernels' ``LAUNCHES`` on
the card.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import registry as jreg
from repro_torch import RotationSequence, obs
from repro_torch.core import registry
from repro_torch.core.registry import (clear_plan_cache, plan_cache_stats,
                                       select_plan)
from repro_torch.kernels.rotseq import kernel as wave_k
from repro_torch.kernels.rotseq_batched import kernel as batched_k
from repro_torch.kernels.rotseq_batched.ops import count_live_planes
from repro_torch.kernels.rotseq_mxu import kernel as mxu_k
from repro_torch.serve import RotationService, synthetic_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(autouse=True)
def _clean_obs():
    for pkg in (obs, jobs):
        pkg.reset()
    clear_plan_cache()
    jreg.clear_plan_cache()
    yield
    for pkg in (obs, jobs):
        pkg.reset()
    clear_plan_cache()
    jreg.clear_plan_cache()


def _seq(rng, n, k, device="cpu"):
    """A plain sequence of ``n`` columns and ``k`` waves from ``rng``."""
    th = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
    return RotationSequence(
        torch.from_numpy(np.cos(th).astype(np.float32)).to(device),
        torch.from_numpy(np.sin(th).astype(np.float32)).to(device))


def _targets(seed=0):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((12, 24)).astype(np.float32))
    Ab = torch.from_numpy(rng.standard_normal((3, 12, 24)).astype(
        np.float32))
    return A, Ab, _seq(rng, 24, 6)


# ------------------------------------------------- metrics primitives ----

def test_histogram_buckets_are_a_pure_function_of_the_value():
    from repro_torch.obs import metrics as m
    assert m.bucket_index(1e-7) == 0
    assert m.bucket_index(1e-6) == 10
    assert m.bucket_index(1e-1) == 60
    assert m.bucket_index(0.0) == 0
    assert m.bucket_index(-1.0) == 0
    assert m.bucket_index(1e9) == m.bucket_index(1e12)
    lo, hi = m.bucket_bounds(m.bucket_index(1e-4))
    assert lo <= 1e-4 < hi
    # the reference's layout: _BASE = 1e-7, 10 a decade, 110 buckets
    from repro.obs import metrics as jm
    assert (m._BASE, m._PER_DECADE, m._N_BUCKETS) == (1e-7, 10, 110)
    for v in (3e-9, 1e-7, 2.5e-5, 0.7, 123.0, 1e5):
        assert m.bucket_index(v) == jm.bucket_index(v)


def test_histogram_percentiles_are_geometric_bucket_midpoints():
    with obs.override(True):
        for v in (1e-4,) * 9 + (1e-1,):
            obs.observe("lat", v)
    h = obs.snapshot()["histograms"]["lat"]
    assert h["count"] == 10
    assert h["unit"] == "seconds"
    assert h["min"] == 1e-4 and h["max"] == 1e-1
    assert h["p50"] == pytest.approx(1e-4, rel=0.2)
    assert h["p99"] == pytest.approx(1e-1, rel=0.3)


def test_zeroed_timings_zeroes_seconds_histograms_only():
    with obs.override(True):
        obs.observe("t", 0.123)
        obs.observe("waves", 7.0, unit="waves")
        obs.inc("c", 3)
    z = obs.zeroed_timings(obs.snapshot())
    assert z["histograms"]["t"]["count"] == 1
    assert z["histograms"]["t"]["sum"] == 0.0
    assert z["histograms"]["t"]["p99"] == 0.0
    assert z["histograms"]["waves"]["sum"] == 7.0
    assert z["counters"]["c"] == 3


def test_disabled_hooks_record_nothing():
    # the port's switch is its own: turning the reference's on leaves it
    with obs.override(False), jobs.override(True):
        obs.inc("c")
        obs.gauge("g", 1.0)
        obs.observe("h", 0.5)
    snap = obs.snapshot()
    assert snap["counters"] == {}
    assert snap["gauges"] == {}
    assert snap["histograms"] == {}
    with obs.override(True), jobs.override(False):
        obs.inc("c")
    assert obs.snapshot()["counters"] == {"c": 1}
    assert jobs.snapshot()["counters"] == {}


# ------------------------------------------------------------ tracing ----

def test_span_is_null_without_a_trace_path():
    with obs.override(True):
        with obs.span("apply", m=4) as sp:
            sp.set(method="blocked")
    assert obs.trace.events() == []


def test_trace_exports_perfetto_loadable_chrome_events(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    with obs.override(True):
        prev = obs.runtime.set_trace_path(path)
        try:
            with obs.span("apply", m=4) as sp:
                sp.set(method="blocked")
            n = obs.write_trace()
        finally:
            obs.runtime.set_trace_path(prev)
    assert n == 1
    payload = json.loads(open(path).read())
    (ev,) = payload["traceEvents"]
    assert ev["ph"] == "X" and ev["name"] == "apply"
    assert ev["args"] == {"m": 4, "method": "blocked"}
    assert ev["dur"] >= 0 and ev["ts"] >= 0


# ------------------------------------- plan-cache counters, exactly ----

def _cache_counters(pkg) -> dict:
    return {k: v for k, v in pkg.snapshot()["counters"].items()
            if k.startswith("registry.plan_cache.")}


def test_plan_cache_counters_cold_warm_interpolated_upgrade():
    """The reference's lifecycle, step by step, on both packages: the
    port's counters equal the reference's after every call."""
    steps = [dict(m=16, n=48, k=6, autotune=True, autotune_top=1),
             dict(m=16, n=48, k=6),
             dict(m=20, n=64, k=8),
             dict(m=20, n=64, k=8),
             dict(m=20, n=64, k=8, autotune=True, autotune_top=1)]
    sources = ["measured", "measured", "interpolated", "interpolated",
               "measured"]
    want = [dict(misses=1), dict(hits=1, misses=1),
            dict(hits=1, misses=2, interpolated=1),
            dict(hits=2, misses=2, interpolated=1),
            dict(hits=2, misses=3, interpolated=1, autotune_upgrade=1)]
    with obs.override(True), jobs.override(True):
        for step, source, counts in zip(steps, sources, want):
            plan = select_plan(platform="cpu", **step)
            jplan = jreg.select_plan(platform="cpu", **step)
            assert plan.source == jplan.source == source
            port = _cache_counters(obs)
            assert port == _cache_counters(jobs)
            assert port == {f"registry.plan_cache.{k}": v
                            for k, v in counts.items()}


# ------------------------------------------------- dispatch + roofline ----

def test_sequence_dispatch_records_roofline_and_counters():
    A, Ab, seq = _targets()
    plan = seq.plan(like=A)
    with obs.override(True):
        plan.apply(A)
        plan.apply_batched(Ab)
        snap = obs.snapshot()
    assert snap["counters"]["sequence.applies"] == 2
    assert snap["histograms"]["sequence.apply_seconds"]["count"] == 2
    roof = snap["roofline"]
    assert len(roof["dispatches"]) == 2
    assert [d["batch"] for d in roof["dispatches"]] == [1, 3]
    for agg in roof["by_backend"].values():
        assert agg["predicted_flops"] > 0
        assert agg["predicted_bytes"] > 0
        assert agg["measured_s"] > 0
        assert agg["model_fraction"] > 0
    # priced by the target's device: the host record here, the same
    # arithmetic the planner ranked with
    rec = roof["dispatches"][0]
    comp = registry.cost_components(plan.method, registry.Problem(
        m=12, n=24, k=6, platform="cpu", live_planes=seq.k_live), plan.plan)
    assert rec["predicted_s"] == comp["seconds"]
    assert rec["predicted_bytes"] == comp["bytes"]


def test_disabled_obs_outputs_bit_identical_and_no_new_cache_keys(
        monkeypatch):
    """With obs off no seam synchronizes or reads the clock; with it on
    each dispatch synchronizes twice and no output bit moves."""
    calls = {"sync": 0, "now": 0}
    sync, now = obs.timing.sync, obs.timing.now

    def counted_sync(device):
        calls["sync"] += 1
        sync(device)

    def counted_now():
        calls["now"] += 1
        return now()

    monkeypatch.setattr(obs.timing, "sync", counted_sync)
    monkeypatch.setattr(obs.timing, "now", counted_now)
    A, Ab, seq = _targets()
    plan = seq.plan(like=A)
    requests = synthetic_stream(6, seed=3, device="cpu")

    def run():
        svc = RotationService(slots=4, store=False)
        return (plan.apply(A), plan.apply_direct(A), plan.apply_batched(Ab),
                svc.apply_many(requests))

    with obs.override(False):
        off = run()
    assert calls == {"sync": 0, "now": 0}
    size0 = plan_cache_stats()["size"]
    with obs.override(True):
        on = run()
    assert plan_cache_stats()["size"] == size0
    assert calls["sync"] >= 2 * 3 and calls["now"] > 0
    for a, b in zip(off[:3], on[:3]):
        assert torch.equal(a, b)
    for a, b in zip(off[3], on[3]):
        assert torch.equal(a, b)


def test_instrumented_apply_stays_differentiable():
    """``torch.autograd.grad``: the forward is concrete and records one
    dispatch, the backward (``seq.T`` through the same backend) records
    none, and the gradient equals the one with obs off bit for bit.  A
    tensor wrapped by ``torch.func.grad`` records nothing, as the
    reference's traced call does."""
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    plan = _seq(rng, 16, 4).plan(like=A, method="blocked")

    def grad():
        Ag = A.clone().requires_grad_(True)
        return torch.autograd.grad((plan.apply(Ag) ** 2).sum(), Ag)[0]

    with obs.override(False):
        g_off = grad()
    with obs.override(True):
        g_on = grad()
        snap = obs.snapshot()
    assert torch.equal(g_on, g_off)
    assert len(snap["roofline"]["dispatches"]) == 1
    assert snap["counters"]["sequence.applies"] == 1
    obs.reset()
    with obs.override(True):
        g_func = torch.func.grad(
            lambda a: (plan.apply_direct(a) ** 2).sum())(A)
        snap = obs.snapshot()
    assert g_func.shape == A.shape
    assert snap["roofline"]["dispatches"] == []
    assert "sequence.applies" not in snap["counters"]


def test_vmapped_route_records_at_the_apply_batched_level():
    """Per-request waves on a vmap-able backend run under
    ``torch.func.vmap``: one dispatch for the batch, no hook inside."""
    rng = np.random.default_rng(4)
    Ab = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    seqs = [_seq(rng, 16, 5) for _ in range(3)]
    plan = seqs[0].plan(like=Ab, method="wavefront", shared_sequence=False)
    assert registry.get_backend("wavefront").capability.supports_vmap
    with obs.override(False):
        off = plan.apply_batched(Ab, sequences=seqs)
    with obs.override(True):
        on = plan.apply_batched(Ab, sequences=seqs)
        snap = obs.snapshot()
    assert torch.equal(off, on)
    (rec,) = snap["roofline"]["dispatches"]
    assert rec["batch"] == 3 and rec["shared_sequence"] is False
    assert snap["counters"]["sequence.applies"] == 1


# --------------------------------------------------- serving + kernels ----

def test_service_metrics_account_pad_slots_and_latency():
    requests = synthetic_stream(8, seed=3, device="cpu")
    with obs.override(True):
        svc = RotationService(slots=4, store=False)
        svc.apply_many(requests)
        snap = obs.snapshot()
    c = snap["counters"]
    assert c["serve.requests"] == 8
    assert c["serve.slots_executed"] == svc.stats["slots_executed"]
    assert c.get("serve.pad_slots", 0) == svc.stats["padded_slots"]
    assert c["serve.batches"] == svc.stats["batches"]
    assert c["serve.plans_resolved"] == svc.stats["plans_resolved"]
    pad_fraction = snap["gauges"]["serve.pad_slot_fraction"]
    assert 0.0 <= pad_fraction < 1.0
    assert snap["gauges"]["serve.queue_depth"] == 0
    lat = snap["histograms"]["serve.request_latency_seconds"]
    assert lat["count"] == 8
    assert lat["p99"] >= lat["p50"] > 0


def test_stream_engine_counters_equal_its_stats():
    """The dispatcher thread and the caller both bump the shared
    registry: the ``serve.stream.*`` counters equal the engine's
    ``stats`` and every request's latency is observed once."""
    from repro_torch.serve import StreamEngine
    requests = synthetic_stream(10, seed=5, device="cpu")
    with obs.override(True):
        with StreamEngine(slots=4, store=False) as eng:
            tickets = [eng.submit(seq, A) for seq, A in requests]
        outs = [t.result(timeout=60) for t in tickets]
        snap = obs.snapshot()
    c = snap["counters"]
    for key, val in eng.stats.items():
        assert c.get(f"serve.stream.{key}", 0) == val, key
    assert c["serve.stream.completed"] == len(outs) == 10
    # batches run through the service's execute_batch, not its submit
    assert "serve.requests" not in c and c["serve.batches"] >= 3
    assert snap["histograms"]["serve.request_latency_seconds"]["count"] \
        == 10
    assert snap["gauges"]["serve.stream.pending"] == 0


def test_service_snapshot_bit_identical_across_runs():
    def run() -> str:
        clear_plan_cache()
        obs.reset()
        svc = RotationService(slots=4, store=False)
        svc.apply_many(synthetic_stream(8, seed=3, device="cpu"))
        return json.dumps(obs.zeroed_timings(obs.snapshot()),
                          sort_keys=True)
    with obs.override(True):
        first = run()
        second = run()
    assert first == second


def test_fused_kernel_accounting_counts_skipped_planes():
    rng = np.random.default_rng(0)
    b, m, n, k_req, k_pad = 4, 8, 16, 3, 8
    A = torch.from_numpy(rng.standard_normal((b, m, n)).astype(np.float32))
    seqs = [_seq(rng, n, k_req).pad_to(k_pad) for _ in range(b)]
    plan = seqs[0].plan(like=A, method="cuda_batched")
    with obs.override(True):
        plan.apply_batched(A, sequences=seqs)
        c = obs.snapshot()["counters"]
    live = sum(count_live_planes(s) for s in seqs)
    assert c["kernels.rotseq_batched.launches"] == 1
    assert c["kernels.rotseq_batched.planes_applied"] == live
    assert c["kernels.rotseq_batched.planes_skipped"] == \
        (n - 1) * k_pad * b - live
    assert c["kernels.rotseq_batched.bytes_moved"] == \
        batched_k.traffic_bytes(b, b, n, m, k_pad)


def test_eig_flush_waves_histogram():
    from repro_torch.eig import eigh_givens
    rng = np.random.default_rng(0)
    X = rng.standard_normal((12, 12)).astype(np.float32)
    H = (X + X.T) / 2
    with obs.override(True):
        eigh_givens(H, method="qr", k_delay=4, device="cpu")
        snap = obs.snapshot()
    flushes = snap["counters"]["eig.flushes"]
    h = snap["histograms"]["eig.waves_per_flush"]
    assert flushes >= 1
    assert h["unit"] == "waves"
    assert h["count"] == flushes
    assert h["max"] <= 4


# --------------------------------------------------------- artifacts ----

def test_write_metrics_json_roundtrip(tmp_path):
    path = str(tmp_path / "OBS_metrics.json")
    with obs.override(True):
        obs.inc("x", 2)
        snap = obs.write_metrics_json(path, extra={"mode": "test"})
    on_disk = json.loads(open(path).read())
    assert on_disk == json.loads(json.dumps(snap))
    assert on_disk["counters"]["x"] == 2
    assert on_disk["meta"] == {"mode": "test"}
    assert "roofline" in on_disk


# ------------------------------------------------------ thread safety ----

def test_metrics_are_thread_safe_under_contention():
    """More threads than cores hammer one counter, histogram and gauge
    with a short switch interval: no increment is lost."""
    n_threads, per_thread = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.override(True):
            def work():
                for i in range(per_thread):
                    obs.inc("ts.counter")
                    obs.observe("ts.hist", 1e-3)
                    obs.gauge("ts.gauge", i)

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            snap = obs.snapshot()
    finally:
        sys.setswitchinterval(old)
    total = n_threads * per_thread
    assert snap["counters"]["ts.counter"] == total
    h = snap["histograms"]["ts.hist"]
    assert h["count"] == total
    assert h["sum"] == pytest.approx(total * 1e-3)
    assert sum(h["buckets"].values()) == total
    assert snap["gauges"]["ts.gauge"] == per_thread - 1


# ------------------------------------- kernel counters vs the reference ----

_KERNEL_KEYS = ("launches", "planes_applied", "planes_skipped")


def _kernel_counts(pkg, name) -> dict:
    c = pkg.snapshot()["counters"]
    return {key: c.get(f"kernels.{name}.{key}") for key in _KERNEL_KEYS}


@pytest.mark.parametrize("kernel", ["rotseq", "rotseq_mxu",
                                    "rotseq_batched_shared",
                                    "rotseq_batched_per_request"])
def test_kernel_counters_equal_the_reference(kernel):
    """Same numpy inputs through each rotation wrapper of both packages
    (the reference in interpret mode): equal ``launches``,
    ``planes_applied`` and ``planes_skipped``; the port's ``bytes_moved``
    is its own kernel's traffic."""
    from repro.kernels.rotseq.ops import rot_sequence_wave as j_wave
    from repro.kernels.rotseq_batched.ops import \
        rot_sequence_batched as j_batched
    from repro.kernels.rotseq_mxu.ops import rot_sequence_mxu as j_mxu
    from repro_torch.kernels.rotseq.ops import rot_sequence_wave
    from repro_torch.kernels.rotseq_batched.ops import rot_sequence_batched
    from repro_torch.kernels.rotseq_mxu.ops import rot_sequence_mxu

    rng = np.random.default_rng(5)
    m, n, k, b = 8, 16, 20, 3
    th = rng.uniform(0.0, 2.0 * np.pi, (b, n - 1, k)).astype(np.float32)
    C, S = np.cos(th), np.sin(th)
    C[:, :, 11:], S[:, :, 11:] = 1.0, 0.0       # identity-padded tails
    C[1, 9:, :4], S[1, 9:, :4] = 1.0, 0.0       # a partly dead wave
    A = rng.standard_normal((b, m, n)).astype(np.float32)
    t = torch.from_numpy
    if kernel == "rotseq":
        name, tiles = "rotseq", dict(k_b=16)
        port = lambda: rot_sequence_wave(t(A[0]), t(C[0]), t(S[0]), **tiles)
        ref = lambda: j_wave(jnp.asarray(A[0]), jnp.asarray(C[0]),
                             jnp.asarray(S[0]), **tiles)
    elif kernel == "rotseq_mxu":
        name, tiles = "rotseq_mxu", dict(n_b=8, k_b=8)   # three bands
        port = lambda: rot_sequence_mxu(t(A[0]), t(C[0]), t(S[0]), **tiles)
        ref = lambda: j_mxu(jnp.asarray(A[0]), jnp.asarray(C[0]),
                            jnp.asarray(S[0]), m_blk=8, **tiles)
    else:
        name = "rotseq_batched"
        if kernel.endswith("shared"):
            C, S = C[1], S[1]
        port = lambda: rot_sequence_batched(t(A), t(C), t(S))
        ref = lambda: j_batched(jnp.asarray(A), jnp.asarray(C),
                                jnp.asarray(S), m_blk=8)
    with obs.override(True), jobs.override(True):
        port()
        jax.block_until_ready(ref())
    got = _kernel_counts(obs, name)
    assert got == _kernel_counts(jobs, name)
    assert got["launches"] == 1 and got["planes_applied"] > 0
    if name == "rotseq_batched":
        assert got["planes_skipped"] > 0
    assert obs.snapshot()["counters"][f"kernels.{name}.bytes_moved"] > 0


def test_kernel_traffic_formulas():
    """``bytes_moved`` follows each kernel's own trips through memory:
    ``rotseq_wave`` one pass of up to 12 bands (the reference models a
    trip a band), ``rotseq_mxu`` one trip a band launch, and
    ``rotseq_batched`` a trip a band of ``BATCHED_KB`` waves, the band
    its source is compiled for."""
    from repro_torch.kernels import limits
    assert wave_k.traffic_bytes(3840, 3840, 180) == \
        4 * (2 * 3840 * 3840 + 3 * 180 * 3839)            # 12 bands: 1 pass
    assert wave_k.traffic_bytes(64, 8, 193) == \
        4 * (2 * 2 * 64 * 8 + 3 * 193 * 63)               # 13 bands: 2
    T, w = 31, 128
    assert mxu_k.traffic_bytes(3840, T, 64, 64) == \
        4 * (2 * 3840 * T * 64 + 3840 * 64 + T * w * w)
    assert batched_k.traffic_bytes(16, 16, 1024, 1024, 64) == \
        4 * (2 * 16 * 1024 * 1024 * 4 + 3 * 16 * 64 * 1023) + 2 * 16 * 64 * 4
    cu = PORT / "csrc" / "rotseq_batched.cu"
    assert f"constexpr int kBand = {limits.BATCHED_KB};" in cu.read_text()


# ------------------------------------------------------ dtype argument ----

@pytest.mark.parametrize("dtype", [np.float32, "f4", torch.float32,
                                   np.dtype("float32")],
                         ids=["np.float32", "f4", "torch.float32",
                              "np.dtype"])
def test_select_plan_normalises_dtype_as_the_reference(dtype):
    plan = select_plan(64, 64, 4, dtype=dtype, platform="cpu")
    jdtype = np.float32 if isinstance(dtype, torch.dtype) else dtype
    jplan = jreg.select_plan(64, 64, 4, dtype=jdtype, platform="cpu")
    assert plan.method == jplan.method
    assert plan == select_plan(64, 64, 4, dtype="float32", platform="cpu")
    assert plan_cache_stats()["size"] == 1


# ----------------------------------------------------------- launcher ----

def _launch(module, tmp_path, tag, *extra):
    metrics, trace = tmp_path / f"{tag}.json", tmp_path / f"{tag}.trace"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", REPRO_PLAN_CACHE="off")
    out = subprocess.run(
        [sys.executable, "-m", module, "--rotations", "--check",
         "--metrics-json", str(metrics), "--trace", str(trace), *extra],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "check: serving matches" in out.stdout
    return json.loads(metrics.read_text()), json.loads(trace.read_text())


def test_launcher_writes_the_reference_metrics(tmp_path):
    """``--metrics-json``/``--trace`` of the port's launcher on the host
    against the reference launcher on the same seeded stream: the same
    counter names, equal ``serve.*`` counts, the spans of a served run,
    and a zeroed snapshot byte-identical between two runs."""
    snap, trace = _launch("repro_torch.launch.serve", tmp_path, "port",
                          "--device", "cpu")
    again, _ = _launch("repro_torch.launch.serve", tmp_path, "again",
                       "--device", "cpu")
    jsnap, _ = _launch("repro.launch.serve", tmp_path, "ref")
    assert sorted(snap["counters"]) == sorted(jsnap["counters"])
    serve = {k: v for k, v in snap["counters"].items()
             if k.startswith("serve.")}
    assert serve == {k: v for k, v in jsnap["counters"].items()
                     if k.startswith("serve.")}
    assert serve["serve.requests"] == snap["meta"]["requests"] == 24
    stats = snap["meta"]["stats"]
    assert [serve["serve.batches"], serve["serve.slots_executed"],
            serve.get("serve.pad_slots", 0),
            serve["serve.plans_resolved"]] == [
        stats["batches"], stats["slots_executed"], stats["padded_slots"],
        stats["plans_resolved"]]
    names = {ev["name"] for ev in trace["traceEvents"]}
    assert {"plan", "resolve", "apply", "apply_batched", "admit",
            "drain"} <= names
    for s in (snap, again):
        s.pop("meta")
    assert json.dumps(obs.zeroed_timings(snap), sort_keys=True) == \
        json.dumps(obs.zeroed_timings(again), sort_keys=True)


# ------------------------------------------------------- one clock ----

_CLOCK_ATTRS = {"perf_counter", "perf_counter_ns", "time", "time_ns",
                "monotonic", "monotonic_ns"}


def _clock_refs(source: str) -> list:
    """Lines naming ``time.perf_counter``, ``time.time`` (and their
    kin) or ``timeit``: attributes of ``time``, names imported from it,
    and any import of ``timeit``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Attribute) and node.attr in _CLOCK_ATTRS \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "time":
            found.append(node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.module in (
                "time", "timeit") and (node.module == "timeit" or any(
                    a.name in _CLOCK_ATTRS for a in node.names)):
            found.append(node.lineno)
        elif isinstance(node, ast.Import) and any(
                a.name == "timeit" for a in node.names):
            found.append(node.lineno)
    return found


def test_the_port_has_one_clock():
    """No module of the port but ``obs/timing.py`` reads the clock (the
    reference's analyzer rule RA502, as a test)."""
    for bad in ("import time\nt = time.perf_counter()\n",
                "from time import perf_counter\n", "import timeit\n",
                "import time\nx = time.time()\n"):
        assert _clock_refs(bad), bad
    timing = PORT / "obs" / "timing.py"
    assert _clock_refs(timing.read_text())
    offenders = {str(p.relative_to(ROOT)): _clock_refs(p.read_text())
                 for p in sorted(PORT.rglob("*.py")) if p != timing}
    assert {p: lines for p, lines in offenders.items() if lines} == {}


def test_obs_imports_torch_numpy_and_the_standard_library_only():
    """The port's own copy: nothing of ``repro.obs`` (which imports no
    JAX), nothing but ``torch``, ``numpy``, the standard library and the
    package itself."""
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy",
                                               "repro_torch"}
    files = sorted((PORT / "obs").glob("*.py"))
    assert {f.name for f in files} == {"__init__.py", "metrics.py",
                                       "roofline.py", "runtime.py",
                                       "timing.py", "trace.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert roots <= allowed, (f.name, roots)


def test_cost_model_and_plan_key_read_no_clock(monkeypatch):
    """Only measured seconds touch time: pricing, keying and a modeled
    pick read no clock, with obs on too (the reference's RA5 family)."""
    import time

    def clock():
        raise AssertionError("the cost model read the clock")

    monkeypatch.setattr(obs.timing, "now", clock)
    monkeypatch.setattr(time, "perf_counter", clock)
    with obs.override(True):
        for method in registry.registered_methods():
            prob = registry.Problem(m=64, n=64, k=8, platform="cuda",
                                    batch=4, shared_sequence=False,
                                    live_planes=300)
            registry.cost_components(method, prob)
            registry._plan_key(prob)
        select_plan(64, 64, 8, platform="cuda")


# ------------------------------------------------------------- card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("method,tiles", [("cuda_wave", {}),
                                          ("cuda_mxu", dict(n_b=64, k_b=64)),
                                          ("cuda_batched", {})])
def test_card_counters_equal_the_launches(method, tiles):
    """On the card each obs launch counter moves with its kernel's
    ``LAUNCHES`` (``cuda_mxu``'s factor launches under
    ``rotseq_batched``), and obs on changes no output (``cuda_mxu``
    within 1e-5, the GEMM family's rule)."""
    dev = _cuda()
    rng = np.random.default_rng(6)
    A = torch.from_numpy(rng.standard_normal((512, 512)).astype(
        np.float32)).to(dev)
    plan = _seq(rng, 512, 40, dev).plan(like=A, method=method, **tiles)
    kernels = {"rotseq": wave_k, "rotseq_mxu": mxu_k,
               "rotseq_batched": batched_k}
    with obs.override(False):
        off = plan.apply(A)
    before = {name: k.LAUNCHES for name, k in kernels.items()}
    with obs.override(True):
        on = plan.apply(A)
        counters = obs.snapshot()["counters"]
    for name, k in kernels.items():
        assert counters.get(f"kernels.{name}.launches", 0) == \
            k.LAUNCHES - before[name]
    if method == "cuda_mxu":
        err = float((on - off).double().norm() / off.double().norm())
        assert err <= 1e-5
    else:
        assert torch.equal(on, off)
    (rec,) = obs.snapshot()["roofline"]["dispatches"]
    assert rec["backend"] == method and rec["measured_s"] > 0
