"""Cost-model-attributed roofline records.

Mirror of :mod:`repro.obs.roofline`.

The registry's SS6 cost model predicts memops and flops for every
candidate plan; this module compares those predictions with what a
dispatch actually did, so a mis-modelled backend cannot win
``method="auto"`` unnoticed.

Every instrumented dispatch (``SequencePlan.apply`` /
``apply_batched``) records the resolved problem, chosen backend+tile,
live-plane count, the model's predicted flops / bytes / seconds
(computed by :func:`repro_torch.core.registry.cost_components`, the
same arithmetic the planner ranked candidates with, priced by the
platform record of the target's device in :mod:`repro_torch.hw`: the
H100 on the card), and the measured wall time (host clock between two
synchronizes of the target's device).  ``model_fraction = predicted_s / measured_s``: ≈1 means the
model explains the dispatch, ≪1 means the backend is far off its
modelled roofline (or the model is wrong — either way, worth a look),
and drift over time is visible in the exported BENCH/OBS artifacts.

Predictions are pure arithmetic on problem shape; only ``measured_s``
and ``model_fraction`` touch the clock, and :func:`snapshot` mirrors
the metrics convention so ``metrics.zeroed_timings`` can strip exactly
those fields for determinism tests.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List

_lock = threading.Lock()
_records: List[Dict[str, Any]] = []

# keep the per-dispatch list bounded: serving loops can dispatch
# millions of times, and per-backend aggregates carry the signal
_MAX_RECORDS = 4096


def record_dispatch(*, backend: str, m_total: int, n: int, k: int,
                    batch: int, dtype: str, tile: Dict[str, Any],
                    planes_live: int, planes_total: int,
                    predicted_flops: float, predicted_bytes: float,
                    predicted_s: float, measured_s: float,
                    predicted_setup_s: float = 0.0,
                    predicted_stream_s: float = 0.0,
                    shared_sequence: bool = True,
                    comm_bytes: float = 0.0,
                    launches_per_shard: int = 0) -> None:
    frac = predicted_s / measured_s if measured_s > 0.0 else 0.0
    rec = {
        "backend": backend,
        "m_total": int(m_total),
        "n": int(n),
        "k": int(k),
        "batch": int(batch),
        "dtype": str(dtype),
        "tile": dict(tile),
        "planes_live": int(planes_live),
        "planes_total": int(planes_total),
        # per-request batches (shared_sequence=False) pay per-sequence
        # setup b times; the setup/stream attribution seconds are the
        # penalty-free per-term split from registry.cost_components
        "shared_sequence": bool(shared_sequence),
        "predicted_flops": float(predicted_flops),
        "predicted_bytes": float(predicted_bytes),
        "predicted_setup_s": float(predicted_setup_s),
        "predicted_stream_s": float(predicted_stream_s),
        "predicted_s": float(predicted_s),
        "measured_s": float(measured_s),
        "model_fraction": float(frac),
        # sharded dispatches: modeled inter-device traffic
        # and planned launches per shard (acceptance bar: exactly 1 for
        # the fused row-sharded path); 0/0 for single-device rows
        "comm_bytes": float(comm_bytes),
        "launches_per_shard": int(launches_per_shard),
    }
    with _lock:
        if len(_records) < _MAX_RECORDS:
            _records.append(rec)
        else:
            _records.append(rec)
            del _records[0]


def records() -> List[Dict[str, Any]]:
    with _lock:
        return [dict(r) for r in _records]


def reset() -> None:
    with _lock:
        _records.clear()


def snapshot() -> dict:
    """Per-dispatch records + per-backend aggregates, JSON-clean."""
    recs = records()
    agg: Dict[str, Dict[str, float]] = {}
    for r in recs:
        a = agg.setdefault(r["backend"], {
            "dispatches": 0, "planes_live": 0, "planes_total": 0,
            "predicted_flops": 0.0, "predicted_bytes": 0.0,
            "predicted_setup_s": 0.0, "predicted_stream_s": 0.0,
            "predicted_s": 0.0, "measured_s": 0.0,
            "comm_bytes": 0.0, "launches_per_shard": 0,
        })
        a["dispatches"] += 1
        a["planes_live"] += r["planes_live"]
        a["planes_total"] += r["planes_total"]
        a["predicted_flops"] += r["predicted_flops"]
        a["predicted_bytes"] += r["predicted_bytes"]
        a["predicted_setup_s"] += r.get("predicted_setup_s", 0.0)
        a["predicted_stream_s"] += r.get("predicted_stream_s", 0.0)
        a["predicted_s"] += r["predicted_s"]
        a["measured_s"] += r["measured_s"]
        a["comm_bytes"] += r.get("comm_bytes", 0.0)
        a["launches_per_shard"] = max(a["launches_per_shard"],
                                      r.get("launches_per_shard", 0))
    for a in agg.values():
        a["model_fraction"] = (a["predicted_s"] / a["measured_s"]
                               if a["measured_s"] > 0.0 else 0.0)
        split = a["predicted_setup_s"] + a["predicted_stream_s"]
        # share of the modeled (penalty-free) time spent on per-sequence
        # setup: ~1 flags a backend rebuilding factors per request
        a["setup_fraction"] = (a["predicted_setup_s"] / split
                               if split > 0.0 else 0.0)
    return {"dispatches": recs,
            "by_backend": {k: agg[k] for k in sorted(agg)}}
