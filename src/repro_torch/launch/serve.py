"""Serving launcher: batched LM decoding, or batched rotation serving.

Mirror of :mod:`repro.launch.serve`.  LM mode (default) drives the
``ServeEngine`` with weights drawn from ``--seed``, for every family but
the encoder-decoder one (``audio``: refused, its cache is made from
encoder frames)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --batch 4 --max-new 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --reduced --device cpu

Rotation mode drives the shape-bucketed ``RotationService`` over a
seeded mixed-shape stream of recorded rotation sequences (``--check``
holds every result against per-request application)::

  PYTHONPATH=src python -m repro_torch.launch.serve --rotations \\
      --requests 64 --slots 8 --check

``--stream`` drives the continuous-batching ``StreamEngine`` over the
same stream instead (``--check``: bit for bit against the synchronous
service).  ``--autotune`` measures the candidate plans of each bucket
when it is first resolved.  ``--device`` is ``cuda`` by default.

With ``--metrics-json PATH`` the run executes with
:mod:`repro_torch.obs` on and writes the metrics and roofline snapshot
(plan-cache counters, the admit to result latency histogram, each
backend's modeled against measured seconds) to ``PATH``; ``--trace
PATH`` also writes a Chrome trace of the plan / resolve / admit / drain
/ apply spans (Perfetto).  With obs on every dispatch on the card
synchronizes before and after itself, so the run is slower than one
without them.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.sequence import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import (RotationService, ServeEngine, StreamEngine,
                               synthetic_stream)


def _clock(device) -> float:
    """Host seconds, after the card (if any) finished its queued work."""
    obs.timing.sync(device)
    return obs.timing.now()


def _write_obs(args, mode: str, requests: int, seconds: float,
               stats: dict) -> None:
    """Write the snapshot (the run's ``stats`` in its meta, for holding
    the counters to them) and the trace the flags ask for."""
    if args.metrics_json:
        snap = obs.write_metrics_json(
            args.metrics_json,
            extra={"mode": mode, "requests": requests, "slots": args.slots,
                   "seconds": seconds, "stats": dict(stats)})
        lat = snap["histograms"].get("serve.request_latency_seconds", {})
        print(f"metrics -> {args.metrics_json} "
              f"(latency p50={lat.get('p50', 0) * 1e3:.2f} ms "
              f"p99={lat.get('p99', 0) * 1e3:.2f} ms)")
    if args.trace:
        n_ev = obs.write_trace(args.trace)
        print(f"trace -> {args.trace} ({n_ev} events)")


def _run_lm(args, device) -> None:
    cfg = get_config(args.arch)
    if cfg.is_encdec:
        # the reference's launcher fails here too: its ServeEngine calls
        # init_cache(batch, max_len), and the encoder-decoder's cache is
        # made from frames (init_cache(frames, max_len))
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family is not served by this "
            f"launcher; its cache needs encoder frames (drive "
            f"model.init_cache(frames, max_len) and model.decode_step)")
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    eng = ServeEngine(model, cfg, batch=args.batch, max_len=args.max_len)
    prompts = [[(7 * i + j) % cfg.vocab for j in range(4 + i)]
               for i in range(args.batch)]
    t0 = _clock(device)
    outs = eng.generate(prompts, max_new=args.max_new)
    dt = _clock(device) - t0
    toks = sum(len(o) for o in outs)
    for p, o in zip(prompts, outs):
        print(f"prompt {p} -> {o}")
    print(f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s batched, "
          f"{eng.steps} decode steps on {device})")


def _run_rotations(args, device) -> None:
    requests = synthetic_stream(args.requests, seed=args.seed, device=device)
    svc = RotationService(slots=args.slots, autotune=args.autotune)
    t0 = _clock(device)
    outs = svc.apply_many(requests)
    dt = _clock(device) - t0
    if args.check:
        for (seq, A), out in zip(requests, outs):
            ref = seq.plan(like=A).apply(A)
            err = float((out - ref).abs().max())
            if not err < 1e-5:
                raise AssertionError(
                    f"serving diverged from per-request: {err}")
        print("check: serving matches per-request application")
    s = svc.stats
    # req/s counts real requests only, never identity pad slots
    print(f"{s['requests']} requests in {dt * 1e3:.1f} ms "
          f"({s['requests'] / dt:.0f} req/s batched; {s['padded_slots']} "
          f"pad slots of {s['slots_executed']} executed)")
    print(f"buckets={len(svc._plans)} batches={s['batches']} "
          f"plans_resolved={s['plans_resolved']} "
          f"warm_plans={s['warm_plans']}")
    _write_obs(args, "rotations", s["requests"], dt, s)


def _run_stream(args, device) -> None:
    requests = synthetic_stream(args.requests, seed=args.seed, device=device)
    with StreamEngine(slots=args.slots, autotune=args.autotune) as eng:
        t0 = _clock(device)
        tickets = [eng.submit(seq, A) for seq, A in requests]
        outs = [t.result(timeout=600.0) for t in tickets]
        dt = _clock(device) - t0
    if args.check:
        refs = RotationService(slots=args.slots).apply_many(requests)
        if not all(torch.equal(r, o) for r, o in zip(refs, outs)):
            raise AssertionError(
                "streamed result diverged from synchronous drain")
        print("check: streamed results bit-equal to synchronous drains")
    s = eng.stats
    print(f"{s['completed']} requests in {dt * 1e3:.1f} ms "
          f"({s['completed'] / dt:.0f} req/s streamed; closes: "
          f"size={s['closes_size']} age={s['closes_age']} "
          f"drain={s['closes_drain']}; shed={s['shed']})")
    _write_obs(args, "stream", s["completed"], dt, s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rotations", action="store_true",
                    help="serve rotation-application requests instead of "
                         "LM decoding")
    ap.add_argument("--stream", action="store_true",
                    help="rotation mode: drive the StreamEngine instead of "
                         "the synchronous service")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=24,
                    help="rotation mode: number of requests to stream")
    ap.add_argument("--slots", type=int, default=8,
                    help="rotation mode: per-bucket batch capacity")
    ap.add_argument("--check", action="store_true",
                    help="rotation mode: verify against per-request apply")
    ap.add_argument("--autotune", action="store_true",
                    help="rotation mode: measure candidate plans when a "
                         "bucket is first resolved")
    ap.add_argument("--metrics-json", default=None,
                    help="rotation mode: enable repro_torch.obs and write "
                         "the metrics + roofline snapshot here")
    ap.add_argument("--trace", default=None,
                    help="rotation mode: enable span tracing and write "
                         "Chrome trace JSON here (view in ui.perfetto.dev)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.metrics_json or args.trace:
        obs.set_enabled(True)
        if args.trace:
            obs.runtime.set_trace_path(args.trace)

    if args.rotations:
        (_run_stream if args.stream else _run_rotations)(args, device)
        return
    if args.arch is None:
        ap.error("--arch is required unless --rotations is given")
    _run_lm(args, device)


if __name__ == "__main__":
    main()
