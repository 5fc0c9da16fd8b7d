"""Serving launcher: batched LM decoding, or batched rotation serving.

Mirror of :mod:`repro.launch.serve`.  LM mode (default) drives the
``ServeEngine`` with weights drawn from ``--seed``::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --batch 4 --max-new 16 --device cpu

Rotation mode drives the shape-bucketed ``RotationService`` over a
seeded mixed-shape stream of recorded rotation sequences (``--check``
holds every result against per-request application)::

  PYTHONPATH=src python -m repro_torch.launch.serve --rotations \\
      --requests 64 --slots 8 --check

``--stream`` drives the continuous-batching ``StreamEngine`` over the
same stream instead (``--check``: bit for bit against the synchronous
service).  ``--autotune`` measures the candidate plans of each bucket
when it is first resolved.  ``--device`` is ``cuda`` by default; the
reference's ``--metrics-json`` and ``--trace`` wait for the telemetry
slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.sequence import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import (RotationService, ServeEngine, StreamEngine,
                               synthetic_stream)


def _clock(device) -> float:
    """Host seconds, after the card (if any) finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _run_lm(args, device) -> None:
    cfg = get_config(args.arch)
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.rotations:
        (_run_stream if args.stream else _run_rotations)(args, device)
        return
    if args.arch is None:
        ap.error("--arch is required unless --rotations is given")
    _run_lm(args, device)


if __name__ == "__main__":
    main()
