#!/usr/bin/env python3
"""A/B the wavefront kernel's small band (``k_b = 4``) between sources,
on one card, in turns.

    python3 tools/wave_small_ab.py TAG=CSRC_DIR [TAG=CSRC_DIR ...]

Builds each ``CSRC_DIR``'s ``rotseq_wave.cu`` (this tree's
``src/repro_torch/csrc``, or another tree's, e.g. the parent unpacked by
``git archive`` under ``build/``; the headers beside it) on its own into
``build/ab/libsmall_<TAG>.so`` (all ``nvcc`` calls at once, the flags of
``kernels/_build.py``) and prints the card's name and power limit, then
one JSON line each:

- ``build``: the ptxas registers and spill bytes of every wavefront
  instantiation (the small band's tagged ``kb4/``);
- ``sass``: which instantiations' SASS equals the first source's
  (whitespace and the anonymous namespace's hash aside);
- ``time``: in turns (the sources in order, then reversed), each in a
  fresh process with this tree's wrapper bound to that library, CUDA
  events over back-to-back launches (ms a launch, the best of three
  rounds) and a checksum of the result's bits, equal across sources:
  the eig flush ``(1024, 1024, 32)``, the paper shape ``(3840, 3840,
  180)`` and the ragged signed problem ``(3000, 1000, 37)``, each in
  float32, bfloat16 and float16 at both bands; at a source's first turn
  the small band's flush and ragged launches held to the plain version
  as bit views (the paper shape's plain version at ``k_b = 4`` takes
  minutes: ``chip_smoke.py`` holds that one).
- ``geometry``: the small band's launch at the flush (rows and bands a
  warp, warps, blocks, the SMs its blocks cover, steps a pass).

Needs a card and the CUDA toolkit.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ab"
sys.path.insert(0, str(ROOT / "tools"))

from batched_half_ab import build, sass  # noqa: E402

CHILD = r'''
import ctypes, json, sys
import torch
sys.path[:0] = [{root!r} + "/src"]
from repro_torch import random_sequence
from repro_torch.kernels.rotseq import kernel as wk
from repro_torch.kernels.rotseq.ref import rotseq_wave_ref
lib = ctypes.CDLL({lib!r})
for dt, entry in wk.ENTRY.items():
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    wk._FN[dt] = fn
dev = torch.device("cuda")


def operands(m, n, k, seed, dt, signs):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((m, n), generator=g)
    seq = random_sequence(n, k, generator=g)
    G = (torch.where(torch.rand((n - 1, k), generator=g) < 0.5, 1.0, -1.0)
         if signs else -torch.ones((n - 1, k)))
    return tuple(x.to(dev, dt).contiguous()
                 for x in (A.t(), seq.cos.t(), seq.sin.t(), G.t()))


def ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        t = a.elapsed_time(b) / reps
        best = t if best is None else min(best, t)
    return best


def bits(x):
    view = torch.int16 if x.element_size() == 2 else torch.int32
    return x.contiguous().view(view)


def checksum(x):
    b = bits(x).view(-1).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device) % 1000003
    return int((b * w).sum())


row = {{}}
cases = [(name, m, n, k, signs, dt, reps)
         for name, m, n, k, signs, reps in (
             ("flush", 1024, 1024, 32, False, 50),
             ("paper", 3840, 3840, 180, False, 5),
             ("ragged", 3000, 1000, 37, True, 20))
         for dt in (torch.float32, torch.bfloat16, torch.float16)]
for name, m, n, k, signs, dt, reps in cases:
    args = operands(m, n, k, 7 + m + k, dt, signs)
    key = f"{{name}}/{{str(dt)[6:]}}"
    r = {{}}
    for kb in (4, 16):
        out = wk.rotseq_wave(*args, k_b=kb)
        r[f"kb{{kb}}_ms"] = ms(lambda: wk.rotseq_wave(*args, k_b=kb), reps)
        r[f"kb{{kb}}_checksum"] = checksum(out)
        if {check!r} and kb == 4 and name != "paper":
            r["kb4_bitwise"] = bool(torch.equal(
                bits(out), bits(rotseq_wave_ref(*args, k_b=4))))
        del out
    row[key] = r
print(json.dumps(row))
'''


def main() -> int:
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    if not variants:
        print(__doc__)
        return 2
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import limits
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(
            lambda kv: build(kv[0], [Path(kv[1]) / "rotseq_wave.cu"],
                             OUT / f"libsmall_{kv[0]}.so"),
            variants.items()))
    libs = {}
    for tag, lib, rc, log, regs in built:
        print(json.dumps({"build": tag, "rc": rc, "ptxas": {
            t: r for (k, t), r in regs.items() if k == "rotseq_wave"}}),
            flush=True)
        if rc:
            print(log[-3000:], file=sys.stderr)
            return 1
        libs[tag] = lib
    first = None
    for tag, lib in libs.items():
        listings = {t: v[1] for (k, t), v in sass(lib).items()
                    if k == "rotseq_wave"}
        first = listings if first is None else first
        print(json.dumps({"sass": tag, "equals_first": {
            t: text == first.get(t) for t, text in listings.items()}}),
            flush=True)
    geo = limits.wave_small_geometry(1024)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps({"geometry": dict(
        geo, sms=sms, sms_covered=min(geo["blocks"], sms),
        steps_a_pass=limits.wave_small_steps(1024, 32))}), flush=True)
    env = {**os.environ, "REPRO_PLAN_CACHE": "off"}
    seen = set()
    for tag in list(libs) + list(reversed(list(libs))):
        code = CHILD.format(root=str(ROOT), lib=str(libs[tag]),
                            check=tag not in seen)
        seen.add(tag)
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=900,
                              env=env)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"time": tag, **json.loads(proc.stdout)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
