#!/usr/bin/env python3
"""A/B the fused batched kernel's sources on one card, in every dtype.

    python3 tools/batched_half_ab.py TAG=SOURCE [TAG=SOURCE ...]

Builds each ``SOURCE`` (a ``rotseq_batched.cu``, this tree's or another
tree's, e.g. the parent unpacked by ``git archive`` under ``build/``) on
its own into ``build/ab/lib<TAG>.so`` (all ``nvcc`` calls at once, the
flags of ``kernels/_build.py``) and prints, one JSON line each:

- ``build``: each source's ptxas registers and spill bytes by
  instantiation;
- ``sass``: each instantiation's conversions, paired half ops and
  widenings (``tools/sass_ops.py``), and whether its float32
  instantiation's SASS equals the first source's (whitespace and the
  anonymous namespace's hash aside);
- ``time``: in turns (the sources in order, then reversed), each in a
  fresh process with this tree's wrapper bound to that library: the
  16 x ``1024²`` serving bucket of ``chip_smoke.py`` and its ``seq.T``
  staircases in float32, bfloat16 and float16, held to the plain
  version as bit views and timed (CUDA events, ms a launch), the
  special-value case of ``chip_smoke.py`` (bfloat16, float16), and
  ``cuda_batched``'s ``plan.apply`` at the paper shape (ms).

Needs a card and the CUDA toolkit.
"""
from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ab"

CHILD = r'''
import ctypes, json, sys
import torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as cs
from repro_torch import RotationSequence, random_sequence
from repro_torch.obs import timing
from repro_torch.kernels.rotseq_batched import kernel as bk
from repro_torch.kernels.rotseq_batched.ref import rotseq_batched_ref
cs.timing = timing
lib = ctypes.CDLL({lib!r})
for dt, entry in bk.ENTRY.items():
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bk._FN[dt] = fn
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(cs.SEED + 2)
ks = torch.randint(cs.KMIN, cs.KMAX + 1, (cs.B,), generator=gen).tolist()
seqs = [random_sequence(cs.NB, k, generator=gen, device=dev) for k in ks]
A0 = torch.randn((cs.B, cs.MB, cs.NB), generator=gen).to(dev)
row = {{}}
for tag, name in (("f32", "float32"), *cs.HALF.items()):
    dt = getattr(torch, name)
    padded = [RotationSequence(s.cos.to(dt), s.sin.to(dt)).pad_to(cs.KB)
              for s in seqs]
    A = A0.to(dt)
    _, _, args = cs.pack_batched(A, padded)
    _, _, args_t = cs.pack_batched(A, [s.T for s in padded])
    bits = []
    for a in (args, args_t):
        o, p = bk.rotseq_batched(*a)
        w, wp = rotseq_batched_ref(*a)
        bits.append(bool(cs.same_bits(o, w) and torch.equal(p, wp)))
    r = dict(bucket_bitwise=bits[0], staircase_bitwise=bits[1],
             bucket_ms=cs.time_ms(lambda: bk.rotseq_batched(*args), 10),
             staircase_ms=cs.time_ms(lambda: bk.rotseq_batched(*args_t),
                                     10))
    if tag != "f32":
        failed = []
        cs.check = lambda ok, what: ok or failed.append(what)
        r["special"] = cs.batched_special_case(A, padded, tag)
        r["special_failed"] = failed
        g = torch.Generator().manual_seed(cs.SEED)
        Ap = torch.randn((cs.M, cs.N), generator=g).to(dev, dt)
        sq = random_sequence(cs.N, cs.K, generator=g, device=dev)
        sq = RotationSequence(sq.cos.to(dt), sq.sin.to(dt))
        plan = sq.plan(like=Ap, method="cuda_batched")
        r["paper_equal_cuda_wave"] = bool(torch.equal(
            plan.apply(Ap), sq.plan(like=Ap, method="cuda_wave").apply(Ap)))
        r["paper_apply_ms"] = cs.time_ms(lambda: plan.apply(Ap), 3)
    row[tag] = r
print(json.dumps(row))
'''


# a band kernel's instantiation in a mangled name: (kernel, storage type)
_INSTANCE = re.compile(r"(rotseq_(?:wave|batched))_kernelILi\d+ELi\d+E"
                       r"(f|13__nv_bfloat16|6__half)")


def build(tag: str, sources, lib: Path):
    """``nvcc`` the ``sources`` into ``lib`` with the flags of
    ``kernels/_build.py``: ``(tag, lib, returncode, output, registers)``,
    ``registers`` the ptxas registers and spill bytes of every band
    kernel instantiation, by ``(kernel, mangled type)``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as kb
    proc = subprocess.run([kb._nvcc(), *kb.FLAGS, "-o", str(lib),
                           *map(str, sources)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\w+)'((?:(?!Compiling)"
                         r".)*)", log, re.S):
        t = _INSTANCE.search(m.group(1))
        used = re.search(r"Used (\d+) registers", m.group(2))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill",
                          m.group(2))
        if t and used:
            regs[t.groups()] = dict(registers=int(used.group(1)),
                                    spill_bytes=sum(map(int, spill.groups()))
                                    if spill else 0)
    return tag, lib, proc.returncode, log, regs


def sass(lib: Path) -> dict:
    """``{(kernel, mangled type): (opcode counts, normalised listing)}``
    of the band kernels' instantiations in ``lib``: the listing with
    whitespace and the anonymous namespace's hash taken out."""
    sys.path.insert(0, str(ROOT / "tools"))
    import sass_ops
    out = {}
    for name, body in sass_ops.listing(lib).items():
        t = _INSTANCE.search(name)
        if t:
            ops = collections.Counter(sass_ops._INSN.findall(body))
            text = [re.sub(r"_GLOBAL__N__\w+?_", "_GLOBAL__N__",
                           re.sub(r"\s+", " ", ln).strip())
                    for ln in body.splitlines() if ln.strip()]
            out[t.groups()] = (dict(instructions=sum(ops.values()),
                                    **sass_ops.conversions(ops)), text)
    return out


def main() -> int:
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    if not variants:
        print(__doc__)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda kv: build(kv[0], [kv[1]],
                                             OUT / f"lib{kv[0]}.so"),
                            variants.items()))
    libs = {}
    for tag, lib, rc, log, regs in built:
        print(json.dumps({"build": tag, "rc": rc, "ptxas": {
            t: r for (k, t), r in regs.items()
            if k == "rotseq_batched"}}), flush=True)
        if rc:
            print(log[-3000:], file=sys.stderr)
            return 1
        libs[tag] = lib
    first = None
    for tag, lib in libs.items():
        found = {t: v for (k, t), v in sass(lib).items()
                 if k == "rotseq_batched"}
        f32 = found.get("f", (None, None))[1]
        first = f32 if first is None else first
        print(json.dumps({"sass": tag, "f32_equals_first": f32 == first,
                          **{k: v[0] for k, v in found.items()}}),
              flush=True)
    env = {**os.environ, "REPRO_PLAN_CACHE": "off"}
    for tag in list(libs) + list(reversed(list(libs))):
        code = CHILD.format(root=str(ROOT), lib=str(libs[tag]))
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
