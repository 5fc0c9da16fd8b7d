#!/usr/bin/env python3
"""A/B the wavefront kernel's sources on one card, in every dtype.

    python3 tools/wave_half_ab.py TAG=CSRC_DIR [TAG=CSRC_DIR ...]

Builds each ``CSRC_DIR``'s ``rotseq_wave.cu`` and ``rotseq_batched.cu``
(this tree's ``src/repro_torch/csrc``, or another tree's, e.g. the parent
unpacked by ``git archive`` under ``build/``; a source finds the headers
beside it) on its own into ``build/ab/libwave_<TAG>.so`` (all ``nvcc``
calls at once, the flags of ``kernels/_build.py``; the build and SASS
helpers of ``tools/batched_half_ab.py``) and prints, one JSON line each:

- ``build``: each source's ptxas registers and spill bytes by
  instantiation of both band kernels;
- ``sass``: each wavefront instantiation's conversions, paired half ops
  and widenings (``tools/sass_ops.py``; the small band's tagged
  ``kb4/``), and which instantiations' SASS equals the first source's
  (whitespace and the anonymous namespace's hash aside): the float32
  wavefront kernel's and the fused kernel's in every dtype;
- ``time``: in turns (the sources in order, then reversed), each in a
  fresh process with this tree's wrapper bound to that library: one
  launch at the paper shape of ``chip_smoke.py`` (``3840²``, ``k = 180``)
  in float32, bfloat16 and float16 (CUDA events, ms a launch) and a
  checksum of its bits (equal across sources); the ragged signed problem
  (``3000 x 1000``, 37 waves) and, in half precision, the special-value
  case of ``chip_smoke.py`` held to the plain version as bit views; and
  at a source's first turn the paper shape held to the plain version.
  A source from before the band argument (``int kb``) is called at the
  default band through a shim.

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
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as cs
from repro_torch import RotationSequence, random_sequence
from repro_torch.obs import timing
from repro_torch.kernels.rotseq import kernel as wk
from repro_torch.kernels.rotseq.ref import rotseq_wave_ref
cs.timing = timing
lib = ctypes.CDLL({lib!r})
for dt, entry in wk.ENTRY.items():
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * ({banded} + 3) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # a source from before the band argument: one band, the default
    wk._FN[dt] = fn if {banded} else (
        lambda *a, fn=fn: fn(*a[:8], a[9]) if a[8] == 16 else -1)
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(cs.SEED)
A0 = torch.randn((cs.M, cs.N), generator=gen).to(dev)
seq = random_sequence(cs.N, cs.K, generator=gen, device=dev)
gen_r = torch.Generator().manual_seed(cs.SEED + 1)
Ar0 = torch.randn((3000, 1000), generator=gen_r).to(dev)
sr = random_sequence(1000, 37, generator=gen_r, device=dev)
sign = torch.where(torch.rand((999, 37), generator=gen_r) < 0.5, 1.0, -1.0)


def checksum(x):
    view = torch.int16 if x.element_size() == 2 else torch.int32
    b = x.contiguous().view(view).view(-1).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device) % 1000003
    return int((b * w).sum())


row = {{}}
for tag, name in (("f32", "float32"), *cs.HALF.items()):
    dt = getattr(torch, name)
    args = cs.pack_wave(A0.to(dt), seq.cos.to(dt), seq.sin.to(dt))
    out = wk.rotseq_wave(*args)
    r = dict(paper_ms=cs.time_ms(lambda: wk.rotseq_wave(*args), 10),
             paper_checksum=checksum(out))
    if {check!r}:
        r["paper_bitwise"] = bool(cs.same_bits(out, rotseq_wave_ref(*args)))
    del out
    a_r = cs.pack_wave(Ar0.to(dt), sr.cos.to(dt), sr.sin.to(dt),
                       sign.to(dev, dt))
    r["ragged_bitwise"] = bool(cs.same_bits(wk.rotseq_wave(*a_r),
                                            rotseq_wave_ref(*a_r)))
    if tag != "f32":
        failed = []
        cs.check = lambda ok, what: ok or failed.append(what)
        r["special"] = cs.wave_special_case(tag, dt, dev)
        r["special_failed"] = failed
    row[tag] = r
print(json.dumps(row))
'''


def main() -> int:
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    if not variants:
        print(__doc__)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(
            lambda kv: build(kv[0], [Path(kv[1]) / "rotseq_wave.cu",
                                     Path(kv[1]) / "rotseq_batched.cu"],
                             OUT / f"libwave_{kv[0]}.so"),
            variants.items()))
    libs = {}
    for tag, lib, rc, log, regs in built:
        print(json.dumps({"build": tag, "rc": rc, "ptxas": {
            f"{k}/{t}": r for (k, t), r in regs.items()}}), flush=True)
        if rc:
            print(log[-3000:], file=sys.stderr)
            return 1
        libs[tag] = lib
    first = None
    for tag, lib in libs.items():
        found = sass(lib)
        listings = {f"{k}/{t}": v[1] for (k, t), v in found.items()}
        first = listings if first is None else first
        print(json.dumps({
            "sass": tag,
            "equals_first": {key: text == first.get(key)
                             for key, text in listings.items()},
            **{t: v[0] for (k, t), v in found.items()
               if k == "rotseq_wave"}}), flush=True)
    env = {**os.environ, "REPRO_PLAN_CACHE": "off"}
    seen = set()
    for tag in list(libs) + list(reversed(list(libs))):
        banded = "int K, int kb, void* stream" in (
            Path(variants[tag]) / "rotseq_wave.cu").read_text()
        code = CHILD.format(root=str(ROOT), lib=str(libs[tag]),
                            check=tag not in seen, banded=int(banded))
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
