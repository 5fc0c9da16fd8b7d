#!/usr/bin/env python3
"""A/B the accumulated kernel's sources on one card, in every dtype.

    python3 tools/mxu_half_ab.py TAG=CSRC_DIR [TAG=CSRC_DIR ...]

Builds each ``CSRC_DIR``'s ``rotseq_mxu_half.cu`` and ``rotseq_mxu.cu``
(this tree's ``src/repro_torch/csrc``, or another tree's, e.g. the parent
unpacked by ``git archive`` under ``build/``) on its own into
``build/ab/libmxu_<TAG>.so`` (all ``nvcc`` calls at once, the flags of
``kernels/_build.py``; the build helper of ``tools/batched_half_ab.py``)
and prints, one JSON line each:

- ``build``: each source's ptxas registers, spill bytes and wgmma
  warnings by instantiation of the half tier;
- ``sass``: each half instantiation's products (``HGMMA``: wgmma,
  ``HMMA``: mma.sync), conversions and instructions
  (``tools/sass_ops.py``);
- ``time``: in turns (the sources in order, then reversed), each in a
  fresh process with this tree's wrappers bound to that library: one
  band's launches at the paper shape of ``chip_smoke.py`` (``3840²``,
  ``k = 180``) at 128/128 and 64/64 in bfloat16 and float16, as that
  line times them (CUDA events, ms for all the bands' launches), a
  checksum of the result's bits, its largest difference from the plain
  version, ``plan.apply`` through ``cuda_mxu`` at each tiling (ms), and
  the float32 tier's launches at 128/128; at a source's first turn the
  application held to the float64 oracle as ``chip_smoke.py`` holds it
  (``half_mxu_errors``).  The factors come from this tree's fused kernel
  in every turn.

Needs a card and the CUDA toolkit.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ab"
sys.path.insert(0, str(ROOT / "tools"))

from batched_half_ab import build  # noqa: E402

CHILD = r'''
import ctypes, json, sys
import torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as cs
from repro_torch import random_sequence
from repro_torch.obs import timing
from repro_torch.core.blocked import num_tiles, rot_sequence_blocked
from repro_torch.kernels import _build
from repro_torch.kernels.rotseq_mxu import kernel as mk
from repro_torch.kernels.rotseq_mxu.ops import (band_factors,
                                                band_inputs_natural,
                                                rot_sequence_mxu)
from repro_torch.kernels.rotseq_mxu.ref import rotseq_mxu_ref
cs.timing = timing
_build.load()   # this tree's library: the factors' fused kernel
lib = ctypes.CDLL({lib!r})
for dt, entry in mk.ENTRY.items():
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mk._FN[dt] = fn
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(cs.SEED)
A0 = torch.randn((cs.M, cs.N), generator=gen).to(dev)
seq = random_sequence(cs.N, cs.K, generator=gen, device=dev)


def checksum(x):
    view = torch.int16 if x.element_size() == 2 else torch.int32
    b = x.contiguous().view(view).view(-1).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device) % 1000003
    return int((b * w).sum())


row = {{}}
for tag, name in (("f32", "float32"), *cs.HALF.items()):
    dt = getattr(torch, name)
    A, C, S = A0.to(dt), seq.cos.to(dt), seq.sin.to(dt)
    sweep = [cs.MXU_TILES] if tag == "f32" else cs.MXU_SWEEP
    if {check!r} and tag != "f32":
        oracle = rot_sequence_blocked(A.double(), C.double(), S.double())
    r = {{}}
    for tiles in sweep:
        n_b, k_b = tiles["n_b"], tiles["k_b"]
        T = num_tiles(cs.N, n_b, k_b)
        bands = -(-cs.K // k_b)
        Q0 = band_factors(C, S, 0, k_b, n_b, T, dtype=dt)
        fresh, init = band_inputs_natural(A, k_b, n_b, T)
        out = mk.rotseq_mxu(fresh, Q0, init)
        e = dict(ms=cs.time_ms(lambda: [mk.rotseq_mxu(fresh, Q0, init)
                                        for _ in range(bands)], 10),
                 checksum=checksum(out),
                 band_max_abs_err_vs_plain=cs.max_abs(
                     out.float(), rotseq_mxu_ref(fresh, Q0, init).float()))
        if tag != "f32":
            e["apply_ms"] = cs.time_ms(
                lambda: rot_sequence_mxu(A, C, S, **tiles), 5)
            if {check!r}:
                failed = []
                cs.check = lambda ok, what: ok or failed.append(what)
                e["errors"] = cs.half_mxu_errors(
                    rot_sequence_mxu(A, C, S, **tiles),
                    cs.mxu_half_plain(A, C, S, n_b, k_b), oracle, cs.K,
                    f"{{tag}} at {{n_b}}/{{k_b}}")
                e["failed"] = failed
        r[f"{{n_b}}/{{k_b}}"] = e
    row[tag] = r
print(json.dumps(row))
'''

# a half instantiation in a mangled name: (storage type, padded width)
_HALF = re.compile(r"rotseq_mxu_half_kernelI(13__nv_bfloat16|6__half)"
                   r"Li(\d+)E")
_TAG = {"13__nv_bfloat16": "bf16", "6__half": "f16"}


def half_report(log: str) -> dict:
    """``{"bf16/wp256": {registers, spill_bytes, wgmma_warnings}}`` of the
    half tier's instantiations in ``nvcc``'s output."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\w+)'((?:(?!Compiling)"
                         r".)*)", log, re.S):
        t = _HALF.search(m.group(1))
        if not t:
            continue
        used = re.search(r"Used (\d+) registers", m.group(2))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill",
                          m.group(2))
        out[f"{_TAG[t.group(1)]}/wp{t.group(2)}"] = dict(
            registers=int(used.group(1)) if used else None,
            spill_bytes=sum(map(int, spill.groups())) if spill else 0,
            wgmma_warnings=len(re.findall(r"wgmma", m.group(2))))
    return out


def sass_products(lib: Path) -> dict:
    """``{"bf16/wp256": {hgmma, hmma, conversion_total, instructions}}``
    of the half tier's instantiations in ``lib``."""
    import sass_ops
    out = {}
    for name, ops in sass_ops.functions(r"rotseq_mxu_half_kernel",
                                        lib=lib).items():
        t = _HALF.search(name)
        out[f"{_TAG[t.group(1)]}/wp{t.group(2)}"] = dict(
            hgmma=sum(n for op, n in ops.items() if op.startswith("HGMMA")),
            hmma=sum(n for op, n in ops.items() if op.startswith("HMMA")),
            conversion_total=sass_ops.conversions(ops)["conversion_total"],
            instructions=sum(ops.values()))
    return out


def main() -> int:
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    if not variants:
        print(__doc__)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(
            lambda kv: build(kv[0], [Path(kv[1]) / "rotseq_mxu_half.cu",
                                     Path(kv[1]) / "rotseq_mxu.cu"],
                             OUT / f"libmxu_{kv[0]}.so"),
            variants.items()))
    libs = {}
    for tag, lib, rc, log, _ in built:
        print(json.dumps({"build": tag, "rc": rc,
                          "ptxas": half_report(log)}), flush=True)
        if rc:
            print(log[-3000:], file=sys.stderr)
            return 1
        libs[tag] = lib
    for tag, lib in libs.items():
        print(json.dumps({"sass": tag, **sass_products(lib)}), flush=True)
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
