#!/usr/bin/env python3
"""Time the fused RoPE kernel at other launch shapes on one NVIDIA card.

    python3 tools/rope_sweep.py 128,2,0,32,16384 128,1,16,32,16384

Each argument is ``threads,items,blocks_per_sm,narrow_threads,
narrow_items``: the kernel's ``kThreads`` (threads a block of a wide
launch), ``kItems`` (vector items a thread of a wide launch loads before
it rotates any), ``kBlocksPerSM`` (the wide grid's cap, blocks an SM,
over which the blocks stride through the items; 0 lets the grid cover
every item once), ``kNarrowThreads`` (threads a block of a narrow
launch, one item a thread) and ``kNarrowItems`` (the most items of a
narrow launch; 0 makes every launch wide).  For each, a copy of
``src/repro_torch/csrc/rope.cu`` with those constants is built with
``nvcc`` (all copies at once) into ``build/rope_sweep/`` and loaded with
``ctypes``; at the decode, ragged, prefill, llama and gemma3 shapes of
``chip_smoke.ROPE_SHAPES`` each variant is held bit for bit to the plain
version and timed by CUPTI (``chip_smoke.device_us``), all variants in
one profiler window, then again in the reverse order in a second.
Prints the card's name and power limit, each variant's ptxas report,
then one JSON line per window.  Exits non-zero without a CUDA device or
when a variant fails.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONSTANTS = ("kThreads", "kItems", "kBlocksPerSM", "kNarrowThreads",
             "kNarrowItems")
DEFAULTS = (128, 2, 0, 32, 16384)
CASES = ["decode/bfloat16", "decode/float32", "ragged/bfloat16",
         "prefill/bfloat16", "prefill/float32", "llama_prefill/bfloat16",
         "gemma3/bfloat16"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rope_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rope.ref import apply_rope_ref

    variants = [tuple(map(int, a.split(","))) for a in sys.argv[1:]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "rope.cu").read_text()
    out_dir = ROOT / "build" / "rope_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(v):
        cu = out_dir / ("rope_" + "_".join(map(str, v)) + ".cu")
        text = src
        for name, old, new in zip(CONSTANTS, DEFAULTS, v):
            line = f"constexpr int {name} = {old};"
            if line not in text:
                raise RuntimeError(f"{line!r} is not in rope.cu")
            text = text.replace(line, f"constexpr int {name} = {new};")
        cu.write_text(text)
        so = cu.with_suffix(".so")
        proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(so),
                               str(cu)], capture_output=True, text=True)
        report = [ln.strip() for ln in (proc.stdout + proc.stderr)
                  .splitlines() if "registers" in ln or "spill" in ln
                  or "error" in ln]
        return v, so, proc.returncode, report

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(build, variants))

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    inputs = {}
    for key in CASES:
        label, dt = key.split("/")
        q, k, c, s = cs.rope_inputs(dev, label, getattr(torch, dt), gen)
        inputs[key] = (q, k, c, s, apply_rope_ref(q, c, s),
                       apply_rope_ref(k, c, s))
    ok, cases = True, []
    stream = torch.cuda.current_stream().cuda_stream
    for v, so, rc, report in built:
        print(json.dumps(dict(variant=v, nvcc=rc, ptxas=report)), flush=True)
        if rc:
            ok = False
            continue
        lib = ctypes.CDLL(str(so))
        for key in CASES:
            q, k, c, s, pq, pk = inputs[key]
            fn = getattr(lib, "rope_f32" if q.dtype == torch.float32
                         else "rope_bf16")
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            qo, ko = torch.empty_like(q), torch.empty_like(k)
            B, S, Hq, D = q.shape

            def call(fn=fn, q=q, k=k, c=c, s=s, qo=qo, ko=ko, B=B, S=S,
                     Hq=Hq, D=D):
                return fn(q.data_ptr(), k.data_ptr(), c.data_ptr(),
                          s.data_ptr(), qo.data_ptr(), ko.data_ptr(), B, S,
                          Hq, k.shape[2], D, 0, stream)

            err = call()
            torch.cuda.synchronize()
            good = err == 0 and torch.equal(qo, pq) and torch.equal(ko, pk)
            ok = ok and good
            if not good:
                print(json.dumps(dict(variant=v, case=key, cuda_error=err,
                                      bitwise=False)), flush=True)
                continue
            cases.append((f"{','.join(map(str, v))}/{key}", call))

    def reps(key):
        return cs.rope_reps(key.split("/")[1])

    for order, window in (("forward", cases), ("reverse", cases[::-1])):
        us = cs.device_us(window, reps)
        print(json.dumps(dict(order=order, device_us=us)), flush=True)
        ok = ok and us is not None
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
