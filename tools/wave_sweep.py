#!/usr/bin/env python3
"""Time the wavefront kernel at other block shapes on one NVIDIA card.

    python3 tools/wave_sweep.py 4,128,32 12,128,32 8,256,64

Each argument is ``warps,chunk_planes,ring``: the kernel's ``kWarps``,
``kChunkPlanes`` and ``kRing``.  For each, a copy of
``src/repro_torch/csrc/rotseq_wave.cu`` with those constants is built
with ``nvcc`` (all copies at once) into ``build/wave_sweep/``, loaded
with ``ctypes``, held bit for bit against the blocked plain version at
k_b = 16 and timed by CUDA events at the paper shape and three others.
Prints the card's name and power limit, then one JSON line per variant
and shape.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(3840, 3840, 180), (3840, 3840, 64), (3000, 1000, 37),
          (1024, 1024, 41)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wave_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import random_sequence
    from repro_torch.core.blocked import rot_sequence_blocked
    from repro_torch.kernels import _build

    variants = [tuple(map(int, a.split(","))) for a in sys.argv[1:]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build.CSRC / "rotseq_wave.cu").read_text()
    out_dir = ROOT / "build" / "wave_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(v):
        warps, planes, ring = v
        cu = out_dir / f"wave_w{warps}_c{planes}_r{ring}.cu"
        cu.write_text(
            src.replace("constexpr int kWarps = 12;",
                        f"constexpr int kWarps = {warps};")
            .replace("constexpr int kChunkPlanes = 128;",
                     f"constexpr int kChunkPlanes = {planes};")
            .replace("constexpr int kRing = 32;",
                     f"constexpr int kRing = {ring};"))
        so = cu.with_suffix(".so")
        proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(so),
                               str(cu)], capture_output=True, text=True)
        report = [ln.strip() for ln in (proc.stdout + proc.stderr)
                  .splitlines() if "registers" in ln or "spill" in ln
                  or "error" in ln]
        return v, so, proc.returncode, report

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(build, variants))

    def time_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    dev = torch.device("cuda")
    problems = []
    for m, n, k in SHAPES:
        gen = torch.Generator().manual_seed(m + k)
        A = torch.randn((m, n), generator=gen).to(dev)
        seq = random_sequence(n, k, generator=gen, device=dev)
        args = (A.t().contiguous(), seq.cos.t().contiguous(),
                seq.sin.t().contiguous())
        want = rot_sequence_blocked(A, seq.cos, seq.sin, k_b=16).t()
        problems.append(((m, n, k), (*args, torch.full_like(args[1], -1.0)),
                         want.contiguous()))
    ok = True
    for v, so, rc, report in built:
        print(json.dumps(dict(variant=v, nvcc=rc, ptxas=report)), flush=True)
        if rc:
            ok = False
            continue
        fn = ctypes.CDLL(str(so)).rotseq_wave_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        for shape, (AT, Cw, Sw, Gw), want in problems:
            out = torch.empty_like(AT)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                return fn(AT.data_ptr(), Cw.data_ptr(), Sw.data_ptr(),
                          Gw.data_ptr(), out.data_ptr(), AT.shape[0],
                          AT.shape[1], Cw.shape[0], stream)

            err = call()
            torch.cuda.synchronize()
            same = err == 0 and torch.equal(out, want)
            ok = ok and same
            print(json.dumps(dict(variant=v, shape=shape, cuda_error=err,
                                  bitwise=same,
                                  ms=time_ms(call) if same else None)),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
