#!/usr/bin/env python3
"""Time the wavefront kernel at other bands and block shapes on one
NVIDIA card.

    python3 tools/wave_sweep.py 4,12,128,32 8,12,128,64 16,12,128,32

Each argument is ``band,warps,chunk_planes,ring``: the waves a band the
variant launches at, and the band pipeline's ``kWarps``,
``kChunkPlanes`` and ``kRing``.  For each, a copy of
``src/repro_torch/csrc/rotseq_wave.cu`` with those constants is built
with ``nvcc`` (all copies at once) into ``build/wave_sweep/``; a band
other than ``kBand`` (16) is compiled as the copy's ``kSmallBand``, which
the small band's own kernel runs (the three constants apply to the band
pipeline alone; ``tools/wave_small_ab.py`` compares that kernel's
sources).  A band a kernel's static asserts refuse (above 4 for the
small band's kernel: its swizzle needs ``2 (band - 1) < 8``) reports
``nvcc``'s error.  Each built variant is loaded with ``ctypes``,
held bit for bit against the blocked plain version at its band and
timed by CUDA events at the eig flush ``(1024, 1024, 32)`` and the
other shapes in ``SHAPES`` (``--shapes eig`` for the flush alone).
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
SHAPES = [(1024, 1024, 32), (1024, 1024, 41), (3000, 1000, 37),
          (3840, 3840, 64), (3840, 3840, 180)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wave_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import random_sequence
    from repro_torch.core.blocked import rot_sequence_blocked
    from repro_torch.kernels import _build

    args = sys.argv[1:]
    shapes = SHAPES
    if args[:2] == ["--shapes", "eig"]:
        args, shapes = args[2:], SHAPES[:1]
    variants = [tuple(map(int, a.split(","))) for a in args]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build.CSRC / "rotseq_wave.cu").read_text()
    out_dir = ROOT / "build" / "wave_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())

    def build(v):
        band, warps, planes, ring = v
        cu = out_dir / f"wave_b{band}_w{warps}_c{planes}_r{ring}.cu"
        text = (src.replace("constexpr int kWarps = 12;",
                            f"constexpr int kWarps = {warps};")
                .replace("constexpr int kChunkPlanes = 128;",
                         f"constexpr int kChunkPlanes = {planes};")
                .replace("constexpr int kRing = 32;",
                         f"constexpr int kRing = {ring};"))
        if band != 16:
            text = text.replace("constexpr int kSmallBand = 4;",
                                f"constexpr int kSmallBand = {band};")
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
    for m, n, k in shapes:
        gen = torch.Generator().manual_seed(m + k)
        A = torch.randn((m, n), generator=gen).to(dev)
        seq = random_sequence(n, k, generator=gen, device=dev)
        args = (A.t().contiguous(), seq.cos.t().contiguous(),
                seq.sin.t().contiguous())
        problems.append(((m, n, k), A, seq,
                         (*args, torch.full_like(args[1], -1.0))))
    ok = True
    for v, so, rc, report in built:
        print(json.dumps(dict(variant=v, nvcc=rc, ptxas=report)), flush=True)
        if rc:
            ok = False
            continue
        band = v[0]
        fn = ctypes.CDLL(str(so)).rotseq_wave_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        for shape, A, seq, (AT, Cw, Sw, Gw) in problems:
            want = rot_sequence_blocked(A, seq.cos, seq.sin, k_b=band).t()
            out = torch.empty_like(AT)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                return fn(AT.data_ptr(), Cw.data_ptr(), Sw.data_ptr(),
                          Gw.data_ptr(), out.data_ptr(), AT.shape[0],
                          AT.shape[1], Cw.shape[0], band, stream)

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
