#!/usr/bin/env python3
"""Time the accumulated kernel at other block shapes on one NVIDIA card.

    python3 tools/mxu_sweep.py 32,32,3,2,4 32,32,3,4,4 32,16,4,2,4

Each argument is ``rows,slab,stages,cluster,tm``: the kernel's
``kRows``, ``kSlab``, ``kStages``, ``kCluster`` and ``kTM`` (rows a
thread).  For each, a copy of ``src/repro_torch/csrc/rotseq_mxu.cu``
with those constants is built with ``nvcc`` (all copies at once) into
``build/mxu_sweep/``, loaded with ``ctypes``, held to the plain version
(``rotseq_mxu_ref``, relative Frobenius error 1e-5) on one band of
every problem below and timed by CUDA events on the paper shape's
bands, beside the SM clock that ``nvidia-smi`` reads while they run.
Prints the card's name and power limit, then one JSON line per variant
and problem.  Exits non-zero without a CUDA device or when a variant
fails.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (m, n, k, n_b, k_b): the paper shape at both tile sizes, then narrow
# and ragged ones (every width path of the kernel, a ragged cluster)
PROBLEMS = [(3840, 3840, 180, 128, 128), (3840, 3840, 180, 64, 64),
            (3000, 1000, 37, 128, 37), (333, 300, 20, 64, 16),
            (129, 40, 5, 8, 4), (97, 70, 16, 16, 16), (1, 50, 9, 8, 3)]
TOL = 1e-5
CONSTANTS = ("kRows", "kSlab", "kStages", "kCluster", "kTM")
DEFAULTS = (32, 32, 3, 2, 4)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mxu_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import random_sequence
    from repro_torch.core.blocked import band_inputs, num_tiles
    from repro_torch.kernels import _build
    from repro_torch.kernels.rotseq_mxu.ops import band_factors
    from repro_torch.kernels.rotseq_mxu.ref import rotseq_mxu_ref

    variants = [tuple(map(int, a.split(","))) for a in sys.argv[1:]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "rotseq_mxu.cu").read_text()
    out_dir = ROOT / "build" / "mxu_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(v):
        cu = out_dir / ("mxu_" + "_".join(map(str, v)) + ".cu")
        text = src
        for name, old, new in zip(CONSTANTS, DEFAULTS, v):
            line = f"constexpr int {name} = {old};"
            if line not in text:
                raise RuntimeError(f"{line!r} is not in rotseq_mxu.cu")
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

    def sm_clock_under(fn, reps):
        """The SM clock (MHz) nvidia-smi reads while ``fn`` runs
        ``reps`` times back to back (about three seconds)."""
        fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        time.sleep(0.3)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True).stdout
        torch.cuda.synchronize()
        return float(smi.split()[0])

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    bands = []
    for m, n, k, n_b, k_b in PROBLEMS:
        gen = torch.Generator().manual_seed(m + n + k)
        A = torch.randn((m, n), generator=gen).to(dev)
        seq = random_sequence(n, k, generator=gen, device=dev)
        T = num_tiles(n, n_b, k_b)
        Q = band_factors(seq.cos, seq.sin, 0, k_b, n_b, T)
        init, fresh = band_inputs(A.t(), k_b, n_b, T)
        init, fresh = init.t().contiguous(), fresh.t().contiguous()
        w = n_b + k_b
        ldq = -(-w // 4) * 4
        Qp = torch.nn.functional.pad(Q, (0, ldq - w, 0, ldq - w))
        want = rotseq_mxu_ref(fresh, Q, init)
        bands.append(((m, n, k, n_b, k_b), -(-k // k_b), T, Qp, ldq, fresh,
                      init, want))
    ok = True
    for v, so, rc, report in built:
        print(json.dumps(dict(variant=v, nvcc=rc, ptxas=report)), flush=True)
        if rc:
            ok = False
            continue
        fn = ctypes.CDLL(str(so)).rotseq_mxu_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        for shape, nbands, T, Qp, ldq, fresh, init, want in bands:
            out = torch.empty_like(fresh)
            stream = torch.cuda.current_stream().cuda_stream
            n_b, k_b = shape[3:]

            def call():
                return fn(fresh.data_ptr(), Qp.data_ptr(), init.data_ptr(),
                          out.data_ptr(), T, n_b, k_b, init.shape[0], ldq,
                          stream)

            err = call()
            torch.cuda.synchronize()
            rel = (float((out.double() - want.double()).norm()
                         / want.double().norm()) if err == 0 else None)
            good = err == 0 and rel <= TOL
            ok = ok and good
            ms = clock = None
            if good and shape[0] == 3840:
                ms = time_ms(lambda: [call() for _ in range(nbands)])
                clock = sm_clock_under(call, int(3000 * nbands / ms))
            print(json.dumps(dict(variant=v, shape=shape, cuda_error=err,
                                  rel_err=rel, bands=nbands, ms=ms,
                                  sm_clock_mhz=clock)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
