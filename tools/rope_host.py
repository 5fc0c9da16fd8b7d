#!/usr/bin/env python3
"""Host microseconds of one RoPE wrapper call, for one source tree.

    python3 tools/rope_host.py SRC_DIR

Imports ``repro_torch`` from ``SRC_DIR`` (a checkout's ``src``, or
another commit's unpacked with ``git archive``) and times the wrapper
``kernels.rope.kernel.rope`` on the card at SmolLM-135M's decode shape
(8, 1, 9, 3, 64) in bfloat16: 400 warm-up calls, then 30 rounds of 400
calls by ``repro_torch.obs.timing.now()`` with the card synchronized
before each round.  Prints one JSON line (median and least µs a call,
every round).  Lighter than ``tools/rope_bench.py`` (no CUPTI, no
decode), so that many processes of two trees can alternate on one card
(parent, change, change, parent, ...).
"""
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(sys.argv[1]).resolve()))
import torch  # noqa: E402

from repro_torch.kernels.rope import kernel as rope_k  # noqa: E402
from repro_torch.obs import timing  # noqa: E402

dev = torch.device("cuda")
g = torch.Generator().manual_seed(5)
q = torch.randn(8, 1, 9, 64, generator=g).to(dev, torch.bfloat16)
k = torch.randn(8, 1, 3, 64, generator=g).to(dev, torch.bfloat16)
c = torch.randn(1, 32, generator=g).to(dev, torch.bfloat16)
s = torch.randn(1, 32, generator=g).to(dev, torch.bfloat16)
with torch.inference_mode():
    for _ in range(400):
        rope_k.rope(q, k, c, s)
    torch.cuda.synchronize()
    us = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = timing.now()
        for _ in range(400):
            rope_k.rope(q, k, c, s)
        us.append((timing.now() - t0) * 1e6 / 400)
    torch.cuda.synchronize()
print(json.dumps({"src": sys.argv[1], "median_us": statistics.median(us),
                  "min_us": min(us), "us": us}))
