"""Deterministic synthetic data pipeline (host-sharded, restart-safe).

The port's own copy of :mod:`repro.data.pipeline`, which is numpy only:
batch ``i`` is a pure function of ``(seed, step, host_slice)``, bit for
bit the reference's, so training is reproducible across restarts and
elastic reshards.  A markov-ish structure (token t+1 depends on t) gives
the LM a learnable signal.  Batches are numpy arrays on the host; the
train step moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def make_batch(cfg: DataConfig, step: int, *, start: int = 0,
               count: Optional[int] = None):
    """Rows ``[start, start+count)`` of the global batch for ``step``.

    Learnable structure: ``tok[t+1] = (a * tok[t] + b + noise) % vocab``
    with one affine map shared across sequences and rare noise.
    """
    count = cfg.global_batch if count is None else count
    a = 1 + 2 * ((cfg.seed % 8) + 1)
    b = (cfg.seed * 31 + 7) % cfg.vocab
    toks = np.empty((count, cfg.seq_len + 1), np.int32)
    for i in range(count):
        r = np.random.default_rng(
            np.uint64((cfg.seed * 7_919 + step) * 1_000_003 + start + i))
        x = np.empty(cfg.seq_len + 1, np.int64)
        x[0] = r.integers(0, cfg.vocab)
        noise = (r.random(cfg.seq_len) < 0.05) * r.integers(
            0, cfg.vocab, cfg.seq_len)
        for t in range(cfg.seq_len):
            x[t + 1] = (a * x[t] + b + noise[t]) % cfg.vocab
        toks[i] = x
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class SyntheticLM:
    """Iterator over global batches; slices rows for this host."""

    def __init__(self, cfg: DataConfig, *, host_index: int = 0,
                 host_count: int = 1, start_step: int = 0):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.per_host = cfg.global_batch // host_count
        self.start_row = host_index * self.per_host
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.step, start=self.start_row,
                       count=self.per_host)
        self.step += 1
        return b
