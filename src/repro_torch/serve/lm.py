"""Batched LM decoding: fixed-slot greedy generation.

Mirror of :mod:`repro.serve.lm`.  Requests (prompt token lists) are
admitted into a fixed-size batch of decode slots that share one cache
index; a slot that is shorter or done still steps with the batch.  The
prompt is fed teacher-forced through the one-token decode step, which
runs eagerly over the whole batch.  Greedy argmax is taken on the
device; one host copy of the ``(B,)`` next tokens a step decides what
each slot feeds next.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

__all__ = ["ServeEngine"]


@dataclass
class _Slot:
    tokens: List[int]
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Greedy decoding of up to ``batch`` prompts through ``model`` (a
    model of :func:`repro_torch.models.build_model` holding its weights
    on its device: anything with ``device``, ``init_cache(batch,
    max_len, dtype=)`` and ``decode_step(cache, tokens)``)."""

    def __init__(self, model, cfg, *, batch: int, max_len: int,
                 eos: Optional[int] = None):
        self.model = model
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.eos = eos
        self._step = model.decode_step
        self.steps = 0   # decode steps of the last generate()

    @torch.inference_mode()
    def generate(self, prompts: List[List[int]], max_new: int = 16):
        """Greedy-decode a batch of prompts (padded to the slot batch)."""
        if len(prompts) > self.batch:
            raise ValueError(f"{len(prompts)} prompts for {self.batch} "
                             f"slots")
        slots = [_Slot(list(p)) for p in prompts]
        while len(slots) < self.batch:
            slots.append(_Slot([0], done=True))

        cache = self.model.init_cache(self.batch, self.max_len,
                                      dtype=torch.float32)
        max_prompt = max(len(s.tokens) for s in slots)
        # teacher-forced prefill through the decode path (slot-uniform)
        last = torch.zeros((self.batch, 1), dtype=torch.int64)
        self.steps = 0
        for t in range(max_prompt + max_new):
            for i, s in enumerate(slots):
                if t < len(s.tokens):
                    last[i, 0] = s.tokens[t]
            logits, cache = self._step(cache, last.to(self.model.device))
            self.steps += 1
            nxt = logits[:, -1].argmax(dim=-1).cpu().tolist()
            for i, s in enumerate(slots):
                if s.done:
                    continue
                if t >= len(s.tokens) - 1:
                    tok = nxt[i]
                    s.out.append(tok)
                    last[i, 0] = tok
                    if (self.eos is not None and tok == self.eos) \
                            or len(s.out) >= max_new:
                        s.done = True
            if all(s.done for s in slots):
                break
        return [s.out for s in slots[: len(prompts)]]
