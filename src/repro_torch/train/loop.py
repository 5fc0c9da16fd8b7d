"""Training loop: checkpoint/restart, straggler monitoring, elastic resume.

Mirror of :mod:`repro.train.loop`.

* restart-safe: restores the newest complete checkpoint onto the loop's
  device; the synthetic pipeline regenerates exactly the next global
  batch (bit for bit).
* straggler mitigation: per-step wall times (``repro_torch.obs.timing``,
  the port's one clock, read after the step's loss reached the host)
  feed a watermark monitor; a step slower than ``median * threshold``
  fires ``on_straggler``.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core.sequence import resolve_device
from repro_torch.obs import timing

__all__ = ["StragglerMonitor", "TrainLoop"]


@dataclass
class StragglerMonitor:
    threshold: float = 3.0
    window: int = 32
    times: List[float] = field(default_factory=list)
    flagged: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if dt > self.threshold * med:
                self.flagged += 1
                is_straggler = True
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.times.append(dt)
        return is_straggler


class TrainLoop:
    """``device`` is where a restored checkpoint goes (the card by
    default; refused without one)."""

    def __init__(self, *, train_step, params, opt_state, data_iter,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
                 monitor: Optional[StragglerMonitor] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.data_iter = data_iter
        self.ckpt_every = ckpt_every
        self.monitor = monitor or StragglerMonitor()
        self.step = 0
        self.mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    def maybe_restore(self) -> int:
        """Restore newest checkpoint; returns start step (0 if none)."""
        if not self.mgr:
            return 0
        latest = self.mgr.latest_step()
        if latest is None:
            return 0
        tree = {"params": self.params, "opt": self.opt_state}
        restored = self.mgr.restore(latest, tree, device=self.device)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = latest
        if hasattr(self.data_iter, "step"):
            self.data_iter.step = latest
        return latest

    def run(self, num_steps: int) -> Dict[str, List[float]]:
        history: Dict[str, List[float]] = {"loss": [], "time": []}
        for _ in range(num_steps):
            batch = next(self.data_iter)
            t0 = timing.now()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = timing.now() - t0
            self.step += 1
            self.monitor.record(self.step, dt)
            history["loss"].append(loss)
            history["time"].append(dt)
            if self.mgr and self.step % self.ckpt_every == 0:
                self.mgr.save(self.step, {"params": self.params,
                                          "opt": self.opt_state})
        if self.mgr:
            self.mgr.save(self.step, {"params": self.params,
                                      "opt": self.opt_state},
                          blocking=True)
        return history
