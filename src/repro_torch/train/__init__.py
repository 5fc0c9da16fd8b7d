"""Training of the port: mirror of :mod:`repro.train`."""
from .loop import StragglerMonitor, TrainLoop
from .losses import softmax_cross_entropy
from .step import (make_eval_fn, make_prefill_fn, make_serve_step,
                   make_train_step)

__all__ = ["StragglerMonitor", "TrainLoop", "softmax_cross_entropy",
           "make_eval_fn", "make_prefill_fn", "make_serve_step",
           "make_train_step"]
