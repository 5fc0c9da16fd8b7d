"""Batched serving of rotation requests: mirror of :mod:`repro.serve`.

``RotationService`` (shape-bucketed batches, one plan per bucket, one
fused launch per batch on the card) and ``StreamEngine`` (continuous
batching on top of it), and ``ServeEngine`` (greedy LM decoding in
fixed slots, :mod:`repro_torch.serve.lm`).
"""
from .lm import ServeEngine
from .rotations import (BucketKey, RotationService, serve_plan_store_path,
                        synthetic_stream)
from .stream import (Backpressure, DeadlineExceeded, EngineClosed,
                     StreamEngine, StreamTicket)

__all__ = ["ServeEngine", "RotationService", "BucketKey",
           "serve_plan_store_path", "synthetic_stream", "StreamEngine",
           "StreamTicket", "Backpressure", "DeadlineExceeded",
           "EngineClosed"]
