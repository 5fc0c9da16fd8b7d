# repro-torch-lint: fixture-as=src/repro_torch/core/bad_keys.py
"""RA501 fixture: wall-clock/RNG in cache-key and cost-model paths."""
import random
import time

import numpy as np
import torch


def plan_key(problem) -> tuple:
    return (problem.m, problem.n, time.time())  # expect: RA501  # expect: RA502


def cost_flaky(problem, plan) -> float:
    return 6.0 * problem.m * problem.k * random.random()  # expect: RA501


def _bucket_key(seq) -> tuple:
    return (seq.n, np.random.default_rng().integers(10))  # expect: RA501


def cost_torch_noise(problem) -> float:
    return float(torch.rand(1)) * problem.m  # expect: RA501


def _measure_plan(fn):
    t0 = time.perf_counter()  # expect: RA502
    fn()
    return time.perf_counter() - t0  # expect: RA502
