"""Train / serve step factories: mirror of :mod:`repro.train.step`.

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` for any of the port's models, where ``params`` is
the reference's parameter tree (the zoo's ``stack_params``: float32
master weights, each scan group stacked) and ``batch`` holds numpy
``tokens``/``labels`` (``repro_torch.data``), or ``frames``/
``dec_tokens``/``labels`` for an encoder-decoder config, moved to the
model's device here.  The forward
runs the model with these weights through
``torch.func.functional_call``; gradients come back float32 in the same
tree.  Under a mesh (``DTensor`` parameters and batch, placed by
:func:`repro_torch.launch.specs.sharding_trees`, inside
:func:`~repro_torch.parallel.sharding.axis_rules`) the same step runs
under ``DTensor`` propagation, its gradients constrained to
``grad_shardings``.  ``make_serve_step`` and ``make_prefill_fn`` serve
such a tree (``params`` first, as in the reference): the module's own
weights are only the template ``functional_call`` swaps them into.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from repro_torch.models.zoo import unstack_params
from repro_torch.parallel.sharding import shard
from repro_torch.tree import leaves, map_tree

from .losses import softmax_cross_entropy

__all__ = ["make_train_step", "make_eval_fn", "make_serve_step",
           "make_prefill_fn"]


def _on(device, x):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


def _full(x):
    """A ``DTensor`` scalar (a loss) as a plain tensor, differentiably;
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _loss_fn(model, cfg, params, batch, *, remat=True):
    # cast the float32 master weights to the compute dtype ONCE, at the
    # top of the differentiated function, as the reference does: each
    # weight's gradient is cast back to float32 by this one cast's
    # backward
    cdt = getattr(torch, cfg.dtype)
    params = map_tree(
        lambda w: w.to(cdt) if w.dtype == torch.float32 else w, params)
    dev = model.device
    if cfg.is_encdec:
        args = (_on(dev, batch["frames"]),
                _on(dev, batch["dec_tokens"]).long())
    else:
        args = (_on(dev, batch["tokens"]).long(),)
    labels = _on(dev, batch["labels"])
    logits = functional_call(model, unstack_params(cfg, params), args,
                             {"remat": remat})
    # under a mesh the vocab axis is gathered first: DTensor has no
    # strategy for the label gather along a sharded dimension
    logits = shard(logits, "batch", None, None)
    loss, z_loss = (_full(x) for x in softmax_cross_entropy(logits, labels))
    return loss + 1e-4 * z_loss, {"loss": loss.detach(),
                                  "z_loss": z_loss.detach()}


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def _value_and_grad(model, cfg, params, batch, remat, constrain=None):
    """``(metrics, grads)`` of one (micro-)batch; ``constrain`` (the
    train step's) places the parameters inside the differentiated
    function."""
    with torch.enable_grad():
        live = map_tree(lambda p: p.detach().requires_grad_(True), params)
        # re-assert the parameters' placements inside the differentiated
        # function: a redistribute's backward places each GRADIENT as its
        # parameter
        total, metrics = _loss_fn(
            model, cfg, live if constrain is None else constrain(live),
            batch, remat=remat)
        # a weight the forward never reads (the RG-LRU hybrid's MLP gate,
        # as in the reference) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(total, leaves(live), allow_unused=True)
    it = iter(grads)
    return metrics, map_tree(lambda p: _or_zeros(next(it), p), params)


def make_train_step(model, cfg, optimizer, *, remat: bool = True,
                    grad_accum: int = 1, grad_shardings=None):
    """Returns the train-step function (optionally micro-batched).

    With ``grad_accum > 1`` the batch's rows split into ``grad_accum``
    micro-batches in order; their gradients are summed in float32 and the
    optimizer gets ``grad_scale = 1 / grad_accum`` (it folds the factor
    into its clip/scale pass), and the metrics are the micro-batches'
    mean, as in the reference.

    ``grad_shardings``: an optional tree of
    :class:`~repro_torch.parallel.sharding.NamedSharding` matching the
    params (``sharding_trees(...)["params"]``): the parameters inside the
    differentiated function, the gradients and the grad-accumulation
    carry are redistributed to it, so each gradient keeps its parameter's
    placements.  A micro-batch of a ``DTensor`` batch takes the same
    block of every rank's local rows (data-parallel accumulation), not
    the reference's block of the global rows: the summed gradient and
    the mean metrics are the whole batch's either way.
    """

    def constrain(tree):
        if grad_shardings is None:
            return tree
        return map_tree(_redistribute, tree, grad_shardings)

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            metrics, grads = _value_and_grad(model, cfg, params, batch,
                                             remat, constrain)
            grads = constrain(grads)
        else:
            grads = metrics = None
            for i in range(grad_accum):
                mb = {k: _micro(v, i, grad_accum) for k, v in batch.items()}
                m, g = _value_and_grad(model, cfg, params, mb, remat,
                                       constrain)
                if grads is None:
                    grads, metrics = constrain(g), m
                else:
                    grads = constrain(map_tree(torch.add, grads, g))
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            metrics = {k: v / grad_accum for k, v in metrics.items()}

        params, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, params, grad_scale=1.0 / grad_accum)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def _redistribute(x, sharding):
    if tuple(x.placements) == sharding.placements:
        return x
    return x.redistribute(sharding.mesh, sharding.placements)


def _micro(x, i: int, n: int):
    """Micro-batch ``i`` of ``n`` of a batch leaf: rows ``i`` of ``n``
    equal blocks, a ``DTensor``'s of its local rows on each rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        local = x.to_local()
        rows = len(local) // n
        return DTensor.from_local(local[i * rows:(i + 1) * rows],
                                  x.device_mesh, x.placements,
                                  run_check=False)
    rows = len(x) // n
    return x[i * rows:(i + 1) * rows]


def make_eval_fn(model, cfg):
    @torch.no_grad()
    def eval_fn(params, batch):
        _, metrics = _loss_fn(model, cfg, params, batch, remat=False)
        return metrics

    return eval_fn


class _Method(nn.Module):
    """Runs ``model.<name>`` as its forward, so that ``functional_call``
    can run a method other than ``forward`` with given weights."""

    def __init__(self, model, name: str):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.name)(*args, **kwargs)


def _weights(cfg, params, prefix=""):
    return {prefix + k: v for k, v in unstack_params(cfg, params).items()}


def make_serve_step(model, cfg):
    """One-token decode step: (params, cache, tokens (B, 1)) -> (logits,
    cache), with the weights ``params`` (the reference's tree, as
    ``make_train_step`` trains it), under ``inference_mode``."""
    decode = _Method(model, "decode_step")

    @torch.inference_mode()
    def serve_step(params, cache, tokens):
        return functional_call(decode, _weights(cfg, params, "model."),
                               (cache, tokens))

    return serve_step


def make_prefill_fn(model, cfg):
    """Prefill: (params, tokens (B, S)) -> logits (B, S, vocab), the full
    prompt with the weights ``params``."""

    @torch.inference_mode()
    def prefill(params, tokens):
        return functional_call(model, _weights(cfg, params), (tokens,),
                               {"remat": False})

    return prefill
