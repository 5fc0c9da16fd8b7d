"""Abstract inputs and sharding trees: the sharding half of the
reference's ``launch/specs.py``, on the meta device.

``input_specs(cfg, shape)`` returns the abstract batch a cell's step
takes (meta tensors, nothing allocated); ``sharding_trees`` returns
:class:`~repro_torch.parallel.sharding.NamedSharding` trees for the
parameters (the reference's stacked tree), the optimizer state, the batch
and the decode cache, whose ``placements`` place a tree as ``DTensor``s
(:func:`distribute_tree`).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.zoo import build_model, reference_shapes
from repro_torch.parallel.sharding import (AxisRules, NamedSharding,
                                           PartitionSpec, _dedup,
                                           logical_to_spec, param_spec)
from repro_torch.tree import map_tree

__all__ = ["input_specs", "batch_spec_tree", "sharding_trees",
           "abstract_params", "abstract_opt_state", "abstract_cache",
           "distribute_tree"]


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape) -> Dict[str, Any]:
    """Abstract batch for the given (arch, shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        if shape.kind in ("train", "prefill"):
            D = min(cfg.dec_len, S)
            return {
                "frames": _sds((B, S, cfg.d_model), torch.bfloat16),
                "dec_tokens": _sds((B, D), torch.int32),
                "labels": _sds((B, D), torch.int32),
            }
        return {"tokens": _sds((B, 1), torch.int32)}  # decode step input
    if shape.kind == "decode":
        return {"tokens": _sds((B, 1), torch.int32)}
    out = {"tokens": _sds((B, S), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _sds((B, S), torch.int32)
    return out


def batch_spec_tree(cfg, shape, rules: AxisRules):
    """PartitionSpecs matching :func:`input_specs` (batch over data
    axes)."""
    abs_tree = input_specs(cfg, shape)

    def leaf(name, logical):
        return logical_to_spec(logical, rules,
                               shape=tuple(abs_tree[name].shape))

    if cfg.is_encdec and shape.kind in ("train", "prefill"):
        return {
            "frames": leaf("frames", ("batch", "seq", "embed")),
            "dec_tokens": leaf("dec_tokens", ("batch", None)),
            "labels": leaf("labels", ("batch", None)),
        }
    if shape.kind == "decode":
        return {"tokens": leaf("tokens", ("batch", None))}
    out = {"tokens": leaf("tokens", ("batch", "seq"))}
    if shape.kind == "train":
        out["labels"] = leaf("labels", ("batch", "seq"))
    return out


def abstract_params(model, dtype=torch.float32):
    """The reference's parameter tree of ``model``'s config as meta
    tensors (the zoo's ``stack_params`` over the meta template)."""
    return map_tree(lambda t: t.to(dtype), reference_shapes(model.cfg))


def abstract_opt_state(optimizer, params_abs):
    return optimizer.init(params_abs)


def _meta(model):
    if model.device.type == "meta":
        return model
    return build_model(model.cfg, device="meta")


def abstract_cache(model, cfg, shape, dtype=torch.bfloat16):
    """The decode cache of the cell as meta tensors (an encoder-decoder's
    from its encoder run on meta frames)."""
    B, S = shape.global_batch, shape.seq_len
    meta = _meta(model)
    if cfg.is_encdec:
        return meta.init_cache(_sds((B, S, cfg.d_model), torch.bfloat16),
                               cfg.dec_len, dtype=dtype)
    return meta.init_cache(B, S, dtype=dtype)


def _spec_from_logical_tree(abs_tree, logical_tree, rules, *,
                            params: bool):
    """Map a logical-axis tree onto PartitionSpecs (leaf-wise); a leaf
    without a shape (the cache's ``idx``) is a scalar."""
    def one(a, logical):
        shape = tuple(getattr(a, "shape", ()))
        if params:
            return param_spec(shape, logical, rules)
        return logical_to_spec(logical, rules, shape=shape)

    return map_tree(one, abs_tree, logical_tree)


def _quantized_specs(abs_sub, p_spec, rules):
    """Specs of an optimizer's moments: each follows its parameter's; a
    q8 scale goes through ``_dedup`` against its own shape."""
    def match(a, s):
        if hasattr(a, "q"):
            sc = PartitionSpec(*_dedup(list(s), tuple(a.scale.shape), rules))
            return type(a)(q=s, scale=sc)
        return s

    return map_tree(match, abs_sub, p_spec,
                    is_leaf=lambda a: hasattr(a, "q"))


def sharding_trees(model, cfg, shape, optimizer, rules: AxisRules,
                   mesh) -> Dict[str, Any]:
    """NamedSharding trees for params / opt state / batch / cache."""
    def named(spec_tree):
        return map_tree(lambda s: NamedSharding(mesh, s), spec_tree,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))

    params_abs = abstract_params(model)
    p_spec = _spec_from_logical_tree(params_abs, model.param_logical(),
                                     rules, params=True)
    out = {"params_abs": params_abs, "params": named(p_spec)}

    if shape.kind == "train":
        opt_abs = abstract_opt_state(optimizer, params_abs)
        if "per" in opt_abs:  # SoapGivens: replicated
            o_spec = map_tree(lambda _: PartitionSpec(), opt_abs)
        else:
            # m/v follow the param spec; the step replicates
            o_spec = {"step": PartitionSpec(),
                      "m": _quantized_specs(opt_abs["m"], p_spec, rules),
                      "v": _quantized_specs(opt_abs["v"], p_spec, rules)}
        out["opt_abs"] = opt_abs
        out["opt"] = named(o_spec)

    out["batch"] = named(batch_spec_tree(cfg, shape, rules))

    if shape.kind == "decode":
        cache_abs = abstract_cache(model, cfg, shape)
        out["cache_abs"] = cache_abs
        out["cache"] = named(_spec_from_logical_tree(
            cache_abs, model.cache_logical(), rules, params=False))
    return out


def distribute_tree(tree, shardings):
    """``tree``'s tensors (numpy arrays too) as ``DTensor``s placed by the
    matching :class:`NamedSharding` leaves of ``shardings`` (each rank
    passes the same full tree); a leaf that is not an array stays as it
    is."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, sh):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            return x
        return distribute_tensor(x.to(sh.mesh.device_type), sh.mesh,
                                 sh.placements)

    return map_tree(put, tree, shardings)
