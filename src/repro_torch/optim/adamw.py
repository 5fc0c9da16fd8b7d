"""AdamW with optional 8-bit state quantization and global-norm clipping.

Mirror of :mod:`repro.optim.adamw`, with its functional interface:
``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (new_params, new_state, metrics)``.
``params`` is a tree of tensors (:mod:`repro_torch.tree`); the update
returns new tensors and leaves its inputs as they were.

8-bit mode stores ``m``/``v`` as int8 with per-block (256) float32
scales along the last axis.  The step is a 0-d int32 tensor; the bias
corrections ``1 - b ** step`` and the schedule's rate are float32, as in
the reference.  The reference scans its update over the stack axis of
large quantized leaves to bound XLA's temporaries; eager PyTorch holds
one leaf's temporaries at a time anyway, and blockwise last-axis
quantization commutes with that slicing, so the result is the same.

Under a mesh (``DTensor`` parameters) the 8-bit state is quantized and
dequantized once a shard, on each rank's local tensor: the same blocks
as the whole tensor's where every shard of the last axis is a whole
number of blocks (or that axis is not sharded).  Where a shard of it is
not (Llama-3-405B's 1024-wide key projection in 16 shards), that axis
is gathered before quantizing, so the state of that leaf is held whole
along it.  The scales keep their tensor's placements.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import gather_last_unless
from repro_torch.tree import leaves, map_tree

__all__ = ["AdamW", "Quantized", "quantize_q8", "dequantize_q8"]

_BLOCK = 256


class Quantized(NamedTuple):
    q: torch.Tensor       # int8 payload, original shape
    scale: torch.Tensor   # float32 per-block scales, shape (*lead, nblocks)


def _is_q(x) -> bool:
    return isinstance(x, Quantized)


def _from_local(local, like, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def quantize_q8(x) -> Quantized:
    """Blockwise int8 along the LAST axis only: leading axes keep their
    shape.  A ``DTensor`` is quantized once a shard."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        # shards of the last axis in whole blocks, else that axis whole
        last = x.shape[-1] if x.dim() else 1
        x = gather_last_unless(x, last // _BLOCK if last % _BLOCK == 0
                               else 1)
        qv = quantize_q8(x.to_local())
        nblocks = -(-x.shape[-1] // _BLOCK) if x.dim() else 1
        return Quantized(_from_local(qv.q, x, x.shape),
                         _from_local(qv.scale, x,
                                     tuple(x.shape[:-1]) + (nblocks,)))
    lead = tuple(x.shape[:-1])
    last = x.shape[-1] if x.dim() else 1
    xr = x.reshape(lead + (last,)) if x.dim() else x.reshape(1)
    pad = (-last) % _BLOCK
    xb = F.pad(xr, (0, pad)).reshape(lead + (-1, _BLOCK))
    scale = torch.clamp(xb.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    q = q.to(torch.int8).reshape(lead + (last + pad,))[..., :last]
    return Quantized(q.reshape(x.shape), scale.to(torch.float32))


def dequantize_q8(qv: Quantized, shape):
    from torch.distributed.tensor import DTensor
    if isinstance(qv.q, DTensor):
        local = qv.q.to_local()
        return _from_local(
            dequantize_q8(Quantized(local, qv.scale.to_local()),
                          local.shape), qv.q, shape)
    shape = tuple(shape)
    lead, last = shape[:-1], shape[-1] if len(shape) else 1
    pad = (-last) % _BLOCK
    xb = F.pad(qv.q.reshape(lead + (last,)).to(torch.float32), (0, pad))
    xb = xb.reshape(lead + (-1, _BLOCK)) * qv.scale[..., None]
    return xb.reshape(lead + (last + pad,))[..., :last].reshape(shape)


def _float32(x) -> float:
    """A float32 0-d value as a Python float (exact)."""
    return float(torch.as_tensor(x, dtype=torch.float32))


def bias_correction(b: float, step: int) -> float:
    """``1 - b ** step`` in float32."""
    one = torch.tensor(1.0, dtype=torch.float32)
    bt = torch.tensor(b, dtype=torch.float32)
    return _float32(one - bt ** torch.tensor(float(step),
                                             dtype=torch.float32))


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    quantized: bool = False      # int8 m/v states

    def _lr(self, step: int) -> float:
        return _float32(self.lr(step) if callable(self.lr) else self.lr)

    def init(self, params):
        def zeros_like_state(p):
            # a DTensor parameter's moments keep its placements
            z = torch.zeros_like(p, dtype=torch.float32)
            return quantize_q8(z) if self.quantized else z

        return {
            "step": torch.zeros((), dtype=torch.int32),
            "m": map_tree(zeros_like_state, params),
            "v": map_tree(zeros_like_state, params),
        }

    @torch.no_grad()
    def update(self, grads, state, params, *, grad_scale: float = 1.0):
        step = int(state["step"]) + 1
        if self.clip_norm:
            gnorm = grad_scale * torch.sqrt(sum(
                torch.sum(torch.square(g.float())) for g in leaves(grads)))
            scale = grad_scale * torch.clamp(
                self.clip_norm / (gnorm + 1e-9), max=1.0)
        else:
            gnorm = torch.zeros(())
            scale = grad_scale
        lr = self._lr(step)
        b1c = bias_correction(self.b1, step)
        b2c = bias_correction(self.b2, step)

        def upd(p, g, m, v):
            g = g.float() * scale
            if self.quantized:
                m_f = dequantize_q8(m, g.shape)
                v_f = dequantize_q8(v, g.shape)
            else:
                m_f, v_f = m, v
            m_f = self.b1 * m_f + (1 - self.b1) * g
            v_f = self.b2 * v_f + (1 - self.b2) * torch.square(g)
            u = (m_f / b1c) / (torch.sqrt(v_f / b2c) + self.eps)
            if self.quantized:
                # quantization can zero tiny v blocks -> unbounded u;
                # Adafactor-style RMS update clipping restores stability
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
                u = u / torch.clamp(rms, min=1.0)
            u = u + self.weight_decay * p.float()
            p_new = (p.float() - lr * u).to(p.dtype)
            if self.quantized:
                return p_new, quantize_q8(m_f), quantize_q8(v_f)
            return p_new, m_f, v_f

        out = map_tree(upd, params, grads, state["m"], state["v"])
        is_out = lambda o: isinstance(o, tuple) and not _is_q(o)  # noqa: E731
        pick = lambda i: map_tree(lambda o: o[i], out,  # noqa: E731
                                  is_leaf=is_out)
        new_state = {"step": torch.tensor(step, dtype=torch.int32),
                     "m": pick(1), "v": pick(2)}
        return pick(0), new_state, {"grad_norm": gnorm}
