"""SOAP-Givens: Shampoo/SOAP-style preconditioning whose eigenbases are
maintained by *rotation-sequence eigensolvers*.

Mirror of :mod:`repro.optim.soap_givens`.  For each 2D parameter ``W``
(d_in, d_out) it tracks Kronecker covariance factors ``L = E[G G^T]`` and
``R = E[G^T G]`` (sides capped at ``max_dim``).  Every ``update_freq``
steps the eigenbases of ``L`` and ``R`` are refreshed by a solver that
records its pivots as a ``RotationSequence`` and applies them through
``seq.plan`` (``apply_method="auto"``: the cost model's pick, on the card
one of the rotation kernels):

* ``solver="jacobi"`` (default): round-robin Jacobi
  (:func:`repro_torch.core.jacobi.jacobi_eigh`, then
  :func:`~repro_torch.core.jacobi.jacobi_apply_basis`).
* ``solver="qr"``: tridiagonal Wilkinson-shift QR
  (:func:`repro_torch.eig.eigh_givens`).

Between refreshes, gradients are rotated into the eigenbasis, Adam runs
there, and updates rotate back:

    G~ = Q_L^T G Q_R ;  Adam(G~) ;  U = Q_L U~ Q_R^T

The update is eager, so both solvers run wherever it is called (the
reference refuses ``"qr"`` under ``jit``).  Which parameters are
preconditioned is decided on the tree the optimizer is given, as in the
reference: the training path hands it the reference's stacked layout
(:func:`repro_torch.models.zoo.stack_params`), where a layer
group's dense weights are 3-D and never eligible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.jacobi import jacobi_apply_basis, jacobi_eigh
from repro_torch.parallel.sharding import any_dtensor
from repro_torch.tree import map_tree

from .adamw import _float32, bias_correction

__all__ = ["SoapGivens"]


def _eligible(p) -> bool:
    return p.dim() == 2 and min(p.shape) >= 4


@dataclass(frozen=True)
class SoapGivens:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    shampoo_beta: float = 0.95
    update_freq: int = 10          # basis refresh period
    jacobi_cycles: int = 4
    max_dim: int = 512             # cap covariance side (block to identity)
    solver: str = "jacobi"         # "jacobi" | "qr"
    apply_method: str = "auto"     # registry dispatch for basis refresh

    def _lr(self, step: int) -> float:
        return _float32(self.lr(step) if callable(self.lr) else self.lr)

    def refresh(self, L, R):
        """The eigenbases ``(QL, QR)`` of the covariances, by the solver."""
        if self.solver == "qr":
            from repro_torch.eig import eigh_givens

            _, QL = eigh_givens(L, method="qr",
                                apply_method=self.apply_method)
            _, QR = eigh_givens(R, method="qr",
                                apply_method=self.apply_method)
            return QL, QR
        if self.solver != "jacobi":
            raise ValueError(f"unknown solver {self.solver!r}; one of "
                             f"('jacobi', 'qr')")
        resL = jacobi_eigh(L, cycles=self.jacobi_cycles)
        resR = jacobi_eigh(R, cycles=self.jacobi_cycles)
        return (jacobi_apply_basis(resL, method=self.apply_method),
                jacobi_apply_basis(resR, method=self.apply_method))

    def preconditions(self, p) -> bool:
        """Whether ``p`` (a tensor, or a shape on the meta device) gets
        covariance factors."""
        return _eligible(p) and max(p.shape) <= self.max_dim

    def init(self, params):
        if any_dtensor(params):
            raise NotImplementedError(
                "SoapGivens under a mesh (DTensor parameters)")

        def one(p):
            st = {
                "m": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device),
            }
            if self.preconditions(p):
                for side, n in (("L", p.shape[0]), ("R", p.shape[1])):
                    eye = torch.eye(n, dtype=torch.float32, device=p.device)
                    st[side] = eye * 1e-6
                    st["Q" + side] = eye
            return st

        return {"step": torch.zeros((), dtype=torch.int32),
                "per": map_tree(one, params)}

    @torch.no_grad()
    def update(self, grads, state, params, *, grad_scale: float = 1.0):
        if any_dtensor(params):
            raise NotImplementedError(
                "SoapGivens under a mesh (DTensor parameters)")
        step = int(state["step"]) + 1
        lr = self._lr(step)
        b1c = bias_correction(self.b1, step)
        b2c = bias_correction(self.b2, step)
        refresh = step % self.update_freq == 0

        def upd(p, g, st):
            g = g.float() * grad_scale
            precond = "L" in st
            if precond:
                L = self.shampoo_beta * st["L"] \
                    + (1 - self.shampoo_beta) * (g @ g.T)
                R = self.shampoo_beta * st["R"] \
                    + (1 - self.shampoo_beta) * (g.T @ g)
                QL, QR = (self.refresh(L, R) if refresh
                          else (st["QL"], st["QR"]))
                g_rot = QL.T @ g @ QR
            else:
                g_rot = g

            m = self.b1 * st["m"] + (1 - self.b1) * g_rot
            v = self.b2 * st["v"] + (1 - self.b2) * torch.square(g_rot)
            u = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if precond:
                u = QL @ u @ QR.T
            u = u + self.weight_decay * p.float()
            p_new = (p.float() - lr * u).to(p.dtype)
            new_st = {"m": m, "v": v}
            if precond:
                new_st.update({"L": L, "R": R, "QL": QL, "QR": QR})
            return p_new, new_st

        out = map_tree(upd, params, grads, state["per"])
        is_out = lambda o: isinstance(o, tuple)  # noqa: E731
        new_p = map_tree(lambda o: o[0], out, is_leaf=is_out)
        new_per = map_tree(lambda o: o[1], out, is_leaf=is_out)
        return new_p, {"step": torch.tensor(step, dtype=torch.int32),
                       "per": new_per}, {}
