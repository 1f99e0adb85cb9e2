"""Compact eigenvalue-constraint approximation path.

JAX-native re-design of `ParOptCompactEigenvalueApprox.{h,cpp}` (930 LoC):
for eigenvalue (buckling / natural-frequency) constraints in topology
optimization, one dense constraint is modeled by a low-rank quadratic
approximation

    c_index(xk + s)  ≈  c0 + g0·s + 1/2 sᵀ (hᵀ M h) s         (h: [N, n])

refreshed by a user callback each accepted trust-region step, while the
Hessian-of-Lagrangian used by the inner IP merges the objective quasi-Newton
approximation with the z0-scaled constraint curvature into one compact form
(`ParOptEigenQuasiNewton::getCompactMat`):

    B = b0·I − [Z_qn; h]ᵀ blockdiag(M_qn, M⁻¹/z0)⁻¹ [Z_qn; h]

All pieces are dense [N, n] stacks — matmul-shaped, one fused
reduction per product when n is sharded.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax.numpy as jnp
import numpy as np

from .ops import qn as qnmod
from .tr import QuadraticSubproblem

__all__ = ["CompactEigenApprox", "EigenQuasiNewton", "EigenSubproblem"]


class CompactEigenApprox:
    """Low-rank quadratic model of one constraint
    (`ParOptCompactEigenApprox`, `ParOptCompactEigenvalueApprox.h:7-32`)."""

    def __init__(self, nvars: int, N: int, dtype=None):
        from .dtypes import resolve_dtype
        dtype = resolve_dtype(dtype)
        self.nvars = nvars
        self.N = N
        self.c0 = jnp.zeros((), dtype)
        self.g0 = jnp.zeros(nvars, dtype)
        self.M = jnp.eye(N, dtype=dtype)
        self.Minv = jnp.eye(N, dtype=dtype)
        self.hvecs = jnp.zeros((N, nvars), dtype)

    def set_approximation(self, c0=None, g0=None, M=None, hvecs=None,
                          Minv=None):
        """Mirror of ``setApproximationValues(c0, M, Minv)``
        (`ParOptCompactEigenvalueApprox.cpp:118-133`): the reference takes the
        inverse explicitly because KS curvature matrices are singular (rank
        N−1) and need a pseudo-inverse. When ``Minv`` is omitted it is derived
        with ``pinv`` (which equals ``inv`` for nonsingular M)."""
        if c0 is not None:
            self.c0 = jnp.asarray(c0)
        if g0 is not None:
            self.g0 = jnp.asarray(g0)
        if M is not None:
            self.M = jnp.asarray(M)
            self.Minv = (jnp.asarray(Minv) if Minv is not None
                         else jnp.linalg.pinv(self.M))
        elif Minv is not None:
            self.Minv = jnp.asarray(Minv)
        if hvecs is not None:
            self.hvecs = jnp.asarray(hvecs)

    def eval_approximation(self, s=None):
        if s is None:
            return self.c0
        hs = self.hvecs @ s
        return self.c0 + jnp.vdot(self.g0, s) + 0.5 * jnp.vdot(hs,
                                                               self.M @ hs)

    def eval_approximation_gradient(self, s):
        return self.g0 + self.hvecs.T @ (self.M @ (self.hvecs @ s))

    def mult_add(self, alpha, x):
        """alpha * H x with H = hᵀ M h (`multAdd`)."""
        return alpha * (self.hvecs.T @ (self.M @ (self.hvecs @ x)))


class EigenQuasiNewton:
    """Merged Hessian approximation B_qn − z0·H_eig as one compact form
    (`ParOptEigenQuasiNewton`, `ParOptCompactEigenvalueApprox.h:34-84`).

    Duck-types the compact-QN surface the interior point consumes:
    `.compact()`, `.mult()`, `.reset()`, `.update_multipliers()`."""

    def __init__(self, qn_state: Optional[qnmod.QNState],
                 eigh: CompactEigenApprox, index: int = 0):
        self.qn = qn_state
        self.eigh = eigh
        self.index = index
        self.z0 = jnp.ones(())
        self.use_quasi_newton_objective = True
        self.scaled = False  # surface parity with QNState

    def update_multipliers(self, x, z, zw):
        """`update(x, z, zw)`: refresh z0 = z[index]
        (`ParOptCompactEigenvalueApprox.cpp:183`)."""
        self.z0 = jnp.asarray(z[self.index])

    def update(self, x, z, zw, s, y):
        """Full update: delegate the (s, y) pair to the inner QN; z0 refresh."""
        self.update_multipliers(x, z, zw)
        if self.qn is not None:
            self.qn, skipped, damped = qnmod.qn_update(self.qn, s, y)
            return int(skipped), int(damped)
        return 0, 0

    def reset(self):
        if self.qn is not None:
            self.qn = qnmod.qn_reset(self.qn)

    def compact(self):
        """(b0, Z, M) with B = b0 I − Zᵀ M⁻¹ Z
        (`getCompactMat`, with the reference's z0→0 convention)."""
        eigh = self.eigh
        dtype = eigh.hvecs.dtype
        N = eigh.N
        z0inv = jnp.where(self.z0 != 0.0, 1.0 / jnp.where(self.z0 != 0.0,
                                                          self.z0, 1.0), 1.0)
        Me = z0inv * eigh.Minv
        if self.qn is not None and self.use_quasi_newton_objective:
            b0, Zq, Mq = qnmod.qn_compact(self.qn)
            K = Zq.shape[0]
            # upcast narrow-storage QN buffers for the concat with the
            # (full-precision) eigen hvecs — the merged stack is small-N
            Z = jnp.concatenate([Zq.astype(dtype), eigh.hvecs], axis=0)
            M = jnp.zeros((K + N, K + N), dtype)
            M = M.at[:K, :K].set(Mq).at[K:, K:].set(Me)
        else:
            b0 = jnp.zeros((), dtype)
            Z = eigh.hvecs
            M = Me
        return b0, Z, M

    def mult(self, x):
        b0, Z, M = self.compact()
        return b0 * x - Z.T @ jnp.linalg.solve(M, Z @ x)


class EigenSubproblem(QuadraticSubproblem):
    """TR subproblem where constraint `index` uses the low-rank quadratic
    eigenvalue model and the model is refreshed by a user callback at each
    accepted step (`ParOptEigenSubproblem`,
    `ParOptCompactEigenvalueApprox.h:86-204`).

    The user callback has signature ``update(x, eigh)`` and may call
    ``eigh.set_approximation(...)``; on entry c0/g0 default to the real
    constraint value/gradient at the new point."""

    def __init__(self, problem, eigen_qn: EigenQuasiNewton):
        holder: Dict[str, Any] = {"state": eigen_qn}
        super().__init__(problem, holder)
        self.approx = eigen_qn
        self._update_fn: Optional[Callable] = None

    def set_eigen_model_update(self, fn: Callable) -> None:
        self._update_fn = fn

    # objective model: quadratic with the MERGED Hessian (B_qn − z0 H)
    def model_obj_con(self, p=None):
        eigh = self.approx.eigh
        idx = self.approx.index
        if p is None:
            f = self.fk
            c = self.ck.at[idx].set(eigh.eval_approximation(None)) \
                if self.ncon else self.ck
            return f, c
        f = self.fk + jnp.vdot(self.gk, p) \
            + 0.5 * jnp.vdot(p, self.approx.mult(p))
        c = self.ck + self.Ak @ p if self.ncon else self.ck
        c = c.at[idx].set(eigh.eval_approximation(p))
        return f, c

    def eval_obj_con(self, p):
        return self.model_obj_con(p)

    def eval_obj_con_gradient(self, p):
        g = self.gk + self.approx.mult(p)
        A = self.Ak.at[self.approx.index].set(
            self.approx.eigh.eval_approximation_gradient(p))
        return g, A

    def eval_trial_step_and_update(self, update_flag, p, z, zw):
        """Real evaluation only; QN/model updates deferred to accept
        (`ParOptEigenSubproblem::evalTrialStepAndUpdate`)."""
        xt = self.xk + p
        ft, ct = self.prob.eval_obj_con(xt)
        self.ft = jnp.asarray(ft)
        self.ct = jnp.asarray(ct).reshape(self.ncon)
        self.gt, self.At = self.prob.eval_obj_con_gradient(xt)
        self.qn_update_type = (0, 0)
        self._last_step = p
        return self.ft, self.ct

    def accept_trial_step(self, p, z=None, zw=None):
        """Refresh the eigen model via the callback and update the inner QN
        (`ParOptEigenSubproblem::acceptTrialStep`)."""
        xt = self.xk + p
        idx = self.approx.index
        eigh = self.approx.eigh
        # default linear terms from the real evaluation
        eigh.set_approximation(c0=self.ct[idx], g0=self.At[idx])
        if self._update_fn is not None:
            self._update_fn(xt, eigh)
        if z is not None and self.approx.qn is not None:
            y0 = self.gk - (self.Ak.T @ z if self.ncon else 0.0)
            if self.nwcon > 0:
                y0 = y0 - self.prob.sparse_jacobian_tvec(self.xk, zw)
            y = self.gt - (self.At.T @ z if self.ncon else 0.0)
            if self.nwcon > 0:
                y = y - self.prob.sparse_jacobian_tvec(xt, zw)
            y = y - y0
            s, y = self.prob.compute_quasi_newton_update_correction(
                xt, z, zw, p, y)
            self.qn_update_type = self.approx.update(xt, z, zw, s, y)
        self.xk = xt
        self.fk = self.ft
        self.ck = self.ct
        self.gk = self.gt
        self.Ak = self.At
        if self.nwcon > 0:
            self.cwk = jnp.asarray(self.prob.eval_sparse_con(self.xk))
            self.Awk = self.prob.sparse_jacobian(self.xk)
