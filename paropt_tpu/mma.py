"""Method of Moving Asymptotes (Svanberg) optimizer.

JAX-native re-design of `ParOptMMA` (`src/ParOptMMA.{h,cpp}`, 1.2k LoC): the
MMA object is itself a `Problem` — the separable convex MMA approximation —
solved each outer iteration by the interior-point method with a diagonal
Hessian and no line search (forced options, `ParOptMMA.cpp:342-344`).

All asymptote/coefficient updates are single fused jnp expressions over [n]
arrays (one XLA kernel each under jit; embarrassingly parallel when sharded):

- asymptote init at ±0.5·range, oscillation-detection contract(0.7)/relax(1.2)
  rule from sign((x_k−x_{k−1})(x_{k−1}−x_{k−2})) (`ParOptMMA.cpp:615-664`)
- p/q coefficients with ε/δ regularization (`:689-734`)
- move limits (`:617-619`), inner bounds α/β
- two constraint modes: true MMA approximation or linearization
  (`use_true_mma`, `ParOptMMA.h:10-26`)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from typing import NamedTuple

from .ip import InteriorPoint
from .ip_fused import FusedIP, FusedIPOptions, ModelFns
from .ops.kkt import ProblemData, detect_aw_layout
from .problem import Problem
from .utils.logging import MMALogger
from .utils.options import OptionRegistry, make_options

__all__ = ["MMA", "FusedMMA", "fused_mma_solve", "FusedMMAOptions",
           "FusedMMAState"]


class MMAParams(NamedTuple):
    """Traced data for the separable MMA subproblem model."""
    L: Any
    U: Any
    p0: Any
    q0: Any
    pi: Any
    qi: Any
    b: Any
    cons: Any
    A: Any
    x0: Any
    cwk: Any
    Aw_cols: Any
    Aw_vals: Any


def make_mma_model(use_true_mma: bool, has_sparse: bool) -> ModelFns:
    """Fused-IP model functions for the MMA subproblem
    (`ParOptMMA::evalObjCon/evalObjConGradient/evalHessianDiag`,
    `ParOptMMA.cpp:804-1010`)."""

    def ev(p: MMAParams, x):
        Uinv = 1.0 / (p.U - x)
        Linv = 1.0 / (x - p.L)
        f = jnp.sum(p.p0 * Uinv + p.q0 * Linv)
        if p.cons.shape[0] == 0:
            c = p.cons
        elif use_true_mma:
            c = -(p.pi @ Uinv + p.qi @ Linv + p.b)
        else:
            c = p.cons + p.A @ (x - p.x0)
        if has_sparse:
            gathered = jnp.take(x - p.x0, p.Aw_cols, axis=-1)
            cw = p.cwk + jnp.sum(p.Aw_vals * gathered, axis=-1)
        else:
            cw = p.cwk
        return f, c, cw

    def gr(p: MMAParams, x):
        Uinv = 1.0 / (p.U - x)
        Linv = 1.0 / (x - p.L)
        g = p.p0 * Uinv ** 2 - p.q0 * Linv ** 2
        if p.cons.shape[0] == 0:
            A = p.A
        elif use_true_mma:
            A = p.qi * (Linv ** 2)[None, :] - p.pi * (Uinv ** 2)[None, :]
        else:
            A = p.A
        return g, A

    def hd(p: MMAParams, x, z, zw):
        Uinv = 1.0 / (p.U - x)
        Linv = 1.0 / (x - p.L)
        h = 2.0 * (p.p0 * Uinv ** 3 + p.q0 * Linv ** 3)
        if use_true_mma and p.cons.shape[0] > 0:
            h = h + 2.0 * (z @ (p.pi * (Uinv ** 3)[None, :]
                                + p.qi * (Linv ** 3)[None, :]))
        return h

    return ModelFns(eval_obj_con=ev, eval_grad=gr, hess_diag=hd)


class MMA(Problem):
    """MMA outer loop; also the separable subproblem consumed by the IP."""

    def __init__(self, problem: Problem, options: Optional[Any] = None):
        super().__init__(nvars=problem.nvars, ncon=problem.ncon,
                         nwcon=problem.nwcon, nwblock=problem.nwblock,
                         ninequality=problem.ninequality,
                         nwinequality=problem.nwinequality)
        self.prob = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="facade")
        o = self.options
        self.use_true_mma = not o["mma_use_constraint_linearization"]

        x0, lb, ub = problem.get_vars_and_bounds()
        self.x = jnp.asarray(x0)
        self.lbv = jnp.asarray(lb)
        self.ubv = jnp.asarray(ub)
        self.x1 = self.x
        self.x2 = self.x
        n = self.nvars
        self.L = jnp.zeros(n)
        self.U = jnp.zeros(n)
        self.alpha = jnp.zeros(n)
        self.beta = jnp.zeros(n)
        self.p0 = jnp.zeros(n)
        self.q0 = jnp.zeros(n)
        self.pi = jnp.zeros((self.ncon, n))
        self.qi = jnp.zeros((self.ncon, n))
        self.b = jnp.zeros(self.ncon)
        self.fobj = None
        self.cons = None
        self.cw = None
        self.g = None
        self.A = None
        self.z = jnp.zeros(self.ncon)
        self.zw = jnp.zeros(self.nwcon)
        self.zl = jnp.zeros(n)
        self.zu = jnp.zeros(n)
        self.mma_iter = 0
        self.subproblem_iter = 0

        # interior-point solver over this subproblem with forced options
        # (`ParOptMMA.cpp:342-344`); kept for API parity and as a host-loop
        # fallback — the fused jitted solver below is the default path
        ip_opts = self.options.copy()
        ip_opts["use_diag_hessian"] = True
        ip_opts["use_line_search"] = False
        ip_opts["qn_type"] = "none"
        ip_opts["write_output_frequency"] = 0
        ip_opts["output_file"] = None
        self.ip = InteriorPoint(self, ip_opts)
        self._logger = None
        self._fused: Optional[FusedIP] = None

    def _build_fused(self):
        o = self.options
        barrier = o["barrier_strategy"]
        fopts = FusedIPOptions(
            abs_res_tol=o["abs_res_tol"],
            init_barrier_param=o["init_barrier_param"],
            monotone_barrier_fraction=o["monotone_barrier_fraction"],
            monotone_barrier_power=o["monotone_barrier_power"],
            rel_bound_barrier=o["rel_bound_barrier"],
            min_fraction_to_boundary=o["min_fraction_to_boundary"],
            function_precision=o["function_precision"],
            design_precision=o["design_precision"],
            max_major_iters=o["max_major_iters"],
            iterative_refinement_steps=o["iterative_refinement_steps"],
            barrier_strategy=barrier,
            starting_point_strategy=o["starting_point_strategy"],
            use_line_search=False,
            use_diag_hessian=True,
            norm_type=o["norm_type"])
        model = make_mma_model(self.use_true_mma, self.nwcon > 0)
        self._fused = FusedIP(model, self.nvars, self.ncon, self.nwcon,
                              self.nwblock, fopts, dtype=self.ip.dtype)

    def _solve_subproblem_fused(self):
        """One inner IP solve of the current MMA approximation, fully
        jitted."""
        if self._fused is None:
            self._build_fused()
        dt = self.ip.dtype
        n, ncon, nwcon = self.nvars, self.ncon, self.nwcon
        if nwcon > 0:
            Aw = self.prob.sparse_jacobian(self.x)
            cols, vals = Aw.cols, jnp.asarray(Aw.vals, dt)
            cwk = jnp.asarray(self.cw, dt)
            layout = detect_aw_layout(cols, self.nvars)
        else:
            cols = vals = None
            cwk = jnp.zeros(0, dt)
            layout = "gather"
        params = MMAParams(
            L=jnp.asarray(self.L, dt), U=jnp.asarray(self.U, dt),
            p0=jnp.asarray(self.p0, dt), q0=jnp.asarray(self.q0, dt),
            pi=jnp.asarray(self.pi, dt), qi=jnp.asarray(self.qi, dt),
            b=jnp.asarray(self.b, dt), cons=jnp.asarray(self.cons, dt),
            A=jnp.asarray(self.A, dt), x0=jnp.asarray(self.x, dt),
            cwk=cwk, Aw_cols=cols, Aw_vals=vals)
        gamma = self.options["penalty_gamma"]
        idx = np.arange(ncon)
        idxw = np.arange(nwcon)
        ones = jnp.ones(n, dt)
        data = ProblemData(
            g=jnp.zeros(n, dt), A=jnp.zeros((ncon, n), dt),
            c=jnp.zeros(ncon, dt), cw=jnp.zeros(nwcon, dt),
            lb=jnp.asarray(self.alpha, dt), ub=jnp.asarray(self.beta, dt),
            lb_mask=ones, ub_mask=ones,
            gamma_s=jnp.asarray(np.where(idx < self.ninequality, 0.0, gamma),
                                dt),
            gamma_t=jnp.full((ncon,), gamma, dt),
            gamma_sw=jnp.asarray(
                np.where(idxw < self.nwinequality, 0.0, gamma), dt),
            gamma_tw=jnp.full((nwcon,), gamma, dt),
            Aw_cols=cols, Aw_vals=vals, nwblock=self.nwblock,
            Aw_layout=layout)
        from .tr import _accel_jit_loop
        st = self._fused.solve(jnp.asarray(self.x, dt), data, params,
                               jit_loop=_accel_jit_loop())
        self.subproblem_iter += int(st.k)
        return st.vars.x, st.vars.z, st.vars.zw, st.vars.zl, st.vars.zu

    # ------------------------------------------------------------------
    # outer loop
    # ------------------------------------------------------------------

    def optimize(self) -> Dict[str, Any]:
        """`ParOptMMA::optimize` (`ParOptMMA.cpp:318-379`)."""
        o = self.options
        max_iters = o["mma_max_iterations"]
        infeas_tol = o["mma_infeas_tol"]
        l1_tol = o["mma_l1_tol"]
        linf_tol = o["mma_linfty_tol"]
        self._logger = MMALogger(o["mma_output_file"])

        scaling = o["mma_kkt_error_scaling"]
        max_no_improve = o["mma_max_no_improvement"]

        self.initialize_subproblem(self.x)
        converged = stalled = False
        infeas = l1 = linf = float("inf")
        best_l1 = float("inf")
        no_improve = 0
        for i in range(max_iters):
            x, z, zw, zl, zu = self._solve_subproblem_fused()
            # set multipliers + re-linearize about the new point
            self.z, self.zw, self.zl, self.zu = z, zw, zl, zu
            self.initialize_subproblem(x)
            infeas, l1, linf = self.compute_kkt_error()
            # 'gradient' scaling: relative stationarity (extension for
            # f32 / large n — see mma_kkt_error_scaling in the registry)
            s1 = sinf = 1.0
            if scaling == "gradient":
                s1 = max(1.0, float(jnp.sum(jnp.abs(self.g))))
                sinf = max(1.0, float(jnp.max(jnp.abs(self.g))))
            if infeas < infeas_tol and (l1 < l1_tol * s1
                                        or linf < linf_tol * sinf):
                converged = True
                break
            # no-improvement window (mma_max_no_improvement, TPU
            # extension): stop at the arithmetic-noise stationarity floor
            if l1 < best_l1:
                best_l1, no_improve = l1, 0
            else:
                no_improve += 1
            if (max_no_improve > 0 and no_improve >= max_no_improve
                    and infeas < infeas_tol):
                converged = stalled = True
                break
        self._logger.close()
        return {"x": self.x, "fobj": float(self.fobj),
                "converged": converged, "stalled": stalled,
                "niter": self.mma_iter,
                "infeas": infeas, "l1": l1, "linfty": linf}

    def get_optimized_point(self):
        return self.x

    def get_asymptotes(self):
        """-> (L, U) current moving asymptotes (`getAsymptotes`,
        ParOpt.pyx:1383-1388)."""
        return self.L, self.U

    def get_design_history(self):
        """-> (x1, x2), the two previous design iterates
        (`getDesignHistory`, ParOpt.pyx:1389-1394)."""
        return self.x1, self.x2

    def initialize_subproblem(self, xv):
        """Shift history, evaluate f/c/gradients at the new point, update
        asymptotes and p/q coefficients (`initializeSubProblem`,
        `ParOptMMA.cpp:523-790`)."""
        o = self.options
        self.x2, self.x1 = self.x1, self.x
        self.x = jnp.asarray(xv)

        fobj, cons = self.prob.eval_obj_con(self.x)
        self.fobj = jnp.asarray(fobj)
        self.cons = jnp.asarray(cons).reshape(self.ncon)
        self.g, self.A = self.prob.eval_obj_con_gradient(self.x)
        if self.nwcon > 0:
            self.cw = jnp.asarray(self.prob.eval_sparse_con(self.x))

        # log this outer iteration
        if self._logger is not None:
            infeas, l1, linf = self.compute_kkt_error()
            l1_lambda = float(jnp.sum(jnp.abs(self.z))) if self.ncon else 0.0
            self._logger.log(self.mma_iter, self.subproblem_iter,
                             float(self.fobj), l1, linf, l1_lambda, infeas)

        movlim = o["mma_move_limit"]
        lower = jnp.maximum(self.lbv, self.x - movlim)
        upper = jnp.minimum(self.ubv, self.x + movlim)

        if self.mma_iter < 2:
            off = o["mma_init_asymptote_offset"]
            self.L = self.x - off * (upper - lower)
            self.U = self.x + off * (upper - lower)
        else:
            contract = o["mma_asymptote_contract"]
            relax = o["mma_asymptote_relax"]
            min_off = o["mma_min_asymptote_offset"]
            max_off = o["mma_max_asymptote_offset"]
            indc = (self.x - self.x1) * (self.x1 - self.x2)
            intrvl = jnp.clip(upper - lower, 0.01, 100.0)
            fac = jnp.where(indc < 0.0, contract, relax)
            L = self.x - fac * (self.x1 - self.L)
            U = self.x + fac * (self.U - self.x1)
            L = jnp.minimum(L, self.x - min_off * intrvl)
            U = jnp.maximum(U, self.x + min_off * intrvl)
            self.L = jnp.maximum(L, self.x - max_off * intrvl)
            self.U = jnp.minimum(U, self.x + max_off * intrvl)

        # inner bounds α/β (`ParOptMMA.cpp:700-710`)
        self.alpha = jnp.maximum(jnp.maximum(lower,
                                             0.9 * self.L + 0.1 * self.x),
                                 self.x - 0.5 * (upper - lower))
        self.beta = jnp.minimum(jnp.minimum(upper,
                                            0.9 * self.U + 0.1 * self.x),
                                self.x + 0.5 * (upper - lower))

        eps = o["mma_eps_regularization"]
        delta = o["mma_delta_regularization"]
        gpos = jnp.maximum(0.0, self.g)
        gneg = jnp.maximum(0.0, -self.g)
        Umx = self.U - self.x
        xmL = self.x - self.L
        self.p0 = Umx ** 2 * ((1.0 + delta) * gpos + delta * gneg
                              + eps / (self.U - self.L))
        self.q0 = xmL ** 2 * ((1.0 + delta) * gneg + delta * gpos
                              + eps / (self.U - self.L))

        if self.use_true_mma and self.ncon > 0:
            # convex approximation of -c(x) (`ParOptMMA.cpp:689-734`)
            Apos = jnp.maximum(0.0, -self.A)
            Aneg = jnp.maximum(0.0, self.A)
            self.pi = Umx[None, :] ** 2 * Apos
            self.qi = xmL[None, :] ** 2 * Aneg
            bsum = jnp.sum(self.pi / Umx[None, :]
                           + self.qi / xmL[None, :], axis=1)
            self.b = -(self.cons + bsum)

        self.mma_iter += 1

    def compute_kkt_error(self):
        """(infeas, l1, linfty) (`computeKKTError`, `ParOptMMA.cpp:
        406-488`): projected gradient of the true Lagrangian with bound
        relaxation."""
        relax = self.options["mma_bound_relax"]
        r = self.g - (self.A.T @ self.z if self.ncon else 0.0)
        if self.nwcon > 0:
            r = r - self.prob.sparse_jacobian_tvec(self.x, self.zw)
        if relax > 0.0:
            r = jnp.where((self.x <= self.lbv + relax) & (r > 0.0), 0.0, r)
            r = jnp.where((self.x >= self.ubv - relax) & (r < 0.0), 0.0, r)
        else:
            r = r - self.zl + self.zu
        l1 = float(jnp.sum(jnp.abs(r)))
        linf = float(jnp.max(jnp.abs(r))) if r.size else 0.0
        if self.ncon:
            idx = np.arange(self.ncon)
            viol = jnp.where(idx < self.ninequality,
                             jnp.maximum(0.0, -self.cons),
                             jnp.abs(self.cons))
            infeas = float(jnp.sum(viol))
        else:
            infeas = 0.0
        if self.nwcon:
            idxw = np.arange(self.nwcon)
            violw = jnp.where(idxw < self.nwinequality,
                              jnp.maximum(0.0, -self.cw), jnp.abs(self.cw))
            infeas += float(jnp.sum(violw))
        return infeas, l1, linf

    # ------------------------------------------------------------------
    # the separable subproblem, as a Problem consumed by the IP
    # ------------------------------------------------------------------

    def get_vars_and_bounds(self):
        return self.x, self.alpha, self.beta

    def eval_obj_con(self, xv):
        """MMA approximation (`ParOptMMA::evalObjCon`, `ParOptMMA.cpp:
        804-868`)."""
        Uinv = 1.0 / (self.U - xv)
        Linv = 1.0 / (xv - self.L)
        f = jnp.sum(self.p0 * Uinv + self.q0 * Linv)
        if self.ncon == 0:
            return f, jnp.zeros(0, xv.dtype)
        if self.use_true_mma:
            csum = self.pi @ Uinv + self.qi @ Linv
            c = -(csum + self.b)
        else:
            c = self.cons + self.A @ (xv - self.x)
        return f, c

    def eval_obj_con_gradient(self, xv):
        self.subproblem_iter += 1
        Uinv = 1.0 / (self.U - xv)
        Linv = 1.0 / (xv - self.L)
        g = self.p0 * Uinv ** 2 - self.q0 * Linv ** 2
        if self.ncon == 0:
            return g, jnp.zeros((0, self.nvars), xv.dtype)
        if self.use_true_mma:
            A = self.qi * (Linv ** 2)[None, :] - self.pi * (Uinv ** 2)[None, :]
        else:
            A = self.A
        return g, A

    def eval_hessian_diag(self, xv, z, zw):
        """`ParOptMMA::evalHessianDiag` (`ParOptMMA.cpp:967-1010`)."""
        Uinv = 1.0 / (self.U - xv)
        Linv = 1.0 / (xv - self.L)
        h = 2.0 * (self.p0 * Uinv ** 3 + self.q0 * Linv ** 3)
        if self.use_true_mma and self.ncon > 0:
            h = h + 2.0 * (z @ (self.pi * (Uinv ** 3)[None, :]
                                + self.qi * (Linv ** 3)[None, :]))
        return h

    def eval_hvec_product(self, xv, z, zw, px):
        return self.eval_hessian_diag(xv, z, zw) * px

    # sparse constraints: linearized about the outer point x
    # (`ParOptMMA::evalSparseCon`, `ParOptMMA.cpp:1015-1050`)
    def eval_sparse_con(self, xv):
        Aw = self.prob.sparse_jacobian(self.x)
        return self.cw + Aw.matvec(xv - self.x)

    def sparse_jacobian(self, xv):
        return self.prob.sparse_jacobian(self.x)

    def write_output(self, it, xv):
        pass


# ---------------------------------------------------------------------------
# Fully-fused MMA: the ENTIRE outer loop (asymptote updates, separable
# coefficient construction, inner interior-point solves, KKT error test) as
# one XLA computation under lax.while_loop — zero host round-trips.  A
# JAX-native extension of the reference's host outer loop
# (`ParOptMMA.cpp:318-379`); available for jax-native problems whose sparse
# constraint Jacobian is CONSTANT (the topology weighting-constraint case).
# ---------------------------------------------------------------------------


class FusedMMAOptions(NamedTuple):
    """Static outer-loop options (mirror the mma_* registry entries)."""
    max_iterations: int = 200
    infeas_tol: float = 1e-5
    l1_tol: float = 1e-6
    linf_tol: float = 1e-6
    move_limit: float = 0.2
    init_asymptote_offset: float = 0.25
    asymptote_contract: float = 0.7
    asymptote_relax: float = 1.2
    min_asymptote_offset: float = 0.01
    max_asymptote_offset: float = 10.0
    eps_regularization: float = 1e-5
    delta_regularization: float = 1e-3
    bound_relax: float = 0.0
    use_true_mma: bool = True
    ninequality: int = 0
    nwinequality: int = 0
    # 'none' (reference absolute test) | 'gradient' (relative to ||g||,
    # the dtype/n-aware criterion — see mma_kkt_error_scaling)
    kkt_error_scaling: str = "none"
    # no-improvement window (mma_max_no_improvement; 0 = disabled)
    max_no_improvement: int = 0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedMMAState:
    """Outer-loop state pytree."""
    x: jnp.ndarray
    x1: jnp.ndarray
    x2: jnp.ndarray
    L: jnp.ndarray
    U: jnp.ndarray
    z: jnp.ndarray
    zw: jnp.ndarray
    zl: jnp.ndarray
    zu: jnp.ndarray
    fobj: jnp.ndarray
    k: jnp.ndarray            # outer iteration counter (int32)
    subiters: jnp.ndarray     # cumulative inner IP iterations (int32)
    converged: jnp.ndarray    # bool
    infeas: jnp.ndarray
    l1: jnp.ndarray
    linf: jnp.ndarray
    best_l1: jnp.ndarray      # best stationarity seen (stall detection)
    no_improve: jnp.ndarray   # int32 consecutive non-improving iterations
    stalled: jnp.ndarray      # bool: converged via the no-improvement exit


def _fused_mma_step(user_model: ModelFns, mma_model: ModelFns,
                    ip_opts: FusedIPOptions, mo: FusedMMAOptions,
                    lbv, ubv, d_tmpl: ProblemData, params_user,
                    state: FusedMMAState) -> FusedMMAState:
    """One fused outer MMA iteration: evaluate, update asymptotes/coeffs,
    test convergence, inner-solve (skipped via lax.cond once converged)."""
    from .ip_fused import _fused_init, _fused_solve_loop

    x, x1, x2 = state.x, state.x1, state.x2
    dt = x.dtype
    fobj, cons, cw = user_model.eval_obj_con(params_user, x)
    g, A = user_model.eval_grad(params_user, x)
    cons = jnp.asarray(cons).reshape(-1)

    # -- asymptotes (`ParOptMMA.cpp:615-664`) -------------------------------
    lower = jnp.maximum(lbv, x - mo.move_limit)
    upper = jnp.minimum(ubv, x + mo.move_limit)
    off = mo.init_asymptote_offset
    L_init = x - off * (upper - lower)
    U_init = x + off * (upper - lower)
    indc = (x - x1) * (x1 - x2)
    intrvl = jnp.clip(upper - lower, 0.01, 100.0)
    fac = jnp.where(indc < 0.0, mo.asymptote_contract, mo.asymptote_relax)
    L_upd = jnp.minimum(x - fac * (x1 - state.L),
                        x - mo.min_asymptote_offset * intrvl)
    U_upd = jnp.maximum(x + fac * (state.U - x1),
                        x + mo.min_asymptote_offset * intrvl)
    L_upd = jnp.maximum(L_upd, x - mo.max_asymptote_offset * intrvl)
    U_upd = jnp.minimum(U_upd, x + mo.max_asymptote_offset * intrvl)
    first = state.k < 2
    L = jnp.where(first, L_init, L_upd)
    U = jnp.where(first, U_init, U_upd)

    # -- inner bounds + p/q coefficients (`ParOptMMA.cpp:689-734`) ----------
    alpha = jnp.maximum(jnp.maximum(lower, 0.9 * L + 0.1 * x),
                        x - 0.5 * (upper - lower))
    beta = jnp.minimum(jnp.minimum(upper, 0.9 * U + 0.1 * x),
                       x + 0.5 * (upper - lower))
    eps, delta = mo.eps_regularization, mo.delta_regularization
    gpos = jnp.maximum(0.0, g)
    gneg = jnp.maximum(0.0, -g)
    Umx = U - x
    xmL = x - L
    p0 = Umx ** 2 * ((1.0 + delta) * gpos + delta * gneg + eps / (U - L))
    q0 = xmL ** 2 * ((1.0 + delta) * gneg + delta * gpos + eps / (U - L))
    ncon = cons.shape[0]
    if mo.use_true_mma and ncon > 0:
        Apos = jnp.maximum(0.0, -A)
        Aneg = jnp.maximum(0.0, A)
        pi = Umx[None, :] ** 2 * Apos
        qi = xmL[None, :] ** 2 * Aneg
        b = -(cons + jnp.sum(pi / Umx[None, :] + qi / xmL[None, :], axis=1))
    else:
        pi = jnp.zeros((ncon, x.shape[0]), dt)
        qi = jnp.zeros((ncon, x.shape[0]), dt)
        b = jnp.zeros(ncon, dt)

    # -- KKT error at x with the incoming multipliers (`computeKKTError`,
    #    `ParOptMMA.cpp:406-488`) -------------------------------------------
    r = g - (A.T @ state.z if ncon else 0.0)
    if d_tmpl.nwcon > 0:
        r = r - d_tmpl.Aw_rmatvec(state.zw)
    if mo.bound_relax > 0.0:
        r = jnp.where((x <= lbv + mo.bound_relax) & (r > 0.0), 0.0, r)
        r = jnp.where((x >= ubv - mo.bound_relax) & (r < 0.0), 0.0, r)
    else:
        r = r - state.zl + state.zu
    l1 = jnp.sum(jnp.abs(r))
    linf = jnp.max(jnp.abs(r)) if r.size else jnp.zeros((), dt)
    idx = jnp.arange(ncon)
    infeas = (jnp.sum(jnp.where(idx < mo.ninequality,
                                jnp.maximum(0.0, -cons), jnp.abs(cons)))
              if ncon else jnp.zeros((), dt))
    if d_tmpl.nwcon:
        idxw = jnp.arange(d_tmpl.nwcon)
        infeas = infeas + jnp.sum(
            jnp.where(idxw < mo.nwinequality,
                      jnp.maximum(0.0, -cw), jnp.abs(cw)))
    if mo.kkt_error_scaling == "gradient":
        # relative stationarity: scale the tolerances by the objective
        # gradient norms (dtype/n-aware; extension)
        s1 = jnp.maximum(1.0, jnp.sum(jnp.abs(g)))
        sinf = jnp.maximum(1.0, jnp.max(jnp.abs(g)))
    else:
        s1 = sinf = jnp.ones((), dt)
    tol_met = (l1 < mo.l1_tol * s1) | (linf < mo.linf_tol * sinf)
    # no-improvement window (extension, mma_max_no_improvement):
    # terminate at the arithmetic-noise stationarity floor.  Frozen once
    # converged so the while_loop carries stable values.
    active = (state.k > 0) & ~state.converged
    improved = l1 < state.best_l1
    best_new = jnp.where(active & improved, l1, state.best_l1)
    no_imp_new = jnp.where(active,
                           jnp.where(improved, 0, state.no_improve + 1),
                           state.no_improve)
    stall_exit = jnp.asarray(False)
    if mo.max_no_improvement > 0:
        stall_exit = no_imp_new >= mo.max_no_improvement
    converged = ((state.k > 0) & (infeas < mo.infeas_tol)
                 & (tol_met | stall_exit))
    stalled = state.stalled | (converged & ~state.converged & stall_exit
                               & ~tol_met)

    # -- inner fused IP solve (skipped at runtime once converged) -----------
    params = MMAParams(L=L, U=U, p0=p0, q0=q0, pi=pi, qi=qi, b=b,
                       cons=cons, A=A, x0=x, cwk=cw,
                       Aw_cols=d_tmpl.Aw_cols, Aw_vals=d_tmpl.Aw_vals)
    d = dataclasses.replace(d_tmpl, lb=alpha, ub=beta)

    def _solve(_):
        st0 = _fused_init(mma_model, ip_opts, x, d, params, None, None)
        st = _fused_solve_loop(mma_model, ip_opts, st0, d, params, None)
        return st.vars.x, st.vars.z, st.vars.zw, st.vars.zl, st.vars.zu, st.k

    def _skip(_):
        return (x, state.z, state.zw, state.zl, state.zu,
                jnp.zeros((), jnp.int32))

    xn, zn, zwn, zln, zun, kin = jax.lax.cond(converged, _skip, _solve, None)

    return FusedMMAState(
        x=xn, x1=jnp.where(converged, x1, x), x2=jnp.where(converged, x2, x1),
        L=L, U=U, z=zn, zw=zwn, zl=zln, zu=zun, fobj=jnp.asarray(fobj, dt),
        k=state.k + jnp.where(converged, 0, 1),
        subiters=state.subiters + kin, converged=converged,
        infeas=infeas, l1=l1, linf=linf,
        best_l1=best_new, no_improve=no_imp_new, stalled=stalled)


class FusedMMA:
    """Build-once fused MMA solver: construction traces nothing; the first
    `solve` compiles the whole outer loop and subsequent solves reuse it.

    The problem's sparse Jacobian (if any) must be CONSTANT in x — its
    values are captured once at x0.  Options use the standard mma_*/IP
    registry names."""

    def __init__(self, problem, options: Optional[Dict[str, Any]] = None):
        from .utils.options import make_options

        o = options if hasattr(options, "descriptors") else \
            make_options(options or {}, which="facade")
        from .dtypes import resolve_dtype
        dt = resolve_dtype(
            jnp.float64 if o["dtype"] == "float64" else jnp.float32)
        x0, lb, ub = problem.get_vars_and_bounds()
        x0 = jnp.asarray(x0, dt)
        lbv = jnp.asarray(lb, dt)
        ubv = jnp.asarray(ub, dt)
        n, ncon, nwcon = problem.nvars, problem.ncon, problem.nwcon

        def ev(params, x):
            f, c = problem.eval_obj_con(x)
            cwv = (problem.eval_sparse_con(x) if nwcon > 0
                   else jnp.zeros(0, x.dtype))
            return f, jnp.asarray(c).reshape(ncon), cwv

        def gr(params, x):
            return problem.eval_obj_con_gradient(x)

        user_model = ModelFns(eval_obj_con=ev, eval_grad=gr)

        use_true = bool(o["mma_use_constraint_linearization"]) is False
        mma_model = make_mma_model(use_true, nwcon > 0)
        gamma = o["penalty_gamma"]
        if nwcon > 0:
            Aw = problem.sparse_jacobian(x0)
            cols, vals = Aw.cols, jnp.asarray(Aw.vals, dt)
            layout = detect_aw_layout(cols, n)
        else:
            cols = vals = None
            layout = "gather"
        idx = np.arange(ncon)
        idxw = np.arange(nwcon)
        ones = jnp.ones(n, dt)
        d_tmpl = ProblemData(
            g=jnp.zeros(n, dt), A=jnp.zeros((ncon, n), dt),
            c=jnp.zeros(ncon, dt), cw=jnp.zeros(nwcon, dt),
            lb=lbv, ub=ubv, lb_mask=ones, ub_mask=ones,
            gamma_s=jnp.asarray(
                np.where(idx < problem.ninequality, 0.0, gamma), dt),
            gamma_t=jnp.full((ncon,), gamma, dt),
            gamma_sw=jnp.asarray(
                np.where(idxw < problem.nwinequality, 0.0, gamma), dt),
            gamma_tw=jnp.full((nwcon,), gamma, dt),
            Aw_cols=cols, Aw_vals=vals, nwblock=problem.nwblock,
            Aw_layout=layout)
        ip_opts = FusedIPOptions(
            abs_res_tol=o["abs_res_tol"],
            init_barrier_param=o["init_barrier_param"],
            barrier_strategy=o["barrier_strategy"],
            starting_point_strategy=o["starting_point_strategy"],
            max_major_iters=o["max_major_iters"],
            iterative_refinement_steps=o["iterative_refinement_steps"],
            use_line_search=False, use_diag_hessian=True,
            norm_type=o["norm_type"])
        mo = FusedMMAOptions(
            max_iterations=o["mma_max_iterations"],
            infeas_tol=o["mma_infeas_tol"], l1_tol=o["mma_l1_tol"],
            linf_tol=o["mma_linfty_tol"], move_limit=o["mma_move_limit"],
            init_asymptote_offset=o["mma_init_asymptote_offset"],
            asymptote_contract=o["mma_asymptote_contract"],
            asymptote_relax=o["mma_asymptote_relax"],
            min_asymptote_offset=o["mma_min_asymptote_offset"],
            max_asymptote_offset=o["mma_max_asymptote_offset"],
            eps_regularization=o["mma_eps_regularization"],
            delta_regularization=o["mma_delta_regularization"],
            bound_relax=o["mma_bound_relax"], use_true_mma=use_true,
            ninequality=problem.ninequality,
            nwinequality=problem.nwinequality,
            kkt_error_scaling=o["mma_kkt_error_scaling"],
            max_no_improvement=o["mma_max_no_improvement"])

        zero = jnp.zeros((), dt)
        state0 = FusedMMAState(
            x=x0, x1=x0, x2=x0, L=jnp.zeros(n, dt), U=jnp.zeros(n, dt),
            z=jnp.zeros(ncon, dt), zw=jnp.zeros(nwcon, dt),
            zl=jnp.zeros(n, dt), zu=jnp.zeros(n, dt), fobj=zero,
            k=jnp.zeros((), jnp.int32), subiters=jnp.zeros((), jnp.int32),
            converged=jnp.asarray(False), infeas=zero, l1=zero, linf=zero,
            best_l1=zero + jnp.inf, no_improve=jnp.zeros((), jnp.int32),
            stalled=jnp.asarray(False))

        from functools import partial
        step = partial(_fused_mma_step, user_model, mma_model, ip_opts, mo,
                       lbv, ubv, d_tmpl, ())
        self._mo = mo
        self._ev = ev
        # compiled: run eagerly, a FEM model's state solve compiles hundreds
        # of small programs
        self._ev_jit = jax.jit(ev)
        self._problem = problem
        self._write_freq = o["write_output_frequency"]
        self._state0 = state0
        self._step = step
        self._step_jit = jax.jit(step)
        self._batched_run = None

        @jax.jit
        def run(s, k_stop):
            def cond(st):
                return (~st.converged) & (st.k < k_stop)
            return jax.lax.while_loop(cond, lambda st: step(st), s)

        self._run_jit = run

    def solve(self, state0: Optional[FusedMMAState] = None,
              jit_loop: bool = True, chunk="auto", checkpoint_path=None):
        """Run the fused outer loop.  Returns (result dict, final state).
        Pass a previous final state to resume.

        ``chunk`` bounds how many outer iterations run inside ONE device
        execution (host-paced between chunks, same compiled program each
        time).  ``chunk='auto'`` (default) MEASURES one outer iteration and
        sizes the device calls to ~10 s each (utils/chunked.py), so no
        problem/cg_iters combination can compile a watchdog-killing
        program — a 192x96 FEM @ cg800 in ONE while_loop call once crashed
        the device worker.  Pass an int to pin the chunk, or ``None`` to run the
        whole loop in one device call (at your own risk at scale).

        ``jit_loop=False`` steps one jitted outer iteration at a time from
        python — use it to inspect/log per-iteration state.

        The problem's ``write_output(it, x)`` hook fires every
        ``write_output_frequency`` outer iterations at chunk boundaries;
        ``checkpoint_path`` additionally writes an Orbax checkpoint of the
        FULL state at the same cadence (resume by passing the restored
        state as ``state0``)."""
        from .utils.chunked import (make_write_output_hook, run_chunked,
                                    user_write_output)
        hook = make_write_output_hook(
            user_write_output(self._problem), self._write_freq,
            get_x=lambda st: st.x, checkpoint_path=checkpoint_path)
        state = state0 if state0 is not None else self._state0
        if jit_loop:
            state = run_chunked(self._run_jit, state,
                                self._mo.max_iterations, chunk,
                                on_chunk=hook)
        else:
            for _ in range(self._mo.max_iterations):
                state = self._step_jit(state)
                if hook is not None:
                    hook(state)
                if bool(state.converged):
                    break
        # state.fobj is the value at the point the LAST step evaluated;
        # when the loop exits at the iteration cap, x has advanced once
        fobj_final, _, _ = self._ev_jit((), state.x)
        result = {"x": state.x, "fobj": float(fobj_final),
                  "converged": bool(state.converged),
                  "stalled": bool(state.stalled), "niter": int(state.k),
                  "infeas": float(state.infeas), "l1": float(state.l1),
                  "linfty": float(state.linf)}
        return result, state

    def solve_batched(self, x0_batch, chunk="auto"):
        """k multi-start fused MMA solves as ONE vmapped `lax.while_loop`
        XLA computation — the natural attack on SIMP nonconvexity (distinct
        local optima from distinct seeds), batching the per-voxel work into
        [k, n]-shaped kernels (the `FusedIP.solve_batched` pattern; no
        reference analogue — there every solve is a separate MPI job).

        ``x0_batch``: [k, n] starting designs.  Early-converged instances
        freeze while the rest iterate.  Returns (results, states) where
        ``results`` holds per-instance arrays (fobj, converged, niter, ...)
        and ``states`` is the FusedMMAState with a leading k axis."""
        x0_batch = jnp.asarray(x0_batch, self._state0.x.dtype)

        def batch_state(x0):
            return dataclasses.replace(self._state0, x=x0, x1=x0, x2=x0)

        state = jax.vmap(batch_state)(x0_batch)
        if self._batched_run is None:
            step = self._step

            @jax.jit
            def runb(s, k_stop):
                def one(si):
                    def cond(st):
                        return (~st.converged) & (st.k < k_stop)
                    return jax.lax.while_loop(cond, step, si)
                return jax.vmap(one)(s)

            self._batched_run = runb
        from .utils.chunked import run_chunked_batched
        state = run_chunked_batched(self._batched_run, state,
                                    self._mo.max_iterations, chunk)
        fobj_final = jax.jit(jax.vmap(lambda x: self._ev((), x)[0]))(state.x)
        results = {"x": state.x, "fobj": np.asarray(fobj_final),
                   "converged": np.asarray(state.converged),
                   "stalled": np.asarray(state.stalled),
                   "niter": np.asarray(state.k),
                   "infeas": np.asarray(state.infeas),
                   "l1": np.asarray(state.l1),
                   "linfty": np.asarray(state.linf)}
        return results, state



# bounded STRONG-reference LRU: a weak-value cache would evict the solver
# the moment fused_mma_solve returns (nothing else holds it), defeating the
# compile reuse it exists for
_FUSED_MMA_CACHE: "OrderedDict" = None
_FUSED_MMA_CACHE_MAX = 8


def fused_mma_solve(problem, options: Optional[Dict[str, Any]] = None,
                    jit_loop: bool = True, chunk="auto"):
    """One-shot convenience wrapper over `FusedMMA` (build + solve).

    The built solver (and its compiled outer loop) is cached per
    (problem, options) so back-to-back calls reuse the compilation instead
    of retracing — the build-once semantics of the `FusedMMA` class.  The
    cache holds strong references to the last few solvers (LRU, size 8);
    problem identity is re-checked via weakref so a recycled id() cannot
    alias a dead problem."""
    global _FUSED_MMA_CACHE
    import weakref
    from collections import OrderedDict
    if _FUSED_MMA_CACHE is None:
        _FUSED_MMA_CACHE = OrderedDict()
    if hasattr(options, "descriptors"):
        key = None  # registry objects are mutable; don't cache
    else:
        try:
            key = (id(problem), tuple(sorted((options or {}).items())))
            hash(key)
        except TypeError:  # unhashable option values
            key = None
    solver = _FUSED_MMA_CACHE.get(key) if key is not None else None
    if solver is None or solver._problem_ref() is not problem:
        solver = FusedMMA(problem, options)
        solver._problem_ref = weakref.ref(problem)
        if key is not None:
            _FUSED_MMA_CACHE[key] = solver
            _FUSED_MMA_CACHE.move_to_end(key)
            while len(_FUSED_MMA_CACHE) > _FUSED_MMA_CACHE_MAX:
                _FUSED_MMA_CACHE.popitem(last=False)
    elif key is not None:
        _FUSED_MMA_CACHE.move_to_end(key)
    return solver.solve(jit_loop=jit_loop, chunk=chunk)
