"""l∞ trust-region / SL1QP optimizer with penalty and filter globalization.

JAX-native re-design of `ParOptTrustRegion` (`src/ParOptTrustRegion.{h,cpp}`,
~3k LoC).  The outer loop solves a sequence of l∞-trust-region quadratic
subproblems — compact-QN quadratic objective + linearized constraints inside
the box [max(-Δ, lb-xk), min(Δ, ub-xk)] — each solved by the interior-point
method; the real objective/constraints are evaluated once per TR iteration
("the hot loop is IP-on-QP", SURVEY.md §3.1).  Globalization strategies:

- SL1QP penalty acceptance with per-constraint adaptive penalties and the
  "steering" infeasibility-minimization subproblem
  (`sl1qpOptimize`/`sl1qpUpdate`, `ParOptTrustRegion.cpp:1231-1671`)
- (f, h) filter with slanting envelope and feasibility-restoration phase
  (`filterOptimize` + filter helpers, `ParOptTrustRegion.cpp:907-1034,
  1697-2210`)

All subproblem evaluations here are pure jnp expressions over the stored
linearization (fk, gk, ck, Ak, cwk, Awk) + the compact QN state, so the IP's
inner iterations never touch user code.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from typing import NamedTuple

import jax

from .ip import InteriorPoint
from .ip_fused import FusedIP, FusedIPOptions, ModelFns
from .ops import qn as qnmod
from .ops.kkt import ProblemData, detect_aw_layout
from .problem import Problem, SparseJacobian
from .utils.logging import TRLogger
from .utils.options import OptionRegistry, make_options

__all__ = ["TrustRegion", "QuadraticSubproblem", "InfeasSubproblem",
           "FusedTR", "FusedTROptions", "FusedTRState"]


def _accel_jit_loop() -> bool:
    """On accelerators, run each inner IP solve as ONE lax.while_loop
    computation (host dispatch per step costs ~ms through remote links);
    on CPU host pacing allows early exit and is faster."""
    return jax.default_backend() != "cpu"


# ---------------------------------------------------------------------------
# fused-IP model of the quadratic subproblem: the whole inner solve is a
# sequence of jitted steps with zero user-code involvement
# ---------------------------------------------------------------------------


class QPParams(NamedTuple):
    """Traced linearization data for the quadratic subproblem model."""
    fk: Any
    gk: Any
    ck: Any
    Ak: Any
    cwk: Any            # [nwcon] (zeros when unused)
    Aw_cols: Any        # sparse Jacobian at xk ([nwcon, k] or None)
    Aw_vals: Any
    b0: Any             # compact-QN pieces (B = b0 I - Z' M^{-1} Z)
    Z: Any              # may be None
    M: Any
    obj_scale: Any      # 1.0 for the QP; 1/gamma_big for the infeas problem
    # optional low-rank quadratic curvature of ONE constraint row (the
    # eigen row, `ParOptCompactEigenvalueApprox.cpp:598-635`): row model
    # c[i] + A[i]·p + 1/2 (h p)' M_eig (h p); None disables
    eig_M: Any = None   # [N, N]
    eig_h: Any = None   # [N, n]


def _qp_Bp(params: QPParams, p):
    Bp = params.b0 * p
    if params.Z is not None:
        Bp = Bp - params.Z.T @ jnp.linalg.solve(params.M, params.Z @ p)
    return Bp


def make_qp_model(has_sparse: bool, obj_mode: str,
                  eig_index: Optional[int] = None) -> ModelFns:
    """Model functions for a (possibly sparse-constrained) QP subproblem;
    `obj_mode` is 'quadratic' or 'linear' (static).  ``eig_index`` (static)
    makes constraint row ``eig_index`` QUADRATIC via params.eig_M/eig_h —
    the reference's `ParOptEigenSubproblem::evalObjCon` exposes the eigen
    row's curvature to the inner IP the same way
    (`ParOptCompactEigenvalueApprox.cpp:598-635`)."""

    def ev(params: QPParams, p):
        f = params.fk + jnp.vdot(params.gk, p)
        if obj_mode == "quadratic":
            f = f + 0.5 * jnp.vdot(p, _qp_Bp(params, p))
        f = params.obj_scale * f
        c = (params.ck + params.Ak @ p) if params.ck.shape[0] else params.ck
        if eig_index is not None:
            hp = params.eig_h @ p
            c = c.at[eig_index].add(0.5 * jnp.vdot(hp, params.eig_M @ hp))
        if has_sparse:
            gathered = jnp.take(p, params.Aw_cols, axis=-1)
            cw = params.cwk + jnp.sum(params.Aw_vals * gathered, axis=-1)
        else:
            cw = params.cwk
        return f, c, cw

    def gr(params: QPParams, p):
        g = params.gk
        if obj_mode == "quadratic":
            g = g + _qp_Bp(params, p)
        A = params.Ak
        if eig_index is not None:
            hp = params.eig_h @ p
            A = A.at[eig_index].add(params.eig_h.T @ (params.eig_M @ hp))
        return params.obj_scale * g, A

    return ModelFns(eval_obj_con=ev, eval_grad=gr, hess_diag=None)


class QuadraticSubproblem(Problem):
    """Quadratic/linear model of the user problem about xk, expressed in the
    step variable p (`ParOptQuadraticSubproblem`, `ParOptTrustRegion.cpp:
    41-419`):

        min  fk + gk·p + 1/2 p·B·p
        s.t. ck + Ak·p >= 0,   cwk + Awk·p >= 0,
             max(-Δ, lb-xk) <= p <= min(Δ, ub-xk)

    with B the compact quasi-Newton approximation shared with the IP solver
    via the qn holder.
    """

    def __init__(self, problem: Problem, qn_holder: Dict[str, Any]):
        super().__init__(nvars=problem.nvars, ncon=problem.ncon,
                         nwcon=problem.nwcon, nwblock=problem.nwblock,
                         ninequality=problem.ninequality,
                         nwinequality=problem.nwinequality)
        self.prob = problem
        self.qn_holder = qn_holder
        x0, lb, ub = problem.get_vars_and_bounds()
        self.xk = jnp.asarray(x0)
        self.lb = jnp.asarray(lb)
        self.ub = jnp.asarray(ub)
        self.lk = self.lb - self.xk
        self.uk = self.ub - self.xk
        # linearization data (filled by init_model)
        self.fk = None
        self.gk = None
        self.ck = None
        self.Ak = None
        self.cwk = None
        self.Awk: Optional[SparseJacobian] = None
        # trial-point cache
        self.ft = None
        self.ct = None
        self.gt = None
        self.At = None
        self.qn_update_type = (0, 0)  # (skipped, damped)
        # second-order-correction state
        self.c_soc = None
        self.is_soc_step = False

    # -- model management ----------------------------------------------------

    def init_model(self, tr_size: float):
        """`initModelAndBounds` (`ParOptTrustRegion.cpp:1087-1105`):
        evaluate the real function/gradients at xk and set TR bounds."""
        fobj, c = self.prob.eval_obj_con(self.xk)
        self.fk = jnp.asarray(fobj)
        self.ck = jnp.asarray(c).reshape(self.ncon)
        self.gk, self.Ak = self.prob.eval_obj_con_gradient(self.xk)
        if self.nwcon > 0:
            self.cwk = jnp.asarray(self.prob.eval_sparse_con(self.xk))
            self.Awk = self.prob.sparse_jacobian(self.xk)
        self.set_trust_region_bounds(tr_size)

    def set_trust_region_bounds(self, tr_size: float):
        self.lk = jnp.maximum(-tr_size, self.lb - self.xk)
        self.uk = jnp.minimum(tr_size, self.ub - self.xk)

    def eval_trial_step_and_update(self, update_flag: bool, p, z, zw
                                   ) -> Tuple[Any, Any]:
        """Evaluate the REAL objective/constraints/gradients at xk + p and
        update the quasi-Newton pair (`evalTrialStepAndUpdate`,
        `ParOptTrustRegion.cpp:172-212`). Returns (ft, ct)."""
        xt = self.xk + p
        # old-point Lagrangian gradient BEFORE the new evaluation (stateful
        # CSR-style problems overwrite their stored Jacobian on evaluation)
        qn = self.qn_holder.get("state")
        if qn is not None and update_flag:
            y0 = self.gk - (self.Ak.T @ z if self.ncon else 0.0)
            if self.nwcon > 0:
                y0 = y0 - self.prob.sparse_jacobian_tvec(self.xk, zw)
        ft, ct = self.prob.eval_obj_con(xt)
        self.ft = jnp.asarray(ft)
        self.ct = jnp.asarray(ct).reshape(self.ncon)
        self.gt, self.At = self.prob.eval_obj_con_gradient(xt)
        self.qn_update_type = (0, 0)
        if qn is not None and update_flag:
            y = self.gt - (self.At.T @ z if self.ncon else 0.0)
            if self.nwcon > 0:
                y = y - self.prob.sparse_jacobian_tvec(xt, zw)
            y = y - y0
            s, y = self.prob.compute_quasi_newton_update_correction(
                xt, z, zw, p, y)
            new_qn, skipped, damped = qnmod.qn_update(qn, s, y)
            self.qn_holder["state"] = new_qn
            self.qn_update_type = (int(skipped), int(damped))
        return self.ft, self.ct

    def accept_trial_step(self, p):
        """`acceptTrialStep` (`ParOptTrustRegion.cpp:215-229`)."""
        self.xk = self.xk + p
        self.fk = self.ft
        self.ck = self.ct
        self.gk = self.gt
        self.Ak = self.At
        if self.nwcon > 0:
            self.cwk = jnp.asarray(self.prob.eval_sparse_con(self.xk))
            self.Awk = self.prob.sparse_jacobian(self.xk)

    def reject_trial_step(self):
        self.ft = None
        self.ct = None

    # -- second-order correction (`updateSocCon`/`startSecondOrderCorrection`)
    def update_soc_con(self, step, ct):
        """c_soc = c(xk + step) - Ak*step, so the linearized model about the
        SOC origin reproduces the actual constraint values at the rejected
        trial point."""
        self.c_soc = jnp.asarray(ct) - (self.Ak @ step if self.ncon
                                        else jnp.zeros(0))

    def start_soc(self):
        self.is_soc_step = True

    def end_soc(self):
        self.is_soc_step = False

    # -- Problem interface (in the step variable p) --------------------------

    def get_vars_and_bounds(self):
        p0 = 0.5 * (self.lk + self.uk)
        return p0, self.lk, self.uk

    def model_obj_con(self, p=None):
        """Model objective/constraints (`evalObjCon`,
        `ParOptTrustRegion.cpp:289-325`); p=None means p=0."""
        if p is None:
            return self.fk, self.ck
        f = self.fk + jnp.vdot(self.gk, p)
        qn = self.qn_holder.get("state")
        if qn is not None:
            f = f + 0.5 * jnp.vdot(p, qnmod.qn_mult(qn, p))
        cbase = self.c_soc if self.is_soc_step else self.ck
        c = (cbase + self.Ak @ p) if self.ncon else self.ck
        return f, c

    def eval_obj_con(self, p):
        return self.model_obj_con(p)

    def eval_obj_con_gradient(self, p):
        qn = self.qn_holder.get("state")
        g = self.gk + (qnmod.qn_mult(qn, p) if qn is not None else 0.0)
        return g, self.Ak

    def eval_sparse_con(self, p):
        return self.cwk + self.Awk.matvec(p)

    def sparse_jacobian(self, p):
        return self.Awk

    def write_output(self, it, p):
        pass


class InfeasSubproblem(Problem):
    """Infeasibility-minimization subproblem for the adaptive-penalty
    "steering" strategy and filter restoration (`ParOptInfeasSubproblem`,
    `ParOptTrustRegion.cpp:293-371` header / `:430-658`): same constraints
    and bounds as the quadratic subproblem but a scaled constant/linear/
    quadratic objective; the IP's elastic slack formulation with unit
    penalties then minimizes the l1 constraint violation."""

    def __init__(self, sub: QuadraticSubproblem,
                 objective_type: str = "linear_objective",
                 constraint_type: str = "linear_constraint"):
        super().__init__(nvars=sub.nvars, ncon=sub.ncon, nwcon=sub.nwcon,
                         nwblock=sub.nwblock, ninequality=sub.ninequality,
                         nwinequality=sub.nwinequality)
        self.sub = sub
        self.objective_type = objective_type
        self.constraint_type = constraint_type
        self.obj_scale = 1.0

    def get_vars_and_bounds(self):
        return self.sub.get_vars_and_bounds()

    def eval_obj_con(self, p):
        s = self.sub
        if self.objective_type == "constant_objective":
            f = s.fk
        elif self.objective_type == "subproblem_objective":
            f, _ = s.model_obj_con(p)
        else:  # linear_objective
            f = s.fk + jnp.vdot(s.gk, p)
        if self.constraint_type == "subproblem_constraint":
            _, c = s.model_obj_con(p)
        else:
            c = (s.ck + s.Ak @ p) if s.ncon else s.ck
        return self.obj_scale * f, c

    def eval_obj_con_gradient(self, p):
        s = self.sub
        if self.objective_type == "constant_objective":
            g = jnp.zeros_like(s.gk)
        elif self.objective_type == "subproblem_objective":
            g, _ = s.eval_obj_con_gradient(p)
        else:
            g = s.gk
        return self.obj_scale * g, s.Ak

    def eval_sparse_con(self, p):
        return self.sub.eval_sparse_con(p)

    def sparse_jacobian(self, p):
        return self.sub.Awk

    def write_output(self, it, p):
        pass


def _fused_ip_options(o, barrier: str, start: str,
                      slm: bool) -> FusedIPOptions:
    """Map the registry's IP options onto the inner fused-IP solver's
    static options — the SINGLE mapping shared by the host TrustRegion's
    fused subproblem solves and FusedTR (forced overrides per
    `sl1qpOptimize`, `ParOptTrustRegion.cpp:1490-1500`:
    use_quasi_newton_update off — the outer loop owns the QN update)."""
    if start == "default":
        start = "affine_step"
    if barrier == "default":
        # Resolve the steering 'default' the same way the host-loop
        # ip_infeas path does: fall back to the main barrier strategy.
        barrier = o["barrier_strategy"]
    return FusedIPOptions(
        abs_res_tol=o["abs_res_tol"],
        init_barrier_param=o["init_barrier_param"],
        monotone_barrier_fraction=o["monotone_barrier_fraction"],
        monotone_barrier_power=o["monotone_barrier_power"],
        rel_bound_barrier=o["rel_bound_barrier"],
        min_fraction_to_boundary=o["min_fraction_to_boundary"],
        penalty_descent_fraction=o["penalty_descent_fraction"],
        min_rho_penalty_search=o["min_rho_penalty_search"],
        armijo_constant=o["armijo_constant"],
        function_precision=o["function_precision"],
        design_precision=o["design_precision"],
        max_line_iters=o["max_line_iters"],
        use_backtracking_alpha=o["use_backtracking_alpha"],
        max_major_iters=o["max_major_iters"],
        iterative_refinement_steps=o["iterative_refinement_steps"],
        qn_sigma=o["qn_sigma"],
        barrier_strategy=barrier,
        starting_point_strategy=start,
        start_affine_multiplier_min=o["start_affine_multiplier_min"],
        use_line_search=o["use_line_search"],
        use_quasi_newton_update=False,
        sequential_linear_method=slm,
        norm_type=o["norm_type"])


def _l1_violation(c, nineq, gamma=None):
    """Σ γ_i · viol_i with viol = max(0, -c) for inequalities, |c| for
    equalities."""
    if c.shape[0] == 0:
        return jnp.zeros(())
    idx = np.arange(c.shape[0])
    viol = jnp.where(idx < nineq, jnp.maximum(0.0, -c), jnp.abs(c))
    if gamma is not None:
        viol = gamma * viol
    return jnp.sum(viol)


class TrustRegion:
    """Trust-region outer loop (`ParOptTrustRegion`), the reference's default
    algorithm."""

    def __init__(self, problem: Problem, options: Optional[Any] = None,
                 subproblem: Optional[QuadraticSubproblem] = None):
        self.problem = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="facade")
        o = self.options
        # a custom subproblem (e.g. the eigenvalue EigenSubproblem) may be
        # injected (`ParOptOptimizer::setTrustRegionSubproblem`); its inner
        # solves use the host-loop IP since its models are not plain QPs
        self._custom_sub = subproblem is not None
        if self._custom_sub:
            self.subproblem = subproblem
            self.qn_holder = subproblem.qn_holder
        else:
            self.qn_holder: Dict[str, Any] = {"state": None}
            self.subproblem = QuadraticSubproblem(problem, self.qn_holder)

        # per-constraint penalties, adaptively updated
        self.penalty_gamma = np.full(problem.ncon, o["penalty_gamma"])
        self.tr_size = o["tr_init_size"]
        self.iter_count = 0
        self._logger = None

        # the IP solver over the quadratic subproblem
        ip_opts = self.options.copy()
        ip_opts["use_quasi_newton_update"] = False
        ip_opts["write_output_frequency"] = 0
        ip_opts["output_file"] = None
        self.ip = InteriorPoint(self.subproblem, ip_opts)
        if not self._custom_sub:
            self._init_ip_qn()
        self.ip.set_quasi_newton_holder(self.qn_holder)

        # steering / restoration solver over the infeasibility subproblem
        self.infeas_problem = InfeasSubproblem(
            self.subproblem, o["tr_adaptive_objective"],
            o["tr_adaptive_constraint"])
        inf_opts = self.options.copy()
        inf_opts["use_quasi_newton_update"] = False
        inf_opts["write_output_frequency"] = 0
        inf_opts["output_file"] = None
        if (o["tr_adaptive_objective"] in ("linear_objective",
                                           "constant_objective")
                and o["tr_adaptive_constraint"] == "linear_constraint"):
            inf_opts["sequential_linear_method"] = True
        if o["tr_steering_barrier_strategy"] != "default":
            inf_opts["barrier_strategy"] = o["tr_steering_barrier_strategy"]
        if o["tr_steering_starting_point_strategy"] != "default":
            inf_opts["starting_point_strategy"] = (
                o["tr_steering_starting_point_strategy"])
        self.ip_infeas = InteriorPoint(self.infeas_problem, inf_opts)
        self.ip_infeas.set_penalty_gamma(1.0)

        self.filter: List[Tuple[float, float]] = []

        # fused-IP inner solvers (pure-jax subproblems => zero host code in
        # the inner loop); built lazily on first solve
        self._fused_qp: Optional[FusedIP] = None
        self._fused_infeas: Optional[FusedIP] = None
        self.subproblem_iters = 0

    # -- fused inner solver --------------------------------------------------

    def _fused_opts(self, barrier: str, start: str,
                    slm: bool) -> FusedIPOptions:
        return _fused_ip_options(self.options, barrier, start, slm)

    def _build_fused(self):
        o = self.options
        prob = self.problem
        n, ncon, nwcon = prob.nvars, prob.ncon, prob.nwcon
        has_sp = nwcon > 0
        qp_model = make_qp_model(has_sp, "quadratic")
        self._fused_qp = FusedIP(
            qp_model, n, ncon, nwcon, prob.nwblock,
            self._fused_opts(o["barrier_strategy"],
                             o["starting_point_strategy"], False),
            dtype=self.ip.dtype)
        obj_mode = {"linear_objective": "linear",
                    "constant_objective": "constant",
                    "subproblem_objective": "quadratic"}[
                        o["tr_adaptive_objective"]]
        slm = (obj_mode in ("linear", "constant")
               and o["tr_adaptive_constraint"] == "linear_constraint")
        inf_model = make_qp_model(has_sp, obj_mode)
        self._fused_infeas = FusedIP(
            inf_model, n, ncon, nwcon, prob.nwblock,
            self._fused_opts(o["tr_steering_barrier_strategy"],
                             o["tr_steering_starting_point_strategy"], slm),
            dtype=self.ip.dtype)

    def _fused_data(self, gamma_s, gamma_t, gamma_scalar_sparse) -> ProblemData:
        sub = self.subproblem
        dt = self.ip.dtype
        n, ncon, nwcon = sub.nvars, sub.ncon, sub.nwcon
        ones = jnp.ones(n, dt)
        if nwcon > 0:
            cols, vals = sub.Awk.cols, jnp.asarray(sub.Awk.vals, dt)
            layout = detect_aw_layout(cols, n)
        else:
            cols = vals = None
            layout = "gather"
        idxw = np.arange(nwcon)
        gsw = jnp.where(idxw < self.problem.nwinequality, 0.0,
                        gamma_scalar_sparse) * jnp.ones(nwcon, dt)
        gtw = jnp.full((nwcon,), gamma_scalar_sparse, dt)
        return ProblemData(
            g=jnp.zeros(n, dt), A=jnp.zeros((ncon, n), dt),
            c=jnp.zeros(ncon, dt), cw=jnp.zeros(nwcon, dt),
            lb=jnp.asarray(sub.lk, dt), ub=jnp.asarray(sub.uk, dt),
            lb_mask=ones, ub_mask=ones,
            gamma_s=jnp.asarray(gamma_s, dt), gamma_t=jnp.asarray(gamma_t, dt),
            gamma_sw=gsw, gamma_tw=gtw,
            Aw_cols=cols, Aw_vals=vals, nwblock=sub.nwblock,
            Aw_layout=layout)

    def _qp_params(self, obj_scale=1.0, ck_override=None) -> "QPParams":
        sub = self.subproblem
        dt = self.ip.dtype
        qn = self.qn_holder.get("state")
        if qn is not None:
            b0, Z, M = qnmod.qn_compact(qn)
        else:
            b0, Z, M = jnp.asarray(1.0, dt), None, None
        nwcon = sub.nwcon
        cwk = (jnp.asarray(sub.cwk, dt) if nwcon > 0
               else jnp.zeros(0, dt))
        ck = sub.ck if ck_override is None else ck_override
        return QPParams(
            fk=jnp.asarray(sub.fk, dt), gk=jnp.asarray(sub.gk, dt),
            ck=jnp.asarray(ck, dt), Ak=jnp.asarray(sub.Ak, dt),
            cwk=cwk,
            Aw_cols=sub.Awk.cols if nwcon > 0 else None,
            Aw_vals=(jnp.asarray(sub.Awk.vals, dt) if nwcon > 0 else None),
            b0=b0, Z=Z, M=M, obj_scale=jnp.asarray(obj_scale, dt))

    def _init_ip_qn(self):
        o = self.options
        qt = o["qn_type"]
        msub = qnmod.resolve_subspace_size(
            o["qn_subspace_size"], o["qn_subspace_auto"],
            self.problem.nvars, self.ip.dtype)
        if qt != "none" and msub > 0:
            from .ip import _resolve_qn_storage
            storage = _resolve_qn_storage(o["qn_storage_dtype"],
                                          self.ip.dtype)
            self.qn_holder["state"] = qnmod.qn_init(
                msub, self.problem.nvars,
                dtype=self.ip.dtype,
                qn_type=qt, storage_dtype=storage,
                update_type=o["qn_update_type"], diag_type=o["qn_diag_type"])
        else:
            self.qn_holder["state"] = None

    # -- shared helpers ------------------------------------------------------

    def _model_infeas(self, c, gamma=None):
        return float(_l1_violation(c, self.problem.ninequality, gamma))

    def compute_kkt_error(self, z, zw) -> Tuple[float, float]:
        """Projected-gradient KKT error with bound-activity masking
        (`computeKKTError`, `ParOptTrustRegion.cpp:2391-2470`)."""
        o = self.options
        relax = o["tr_bound_relax"]
        s = self.subproblem
        r = s.gk - (s.Ak.T @ z if s.ncon else 0.0)
        if s.nwcon > 0:
            r = r - s.Awk.rmatvec(zw)
        x, lb, ub = s.xk, s.lb, s.ub
        r = jnp.where((x <= lb + relax) & (r > 0.0), 0.0, r)
        r = jnp.where((x >= ub - relax) & (r < 0.0), 0.0, r)
        l1 = float(jnp.sum(jnp.abs(r)))
        linf = float(jnp.max(jnp.abs(r))) if r.size else 0.0
        zmax = 1.0
        if s.ncon:
            zmax = max(zmax, float(jnp.max(jnp.abs(z))))
        if s.nwcon:
            zmax = max(zmax, float(jnp.max(jnp.abs(zw))))
        g_l1 = float(jnp.sum(jnp.abs(s.gk)))
        g_inf = float(jnp.max(jnp.abs(s.gk)))
        return l1 / max(g_l1, zmax), linf / max(g_inf, zmax)

    def _solve_subproblem(self, ck_override=None):
        if self._custom_sub:
            self.ip.reset_design_and_bounds()
            self.ip.set_penalty_gamma(jnp.asarray(self.penalty_gamma))
            self.ip.optimize()
            self.subproblem_iters = self.ip.niter
            step, z, zw, _, _ = self.ip.get_optimized_point()
            return step, z, zw
        if self._fused_qp is None:
            self._build_fused()
        idx = np.arange(self.problem.ncon)
        gam = jnp.asarray(self.penalty_gamma)
        gamma_s = jnp.where(idx < self.problem.ninequality, 0.0, gam)
        data = self._fused_data(gamma_s, gam,
                                self.options["penalty_gamma"])
        params = self._qp_params(ck_override=ck_override)
        compact = (params.b0, params.Z, params.M)
        p0 = 0.5 * (self.subproblem.lk + self.subproblem.uk)
        st = self._fused_qp.solve(p0.astype(self.ip.dtype), data, params,
                                  compact=compact,
                                  jit_loop=_accel_jit_loop())
        self.subproblem_iters = int(st.k)
        return st.vars.x, st.vars.z, st.vars.zw

    def _minimize_infeas(self):
        """Steering / restoration infeasibility solve (`minimizeInfeas`,
        `ParOptTrustRegion.cpp:1107-1229`). Returns (step, best_con_infeas):
        unit elastic penalties + a tiny objective scale make the IP minimize
        the l1 constraint violation inside the TR box."""
        o = self.options
        if self._custom_sub:
            gamma_big = max(1e6, 1e2 * o["tr_penalty_gamma_max"])
            qn_obj = self.qn_holder.get("state")
            if hasattr(qn_obj, "use_quasi_newton_objective"):
                qn_obj.use_quasi_newton_objective = False
            self.infeas_problem.obj_scale = 1.0 / gamma_big
            self.ip_infeas.set_quasi_newton_holder(self.qn_holder)
            self.ip_infeas.reset_design_and_bounds()
            self.ip_infeas.optimize()
            step, _, _, _, _ = self.ip_infeas.get_optimized_point()
            if hasattr(qn_obj, "use_quasi_newton_objective"):
                qn_obj.use_quasi_newton_objective = True
            _, c_best = self.subproblem.model_obj_con(step)
            idx = np.arange(self.problem.ncon)
            best = jnp.where(idx < self.problem.ninequality,
                             jnp.maximum(0.0, -c_best), jnp.abs(c_best))
            return step, np.asarray(best)
        if self._fused_infeas is None:
            self._build_fused()
        gamma_big = max(1e6, 1e2 * o["tr_penalty_gamma_max"])
        ncon = self.problem.ncon
        ones = jnp.ones(ncon)
        idx = np.arange(ncon)
        gamma_s = jnp.where(idx < self.problem.ninequality, 0.0, ones)
        data = self._fused_data(gamma_s, ones, 1.0)
        use_quad = o["tr_adaptive_objective"] == "subproblem_objective"
        params = self._qp_params(obj_scale=1.0 / gamma_big)
        compact = (params.b0, params.Z, params.M) if use_quad else None
        p0 = 0.5 * (self.subproblem.lk + self.subproblem.uk)
        st = self._fused_infeas.solve(p0.astype(self.ip.dtype), data, params,
                                      compact=compact,
                                      jit_loop=_accel_jit_loop())
        step = st.vars.x
        _, c_best = self.subproblem.model_obj_con(step)
        best = jnp.where(idx < self.problem.ninequality,
                         jnp.maximum(0.0, -c_best), jnp.abs(c_best))
        return step, np.asarray(best)

    # -- main entry ----------------------------------------------------------

    def optimize(self) -> Dict[str, Any]:
        o = self.options
        self._logger = TRLogger(o["tr_output_file"])
        if o["tr_accept_step_strategy"] == "filter_method":
            result = self._filter_optimize()
        else:
            result = self._sl1qp_optimize()
        self._logger.close()
        return result

    def get_optimized_point(self):
        return self.subproblem.xk

    # -- SL1QP ---------------------------------------------------------------

    def _sl1qp_optimize(self) -> Dict[str, Any]:
        o = self.options
        adaptive = o["tr_adaptive_gamma_update"]
        max_iters = o["tr_max_iterations"]
        infeas_tol = o["tr_infeas_tol"]
        l1_tol, linf_tol = o["tr_l1_tol"], o["tr_linfty_tol"]
        gamma_max = o["tr_penalty_gamma_max"]
        gamma_min = o["tr_penalty_gamma_min"]
        nineq = self.problem.ninequality
        write_freq = o["tr_write_output_frequency"]

        self.subproblem.init_model(self.tr_size)
        converged = False
        infeas = l1 = linf = float("inf")

        for i in range(max_iters):
            best_con_infeas = None
            if adaptive:
                _, best_con_infeas = self._minimize_infeas()

            if write_freq > 0 and i % write_freq == 0:
                self.problem.write_output(i, self.subproblem.xk)

            step, z, zw = self._solve_subproblem()

            if adaptive:
                _, c0 = self.subproblem.model_obj_con(None)
                _, cm = self.subproblem.model_obj_con(step)
                idx = np.arange(self.problem.ncon)
                con_infeas = np.asarray(jnp.where(
                    idx < nineq, jnp.maximum(0.0, -c0), jnp.abs(c0)))
                model_con_infeas = np.asarray(jnp.where(
                    idx < nineq, jnp.maximum(0.0, -cm), jnp.abs(cm)))

            infeas, l1, linf, rho = self._sl1qp_update(step, z, zw)

            if infeas < infeas_tol and (l1 < l1_tol or linf < linf_tol):
                converged = True
                break

            if adaptive:
                # per-constraint penalty adaptation
                # (`ParOptTrustRegion.cpp:1609-1671`)
                zabs = np.abs(np.asarray(z))
                for j in range(self.problem.ncon):
                    infeas_reduction = con_infeas[j] - model_con_infeas[j]
                    best_reduction = con_infeas[j] - best_con_infeas[j]
                    if (zabs[j] > infeas_tol and con_infeas[j] < infeas_tol
                            and self.penalty_gamma[j] >= 2.0 * zabs[j]):
                        self.penalty_gamma[j] = max(
                            0.5 * (self.penalty_gamma[j] + zabs[j]),
                            gamma_min)
                    elif (con_infeas[j] > infeas_tol
                          and 0.995 * best_reduction > infeas_reduction):
                        self.penalty_gamma[j] = min(
                            1.5 * self.penalty_gamma[j], gamma_max)

        return {"x": self.subproblem.xk, "fobj": float(self.subproblem.fk),
                "converged": converged, "niter": self.iter_count,
                "infeas": infeas, "l1": l1, "linfty": linf}

    def _sl1qp_update(self, step, z, zw):
        """Accept/reject + radius update (`sl1qpUpdate`,
        `ParOptTrustRegion.cpp:1231-1452`)."""
        o = self.options
        t0 = time.time()
        eta = o["tr_eta"]
        tr_min, tr_max = o["tr_min_size"], o["tr_max_size"]
        fprec = o["function_precision"]
        gam = jnp.asarray(self.penalty_gamma)
        nineq = self.problem.ninequality

        fk, ck = self.subproblem.model_obj_con(None)
        infeas_k = self._model_infeas(ck, gam)
        ft_model, ct_model = self.subproblem.model_obj_con(step)
        obj_reduc = float(fk - ft_model)
        infeas_model = self._model_infeas(ct_model, gam)

        ft, ct = self.subproblem.eval_trial_step_and_update(
            True, step, z, zw)
        infeas_t = self._model_infeas(ct, gam)

        actual_reduc = float(fk - ft) + (infeas_k - infeas_t)
        model_reduc = obj_reduc + (infeas_k - infeas_model)

        if abs(model_reduc) <= fprec and abs(actual_reduc) <= fprec:
            rho = 1.0
        else:
            rho = actual_reduc / model_reduc if model_reduc != 0 else 1.0

        if self._logger is not None and o["output_level"] > 0:
            # actual/predicted reduction block, the contract
            # `unpack_tr_2nd_output` parses (`ParOptTrustRegion.cpp:
            # 1316-1321`)
            self._logger.write(
                "\n%-15s %12s %12s %12s %12s\n"
                % ("Model", "ared(f)", "pred(f)", "ared(c)", "pred(c)"))
            self._logger.write(
                "%15s %12.5e %12.5e %12.5e %12.5e\n"
                % (" ", float(fk - ft), obj_reduc,
                   float(infeas_k - infeas_t),
                   float(infeas_k - infeas_model)))

        infeas_new = self._model_infeas(ct)

        accepted = rho >= eta or self.tr_size <= tr_min
        if accepted:
            smax = float(jnp.max(jnp.abs(step))) if step.size else 0.0
            try:
                self.subproblem.accept_trial_step(step, z, zw)
            except TypeError:
                self.subproblem.accept_trial_step(step)
        else:
            self.subproblem.reject_trial_step()
            smax = 0.0

        if rho < 0.25:
            self.tr_size = max(0.25 * self.tr_size, tr_min)
        elif rho > 0.75:
            self.tr_size = min(1.5 * self.tr_size, tr_max)
        self.subproblem.set_trust_region_bounds(self.tr_size)

        l1, linf = self.compute_kkt_error(z, zw)

        m = max(self.problem.ncon, 1)
        zav = float(np.sum(np.abs(np.asarray(z)))) / m
        zmax = float(np.max(np.abs(np.asarray(z)))) if self.problem.ncon \
            else 0.0
        gav = float(np.mean(self.penalty_gamma)) if self.problem.ncon else 0.0
        gmax = float(np.max(self.penalty_gamma)) if self.problem.ncon else 0.0

        skipped, damped = self.subproblem.qn_update_type
        info = ("dampH " if damped else "") + ("skipH " if skipped else "")
        info += f"{self.subproblem_iters} "
        if not accepted:
            info += "rej "
        self._logger.log(self.iter_count, float(fk), infeas_new, l1, linf,
                         smax, self.tr_size, rho, model_reduc, zav, zmax,
                         gav, gmax, time.time() - t0, info)
        self.iter_count += 1
        return infeas_new, l1, linf, rho

    # -- filter method -------------------------------------------------------

    def _acceptable_by_pair(self, f_new, h_new, f_old, h_old) -> bool:
        o = self.options
        gamma = o["filter_gamma"]
        if o["filter_sufficient_reduction"]:
            return (h_new < (1.0 - gamma) * h_old
                    or f_new < f_old - gamma * h_new)
        return h_new < h_old or f_new < f_old

    def _acceptable_by_filter(self, f, h) -> bool:
        return all(self._acceptable_by_pair(f, h, fe, he)
                   for fe, he in self.filter)

    def _add_to_filter(self, f, h):
        self.filter = [(fe, he) for fe, he in self.filter
                       if not (f <= fe and h <= he)]
        self.filter.append((f, h))

    def _is_accepted_by_soc(self, step, ft, ct):
        """Second-order-correction loop (`isAcceptedBySoc`,
        `ParOptTrustRegion.cpp:2228-2355`): re-solve the QP with the
        constraint linearization shifted to reproduce the rejected trial
        values; accept when filter-acceptable.  Returns
        (success, step, ft, ct, niters)."""
        o = self.options
        max_soc = o["tr_max_soc_iterations"]
        infeas_tol = o["tr_infeas_tol"]
        nineq = self.problem.ninequality
        gam = jnp.asarray(self.penalty_gamma)

        def merit_and_infeas(f, c):
            h = self._model_infeas(c)
            m = float(f) + self._model_infeas(c, gam)
            return m, h

        best_step, best_ft, best_ct = step, ft, ct
        merit_old, infeas_old = merit_and_infeas(ft, ct)
        niters = 0
        for _ in range(max_soc):
            c_soc = jnp.asarray(ct) - (self.subproblem.Ak @ step
                                       if self.problem.ncon else ct)
            step, z, zw = self._solve_subproblem(ck_override=c_soc)
            ft, ct = self.subproblem.eval_trial_step_and_update(
                bool(o["tr_soc_update_qn"]), step, z, zw)
            ft = float(ft)
            niters += 1
            merit_new, infeas_new = merit_and_infeas(ft, ct)
            r = infeas_new / max(infeas_old, 1e-300)
            infeas_old = infeas_new
            if merit_new < merit_old:
                best_step, best_ft, best_ct = step, ft, ct
                merit_old = merit_new
            zabs = np.abs(np.asarray(z)) if self.problem.ncon else np.zeros(0)
            infeas_qp = bool(
                (zabs + infeas_tol >= np.asarray(self.penalty_gamma)).any())
            if self._acceptable_by_filter(ft, infeas_new):
                self._add_to_filter(ft, infeas_new)
                return True, step, ft, ct, niters
            if infeas_qp or r > 0.25 or infeas_new < infeas_tol:
                return False, best_step, best_ft, best_ct, niters
        return False, best_step, best_ft, best_ct, niters

    def _filter_optimize(self) -> Dict[str, Any]:
        o = self.options
        max_iters = o["tr_max_iterations"]
        eta = o["tr_eta"]
        tr_min, tr_max = o["tr_min_size"], o["tr_max_size"]
        infeas_tol = o["tr_infeas_tol"]
        l1_tol, linf_tol = o["tr_l1_tol"], o["tr_linfty_tol"]
        has_restore = o["filter_has_feas_restore_phase"]
        write_freq = o["tr_write_output_frequency"]

        self.subproblem.init_model(self.tr_size)
        f0, c0 = self.subproblem.model_obj_con(None)
        h0 = self._model_infeas(c0)
        self.filter = []
        self._add_to_filter(-1e20, max(1e4, 1.25 * h0))

        last_resto = False
        converged = False
        infeas_trial = l1 = linf = float("inf")

        for it in range(max_iters):
            t0 = time.time()
            fk, ck = self.subproblem.model_obj_con(None)
            fk = float(fk)
            hk = self._model_infeas(ck)

            step, z, zw = self._solve_subproblem()

            this_resto = False
            if has_restore:
                _, cm = self.subproblem.model_obj_con(step)
                resid = self._model_infeas(cm)
                if resid > infeas_tol:
                    this_resto = True
                    self._add_to_filter(fk, hk)
                elif last_resto and self.qn_holder["state"] is not None:
                    self.qn_holder["state"] = qnmod.qn_reset(
                        self.qn_holder["state"])

            if this_resto:
                if not last_resto and self.qn_holder["state"] is not None:
                    self.qn_holder["state"] = qnmod.qn_reset(
                        self.qn_holder["state"])
                step, _ = self._minimize_infeas()

            fobj_model, _ = self.subproblem.model_obj_con(step)
            ft, ct = self.subproblem.eval_trial_step_and_update(
                True, step, z, zw)
            ft = float(ft)
            infeas_trial = self._model_infeas(ct)
            smax = float(jnp.max(jnp.abs(step))) if step.size else 0.0

            init_tr = increase_tr = decrease_tr = False
            accepted = False
            info_rej = ""
            model_red = fk - float(fobj_model)
            actual_red = fk - ft
            rho = actual_red / model_red if model_red != 0 else 1.0

            if this_resto:
                self.subproblem.accept_trial_step(step)
                accepted = True
                if smax >= 0.99 * self.tr_size:
                    increase_tr = True
            else:
                by_filter = self._acceptable_by_filter(ft, infeas_trial)
                by_pair = self._acceptable_by_pair(ft, infeas_trial, fk, hk)
                if by_filter and by_pair:
                    if actual_red < eta * model_red and model_red > 0.0:
                        self.subproblem.reject_trial_step()
                        smax = 0.0
                        decrease_tr = True
                        info_rej = "rej:rho"
                    else:
                        self.subproblem.accept_trial_step(step)
                        accepted = True
                        if model_red <= 0.0:
                            self._add_to_filter(ft, infeas_trial)
                        init_tr = True
                elif self.tr_size <= tr_min:
                    self.subproblem.accept_trial_step(step)
                    accepted = True
                    if smax >= 0.99 * self.tr_size:
                        increase_tr = True
                elif o["tr_use_soc"]:
                    ok, step, ft, ct, _soc_iters = self._is_accepted_by_soc(
                        step, ft, ct)
                    infeas_trial = self._model_infeas(ct)
                    smax = float(jnp.max(jnp.abs(step))) if ok else 0.0
                    if ok:
                        self.subproblem.accept_trial_step(step)
                        accepted = True
                        if smax >= 0.99 * self.tr_size:
                            increase_tr = True
                        info_rej = "SocSucc"
                    else:
                        self.subproblem.reject_trial_step()
                        decrease_tr = True
                        info_rej = "SocFail"
                else:
                    self.subproblem.reject_trial_step()
                    smax = 0.0
                    decrease_tr = True
                    info_rej = "rej:" + ("F" if not by_filter else "") + (
                        "xk" if not by_pair else "")

            if write_freq > 0 and it % write_freq == 0:
                self.problem.write_output(it, self.subproblem.xk)

            l1, linf = self.compute_kkt_error(z, zw)

            skipped, damped = self.subproblem.qn_update_type
            info = ("dampH " if damped else "") + ("skipH " if skipped else "")
            info += f"{self.subproblem_iters} f{len(self.filter)} "
            if this_resto:
                info += "R "
            if not accepted:
                info += info_rej or "rej"
            m = max(self.problem.ncon, 1)
            zav = float(np.sum(np.abs(np.asarray(z)))) / m
            zmax = (float(np.max(np.abs(np.asarray(z))))
                    if self.problem.ncon else 0.0)
            self._logger.log(self.iter_count, ft, infeas_trial, l1, linf,
                             smax, self.tr_size, rho, model_red, zav, zmax,
                             float(np.mean(self.penalty_gamma))
                             if self.problem.ncon else 0.0,
                             float(np.max(self.penalty_gamma))
                             if self.problem.ncon else 0.0,
                             time.time() - t0, info)
            self.iter_count += 1

            if increase_tr:
                self.tr_size = min(2.0 * self.tr_size, tr_max)
            elif decrease_tr:
                self.tr_size = max(0.5 * self.tr_size, tr_min)
            if init_tr:
                self.tr_size = tr_max
            self.subproblem.set_trust_region_bounds(self.tr_size)
            last_resto = this_resto

            if infeas_trial < infeas_tol and (l1 < l1_tol or linf < linf_tol):
                converged = True
                break

        return {"x": self.subproblem.xk, "fobj": float(self.subproblem.fk),
                "converged": converged, "niter": self.iter_count,
                "infeas": infeas_trial, "l1": l1, "linfty": linf}


# ---------------------------------------------------------------------------
# Fully-fused trust region: the ENTIRE SL1QP outer loop (TR bounds, steering
# infeasibility solve, QP solve, trial evaluation, quasi-Newton update,
# accept/reject + radius + per-constraint penalty adaptation, KKT test) as
# one XLA computation under lax.while_loop — zero host round-trips.  The
# JAX-native form of the reference's DEFAULT algorithm
# (`sl1qpOptimize`, `ParOptTrustRegion.cpp:1454-1671`), available for
# jax-native problems whose sparse constraint Jacobian is CONSTANT
# (the topology weighting-constraint case) — the same contract as FusedMMA.
# ---------------------------------------------------------------------------


class FusedTROptions(NamedTuple):
    """Static outer-loop options (mirror the tr_* registry entries)."""
    max_iterations: int = 200
    infeas_tol: float = 1e-5
    l1_tol: float = 1e-6
    linf_tol: float = 1e-6
    eta: float = 0.25
    tr_min: float = 1e-3
    tr_max: float = 1.0
    init_size: float = 0.1
    bound_relax: float = 1e-4
    function_precision: float = 1e-10
    adaptive_gamma: bool = True
    gamma_max: float = 1e4
    gamma_min: float = 0.0
    penalty_gamma: float = 1000.0       # elastic gamma for sparse cons
    ninequality: int = 0
    nwinequality: int = 0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedTRState:
    """Outer-loop state pytree (the linearization point + TR machinery)."""
    xk: jnp.ndarray
    fk: jnp.ndarray
    ck: jnp.ndarray
    gk: jnp.ndarray
    Ak: jnp.ndarray
    cwk: jnp.ndarray
    qn: Any                    # QNState or None
    tr_size: jnp.ndarray
    gamma: jnp.ndarray         # [ncon] per-constraint penalties
    k: jnp.ndarray             # outer iteration counter (int32)
    subiters: jnp.ndarray      # cumulative inner IP iterations (int32)
    converged: jnp.ndarray
    infeas: jnp.ndarray
    l1: jnp.ndarray
    linf: jnp.ndarray
    rho: jnp.ndarray           # last actual/model reduction ratio


def _viol(c, nineq):
    """Per-constraint violation: max(0, -c) for inequalities, |c| for
    equalities (`ParOptTrustRegion.cpp:1620-1665`)."""
    if c.shape[0] == 0:
        return c
    idx = jnp.arange(c.shape[0])
    return jnp.where(idx < nineq, jnp.maximum(0.0, -c), jnp.abs(c))


def _fused_tr_step(user_model: ModelFns, qp_model: ModelFns,
                   inf_model: ModelFns, qp_opts: FusedIPOptions,
                   inf_opts: FusedIPOptions, to: FusedTROptions,
                   lbv, ubv, d_tmpl: ProblemData, params_user,
                   state: FusedTRState) -> FusedTRState:
    """One fused SL1QP outer iteration (`sl1qpOptimize` loop body +
    `sl1qpUpdate`, `ParOptTrustRegion.cpp:1544-1671, 1231-1452`)."""
    from .ip_fused import _fused_init, _fused_solve_loop

    xk, fk, ck, gk, Ak, cwk = (state.xk, state.fk, state.ck, state.gk,
                               state.Ak, state.cwk)
    dt = xk.dtype
    ncon = ck.shape[0]
    nineq = to.ninequality
    idx = jnp.arange(ncon)

    # -- trust-region bounds (`initModelAndBounds`/`setTrustRegionBounds`) --
    lk = jnp.maximum(-state.tr_size, lbv - xk)
    uk = jnp.minimum(state.tr_size, ubv - xk)
    p0 = 0.5 * (lk + uk)

    # compact quasi-Newton pieces for the QP objective
    if state.qn is not None:
        b0, Z, M = qnmod.qn_compact(state.qn)
    else:
        b0, Z, M = jnp.asarray(1.0, dt), None, None
    params = QPParams(fk=fk, gk=gk, ck=ck, Ak=Ak, cwk=cwk,
                      Aw_cols=d_tmpl.Aw_cols, Aw_vals=d_tmpl.Aw_vals,
                      b0=b0, Z=Z, M=M, obj_scale=jnp.asarray(1.0, dt))

    # -- steering infeasibility solve (`minimizeInfeas`) --------------------
    if to.adaptive_gamma:
        gamma_big = max(1e6, 1e2 * to.gamma_max)
        inf_params = params._replace(obj_scale=jnp.asarray(1.0 / gamma_big,
                                                           dt))
        ones = jnp.ones(ncon, dt)
        d_inf = dataclasses.replace(
            d_tmpl, lb=lk, ub=uk,
            gamma_s=jnp.where(idx < nineq, 0.0, ones), gamma_t=ones,
            gamma_sw=jnp.where(jnp.arange(d_tmpl.nwcon) < to.nwinequality,
                               0.0, jnp.ones(d_tmpl.nwcon, dt)),
            gamma_tw=jnp.ones(d_tmpl.nwcon, dt))
        st_inf0 = _fused_init(inf_model, inf_opts, p0, d_inf, inf_params,
                              None, None)
        st_inf = _fused_solve_loop(inf_model, inf_opts, st_inf0, d_inf,
                                   inf_params, None)
        c_best = (ck + Ak @ st_inf.vars.x) if ncon else ck
        best_con_infeas = _viol(c_best, nineq)
        inf_iters = st_inf.k
    else:
        best_con_infeas = jnp.zeros(ncon, dt)
        inf_iters = jnp.zeros((), jnp.int32)

    # -- QP subproblem solve (IP-on-QP, the hot loop) ------------------------
    d_qp = dataclasses.replace(
        d_tmpl, lb=lk, ub=uk,
        gamma_s=jnp.where(idx < nineq, 0.0, state.gamma),
        gamma_t=state.gamma)
    compact = (b0, Z, M)
    st0 = _fused_init(qp_model, qp_opts, p0, d_qp, params, None, compact)
    st = _fused_solve_loop(qp_model, qp_opts, st0, d_qp, params, compact)
    p, z, zw = st.vars.x, st.vars.z, st.vars.zw

    # -- model reductions (`sl1qpUpdate`) ------------------------------------
    gam = state.gamma
    infeas_k = jnp.sum(gam * _viol(ck, nineq)) if ncon else jnp.zeros((), dt)
    cm = (ck + Ak @ p) if ncon else ck
    fm = fk + jnp.vdot(gk, p)
    if state.qn is not None:
        fm = fm + 0.5 * jnp.vdot(p, qnmod.qn_mult(state.qn, p,
                                                  compact=compact))
    obj_reduc = fk - fm
    infeas_model = (jnp.sum(gam * _viol(cm, nineq)) if ncon
                    else jnp.zeros((), dt))

    # -- trial evaluation + quasi-Newton update (`evalTrialStepAndUpdate`,
    #    update_flag=True: the QN updates on the trial REGARDLESS of
    #    acceptance, `ParOptTrustRegion.cpp:172-212`) ------------------------
    xt = xk + p
    ft, ct, cwt = user_model.eval_obj_con(params_user, xt)
    ft = jnp.asarray(ft, dt)
    ct = jnp.asarray(ct).reshape(ncon)
    gt, At = user_model.eval_grad(params_user, xt)
    # FAIL-STOP on non-finite trial data (the FusedIP freeze's analogue,
    # and the host loop's eval-failure shrink-retry, `ParOptInteriorPoint.
    # cpp:4019-4026`): a NaN/Inf trial — e.g. a diverged f32 CG solve in a
    # SIMP objective — must never be accepted, never reach the QN state,
    # and must shrink the radius so the next trial is tamer
    trial_finite = (jnp.isfinite(ft) & jnp.all(jnp.isfinite(ct))
                    & jnp.all(jnp.isfinite(gt)) & jnp.all(jnp.isfinite(p)))
    skipped = damped = jnp.zeros((), jnp.int32)
    qn_new = state.qn
    if state.qn is not None:
        # y = grad_x L(xt, z) - grad_x L(xk, z); the CONSTANT sparse
        # Jacobian's Aw^T zw term is identical at both points and cancels
        y = (gt - (At.T @ z if ncon else 0.0)) \
            - (gk - (Ak.T @ z if ncon else 0.0))
        qn_new, skipped, damped = qnmod.qn_update(state.qn, p, y,
                                                  accept=trial_finite)

    infeas_t = jnp.sum(gam * _viol(ct, nineq)) if ncon else jnp.zeros((), dt)
    actual_reduc = (fk - ft) + (infeas_k - infeas_t)
    model_reduc = obj_reduc + (infeas_k - infeas_model)
    fprec = to.function_precision
    both_tiny = (jnp.abs(model_reduc) <= fprec) & \
        (jnp.abs(actual_reduc) <= fprec)
    rho = jnp.where(both_tiny | (model_reduc == 0.0), 1.0,
                    actual_reduc / jnp.where(model_reduc == 0.0, 1.0,
                                             model_reduc))
    # a non-finite trial counts as maximal disagreement: reject + shrink
    rho = jnp.where(trial_finite, rho, -jnp.inf)

    # -- accept / reject + radius update (`:1353-1372`) ----------------------
    accepted = ((rho >= to.eta)
                | ((state.tr_size <= to.tr_min) & trial_finite))
    sel = lambda a, b: jnp.where(accepted, a, b)  # noqa: E731
    xk_n, fk_n, ck_n = sel(xt, xk), sel(ft, fk), sel(ct, ck)
    gk_n, Ak_n = sel(gt, gk), sel(At, Ak)
    # cw at the accepted point comes from the trial evaluation — no extra
    # model eval (accepted: xk_n == xt; rejected: xk_n == xk)
    cwk_n = sel(cwt, cwk) if d_tmpl.nwcon > 0 else cwk
    tr_n = jnp.where(rho < 0.25,
                     jnp.maximum(0.25 * state.tr_size, to.tr_min),
                     jnp.where(rho > 0.75,
                               jnp.minimum(1.5 * state.tr_size, to.tr_max),
                               state.tr_size))

    # -- adaptive per-constraint penalties (`:1609-1671`) --------------------
    gamma_n = state.gamma
    if to.adaptive_gamma and ncon:
        zabs = jnp.abs(z)
        con_infeas = _viol(ck, nineq)
        model_con_infeas = _viol(cm, nineq)
        infeas_reduction = con_infeas - model_con_infeas
        best_reduction = con_infeas - best_con_infeas
        shrink = ((zabs > to.infeas_tol) & (con_infeas < to.infeas_tol)
                  & (gamma_n >= 2.0 * zabs))
        grow = ((con_infeas > to.infeas_tol)
                & (0.995 * best_reduction > infeas_reduction))
        gamma_n = jnp.where(
            shrink, jnp.maximum(0.5 * (gamma_n + zabs), to.gamma_min),
            jnp.where(grow, jnp.minimum(1.5 * gamma_n, to.gamma_max),
                      gamma_n))

    # -- KKT error at the post-update point (`computeKKTError`,
    #    `ParOptTrustRegion.cpp:2391-2470`) ----------------------------------
    r = gk_n - (Ak_n.T @ z if ncon else 0.0)
    if d_tmpl.nwcon > 0:
        r = r - d_tmpl.Aw_rmatvec(zw)
    relax = to.bound_relax
    r = jnp.where((xk_n <= lbv + relax) & (r > 0.0), 0.0, r)
    r = jnp.where((xk_n >= ubv - relax) & (r < 0.0), 0.0, r)
    l1_raw = jnp.sum(jnp.abs(r))
    linf_raw = jnp.max(jnp.abs(r)) if r.size else jnp.zeros((), dt)
    zmax = jnp.asarray(1.0, dt)
    if ncon:
        zmax = jnp.maximum(zmax, jnp.max(jnp.abs(z)))
    if d_tmpl.nwcon:
        zmax = jnp.maximum(zmax, jnp.max(jnp.abs(zw)))
    l1 = l1_raw / jnp.maximum(jnp.sum(jnp.abs(gk_n)), zmax)
    linf = linf_raw / jnp.maximum(jnp.max(jnp.abs(gk_n)), zmax)
    infeas_new = (jnp.sum(_viol(ct, nineq)) if ncon
                  else jnp.zeros((), dt))
    converged = ((infeas_new < to.infeas_tol)
                 & ((l1 < to.l1_tol) | (linf < to.linf_tol)))

    return FusedTRState(
        xk=xk_n, fk=fk_n, ck=ck_n, gk=gk_n, Ak=Ak_n, cwk=cwk_n, qn=qn_new,
        tr_size=tr_n, gamma=gamma_n, k=state.k + 1,
        subiters=state.subiters + st.k + inf_iters, converged=converged,
        infeas=infeas_new, l1=l1, linf=linf, rho=rho)


class FusedTR:
    """Build-once fused SL1QP trust-region solver (the reference's DEFAULT
    algorithm, fully on-device): construction traces nothing; the first
    `solve` compiles the whole outer loop and subsequent solves reuse it.

    Same contract as `FusedMMA`: jax-native problem, sparse constraint
    Jacobian (if any) CONSTANT in x.  Options use the standard tr_*/IP
    registry names.  Per-iteration logging is available through
    ``solve(jit_loop=False)``."""

    def __init__(self, problem, options: Optional[Dict[str, Any]] = None):
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
            cwv = (jnp.asarray(problem.eval_sparse_con(x), dt) if nwcon > 0
                   else jnp.zeros(0, dt))
            return jnp.asarray(f, dt), jnp.asarray(c, dt).reshape(ncon), cwv

        def gr(params, x):
            g, A = problem.eval_obj_con_gradient(x)
            return jnp.asarray(g, dt), jnp.asarray(A, dt).reshape(ncon, n)

        user_model = ModelFns(eval_obj_con=ev, eval_grad=gr)
        has_sp = nwcon > 0
        qp_model = make_qp_model(has_sp, "quadratic")
        obj_mode = {"linear_objective": "linear",
                    "constant_objective": "linear",
                    "subproblem_objective": "quadratic"}[
                        o["tr_adaptive_objective"]]
        inf_model = make_qp_model(has_sp, obj_mode)

        if nwcon > 0:
            Aw = problem.sparse_jacobian(x0)
            cols, vals = Aw.cols, jnp.asarray(Aw.vals, dt)
            layout = detect_aw_layout(cols, n)
        else:
            cols = vals = None
            layout = "gather"
        gamma = o["penalty_gamma"]
        idxw = np.arange(nwcon)
        ones = jnp.ones(n, dt)
        d_tmpl = ProblemData(
            g=jnp.zeros(n, dt), A=jnp.zeros((ncon, n), dt),
            c=jnp.zeros(ncon, dt), cw=jnp.zeros(nwcon, dt),
            lb=lbv, ub=ubv, lb_mask=ones, ub_mask=ones,
            gamma_s=jnp.zeros(ncon, dt), gamma_t=jnp.zeros(ncon, dt),
            gamma_sw=jnp.asarray(
                np.where(idxw < problem.nwinequality, 0.0, gamma), dt),
            gamma_tw=jnp.full((nwcon,), gamma, dt),
            Aw_cols=cols, Aw_vals=vals, nwblock=problem.nwblock,
            Aw_layout=layout)

        slm = (o["tr_adaptive_objective"] in ("linear_objective",
                                              "constant_objective")
               and o["tr_adaptive_constraint"] == "linear_constraint")
        # the SAME registry->FusedIPOptions mapping the host TrustRegion
        # uses for its fused subproblem solves
        qp_opts = _fused_ip_options(o, o["barrier_strategy"],
                                    o["starting_point_strategy"], False)
        inf_opts = _fused_ip_options(
            o, o["tr_steering_barrier_strategy"],
            o["tr_steering_starting_point_strategy"], slm)
        to = FusedTROptions(
            max_iterations=o["tr_max_iterations"],
            infeas_tol=o["tr_infeas_tol"], l1_tol=o["tr_l1_tol"],
            linf_tol=o["tr_linfty_tol"], eta=o["tr_eta"],
            tr_min=o["tr_min_size"], tr_max=o["tr_max_size"],
            init_size=o["tr_init_size"], bound_relax=o["tr_bound_relax"],
            function_precision=o["function_precision"],
            adaptive_gamma=o["tr_adaptive_gamma_update"],
            gamma_max=o["tr_penalty_gamma_max"],
            gamma_min=o["tr_penalty_gamma_min"],
            penalty_gamma=gamma,
            ninequality=problem.ninequality,
            nwinequality=problem.nwinequality)

        # initial quasi-Newton state (shared ladder with the host TR)
        qn0 = None
        msub = qnmod.resolve_subspace_size(
            o["qn_subspace_size"], o["qn_subspace_auto"], n, dt)
        if o["qn_type"] != "none" and msub > 0:
            from .ip import _resolve_qn_storage
            qn0 = qnmod.qn_init(
                msub, n, dtype=dt, qn_type=o["qn_type"],
                storage_dtype=_resolve_qn_storage(o["qn_storage_dtype"], dt),
                update_type=o["qn_update_type"],
                diag_type=o["qn_diag_type"])

        # initial linearization at x0 (compiled: run eagerly, a FEM model's
        # state solve compiles hundreds of small programs)
        f0, c0, cw0 = jax.jit(ev)((), x0)
        g0, A0 = jax.jit(gr)((), x0)
        zero = jnp.zeros((), dt)
        state0 = FusedTRState(
            xk=x0, fk=f0, ck=c0, gk=g0, Ak=A0, cwk=cw0, qn=qn0,
            tr_size=zero + to.init_size,
            gamma=jnp.full((ncon,), gamma, dt),
            k=jnp.zeros((), jnp.int32), subiters=jnp.zeros((), jnp.int32),
            converged=jnp.asarray(False), infeas=zero + jnp.inf,
            l1=zero + jnp.inf, linf=zero + jnp.inf, rho=zero)

        from functools import partial
        step = partial(_fused_tr_step, user_model, qp_model, inf_model,
                       qp_opts, inf_opts, to, lbv, ubv, d_tmpl, ())
        self._to = to
        self._ev = ev
        self._gr = gr
        self._problem = problem
        self._write_freq = o["tr_write_output_frequency"]
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

    def solve(self, state0: Optional[FusedTRState] = None,
              jit_loop: bool = True, chunk="auto", checkpoint_path=None):
        """Run the fused SL1QP outer loop; returns (result dict, state).
        ``chunk``/'auto' semantics as in FusedMMA (utils/chunked.py).

        The problem's ``write_output(it, x)`` hook fires every
        ``tr_write_output_frequency`` outer iterations at chunk boundaries
        (the host loop's cadence, `ParOptTrustRegion.cpp` sl1qpOptimize);
        ``checkpoint_path`` additionally writes an Orbax checkpoint of the
        FULL state at the same cadence — pass a previous checkpoint's
        restored state as ``state0`` to resume."""
        from .utils.chunked import (make_write_output_hook, run_chunked,
                                    user_write_output)
        hook = make_write_output_hook(user_write_output(self._problem),
                                      self._write_freq,
                                      checkpoint_path=checkpoint_path)
        state = state0 if state0 is not None else self._state0
        if jit_loop:
            state = run_chunked(self._run_jit, state,
                                self._to.max_iterations, chunk,
                                on_chunk=hook)
        else:
            for _ in range(self._to.max_iterations):
                state = self._step_jit(state)
                if hook is not None:
                    hook(state)
                if bool(state.converged):
                    break
        result = {"x": state.xk, "fobj": float(state.fk),
                  "converged": bool(state.converged), "niter": int(state.k),
                  "infeas": float(state.infeas), "l1": float(state.l1),
                  "linfty": float(state.linf),
                  "tr_size": float(state.tr_size),
                  "subiters": int(state.subiters)}
        return result, state

    def solve_batched(self, x0_batch, chunk="auto"):
        """k multi-start fused TR solves as ONE vmapped `lax.while_loop`
        (the `FusedMMA.solve_batched` pattern).  The per-instance initial
        linearization (f, c, g, A, cw at each x0) is built under the same
        vmap.  Returns (results, states) with leading-k-axis arrays."""
        x0_batch = jnp.asarray(x0_batch, self._state0.xk.dtype)

        def batch_state(x0):
            f0, c0, cw0 = self._ev((), x0)
            g0, A0 = self._gr((), x0)
            return dataclasses.replace(self._state0, xk=x0, fk=f0, ck=c0,
                                       gk=g0, Ak=A0, cwk=cw0)

        state = jax.jit(jax.vmap(batch_state))(x0_batch)
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
                                    self._to.max_iterations, chunk)
        results = {"x": state.xk, "fobj": np.asarray(state.fk),
                   "converged": np.asarray(state.converged),
                   "niter": np.asarray(state.k),
                   "infeas": np.asarray(state.infeas),
                   "l1": np.asarray(state.l1),
                   "linfty": np.asarray(state.linf)}
        return results, state
