"""Fused eigenvalue-constrained trust region: the ParOptEig path as ONE
on-device outer loop.

The reference pairs `ParOptEigenSubproblem` with a host callback that
refreshes a low-rank quadratic model of the eigenvalue constraint each
accepted step (`ParOptCompactEigenvalueApprox.cpp:118-183`,
`examples/eigenvalue/eigenvalue_opt.py:269-306`), and merges the
constraint curvature into the inner IP's Hessian via `getCompactMat`
(`ParOptCompactEigenvalueApprox.h:34-84`).  Here the ENTIRE loop — the
eigensolve (LOBPCG), the KS aggregate and its low-rank curvature model,
the merged-compact QP solve, trial evaluation, quasi-Newton update, and
radius/penalty logic — is one `lax.while_loop` XLA computation with zero
host round-trips, so the per-iteration host round trips of the host eigen
path disappear.

Model choice (measured with scripts/ab_eig_row.py):
``eig_row_model='quadratic'`` gives the inner IP the QUADRATIC model of the
eigen row — c + A·p + ½(hp)ᵀM(hp) with gradient A + hᵀM(hp) — exactly the
reference's `ParOptEigenSubproblem::evalObjCon`
(`ParOptCompactEigenvalueApprox.cpp:598-635`); the curvature also enters
the QP Hessian as −z0·hᵀMh through the merged compact (`getCompactMat`).
The DEFAULT is ``'linear'`` (curvature via the merged Hessian only): on an
analytic low-rank problem with the constraint active both reach the same
optimum but linear needs ~1.5x fewer outer and ~2.3x fewer inner
iterations, and on KS frequency aggregates with separated modes M ≈ 0
makes the two bit-identical.  The steering solve always follows
``tr_adaptive_constraint`` (default linearized, like the host
InfeasSubproblem) — a quadratic CONCAVE row inside the elastic steering
problem wedges its inner IP.

Requires a jax-native problem exposing

    eval_full(x) -> (f, c [ncon], g, A [ncon, n], M [N,N], Minv, h [N,n])

where constraint row `index` is the eigenvalue aggregate and (M, Minv, h)
its curvature model at x (`models/fem_frequency.py::eval_full`).  One
evaluation per trial point: the eigensolve that prices the trial ALSO
delivers the refreshed model, so rejected steps pay nothing extra.

If the problem opts in to warm starting (a ``supports_eig_warm_start``
attribute, or an ``eval_full`` parameter named ``V0``) and returns an 8th
element ``V`` (the eigenbasis), the loop WARM-STARTS every eigensolve
after the first from the previous trial's basis — the basis rides the TR
state, and LOBPCG's residual-based exit makes a converged warm basis cost
~1 block iteration (`fem_frequency._FrequencyBase.eval_full`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ip_fused import FusedIPOptions, ModelFns, ProblemData, _fused_init, \
    _fused_solve_loop
from .ops import qn as qnmod
from .tr import FusedTROptions, QPParams, _fused_ip_options, _viol, \
    make_qp_model
from .utils.options import make_options

__all__ = ["FusedEigenTR", "EigModel", "FusedEigTRState"]


class EigModel(NamedTuple):
    """Low-rank quadratic constraint-curvature model at xk:
    c(xk + p) ~= ck[index] + Ak[index]·p + 1/2 (h p)' M (h p).
    The linear terms are the state's REAL (ck, Ak) rows — eval_full
    returns them together, so no separate c0/g0 override exists (the
    reference's callback MAY override them; reintroduce fields here if a
    model ever needs that hook)."""
    M: Any             # [N, N] curvature (NSD for KS aggregates)
    Minv: Any          # [N, N] regularized inverse
    h: Any             # [N, n] eigenvector sensitivity stack


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedEigTRState:
    xk: jnp.ndarray
    fk: jnp.ndarray
    ck: jnp.ndarray            # REAL constraint values at xk
    gk: jnp.ndarray
    Ak: jnp.ndarray            # REAL constraint gradients at xk
    qn: Any
    eig: EigModel
    z0: jnp.ndarray            # eigen-constraint multiplier estimate
    tr_size: jnp.ndarray
    gamma: jnp.ndarray
    k: jnp.ndarray
    subiters: jnp.ndarray
    converged: jnp.ndarray
    infeas: jnp.ndarray
    l1: jnp.ndarray
    linf: jnp.ndarray
    rho: jnp.ndarray
    # eigenbasis carried for LOBPCG warm-starting (None when the problem's
    # eval_full doesn't support a V0 argument)
    V: Any = None


def _merged_compact(qn, eig: EigModel, z0, dt):
    """(b0, Z, M) with B = b0 I − Zᵀ M⁻¹ Z merging the objective QN with
    the z0-scaled constraint curvature (`getCompactMat`,
    `ParOptCompactEigenvalueApprox.cpp:246-318`, z0→0 convention)."""
    N = eig.h.shape[0]
    z0inv = jnp.where(z0 != 0.0, 1.0 / jnp.where(z0 != 0.0, z0, 1.0), 1.0)
    Me = z0inv * eig.Minv
    if qn is not None:
        b0, Zq, Mq = qnmod.qn_compact(qn)
        K = Zq.shape[0]
        Z = jnp.concatenate([Zq.astype(dt), eig.h], axis=0)
        M = jnp.zeros((K + N, K + N), dt)
        M = M.at[:K, :K].set(Mq).at[K:, K:].set(Me)
        return b0, Z, M
    return jnp.zeros((), dt), eig.h, Me


def _fused_eig_tr_step(eval_full, qp_model: ModelFns, inf_model: ModelFns,
                       qp_opts: FusedIPOptions, inf_opts: FusedIPOptions,
                       to: FusedTROptions, index: int, lbv, ubv,
                       d_tmpl: ProblemData,
                       state: FusedEigTRState) -> FusedEigTRState:
    """One fused eigen-TR outer iteration (`sl1qpOptimize` body with the
    `ParOptEigenSubproblem` model plumbing)."""
    xk, fk, ck, gk, Ak = state.xk, state.fk, state.ck, state.gk, state.Ak
    eig = state.eig
    dt = xk.dtype
    ncon = ck.shape[0]
    nineq = to.ninequality
    idx = jnp.arange(ncon)

    lk = jnp.maximum(-state.tr_size, lbv - xk)
    uk = jnp.minimum(state.tr_size, ubv - xk)
    p0 = 0.5 * (lk + uk)

    b0, Z, M = _merged_compact(state.qn, eig, state.z0, dt)
    compact = (b0, Z, M)
    params = QPParams(fk=fk, gk=gk, ck=ck, Ak=Ak,
                      cwk=jnp.zeros(0, dt), Aw_cols=None, Aw_vals=None,
                      b0=b0, Z=Z, M=M, obj_scale=jnp.asarray(1.0, dt),
                      eig_M=eig.M, eig_h=eig.h)

    def c_model(p):
        """Constraint model values: linear rows with the eigen row's
        quadratic curvature term added (the host EigenSubproblem's
        model_obj_con shape)."""
        hp = eig.h @ p
        return (ck + Ak @ p).at[index].add(0.5 * jnp.vdot(hp, eig.M @ hp))

    # steering infeasibility solve (`minimizeInfeas`)
    if to.adaptive_gamma:
        gamma_big = max(1e6, 1e2 * to.gamma_max)
        inf_params = params._replace(
            obj_scale=jnp.asarray(1.0 / gamma_big, dt))
        ones = jnp.ones(ncon, dt)
        d_inf = dataclasses.replace(
            d_tmpl, lb=lk, ub=uk,
            gamma_s=jnp.where(idx < nineq, 0.0, ones), gamma_t=ones)
        st_inf0 = _fused_init(inf_model, inf_opts, p0, d_inf, inf_params,
                              None, None)
        st_inf = _fused_solve_loop(inf_model, inf_opts, st_inf0, d_inf,
                                   inf_params, None)
        # SAME (quadratic-eigen-row) model on both sides of the adaptive
        # gamma test — mixing linear/quadratic rows biases 'grow'
        best_con_infeas = _viol(c_model(st_inf.vars.x), nineq)
        inf_iters = st_inf.k
    else:
        best_con_infeas = jnp.zeros(ncon, dt)
        inf_iters = jnp.zeros((), jnp.int32)

    # QP subproblem with the merged Hessian
    d_qp = dataclasses.replace(
        d_tmpl, lb=lk, ub=uk,
        gamma_s=jnp.where(idx < nineq, 0.0, state.gamma),
        gamma_t=state.gamma)
    st0 = _fused_init(qp_model, qp_opts, p0, d_qp, params, None, compact)
    st = _fused_solve_loop(qp_model, qp_opts, st0, d_qp, params, compact)
    p, z = st.vars.x, st.vars.z

    # model reductions; the eigen row's model value is QUADRATIC
    gam = state.gamma
    cm = c_model(p)
    fm = fk + jnp.vdot(gk, p) + 0.5 * jnp.vdot(
        p, b0 * p - Z.T @ jnp.linalg.solve(M, Z @ p))
    infeas_k = jnp.sum(gam * _viol(ck, nineq))
    obj_reduc = fk - fm
    infeas_model = jnp.sum(gam * _viol(cm, nineq))

    # trial evaluation: ONE eval_full prices the trial AND refreshes the
    # eigen model (the eigensolve is shared); state.V warm-starts the
    # LOBPCG when the problem supports it
    xt = xk + p
    ft, ct, gt, At, Mt, Minvt, ht, Vt = eval_full(xt, state.V)
    ft = jnp.asarray(ft, dt)
    ct = jnp.asarray(ct).reshape(ncon)
    # z (the QP multipliers) must be finite too: a failed inner QP can
    # return finite p with NaN z, which would poison the QN secant y and
    # the multiplier refresh while slipping past a p/f/c-only guard
    trial_finite = (jnp.isfinite(ft) & jnp.all(jnp.isfinite(ct))
                    & jnp.all(jnp.isfinite(gt)) & jnp.all(jnp.isfinite(p))
                    & jnp.all(jnp.isfinite(ht)) & jnp.all(jnp.isfinite(z)))

    qn_new = state.qn
    if state.qn is not None:
        # objective-Lagrangian secant pair with REAL gradients
        # (`ParOptEigenSubproblem::acceptTrialStep`)
        y = (gt - At.T @ z) - (gk - Ak.T @ z)
        qn_new, _, _ = qnmod.qn_update(state.qn, p, y,
                                       accept=trial_finite)

    infeas_t = jnp.sum(gam * _viol(ct, nineq))
    actual_reduc = (fk - ft) + (infeas_k - infeas_t)
    model_reduc = obj_reduc + (infeas_k - infeas_model)
    fprec = to.function_precision
    both_tiny = (jnp.abs(model_reduc) <= fprec) & \
        (jnp.abs(actual_reduc) <= fprec)
    rho = jnp.where(both_tiny | (model_reduc == 0.0), 1.0,
                    actual_reduc / jnp.where(model_reduc == 0.0, 1.0,
                                             model_reduc))
    # NaN rho (e.g. a NaN model reduction from a failed compact solve)
    # fails BOTH radius-update comparisons, deadlocking the radius at a
    # permanently-rejected step — force any non-finite rho to -inf so the
    # radius shrinks (same lesson as FusedTR's non-finite fail-stop)
    rho = jnp.where(trial_finite & ~jnp.isnan(rho), rho, -jnp.inf)

    accepted = ((rho >= to.eta)
                | ((state.tr_size <= to.tr_min) & trial_finite))
    sel = lambda a, b: jnp.where(accepted, a, b)  # noqa: E731
    xk_n, fk_n, ck_n = sel(xt, xk), sel(ft, fk), sel(ct, ck)
    gk_n, Ak_n = sel(gt, gk), sel(At, Ak)
    eig_n = EigModel(M=sel(Mt, eig.M), Minv=sel(Minvt, eig.Minv),
                     h=sel(ht, eig.h))
    # multiplier refresh on accept (`update_multipliers`,
    # `ParOptCompactEigenvalueApprox.cpp:183`)
    z0_n = sel(z[index], state.z0)
    tr_n = jnp.where(rho < 0.25,
                     jnp.maximum(0.25 * state.tr_size, to.tr_min),
                     jnp.where(rho > 0.75,
                               jnp.minimum(1.5 * state.tr_size, to.tr_max),
                               state.tr_size))

    gamma_n = state.gamma
    if to.adaptive_gamma:
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

    # KKT error with REAL gradients (`computeKKTError`)
    r = gk_n - Ak_n.T @ z
    relax = to.bound_relax
    r = jnp.where((xk_n <= lbv + relax) & (r > 0.0), 0.0, r)
    r = jnp.where((xk_n >= ubv - relax) & (r < 0.0), 0.0, r)
    l1_raw = jnp.sum(jnp.abs(r))
    linf_raw = jnp.max(jnp.abs(r))
    zmax = jnp.maximum(jnp.asarray(1.0, dt), jnp.max(jnp.abs(z)))
    l1 = l1_raw / jnp.maximum(jnp.sum(jnp.abs(gk_n)), zmax)
    linf = linf_raw / jnp.maximum(jnp.max(jnp.abs(gk_n)), zmax)
    infeas_new = jnp.sum(_viol(ct, nineq))
    converged = ((infeas_new < to.infeas_tol)
                 & ((l1 < to.l1_tol) | (linf < to.linf_tol)))

    # the trial basis is a valid warm start even on rejection (the trial
    # point is near xk) — carry it forward whenever it is finite
    V_n = None
    if state.V is not None:
        V_n = jnp.where(jnp.all(jnp.isfinite(Vt)), Vt, state.V)

    return FusedEigTRState(
        xk=xk_n, fk=fk_n, ck=ck_n, gk=gk_n, Ak=Ak_n, qn=qn_new,
        eig=eig_n, z0=z0_n, tr_size=tr_n, gamma=gamma_n, k=state.k + 1,
        subiters=state.subiters + st.k + inf_iters, converged=converged,
        infeas=infeas_new, l1=l1, linf=linf, rho=rho, V=V_n)


class FusedEigenTR:
    """Build-once fused eigenvalue-constrained SL1QP trust region.

    Contract: jax-native problem with ``eval_full`` (see module docstring),
    dense constraints only (``nwcon == 0``), the eigen constraint at row
    ``index``.  Options use the standard tr_*/IP registry names;
    ``qn_b0`` seeds the objective quasi-Newton diagonal (the frequency
    model passes 1/nvars — see `build_tr_subproblem`'s rationale)."""

    def __init__(self, problem, options: Optional[Dict[str, Any]] = None,
                 index: int = 0, qn_b0: float = 1.0,
                 eig_row_model: str = "linear"):
        if problem.nwcon:
            raise ValueError("FusedEigenTR supports dense constraints only")
        if eig_row_model not in ("quadratic", "linear"):
            raise ValueError(f"eig_row_model must be 'quadratic' or "
                             f"'linear', got {eig_row_model!r}")
        o = options if hasattr(options, "descriptors") else \
            make_options(options or {}, which="facade")
        from .dtypes import resolve_dtype
        dt = resolve_dtype(
            jnp.float64 if o["dtype"] == "float64" else jnp.float32)
        x0, lb, ub = problem.get_vars_and_bounds()
        x0 = jnp.asarray(x0, dt)
        lbv = jnp.asarray(lb, dt)
        ubv = jnp.asarray(ub, dt)
        n, ncon = problem.nvars, problem.ncon

        # warm-start capability is an EXPLICIT opt-in: either a
        # `supports_eig_warm_start = True` attribute, or an eval_full
        # parameter literally named 'V0' (the documented warm-start
        # keyword).  Raw arity would misroute any future problem whose
        # eval_full grows an unrelated second parameter / **kwargs into
        # the 8-value unpack below.
        import inspect
        warm = bool(getattr(problem, "supports_eig_warm_start", False))
        if not warm:
            try:
                params = inspect.signature(problem.eval_full).parameters
                warm = "V0" in params
            except (TypeError, ValueError):
                warm = False
        if warm:
            def eval_full(x, V=None):
                f, c, g, A, M, Minv, h, Vn = problem.eval_full(x, V)
                return (jnp.asarray(f, dt),
                        jnp.asarray(c, dt).reshape(ncon),
                        jnp.asarray(g, dt),
                        jnp.asarray(A, dt).reshape(ncon, n),
                        jnp.asarray(M, dt), jnp.asarray(Minv, dt),
                        jnp.asarray(h, dt), Vn)
        else:
            def eval_full(x, V=None):
                f, c, g, A, M, Minv, h = problem.eval_full(x)
                return (jnp.asarray(f, dt),
                        jnp.asarray(c, dt).reshape(ncon),
                        jnp.asarray(g, dt),
                        jnp.asarray(A, dt).reshape(ncon, n),
                        jnp.asarray(M, dt), jnp.asarray(Minv, dt),
                        jnp.asarray(h, dt), V)

        # eig_row_model='quadratic' (default) gives the inner IP the
        # QUADRATIC model of the eigen row, matching the reference's
        # `ParOptEigenSubproblem::evalObjCon`
        # (`ParOptCompactEigenvalueApprox.cpp:598-635`); 'linear' keeps
        # the round-3 linearized-row QP (curvature only via the merged
        # Hessian) for A/B comparison
        eig_idx = index if eig_row_model == "quadratic" else None
        qp_model = make_qp_model(False, "quadratic", eig_index=eig_idx)
        obj_mode = {"linear_objective": "linear",
                    "constant_objective": "linear",
                    "subproblem_objective": "quadratic"}[
                        o["tr_adaptive_objective"]]
        # the steering solve follows tr_adaptive_constraint (the host
        # InfeasSubproblem default LINEARIZES constraint rows even when
        # the subproblem model is quadratic)
        inf_eig_idx = (eig_idx if o["tr_adaptive_constraint"]
                       == "subproblem_constraint" else None)
        inf_model = make_qp_model(False, obj_mode, eig_index=inf_eig_idx)

        ones = jnp.ones(n, dt)
        d_tmpl = ProblemData(
            g=jnp.zeros(n, dt), A=jnp.zeros((ncon, n), dt),
            c=jnp.zeros(ncon, dt), cw=jnp.zeros(0, dt),
            lb=lbv, ub=ubv, lb_mask=ones, ub_mask=ones,
            gamma_s=jnp.zeros(ncon, dt), gamma_t=jnp.zeros(ncon, dt),
            gamma_sw=jnp.zeros(0, dt), gamma_tw=jnp.zeros(0, dt),
            Aw_cols=None, Aw_vals=None, nwblock=1, Aw_layout="gather")

        slm = (o["tr_adaptive_objective"] in ("linear_objective",
                                              "constant_objective")
               and o["tr_adaptive_constraint"] == "linear_constraint")
        qp_opts = _fused_ip_options(o, o["barrier_strategy"],
                                    o["starting_point_strategy"], False)
        inf_opts = _fused_ip_options(
            o, o["tr_steering_barrier_strategy"],
            o["tr_steering_starting_point_strategy"], slm)
        gamma = o["penalty_gamma"]
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
            ninequality=problem.ninequality, nwinequality=0)

        qn0 = None
        msub = qnmod.resolve_subspace_size(
            o["qn_subspace_size"], o["qn_subspace_auto"], n, dt)
        if o["qn_type"] != "none" and msub > 0:
            from .ip import _resolve_qn_storage
            qn0 = qnmod.qn_init(
                msub, n, dtype=dt, qn_type=o["qn_type"],
                b0=qn_b0,
                storage_dtype=_resolve_qn_storage(o["qn_storage_dtype"], dt),
                update_type=o["qn_update_type"],
                diag_type=o["qn_diag_type"])

        with jax.default_matmul_precision("highest"):
            # compiled: run eagerly, the eigensolve compiles dozens of
            # small programs
            f0, c0, g0, A0, M0, Minv0, h0, V0 = jax.jit(eval_full)(x0)
        zero = jnp.zeros((), dt)
        state0 = FusedEigTRState(
            xk=x0, fk=f0, ck=c0, gk=g0, Ak=A0, qn=qn0,
            eig=EigModel(M=M0, Minv=Minv0, h=h0),
            z0=zero, tr_size=zero + to.init_size,
            gamma=jnp.full((ncon,), gamma, dt),
            k=jnp.zeros((), jnp.int32), subiters=jnp.zeros((), jnp.int32),
            converged=jnp.asarray(False), infeas=zero + jnp.inf,
            l1=zero + jnp.inf, linf=zero + jnp.inf, rho=zero, V=V0)

        raw_step = partial(_fused_eig_tr_step, eval_full, qp_model,
                           inf_model, qp_opts, inf_opts, to, index, lbv,
                           ubv, d_tmpl)

        def step(st):
            # at default precision an accelerator may run f32 matmuls with
            # reduced-precision inputs (bf16 passes, TF32 on GPUs); the
            # merged compact's small-matrix algebra (M entries ~ ks_rho /
            # lam_target^2, up to ~1e10 on fine 3-D meshes) cannot survive
            # that — garbage M-solves turn B indefinite and NaN the inner
            # QP's quasi-definite Cholesky (observed with bf16-input
            # matmuls: 64x32x32 frequency problem frozen at mass=1.0,
            # rho=nan; CPU f32 is fine).  Trace the WHOLE outer step —
            # eval_full/LOBPCG, the inner QP, the model algebra — at full
            # f32 precision.
            with jax.default_matmul_precision("highest"):
                return raw_step(st)
        self._to = to
        self._index = index
        self._eval_full = eval_full
        self._problem = problem
        self._write_freq = o["tr_write_output_frequency"]
        self._state0 = state0
        self._step = step
        self._raw_step = raw_step     # introspectable partial (tests)
        self._step_jit = jax.jit(step)
        self._batched_run = None

        @jax.jit
        def run(s, k_stop):
            def cond(st):
                return (~st.converged) & (st.k < k_stop)
            return jax.lax.while_loop(cond, lambda st: step(st), s)

        self._run_jit = run

    def solve(self, state0: Optional[FusedEigTRState] = None,
              jit_loop: bool = True, chunk="auto", checkpoint_path=None):
        """Run the fused eigen-TR outer loop; returns (result dict, state).
        ``chunk``/'auto' semantics as in FusedTR (utils/chunked.py);
        ``write_output``/``checkpoint_path`` fire every
        ``tr_write_output_frequency`` iterations at chunk boundaries."""
        from .utils.chunked import (make_write_output_hook, run_chunked,
                                    user_write_output)
        hook = make_write_output_hook(
            user_write_output(self._problem), self._write_freq,
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
                  "converged": bool(state.converged),
                  "niter": int(state.k),
                  "infeas": float(state.infeas), "l1": float(state.l1),
                  "linfty": float(state.linf),
                  "tr_size": float(state.tr_size),
                  "subiters": int(state.subiters)}
        return result, state

    def solve_batched(self, x0_batch, chunk="auto"):
        """k multi-start fused eigen-TR solves as ONE vmapped
        `lax.while_loop` (the `FusedTR.solve_batched` pattern); the
        per-instance initial model refresh runs under the same vmap."""
        x0_batch = jnp.asarray(x0_batch, self._state0.xk.dtype)

        def batch_state(x0):
            with jax.default_matmul_precision("highest"):
                f0, c0, g0, A0, M0, Minv0, h0, V0 = self._eval_full(x0)
            return dataclasses.replace(
                self._state0, xk=x0, fk=f0, ck=c0, gk=g0, Ak=A0,
                eig=EigModel(M=M0, Minv=Minv0, h=h0), V=V0)

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
                                    self._to.max_iterations, chunk)
        results = {"x": state.xk, "fobj": np.asarray(state.fk),
                   "converged": np.asarray(state.converged),
                   "niter": np.asarray(state.k),
                   "infeas": np.asarray(state.infeas),
                   "l1": np.asarray(state.l1),
                   "linfty": np.asarray(state.linf)}
        return results, state
