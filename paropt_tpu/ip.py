"""Primal-dual interior-point optimizer.

JAX-native re-design of `ParOptInteriorPoint` (`src/ParOptInteriorPoint.{h,cpp}`,
~6.8k LoC): the same algorithm — elastic double-slack l1 formulation, monotone /
Mehrotra / predictor-corrector / complementarity-fraction barrier strategies,
least-squares and affine-step multiplier initialization, quasi-definite KKT
factorization with dense-multiplier Schur complement and SMW compact-QN
correction, fraction-to-boundary scaling, l1-merit Armijo line search with
function-precision relaxation, and the QN-reset/diagonal-step degradation
ladder — but structured accelerator-first:

- All state lives in fixed-shape pytrees (`IPVars`, `QNState`); every
  numerically heavy phase (residual+norms, KKT factor+solve, step scaling,
  merit pieces, variable update) is one `jit`-compiled function whose inputs
  are the state pytrees, so a major iteration is a handful of fused XLA
  computations with one all-reduce per reduction group when the design axis is
  sharded over a mesh.
- Branch-heavy safeguard logic (barrier updates, the ρ penalty update, line
  search accept/reject, the dm0>=0 recovery ladder) runs host-side on scalars,
  exactly where the reference used root-computed + broadcast values
  (`ParOptInteriorPoint.cpp:1963-1965` etc.); under SPMD/jit these scalars are
  replicated by construction so every host branches identically.
- User callbacks (`eval_obj_con`, gradients) are host calls and may be plain
  numpy physics codes; when the problem is differentiable JAX the gradients
  are autodiff-derived (see problem.py).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops import kkt
from .ops.kkt import IPVars, ProblemData
from .ops import qn as qnmod
from .ops.veclib import multi_norm
from .utils.logging import IPLogger
from .utils.options import OptionRegistry, make_options

__all__ = ["InteriorPoint"]


def _resolve_qn_storage(opt_value: str, compute_dtype):
    """Map the `qn_storage_dtype` option to a qn_init storage dtype."""
    if opt_value == "bfloat16":
        return jnp.bfloat16
    if opt_value == "auto":
        return qnmod.default_storage_dtype(compute_dtype)
    return None


# line search status flags (bitmask, mirroring the reference's enum)
LS_SUCCESS = 1
LS_FAILURE = 2
LS_MIN_STEP = 4
LS_MAX_ITERS = 8
LS_NO_IMPROVEMENT = 16
LS_SHORT_STEP = 32


# ---------------------------------------------------------------------------
# jitted computational kernels (pure functions of pytrees + scalars)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("norm_type",))
def _residual_and_norms(v: IPVars, d: ProblemData, mu, rel_bound_barrier,
                        norm_type: str):
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    prime = multi_norm([r.x, r.s, r.t], norm_type)
    dual = multi_norm([r.zl, r.zu, r.zs, r.zt, r.sw, r.tw, r.zsw, r.ztw],
                      norm_type)
    infeas = multi_norm([r.z, r.zw], norm_type)
    if norm_type == "infinity":
        res_norm = jnp.maximum(prime, jnp.maximum(dual, infeas))
    elif norm_type == "l1":
        res_norm = prime + dual + infeas
    else:
        res_norm = jnp.sqrt(prime ** 2 + dual ** 2 + infeas ** 2)
    comp = kkt.average_complementarity(v, d)
    # scalars ONLY: returning the residual tree would materialize three
    # n-length leaves per call that no caller consumes
    return prime, dual, infeas, res_norm, comp


@partial(jax.jit, static_argnames=("refine_steps", "use_qn"))
def _compute_step(v: IPVars, d: ProblemData, compact, mu, rel_bound_barrier,
                  qn_sigma, refine_steps: int, use_qn: bool):
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    cq = compact if use_qn else (compact[0], None, None)
    f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=qn_sigma)
    p = kkt.solve_kkt(v, d, f, r, refine_steps=refine_steps, qn_compact=cq)
    return p


@partial(jax.jit, static_argnames=("refine_steps", "use_qn"))
def _compute_step_mpc(v: IPVars, d: ProblemData, compact, mu,
                      rel_bound_barrier, qn_sigma, p_aff: IPVars,
                      refine_steps: int, use_qn: bool):
    """Mehrotra predictor-corrector step: the complementarity residuals get
    the second-order Δ·Δ terms from the affine predictor
    (`ParOptInteriorPoint.cpp:4999-5051`)."""
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    r = dataclasses.replace(
        r,
        zs=r.zs + p_aff.s * p_aff.zs,
        zt=r.zt + p_aff.t * p_aff.zt,
        zsw=r.zsw + p_aff.sw * p_aff.zsw,
        ztw=r.ztw + p_aff.tw * p_aff.ztw,
        zl=jnp.where(d.lb_mask > 0, r.zl + p_aff.x * p_aff.zl, 0.0),
        zu=jnp.where(d.ub_mask > 0, r.zu - p_aff.x * p_aff.zu, 0.0))
    cq = compact if use_qn else (compact[0], None, None)
    f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=qn_sigma)
    p = kkt.solve_kkt(v, d, f, r, refine_steps=refine_steps, qn_compact=cq)
    return p


def _compute_step_eager(v, d, compact, mu, rel_bound_barrier, qn_sigma,
                        refine_steps, use_qn, csr_mat):
    """Un-jitted step computation for the general-CSR path (the native
    factor object cannot live under jit; the reference's general-sparse path
    is likewise serial per-process)."""
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    cq = compact if use_qn else (compact[0], None, None)
    f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=qn_sigma,
                             csr_mat=csr_mat)
    return kkt.solve_kkt(v, d, f, r, refine_steps=refine_steps, qn_compact=cq)


@partial(jax.jit, static_argnames=("use_qn",))
def _check_kkt_step(v: IPVars, d: ProblemData, p: IPVars, compact, mu,
                    rel_bound_barrier, qn_sigma, use_qn: bool):
    """Max per-equation error of K·p + r (`checkKKTStep`,
    `ParOptInteriorPoint.cpp:6212+`)."""
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    cq = compact if use_qn else (compact[0], None, None)
    Kp = kkt.apply_kkt_matrix(v, d, p, qn_compact=cq, qn_sigma=qn_sigma)
    err = jax.tree_util.tree_map(lambda a, b: a + b, Kp, r)
    leaves = [jnp.max(jnp.abs(l)) for l in jax.tree_util.tree_leaves(err)
              if l.size]
    return jnp.max(jnp.stack(leaves)) if leaves else jnp.zeros(())


@jax.jit
def _scale_step(v: IPVars, d: ProblemData, p: IPVars, mu, comp, inexact,
                tau_min=0.95):
    """Fraction-to-boundary scaling with the equal-step safeguard
    (`scaleKKTStep`, `ParOptInteriorPoint.cpp:3196-3278`)."""
    tau = jnp.maximum(tau_min, 1.0 - mu)
    ax, az = kkt.max_step_lengths(v, d, p, tau)
    # bound the ratio between the two step lengths by 100 (clamp the larger)
    mb = 100.0
    ax = jnp.where(ax > az, jnp.clip(ax, az / mb, az * mb), ax)
    az = jnp.where(az > ax, jnp.clip(az, ax / mb, ax * mb), az)
    # if complementarity grows 10x at the scaled step, equalize
    vn = v.axpy(ax, az, p)
    comp_new = kkt.average_complementarity(vn, d)
    amin = jnp.minimum(ax, az)
    ceq = (comp_new > 10.0 * comp) | inexact
    ax = jnp.where(ceq, amin, ax)
    az = jnp.where(ceq, amin, az)
    ps = IPVars(x=ax * p.x, zl=az * p.zl, zu=az * p.zu, s=ax * p.s,
                t=ax * p.t, z=az * p.z, zs=az * p.zs, zt=az * p.zt,
                sw=ax * p.sw, tw=ax * p.tw, zw=az * p.zw, zsw=az * p.zsw,
                ztw=az * p.ztw)
    return ps, ax, az, (ceq & ~inexact)


def _barrier_terms(x, s, t, sw, tw, d: ProblemData, rel_bound_barrier):
    """Sum of log-barrier terms (the φ part of the merit function,
    `evalMeritFunc`, `ParOptInteriorPoint.cpp:3524-3650`)."""
    total = rel_bound_barrier * (
        jnp.sum(jnp.where(d.lb_mask > 0, jnp.log(jnp.maximum(x - d.lb, 1e-300)),
                          0.0))
        + jnp.sum(jnp.where(d.ub_mask > 0,
                            jnp.log(jnp.maximum(d.ub - x, 1e-300)), 0.0)))
    for arr in (s, t, sw, tw):
        if arr.size:
            total = total + jnp.sum(jnp.log(jnp.maximum(arr, 1e-300)))
    return total


def _infeas_l2(c, s, t, cw, sw, tw):
    dense = jnp.sum((c - s + t) ** 2) if c.size else 0.0
    sparse = jnp.sum((cw - sw + tw) ** 2) if cw.size else 0.0
    return jnp.sqrt(dense + sparse)


@partial(jax.jit, static_argnames=("use_qn",))
def _merit_parts(v: IPVars, d: ProblemData, p: IPVars, fobj, mu,
                 rel_bound_barrier, compact, use_qn: bool):
    """Merit value/derivative pieces sans the ρ·infeasibility term
    (`evalMeritInitDeriv`, `ParOptInteriorPoint.cpp:3652-3938`).
    Returns (merit0, pmerit0, infeas, infeas_proj, pTBp)."""
    merit0 = (fobj
              + jnp.sum(d.gamma_s * v.s) + jnp.sum(d.gamma_t * v.t)
              + jnp.sum(d.gamma_sw * v.sw) + jnp.sum(d.gamma_tw * v.tw)
              - mu * _barrier_terms(v.x, v.s, v.t, v.sw, v.tw, d,
                                    rel_bound_barrier))
    pbarrier = rel_bound_barrier * (
        jnp.sum(jnp.where(d.lb_mask > 0, p.x / (v.x - d.lb), 0.0))
        - jnp.sum(jnp.where(d.ub_mask > 0, p.x / (d.ub - v.x), 0.0)))
    for val, st in ((v.s, p.s), (v.t, p.t), (v.sw, p.sw), (v.tw, p.tw)):
        if val.size:
            pbarrier = pbarrier + jnp.sum(st / val)
    pmerit0 = (jnp.vdot(d.g, p.x)
               + jnp.sum(d.gamma_s * p.s) + jnp.sum(d.gamma_t * p.t)
               + jnp.sum(d.gamma_sw * p.sw) + jnp.sum(d.gamma_tw * p.tw)
               - mu * pbarrier)
    infeas = _infeas_l2(d.c, v.s, v.t, d.cw, v.sw, v.tw)
    # directional derivative of the l2 infeasibility
    pdense = (jnp.sum((d.c - v.s + v.t) * (d.A @ p.x - p.s + p.t))
              if d.ncon else 0.0)
    psparse = (jnp.sum((d.cw - v.sw + v.tw)
                       * (d.Aw_matvec(p.x) - p.sw + p.tw)) if d.nwcon else 0.0)
    infeas_proj = jnp.where(infeas > 0.0, (pdense + psparse)
                            / jnp.maximum(infeas, 1e-300), 0.0)
    if use_qn:
        b0, Z, M = compact
        Bpx = b0 * p.x
        if Z is not None and Z.shape[0] > 0:
            Bpx = Bpx - Z.T @ jnp.linalg.solve(M, Z @ p.x)
        pTBp = jnp.vdot(p.x, Bpx)
    else:
        pTBp = jnp.zeros_like(fobj)
    return merit0, pmerit0, infeas, infeas_proj, pTBp


@partial(jax.jit, static_argnames=("refine_steps", "use_qn", "norm_type"))
def _step_scale_merit(v: IPVars, d: ProblemData, compact, fobj, mu, comp,
                      rel_bound_barrier, qn_sigma, tau_min,
                      refine_steps: int, use_qn: bool, norm_type: str):
    """Fused iteration head: KKT step + fraction-to-boundary scaling +
    merit parts as ONE XLA computation.

    The host loop's per-phase jit boundaries each materialize full IPVars
    trees (3 n-length leaves); measured at n=1M f64 the split phases cost
    ~9x the fused-IP per-iteration time at identical numerical work
    (scripts/bench_callback_overhead.py).  Fusing the three phases keeps
    every intermediate (residual tree, unscaled step) inside one program,
    the analogue of the reference running its whole iteration in-process
    (no materialization boundaries at all)."""
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    cq = compact if use_qn else (compact[0], None, None)
    f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=qn_sigma)
    p = kkt.solve_kkt(v, d, f, r, refine_steps=refine_steps, qn_compact=cq)
    ps, ax, az, ceq = _scale_step.__wrapped__(
        v, d, p, mu, comp, jnp.asarray(False), tau_min)
    mp = _merit_parts.__wrapped__(v, d, ps, fobj, mu, rel_bound_barrier,
                                  compact, use_qn=use_qn)
    px_norm = multi_norm([p.x], norm_type)   # unscaled (abs_step_tol test)
    return ps, ax, az, ceq, mp, px_norm


@jax.jit
def _nk_projections(v: IPVars, d: ProblemData, b: IPVars, p: IPVars, mu,
                    rel_bound_barrier):
    """GMRES descent-gate/trace projections: fproj = the barrier-objective
    directional derivative along p (`evalObjBarrierDeriv`,
    `ParOptInteriorPoint.cpp:5669-5773`) and cproj = aproj + awproj, the
    constraint-residual projections NORMALIZED by the reference's
    cscale = 1/||c-s+t|| and cwscale = 1/||cw-sw+tw|| (`:5866-5888`,
    `:5954-5969`) — so cproj is the directional derivative of the
    infeasibility NORMS and the -0.01*(cinfeas+cwinfeas) descent
    threshold means the same thing at every feasibility level.
    ``b`` is the GMRES right-hand side (b.z = -(c - s + t))."""
    pbarrier = rel_bound_barrier * (
        jnp.sum(jnp.where(d.lb_mask > 0, p.x / (v.x - d.lb), 0.0))
        - jnp.sum(jnp.where(d.ub_mask > 0, p.x / (d.ub - v.x), 0.0)))
    for val, st in ((v.s, p.s), (v.t, p.t), (v.sw, p.sw), (v.tw, p.tw)):
        if val.size:
            pbarrier = pbarrier + jnp.sum(st / val)
    fproj = (jnp.vdot(d.g, p.x)
             + jnp.sum(d.gamma_s * p.s) + jnp.sum(d.gamma_t * p.t)
             + jnp.sum(d.gamma_sw * p.sw) + jnp.sum(d.gamma_tw * p.tw)
             - mu * pbarrier)
    cproj = jnp.zeros_like(fproj)
    if d.ncon:
        cinfeas = jnp.linalg.norm(d.c - v.s + v.t)
        cscale = jnp.where(cinfeas != 0.0,
                           1.0 / jnp.where(cinfeas != 0.0, cinfeas, 1.0),
                           0.0)
        cproj = cproj - cscale * jnp.sum(b.z * (d.A @ p.x - p.s + p.t))
    if d.nwcon:
        cwinfeas = jnp.linalg.norm(d.cw - v.sw + v.tw)
        cwscale = jnp.where(
            cwinfeas != 0.0,
            1.0 / jnp.where(cwinfeas != 0.0, cwinfeas, 1.0), 0.0)
        cproj = cproj - cwscale * jnp.sum(
            b.zw * (d.Aw_matvec(p.x) - p.sw + p.tw))
    return fproj, cproj


@jax.jit
def _merit_eval(x, s, t, sw, tw, fobj, c, cw, d: ProblemData, mu,
                rel_bound_barrier, rho):
    """Merit at a trial point (`evalMeritFunc`)."""
    merit = (fobj
             + jnp.sum(d.gamma_s * s) + jnp.sum(d.gamma_t * t)
             + jnp.sum(d.gamma_sw * sw) + jnp.sum(d.gamma_tw * tw)
             - mu * _barrier_terms(x, s, t, sw, tw, d, rel_bound_barrier)
             + rho * _infeas_l2(c, s, t, cw, sw, tw))
    return merit


@jax.jit
def _apply_step(v: IPVars, d: ProblemData, p: IPVars, alpha, design_precision):
    """vars + α·p with strict-interior clipping (`computeStepVec`,
    `ParOptInteriorPoint.cpp:3122-3194`): x clipped to
    [lb+dp, ub-dp] where bounded; slack/positivity variables clipped at dp."""
    vn = v.axpy(alpha, alpha, p)
    x = vn.x
    # pad by at least a few ulps of the bound: design_precision (1e-14) is
    # below f32 resolution, where lb + 1e-14 == lb would let a rounded
    # step land exactly ON the bound (zl/(x-lb) -> division by zero)
    eps4 = 4.0 * jnp.finfo(x.dtype).eps
    lo_pad = jnp.maximum(design_precision, eps4 * (1.0 + jnp.abs(d.lb)))
    hi_pad = jnp.maximum(design_precision, eps4 * (1.0 + jnp.abs(d.ub)))
    x = jnp.where((d.lb_mask > 0) & (x <= d.lb + lo_pad),
                  d.lb + lo_pad, x)
    x = jnp.where((d.ub_mask > 0) & (x + hi_pad >= d.ub),
                  d.ub - hi_pad, x)

    def clip0(a):
        return jnp.maximum(a, design_precision)

    return IPVars(x=x, zl=jnp.where(d.lb_mask > 0, clip0(vn.zl), 0.0),
                  zu=jnp.where(d.ub_mask > 0, clip0(vn.zu), 0.0),
                  s=clip0(vn.s), t=clip0(vn.t), z=vn.z, zs=clip0(vn.zs),
                  zt=clip0(vn.zt), sw=clip0(vn.sw), tw=clip0(vn.tw),
                  zw=vn.zw, zsw=clip0(vn.zsw), ztw=clip0(vn.ztw))


@jax.jit
def _trial_point(v: IPVars, d: ProblemData, p: IPVars, alpha,
                 design_precision):
    """(x, s, t, sw, tw) at v + α·p with the same clipping as _apply_step."""
    x = v.x + alpha * p.x
    eps4 = 4.0 * jnp.finfo(x.dtype).eps
    lo_pad = jnp.maximum(design_precision, eps4 * (1.0 + jnp.abs(d.lb)))
    hi_pad = jnp.maximum(design_precision, eps4 * (1.0 + jnp.abs(d.ub)))
    x = jnp.where((d.lb_mask > 0) & (x <= d.lb + lo_pad),
                  d.lb + lo_pad, x)
    x = jnp.where((d.ub_mask > 0) & (x + hi_pad >= d.ub),
                  d.ub - hi_pad, x)
    clip = lambda a: jnp.maximum(a, design_precision)
    return (x, clip(v.s + alpha * p.s), clip(v.t + alpha * p.t),
            clip(v.sw + alpha * p.sw), clip(v.tw + alpha * p.tw))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class InteriorPoint:
    """Interior-point method, usable standalone or as the subproblem solver
    for the trust-region and MMA outer loops.

    Parameters
    ----------
    problem : paropt_tpu.Problem
    options : dict or OptionRegistry, reference option names
      (`ParOptInteriorPoint.cpp:536-727`).
    """

    def __init__(self, problem, options: Optional[Any] = None):
        self.problem = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="ip")
        o = self.options
        from .dtypes import resolve_dtype
        self.dtype = resolve_dtype(
            jnp.float64 if o["dtype"] == "float64" else jnp.float32)
        # The reference default abs_res_tol=1e-6 holds at f32 too: measured
        # residual floors are ~3e-7 at 1M vars (scripts/precision_study.py),
        # and the no-improvement exit
        # (line_search_test) handles problems where the f32 floor bites
        # before the tolerance — no silent relaxation.

        # counters (`getIterationCounters`, ParOptInteriorPoint.h:203-217)
        self.niter = 0
        self.neval = 0
        self.ngeval = 0
        self.nhvec = 0

        # penalties (ParOptInteriorPoint.cpp:343-374): inequality
        # constraints get gamma_s = 0; equalities get both
        gamma = o["penalty_gamma"]
        ncon, nwcon = problem.ncon, problem.nwcon
        nineq, nwineq = problem.ninequality, problem.nwinequality
        idx = np.arange(ncon)
        self.gamma_s = jnp.asarray(np.where(idx < nineq, 0.0, gamma),
                                   self.dtype)
        self.gamma_t = jnp.full((ncon,), gamma, self.dtype)
        idxw = np.arange(nwcon)
        self.gamma_sw = jnp.asarray(np.where(idxw < nwineq, 0.0, gamma),
                                    self.dtype)
        self.gamma_tw = jnp.full((nwcon,), gamma, self.dtype)

        self.mu = o["init_barrier_param"]
        self.rho_penalty = o["init_rho_penalty_search"]

        # quasi-Newton state, held in a shared mutable holder so an outer
        # loop (trust region) and this optimizer see the same approximation
        # (the reference shares one ParOptCompactQuasiNewton object)
        self._qn_holder: Dict[str, Optional[qnmod.QNState]] = {"state": None}
        self._make_qn()

        # bounds + design variables
        self._init_design_and_bounds()

        self._eval_exc_warned = False

        # current evaluation cache
        self.fobj = None
        self.c = None
        self.g = None
        self.A = None
        self.cw = None

        self.vars: Optional[IPVars] = None
        self._init_vars()

        # general-CSR constraint path: host-side native quasi-definite
        # factor (ParOptQuasiDefSparseMat role); forces eager KKT solves
        self._csr_mat = None
        if getattr(problem, "use_csr_path", False):
            self._csr_mat = problem.create_quasi_def_mat()
        # block-callback sparse operators (the reference's
        # addSparseJacobian-style user callbacks): no structured Jacobian is
        # available, so ALL kernels run eagerly with callback products
        self._callback_sparse = False
        if problem.nwcon > 0 and self._csr_mat is None:
            try:
                problem.sparse_jacobian(self.x0)
            except NotImplementedError:
                # only the "not provided" signal demotes to the (much
                # slower) callback path; real bugs in a user's structured
                # Jacobian must propagate, not silently degrade
                self._callback_sparse = True
        self._eager = self._csr_mat is not None or self._callback_sparse

        self._logger = None
        self._converged_reason = ""

    def _fn(self, jitted):
        """Return the jitted callable, or its eager python version when the
        problem requires host callbacks inside the kernels."""
        return jitted.__wrapped__ if self._eager else jitted

    # -- setup ---------------------------------------------------------------

    @property
    def qn(self) -> Optional[qnmod.QNState]:
        return self._qn_holder["state"]

    @qn.setter
    def qn(self, state):
        self._qn_holder["state"] = state

    def _make_qn(self):
        o = self.options
        qt = o["qn_type"]
        if qt == "none" or o["sequential_linear_method"]:
            self.qn = None
            return
        msub = qnmod.resolve_subspace_size(
            o["qn_subspace_size"], o["qn_subspace_auto"],
            self.problem.nvars, self.dtype)
        if msub <= 0:
            self.qn = None
            return
        storage = _resolve_qn_storage(o["qn_storage_dtype"], self.dtype)
        self.qn = qnmod.qn_init(
            msub, self.problem.nvars, dtype=self.dtype,
            qn_type=qt, storage_dtype=storage,
            update_type=o["qn_update_type"], diag_type=o["qn_diag_type"])

    def set_quasi_newton_holder(self, holder: Dict[str, Any]):
        """Share a mutable {'state': QNState} holder with an outer loop (the
        analogue of `ParOptInteriorPoint::setQuasiNewton` — the reference
        shares the QN object between TR and IP)."""
        self._qn_holder = holder

    def set_penalty_gamma(self, gamma, gamma_sparse=None):
        """Set the l1 elastic penalties, scalar or per-constraint
        (`ParOptInteriorPoint::setPenaltyGamma`).  Inequality constraints
        keep gamma_s = 0."""
        ncon, nwcon = self.problem.ncon, self.problem.nwcon
        g = jnp.broadcast_to(jnp.asarray(gamma, self.dtype), (ncon,))
        idx = np.arange(ncon)
        self.gamma_s = jnp.where(idx < self.problem.ninequality, 0.0, g)
        self.gamma_t = g
        if gamma_sparse is None:
            gamma_sparse = gamma if np.ndim(gamma) == 0 else None
        if gamma_sparse is not None and nwcon > 0:
            gw = jnp.broadcast_to(jnp.asarray(gamma_sparse, self.dtype),
                                  (nwcon,))
            idxw = np.arange(nwcon)
            self.gamma_sw = jnp.where(idxw < self.problem.nwinequality,
                                      0.0, gw)
            self.gamma_tw = gw

    def _init_design_and_bounds(self):
        """`initAndCheckDesignAndBounds` (`ParOptInteriorPoint.cpp:4277+`)."""
        o = self.options
        x, lb, ub = self.problem.get_vars_and_bounds()
        x = jnp.asarray(x, self.dtype)
        lb = jnp.asarray(lb, self.dtype)
        ub = jnp.asarray(ub, self.dtype)
        mbv = o["max_bound_value"]
        self.lb_mask = (lb > -mbv).astype(self.dtype)
        self.ub_mask = (ub < mbv).astype(self.dtype)
        # clip strictly inside the bounds (dtype-aware pad, see _apply_step)
        eps4 = 4.0 * jnp.finfo(self.dtype).eps
        lo_pad = jnp.maximum(o["design_precision"],
                             eps4 * (1.0 + jnp.abs(lb)))
        hi_pad = jnp.maximum(o["design_precision"],
                             eps4 * (1.0 + jnp.abs(ub)))
        x = jnp.where((self.lb_mask > 0) & (x < lb + lo_pad), lb + lo_pad, x)
        x = jnp.where((self.ub_mask > 0) & (x > ub - hi_pad), ub - hi_pad, x)
        self.x0, self.lb, self.ub = x, lb, ub

    def reset_design_and_bounds(self):
        """Re-query the problem for x/bounds (TR calls this between
        subproblem solves, `resetDesignAndBounds`)."""
        self._init_design_and_bounds()
        if self.vars is not None:
            self.vars = dataclasses.replace(self.vars, x=self.x0)

    def _init_vars(self):
        n = self.problem.nvars
        ncon, nwcon = self.problem.ncon, self.problem.nwcon
        one_c = jnp.ones(ncon, self.dtype)
        one_w = jnp.ones(nwcon, self.dtype)
        self.vars = IPVars(
            x=self.x0,
            zl=jnp.where(self.lb_mask > 0, 1.0, 0.0).astype(self.dtype),
            zu=jnp.where(self.ub_mask > 0, 1.0, 0.0).astype(self.dtype),
            s=one_c, t=one_c, z=jnp.zeros(ncon, self.dtype),
            zs=one_c, zt=one_c,
            sw=one_w, tw=one_w, zw=jnp.zeros(nwcon, self.dtype),
            zsw=one_w, ztw=one_w)

    # -- user evaluation wrappers -------------------------------------------

    def _eval_obj_con(self, x) -> Tuple[Any, Any, Any]:
        """-> (fobj, c, cw) or (None,)*3 on failure.

        Any exception raised by the user callbacks — not just
        FloatingPointError — maps to the fail path, mirroring the
        reference's treatment of any nonzero fail flag
        (`ParOptInteriorPoint.cpp:4019-4026`): a failed evaluation during
        the line search shrinks the step and retries instead of
        propagating a raw traceback mid-solve."""
        # ONLY the user callback invocations sit inside the try: a
        # wrong-shaped return must still surface as a programming error
        # (the reshape below), not loop forever as a "failed evaluation"
        try:
            fobj, c = self.problem.eval_obj_con(x)
            if self.problem.nwcon > 0:
                cw_raw = self.problem.eval_sparse_con(x)
            else:
                cw_raw = None
        except Exception as exc:  # user-callback failure -> fail flag
            if not self._eval_exc_warned:
                self._eval_exc_warned = True
                warnings.warn(
                    "objective/constraint evaluation raised "
                    f"{type(exc).__name__}: {exc}; treating as a failed "
                    "evaluation (fail flag)", RuntimeWarning)
            return None, None, None
        self.neval += 1
        fobj = jnp.asarray(fobj, self.dtype)
        c = jnp.asarray(c, self.dtype).reshape(self.problem.ncon)
        cw = (jnp.asarray(cw_raw, self.dtype).reshape(self.problem.nwcon)
              if cw_raw is not None else jnp.zeros(0, self.dtype))
        if not (bool(jnp.isfinite(fobj)) and bool(jnp.all(jnp.isfinite(c)))
                and bool(jnp.all(jnp.isfinite(cw)))):
            return None, None, None
        return fobj, c, cw

    def _eval_gradients(self, x):
        try:
            g, A = self.problem.eval_obj_con_gradient(x)
        except Exception as exc:
            # gradient failure is fatal in the reference too
            # ("Gradient evaluation failed", ParOptInteriorPoint.cpp:4230),
            # but surface it as a clear solver error, not a raw traceback
            raise RuntimeError(
                f"gradient evaluation failed: {type(exc).__name__}: {exc}"
            ) from exc
        self.ngeval += 1
        g = jnp.asarray(g, self.dtype)
        A = jnp.asarray(A, self.dtype).reshape(self.problem.ncon,
                                               self.problem.nvars)
        return g, A

    def _make_data(self) -> ProblemData:
        prob = self.problem
        if prob.nwcon > 0 and self._callback_sparse:
            x_cur = self.vars.x

            def cb_mat(px):
                if px.ndim == 1:
                    return jnp.asarray(prob.sparse_jacobian_vec(x_cur, px),
                                       self.dtype)
                return jnp.stack([jnp.asarray(
                    prob.sparse_jacobian_vec(x_cur, row), self.dtype)
                    for row in px])

            def cb_rmat(pzw):
                if pzw.ndim == 1:
                    return jnp.asarray(prob.sparse_jacobian_tvec(x_cur, pzw),
                                       self.dtype)
                return jnp.stack([jnp.asarray(
                    prob.sparse_jacobian_tvec(x_cur, row), self.dtype)
                    for row in pzw])

            def cb_inner(dv):
                return jnp.asarray(prob.sparse_inner_product(x_cur, dv),
                                   self.dtype)

            return ProblemData(
                g=self.g, A=self.A, c=self.c, cw=self.cw, lb=self.lb,
                ub=self.ub, lb_mask=self.lb_mask, ub_mask=self.ub_mask,
                gamma_s=self.gamma_s, gamma_t=self.gamma_t,
                gamma_sw=self.gamma_sw, gamma_tw=self.gamma_tw,
                Aw_cols=None, Aw_vals=None, nwblock=prob.nwblock,
                Aw_callbacks=(cb_mat, cb_rmat, cb_inner))
        if prob.nwcon > 0:
            Aw = prob.sparse_jacobian(self.vars.x)
            Aw_cols, Aw_vals = Aw.cols, jnp.asarray(Aw.vals, self.dtype)
            nwblock = prob.nwblock
            layout = kkt.detect_aw_layout(Aw_cols, prob.nvars)
        else:
            Aw_cols = Aw_vals = None
            nwblock = 1
            layout = "gather"
        if self._csr_mat is not None and prob.nwcon > 0:
            self._csr_mat.set_values(prob._data)
        return ProblemData(
            g=self.g, A=self.A, c=self.c, cw=self.cw, lb=self.lb, ub=self.ub,
            lb_mask=self.lb_mask, ub_mask=self.ub_mask,
            gamma_s=self.gamma_s, gamma_t=self.gamma_t,
            gamma_sw=self.gamma_sw, gamma_tw=self.gamma_tw,
            Aw_cols=Aw_cols, Aw_vals=Aw_vals, nwblock=nwblock,
            Aw_layout=layout)

    # -- multiplier initialization ------------------------------------------

    def _init_least_squares_multipliers(self, d: ProblemData):
        """`initLeastSquaresMultipliers` (`ParOptInteriorPoint.cpp:
        5336-5534`): set everything to μ0, then solve the regularized
        least-squares system for (z, zw) and clamp outliers to zero."""
        o = self.options
        mu0 = o["init_barrier_param"]
        v = self.vars
        dt = self.dtype
        ncon, nwcon = d.ncon, d.nwcon
        v = IPVars(
            x=v.x,
            zl=jnp.where(d.lb_mask > 0, mu0, 0.0).astype(dt),
            zu=jnp.where(d.ub_mask > 0, mu0, 0.0).astype(dt),
            s=jnp.full((ncon,), mu0, dt), t=jnp.full((ncon,), mu0, dt),
            z=jnp.full((ncon,), mu0, dt), zs=jnp.full((ncon,), mu0, dt),
            zt=jnp.full((ncon,), mu0, dt),
            sw=jnp.full((nwcon,), mu0, dt), tw=jnp.full((nwcon,), mu0, dt),
            zw=jnp.full((nwcon,), mu0, dt), zsw=jnp.full((nwcon,), mu0, dt),
            ztw=jnp.full((nwcon,), mu0, dt))

        small = 1e-4
        rhs = -(d.g - v.zl + v.zu)
        if self._csr_mat is not None:
            self._csr_mat.set_values(self.problem._data)
            self._csr_mat.factor(jnp.ones_like(v.x),
                                 jnp.full((nwcon,), small))
        # quasi-definite system with D = I, C = small
        f0 = kkt.KKTFactor(
            Dinv=jnp.ones_like(v.x), Gamma=None, C0=None,
            Cw_chol=(jnp.sqrt(small + d.Aw_inner_blocks(jnp.ones_like(v.x)))
                     if nwcon > 0 and d.nwblock == 1 else
                     (jnp.linalg.cholesky(
                         d.Aw_inner_blocks(jnp.ones_like(v.x))
                         + small * jnp.eye(d.nwblock, dtype=dt))
                      if nwcon > 0 else None)),
            Xa=None, Wa=None, G_lu=None, Zqn=None, Phi_x=None, Phi_z=None,
            Phi_w=None, Ce_inv=None, csr_solver=self._csr_mat)
        if ncon > 0:
            Xa, _ = kkt.quasi_def_solve(f0, d, d.A,
                                        jnp.zeros((ncon, nwcon), dt))
            G = d.A @ Xa.T + small * jnp.eye(ncon, dtype=dt)
            yx0, _ = kkt.quasi_def_solve(f0, d, rhs, jnp.zeros(nwcon, dt))
            z = jnp.linalg.solve(G, -(d.A @ yx0))
            gmax = 10.0 * jnp.maximum(d.gamma_s, d.gamma_t)
            z = jnp.where((z < -gmax) | (z > gmax), 0.0, z)
        else:
            z = jnp.zeros(0, dt)
        if nwcon > 0:
            rx = rhs + (d.A.T @ z if ncon else 0.0)
            _, zw_neg = kkt.quasi_def_solve(f0, d, rx, jnp.zeros(nwcon, dt))
            zw = -zw_neg
            gwmax = 10.0 * jnp.maximum(d.gamma_sw, d.gamma_tw)
            zw = jnp.where((zw < -gwmax) | (zw > gwmax), 0.0, zw)
        else:
            zw = jnp.zeros(0, dt)
        self.vars = dataclasses.replace(v, z=z, zw=zw)

    def _init_affine_step_multipliers(self, d: ProblemData):
        """`initAffineStepMultipliers` (`ParOptInteriorPoint.cpp:5536-5667`):
        least-squares estimate, then one μ=0 KKT step; slacks/multipliers set
        to |v + p| floored at start_affine_multiplier_min; μ0 from the
        resulting complementarity."""
        o = self.options
        self._init_least_squares_multipliers(d)
        v = self.vars
        compact = self._qn_compact()
        use_qn = (self.qn is not None and bool(o["use_qn_gmres_precon"])
                  and not o["sequential_linear_method"]
                  and not o["use_diag_hessian"])
        if self._eager:
            p = _compute_step_eager(v, d, compact,
                                    jnp.asarray(0.0, self.dtype),
                                    o["rel_bound_barrier"], o["qn_sigma"],
                                    0, use_qn, self._csr_mat)
        else:
            p = _compute_step(v, d, compact, jnp.asarray(0.0, self.dtype),
                              o["rel_bound_barrier"], o["qn_sigma"],
                              refine_steps=0, use_qn=use_qn)
        amin = o["start_affine_multiplier_min"]

        def aff(val, st, mask=None):
            out = jnp.maximum(amin, jnp.abs(val + st))
            if mask is not None:
                out = jnp.where(mask > 0, out, 0.0)
            return out

        self.vars = IPVars(
            x=v.x,
            zl=aff(v.zl, p.zl, d.lb_mask), zu=aff(v.zu, p.zu, d.ub_mask),
            s=aff(v.s, p.s), t=aff(v.t, p.t), z=v.z + p.z,
            zs=aff(v.zs, p.zs), zt=aff(v.zt, p.zt),
            sw=aff(v.sw, p.sw), tw=aff(v.tw, p.tw), zw=v.zw + p.zw,
            zsw=aff(v.zsw, p.zsw), ztw=aff(v.ztw, p.ztw))
        self.mu = float(kkt.average_complementarity(self.vars, d))

    # -- helpers -------------------------------------------------------------

    def _reset_qn(self):
        """Reset whichever Hessian approximation is installed (QNState or a
        duck-typed provider like EigenQuasiNewton)."""
        if self.qn is None:
            return
        if isinstance(self.qn, qnmod.QNState):
            self.qn = qnmod.qn_reset(self.qn)
        else:
            self.qn.reset()

    def _qn_compact(self):
        if self.qn is not None and not isinstance(self.qn, qnmod.QNState):
            # duck-typed compact provider (e.g. EigenQuasiNewton)
            return self.qn.compact()
        if self.qn is not None:
            return qnmod.qn_compact(self.qn)
        # Without a QN the Hessian block is b0·I: zero for the sequential
        # linear method (the bound/barrier terms keep the KKT diagonal SPD
        # inside the TR box), identity otherwise.
        b0 = 0.0 if self.options["sequential_linear_method"] else 1.0
        return (jnp.asarray(b0, self.dtype), None, None)

    def _rho_update(self, merit0, pmerit0, infeas, infeas_proj, pTBp, max_x):
        """Penalty parameter ρ update (`evalMeritInitDeriv` tail,
        `ParOptInteriorPoint.cpp:3838-3920`). Host scalar logic.
        Returns (m0, dm0)."""
        o = self.options
        descent = o["penalty_descent_fraction"]
        abs_res_tol = o["abs_res_tol"]
        numer = pmerit0
        if pTBp > 0.0:
            numer += 0.5 * pTBp
        if infeas < 0.1 * abs_res_tol:
            denom = -(1.0 - descent) * max_x * infeas
            rho_hat = -numer / denom if (numer >= 0.0 and denom < 0.0) else 0.0
        else:
            denom = infeas_proj + descent * max_x * infeas
            if numer >= 0.0:
                if denom < 0.0:
                    rho_hat = -numer / denom
                else:
                    denom = -(1.0 - descent) * max_x * infeas
                    rho_hat = -numer / denom if denom < 0.0 else 0.0
            else:
                rho_hat = 0.0
        if rho_hat > self.rho_penalty:
            self.rho_penalty = rho_hat
        else:
            self.rho_penalty = max(0.5 * self.rho_penalty, rho_hat)
        self.rho_penalty = max(self.rho_penalty,
                               o["min_rho_penalty_search"])
        m0 = merit0 + self.rho_penalty * infeas
        if infeas < 0.1 * abs_res_tol:
            dm0 = pmerit0 - self.rho_penalty * max_x * infeas
        else:
            dm0 = pmerit0 + self.rho_penalty * infeas_proj
        return m0, dm0

    def _eval_merit_at(self, d, alpha, p):
        """Evaluate the merit function at v + α·p.  Returns (merit, trial)
        where trial = (x, s, t, sw, tw, fobj, c, cw), or (None, None) if the
        user evaluation failed."""
        o = self.options
        xt, st, tt, swt, twt = self._fn(_trial_point)(
            self.vars, d, p, jnp.asarray(alpha, self.dtype),
            o["design_precision"])
        fobj, c, cw = self._eval_obj_con(xt)
        if fobj is None:
            return None, None
        m = self._fn(_merit_eval)(xt, st, tt, swt, twt, fobj, c, cw, d,
                        jnp.asarray(self.mu, self.dtype),
                        o["rel_bound_barrier"],
                        jnp.asarray(self.rho_penalty, self.dtype))
        return float(m), (xt, st, tt, swt, twt, fobj, c, cw)

    def check_merit_func_gradient(self, xpt=None, dh: float = 1e-6, p=None):
        """FD verification of the merit directional derivative used by the
        line search (`checkMeritFuncGradient`,
        `ParOptInteriorPoint.cpp:3280-3436`).

        Evaluates f/c and gradients at ``xpt`` (or the current point),
        computes (m0, dm0) along a probe direction through the same
        ρ-penalty update the line search uses (max_x = 1), then compares
        dm0 against the forward difference (m(dh) - m0) / dh.

        The direction is ``p`` (an IPVars — the in-loop caller passes the
        actual scaled KKT step) or, by default, the reference's
        deterministic test direction: px = -g/|g| with fixed patterned
        slack components (`:3325-3350`).

        Returns (fd, dm0, abs_err, rel_err) and logs one line in the
        reference's ``Merit function test`` format.
        """
        o = self.options
        if self.vars is None:
            self._init_design_and_bounds()
            self._init_vars()
        if xpt is not None:
            self.vars = dataclasses.replace(
                self.vars, x=jnp.asarray(xpt, self.dtype))
        self.fobj, self.c, self.cw = self._eval_obj_con(self.vars.x)
        if self.fobj is None:
            raise RuntimeError("function evaluation failed")
        self.g, self.A = self._eval_gradients(self.vars.x)
        d = self._make_data()
        ncon, nwcon = self.problem.ncon, self.problem.nwcon
        if p is None:
            # the reference's deterministic probe direction
            gnorm = float(jnp.linalg.norm(d.g)) or 1.0
            ic = np.arange(ncon)
            iw = np.arange(nwcon)
            zc = jnp.zeros(ncon, self.dtype)
            zwv = jnp.zeros(nwcon, self.dtype)
            p = IPVars(
                x=(-d.g / gnorm).astype(self.dtype),
                zl=jnp.zeros_like(self.vars.zl),
                zu=jnp.zeros_like(self.vars.zu),
                s=jnp.asarray(-0.259 * (1 + ic % 3), self.dtype),
                t=jnp.asarray(-0.349 * (4 - ic % 2), self.dtype),
                z=zc, zs=zc, zt=zc,
                sw=jnp.asarray(-0.419 * (1 + iw % 5), self.dtype),
                tw=jnp.asarray(-0.7513 * (1 + iw % 19), self.dtype),
                zw=zwv, zsw=zwv, ztw=zwv)
        use_qn = (self.qn is not None
                  and not o["sequential_linear_method"])
        mp = self._fn(_merit_parts)(
            self.vars, d, p, self.fobj, jnp.asarray(self.mu, self.dtype),
            o["rel_bound_barrier"], self._qn_compact(), use_qn=use_qn)
        m0, dm0 = self._rho_update(*(float(v) for v in mp), 1.0)

        # forward probe of all merit-relevant components (no clipping —
        # the reference perturbs the raw variables, `:3381-3394`)
        v = self.vars
        ftemp, rc, rcw = self._eval_obj_con(v.x + dh * p.x)
        if ftemp is None:
            raise RuntimeError("function evaluation failed")
        m1 = float(self._fn(_merit_eval)(
            v.x + dh * p.x, v.s + dh * p.s, v.t + dh * p.t,
            v.sw + dh * p.sw, v.tw + dh * p.tw, ftemp, rc, rcw, d,
            jnp.asarray(self.mu, self.dtype), o["rel_bound_barrier"],
            jnp.asarray(self.rho_penalty, self.dtype)))
        fd = (m1 - m0) / dh
        abs_err = abs(fd - dm0)
        rel_err = abs_err / max(abs(fd), 1e-300)
        line = ("Merit function test\n"
                f"dm FD: {fd:15.8e}  Actual: {dm0:15.8e}  "
                f"Err: {abs_err:8.2e}  Rel err: {rel_err:8.2e}\n")
        if self._logger is not None:
            self._logger.write(line)
        else:
            print(line, end="")
        return fd, dm0, abs_err, rel_err

    def _line_search(self, d, p, alpha_min, m0, dm0):
        """Backtracking / quadratic-interpolation merit line search
        (`lineSearch`, `ParOptInteriorPoint.cpp:3939-4160`).
        Returns (fail_flags, alpha, trial-or-None)."""
        o = self.options
        max_iters = o["max_line_iters"]
        backtrack = o["use_backtracking_alpha"]
        armijo = o["armijo_constant"]
        fprec = o["function_precision"]

        alpha = 1.0
        fail = LS_FAILURE
        best_alpha = -1.0
        best_merit = 0.0
        best_trial = None
        merit = None
        verbose = o["output_level"] > 0 and self._logger is not None
        if verbose:
            # reference per-trial trace (`ParOptInteriorPoint.cpp:3986-3994`)
            pxnorm = float(jnp.max(jnp.abs(p.x))) if p.x.size else 0.0
            self._logger.write(
                "%5s %7s %25s %12s %12s %12s\n"
                % ("iter", "alpha", "merit", "dmerit", "||px||",
                   "min(alpha)"))
            self._logger.write("%5d %7s %25.16e %12.5e %12.5e %12.5e\n"
                               % (0, " ", m0, dm0, pxnorm, alpha_min))
        j = 0
        while j < max_iters:
            merit, trial = self._eval_merit_at(d, alpha, p)
            if merit is None:
                alpha *= 0.1
                j += 1
                continue
            if verbose:
                self._logger.write(
                    "%5d %7.1e %25.16e %12.5e\n"
                    % (j + 1, alpha, merit, (merit - m0) / alpha))
            if best_alpha < 0.0 or merit < best_merit:
                best_alpha, best_merit, best_trial = alpha, merit, trial
            # Armijo relaxed by the function precision
            if merit - armijo * alpha * dm0 < m0 + fprec:
                fail = (LS_SUCCESS | LS_MIN_STEP if (fail & LS_MIN_STEP)
                        else LS_SUCCESS)
                if (merit <= m0 + fprec) and (merit + fprec >= m0):
                    fail |= LS_NO_IMPROVEMENT
                break
            elif fail & LS_MIN_STEP:
                break
            if j < max_iters - 1:
                if backtrack:
                    alpha = 0.5 * alpha
                    if alpha <= alpha_min:
                        alpha = alpha_min
                        fail |= LS_MIN_STEP
                else:
                    denom = merit - m0 - dm0 * alpha
                    alpha_new = (-0.5 * dm0 * alpha * alpha / denom
                                 if denom != 0.0 else alpha_min)
                    if alpha_new <= alpha_min:
                        alpha = alpha_min
                        fail |= LS_MIN_STEP
                    elif alpha_new < 0.01 * alpha:
                        alpha = 0.01 * alpha
                    else:
                        alpha = alpha_new
            j += 1
        if j == max_iters:
            fail |= LS_MAX_ITERS
        trial_out = best_trial
        if not (fail & LS_SUCCESS):
            if best_merit <= m0 + fprec and best_alpha > 0:
                fail |= LS_SUCCESS
                fail &= ~LS_FAILURE
            elif (merit is not None and merit <= m0 + fprec
                  and merit + fprec >= m0):
                fail |= LS_NO_IMPROVEMENT
            alpha = best_alpha if best_alpha > 0 else alpha
        else:
            trial_out = trial if (fail & LS_SUCCESS) and merit is not None \
                else best_trial
        return fail, alpha, trial_out

    def _accept_step(self, d, alpha, p, trial, perform_qn_update=True):
        """`computeStepAndUpdate` (`ParOptInteriorPoint.cpp:4169-4270`):
        apply the step, refresh gradients, update the quasi-Newton pair
        y = ∇ₓL(x₊, z₊) − ∇ₓL(x₀, z₊), s = α·px."""
        o = self.options
        v = self.vars
        new_vars = self._fn(_apply_step)(v, d, p, jnp.asarray(alpha, self.dtype),
                               o["design_precision"])
        if trial is not None:
            # reuse function values from the line search
            xt, st, tt, swt, twt, fobj, c, cw = trial
            new_vars = dataclasses.replace(new_vars, x=xt, s=st, t=tt,
                                           sw=swt, tw=twt)
            self.fobj, self.c, self.cw = fobj, c, cw
        else:
            fobj, c, cw = self._eval_obj_con(new_vars.x)
            if fobj is None:
                return False, 0, 0
            self.fobj, self.c, self.cw = fobj, c, cw

        g_old, A_old, x_old = self.g, self.A, v.x
        do_qn = (self.qn is not None and perform_qn_update
                 and o["use_quasi_newton_update"])
        z_new, zw_new = new_vars.z, new_vars.zw
        # the old-point Lagrangian gradient must be formed BEFORE the new
        # gradient evaluation: stateful problems (CSR data-fill style)
        # overwrite their stored Jacobian on evaluation
        # (`computeStepAndUpdate` ordering, ParOptInteriorPoint.cpp:4199-4216)
        if do_qn:
            y_old = g_old - (A_old.T @ z_new if d.ncon else 0.0)
            if d.nwcon > 0:
                y_old = y_old - self.problem.sparse_jacobian_tvec(x_old,
                                                                  zw_new)
        self.g, self.A = self._eval_gradients(new_vars.x)
        skipped = damped = 0
        if (self.qn is not None and perform_qn_update
                and not o["use_quasi_newton_update"]
                and hasattr(self.qn, "update_multipliers")):
            # refresh multiplier-dependent pieces of an externally-managed
            # Hessian approximation (EigenQuasiNewton z0 refresh, the role
            # of qn->update(x, z, zw) at ParOptInteriorPoint.cpp:4263)
            self.qn.update_multipliers(new_vars.x, new_vars.z, new_vars.zw)
        if do_qn:
            y = self.g - (self.A.T @ z_new if d.ncon else 0.0)
            if d.nwcon > 0:
                y = y - self.problem.sparse_jacobian_tvec(new_vars.x, zw_new)
            y = y - y_old
            s_step = alpha * p.x
            s_step, y = self.problem.compute_quasi_newton_update_correction(
                new_vars.x, z_new, zw_new, s_step, y)
            z0 = (z_new[0] if (self.qn.scaled and d.ncon > 0) else None)
            self.qn, skipped, damped = qnmod.qn_update(self.qn, s_step, y,
                                                       z0=z0)
        self.vars = new_vars
        return True, int(skipped), int(damped)

    # -- Newton-Krylov (GMRES) inexact phase --------------------------------

    def _gmres_step(self, d, mu_j, compact, rtol):
        """Right-preconditioned GMRES on the exact KKT linearization with
        user Hessian-vector products (`computeKKTGMRESStep`,
        `ParOptInteriorPoint.cpp:5774-6195`).

        The preconditioner is the diagonal+SMW KKT factorization (with the
        quasi-Newton Hessian when `use_qn_gmres_precon`); the operator uses
        `eval_hvec_product` for the Hessian block.  Returns (step, iters) or
        (None, 0) if GMRES fails to reduce the residual."""
        o = self.options
        v = self.vars
        m = o["gmres_subspace_size"]
        atol = o["gmres_atol"]
        r = kkt.kkt_residual(v, d, mu_j, o["rel_bound_barrier"])
        b = jax.tree_util.tree_map(jnp.negative, r)

        use_qn = (self.qn is not None and bool(o["use_qn_gmres_precon"])
                  and not o["sequential_linear_method"])
        cq = compact if use_qn else (compact[0], None, None)
        f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=o["qn_sigma"],
                                 csr_mat=self._csr_mat)

        def tdot(a, c):
            return sum(jnp.vdot(x, y) for x, y in
                       zip(jax.tree_util.tree_leaves(a),
                           jax.tree_util.tree_leaves(c)))

        def precon(w):
            neg_w = jax.tree_util.tree_map(jnp.negative, w)
            return kkt.solve_kkt(v, d, f, neg_w, qn_compact=cq)

        def bmult(px):
            b0c, Zc, Mc = cq
            out = b0c * px
            if Zc is not None and Zc.shape[0] > 0:
                out = out - Zc.T @ jnp.linalg.solve(Mc, Zc @ px)
            return out

        # MEMORY-SAVING SUBSPACE (`docs/ParOpt_theory_manual.tex:437-438`,
        # the (W[i], alpha[i]) pairs at `ParOptInteriorPoint.cpp:
        # 5884-5999`): the right-preconditioned operator K·K_B⁻¹ changes
        # only x-components, so every Krylov vector's non-x part is a
        # scalar multiple of b's — store (x-vector w, scalar a) with the
        # full vector N·w + (a/bnorm)·(I-NNᵀ)·b, dot products
        # wᵢᵀwⱼ + β·aᵢaⱼ, and recover the step with ONE final
        # preconditioner solve of the subspace combination.
        bsq = float(tdot(b, b))
        bnorm = float(np.sqrt(bsq))
        if bnorm == 0.0:
            return None, 0
        beta_n = (bsq - float(jnp.vdot(b.x, b.x))) / (bnorm * bnorm)

        def embed(wx, a):
            scale = a / bnorm
            out = jax.tree_util.tree_map(lambda leaf: scale * leaf, b)
            return dataclasses.replace(out, x=wx)

        verbose = o["output_level"] > 0 and self._logger is not None
        if verbose:
            # reference GMRES trace (`ParOptInteriorPoint.cpp:5904-5910`)
            self._logger.write(
                "%5s %4s %4s %7s %7s %8s %8s gmres rtol: %7.1e\n"
                % ("gmres", "nhvc", "iter", "res", "rel", "fproj",
                   "cproj", rtol))
            self._logger.write("      %4d %4d %7.1e %7.1e\n"
                               % (self.nhvec, 0, bnorm, 1.0))
        fproj: list = []
        cproj: list = []
        # descent-direction gate threshold (`ParOptInteriorPoint.cpp:
        # 6058-6069`): the tolerance exit is only taken when the current
        # least-squares solution is a candidate DESCENT direction —
        # fpr < 0, or the constraint projection reduces the l2
        # infeasibility by at least 1% of its magnitude
        cinfeas = float(jnp.linalg.norm(d.c - v.s + v.t)) if d.ncon else 0.0
        cwinfeas = (float(jnp.linalg.norm(d.cw - v.sw + v.tw))
                    if d.nwcon else 0.0)
        descent_thresh = -0.01 * (cinfeas + cwinfeas)

        W = [b.x / bnorm]
        al = [1.0]
        H = np.zeros((m + 1, m))
        g_vec = np.zeros(m + 1)
        g_vec[0] = bnorm
        cs = np.zeros(m)
        sn = np.zeros(m)
        iters = 0
        for j in range(m):
            # z_j = K_B⁻¹ v̂_j (transient); K z_j = v̂_j + N(H-B)z_j.x
            zj = precon(embed(W[j], al[j]))
            fp, cp = self._fn(_nk_projections)(
                v, d, b, zj, mu_j, o["rel_bound_barrier"])
            fproj.append(float(fp))
            cproj.append(float(cp))
            hvp = self.problem.eval_hvec_product(v.x, v.z, v.zw, zj.x)
            self.nhvec += 1
            w = W[j] + (jnp.asarray(hvp, self.dtype) - bmult(zj.x))
            a = al[j]
            for i in range(j + 1):
                H[i, j] = float(jnp.vdot(w, W[i])) + beta_n * a * al[i]
                w = w - H[i, j] * W[i]
                a = a - H[i, j] * al[i]
            wnorm = float(np.sqrt(max(
                float(jnp.vdot(w, w)) + beta_n * a * a, 0.0)))
            H[j + 1, j] = wnorm
            if j + 1 < m and wnorm > 0.0:
                W.append(w / wnorm)
                al.append(a / wnorm)
            # Givens rotations to maintain the QR of H
            for i in range(j):
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            denom = np.hypot(H[j, j], H[j + 1, j])
            cs[j] = H[j, j] / denom if denom else 1.0
            sn[j] = H[j + 1, j] / denom if denom else 0.0
            H[j, j] = denom
            H[j + 1, j] = 0.0
            g_vec[j + 1] = -sn[j] * g_vec[j]
            g_vec[j] = cs[j] * g_vec[j]
            iters = j + 1
            res = abs(g_vec[j + 1])
            # projection of the CURRENT least-squares solution onto the
            # objective/constraint directions (`:6040-6056`); y solves the
            # rotated upper-triangular system built so far (diagonal can
            # only be 0 on a lucky breakdown — treated as exact)
            yk = np.zeros(j + 1)
            for i2 in range(j, -1, -1):
                hd = H[i2, i2]
                yk[i2] = 0.0 if hd == 0.0 else \
                    (g_vec[i2] - H[i2, i2 + 1:j + 1] @ yk[i2 + 1:j + 1]) / hd
            fpr = float(yk @ np.asarray(fproj[:j + 1]))
            cpr = float(yk @ np.asarray(cproj[:j + 1]))
            if verbose:
                self._logger.write(
                    "      %4d %4d %7.1e %7.1e %8.1e %8.1e\n"
                    % (self.nhvec, j + 1, res, res / bnorm, fpr, cpr))
            # tolerance exit only for candidate descent directions
            # (`:6058-6069`); a breakdown (wnorm == 0) always terminates
            is_descent = fpr < 0.0 or cpr <= descent_thresh
            if (is_descent and (res < rtol * bnorm or res < atol)) \
                    or wnorm == 0.0:
                break
        # back-substitute y
        k = iters
        y = np.zeros(k)
        for i in range(k - 1, -1, -1):
            hd = H[i, i]
            y[i] = 0.0 if hd == 0.0 else \
                (g_vec[i] - H[i, i + 1:k] @ y[i + 1:k]) / hd
        final_res = abs(g_vec[k])
        if not np.isfinite(final_res) or final_res > bnorm:
            return None, iters
        # p = K_B⁻¹ Σ yᵢ v̂ᵢ — equals the old Σ yᵢ Zᵢ by linearity
        u_w = sum((float(y[i]) * W[i] for i in range(k)),
                  jnp.zeros_like(b.x))
        u_a = float(sum(y[i] * al[i] for i in range(k)))
        p = precon(embed(u_w, u_a))
        # the ASSEMBLED step must itself be a descent direction
        # (`:6154-6189`): recompute the projections on the full step —
        # p includes the non-x components the subspace combination only
        # approximated — and fall back to the quasi-Newton step otherwise
        # (the reference's -niters return)
        fp_f, cp_f = self._fn(_nk_projections)(
            v, d, b, p, mu_j, o["rel_bound_barrier"])
        fpr_f, cpr_f = float(fp_f), float(cp_f)
        if verbose:
            self._logger.write("      %9s %7s %7s %8.1e %8.1e\n"
                               % ("final", " ", " ", fpr_f, cpr_f))
        if not (fpr_f < 0.0 or cpr_f < descent_thresh):
            return None, iters
        return p, iters

    # -- checkpointing (`writeSolutionFile`/`readSolutionFile`,
    #    ParOptInteriorPoint.cpp:883-1110) ----------------------------------

    def _state_is_sharded(self) -> bool:
        """True when any state leaf lives sharded across >1 device."""
        for leaf in jax.tree_util.tree_leaves(self.vars):
            sh = getattr(leaf, "sharding", None)
            if sh is not None and len(getattr(sh, "device_set", ())) > 1:
                return True
        return False

    def write_solution_file(self, path: str) -> None:
        """Sharded state goes through the Orbax/TensorStore path (each
        shard written in parallel — the MPI-IO collective-write role);
        plain single-device arrays keep the simple npz format."""
        if self._state_is_sharded():
            from .utils.checkpoint import save_state
            save_state(path, {"vars": self.vars,
                              "mu": jnp.asarray(self.mu, self.dtype)})
            return
        v = self.vars
        arrays = {f.name: np.asarray(getattr(v, f.name))
                  for f in dataclasses.fields(IPVars)}
        arrays["mu"] = np.asarray(self.mu)
        np.savez(path, **arrays)

    def read_solution_file(self, path: str) -> None:
        if os.path.isdir(path):   # Orbax checkpoints are directories
            from .utils.checkpoint import restore_state
            template = {"vars": self.vars,
                        "mu": jnp.asarray(self.mu, self.dtype)}
            restored = restore_state(path, template)
            self.vars = restored["vars"]
            self.mu = float(restored["mu"])
            return
        if not path.endswith(".npz"):
            path = path + ".npz"
        dat = np.load(path)
        fields = {f.name: jnp.asarray(dat[f.name], self.dtype)
                  for f in dataclasses.fields(IPVars)}
        expect = {f.name: getattr(self.vars, f.name).shape
                  for f in dataclasses.fields(IPVars)}
        for name, val in fields.items():
            if val.shape != expect[name]:
                raise ValueError(
                    f"checkpoint field {name} has shape {val.shape}, "
                    f"expected {expect[name]}")
        self.vars = IPVars(**fields)
        self.mu = float(dat["mu"])

    # -- accessors -----------------------------------------------------------

    def get_optimized_point(self):
        v = self.vars
        return v.x, v.z, v.zw, v.zl, v.zu

    def get_optimized_slacks(self):
        """-> (s, t, sw, tw) (`getOptimizedSlacks`, ParOpt.pyx:1291-1310)."""
        v = self.vars
        return v.s, v.t, v.sw, v.tw

    def reset_quasi_newton_hessian(self):
        """Zero out the quasi-Newton approximation
        (`resetQuasiNewtonHessian`, ParOpt.pyx:1344-1345).  Handles both
        plain QNState holders and duck-typed providers (EigenQuasiNewton)."""
        self._reset_qn()

    def get_iteration_counters(self):
        return self.niter, self.neval, self.ngeval, self.nhvec

    def get_barrier_parameter(self):
        return self.mu

    def set_barrier_parameter(self, mu):
        self.mu = float(mu)

    def get_complementarity(self):
        return float(kkt.average_complementarity(self.vars, self._make_data()))

    # -- the major iteration loop -------------------------------------------

    def optimize(self, checkpoint: Optional[str] = None) -> Dict[str, Any]:
        """Run the optimization (`ParOptInteriorPoint::optimize`,
        `ParOptInteriorPoint.cpp:4399-5333`).  Returns a result dict."""
        o = self.options
        norm_type = o["norm_type"]
        abs_res_tol = o["abs_res_tol"]
        abs_step_tol = o["abs_step_tol"]
        rel_func_tol = o["rel_func_tol"]
        barrier_strategy = o["barrier_strategy"]
        max_iters = o["max_major_iters"]
        fprec = o["function_precision"]
        dprec = o["design_precision"]
        rbb = o["rel_bound_barrier"]
        refine_steps = o["iterative_refinement_steps"]
        seq_linear = o["sequential_linear_method"]
        use_line_search = o["use_line_search"]
        hessian_reset_freq = o["hessian_reset_freq"]
        write_freq = o["write_output_frequency"]
        output_file = o["output_file"]
        summary = ""
        if output_file:
            # full option summary at the log header (printOptionSummary,
            # ParOptInteriorPoint.cpp:869-881)
            lines = ["options:"]
            for name in o:
                lines.append(f"  {name} = {o[name]!r}")
            summary = "\n".join(lines) + "\n"
        self._logger = IPLogger(output_file, options_summary=summary)
        use_qn_default = (self.qn is not None and not seq_linear)

        # initial evaluation (failure aborts, ParOptInteriorPoint.cpp:4549)
        self.fobj, self.c, self.cw = self._eval_obj_con(self.vars.x)
        if self.fobj is None:
            raise RuntimeError("initial objective evaluation failed")
        self.g, self.A = self._eval_gradients(self.vars.x)
        d = self._make_data()

        # multiplier initialization strategy
        strategy = o["starting_point_strategy"]
        if strategy == "affine_step":
            self._init_affine_step_multipliers(d)
        elif strategy == "least_squares_multipliers":
            self._init_least_squares_multipliers(d)

        fobj_prev = float(self.fobj)
        res_norm = float("inf")
        res_norm_prev = None
        step_norm_prev = None
        alpha_prev = alpha_xprev = alpha_zprev = 1.0
        dm0_prev = 0.0
        line_search_test = 0
        no_merit_improvement = False
        self._converged_reason = ""
        converged = False
        info_prev = ""

        k = 0
        for k in range(max_iters):
            self.niter = k
            info = info_prev
            qn_hessian_reset = False
            # QN-update outcome flags: must be re-initialized every major
            # iteration — _accept_step may never run (LFail through the whole
            # DQN/SLP ladder), and stale flags from a previous iteration must
            # not leak into this iteration's info row.
            skipped = damped = 0
            if (self.qn is not None and not seq_linear and k > 0
                    and k % hessian_reset_freq == 0
                    and o["use_quasi_newton_update"]):
                self._reset_qn()
                qn_hessian_reset = True

            if write_freq > 0 and k % write_freq == 0:
                if checkpoint:
                    try:
                        self.write_solution_file(checkpoint)
                    except OSError:
                        checkpoint = None
                self.problem.write_output(k, self.vars.x)

            gv_freq = o["gradient_verification_frequency"]
            if k > 0 and gv_freq > 0 and k % gv_freq == 0:
                self.problem.check_gradients(
                    o["gradient_check_step_length"], x=self.vars.x,
                    check_hvec_product=o["use_hvec_product"])

            # convergence bookkeeping tests
            rel_function_test = (
                alpha_xprev == 1.0 and alpha_zprev == 1.0
                and abs(float(self.fobj) - fobj_prev)
                < rel_func_tol * abs(fobj_prev) if k > 0 else False)
            if no_merit_improvement:
                line_search_test += 1
            else:
                line_search_test = 0

            # barrier strategy (ParOptInteriorPoint.cpp:4656-4764)
            mu_j = jnp.asarray(self.mu, self.dtype)
            prime, dual, infeas_n, res_norm, comp = (
                self._fn(_residual_and_norms)(self.vars, d, mu_j, rbb,
                                              norm_type))
            prime, dual, infeas_n = float(prime), float(dual), float(infeas_n)
            res_norm = float(res_norm)
            comp = float(comp)
            if res_norm_prev is None:
                res_norm_prev = res_norm

            if barrier_strategy == "monotone":
                barrier_converged = k > 0 and (
                    res_norm < 10.0 * self.mu or rel_function_test
                    or line_search_test >= 2)
                if barrier_converged:
                    if self.mu > 0.1 * abs_res_tol:
                        line_search_test = 0
                    frac = o["monotone_barrier_fraction"] * self.mu
                    powv = self.mu ** o["monotone_barrier_power"]
                    new_mu = min(frac, powv)
                    if new_mu < 0.1 * abs_res_tol:
                        new_mu = 0.09999 * abs_res_tol
                    self.mu = new_mu
                    mu_j = jnp.asarray(self.mu, self.dtype)
                    prime, dual, infeas_n, res_norm, comp = (
                        self._fn(_residual_and_norms)(self.vars, d, mu_j, rbb,
                                                      norm_type))
                    prime, dual = float(prime), float(dual)
                    infeas_n, res_norm = float(infeas_n), float(res_norm)
                    comp = float(comp)
                    self.rho_penalty = o["min_rho_penalty_search"]
            elif barrier_strategy == "complementarity_fraction":
                self.mu = max(o["monotone_barrier_fraction"] * comp,
                              0.1 * abs_res_tol)
                mu_j = jnp.asarray(self.mu, self.dtype)
                prime, dual, infeas_n, res_norm, comp = (
                    self._fn(_residual_and_norms)(self.vars, d, mu_j, rbb,
                                                  norm_type))
                prime, dual = float(prime), float(dual)
                infeas_n, res_norm = float(infeas_n), float(res_norm)
                comp = float(comp)
            # mehrotra / mpc adapt μ after the affine probe below

            if (self._csr_mat is not None
                    and (o["output_level"] > 0 or k == 0)):
                # factorization fill-in stats ('MatInfo:' rows,
                # ParOptInteriorPoint.cpp:4768-4775)
                self._logger.write(
                    f"MatInfo: {self._csr_mat.get_factor_info()}\n")
            self._logger.log(k, self.neval, self.ngeval, self.nhvec,
                             alpha_prev, alpha_xprev, alpha_zprev,
                             float(self.fobj), prime, infeas_n, dual,
                             self.mu, comp, dm0_prev, self.rho_penalty,
                             info, o["output_level"])
            info = ""

            # convergence (ParOptInteriorPoint.cpp:4811-4840); the step-norm
            # test only participates when abs_step_tol is set (default 0)
            step_test = (abs_step_tol > 0.0 and step_norm_prev is not None
                         and step_norm_prev < abs_step_tol)
            if k > 0 and self.mu <= 0.1 * abs_res_tol and (
                    res_norm < abs_res_tol or rel_function_test
                    or line_search_test >= 2 or step_test):
                if rel_function_test:
                    self._converged_reason = "rel_function"
                elif line_search_test >= 2:
                    self._converged_reason = "no_improvement"
                elif step_test:
                    self._converged_reason = "step_tol"
                else:
                    self._converged_reason = "tolerance"
                converged = True
                break

            # -- step computation ------------------------------------------
            fobj_before_step = float(self.fobj)
            # Newton-Krylov inexact phase (`ParOptInteriorPoint.cpp:
            # 4853-4899`): once all residuals drop below nk_switch_tol and
            # the Eisenstat-Walker forcing term is small enough, solve the
            # exact KKT linearization by preconditioned GMRES with user
            # Hessian-vector products.
            inexact_step = None
            gmres_iters = 0
            if (o["use_hvec_product"] and o["gmres_subspace_size"] > 0
                    and res_norm_prev is not None and res_norm_prev > 0):
                gmres_rtol = (o["eisenstat_walker_gamma"]
                              * (res_norm / res_norm_prev)
                              ** o["eisenstat_walker_alpha"])
                nk_tol = o["nk_switch_tol"]
                if (prime < nk_tol and dual < nk_tol and infeas_n < nk_tol
                        and gmres_rtol < o["max_gmres_rtol"]):
                    mu_j = jnp.asarray(self.mu, self.dtype)
                    inexact_step, gmres_iters = self._gmres_step(
                        d, mu_j, self._qn_compact(),
                        max(gmres_rtol, 1e-12))
                    if inexact_step is not None:
                        info += f"iNK{gmres_iters} "
                    elif (gmres_iters > 0 and o["output_level"] > 0
                          and self._logger is not None):
                        # rejected non-descent NK step
                        # (`ParOptInteriorPoint.cpp:4885-4888`)
                        self._logger.write("      %9s\n" % "step failed")
            if o["use_diag_hessian"]:
                # B = diag(h) from the problem's Hessian diagonal (the MMA
                # subproblem path, `ParOptInteriorPoint.cpp:4944-4949`)
                hd = jnp.asarray(self.problem.eval_hessian_diag(
                    self.vars.x, self.vars.z, self.vars.zw), self.dtype)
                self.nhvec += 1
                if not bool(jnp.all(jnp.isfinite(hd))):
                    raise RuntimeError("Hessian diagonal evaluation failed")
                compact = (hd, None, None)
                use_qn = True
            else:
                compact = self._qn_compact()
                use_qn = use_qn_default
            sv_freq = o["step_verification_frequency"]
            sv_check_iter = sv_freq > 0 and k % sv_freq == 0
            # fused iteration head (step + scale + merit in ONE program —
            # see _step_scale_merit): the default monotone /
            # complementarity-fraction line-search path with no host
            # decision between the three phases
            fuse_head = (inexact_step is None and not self._eager
                         and use_line_search and not sv_check_iter
                         and barrier_strategy in ("monotone",
                                                  "complementarity_fraction"))
            mp = None
            if fuse_head:
                p = None
                p_s, axj, azj, ceq, mp, pxn = _step_scale_merit(
                    self.vars, d, compact,
                    jnp.asarray(self.fobj, self.dtype), mu_j,
                    jnp.asarray(comp, self.dtype), rbb, o["qn_sigma"],
                    o["min_fraction_to_boundary"],
                    refine_steps=refine_steps, use_qn=use_qn,
                    norm_type=norm_type)
                ax, az = float(axj), float(azj)
                res_norm_prev = max(res_norm, 1e-30)
                if abs_step_tol > 0.0:
                    step_norm_prev = float(pxn)
            elif inexact_step is not None:
                p = inexact_step
            elif self._eager:
                p = _compute_step_eager(self.vars, d, compact, mu_j, rbb,
                                        o["qn_sigma"], refine_steps, use_qn,
                                        self._csr_mat)
            else:
                p = _compute_step(self.vars, d, compact, mu_j, rbb,
                                  o["qn_sigma"], refine_steps=refine_steps,
                                  use_qn=use_qn)

            if not fuse_head and inexact_step is None and barrier_strategy \
                    in ("mehrotra", "mehrotra_predictor_corrector"):
                # affine probe: step toward μ = 0 from the same factorization
                if self._eager:
                    p_aff = _compute_step_eager(
                        self.vars, d, compact, jnp.asarray(0.0, self.dtype),
                        rbb, o["qn_sigma"], 0, use_qn, self._csr_mat)
                else:
                    p_aff = _compute_step(self.vars, d, compact,
                                          jnp.asarray(0.0, self.dtype), rbb,
                                          o["qn_sigma"], refine_steps=0,
                                          use_qn=use_qn)
                ax_a, az_a = kkt.max_step_lengths(
                    self.vars, d, p_aff, jnp.asarray(1.0, self.dtype))
                v_aff = self.vars.axpy(float(ax_a), float(az_a), p_aff)
                comp_aff = float(kkt.average_complementarity(v_aff, d))
                sigma = max((comp_aff / comp) ** 3 if comp > 0 else 0.01,
                            0.01)
                self.mu = max(sigma * comp, 0.09999 * abs_res_tol)
                mu_j = jnp.asarray(self.mu, self.dtype)
                if (barrier_strategy == "mehrotra_predictor_corrector"
                        and not self._eager):
                    ax_aff = min(float(ax_a), 1.0)
                    az_aff = min(float(az_a), 1.0)
                    p_aff_s = IPVars(
                        x=ax_aff * p_aff.x, zl=az_aff * p_aff.zl,
                        zu=az_aff * p_aff.zu, s=ax_aff * p_aff.s,
                        t=ax_aff * p_aff.t, z=az_aff * p_aff.z,
                        zs=az_aff * p_aff.zs, zt=az_aff * p_aff.zt,
                        sw=ax_aff * p_aff.sw, tw=ax_aff * p_aff.tw,
                        zw=az_aff * p_aff.zw, zsw=az_aff * p_aff.zsw,
                        ztw=az_aff * p_aff.ztw)
                    p = _compute_step_mpc(self.vars, d, compact, mu_j, rbb,
                                          o["qn_sigma"], p_aff_s,
                                          refine_steps=refine_steps,
                                          use_qn=use_qn)
                elif self._eager:
                    p = _compute_step_eager(self.vars, d, compact, mu_j, rbb,
                                            o["qn_sigma"], refine_steps,
                                            use_qn, self._csr_mat)
                else:
                    p = _compute_step(self.vars, d, compact, mu_j, rbb,
                                      o["qn_sigma"],
                                      refine_steps=refine_steps,
                                      use_qn=use_qn)

            if not fuse_head:
                res_norm_prev = max(res_norm, 1e-30)
                if abs_step_tol > 0.0:
                    from .ops.veclib import norm as _vnorm
                    step_norm_prev = float(_vnorm(p.x, norm_type))

                if (sv_check_iter and inexact_step is None
                        and barrier_strategy not in
                        ("mehrotra", "mehrotra_predictor_corrector")):
                    err = float(self._fn(_check_kkt_step)(
                        self.vars, d, p, compact, mu_j, rbb, o["qn_sigma"],
                        use_qn=use_qn))
                    self._logger.write(
                        f"KKT step check: max |K*p + r| = {err:.6e}\n")

                # fraction-to-boundary scaling (equal steps: Newton steps)
                p_s, ax, az, ceq = self._fn(_scale_step)(
                    self.vars, d, p, mu_j, jnp.asarray(comp, self.dtype),
                    jnp.asarray(inexact_step is not None),
                    o["min_fraction_to_boundary"])
                ax, az = float(ax), float(az)
            if bool(ceq):
                info += "cmpEq "

            line_fail = LS_FAILURE
            alpha = 1.0
            no_merit_improvement = False

            if use_line_search:
                if mp is None:
                    mp = self._fn(_merit_parts)(self.vars, d, p_s, self.fobj,
                                                mu_j, rbb, compact,
                                                use_qn=use_qn)
                m0, dm0 = self._rho_update(*(float(x) for x in mp), ax)
                dm0_prev = dm0
                # FD-verify the merit derivative along the ACTUAL step
                # (`ParOptInteriorPoint.cpp:5177-5180`).  The check runs a
                # ρ update of its own; restore the penalty afterwards so a
                # diagnostic never changes the line search it is checking
                # (m0/dm0 above were computed with the pre-check ρ).
                if gv_freq > 0 and k % gv_freq == 0:
                    rho_saved = self.rho_penalty
                    try:
                        self.check_merit_func_gradient(
                            None, o["gradient_check_step_length"], p=p_s)
                    finally:
                        self.rho_penalty = rho_saved
                if 0.0 <= dm0 <= fprec:
                    # descent within precision of zero: skip the line search
                    ok, skipped, damped = self._accept_step(d, 1.0, p_s, None)
                    if not ok:
                        raise RuntimeError("function evaluation failed")
                    line_fail = LS_SUCCESS
                    if abs(float(self.fobj) - fobj_before_step) <= fprec:
                        line_fail |= LS_NO_IMPROVEMENT
                    info += "skipLS "
                else:
                    if dm0 >= 0.0:
                        # not a descent direction: reset QN, diagonal-only
                        # step (ParOptInteriorPoint.cpp:5130-5173)
                        if self.qn is not None:
                            self._reset_qn()
                            qn_hessian_reset = True
                        compact = self._qn_compact()
                        if self._eager:
                            p = _compute_step_eager(
                                self.vars, d, compact, mu_j, rbb,
                                o["qn_sigma"], refine_steps, False,
                                self._csr_mat)
                        else:
                            p = _compute_step(self.vars, d, compact, mu_j,
                                              rbb, o["qn_sigma"],
                                              refine_steps=refine_steps,
                                              use_qn=False)
                        p_s, ax, az, ceq = self._fn(_scale_step)(
                            self.vars, d, p, mu_j,
                            jnp.asarray(comp, self.dtype), jnp.asarray(False),
                            o["min_fraction_to_boundary"])
                        ax, az = float(ax), float(az)
                        mp = self._fn(_merit_parts)(self.vars, d, p_s, self.fobj, mu_j,
                                          rbb, compact, use_qn=False)
                        m0, dm0 = self._rho_update(
                            *(float(x) for x in mp), ax)
                        dm0_prev = dm0
                        info += "DQN "
                    if dm0 >= 0.0 and not o["sequential_linear_method"]:
                        # last ladder stage (`ParOptInteriorPoint.cpp:
                        # 5264-5269`): drop the Hessian entirely — a
                        # sequential-linear step regularized only by the
                        # bound terms
                        compact = (jnp.asarray(0.0, self.dtype), None, None)
                        if self._eager:
                            p = _compute_step_eager(
                                self.vars, d, compact, mu_j, rbb,
                                o["qn_sigma"], refine_steps, False,
                                self._csr_mat)
                        else:
                            p = _compute_step(self.vars, d, compact, mu_j,
                                              rbb, o["qn_sigma"],
                                              refine_steps=refine_steps,
                                              use_qn=False)
                        p_s, ax, az, ceq = self._fn(_scale_step)(
                            self.vars, d, p, mu_j,
                            jnp.asarray(comp, self.dtype), jnp.asarray(False),
                            o["min_fraction_to_boundary"])
                        ax, az = float(ax), float(az)
                        mp = self._fn(_merit_parts)(
                            self.vars, d, p_s, self.fobj, mu_j, rbb, compact,
                            use_qn=False)
                        m0, dm0 = self._rho_update(
                            *(float(x) for x in mp), ax)
                        dm0_prev = dm0
                        info += "SLP "
                    if dm0 >= 0.0:
                        line_fail = LS_FAILURE
                        info += "LFail "
                    else:
                        px_norm = float(jnp.max(jnp.abs(p_s.x)))
                        alpha_min = 1.0
                        if px_norm != 0.0:
                            alpha_min = min(fprec / px_norm, 0.5)
                        line_fail, alpha, trial = self._line_search(
                            d, p_s, alpha_min, m0, dm0)
                        if px_norm < dprec:
                            line_fail |= LS_SHORT_STEP
                        if not (line_fail & LS_FAILURE):
                            ok, skipped, damped = self._accept_step(
                                d, alpha, p_s, trial)
                            if not ok:
                                line_fail |= LS_FAILURE
                        if line_fail & LS_MIN_STEP:
                            info += "LMnStp "
                        if line_fail & LS_MAX_ITERS:
                            info += "LMxItr "
            else:
                mp = self._fn(_merit_parts)(self.vars, d, p_s, self.fobj, mu_j, rbb,
                                  compact, use_qn=use_qn)
                m0, dm0 = self._rho_update(*(float(x) for x in mp), ax)
                dm0_prev = dm0
                ok, skipped, damped = self._accept_step(d, 1.0, p_s, None)
                if not ok:
                    raise RuntimeError("function evaluation failed")
                line_fail = LS_SUCCESS
                m1, _ = (float(self._fn(_merit_eval)(
                    self.vars.x, self.vars.s, self.vars.t, self.vars.sw,
                    self.vars.tw, self.fobj, self.c, self.cw, d, mu_j, rbb,
                    jnp.asarray(self.rho_penalty, self.dtype))), None)
                if m0 - fprec <= m1 <= m0 + fprec:
                    line_fail |= LS_NO_IMPROVEMENT
                elif abs(dm0) <= fprec:
                    line_fail = LS_NO_IMPROVEMENT

            # quasi-Newton update outcome flags (the reference's skipH /
            # dampH vocabulary, `ParOptInteriorPoint.cpp:5272-5322`)
            if skipped:
                info += "skipH "
            if damped:
                info += "dampH "
            if line_fail & LS_NO_IMPROVEMENT:
                info += "LNoImprv "
            no_merit_improvement = bool(
                line_fail & (LS_NO_IMPROVEMENT | LS_MIN_STEP | LS_SHORT_STEP
                             | LS_FAILURE))
            if (line_fail & LS_FAILURE):
                if self.qn is not None and o["use_quasi_newton_update"]:
                    self._reset_qn()
                info += "resetH "
            if qn_hessian_reset:
                info += "rstH "

            fobj_prev = fobj_before_step
            alpha_prev, alpha_xprev, alpha_zprev = alpha, ax, az
            info_prev = info

            # refresh the problem data pytree with the new evaluations
            d = self._make_data()

        self.niter = k
        result = {
            "x": self.vars.x, "fobj": float(self.fobj),
            "converged": converged, "reason": self._converged_reason,
            "niter": k, "neval": self.neval, "ngeval": self.ngeval,
            "res_norm": res_norm, "mu": self.mu,
        }
        if converged:
            self._logger.write(
                "\nParOpt: Successfully converged to requested tolerance\n"
                if self._converged_reason == "tolerance" else
                "\nParOpt: Converged ({})\n".format(self._converged_reason))
        self._logger.close()
        return result
