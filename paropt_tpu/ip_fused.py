"""Fused (fully-jitted) interior-point solver for pure-JAX problems.

The host-loop `InteriorPoint` in ip.py supports arbitrary host callbacks (the
reference's primary usage mode).  When the problem is pure JAX — every
trust-region quadratic subproblem, every MMA separable subproblem, and any
user problem written with `objective(x)`/`constraints(x)` — the entire major
iteration can be ONE compiled XLA computation: residual + norms, quasi-definite
KKT factor/solve, fraction-to-boundary scaling, merit/penalty update, the full
Armijo line search (model evaluations inlined), and the variable update.

This is the JAX-native answer to the reference's "hot loop = IP-on-QP"
structure (SURVEY.md §3.1): a subproblem solve becomes ~K jitted step calls
(host-paced, one device round-trip each) or a single `lax.while_loop` call
(`solve` with jit_loop=True) with zero host round-trips — the right shape for
an accelerator where dispatch latency would otherwise dominate.

Feature set (a subset of ip.py, sufficient for the TR/MMA inner solves and
jax-native outer problems): elastic double-slack formulation, all four
barrier strategies (monotone / mehrotra / mehrotra_predictor_corrector /
complementarity_fraction), least-squares + affine-step starting strategies, compact-QN or diagonal or fixed Hessians (optional in-loop L-BFGS
updates), merit line search with function-precision-relaxed Armijo and the
ρ-penalty update, equal-step complementarity safeguard, iterative refinement.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import full_precision
from .ops import kkt
from .ops import qn as qnmod
from .ops.kkt import IPVars, ProblemData

__all__ = ["FusedIP", "FusedIPOptions", "FusedState", "ModelFns",
           "fused_ip_optimize"]


class ModelFns(NamedTuple):
    """Pure-function problem definition.  Each callable takes
    (model_params, ...) and must be jit-traceable.  `hess_diag` may be None
    (use the compact/QN Hessian from params instead)."""
    eval_obj_con: Callable[[Any, jnp.ndarray],
                           Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]
    # (params, x) -> (f, c[ncon], cw[nwcon])
    eval_grad: Callable[[Any, jnp.ndarray],
                        Tuple[jnp.ndarray, jnp.ndarray]]
    # (params, x) -> (g[n], A[ncon, n])
    hess_diag: Optional[Callable[[Any, jnp.ndarray, jnp.ndarray, jnp.ndarray],
                                 jnp.ndarray]] = None
    # (params, x, z, zw) -> h[n]
    hvp: Optional[Callable[[Any, jnp.ndarray, jnp.ndarray, jnp.ndarray,
                            jnp.ndarray], jnp.ndarray]] = None
    # (params, x, z, zw, px) -> H(x,z,zw) @ px  (exact Lagrangian Hessian;
    # enables the fused Newton-Krylov phase)


class FusedIPOptions(NamedTuple):
    """Static solver options (a subset of the full registry; changing any
    value retraces)."""
    abs_res_tol: float = 1e-6
    init_barrier_param: float = 0.1
    monotone_barrier_fraction: float = 0.25
    monotone_barrier_power: float = 1.1
    rel_bound_barrier: float = 1.0
    min_fraction_to_boundary: float = 0.95
    penalty_descent_fraction: float = 0.3
    min_rho_penalty_search: float = 0.0
    armijo_constant: float = 1e-5
    function_precision: float = 1e-10
    design_precision: float = 1e-14
    max_line_iters: int = 10
    use_backtracking_alpha: bool = False
    max_major_iters: int = 200
    iterative_refinement_steps: int = 1
    qn_sigma: float = 0.0
    # 'monotone'|'mehrotra'|'mehrotra_predictor_corrector'|
    # 'complementarity_fraction' (see `_fused_step`'s barrier chain)
    barrier_strategy: str = "monotone"
    starting_point_strategy: str = "affine_step"
    start_affine_multiplier_min: float = 1.0
    use_line_search: bool = True
    use_quasi_newton_update: bool = False   # in-loop L-BFGS updates
    use_diag_hessian: bool = False          # B from model.hess_diag
    sequential_linear_method: bool = False  # B = qn_sigma (bounds regularize)
    norm_type: str = "infinity"
    # fused Newton-Krylov (inexact GMRES) phase — a JAX-native extension of
    # the reference's host-callback GMRES (`ParOptInteriorPoint.cpp:
    # 5774-6195`): once the residuals drop below nk_switch_tol, solve the
    # exact KKT linearization (autodiff Hessian-vector products) by
    # right-preconditioned GMRES, unrolled inside the fused step
    use_hvec_product: bool = False
    gmres_subspace_size: int = 25
    nk_switch_tol: float = 1e-3
    eisenstat_walker_gamma: float = 1.0
    eisenstat_walker_alpha: float = 1.5
    max_gmres_rtol: float = 0.1
    gmres_atol: float = 1e-30


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedState:
    """Complete solver state — one pytree, so the step function is
    (state, params) -> state and can live under lax.while_loop."""
    vars: IPVars
    qn: Optional[qnmod.QNState]
    mu: jnp.ndarray
    rho: jnp.ndarray
    fobj: jnp.ndarray
    c: jnp.ndarray
    cw: jnp.ndarray
    g: jnp.ndarray
    A: jnp.ndarray
    k: jnp.ndarray                 # iteration counter (int32)
    converged: jnp.ndarray         # bool
    res_norm: jnp.ndarray
    comp: jnp.ndarray
    fobj_prev: jnp.ndarray
    line_search_test: jnp.ndarray  # int32 consecutive no-improvement count
    neval: jnp.ndarray             # int32
    alpha: jnp.ndarray             # last accepted line-search step
    alpha_x: jnp.ndarray
    alpha_z: jnp.ndarray
    gmres_iters: jnp.ndarray       # int32 NK iterations used (0 = QN step)


def _norm_components(r: IPVars, norm_type: str):
    """(prime, dual, infeas) residual norms — the three groups the
    Newton-Krylov switch tests (`ParOptInteriorPoint.cpp:4853-4899`)."""
    from .ops.veclib import multi_norm
    prime = multi_norm([r.x, r.s, r.t], norm_type)
    dual = multi_norm([r.zl, r.zu, r.zs, r.zt, r.sw, r.tw, r.zsw, r.ztw],
                      norm_type)
    infeas = multi_norm([r.z, r.zw], norm_type)
    return prime, dual, infeas


def _norms(r: IPVars, norm_type: str):
    from .ops.veclib import multi_norm
    prime = multi_norm([r.x, r.s, r.t], norm_type)
    dual = multi_norm([r.zl, r.zu, r.zs, r.zt, r.sw, r.tw, r.zsw, r.ztw],
                     norm_type)
    infeas = multi_norm([r.z, r.zw], norm_type)
    if norm_type == "infinity":
        res = jnp.maximum(prime, jnp.maximum(dual, infeas))
    elif norm_type == "l1":
        res = prime + dual + infeas
    else:
        res = jnp.sqrt(prime ** 2 + dual ** 2 + infeas ** 2)
    return res


class FusedIP:
    """Factory for the fused solver.

    Parameters
    ----------
    model : ModelFns
    n, ncon, nwcon, nwblock : problem sizes (static)
    opts : FusedIPOptions
    """

    def __init__(self, model: ModelFns, n: int, ncon: int, nwcon: int = 0,
                 nwblock: int = 1, opts: FusedIPOptions = FusedIPOptions(),
                 dtype=None):
        from .dtypes import resolve_dtype
        self.model = model
        self.n, self.ncon, self.nwcon = n, ncon, nwcon
        self.nwblock = nwblock
        self.opts = opts
        self.dtype = resolve_dtype(dtype)
        self._step_jit = jax.jit(partial(_fused_step, model, opts))
        self._init_jit = jax.jit(partial(_fused_init, model, opts))
        self._solve_jit = jax.jit(partial(_fused_solve_loop, model, opts))
        self._batched_jit = {}  # (data_axes, params_axes) -> jitted vmap

        @jax.jit
        def run_k(state, k_stop, data, model_params, compact):
            def cond(s):
                return (~s.converged) & (s.k < k_stop)

            def body(s):
                return _fused_step(model, opts, s, data, model_params,
                                   compact)

            return jax.lax.while_loop(cond, body, state)

        self._run_k_jit = run_k

    def init(self, x0, data: ProblemData, model_params,
             qn_state: Optional[qnmod.QNState], compact) -> FusedState:
        """Initialize state (bounds clipping, multiplier start strategy)."""
        return self._init_jit(x0, data, model_params, qn_state, compact)

    def step(self, state: FusedState, data: ProblemData, model_params,
             compact) -> FusedState:
        return self._step_jit(state, data, model_params, compact)

    def solve(self, x0, data: ProblemData, model_params,
              qn_state: Optional[qnmod.QNState] = None, compact=None,
              jit_loop: bool = False, max_iters: Optional[int] = None,
              on_chunk=None, chunk=None) -> FusedState:
        """Run to convergence.  jit_loop=True runs the whole solve as one
        `lax.while_loop` XLA computation (zero host round-trips — the
        accelerator path); otherwise the host paces the jitted steps and can stop early.

        ``on_chunk(state)`` / ``chunk``: when either is given with
        jit_loop=True, the while_loop runs in bounded k-windows
        (utils/chunked.py) and the callback fires at each boundary — the
        fused-path home of the reference's mid-solve `writeOutput` +
        checkpoint cadence (`ParOptInteriorPoint.cpp:4620-4631`); build
        the callback with `make_write_output_hook`.
        """
        state = self.init(x0, data, model_params, qn_state, compact)
        iters = max_iters or self.opts.max_major_iters
        if jit_loop:
            if on_chunk is None and chunk is None:
                return self._solve_jit(state, data, model_params, compact)
            from .utils.chunked import run_chunked

            def run(s, k_stop):
                return self._run_k_jit(s, k_stop, data, model_params,
                                       compact)

            return run_chunked(run, state, iters,
                               chunk if chunk is not None else "auto",
                               on_chunk=on_chunk)
        for _ in range(iters):
            state = self.step(state, data, model_params, compact)
            if on_chunk is not None:
                on_chunk(state)
            if bool(state.converged):
                break
        return state

    def solve_batched(self, x0_batch, data: ProblemData, model_params=(),
                      qn_state: Optional[qnmod.QNState] = None, compact=None,
                      data_axes=None, model_params_axes=None) -> FusedState:
        """Run MANY whole solves as ONE XLA computation (`jax.vmap` over the
        fused `lax.while_loop`).

        A JAX-native capability with no reference analogue (in the reference
        every solve is a separate MPI job, `ParOptInteriorPoint.cpp:4399`):
        k multi-start solves — or a parameter sweep over problem data —
        batch onto the same device program, turning the per-variable work
        into [k, n]-shaped kernels that keep the device busy at sizes where
        a single instance is latency-bound.  Instances that converge first
        are frozen by the while_loop batching rule (their carry is masked)
        while the rest keep iterating, so the batch costs max-iterations,
        not sum.

        Parameters
        ----------
        x0_batch : [k, n] array of starting points (leading batch axis).
        data, model_params : shared across the batch by default; to sweep a
            field, pass it with a leading batch axis and give the matching
            vmap ``in_axes`` prefix pytree via ``data_axes`` /
            ``model_params_axes`` (e.g. ``dataclasses.replace`` the data
            with a [k, ...] field and an axes pytree with 0 at that leaf).
        qn_state : shared initial quasi-Newton state (e.g. ``qn_init``);
            its in-loop history is batched automatically by the vmap.

        Returns a FusedState whose every leaf has a leading k axis; index
        with ``jax.tree_util.tree_map(lambda a: a[i], state)`` or inspect
        ``state.converged`` / ``state.fobj`` per instance directly.
        """
        # cache key: the axes pytrees' structure + leaves (hashable ints /
        # None), not repr — semantically identical trees share one entry
        def _axes_key(axes):
            leaves, treedef = jax.tree_util.tree_flatten(
                axes, is_leaf=lambda x: x is None)
            return (treedef, tuple(leaves))

        key = (_axes_key(data_axes), _axes_key(model_params_axes))
        fn = self._batched_jit.get(key)
        if fn is None:
            def one(x0, d, p, q, c):
                st = _fused_init(self.model, self.opts, x0, d, p, q, c)
                return _fused_solve_loop(self.model, self.opts, st, d, p, c)

            fn = jax.jit(jax.vmap(
                one, in_axes=(0, data_axes, model_params_axes, None, None)))
            self._batched_jit[key] = fn
        return fn(x0_batch, data, model_params, qn_state, compact)


# ---------------------------------------------------------------------------
# implementation (module-level pure functions; `model`/`opts` bound at jit)
# ---------------------------------------------------------------------------


def _refresh_data(d: ProblemData, g, A, c, cw) -> ProblemData:
    return dataclasses.replace(d, g=g, A=A, c=c, cw=cw)


def _bound_pads(d: ProblemData, dprec, dtype):
    """Distance the clips keep x STRICTLY inside [lb, ub].

    design_precision (1e-14, the reference's f64-scale default) is below
    f32 resolution: lb + 1e-14 == lb in f32, so the clip intended to keep
    x off the bound becomes a no-op and a rounded step can land exactly ON
    it — the barrier quotients zl/(x-lb) then divide by zero (observed as
    inner-IP NaN on a 192x96 FEM topology subproblem).  Pad by at least a
    few ulps of the bound's magnitude."""
    eps = jnp.finfo(dtype).eps
    lo = jnp.maximum(dprec, 4.0 * eps * (1.0 + jnp.abs(d.lb)))
    hi = jnp.maximum(dprec, 4.0 * eps * (1.0 + jnp.abs(d.ub)))
    return lo, hi


def _get_compact(opts: FusedIPOptions, model: ModelFns, state: FusedState,
                 model_params, compact):
    """Resolve the Hessian representation for this iteration."""
    if opts.use_diag_hessian:
        h = model.hess_diag(model_params, state.vars.x, state.vars.z,
                            state.vars.zw)
        return (h, None, None)
    if opts.use_quasi_newton_update and state.qn is not None:
        return qnmod.qn_compact(state.qn)
    if compact is not None:
        return compact
    b0 = 0.0 if opts.sequential_linear_method else 1.0
    return (jnp.asarray(b0, state.vars.x.dtype), None, None)


@full_precision
def _fused_init(model: ModelFns, opts: FusedIPOptions, x0, d: ProblemData,
                model_params, qn_state, compact) -> FusedState:
    dtype = x0.dtype
    lo_pad, hi_pad = _bound_pads(d, opts.design_precision, dtype)
    x = jnp.where((d.lb_mask > 0) & (x0 < d.lb + lo_pad), d.lb + lo_pad, x0)
    x = jnp.where((d.ub_mask > 0) & (x > d.ub - hi_pad), d.ub - hi_pad, x)

    n = x.shape[0]
    ncon, nwcon = d.ncon, d.nwcon
    mu0 = opts.init_barrier_param

    fobj, c, cw = model.eval_obj_con(model_params, x)
    g, A = model.eval_grad(model_params, x)
    d = _refresh_data(d, g, A, c, cw)

    full_c = jnp.full((ncon,), mu0, dtype)
    full_w = jnp.full((nwcon,), mu0, dtype)
    v = IPVars(
        x=x,
        zl=jnp.where(d.lb_mask > 0, mu0, 0.0).astype(dtype),
        zu=jnp.where(d.ub_mask > 0, mu0, 0.0).astype(dtype),
        s=full_c, t=full_c, z=full_c, zs=full_c, zt=full_c,
        sw=full_w, tw=full_w, zw=full_w, zsw=full_w, ztw=full_w)

    strategy = opts.starting_point_strategy
    if strategy in ("least_squares_multipliers", "affine_step"):
        # regularized least-squares multiplier estimate
        # (`initLeastSquaresMultipliers`, ParOptInteriorPoint.cpp:5336-5534)
        small = 1e-4
        rhs = -(g - v.zl + v.zu)
        if nwcon > 0:
            blocks = d.Aw_inner_blocks(jnp.ones_like(x))
            nb = d.nwblock
            eye = jnp.eye(nb, dtype=dtype)
            Cw_chol = jnp.linalg.cholesky(blocks + small * eye)
        else:
            Cw_chol = None
        f0 = kkt.KKTFactor(Dinv=jnp.ones_like(x), Gamma=None, C0=None,
                           Cw_chol=Cw_chol, Xa=None, Wa=None, G_lu=None,
                           Zqn=None, Phi_x=None, Phi_z=None, Phi_w=None,
                           Ce_inv=None)
        if ncon > 0:
            Xa, _ = kkt.quasi_def_solve(f0, d, d.A,
                                        jnp.zeros((ncon, nwcon), dtype))
            G = d.A @ Xa.T + small * jnp.eye(ncon, dtype=dtype)
            yx0, _ = kkt.quasi_def_solve(f0, d, rhs, jnp.zeros(nwcon, dtype))
            z = jnp.linalg.solve(G, -(d.A @ yx0))
            gmax = 10.0 * jnp.maximum(d.gamma_s, d.gamma_t)
            z = jnp.where((z < -gmax) | (z > gmax), 0.0, z)
            v = dataclasses.replace(v, z=z)
        if nwcon > 0:
            rx = rhs + (d.A.T @ v.z if ncon else 0.0)
            _, zw_neg = kkt.quasi_def_solve(f0, d, rx,
                                            jnp.zeros(nwcon, dtype))
            zw = -zw_neg
            gwmax = 10.0 * jnp.maximum(d.gamma_sw, d.gamma_tw)
            zw = jnp.where((zw < -gwmax) | (zw > gwmax), 0.0, zw)
            v = dataclasses.replace(v, zw=zw)

    mu = jnp.asarray(mu0, dtype)
    if strategy == "affine_step":
        # one μ=0 Newton step; variables = |v + p| floored
        # (`initAffineStepMultipliers`, ParOptInteriorPoint.cpp:5536-5667)
        cq = compact if compact is not None else (
            (jnp.asarray(0.0 if opts.sequential_linear_method else 1.0,
                         dtype), None, None))
        if opts.use_diag_hessian and model.hess_diag is not None:
            cq = (model.hess_diag(model_params, x, v.z, v.zw), None, None)
        r = kkt.kkt_residual(v, d, jnp.asarray(0.0, dtype),
                             opts.rel_bound_barrier)
        f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=opts.qn_sigma)
        p = kkt.solve_kkt(v, d, f, r)
        amin = opts.start_affine_multiplier_min

        def aff(val, st, mask=None):
            out = jnp.maximum(amin, jnp.abs(val + st))
            if mask is not None:
                out = jnp.where(mask > 0, out, 0.0)
            return out

        v = IPVars(
            x=v.x, zl=aff(v.zl, p.zl, d.lb_mask), zu=aff(v.zu, p.zu,
                                                         d.ub_mask),
            s=aff(v.s, p.s), t=aff(v.t, p.t), z=v.z + p.z,
            zs=aff(v.zs, p.zs), zt=aff(v.zt, p.zt),
            sw=aff(v.sw, p.sw), tw=aff(v.tw, p.tw), zw=v.zw + p.zw,
            zsw=aff(v.zsw, p.zsw), ztw=aff(v.ztw, p.ztw))
        mu = kkt.average_complementarity(v, d)

    r = kkt.kkt_residual(v, d, mu, opts.rel_bound_barrier)
    zero = jnp.zeros((), dtype)
    return FusedState(
        vars=v, qn=qn_state, mu=mu, rho=zero + opts.min_rho_penalty_search,
        fobj=fobj, c=c, cw=cw, g=g, A=A,
        k=jnp.zeros((), jnp.int32), converged=jnp.asarray(False),
        res_norm=_norms(r, opts.norm_type), comp=kkt.average_complementarity(
            v, d),
        fobj_prev=fobj, line_search_test=jnp.zeros((), jnp.int32),
        neval=jnp.ones((), jnp.int32), alpha=zero + 1.0, alpha_x=zero + 1.0,
        alpha_z=zero + 1.0, gmres_iters=jnp.zeros((), jnp.int32))


def _merit_fn(opts: FusedIPOptions, d: ProblemData, x, s, t, sw, tw, fobj,
              c, cw, mu, rho):
    from .ip import _barrier_terms, _infeas_l2
    return (fobj + jnp.sum(d.gamma_s * s) + jnp.sum(d.gamma_t * t)
            + jnp.sum(d.gamma_sw * sw) + jnp.sum(d.gamma_tw * tw)
            - mu * _barrier_terms(x, s, t, sw, tw, d, opts.rel_bound_barrier)
            + rho * _infeas_l2(c, s, t, cw, sw, tw))


def _fused_gmres(model: ModelFns, opts: FusedIPOptions, model_params,
                 v: kkt.IPVars, d: ProblemData, f, cq, r: kkt.IPVars, rtol,
                 mu):
    """Right-preconditioned GMRES on the exact KKT linearization, UNROLLED
    to static length inside the fused step (the JAX-native form of
    `computeKKTGMRESStep`, `ParOptInteriorPoint.cpp:5774-6195`).

    - operator: the exact Lagrangian Hessian-vector product from
      `model.hvp` (autodiff — no hand-coded Hessians);
    - preconditioner: the diagonal+SMW KKT factorization `f` (one
      `solve_kkt` per Krylov vector);
    - all subspace indices are STATIC (python-level unroll) — no dynamic
      slicing in the hot loop; early convergence freezes the recurrence
      with masks, so extra arms are algebraically inert;
    - MEMORY-SAVING SUBSPACE (the reference's scheme, theory manual
      `docs/ParOpt_theory_manual.tex:437-438` and the (W[i], alpha[i])
      pairs in `ParOptInteriorPoint.cpp:5884-5999`): the preconditioned
      operator A = -K·K_B⁻¹ modifies only the x-components, so every
      Krylov basis vector's non-x components are a scalar multiple of the
      initial residual's.  Each basis vector is stored as an x-vector w
      plus ONE scalar a — full vector = N·w + (a/bnorm)·(I-NNᵀ)·b — and
      dots become wᵢᵀwⱼ + β·aᵢ·aⱼ with β = ‖b_nonx‖²/bnorm².  The
      preconditioned vectors Z are never stored at all: the solution is
      recovered with one extra `solve_kkt` of the subspace combination.
      Basis memory drops from ~6n to n+1 floats per arm (at n=16.7M f32,
      msub=25: ~10 GB → 1.7 GB);
    - fallback: embed(b.x, bnorm) reconstructs b exactly, so the fallback
      solve_kkt(b) — the ordinary quasi-Newton step — shares the single
      final preconditioner application via a select on the subspace
      combination.

    Returns (step pytree, iterations used)."""
    tmap = jax.tree_util.tree_map

    def tdot(a, c):
        return sum(jnp.vdot(x, y) for x, y in
                   zip(jax.tree_util.tree_leaves(a),
                       jax.tree_util.tree_leaves(c)))

    def precon(w):
        return kkt.solve_kkt(v, d, f, w, qn_compact=cq)

    def bmult(px):
        """B @ px for the preconditioner's Hessian approximation (the
        compact QN / diagonal / scalar b0 in `cq`)."""
        b0c, Zc, Mc = cq
        out = b0c * px
        if Zc is not None and Zc.shape[0] > 0:
            out = out - Zc.T @ jnp.linalg.solve(Mc, Zc @ px)
        return out

    msub = opts.gmres_subspace_size
    b = r  # solve_kkt solves K p = -b; GMRES runs on A = -K·K_B⁻¹
    bnorm = jnp.sqrt(tdot(b, b))
    bsafe = jnp.maximum(bnorm, 1e-300)
    atol = opts.gmres_atol
    # β: non-x energy of b, normalized (the reference's beta factor)
    beta_n = (tdot(b, b) - jnp.vdot(b.x, b.x)) / (bsafe * bsafe)

    def embed(wx, a):
        """Reconstruct the full tree N·wx + (a/bnorm)·(I-NNᵀ)·b."""
        scale = a / bsafe
        out = tmap(lambda leaf: scale * leaf, b)
        return dataclasses.replace(out, x=wx)

    # descent-gate threshold (`ParOptInteriorPoint.cpp:6154-6189`); the
    # gate itself is applied DIRECTLY to the assembled step after the
    # loop — see the end of this function.  (The reference's
    # per-iteration descent gate on the EARLY EXIT is host-loop-only: it
    # would need an O(msub^2) scalar triangular solve per arm in this
    # static unroll; the final gate is the one that decides whether the
    # step is usable.)
    from .ip import _nk_projections
    cinfeas = jnp.linalg.norm(d.c - v.s + v.t) if d.ncon else 0.0
    cwinfeas = jnp.linalg.norm(d.cw - v.sw + v.tw) if d.nwcon else 0.0
    descent_thresh = -0.01 * (cinfeas + cwinfeas)

    dt = v.x.dtype
    W = [b.x / bsafe]                     # x-components of the basis
    al = [jnp.ones((), dt)]               # non-x scalars
    H = [[jnp.zeros((), dt) for _ in range(msub)] for _ in range(msub + 1)]
    cs = [jnp.zeros((), dt) for _ in range(msub)]
    sn = [jnp.zeros((), dt) for _ in range(msub)]
    g_vec = [jnp.zeros((), dt) for _ in range(msub + 1)]
    g_vec[0] = bnorm
    done = jnp.asarray(False)
    last_res = bnorm
    iters = jnp.zeros((), jnp.int32)

    for j in range(msub):
        was_done = done
        # z_j = -K_B⁻¹ v̂_j (transient — consumed by the hvp below);
        # A v̂_j = K z_j = -v̂_j + N(H-B)z_j.x, so only the x-component
        # needs fresh storage and the scalar simply flips sign
        zj = precon(embed(W[j], al[j]))
        hv = model.hvp(model_params, v.x, v.z, v.zw, zj.x)
        w = -W[j] + (hv - bmult(zj.x))
        a = -al[j]
        for i in range(j + 1):
            hij = jnp.vdot(w, W[i]) + beta_n * a * al[i]
            H[i][j] = jnp.where(was_done, 0.0, hij)
            w = w - H[i][j] * W[i]
            a = a - H[i][j] * al[i]
        wnorm = jnp.sqrt(jnp.maximum(
            jnp.vdot(w, w) + beta_n * a * a, 0.0))
        wsafe = jnp.maximum(wnorm, 1e-300)
        hsub = jnp.where(was_done, 0.0, wnorm)
        W.append(w / wsafe)
        al.append(a / wsafe)
        # Givens rotations maintaining the QR of H
        for i in range(j):
            t = cs[i] * H[i][j] + sn[i] * H[i + 1][j]
            H[i + 1][j] = -sn[i] * H[i][j] + cs[i] * H[i + 1][j]
            H[i][j] = t
        denom = jnp.sqrt(H[j][j] ** 2 + hsub ** 2)
        dsafe = jnp.maximum(denom, 1e-300)
        cs[j] = jnp.where(denom > 0.0, H[j][j] / dsafe, 1.0)
        sn[j] = jnp.where(denom > 0.0, hsub / dsafe, 0.0)
        # frozen arms keep H[j][j] = 1 so back-substitution yields y = 0
        H[j][j] = jnp.where(was_done, 1.0, denom)
        g_next = -sn[j] * g_vec[j]
        g_vec[j] = jnp.where(was_done, g_vec[j], cs[j] * g_vec[j])
        g_vec[j + 1] = jnp.where(was_done, 0.0, g_next)
        res = jnp.abs(g_vec[j + 1])
        last_res = jnp.where(was_done, last_res, res)
        iters = iters + jnp.where(was_done, 0, 1)
        done = done | (res < rtol * bnorm) | (res < atol) | (wnorm <= 0.0)

    # back-substitute y over the full (masked) subspace
    y = [jnp.zeros((), dt) for _ in range(msub)]
    for i in range(msub - 1, -1, -1):
        acc = g_vec[i]
        for t in range(i + 1, msub):
            acc = acc - H[i][t] * y[t]
        y[i] = acc / jnp.where(H[i][i] != 0.0, H[i][i], 1.0)
    # subspace combination u = Σ yᵢ v̂ᵢ in (w, a) form; the step is
    # p = -K_B⁻¹ u = precon(u) — ONE final preconditioner application
    # (by linearity it equals the old Σ yᵢ Zᵢ)
    u_w = y[0] * W[0]
    u_a = y[0] * al[0]
    for i in range(1, msub):
        u_w = u_w + y[i] * W[i]
        u_a = u_a + y[i] * al[i]

    final_res = last_res  # residual after the final ACTIVE arm
    ok = (jnp.isfinite(final_res) & (final_res <= bnorm) & (iters > 0)
          & jnp.isfinite(jnp.vdot(u_w, u_w) + beta_n * u_a * u_a))
    # SIGN: precon solves K z = -w, so the raw subspace combination
    # satisfies K (Σ y_i z_i) = +r — the ANTI-Newton direction.  Negate
    # the combination before the final preconditioner application so the
    # returned step solves K p = -r like the quasi-Newton branch (this
    # inversion previously shipped unnoticed because the residual-only
    # acceptance had nothing direction-aware to trip on).
    p_nk = precon(embed(jnp.where(ok, -u_w, b.x),
                        jnp.where(ok, -u_a, bsafe)))
    # the assembled step must be a DESCENT direction
    # (`ParOptInteriorPoint.cpp:6154-6189`): project the ACTUAL step —
    # no per-arm linearity assumptions (the first frozen arm carries
    # y = final_res != 0, so weighted per-arm sums are not exact).
    # fused b is the UNNEGATED residual, so cproj flips sign.
    fpr, cpr_neg = _nk_projections.__wrapped__(
        v, d, b, p_nk, mu, opts.rel_bound_barrier)
    cpr = -cpr_neg
    accept = ok & ((fpr < 0.0) | (cpr < descent_thresh))
    # rejected (or non-finite) NK step falls back to the ordinary
    # quasi-Newton direction — the reference's -niters convention
    # (`:4883-4894` prints 'step failed' and keeps the QN step); iters
    # keeps reporting the Krylov work executed
    p_qn = precon(b)
    p_out = jax.tree_util.tree_map(
        lambda a2, b2: jnp.where(accept, a2, b2), p_nk, p_qn)
    return p_out, iters


@full_precision
def _fused_step(model: ModelFns, opts: FusedIPOptions, state: FusedState,
                d: ProblemData, model_params, compact) -> FusedState:
    """One full major iteration (pure, jittable)."""
    from .ip import _barrier_terms, _infeas_l2
    v = state.vars
    dtype = v.x.dtype
    d = _refresh_data(d, state.g, state.A, state.c, state.cw)
    tol = opts.abs_res_tol

    # -- factorization (μ-independent) --------------------------------------
    comp = kkt.average_complementarity(v, d)
    cq = _get_compact(opts, model, state, model_params, compact)
    # named scopes label the phases in jax.profiler / XLA traces (the
    # per-phase observability SURVEY.md §5.1 calls for)
    with jax.named_scope("kkt_factor"):
        f = kkt.setup_kkt_factor(v, d, qn_compact=cq,
                                 qn_sigma=opts.qn_sigma)

    # the KKT residual is affine in μ (only the complementarity rows carry
    # −μ), so compute it ONCE at μ = 0 and shift
    r00 = kkt.kkt_residual(v, d, jnp.zeros((), dtype),
                           opts.rel_bound_barrier)
    rbb = opts.rel_bound_barrier

    def _residual_at(m):
        return dataclasses.replace(
            r00,
            zs=r00.zs - m, zt=r00.zt - m, zsw=r00.zsw - m, ztw=r00.ztw - m,
            zl=jnp.where(d.lb_mask > 0, r00.zl - rbb * m, 0.0),
            zu=jnp.where(d.ub_mask > 0, r00.zu - rbb * m, 0.0))

    # -- barrier strategy ----------------------------------------------------
    ls_base = state.line_search_test
    p_aff_s = None
    if opts.barrier_strategy == "complementarity_fraction":
        mu = jnp.maximum(opts.monotone_barrier_fraction * comp, 0.1 * tol)
    elif opts.barrier_strategy in ("mehrotra",
                                   "mehrotra_predictor_corrector"):
        # affine predictor toward μ = 0 from the same factorization
        # (ParOptInteriorPoint.cpp:4999-5051)
        p_aff = kkt.solve_kkt(v, d, f, r00, qn_compact=cq)
        ax_a, az_a = kkt.max_step_lengths(v, d, p_aff,
                                          jnp.asarray(1.0, dtype))
        ax_a = jnp.minimum(ax_a, 1.0)
        az_a = jnp.minimum(az_a, 1.0)
        comp_aff = kkt.average_complementarity(v.axpy(ax_a, az_a, p_aff), d)
        sigma = jnp.maximum((comp_aff / jnp.maximum(comp, 1e-300)) ** 3,
                            0.01)
        # keep the barrier non-increasing: letting μ chase a growing
        # complementarity can drive the solve into the elastic regime
        mu = jnp.clip(jnp.maximum(sigma * comp, 0.09999 * tol),
                      0.09999 * tol, state.mu)
        if opts.barrier_strategy == "mehrotra_predictor_corrector":
            p_aff_s = IPVars(
                x=ax_a * p_aff.x, zl=az_a * p_aff.zl, zu=az_a * p_aff.zu,
                s=ax_a * p_aff.s, t=ax_a * p_aff.t, z=az_a * p_aff.z,
                zs=az_a * p_aff.zs, zt=az_a * p_aff.zt, sw=ax_a * p_aff.sw,
                tw=ax_a * p_aff.tw, zw=az_a * p_aff.zw,
                zsw=az_a * p_aff.zsw, ztw=az_a * p_aff.ztw)
    else:  # monotone
        res0 = _norms(_residual_at(state.mu), opts.norm_type)
        barrier_conv = (state.k > 0) & ((res0 < 10.0 * state.mu)
                                        | (state.line_search_test >= 2))
        mu_frac = opts.monotone_barrier_fraction * state.mu
        mu_pow = state.mu ** opts.monotone_barrier_power
        new_mu = jnp.minimum(mu_frac, mu_pow)
        new_mu = jnp.maximum(new_mu, 0.09999 * tol)
        mu = jnp.where(barrier_conv, new_mu, state.mu)
        # reset the no-improvement counter when a new barrier problem
        # starts (ParOptInteriorPoint.cpp:4697-4700)
        ls_base = jnp.where(barrier_conv & (state.mu > 0.1 * tol),
                            jnp.zeros((), jnp.int32), state.line_search_test)

    r = _residual_at(mu)
    res_norm = _norms(r, opts.norm_type)
    if p_aff_s is not None:
        # corrector: second-order Δ·Δ complementarity terms
        r = dataclasses.replace(
            r,
            zs=r.zs + p_aff_s.s * p_aff_s.zs,
            zt=r.zt + p_aff_s.t * p_aff_s.zt,
            zsw=r.zsw + p_aff_s.sw * p_aff_s.zsw,
            ztw=r.ztw + p_aff_s.tw * p_aff_s.ztw,
            zl=jnp.where(d.lb_mask > 0, r.zl + p_aff_s.x * p_aff_s.zl, 0.0),
            zu=jnp.where(d.ub_mask > 0, r.zu - p_aff_s.x * p_aff_s.zu, 0.0))

    converged = (state.k > 0) & (mu <= 0.1 * tol) & (
        (res_norm < tol) | (state.line_search_test >= 2))

    # -- KKT step -----------------------------------------------------------
    nk_iters = jnp.zeros((), jnp.int32)
    if (opts.use_hvec_product and opts.gmres_subspace_size > 0
            and model.hvp is not None):
        # Newton-Krylov switch (`ParOptInteriorPoint.cpp:4853-4899`):
        # residual groups small + Eisenstat-Walker forcing term small
        prime0, dual0, infeas0 = _norm_components(r, opts.norm_type)
        ew_rtol = (opts.eisenstat_walker_gamma
                   * (res_norm / jnp.maximum(state.res_norm, 1e-300))
                   ** opts.eisenstat_walker_alpha)
        nk_tol = opts.nk_switch_tol
        use_nk = ((state.k > 0) & (prime0 < nk_tol) & (dual0 < nk_tol)
                  & (infeas0 < nk_tol) & (ew_rtol < opts.max_gmres_rtol))
        rtol = jnp.clip(ew_rtol, 1e-12, opts.max_gmres_rtol)

        def _qn_step(_):
            pq = kkt.solve_kkt(v, d, f, r,
                               refine_steps=opts.iterative_refinement_steps,
                               qn_compact=cq)
            return pq, jnp.zeros((), jnp.int32)

        def _nk_step(_):
            return _fused_gmres(model, opts, model_params, v, d, f, cq, r,
                                rtol, mu)

        with jax.named_scope("kkt_solve_nk"):
            p, nk_iters = jax.lax.cond(use_nk, _nk_step, _qn_step, None)
    else:
        with jax.named_scope("kkt_solve"):
            p = kkt.solve_kkt(v, d, f, r,
                              refine_steps=opts.iterative_refinement_steps,
                              qn_compact=cq)

    # -- fraction-to-boundary scaling ---------------------------------------
    tau = jnp.maximum(opts.min_fraction_to_boundary, 1.0 - mu)
    ax, az = kkt.max_step_lengths(v, d, p, tau)
    mb = 100.0
    ax = jnp.where(ax > az, jnp.clip(ax, az / mb, az * mb), ax)
    az = jnp.where(az > ax, jnp.clip(az, ax / mb, ax * mb), az)
    comp_new = kkt.average_complementarity(v.axpy(ax, az, p), d)
    amin2 = jnp.minimum(ax, az)
    ceq = comp_new > 10.0 * comp
    ax = jnp.where(ceq, amin2, ax)
    az = jnp.where(ceq, amin2, az)
    ps = IPVars(x=ax * p.x, zl=az * p.zl, zu=az * p.zu, s=ax * p.s,
                t=ax * p.t, z=az * p.z, zs=az * p.zs, zt=az * p.zt,
                sw=ax * p.sw, tw=ax * p.tw, zw=az * p.zw, zsw=az * p.zsw,
                ztw=az * p.ztw)

    # -- merit + rho update -------------------------------------------------
    merit0 = (state.fobj + jnp.sum(d.gamma_s * v.s) + jnp.sum(d.gamma_t * v.t)
              + jnp.sum(d.gamma_sw * v.sw) + jnp.sum(d.gamma_tw * v.tw)
              - mu * _barrier_terms(v.x, v.s, v.t, v.sw, v.tw, d,
                                    opts.rel_bound_barrier))
    pbarrier = opts.rel_bound_barrier * (
        jnp.sum(jnp.where(d.lb_mask > 0, ps.x / (v.x - d.lb), 0.0))
        - jnp.sum(jnp.where(d.ub_mask > 0, ps.x / (d.ub - v.x), 0.0)))
    for val, st in ((v.s, ps.s), (v.t, ps.t), (v.sw, ps.sw), (v.tw, ps.tw)):
        if val.size:
            pbarrier = pbarrier + jnp.sum(st / val)
    pmerit0 = (jnp.vdot(d.g, ps.x)
               + jnp.sum(d.gamma_s * ps.s) + jnp.sum(d.gamma_t * ps.t)
               + jnp.sum(d.gamma_sw * ps.sw) + jnp.sum(d.gamma_tw * ps.tw)
               - mu * pbarrier)
    infeas = _infeas_l2(d.c, v.s, v.t, d.cw, v.sw, v.tw)
    pdense = (jnp.sum((d.c - v.s + v.t) * (d.A @ ps.x - ps.s + ps.t))
              if d.ncon else 0.0)
    psparse = (jnp.sum((d.cw - v.sw + v.tw)
                       * (d.Aw_matvec(ps.x) - ps.sw + ps.tw))
               if d.nwcon else 0.0)
    infeas_proj = jnp.where(infeas > 0.0,
                            (pdense + psparse) / jnp.maximum(infeas, 1e-300),
                            0.0)
    b0c, Zc, Mc = cq
    Bpx = b0c * ps.x
    if Zc is not None:
        Bpx = Bpx - Zc.T @ jnp.linalg.solve(Mc, Zc @ ps.x)
    pTBp = jnp.vdot(ps.x, Bpx)

    # ρ update (evalMeritInitDeriv tail, as jnp.where chains)
    descent = opts.penalty_descent_fraction
    numer = pmerit0 + jnp.where(pTBp > 0.0, 0.5 * pTBp, 0.0)
    small_inf = infeas < 0.1 * tol
    denom_small = -(1.0 - descent) * ax * infeas
    rho_small = jnp.where((numer >= 0.0) & (denom_small < 0.0),
                          -numer / jnp.where(denom_small < 0.0, denom_small,
                                             -1.0), 0.0)
    denom_big = infeas_proj + descent * ax * infeas
    rho_big = jnp.where(
        numer >= 0.0,
        jnp.where(denom_big < 0.0,
                  -numer / jnp.where(denom_big < 0.0, denom_big, -1.0),
                  jnp.where(denom_small < 0.0,
                            -numer / jnp.where(denom_small < 0.0, denom_small,
                                               -1.0), 0.0)),
        0.0)
    rho_hat = jnp.where(small_inf, rho_small, rho_big)
    rho = jnp.where(rho_hat > state.rho, rho_hat,
                    jnp.maximum(0.5 * state.rho, rho_hat))
    rho = jnp.maximum(rho, opts.min_rho_penalty_search)
    m0 = merit0 + rho * infeas
    dm0 = jnp.where(small_inf, pmerit0 - rho * ax * infeas,
                    pmerit0 + rho * infeas_proj)

    # -- line search --------------------------------------------------------
    fprec = opts.function_precision
    dprec = opts.design_precision

    lo_pad, hi_pad = _bound_pads(d, dprec, dtype)

    def trial(alpha):
        xt = v.x + alpha * ps.x
        xt = jnp.where((d.lb_mask > 0) & (xt <= d.lb + lo_pad),
                       d.lb + lo_pad, xt)
        xt = jnp.where((d.ub_mask > 0) & (xt + hi_pad >= d.ub),
                       d.ub - hi_pad, xt)
        clip = lambda a: jnp.maximum(a, dprec)
        st_ = clip(v.s + alpha * ps.s)
        tt = clip(v.t + alpha * ps.t)
        swt = clip(v.sw + alpha * ps.sw)
        twt = clip(v.tw + alpha * ps.tw)
        ft, ct, cwt = model.eval_obj_con(model_params, xt)
        merit = _merit_fn(opts, d, xt, st_, tt, swt, twt, ft, ct, cwt, mu,
                          rho)
        return merit

    if opts.use_line_search:
        px_norm = jnp.max(jnp.abs(ps.x))
        alpha_min = jnp.minimum(
            jnp.where(px_norm > 0, fprec / jnp.maximum(px_norm, 1e-300), 1.0),
            0.5)

        def ls_cond(carry):
            j, alpha, best_a, best_m, done, success, neval = carry
            return (~done) & (j < opts.max_line_iters)

        def ls_body(carry):
            j, alpha, best_a, best_m, done, success, neval = carry
            merit = trial(alpha)
            neval = neval + 1
            better = (best_a < 0.0) | (merit < best_m)
            best_a = jnp.where(better, alpha, best_a)
            best_m = jnp.where(better, merit, best_m)
            armijo_ok = (merit - opts.armijo_constant * alpha * dm0
                         < m0 + fprec)
            # quadratic interpolation backtrack
            denom = merit - m0 - dm0 * alpha
            if opts.use_backtracking_alpha:
                alpha_new = 0.5 * alpha
            else:
                alpha_new = jnp.where(
                    denom != 0.0,
                    -0.5 * dm0 * alpha * alpha
                    / jnp.where(denom != 0.0, denom, 1.0), alpha_min)
                alpha_new = jnp.clip(alpha_new, 0.01 * alpha, alpha)
            alpha_next = jnp.maximum(alpha_new, alpha_min)
            min_step = alpha <= alpha_min
            done = armijo_ok | min_step
            success = success | armijo_ok
            alpha = jnp.where(done, alpha, alpha_next)
            return (j + 1, alpha, best_a, best_m, done, success, neval)

        one = jnp.asarray(1.0, dtype)
        init = (jnp.zeros((), jnp.int32), one, -one,
                jnp.zeros((), dtype), jnp.asarray(False), jnp.asarray(False),
                jnp.zeros((), jnp.int32))
        jls, alpha_f, best_a, best_m, _, ls_done_ok, nev = (
            jax.lax.while_loop(ls_cond, ls_body, init))
        # if Armijo failed everywhere, fall back to the best alpha seen when
        # it at least does not increase the merit beyond precision
        use_best = (~ls_done_ok) & (best_m <= m0 + fprec) & (best_a > 0.0)
        alpha = jnp.where(ls_done_ok, alpha_f,
                          jnp.where(use_best, best_a, 0.0))
        # descent-direction failure: don't move
        alpha = jnp.where(dm0 >= 0.0, 0.0, alpha)
        no_improve = ((best_m >= m0 - fprec) & (best_m <= m0 + fprec)) | \
            (alpha <= 0.0) | (px_norm < dprec)
        neval_add = nev
    else:
        alpha = jnp.asarray(1.0, dtype)
        m1 = trial(alpha)
        no_improve = ((m1 >= m0 - fprec) & (m1 <= m0 + fprec)) | \
            (jnp.abs(dm0) <= fprec)
        neval_add = jnp.ones((), jnp.int32)

    # -- apply the step -----------------------------------------------------
    vn = v.axpy(alpha, alpha, ps)
    xn = vn.x
    xn = jnp.where((d.lb_mask > 0) & (xn <= d.lb + lo_pad), d.lb + lo_pad,
                   xn)
    xn = jnp.where((d.ub_mask > 0) & (xn + hi_pad >= d.ub), d.ub - hi_pad,
                   xn)
    clip = lambda a: jnp.maximum(a, dprec)
    vn = IPVars(x=xn, zl=jnp.where(d.lb_mask > 0, clip(vn.zl), 0.0),
                zu=jnp.where(d.ub_mask > 0, clip(vn.zu), 0.0),
                s=clip(vn.s), t=clip(vn.t), z=vn.z, zs=clip(vn.zs),
                zt=clip(vn.zt), sw=clip(vn.sw), tw=clip(vn.tw), zw=vn.zw,
                zsw=clip(vn.zsw), ztw=clip(vn.ztw))

    fobj_n, c_n, cw_n = model.eval_obj_con(model_params, vn.x)
    g_n, A_n = model.eval_grad(model_params, vn.x)

    # optional in-loop quasi-Newton update
    qn_n = state.qn
    if opts.use_quasi_newton_update and state.qn is not None:
        y = g_n - (A_n.T @ vn.z if d.ncon else 0.0)
        y0 = state.g - (state.A.T @ vn.z if d.ncon else 0.0)
        if d.nwcon > 0:
            y = y - d.Aw_rmatvec(vn.zw)
            y0 = y0 - d.Aw_rmatvec(vn.zw)
        # the rejected-step gate is folded into qn_update's own select
        # (one pass over the [m, n] buffers instead of a second tree_map)
        qn_n, _, _ = qnmod.qn_update(
            state.qn, alpha * ps.x, y - y0,
            compact=None if opts.use_diag_hessian else cq,
            accept=alpha > 0.0)

    ls_count = jnp.where(no_improve, ls_base + 1,
                         jnp.zeros((), jnp.int32))

    new_state = FusedState(
        vars=vn, qn=qn_n, mu=mu, rho=rho, fobj=fobj_n, c=c_n, cw=cw_n,
        g=g_n, A=A_n, k=state.k + 1, converged=converged,
        res_norm=res_norm, comp=comp, fobj_prev=state.fobj,
        line_search_test=ls_count, neval=state.neval + neval_add + 1,
        alpha=alpha, alpha_x=ax, alpha_z=az, gmres_iters=nk_iters)

    # fail-stop safeguard: if the accepted state went non-finite (an
    # ill-conditioned subproblem at f32 — no host-side recovery ladder
    # exists inside the fused loop), freeze at the previous finite state
    # and stop, instead of burning iterations on NaN (the fused analogue
    # of the reference's fail-flag abort, `ParOptInteriorPoint.cpp:
    # 4549-4561`; observed on a 192x96 FEM topology MMA subproblem)
    bad = ~(jnp.isfinite(fobj_n) & jnp.isfinite(jnp.max(jnp.abs(vn.x)))
            & jnp.isfinite(jnp.max(jnp.abs(g_n))))
    stop = converged | bad

    # freeze everything once converged (for the while_loop path) — but
    # record the converging iteration's res_norm/mu so the final state
    # reports the values the convergence test actually saw, not the
    # previous iteration's
    return jax.tree_util.tree_map(
        lambda new, old: jnp.where(stop, old, new),
        new_state, dataclasses.replace(state, converged=stop,
                                       res_norm=res_norm, mu=mu))


def _fused_solve_loop(model: ModelFns, opts: FusedIPOptions,
                      state: FusedState, d: ProblemData, model_params,
                      compact) -> FusedState:
    def cond(s):
        return (~s.converged) & (s.k < opts.max_major_iters)

    def body(s):
        return _fused_step(model, opts, s, d, model_params, compact)

    return jax.lax.while_loop(cond, body, state)


# ---------------------------------------------------------------------------
# convenience: wrap any pure-JAX Problem for the fused solver
# ---------------------------------------------------------------------------


def model_from_problem(problem) -> ModelFns:
    """ModelFns closing over a jax-native `Problem` (its arrays become jit
    constants; model_params is unused — pass ())."""

    def ev(params, x):
        f, c = problem.eval_obj_con(x)
        if problem.nwcon > 0:
            cw = problem.eval_sparse_con(x)
        else:
            cw = jnp.zeros(0, x.dtype)
        return f, c, cw

    def gr(params, x):
        return problem.eval_obj_con_gradient(x)

    def hd(params, x, z, zw):
        # only traced when opts.use_diag_hessian is set; raises
        # NotImplementedError for problems without a Hessian diagonal
        return problem.eval_hessian_diag(x, z, zw)

    def hvp(params, x, z, zw, px):
        # only traced when opts.use_hvec_product is set (fused NK phase)
        return problem.eval_hvec_product(x, z, zw, px)

    return ModelFns(eval_obj_con=ev, eval_grad=gr, hess_diag=hd, hvp=hvp)


def data_template_from_problem(problem, penalty_gamma: float = 1000.0,
                               max_bound_value: float = 1e20,
                               dtype=None) -> Tuple[ProblemData, Any]:
    """Build the static ProblemData template (bounds, masks, penalties,
    sparse-Jacobian pattern) + x0 for a jax-native Problem."""
    from .dtypes import resolve_dtype
    dtype = resolve_dtype(dtype)
    x0, lb, ub = problem.get_vars_and_bounds()
    x0 = jnp.asarray(x0, dtype)
    lb = jnp.asarray(lb, dtype)
    ub = jnp.asarray(ub, dtype)
    n, ncon, nwcon = problem.nvars, problem.ncon, problem.nwcon
    idx = np.arange(ncon)
    idxw = np.arange(nwcon)
    if nwcon > 0:
        Aw = problem.sparse_jacobian(x0)
        cols, vals = Aw.cols, jnp.asarray(Aw.vals, dtype)
        layout = kkt.detect_aw_layout(cols, n)
    else:
        cols = vals = None
        layout = "gather"
    d = ProblemData(
        g=jnp.zeros(n, dtype), A=jnp.zeros((ncon, n), dtype),
        c=jnp.zeros(ncon, dtype), cw=jnp.zeros(nwcon, dtype),
        lb=lb, ub=ub,
        lb_mask=(lb > -max_bound_value).astype(dtype),
        ub_mask=(ub < max_bound_value).astype(dtype),
        gamma_s=jnp.asarray(
            np.where(idx < problem.ninequality, 0.0, penalty_gamma), dtype),
        gamma_t=jnp.full((ncon,), penalty_gamma, dtype),
        gamma_sw=jnp.asarray(
            np.where(idxw < problem.nwinequality, 0.0, penalty_gamma), dtype),
        gamma_tw=jnp.full((nwcon,), penalty_gamma, dtype),
        Aw_cols=cols, Aw_vals=vals, nwblock=problem.nwblock,
        Aw_layout=layout)
    return d, x0


def fused_ip_optimize(problem, options=None):
    """Facade-style whole-solve on the fused IP for jax-native problems
    (`Optimizer(..., {"algorithm": "ip", "use_fused_loop": True})`).

    Maps the registry options onto `FusedIPOptions` (the same mapping the
    TR/MMA inner solvers use, `tr._fused_ip_options`), builds the
    model/data/QN state, runs the zero-round-trip `lax.while_loop` solve,
    and returns (result dict shaped like `InteriorPoint.optimize`,
    final `FusedState`)."""
    from .utils.options import make_options
    from .dtypes import resolve_dtype
    from .tr import _fused_ip_options
    from .ip import _resolve_qn_storage

    o = options if hasattr(options, "descriptors") else \
        make_options(options or {}, which="facade")
    dt = resolve_dtype(
        jnp.float64 if o["dtype"] == "float64" else jnp.float32)
    fopts = _fused_ip_options(
        o, o["barrier_strategy"], o["starting_point_strategy"],
        o["sequential_linear_method"])._replace(
        use_quasi_newton_update=not o["sequential_linear_method"])

    qn0 = None
    msub = qnmod.resolve_subspace_size(
        o["qn_subspace_size"], o["qn_subspace_auto"], problem.nvars, dt)
    if o["qn_type"] != "none" and not o["sequential_linear_method"] \
            and msub > 0:
        qn0 = qnmod.qn_init(
            msub, problem.nvars, dtype=dt,
            qn_type=o["qn_type"],
            storage_dtype=_resolve_qn_storage(o["qn_storage_dtype"], dt),
            update_type=o["qn_update_type"], diag_type=o["qn_diag_type"])

    model = model_from_problem(problem)
    data, x0 = data_template_from_problem(
        problem, penalty_gamma=o["penalty_gamma"],
        max_bound_value=o["max_bound_value"], dtype=dt)
    fused = FusedIP(model, problem.nvars, problem.ncon, problem.nwcon,
                    problem.nwblock, fopts, dtype=dt)
    # mid-solve writeOutput + checkpoint cadence at chunk boundaries
    # (`ParOptInteriorPoint.cpp:4620-4631`); with the default no-op
    # write_output this also gives the watchdog-safe chunked execution
    from .utils.chunked import make_write_output_hook, user_write_output
    hook = make_write_output_hook(user_write_output(problem),
                                  o["write_output_frequency"],
                                  get_x=lambda st: st.vars.x,
                                  checkpoint_path=o["ip_checkpoint_file"])
    # chunk='auto' ALWAYS: the watchdog-safe bounded device executions must
    # not depend on whether a write_output hook exists (user_write_output
    # returns None for the default no-op, which would otherwise select the
    # single unbounded while_loop)
    state = fused.solve(x0, data, (), qn0, None, jit_loop=True,
                        on_chunk=hook, chunk="auto")
    result = {
        "x": state.vars.x, "fobj": float(state.fobj),
        "converged": bool(state.converged),
        "reason": "tolerance" if bool(state.converged) else "max iterations",
        "niter": int(state.k), "neval": int(state.neval),
        # one gradient evaluation per accepted major iteration + init
        "ngeval": int(state.k) + 1,
        "res_norm": float(state.res_norm), "mu": float(state.mu),
    }
    return result, state
