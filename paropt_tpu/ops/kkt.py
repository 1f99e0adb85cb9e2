"""KKT system assembly and solution for the interior-point method.

This implements, accelerator-first, the role of the reference's KKT machinery
(`setUpKKTDiagSystem` `ParOptInteriorPoint.cpp:1832-1971`, algebra documented
at `:1973-2072`, quasi-definite matrix `src/ParOptSparseMat.{h,cpp}`, SMW
compact-QN correction `setUpKKTSystem` `:2634-2698`), but the algebra below is
re-derived from the perturbed KKT conditions of the elastic double-slack
formulation (`ParOptInteriorPoint.h:47-71`, slack setup `:343-374`):

    min f(x) + γ_s's + γ_t't + γ_sw'sw + γ_tw'tw
    s.t. c(x) - s + t = 0,  cw(x) - sw + tw = 0,
         s,t,sw,tw >= 0,    lb <= x <= ub

First-order conditions with barrier μ (multipliers z, zw for the equalities;
zs,zt,zsw,ztw for slack positivity; zl,zu for bounds):

    rx   = g - A'z - Aw'zw - zl + zu            = 0
    rs   = γ_s + z - zs                          = 0
    rt   = γ_t - z - zt                          = 0
    rsw  = γ_sw + zw - zsw                       = 0
    rtw  = γ_tw - zw - ztw                       = 0
    rc   = c - s + t                             = 0
    rcw  = cw - sw + tw                          = 0
    rzs  = S·zs - μe     rzt  = T·zt - μe
    rzsw = Sw·zsw - μe   rztw = Tw·ztw - μe
    rzl  = (X-Lb)·zl - μ_b e   rzu = (Ub-X)·zu - μ_b e

Newton elimination reduces to the 3x3 block system

    [H    -A'   -Aw'] [px ]   [bx ]         H  = B + Zl/(X-Lb) + Zu/(Ub-X)
    [A     Γ     0  ] [pz ] = [bc ]         Γ  = S/Zs + T/Zt        (diag, ncon)
    [Aw    0     C0 ] [pzw]   [bcw]         C0 = Sw/Zsw + Tw/Ztw    (diag, nwcon)

solved by (i) factoring the block-diagonal Cw = C0 + Aw·D⁻¹·Aw' (batched
Cholesky over [nblocks, nwblock, nwblock] — the reference's per-rank dpptrf,
`ParOptSparseMat.cpp:41-224`), (ii) an ncon×ncon replicated Schur complement
("Gmat"), and (iii) a Sherman-Morrison-Woodbury correction for the compact
quasi-Newton low-rank term B = b0·I - Z'M⁻¹Z ("Ce", 2q×2q).  Every multi-RHS
solve is batched so the design-axis work is a handful of [K, n] matmuls (one
fused all-reduce each when n is sharded).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..dtypes import full_precision


def is_blocked_pattern(cols, n) -> bool:
    """True when cols == arange(n).reshape(nwcon, k): the partition pattern
    whose Jacobian products are pure reshapes (no gather/scatter)."""
    import numpy as _np
    if cols is None:
        return False
    c = _np.asarray(cols)
    return c.size == n and bool(_np.array_equal(c.reshape(-1), _np.arange(n)))


def detect_aw_layout(cols, n) -> str:
    """Classify the sparse-Jacobian pattern:

    - 'blocked'   : cols == arange(n).reshape(nwcon, k) — contiguous blocks;
      products are reshapes to [..., nwcon, k] (minor dim k).
    - 'blocked_t' : cols[i, j] == i + j*nwcon — strided/transposed blocks;
      products are reshapes to [..., k, nwcon] with the LARGE axis minor
      (contiguous, coalesced accesses along n).
    - 'gather'    : anything else (general gather/scatter).
    """
    import numpy as _np
    if cols is None:
        return "gather"
    c = _np.asarray(cols)
    if c.size != n:
        return "gather"
    nwcon, k = c.shape
    if _np.array_equal(c.reshape(-1), _np.arange(n)):
        return "blocked"
    want = _np.arange(nwcon)[:, None] + _np.arange(k)[None, :] * nwcon
    if _np.array_equal(c, want):
        return "blocked_t"
    return "gather"


__all__ = ["IPVars", "ProblemData", "KKTFactor", "kkt_residual",
           "setup_kkt_factor", "solve_kkt", "apply_kkt_matrix",
           "recover_full_step", "max_step_lengths", "average_complementarity"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IPVars:
    """Full primal-dual state (the reference's ParOptVars,
    `ParOptInteriorPoint.h:373-389`). Also used for steps and residuals."""
    x: jnp.ndarray    # [n] design
    zl: jnp.ndarray   # [n] lower-bound multipliers
    zu: jnp.ndarray   # [n] upper-bound multipliers
    s: jnp.ndarray    # [ncon] positive elastic slack
    t: jnp.ndarray    # [ncon] negative elastic slack
    z: jnp.ndarray    # [ncon] dense-constraint multipliers
    zs: jnp.ndarray   # [ncon] multipliers for s >= 0
    zt: jnp.ndarray   # [ncon] multipliers for t >= 0
    sw: jnp.ndarray   # [nwcon]
    tw: jnp.ndarray   # [nwcon]
    zw: jnp.ndarray   # [nwcon]
    zsw: jnp.ndarray  # [nwcon]
    ztw: jnp.ndarray  # [nwcon]

    def axpy(self, alpha_x, alpha_z, p: "IPVars") -> "IPVars":
        """Primal step with alpha_x, dual step with alpha_z (the reference
        scales {x,s,t,sw,tw} by αx and duals by αz, `ParOptInteriorPoint.cpp:
        3196-3278`)."""
        return IPVars(
            x=self.x + alpha_x * p.x,
            zl=self.zl + alpha_z * p.zl,
            zu=self.zu + alpha_z * p.zu,
            s=self.s + alpha_x * p.s,
            t=self.t + alpha_x * p.t,
            z=self.z + alpha_z * p.z,
            zs=self.zs + alpha_z * p.zs,
            zt=self.zt + alpha_z * p.zt,
            sw=self.sw + alpha_x * p.sw,
            tw=self.tw + alpha_x * p.tw,
            zw=self.zw + alpha_z * p.zw,
            zsw=self.zsw + alpha_z * p.zsw,
            ztw=self.ztw + alpha_z * p.ztw)


def zero_vars(n: int, ncon: int, nwcon: int, dtype=None) -> IPVars:
    from ..dtypes import resolve_dtype
    dtype = resolve_dtype(dtype)
    zn = jnp.zeros(n, dtype=dtype)
    zc = jnp.zeros(ncon, dtype=dtype)
    zw = jnp.zeros(nwcon, dtype=dtype)
    return IPVars(x=zn, zl=zn, zu=zn, s=zc, t=zc, z=zc, zs=zc, zt=zc,
                  sw=zw, tw=zw, zw=zw, zsw=zw, ztw=zw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Problem quantities at the current point, all jit-traceable."""
    g: jnp.ndarray                  # [n] objective gradient
    A: jnp.ndarray                  # [ncon, n] dense constraint Jacobian
    c: jnp.ndarray                  # [ncon] dense constraint values
    cw: jnp.ndarray                 # [nwcon] sparse constraint values
    lb: jnp.ndarray                 # [n]
    ub: jnp.ndarray                 # [n]
    lb_mask: jnp.ndarray            # [n] 1.0 where the bound is active (finite)
    ub_mask: jnp.ndarray            # [n]
    gamma_s: jnp.ndarray            # [ncon] elastic penalties
    gamma_t: jnp.ndarray            # [ncon]
    gamma_sw: jnp.ndarray           # [nwcon]
    gamma_tw: jnp.ndarray           # [nwcon]
    Aw_cols: Optional[jnp.ndarray] = None   # [nwcon, k] sparse Jacobian indices
    Aw_vals: Optional[jnp.ndarray] = None   # [nwcon, k]
    nwblock: int = dataclasses.field(metadata=dict(static=True), default=1)
    # Pattern classification from detect_aw_layout(): 'gather' | 'blocked'
    # | 'blocked_t'.  Partition patterns lower to pure reshapes (no
    # gather/scatter); 'blocked_t' keeps the large axis minor.
    Aw_layout: str = dataclasses.field(metadata=dict(static=True),
                                       default="gather")
    # host-callback escape hatch (the reference's addSparseJacobian-style
    # user operators, `ParOptProblem.h:225-266`): a (matvec, rmatvec,
    # inner_blocks) triple of python functions.  Eager mode only.
    Aw_callbacks: Any = dataclasses.field(metadata=dict(static=True),
                                          default=None)

    @property
    def Aw_blocked(self):
        return self.Aw_layout in ("blocked", "blocked_t")

    @property
    def n(self):
        return self.g.shape[0]

    @property
    def ncon(self):
        return self.c.shape[0]

    @property
    def nwcon(self):
        return self.cw.shape[0]

    # -- sparse Jacobian products (static-shape gather/scatter; support a
    #    leading batch axis for the multi-RHS KKT solves) -------------------
    @property
    def _vals_t(self):
        """[k, nwcon] view of the values for the blocked_t layout."""
        return self.Aw_vals.T

    def Aw_matvec(self, px):
        """Aw @ px for px [..., n] -> [..., nwcon]."""
        if self.Aw_callbacks is not None:
            return self.Aw_callbacks[0](px)
        nwcon, k = self.Aw_cols.shape
        if self.Aw_layout == "blocked_t":
            shaped = px.reshape(px.shape[:-1] + (k, nwcon))
            return jnp.sum(self._vals_t * shaped, axis=-2)
        if self.Aw_layout == "blocked":
            shaped = px.reshape(px.shape[:-1] + (nwcon, k))
            return jnp.sum(self.Aw_vals * shaped, axis=-1)
        gathered = jnp.take(px, self.Aw_cols, axis=-1)  # [..., nwcon, k]
        return jnp.sum(self.Aw_vals * gathered, axis=-1)

    def Aw_rmatvec(self, pzw):
        """Aw' @ pzw for pzw [..., nwcon] -> [..., n]."""
        if self.Aw_callbacks is not None:
            return self.Aw_callbacks[1](pzw)
        nwcon, k = self.Aw_cols.shape
        if self.Aw_layout == "blocked_t":
            contrib = self._vals_t * pzw[..., None, :]  # [..., k, nwcon]
            return contrib.reshape(contrib.shape[:-2] + (self.n,))
        contrib = self.Aw_vals * pzw[..., :, None]      # [..., nwcon, k]
        if self.Aw_layout == "blocked":
            return contrib.reshape(contrib.shape[:-2] + (self.n,))
        flat = contrib.reshape(contrib.shape[:-2] + (-1,))
        idx = self.Aw_cols.reshape(-1)
        out = jnp.zeros(contrib.shape[:-2] + (self.n,), dtype=contrib.dtype)
        return out.at[..., idx].add(flat)

    def Aw_inner_blocks(self, d):
        """Blocks of Aw @ diag(d) @ Aw' -> [nblocks, nwblock, nwblock]."""
        nb = self.nwblock
        if self.Aw_callbacks is not None:
            return self.Aw_callbacks[2](d)
        nwcon, k = self.Aw_cols.shape
        if self.Aw_layout == "blocked_t" and nb == 1:
            dv = d.reshape(k, nwcon)
            return jnp.sum(self._vals_t ** 2 * dv, axis=0).reshape(-1, 1, 1)
        if self.Aw_layout == "blocked_t":
            dw = d.reshape(k, nwcon).T            # [nwcon, k]
        elif self.Aw_layout == "blocked":
            dw = d.reshape(self.Aw_cols.shape)    # [nwcon, k]
        else:
            dw = d[self.Aw_cols]                  # [nwcon, k]
        if nb == 1:
            return jnp.sum(self.Aw_vals ** 2 * dw, axis=1).reshape(-1, 1, 1)
        nblocks = self.nwcon // nb
        k = self.Aw_cols.shape[1]
        colsb = self.Aw_cols.reshape(nblocks, nb, k)
        valsb = self.Aw_vals.reshape(nblocks, nb, k)
        db = dw.reshape(nblocks, nb, k)
        eq = (colsb[:, :, None, :, None] == colsb[:, None, :, None, :])
        prod = (valsb * db)[:, :, None, :, None] * valsb[:, None, :, None, :]
        return jnp.sum(jnp.where(eq, prod, 0.0), axis=(3, 4))


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------


@full_precision
def kkt_residual(v: IPVars, d: ProblemData, mu, rel_bound_barrier: float = 1.0
                 ) -> IPVars:
    """Perturbed KKT residuals, packed into an IPVars-shaped pytree.

    Field mapping: .x=rx .zl=rzl .zu=rzu .s=rs .t=rt .z=rc .zs=rzs .zt=rzt
    .sw=rsw .tw=rtw .zw=rcw .zsw=rzsw .ztw=rztw  (residual of the equation
    *associated* with that variable's complementarity/stationarity).
    """
    mu_b = rel_bound_barrier * mu
    rx = d.g - d.A.T @ v.z - v.zl + v.zu
    if d.nwcon > 0:
        rx = rx - d.Aw_rmatvec(v.zw)
    rzl = (v.x - d.lb) * v.zl - mu_b
    rzl = jnp.where(d.lb_mask > 0, rzl, 0.0)
    rzu = (d.ub - v.x) * v.zu - mu_b
    rzu = jnp.where(d.ub_mask > 0, rzu, 0.0)
    rs = d.gamma_s + v.z - v.zs
    rt = d.gamma_t - v.z - v.zt
    rc = d.c - v.s + v.t
    rzs = v.s * v.zs - mu
    rzt = v.t * v.zt - mu
    rsw = d.gamma_sw + v.zw - v.zsw
    rtw = d.gamma_tw - v.zw - v.ztw
    rcw = d.cw - v.sw + v.tw
    rzsw = v.sw * v.zsw - mu
    rztw = v.tw * v.ztw - mu
    return IPVars(x=rx, zl=rzl, zu=rzu, s=rs, t=rt, z=rc, zs=rzs, zt=rzt,
                  sw=rsw, tw=rtw, zw=rcw, zsw=rzsw, ztw=rztw)


# ---------------------------------------------------------------------------
# diagonal KKT system + quasi-definite factorization
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KKTFactor:
    """Factored per-iteration KKT data (the combination of the reference's
    setUpKKTDiagSystem + setUpKKTSystem products)."""
    Dinv: jnp.ndarray                    # [n] inverse of diagonal H0
    Gamma: jnp.ndarray                   # [ncon]
    C0: jnp.ndarray                      # [nwcon]
    Cw_chol: Optional[jnp.ndarray]       # [nblocks, nwblock, nwblock] or None
    Xa: jnp.ndarray                      # [ncon, n] quasi-def solves of A rows
    Wa: Optional[jnp.ndarray]            # [ncon, nwcon]
    G_lu: Any                            # lu_factor of Gmat (ncon x ncon)
    # SMW (compact QN correction); None when B is purely diagonal
    Zqn: Optional[jnp.ndarray]           # [K, n]
    Phi_x: Optional[jnp.ndarray]         # [K, n]
    Phi_z: Optional[jnp.ndarray]         # [K, ncon]
    Phi_w: Optional[jnp.ndarray]         # [K, nwcon]
    Ce_inv: Any                          # explicit inverse of Ce (K x K):
    # one LU at setup, then every SMW correction is a matmul instead
    # of sequential triangular solves
    # host-side factor object for the general-CSR constraint path (the
    # ParOptQuasiDefSparseMat role); eager-mode only, never traced
    csr_solver: Any = dataclasses.field(metadata=dict(static=True),
                                        default=None)


def _bound_quotients(v: IPVars, d: ProblemData):
    ql = jnp.where(d.lb_mask > 0, v.zl / (v.x - d.lb), 0.0)
    qu = jnp.where(d.ub_mask > 0, v.zu / (d.ub - v.x), 0.0)
    return ql, qu


def _chol_solve_blocks(chol, b):
    """Batched lower-Cholesky solve: chol [nb, w, w], b [..., nwcon]."""
    nb, w, _ = chol.shape
    if w == 1:
        # nwblock == 1 fast path: Cw is diagonal, chol holds its sqrt
        return b / (chol[:, 0, 0] ** 2)
    bb = b.reshape(b.shape[:-1] + (nb, w, 1))
    cb = jnp.broadcast_to(chol, bb.shape[:-2] + (w, w))
    y = jax.scipy.linalg.solve_triangular(cb, bb, lower=True)
    out = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(cb, -1, -2), y, lower=False)
    return out[..., 0].reshape(b.shape)


@full_precision
def quasi_def_solve(f: "KKTFactor", d: ProblemData, bx, bw):
    """Solve [[D, -Aw'], [Aw, C0]] [yx; yw] = [bx; bw] via the block-diagonal
    Schur complement Cw = C0 + Aw·D⁻¹·Aw' (`ParOptSparseMat.cpp:41-224`).
    Batched over leading dims of bx [..., n] / bw [..., nwcon].

    With a `csr_solver` installed (general-CSR path), Cw is a general sparse
    matrix factored by the native host Cholesky — eager mode only."""
    if d.nwcon == 0:
        return f.Dinv * bx, bw
    rw = bw - d.Aw_matvec(f.Dinv * bx)
    if f.csr_solver is not None:
        import numpy as _np
        rw_np = _np.asarray(rw)
        if rw_np.ndim == 1:
            yw = jnp.asarray(f.csr_solver.solve(rw_np))
        else:
            yw = jnp.asarray(
                f.csr_solver.solve(_np.asfortranarray(rw_np.T)).T)
    else:
        yw = _chol_solve_blocks(f.Cw_chol, rw)
    yx = f.Dinv * (bx + d.Aw_rmatvec(yw))
    return yx, yw


@full_precision
def setup_kkt_factor(v: IPVars, d: ProblemData, qn_compact=None,
                     qn_sigma: float = 0.0, use_qn: bool = True,
                     csr_mat=None) -> KKTFactor:
    """Build all per-iteration factorizations.

    qn_compact: (b0, Z [K, n], M [K, K]) from `qn_compact()` or None for a
    pure-diagonal Hessian b0=qn_sigma... (sequential-linear / diag mode pass
    their diagonal via qn_compact=(diag_vec, None, None)).

    csr_mat: host-side general-CSR quasi-definite factor object with
    `.factor(Dinv, C0)` (eager mode only; the ParOptQuasiDefSparseMat role).
    """
    dtype = v.x.dtype
    ql, qu = _bound_quotients(v, d)
    if qn_compact is None:
        b0_diag = jnp.asarray(1.0, dtype=dtype)
        Zqn = Mqn = None
    else:
        b0, Zqn, Mqn = qn_compact
        b0_diag = b0
        if not use_qn:
            Zqn = Mqn = None
    H0 = b0_diag + qn_sigma + ql + qu
    Dinv = 1.0 / H0

    Gamma = v.s / v.zs + v.t / v.zt if d.ncon > 0 else jnp.zeros(0, dtype)

    if d.nwcon > 0 and csr_mat is not None:
        C0 = v.sw / v.zsw + v.tw / v.ztw
        csr_mat.factor(Dinv, C0)
        Cw_chol = None
    elif d.nwcon > 0:
        C0 = v.sw / v.zsw + v.tw / v.ztw
        nb = d.nwblock
        blocks = d.Aw_inner_blocks(Dinv)
        eye = jnp.eye(nb, dtype=dtype)
        Cw = blocks + C0.reshape(-1, nb)[:, :, None] * eye
        if nb == 1:
            # scalar blocks: "Cholesky" is an elementwise sqrt — avoids a
            # batched LAPACK/XLA cholesky over nwcon tiny problems
            Cw_chol = jnp.sqrt(Cw)
        else:
            Cw_chol = jnp.linalg.cholesky(Cw)
    else:
        C0 = jnp.zeros(0, dtype)
        Cw_chol = None

    # Schur complement over the dense multipliers: Gmat = Γ + A K_qd^{-1} A'
    ncon = d.ncon

    f0 = KKTFactor(Dinv=Dinv, Gamma=Gamma, C0=C0, Cw_chol=Cw_chol,
                   Xa=jnp.zeros((ncon, d.n), dtype), Wa=None, G_lu=None,
                   Zqn=None, Phi_x=None, Phi_z=None, Phi_w=None, Ce_inv=None,
                   csr_solver=csr_mat)
    if ncon > 0:
        zerow = jnp.zeros((ncon, d.nwcon), dtype)
        Xa, Wa = quasi_def_solve(f0, d, d.A, zerow)  # batched: [ncon, n]
        Gmat = jnp.diag(Gamma) + d.A @ Xa.T
        if ncon == 1:
            # closed-form inverse avoids a sequential LU on the device for the
            # common single-dense-constraint case; consumers branch on the
            # static ncon
            G_lu = 1.0 / Gmat
        elif ncon == 2:
            det = Gmat[0, 0] * Gmat[1, 1] - Gmat[0, 1] * Gmat[1, 0]
            G_lu = jnp.array([[Gmat[1, 1], -Gmat[0, 1]],
                              [-Gmat[1, 0], Gmat[0, 0]]]) / det
        else:
            G_lu = jax.scipy.linalg.lu_factor(Gmat)
    else:
        Xa = jnp.zeros((0, d.n), dtype)
        Wa = jnp.zeros((0, d.nwcon), dtype)
        G_lu = None

    f1 = dataclasses.replace(f0, Xa=Xa, Wa=Wa, G_lu=G_lu)

    # SMW correction for the compact quasi-Newton low-rank term:
    # K = K0 - Ẑ M^{-1} Ẑ'  with  Ẑ = [Z'; 0; 0]  =>
    # K^{-1} = K0^{-1} + K0^{-1} Ẑ Ce^{-1} Ẑ' K0^{-1},  Ce = M - Z K0x^{-1} Z'
    # (the role of the reference's Ce, `ParOptInteriorPoint.cpp:2634-2698`).
    if Zqn is not None and Zqn.shape[0] > 0:
        K = Zqn.shape[0]
        zc = jnp.zeros((K, ncon), dtype)
        zw = jnp.zeros((K, d.nwcon), dtype)
        Phi_x, Phi_z, Phi_w = _solve_diag3(f1, d, Zqn, zc, zw)
        Ce = Mqn - Zqn @ Phi_x.T
        Ce_inv = jnp.linalg.inv(Ce)
        # narrow QN storage (qn_init storage_dtype): the Phi stacks carry
        # the same bandwidth weight as Z — store them in Z's dtype too
        # (Ce above is formed from the full-precision solve results first)
        if Zqn.dtype != dtype:
            Phi_x = Phi_x.astype(Zqn.dtype)
            Phi_z = Phi_z.astype(Zqn.dtype)
            Phi_w = Phi_w.astype(Zqn.dtype)
        return dataclasses.replace(f1, Zqn=Zqn, Phi_x=Phi_x, Phi_z=Phi_z,
                                   Phi_w=Phi_w, Ce_inv=Ce_inv)
    return f1


def _solve_diag3(f: KKTFactor, d: ProblemData, bx, bc, bw):
    """Solve the 3x3 diagonal-Hessian KKT system
    [[H0, -A', -Aw'], [A, Γ, 0], [Aw, 0, C0]] p = [bx; bc; bw].
    Batched over a leading axis when present."""
    px0, pw0 = quasi_def_solve(f, d, bx, bw)
    if d.ncon > 0:
        rhs = bc - px0 @ d.A.T if bx.ndim > 1 else bc - d.A @ px0
        if d.ncon <= 2:
            pz = rhs @ f.G_lu.T if bx.ndim > 1 else f.G_lu @ rhs
        else:
            pz = jax.scipy.linalg.lu_solve(f.G_lu, rhs.T).T \
                if bx.ndim > 1 else jax.scipy.linalg.lu_solve(f.G_lu, rhs)
        px = px0 + pz @ f.Xa if bx.ndim > 1 else px0 + f.Xa.T @ pz
        pw = pw0 + pz @ f.Wa if bx.ndim > 1 else pw0 + f.Wa.T @ pz
    else:
        pz = bc
        px, pw = px0, pw0
    return px, pz, pw


def _solve_reduced(f: KKTFactor, d: ProblemData, bx, bc, bw):
    """Full reduced solve including the SMW quasi-Newton correction."""
    px, pz, pw = _solve_diag3(f, d, bx, bc, bw)
    if f.Zqn is not None:
        w = f.Zqn @ px
        y = f.Ce_inv @ w
        px = px + f.Phi_x.T @ y
        pz = pz + f.Phi_z.T @ y
        pw = pw + f.Phi_w.T @ y
    return px, pz, pw


@full_precision
def reduced_rhs(v: IPVars, d: ProblemData, r: IPVars):
    """Condense the full Newton residual system K p = -r to the 3x3 system
    right-hand sides (bx, bc, bcw) via the slack/bound eliminations."""
    ql_den = jnp.where(d.lb_mask > 0, v.x - d.lb, 1.0)
    qu_den = jnp.where(d.ub_mask > 0, d.ub - v.x, 1.0)
    bx = -r.x - jnp.where(d.lb_mask > 0, r.zl / ql_den, 0.0) \
        + jnp.where(d.ub_mask > 0, r.zu / qu_den, 0.0)
    bc = -r.z - (r.zs + v.s * r.s) / v.zs + (r.zt + v.t * r.t) / v.zt
    bcw = -r.zw - (r.zsw + v.sw * r.sw) / v.zsw \
        + (r.ztw + v.tw * r.tw) / v.ztw
    return bx, bc, bcw


@full_precision
def recover_full_step(v: IPVars, d: ProblemData, r: IPVars,
                      px, pz, pzw) -> IPVars:
    """Back-substitute the eliminated variables given (px, pz, pzw)."""
    ql_den = jnp.where(d.lb_mask > 0, v.x - d.lb, 1.0)
    qu_den = jnp.where(d.ub_mask > 0, d.ub - v.x, 1.0)
    pzl = jnp.where(d.lb_mask > 0, -(r.zl + v.zl * px) / ql_den, -v.zl)
    pzu = jnp.where(d.ub_mask > 0, -(r.zu - v.zu * px) / qu_den, -v.zu)
    pzs = pz + r.s
    pzt = r.t - pz
    ps = -(r.zs + v.s * pzs) / v.zs
    pt = -(r.zt + v.t * pzt) / v.zt
    pzsw = pzw + r.sw
    pztw = r.tw - pzw
    psw = -(r.zsw + v.sw * pzsw) / v.zsw
    ptw = -(r.ztw + v.tw * pztw) / v.ztw
    return IPVars(x=px, zl=pzl, zu=pzu, s=ps, t=pt, z=pz, zs=pzs, zt=pzt,
                  sw=psw, tw=ptw, zw=pzw, zsw=pzsw, ztw=pztw)


@full_precision
def solve_kkt(v: IPVars, d: ProblemData, f: KKTFactor, r: IPVars,
              refine_steps: int = 0, qn_compact=None) -> IPVars:
    """Solve the Newton system K p = -r for the full step pytree, with
    optional iterative refinement (`ParOptInteriorPoint.cpp:4985-4991`)."""
    bx, bc, bcw = reduced_rhs(v, d, r)
    px, pz, pzw = _solve_reduced(f, d, bx, bc, bcw)
    p = recover_full_step(v, d, r, px, pz, pzw)
    for _ in range(refine_steps):
        Kp = apply_kkt_matrix(v, d, p, qn_compact)
        rr = jax.tree_util.tree_map(lambda ri, kpi: -ri - kpi, r, Kp)
        bx, bc, bcw = reduced_rhs(v, d, _negate(rr))
        dx, dz, dzw = _solve_reduced(f, d, bx, bc, bcw)
        dp = recover_full_step(v, d, _negate(rr), dx, dz, dzw)
        p = jax.tree_util.tree_map(jnp.add, p, dp)
    return p


def _negate(t):
    return jax.tree_util.tree_map(jnp.negative, t)


@full_precision
def apply_kkt_matrix(v: IPVars, d: ProblemData, p: IPVars,
                     qn_compact=None, qn_sigma: float = 0.0,
                     hvp: Optional[jnp.ndarray] = None) -> IPVars:
    """Apply the full Newton/KKT matrix K to a step pytree p, returning an
    IPVars-shaped product with the same field mapping as `kkt_residual`.
    Used for iterative refinement and the checkKKTStep-style verification
    (`ParOptInteriorPoint.cpp:6212+`).  The Hessian block is B·px from the
    compact QN (or an explicit Hessian-vector product ``hvp``)."""
    if hvp is not None:
        Bpx = hvp + qn_sigma * p.x
    elif qn_compact is not None:
        b0, Z, M = qn_compact
        Bpx = (b0 + qn_sigma) * p.x
        if Z is not None and Z.shape[0] > 0:
            Bpx = Bpx - Z.T @ jnp.linalg.solve(M, Z @ p.x)
    else:
        Bpx = (1.0 + qn_sigma) * p.x
    kx = Bpx - d.A.T @ p.z - p.zl + p.zu
    if d.nwcon > 0:
        kx = kx - d.Aw_rmatvec(p.zw)
    kzl = jnp.where(d.lb_mask > 0, v.zl * p.x + (v.x - d.lb) * p.zl, p.zl)
    kzu = jnp.where(d.ub_mask > 0, -v.zu * p.x + (d.ub - v.x) * p.zu, p.zu)
    ks = p.z - p.zs
    kt = -p.z - p.zt
    kc = d.A @ p.x - p.s + p.t
    kzs = v.zs * p.s + v.s * p.zs
    kzt = v.zt * p.t + v.t * p.zt
    ksw = p.zw - p.zsw
    ktw = -p.zw - p.ztw
    kcw = (d.Aw_matvec(p.x) if d.nwcon > 0 else
           jnp.zeros(0, p.x.dtype)) - p.sw + p.tw
    kzsw = v.zsw * p.sw + v.sw * p.zsw
    kztw = v.ztw * p.tw + v.tw * p.ztw
    return IPVars(x=kx, zl=kzl, zu=kzu, s=ks, t=kt, z=kc, zs=kzs, zt=kzt,
                  sw=ksw, tw=ktw, zw=kcw, zsw=kzsw, ztw=kztw)


# ---------------------------------------------------------------------------
# step-length computation
# ---------------------------------------------------------------------------


def _max_alpha_pos(val, step, tau, mask=None):
    """max α ∈ (0, 1] keeping val + α·step >= (1-τ)·val (val > 0)."""
    ratio = jnp.where(step < 0, -tau * val / jnp.where(step < 0, step, -1.0),
                      jnp.inf)
    if mask is not None:
        ratio = jnp.where(mask > 0, ratio, jnp.inf)
    if ratio.size == 0:
        return jnp.asarray(jnp.inf, dtype=val.dtype)
    return jnp.min(ratio)


def max_step_lengths(v: IPVars, d: ProblemData, p: IPVars, tau):
    """Fraction-to-boundary maximum primal/dual steps (`computeMaxStep`,
    `ParOptInteriorPoint.cpp:2942-3106`): one fused reduction each."""
    one = jnp.asarray(1.0, dtype=v.x.dtype)
    ax = jnp.minimum(one, _max_alpha_pos(v.x - d.lb, p.x, tau, d.lb_mask))
    ax = jnp.minimum(ax, _max_alpha_pos(d.ub - v.x, -p.x, tau, d.ub_mask))
    for val, st in ((v.s, p.s), (v.t, p.t), (v.sw, p.sw), (v.tw, p.tw)):
        ax = jnp.minimum(ax, _max_alpha_pos(val, st, tau))
    az = one
    for val, st in ((v.zl, p.zl), (v.zu, p.zu), (v.zs, p.zs), (v.zt, p.zt),
                    (v.zsw, p.zsw), (v.ztw, p.ztw)):
        mask = None
        if val is v.zl:
            mask = d.lb_mask
        elif val is v.zu:
            mask = d.ub_mask
        az = jnp.minimum(az, _max_alpha_pos(val, st, tau, mask))
    return ax, az


def average_complementarity(v: IPVars, d: ProblemData):
    """Average complementarity products (`computeComp`,
    `ParOptInteriorPoint.cpp:2742+`)."""
    total = (jnp.sum(jnp.where(d.lb_mask > 0, (v.x - d.lb) * v.zl, 0.0))
             + jnp.sum(jnp.where(d.ub_mask > 0, (d.ub - v.x) * v.zu, 0.0)))
    count = jnp.sum(d.lb_mask) + jnp.sum(d.ub_mask)
    if d.ncon > 0:
        total = total + jnp.sum(v.s * v.zs) + jnp.sum(v.t * v.zt)
        count = count + 2.0 * d.ncon
    if d.nwcon > 0:
        total = total + jnp.sum(v.sw * v.zsw) + jnp.sum(v.tw * v.ztw)
        count = count + 2.0 * d.nwcon
    return total / jnp.maximum(count, 1.0)
