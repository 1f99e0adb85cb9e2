"""Frequency-constrained SIMP topology optimization — the compact
eigenvalue-approximation path (`ParOptCompactEigenvalueApprox.{h,cpp}`,
`examples/eigenvalue/eigenvalue_opt.py`) exercised on the reference's real
workload class (continuum topology), accelerator-first:

    min   mass(x) = mean(xf)
    s.t.  KS_min(lam(x)) >= lam_target            (one dense constraint)
          lb <= x <= 1

where lam are the N lowest natural-frequency eigenvalues of the generalized
problem  K(x) phi = lam M(x) phi  on a 2-D plane-stress cantilever
(K: SIMP-penalized stiffness, M: lumped diagonal mass), aggregated with a
Kreisselmeier–Steinhauser minimum over the normalized gaps
g_i = (lam_i - lam_target)/lam_target:

    KS = min_i g_i - log(sum_i exp(-rho (g_i - min g))) / rho  >= 0.

accelerator-first implementation choices:

- **Matrix-free shift-inverted LOBPCG**: the N lowest eigenpairs come from
  the LARGEST eigenvalues of S = M^{1/2} K^{-1} M^{1/2} (lam = 1/mu,
  v = M^{1/2} phi so unit v gives the M-normalization phi' M phi = 1).
  S is applied as (sqrt-mass scale) ∘ (blocked diagonal-preconditioned CG)
  ∘ (sqrt-mass scale) — each CG matvec is the same [ne, 8] batched element
  matmul as the static path; `lobpcg_standard` block iterations are
  matmul-shaped. No matrix is ever assembled.
- **Analytic eigenvalue sensitivities** (no differentiation through the
  eigensolve): dlam_i/dxf_e = phi_e' dK_e phi_e - lam_i phi_e' dM_e phi_e,
  both element-local batched contractions; the linear density filter is
  chained by one vjp.
- The per-point eigensolve is ONE jitted XLA computation returning
  (lam[N], W[N, nvars]); the cheap KS reduction runs host-side in f64 so
  the aggregate is overflow-safe at large rho.

Use with the eigenvalue trust-region path (mirrors
`eigenvalue_opt.py:281-306`):

    prob = FrequencyTopology(...)
    eigh = CompactEigenApprox(prob.nvars, N=prob.N)
    eqn = EigenQuasiNewton(qn_init(10, prob.nvars), eigh, index=0)
    sub = EigenSubproblem(prob, eqn)
    sub.set_eigen_model_update(prob.update_eigen_model)
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.sparse.linalg import lobpcg_standard

from ..problem import Problem
from .fem_topology import FEMTopology

__all__ = ["FrequencyTopology", "FrequencyTopology3D"]


class _FrequencyBase(Problem):
    """Dimension-independent KS-aggregate / eigen-model plumbing shared by
    the 2-D and 3-D frequency-constrained models.  Subclasses set
    `self.fem`, `self._eig_fn` (x -> (lam[N], W[N, nvars])), `self.N`,
    `self.ks_rho`, `self.lam_target`, `self.lb`, `self._dtype`."""

    def _minv_floor(self):
        """Relative eigenvalue floor for the regularized KS-curvature
        inverse: bounds cond(M) (and cond(Minv)) by 1/floor so the merged
        compact's small-matrix solves stay accurate in the COMPUTE dtype.
        f64 keeps the historical 1e-8; f32 needs ~1e3 eps (cond <= 1e4) —
        see update_eigen_model's docstring for the failure this guards."""
        eps = float(jnp.finfo(self._dtype).eps)
        return max(1e-8, 1e3 * eps)

    def _eval(self, x):
        """Cached per-point eigensolve + host-side f64 KS reduction."""
        x = jnp.asarray(x, self._dtype)
        key = np.asarray(x).tobytes()
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        lam, W, _ = self._eig_fn(x, None)
        lam64 = np.asarray(lam, np.float64)
        g = (lam64 - self.lam_target) / self.lam_target
        gmin = g.min()
        eta = np.exp(-self.ks_rho * (g - gmin))
        beta = eta.sum()
        eta /= beta
        ks = gmin - np.log(beta) / self.ks_rho
        dks = (eta @ np.asarray(W, np.float64)) / self.lam_target
        out = {"lam": lam64, "W": np.asarray(W, np.float64),
               "ks": ks, "dks": dks, "eta": eta}
        # keep only the two live points (current + trial)
        if len(self._cache) >= 2:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = out
        return out

    # -- Problem surface (reference-style overrides: the constraint is not
    #    autodiff-able through the eigensolve) ---------------------------
    def objective(self, x):
        return jnp.mean(self.fem._filter(x))

    def eval_obj_con(self, x):
        ev = self._eval(x)
        return self.objective(x), jnp.asarray([ev["ks"]], self._dtype)

    def eval_obj_con_gradient(self, x):
        ev = self._eval(x)
        g = jax.grad(self.objective)(jnp.asarray(x, self._dtype))
        A = jnp.asarray(ev["dks"], self._dtype)[None, :]
        return g, A

    def get_vars_and_bounds(self):
        n = self.nvars
        return (jnp.ones(n, self._dtype), jnp.full(n, self.lb, self._dtype),
                jnp.ones(n, self._dtype))

    # -- eigen-model refresh callback (`updateModel`,
    #    eigenvalue_opt.py:269-306 analogue) -----------------------------
    def update_eigen_model(self, x, eigh) -> None:
        """Refresh the low-rank quadratic KS model at an accepted point:
        hvecs = per-eigenvalue gradients W, M = KS curvature w.r.t. the
        eigenvalues, rho/lam_t^2 (eta eta' - diag eta)  (rank N-1, NSD).

        The inverse is REGULARIZED, not pinv'd: when one mode dominates,
        eta collapses and M's entries underflow toward 0, so a raw
        pinv produces ~1/eps entries that overflow the compact-form block
        solves (observed: NaN objective model at x0). Clamping M's (all
        non-positive) eigenvalues at -floor keeps Minv NSD and bounded, so
        the merged Hessian contribution -z0 h'Mh stays PSD and finite —
        the regularization only adds a negligible curvature floor in
        directions where the KS aggregate is genuinely linear.

        The floor is DTYPE-AWARE (`_minv_floor`): scale = ks_rho /
        lam_target^2 reaches ~5e10 on fine 3-D meshes (lam ~ h^2), and a
        fixed 1e-8 relative floor leaves cond(M) ~ 1e8 — garbage linear
        solves in f32 that turn the merged compact indefinite and NaN the
        inner QP's quasi-definite Cholesky (observed: 64x32x32 fused
        eigen-TR in f32 frozen at mass=1.0 with rho=nan)."""
        ev = self._eval(x)
        eta = ev["eta"]
        scale = self.ks_rho / self.lam_target ** 2
        M = scale * (np.outer(eta, eta) - np.diag(eta))
        e, Q = np.linalg.eigh(0.5 * (M + M.T))
        e = np.minimum(e, -self._minv_floor() * scale)
        Minv = (Q / e) @ Q.T
        eigh.set_approximation(M=jnp.asarray(M, self._dtype),
                               Minv=jnp.asarray(Minv, self._dtype),
                               hvecs=jnp.asarray(ev["W"], self._dtype))

    def eval_full(self, x, V0=None):
        """Jit-traceable combined evaluation for the FUSED eigen-TR path
        (`eig_fused.FusedEigenTR`): ONE eigensolve yields the objective,
        the KS constraint, both gradients, AND the refreshed low-rank
        curvature model (M, Minv, hvecs) — so a trial evaluation and the
        accepted-step model refresh share the LOBPCG. Unlike `_eval`, the
        KS reduction runs in the compute dtype (N max-shifted values —
        safe in f32); the Minv regularization mirrors
        `update_eigen_model`.

        ``V0`` WARM-STARTS the LOBPCG from a previous eigenbasis (in the
        old point's M^(1/2) coordinates — still an excellent subspace
        initializer under smooth mass changes).  Warm solves run under the
        SAME `lobpcg_iters` budget as cold ones: LOBPCG's residual-based
        while_loop exit makes a converged warm basis cost ~1 block
        iteration while an under-converged one (large rejected step)
        continues toward the cold budget.  The fused TR threads the
        accepted basis through its state.  Returns (..., V) — the basis
        to thread."""
        x = jnp.asarray(x, self._dtype)
        lam, W, V = self._eig_fn(x, V0)
        g = (lam - self.lam_target) / self.lam_target
        gmin = jnp.min(g)
        eta = jnp.exp(-self.ks_rho * (g - gmin))
        beta = jnp.sum(eta)
        eta = eta / beta
        ks = gmin - jnp.log(beta) / self.ks_rho
        dks = (eta @ W) / self.lam_target
        fobj = self.objective(x)
        gobj = jax.grad(self.objective)(x)
        scale = self.ks_rho / self.lam_target ** 2
        M = scale * (jnp.outer(eta, eta) - jnp.diag(eta))
        e, Q = jnp.linalg.eigh(0.5 * (M + M.T))
        e = jnp.minimum(e, -self._minv_floor() * scale)
        Minv = (Q / e) @ Q.T
        return (fobj, jnp.asarray([ks], self._dtype), gobj,
                dks[None, :], M, Minv, W, V)

    def build_fused_tr(self, options=None, eig_row_model="linear"):
        """Whole-loop on-device eigen TR (`eig_fused.FusedEigenTR`) with
        the same b0 = 1/nvars seeding rationale as
        `build_tr_subproblem`."""
        from ..eig_fused import FusedEigenTR
        return FusedEigenTR(self, options, index=0,
                            qn_b0=1.0 / self.nvars,
                            eig_row_model=eig_row_model)

    # -- subproblem wiring -------------------------------------------------
    def build_tr_subproblem(self, msub: int = 10):
        """Wire the eigenvalue TR subproblem (`eigenvalue_opt.py:281-306`
        boilerplate) with the model refreshed at x0.

        The inner quasi-Newton starts from b0 = 1/nvars, NOT the default 1:
        the mass objective is LINEAR with per-element gradient 1/nvars, so
        while the frequency constraint is slack the Lagrangian gradient
        change y is ~0, every curvature update is skipped, and b0 never
        adapts — with b0 = 1 the inner QP then takes gradient-sized
        (1/nvars) steps and the descent rate scales as 1/nvars (observed:
        a 48x24 mesh crawling at 1e-3 mass per TR iteration).  Matching b0
        to the gradient scale makes the early, constraint-slack phase take
        trust-region-sized steps."""
        from ..eig import CompactEigenApprox, EigenQuasiNewton, \
            EigenSubproblem
        from ..ops import qn as qnmod

        eigh = CompactEigenApprox(nvars=self.nvars, N=self.N,
                                  dtype=self._dtype)
        qn0 = qnmod.qn_init(msub, self.nvars, dtype=self._dtype,
                            b0=1.0 / self.nvars)
        eqn = EigenQuasiNewton(qn0, eigh, index=0)
        sub = EigenSubproblem(self, eqn)
        sub.set_eigen_model_update(self.update_eigen_model)
        x0, _, _ = self.get_vars_and_bounds()
        _, c0 = self.eval_obj_con(x0)
        _, A0 = self.eval_obj_con_gradient(x0)
        eigh.set_approximation(c0=c0[0], g0=A0[0])
        self.update_eigen_model(x0, eigh)
        return sub, eigh

    # -- reporting -------------------------------------------------------
    def frequencies(self, x):
        """The N lowest natural frequencies sqrt(lam) at x."""
        return np.sqrt(np.maximum(self._eval(x)["lam"], 0.0))


class FrequencyTopology(_FrequencyBase):
    def __init__(self, nex: int = 32, ney: int = 16, N: int = 6,
                 ks_rho: float = 30.0, freq_fraction: float = 0.5,
                 rho_min: float = 0.025, lb: float = 0.05,
                 cg_iters: int = 200, lobpcg_iters: int = 60,
                 lobpcg_warm_iters: Optional[int] = None,
                 filter_radius: int = 1, solver: str = "jacobi",
                 dtype=None, seed: int = 0):
        super().__init__(nvars=nex * ney, ncon=1)
        from ..dtypes import resolve_dtype
        dt = resolve_dtype(dtype)
        self._dtype = dt
        # reuse the static model's mesh/element/CG machinery (composition,
        # like DMOFEMTopology)
        self.fem = FEMTopology(nex=nex, ney=ney, cg_iters=cg_iters,
                               filter_radius=filter_radius, solver=solver,
                               dtype=dt)
        self.N = N
        self.ks_rho = float(ks_rho)
        self.rho_min = float(rho_min)
        self.lb = float(lb)
        self.lobpcg_iters = int(lobpcg_iters)
        # superseded: warm starts now run under the full lobpcg_iters
        # budget and rely on LOBPCG's residual-based early stopping
        # (kept for API compatibility)
        self.lobpcg_warm_iters = int(lobpcg_warm_iters
                                     if lobpcg_warm_iters is not None
                                     else max(10, lobpcg_iters // 2))

        # deterministic LOBPCG start block, zeroed on fixed dofs
        rng = np.random.default_rng(seed)
        X0 = rng.standard_normal((self.fem.ndof, N))
        X0[np.asarray(self.fem.fixed_mask) > 0, :] = 0.0
        self._X0 = jnp.asarray(X0, dt)

        self._eig_fn = jax.jit(self._make_eig_fn())
        self._cache = {}

        # frequency target: a fraction of the full-material fundamental
        # eigenvalue, so x0 = 1 is strictly feasible and mass can be cut
        # until the constraint activates
        x0 = jnp.ones(self.nvars, dt)
        lam_full, _, _ = self._eig_fn(x0, None)
        self.lam_target = freq_fraction * float(lam_full[0])

    # -- eigensolve ------------------------------------------------------
    def _mass_diag(self, xf):
        """Lumped mass diagonal: element mass rho_e (unit area) split over
        its 4 nodes, applied to both dofs of each node."""
        rho = self.rho_min + xf * (1.0 - self.rho_min)
        m = self.fem._scatter_elem(
            jnp.broadcast_to((rho / 4.0)[:, None], (rho.shape[0], 8)))
        return jnp.where(self.fem.fixed_mask > 0, 0.0, m)

    def _make_eig_fn(self):
        fem = self.fem
        hi = jax.lax.Precision.HIGHEST

        def simp(xf):
            return fem.emin + xf ** fem.penal * (fem.e0 - fem.emin)

        def eig_fn(x, V0=None):
            # full-precision matmuls for EVERY caller (default-precision
            # f32 matmuls may take reduced-precision inputs on an
            # accelerator — TF32 on GPUs — which degrades the dense
            # Rayleigh-Ritz
            # projections inside LOBPCG): applying the context here covers
            # lam_target calibration, the host path, and frequencies()
            # rather than relying on call-site wrapping
            with jax.default_matmul_precision("highest"):
                return _eig_body(x, V0)

        def _eig_body(x, V0):
            xf, filt_vjp = jax.vjp(fem._filter, x)
            E = simp(xf)
            m = self._mass_diag(xf)
            msqrt = jnp.sqrt(m)

            def S(vblock):                      # [ndof, k] -> [ndof, k]
                b = msqrt[:, None] * vblock
                u = jax.vmap(lambda col: fem._cg(E, col),
                             in_axes=1, out_axes=1)(b)
                return msqrt[:, None] * u

            X = self._X0 if V0 is None else V0
            # WARM starts get the full iteration budget: lobpcg_standard's
            # lax.while_loop stops at its residual self-consistency test,
            # so a good warm basis costs ~1 block iteration (measured 1/60
            # f32, 23/60 f64 after a small design step vs 5/60, 37/60
            # cold) while an under-converged warm solve (e.g. after a
            # large rejected step) continues toward the cold budget —
            # accuracy is monitored, not assumed
            mu, V, _ = lobpcg_standard(S, X, m=self.lobpcg_iters)
            lam = 1.0 / mu                      # ascending: lam[0] smallest
            # phi = M^{-1/2} v; unit v gives phi' M phi = 1
            phi = jnp.where(msqrt[:, None] > 0, V / msqrt[:, None], 0.0)

            # analytic sensitivities, element-local:
            #   dlam/dxf_e = dE_e (phi_e' k0 phi_e) - lam (drho/4) sum phi_e^2
            phie = jax.vmap(fem._gather_elem)(phi.T)   # [N, ne, 8]
            kterm = jnp.sum(jnp.matmul(phie, fem.KE, precision=hi) * phie,
                            axis=-1)            # [N, ne]
            mterm = jnp.sum(phie * phie, axis=-1) / 4.0
            dE = fem.penal * xf ** (fem.penal - 1.0) * (fem.e0 - fem.emin)
            Wf = dE[None, :] * kterm \
                - lam[:, None] * (1.0 - self.rho_min) * mterm
            W = jax.vmap(lambda w: filt_vjp(w)[0])(Wf)   # chain the filter
            return lam, W, V

        return eig_fn


class FrequencyTopology3D(_FrequencyBase):
    """3-D frequency-constrained voxel SIMP — the reference's flagship
    eigenvalue application scale ("1M+ var topology problem w/ compact
    eigenvalue approx", `examples/eigenvalue/eigenvalue_opt.py` +
    `docs/ParOpt_theory_manual.tex:27-28`):

        min   mass(x) = mean(xf)
        s.t.  KS_min(lam(x)) >= lam_target
              lb <= x <= 1

    on the 8-node hex voxel cantilever.  Same matrix-free shift-inverted
    LOBPCG recipe as the 2-D model, but every per-iteration kernel is the
    grid-form (SoA) stencil: the CG state solves via FEMTopology3D's
    grid path, the stiffness sensitivity phi' dK phi via _energy_grid,
    and the mass terms via corner-slice sums — no [ne, 24]
    materialization anywhere in the eigensolve."""

    def __init__(self, nex: int = 16, ney: int = 8, nez: int = 8,
                 N: int = 6, ks_rho: float = 30.0,
                 freq_fraction: float = 0.5, rho_min: float = 0.025,
                 lb: float = 0.05, cg_iters: int = 30,
                 lobpcg_iters: int = 60,
                 lobpcg_warm_iters: Optional[int] = None,
                 solver: str = "mgcg", layout: str = "auto",
                 dtype=None, seed: int = 0):
        super().__init__(nvars=nex * ney * nez, ncon=1)
        from ..dtypes import resolve_dtype
        from .fem_topology3d import FEMTopology3D
        dt = resolve_dtype(dtype)
        self._dtype = dt
        self.fem = FEMTopology3D(nex=nex, ney=ney, nez=nez,
                                 cg_iters=cg_iters, solver=solver,
                                 layout=layout, dtype=dt)
        self.N = N
        self.ks_rho = float(ks_rho)
        self.rho_min = float(rho_min)
        self.lb = float(lb)
        self.lobpcg_iters = int(lobpcg_iters)
        # superseded: warm starts now run under the full lobpcg_iters
        # budget and rely on LOBPCG's residual-based early stopping
        # (kept for API compatibility)
        self.lobpcg_warm_iters = int(lobpcg_warm_iters
                                     if lobpcg_warm_iters is not None
                                     else max(10, lobpcg_iters // 2))

        rng = np.random.default_rng(seed)
        X0 = rng.standard_normal((self.fem.ndof, N))
        X0[np.asarray(self.fem.fixed_mask) > 0, :] = 0.0
        self._X0 = jnp.asarray(X0, dt)

        self._eig_fn = jax.jit(self._make_eig_fn())
        self._cache = {}

        x0 = jnp.ones(self.nvars, dt)
        lam_full, _, _ = self._eig_fn(x0, None)
        self.lam_target = freq_fraction * float(lam_full[0])

    def _mass_grids(self, xf):
        """(node mass diag as [3, nnx, nny, nnz] grid, flat [ndof]):
        element mass rho_e split over its 8 nodes, all 3 dofs/node."""
        from .fem_topology3d import _CORNERS3D, _from_grid3
        fem = self.fem
        rho = self.rho_min + xf * (1.0 - self.rho_min)
        rg = rho.reshape(fem.nex, fem.ney, fem.nez) / 8.0
        m = None
        for a, b, c in _CORNERS3D:
            t = jnp.pad(rg, ((a, 1 - a), (b, 1 - b), (c, 1 - c)))
            m = t if m is None else m + t
        mg = jnp.where(fem._fixed_g > 0, 0.0,
                       jnp.broadcast_to(m[None], fem._fixed_g.shape))
        return mg, _from_grid3(mg)

    def _make_eig_fn(self):
        from .fem_topology3d import _CORNERS3D, _sl, _to_grid3
        fem = self.fem
        nnx, nny, nnz = fem.nex + 1, fem.ney + 1, fem.nez + 1

        def simp(xf):
            return fem.emin + xf ** fem.penal * (fem.e0 - fem.emin)

        def eig_fn(x, V0=None):
            # full-precision matmuls for every caller (see the 2-D model)
            with jax.default_matmul_precision("highest"):
                return _eig_body(x, V0)

        def _eig_body(x, V0):
            xf, filt_vjp = jax.vjp(fem._filter, x)
            E = simp(xf)
            _, m = self._mass_grids(xf)
            msqrt = jnp.sqrt(m)

            def S(vblock):                      # [ndof, k] -> [ndof, k]
                b = msqrt[:, None] * vblock
                u = jax.vmap(lambda col: fem._cg(E, col),
                             in_axes=1, out_axes=1)(b)
                return msqrt[:, None] * u

            X = self._X0 if V0 is None else V0
            # warm starts get the full budget; lobpcg's residual test makes
            # converged warm bases cost ~1 block iteration (see 2-D model)
            mu, V, _ = lobpcg_standard(S, X, m=self.lobpcg_iters)
            lam = 1.0 / mu                      # ascending: lam[0] smallest
            phi = jnp.where(msqrt[:, None] > 0, V / msqrt[:, None], 0.0)

            # analytic sensitivities, all grid-form (no [ne, 24] tensors):
            #   dlam/dxf_e = dE_e (phi_e' k0 phi_e)
            #                - lam (drho/8) sum_corners sum_c phi_c^2
            def per_mode(p):
                pg = _to_grid3(p, nnx, nny, nnz)
                kterm = fem._energy_g(pg).reshape(-1)
                s = jnp.sum(pg * pg, axis=0)    # node grid
                mterm = None
                for a, b, c in _CORNERS3D:
                    t = s[_sl(a), _sl(b), _sl(c)]
                    mterm = t if mterm is None else mterm + t
                return kterm, mterm.reshape(-1) / 8.0

            kterm, mterm = jax.vmap(per_mode)(phi.T)      # [N, ne] each
            dE = fem.penal * xf ** (fem.penal - 1.0) * (fem.e0 - fem.emin)
            Wf = dE[None, :] * kterm \
                - lam[:, None] * (1.0 - self.rho_min) * mterm
            W = jax.vmap(lambda w: filt_vjp(w)[0])(Wf)   # chain the filter
            return lam, W, V

        return eig_fn
