"""2-D plane-stress SIMP topology optimization (the reference's real
workload: `examples/topology_optimization/`, Chin/Leader/Kennedy 2019).

Minimum-compliance design of an nex × ney bilinear-quad cantilever:

    min  f·u(x)            K(x) u = f,  E_e = Emin + xf_e^p (E0 − Emin)
    s.t. V − mean(xf) >= 0                      (volume, dense)
         cap − regionmean(xf) >= 0              (per-region weighting, sparse)
         0 <= x <= 1

accelerator-first implementation choices:

- **Matrix-free CG** for K u = f: the element stiffness product is a dense
  [ne, 8] batch matmul against the constant 8×8 element matrix, with
  gather/scatter only at the element-node incidence (regular pattern).
- **Adjoint gradient via custom_vjp**: compliance is self-adjoint, so
  dc/dx_e = −p xf^{p−1}(E0−Emin)·(uₑᵀ k0 uₑ) with NO second solve and no
  differentiation through the CG loop.
- The density filter is a shift-and-add 2-D stencil (elementwise work).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..problem import Problem, SparseJacobian

__all__ = ["FEMTopology", "DMOFEMTopology"]


def _element_stiffness(nu: float = 0.3) -> np.ndarray:
    """8x8 bilinear quad plane-stress element stiffness (unit E, thickness).
    Standard closed form (e.g. Sigmund's 99-line layout)."""
    k = np.array([
        1 / 2 - nu / 6, 1 / 8 + nu / 8, -1 / 4 - nu / 12, -1 / 8 + 3 * nu / 8,
        -1 / 4 + nu / 12, -1 / 8 - nu / 8, nu / 6, 1 / 8 - 3 * nu / 8])
    KE = np.array([
        [k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]],
        [k[1], k[0], k[7], k[6], k[5], k[4], k[3], k[2]],
        [k[2], k[7], k[0], k[5], k[6], k[3], k[4], k[1]],
        [k[3], k[6], k[5], k[0], k[7], k[2], k[1], k[4]],
        [k[4], k[5], k[6], k[7], k[0], k[1], k[2], k[3]],
        [k[5], k[4], k[3], k[2], k[1], k[0], k[7], k[6]],
        [k[6], k[3], k[4], k[1], k[2], k[7], k[0], k[5]],
        [k[7], k[2], k[1], k[4], k[3], k[6], k[5], k[0]]])
    return KE / (1.0 - nu ** 2)


# Element corner order (matches _element_stiffness): ll, lr, ur, ul.
_CORNERS2D = ((0, 0), (1, 0), (1, 1), (0, 1))


def _gather2d(u, nex, ney):
    """[ne, 8] element dof values via corner SLICES of the node grid
    (== u[edofs], but with no gather op)."""
    ug = u.reshape(nex + 1, ney + 1, 2)
    ue = jnp.concatenate(
        [ug[:-1, :-1], ug[1:, :-1], ug[1:, 1:], ug[:-1, 1:]], axis=-1)
    return ue.reshape(nex * ney, 8)


def _scatter2d(fe, nex, ney):
    """Adjoint of _gather2d: sum [ne, 8] element-corner values into the
    [ndof] node vector via four static pads (XLA fuses them)."""
    fe = fe.reshape(nex, ney, 8)
    out = 0.0
    for i, (a, b) in enumerate(_CORNERS2D):
        out = out + jnp.pad(fe[..., 2 * i:2 * i + 2],
                            ((a, 1 - a), (b, 1 - b), (0, 0)))
    return out.reshape(-1)


def _interleave(c, axis):
    """Insert midpoints along `axis`: size k+1 -> 2k+1 (linear)."""
    lo = jax.lax.slice_in_dim(c, 0, c.shape[axis] - 1, axis=axis)
    hi = jax.lax.slice_in_dim(c, 1, c.shape[axis], axis=axis)
    mid = 0.5 * (lo + hi)
    st = jnp.stack([lo, mid], axis=axis + 1)
    shp = list(c.shape)
    shp[axis] = 2 * (shp[axis] - 1)
    st = st.reshape(shp)
    last = jax.lax.slice_in_dim(c, c.shape[axis] - 1, c.shape[axis],
                                axis=axis)
    return jnp.concatenate([st, last], axis=axis)


def _prolong2d(nexc, neyc):
    """Bilinear node-grid prolongation [(nexc+1)(neyc+1)*2] ->
    [(2nexc+1)(2neyc+1)*2], built from interleave reshapes (no gather)."""

    def prolong(c_flat):
        c = c_flat.reshape(nexc + 1, neyc + 1, 2)
        for ax in range(2):
            c = _interleave(c, ax)
        return c.reshape(-1)

    return prolong


class FEMTopology(Problem):
    def __init__(self, nex: int = 32, ney: int = 16,
                 volume_fraction: float = 0.4, penal: float = 3.0,
                 emin: float = 1e-3, e0: float = 1.0,
                 region: int = 0, region_cap: float = 0.8,
                 filter_radius: int = 1, cg_iters: int = 200,
                 solver: str = "jacobi", mg_smooth: int = 2,
                 mg_omega: float = 0.5, dtype=None, seed: int = 0):
        ne = nex * ney
        nwcon = 0
        if region > 0:
            assert ne % region == 0
            nwcon = ne // region
        super().__init__(nvars=ne, ncon=1, nwcon=nwcon, nwblock=1)
        from ..dtypes import resolve_dtype
        dt = resolve_dtype(dtype)
        self._dtype = dt
        self.nex, self.ney = nex, ney
        self.volume_fraction = volume_fraction
        self.penal = penal
        self.emin, self.e0 = emin, e0
        self.region = region
        self.region_cap = region_cap
        self.rfil = filter_radius
        self.cg_iters = cg_iters

        # node numbering: (nex+1) x (ney+1), dof = 2*node
        nnx, nny = nex + 1, ney + 1
        self.ndof = 2 * nnx * nny
        ex, ey = np.meshgrid(np.arange(nex), np.arange(ney), indexing="ij")
        n1 = (ex * nny + ey).ravel()          # lower-left node of element
        # element node order: ll, lr, ur, ul
        nodes = np.stack([n1, n1 + nny, n1 + nny + 1, n1 + 1], axis=1)
        edofs = np.stack([2 * nodes[:, j // 2] + (j % 2)
                          for j in range(8)], axis=1)
        self.edofs = jnp.asarray(edofs.astype(np.int32))
        self.KE = jnp.asarray(_element_stiffness(), dt)

        # cantilever: left edge fixed, downward load at right-mid node
        fixed = []
        for j in range(nny):
            node = 0 * nny + j
            fixed.extend([2 * node, 2 * node + 1])
        self.free = jnp.asarray(
            np.setdiff1d(np.arange(self.ndof), fixed).astype(np.int32))
        self.fixed_mask = jnp.zeros(self.ndof, dt).at[
            jnp.asarray(np.asarray(fixed))].set(1.0)
        f = np.zeros(self.ndof)
        load_node = nex * nny + nny // 2
        f[2 * load_node + 1] = -1.0
        self.f = jnp.asarray(f, dt)

        if region > 0:
            cols = np.arange(ne, dtype=np.int32).reshape(nwcon, region)
            vals = -np.full((nwcon, region), 1.0 / region)
            self._jac = SparseJacobian(ne, jnp.asarray(cols),
                                       jnp.asarray(vals, dt), nwblock=1)

        # geometric-multigrid hierarchy (static: level dims, fixed masks,
        # prolongators); coarsen 2x while both element counts stay even
        assert solver in ("jacobi", "mgcg"), solver
        self.solver = solver
        self.mg_smooth = mg_smooth
        self.mg_omega = mg_omega
        dims = [(nex, ney)]
        while (dims[-1][0] % 2 == 0 and dims[-1][1] % 2 == 0
               and dims[-1][0] >= 4 and dims[-1][1] >= 4):
            dims.append((dims[-1][0] // 2, dims[-1][1] // 2))
        self._mg_dims = dims
        if solver == "mgcg" and len(dims) == 1:
            import warnings
            warnings.warn(
                f"mesh {nex}x{ney} cannot coarsen (element counts must be "
                "even and >= 4): solver='mgcg' falls back to Jacobi-CG — "
                f"cg_iters={cg_iters} sized for multigrid will NOT "
                "converge the state solve; use hundreds of iterations or "
                "an even mesh", stacklevel=2)
        # level 0 reuses the model's own Dirichlet mask; coarser levels
        # apply the same rule (left-edge nodes) on the coarse node grids
        self._mg_fixed = [self.fixed_mask]
        for cx, cy in dims[1:]:
            m = np.zeros(2 * (cx + 1) * (cy + 1))
            m[:2 * (cy + 1)] = 1.0          # left-edge (i == 0) nodes
            self._mg_fixed.append(jnp.asarray(m, dt))
        self._mg_prolong = [_prolong2d(cx, cy) for cx, cy in dims[1:]]

        # build the matrix-free operators once
        self._compliance = self._make_compliance()
        # normalize the objective by the initial compliance so the volume
        # multiplier is O(1) and well inside the elastic penalty gamma (one
        # compiled state solve; run eagerly it compiles ~300 small programs)
        x0 = jnp.full(ne, volume_fraction, dt)
        self.c_scale = 1.0 / float(jax.jit(
            lambda x: self._compliance(self._filter(x)))(x0))

    # -- filter ---------------------------------------------------------
    def _filter(self, x):
        if self.rfil <= 0:
            return x
        xg = x.reshape(self.nex, self.ney)
        acc = xg
        cnt = jnp.ones_like(xg)
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            acc = acc + jnp.roll(xg, (dx, dy), axis=(0, 1))
            cnt = cnt + 1.0
        return (acc / cnt).reshape(-1)

    # -- element gather/scatter ------------------------------------------
    # On the regular grid the element-node incidence is four corner SLICES
    # of the node grid, so both directions are pure slicing/padding — the
    # equivalent u[self.edofs] gather / .at[...].add scatter need
    # index arrays and atomics that slices and pads avoid.

    def _gather_elem(self, u):
        """[ne, 8] element dof values via corner slices (== u[self.edofs])."""
        return _gather2d(u, self.nex, self.ney)

    def _scatter_elem(self, fe):
        """Adjoint of _gather_elem: sum [ne, 8] element-corner values into
        the [ndof] node vector via four static pads (XLA fuses them)."""
        return _scatter2d(fe, self.nex, self.ney)

    # -- FEM ------------------------------------------------------------
    def _kmul(self, E, u):
        """K(E) @ u, matrix-free: slice element dofs off the node grid,
        batch 8x8 matmul, pad-add back; fixed dofs carry identity."""
        ue = self._gather_elem(u)                   # [ne, 8]
        # full f32 accumulation: reduced-precision matmul inputs (bf16,
        # TF32) make CG diverge on the ill-conditioned SIMP system
        fe = jnp.matmul(ue, self.KE,
                        precision=jax.lax.Precision.HIGHEST) * E[:, None]
        out = self._scatter_elem(fe)
        return jnp.where(self.fixed_mask > 0, u, out)

    def _solve(self, E):
        """Preconditioned CG on K(E) u = f (fixed iteration count —
        jit friendly)."""
        return self._cg(E, self.f)

    # -- geometric multigrid ----------------------------------------------
    def _kmul_level(self, El, u, cx, cy, fixed):
        """K(E_l) @ u on MG level (cx, cy) with symmetric Dirichlet
        handling: zero on entry, identity on exit (so the assembled coarse
        matrix is SPD)."""
        u0 = jnp.where(fixed > 0, 0.0, u)
        ue = _gather2d(u0, cx, cy)
        fe = jnp.matmul(ue, self.KE,
                        precision=jax.lax.Precision.HIGHEST) * El[:, None]
        return jnp.where(fixed > 0, u, _scatter2d(fe, cx, cy))

    def _mg_setup(self, E):
        """Per-level (E_l, diag_l) from the fine element moduli (2x2 mean
        pooling — plane-stress K is element-size-invariant, so the
        rediscretized coarse operator needs no h scaling) + the dense
        Cholesky factor of the coarsest-level matrix."""
        Eg = E.reshape(self.nex, self.ney)
        levels = []
        for li, (cx, cy) in enumerate(self._mg_dims):
            El = Eg.reshape(-1)
            fixed = self._mg_fixed[li]
            diag = _scatter2d(jnp.diag(self.KE)[None, :] * El[:, None],
                              cx, cy)
            diag = jnp.where(fixed > 0, 1.0, jnp.maximum(diag, 1e-12))
            levels.append((El, diag, fixed, cx, cy))
            if li + 1 < len(self._mg_dims):
                Eg = Eg.reshape(cx // 2, 2, cy // 2, 2).mean(axis=(1, 3))
        El, _, fixed, cx, cy = levels[-1]
        ndc = 2 * (cx + 1) * (cy + 1)
        Kc = jax.vmap(self._kmul_level, in_axes=(None, 1, None, None, None),
                      out_axes=1)(El, jnp.eye(ndc, dtype=E.dtype), cx, cy,
                                  fixed)
        chol = jax.scipy.linalg.cho_factor(Kc)
        return levels, chol

    def _mg_vcycle(self, levels, chol, r):
        """One symmetric V-cycle (weighted-Jacobi smoothing, bilinear
        transfer, dense coarse solve); SPD for fixed smoothing counts, so
        plain CG accepts it as preconditioner."""
        nu, om = self.mg_smooth, self.mg_omega

        def cycle(l, r):
            El, diag, fixed, cx, cy = levels[l]
            if l == len(levels) - 1:
                e = jax.scipy.linalg.cho_solve(chol, r)
                return jnp.where(fixed > 0, 0.0, e)

            def kmul(v):
                return self._kmul_level(El, v, cx, cy, fixed)

            e = (om / diag) * r
            for _ in range(nu - 1):
                e = e + (om / diag) * (r - kmul(e))
            prolong = self._mg_prolong[l]
            ndc = 2 * (levels[l + 1][3] + 1) * (levels[l + 1][4] + 1)
            restrict = jax.linear_transpose(
                prolong, jax.ShapeDtypeStruct((ndc,), r.dtype))
            rc, = restrict(r - kmul(e))
            rc = jnp.where(levels[l + 1][2] > 0, 0.0, rc)
            e = e + jnp.where(fixed > 0, 0.0, prolong(cycle(l + 1, rc)))
            for _ in range(nu):
                e = e + (om / diag) * (r - kmul(e))
            return e

        return cycle(0, r)

    def _cg(self, E, b):
        """Preconditioned CG on K(E) u = b for a general RHS (fixed dofs
        are zeroed): Jacobi (solver='jacobi') or a geometric-multigrid
        V-cycle (solver='mgcg'). Reused by the frequency model's
        shift-inverted eigensolve."""
        if self.solver == "mgcg" and len(self._mg_dims) > 1:
            levels, chol = self._mg_setup(E)      # carries per-level diags

            def precond(r):
                return self._mg_vcycle(levels, chol, r)
        else:
            diag = self._scatter_elem(
                jnp.diag(self.KE)[None, :] * E[:, None])
            diag = jnp.where(self.fixed_mask > 0, 1.0,
                             jnp.maximum(diag, 1e-12))

            def precond(r):
                return r / diag
        b = jnp.where(self.fixed_mask > 0, 0.0, b)

        # CG scalars need full-precision reductions: default-precision f32
        # dots may take reduced-precision inputs on an accelerator (bf16,
        # TF32), and on the ill-conditioned SIMP system
        # (large meshes, E contrast ~1e3) the rounded alpha/beta make CG
        # diverge to NaN late in the optimization (observed at 192x96).
        # The breakdown guard must also be representable in f32 — 1e-300
        # underflows to 0 and turns a rounded-to-zero curvature into inf.
        hi = jax.lax.Precision.HIGHEST
        tiny = float(jnp.finfo(self._dtype).tiny)

        def body(i, carry):
            u, r, p, rz = carry
            Kp = self._kmul(E, p)
            pKp = jnp.vdot(p, Kp, precision=hi)
            # rounded-to-nonpositive curvature: freeze instead of blowing up
            alpha = jnp.where(pKp > tiny, rz / jnp.where(pKp > tiny, pKp,
                                                         1.0), 0.0)
            u = u + alpha * p
            r = r - alpha * Kp
            z = precond(r)
            rz_new = jnp.vdot(r, z, precision=hi)
            # degenerate rz: restart with the steepest-descent direction
            beta = jnp.where(rz > tiny, rz_new / jnp.where(rz > tiny, rz,
                                                           1.0), 0.0)
            p = z + beta * p
            return (u, r, p, rz_new)

        u0 = jnp.zeros(self.ndof, self._dtype)
        z0 = precond(b)
        carry = (u0, b, z0, jnp.vdot(b, z0, precision=hi))
        u, r, _, _ = jax.lax.fori_loop(0, self.cg_iters, body, carry)
        return u

    def _make_compliance(self):
        """compliance(xf) with the self-adjoint gradient as a custom VJP
        (no differentiation through CG, no extra solve)."""

        def simp(xf):
            return self.emin + xf ** self.penal * (self.e0 - self.emin)

        @jax.custom_vjp
        def compliance(xf):
            u = self._solve(simp(xf))
            return jnp.vdot(self.f, u)

        def fwd(xf):
            u = self._solve(simp(xf))
            return jnp.vdot(self.f, u), (xf, u)

        def bwd(res, ct):
            xf, u = res
            ue = self._gather_elem(u)
            energies = jnp.sum(
                jnp.matmul(ue, self.KE,
                           precision=jax.lax.Precision.HIGHEST) * ue,
                axis=1)                                   # u_e' k0 u_e
            dE = (self.penal * xf ** (self.penal - 1.0)
                  * (self.e0 - self.emin))
            return (-ct * dE * energies,)

        compliance.defvjp(fwd, bwd)
        return compliance

    # -- Problem surface -------------------------------------------------
    def objective(self, x):
        return self.c_scale * self._compliance(self._filter(x))

    def constraints(self, x):
        return jnp.array([self.volume_fraction - jnp.mean(self._filter(x))])

    def sparse_constraints(self, x):
        # region caps act on the RAW densities, keeping the weighting
        # Jacobian exactly the block pattern (the reference's
        # weighting-constraint structure)
        rm = jnp.mean(x.reshape(self.nwcon, self.region), axis=1)
        return self.region_cap - rm

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        ne = self.nvars
        x0 = jnp.full(ne, self.volume_fraction, self._dtype)
        return x0, jnp.full(ne, 1e-3, self._dtype), jnp.ones(ne, self._dtype)


class DMOFEMTopology(Problem):
    """Multi-material (Discrete Material Optimization) 2-D compliance
    problem — the continuum analogue of the reference's `examples/dmo_truss`
    and the flagship use of the BLOCK weighting-constraint path
    (`ParOptSparseMat.cpp:41-224`): per-element material weight variables
    with one separable "weights sum <= 1" constraint PER ELEMENT, so the
    sparse Jacobian is exactly the partition ('blocked') pattern and
    Cw = C0 + Aw·D⁻¹·Awᵀ is diagonal.

    Design x[e, m] ∈ [0, 1] (flattened element-major):
        E_e   = emin + Σ_m x[e,m]^p (E_m − emin)     (DMO interpolation)
        min   compliance(E)
        s.t.  mass_fraction − Σ_{e,m} ρ_m x[e,m]/ne  >= 0   (dense, ncon=1)
              1 − Σ_m x[e,m]                        >= 0   (per element)
    """

    def __init__(self, nex: int = 24, ney: int = 12,
                 e_mats=(1.0, 0.55, 0.25), rho_mats=(1.0, 0.5, 0.2),
                 mass_fraction: float = 0.3, penal: float = 3.0,
                 cg_iters: int = 300, solver: str = "jacobi", dtype=None):
        from ..dtypes import resolve_dtype
        dt = resolve_dtype(dtype)
        self.fem = FEMTopology(nex=nex, ney=ney, cg_iters=cg_iters,
                               solver=solver, dtype=dt)
        ne = nex * ney
        nmat = len(e_mats)
        super().__init__(nvars=ne * nmat, ncon=1, nwcon=ne, nwblock=1)
        self.ne, self.nmat = ne, nmat
        self._dtype = dt
        self.penal = penal
        self.mass_fraction = mass_fraction
        self.e_mats = jnp.asarray(e_mats, dt)
        self.rho_mats = jnp.asarray(rho_mats, dt)
        self.emin = self.fem.emin

        # partition-pattern weighting Jacobian: element e's row touches
        # columns [e*nmat, (e+1)*nmat) — the 'blocked' reshape fast path
        cols = np.arange(ne * nmat, dtype=np.int32).reshape(ne, nmat)
        vals = -np.ones((ne, nmat))
        self._jac = SparseJacobian(ne * nmat, jnp.asarray(cols),
                                   jnp.asarray(vals, dt), nwblock=1)
        self._compliance = self._make_compliance()
        x0, _, _ = self.get_vars_and_bounds()
        self.c_scale = 1.0 / float(self._compliance(x0))

    def _modulus(self, x):
        w = x.reshape(self.ne, self.nmat) ** self.penal
        return self.emin + w @ (self.e_mats - self.emin)

    def _make_compliance(self):
        fem = self.fem

        @jax.custom_vjp
        def compliance(x):
            u = fem._solve(self._modulus(x))
            return jnp.vdot(fem.f, u)

        def fwd(x):
            u = fem._solve(self._modulus(x))
            return jnp.vdot(fem.f, u), (x, u)

        def bwd(res, ct):
            x, u = res
            ue = fem._gather_elem(u)
            energies = jnp.sum(
                jnp.matmul(ue, fem.KE,
                           precision=jax.lax.Precision.HIGHEST) * ue,
                axis=1)                               # [ne]
            xm = x.reshape(self.ne, self.nmat)
            dwdx = self.penal * xm ** (self.penal - 1.0)
            dE = dwdx * (self.e_mats - self.emin)[None, :]   # [ne, nmat]
            g = -ct * energies[:, None] * dE
            return (g.reshape(-1),)

        compliance.defvjp(fwd, bwd)
        return compliance

    # -- Problem surface -------------------------------------------------
    def objective(self, x):
        return self.c_scale * self._compliance(x)

    def constraints(self, x):
        mass = jnp.mean(x.reshape(self.ne, self.nmat) @ self.rho_mats)
        return jnp.array([self.mass_fraction - mass])

    def sparse_constraints(self, x):
        return 1.0 - jnp.sum(x.reshape(self.ne, self.nmat), axis=1)

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        n = self.nvars
        x0 = jnp.full(n, self.mass_fraction / self.nmat, self._dtype)
        return (x0, jnp.full(n, 1e-4, self._dtype),
                jnp.ones(n, self._dtype))

    def material_field(self, x):
        """[ne] argmax material index (-1 where all weights ~ void)."""
        xm = np.asarray(x).reshape(self.ne, self.nmat)
        idx = xm.argmax(axis=1)
        idx[xm.max(axis=1) < 0.3] = -1
        return idx
