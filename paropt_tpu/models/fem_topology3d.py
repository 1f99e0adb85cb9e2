"""3-D SIMP topology optimization: matrix-free voxel FEM on an accelerator.

The reference's stated target workload is *large-scale 3-D* (multi-material)
topology optimization (`README.md:12-31`, `docs/ParOpt_theory_manual.tex:
27-28`, the Chin/Leader/Kennedy 2019 applications).  This model provides the
3-D analogue of `fem_topology.FEMTopology`:

    min  compliance(x)
    s.t. volume_fraction - mean(x) >= 0             (1 dense constraint)
         [optional] cap - regionmean(x) >= 0        (separable sparse caps)
         0 <= x <= 1

- 8-node hexahedral voxels, 3 dofs/node; K(E)·u is matrix-free:
  gather element dofs [ne, 24] → one [ne, 24]@[24, 24] batched matmul
  (full-f32 accumulation — reduced-precision matmul inputs diverge on the
  ill-conditioned SIMP system, see fem_topology.py) → scatter-add.
- Jacobi-preconditioned CG with full-precision scalar reductions and
  freeze/restart breakdown guards (same recipe as the 2-D model).
- 6-neighbor density filter via `jnp.roll` on the voxel grid (no gather).
- Compliance gradient by the self-adjoint custom VJP (no differentiation
  through CG, no adjoint solve).

Everything jits; `FusedMMA(FEMTopology3D(...))` runs the whole optimization
on-device.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..problem import Problem, SparseJacobian
from .fem_topology import _interleave

__all__ = ["FEMTopology3D", "DMOFEMTopology3D", "hex_element_stiffness"]


def hex_element_stiffness(nu: float = 0.3) -> np.ndarray:
    """[24, 24] stiffness of a unit-cube 8-node hex with E = 1 (standard
    isoparametric 2x2x2 Gauss quadrature)."""
    # local node coordinates (standard ordering)
    nodes = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                     dtype=float)
    # isotropic elasticity (Voigt: xx, yy, zz, yz, xz, xy)
    lam = nu / ((1 + nu) * (1 - 2 * nu))
    mu = 1.0 / (2 * (1 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[0, 0] = D[1, 1] = D[2, 2] = lam + 2 * mu
    D[3, 3] = D[4, 4] = D[5, 5] = mu

    g = 1.0 / np.sqrt(3.0)
    KE = np.zeros((24, 24))
    for gx in (-g, g):
        for gy in (-g, g):
            for gz in (-g, g):
                # dN/dxi at the gauss point; unit cube => dxi/dx = 2
                dN = np.zeros((3, 8))
                for i, (xi, eta, zeta) in enumerate(nodes):
                    dN[0, i] = xi * (1 + eta * gy) * (1 + zeta * gz) / 8.0
                    dN[1, i] = (1 + xi * gx) * eta * (1 + zeta * gz) / 8.0
                    dN[2, i] = (1 + xi * gx) * (1 + eta * gy) * zeta / 8.0
                dN = 2.0 * dN  # to physical coords
                B = np.zeros((6, 24))
                for i in range(8):
                    B[0, 3 * i + 0] = dN[0, i]
                    B[1, 3 * i + 1] = dN[1, i]
                    B[2, 3 * i + 2] = dN[2, i]
                    B[3, 3 * i + 1] = dN[2, i]
                    B[3, 3 * i + 2] = dN[1, i]
                    B[4, 3 * i + 0] = dN[2, i]
                    B[4, 3 * i + 2] = dN[0, i]
                    B[5, 3 * i + 0] = dN[1, i]
                    B[5, 3 * i + 1] = dN[0, i]
                KE += (B.T @ D @ B) / 8.0  # detJ = 1/8, weight 1
    return KE


# Corner order matches hex_element_stiffness's local node ordering.
_CORNERS3D = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
              (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


def _sl(a):
    return slice(1, None) if a else slice(None, -1)


def _to_grid3(u_flat, nnx, nny, nnz):
    """Flat AoS dof vector [3*nnx*nny*nnz] -> SoA component grids
    [3, nnx, nny, nnz] (minor dim nnz instead of the [ne, 24] form's
    minor dims of 3/24)."""
    return jnp.moveaxis(u_flat.reshape(nnx, nny, nnz, 3), -1, 0)


def _from_grid3(ug):
    """Inverse of _to_grid3 (same dof ordering as the flat vector)."""
    return jnp.moveaxis(ug, 0, -1).reshape(-1)


def _grid_min_nnz() -> Optional[int]:
    """layout='auto' threshold: use the grid-form stencil on multigrid
    levels whose node-grid minor dim (nnz = nez + 1) is at least
    `PAROPT_TPU_FEM3D_GRID_MIN_NNZ`, else the [ne, 24] AoS matmul form.
    Unset (None), 'auto' is AoS on every level: on the H100 the 576-term
    stencil on the nnz-81 top level of the 160x80x80 mesh made one state
    solve 3.5x slower and its compilation 3.2x longer (CHANGES.md,
    bring-up; scripts/fem3d_layout.py measures it)."""
    import os
    value = os.environ.get("PAROPT_TPU_FEM3D_GRID_MIN_NNZ")
    return int(value) if value else None


def _kmul_aos(KE, Eg, ug, fixed_g, zero_entry):
    """K(E) @ u in the [ne, 24] AoS form, grid-in/grid-out: corner-slice
    gather -> one [ne, 24]@[24, 24] matmul (full-f32 accumulation) ->
    static-pad scatter.  Semantics identical to _kmul_grid; preferred at
    small meshes, where the 576-term stencil bloats compile time (see
    _grid_min_nnz)."""
    nex, ney, nez = Eg.shape
    ug0 = jnp.where(fixed_g > 0, 0.0, ug) if zero_entry else ug
    ue = _gather3d(_from_grid3(ug0), nex, ney, nez)
    fe = jnp.matmul(ue, KE,
                    precision=jax.lax.Precision.HIGHEST) * Eg.reshape(-1)[:, None]
    out = _to_grid3(_scatter3d(fe, nex, ney, nez), nex + 1, ney + 1, nez + 1)
    return jnp.where(fixed_g > 0, ug, out)


def _energy_aos(KE, ug):
    """Per-element unit-modulus strain energies in the [ne, 24] AoS form
    (== _energy_grid), returned as an [nex, ney, nez] grid."""
    nnx, nny, nnz = ug.shape[1:]
    nex, ney, nez = nnx - 1, nny - 1, nnz - 1
    ue = _gather3d(_from_grid3(ug), nex, ney, nez)
    en = jnp.sum(jnp.matmul(ue, KE,
                            precision=jax.lax.Precision.HIGHEST) * ue,
                 axis=1)
    return en.reshape(nex, ney, nez)


def _kmul_grid(KEh, Eg, ug, fixed_g, zero_entry):
    """K(E) @ u entirely on SoA component grids: 576 scalar-coefficient
    multiply-adds on [nex, ney, nez] element grids, assembled with 8
    static pads — no [ne, 24] materialization, no strided minor-dim
    copies.

    `zero_entry=True` gives the symmetric-Dirichlet operator (zero on
    entry, identity on exit -> SPD) used on multigrid levels;
    `zero_entry=False` matches the original _kmul semantics (identity
    exit only).
    """
    ug0 = jnp.where(fixed_g > 0, 0.0, ug) if zero_entry else ug
    out = jnp.zeros_like(ug)
    for i, (a, b, c) in enumerate(_CORNERS3D):
        acc = [None, None, None]
        for j, (d, e, f2) in enumerate(_CORNERS3D):
            for cj in range(3):
                uj = ug0[cj, _sl(d), _sl(e), _sl(f2)]
                for ci in range(3):
                    k = float(KEh[3 * i + ci, 3 * j + cj])
                    if k == 0.0:
                        continue
                    t = k * uj
                    acc[ci] = t if acc[ci] is None else acc[ci] + t
        fe = jnp.stack([(x if x is not None else jnp.zeros_like(Eg)) * Eg
                        for x in acc])
        out = out + jnp.pad(fe, ((0, 0), (a, 1 - a), (b, 1 - b),
                                 (c, 1 - c)))
    return jnp.where(fixed_g > 0, ug, out)


def _diag_grid(KEh, Eg, fixed_g):
    """diag(K(E)) on component grids (8 static pads); 1.0 at fixed dofs."""
    out = None
    for i, (a, b, c) in enumerate(_CORNERS3D):
        d3 = jnp.stack([float(KEh[3 * i + ci, 3 * i + ci]) * Eg
                        for ci in range(3)])
        d3 = jnp.pad(d3, ((0, 0), (a, 1 - a), (b, 1 - b), (c, 1 - c)))
        out = d3 if out is None else out + d3
    return jnp.where(fixed_g > 0, 1.0, jnp.maximum(out, 1e-12))


def _energy_grid(KEh, ug):
    """Per-element unit-modulus strain energies  u_e' KE u_e  as an
    [nex, ney, nez] grid — the compliance-gradient kernel, in the same
    stencil form as _kmul_grid (no [ne, 24] materialization)."""
    en = None
    for i, (a, b, c) in enumerate(_CORNERS3D):
        for ci in range(3):
            acc = None
            for j, (d, e, f2) in enumerate(_CORNERS3D):
                for cj in range(3):
                    k = float(KEh[3 * i + ci, 3 * j + cj])
                    if k == 0.0:
                        continue
                    t = k * ug[cj, _sl(d), _sl(e), _sl(f2)]
                    acc = t if acc is None else acc + t
            term = acc * ug[ci, _sl(a), _sl(b), _sl(c)]
            en = term if en is None else en + term
    return en


def _gather3d(u, nex, ney, nez):
    """[ne, 24] element dof values via corner SLICES of the node grid."""
    ug = u.reshape(nex + 1, ney + 1, nez + 1, 3)
    ue = jnp.concatenate(
        [ug[_sl(a), _sl(b), _sl(c)] for a, b, c in _CORNERS3D], axis=-1)
    return ue.reshape(nex * ney * nez, 24)


def _scatter3d(fe, nex, ney, nez):
    """Adjoint of _gather3d: sum element-corner values into node dofs via
    eight static pads."""
    fe = fe.reshape(nex, ney, nez, 24)
    out = 0.0
    for i, (a, b, c) in enumerate(_CORNERS3D):
        out = out + jnp.pad(fe[..., 3 * i:3 * i + 3],
                            ((a, 1 - a), (b, 1 - b), (c, 1 - c), (0, 0)))
    return out.reshape(-1)


def _prolong3d(nexc, neyc, nezc):
    """Trilinear SoA-grid prolongation [3, nnxc, nnyc, nnzc] ->
    [3, 2nexc+1, 2neyc+1, 2nezc+1], built from interleave reshapes."""

    def prolong(cg):
        for ax in (1, 2, 3):
            cg = _interleave(cg, ax)
        return cg

    return prolong


class FEMTopology3D(Problem):
    """Cantilever voxel design domain: fixed at the x = 0 face, unit
    downward load along the bottom edge of the free face."""

    def __init__(self, nex: int = 16, ney: int = 8, nez: int = 8,
                 volume_fraction: float = 0.3, penal: float = 3.0,
                 emin: float = 1e-3, e0: float = 1.0,
                 region: int = 0, region_cap: float = 0.8,
                 cg_iters: int = 400, filter_on: bool = True,
                 solver: str = "jacobi", mg_smooth: int = 2,
                 mg_omega: float = 0.4, layout: str = "auto", dtype=None):
        from ..dtypes import resolve_dtype
        assert layout in ("auto", "grid", "aos"), layout
        self.layout = layout
        dt = resolve_dtype(dtype)
        ne = nex * ney * nez
        nwcon = ne // region if region > 0 else 0
        if region > 0:
            assert ne % region == 0
        super().__init__(nvars=ne, ncon=1, nwcon=nwcon, nwblock=1)
        self.nex, self.ney, self.nez = nex, ney, nez
        self.ne = ne
        self._dtype = dt
        self.penal = penal
        self.emin, self.e0 = emin, e0
        self.volume_fraction = volume_fraction
        self.region, self.region_cap = region, region_cap
        self.cg_iters = cg_iters
        self.filter_on = filter_on
        self._KE_np = hex_element_stiffness()   # scalar stencil coeffs
        self.KE = jnp.asarray(self._KE_np, dt)

        # node numbering: node(i, j, k) for i<=nex, j<=ney, k<=nez
        nnx, nny, nnz = nex + 1, ney + 1, nez + 1
        self.ndof = 3 * nnx * nny * nnz

        def nid(i, j, k):
            return (i * nny + j) * nnz + k

        # vectorized element-dof map (local ordering must match
        # hex_element_stiffness / _CORNERS3D); a python triple loop here
        # cost 700+ s at 10^6 elements
        ii, jj, kk = np.meshgrid(np.arange(nex), np.arange(ney),
                                 np.arange(nez), indexing="ij")
        corners = np.stack([nid(ii + a, jj + b, kk + c)
                            for a, b, c in _CORNERS3D],
                           axis=-1).reshape(ne, 8)
        edofs = (3 * corners[:, :, None]
                 + np.arange(3)).reshape(ne, 24).astype(np.int32)
        self.edofs = jnp.asarray(edofs)

        # fixed: all dofs on the x = 0 face
        fixed = np.zeros(self.ndof, dtype=bool)
        for j in range(nny):
            for k in range(nnz):
                c = nid(0, j, k)
                fixed[3 * c:3 * c + 3] = True
        self.fixed_mask = jnp.asarray(fixed.astype(np.float64), dt)
        self._fixed_g = _to_grid3(self.fixed_mask, nnx, nny, nnz)

        # load: unit force in -z along the bottom edge (z=0) of the free
        # face (x = nex)
        f = np.zeros(self.ndof)
        for j in range(nny):
            c = nid(nex, j, 0)
            f[3 * c + 2] = -1.0 / nny
        self.f = jnp.asarray(f, dt)

        if region > 0:
            cols = np.arange(ne, dtype=np.int32).reshape(nwcon, region)
            vals = -np.full((nwcon, region), 1.0 / region)
            self._jac = SparseJacobian(ne, jnp.asarray(cols),
                                       jnp.asarray(vals, dt), nwblock=1)

        # geometric-multigrid hierarchy (static): coarsen 2x while all
        # three element counts stay even
        assert solver in ("jacobi", "mgcg"), solver
        self.solver = solver
        self.mg_smooth = mg_smooth
        self.mg_omega = mg_omega
        dims = [(nex, ney, nez)]
        while all(d % 2 == 0 and d >= 4 for d in dims[-1]):
            dims.append(tuple(d // 2 for d in dims[-1]))
        self._mg_dims = dims
        if solver == "mgcg" and len(dims) == 1:
            import warnings
            warnings.warn(
                f"mesh {nex}x{ney}x{nez} cannot coarsen (element counts "
                "must be even and >= 4): solver='mgcg' falls back to "
                f"Jacobi-CG — cg_iters={cg_iters} sized for multigrid "
                "will NOT converge the state solve; use hundreds of "
                "iterations or an even mesh", stacklevel=2)
        # level 0 reuses the model's own Dirichlet mask; coarser levels
        # apply the same rule (x == 0 face) on the coarse node grids.
        # All masks are SoA grids [3, cx+1, cy+1, cz+1].
        self._mg_fixed = [self._fixed_g]
        for cx, cy, cz in dims[1:]:
            m = np.zeros((3, cx + 1, cy + 1, cz + 1))
            m[:, 0] = 1.0   # x == 0 face nodes
            self._mg_fixed.append(jnp.asarray(m, dt))
        self._mg_prolong = [_prolong3d(*d) for d in dims[1:]]

        self._compliance = self._make_compliance()
        # one compiled state solve (run eagerly it compiles ~300 programs)
        x0 = jnp.full(ne, volume_fraction, dt)
        self.c_scale = 1.0 / float(jax.jit(
            lambda x: self._compliance(self._filter(x)))(x0))

    # -- filter (6-neighbor average on the voxel grid) -------------------
    def _filter(self, x):
        if not self.filter_on:
            return x
        xg = x.reshape(self.nex, self.ney, self.nez)
        acc = xg
        cnt = jnp.ones_like(xg)
        for ax in (0, 1, 2):
            for sh in (1, -1):
                acc = acc + jnp.roll(xg, sh, axis=ax)
                cnt = cnt + 1.0
        return (acc / cnt).reshape(-1)

    # -- element gather/scatter --------------------------------------------
    # Regular-voxel incidence == eight corner SLICES of the node grid; both
    # directions are pure slicing/padding (no gather/scatter ops).

    def _gather_elem(self, u):
        """[ne, 24] element dof values via corner slices (== u[self.edofs])."""
        return _gather3d(u, self.nex, self.ney, self.nez)

    def _scatter_elem(self, fe):
        """Adjoint of _gather_elem: sum [ne, 24] element-corner values into
        the [ndof] node vector via eight static pads."""
        return _scatter3d(fe, self.nex, self.ney, self.nez)

    # -- FEM -------------------------------------------------------------
    # All state-solve linear algebra runs on SoA component grids
    # [3, nnx, nny, nnz].  The K-apply kernel is size-selected PER GRID
    # (hence per multigrid level): the scalar-coefficient stencil
    # _kmul_grid at nnz >= _grid_min_nnz() when that is set, else the
    # [ne, 24] AoS matmul form, whose compile time the stencil's 576
    # multiply-adds exceed several times.  The flat [ndof] AoS contract is
    # kept at the _solve/_kmul boundaries.

    def _use_grid(self, nnz: int) -> bool:
        if self.layout != "auto":
            return self.layout == "grid"
        threshold = _grid_min_nnz()
        return threshold is not None and nnz >= threshold

    def _kmul_g(self, Eg, ug, fixed_g, zero_entry):
        """K(E) @ u on SoA grids, layout-dispatched by minor dim."""
        if self._use_grid(ug.shape[-1]):
            return _kmul_grid(self._KE_np, Eg, ug, fixed_g, zero_entry)
        return _kmul_aos(self.KE.astype(ug.dtype), Eg, ug, fixed_g,
                         zero_entry)

    def _energy_g(self, ug):
        """Per-element strain-energy grid, layout-dispatched."""
        if self._use_grid(ug.shape[-1]):
            return _energy_grid(self._KE_np, ug)
        return _energy_aos(self.KE.astype(ug.dtype), ug)

    def _kmul(self, E, u):
        ug = _to_grid3(u, self.nex + 1, self.ney + 1, self.nez + 1)
        Eg = E.reshape(self.nex, self.ney, self.nez)
        out = self._kmul_g(Eg, ug, self._fixed_g, zero_entry=False)
        return _from_grid3(out)

    # -- geometric multigrid ----------------------------------------------
    def _mg_setup(self, Eg):
        """Per-level (E_l, diag_l) grids: 2x2x2 mean pooling with a x2
        scale per level (3-D stiffness scales LINEARLY with element size,
        so the rediscretized coarse operator on a 2h grid needs
        K_c = 2 E_c KE) + the dense Cholesky factor of the coarsest-level
        matrix."""
        KEh = self._KE_np
        levels = []
        for li, (cx, cy, cz) in enumerate(self._mg_dims):
            fixed_g = self._mg_fixed[li]
            diag_g = _diag_grid(KEh, Eg, fixed_g)
            levels.append((Eg, diag_g, fixed_g, cx, cy, cz))
            if li + 1 < len(self._mg_dims):
                Eg = 2.0 * Eg.reshape(cx // 2, 2, cy // 2, 2,
                                      cz // 2, 2).mean(axis=(1, 3, 5))
        Eg_c, _, fixed_g, cx, cy, cz = levels[-1]
        ndc = 3 * (cx + 1) * (cy + 1) * (cz + 1)

        def kmul_flat(v):
            vg = _to_grid3(v, cx + 1, cy + 1, cz + 1)
            return _from_grid3(self._kmul_g(Eg_c, vg, fixed_g,
                                            zero_entry=True))

        Kc = jax.vmap(kmul_flat, in_axes=1, out_axes=1)(
            jnp.eye(ndc, dtype=Eg_c.dtype))
        chol = jax.scipy.linalg.cho_factor(Kc)
        return levels, chol

    def _mg_vcycle(self, levels, chol, r):
        """Symmetric V-cycle on SoA grids: weighted-Jacobi smoothing,
        trilinear transfer, dense coarse solve."""
        nu, om = self.mg_smooth, self.mg_omega

        def cycle(l, r):
            Eg, diag, fixed, cx, cy, cz = levels[l]
            if l == len(levels) - 1:
                e = jax.scipy.linalg.cho_solve(chol, _from_grid3(r))
                e = _to_grid3(e, cx + 1, cy + 1, cz + 1)
                return jnp.where(fixed > 0, 0.0, e)

            def kmul(v):
                return self._kmul_g(Eg, v, fixed, zero_entry=True)

            e = (om / diag) * r
            for _ in range(nu - 1):
                e = e + (om / diag) * (r - kmul(e))
            prolong = self._mg_prolong[l]
            nxt = levels[l + 1]
            shc = (3, nxt[3] + 1, nxt[4] + 1, nxt[5] + 1)
            restrict = jax.linear_transpose(
                prolong, jax.ShapeDtypeStruct(shc, r.dtype))
            rc, = restrict(r - kmul(e))
            rc = jnp.where(nxt[2] > 0, 0.0, rc)
            e = e + jnp.where(fixed > 0, 0.0, prolong(cycle(l + 1, rc)))
            for _ in range(nu):
                e = e + (om / diag) * (r - kmul(e))
            return e

        return cycle(0, r)

    def _solve(self, E):
        return self._cg(E, self.f)

    def _cg(self, E, b):
        """Preconditioned CG on K(E) u = b: Jacobi (solver='jacobi') or a
        geometric-multigrid V-cycle (solver='mgcg').  Flat [ndof] in/out;
        every iteration runs on SoA grids."""
        KEh = self._KE_np
        nnx, nny, nnz = self.nex + 1, self.ney + 1, self.nez + 1
        Eg = E.reshape(self.nex, self.ney, self.nez)
        fixed_g = self._fixed_g
        if self.solver == "mgcg" and len(self._mg_dims) > 1:
            levels, chol = self._mg_setup(Eg)     # carries per-level diags

            def precond(r):
                return self._mg_vcycle(levels, chol, r)
        else:
            diag_g = _diag_grid(KEh, Eg, fixed_g)

            def precond(r):
                return r / diag_g

        bg = jnp.where(fixed_g > 0, 0.0, _to_grid3(b, nnx, nny, nnz))
        hi = jax.lax.Precision.HIGHEST
        tiny = float(jnp.finfo(self._dtype).tiny)

        def body(i, carry):
            u, r, p, rz = carry
            Kp = self._kmul_g(Eg, p, fixed_g, zero_entry=False)
            pKp = jnp.vdot(p, Kp, precision=hi)
            alpha = jnp.where(pKp > tiny,
                              rz / jnp.where(pKp > tiny, pKp, 1.0), 0.0)
            u = u + alpha * p
            r = r - alpha * Kp
            z = precond(r)
            rz_new = jnp.vdot(r, z, precision=hi)
            beta = jnp.where(rz > tiny,
                             rz_new / jnp.where(rz > tiny, rz, 1.0), 0.0)
            p = z + beta * p
            return (u, r, p, rz_new)

        u0 = jnp.zeros_like(bg)
        z0 = precond(bg)
        carry = (u0, bg, z0, jnp.vdot(bg, z0, precision=hi))
        u, _, _, _ = jax.lax.fori_loop(0, self.cg_iters, body, carry)
        return _from_grid3(u)

    def _make_compliance(self):
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
            ug = _to_grid3(u, self.nex + 1, self.ney + 1, self.nez + 1)
            energies = self._energy_g(ug).reshape(-1)
            dE = (self.penal * xf ** (self.penal - 1.0)
                  * (self.e0 - self.emin))
            return (-ct * dE * energies,)

        compliance.defvjp(fwd, bwd)
        return compliance

    # -- Problem surface --------------------------------------------------
    def objective(self, x):
        return self.c_scale * self._compliance(self._filter(x))

    def constraints(self, x):
        return jnp.array([self.volume_fraction - jnp.mean(x)])

    def sparse_constraints(self, x):
        xb = x.reshape(self.nwcon, self.region)
        return self.region_cap - jnp.mean(xb, axis=1)

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        n = self.nvars
        x0 = jnp.full(n, self.volume_fraction, self._dtype)
        return x0, jnp.zeros(n, self._dtype), jnp.ones(n, self._dtype)


class DMOFEMTopology3D(Problem):
    """Multi-material (DMO) 3-D voxel compliance design — the reference's
    flagship application class ("large-scale 3D multi-material topology
    optimization", README.md:12-31) and the continuum use of the BLOCK
    weighting-constraint path: per-voxel material weights x[e, m] with one
    separable "weights sum <= 1" constraint PER VOXEL, so the sparse
    Jacobian is the partition ('blocked') pattern and Cw is diagonal.

        E_e = emin + Σ_m x[e,m]^p (E_m − emin)
        min  compliance(E)
        s.t. mass_fraction − Σ_{e,m} ρ_m x[e,m]/ne >= 0   (dense)
             1 − Σ_m x[e,m] >= 0                          (per voxel)
    """

    def __init__(self, nex: int = 12, ney: int = 6, nez: int = 6,
                 e_mats=(1.0, 0.55, 0.25), rho_mats=(1.0, 0.5, 0.2),
                 mass_fraction: float = 0.3, penal: float = 3.0,
                 cg_iters: int = 400, solver: str = "jacobi",
                 layout: str = "auto", dtype=None):
        from ..dtypes import resolve_dtype
        dt = resolve_dtype(dtype)
        self.fem = FEMTopology3D(nex=nex, ney=ney, nez=nez,
                                 cg_iters=cg_iters, filter_on=False,
                                 solver=solver, layout=layout, dtype=dt)
        ne = self.fem.ne
        nmat = len(e_mats)
        super().__init__(nvars=ne * nmat, ncon=1, nwcon=ne, nwblock=1)
        self.ne, self.nmat = ne, nmat
        self._dtype = dt
        self.penal = penal
        self.mass_fraction = mass_fraction
        self.e_mats = jnp.asarray(e_mats, dt)
        self.rho_mats = jnp.asarray(rho_mats, dt)
        self.emin = self.fem.emin

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
            ug = _to_grid3(u, fem.nex + 1, fem.ney + 1, fem.nez + 1)
            energies = fem._energy_g(ug).reshape(-1)  # [ne]
            xm = x.reshape(self.ne, self.nmat)
            dwdx = self.penal * xm ** (self.penal - 1.0)
            dE = dwdx * (self.e_mats - self.emin)[None, :]
            g = -ct * energies[:, None] * dE
            return (g.reshape(-1),)

        compliance.defvjp(fwd, bwd)
        return compliance

    # -- Problem surface --------------------------------------------------
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
