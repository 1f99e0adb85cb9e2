"""3-D frequency-constrained voxel topology: grid-form eigensolve
correctness, KS sensitivities, and a fused eigen-TR design run (the
reference's flagship eigenvalue application scale — 3-D topology with the
compact eigenvalue approximation, `examples/eigenvalue/eigenvalue_opt.py`
+ `ParOptCompactEigenvalueApprox`)."""

import numpy as np
import jax
import jax.numpy as jnp

from paropt_tpu.models.fem_frequency import FrequencyTopology3D


def _small(nex=6, ney=3, nez=3, N=3):
    return FrequencyTopology3D(nex=nex, ney=ney, nez=nez, N=N,
                               cg_iters=250, lobpcg_iters=80,
                               solver="jacobi", dtype=jnp.float64)


def test_eigensolve_matches_dense_3d():
    """Matrix-free shift-inverted LOBPCG (grid-form CG inner solves) ==
    dense generalized eigensolve on the assembled voxel matrices."""
    p = _small()
    fem = p.fem
    x = jnp.asarray(np.random.default_rng(1).uniform(0.3, 1.0, p.nvars))
    xf = fem._filter(x)
    E = fem.emin + xf ** fem.penal * (fem.e0 - fem.emin)
    I = jnp.eye(fem.ndof)
    K = jax.vmap(lambda col: fem._kmul(E, col), in_axes=1, out_axes=1)(I)
    _, m = p._mass_grids(xf)
    free = np.asarray(fem.fixed_mask) == 0
    Kf = np.asarray(K)[np.ix_(free, free)]
    mf = np.asarray(m)[free]
    A = Kf / np.sqrt(np.outer(mf, mf))
    lam_ref = np.sort(np.linalg.eigvalsh(0.5 * (A + A.T)))[:p.N]

    lam, W, _ = p._eig_fn(x, None)
    assert np.allclose(np.asarray(lam), lam_ref, rtol=1e-7), (lam, lam_ref)
    assert np.isfinite(np.asarray(W)).all()


def test_mass_grid_matches_scatter_3d():
    """The corner-slice lumped-mass grid equals the [ne, 24] scatter."""
    p = _small()
    fem = p.fem
    xf = jnp.asarray(np.random.default_rng(3).uniform(0.1, 1.0, p.nvars))
    _, m = p._mass_grids(xf)
    rho = p.rho_min + xf * (1.0 - p.rho_min)
    ref = fem._scatter_elem(
        jnp.broadcast_to((rho / 8.0)[:, None], (p.nvars, 24)))
    ref = jnp.where(fem.fixed_mask > 0, 0.0, ref)
    np.testing.assert_allclose(np.asarray(m), np.asarray(ref), rtol=1e-13)


def test_ks_gradient_matches_fd_3d():
    """Analytic grid-form eigenvalue sensitivities + filter chain vs
    central FD."""
    p = _small()
    rng = np.random.default_rng(2)
    x = np.asarray(rng.uniform(0.3, 1.0, p.nvars))
    d = rng.standard_normal(p.nvars)
    d /= np.linalg.norm(d)
    ex = p._eval(jnp.asarray(x))["dks"] @ d
    dh = 1e-6
    c1 = p._eval(jnp.asarray(x + dh * d))["ks"]
    c0 = p._eval(jnp.asarray(x - dh * d))["ks"]
    fd = (c1 - c0) / (2 * dh)
    assert abs(fd - ex) < 1e-6 * max(1.0, abs(fd)), (fd, ex)


def test_fused_eigen_tr_3d_design():
    """FusedEigenTR on the 3-D frequency problem: mass drops while the
    KS frequency constraint stays (near-)feasible and the lowest
    frequency lands at/above the target."""
    prob = FrequencyTopology3D(nex=8, ney=4, nez=4, N=3, cg_iters=25,
                               lobpcg_iters=40, solver="mgcg")
    ftr = prob.build_fused_tr({"tr_max_iterations": 10,
                               "tr_output_file": None,
                               "output_file": None})
    res, st = ftr.solve()
    assert np.isfinite(res["fobj"])
    assert res["fobj"] < 0.9            # mass reduced from 1.0
    assert res["infeas"] < 1e-3
    freqs = prob.frequencies(res["x"])
    assert freqs[0] >= np.sqrt(prob.lam_target) * (1.0 - 1e-2)


def test_minv_floor_f32_regime():
    """The dtype-aware Minv regularization floor (the da34b66 f32
    fix): in float32 the relative eigenvalue floor is 1e3*eps (cond
    bound ~1e4), in float64 the historical 1e-8 — and at a mesh where
    the KS aggregate concentrates on one mode, the f32 floor actually
    BINDS (raw relative spread of the KS curvature exceeds 1e4) while
    the regularized inverse respects the conditioning bound."""
    p32 = FrequencyTopology3D(nex=16, ney=8, nez=8, N=4, cg_iters=30,
                              lobpcg_iters=50, solver="mgcg",
                              dtype=jnp.float32)
    p64 = _small()
    f32_eps = float(np.finfo(np.float32).eps)
    assert p32._minv_floor() == max(1e-8, 1e3 * f32_eps)
    assert p64._minv_floor() == 1e-8

    x0, _, _ = p32.get_vars_and_bounds()
    f, c, g, A, M, Minv, h = p32.eval_full(x0)[:7]
    scale = p32.ks_rho / p32.lam_target ** 2
    e_raw = np.linalg.eigvalsh(np.asarray(M, np.float64))
    # the regime: raw spread beyond the f32 cond bound (eta collapse)
    assert np.max(np.abs(e_raw)) / max(np.max(-e_raw[e_raw < 0])
                                       if np.any(e_raw < 0) else 0.0,
                                       p32._minv_floor() * scale) >= 1.0
    floor = p32._minv_floor() * scale
    e_inv = np.linalg.eigvalsh(np.asarray(Minv, np.float64))
    assert np.all(e_inv < 0.0)                     # NSD inverse
    assert np.max(np.abs(e_inv)) <= 1.0 / floor * 1.01  # cond bound holds
    assert np.isfinite(np.asarray(Minv)).all()


def test_fused_eigen_tr_f32_fine_mesh_progress():
    """f32 fused eigen-TR at a mesh in the high-scale regime: every
    outer iteration stays finite (no NaN-freeze) and the design makes
    progress — the end-to-end guard for the f32 failure that froze
    64x32x32 at mass=1.0 with rho=nan."""
    p = FrequencyTopology3D(nex=16, ney=8, nez=8, N=4, cg_iters=30,
                            lobpcg_iters=50, solver="mgcg",
                            dtype=jnp.float32)
    ftr = p.build_fused_tr({"tr_max_iterations": 8,
                            "tr_output_file": None, "output_file": None})
    res, st = ftr.solve()
    x = np.asarray(res["x"])
    assert np.isfinite(x).all()
    assert np.isfinite(float(res["fobj"]))
    assert float(res["fobj"]) < 0.95          # mass reduced from 1.0
    assert np.isfinite(float(st.rho))
