"""3-D SIMP voxel topology model: element correctness, gradients, and a
short MMA design run (the reference's stated target workload is 3-D
topology optimization, README.md:12-31)."""

import numpy as np
import jax
import jax.numpy as jnp

from paropt_tpu.models.fem_topology3d import FEMTopology3D, \
    hex_element_stiffness


def test_hex_element_stiffness_properties():
    KE = hex_element_stiffness()
    assert KE.shape == (24, 24)
    assert np.allclose(KE, KE.T, atol=1e-12)
    # rigid-body modes: 3 translations + 3 rotations -> 6 zero eigenvalues
    w = np.linalg.eigvalsh(KE)
    assert np.all(w > -1e-10)
    assert np.sum(np.abs(w) < 1e-10) == 6
    # translation null vectors explicitly
    for d in range(3):
        t = np.zeros(24)
        t[d::3] = 1.0
        assert np.max(np.abs(KE @ t)) < 1e-12


def test_stencil_gather_scatter_matches_edofs_3d():
    """Slice/pad voxel gather/scatter == index-based edofs paths exactly."""
    rng = np.random.default_rng(5)
    prob = FEMTopology3D(nex=4, ney=3, nez=2, cg_iters=50)
    u = jnp.asarray(rng.standard_normal(prob.ndof))
    assert np.array_equal(np.asarray(prob._gather_elem(u)),
                          np.asarray(u[prob.edofs]))
    fe = jnp.asarray(rng.standard_normal((prob.ne, 24)))
    ref = jnp.zeros(prob.ndof, fe.dtype).at[
        prob.edofs.reshape(-1)].add(fe.reshape(-1))
    np.testing.assert_allclose(np.asarray(prob._scatter_elem(fe)),
                               np.asarray(ref), rtol=1e-13)


def test_static_solve_sanity():
    """Full-density cantilever: the CG solve satisfies K u = f and tip
    deflection is negative (load direction)."""
    prob = FEMTopology3D(nex=6, ney=3, nez=3, cg_iters=500)
    E = jnp.full(prob.ne, 1.0, prob._dtype)
    u = prob._solve(E)
    r = prob._kmul(E, u) - jnp.where(prob.fixed_mask > 0, 0.0, prob.f)
    rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(prob.f))
    assert rel < 1e-8, rel
    # compliance positive; fixed dofs stay zero
    assert float(jnp.vdot(prob.f, u)) > 0.0
    assert float(jnp.max(jnp.abs(u * prob.fixed_mask))) == 0.0


def test_mgcg_static_solve_3d():
    """MG-preconditioned CG solves the full-density cantilever to tight
    residual in 25 iterations (Jacobi needs hundreds)."""
    prob = FEMTopology3D(nex=8, ney=4, nez=4, cg_iters=25, solver="mgcg")
    assert len(prob._mg_dims) >= 2
    E = jnp.full(prob.ne, 1.0, prob._dtype)
    u = prob._solve(E)
    r = prob._kmul(E, u) - jnp.where(prob.fixed_mask > 0, 0.0, prob.f)
    rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(prob.f))
    assert rel < 1e-8, rel


def test_gradients_and_volume_constraint():
    prob = FEMTopology3D(nex=4, ney=2, nez=2, cg_iters=400)
    errs = prob.check_gradients(1e-6, verbose=False)
    assert errs["obj_gradient"] < 1e-5, errs
    assert errs["con_gradient"] < 1e-8, errs


def test_mma_reduces_compliance():
    """A short fused MMA run on a small 3-D cantilever reduces compliance
    while honoring the volume bound."""
    from paropt_tpu.mma import FusedMMA

    prob = FEMTopology3D(nex=8, ney=4, nez=4, cg_iters=300)
    solver = FusedMMA(prob, {"mma_max_iterations": 15,
                             "mma_output_file": None})
    res, st = solver.solve(chunk=5)
    x = np.asarray(res["x"])
    # volume bound respected, compliance reduced vs the uniform start
    assert np.mean(x) <= prob.volume_fraction + 1e-4
    assert res["fobj"] < 1.0  # objective normalized to 1 at x0
    assert res["fobj"] > 0.0
    # material concentrates (design departs from uniform)
    assert x.std() > 0.05


def test_region_caps_sparse_path():
    """Separable region caps route through the sparse weighting path."""
    prob = FEMTopology3D(nex=4, ney=2, nez=2, region=4, region_cap=0.6,
                         cg_iters=300)
    assert prob.nwcon == prob.ne // 4
    errs = prob.check_gradients(1e-6, verbose=False)
    assert errs["sparse_jacobian"] < 1e-8, errs


def test_dmo_3d_gradients_and_design():
    """3-D multi-material DMO: gradient checks plus a short fused MMA run
    that respects the per-voxel weight-sum and global mass constraints
    (the reference's flagship 3-D multi-material application class)."""
    from paropt_tpu.models.fem_topology3d import DMOFEMTopology3D
    from paropt_tpu.mma import FusedMMA

    prob = DMOFEMTopology3D(nex=6, ney=3, nez=3, cg_iters=250)
    errs = prob.check_gradients(1e-6, verbose=False)
    assert errs["obj_gradient"] < 1e-5, errs
    assert errs["con_gradient"] < 1e-8, errs
    assert errs["sparse_jacobian"] < 1e-8, errs

    res, st = FusedMMA(prob, {"mma_max_iterations": 12,
                              "mma_output_file": None}).solve(chunk=4)
    x = np.asarray(res["x"])
    xm = x.reshape(prob.ne, prob.nmat)
    assert np.all(xm.sum(axis=1) <= 1.0 + 1e-4)       # per-voxel simplex
    mass = float(np.mean(xm @ np.asarray(prob.rho_mats)))
    assert mass <= prob.mass_fraction + 1e-4          # global mass bound
    assert 0.0 < res["fobj"] < 1.0                    # compliance reduced


def test_fused_tr_on_3d_simp():
    """FusedTR (the reference's default algorithm, whole outer loop
    on-device) drives the 3-D voxel SIMP compliance problem: substantial
    compliance reduction at the volume bound, all trials finite."""
    import numpy as np
    import jax.numpy as jnp
    from paropt_tpu.models.fem_topology3d import FEMTopology3D
    from paropt_tpu.tr import FusedTR

    prob = FEMTopology3D(nex=8, ney=4, nez=4, cg_iters=300)
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(jnp.asarray(x0)))
    r, st = FusedTR(prob, {
        "tr_output_file": None, "output_file": None,
        "tr_max_iterations": 15, "abs_res_tol": 1e-7,
        "tr_infeas_tol": 1e-5, "tr_l1_tol": 0.0,
        "tr_linfty_tol": 1e-4}).solve()
    assert r["fobj"] < 0.6 * f0, (r["fobj"], f0)
    assert r["infeas"] < 1e-5
    x = np.asarray(r["x"])
    assert np.all(np.isfinite(x))
    assert x.mean() <= prob.volume_fraction + 1e-6


def test_layout_grid_vs_aos_equivalence():
    """The grid-form stencil and the [ne, 24] AoS matmul layouts are the
    same operator: K-apply, energy grid, state solve, and a short MMA
    trajectory agree (layout='auto' picks per-level by minor dim; both
    forced layouts must match)."""
    from paropt_tpu.models.fem_topology3d import _to_grid3
    from paropt_tpu.mma import FusedMMA

    rng = np.random.default_rng(11)
    pg = FEMTopology3D(nex=8, ney=4, nez=4, cg_iters=60, solver="mgcg",
                       layout="grid")
    pa = FEMTopology3D(nex=8, ney=4, nez=4, cg_iters=60, solver="mgcg",
                       layout="aos")
    E = jnp.asarray(rng.uniform(0.1, 1.0, pg.ne), pg._dtype)
    u = jnp.asarray(rng.standard_normal(pg.ndof), pg._dtype)
    np.testing.assert_allclose(np.asarray(pg._kmul(E, u)),
                               np.asarray(pa._kmul(E, u)),
                               rtol=5e-12, atol=5e-12)
    ug = _to_grid3(u, pg.nex + 1, pg.ney + 1, pg.nez + 1)
    np.testing.assert_allclose(np.asarray(pg._energy_g(ug)),
                               np.asarray(pa._energy_g(ug)),
                               rtol=5e-12, atol=5e-12)
    ug_sol = pg._solve(E)
    ua_sol = pa._solve(E)
    np.testing.assert_allclose(np.asarray(ug_sol), np.asarray(ua_sol),
                               rtol=1e-8, atol=1e-10)

    opts = {"mma_max_iterations": 8, "mma_output_file": None}
    rg, _ = FusedMMA(pg, dict(opts)).solve(chunk=4)
    ra, _ = FusedMMA(pa, dict(opts)).solve(chunk=4)
    np.testing.assert_allclose(np.asarray(rg["x"]), np.asarray(ra["x"]),
                               rtol=1e-6, atol=1e-8)
    assert abs(float(rg["fobj"]) - float(ra["fobj"])) < 1e-8


def test_layout_auto_per_level_selection(monkeypatch):
    """'auto' is AoS at every width unless PAROPT_TPU_FEM3D_GRID_MIN_NNZ is
    set; then it picks the stencil only at/above that nnz — per multigrid
    level, so one problem can mix layouts."""
    prob = FEMTopology3D(nex=8, ney=4, nez=4, cg_iters=10)
    monkeypatch.delenv("PAROPT_TPU_FEM3D_GRID_MIN_NNZ", raising=False)
    assert not any(prob._use_grid(nnz) for nnz in (3, 41, 81, 1 << 12))
    thr = 48
    monkeypatch.setenv("PAROPT_TPU_FEM3D_GRID_MIN_NNZ", str(thr))
    assert prob._use_grid(thr) and prob._use_grid(thr + 1)
    assert not prob._use_grid(thr - 1)
    assert FEMTopology3D(nex=4, ney=2, nez=2, cg_iters=5,
                         layout="grid")._use_grid(5)
    assert not FEMTopology3D(nex=4, ney=2, nez=2, cg_iters=5,
                             layout="aos")._use_grid(500)
