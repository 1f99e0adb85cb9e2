"""2-D plane-stress SIMP topology model tests."""

import numpy as np
import jax.numpy as jnp

from paropt_tpu import InteriorPoint
from paropt_tpu.mma import MMA
from paropt_tpu.models.fem_topology import FEMTopology


def test_stencil_gather_scatter_matches_edofs():
    """The slice/pad element gather/scatter (the gather-free path) must equal
    the index-based u[edofs] gather and .at[edofs].add scatter exactly."""
    rng = np.random.default_rng(3)
    prob = FEMTopology(nex=7, ney=5)
    u = jnp.asarray(rng.standard_normal(prob.ndof))
    assert np.array_equal(np.asarray(prob._gather_elem(u)),
                          np.asarray(u[prob.edofs]))
    fe = jnp.asarray(rng.standard_normal((prob.nvars, 8)))
    ref = jnp.zeros(prob.ndof, fe.dtype).at[
        prob.edofs.reshape(-1)].add(fe.reshape(-1))
    np.testing.assert_allclose(np.asarray(prob._scatter_elem(fe)),
                               np.asarray(ref), rtol=1e-13)


def test_fem_gradients_adjoint_exact():
    prob = FEMTopology(nex=8, ney=4, cg_iters=400)
    errs = prob.check_gradients(1e-6, verbose=False)
    assert errs["obj_gradient"] < 1e-4, errs
    assert errs["con_gradient"] < 1e-6, errs


def test_fem_solver_against_dense():
    """CG displacement solution matches a dense assembled solve."""
    prob = FEMTopology(nex=6, ney=3, cg_iters=600)
    x0, _, _ = prob.get_vars_and_bounds()
    xf = prob._filter(x0)
    E = prob.emin + xf ** prob.penal * (prob.e0 - prob.emin)
    u = prob._solve(E)
    # dense assembly
    nd = prob.ndof
    K = np.zeros((nd, nd))
    KE = np.asarray(prob.KE)
    ed = np.asarray(prob.edofs)
    for e in range(prob.nvars):
        K[np.ix_(ed[e], ed[e])] += float(E[e]) * KE
    fixed = np.asarray(prob.fixed_mask) > 0
    K[fixed, :] = 0.0
    K[:, fixed] = 0.0
    K[fixed, fixed] = 1.0
    b = np.where(fixed, 0.0, np.asarray(prob.f))
    u_ref = np.linalg.solve(K, b)
    assert np.allclose(np.asarray(u), u_ref, atol=1e-7), \
        np.abs(np.asarray(u) - u_ref).max()


def test_mgcg_matches_dense_solve():
    """Geometric-multigrid-preconditioned CG reaches the dense solution in
    ~25 iterations (vs hundreds for Jacobi-CG) on a high-contrast field."""
    rng = np.random.default_rng(1)
    prob = FEMTopology(nex=8, ney=4, cg_iters=25, solver="mgcg")
    assert len(prob._mg_dims) >= 2
    x = jnp.asarray(np.clip(rng.random(prob.nvars) * 1.4 - 0.2, 0.0, 1.0))
    xf = prob._filter(x)
    E = prob.emin + xf ** prob.penal * (prob.e0 - prob.emin)
    u = prob._solve(E)
    nd = prob.ndof
    K = np.zeros((nd, nd))
    KE = np.asarray(prob.KE)
    ed = np.asarray(prob.edofs)
    for e in range(prob.nvars):
        K[np.ix_(ed[e], ed[e])] += float(E[e]) * KE
    fixed = np.asarray(prob.fixed_mask) > 0
    K[fixed, :] = 0.0
    K[:, fixed] = 0.0
    K[fixed, fixed] = 1.0
    b = np.where(fixed, 0.0, np.asarray(prob.f))
    u_ref = np.linalg.solve(K, b)
    assert np.allclose(np.asarray(u), u_ref, atol=1e-8), \
        np.abs(np.asarray(u) - u_ref).max()


def test_mgcg_binary_density_fuzz():
    """Unfiltered random 0/1 densities (salt-and-pepper, exact 1e3
    modulus contrast at every element boundary — the worst case for the
    rediscretized coarse operator) across several even meshes: MG-CG
    converges in ~80 iterations (vs ~400 Jacobi-CG; real SIMP end states
    are filtered/connected and take ~25)."""
    for seed, (nex, ney) in enumerate(((8, 4), (12, 8), (16, 4))):
        rng = np.random.default_rng(seed)
        prob = FEMTopology(nex=nex, ney=ney, cg_iters=80, solver="mgcg",
                           filter_radius=0)
        x = jnp.asarray((rng.random(prob.nvars) > 0.5).astype(np.float64))
        E = prob.emin + x ** prob.penal * (prob.e0 - prob.emin)
        u = prob._solve(E)
        nd = prob.ndof
        K = np.zeros((nd, nd))
        KE = np.asarray(prob.KE)
        ed = np.asarray(prob.edofs)
        for e in range(prob.nvars):
            K[np.ix_(ed[e], ed[e])] += float(E[e]) * KE
        fixed = np.asarray(prob.fixed_mask) > 0
        K[fixed, :] = 0.0
        K[:, fixed] = 0.0
        K[fixed, fixed] = 1.0
        b = np.where(fixed, 0.0, np.asarray(prob.f))
        u_ref = np.linalg.solve(K, b)
        err = np.abs(np.asarray(u) - u_ref).max() / np.abs(u_ref).max()
        assert err < 1e-8, (nex, ney, err)


def test_mgcg_gradients_and_fallback():
    """check_gradients passes under the MG solver; a non-coarsenable mesh
    silently falls back to Jacobi."""
    prob = FEMTopology(nex=8, ney=4, cg_iters=30, solver="mgcg")
    errs = prob.check_gradients(1e-6, verbose=False)
    assert errs["obj_gradient"] < 1e-4, errs
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        odd = FEMTopology(nex=7, ney=5, cg_iters=400, solver="mgcg")
    assert any("falls back to Jacobi" in str(w.message) for w in caught)
    assert len(odd._mg_dims) == 1  # falls back to the Jacobi path
    x0, _, _ = odd.get_vars_and_bounds()
    assert np.isfinite(float(odd.objective(x0)))


def test_fem_topology_ip():
    prob = FEMTopology(nex=12, ney=6, cg_iters=250)
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    ip = InteriorPoint(prob, {"output_file": None, "abs_res_tol": 1e-4,
                              "max_major_iters": 60})
    res = ip.optimize()
    # compliance must improve substantially and stay volume-feasible
    assert res["fobj"] < 0.8 * f0, (res["fobj"], f0)
    assert float(prob.constraints(res["x"])[0]) > -1e-4


def test_fused_mma_mgcg_matches_jacobi():
    """The fused MMA outer loop under the multigrid state solver follows
    the Jacobi-CG trajectory (the state solves agree to solver tolerance,
    which is far inside MMA's asymptote dynamics)."""
    from paropt_tpu.mma import FusedMMA

    opts = {"mma_output_file": None, "output_file": None,
            "mma_max_iterations": 6}
    res = {}
    for solver, cg in (("jacobi", 250), ("mgcg", 25)):
        prob = FEMTopology(nex=12, ney=6, cg_iters=cg, solver=solver)
        r, _ = FusedMMA(prob, dict(opts)).solve()
        res[solver] = r
    assert res["mgcg"]["niter"] == res["jacobi"]["niter"]
    np.testing.assert_allclose(res["mgcg"]["fobj"], res["jacobi"]["fobj"],
                               rtol=1e-6)


def test_fem_topology_regions_mma():
    prob = FEMTopology(nex=8, ney=4, region=4, region_cap=0.7, cg_iters=250)
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    mma = MMA(prob, {"mma_output_file": None, "output_file": None,
                     "mma_max_iterations": 25})
    res = mma.optimize()
    assert res["fobj"] < f0
    assert float(jnp.min(prob.sparse_constraints(res["x"]))) > -1e-4


def test_dmo_multimaterial():
    """Multi-material DMO compliance problem: block weighting constraints
    (one per element), mass cap active, materials selected discretely."""
    import numpy as np
    from paropt_tpu.models.fem_topology import DMOFEMTopology
    from paropt_tpu.ip import InteriorPoint

    prob = DMOFEMTopology(nex=12, ney=6, cg_iters=150)
    rep = prob.check_gradients(dh=1e-6, verbose=False)
    assert rep["obj_gradient"] < 1e-7
    assert rep["sparse_jacobian"] < 1e-9

    ip = InteriorPoint(prob, {"output_file": None, "max_major_iters": 200,
                              "abs_res_tol": 1e-5})
    res = ip.optimize()
    assert res["converged"], res
    x = np.asarray(res["x"])
    xm = x.reshape(prob.ne, prob.nmat)
    # feasibility: per-element weight sums and the mass cap
    assert (xm.sum(axis=1) <= 1.0 + 1e-6).all()
    mass = float(np.mean(xm @ np.asarray(prob.rho_mats)))
    assert mass <= prob.mass_fraction + 1e-4
    # the mass constraint should be active (compliance monotone in mass)
    assert mass > 0.8 * prob.mass_fraction


def test_dmo_fused_mma():
    """Fused MMA drives the DMO model (blocked weighting constraints in the
    on-device outer loop) to a feasible design at the mass cap."""
    import numpy as np
    from paropt_tpu.models.fem_topology import DMOFEMTopology
    from paropt_tpu.mma import FusedMMA

    prob = DMOFEMTopology(nex=12, ney=6, cg_iters=120)
    res, st = FusedMMA(prob, {
        "mma_max_iterations": 30, "mma_output_file": None,
        "abs_res_tol": 1e-6, "mma_l1_tol": 1e-30, "mma_linfty_tol": 1e-30,
        "max_major_iters": 50}).solve()
    x = np.asarray(res["x"])
    xm = x.reshape(prob.ne, prob.nmat)
    assert (xm.sum(axis=1) <= 1.0 + 1e-5).all()
    mass = float(np.mean(xm @ np.asarray(prob.rho_mats)))
    assert mass <= prob.mass_fraction + 1e-4
    assert int(st.subiters) > 0
