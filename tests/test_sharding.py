"""Multi-device (virtual 8-CPU mesh) tests: the fused IP step must produce
identical results sharded and unsharded — the SPMD analogue of the
reference's rank-count-agnostic design (`SURVEY.md` §2.3, §5.8)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paropt_tpu import ip_fused
from paropt_tpu.models.topology import SyntheticTopology
from paropt_tpu.ops import qn as qnmod


def _build(n=1024, msub=10, tol=1e-5):
    prob = SyntheticTopology(n=n, block=8)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=tol,
                                   max_major_iters=400)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts)
    data, x0 = ip_fused.data_template_from_problem(prob)
    qn0 = qnmod.qn_init(msub, prob.nvars)
    return fused, data, x0, qn0


def _shard_tree(tree, mesh, n):
    shard_n = NamedSharding(mesh, P("d"))
    shard_rows = NamedSharding(mesh, P(None, "d"))
    repl = NamedSharding(mesh, P())

    def place(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[-1] == n:
            return jax.device_put(
                leaf, shard_n if leaf.ndim == 1 else shard_rows)
        return jax.device_put(leaf, repl)

    return jax.tree_util.tree_map(place, tree)


def _tree_maxdiff(a, b):
    diffs = []
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        if not hasattr(x, "size") or not x.size:
            continue
        x, y = jnp.asarray(x), jnp.asarray(y)
        if x.dtype == bool:
            diffs.append(float(jnp.max(x != y)))
        else:
            diffs.append(float(jnp.max(jnp.abs(x - y))))
    return max(diffs)


def test_fused_step_sharded_matches_unsharded():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    n = 1024
    fused, data, x0, qn0 = _build(n=n)

    # unsharded reference
    st = fused.init(x0, data, (), qn0, None)
    for _ in range(5):
        st = fused.step(st, data, (), None)

    # sharded over an 8-device mesh
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    st_s = fused.init(x0, data, (), qn0, None)
    st_s = _shard_tree(st_s, mesh, n)
    data_s = _shard_tree(data, mesh, n)
    for _ in range(5):
        st_s = fused.step(st_s, data_s, (), None)

    assert _tree_maxdiff(st.vars, st_s.vars) < 1e-10
    assert float(st.fobj) == pytest.approx(float(st_s.fobj), rel=1e-12)
    assert int(st.k) == int(st_s.k)


def test_fused_step_hybrid_host_mesh_matches_unsharded():
    """The hybrid multi-host mesh shape — 2-D ('host', 'd'), design axis
    sharded over BOTH axes (DCN outer / ICI inner in deployment,
    docs/design.md 'Scaling') — reproduces the unsharded trajectory."""
    from paropt_tpu.parallel.sharding import (hybrid_design_mesh,
                                              design_sharding, row_sharding,
                                              replicated_sharding)
    n = 1024
    fused, data, x0, qn0 = _build(n=n)

    st = fused.init(x0, data, (), qn0, None)
    for _ in range(5):
        st = fused.step(st, data, (), None)

    mesh = hybrid_design_mesh(n_hosts=2, local_devices=4,
                              devices=jax.devices()[:8])
    assert mesh.axis_names == ("host", "d")

    def place(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[-1] == n:
            sh = (design_sharding(mesh) if leaf.ndim == 1
                  else row_sharding(mesh))
            return jax.device_put(leaf, sh)
        return jax.device_put(leaf, replicated_sharding(mesh))

    st_h = jax.tree_util.tree_map(place, fused.init(x0, data, (), qn0, None))
    data_h = jax.tree_util.tree_map(place, data)
    for _ in range(5):
        st_h = fused.step(st_h, data_h, (), None)

    assert _tree_maxdiff(st.vars, st_h.vars) < 1e-10
    assert float(st.fobj) == pytest.approx(float(st_h.fobj), rel=1e-12)


def test_fused_full_solve_sharded():
    n = 1024
    fused, data, x0, qn0 = _build(n=n)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    st = fused.init(x0, data, (), qn0, None)
    st = _shard_tree(st, mesh, n)
    data_s = _shard_tree(data, mesh, n)
    out = fused.solve(st.vars.x, data_s, (), qn0, None, max_iters=400)
    assert bool(out.converged), (float(out.res_norm), int(out.k))
    # volume constraint satisfied at solution
    assert float(out.c[0]) > -1e-6


def test_fused_fail_stop_freezes_finite():
    """If an iteration's accepted state goes non-finite (ill-conditioned
    subproblem, no host recovery ladder inside the fused loop), the solver
    freezes at the last finite state and stops instead of iterating on NaN
    (observed on a 192x96 FEM topology MMA subproblem at f32)."""
    from paropt_tpu.problem import Problem

    n = 64
    trap = 0.9  # gradient blows up once max(x) crosses this

    class TrapProblem(Problem):
        """Gradient 'callback' goes NaN beyond the trap while the objective
        stays finite — so the line search happily accepts a step into the
        trap and the POST-ACCEPT gradient evaluation is what poisons the
        state (the scenario the fail-stop exists for)."""

        def __init__(self):
            super().__init__(nvars=n, ncon=1)

        def objective(self, x):
            return jnp.sum((x - 2.0) ** 2)

        def constraints(self, x):
            return jnp.array([jnp.sum(x) * 0.0 + 1.0])

        def eval_obj_con_gradient(self, x):
            g = 2.0 * (x - 2.0)
            g = jnp.where(jnp.max(x) > trap, jnp.nan, g)
            return g, jnp.zeros((1, n), x.dtype)

        def get_vars_and_bounds(self):
            return jnp.zeros(n), jnp.full(n, -2.0), jnp.full(n, 2.0)

    prob = TrapProblem()
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(abs_res_tol=1e-8, max_major_iters=100,
                                   use_quasi_newton_update=True)
    fused = ip_fused.FusedIP(model, n, 1, opts=opts)
    data, x0 = ip_fused.data_template_from_problem(prob)
    qn0 = qnmod.qn_init(5, n)
    out = fused.solve(x0, data, (), qn0, None, jit_loop=True)
    # the minimizer x=2 sits beyond the trap: the solve must stop at a
    # FINITE state rather than return NaN
    assert bool(out.converged)
    assert bool(jnp.all(jnp.isfinite(out.vars.x))), "frozen state not finite"
    assert bool(jnp.isfinite(out.fobj))


def test_jit_loop_whole_solve():
    """The zero-round-trip lax.while_loop path gives the same answer as the
    host-paced path."""
    n = 512
    fused, data, x0, qn0 = _build(n=n)
    out_host = fused.solve(x0, data, (), qn0, None)
    out_jit = fused.solve(x0, data, (), qn0, None, jit_loop=True)
    assert bool(out_jit.converged)
    assert float(out_jit.fobj) == pytest.approx(float(out_host.fobj),
                                                rel=1e-8)
    assert np.allclose(np.asarray(out_jit.vars.x),
                       np.asarray(out_host.vars.x), atol=1e-8)


def test_orbax_checkpoint_roundtrip(tmp_path):
    """Sharded fused-state checkpoint/resume (the MPI-IO checkpoint role)."""
    from paropt_tpu.utils.checkpoint import save_state, restore_state
    n = 512
    fused, data, x0, qn0 = _build(n=n)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    st = fused.init(x0, data, (), qn0, None)
    st = _shard_tree(st, mesh, n)
    data_s = _shard_tree(data, mesh, n)
    for _ in range(3):
        st = fused.step(st, data_s, (), None)
    path = str(tmp_path / "ckpt")
    save_state(path, st)
    st2 = restore_state(path, st)
    assert _tree_maxdiff(st, st2) == 0.0
    # sharding preserved
    assert st2.vars.x.sharding == st.vars.x.sharding
    # resumed state continues identically
    a = fused.step(st, data_s, (), None)
    b = fused.step(st2, data_s, (), None)
    assert _tree_maxdiff(a, b) == 0.0


def test_host_loop_ip_sharded_checkpoint_roundtrip(tmp_path):
    """The host-loop InteriorPoint's write/read_solution_file routes
    sharded state through Orbax (the MPI-IO collective-checkpoint role,
    `ParOptInteriorPoint.cpp:883-972`), preserving shardings on restore;
    single-device state keeps the npz format."""
    from paropt_tpu import InteriorPoint
    from paropt_tpu.models.topology import SyntheticTopology

    n = 512
    prob = SyntheticTopology(n=n, block=8, dtype=jnp.float64)
    ip = InteriorPoint(prob, {"output_file": None, "max_major_iters": 3})
    ip.optimize()
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    ip.vars = _shard_tree(ip.vars, mesh, n)
    assert ip._state_is_sharded()

    path = str(tmp_path / "ipckpt")
    ip.write_solution_file(path)
    import os
    assert os.path.isdir(path)    # Orbax directory, not an npz

    ip2 = InteriorPoint(SyntheticTopology(n=n, block=8, dtype=jnp.float64),
                        {"output_file": None})
    ip2.vars = _shard_tree(ip2.vars, mesh, n)
    ip2.read_solution_file(path)
    assert _tree_maxdiff(ip.vars, ip2.vars) == 0.0
    assert ip2.vars.x.sharding == ip.vars.x.sharding
    assert ip2.mu == pytest.approx(float(ip.mu))

    # unsharded state keeps the npz path
    ip3 = InteriorPoint(SyntheticTopology(n=n, block=8, dtype=jnp.float64),
                        {"output_file": None, "max_major_iters": 2})
    ip3.optimize()
    assert not ip3._state_is_sharded()
    npz_path = str(tmp_path / "ipckpt_plain")
    ip3.write_solution_file(npz_path)
    assert os.path.exists(npz_path + ".npz") or os.path.exists(npz_path)


def test_fused_mehrotra_strategies():
    """Fused solver with Mehrotra and predictor-corrector barriers reaches
    the same solution as monotone."""
    n = 512
    x_ref = None
    for strat in ("monotone", "mehrotra", "mehrotra_predictor_corrector"):
        prob = SyntheticTopology(n=n, block=8)
        model = ip_fused.model_from_problem(prob)
        opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                       abs_res_tol=1e-5,
                                       barrier_strategy=strat,
                                       max_major_iters=400)
        fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                                 prob.nwblock, opts)
        data, x0 = ip_fused.data_template_from_problem(prob)
        qn0 = qnmod.qn_init(10, prob.nvars)
        out = fused.solve(x0, data, (), qn0, None)
        assert bool(out.converged), (strat, float(out.res_norm), int(out.k))
        assert float(out.c[0]) > -1e-6, strat  # volume feasible
        # at tol 1e-5 the iterates may differ in flat directions; the
        # optimal objective must agree tightly
        if x_ref is None:
            x_ref = float(out.fobj)
        else:
            assert abs(float(out.fobj) - x_ref) < 1e-4, (strat, out.fobj)


def test_f32_smoke():
    """The f32 configuration (explicit dtype, the bench.py configuration
    on the GPU) converges to the f32-appropriate tolerance."""
    prob = SyntheticTopology(n=1024, block=8, dtype=jnp.float32)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=1e-4, max_major_iters=300)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=jnp.float32)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=jnp.float32)
    qn0 = qnmod.qn_init(10, prob.nvars, dtype=jnp.float32)
    out = fused.solve(x0, data, (), qn0, None)
    assert out.vars.x.dtype == jnp.float32
    assert bool(out.converged), (float(out.res_norm), int(out.k))
    assert float(out.c[0]) > -1e-4


def test_tr_fused_qp_sharded_matches_unsharded():
    """The TR inner fused QP (make_qp_model + FusedIP) runs sharded over the
    design axis: same solution as unsharded — the multi-chip path of the
    SL1QP outer loop."""
    from paropt_tpu.optimizer import Optimizer
    from paropt_tpu.tr import TrustRegion

    n = 1024
    prob = SyntheticTopology(n=n, block=8)
    tr = TrustRegion(prob, {"output_file": None, "tr_output_file": None,
                            "tr_max_iterations": 1})
    # initialize the subproblem at x0 and build the fused inner solver
    x0, lb, ub = prob.get_vars_and_bounds()
    tr.subproblem.init_model(tr.tr_size)
    tr._build_fused()
    idx = np.arange(prob.ncon)
    gam = jnp.asarray(tr.penalty_gamma)
    gamma_s = jnp.where(idx < prob.ninequality, 0.0, gam)
    data = tr._fused_data(gamma_s, gam, tr.options["penalty_gamma"])
    params = tr._qp_params()
    compact = (params.b0, params.Z, params.M)
    p0 = 0.5 * (tr.subproblem.lk + tr.subproblem.uk)

    st_ref = tr._fused_qp.solve(p0, data, params, compact=compact)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    data_s = _shard_tree(data, mesh, n)
    params_s = _shard_tree(params, mesh, n)
    compact_s = (params_s.b0, params_s.Z, params_s.M)
    p0_s = _shard_tree(p0, mesh, n)
    st_sh = tr._fused_qp.solve(p0_s, data_s, params_s, compact=compact_s)

    assert int(st_sh.k) == int(st_ref.k)
    assert float(jnp.max(jnp.abs(st_sh.vars.x - st_ref.vars.x))) < 1e-10
    assert float(jnp.max(jnp.abs(st_sh.vars.zw - st_ref.vars.zw))) < 1e-10


def test_fused_nk_sharded():
    """The fused Newton-Krylov phase (unrolled GMRES + autodiff HVPs)
    compiles and runs over the device mesh, engaging in the endgame and
    matching the unsharded solution."""
    from paropt_tpu.models.analytic import RandomConvexQP

    n = 256
    prob = RandomConvexQP(n=n, ncon=2, seed=5)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(
        use_quasi_newton_update=True, abs_res_tol=1e-9, max_major_iters=300,
        use_hvec_product=True, gmres_subspace_size=10, nk_switch_tol=1.0)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts)
    data, x0 = ip_fused.data_template_from_problem(prob)
    qn0 = qnmod.qn_init(8, prob.nvars)

    st_ref = fused.solve(x0, data, (), qn0, None, jit_loop=True)
    assert bool(st_ref.converged)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    data_s = _shard_tree(data, mesh, n)
    x0_s = _shard_tree(x0, mesh, n)
    qn_s = _shard_tree(qn0, mesh, n)
    st_sh = fused.solve(x0_s, data_s, (), qn_s, None, jit_loop=True)
    assert bool(st_sh.converged)
    # cross-device reduction order perturbs trajectories at the bit level;
    # the converged solutions agree to solver tolerance
    assert float(jnp.max(jnp.abs(st_sh.vars.x - st_ref.vars.x))) < 1e-6

    # NK engages on the sharded state (python-mode stepping exposes it)
    state = fused.init(x0_s, data_s, (), qn_s, None)
    engaged = False
    for _ in range(300):
        state = fused.step(state, data_s, (), None)
        engaged = engaged or int(state.gmres_iters) > 0
        if bool(state.converged):
            break
    assert engaged


def test_fused_mma_fem_topology_sharded():
    """The flagship FEM SIMP workload with the design axis sharded over the
    8-device mesh: the stencil matvec's slices/pads become halo exchanges
    under SPMD (x-strips of the element grid = contiguous chunks of the
    flat design vector), and the multigrid V-cycle distributes too. The
    sharded FusedMMA run must match the unsharded one."""
    from paropt_tpu.mma import FusedMMA
    from paropt_tpu.models.fem_topology import FEMTopology

    prob = FEMTopology(nex=16, ney=8, cg_iters=25, solver="mgcg")
    opts = {"mma_max_iterations": 6, "mma_output_file": None}
    solver = FusedMMA(prob, dict(opts))
    res1, _ = solver.solve()

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    st0_s = _shard_tree(solver._state0, mesh, prob.nvars)
    res_s, _ = solver.solve(state0=st0_s)
    assert res_s["niter"] == res1["niter"]
    assert abs(res_s["fobj"] - res1["fobj"]) < 1e-9, \
        (res_s["fobj"], res1["fobj"])


def test_fused_mma_fem_topology3d_sharded():
    """Same for the 3-D voxel model's GRID-FORM solve: the design vector
    shards along the (row-major) flat voxel axis = contiguous x-slabs of
    the [nex, ney, nez] element grid, so the component-grid stencil's
    slices/pads become halo exchanges and the V-cycle distributes.  The
    sharded FusedMMA run must match the unsharded one."""
    from paropt_tpu.mma import FusedMMA
    from paropt_tpu.models.fem_topology3d import FEMTopology3D

    prob = FEMTopology3D(nex=8, ney=4, nez=4, cg_iters=20, solver="mgcg")
    opts = {"mma_max_iterations": 5, "mma_output_file": None}
    solver = FusedMMA(prob, dict(opts))
    res1, _ = solver.solve()

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    st0_s = _shard_tree(solver._state0, mesh, prob.nvars)
    res_s, _ = solver.solve(state0=st0_s)
    assert res_s["niter"] == res1["niter"]
    assert abs(res_s["fobj"] - res1["fobj"]) < 1e-9, \
        (res_s["fobj"], res1["fobj"])


def test_fused_mma_sharded_and_resume():
    """FusedMMA over the mesh matches unsharded, and a solve can resume
    from a previous final state."""
    from paropt_tpu.mma import FusedMMA

    n = 512
    opts = {"mma_max_iterations": 8, "mma_output_file": None}
    solver = FusedMMA(SyntheticTopology(n=n, block=8), dict(opts))
    res1, st1 = solver.solve()

    # resume: 8 more iterations from the final state
    import dataclasses as dc
    st_resume = dc.replace(st1, k=jnp.zeros((), jnp.int32))
    res2, st2 = solver.solve(state0=st_resume)
    # the resumed run continues to improve (or stays converged)
    assert res2["fobj"] <= res1["fobj"] + 1e-8

    # sharded initial state
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    st0_s = _shard_tree(solver._state0, mesh, n)
    res_s, _ = solver.solve(state0=st0_s)
    assert abs(res_s["fobj"] - res1["fobj"]) < 1e-8


def test_fused_eigen_tr_sharded_matches_unsharded():
    """The fused ParOptEig loop with the design axis sharded over the
    8-device mesh (LOBPCG matvecs, KS model, merged-compact QP all
    distribute) matches the unsharded solve."""
    import dataclasses as dc
    from paropt_tpu.models.fem_frequency import FrequencyTopology

    p = FrequencyTopology(nex=8, ney=4, N=3, cg_iters=25, solver="mgcg",
                          lobpcg_iters=40, dtype=jnp.float64)
    ftr = p.build_fused_tr({
        "tr_output_file": None, "output_file": None,
        "tr_max_iterations": 6, "tr_init_size": 0.05,
        "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
        "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
        "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0})
    res1, _ = ftr.solve()

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    st0_s = _shard_tree(ftr._state0, mesh, p.nvars)
    res_s, _ = ftr.solve(state0=st0_s)
    assert res_s["niter"] == res1["niter"]
    assert abs(res_s["fobj"] - res1["fobj"]) < 1e-9
