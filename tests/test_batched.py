"""Batched whole-solve path (`FusedIP.solve_batched`) — many IP solves as
ONE vmapped XLA computation (multi-start / problem-data sweeps).

extension with no reference analogue: in the reference every solve is a
separate MPI job (`ParOptInteriorPoint.cpp:4399`). Correctness contract:
each batch instance must match its own single `jit_loop` solve."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from paropt_tpu import ip_fused
from paropt_tpu.models.topology import SyntheticTopology
from paropt_tpu.ops import qn as qnmod


def _build(n=256, tol=1e-5):
    prob = SyntheticTopology(n=n, block=8, dtype=jnp.float64)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=tol, max_major_iters=400)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=jnp.float64)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=jnp.float64)
    qn0 = qnmod.qn_init(5, prob.nvars, dtype=jnp.float64)
    return fused, data, x0, qn0


def test_solve_batched_multistart_matches_single_solves():
    fused, data, x0, qn0 = _build()
    rng = np.random.default_rng(0)
    k, n = 3, x0.shape[0]
    x0s = jnp.asarray(x0)[None, :] * jnp.asarray(
        rng.uniform(0.4, 1.6, size=(k, n)))

    st = fused.solve_batched(x0s, data, (), qn0)
    assert st.vars.x.shape == (k, n)
    assert bool(jnp.all(st.converged))

    for i in range(k):
        single = fused.solve(x0s[i], data, (), qn0, jit_loop=True)
        assert bool(single.converged)
        # identical algorithm, batched shapes: near-identical iterate count
        # and a matching optimum (fp association differs under vmap, so a
        # near-tolerance instance may legitimately converge one iteration
        # earlier/later on another backend/XLA version)
        assert abs(int(st.k[i]) - int(single.k)) <= 1
        np.testing.assert_allclose(float(st.fobj[i]), float(single.fobj),
                                   rtol=1e-9)
        np.testing.assert_allclose(np.asarray(st.vars.x[i]),
                                   np.asarray(single.vars.x),
                                   rtol=1e-6, atol=1e-9)

    # early-converged instances stay frozen while the rest iterate: batch
    # iteration counts need not be equal, but every residual meets the tol
    assert float(jnp.max(st.res_norm)) < 1e-5


def test_solve_batched_data_sweep():
    """Sweep a ProblemData field (upper bound) across the batch via
    ``data_axes``: looser box => no worse objective."""
    fused, data, x0, qn0 = _build()
    scales = jnp.asarray([1.0, 2.0, 4.0])
    data_b = dataclasses.replace(
        data, ub=scales[:, None] * jnp.asarray(data.ub)[None, :])
    axes = dataclasses.replace(
        jax.tree_util.tree_map(lambda _: None, data), ub=0)

    x0s = jnp.broadcast_to(jnp.asarray(x0), (3, x0.shape[0]))
    st = fused.solve_batched(x0s, data_b, (), qn0, data_axes=axes)
    assert bool(jnp.all(st.converged))
    f = np.asarray(st.fobj)
    assert f[1] <= f[0] + 1e-10 and f[2] <= f[1] + 1e-10

    # per-instance cross-check against a single solve at the middle scale
    single = fused.solve(x0s[1], dataclasses.replace(
        data, ub=2.0 * jnp.asarray(data.ub)), (), qn0, jit_loop=True)
    np.testing.assert_allclose(float(st.fobj[1]), float(single.fobj),
                               rtol=1e-9)
