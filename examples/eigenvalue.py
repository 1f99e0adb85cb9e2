"""Eigenvalue-constraint trust-region optimization with the low-rank compact
approximation (the role of `examples/eigenvalue/eigenvalue_opt.py`).

A synthetic buckling-style constraint c(x) = r2 - |V'x|^2/2 >= 0 whose exact
Hessian is low-rank; the user callback refreshes the CompactEigenApprox each
accepted TR step.
"""

import numpy as np
import jax.numpy as jnp

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from paropt_tpu.eig import (CompactEigenApprox, EigenQuasiNewton,
                            EigenSubproblem)
from paropt_tpu.tr import TrustRegion
from paropt_tpu.problem import Problem
from paropt_tpu.ops import qn as qnmod


class BucklingStyleProblem(Problem):
    def __init__(self, n=32, N=3, r2=1.0, seed=0):
        super().__init__(nvars=n, ncon=1)
        rng = np.random.default_rng(seed)
        self.V = jnp.asarray(rng.standard_normal((N, n)) / np.sqrt(n))
        self.N = N
        self.r2 = r2

    def objective(self, x):
        return jnp.sum((x - 1.0) ** 2)

    def constraints(self, x):
        vx = self.V @ x
        return jnp.array([self.r2 - 0.5 * jnp.vdot(vx, vx)])

    def get_vars_and_bounds(self):
        n = self.nvars
        return jnp.zeros(n), jnp.full(n, -10.0), jnp.full(n, 10.0)


def main():
    prob = BucklingStyleProblem()
    eigh = CompactEigenApprox(nvars=prob.nvars, N=prob.N)
    eqn = EigenQuasiNewton(qnmod.qn_init(10, prob.nvars), eigh, index=0)
    sub = EigenSubproblem(prob, eqn)

    def update_model(x, eigh):
        # exact low-rank curvature of the constraint: H = -V'V
        eigh.set_approximation(M=-jnp.eye(prob.N), hvecs=prob.V)

    sub.set_eigen_model_update(update_model)
    x0, _, _ = prob.get_vars_and_bounds()
    f0, c0 = prob.eval_obj_con(x0)
    g0, A0 = prob.eval_obj_con_gradient(x0)
    eigh.set_approximation(c0=c0[0], g0=A0[0], M=-jnp.eye(prob.N),
                           hvecs=prob.V)

    tr = TrustRegion(prob, {
        "tr_output_file": "-", "output_file": None,
        "tr_max_iterations": 100, "tr_init_size": 1.0,
        "tr_adaptive_gamma_update": False,
    }, subproblem=sub)
    res = tr.optimize()
    print(f"\nconverged: {res['converged']}  f* = {res['fobj']:.6e}")
    print(f"constraint: {float(prob.constraints(res['x'])[0]):.3e}")


if __name__ == "__main__":
    main()
