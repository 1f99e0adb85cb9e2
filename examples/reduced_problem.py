"""Reduced problem: optimize over a subset of the design variables
(the reference's `examples/reduced_problem/` role).

    python examples/reduced_problem.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .jax_cache): repeat runs skip compilation
from paropt_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax.numpy as jnp
import numpy as np

from paropt_tpu import Problem, ReducedProblem
from paropt_tpu.optimizer import Optimizer


class Quartic(Problem):
    """min x0^4 + x1^4 + x2^4  s.t.  x0 + x1 + x2 - 1 >= 0."""

    def __init__(self):
        super().__init__(nvars=3, ncon=1)

    def objective(self, x):
        return jnp.sum(x ** 4)

    def constraints(self, x):
        return jnp.array([jnp.sum(x) - 1.0])

    def get_vars_and_bounds(self):
        return jnp.ones(3), jnp.zeros(3), jnp.full(3, 10.0)


def main():
    full = Quartic()
    red = ReducedProblem(full, fixed_idx=[0], fixed_vals=[0.1])
    opt = Optimizer(red, {"algorithm": "tr", "output_file": None,
                          "tr_output_file": None, "tr_max_iterations": 200})
    res = opt.optimize()
    xfull = np.asarray(red.expand(res["x"]))
    print(f"free solution: {np.asarray(res['x']).round(5)}")
    print(f"full solution: {xfull.round(5)}  (x0 fixed at 0.1)")
    print(f"constraint: {float(full.constraints(xfull)[0]):+.2e}")


if __name__ == "__main__":
    main()
